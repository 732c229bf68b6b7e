// Greedy non-maximum suppression for NVIDIA Hopper (sm_90a), CUDA C++
// with a plain C entry point (loaded with ctypes by
// mxnet_tpu_torch/_kernels.py).
//
// Replaces no Pallas kernel: the reference keeps its greedy loop on the
// device as one lax.fori_loop (mxnet_tpu/ops/contrib.py::_nms_keep,
// keep & ~(sup_mat[i] & keep[i]) for i = 0 .. n-1), which XLA compiles
// into a device loop.  As torch ops that loop costs one to three launches
// a box (400 a forward for SSD's and YOLOv3's nms_topk, 2,000 for the
// RPN's pre_nms), so the port scans with two kernels instead.
//
// Inputs: boxes (G, n, 4) f32 corners sorted by descending score, the
// valid mask (G, n) as bytes, the class ids (G, n) f32 or null (suppress
// across classes), the threshold; scratch for a chunk of images: their
// suppression words (images, n, W), the words' summaries (images, n,
// ceil(W / 64)) and the removed masks (images, W), W = ceil(n / 64) 64-bit
// words.  Output: the keep mask (G, n) bytes, and the number of kernels
// the call launched.
//
// (a) nms_words_kernel, a block of 64 threads for each (column block,
//     row block, image) on or above the diagonal: the block stages its 64
//     column boxes and their class ids in shared memory, and thread i
//     makes word (i, cb), whose bit c says that box j = 64 cb + c > i has
//     i's class (when ids are given) and suppresses(box i, box j), and
//     sets bit cb of row i's summary when the word is not 0.  An invalid
//     box i makes 0: it is never kept, so its words are never read.
// (b) nms_walk_kernel, one warp an image, in word order.  The removed
//     mask starts as the negated valid mask.  For word w the warp decides
//     its 64 boxes in order in registers (a box is kept when its removed
//     bit is still clear, and then ORs in its own word of the diagonal;
//     a ballot skips the boxes whose diagonal word is 0); then each lane
//     takes the kept boxes b = lane and lane + 32 and ORs the later words
//     their summaries name (a box overlaps few others, so most words are
//     0 and never read) into the removed mask with atomicOr.  Only
//     __syncwarp orders the lanes; there is no block barrier.  The keep
//     mask is the complement of the removed mask.
// The wrapper groups the images into chunks whose scratch stays under a
// cap (ops/contrib.py::_nms_plan, 64 MiB); an image whose scratch alone
// passes it is a chunk of its own, so every n runs on the same two
// kernels and nothing waits on shared memory's size.  This is exactly
// the plain version's keep & ~(sup_mat[i] & keep[i]).
//
// The IoU follows the reference's _pair_iou operation by operation, in
// its order, in f32 with IEEE division, and this file is compiled with
// --fmad=false, so that no multiply-add contracts into an FMA that the
// plain version's separate torch ops do not make: the keep mask equals
// the plain version's (_nms_keep_plain) bit for bit.
//
// Bound on this card (H100 SXM): the scan must read each box, id and valid
// flag once and write each keep flag once (22 bytes a box with ids: 0.084
// us for SSD-512's 32 x 400 boxes at 3.35 TB/s), and test every pair that
// a greedy scan of these boxes meets (a kept box against each later valid
// box of its class until that box is removed), 26 f32 operations a pair
// with ids (suppresses() and the class test) at 67 TFLOP/s.  For these
// shapes the operations bind (chip_smoke.py, phase 23a).  Phase (a)
// computes about half of all pairs; the walk is a chain of one step a
// word (a few dependent loads each), which rules at large n, and at small
// n the launches' latency does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;
constexpr int kWord = 64;  // boxes a word, and a row or column block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool suppresses(float4 a, float4 b, float t) {
  // _pair_iou(lhs=a, rhs=b): the same operations in the same order
  float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  float inter = iw * ih;
  float la = fmaxf(a.z - a.x, 0.0f) * fmaxf(a.w - a.y, 0.0f);
  float ra = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  float uni = la + ra - inter;
  float iou = uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
  return iou > t;
}

// (a) the words of image g0 + blockIdx.z, into words (images, n, nw),
// and their summary (images, n, ns), ns = ceil(nw / 64): bit cb of row
// i's summary is set when word (i, cb) is not 0 (the summary is zeroed
// before the launch).  A zero word off the diagonal is not written: the
// walk reads only the diagonal's words and those its summary names.
__global__ void __launch_bounds__(kWord)
nms_words_kernel(const float4* __restrict__ boxes,
                 const uint8_t* __restrict__ valid,
                 const float* __restrict__ cls, u64* __restrict__ words,
                 u64* __restrict__ summary, int n, int nw, int g0,
                 float thresh) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  if (cb < rb) return;  // below the diagonal: no pair j > i
  const size_t base = (static_cast<size_t>(g0) + blockIdx.z) * n;
  __shared__ float4 sbox[kWord];
  __shared__ float sid[kWord];
  const int t = threadIdx.x;
  const int j = cb * kWord + t;
  if (j < n) {
    sbox[t] = boxes[base + j];
    if (cls) sid[t] = cls[base + j];
  }
  __syncthreads();
  const int i = rb * kWord + t;
  if (i >= n) return;
  u64 word = 0;
  if (valid[base + i]) {
    const float4 bi = boxes[base + i];
    const float ci = cls ? cls[base + i] : 0.0f;
    const int lim = min(kWord, n - cb * kWord);
    for (int c = cb == rb ? t + 1 : 0; c < lim; ++c) {
      if ((!cls || sid[c] == ci) && suppresses(bi, sbox[c], thresh))
        word |= 1ull << c;
    }
  }
  const size_t row = static_cast<size_t>(blockIdx.z) * n + i;
  if (word != 0 || cb == rb) words[row * nw + cb] = word;
  if (word != 0) {
    const int ns = (nw + kWord - 1) / kWord;
    atomicOr(summary + row * ns + cb / kWord, 1ull << (cb % kWord));
  }
}

// (b) the walk of image g0 + blockIdx.x over its words and summary, with
// its removed mask (nw words) in scratch; writes its keep flags
__global__ void __launch_bounds__(32)
nms_walk_kernel(const uint8_t* __restrict__ valid,
                const u64* __restrict__ words,
                const u64* __restrict__ summary, u64* __restrict__ removed,
                uint8_t* __restrict__ keep, int n, int nw, int g0) {
  const int lane = threadIdx.x;
  const int ns = (nw + kWord - 1) / kWord;
  const size_t base = (static_cast<size_t>(g0) + blockIdx.x) * n;
  u64* rem = removed + static_cast<size_t>(blockIdx.x) * nw;
  const u64* wd = words + static_cast<size_t>(blockIdx.x) * n * nw;
  const u64* sm = summary + static_cast<size_t>(blockIdx.x) * n * ns;
  // removed starts as the negated valid mask; bits past n are removed
  for (int c = 0; c < nw; ++c) {
    const int j = c * kWord + lane;
    const unsigned lo = __ballot_sync(kFull, j < n && valid[base + j]);
    const unsigned hi =
        __ballot_sync(kFull, j + 32 < n && valid[base + j + 32]);
    if (lane == 0) rem[c] = ~((static_cast<u64>(hi) << 32) | lo);
  }
  __syncwarp();
  // the diagonal words of word w held by this lane: rows 64 w + lane and
  // 64 w + 32 + lane (0 past n)
  auto diag = [&](int w, int r) -> u64 {
    const int i = w * kWord + r;
    return i < n ? wd[static_cast<size_t>(i) * nw + w] : 0ull;
  };
  // the removed mask is read from L2 (ld.cg): other lanes' atomicOr
  // updates it there
  u64 cur = __ldcg(rem);
  u64 d0 = diag(0, lane), d1 = diag(0, lane + 32);
  for (int w = 0; w < nw; ++w) {
    // decide word w's boxes in order: a box still clear is kept, and
    // removes what its diagonal word names (later boxes of word w); a box
    // whose diagonal word is 0 changes nothing, so only the others are
    // visited, in order
    u64 nz = (static_cast<u64>(__ballot_sync(kFull, d1 != 0)) << 32) |
             __ballot_sync(kFull, d0 != 0);
    while (nz) {
      const int b = __ffsll(static_cast<long long>(nz)) - 1;
      nz &= nz - 1;
      const u64 d = __shfl_sync(kFull, b < 32 ? d0 : d1, b & 31);
      if (!((cur >> b) & 1ull)) cur |= d;
    }
    const u64 kept = ~cur;  // bits past n are set in cur: never kept
    if (lane == 0) rem[w] = cur;
    if (w + 1 < nw) {  // the next word's diagonal, in flight meanwhile
      d0 = diag(w + 1, lane);
      d1 = diag(w + 1, lane + 32);
    }
    // each kept box (lane b % 32) ORs its later nonzero words, those its
    // summary names past column block w, into the removed mask
    const int s0 = (w + 1) / kWord;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = lane + 32 * h;
      if (w + 1 >= nw || !((kept >> b) & 1ull)) continue;
      const size_t r = static_cast<size_t>(w) * kWord + b;
      for (int si = s0; si < ns; ++si) {
        u64 m = sm[r * ns + si];
        if (si == s0) m &= ~0ull << ((w + 1) % kWord);
        while (m) {
          const int c = si * kWord + __ffsll(static_cast<long long>(m)) - 1;
          m &= m - 1;
          atomicOr(rem + c, wd[r * nw + c]);
        }
      }
    }
    __syncwarp();  // the ORs are seen by every lane from here
    if (w + 1 < nw) cur = __ldcg(rem + w + 1);
  }
  for (int c = 0; c < nw; ++c) {
    const u64 r = __ldcg(rem + c);
    const int j = c * kWord + lane;
    if (j < n) keep[base + j] = !((r >> lane) & 1ull);
    if (j + 32 < n) keep[base + j + 32] = !((r >> (lane + 32)) & 1ull);
  }
}

}  // namespace

// images_per_chunk images a pair of launches: scratch holds, for each,
// n rows of ceil(n / 64) words and of ceil(n / 4096) summary words, then
// ceil(n / 64) removed words.  *launches is set to the kernels launched.
extern "C" int mxt_nms_keep(const void* boxes, const void* valid,
                            const void* cls, void* keep, void* scratch,
                            int groups, int n, float thresh,
                            int images_per_chunk, int* launches,
                            void* stream) {
  *launches = 0;
  if (groups < 0 || n < 0) return cudaErrorInvalidValue;
  if (groups == 0 || n == 0) return 0;
  const int nw = (n + kWord - 1) / kWord, ns = (nw + kWord - 1) / kWord;
  if (images_per_chunk < 1 || images_per_chunk > 65535 || nw > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b = static_cast<const float4*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* c = static_cast<const float*>(cls);
  u64* wd = static_cast<u64*>(scratch);
  u64* sm = wd + static_cast<size_t>(images_per_chunk) * n * nw;
  u64* rem = sm + static_cast<size_t>(images_per_chunk) * n * ns;
  uint8_t* k = static_cast<uint8_t*>(keep);
  for (int g0 = 0; g0 < groups; g0 += images_per_chunk) {
    const int gc = groups - g0 < images_per_chunk ? groups - g0
                                                  : images_per_chunk;
    cudaError_t err = cudaMemsetAsync(
        sm, 0, static_cast<size_t>(gc) * n * ns * sizeof(u64), s);
    if (err != cudaSuccess) return err;
    const dim3 grid(nw, nw, gc);
    nms_words_kernel<<<grid, kWord, 0, s>>>(b, v, c, wd, sm, n, nw, g0,
                                            thresh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
    nms_walk_kernel<<<gc, 32, 0, s>>>(v, wd, sm, rem, k, n, nw, g0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return 0;
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
