// Greedy non-maximum suppression scan for NVIDIA Hopper (sm_90a), CUDA C++
// with a plain C entry point (loaded with ctypes by
// mxnet_tpu_torch/_kernels.py).
//
// Replaces no Pallas kernel: the reference keeps its greedy loop on the
// device as one lax.fori_loop (mxnet_tpu/ops/contrib.py::_nms_keep,
// keep & ~(sup_mat[i] & keep[i]) for i = 0 .. n-1), which XLA compiles
// into a device loop.  As torch ops that loop costs one to three launches
// a box (400 a forward for SSD's and YOLOv3's nms_topk, 2,000 for the
// RPN's pre_nms), so the port scans in one launch instead.
//
// Inputs: boxes (G, n, 4) f32 corners sorted by descending score, the
// valid mask (G, n) as bytes, the class ids (G, n) f32 or null (suppress
// across classes), the threshold.  Output: the keep mask (G, n) bytes.
// One block an image.  The block loads the valid mask into the keep
// mask; then for i = 0 .. n-1, if keep[i], every thread clears keep[j]
// for its j > i whose IoU with box i exceeds the threshold (same class
// unless forced), and the block meets at a barrier.  A box that is not
// kept writes nothing, so it needs no barrier: keep[i+1] is already
// final for every thread.  This is exactly keep & ~(sup_mat[i] & keep[i])
// with no n x n matrix.
//
// The IoU follows the reference's _pair_iou operation by operation, in
// its order, in f32 with IEEE division, and this file is compiled with
// --fmad=false, so that no multiply-add contracts into an FMA that the
// plain version's separate torch ops do not make: the keep mask equals
// the plain version's (_nms_keep_plain) bit for bit.
//
// Memory: the boxes, the class ids and the mask of one image live in
// dynamic shared memory (21 bytes a box with class ids, 17 without) when
// they fit the block's 227 KB (n <= 11,068 with class ids); past that the
// block reads boxes and ids from device memory and keeps the mask in the
// output itself (volatile, ordered by the same barriers).  Every n runs.
//
// Bound on this card (H100 SXM, 3.35 TB/s): the scan must read each box,
// id and valid flag once and write each keep flag once, 22 bytes a box,
// about 3 us for SSD-512's 32 x 400 boxes; it is latency-bound instead, by
// one pass over the remaining boxes and one barrier for every kept box,
// which the design does nothing yet to shorten (ROADMAP Queue 2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr size_t kMaxShared = 232448;  // 227 KB: a block's opt-in limit

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

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ cls, uint8_t* keep_out, int n,
                float thresh) {
  extern __shared__ float4 smem[];
  const int g = blockIdx.x;
  const size_t base = static_cast<size_t>(g) * n;
  const float4* bx = boxes + base;
  const float* ids = cls ? cls + base : nullptr;
  volatile uint8_t* keep = keep_out + base;
  if (kShared) {
    float4* sbox = smem;
    float* sid = reinterpret_cast<float*>(sbox + n);
    uint8_t* skeep = reinterpret_cast<uint8_t*>(cls ? sid + n : sid);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      sbox[j] = bx[j];
      if (cls) sid[j] = ids[j];
      skeep[j] = valid[base + j];
    }
    bx = sbox;
    ids = cls ? sid : nullptr;
    keep = skeep;
  } else {
    for (int j = threadIdx.x; j < n; j += kThreads) keep[j] = valid[base + j];
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;  // uniform: keep[i] is final for every thread
    const float4 bi = bx[i];
    const float ci = ids ? ids[i] : 0.0f;
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads) {
      if (keep[j] && (!ids || ids[j] == ci) && suppresses(bi, bx[j], thresh))
        keep[j] = 0;
    }
    __syncthreads();
  }
  if (kShared) {
    for (int j = threadIdx.x; j < n; j += kThreads) keep_out[base + j] = keep[j];
  }
}

}  // namespace

extern "C" int mxt_nms_keep(const void* boxes, const void* valid,
                            const void* cls, void* keep, int groups, int n,
                            float thresh, void* stream) {
  if (groups < 0 || n < 0) return cudaErrorInvalidValue;
  if (groups == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t per_box = sizeof(float4) + (cls ? sizeof(float) : 0) + 1;
  const size_t bytes = per_box * static_cast<size_t>(n);
  const float4* b = static_cast<const float4*>(boxes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* c = static_cast<const float*>(cls);
  uint8_t* k = static_cast<uint8_t*>(keep);
  if (bytes <= kMaxShared) {
    static size_t opted = 48 * 1024;  // the limit without opting in
    if (bytes > opted) {
      cudaError_t err = cudaFuncSetAttribute(
          nms_keep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxShared));
      if (err != cudaSuccess) return err;
      opted = kMaxShared;
    }
    nms_keep_kernel<true><<<groups, kThreads, bytes, s>>>(b, v, c, k, n,
                                                          thresh);
  } else {
    nms_keep_kernel<false><<<groups, kThreads, 0, s>>>(b, v, c, k, n, thresh);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
