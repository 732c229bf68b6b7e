// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++ with plain C
// entry points (loaded with ctypes by mxnet_tpu_torch/_kernels.py).
//
// Replaces: the Pallas TPU kernel mxnet_tpu/ops/flash_attention.py::_fa_kernel
// (launched by _fa_forward_pallas).  It computes the same function, not the
// same blocking:
//   S = Q K^T * scale in f32; key j is visible to query i iff j < Tk and,
//   when causal, j <= i + (Tk - Tq) (bottom-right alignment, as the
//   reference's tril(k = Tk - Tq)); online softmax with running (m, l, acc);
//   O = acc / max(l, 1e-30) in the input dtype; lse = m + log(l) in f32
//   (natural log: the backward kernels compute exp(S * scale - lse)).
//   A row that sees no key gets O = 0 and lse = -inf.
// Inputs: q (B, H, Tq, D), k and v (B, H, Tk, D), contiguous, one dtype;
// D in {16, 32, 64, 128}; any Tq and Tk (ragged tails are masked here).
// The 128-multiple gate, the 512-row blocks and the (..., block_q, 1) lse
// layout of the TPU kernel are Mosaic constraints and are not carried over.
// Heavy (late, causal) q tiles are scheduled first in both designs.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// Llama-3-8B slice shape B1 H32 T2048 D128, causal, bf16, the work is 34.4
// GFLOP (0.0348 ms) against 67 MB moved (0.020 ms): bound by operations,
// which only the tensor cores can approach (the f32 FMA pipes' 67 TFLOP/s
// alone need 0.513 ms).
//
// Two designs, chosen by the caller (ops/flash_attention.py) by dtype:
//
// mxt_flash_attention_fwd_mma (bf16, f16): tensor cores, mma.sync.
//   One 256-thread block (8 warps) per (b*h, 128-row q tile); each warp
//   owns 16 query rows.  Q is loaded once with cp.async into padded shared
//   memory and kept in registers as A fragments (ldmatrix).  K and V come
//   in 64-row tiles, double-buffered with cp.async: tile t+1 loads while
//   tile t computes (104 KB of shared memory and 175 registers a thread at
//   D = 128: one block, 8 warps, an SM).  A 128-row q tile shares each K
//   and V tile between 8 warps; it measured 5% faster than a 64-row tile
//   with 4 warps (two blocks an SM) at the slice shape.
//   S = Q K^T runs on mma.m16n8k16 with K's rows as the ".col" B operand
//   (ldmatrix); the f32 scores stay in registers.  Masks are applied only
//   on tiles that cross the causal diagonal or the Tk tail, and the loop
//   stops at the last tile the mask reaches.  The online softmax runs in
//   registers in the base-2 domain (scale * log2(e) folded into the
//   scores, exp2f); each row lives on one quad, so its max is two
//   shuffles and its sum is reduced once, at the end.  P is rounded to the
//   input dtype in registers (the accumulators of two n8 tiles are the A
//   fragment of one k16 step, flash_attention_mma.cuh) and multiplied by V
//   through ldmatrix.trans, so it never goes through shared memory; the
//   JAX package's dense path rounds P to v's dtype before this product
//   too.  O is divided by max(l, 1e-30) and stored with 4-byte stores.
//   What it still leaves: wgmma and TMA (Hopper's own matrix and copy
//   units), warp specialisation, and the masked halves of diagonal tiles,
//   which are computed and then discarded.
//
// mxt_flash_attention_fwd_fma (f32): the f32 FMA design, exact f32 (TF32
//   would change f32 users' results).  One 256-thread block per (b*h,
//   64-row q tile); Q, the current K (then V) tile and the 64x64 score
//   tile live in shared memory as f32 (82 KB at D = 128); each thread
//   keeps a 4 x (D/16) slice of the output accumulator in registers, and
//   one warp per 8 rows keeps the running max and sum.  Scalar shared
//   memory reads and synchronous tile loads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "flash_attention_mma.cuh"

namespace {

// ---- tensor-core design (bf16, f16) ----------------------------------------

constexpr int kMmaThreads = 256;  // 8 warps, 16 q rows each
constexpr int kMmaBlockQ = 128;
constexpr int kMmaBlockK = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t mma_smem_bytes() {
  // the Q tile, then two K and two V tiles, rows padded by 16 bytes
  return 2 * (size_t)(kMmaBlockQ + 4 * kMmaBlockK) * (D + mxt_mma::kPad);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    fa_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, int causal,
                      float scale) {
  using namespace mxt_mma;
  constexpr int kLd = D + kPad;
  constexpr int kDK = D / 16;           // k16 steps over D
  constexpr int kDN = D / 8;            // n8 tiles over D
  constexpr int kKN = kMmaBlockK / 8;   // n8 tiles over a k tile
  constexpr int kTile = kMmaBlockK * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kMmaBlockQ x kLd
  T* ks = qs + kMmaBlockQ * kLd;           // 2 x kTile
  T* vs = ks + 2 * kTile;                  // 2 x kTile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_col = 2 * (lane & 3);
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBlockQ;  // heavy first
  const T* qb = q + bh * (size_t)tq * D;
  const T* kb = k + bh * (size_t)tk * D;
  const T* vb = v + bh * (size_t)tk * D;
  const int offset = tk - tq;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // and row_a + 8

  int n_tiles = (tk + kMmaBlockK - 1) / kMmaBlockK;
  if (causal) {
    const int k_last = min(q0 + kMmaBlockQ, tq) - 1 + offset;
    n_tiles = k_last < 0 ? 0 : min(n_tiles, k_last / kMmaBlockK + 1);
  }
  if (n_tiles > 0) {
    cp_async_tile<kMmaBlockQ, D, kMmaThreads>(qs, qb, q0, tq);
    cp_async_tile<kMmaBlockK, D, kMmaThreads>(ks, kb, 0, tk);
    cp_async_tile<kMmaBlockK, D, kMmaThreads>(vs, vb, 0, tk);
  }
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // running max, base-2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  float acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[kDK][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kMmaBlockK;
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile loads while this one computes
      cp_async_tile<kMmaBlockK, D, kMmaThreads>(ks + (buf ^ 1) * kTile, kb,
                                                k0 + kMmaBlockK, tk);
      cp_async_tile<kMmaBlockK, D, kMmaThreads>(vs + (buf ^ 1) * kTile, vb,
                                                k0 + kMmaBlockK, tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group (and Q's) has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk)
        ldmatrix_x4(qf[kk], frag_a<kLd>(qs, warp * 16, kk * 16, lane));
    }
    const T* kt = ks + buf * kTile;
    const T* vt = vs + buf * kTile;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kKN][4];
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
#pragma unroll
      for (int np = 0; np < kKN / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, frag_b<kLd>(kt, np * 16, kk * 16, lane));
        mma_16816<T>(s[2 * np], qf[kk], b[0], b[1]);
        mma_16816<T>(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    // only tiles on the causal diagonal or the Tk tail hold masked pairs
    if (k0 + kMmaBlockK > tk ||
        (causal && k0 + kMmaBlockK - 1 > q0 + offset)) {
#pragma unroll
      for (int j = 0; j < kKN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + quad_col + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (key >= tk || (causal && key > row + offset))
            s[j][e] = -INFINITY;
        }
    }

    // online softmax; values e = 2h, 2h + 1 belong to row row_a + 8h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKN; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[h] - safe);  // 0 while m[h] = -inf
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKN; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - safe);  // 0 where masked
          sum += s[j][e];
        }
      l[h] = l[h] * corr + sum;
#pragma unroll
      for (int j = 0; j < kDN; ++j) {
        acc[j][2 * h] *= corr;
        acc[j][2 * h + 1] *= corr;
      }
    }

    // acc += P V, P rounded to T in registers
#pragma unroll
    for (int j = 0; j < kMmaBlockK / 16; ++j) {
      uint32_t a[4];
      acc_to_a<T>(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, frag_a<kLd>(vt, j * 16, dp * 16, lane));
        mma_16816<T>(acc[2 * dp], a, b[0], b[1]);
        mma_16816<T>(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_row = quad_sum(l[h]);
    const int row = row_a + 8 * h;
    if (row < tq) {
      const float inv = 1.f / fmaxf(l_row, 1e-30f);
      T* orow = o + (bh * (size_t)tq + row) * D + quad_col;
#pragma unroll
      for (int j = 0; j < kDN; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack2<T>(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
      if ((lane & 3) == 0)
        lse[bh * (size_t)tq + row] = (m[h] == -INFINITY || !(l_row > 0.f))
                                         ? -INFINITY
                                         : m[h] * kLn2 + logf(l_row);
    }
  }
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tq == 0) return cudaSuccess;
  const dim3 grid(bh, (tq + kMmaBlockQ - 1) / kMmaBlockQ);
  fa_fwd_mma_kernel<T, D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_d(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int d, int causal,
                         float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_mma<T, 16>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                               stream);
    case 32:
      return launch_mma<T, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                               stream);
    case 64:
      return launch_mma<T, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                               stream);
    case 128:
      return launch_mma<T, 128>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- f32 FMA design --------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLdS = kBlockK + 1;  // padded row stride of the score tile

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile + k/v tile (row stride D + 1), score tile, then m, l, corr
  return sizeof(float) *
         (size_t)(kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockQ * kLdS +
                  3 * kBlockQ);
}

// Rows [row0, row0 + 64) of a (rows, D) matrix into shared memory with row
// stride D + 1; rows past the end read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < rows ? src[(size_t)gr * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int tq, int tk, int causal,
                  float scale) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // kBlockQ x kLd
  float* kvs = qs + kBlockQ * kLd;   // kBlockK x kLd: K, then V
  float* ss = kvs + kBlockK * kLd;   // kBlockQ x kLdS: S, then P
  float* m_s = ss + kBlockQ * kLdS;  // running max per row
  float* l_s = m_s + kBlockQ;        // running sum per row
  float* c_s = l_s + kBlockQ;        // this tile's correction per row

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heavy tiles first
  const float* qb = q + bh * (size_t)tq * D;
  const float* kb = k + bh * (size_t)tk * D;
  const float* vb = v + bh * (size_t)tk * D;
  const int offset = tk - tq;

  load_tile<D>(qs, qb, q0, tq);
  if (tid < kBlockQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  int n_tiles = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int k_last = min(q0 + kBlockQ, tq) - 1 + offset;
    n_tiles = k_last < 0 ? 0 : min(n_tiles, k_last / kBlockK + 1);
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the last tile's P.V is done with kvs and ss
    load_tile<D>(kvs, kb, k0, tk);
    __syncthreads();

    // S for rows ty + 16 i and columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kvs[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool keep =
            kpos < tk && (!causal || kpos <= q0 + r + offset);
        ss[r * kLdS + c] = keep ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();  // S complete, and every thread is done reading K

    // online softmax: one warp per 8 rows, two columns per lane
    for (int rr = 0; rr < kBlockQ / 8; ++rr) {
      const int r = warp * (kBlockQ / 8) + rr;
      const float s0 = ss[r * kLdS + lane];
      const float s1 = ss[r * kLdS + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float safe = isfinite(m_new) ? m_new : 0.f;
      const float p0 = isfinite(s0) ? expf(s0 - safe) : 0.f;
      const float p1 = isfinite(s1) ? expf(s1 - safe) : 0.f;
      const float sum = warp_sum(p0 + p1);
      ss[r * kLdS + lane] = p0;
      ss[r * kLdS + lane + 32] = p1;
      if (lane == 0) {
        const float corr = isfinite(m_old) ? expf(m_old - safe) : 0.f;
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    load_tile<D>(kvs, vb, k0, tk);
    __syncthreads();  // P, the corrections and V are in place

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * kLdS + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = kvs[kk * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // m_s and l_s are final (also when n_tiles == 0)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    if (qpos < tq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      float* orow = o + (bh * (size_t)tq + qpos) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = acc[i][j] / l;
    }
  }
  if (tid < kBlockQ && q0 + tid < tq) {
    const float m = m_s[tid], l = l_s[tid];
    lse[bh * (size_t)tq + q0 + tid] =
        (isfinite(m) && l > 0.f) ? m + logf(fmaxf(l, 1e-30f)) : -INFINITY;
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tq == 0) return cudaSuccess;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  fa_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Each returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// dtype or D the design does not take); the kernel itself runs
// asynchronously on `stream`.  The tensor-core design needs 16-byte aligned
// q, k and v.
extern "C" int mxt_flash_attention_fwd_mma(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int bh, int tq, int tk, int d,
                                           int dtype, int causal, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_mma_d<__half>(q, k, v, o, lse, bh, tq, tk, d, causal,
                                  scale, s);
    case 2:
      return launch_mma_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d,
                                         causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int mxt_flash_attention_fwd_fma(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int bh, int tq, int tk, int d,
                                           int dtype, int causal, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_fma<16>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    case 32:
      return launch_fma<32>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    case 64:
      return launch_fma<64>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    case 128:
      return launch_fma<128>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
