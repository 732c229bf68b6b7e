// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C entry point (loaded with ctypes by mxnet_tpu_torch/_kernels.py).
//
// Replaces: the Pallas TPU kernel mxnet_tpu/ops/flash_attention.py::_fa_kernel
// (launched by _fa_forward_pallas).  It computes the same function, not the
// same blocking:
//   S = Q K^T * scale in f32; key j is visible to query i iff j < Tk and,
//   when causal, j <= i + (Tk - Tq) (bottom-right alignment, as the
//   reference's tril(k = Tk - Tq)); online softmax with running (m, l, acc);
//   O = acc / max(l, 1e-30) in the input dtype; lse = m + log(l) in f32.
//   A row that sees no key gets O = 0 and lse = -inf.
// Inputs: q (B, H, Tq, D), k and v (B, H, Tk, D), contiguous, f32, f16 or
// bf16; D in {16, 32, 64, 128}; any Tq and Tk (ragged tails are masked here).
// The 128-multiple gate, the 512-row blocks and the (..., block_q, 1) lse
// layout of the TPU kernel are Mosaic constraints and are not carried over.
//
// Design: one thread block of 256 threads per (b*h, 64-row q tile).  The
// TPU kernel's sequential "arbitrary" k-grid axis becomes a loop inside the
// block over 64-row k tiles, which stops at the last tile the causal mask
// reaches.  Q, the current K (then V) tile and the 64x64 score tile live in
// dynamic shared memory as f32 (about 82 KB at D = 128, so two blocks fit
// on an SM); each thread keeps a 4 x (D/16) slice of the output accumulator
// in registers, and one warp per 8 rows keeps the running max and sum.
// Heavy (late, causal) q tiles are scheduled first.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// Llama-3-8B slice shape B1 H32 T2048 D128, causal, bf16, the work is about
// 34.4 GFLOP (35 us) against about 67 MB moved (20 us), so it is bound by
// operations.  What this simple design leaves on the table: the products
// run on the f32 FMA pipes (67 TFLOP/s peak), not on the tensor cores
// (mma.sync / wgmma), the scalar shared-memory reads cap the FMA rate at
// about half of that, the tiles are loaded synchronously (no cp.async or
// TMA double buffering), and diagonal tiles compute their masked half.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLdS = kBlockK + 1;  // padded row stride of the score tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// Rows [row0, row0 + 64) of a (rows, D) matrix into shared memory as f32
// with row stride D + 1; rows past the end read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < rows ? to_float(src[(size_t)gr * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + bh * (size_t)tq * D;
  const T* kb = k + bh * (size_t)tk * D;
  const T* vb = v + bh * (size_t)tk * D;
  const int offset = tk - tq;

  load_tile<T, D>(qs, qb, q0, tq);
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
    load_tile<T, D>(kvs, kb, k0, tk);
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
    load_tile<T, D>(kvs, vb, k0, tk);
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
      T* orow = o + (bh * (size_t)tq + qpos) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        orow[tx + 16 * j] = from_float<T>(acc[i][j] / l);
    }
  }
  if (tid < kBlockQ && q0 + tid < tq) {
    const float m = m_s[tid], l = l_s[tid];
    lse[bh * (size_t)tq + q0 + tid] =
        (isfinite(m) && l > 0.f) ? m + logf(fmaxf(l, 1e-30f)) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tq == 0) return cudaSuccess;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int tq, int tk, int d, int causal,
                     float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Returns the cudaError_t of
// the launch (0 on success); the kernel itself runs asynchronously on
// `stream`.
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int tq, int tk, int d,
                                       int dtype, int causal, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, lse, bh, tq, tk, d, causal, scale, s);
    case 1:
      return launch_d<__half>(q, k, v, o, lse, bh, tq, tk, d, causal, scale,
                              s);
    case 2:
      return launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, causal,
                                     scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
