// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ with plain C
// entry points (loaded with ctypes by mxnet_tpu_torch/_kernels.py).
//
// Replaces the two Pallas TPU kernels of mxnet_tpu/ops/flash_attention.py,
// launched by _fa_backward_pallas:
//   fa_bwd_dq_kernel  <- _fa_bwd_dq_kernel   (dQ)
//   fa_bwd_dkv_kernel <- _fa_bwd_dkv_kernel  (dK and dV)
// Both recompute the probabilities from the forward's per-row lse:
//   S = Q K^T * scale, P = exp(S - lse) (0 where masked or lse = -inf),
//   dP = dO V^T, dS = P * (dP - delta) * scale, with delta = rowsum(dO * O)
//   computed in f32 by the caller before either kernel runs;
//   dQ = dS K, dK = dS^T Q, dV = P^T dO.
// Masking follows the port's forward, not the Pallas backward (which masks
// q >= k and so is right only at Tq = Tk): key j is visible to query i iff
// j < Tk and, when causal, j <= i + (Tk - Tq) (bottom-right alignment).
// Ragged tails are masked here.  Rows that see no key (lse = -inf) get
// dQ = 0 and add nothing to dK and dV.
// Inputs: q, dO (B*H, Tq, D); k, v (B*H, Tk, D); contiguous, all of one dtype
// (f32, f16 or bf16); lse, delta f32 (B*H, Tq); D in {16, 32, 64, 128}.
// Outputs in the input dtype; all arithmetic and accumulation in f32.
//
// Design: each output tile is owned by exactly one thread block, as the TPU
// split has it, so there are no atomics and the gradients are the same bits
// from run to run.
//   dQ: one 256-thread block per (b*h, 64-row q tile); the TPU kernel's
//       sequential k grid axis becomes a loop over 64-row k tiles inside the
//       block, which stops at the last tile the causal mask reaches.  Q, dO,
//       the current K and V tiles and the dS tile live in dynamic shared
//       memory as f32; dQ accumulates in registers (4 x D/16 per thread).
//   dK/dV: one block per (b*h, 64-row k tile), K and V resident, a loop over
//       q tiles that starts at the first tile that sees this k tile; P^T and
//       dS^T go through shared memory, dK and dV accumulate in registers.
// Heavy tiles (late q tiles for dQ, early k tiles for dK/dV) start first.
// Shared memory at D = 128: about 149 KB (dQ) and 166 KB (dK/dV), above the
// 48 KB static limit, so it is dynamic and opted into per kernel.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// Llama-3-8B slice shape B1 H32 T2048 D128 causal bf16 the five products
// the function needs come to about 86 GFLOP (87 us) against about 135 MB
// moved (40 us): bound by operations.  What this simple design leaves: the
// products run on the f32 FMA pipes (67 TFLOP/s peak), not the tensor cores
// (mma.sync / wgmma); S and dP are computed in both kernels (seven products
// where five would do); the tiles are loaded synchronously (no cp.async or
// TMA); diagonal tiles compute their masked half; and one block fits on an
// SM at D = 128.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBlock = 64;  // rows of a q tile and of a k tile
constexpr int kThreads = 256;
constexpr int kLdS = kBlock + 1;  // padded row stride of the 64x64 tiles

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

// Rows [row0, row0 + 64) of a (rows, D) matrix into shared memory as f32
// with row stride D + 1; rows past the end read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  for (int e = threadIdx.x; e < kBlock * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < rows ? to_float(src[(size_t)gr * D + c]) : 0.f;
  }
}

// lse and delta of rows [row0, row0 + 64); rows past the end see no key.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int row0,
                                          int rows) {
  if (threadIdx.x < kBlock) {
    const int r = row0 + threadIdx.x;
    lse_s[threadIdx.x] = r < rows ? lse[r] : -INFINITY;
    delta_s[threadIdx.x] = r < rows ? delta[r] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles (row stride D + 1), the dS tile, lse and delta
  return sizeof(float) *
         (size_t)(4 * kBlock * (D + 1) + kBlock * kLdS + 2 * kBlock);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles, the P^T and dS^T tiles, lse and delta
  return sizeof(float) *
         (size_t)(4 * kBlock * (D + 1) + 2 * kBlock * kLdS + 2 * kBlock);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int tq, int tk, int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // kBlock x kLd
  float* dos = qs + kBlock * kLd;  // kBlock x kLd
  float* ks = dos + kBlock * kLd;  // kBlock x kLd
  float* vs = ks + kBlock * kLd;   // kBlock x kLd
  float* dss = vs + kBlock * kLd;  // kBlock x kLdS
  float* lse_s = dss + kBlock * kLdS;
  float* delta_s = lse_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // heavy tiles first
  const T* kb = k + bh * (size_t)tk * D;
  const T* vb = v + bh * (size_t)tk * D;
  const int offset = tk - tq;

  load_tile<T, D>(qs, q + bh * (size_t)tq * D, q0, tq);
  load_tile<T, D>(dos, dout + bh * (size_t)tq * D, q0, tq);
  load_rows(lse_s, delta_s, lse + bh * (size_t)tq, delta + bh * (size_t)tq,
            q0, tq);
  __syncthreads();
  float lrow[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lrow[i] = lse_s[ty + 16 * i];
    drow[i] = delta_s[ty + 16 * i];
  }

  int n_tiles = (tk + kBlock - 1) / kBlock;
  if (causal) {
    const int k_last = min(q0 + kBlock, tq) - 1 + offset;
    n_tiles = k_last < 0 ? 0 : min(n_tiles, k_last / kBlock + 1);
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // the last tile's dS.K is done with ks and dss
    load_tile<T, D>(ks, kb, k0, tk);
    load_tile<T, D>(vs, vb, k0, tk);
    __syncthreads();

    // S and dP for rows ty + 16 i and columns tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * kLd + d];
        g[i] = dos[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[(tx + 16 * j) * kLd + d];
        c[j] = vs[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool keep = kpos < tk && isfinite(lrow[i]) &&
                          (!causal || kpos <= qpos + offset);
        const float p = keep ? expf(s[i][j] * scale - lrow[i]) : 0.f;
        dss[r * kLdS + c] = p * (dp[i][j] - drow[i]) * scale;
      }
    }
    __syncthreads();  // dS is complete

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty + 16 * i) * kLdS + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = ks[kk * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos < tq) {
      T* row = dq + (bh * (size_t)tq + qpos) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        row[tx + 16 * j] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int tq, int tk, int causal,
                      float scale) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                // kBlock x kLd, resident
  float* vs = ks + kBlock * kLd;   // kBlock x kLd, resident
  float* qs = vs + kBlock * kLd;   // kBlock x kLd, this q tile
  float* dos = qs + kBlock * kLd;  // kBlock x kLd, this q tile
  float* ps = dos + kBlock * kLd;  // kBlock x kLdS: P^T (k rows, q columns)
  float* dss = ps + kBlock * kLdS;  // kBlock x kLdS: dS^T
  float* lse_s = dss + kBlock * kLdS;
  float* delta_s = lse_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;  // early (heavy) k tiles first
  const T* qb = q + bh * (size_t)tq * D;
  const T* dob = dout + bh * (size_t)tq * D;
  const float* lseb = lse + bh * (size_t)tq;
  const float* deltab = delta + bh * (size_t)tq;
  const int offset = tk - tq;

  load_tile<T, D>(ks, k + bh * (size_t)tk * D, k0, tk);
  load_tile<T, D>(vs, v + bh * (size_t)tk * D, k0, tk);

  // causal: query i sees key j iff i >= j - offset, so the first q row that
  // sees any key of this tile is k0 - offset
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int n_q = (tq + kBlock - 1) / kBlock;
  const int t_first = q_first < tq ? q_first / kBlock : n_q;

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int t = t_first; t < n_q; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();  // the last tile's products are done with qs, dos, ps
    load_tile<T, D>(qs, qb, q0, tq);
    load_tile<T, D>(dos, dob, q0, tq);
    load_rows(lse_s, delta_s, lseb, deltab, q0, tq);
    __syncthreads();

    // S^T and dP^T for k rows ty + 16 i and q columns tx + 16 j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty + 16 * i) * kLd + d];
        c[i] = vs[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = qs[(tx + 16 * j) * kLd + d];
        g[j] = dos[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i], b[j], st[i][j]);
          dpt[i][j] = fmaf(c[i], g[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int qpos = q0 + c;
      const float l = lse_s[c], dl = delta_s[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int kpos = k0 + r;
        const bool keep = kpos < tk && isfinite(l) &&
                          (!causal || kpos <= qpos + offset);
        const float p = keep ? expf(st[i][j] * scale - l) : 0.f;
        ps[r * kLdS + c] = p;
        dss[r * kLdS + c] = p * (dpt[i][j] - dl) * scale;
      }
    }
    __syncthreads();  // P^T and dS^T are complete

#pragma unroll 4
    for (int qq = 0; qq < kBlock; ++qq) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ps[(ty + 16 * i) * kLdS + qq];
        ds[i] = dss[(ty + 16 * i) * kLdS + qq];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float gv = dos[qq * kLd + tx + 16 * j];
        const float qv = qs[qq * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(p[i], gv, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos < tk) {
      T* krow = dk + (bh * (size_t)tk + kpos) * D;
      T* vrow = dv + (bh * (size_t)tk + kpos) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        krow[tx + 16 * j] = from_float<T>(dk_acc[i][j]);
        vrow[tx + 16 * j] = from_float<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int tq, int tk, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tq == 0) return cudaSuccess;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  fa_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tk == 0) return cudaSuccess;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  fa_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_d(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int bh, int tq, int tk, int d, int causal,
                        float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_dq<T, 16>(q, k, v, dout, lse, delta, dq, bh, tq, tk,
                              causal, scale, stream);
    case 32:
      return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, tq, tk,
                              causal, scale, stream);
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk,
                              causal, scale, stream);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, tq, tk,
                               causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dkv_d(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int bh,
                         int tq, int tk, int d, int causal, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                               causal, scale, stream);
    case 32:
      return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                               causal, scale, stream);
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                               causal, scale, stream);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                tk, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Each returns the
// cudaError_t of its launch (0 on success); the kernel itself runs
// asynchronously on `stream`.  delta = rowsum(dO * O) in f32
// must already be computed on the same stream.
extern "C" int mxt_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int bh, int tq, int tk,
                                          int d, int dtype, int causal,
                                          float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dq_d<float>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                                causal, scale, s);
    case 1:
      return launch_dq_d<__half>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                                 causal, scale, s);
    case 2:
      return launch_dq_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, tq,
                                        tk, d, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int mxt_flash_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int bh, int tq,
                                           int tk, int d, int dtype,
                                           int causal, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dkv_d<float>(q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                 tk, d, causal, scale, s);
    case 1:
      return launch_dkv_d<__half>(q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                  tk, d, causal, scale, s);
    case 2:
      return launch_dkv_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                         bh, tq, tk, d, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
