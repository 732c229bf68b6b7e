// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ with plain C
// entry points (loaded with ctypes by mxnet_tpu_torch/_kernels.py).
//
// Replaces the two Pallas TPU kernels of mxnet_tpu/ops/flash_attention.py,
// launched by _fa_backward_pallas:
//   fa_bwd_dq_kernel                          <- _fa_bwd_dq_kernel  (dQ)
//   fa_bwd_dkv_mma_kernel, fa_bwd_dkv_kernel  <- _fa_bwd_dkv_kernel (dK, dV)
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
// Outputs in the input dtype; accumulation in f32.
//
// Each output tile is owned by exactly one thread block, as the TPU split
// has it, so there are no atomics and the gradients are the same bits from
// run to run.  Heavy tiles (late q tiles for dQ, early k tiles for dK/dV)
// start first.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// Llama-3-8B slice shape B1 H32 T2048 D128 causal bf16, dK/dV's four
// products come to 68.75 GFLOP (0.0695 ms) and dQ's three to 51.6 GFLOP
// (0.0521 ms), against 50-70 MB moved (0.02 ms) each: bound by operations
// (the f32 FMA pipes alone need 1.026 and 0.770 ms).
//
// dK/dV, bf16 and f16 (mxt_flash_attention_bwd_dkv_mma): tensor cores,
//   mma.sync (building blocks in flash_attention_mma.cuh).  One 128-thread
//   block (4 warps, 16 keys each) per (b*h, 64-row k tile); K and V stay in
//   padded shared memory; Q and dO tiles of 32 rows (D = 128) or 64 rows
//   (D <= 64) are double-buffered with cp.async, with each q tile's lse and
//   delta beside them.  The loop over q tiles starts at the first tile that
//   sees this k tile.  Keys are the rows of every product: S^T = K Q^T and
//   dP^T = V dO^T (Q and dO as ".col" B operands through ldmatrix) give
//   P^T = exp(S^T * scale - lse[col]) and dS^T = P^T (dP^T - delta[col])
//   * scale in the accumulator layout; rounded to the input dtype that
//   layout is the A operand of dV += P^T dO and dK += dS^T Q (dO and Q
//   through ldmatrix.trans), so neither goes through shared memory.  dK and
//   dV accumulate in f32 registers (16 x D a warp each).  Masks are applied
//   only on tiles that cross the causal diagonal or the Tk tail.  70 KB of
//   shared memory at D = 128, three blocks an SM.  What it still leaves:
//   wgmma and TMA, warp specialisation, the masked halves of diagonal
//   tiles, and S and dP computed again by the dQ kernel.
// dK/dV, f32 (mxt_flash_attention_bwd_dkv_fma): exact f32 on the FMA pipes.
//   One 256-thread block per (b*h, 64-row k tile), K and V resident, a
//   loop over 64-row q tiles; P^T and dS^T go through shared memory, dK and
//   dV accumulate in registers (166 KB of shared memory at D = 128).
// dQ, every dtype (mxt_flash_attention_bwd_dq, unchanged): one 256-thread
//   block per (b*h, 64-row q tile), a loop over 64-row k tiles that stops
//   at the last tile the causal mask reaches; Q, dO, K, V and dS as f32
//   tiles in shared memory (149 KB at D = 128), dQ in registers, on the f32
//   FMA pipes with synchronous loads: the next kernel to move to the
//   tensor cores.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "flash_attention_mma.cuh"

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int tq, int tk, int causal,
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
  const float* qb = q + bh * (size_t)tq * D;
  const float* dob = dout + bh * (size_t)tq * D;
  const float* lseb = lse + bh * (size_t)tq;
  const float* deltab = delta + bh * (size_t)tq;
  const int offset = tk - tq;

  load_tile<float, D>(ks, k + bh * (size_t)tk * D, k0, tk);
  load_tile<float, D>(vs, v + bh * (size_t)tk * D, k0, tk);

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
    load_tile<float, D>(qs, qb, q0, tq);
    load_tile<float, D>(dos, dob, q0, tq);
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
      float* krow = dk + (bh * (size_t)tk + kpos) * D;
      float* vrow = dv + (bh * (size_t)tk + kpos) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        krow[tx + 16 * j] = dk_acc[i][j];
        vrow[tx + 16 * j] = dv_acc[i][j];
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

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tk == 0) return cudaSuccess;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  fa_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), tq, tk, causal,
      scale);
  return cudaGetLastError();
}

// ---- dK/dV on the tensor cores (bf16, f16) ---------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 16 keys each
constexpr float kLog2e = 1.4426950408889634f;

// q rows a tile: 32 at D = 128 keeps dK, dV (64 + 64 registers a thread),
// S^T and dP^T (16 + 16) in registers without spills (236 registers; 64
// rows measured 10% faster in bf16 but needs all 255, with no room left
// for the f16 row scaling)
template <int D>
__host__ __device__ constexpr int dkv_mma_block_q() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K and V tiles, two Q and two dO tiles (rows padded by 16 bytes), then
  // two buffers of -lse * log2(e) and of delta
  return 2 * (size_t)(2 * kBlock + 4 * dkv_mma_block_q<D>()) *
             (D + mxt_mma::kPad) +
         sizeof(float) * 4 * dkv_mma_block_q<D>();
}

// -lse * log2(e) (-inf for rows that see no key or lie past the end) and
// delta of rows [row0, row0 + ROWS)
template <int ROWS>
__device__ __forceinline__ void load_rows_log2(float* nlse_s, float* delta_s,
                                               const float* lse,
                                               const float* delta, int row0,
                                               int rows) {
  for (int i = threadIdx.x; i < ROWS; i += kMmaThreads) {
    const int r = row0 + i;
    const float l = r < rows ? lse[r] : -INFINITY;
    nlse_s[i] = isfinite(l) ? -l * kLog2e : -INFINITY;
    delta_s[i] = r < rows ? delta[r] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    fa_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int tq,
                          int tk, int causal, float scale) {
  using namespace mxt_mma;
  constexpr int kBq = dkv_mma_block_q<D>();
  constexpr int kLd = D + kPad;
  constexpr int kDK = D / 16;  // k16 steps over D
  constexpr int kDN = D / 8;   // n8 tiles over D
  constexpr int kQN = kBq / 8;  // n8 tiles over a q tile
  constexpr int kQTile = kBq * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // kBlock x kLd, resident
  T* vs = ks + kBlock * kLd;               // kBlock x kLd, resident
  T* qs = vs + kBlock * kLd;               // 2 x kQTile
  T* dos = qs + 2 * kQTile;                // 2 x kQTile
  float* nlse_s = reinterpret_cast<float*>(dos + 2 * kQTile);  // 2 x kBq
  float* delta_s = nlse_s + 2 * kBq;                           // 2 x kBq

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_col = 2 * (lane & 3);
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;  // early (heavy) k tiles first
  const T* qb = q + bh * (size_t)tq * D;
  const T* dob = dout + bh * (size_t)tq * D;
  const float* lseb = lse + bh * (size_t)tq;
  const float* deltab = delta + bh * (size_t)tq;
  const int offset = tk - tq;
  const int key_a = k0 + warp * 16 + (lane >> 2);  // and key_a + 8

  // causal: query i sees key j iff i >= j - offset, so the first q row that
  // sees any key of this tile is k0 - offset
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int n_q = (tq + kBq - 1) / kBq;
  const int t_first = q_first < tq ? q_first / kBq : n_q;

  if (t_first < n_q) {
    cp_async_tile<kBlock, D, kMmaThreads>(ks, k + bh * (size_t)tk * D, k0,
                                          tk);
    cp_async_tile<kBlock, D, kMmaThreads>(vs, v + bh * (size_t)tk * D, k0,
                                          tk);
    cp_async_tile<kBq, D, kMmaThreads>(qs, qb, t_first * kBq, tq);
    cp_async_tile<kBq, D, kMmaThreads>(dos, dob, t_first * kBq, tq);
    load_rows_log2<kBq>(nlse_s, delta_s, lseb, deltab, t_first * kBq, tq);
  }
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  // f16: per-row powers of two for P^T and dS^T (f16_row_scale)
  constexpr bool kF16 = std::is_same<T, __half>::value;
  int e_p[2] = {kRowScaleMax, kRowScaleMax};
  int e_ds[2] = {kRowScaleMax, kRowScaleMax};
  float dk_acc[kDN][4], dv_acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int t = t_first; t < n_q; ++t) {
    const int q0 = t * kBq;
    const int buf = (t - t_first) & 1;
    if (t + 1 < n_q) {  // the next q tile loads while this one computes
      const int nb = buf ^ 1;
      cp_async_tile<kBq, D, kMmaThreads>(qs + nb * kQTile, qb, q0 + kBq, tq);
      cp_async_tile<kBq, D, kMmaThreads>(dos + nb * kQTile, dob, q0 + kBq,
                                         tq);
      load_rows_log2<kBq>(nlse_s + nb * kBq, delta_s + nb * kBq, lseb,
                          deltab, q0 + kBq, tq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group (and K's, V's) has landed
    __syncthreads();
    const T* qt = qs + buf * kQTile;
    const T* dot = dos + buf * kQTile;
    const float* nl = nlse_s + buf * kBq;
    const float* dl = delta_s + buf * kBq;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    float st[kQN][4], dpt[kQN][4];
#pragma unroll
    for (int j = 0; j < kQN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, frag_a<kLd>(ks, warp * 16, kk * 16, lane));
      ldmatrix_x4(va, frag_a<kLd>(vs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < kQN / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, frag_b<kLd>(qt, np * 16, kk * 16, lane));
        mma_16816<T>(st[2 * np], ka, b[0], b[1]);
        mma_16816<T>(st[2 * np + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, frag_b<kLd>(dot, np * 16, kk * 16, lane));
        mma_16816<T>(dpt[2 * np], va, b[0], b[1]);
        mma_16816<T>(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }

    // P^T and dS^T in place; only tiles on the causal diagonal or the Tk
    // tail hold masked pairs
    const bool edge =
        k0 + kBlock > tk || (causal && k0 + kBlock - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < kQN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + quad_col + (e & 1);
        float p = exp2f(fmaf(st[j][e], scale_log2, nl[col]));
        if (edge) {
          const int key = key_a + (e >> 1) * 8;
          if (key >= tk || (causal && key > q0 + col + offset)) p = 0.f;
        }
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl[col]) * scale;
      }
    if constexpr (kF16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f16_row_scale(st, dv_acc, e_p[h], h);
        f16_row_scale(dpt, dk_acc, e_ds[h], h);
      }
    }

    // dV += P^T dO, dK += dS^T Q, both A operands rounded to T in registers
#pragma unroll
    for (int j = 0; j < kBq / 16; ++j) {
      uint32_t ap[4], ads[4];
      acc_to_a<T>(ap, st[2 * j], st[2 * j + 1]);
      acc_to_a<T>(ads, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, frag_a<kLd>(dot, j * 16, dp * 16, lane));
        mma_16816<T>(dv_acc[2 * dp], ap, b[0], b[1]);
        mma_16816<T>(dv_acc[2 * dp + 1], ap, b[2], b[3]);
        ldmatrix_x4_trans(b, frag_a<kLd>(qt, j * 16, dp * 16, lane));
        mma_16816<T>(dk_acc[2 * dp], ads, b[0], b[1]);
        mma_16816<T>(dk_acc[2 * dp + 1], ads, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_a + 8 * h;
    if (key < tk) {
      T* krow = dk + (bh * (size_t)tk + key) * D + quad_col;
      T* vrow = dv + (bh * (size_t)tk + key) * D + quad_col;
      const float fk = kF16 ? pow2(-e_ds[h]) : 1.f;
      const float fv = kF16 ? pow2(-e_p[h]) : 1.f;
#pragma unroll
      for (int j = 0; j < kDN; ++j) {
        *reinterpret_cast<uint32_t*>(krow + j * 8) =
            pack2<T>(dk_acc[j][2 * h] * fk, dk_acc[j][2 * h + 1] * fk);
        *reinterpret_cast<uint32_t*>(vrow + j * 8) =
            pack2<T>(dv_acc[j][2 * h] * fv, dv_acc[j][2 * h + 1] * fv);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int tq, int tk, int causal, float scale,
                           cudaStream_t stream) {
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_mma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tk == 0) return cudaSuccess;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  fa_bwd_dkv_mma_kernel<T, D><<<grid, kMmaThreads, smem, stream>>>(
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
cudaError_t launch_dkv_mma_d(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, int causal, float scale,
                             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_dkv_mma<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                   tk, causal, scale, stream);
    case 32:
      return launch_dkv_mma<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                   tk, causal, scale, stream);
    case 64:
      return launch_dkv_mma<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq,
                                   tk, causal, scale, stream);
    case 128:
      return launch_dkv_mma<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                    tq, tk, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Each returns the
// cudaError_t of its launch (0 on success; cudaErrorInvalidValue for a
// dtype or D the kernel does not take); the kernel itself runs
// asynchronously on `stream`.  delta = rowsum(dO * O) in f32 must already
// be computed on the same stream.  The tensor-core dK/dV needs 16-byte
// aligned q, k, v and dO.
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

extern "C" int mxt_flash_attention_bwd_dkv_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int d, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_dkv_mma_d<__half>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      tq, tk, d, causal, scale, s);
    case 2:
      return launch_dkv_mma_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk,
                                             dv, bh, tq, tk, d, causal,
                                             scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int mxt_flash_attention_bwd_dkv_fma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int d, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                             causal, scale, s);
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                             causal, scale, s);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                             causal, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                             causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
