// Fused 1x1-convolution product + folded BatchNorm + ReLU for NVIDIA Hopper
// (sm_90a), CUDA C++ with plain C entry points (loaded with ctypes by
// mxnet_tpu_torch/_kernels.py).
//
// Replaces: the Pallas TPU kernel tools/pallas_conv_probe.py::
// fused_matmul_affine_relu.  It computes the same function, not the same
// blocking:
//   out[m, n] = relu(scale[n] * sum_k x[m, k] * w[k, n] + bias[n])
// with the sum accumulated in f32, the affine and the ReLU applied to the
// f32 accumulator, and one rounding to the output dtype before the one store.
// Inputs: x (M, K) row-major, w (K, N) row-major, both bf16, both f16 or
// both f32; scale and bias (N,) f32; out (M, N) in x's dtype.  Any M, N, K:
// ragged tails are masked here (the TPU kernel needed M, N, K to divide its
// 512/256/256 blocks).  bf16 and f16 products are exact products of the
// 16-bit values, summed in f32, as on the TPU's MXU (which takes bf16).
// f32 operands stay f32 (the TPU kernel rounds them to bf16 first; the
// port does not, so that an f32 model equals the JAX package's f32 XLA
// convolution).
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// ResNet-50 v1 shapes (B = 128, 224 x 224; K, N = 64 .. 2048) the function
// moves 20-257 MB and does 3.3-13.2 GFLOP a launch, so six of its eight
// shapes are bound by bytes and the two deepest by operations; the 16
// launches of a forward come to about 0.46 ms at the bound, a third of it
// in the two shapes with M = 401,408 and N = 64.
//
// Two designs, chosen by the caller (ops/conv_bn_relu.py) by dtype:
//
// mxt_fused_matmul_affine_relu_mma (bf16, f16): tensor cores, mma.sync
//   (building blocks in flash_attention_mma.cuh).  What bounds most shapes
//   is bytes, so the design reads x from device memory once and keeps loads in
//   flight.  One 256-thread block (8 warps: 4 over M, 2 over N, each 32
//   rows) per 128-row M tile and N tile of 64 (N <= 64) or 128 columns; a
//   block's N tile covers all of N when N <= 128, and the N tiles of one M
//   tile are neighbours in launch order, so they find x's rows in L2 (w,
//   at most 2 MB, stays there).  K is walked in 32-wide steps through a
//   4-stage cp.async ring of 16-byte loads (rows past M and K zero-filled),
//   three steps in flight while one computes (76 KB of shared memory at N
//   tile 128).  x tiles are A operands through ldmatrix, w tiles, (k, n)
//   row-major, B operands through ldmatrix.trans; mma.m16n8k16 with f32
//   accumulators, 32 x 64 (or 32 x 32) a warp.  The epilogue applies the
//   affine and the ReLU to the accumulators in registers, rounds to the
//   16-bit output dtype once, stages the tile in shared memory and writes
//   each row with 16-byte stores.  No atomics, no split over K: the same
//   bits from run to run.  A K or N that is not a multiple of 8, or an
//   operand that is not 16-byte aligned, loads and stores element by
//   element instead (zeros past the edges): the same kernel, a template
//   flag the entry point sets.  bf16 and f16 are two instances of one
//   template (the header's mma_16816 and pack2 take either type).
//   What it still leaves: wgmma and TMA, and reading NCHW directly instead
//   of the caller's (M, K) copy.
//
// mxt_fused_matmul_affine_relu_fma (f32): exact f32 on the FMA pipes (TF32
//   would change f32 users' results).  One 256-thread block per 128 x 64
//   output tile; a loop over 16-wide K chunks, each chunk of x (stored
//   transposed, K-major) and of w staged in shared memory, each thread an
//   8 x 4 slice of the accumulator in registers, read as float4; scalar
//   synchronous loads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_attention_mma.cuh"

namespace {

// ---- tensor-core design (bf16, f16) ----------------------------------------

using bf16 = __nv_bfloat16;
using f16 = __half;

template <typename T>
__device__ __forceinline__ T zero16();
template <>
__device__ __forceinline__ bf16 zero16<bf16>() {
  return __float2bfloat16_rn(0.f);
}
template <>
__device__ __forceinline__ f16 zero16<f16>() {
  return __float2half_rn(0.f);
}

constexpr int kMmaThreads = 256;  // 8 warps: 4 over M, 2 over N
constexpr int kMmaBM = 128;       // tile rows (M)
constexpr int kMmaBK = 32;        // K step
constexpr int kStages = 4;        // depth of the cp.async ring
constexpr int kLdX = kMmaBK + mxt_mma::kPad;  // x tile row stride (80 bytes)

template <int BN>
constexpr size_t mma_smem_bytes() {
  // kStages x (x tile + w tile), rows padded by 16 bytes; the epilogue's
  // output tile reuses the ring
  return 2 * (size_t)kStages *  // 2 bytes an element (bf16, f16)
         (kMmaBM * kLdX + kMmaBK * (BN + mxt_mma::kPad));
}

// K step k0 of x (rows m0 .. m0 + 128) and of w (columns n0 .. n0 + BN)
// into one stage of the ring; zeros past M, N and K.
template <typename T, int BN, bool kAligned>
__device__ __forceinline__ void load_stage(T* xs, T* ws,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           int m0, int n0, int k0, int m,
                                           int n, int k) {
  using namespace mxt_mma;
  constexpr int kLdW = BN + kPad;
  if constexpr (kAligned) {  // 16-byte chunks, each wholly in or out
    constexpr int kXChunks = kMmaBK / 8;
#pragma unroll
    for (int i = 0; i < kMmaBM * kXChunks / kMmaThreads; ++i) {
      const int c = threadIdx.x + i * kMmaThreads;
      const int r = c / kXChunks, col = (c % kXChunks) * 8;
      const int gm = m0 + r, gk = k0 + col;
      const bool valid = gm < m && gk < k;
      cp_async_16(xs + r * kLdX + col, x + (valid ? (size_t)gm * k + gk : 0),
                  valid);
    }
    constexpr int kWChunks = BN / 8;
#pragma unroll
    for (int i = 0; i < kMmaBK * kWChunks / kMmaThreads; ++i) {
      const int c = threadIdx.x + i * kMmaThreads;
      const int r = c / kWChunks, col = (c % kWChunks) * 8;
      const int gk = k0 + r, gn = n0 + col;
      const bool valid = gk < k && gn < n;
      cp_async_16(ws + r * kLdW + col, w + (valid ? (size_t)gk * n + gn : 0),
                  valid);
    }
  } else {  // element by element, synchronous
    const T zero = zero16<T>();
    for (int e = threadIdx.x; e < kMmaBM * kMmaBK; e += kMmaThreads) {
      const int r = e / kMmaBK, col = e % kMmaBK;
      const int gm = m0 + r, gk = k0 + col;
      xs[r * kLdX + col] = gm < m && gk < k ? x[(size_t)gm * k + gk] : zero;
    }
    for (int e = threadIdx.x; e < kMmaBK * BN; e += kMmaThreads) {
      const int r = e / BN, col = e % BN;
      const int gk = k0 + r, gn = n0 + col;
      ws[r * kLdW + col] = gk < k && gn < n ? w[(size_t)gk * n + gn] : zero;
    }
  }
}

template <typename T, int BN, bool kAligned>
__global__ void __launch_bounds__(kMmaThreads)
    fused_mm_affine_relu_mma_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    T* __restrict__ out, int m, int n,
                                    int k) {
  using namespace mxt_mma;
  constexpr int kLdW = BN + kPad;
  constexpr int kLdO = BN + kPad;  // output tile row stride
  constexpr int kWN = BN / 2;      // columns of a warp's tile
  constexpr int kMT = 2;           // m16 tiles of a warp (32 rows)
  constexpr int kNT = kWN / 8;     // n8 tiles of a warp
  constexpr int kXTile = kMmaBM * kLdX;
  constexpr int kWTile = kMmaBK * kLdW;
  static_assert(kMmaBM * kLdO <= kStages * (kXTile + kWTile),
                "the output tile must fit in the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // kStages x kXTile
  T* ws = xs + kStages * kXTile;           // kStages x kWTile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;  // rows wm * 32, columns wn * kWN
  // the N tiles of one M tile are neighbours in launch order
  const int n_tiles = (n + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * kMmaBM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int n_k = (k + kMmaBK - 1) / kMmaBK;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      load_stage<T, BN, kAligned>(xs + s * kXTile, ws + s * kWTile, x, w, m0,
                               n0, s * kMmaBK, m, n, k);
    cp_async_commit();
  }
  for (int t = 0; t < n_k; ++t) {
    cp_async_wait<kStages - 2>();  // step t's group has landed
    __syncthreads();  // for every thread; and all are done with step t - 1
    const int next = t + kStages - 1;  // into step t - 1's slot
    if (next < n_k)
      load_stage<T, BN, kAligned>(xs + (next % kStages) * kXTile,
                               ws + (next % kStages) * kWTile, x, w, m0, n0,
                               next * kMmaBK, m, n, k);
    cp_async_commit();
    const T* xt = xs + (t % kStages) * kXTile;
    const T* wt = ws + (t % kStages) * kWTile;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(a[i], frag_a<kLdX>(xt, wm * 32 + i * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b,
                          frag_a<kLdW>(wt, kk * 16, wn * kWN + np * 16, lane));
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma_16816<T>(acc[i][2 * np], a[i], b[0], b[1]);
          mma_16816<T>(acc[i][2 * np + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // relu(scale * acc + bias) rounded to T into the output tile; two
  // roundings (product, then sum), as the plain version's (acc * scale) +
  // bias; "y < 0 ? 0 : y" keeps NaN, as torch.relu
  T* os = xs;  // kMmaBM x kLdO
  const int g = lane >> 2, quad_col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = wn * kWN + j * 8 + quad_col;  // and col + 1
    float sc[2], bi[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gn = n0 + col + c;
      sc[c] = gn < n ? scale[gn] : 0.f;
      bi[c] = gn < n ? bias[gn] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + i * 16 + g + 8 * h;
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          y[c] = __fadd_rn(__fmul_rn(acc[i][j][2 * h + c], sc[c]), bi[c]);
          y[c] = y[c] < 0.f ? 0.f : y[c];
        }
        *reinterpret_cast<uint32_t*>(os + row * kLdO + col) =
            pack2<T>(y[0], y[1]);
      }
  }
  __syncthreads();
  if constexpr (kAligned) {  // 16-byte stores, a row's chunks side by side
    constexpr int kChunks = BN / 8;
    for (int c = threadIdx.x; c < kMmaBM * kChunks; c += kMmaThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int gm = m0 + r, gn = n0 + col;
      if (gm < m && gn < n)
        *reinterpret_cast<uint4*>(out + (size_t)gm * n + gn) =
            *reinterpret_cast<const uint4*>(os + r * kLdO + col);
    }
  } else {
    for (int e = threadIdx.x; e < kMmaBM * BN; e += kMmaThreads) {
      const int r = e / BN, col = e % BN;
      const int gm = m0 + r, gn = n0 + col;
      if (gm < m && gn < n) out[(size_t)gm * n + gn] = os[r * kLdO + col];
    }
  }
}

template <typename T, int BN, bool kAligned>
cudaError_t launch_mma_tile(const void* x, const void* w, const void* scale,
                            const void* bias, void* out, int m, int n, int k,
                            cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<BN>();
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t err = cudaFuncSetAttribute(
      fused_mm_affine_relu_mma_kernel<T, BN, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((m + kMmaBM - 1) / kMmaBM) * ((n + BN - 1) / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  fused_mm_affine_relu_mma_kernel<T, BN, kAligned>
      <<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<T*>(out), m, n, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma(const void* x, const void* w, const void* scale,
                       const void* bias, void* out, int m, int n, int k,
                       cudaStream_t stream) {
  if (m == 0 || n == 0) return cudaSuccess;
  const bool aligned = k % 8 == 0 && n % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (n <= 64)
    return aligned ? launch_mma_tile<T, 64, true>(x, w, scale, bias, out, m,
                                                  n, k, stream)
                   : launch_mma_tile<T, 64, false>(x, w, scale, bias, out, m,
                                                   n, k, stream);
  return aligned ? launch_mma_tile<T, 128, true>(x, w, scale, bias, out, m, n,
                                                 k, stream)
                 : launch_mma_tile<T, 128, false>(x, w, scale, bias, out, m,
                                                  n, k, stream);
}

// ---- f32 FMA design --------------------------------------------------------

constexpr int kBM = 128;            // tile rows (M)
constexpr int kBN = 64;             // tile columns (N)
constexpr int kBK = 16;             // K chunk
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kTM = 8;              // accumulator rows per thread
constexpr int kTN = 4;              // accumulator columns per thread
constexpr int kLdA = kBM + 4;       // padded row stride of the x chunk

__global__ void __launch_bounds__(kThreads)
    fused_mm_affine_relu_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                float* __restrict__ out, int m, int n,
                                int k) {
  __shared__ __align__(16) float as[kBK * kLdA];  // x chunk, K-major
  __shared__ __align__(16) float bs[kBK * kBN];   // w chunk
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x[m0 .. m0 + 128, k0 .. k0 + 16): 16 neighbouring threads read one
    // row's 16 neighbouring values; zeros past the ragged edges
#pragma unroll
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int gm = m0 + r, gk = k0 + c;
      as[c * kLdA + r] = (gm < m && gk < k) ? x[(size_t)gm * k + gk] : 0.f;
    }
    // w[k0 .. k0 + 16, n0 .. n0 + 64): one row's 64 values per 64 threads
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r * kBN + c] = (gk < k && gn < n) ? w[(size_t)gk * n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&as[kk * kLdA + ty * kTM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[kk * kLdA + ty * kTM + 4]);
      const float4 b4 =
          *reinterpret_cast<const float4*>(&bs[kk * kBN + tx * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every thread is done with this chunk
  }

  float s[kTN], bv[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int gn = n0 + tx * kTN + j;
    s[j] = gn < n ? scale[gn] : 0.f;
    bv[j] = gn < n ? bias[gn] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= m) continue;
    float* orow = out + (size_t)gm * n;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < n) {
        // two roundings (product, then sum), as the plain version's
        // (acc * scale) + bias; "y < 0 ? 0 : y" keeps NaN, as torch.relu
        const float y = __fadd_rn(__fmul_rn(acc[i][j], s[j]), bv[j]);
        orow[gn] = y < 0.f ? 0.f : y;
      }
    }
  }
}

cudaError_t launch_fma(const void* x, const void* w, const void* scale,
                       const void* bias, void* out, int m, int n, int k,
                       cudaStream_t stream) {
  if (m == 0 || n == 0) return cudaSuccess;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  fused_mm_affine_relu_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (the codes of the other
// kernels): _mma takes bf16 and f16, _fma f32 only.  Each returns the
// cudaError_t of its launch (0 on success; cudaErrorInvalidValue for a
// dtype the design does not take); the kernel itself runs asynchronously
// on `stream`.
extern "C" int mxt_fused_matmul_affine_relu_mma(const void* x, const void* w,
                                                const void* scale,
                                                const void* bias, void* out,
                                                int m, int n, int k,
                                                int dtype, void* stream) {
  if (m < 0 || n < 0 || k < 0 || (dtype != 1 && dtype != 2))
    return cudaErrorInvalidValue;
  return dtype == 2 ? launch_mma<bf16>(x, w, scale, bias, out, m, n, k,
                                       static_cast<cudaStream_t>(stream))
                    : launch_mma<f16>(x, w, scale, bias, out, m, n, k,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int mxt_fused_matmul_affine_relu_fma(const void* x, const void* w,
                                                const void* scale,
                                                const void* bias, void* out,
                                                int m, int n, int k,
                                                int dtype, void* stream) {
  if (m < 0 || n < 0 || k < 0 || dtype != 0) return cudaErrorInvalidValue;
  return launch_fma(x, w, scale, bias, out, m, n, k,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
