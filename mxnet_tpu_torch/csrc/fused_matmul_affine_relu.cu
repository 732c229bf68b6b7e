// Fused 1x1-convolution product + folded BatchNorm + ReLU for NVIDIA Hopper
// (sm_90a), CUDA C++ with a plain C entry point (loaded with ctypes by
// mxnet_tpu_torch/_kernels.py).
//
// Replaces: the Pallas TPU kernel tools/pallas_conv_probe.py::
// fused_matmul_affine_relu.  It computes the same function, not the same
// blocking:
//   out[m, n] = relu(scale[n] * sum_k x[m, k] * w[k, n] + bias[n])
// with the sum accumulated in f32, the affine and the ReLU applied to the
// f32 accumulator, and one rounding to the output dtype before the one store.
// Inputs: x (M, K) row-major, w (K, N) row-major, both bf16 or both f32;
// scale and bias (N,) f32; out (M, N) in x's dtype.  Any M, N, K: ragged
// tails are masked here (the TPU kernel needed M, N, K to divide its
// 512/256/256 blocks).  bf16 operands are widened to f32 exactly, so each
// product is the exact product of the bf16 values, as on the TPU's MXU.  f32
// operands stay f32 (the TPU kernel rounds them to bf16 first; the port does
// not, so that an f32 model equals the JAX package's f32 XLA convolution).
//
// Design: one 256-thread block per 128 x 64 output tile, which it alone
// writes (no atomics: the same bits from run to run).  The TPU kernel's
// sequential K grid axis becomes a loop inside the block over 16-wide K
// chunks; each chunk of x (stored transposed, K-major) and of w is staged in
// shared memory as f32, and each thread keeps an 8 x 4 slice of the tile's
// accumulator in registers, reading its operands as float4.  The epilogue
// multiplies by scale, adds bias, clamps at 0 (NaN passes, as in torch.relu)
// and stores each row's 64 columns contiguously.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// ResNet-50 v1 shapes (B = 128, 224 x 224; K, N = 64 .. 2048) the function
// moves 20-257 MB and does 3.3-13.2 GFLOP a launch, so six of its eight
// shapes are bound by bytes and the two deepest by operations; the 16
// launches of a forward come to about 0.46 ms at the bound.  What this
// simple design leaves: the products run on the f32 FMA pipes (67 TFLOP/s
// peak), not on the tensor cores (mma.sync / wgmma), so every shape here is
// bound by the FMA rate instead; the chunks are loaded synchronously with
// scalar loads (no cp.async or TMA double buffering).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBM = 128;            // tile rows (M)
constexpr int kBN = 64;             // tile columns (N)
constexpr int kBK = 16;             // K chunk
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kTM = 8;              // accumulator rows per thread
constexpr int kTN = 4;              // accumulator columns per thread
constexpr int kLdA = kBM + 4;       // padded row stride of the x chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_mm_affine_relu_kernel(const T* __restrict__ x,
                                const T* __restrict__ w,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                T* __restrict__ out, int m, int n, int k) {
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
      as[c * kLdA + r] =
          (gm < m && gk < k) ? to_float(x[(size_t)gm * k + gk]) : 0.f;
    }
    // w[k0 .. k0 + 16, n0 .. n0 + 64): one row's 64 values per 64 threads
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r * kBN + c] =
          (gk < k && gn < n) ? to_float(w[(size_t)gk * n + gn]) : 0.f;
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
    T* orow = out + (size_t)gm * n;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < n) {
        // two roundings (product, then sum), as the plain version's
        // (acc * scale) + bias; "y < 0 ? 0 : y" keeps NaN, as torch.relu
        const float y = __fadd_rn(__fmul_rn(acc[i][j], s[j]), bv[j]);
        orow[gn] = from_float<T>(y < 0.f ? 0.f : y);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* bias, void* out, int m, int n, int k,
                   cudaStream_t stream) {
  if (m == 0 || n == 0) return cudaSuccess;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  fused_mm_affine_relu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 2 = bfloat16 (the codes of the other kernels; float16
// is not taken).  Returns the cudaError_t of the launch (0 on success); the
// kernel itself runs asynchronously on `stream`.
extern "C" int mxt_fused_matmul_affine_relu(const void* x, const void* w,
                                            const void* scale,
                                            const void* bias, void* out,
                                            int m, int n, int k, int dtype,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 0 || n < 0 || k < 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, w, scale, bias, out, m, n, k, s);
    case 2:
      return launch<__nv_bfloat16>(x, w, scale, bias, out, m, n, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
