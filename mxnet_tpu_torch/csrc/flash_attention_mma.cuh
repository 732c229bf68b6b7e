// Tensor-core building blocks shared by the flash-attention kernels of
// flash_attention_fwd.cu (forward) and flash_attention_bwd.cu (dQ, dK/dV),
// and by the fused 1x1 conv+BN+ReLU product of fused_matmul_affine_relu.cu.
//
// The flash kernels replace Pallas TPU kernels of
// mxnet_tpu/ops/flash_attention.py (_fa_kernel, _fa_bwd_dq_kernel and
// _fa_bwd_dkv_kernel) for bf16 and f16 inputs, the fused product the one of
// tools/pallas_conv_probe.py (fused_matmul_affine_relu) for bf16 and f16;
// their source notes give the bounds.  All of them run on wgmma
// (flash_attention_sm90.cuh), whose accumulators hold mma.m16n8k16's C
// fragment per n8 tile and whose A operand from registers takes its A
// fragment.  What this header holds, each a plain device function:
//   - packing two f32 values into one bf16x2 / half2 register, and the A
//     fragment of a k16 step from two n8 tiles' accumulators;
//   - quad reductions: on an m16n8 accumulator a row lives on the four
//     lanes of a quad, so its max and sum are two xor shuffles;
//   - f16_row_scale, which keeps f16 operands' relative precision.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..),
//                           a2 = (g, 2c+8..), a3 = (g+8, 2c+8..);
//   C (16 x 8, f32):        c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, 2c..).
// So the accumulators of two adjacent n8 tiles, rounded and packed, are the
// A fragment of one k16 step: a probability tile computed by one product
// feeds the next product without going through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace mxt_mma {

// (lo, hi) rounded to the nearest T, lo in the low 16 bits
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// The A fragment of k16 step j from the accumulators of n8 tiles 2j, 2j+1
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// f16 keeps 11 significant bits only down to 2^-14 (6.1e-5); below that its
// step is a fixed 2^-24.  Probabilities and dS values can be far smaller,
// and a row of them rounded to f16 as it is would lose its relative
// precision.  Before rounding, f16_row_scale multiplies row h of x (values
// 2h, 2h + 1 of each n8 tile: the row a quad holds) by 2^e, the largest
// power of two that has kept every tile of that row so far below 2^14;
// when a tile needs a smaller e, the row's f32 accumulator, which holds the
// earlier tiles times 2^e, is rescaled (exactly: a power of two).  The
// caller starts e at kRowScaleMax and multiplies the accumulator by
// pow2(-e) at the end.  bf16 has f32's exponent range and needs none of it.
constexpr int kRowScaleMax = 100;

__device__ __forceinline__ float pow2(int e) {  // exact for -126 <= e <= 127
  return __int_as_float((127 + e) << 23);
}

template <int N, int M>
__device__ __forceinline__ void f16_row_scale(float (&x)[N][4],
                                              float (&acc)[M][4], int& e,
                                              int h) {
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    mx = fmaxf(mx, fmaxf(fabsf(x[j][2 * h]), fabsf(x[j][2 * h + 1])));
  mx = quad_max(mx);
  if (mx > 0.f) {
    int ex;
    frexpf(mx, &ex);  // mx < 2^ex
    const int e_new = 14 - ex;
    if (e_new < e) {  // e_new - e >= 14 - 128 - kRowScaleMax = -214
      const int d1 = max(e_new - e, -126);
      const float f1 = pow2(d1), f2 = pow2(e_new - e - d1);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        acc[j][2 * h] = acc[j][2 * h] * f1 * f2;
        acc[j][2 * h + 1] = acc[j][2 * h + 1] * f1 * f2;
      }
      e = e_new;
    }
  }
  const float f = pow2(e);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j][2 * h] *= f;
    x[j][2 * h + 1] *= f;
  }
}

}  // namespace mxt_mma
