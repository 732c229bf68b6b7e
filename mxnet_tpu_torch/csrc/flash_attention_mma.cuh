// Tensor-core building blocks shared by the flash-attention kernels of
// flash_attention_fwd.cu (forward) and flash_attention_bwd.cu (dQ, dK/dV),
// and by the fused 1x1 conv+BN+ReLU product of fused_matmul_affine_relu.cu.
//
// The flash kernels replace Pallas TPU kernels of
// mxnet_tpu/ops/flash_attention.py (_fa_kernel, _fa_bwd_dq_kernel and
// _fa_bwd_dkv_kernel) for bf16 and f16 inputs, the fused product the one of
// tools/pallas_conv_probe.py (fused_matmul_affine_relu) for bf16; their
// source notes give the bounds.  What this header holds, each an inline PTX wrapper
// or a plain device function (sm_80-era instructions, valid for sm_90a, no
// CUTLASS):
//   - cp.async.cg of 16 bytes from global to shared memory, with the
//     src-size operand set to 0 for rows past the end of a matrix, so that
//     they are zero-filled and never read; commit_group and wait_group<N>;
//   - ldmatrix.x4 (four 8x8 b16 matrices) and its .trans form;
//   - mma.sync m16n8k16 with bf16 or f16 operands and f32 accumulators;
//   - packing two f32 values into one bf16x2 / half2 register;
//   - quad reductions: on an m16n8 accumulator a row lives on the four
//     lanes of a quad, so its max and sum are two xor shuffles;
//   - tiles in shared memory with rows padded by 16 bytes: an unpadded row
//     of 2*D bytes puts the eight row addresses of an ldmatrix on one bank
//     group (8-way conflicts); D + 8 elements a row spreads them over all
//     32 banks for D in {16, 32, 64, 128}.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..),
//                           a2 = (g, 2c+8..), a3 = (g+8, 2c+8..);
//   B (16 x 8, "col"):      b0 = (k 2c..2c+1, n g), b1 = (k 2c+8.., n g);
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

constexpr int kPad = 8;  // elements of padding a shared-memory row (16 bytes)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when !valid nothing is read and the 16 bytes
// are zero-filled (src-size 0)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of a row-major (rows, D) matrix of a 16-bit type
// into shared memory with row stride D + kPad; rows past `rows` are zeros.
template <int ROWS, int D, int THREADS, typename T>
__device__ __forceinline__ void cp_async_tile(T* dst, const T* src, int row0,
                                              int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + THREADS - 1) / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (kTotal % THREADS != 0 && c >= kTotal) break;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < rows;
    cp_async_16(dst + r * (D + kPad) + col,
                src + (size_t)(valid ? gr : 0) * D + col, valid);
  }
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds row l / 4, columns 2(l % 4)..+1 of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same with each matrix transposed: register i of lane l holds rows
// 2(l % 4)..+1 of column l / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Address a lane gives ldmatrix_x4 for the A fragment of the 16x16 tile at
// (row0, col0) of a row-major tile with row stride LD; with
// ldmatrix_x4_trans on a row-major (k, n) tile the same address gives the B
// fragments of n8 tiles col0 (registers 0, 1) and col0 + 8 (2, 3).
template <int LD, typename T>
__device__ __forceinline__ const T* frag_a(const T* tile, int row0, int col0,
                                           int lane) {
  return tile + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8;
}

// Address a lane gives ldmatrix_x4 for the B fragments of n8 tiles row0
// (registers 0, 1) and row0 + 8 (2, 3), k16 step col0, of a (n, k)
// row-major tile: B(k, n) = tile[n][k], the ".col" operand.
template <int LD, typename T>
__device__ __forceinline__ const T* frag_b(const T* tile, int row0, int col0,
                                           int lane) {
  return tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * LD + col0 +
         ((lane >> 3) & 1) * 8;
}

// c += a * b on the tensor cores: 16x16 by 16x8, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
