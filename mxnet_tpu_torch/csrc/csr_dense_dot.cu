// CSR x dense product for NVIDIA Hopper (sm_90a), CUDA C++ with a plain C
// entry point (loaded with ctypes by mxnet_tpu_torch/_kernels.py).
//
// Replaces no Pallas kernel: the reference's CSR product is XLA's BCOO
// matmul (mxnet_tpu/ndarray/sparse.py, dot of a CSRNDArray and a dense
// array).  The port's plain route (mxnet_tpu_torch/ndarray/sparse.py::
// _csr_dense_dot: gather the rhs rows at the stored columns, scale them by
// the stored values, index_add_ them into the output rows) adds with
// atomics on the card, so a row's sum took a new order every run and the
// product was not deterministic.  This kernel is the non-transposed
// product out = A @ rhs in a fixed order, and only that one: the
// transposed product (the gradient of rhs) stays on the plain route.
//
// Inputs: the stored values data (nnz,), their columns cols (nnz,) int64,
// the row pointers indptr (rows + 1,) int64, rhs (K, n) row-major; output
// out (rows, n).  One thread an output element (r, j): it starts from 0 and
// walks row r's stored entries in stored order, adding rhs[cols[k], j] *
// data[k], with no atomics.  The product is rounded to the value type before
// the add and every add rounds (__fmul_rn/__fadd_rn and their double
// counterparts; the file is also compiled with --fmad=false), which is the
// CPU's arithmetic: its index_add_ adds the scaled rows into a zeroed output
// one stored entry at a time, in index order (in float for half and
// bfloat16 values, rounded once at the end, as here).  So the card's result
// equals the CPU's bit for bit.
//
// Bound on this card (H100 SXM, 3.35 TB/s): the product must read each
// stored value, column and row pointer once, the rhs rows the stored
// columns name once, and write the output once.  At the factorization
// machine's batch (1,000 rows of 39 entries, n = 16, f32) that is about
// 2.6 MB, under a microsecond.  The design is latency-bound instead: a
// thread's sum is a chain of dependent adds over its row (39 here), and
// the 16 threads of a row read one 64-byte rhs row an entry, coalesced.
// Nothing is done yet to shorten the chain (ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the value type's rounded product, widened to the accumulator, and the
// accumulator's rounded sum: float and double accumulate in their own
// type; half and bfloat16 products are rounded to their type and summed
// in float, rounded once at the end, as the CPU's index_add_ does for them
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using Acc = float;
  __device__ static Acc mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static Acc add(Acc a, Acc b) { return __fadd_rn(a, b); }
  __device__ static float out(Acc a) { return a; }
};

template <>
struct Arith<double> {
  using Acc = double;
  __device__ static Acc mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static Acc add(Acc a, Acc b) { return __dadd_rn(a, b); }
  __device__ static double out(Acc a) { return a; }
};

template <>
struct Arith<__half> {
  using Acc = float;
  __device__ static Acc mul(__half a, __half b) {
    return __half2float(
        __float2half_rn(__fmul_rn(__half2float(a), __half2float(b))));
  }
  __device__ static Acc add(Acc a, Acc b) { return __fadd_rn(a, b); }
  __device__ static __half out(Acc a) { return __float2half_rn(a); }
};

template <>
struct Arith<__nv_bfloat16> {
  using Acc = float;
  __device__ static Acc mul(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __bfloat162float(__float2bfloat16_rn(
        __fmul_rn(__bfloat162float(a), __bfloat162float(b))));
  }
  __device__ static Acc add(Acc a, Acc b) { return __fadd_rn(a, b); }
  __device__ static __nv_bfloat16 out(Acc a) {
    return __float2bfloat16_rn(a);
  }
};

template <typename T>
__global__ void csr_dense_dot_kernel(const T* __restrict__ data,
                                     const int64_t* __restrict__ cols,
                                     const int64_t* __restrict__ indptr,
                                     const T* __restrict__ rhs,
                                     T* __restrict__ out, int64_t rows,
                                     int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows * n) return;
  const int64_t r = t / n;
  const int64_t j = t - r * n;
  const int64_t end = indptr[r + 1];
  typename Arith<T>::Acc acc = 0;
  for (int64_t k = indptr[r]; k < end; ++k) {
    acc = Arith<T>::add(acc, Arith<T>::mul(rhs[cols[k] * n + j], data[k]));
  }
  out[t] = Arith<T>::out(acc);
}

template <typename T>
int launch(const void* data, const void* cols, const void* indptr,
           const void* rhs, void* out, int64_t rows, int64_t n,
           cudaStream_t s) {
  const int64_t total = rows * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  csr_dense_dot_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(data), static_cast<const int64_t*>(cols),
      static_cast<const int64_t*>(indptr), static_cast<const T*>(rhs),
      static_cast<T*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 float16, 3 bfloat16
extern "C" int mxt_csr_dense_dot(const void* data, const void* cols,
                                 const void* indptr, const void* rhs,
                                 void* out, long long rows, long long n,
                                 int dtype, void* stream) {
  if (rows < 0 || n < 0) return cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(data, cols, indptr, rhs, out, rows, n, s);
    case 1: return launch<double>(data, cols, indptr, rhs, out, rows, n, s);
    case 2: return launch<__half>(data, cols, indptr, rhs, out, rows, n, s);
    case 3:
      return launch<__nv_bfloat16>(data, cols, indptr, rhs, out, rows, n, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
