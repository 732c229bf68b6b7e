// CSR x dense product for NVIDIA Hopper (sm_90a), CUDA C++ with a plain C
// entry point (loaded with ctypes by mxnet_tpu_torch/_kernels.py).
//
// Replaces no Pallas kernel: the reference's CSR product is XLA's BCOO
// matmul (mxnet_tpu/ndarray/sparse.py, dot of a CSRNDArray and a dense
// array).  The port's plain route (mxnet_tpu_torch/ndarray/sparse.py::
// _csr_dense_dot: gather the rhs rows at the stored columns, scale them by
// the stored values, index_add_ them into the output rows) adds with
// atomics on the card, so a sum would take a new order every run.  This
// kernel computes out = A @ rhs in a fixed order.  The transposed product
// A^T @ rhs (the gradient of rhs, and the factorization machine's three
// transposed dots) is the same kernel on a column-ordered view of A that
// the wrapper builds (a stable sort of the columns: each column's entries
// keep their stored order), so both directions are deterministic.
//
// Inputs: the stored values data (nnz,), their columns cols (nnz,) int64,
// the row pointers indptr (rows + 1,) int64, rhs (K, n) row-major; output
// out (rows, n), every row written (an empty row is 0).
//
// Design: a group of G lanes a row (G = 32, a warp, for wide rows; the
// smallest power of two that covers the row's n / V vectors otherwise),
// each lane owning V output columns (16 bytes when n and the pointers
// allow it: four floats at n = 16, so a 64-byte rhs row is four lanes;
// one value otherwise).  The group reads the row's (column, value) pairs
// coalesced, B or more at a time, and hands them round with shuffles;
// each lane then issues the rhs gathers of B entries before it does any
// add, while the next round's pairs load (B = 16 when every row has a
// group of its own, 8 on a tall output, where more resident groups matter
// more than a deeper batch).  The adds run in stored order: every output
// element starts from 0 and adds its row's products one stored entry at
// a time.
// Each product is rounded to the value type before the add and every add
// rounds (__fmul_rn/__fadd_rn and their double counterparts; the file is
// also compiled with --fmad=false), which is the CPU's arithmetic: its
// index_add_ adds the scaled rows into a zeroed output one stored entry
// at a time, in index order (in float for half and bfloat16 values,
// rounded once at the end, as here).  So the card's result equals the
// CPU's bit for bit; no tree reduction, no tolerance.  The grid holds at
// most one wave of resident blocks and strides over the rows; on a tall
// output (more rows than groups) a group takes G consecutive rows at
// once, lane i loading row i's pointers.
//
// Bound on this card (H100 SXM, 3.35 TB/s): the product must read each
// stored value, column and row pointer once, the rhs rows the stored
// columns name once, and write the output once.  At the factorization
// machine's batch (1,000 rows of 39 entries, n = 16, f32) that is about
// 3 MB, under a microsecond: the kernel stays latency-bound (a row's 39
// ordered adds behind three rounds of gathers, a launch of 63 blocks).
// The transposed product at the same batch writes a (1,000,000 x 16)
// output, 64 MB, which bounds it (19 us).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 64;  // two warps a block: the small launches
                              // spread over more of the 132 SMs
// rhs gathers in flight a lane: 16 where the output's rows all fit one
// wave of groups, 8 on a tall output, whose mostly empty rows want the
// resident groups that the deeper batch's registers would cost
constexpr int kDeep = 16, kShallow = 8;

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

// lane ``src`` of the caller's group of ``width`` lanes: ``v`` moved as
// its bits, so one shuffle serves every value type
template <typename T>
__device__ __forceinline__ T group_shfl(unsigned mask, T v, int src,
                                        int width) {
  if constexpr (sizeof(T) == 8) {
    long long x;
    memcpy(&x, &v, 8);
    x = __shfl_sync(mask, x, src, width);
    memcpy(&v, &x, 8);
  } else if constexpr (sizeof(T) == 4) {
    int x;
    memcpy(&x, &v, 4);
    x = __shfl_sync(mask, x, src, width);
    memcpy(&v, &x, 4);
  } else {
    unsigned short s;
    memcpy(&s, &v, 2);
    s = static_cast<unsigned short>(
        __shfl_sync(mask, static_cast<int>(s), src, width));
    memcpy(&v, &s, 2);
  }
  return v;
}

// V values of T from p (16 bytes at once when V > 1; p is then aligned)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[0];
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(v, &u, 16);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
    uint4 u;
    memcpy(&u, v, 16);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// one output row r: its entries [start, end) in stored order
template <typename T, int V, int G, int B>
__device__ __forceinline__ void row_dot(const T* __restrict__ data,
                                        const int64_t* __restrict__ cols,
                                        const T* __restrict__ rhs,
                                        T* __restrict__ out, int64_t n,
                                        int64_t vecs, int64_t r,
                                        int64_t start, int64_t end, int gl,
                                        unsigned mask) {
  using A = Arith<T>;
  constexpr int U = G >= B ? 1 : B / G;  // pairs a lane a round
  constexpr int P = G * U;                         // entries a round
  // a pass a G vectors of the row (one pass unless the row is wider than
  // 32 vectors); every lane of the group takes every pass and every
  // round, so each shuffle finds its whole group
  for (int64_t c0 = 0; c0 < vecs; c0 += G) {
    const int64_t c = c0 + gl;
    const bool mine = c < vecs;
    typename A::Acc acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0;
    // a round's pairs, coalesced: lane gl holds entries base + gl + u * G
    // (an entry past the row reads the row's first, and is never used);
    // the next round's are loaded while this round's gathers are in
    // flight
    int64_t pc[U];
    T pv[U];
    auto pairs = [&](int64_t base, int64_t (&c)[U], T (&v)[U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t k = base + gl + static_cast<int64_t>(u) * G;
        const int64_t kk = k < end ? k : start;
        c[u] = cols[kk];
        v[u] = data[kk];
      }
    };
    if (start < end) pairs(start, pc, pv);
    for (int64_t base = start; base < end; base += P) {
      int64_t nc[U];
      T nv[U];
      if (base + P < end) pairs(base + P, nc, nv);
#pragma unroll
      for (int e0 = 0; e0 < P; e0 += B) {
        // B gathers issued before any add
        T rv[B][V];
        T dv[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const int e = e0 + b;
          int64_t col;
          if constexpr (G == 1) {
            col = pc[e];
            dv[b] = pv[e];
          } else {
            col = group_shfl(mask, pc[e / G], e % G, G);
            dv[b] = group_shfl(mask, pv[e / G], e % G, G);
          }
          if (mine && base + e < end) load_vec<T, V>(rhs + col * n + c * V,
                                                     rv[b]);
        }
        // then the adds, in stored order
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if (mine && base + e0 + b < end) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = A::add(acc[v], A::mul(rv[b][v], dv[b]));
          }
        }
      }
      if (base + P < end) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          pc[u] = nc[u];
          pv[u] = nv[u];
        }
      }
    }
    if (mine) {
      T o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = A::out(acc[v]);
      store_vec<T, V>(out + r * n + c * V, o);
    }
  }
}

// V: output columns a lane (n % V == 0); G: lanes a row (a power of two,
// at most 32, so a group never straddles a warp); B: gathers in flight a
// lane
template <typename T, int V, int G, int B>
__global__ void __launch_bounds__(kThreads)
csr_dense_dot_kernel(const T* __restrict__ data,
                     const int64_t* __restrict__ cols,
                     const int64_t* __restrict__ indptr,
                     const T* __restrict__ rhs, T* __restrict__ out,
                     int64_t rows, int64_t n) {
  const int gl = static_cast<int>(threadIdx.x % G);
  constexpr unsigned kOnes = G == 32 ? 0xffffffffu : (1u << (G & 31)) - 1u;
  const unsigned mask = kOnes << (static_cast<int>(threadIdx.x % 32) / G *
                                  G);  // the group's lanes
  const int64_t vecs = n / V;
  // rows grid-stride: the launch holds at most one wave of resident
  // blocks (launch_g).  When
  // that is fewer groups than rows (a tall output: the transposed
  // product's million rows, mostly empty), a group takes G consecutive
  // rows at once, lane i loading row i's pointers, so one round trip
  // serves G rows; otherwise a row a group
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (kThreads / G);
  const int rpg = rows > groups ? G : 1;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kThreads +
                         threadIdx.x) / G * rpg;
  for (int64_t r0 = first; r0 < rows; r0 += groups * rpg) {
    const int64_t ri = r0 + (gl < rpg ? gl : 0);
    const int64_t a = ri < rows ? indptr[ri] : 0;
    const int64_t b = ri < rows ? indptr[ri + 1] : 0;
    for (int i = 0; i < rpg && r0 + i < rows; ++i) {  // uniform in the group
      int64_t start = a, end = b;
      if constexpr (G > 1) {
        start = group_shfl(mask, a, i, G);
        end = group_shfl(mask, b, i, G);
      }
      row_dot<T, V, G, B>(data, cols, rhs, out, n, vecs, r0 + i, start, end,
                       gl, mask);
    }
  }
}

// the blocks of csr_dense_dot_kernel<T, V, G, B> resident at once on this
// card (0 on an error, which *err then holds)
template <typename T, int V, int G, int B>
int64_t wave(cudaError_t* err) {
  static int64_t blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    *err = cudaGetDevice(&dev);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, csr_dense_dot_kernel<T, V, G, B>, kThreads, 0);
    if (*err != cudaSuccess) return 0;
    blocks = static_cast<int64_t>(sms) * per_sm;
  }
  return blocks;
}

template <typename T, int V, int G, int B>
int launch_b(const void* data, const void* cols, const void* indptr,
             const void* rhs, void* out, int64_t rows, int64_t n,
             int64_t blocks, cudaStream_t s) {
  csr_dense_dot_kernel<T, V, G, B>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<const T*>(data), static_cast<const int64_t*>(cols),
          static_cast<const int64_t*>(indptr), static_cast<const T*>(rhs),
          static_cast<T*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, int G>
int launch_g(const void* data, const void* cols, const void* indptr,
             const void* rhs, void* out, int64_t rows, int64_t n,
             cudaStream_t s) {
  // at most the blocks that are resident at once on this card, so that no
  // block waits for another to finish: the deep batch when a group a row
  // fits that, else the shallow one (a tall output)
  cudaError_t err = cudaSuccess;
  const int64_t need = (rows * G + kThreads - 1) / kThreads;
  const int64_t deep = wave<T, V, G, kDeep>(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (need <= deep)
    return launch_b<T, V, G, kDeep>(data, cols, indptr, rhs, out, rows, n,
                                    need, s);
  const int64_t shallow = wave<T, V, G, kShallow>(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_b<T, V, G, kShallow>(data, cols, indptr, rhs, out, rows, n,
                                     need < shallow ? need : shallow, s);
}

template <typename T, int V>
int launch_v(const void* data, const void* cols, const void* indptr,
             const void* rhs, void* out, int64_t rows, int64_t n,
             cudaStream_t s) {
  // the group: the fewest lanes (a power of two) that cover a row
  const int64_t vecs = n / V;
#define MXT_GROUP(g) \
  launch_g<T, V, g>(data, cols, indptr, rhs, out, rows, n, s)
  if (vecs <= 1) return MXT_GROUP(1);
  if (vecs <= 2) return MXT_GROUP(2);
  if (vecs <= 4) return MXT_GROUP(4);
  if (vecs <= 8) return MXT_GROUP(8);
  if (vecs <= 16) return MXT_GROUP(16);
  return MXT_GROUP(32);
#undef MXT_GROUP
}

template <typename T>
int launch(const void* data, const void* cols, const void* indptr,
           const void* rhs, void* out, int64_t rows, int64_t n,
           cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = n % kVec == 0 &&
                    reinterpret_cast<uintptr_t>(rhs) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return wide ? launch_v<T, kVec>(data, cols, indptr, rhs, out, rows, n, s)
              : launch_v<T, 1>(data, cols, indptr, rhs, out, rows, n, s);
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
