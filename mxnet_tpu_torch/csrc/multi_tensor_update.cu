// Fused multi-tensor optimizer update for NVIDIA Hopper (sm_90a), CUDA C++
// with a plain C entry point (loaded with ctypes by
// mxnet_tpu_torch/_kernels.py).
//
// Replaces: the reference's fused multi-tensor update, which has no Pallas
// kernel: mxnet_tpu/gluon/trainer.py::Trainer._try_fused_update traces every
// parameter's Optimizer._step rule (mxnet_tpu/optimizer/__init__.py::
// _fused_param_updates) into one XLA program, one dispatch a step.  Here
// one launch updates every live tensor of a step in place: weights, their
// optimizer states and, with multi_precision, their f32 master weights.
//
// Rules (the entry point's ``rule``), each the port's plain per-tensor rule
// (mxnet_tpu_torch/optimizer/__init__.py, Optimizer._step) with its
// rounding points: every elementwise op of the plain rule computes in f32
// and rounds to the dtype of the tensor it produces (bf16/f16/f32), and the
// kernel rounds at the same places (rnd below).  This file is compiled with
// --fmad=false, so that no multiply-add is contracted into an FMA that the
// plain rule's separate torch ops do not make.
//   0 SGD           w -= lr*g
//   1 SGD momentum  m = mu*m - lr*g (f32); w += m
//   2 NAG momentum  m = mu*m + g; w -= lr*(g + mu*m) (m in w's dtype)
//   3 Adam          m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g^2 (f32);
//                   w -= lr_t*m/(sqrt(v) + eps), lr_t = lr*sqrt(1-b2^t)/(1-b1^t)
//   4 AdamW         Adam + lr*wd*w, with wd decoupled from g
// g is first rescaled (rescale_grad), clipped (clip_gradient) and, except
// for AdamW, given + wd*w, in the rule's compute dtype (w's for SGD and
// NAG, the state's for Adam), each step only where the plain rule makes it.
// With a master (multi_precision), the rule runs on the f32 master with g
// read as f32, and the weight is written as the master rounded to its
// dtype.
//
// The device table: one 80-byte Entry a tensor (pointers of w, g, the two
// states and the master, the length, the weight's dtype, and lr, wd and t),
// and a block map, one (tensor, chunk) pair a block.  lr, wd and t are read
// from the table in device memory, never from launch arguments, so that a
// CUDA graph that captured this launch sees a new lr schedule and a new t
// on every replay (the host rewrites the table before each).  Adam's lr_t
// is computed from t here, in double as the plain rule does on the host.
// Any tensor length from 1 up: a block covers one chunk of kChunk elements
// of one tensor; there are no atomics.  Each block dispatches once on its
// tensor's dtypes to a loop instantiated for them, so the loop itself has
// no branch on a dtype or an option (a loop with such loop-invariant
// branches made the compiler's loop unswitching run without end).
//
// Bound on this card (H100 SXM, 3.35 TB/s): an optimizer update reads and
// writes each weight and each state once and reads each gradient once, so
// it is bound by bytes: SGD with momentum on bf16 weights moves 2+2+2 B of
// weight and gradient and 4+4 B of f32 momentum, 14 B a parameter, and the
// 4,540,469,248 parameters of the 16-layer Llama-3-8B training slice take
// 18.97 ms at the bound.  The design does one pass over those bytes: each
// thread loads kUnroll elements of each operand before it computes, so that
// enough loads are in flight; loads and stores are scalar (a tensor's
// length and offset may be anything), coalesced across the warp.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = 16384;  // elements a block (the Python side
                                     // builds the block map with it)

// dtype codes: 0 f32, 1 f16, 2 bf16
struct Entry {
  void* w;          // the weight (written as the master, rounded, with one)
  const void* g;    // the gradient, in the weight's dtype
  void* s0;         // momentum / Adam's m, or null
  void* s1;         // Adam's v, or null
  float* master;    // f32 master weight (multi_precision), or null
  long long n;      // elements
  long long dtype;  // the weight's (the states' follows from the rule
                    // and the master; the wrapper checks them)
  double lr;
  double wd;
  long long t;      // the update count of this step
};
static_assert(sizeof(Entry) == 80, "Entry must match the Python table");

// rescale is 1 and clip +inf where the plain rule skips them: g * 1 and
// a clamp to +-inf change no value, so the loop has no branch on them
struct Hyper {
  float rescale, clip, mom, b1, omb1, b2, omb2, eps;
  double b1d, b2d;
};

template <int C>
__device__ __forceinline__ float ld(const void* p, long long i) {
  if constexpr (C == 1) return __half2float(static_cast<const __half*>(p)[i]);
  else if constexpr (C == 2)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  else return static_cast<const float*>(p)[i];
}

template <int C>
__device__ __forceinline__ void st(void* p, long long i, float v) {
  if constexpr (C == 1) static_cast<__half*>(p)[i] = __float2half_rn(v);
  else if constexpr (C == 2)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(p)[i] = v;
}

// x rounded to the dtype C (round to nearest even) and back to f32
template <int C>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (C == 1) return __half2float(__float2half_rn(x));
  else if constexpr (C == 2) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

// the plain rule's _prep_grad in dtype CT: rescale, clip, + wd*w (wd_on:
// the rule adds it, the plain rule's ``if wd``)
template <int CT>
__device__ __forceinline__ float prep(const Hyper& h, float g, float w,
                                      float wd, bool wd_on) {
  g = rnd<CT>(g * h.rescale);
  g = isnan(g) ? g : rnd<CT>(fminf(fmaxf(g, -h.clip), h.clip));
  const float with_wd = rnd<CT>(g + rnd<CT>(wd * w));
  return wd_on ? with_wd : g;
}

// one element: RULE on w (in CW: f32 with a master), states in CS
template <int RULE, int CW, int CS>
__device__ __forceinline__ void rule(const Hyper& h, float& w, float g,
                                     float& s0, float& s1, float lr,
                                     float wd, bool wd_on, float lrwd,
                                     float lr_t) {
  if constexpr (RULE == 0) {
    g = prep<CW>(h, g, w, wd, wd_on);
    w = rnd<CW>(w - rnd<CW>(lr * g));
  } else if constexpr (RULE == 1) {
    g = prep<CW>(h, g, w, wd, wd_on);
    s0 = rnd<CS>(s0 * h.mom);
    s0 = rnd<CS>(s0 - rnd<CS>(lr * g));
    w = rnd<CW>(w + rnd<CW>(s0));
  } else if constexpr (RULE == 2) {
    g = prep<CW>(h, g, w, wd, wd_on);
    s0 = rnd<CS>(s0 * h.mom);
    s0 = rnd<CS>(s0 + g);
    const float t2 = rnd<CW>(g + rnd<CW>(h.mom * s0));
    w = rnd<CW>(w - rnd<CW>(lr * t2));
  } else {
    g = prep<CS>(h, g, w, wd, RULE == 3 && wd_on);
    s0 = rnd<CS>(s0 * h.b1);
    s0 = rnd<CS>(s0 + rnd<CS>(h.omb1 * g));
    s1 = rnd<CS>(s1 * h.b2);
    s1 = rnd<CS>(s1 + rnd<CS>(h.omb2 * rnd<CS>(g * g)));
    float u = rnd<CS>(rnd<CS>(lr_t * s0) /
                      rnd<CS>(rnd<CS>(sqrtf(s1)) + h.eps));
    if constexpr (RULE == 4) u = rnd<CS>(u + rnd<CS>(lrwd * w));
    w = rnd<CW>(w - rnd<CW>(u));
  }
}

// one block's chunk of one tensor: weight dtype WC, with a master (MP) or
// not; the state dtype is the weight's for NAG without a master, f32
// otherwise (the optimizers' create_state)
template <int RULE, int WC, bool MP>
__device__ __forceinline__ void update_chunk(const Entry& e, const Hyper& h,
                                             long long start,
                                             long long end) {
  constexpr int CW = MP ? 0 : WC;
  constexpr int CS = (RULE == 2 && !MP) ? WC : 0;
  constexpr int kStates = RULE == 0 ? 0 : (RULE <= 2 ? 1 : 2);
  const float lr = static_cast<float>(e.lr);
  const float wd = static_cast<float>(e.wd);
  const bool wd_on = e.wd != 0.0;
  const float lrwd = static_cast<float>(e.lr * e.wd);
  float lr_t = 0.f;
  if constexpr (RULE >= 3) {
    const double t = static_cast<double>(e.t);
    lr_t = static_cast<float>(e.lr * sqrt(1.0 - pow(h.b2d, t)) /
                              (1.0 - pow(h.b1d, t)));
  }
  for (long long base = start + threadIdx.x; base < end;
       base += kThreads * kUnroll) {
    float w[kUnroll], g[kUnroll], s0[kUnroll], s1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      w[u] = g[u] = s0[u] = s1[u] = 0.f;
      if (i < end) {
        w[u] = MP ? e.master[i] : ld<WC>(e.w, i);
        g[u] = ld<WC>(e.g, i);
        if constexpr (kStates > 0) s0[u] = ld<CS>(e.s0, i);
        if constexpr (kStates > 1) s1[u] = ld<CS>(e.s1, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < end) {
        rule<RULE, CW, CS>(h, w[u], g[u], s0[u], s1[u], lr, wd, wd_on, lrwd,
                           lr_t);
        if constexpr (MP) e.master[i] = w[u];
        st<WC>(e.w, i, w[u]);
        if constexpr (kStates > 0) st<CS>(e.s0, i, s0[u]);
        if constexpr (kStates > 1) st<CS>(e.s1, i, s1[u]);
      }
    }
  }
}

template <int RULE>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_update_kernel(const Entry* __restrict__ table,
                               const int2* __restrict__ blocks, Hyper h) {
  const int2 blk = blocks[blockIdx.x];
  const Entry e = table[blk.x];
  const long long start = static_cast<long long>(blk.y) * kChunk;
  const long long end = start + kChunk < e.n ? start + kChunk : e.n;
  // the dtype dispatch is uniform over the block and outside the loop
  switch (static_cast<int>(e.dtype) * 2 + (e.master != nullptr)) {
    case 0: update_chunk<RULE, 0, false>(e, h, start, end); break;
    case 2: update_chunk<RULE, 1, false>(e, h, start, end); break;
    case 3: update_chunk<RULE, 1, true>(e, h, start, end); break;
    case 4: update_chunk<RULE, 2, false>(e, h, start, end); break;
    case 5: update_chunk<RULE, 2, true>(e, h, start, end); break;
    default: break;  // the wrapper admits no other combination
  }
}

template <int RULE>
cudaError_t launch(const void* table, const void* blocks, int nblocks,
                   const Hyper& h, cudaStream_t stream) {
  multi_tensor_update_kernel<RULE><<<nblocks, kThreads, 0, stream>>>(
      static_cast<const Entry*>(table), static_cast<const int2*>(blocks), h);
  return cudaGetLastError();
}

}  // namespace

// table: (n_tensors, 10) int64 on the card, one Entry a row; blocks:
// (nblocks, 2) int32 (tensor, chunk of kChunk elements); flags: bit 0 the
// gradient is rescaled, bit 1 it is clipped.
extern "C" int mxt_multi_tensor_update(const void* table, const void* blocks,
                                       int nblocks, int rule, int flags,
                                       float rescale, float clip, float mom,
                                       float b1, float omb1, float b2,
                                       float omb2, float eps, double b1d,
                                       double b2d, void* stream) {
  if (nblocks <= 0 || rule < 0 || rule > 4) return cudaErrorInvalidValue;
  const Hyper h{(flags & 1) ? rescale : 1.f,
                (flags & 2) ? clip : __builtin_huge_valf(),
                mom, b1, omb1, b2, omb2, eps, b1d, b2d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0: return launch<0>(table, blocks, nblocks, h, s);
    case 1: return launch<1>(table, blocks, nblocks, h, s);
    case 2: return launch<2>(table, blocks, nblocks, h, s);
    case 3: return launch<3>(table, blocks, nblocks, h, s);
    default: return launch<4>(table, blocks, nblocks, h, s);
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
