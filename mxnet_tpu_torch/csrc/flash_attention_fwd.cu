// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++ with plain C
// entry points (loaded with ctypes by mxnet_tpu_torch/_kernels.py).
//
// Replaces: the Pallas TPU kernel mxnet_tpu/ops/flash_attention.py::_fa_kernel
// (launched by _fa_forward_pallas).  It computes the same function, not the
// same blocking:
//   S = Q K^T * scale in f32; key j is visible to query i iff j < Tk and,
//   when causal, j <= i + (Tk - Tq) (bottom-right alignment, as the
//   reference's tril(k = Tk - Tq)); online softmax with running (m, l, acc);
//   O = acc / max(l, 1e-30) in the input dtype; lse = m + log(l) in f32
//   (natural log: the backward kernels compute exp(S * scale - lse)).
//   A row that sees no key gets O = 0 and lse = -inf.
// Inputs: q (B, H, Tq, D), k and v (B, H, Tk, D), contiguous, one dtype;
// D in {16, 32, 64, 128, 256}; any Tq and Tk (ragged tails are masked here).
// The TPU kernel takes any D as the whole block width; the wrappers
// (ops/flash_attention.py) zero-pad a D between these up to the next one.
// The 128-multiple gate, the 512-row blocks and the (..., block_q, 1) lse
// layout of the TPU kernel are Mosaic constraints and are not carried over.
// Heavy (late, causal) q tiles are scheduled first in both designs.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// Llama-3-8B slice shape B1 H32 T2048 D128, causal, bf16, the work is 34.4
// GFLOP (0.0348 ms) against 67 MB moved (0.020 ms): bound by operations,
// which only the tensor cores can approach (the f32 FMA pipes' 67 TFLOP/s
// alone need 0.513 ms).
//
// Two designs, chosen by the caller (ops/flash_attention.py) by dtype:
//
// mxt_flash_attention_fwd_mma (bf16, f16): Hopper's tensor cores, wgmma on
//   tiles that the TMA unit loads into shared memory behind mbarriers
//   (building blocks in flash_attention_sm90.cuh). It replaces an earlier
//   mma.sync design (16-row warps, cp.async double buffering, ldmatrix) that
//   reached a fifth of the bound and lost 2x to torch's SDPA: Ampere's
//   instructions reach a fraction of this card's tensor-core rate, and every
//   warp spent registers and instructions on copies. One block per (b*h, q
//   tile), heavy (late, causal) tiles first: at D = 128 two warpgroups of 64
//   query rows share each K/V tile (256 threads, 160 KB of shared memory: Q
//   32 KB, two stages of K and V 64 KB each; one block an SM); at D <= 64 one
//   warpgroup (64 rows), so that several blocks share an SM. K/V tiles hold
//   128 keys, or 64 at D <= 64 where Tk <= 128 (launch_wgmma_d). At D = 256
//   two warpgroups again, on 64-key tiles (192 KB: Q 64 KB, two stages of K
//   and V 32 KB each; 128-key tiles would need 320 KB), O += P V on wgmma
//   m64n256k16, and the O accumulator takes 128 registers a thread. Thread 0
//   is the producer: it issues every TMA load, Q and the first two K/V tiles
//   at the start, then each later tile into the stage the last tile leaves,
//   once every warp has arrived on that stage's empty barrier; each stage has
//   a full barrier for K and one for V, so S = Q K^T starts while V lands. (A
//   dedicated producer warpgroup with setmaxnreg measured the same here, and
//   much slower in dK/dV: flash_attention_bwd.cu.) The tensor maps are 3-D
//   (D, T, B*H), so a ragged tail reads zeros and never the next head's rows;
//   zero keys still score 0, not -inf, so the Tk-tail mask stays. Tiles are
//   column blocks of 64 elements (D >= 64; D = 32 and 16: one block),
//   swizzled over 128 bytes (64 and 32), read by wgmma through descriptors of
//   the same swizzle.
//   Each warpgroup: S = Q K^T on wgmma m64nNk16 (Q and K both K-major from
//   shared memory), f32 in registers; the Tk-tail and causal masks only on
//   the tiles that cross them, and a tile no row of the warpgroup sees is
//   skipped; the online softmax in registers in the base-2 domain (scale *
//   log2(e) folded into the scores, exp2f), a row on the four lanes of a quad
//   as in the mma.sync layout; P rounded to the input dtype in registers is
//   wgmma's A operand for O += P V, with V as the MN-major B operand (the
//   transposed descriptor), so P never goes through shared memory; the JAX
//   package's dense path rounds P to v's dtype before this product too. O is
//   divided by max(l, 1e-30) and stored with 4-byte stores. What it still
//   leaves: the two warpgroups' softmax and products are not interleaved with
//   each other (FlashAttention-3's ping-pong), S of the next tile does not
//   overlap this tile's softmax, O goes out through registers rather than a
//   TMA store, and the grid is not persistent.
//
// mxt_flash_attention_fwd_fma (f32): the f32 FMA design, exact f32 (TF32
//   would change f32 users' results).  One 256-thread block per (b*h,
//   64-row q tile); Q, the current K (then V) tile and the 64x64 score
//   tile live in shared memory as f32 (82 KB at D = 128); each thread
//   keeps a 4 x (D/16) slice of the output accumulator in registers, and
//   one warp per 8 rows keeps the running max and sum (149 KB of shared
//   memory at D = 256).  Scalar shared memory reads and synchronous tile
//   loads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "flash_attention_mma.cuh"
#include "flash_attention_sm90.cuh"

namespace {

// ---- tensor-core design (bf16, f16): wgmma on TMA tiles --------------------

constexpr int kWgStages = 2;  // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The plan of the wgmma design at head dim D with K/V tiles of BK keys.
// D >= 128: two warpgroups (128 q rows) share each K/V tile, one block an
// SM.  D <= 64: one warpgroup (64 q rows), so that several blocks share an
// SM and one block's loads and stores overlap another's products.  Shared
// memory: the Q tile, then kWgStages (K tile, V tile) pairs, each tile
// kBlocks column blocks of kSwz-byte rows, then the barriers; 1024 bytes
// of slack to align the start.
template <int D, int BK>
struct FwdTiles {
  static constexpr int kGroups = D >= 128 ? 2 : 1;
  static constexpr int kBlockK = BK;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBlockQ = 64 * kGroups;
  static constexpr int kSwz = mxt_sm90::swizzle_bytes<D>();
  static constexpr int kBlocks = 2 * D / kSwz;
  static constexpr int kQRegion = kBlockQ * kSwz;  // one column block
  static constexpr int kKRegion = kBlockK * kSwz;
  static constexpr int kQBytes = kBlocks * kQRegion;
  static constexpr int kKBytes = kBlocks * kKRegion;
  static constexpr int kBarOffset = kQBytes + 2 * kWgStages * kKBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 3 * kWgStages);
};

// K/V tile t into stage t % kWgStages (thread 0)
template <int D, int BK>
__device__ __forceinline__ void fwd_load_kv(const CUtensorMap* k_map,
                                            const CUtensorMap* v_map,
                                            unsigned char* kvs,
                                            uint64_t* k_full,
                                            uint64_t* v_full, int t, int bh) {
  using namespace mxt_sm90;
  using L = FwdTiles<D, BK>;
  const int s = t % kWgStages;
  unsigned char* kt = kvs + s * 2 * L::kKBytes;
  unsigned char* vt = kt + L::kKBytes;
  mbar_arrive_expect_tx(&k_full[s], L::kKBytes);
  for (int c = 0; c < L::kBlocks; ++c)
    tma_load_3d(kt + c * L::kKRegion, k_map, &k_full[s], c * L::kSwz / 2,
                t * L::kBlockK, bh);
  mbar_arrive_expect_tx(&v_full[s], L::kKBytes);
  for (int c = 0; c < L::kBlocks; ++c)
    tma_load_3d(vt + c * L::kKRegion, v_map, &v_full[s], c * L::kSwz / 2,
                t * L::kBlockK, bh);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(FwdTiles<D, BK>::kThreads, 1)
    fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        T* __restrict__ o, float* __restrict__ lse, int tq,
                        int tk, int causal, float scale) {
  using namespace mxt_sm90;
  using namespace mxt_mma;
  using L = FwdTiles<D, BK>;
  constexpr int kSwz = L::kSwz;
  constexpr int kSteps = kSwz / 32;    // k16 steps a column block row
  constexpr int kKN = L::kBlockK / 8;  // n8 tiles of S
  constexpr int kDN = D / 8;           // n8 tiles of O
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* kvs = smem + L::kQBytes;  // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kWgStages;
  uint64_t* empty = v_full + kWgStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kBlockQ;  // heavy first
  const int offset = tk - tq;
  int n_tiles = (tk + L::kBlockK - 1) / L::kBlockK;
  if (causal) {
    const int k_last = min(q0 + L::kBlockQ, tq) - 1 + offset;
    n_tiles = k_last < 0 ? 0 : min(n_tiles, k_last / L::kBlockK + 1);
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * L::kGroups);  // every warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // thread 0 issues every load: Q and the first kWgStages K/V tiles now,
  // then each later tile as the stage it goes to is released
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_arrive_expect_tx(q_full, L::kQBytes);
    for (int c = 0; c < L::kBlocks; ++c)
      tma_load_3d(qs + c * L::kQRegion, &q_map, q_full, c * kSwz / 2, q0, bh);
    for (int t = 0; t < kWgStages && t < n_tiles; ++t)
      fwd_load_kv<D, BK>(&k_map, &v_map, kvs, k_full, v_full, t, bh);
  }

  // warpgroup wg: q rows row0 .. row0 + 63
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int quad_col = 2 * (lane & 3);
  const int row0 = q0 + 64 * wg;
  const int row_a = row0 + warp * 16 + (lane >> 2);  // and row_a + 8
  // the last key a row of this warpgroup sees (-1: it has no rows)
  const int key_last = row0 >= tq ? -1
                       : causal   ? min(row0 + 63, tq - 1) + offset
                                  : tk - 1;
  const uint32_t q_addr = smem_u32(qs) + 64 * wg * kSwz;

  const float scale_log2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // running max, base-2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the sum
  float acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kWgStages;
    const uint32_t parity = (t / kWgStages) & 1;
    // the last tile's stage takes tile t - 1 + kWgStages once every warp
    // is done with it
    if (threadIdx.x == 0 && t > 0 && t - 1 + kWgStages < n_tiles) {
      mbar_wait(&empty[(t - 1) % kWgStages], ((t - 1) / kWgStages) & 1);
      fwd_load_kv<D, BK>(&k_map, &v_map, kvs, k_full, v_full,
                         t - 1 + kWgStages, bh);
    }
    const int k0 = t * L::kBlockK;
    if (k0 > key_last) {  // no row of this warpgroup sees the tile
      // the stage is released only once filled: a warpgroup that skips
      // never runs a round ahead of the other one on the empty barrier
      mbar_wait(&k_full[s], parity);
      mbar_wait(&v_full[s], parity);
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t k_addr = smem_u32(kvs) + s * 2 * L::kKBytes;
    const uint32_t v_addr = k_addr + L::kKBytes;

    // S = Q K^T for the warpgroup's 64 rows and the tile's 128 keys
    float sc[kKN][4];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % kSteps) * 32;
      wgmma_ss_step<T>(sc,
                       desc<kSwz>(q_addr + (kk / kSteps) * L::kQRegion + col,
                                  16, 8 * kSwz),
                       desc<kSwz>(k_addr + (kk / kSteps) * L::kKRegion + col,
                                  16, 8 * kSwz),
                       kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= scale_log2;
    // only tiles on the causal diagonal or the Tk tail hold masked pairs
    if (k0 + L::kBlockK > tk ||
        (causal && k0 + L::kBlockK - 1 > row0 + offset)) {
#pragma unroll
      for (int j = 0; j < kKN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + quad_col + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (key >= tk || (causal && key > row + offset))
            sc[j][e] = -INFINITY;
        }
    }

    // online softmax; values e = 2h, 2h + 1 belong to row row_a + 8h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKN; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[h] - safe);  // 0 while m[h] = -inf
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKN; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          sc[j][e] = exp2f(sc[j][e] - safe);  // 0 where masked
          sum += sc[j][e];
        }
      l[h] = l[h] * corr + sum;
#pragma unroll
      for (int j = 0; j < kDN; ++j) {
        acc[j][2 * h] *= corr;
        acc[j][2 * h + 1] *= corr;
      }
    }

    // O += P V: P rounded to T in registers (wgmma's A), V MN-major
    uint32_t pa[L::kBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < L::kBlockK / 16; ++j)
      acc_to_a<T>(pa[j], sc[2 * j], sc[2 * j + 1]);
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < L::kBlockK / 16; ++j)
      wgmma_rs<T>(acc, pa[j],
                  desc<kSwz>(v_addr + j * 16 * kSwz, L::kKRegion, 8 * kSwz));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_row = quad_sum(l[h]);
    const int row = row_a + 8 * h;
    if (row < tq) {
      const float inv = 1.f / fmaxf(l_row, 1e-30f);
      T* orow = o + ((size_t)bh * tq + row) * D + quad_col;
#pragma unroll
      for (int j = 0; j < kDN; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack2<T>(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
      if ((lane & 3) == 0)
        lse[(size_t)bh * tq + row] = (m[h] == -INFINITY || !(l_row > 0.f))
                                         ? -INFINITY
                                         : m[h] * kLn2 + logf(l_row);
    }
  }
}

template <typename T, int D, int BK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int tq, int tk, int causal,
                         float scale, cudaStream_t stream) {
  using L = FwdTiles<D, BK>;
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_wgmma_kernel<T, D, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tq == 0) return cudaSuccess;
  // at Tk = 0 no tile is loaded; the maps need a tensor all the same
  const bool no_keys = tk == 0;
  CUtensorMap q_map, k_map, v_map;
  if ((err = mxt_sm90::make_map<T, D>(&q_map, q, bh, tq, L::kBlockQ)) ||
      (err = mxt_sm90::make_map<T, D>(&k_map, no_keys ? q : k, bh,
                                      no_keys ? tq : tk, L::kBlockK)) ||
      (err = mxt_sm90::make_map<T, D>(&v_map, no_keys ? q : v, bh,
                                      no_keys ? tq : tk, L::kBlockK)))
    return err;
  const dim3 grid(bh, (tq + L::kBlockQ - 1) / L::kBlockQ);
  fa_fwd_wgmma_kernel<T, D, BK>
      <<<grid, L::kThreads, L::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(o), static_cast<float*>(lse), tq,
      tk, causal, scale);
  return cudaGetLastError();
}

// K/V tiles of 128 keys, or of 64 at D <= 64 where Tk <= 128 (BERT-base's
// T = 128): two tiles, so that the second one's load overlaps the first
// one's products in a block that sees only them (0.0251 against 0.0264 ms
// at B64 H12 T128 D64 on an H100; at T = 2048 the 64-key tiles measured
// 30% slower); at D = 256 tiles of 64 keys, the most that two stages of
// K and V fit beside a 128-row Q tile
template <typename T>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int tq, int tk, int d,
                           int causal, float scale, cudaStream_t stream) {
  const bool short_keys = tk <= 128;
  switch (d) {
    case 16:
      return short_keys ? launch_wgmma<T, 16, 64>(q, k, v, o, lse, bh, tq, tk,
                                                  causal, scale, stream)
                        : launch_wgmma<T, 16, 128>(q, k, v, o, lse, bh, tq,
                                                   tk, causal, scale, stream);
    case 32:
      return short_keys ? launch_wgmma<T, 32, 64>(q, k, v, o, lse, bh, tq, tk,
                                                  causal, scale, stream)
                        : launch_wgmma<T, 32, 128>(q, k, v, o, lse, bh, tq,
                                                   tk, causal, scale, stream);
    case 64:
      return short_keys ? launch_wgmma<T, 64, 64>(q, k, v, o, lse, bh, tq, tk,
                                                  causal, scale, stream)
                        : launch_wgmma<T, 64, 128>(q, k, v, o, lse, bh, tq,
                                                   tk, causal, scale, stream);
    case 128:
      return launch_wgmma<T, 128, 128>(q, k, v, o, lse, bh, tq, tk, causal,
                                       scale, stream);
    case 256:
      return launch_wgmma<T, 256, 64>(q, k, v, o, lse, bh, tq, tk, causal,
                                      scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- f32 FMA design --------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLdS = kBlockK + 1;  // padded row stride of the score tile

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

// Rows [row0, row0 + 64) of a (rows, D) matrix into shared memory with row
// stride D + 1; rows past the end read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < rows ? src[(size_t)gr * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + bh * (size_t)tq * D;
  const float* kb = k + bh * (size_t)tk * D;
  const float* vb = v + bh * (size_t)tk * D;
  const int offset = tk - tq;

  load_tile<D>(qs, qb, q0, tq);
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
    load_tile<D>(kvs, kb, k0, tk);
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
    load_tile<D>(kvs, vb, k0, tk);
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
      float* orow = o + (bh * (size_t)tq + qpos) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = acc[i][j] / l;
    }
  }
  if (tid < kBlockQ && q0 + tid < tq) {
    const float m = m_s[tid], l = l_s[tid];
    lse[bh * (size_t)tq + q0 + tid] =
        (isfinite(m) && l > 0.f) ? m + logf(fmaxf(l, 1e-30f)) : -INFINITY;
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tq == 0) return cudaSuccess;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  fa_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Each returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// dtype or D the design does not take); the kernel itself runs
// asynchronously on `stream`.  The tensor-core design needs 16-byte aligned
// q, k and v.
extern "C" int mxt_flash_attention_fwd_mma(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int bh, int tq, int tk, int d,
                                           int dtype, int causal, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_wgmma_d<__half>(q, k, v, o, lse, bh, tq, tk, d, causal,
                                    scale, s);
    case 2:
      return launch_wgmma_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d,
                                           causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int mxt_flash_attention_fwd_fma(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int bh, int tq, int tk, int d,
                                           int dtype, int causal, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_fma<16>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    case 32:
      return launch_fma<32>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    case 64:
      return launch_fma<64>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    case 128:
      return launch_fma<128>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    case 256:
      return launch_fma<256>(q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
