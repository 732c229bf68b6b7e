// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ with plain C
// entry points (loaded with ctypes by mxnet_tpu_torch/_kernels.py).
//
// Replaces the two Pallas TPU kernels of mxnet_tpu/ops/flash_attention.py,
// launched by _fa_backward_pallas:
//   fa_bwd_dq_wgmma_kernel, fa_bwd_dq_kernel  <- _fa_bwd_dq_kernel  (dQ)
//   fa_bwd_dkv_wgmma_kernel, fa_bwd_dkv_kernel <- _fa_bwd_dkv_kernel (dK,
//   dV)
// Both recompute the probabilities from the forward's per-row lse:
//   S = Q K^T * scale, P = exp(S - lse) (0 where masked or lse = -inf),
//   dP = dO V^T, dS = P * (dP - delta) * scale, with delta = rowsum(dO * O)
//   in f32, which the reference computes outside its kernels and the dQ
//   kernel here computes for its own rows and writes for dK/dV to read;
//   dQ = dS K, dK = dS^T Q, dV = P^T dO.
// Masking follows the port's forward, not the Pallas backward (which masks
// q >= k and so is right only at Tq = Tk): key j is visible to query i iff
// j < Tk and, when causal, j <= i + (Tk - Tq) (bottom-right alignment).
// Ragged tails are masked here.  Rows that see no key (lse = -inf) get
// dQ = 0 and add nothing to dK and dV.
// Inputs: q, O, dO (B*H, Tq, D); k, v (B*H, Tk, D); contiguous, all of one
// dtype (f32, f16 or bf16); lse f32 (B*H, Tq); D in {16, 32, 64, 128,
// 256} (the wrappers zero-pad a D between these up to the next one).
// Outputs dQ, dK, dV in the input dtype, delta f32 (B*H, Tq) (dQ's output,
// dK/dV's input); accumulation in f32.
//
// Each output tile is owned by exactly one thread block, as the TPU split
// has it, so there are no atomics and the gradients are the same bits from
// run to run; delta is summed in a fixed order, a pair of threads a row.
// Heavy tiles (late q tiles for dQ, early k tiles for dK/dV) start first.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// Llama-3-8B slice shape B1 H32 T2048 D128 causal bf16, dK/dV's four
// products come to 68.75 GFLOP (0.0695 ms) and dQ's three to 51.6 GFLOP
// (0.0521 ms), against 50-85 MB moved (0.02-0.025 ms) each (dQ's reading
// of O for delta adds 16.8 MB, 5 us): bound by operations (the f32 FMA
// pipes alone need 1.026 and 0.770 ms).
//
// Each kernel has two designs, chosen by the caller (ops/flash_attention.py)
// by dtype: bf16 and f16 on the tensor cores (_mma), f32 on the FMA pipes
// in exact f32 (_fma; TF32 would change f32 users' results).
//
// dQ, bf16 and f16 (mxt_flash_attention_bwd_dq_mma): Hopper's tensor cores,
//   wgmma on tiles that the TMA unit loads behind mbarriers, the forward's
//   design with the backward's arithmetic.  It replaces an earlier
//   mma.sync design (8 warps of 16 rows, cp.async double buffering,
//   ldmatrix) that reached a quarter of the bound, needed a separate delta
//   pass and spilled at D = 16 and 32.  One block per (b*h, q tile), heavy
//   (late, causal) tiles first: at D = 128 two warpgroups of 64 q rows (256
//   threads, one block an SM: Q and dO 32 KB each, two stages of 64-key K
//   and V tiles 32 KB each, 128 KB), at D <= 64 one warpgroup, so that
//   several blocks share an SM; at D = 256 one warpgroup too, because two
//   do not fit (Q and dO 32 KB each for 64 rows, two stages of K and V 128
//   KB: 192 KB, one block an SM), with dQ += dS K on wgmma m64n256k16 and
//   the dQ accumulator in 128 registers a thread.  Q and dO are loaded once
//   and stay in
//   shared memory; K and V stream through a ring of two stages, the loop
//   stopping at the last tile the causal mask reaches.  Thread 0 is the
//   producer, as in the forward: every TMA load (3-D maps: a ragged tail
//   reads zeros, never the next head's rows), each later K/V tile into the
//   stage the last one leaves once every warp has arrived on that stage's
//   empty barrier.  Before its loop each warpgroup computes delta =
//   rowsum(dO * O) in f32 for its 64 rows, reading O once from device
//   memory and dO from its resident (swizzled) tile, two threads a row in a
//   fixed order, and writes it for the dK/dV kernel, also for rows that see
//   no key.  Per K/V tile: S = Q K^T and dP = dO V^T on wgmma m64n64k16
//   (all four operands K-major from shared memory), one commit group; P =
//   exp2(S * scale * log2(e) - lse * log2(e)) and dS = P (dP - delta) *
//   scale in the accumulator layout, masked only on tiles that cross the
//   causal diagonal or the Tk tail, and a tile no row of the warpgroup sees
//   is skipped; f16 scales dS and the dQ accumulator per row
//   (f16_row_scale), as dK/dV does; dS rounded to the input dtype in
//   registers is wgmma's A operand for dQ += dS K, with K as the MN-major B
//   operand (the transposed descriptor of the same tile), so dS never goes
//   through shared memory.  dQ stays in f32 registers (D / 2 a thread) and
//   is stored in the input dtype with 4-byte stores.  What it still leaves:
//   S and dP computed by both backward kernels, no overlap of one tile's
//   products with the last one's elementwise work within a warpgroup, and
//   no persistent grid.
// dK/dV, bf16 and f16 (mxt_flash_attention_bwd_dkv_mma): Hopper's tensor
//   cores, wgmma on tiles that the TMA unit loads into shared memory
//   behind mbarriers (building blocks in flash_attention_sm90.cuh).  It
//   replaces an earlier mma.sync design (4 warps of 16 keys, cp.async
//   double buffering, ldmatrix) that reached a fifth of the bound:
//   Ampere's instructions reach a fraction of this card's tensor-core
//   rate.  One 256-thread block per (b*h, 128-key tile), early (heavy,
//   causal) key tiles first: two warpgroups of 64 keys each (D = 256: see
//   below).  K and V are
//   loaded once and stay in shared memory; 64-row Q and dO tiles stream
//   through a ring of two stages from the first q tile that sees the key
//   tile.  Warp 0 is the producer: lane 0 issues the TMA loads (3-D maps:
//   a ragged tail reads zeros, never the next head's rows) while every
//   lane copies its rows' -lse * log2(e) (-inf past Tq and for rows that
//   see no key) and delta beside them, first for two q tiles, then for
//   each later one into the stage the last one leaves, once every warp has
//   arrived on that stage's empty barrier; the full barrier counts the 32
//   lanes and the tiles' bytes.  (A dedicated producer warpgroup with
//   setmaxnreg giving the consumers 240 registers measured 0.26 ms against
//   0.18 at the Llama slice shape on an H100 80GB HBM3 at 700 W: ptxas
//   spilled and serialized every wgmma; with 256 threads each may hold
//   255.)  Keys are the rows of every product, so dK and dV stay in f32
//   registers (64 x D a warpgroup each, D registers a thread) and no block
//   shares an output row: no atomics, and the gradients are the same bits
//   from run to run.  At D = 256 that plan would take 512 registers a
//   thread, so the block holds 64 keys and its two warpgroups split D
//   instead: each computes S^T and dP^T for all 64 keys in full (both
//   warpgroups the same products, 1.5x the plan's operations: the simple
//   road, kept over sharing P^T and dS^T through shared memory) and owns
//   128 of the 256 columns of dK and dV, which keeps 128 accumulator
//   registers a thread as at D = 128 and one owner for each output value
//   (shared memory 192 KB: K and V 32 KB each, two stages of Q and dO 32 KB
//   each).
//   Each warpgroup, per q tile: S^T = K Q^T and dP^T = V dO^T on wgmma
//   m64n64k16 (K, V, Q and dO K-major from shared memory), one commit
//   group; P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) and dS^T =
//   P^T (dP^T - delta) * scale in the accumulator layout, masked only on
//   tiles that cross the causal diagonal or the Tk tail, and a tile no
//   query of which sees the warpgroup's keys is skipped; f16 scales each
//   row of P^T and dS^T by a power of two (f16_row_scale), bf16 needs
//   none; both are rounded to the input dtype in registers and are
//   wgmma's A operand for dV += P^T dO and dK += dS^T Q, with dO and Q as
//   MN-major B operands (the transposed descriptors of the same tiles), so
//   neither goes through shared memory.  Shared memory: 128 KB at D = 128
//   (K, V 32 KB each, two stages of Q and dO 32 KB each), one block an SM.
//   What it still leaves: no overlap of one q tile's products with the
//   last one's elementwise work within a warpgroup, dK and dV stored
//   through registers rather than a TMA store, S and dP computed again by
//   the dQ kernel, and no persistent grid.
// dQ, f32 (mxt_flash_attention_bwd_dq_fma): one 256-thread block per (b*h,
//   64-row q tile), delta of its rows first (a thread a row, from the dO
//   tile and O), then a loop over 64-row k tiles that stops at the last
//   tile the causal mask reaches; Q, dO, K, V and dS as f32 tiles in shared
//   memory (149 KB at D = 128), dQ in registers, synchronous loads.  At
//   D = 256 four f32 tiles do not fit (280 KB): K and V take turns in one
//   buffer (V for dP, then K for S and dS K; 215 KB).
// dK/dV, f32 (mxt_flash_attention_bwd_dkv_fma): one 256-thread block per
//   (b*h, 64-row k tile), K and V resident, a loop over 64-row q tiles;
//   P^T and dS^T go through shared memory, dK and dV accumulate in
//   registers (166 KB of shared memory at D = 128).  At D = 256 that
//   plan needs 297 KB, so Q and dO take turns in one buffer and P^T and
//   dS^T in one tile: Q for S^T, dO for dP^T and dV += P^T dO, then Q
//   again for dK += dS^T Q (215 KB).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "flash_attention_mma.cuh"
#include "flash_attention_sm90.cuh"

namespace {

constexpr int kBlock = 64;  // rows of a q tile and of a k tile
constexpr int kThreads = 256;
constexpr int kLdS = kBlock + 1;  // padded row stride of the 64x64 tiles

// Rows [row0, row0 + 64) of a (rows, D) matrix into shared memory with row
// stride D + 1; rows past the end read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int rows) {
  for (int e = threadIdx.x; e < kBlock * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < rows ? src[(size_t)gr * D + c] : 0.f;
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

// D = 256: two f32 operand tiles share one buffer, in turns (the notes
// above), so that the kernel fits a block's shared memory
template <int D>
__host__ __device__ constexpr bool one_buffer() {
  return D > 128;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles (row stride D + 1; k and v one tile at D = 256), the
  // dS tile, lse and delta
  constexpr int kTiles = one_buffer<D>() ? 3 : 4;
  return sizeof(float) *
         (size_t)(kTiles * kBlock * (D + 1) + kBlock * kLdS + 2 * kBlock);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles (q and dO one tile at D = 256), the P^T and dS^T
  // tiles (one at D = 256), lse and delta
  constexpr int kTiles = one_buffer<D>() ? 3 : 4;
  constexpr int kSTiles = one_buffer<D>() ? 1 : 2;
  return sizeof(float) * (size_t)(kTiles * kBlock * (D + 1) +
                                  kSTiles * kBlock * kLdS + 2 * kBlock);
}

// acc[i][j] = row ty + 16 i of a . row tx + 16 j of b (64-row tiles of row
// stride D + 1), summed over D in element order
template <int D>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          float (&acc)[4][4]) {
  constexpr int kLd = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += t (64 x 64, row stride kLdS) times m (64 x D, row stride
// D + 1) at row ty + 16 i and column tx + 16 j, summed in row order of m
template <int D>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][D / 16],
                                                const float* t,
                                                const float* m) {
  constexpr int kLd = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int kk = 0; kk < kBlock; ++kk) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = t[(ty + 16 * i) * kLdS + kk];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float x = m[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(w[i], x, acc[i][j]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     float* __restrict__ dq, int tq, int tk, int causal,
                     float scale) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;  // accumulator columns per thread
  constexpr bool kOneBuf = one_buffer<D>();
  extern __shared__ float smem[];
  float* qs = smem;                // kBlock x kLd
  float* dos = qs + kBlock * kLd;  // kBlock x kLd
  float* ks = dos + kBlock * kLd;  // kBlock x kLd
  float* vs = kOneBuf ? ks : ks + kBlock * kLd;  // kBlock x kLd
  float* dss = vs + kBlock * kLd;  // kBlock x kLdS
  float* lse_s = dss + kBlock * kLdS;
  float* delta_s = lse_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // heavy tiles first
  const float* kb = k + bh * (size_t)tk * D;
  const float* vb = v + bh * (size_t)tk * D;
  const int offset = tk - tq;

  load_tile<D>(qs, q + bh * (size_t)tq * D, q0, tq);
  load_tile<D>(dos, dout + bh * (size_t)tq * D, q0, tq);
  __syncthreads();
  // lse, and delta = rowsum(dO * O) of the tile's rows, in element order,
  // written for every row (rows past the end see no key)
  if (tid < kBlock) {
    const int row = q0 + tid;
    float sum = 0.f;
    if (row < tq) {
      const float* orow = o + (bh * (size_t)tq + row) * D;
      for (int d = 0; d < D; ++d) sum = fmaf(dos[tid * kLd + d], orow[d], sum);
      delta[bh * (size_t)tq + row] = sum;
    }
    lse_s[tid] = row < tq ? lse[bh * (size_t)tq + row] : -INFINITY;
    delta_s[tid] = sum;
  }
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
    load_tile<D>(vs, vb, k0, tk);
    if constexpr (!kOneBuf) load_tile<D>(ks, kb, k0, tk);
    __syncthreads();

    // dP and S for rows ty + 16 i and columns tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<D>(dos, vs, dp);
    if constexpr (kOneBuf) {
      __syncthreads();  // every thread is done reading V
      load_tile<D>(ks, kb, k0, tk);
      __syncthreads();
    }
    tile_dots<D>(qs, ks, s);
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

    tile_accumulate<D>(acc, dss, ks);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos < tq) {
      float* row = dq + (bh * (size_t)tq + qpos) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) row[tx + 16 * j] = acc[i][j];
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
  constexpr bool kOneBuf = one_buffer<D>();
  extern __shared__ float smem[];
  float* ks = smem;                // kBlock x kLd, resident
  float* vs = ks + kBlock * kLd;   // kBlock x kLd, resident
  float* qs = vs + kBlock * kLd;   // kBlock x kLd, this q tile
  float* dos = kOneBuf ? qs : qs + kBlock * kLd;  // kBlock x kLd, this q tile
  float* ps = dos + kBlock * kLd;  // kBlock x kLdS: P^T (k rows, q columns)
  float* dss = kOneBuf ? ps : ps + kBlock * kLdS;  // kBlock x kLdS: dS^T
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

  load_tile<D>(ks, k + bh * (size_t)tk * D, k0, tk);
  load_tile<D>(vs, v + bh * (size_t)tk * D, k0, tk);

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
    load_tile<D>(qs, qb, q0, tq);
    if constexpr (!kOneBuf) load_tile<D>(dos, dob, q0, tq);
    load_rows(lse_s, delta_s, lseb, deltab, q0, tq);
    __syncthreads();

    // S^T and dP^T for k rows ty + 16 i and q columns tx + 16 j
    float st[4][4], dpt[4][4];
    tile_dots<D>(ks, qs, st);
    if constexpr (kOneBuf) {
      __syncthreads();  // every thread is done reading Q
      load_tile<D>(dos, dob, q0, tq);
      __syncthreads();
    }
    tile_dots<D>(vs, dos, dpt);
    // P^T and dS^T in place of S^T and dP^T
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
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - dl) * scale;
        ps[r * kLdS + c] = p;
        if constexpr (!kOneBuf) dss[r * kLdS + c] = dpt[i][j];
      }
    }
    __syncthreads();  // P^T (and dS^T) are complete

    tile_accumulate<D>(dv_acc, ps, dos);  // dV += P^T dO
    if constexpr (kOneBuf) {
      __syncthreads();  // every thread is done with P^T and dO
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dss[(ty + 16 * i) * kLdS + tx + 16 * j] = dpt[i][j];
      load_tile<D>(qs, qb, q0, tq);
      __syncthreads();
    }
    tile_accumulate<D>(dk_acc, dss, qs);  // dK += dS^T Q
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

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int bh, int tq, int tk,
                      int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tq == 0) return cudaSuccess;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  fa_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), tq, tk, causal,
      scale);
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

// ---- dQ on the tensor cores (bf16, f16): wgmma on TMA tiles, delta in ---

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDqStages = 2;   // K/V tiles in flight
constexpr int kDqBlockK = 64;  // keys a K/V tile

// The plan of the dQ design at head dim D: at D = 128 two warpgroups (128 q
// rows) share each K/V tile, one block an SM; at D <= 64 one warpgroup (64
// rows), so that several blocks share an SM (as the forward); at D = 256 one
// warpgroup, because a second one's Q and dO do not fit.  Shared
// memory: the Q and dO tiles, kDqStages (K tile, V tile) pairs, each tile
// kBlocks column blocks of kSwz-byte rows, then delta of the block's rows,
// then the barriers; 1024 bytes of slack to align the start.
template <int D>
struct DqTiles {
  static constexpr int kGroups = D == 128 ? 2 : 1;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBlockQ = 64 * kGroups;
  static constexpr int kSwz = mxt_sm90::swizzle_bytes<D>();
  static constexpr int kBlocks = 2 * D / kSwz;
  static constexpr int kQRegion = kBlockQ * kSwz;  // one column block
  static constexpr int kKRegion = kDqBlockK * kSwz;
  static constexpr int kQBytes = kBlocks * kQRegion;
  static constexpr int kKBytes = kBlocks * kKRegion;
  static constexpr int kDeltaOffset = 2 * kQBytes + 2 * kDqStages * kKBytes;
  static constexpr int kBarOffset =
      kDeltaOffset + kBlockQ * (int)sizeof(float);
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 3 * kDqStages);
};

// K/V tile t into stage t % kDqStages (thread 0); K and V complete on
// barriers of their own
template <int D>
__device__ __forceinline__ void dq_load_kv(const CUtensorMap* k_map,
                                           const CUtensorMap* v_map,
                                           unsigned char* kvs,
                                           uint64_t* k_full, uint64_t* v_full,
                                           int t, int bh) {
  using namespace mxt_sm90;
  using L = DqTiles<D>;
  const int s = t % kDqStages;
  unsigned char* kt = kvs + s * 2 * L::kKBytes;
  unsigned char* vt = kt + L::kKBytes;
  mbar_arrive_expect_tx(&k_full[s], L::kKBytes);
  for (int c = 0; c < L::kBlocks; ++c)
    tma_load_3d(kt + c * L::kKRegion, k_map, &k_full[s], c * L::kSwz / 2,
                t * kDqBlockK, bh);
  mbar_arrive_expect_tx(&v_full[s], L::kKBytes);
  for (int c = 0; c < L::kBlocks; ++c)
    tma_load_3d(vt + c * L::kKRegion, v_map, &v_full[s], c * L::kSwz / 2,
                t * kDqBlockK, bh);
}

// The two values of a packed pair of T as f32
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u);

template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof(v));
  return __bfloat1622float2(v);
}

template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
  __half2 v;
  memcpy(&v, &u, sizeof(v));
  return __half22float2(v);
}

// sum + the dot product of eight values of T each, in element order
template <typename T>
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float sum) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = unpack2<T>(av[i]), y = unpack2<T>(bv[i]);
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
  }
  return sum;
}

template <typename T, int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
    fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const T* __restrict__ o,
                           const float* __restrict__ lse,
                           float* __restrict__ delta, T* __restrict__ dq,
                           int tq, int tk, int causal, float scale) {
  using namespace mxt_sm90;
  using namespace mxt_mma;
  using L = DqTiles<D>;
  constexpr int kSwz = L::kSwz;
  constexpr int kSteps = kSwz / 32;     // k16 steps a column block row
  constexpr int kKN = kDqBlockK / 8;    // n8 tiles of S and dP
  constexpr int kDN = D / 8;            // n8 tiles of dQ
  constexpr bool kF16 = std::is_same<T, __half>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = qs + L::kQBytes;
  unsigned char* kvs = dos + L::kQBytes;  // stage s: K, then V
  float* delta_s = reinterpret_cast<float*>(smem + L::kDeltaOffset);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kDqStages;
  uint64_t* empty = v_full + kDqStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kBlockQ;  // heavy first
  const int offset = tk - tq;
  int n_tiles = (tk + kDqBlockK - 1) / kDqBlockK;
  if (causal) {
    const int k_last = min(q0 + L::kBlockQ, tq) - 1 + offset;
    n_tiles = k_last < 0 ? 0 : min(n_tiles, k_last / kDqBlockK + 1);
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * L::kGroups);  // every warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // thread 0 issues every load: Q and dO (always: delta needs dO even where
  // no key is seen) and the first kDqStages K/V tiles now, then each later
  // tile as the stage it goes to is released
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(q_full, 2 * L::kQBytes);
    for (int c = 0; c < L::kBlocks; ++c) {
      tma_load_3d(qs + c * L::kQRegion, &q_map, q_full, c * kSwz / 2, q0, bh);
      tma_load_3d(dos + c * L::kQRegion, &do_map, q_full, c * kSwz / 2, q0,
                  bh);
    }
    for (int t = 0; t < kDqStages && t < n_tiles; ++t)
      dq_load_kv<D>(&k_map, &v_map, kvs, k_full, v_full, t, bh);
  }

  // warpgroup wg: q rows row0 .. row0 + 63
  const int wg = threadIdx.x / 128;
  const int wt = threadIdx.x & 127;  // thread of the warpgroup
  const int warp = wt >> 5, lane = threadIdx.x & 31;
  const int quad_col = 2 * (lane & 3);
  const int row0 = q0 + 64 * wg;
  const int row_a = row0 + warp * 16 + (lane >> 2);  // and row_a + 8
  // the last key a row of this warpgroup sees (-1: it has no rows)
  const int key_last = row0 >= tq ? -1
                       : causal   ? min(row0 + 63, tq - 1) + offset
                                  : tk - 1;
  const uint32_t q_addr = smem_u32(qs) + 64 * wg * kSwz;
  const uint32_t do_addr = smem_u32(dos) + 64 * wg * kSwz;

  // delta = rowsum(dO * O) in f32 for the warpgroup's 64 rows, O read once
  // from device memory and dO from its resident (swizzled) tile: two
  // threads a row, each over its half of D in element order, then their
  // sum; written for every row, also one that sees no key
  mbar_wait(q_full, 0);
  {
    const int r = 64 * wg + (wt >> 1), half = wt & 1;  // r: row of the tile
    const int row = q0 + r;
    float sum = 0.f;
    if (row < tq) {
      const T* orow = o + ((size_t)bh * tq + row) * D;
#pragma unroll
      for (int c = half * D / 16; c < (half + 1) * D / 16; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 gv = *reinterpret_cast<const uint4*>(
            dos + (c * 16 / kSwz) * L::kQRegion +
            swizzled<kSwz>(r, (c * 16) % kSwz));
        sum = dot8<T>(gv, ov, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      delta_s[r] = sum;
      if (row < tq) delta[(size_t)bh * tq + row] = sum;
    }
    warpgroup_sync(wg);
  }
  // -lse * log2(e) (-inf for rows that see no key or lie past the end) and
  // delta of this thread's rows row_a + 8h
  float nlse[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    const float l = row < tq ? lse[(size_t)bh * tq + row] : -INFINITY;
    nlse[h] = isfinite(l) ? -l * kLog2e : -INFINITY;
    dl[h] = delta_s[row - q0];
  }

  const float scale_log2 = scale * kLog2e;
  // f16: per-row powers of two for dS (f16_row_scale)
  int e_ds[2] = {kRowScaleMax, kRowScaleMax};
  float acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kDqStages;
    const uint32_t parity = (t / kDqStages) & 1;
    // the last tile's stage takes tile t - 1 + kDqStages once every warp
    // is done with it
    if (threadIdx.x == 0 && t > 0 && t - 1 + kDqStages < n_tiles) {
      mbar_wait(&empty[(t - 1) % kDqStages], ((t - 1) / kDqStages) & 1);
      dq_load_kv<D>(&k_map, &v_map, kvs, k_full, v_full, t - 1 + kDqStages,
                    bh);
    }
    const int k0 = t * kDqBlockK;
    mbar_wait(&k_full[s], parity);
    mbar_wait(&v_full[s], parity);
    if (k0 > key_last) {  // no row of this warpgroup sees the tile
      // the stage is released only once filled: a warpgroup that skips
      // never runs a round ahead of the other one on the empty barrier
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t k_addr = smem_u32(kvs) + s * 2 * L::kKBytes;
    const uint32_t v_addr = k_addr + L::kKBytes;

    // S = Q K^T and dP = dO V^T for the warpgroup's 64 rows and the tile's
    // 64 keys, one commit group
    float sc[kKN][4], dp[kKN][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % kSteps) * 32;
      const uint32_t qo = (kk / kSteps) * L::kQRegion + col;
      const uint32_t ko = (kk / kSteps) * L::kKRegion + col;
      wgmma_ss_step<T>(sc, desc<kSwz>(q_addr + qo, 16, 8 * kSwz),
                       desc<kSwz>(k_addr + ko, 16, 8 * kSwz), kk);
      wgmma_ss_step<T>(dp, desc<kSwz>(do_addr + qo, 16, 8 * kSwz),
                       desc<kSwz>(v_addr + ko, 16, 8 * kSwz), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);

    // dS in place of dP; values e = 2h, 2h + 1 belong to row row_a + 8h.
    // Only tiles on the causal diagonal or the Tk tail hold masked pairs.
    const bool edge =
        k0 + kDqBlockK > tk || (causal && k0 + kDqBlockK - 1 > row0 + offset);
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(fmaf(sc[j][e], scale_log2, nlse[h]));
        if (edge) {
          const int key = k0 + j * 8 + quad_col + (e & 1);
          if (key >= tk || (causal && key > row_a + 8 * h + offset)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl[h]) * scale;
      }
    if constexpr (kF16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) f16_row_scale(dp, acc, e_ds[h], h);
    }

    // dQ += dS K: dS rounded to T in registers (wgmma's A), K MN-major
    // (the transposed descriptor of the same tile)
    uint32_t da[kDqBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < kDqBlockK / 16; ++j)
      acc_to_a<T>(da[j], dp[2 * j], dp[2 * j + 1]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kDqBlockK / 16; ++j)
      wgmma_rs<T>(acc, da[j],
                  desc<kSwz>(k_addr + j * 16 * kSwz, L::kKRegion, 8 * kSwz));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row < tq) {
      T* qrow = dq + ((size_t)bh * tq + row) * D + quad_col;
      const float f = kF16 ? pow2(-e_ds[h]) : 1.f;
#pragma unroll
      for (int j = 0; j < kDN; ++j)
        *reinterpret_cast<uint32_t*>(qrow + j * 8) =
            pack2<T>(acc[j][2 * h] * f, acc[j][2 * h + 1] * f);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, int bh, int tq, int tk,
                            int causal, float scale, cudaStream_t stream) {
  using L = DqTiles<D>;
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tq == 0) return cudaSuccess;
  // at Tk = 0 no K/V tile is loaded; the maps need a tensor all the same
  const bool no_keys = tk == 0;
  CUtensorMap q_map, k_map, v_map, do_map;
  if ((err = mxt_sm90::make_map<T, D>(&q_map, q, bh, tq, L::kBlockQ)) ||
      (err = mxt_sm90::make_map<T, D>(&k_map, no_keys ? q : k, bh,
                                      no_keys ? tq : tk, kDqBlockK)) ||
      (err = mxt_sm90::make_map<T, D>(&v_map, no_keys ? q : v, bh,
                                      no_keys ? tq : tk, kDqBlockK)) ||
      (err = mxt_sm90::make_map<T, D>(&do_map, dout, bh, tq, L::kBlockQ)))
    return err;
  const dim3 grid(bh, (tq + L::kBlockQ - 1) / L::kBlockQ);
  fa_bwd_dq_wgmma_kernel<T, D><<<grid, L::kThreads, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), tq, tk, causal, scale);
  return cudaGetLastError();
}

// ---- dK/dV on the tensor cores (bf16, f16): wgmma on TMA tiles -------------

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kWgBlockQ = 64;    // q rows a streamed Q/dO tile
constexpr int kWgStages = 2;     // Q/dO tiles in flight

// The plan of the dK/dV design at head dim D: the block's two warpgroups
// take 64 keys each (128 keys a block), or at D = 256 the same 64 keys,
// each owning D / 2 columns of dK and dV (kSplit).  Shared memory: the
// resident K and V tiles, kWgStages (Q tile, dO tile) pairs (each tile
// kBlocks column blocks of kSwz-byte rows), then -lse * log2(e) and delta
// of each stage's rows, then the barriers; 1024 bytes of slack to align
// the start
template <int D>
struct DkvTiles {
  static constexpr int kSplit = D == 256 ? 2 : 1;  // warpgroups a key
  static constexpr int kBlockK = 128 / kSplit;      // keys a block
  static constexpr int kCols = D / kSplit;  // dK/dV columns a warpgroup
  static constexpr int kSwz = mxt_sm90::swizzle_bytes<D>();
  static constexpr int kBlocks = 2 * D / kSwz;
  static constexpr int kKRegion = kBlockK * kSwz;  // one column block
  static constexpr int kQRegion = kWgBlockQ * kSwz;
  static constexpr int kKBytes = kBlocks * kKRegion;
  static constexpr int kQBytes = kBlocks * kQRegion;
  static constexpr int kRowsOffset = 2 * kKBytes + 2 * kWgStages * kQBytes;
  static constexpr int kBarOffset =
      kRowsOffset + 2 * kWgStages * kWgBlockQ * (int)sizeof(float);
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kWgStages);
};

// Warp 0 fills stage (t - t_first) % kWgStages with q tile t: every lane
// writes -lse * log2(e) (-inf past Tq and for rows that see no key) and
// delta of its rows, lane 0 issues the Q and dO loads; the stage's full
// barrier counts the 32 lanes and the tiles' bytes.
template <int D>
__device__ __forceinline__ void dkv_load_q(
    const CUtensorMap* q_map, const CUtensorMap* do_map, const float* lse,
    const float* delta, unsigned char* qdos, float* nlse_s, float* delta_s,
    uint64_t* full, int t, int t_first, int bh, int tq, int lane) {
  using namespace mxt_sm90;
  using L = DkvTiles<D>;
  const int s = (t - t_first) % kWgStages;
  const int q0 = t * kWgBlockQ;
  for (int r = lane; r < kWgBlockQ; r += 32) {
    const int row = q0 + r;
    const float l = row < tq ? lse[(size_t)bh * tq + row] : -INFINITY;
    nlse_s[s * kWgBlockQ + r] = isfinite(l) ? -l * kLog2e : -INFINITY;
    delta_s[s * kWgBlockQ + r] =
        row < tq ? delta[(size_t)bh * tq + row] : 0.f;
  }
  if (lane == 0) {
    unsigned char* qt = qdos + s * 2 * L::kQBytes;
    mbar_arrive_expect_tx(&full[s], 2 * L::kQBytes);
    for (int c = 0; c < L::kBlocks; ++c) {
      tma_load_3d(qt + c * L::kQRegion, q_map, &full[s], c * L::kSwz / 2, q0,
                  bh);
      tma_load_3d(qt + L::kQBytes + c * L::kQRegion, do_map, &full[s],
                  c * L::kSwz / 2, q0, bh);
    }
  } else {
    mbar_arrive(&full[s]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int tq,
                            int tk, int causal, float scale) {
  using namespace mxt_sm90;
  using namespace mxt_mma;
  using L = DkvTiles<D>;
  constexpr int kSwz = L::kSwz;
  constexpr int kSteps = kSwz / 32;   // k16 steps a column block row
  constexpr int kQN = kWgBlockQ / 8;  // n8 tiles over a q tile
  constexpr int kDN = L::kCols / 8;   // n8 tiles over the owned columns
  constexpr bool kF16 = std::is_same<T, __half>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = ks + L::kKBytes;
  unsigned char* qdos = vs + L::kKBytes;  // stage s: Q, then dO
  float* nlse_s = reinterpret_cast<float*>(smem + L::kRowsOffset);
  float* delta_s = nlse_s + kWgStages * kWgBlockQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kWgStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * L::kBlockK;  // early (heavy) k tiles first
  const int offset = tk - tq;
  // causal: query i sees key j iff i >= j - offset, so the first q row that
  // sees any key of this tile is k0 - offset
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int n_q = (tq + kWgBlockQ - 1) / kWgBlockQ;
  const int t_first = q_first < tq ? q_first / kWgBlockQ : n_q;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 32);  // warp 0's lanes
      mbar_init(&empty[s], 8);  // every warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // warp 0 issues every load: K and V and the first kWgStages q tiles now,
  // then each later q tile as the stage it goes to is released
  if (threadIdx.x < 32 && t_first < n_q) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKBytes);
      for (int c = 0; c < L::kBlocks; ++c) {
        tma_load_3d(ks + c * L::kKRegion, &k_map, kv_full, c * kSwz / 2, k0,
                    bh);
        tma_load_3d(vs + c * L::kKRegion, &v_map, kv_full, c * kSwz / 2, k0,
                    bh);
      }
    }
    for (int t = t_first; t < t_first + kWgStages && t < n_q; ++t)
      dkv_load_q<D>(&q_map, &do_map, lse, delta, qdos, nlse_s, delta_s, full,
                    t, t_first, bh, tq, lane);
  }

  // warpgroup wg: keys kw0 .. kw0 + 63, columns col0 .. col0 + kCols - 1
  // of dK and dV
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x & 127) >> 5;
  const int quad_col = 2 * (lane & 3);
  const int kw0 = k0 + (L::kSplit == 1 ? 64 * wg : 0);
  const int col0 = L::kSplit == 1 ? 0 : wg * L::kCols;
  const int key_a = kw0 + warp * 16 + (lane >> 2);  // and key_a + 8
  const uint32_t k_addr = smem_u32(ks) + (kw0 - k0) * kSwz;
  const uint32_t v_addr = smem_u32(vs) + (kw0 - k0) * kSwz;
  // the owned columns' first column block of a Q or dO tile
  const uint32_t col_off = (col0 * 2 / kSwz) * L::kQRegion;

  const float scale_log2 = scale * kLog2e;
  // f16: per-row powers of two for P^T and dS^T (f16_row_scale)
  int e_p[2] = {kRowScaleMax, kRowScaleMax};
  int e_ds[2] = {kRowScaleMax, kRowScaleMax};
  float dk_acc[kDN][4], dv_acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  if (t_first < n_q) mbar_wait(kv_full, 0);
  for (int t = t_first; t < n_q; ++t) {
    const int i = t - t_first;
    const int s = i % kWgStages;
    const uint32_t parity = (i / kWgStages) & 1;
    // the last tile's stage takes tile t - 1 + kWgStages once every warp
    // is done with it
    if (threadIdx.x < 32 && i > 0 && t - 1 + kWgStages < n_q) {
      mbar_wait(&empty[(i - 1) % kWgStages], ((i - 1) / kWgStages) & 1);
      dkv_load_q<D>(&q_map, &do_map, lse, delta, qdos, nlse_s, delta_s, full,
                    t - 1 + kWgStages, t_first, bh, tq, lane);
    }
    const int q0 = t * kWgBlockQ;
    // no query of the tile sees a key of this warpgroup
    if (kw0 >= tk || (causal && kw0 > q0 + kWgBlockQ - 1 + offset)) {
      // the stage is released only once filled: a warpgroup that skips
      // never runs a round ahead of the other one on the empty barrier
      mbar_wait(&full[s], parity);
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t q_addr = smem_u32(qdos) + s * 2 * L::kQBytes;
    const uint32_t do_addr = q_addr + L::kQBytes;
    const float* nl = nlse_s + s * kWgBlockQ;
    const float* dl = delta_s + s * kWgBlockQ;

    // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys
    float st[kQN][4], dpt[kQN][4];
    mbar_wait(&full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % kSteps) * 32;
      wgmma_ss_step<T>(st,
                       desc<kSwz>(k_addr + (kk / kSteps) * L::kKRegion + col,
                                  16, 8 * kSwz),
                       desc<kSwz>(q_addr + (kk / kSteps) * L::kQRegion + col,
                                  16, 8 * kSwz),
                       kk);
      wgmma_ss_step<T>(dpt,
                       desc<kSwz>(v_addr + (kk / kSteps) * L::kKRegion + col,
                                  16, 8 * kSwz),
                       desc<kSwz>(do_addr + (kk / kSteps) * L::kQRegion + col,
                                  16, 8 * kSwz),
                       kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(st);
    fence_operand(dpt);

    // P^T and dS^T in place; only tiles on the causal diagonal or the Tk
    // tail hold masked pairs (q rows past Tq have -lse = -inf: P^T = 0)
    const bool edge = kw0 + 64 > tk || (causal && kw0 + 63 > q0 + offset);
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

    // dV += P^T dO and dK += dS^T Q: both A operands rounded to T in
    // registers, dO and Q MN-major
    uint32_t pa[kWgBlockQ / 16][4], da[kWgBlockQ / 16][4];
#pragma unroll
    for (int j = 0; j < kWgBlockQ / 16; ++j) {
      acc_to_a<T>(pa[j], st[2 * j], st[2 * j + 1]);
      acc_to_a<T>(da[j], dpt[2 * j], dpt[2 * j + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kWgBlockQ / 16; ++j) {
      wgmma_rs<T>(dv_acc, pa[j],
                  desc<kSwz>(do_addr + col_off + j * 16 * kSwz, L::kQRegion,
                             8 * kSwz));
      wgmma_rs<T>(dk_acc, da[j],
                  desc<kSwz>(q_addr + col_off + j * 16 * kSwz, L::kQRegion,
                             8 * kSwz));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dv_acc);
    fence_operand(dk_acc);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_a + 8 * h;
    if (key < tk) {
      T* krow = dk + ((size_t)bh * tk + key) * D + col0 + quad_col;
      T* vrow = dv + ((size_t)bh * tk + key) * D + col0 + quad_col;
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
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int causal, float scale,
                             cudaStream_t stream) {
  using L = DkvTiles<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  if (bh == 0 || tk == 0) return cudaSuccess;
  if (tq == 0) {  // no query: dK = dV = 0 (and no Q map to make)
    const size_t bytes = (size_t)bh * tk * D * sizeof(T);
    if ((err = cudaMemsetAsync(dk, 0, bytes, stream))) return err;
    return cudaMemsetAsync(dv, 0, bytes, stream);
  }
  CUtensorMap q_map, k_map, v_map, do_map;
  if ((err = mxt_sm90::make_map<T, D>(&q_map, q, bh, tq, kWgBlockQ)) ||
      (err = mxt_sm90::make_map<T, D>(&k_map, k, bh, tk, L::kBlockK)) ||
      (err = mxt_sm90::make_map<T, D>(&v_map, v, bh, tk, L::kBlockK)) ||
      (err = mxt_sm90::make_map<T, D>(&do_map, dout, bh, tq, kWgBlockQ)))
    return err;
  const dim3 grid(bh, (tk + L::kBlockK - 1) / L::kBlockK);
  fa_bwd_dkv_wgmma_kernel<T, D><<<grid, kWgThreads, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_wgmma_d(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq, int bh,
                              int tq, int tk, int d, int causal, float scale,
                              cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_dq_wgmma<T, 16>(q, k, v, o, dout, lse, delta, dq, bh, tq,
                                    tk, causal, scale, stream);
    case 32:
      return launch_dq_wgmma<T, 32>(q, k, v, o, dout, lse, delta, dq, bh, tq,
                                    tk, causal, scale, stream);
    case 64:
      return launch_dq_wgmma<T, 64>(q, k, v, o, dout, lse, delta, dq, bh, tq,
                                    tk, causal, scale, stream);
    case 128:
      return launch_dq_wgmma<T, 128>(q, k, v, o, dout, lse, delta, dq, bh,
                                     tq, tk, causal, scale, stream);
    case 256:
      return launch_dq_wgmma<T, 256>(q, k, v, o, dout, lse, delta, dq, bh,
                                     tq, tk, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dkv_wgmma_d(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int bh,
                               int tq, int tk, int d, int causal, float scale,
                               cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_dkv_wgmma<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     tq, tk, causal, scale, stream);
    case 32:
      return launch_dkv_wgmma<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     tq, tk, causal, scale, stream);
    case 64:
      return launch_dkv_wgmma<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     tq, tk, causal, scale, stream);
    case 128:
      return launch_dkv_wgmma<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      tq, tk, causal, scale, stream);
    case 256:
      return launch_dkv_wgmma<T, 256>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      tq, tk, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Each returns the
// cudaError_t of its launch (0 on success; cudaErrorInvalidValue for a
// dtype or D the kernel does not take); the kernel itself runs
// asynchronously on `stream`.  The dQ kernels also write delta =
// rowsum(dO * O) in f32 (B*H, Tq), which the dK/dV kernels then read on the
// same stream.  The tensor-core designs need 16-byte aligned q, k, v, O and
// dO.
extern "C" int mxt_flash_attention_bwd_dq_mma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int bh, int tq,
    int tk, int d, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_dq_wgmma_d<__half>(q, k, v, o, dout, lse, delta, dq, bh,
                                       tq, tk, d, causal, scale, s);
    case 2:
      return launch_dq_wgmma_d<__nv_bfloat16>(q, k, v, o, dout, lse, delta,
                                              dq, bh, tq, tk, d, causal,
                                              scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int mxt_flash_attention_bwd_dq_fma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int bh, int tq,
    int tk, int d, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_dq<16>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk,
                           causal, scale, s);
    case 32:
      return launch_dq<32>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk,
                           causal, scale, s);
    case 64:
      return launch_dq<64>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk,
                           causal, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk,
                            causal, scale, s);
    case 256:
      return launch_dq<256>(q, k, v, o, dout, lse, delta, dq, bh, tq, tk,
                            causal, scale, s);
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
      return launch_dkv_wgmma_d<__half>(q, k, v, dout, lse, delta, dk, dv,
                                        bh, tq, tk, d, causal, scale, s);
    case 2:
      return launch_dkv_wgmma_d<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                               dk, dv, bh, tq, tk, d, causal,
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
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                             causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
