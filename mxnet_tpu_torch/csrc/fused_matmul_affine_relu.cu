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
// both f32; scale and bias (N,) f32; out (M, N) in x's dtype.  Any M; any
// N and K in f32, multiples of 8 in bf16 and f16 (the caller pads the
// rest); ragged tails past the tiles are masked or read as zeros here (the
// TPU kernel needed M, N, K to divide its 512/256/256 blocks).  bf16 and f16 products are exact products of the
// 16-bit values, summed in f32, as on the TPU's MXU (which takes bf16).
// f32 operands stay f32 (the TPU kernel rounds them to bf16 first; the
// port does not, so that an f32 model equals the JAX package's f32 XLA
// convolution).
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// ResNet-50 v1 shapes (B = 128, 224 x 224; K, N = 64 .. 2048) the function
// moves 17-257 MB and does 0.8-13.2 GFLOP a launch, so six of its eight
// shapes are bound by bytes and the two deepest (M = 6,272, N = 512) by
// operations; the 16 launches of a forward come to about 0.46 ms at the
// bound, a third of it in the two shapes with M = 401,408 and N = 64.
// Where bytes bound, the kernel's job is to stream x from device memory
// once at the memory's rate and write the output once.
//
// Two designs, chosen by the caller (ops/conv_bn_relu.py) by dtype:
//
// mxt_fused_matmul_affine_relu_mma (bf16, f16; K and N multiples of 8,
//   x, w and out 16-byte aligned, K > 0: what a TMA tensor map describes,
//   and every shape of the port's nets; the caller zero-pads K and N to
//   multiples of 8 and copies a misaligned operand elsewhere): Hopper's
//   tensor cores, wgmma on tiles that the TMA unit loads behind mbarriers
//   (flash_attention_sm90.cuh).  It replaces an mma.sync design (cp.async
//   ring, one block a tile) that lost to cuBLAS by 1.23-1.38x on three of
//   the four nets.  A persistent grid, one block an SM (sized by the
//   occupancy query), each block walking output tiles of 128 rows and BN
//   columns (tile b, b + grid, ...), the N tiles of one M tile adjacent, so
//   that x's rows are found in L2 while its neighbours read them.  288
//   threads: two consumer warpgroups (64 rows each) and a producer warp
//   whose lane 0 issues the TMA loads of x (a 128 x 64 box: K-major A) and
//   w (64 x 64 boxes: wgmma's transposed-B operand, N-major) into a ring of
//   kWgStages stages with full and empty barriers, running ahead across
//   tile boundaries, so that one tile's epilogue overlaps the next tiles'
//   loads.  Both maps are 2-D and swizzled over 128 bytes; rows and columns
//   past M, N and K read zeros.  Each consumer issues the four m64nBNk16
//   products of a K step as one group and keeps one group in flight
//   (wgmma.wait_group 1), releasing a stage when its group has completed.
//   The epilogue applies the affine and the ReLU to the f32 accumulators in
//   registers, rounds once, stages the warpgroup's 64 rows in shared memory
//   (padded rows, no bank conflicts) and writes them with 16-byte stores.
//   Where operations weigh (stages 3 and 4), what bounds the kernel is the
//   bytes a K step brings from L2 into the SMs (x's rows are read by every
//   N tile, w by every M tile): BN = 128 where N > 64, which feeds twice
//   the products of 64-column tiles from the same x bytes (15-29% faster
//   at M = 6,272, ResNet-50's stage 4 at B = 128 and stage 3 at B = 32,
//   at 0.74-1.5 waves of the SMs), and 64 where N <= 64 or 128-column
//   tiles would fill less than half the SMs (the B = 32 bucket's stage 4:
//   52 tiles of 128 columns, 104 of 64; 64 measured 14% faster there).
//   No atomics, no split over K: the same bits from run to run.  What it
//   still leaves: TMA multicast of w (and x) within a cluster, which would
//   cut those L2 bytes; a split of K where even 64-column tiles fill less
//   than a wave; a TMA store of the output; and reading NCHW directly
//   instead of the caller's (M, K) copy.
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
#include <stddef.h>
#include <stdint.h>

#include "flash_attention_mma.cuh"
#include "flash_attention_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

// relu(scale * acc + bias): two roundings (product, then sum), as the plain
// version's (acc * scale) + bias; "y < 0 ? 0 : y" keeps NaN, as torch.relu
__device__ __forceinline__ float affine_relu(float acc, float sc, float bi) {
  const float y = __fadd_rn(__fmul_rn(acc, sc), bi);
  return y < 0.f ? 0.f : y;
}

// ---- tensor-core design (bf16, f16): wgmma on TMA tiles, persistent --------

constexpr int kWgConsumers = 2;  // consumer warpgroups, 64 rows of a tile each
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // and the producer warp
constexpr int kWgBM = 64 * kWgConsumers;  // tile rows
constexpr int kWgBK = 64;                 // K step: one 128-byte swizzle span
constexpr int kWgStages = 4;              // K steps in flight

// Shared memory of the wgmma design at tile width BN: kWgStages stages of
// (x tile: kWgBM rows of 128 bytes; w tile: BN / 64 column blocks of 64
// rows of 128 bytes), then each consumer's output tile (64 rows of BN + 8
// elements), then the barriers; 1024 bytes of slack to align the start
template <int BN>
struct FusedTiles {
  static constexpr int kXBytes = kWgBM * 128;
  static constexpr int kWRegion = kWgBK * 128;  // one column block of w
  static constexpr int kWBytes = BN / 64 * kWRegion;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kLdO = BN + 8;  // output tile row stride (elements)
  static constexpr int kOutOffset = kWgStages * kStageBytes;
  static constexpr int kBarOffset = kOutOffset + kWgConsumers * 64 * kLdO * 2;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * 2 * kWgStages;
};

template <typename T, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    fused_mm_affine_relu_wgmma_kernel(
        const __grid_constant__ CUtensorMap x_map,
        const __grid_constant__ CUtensorMap w_map,
        const float* __restrict__ scale, const float* __restrict__ bias,
        T* __restrict__ out, int m, int n, int k) {
  using namespace mxt_sm90;
  using namespace mxt_mma;
  using L = FusedTiles<BN>;
  constexpr int kNT = BN / 8;  // n8 tiles of a consumer's accumulator
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kWgStages;

  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = (m + kWgBM - 1) / kWgBM * n_tiles;
  const int n_k = (k + kWgBK - 1) / kWgBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWgConsumers);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * kWgConsumers) {  // the producer warp
    if (lane == 0) {
      int it = 0;  // K steps issued by this block so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kWgBM, n0 = tile % n_tiles * BN;
        for (int kb = 0; kb < n_k; ++kb, ++it) {
          const int s = it % kWgStages;
          // the stage's last K step has been consumed
          if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
          unsigned char* st = smem + s * L::kStageBytes;
          mbar_arrive_expect_tx(&full[s], L::kStageBytes);
          tma_load_2d(st, &x_map, &full[s], kb * kWgBK, m0);
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(st + L::kXBytes + c * L::kWRegion, &w_map, &full[s],
                        n0 + 64 * c, kb * kWgBK);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
  const int wg = warp / 4;
  const int wt = threadIdx.x & 127;  // thread of the warpgroup
  const int g = lane >> 2, quad_col = 2 * (lane & 3);
  const int row_a = (warp & 3) * 16 + g;  // and row_a + 8, in the 64 rows
  T* os = reinterpret_cast<T*>(smem + L::kOutOffset) + wg * 64 * L::kLdO;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int it = 0;  // K steps consumed by this block so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kWgBM, n0 = tile % n_tiles * BN;
    for (int kb = 0; kb < n_k; ++kb, ++it) {
      const int s = it % kWgStages;
      mbar_wait(&full[s], (it / kWgStages) & 1);
      const uint32_t xa =
          smem_u32(smem + s * L::kStageBytes) + wg * 64 * 128;
      const uint32_t wa = smem_u32(smem + s * L::kStageBytes + L::kXBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_ss_tb<T>(acc, desc<128>(xa + kk * 32, 16, 1024),
                       desc<128>(wa + kk * 16 * 128, L::kWRegion, 1024),
                       kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the last K step's group has completed
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kWgStages]);
    }
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kWgStages]);

    // relu(scale * acc + bias) rounded to T into the output tile, once every
    // thread of the warpgroup is done storing the last tile from it
    warpgroup_sync(wg);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = j * 8 + quad_col;  // and col + 1
      float sc[2], bi[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gn = n0 + col + c;
        sc[c] = gn < n ? __ldg(scale + gn) : 0.f;
        bi[c] = gn < n ? __ldg(bias + gn) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(os + (row_a + 8 * h) * L::kLdO + col) =
            pack2<T>(affine_relu(acc[j][2 * h], sc[0], bi[0]),
                     affine_relu(acc[j][2 * h + 1], sc[1], bi[1]));
    }
    warpgroup_sync(wg);
    // 16-byte stores, a row's chunks side by side (N is a multiple of 8:
    // each chunk wholly in or out)
    constexpr int kChunks = BN / 8;
    for (int c = wt; c < 64 * kChunks; c += 128) {
      const int r = c / kChunks, col = c % kChunks * 8;
      const int gm = m0 + 64 * wg + r, gn = n0 + col;
      if (gm < m && gn < n)
        *reinterpret_cast<uint4*>(out + (size_t)gm * n + gn) =
            *reinterpret_cast<const uint4*>(os + r * L::kLdO + col);
    }
  }
}

constexpr int kMaxDevices = 64;

// The SMs of device dev, looked up at its first launch and kept
cudaError_t sm_count(int dev, int* sms) {
  static int cached[kMaxDevices] = {};
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err && dev < kMaxDevices) cached[dev] = *sms;
  return err;
}

// The blocks of the wgmma kernel at width BN that the current device holds
// at once (SMs times blocks an SM), after opting the kernel into its shared
// memory there; looked up at a device's first launch and kept (the
// occupancy query costs microseconds of host time a call)
template <typename T, int BN>
cudaError_t resident_blocks(int dev, int* blocks) {
  static int cached[kMaxDevices] = {};
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  const auto kernel = fused_mm_affine_relu_wgmma_kernel<T, BN>;
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FusedTiles<BN>::kSmem);
  int sms = 0, per_sm = 0;
  if (err || (err = sm_count(dev, &sms)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kWgThreads, FusedTiles<BN>::kSmem)))
    return err;
  *blocks = sms * max(per_sm, 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <typename T, int BN>
cudaError_t launch_wgmma_tile(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int m, int n,
                              int k, int dev, cudaStream_t stream) {
  using L = FusedTiles<BN>;
  int resident = 0;
  cudaError_t err = resident_blocks<T, BN>(dev, &resident);
  if (err) return err;
  CUtensorMap x_map, w_map;
  if ((err = mxt_sm90::make_map_2d<T>(&x_map, x, m, k, kWgBM)) ||
      (err = mxt_sm90::make_map_2d<T>(&w_map, w, k, n, kWgBK)))
    return err;
  const long long tiles =
      (long long)((m + kWgBM - 1) / kWgBM) * ((n + BN - 1) / BN);
  const int grid = (int)(tiles < resident ? tiles : resident);
  fused_mm_affine_relu_wgmma_kernel<T, BN>
      <<<grid, kWgThreads, L::kSmem, stream>>>(
      x_map, w_map, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), m, n, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* w, const void* scale,
                         const void* bias, void* out, int m, int n, int k,
                         cudaStream_t stream) {
  if (m == 0 || n == 0) return cudaSuccess;
  // what a TMA tensor map describes: rows of a multiple of 16 bytes from
  // a 16-byte aligned base, and at least one column; the caller pads
  // anything else
  if (k == 0 || k % 8 || n % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err || (err = sm_count(dev, &sms))) return err;
  const long long m_tiles = (m + kWgBM - 1) / kWgBM;
  // 128-column tiles (a K step's bytes from L2 feed twice the products of
  // 64-column ones), unless they would fill less than half the SMs
  if (n > 64 && 2 * m_tiles * ((n + 127) / 128) >= sms)
    return launch_wgmma_tile<T, 128>(x, w, scale, bias, out, m, n, k, dev,
                                     stream);
  return launch_wgmma_tile<T, 64>(x, w, scale, bias, out, m, n, k, dev,
                                  stream);
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
        orow[gn] = affine_relu(acc[i][j], s[j], bv[j]);
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
// kernels): _mma takes bf16 and f16, _fma f32 only.  _mma takes only what
// a TMA tensor map describes (K and N multiples of 8; x, w and out 16-byte
// aligned) and K > 0; the caller pads the rest.  Each returns the cudaError_t of its launch (0 on
// success; cudaErrorInvalidValue for operands the instance does not take);
// the kernel itself runs asynchronously on `stream`.
extern "C" int mxt_fused_matmul_affine_relu_mma(const void* x, const void* w,
                                                const void* scale,
                                                const void* bias, void* out,
                                                int m, int n, int k,
                                                int dtype, void* stream) {
  if (m < 0 || n < 0 || k < 0 || (dtype != 1 && dtype != 2))
    return cudaErrorInvalidValue;
  return dtype == 2 ? launch_wgmma<bf16>(x, w, scale, bias, out, m, n, k,
                                         static_cast<cudaStream_t>(stream))
                    : launch_wgmma<f16>(x, w, scale, bias, out, m, n, k,
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
