// The 3x3 convolution's implicit GEMM on Hopper (sm_90a), shared by kernel
// #12 (conv_nhwc.cu, NHWC y plus bias) and kernels #9 and #10
// (fused_resnet.cu, NCHW y plus bias and residual, with moments): the loop
// below is the same for all, and each kernel passes its own epilogue. The
// fp32 loop (3xTF32) further down serves #9 and #10 at fp32.
//
// Input x (N, H, W, Cin) bf16 (for #9 the pre-pass's s), weight HWIO (3, 3,
// Cin, Cout) bf16; fp32 accumulation. M = 128 output pixels, N = 128 output
// channels, K = 9 taps x Cin in chunks of KC = 64 channels (32 where Cin is
// no multiple of 64):
//   - the M tile is a BH x BW = 128 rectangle of pixels of one image (the
//     wrapper picks BW, a power of two, to waste the fewest pixels: 2 x 64
//     at W = 64, 4 x 32 at W = 32, 1 x 128 at W >= 128);
//   - one producer warp issues, for each (tap, channel chunk), one TMA box
//     of x at (ci0, w0 + dx - 1, h0 + dy - 1, n), BH x BW pixels of KC
//     channels; TMA zero-fills whatever lies outside the image, which is
//     the halo and the ragged edge, 128- (or 64-) byte swizzled; and two
//     boxes of the HWIO weight, KC input channels x 64 output channels
//     each, 128-byte swizzled: Cout is contiguous, so the weight is an
//     MN-major B operand that wgmma reads transposed, and no copy of it is
//     made (past Cout it is zero-filled and never stored). A ring of STAGES
//     stages with a full and an empty mbarrier each, two blocks an SM, so
//     one block's prologue and epilogue overlap the other's products;
//   - two consumer warpgroups, 64 pixels each, run wgmma m64n128k16 on the
//     stage from shared memory (64 fp32 accumulators a thread), keep one
//     commit group in flight, and release a stage once its group is done;
//   - then the epilogue: epi(acc, smem, tile, wg, warp, lane), on the
//     consumer threads only. The ring is free once every consumer has passed
//     conv3x3::consumers_sync() after its products: an epilogue may stage its
//     output there.
// Each output is written once by one block, with no atomics, so runs are
// bit-equal.

#pragma once

#include "sm90_wgmma.cuh"

namespace vcd {
namespace conv3x3 {

using namespace vcd::sm90;

constexpr int BM = 128;                        // output pixels per block
constexpr int BN = 128;                        // output channels per block
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;                   // warpgroups, 64 pixels each
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int STAGE_MAX = (BM + BN) * 64 * 2;  // bytes of one stage at KC = 64
constexpr int RING = STAGES * STAGE_MAX;       // free for the epilogue after the loop
constexpr int SMEM = RING + 1024 + 2 * STAGES * 8;

// The block's output tile: image n, pixels from (h0, w0) in a bh x bw
// rectangle, output channels from co0. The consumer thread with accumulator
// row m (wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * half) holds pixel
// (h0 + m / bw, w0 + m % bw); acc[4j + 2 half + e] is output channel co0 +
// 8j + 2 (lane % 4) + e.
struct Tile {
  int n, h0, w0, co0, bw;
};

// Synchronises the consumer threads (named barrier 1): the producer warp has
// left the loop.
__device__ __forceinline__ void consumers_sync() { named_barrier(1, CONSUMERS * 128); }

// The loop, then epi on the consumer threads. Grid (tiles_h * tiles_w,
// ceil(Cout / BN), N); THREADS threads; SMEM bytes of dynamic shared memory.
template <int KC, class Epilogue>
__device__ __forceinline__ void conv3x3_wgmma(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                              int wd, int cin, int bw, const Epilogue& epi) {
  constexpr int A_BYTES = BM * KC * 2, B_BYTES = BN * KC * 2, STAGE = A_BYTES + B_BYTES;
  constexpr int SW = KC * 2;  // the swizzle: one row of KC channels
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = BM / bw, tiles_w = (wd + bw - 1) / bw;
  const Tile tile = {static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.x / tiles_w) * bh,
                     static_cast<int>(blockIdx.x % tiles_w) * bw,
                     static_cast<int>(blockIdx.y) * BN, bw};
  const int chunks_per_tap = cin / KC, nchunks = 9 * chunks_per_tap;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---- the producer warp: one thread keeps the ring full ----
    if (lane == 0) {
      for (int k = 0; k < nchunks; ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty[s], ((k / STAGES) - 1) & 1);
        const int tap = k / chunks_per_tap, ci0 = (k % chunks_per_tap) * KC;
        uint8_t* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load_4d(st, xmap, &full[s], ci0, tile.w0 + tap % 3 - 1, tile.h0 + tap / 3 - 1,
                    tile.n);
        tma_load_3d(st + A_BYTES, wmap, &full[s], tile.co0, ci0, tap);
        tma_load_3d(st + A_BYTES + KC * 128, wmap, &full[s], tile.co0 + 64, ci0, tap);
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int k = 0; k < nchunks; ++k) {
    const int s = k % STAGES;
    mbar_wait(&full[s], (k / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE;
    const uint64_t da = make_desc(st + wg * 64 * SW, SW);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      wgmma_ss_m64n128k16<1>(acc, da + 2 * kk,  // 32 bytes on in A's K; 16 rows in B's
                             make_desc_mn(st + A_BYTES + kk * 16 * 128, KC * 128, 1024));
    wgmma_commit();
    // chunk k - 1's products are done: its stage goes back to the producer
    wgmma_wait<1>();
    fence_regs(acc);
    if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  epi(acc, smem, tile, wg, warp, lane);
}

// ---- the fp32 loop (3xTF32) ------------------------------------------------ //
// The same implicit GEMM in fp32 for #9 and #10 at fp32: every product x*w
// is three TF32 products, hi hi + hi lo + lo hi, with hi = tf32(v) and lo =
// tf32(v - hi) rounded to nearest (sm90_wgmma.cuh's to_tf32), on wgmma
// m64n128k8 with fp32 accumulation. tf32 wgmma takes K-major operands only,
// so the weight comes K-major too: (3, 3, Cout, Cin), rows of Cin. Both
// operands arrive split: x as two NHWC planes (hi, then lo: 2N images of
// (H, W, Cin) fp32, the pre-pass's work) and the weight as (2, 3, 3, Cout,
// Cin) (hi, then lo: 18 taps), so a stage is four TMA boxes of 32 channels,
// one 128-byte swizzled row a pixel or an output channel: A hi, A lo, B hi,
// B lo, 16 KB each. The tensor cores truncate each fp32 accumulation (round
// toward zero), so no accumulation is long: each group of F32_GROUP chunks
// (one tap's 64 channels, 8 k-steps of 3 products) goes into a fresh
// accumulator, added to the running sum in fp32 registers once the group
// is done; the sum is what the epilogue gets. One block an SM (64 KB
// stages), F32_STAGES stages.
constexpr int F32_KC = 32;                         // fp32 channels a chunk: a 128-byte row
constexpr int F32_GROUP = 2;                       // chunks a fresh accumulation
constexpr int F32_STAGES = 3;
constexpr int F32_TILE = BM * F32_KC * 4;          // A or B, hi or lo: 16 KB
constexpr int F32_STAGE = 4 * F32_TILE;
constexpr int F32_RING = F32_STAGES * F32_STAGE;   // free for the epilogue after the loop
constexpr int F32_SMEM = F32_RING + 1024 + 2 * F32_STAGES * 8;
static_assert(BM == BN, "A and B tiles are the same size");
static_assert(BN * (BM + 4) * 4 <= F32_RING, "an epilogue's staging fits the fp32 ring");

// The fp32 loop, then epi on the consumer threads, as conv3x3_wgmma. x holds
// 2 * n_batch images (hi, then lo); grid, THREADS as the bf16 loop,
// F32_SMEM bytes of dynamic shared memory. cin a multiple of 64.
template <class Epilogue>
__device__ __forceinline__ void conv3x3_tf32x3(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                               int n_batch, int wd, int cin, int bw,
                                               const Epilogue& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F32_RING);
  uint64_t* empty = full + F32_STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = BM / bw, tiles_w = (wd + bw - 1) / bw;
  const Tile tile = {static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.x / tiles_w) * bh,
                     static_cast<int>(blockIdx.x % tiles_w) * bw,
                     static_cast<int>(blockIdx.y) * BN, bw};
  const int chunks_per_tap = cin / F32_KC, nchunks = 9 * chunks_per_tap;

  if (tid == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---- the producer warp: one thread keeps the ring full ----
    if (lane == 0) {
      for (int k = 0; k < nchunks; ++k) {
        const int s = k % F32_STAGES;
        if (k >= F32_STAGES) mbar_wait(&empty[s], ((k / F32_STAGES) - 1) & 1);
        const int tap = k / chunks_per_tap, ci0 = (k % chunks_per_tap) * F32_KC;
        const int x0 = tile.w0 + tap % 3 - 1, y0 = tile.h0 + tap / 3 - 1;
        uint8_t* st = smem + s * F32_STAGE;
        mbar_arrive_expect_tx(&full[s], F32_STAGE);
        tma_load_4d(st, xmap, &full[s], ci0, x0, y0, tile.n);
        tma_load_4d(st + F32_TILE, xmap, &full[s], ci0, x0, y0, tile.n + n_batch);
        tma_load_3d(st + 2 * F32_TILE, wmap, &full[s], ci0, tile.co0, tap);
        tma_load_3d(st + 3 * F32_TILE, wmap, &full[s], ci0, tile.co0, tap + 9);
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  const int wg = warp / 4;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.0f;

  for (int k = 0; k < nchunks; ++k) {
    const int s = k % F32_STAGES;
    mbar_wait(&full[s], (k / F32_STAGES) & 1);
    const uint8_t* st = smem + s * F32_STAGE;
    const uint64_t ahi = make_desc(st + wg * 64 * 128, 128);
    const uint64_t alo = make_desc(st + F32_TILE + wg * 64 * 128, 128);
    const uint64_t bhi = make_desc(st + 2 * F32_TILE, 128);
    const uint64_t blo = make_desc(st + 3 * F32_TILE, 128);
    const int fresh = k % F32_GROUP == 0;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F32_KC / 8; ++kk) {  // 32 bytes on in both operands' K
      wgmma_tf32<128>(acc, alo + 2 * kk, bhi + 2 * kk, fresh && kk == 0 ? 0 : 1);
      wgmma_tf32<128>(acc, ahi + 2 * kk, blo + 2 * kk);
      wgmma_tf32<128>(acc, ahi + 2 * kk, bhi + 2 * kk);
    }
    wgmma_commit();
    if (k % F32_GROUP == F32_GROUP - 1) {
      // the group is done: into the sum in fp32, and its stages go back
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      if (lane == 0)
        for (int j = k - F32_GROUP + 1; j <= k; ++j) mbar_arrive(&empty[j % F32_STAGES]);
    }
  }
  epi(sum, smem, tile, wg, warp, lane);
}

// The tensor maps of the fp32 loop: x (2n, h, wd, cin) fp32 (hi images, then
// lo) in boxes of 32 channels x bw x 128 / bw pixels; the K-major weight (18,
// cout, cin) fp32 (hi taps, then lo) in boxes of 32 x 128 output channels;
// both 128-byte swizzled.
inline cudaError_t make_maps_f32(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                                 const void* w, int n, int h, int wd, int cin, int cout,
                                 int bw) {
  const uint64_t xdims[4] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(wd),
                             static_cast<uint64_t>(h), 2ull * n};
  const uint64_t xstrides[3] = {4ull * cin, 4ull * cin * wd, 4ull * cin * wd * h};
  const uint32_t xbox[4] = {F32_KC, static_cast<uint32_t>(bw), static_cast<uint32_t>(BM / bw),
                            1};
  cudaError_t err = make_tensor_map(xmap, x, 4, xdims, xstrides, xbox, 128,
                                    CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(cout), 18};
  const uint64_t wstrides[2] = {4ull * cin, 4ull * cin * cout};
  const uint32_t wbox[3] = {F32_KC, BN, 1};
  return make_tensor_map(wmap, w, 3, wdims, wstrides, wbox, 128, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The tensor maps of the loop: x (n, h, wd, cin) bf16 in boxes of KC
// channels x bw x 128 / bw pixels, swizzled by one row of KC channels; the
// HWIO weight (9, cin, cout) bf16 in boxes of KC x 64 output channels,
// 128-byte swizzled.
inline cudaError_t make_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x, const void* w,
                             int n, int h, int wd, int cin, int cout, int bw, int kc) {
  const uint64_t xdims[4] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(wd),
                             static_cast<uint64_t>(h), static_cast<uint64_t>(n)};
  const uint64_t xstrides[3] = {2ull * cin, 2ull * cin * wd, 2ull * cin * wd * h};
  const uint32_t xbox[4] = {static_cast<uint32_t>(kc), static_cast<uint32_t>(bw),
                            static_cast<uint32_t>(BM / bw), 1};
  cudaError_t err = make_tensor_map(xmap, x, 4, xdims, xstrides, xbox, kc * 2);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {static_cast<uint64_t>(cout), static_cast<uint64_t>(cin), 9};
  const uint64_t wstrides[2] = {2ull * cout, 2ull * cout * cin};
  const uint32_t wbox[3] = {64, static_cast<uint32_t>(kc), 1};
  return make_tensor_map(wmap, w, 3, wdims, wstrides, wbox, 128);
}

// The grid of the loop: (pixel tiles, ceil(cout / BN), n).
inline dim3 grid(int n, int h, int wd, int cout, int bw) {
  const int bh = BM / bw;
  return dim3(static_cast<unsigned>(((h + bh - 1) / bh) * ((wd + bw - 1) / bw)),
              (cout + BN - 1) / BN, n);
}

}  // namespace conv3x3
}  // namespace vcd
