// The 3x3 convolution's implicit GEMM on Hopper (sm_90a), shared by kernel
// #12 (conv_nhwc.cu, NHWC y plus bias) and kernel #9 (fused_resnet.cu, NCHW y
// plus bias and residual, with moments): the loop below is the same for
// both, and each kernel passes its own epilogue.
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
