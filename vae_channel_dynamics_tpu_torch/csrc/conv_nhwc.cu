// The NHWC 3x3 convolution with bias, hand-written for Hopper (sm_90a), with
// no layout transposes: y = conv3x3_SAME(x, w) + b.
//
// Replaces the Pallas TPU prototype of experiments/conv_bench.py, both of its
// formulations: _conv_kernel_v9 (:34, nine (tile_h*W, Cin) @ (Cin, Cout)
// products) and _conv_kernel_v3 (:72, three (tile_h*W, 3Cin) @ (3Cin, Cout)
// products over the dx-concatenated window). v3's weight keeps v9's K order
// row for row (dx-major, then Cin: conv_bench.py:113-116), so in an implicit
// GEMM over K = 9 * Cin in the order (dy, dx, ci) the two are one loop; which
// one the TPU ran was a matter of its matrix unit's shape. The TPU's
// first-tile realignment (:38-45, :76-83) works around a Mosaic padding
// limit and has no counterpart: the halo is TMA's zero fill.
//
// x (N, H, W, Cin) bf16, w HWIO (3, 3, Cin, Cout) bf16, b (Cout) fp32, y (N,
// H, W, Cout) bf16; fp32 accumulation, the bias added in the fp32 epilogue,
// y rounded once.
//
// What bounds it on the H100: 2*N*H*W*9*Cin*Cout FLOPs against
// 2*N*H*W*(Cin + Cout) bytes of activations, 9*Cin/2 or more FLOPs a byte
// (576 at Cin = 128): tensor-core bound at every shape of the bench (0.156
// ms at 989 TFLOP/s for its shapes A-C). Only wgmma reaches that rate; the
// earlier mma.sync design (2 cp.async stages, every thread computing halo
// addresses, 64 output channels a block) reached 15-20% of it.
//
// The design, an implicit GEMM with M = 128 output pixels, N = 128 output
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
//   - the epilogue adds the bias in fp32 and stores bf16 pairs, masked to
//     the image and to Cout.
// No atomics: each output is written once by one block, so runs are
// bit-equal.
//
// Plain C interface for ctypes: pointers and the stream are void*; the
// function returns cudaGetLastError() after its launch. It launches on the
// caller's stream, allocates nothing and does not synchronise.

#include "sm90_wgmma.cuh"

namespace {

using namespace vcd::sm90;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                     // output pixels per block
constexpr int BN = 128;                     // output channels per block
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;                // warpgroups, 64 pixels each
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int STAGE_MAX = (BM + BN) * 64 * 2;  // bytes of one stage at KC = 64
constexpr int SMEM = STAGES * STAGE_MAX + 1024 + 2 * STAGES * 8;

// Grid (tiles_h * tiles_w, ceil(Cout / BN), N); KC = 64 or 32.
template <int KC>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_nhwc_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                        bf16* __restrict__ y, int h, int wd, int cin, int cout, int bw) {
  constexpr int A_BYTES = BM * KC * 2, B_BYTES = BN * KC * 2, STAGE = A_BYTES + B_BYTES;
  constexpr int SW = KC * 2;  // the swizzle: one row of KC channels
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = BM / bw, tiles_w = (wd + bw - 1) / bw;
  const int h0 = (blockIdx.x / tiles_w) * bh, w0 = (blockIdx.x % tiles_w) * bw;
  const int co0 = blockIdx.y * BN, n = blockIdx.z;
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
        tma_load_4d(st, &xmap, &full[s], ci0, w0 + tap % 3 - 1, h0 + tap / 3 - 1, n);
        tma_load_3d(st + A_BYTES, &wmap, &full[s], co0, ci0, tap);
        tma_load_3d(st + A_BYTES + KC * 128, &wmap, &full[s], co0 + 64, ci0, tap);
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

  // epilogue: bias in fp32, one bf16 rounding, masked to the image and Cout
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = wg * 64 + (warp % 4) * 16 + gid + half * 8;
    const int ph = h0 + m / bw, pw = w0 + m % bw;
    if (ph >= h || pw >= wd) continue;
    bf16* yp = y + ((static_cast<size_t>(n) * h + ph) * wd + pw) * cout;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int co = co0 + 8 * j + 2 * tig;
      if (co >= cout) continue;
      *reinterpret_cast<__nv_bfloat162*>(yp + co) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] + bias[co], acc[4 * j + 2 * half + 1] + bias[co + 1]);
    }
  }
}

template <int KC>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, int n, int h, int wd,
                   int cin, int cout, int bw, cudaStream_t stream) {
  const int bh = BM / bw;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(wd),
                             static_cast<uint64_t>(h), static_cast<uint64_t>(n)};
  const uint64_t xstrides[3] = {2ull * cin, 2ull * cin * wd, 2ull * cin * wd * h};
  const uint32_t xbox[4] = {KC, static_cast<uint32_t>(bw), static_cast<uint32_t>(bh), 1};
  cudaError_t err = make_tensor_map(&xmap, x, 4, xdims, xstrides, xbox, KC * 2);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[3] = {static_cast<uint64_t>(cout), static_cast<uint64_t>(cin), 9};
  const uint64_t wstrides[2] = {2ull * cout, 2ull * cout * cin};
  const uint32_t wbox[3] = {64, KC, 1};
  err = make_tensor_map(&wmap, w, 3, wdims, wstrides, wbox, 128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_nhwc_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((h + bh - 1) / bh) * ((wd + bw - 1) / bw);
  conv3x3_nhwc_kernel<KC><<<dim3(static_cast<unsigned>(tiles), (cout + BN - 1) / BN, n), THREADS,
                            SMEM, stream>>>(xmap, wmap, static_cast<const float*>(bias),
                                            static_cast<bf16*>(y), h, wd, cin, cout, bw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, h, w, cin) bf16, w (3, 3, cin, cout) bf16 (HWIO), bias (cout) fp32,
// y (n, h, w, cout) bf16, all contiguous and 16-byte aligned; cin a multiple of 32, cout of 64,
// 1 <= n <= 65535; bw the pixel tile's width, a power of two <= 128 (its
// height is 128 / bw).
int vcd_conv3x3_nhwc(const void* x, const void* w, const void* bias, void* y, int n, int h,
                     int wd, int cin, int cout, int bw, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || wd < 1 || cin < 32 || cin % 32 != 0 || cout < 64 ||
      cout % 64 != 0 || bw < 1 || bw > BM || (bw & (bw - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = BM / bw;
  const long long tiles = static_cast<long long>((h + bh - 1) / bh) * ((wd + bw - 1) / bw);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cin % 64 == 0 ? launch<64>(x, w, bias, y, n, h, wd, cin, cout, bw, s)
                                        : launch<32>(x, w, bias, y, n, h, wd, cin, cout, bw, s));
}

const char* vcd_conv_nhwc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
