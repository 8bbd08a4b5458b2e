// The fused GroupNorm+SiLU+conv3x3 resnet kernels, hand-written for Hopper
// (sm_90a), over NCHW tensors: no activation is transposed, and #9 and #11
// write their conv input s = silu(a*x + o) once, pixel-major, into a scratch.
//
// Replaces the Pallas TPU kernels of vae_channel_dynamics_tpu/ops/
// pallas_resnet.py:
//   fused_gn_silu_conv3x3 <- _fused_fwd_kernel (:173): y = conv3x3(silu(a*x + o))
//                            + bias (+ residual), the optional sum |z| tap over
//                            the image's own pixels and the optional sum y,
//                            sum y^2 of the fp32 output;
//   conv3x3               <- _plain_conv_kernel (:361): conv3x3(x) + bias, which
//                            the backward runs on dy with the flipped,
//                            channel-swapped weight (:348-358);
//   conv3x3_dw            <- _dw_kernel (:423): dW = sum over N, H, W of
//                            silu(a*x + o) shifted, times dy, with s computed
//                            from x by a pre-pass.
//
// What bounds them on the H100: at the 256px step's 32x32 mid-level resnets
// (16, 512, 32, 32), each is 2*N*H*W*9*Cin*Cout = 77.3 GFLOP against about
// 55 MB of device memory, some 1,400 FLOPs a byte: tensor-core bound (0.078
// ms at 989 TFLOP/s; the bytes need 0.016 ms).
//
// fused_gn_silu_conv3x3, on wgmma/TMA. s is computed once, not by each of
// the Cout / 128 output-channel blocks over its tiles' halo windows, and the
// products run from a ring of TMA stages:
//   1. silu_nhwc_kernel computes s = silu(a*x + o), rounded to bf16, once,
//      into an NHWC scratch (N, H, W, Cin), and, where asked, each block's
//      sum |z| over its own 64 pixels for its 64 channels, added over the
//      blocks in a fixed order by sum_tiles_kernel;
//   2. kernel #12's loop (sm90_conv3x3.cuh) runs the conv on s and the HWIO
//      weight; the conv's zero padding of s is TMA's zero fill, which is the
//      JAX kernel's mask after the affine (a zero x never enters as silu(o));
//   3. its epilogue stages acc + bias in fp32 in the free ring, then writes y
//      NCHW, each output channel's row of the pixel rectangle in 16-byte
//      stores masked to the image, adding the NCHW residual in fp32 first,
//      and the tile's sum y and sum y^2 of the fp32 y as per-tile partials,
//      which sum_tiles_kernel adds in a fixed order. No atomics.
//
// conv3x3 is an implicit GEMM on mma.sync: M = output channels, N = a tile of
// output pixels, K = 9 * input channels. A block owns 128 output channels of
// one sample and an 8-row by 16-column pixel tile, so any W that is a
// multiple of 16 and any H work (rows past H are masked). Per chunk of 32
// input channels it
//   1. copies the weights, laid out [tap][out][in] by the wrapper, with
//      cp.async into shared memory (9 x 128 x 32, rows padded to 40);
//   2. reads the 10 x 18 halo window of x for those channels, zero outside
//      the image, and stores it pixel-major, [pixel][channel]: a shifted tap
//      is then only another pixel row, so every ldmatrix address stays
//      16-byte aligned whatever the shift;
//   3. runs 9 taps x 2 k-steps of 16 on eight warps, each 64 channels x 32
//      pixels (4 x 4 mma tiles, 64 fp32 accumulators a thread).
// The epilogue adds the bias in fp32 and stores bf16.
//
// conv3x3_dw (redesigned for wgmma/TMA; the mma.sync version ran at 14% of
// its bound: one stage, s recomputed with one expf per element by each of
// the Cout / 64 output-channel blocks, and 5 splits of fp32 partials, 47 MB
// written and read again at the 256px step's shape). Now:
//   1. silu_nhwc_kernel computes s = silu(a*x + o), rounded to bf16, once,
//      into an NHWC scratch (N, H, W, Cin): 2 * N*H*W*Cin bytes written and
//      read again, against 8 recomputations;
//   2. the transposed product dW^T[ci][co] = sum over pixels of s * dy runs
//      on wgmma with M = 64 input channels, N = 64 output channels, K =
//      pixels, in units of 128 pixels (RS rows x BW columns, BW the widest of
//      64, 32, 16 dividing W). Thread 0 issues per unit one TMA box
//      of s, the unit's window with its one-pixel halo, (RS + 2) x (BW + 2)
//      pixels of 64 channels at (ci0, w0 - 1, h0 - 1, n), zero-filled
//      outside the image (the conv's padding of s), 128-byte swizzled; and
//      RS boxes of NCHW dy, [64 co][BW pixels] each, swizzled by the row's
//      BW * 2 bytes, the K-major B operand; 4 stages.
//   3. The tap shifts are arbitrary pixel offsets that no swizzled wgmma
//      descriptor expresses, so A comes from registers: three consumer
//      warpgroups, warpgroup g the taps of kernel row g, load each 64 x 16
//      fragment with ldmatrix.trans from the swizzled [pixel][channel]
//      window at the tap's shift and run wgmma m64n64k16 (3 x 32 fp32
//      accumulators a thread), two fragment sets in flight.
//   4. Splits of the pixel units fill the card (at most 8, chosen by the
//      wrapper from the clusters the card can hold at once, so that the
//      grid runs in the fewest waves): the splits of one channel block form
//      a thread-block cluster,
//      and the first adds the others' sums through distributed shared
//      memory in order of the split and writes dW (OIHW fp32). No partials
//      in device memory, no atomics: two runs give the same bits.
//
// Plain C interface for ctypes: pointers and the stream are void*; every
// activation is bf16 NCHW (the scratch s NHWC), a and o fp32 (N, Cin), bias
// fp32 or null. Each
// function returns cudaGetLastError() after its launches; it launches on the
// caller's stream, allocates nothing and does not synchronise.

#include "sm90_conv3x3.cuh"
#include "sm90_mma.cuh"

#include <cooperative_groups.h>

namespace {

using namespace vcd;
using namespace vcd::sm90;
namespace c3 = vcd::conv3x3;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TR = 8, TC = 16;            // output pixel tile: 8 rows x 16 columns
constexpr int WR = TR + 2, WC = TC + 2;   // its halo window: 10 x 18
constexpr int WIN_PX = WR * WC;
constexpr int KC = 32;                    // input channels per window
constexpr int LDW = KC + PAD;             // window row stride: [pixel][channel]
constexpr int WIN_ITEMS = WR * KC;        // (window row, channel) pairs

// input-gradient conv
constexpr int BM = 128;                   // output channels per block
constexpr int LDA = KC + PAD;             // weight rows [tap][out][in chunk]
constexpr int A_BYTES = 9 * BM * LDA * 2;
constexpr int W_BYTES = WIN_PX * LDW * 2;
constexpr int CONV_SMEM = A_BYTES + W_BYTES;

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// z = x*a + o as two rounded operations, like the plain version's x*a + o
__device__ __forceinline__ float affine(float x, float a, float o) {
  return __fadd_rn(__fmul_rn(x, a), o);
}

// Fills the [pixel][channel] halo window for KC channels starting at plane
// `plane0` (= sample * C + first channel) around the tile whose top-left
// output pixel is (row0, col0): x, zero outside the image.
__device__ __forceinline__ void fill_window(bf16* __restrict__ win, const bf16* __restrict__ x,
                                            int plane0, int h, int w, int row0, int col0,
                                            int tid) {
  for (int i = tid; i < WIN_ITEMS; i += THREADS) {
    const int ch = i % KC, wr = i / KC;
    const int row = row0 - 1 + wr;
    const bool row_ok = row >= 0 && row < h;
    bf16* dst = win + (wr * WC) * LDW + ch;
    const bf16 zero = __float2bfloat16(0.0f);
    if (!row_ok) {
#pragma unroll
      for (int j = 0; j < WC; ++j) dst[j * LDW] = zero;
      continue;
    }
    const bf16* xp = x + (static_cast<size_t>(plane0 + ch) * h + row) * w + col0;
    const uint4 lo = *reinterpret_cast<const uint4*>(xp);
    const uint4 hi = *reinterpret_cast<const uint4*>(xp + 8);
    const bf16* l8 = reinterpret_cast<const bf16*>(&lo);
    const bf16* h8 = reinterpret_cast<const bf16*>(&hi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dst[(1 + j) * LDW] = l8[j];
      dst[(9 + j) * LDW] = h8[j];
    }
    dst[0] = col0 > 0 ? xp[-1] : zero;
    dst[(WC - 1) * LDW] = col0 + TC < w ? xp[TC] : zero;
  }
}

// y (N, Cout, H, W) = conv3x3(x) + bias; see the header. Grid (tiles, Cout /
// BM, N).
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
                   const float* __restrict__ bias, bf16* __restrict__ y, int cin, int cout, int h,
                   int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sW = reinterpret_cast<bf16*>(smem + A_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int gid = lane / 4, tig = lane % 4;
  const int tiles_w = w / TC;
  const int tile = blockIdx.x;
  const int row0 = (tile / tiles_w) * TR, col0 = (tile % tiles_w) * TC;
  const int co0 = blockIdx.y * BM;
  const int n = blockIdx.z;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int ci0 = 0; ci0 < cin; ci0 += KC) {
    __syncthreads();  // the previous chunk's products are done with sA, sW
    // 1. weights [tap][co0 .. co0+127][ci0 .. ci0+31], 4 x 16 bytes a row
    for (int i = tid; i < 9 * BM * (KC / 8); i += THREADS) {
      const int row = i / (KC / 8), part = i % (KC / 8);
      const int tap = row / BM, co = row % BM;
      cp_async16(sA + row * LDA + part * 8,
                 w9 + (static_cast<size_t>(tap) * cout + co0 + co) * cin + ci0 + part * 8);
    }
    cp_async_commit();
    // 2. the x window
    fill_window(sW, x, n * cin + ci0, h, w, row0, col0, tid);
    cp_async_wait<0>();
    __syncthreads();
    // 3. the products: 9 taps x 2 k-steps
#pragma unroll 1
    for (int tp = 0; tp < 9; ++tp) {
      const int dy = tp / 3, dx = tp % 3;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(af[mt], sA + (tp * BM + warp_m * 64 + mt * 16 + (lane & 15)) * LDA + kk +
                                  (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          // two 8-pixel n-tiles of tile row r: lanes 0-15 columns 0-7, lanes
          // 16-31 columns 8-15; odd lane octets the upper 8 channels
          const int r = 2 * warp_n + np;
          const int c = ((lane >> 4) << 3) + (lane & 7);
          uint32_t bf[4];
          ldmatrix_x4(bf, sW + ((r + dy) * WC + c + dx) * LDW + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // epilogue: bias in fp32, bf16 store
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + warp_m * 64 + mt * 16 + gid + half * 8;
      const float bc = bias != nullptr ? bias[co] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int row = row0 + 2 * warp_n + nt / 2;
        if (row >= h) continue;
        const int col = col0 + (nt % 2) * 8 + 2 * tig;
        const size_t off = (static_cast<size_t>(n * cout + co) * h + row) * w + col;
        *reinterpret_cast<__nv_bfloat162*>(y + off) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half] + bc, acc[mt][nt][2 * half + 1] + bc);
      }
    }
  }
}

// out[r][c] = sum over t < tiles of part[r][t][c], in order of t.
__global__ void sum_tiles_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int rows, int tiles, int c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * c) return;
  const int r = idx / c, ch = idx % c;
  const float* p = part + static_cast<size_t>(r) * tiles * c + ch;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += p[static_cast<size_t>(t) * c];
  out[idx] = s;
}

// ---- the NHWC pre-pass (#9 and #11) ---------------------------------------- //
// s (N, H, W, Cin) bf16 = silu(a*x + o) rounded, from x (N, Cin, H, W): the
// input of #9's conv and of the weight gradient, computed once and laid out
// pixel-major so that a tap's operand is one TMA box. A block transposes 64
// channels x 64 pixels through shared memory, 16 bytes a load and a store
// (H*W is a multiple of 16). With tap_part, the block also writes its
// channels' sum |z| over its own pixels to tap_part (N, blocks, Cin): each
// thread sums its 8 pixels in order, then the channel's 8 threads (lanes 8q
// .. 8q + 7) add theirs by shuffles in a fixed order. Grid (ceil(H*W / 64),
// Cin / 64, N).
constexpr int SILU_PIXELS = 64;  // pixels (and channels) of one pre-pass block

__global__ void __launch_bounds__(256)
    silu_nhwc_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ o, bf16* __restrict__ s,
                     float* __restrict__ tap_part, int cin, int hw) {
  __shared__ __align__(16) bf16 tile[64][64 + 8];
  const int p0 = blockIdx.x * SILU_PIXELS, c0 = blockIdx.y * 64, n = blockIdx.z;
  for (int i = threadIdx.x; i < 64 * 8; i += 256) {  // two rounds, every thread in both
    const int c = i / 8, pv = (i % 8) * 8;
    const int plane = n * cin + c0 + c;
    float tap = 0.0f;
    if (p0 + pv < hw) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(x + static_cast<size_t>(plane) * hw + p0 + pv);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      const float ap = a[plane], op = o[plane];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float z = affine(__bfloat162float(v[j]), ap, op);
        tap += fabsf(z);
        tile[pv + j][c] = __float2bfloat16(z * sigmoid(z));
      }
    }
    if (tap_part != nullptr) {
      tap += __shfl_xor_sync(0xffffffffu, tap, 1);
      tap += __shfl_xor_sync(0xffffffffu, tap, 2);
      tap += __shfl_xor_sync(0xffffffffu, tap, 4);
      if (i % 8 == 0)
        tap_part[(static_cast<size_t>(n) * gridDim.x + blockIdx.x) * cin + c0 + c] = tap;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 8; i += 256) {
    const int p = i / 8, cv = (i % 8) * 8;
    if (p0 + p >= hw) continue;
    *reinterpret_cast<uint4*>(s + (static_cast<size_t>(n) * hw + p0 + p) * cin + c0 + cv) =
        *reinterpret_cast<const uint4*>(&tile[p][cv]);
  }
}

// The pre-pass's blocks along the pixels of one image, and so its |z| partials.
inline int silu_chunks(int hw) { return (hw + SILU_PIXELS - 1) / SILU_PIXELS; }

cudaError_t silu_nhwc(const void* x, const void* a, const void* o, void* s, void* tap_part,
                      int n, int cin, int hw, cudaStream_t stream) {
  silu_nhwc_kernel<<<dim3(silu_chunks(hw), cin / 64, n), 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(o),
      static_cast<bf16*>(s), static_cast<float*>(tap_part), cin, hw);
  return cudaGetLastError();
}

// ---- fused_gn_silu_conv3x3 --------------------------------------------------- //
// #9's epilogue on #12's loop: y (N, Cout, H, W) = acc + bias (+ residual), in
// fp32, rounded once; per-tile sum y and sum y^2 of that fp32 y into mom_part
// (2, N, tiles, Cout). acc + bias is staged [channel][pixel] in the free ring
// (rows of 128 + 4 floats: the fragment's stores hit 32 banks), then each
// consumer thread takes 8 pixels of one channel's row of the rectangle: a
// 16-byte residual load and y store, masked to the image. bias and residual
// are read with __ldg, so that they need not wait for the stores to y.
struct NchwEpilogue {
  const float* bias;
  const bf16* residual;
  bf16* y;
  float* mom_part;
  int h, wd, cout;

  __device__ __forceinline__ void operator()(float (&acc)[64], uint8_t* smem, const c3::Tile& t,
                                             int wg, int warp, int lane) const {
    constexpr int LD = c3::BM + 4;
    constexpr int SEGS = c3::BM / 8;  // 8-pixel segments of a channel's row
    static_assert(c3::BN * LD * 4 <= c3::RING, "the staging fits the ring");
    float* stage = reinterpret_cast<float*>(smem);
    const int gid = lane / 4, tig = lane % 4;
    c3::consumers_sync();  // every consumer's products are done with the ring
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wg * 64 + (warp % 4) * 16 + gid + half * 8;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * tig;
        const float b0 = bias != nullptr ? __ldg(bias + t.co0 + c) : 0.0f;
        const float b1 = bias != nullptr ? __ldg(bias + t.co0 + c + 1) : 0.0f;
        stage[c * LD + m] = acc[4 * j + 2 * half] + b0;
        stage[(c + 1) * LD + m] = acc[4 * j + 2 * half + 1] + b1;
      }
    }
    c3::consumers_sync();
    const int ct = threadIdx.x, tiles = gridDim.x;
#pragma unroll 1
    for (int it = 0; it < c3::BN * SEGS / (c3::CONSUMERS * 128); ++it) {
      const int item = it * c3::CONSUMERS * 128 + ct, c = item / SEGS, seg = item % SEGS;
      const int px0 = seg * 8, ph = t.h0 + px0 / t.bw, pw = t.w0 + px0 % t.bw;
      const float4 v0 = *reinterpret_cast<const float4*>(stage + c * LD + px0);
      const float4 v1 = *reinterpret_cast<const float4*>(stage + c * LD + px0 + 4);
      float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      float sum = 0.0f, sq = 0.0f;
      if (ph < h && pw < wd) {
        const size_t off = (static_cast<size_t>(t.n * cout + t.co0 + c) * h + ph) * wd + pw;
        if (residual != nullptr) {
          const uint4 r = __ldg(reinterpret_cast<const uint4*>(residual + off));
          const bf16* rb = reinterpret_cast<const bf16*>(&r);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(rb[e]);
        }
        uint4 out;
        bf16* ob = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sum += v[e];
          sq += v[e] * v[e];
          ob[e] = __float2bfloat16(v[e]);
        }
        *reinterpret_cast<uint4*>(y + off) = out;
      }
      if (mom_part != nullptr) {
        // the channel's 16 segments are lanes 16q .. 16q + 15: a fixed order
#pragma unroll
        for (int d = 1; d < SEGS; d *= 2) {
          sum += __shfl_xor_sync(0xffffffffu, sum, d);
          sq += __shfl_xor_sync(0xffffffffu, sq, d);
        }
        if (seg == 0) {
          const size_t mo = (static_cast<size_t>(t.n) * tiles + blockIdx.x) * cout + t.co0 + c;
          mom_part[mo] = sum;
          mom_part[static_cast<size_t>(gridDim.z) * tiles * cout + mo] = sq;
        }
      }
    }
  }
};

__global__ void __launch_bounds__(c3::THREADS, 2)
    fused_gn_silu_conv3x3_kernel(const __grid_constant__ CUtensorMap smap,
                                 const __grid_constant__ CUtensorMap wmap,
                                 const NchwEpilogue epi, int wd, int cin, int bw) {
  c3::conv3x3_wgmma<64>(&smap, &wmap, wd, cin, bw, epi);
}

constexpr int DW_CI = 64;              // input channels per block: wgmma's M
constexpr int DW_CO = 64;              // output channels per block: wgmma's N
constexpr int DW_PIX = 128;            // pixels per stage: RS rows x BW columns
constexpr int DW_STAGES = 4;
constexpr int DW_MAX_SPLITS = 8;        // the largest portable cluster
constexpr int DW_THREADS = 3 * 128;  // 3 consumer warpgroups

template <int BW>
struct DwTile {
  static constexpr int RS = DW_PIX / BW;             // rows per stage
  static constexpr int WIN_PX = (RS + 2) * (BW + 2);  // the window, with its halo
  static constexpr int WIN_BYTES = WIN_PX * DW_CI * 2;
  static constexpr int WIN_ALIGNED = (WIN_BYTES + 1023) / 1024 * 1024;
  static constexpr int SUB_BYTES = DW_CO * BW * 2;   // dy, one row: [co][BW pixels]
  static constexpr int STAGE = WIN_ALIGNED + RS * SUB_BYTES;
  static constexpr int SMEM = DW_STAGES * STAGE + 1024 + 2 * DW_STAGES * 8;
  static_assert(DW_STAGES * STAGE >= 9 * DW_CI * DW_CO * 4, "the ring holds the split's sums");
};

// dw[co][ci][tap] (OIHW) = sum over the pixel units of dy[co][p] *
// s[p + tap shift][ci]: each split of a cluster sums a contiguous range of
// units, and the cluster adds the splits. Warpgroup g owns the taps of kernel
// row g (dx = 0, 1, 2). Grid (Cin / 64, Cout / 64, splits), clusters (1, 1,
// splits).
template <int BW>
__global__ void __launch_bounds__(DW_THREADS, 1)
    conv3x3_dw_kernel(const __grid_constant__ CUtensorMap smap,
                      const __grid_constant__ CUtensorMap dymap, float* __restrict__ dw,
                      int n_batch, int cin, int cout, int h, int w) {
  using T = DwTile<BW>;
  constexpr int STEPS = T::RS * (BW / 16);  // k-steps of 16 pixels per stage: 8
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * T::STAGE);
  uint64_t* empty = full + DW_STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ci0 = blockIdx.x * DW_CI, co0 = blockIdx.y * DW_CO;
  const int units_w = w / BW, units_img = ((h + T::RS - 1) / T::RS) * units_w;
  const long long total = static_cast<long long>(n_batch) * units_img;
  const int g_begin = static_cast<int>(blockIdx.z * total / gridDim.z);
  const int g_end = static_cast<int>((blockIdx.z + 1) * total / gridDim.z);

  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 is also the producer: it fills the ring, and refills each stage
  // once every warp has released it. (A producer warp of its own would make
  // 13 warps, 4 on one of the SM's register files, and cap every thread at
  // 128 registers: the accumulators would spill.)
  auto issue = [&](int g) {
    const int k = g - g_begin, s = k % DW_STAGES;
    const int nn = g / units_img, u = g % units_img;
    const int h0 = (u / units_w) * T::RS, w0 = (u % units_w) * BW;
    uint8_t* st = smem + s * T::STAGE;
    mbar_arrive_expect_tx(&full[s], T::WIN_BYTES + T::RS * T::SUB_BYTES);
    tma_load_4d(st, &smap, &full[s], ci0, w0 - 1, h0 - 1, nn);
    for (int r = 0; r < T::RS; ++r)
      tma_load_4d(st + T::WIN_ALIGNED + r * T::SUB_BYTES, &dymap, &full[s], w0, h0 + r, co0, nn);
  };
  if (tid == 0)
    for (int g = g_begin; g < g_end && g < g_begin + DW_STAGES; ++g) issue(g);

  // ---- the consumer warpgroups: M = 64 input channels, N = 64 outputs ----
  const int wg = warp / 4, wq = warp % 4;
  // this lane's ldmatrix.trans row: pixel (lane & 7) + 8 (lane >> 4) of the
  // k-step, 16-byte channel chunk 2 wq + ((lane >> 3) & 1) of the window row
  const int lane_px = (lane & 7) + ((lane >> 4) << 3);
  const int chunk = wq * 2 + ((lane >> 3) & 1);
  float acc[3][32];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[dx][i] = 0.0f;
  uint32_t af[2][3][4];

  for (int g = g_begin; g < g_end; ++g) {
    const int k = g - g_begin, s = k % DW_STAGES;
    mbar_wait(&full[s], (k / DW_STAGES) & 1);
    const uint8_t* win = smem + s * T::STAGE;
    const uint8_t* dys = win + T::WIN_ALIGNED;
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      const int r = t / (BW / 16), kk = t % (BW / 16);
      const uint64_t db = make_desc(dys + r * T::SUB_BYTES, BW * 2) + 2 * kk;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int p = (r + wg) * (BW + 2) + kk * 16 + dx + lane_px;
        ldmatrix_x4_trans(af[t & 1][dx], win + p * 128 + ((chunk ^ (p & 7)) << 4));
      }
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) wgmma_rs_m64n64k16(acc[dx], af[t & 1][dx], db);
      wgmma_commit();
      // step t - 1's products are done: its A registers may be loaded again
      wgmma_wait<1>();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) fence_regs(af[(t + 1) & 1][dx]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      fence_regs(af[0][dx]);
      fence_regs(af[1][dx]);
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage goes back to the producer
    if (tid == 0 && g + DW_STAGES < g_end) {
      mbar_wait(&empty[s], (k / DW_STAGES) & 1);
      issue(g + DW_STAGES);
    }
    __syncwarp();
  }
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) fence_regs(acc[dx]);

  // The splits of one (ci, co) block form a thread-block cluster. Every
  // split but the first stages its sums in its own shared memory (the ring
  // is free: every unit has been consumed), and the first adds them to its
  // own through distributed shared memory in order of the split, then
  // writes dW. No partials in device memory, no atomics.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  float* red = reinterpret_cast<float*>(smem);  // [tap][ci 64][co 64]
  const int gid = lane / 4, tig = lane % 4;
  __syncthreads();
  if (rank != 0) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((wg * 3 + dx) * DW_CI + wq * 16 + gid + (e >> 1) * 8) * DW_CO + 8 * j + 2 * tig +
              (e & 1)] = acc[dx][4 * j + e];
  }
  cluster.sync();
  if (rank == 0) {
    for (int r = 1; r < splits; ++r) {
      const float* remote = cluster.map_shared_rank(red, r);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[dx][4 * j + e] += remote[((wg * 3 + dx) * DW_CI + wq * 16 + gid + (e >> 1) * 8) *
                                             DW_CO + 8 * j + 2 * tig + (e & 1)];
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = wg * 3 + dx;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = ci0 + wq * 16 + gid + (e >> 1) * 8;
          const int co = co0 + 8 * j + 2 * tig + (e & 1);
          dw[(static_cast<size_t>(co) * cin + ci) * 9 + tap] = acc[dx][4 * j + e];
        }
    }
  }
  cluster.sync();  // the other splits keep their shared memory until it is read
}

// The columns of one pixel unit of conv3x3_dw: the widest of 64, 32, 16
// that divides W (a multiple of 16); the unit is 128 / cols rows tall.
int dw_cols(int w) { return w % 64 == 0 ? 64 : w % 32 == 0 ? 32 : 16; }

// How many clusters of `splits` conv3x3_dw blocks the card runs at once
// (each block holds an SM; a cluster's blocks share one GPC, so fewer than
// 132 / splits where a GPC's SMs do not divide by it), or -(CUDA error).
template <int BW>
int dw_max_clusters(int splits) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_dw_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize, DwTile<BW>::SMEM);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.dynamicSmemBytes = DwTile<BW>::SMEM;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, conv3x3_dw_kernel<BW>, &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

template <int BW>
cudaError_t launch_dw(const void* x, const void* a, const void* o, const void* dy, void* s,
                      void* dw, int n, int cin, int cout, int h, int w, int splits,
                      cudaStream_t stream) {
  using T = DwTile<BW>;
  const int hw = h * w;
  cudaError_t err = silu_nhwc(x, a, o, s, nullptr, n, cin, hw, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap smap, dymap;
  const uint64_t sdims[4] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(w),
                             static_cast<uint64_t>(h), static_cast<uint64_t>(n)};
  const uint64_t sstrides[3] = {2ull * cin, 2ull * cin * w, 2ull * cin * hw};
  const uint32_t sbox[4] = {DW_CI, BW + 2, T::RS + 2, 1};
  err = make_tensor_map(&smap, s, 4, sdims, sstrides, sbox, 128);
  if (err != cudaSuccess) return err;
  const uint64_t ddims[4] = {static_cast<uint64_t>(w), static_cast<uint64_t>(h),
                             static_cast<uint64_t>(cout), static_cast<uint64_t>(n)};
  const uint64_t dstrides[3] = {2ull * w, 2ull * hw, 2ull * hw * cout};
  const uint32_t dbox[4] = {BW, 1, DW_CO, 1};
  err = make_tensor_map(&dymap, dy, 4, ddims, dstrides, dbox, BW * 2);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_dw_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cin / DW_CI, cout / DW_CO, splits);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv3x3_dw_kernel<BW>, smap, dymap, static_cast<float*>(dw), n,
                           cin, cout, h, w);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool conv_shape_ok(int n, int cin, int cout, int h, int w) {
  return n >= 1 && n <= 65535 && cin >= KC && cin % KC == 0 && cout >= BM && cout % BM == 0 &&
         h >= 1 && w >= TC && w % TC == 0;
}

int tile_count(int h, int w) { return ((h + TR - 1) / TR) * (w / TC); }

cudaError_t sum_tiles(const float* part, float* out, int rows, int tiles, int c,
                      cudaStream_t s) {
  const int total = rows * c;
  sum_tiles_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>(part, out, rows, tiles,
                                                                       c);
  return cudaGetLastError();
}

cudaError_t launch_conv(const void* x, const void* w9, const void* bias, void* y, int n, int cin,
                        int cout, int h, int w, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CONV_SMEM);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<<<dim3(tile_count(h, w), cout / BM, n), THREADS, CONV_SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w9), static_cast<const float*>(bias),
      static_cast<bf16*>(y), cin, cout, h, w);
  return cudaGetLastError();
}

cudaError_t launch_fused(const void* x, const void* a, const void* o, const void* w,
                         const void* bias, const void* residual, void* y, void* s, void* tap_part,
                         void* mom_part, int n, int cin, int cout, int h, int wd, int bw,
                         cudaStream_t stream) {
  cudaError_t err = silu_nhwc(x, a, o, s, tap_part, n, cin, h * wd, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap smap, wmap;
  err = c3::make_maps(&smap, &wmap, s, w, n, h, wd, cin, cout, bw, 64);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_gn_silu_conv3x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, c3::SMEM);
  if (err != cudaSuccess) return err;
  const NchwEpilogue epi = {static_cast<const float*>(bias), static_cast<const bf16*>(residual),
                            static_cast<bf16*>(y), static_cast<float*>(mom_part), h, wd, cout};
  fused_gn_silu_conv3x3_kernel<<<c3::grid(n, h, wd, cout, bw), c3::THREADS, c3::SMEM, stream>>>(
      smap, wmap, epi, wd, cin, bw);
  return cudaGetLastError();
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

// x (n, cin, h, w) bf16; a, o (n, cin) fp32; w (3, 3, cin, cout) bf16, the
// HWIO weight; bias (cout) fp32 or null; residual (n, cout, h, w) bf16 or
// null; y (n, cout, h, w) bf16; s (n, h, w, cin) bf16 scratch. For the |z|
// tap, tap_part (n, chunks, cin) fp32 scratch and tap (n, cin) fp32, else
// both null; for the moments, mom_part (2, n, tiles, cout) fp32 scratch and
// ysum, ysq (n, cout) fp32, else all null. chunks and tiles are the partial
// counts the caller sized those buffers by; the call is refused unless they
// are the kernels' own, chunks = ceil(h*w / 64) and tiles = ceil(h / (128 /
// bw)) * ceil(w / bw). cin a multiple of 64, cout of 128, w of 16; bw the
// pixel rectangle's width, a power of two from 16 to 128.
int vcd_fused_gn_silu_conv3x3(const void* x, const void* a, const void* o, const void* w,
                              const void* bias, const void* residual, void* y, void* s,
                              void* tap_part, void* tap, void* mom_part, void* ysum, void* ysq,
                              int n, int cin, int cout, int h, int wd, int bw, int chunks,
                              int tiles, void* stream) {
  if (!conv_shape_ok(n, cin, cout, h, wd) || cin % 64 != 0 || bw < 16 || bw > c3::BM ||
      (bw & (bw - 1)) != 0)
    return kInvalid;
  if ((tap_part != nullptr && chunks != silu_chunks(h * wd)) ||
      (mom_part != nullptr && tiles != static_cast<int>(c3::grid(n, h, wd, cout, bw).x)))
    return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_fused(x, a, o, w, bias, residual, y, s, tap_part, mom_part, n, cin,
                                 cout, h, wd, bw, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tap_part != nullptr) {
    err = sum_tiles(static_cast<const float*>(tap_part), static_cast<float*>(tap), n, chunks, cin,
                    st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (mom_part != nullptr) {
    const float* mp = static_cast<const float*>(mom_part);
    const size_t one = static_cast<size_t>(n) * tiles * cout;
    err = sum_tiles(mp, static_cast<float*>(ysum), n, tiles, cout, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = sum_tiles(mp + one, static_cast<float*>(ysq), n, tiles, cout, st);
  }
  return static_cast<int>(err);
}

// y (n, cout, h, w) bf16 = conv3x3(x (n, cin, h, w) bf16) + bias; w9 (9,
// cout, cin) bf16, the OIHW weight as [kh*3 + kw][out][in]; bias (cout) fp32
// or null.
int vcd_conv3x3(const void* x, const void* w9, const void* bias, void* y, int n, int cin,
                int cout, int h, int w, void* stream) {
  if (!conv_shape_ok(n, cin, cout, h, w)) return kInvalid;
  return static_cast<int>(
      launch_conv(x, w9, bias, y, n, cin, cout, h, w, static_cast<cudaStream_t>(stream)));
}

// dw (cout, cin, 3, 3) fp32 = sum over n, h, w of dy (n, cout, h, w) bf16
// times silu(a*x + o) shifted, x (n, cin, h, w) bf16, a, o (n, cin) fp32;
// s (n, h, w, cin) bf16 scratch; 1 <= splits <= DW_MAX_SPLITS (a cluster)
// and <= the pixel units, n * ceil(h / (128 / cols)) * (w / cols) with
// cols = dw_cols(w).
int vcd_conv3x3_dw(const void* x, const void* a, const void* o, const void* dy, void* s,
                   void* dw, int n, int cin, int cout, int h, int w, int splits, void* stream) {
  if (!conv_shape_ok(n, cin, cout, h, w) || cin % DW_CI != 0 || cout % DW_CO != 0)
    return kInvalid;
  const int cols = dw_cols(w), rows = DW_PIX / cols;
  const long long units = static_cast<long long>(n) * ((h + rows - 1) / rows) * (w / cols);
  if (splits < 1 || splits > units || splits > DW_MAX_SPLITS) return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cols == 64   ? launch_dw<64>(x, a, o, dy, s, dw, n, cin, cout, h, w, splits, st)
      : cols == 32 ? launch_dw<32>(x, a, o, dy, s, dw, n, cin, cout, h, w, splits, st)
                   : launch_dw<16>(x, a, o, dy, s, dw, n, cin, cout, h, w, splits, st);
  return static_cast<int>(err);
}

// How many clusters of `splits` (1-8) blocks conv3x3_dw runs at once on the
// current card at width w, or -(CUDA error).
int vcd_conv3x3_dw_max_clusters(int w, int splits) {
  if (w < 16 || w % 16 != 0 || splits < 1 || splits > DW_MAX_SPLITS) return -kInvalid;
  const int cols = dw_cols(w);
  return cols == 64 ? dw_max_clusters<64>(splits)
         : cols == 32 ? dw_max_clusters<32>(splits)
                      : dw_max_clusters<16>(splits);
}

const char* vcd_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
