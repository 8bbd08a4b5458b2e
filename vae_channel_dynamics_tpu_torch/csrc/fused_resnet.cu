// The fused GroupNorm+SiLU+conv3x3 resnet kernels, hand-written for Hopper
// (sm_90a), over NCHW tensors: no activation is transposed, and #9 and #11
// write their conv input s = silu(a*x + o) once, pixel-major, into a scratch,
// as #10 writes its input unchanged.
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
// conv3x3, on the same loop (redesigned for wgmma/TMA; the mma.sync version
// ran at 26% of its bound: one stage, the whole 9 x 128 x 32 weight slice of
// each chunk reloaded by every pixel-tile block, and the halo window filled
// by scalar shared stores). The backward runs it on dy with the flipped,
// channel-swapped weight, so its input is NCHW and comes from no pre-pass:
//   1. silu_nhwc_kernel in its identity mode copies x to an NHWC scratch
//      (N, H, W, Cin) unchanged, 2 * N*H*W*Cin bytes written and read again;
//   2. kernel #12's loop runs the conv on it and the HWIO weight, zero
//      padding by TMA's zero fill;
//   3. #9's epilogue, without residual and moments, writes y + bias NCHW.
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
// At fp32 each of the three has an _f32 entry of its own (the op runs on the
// card in bf16 and fp32; the model fuses bf16 only). Every fp32 product is
// three TF32 products on wgmma (3xTF32: hi hi + hi lo + lo hi, hi = tf32(v),
// lo = tf32(v - hi), rounded to nearest), about 2^-22 of each product
// against the 2^-11 of one TF32 product. tf32 wgmma takes K-major operands
// only, and the tensor cores truncate each fp32 accumulation, so:
//   - #9 and #10 run the fp32 loop of sm90_conv3x3.cuh on operands split
//     before it: split_nhwc_f32_kernel writes s (or x) as hi and lo NHWC
//     planes, and the wrapper the weight K-major, (2, 3, 3, Cout, Cin); each
//     tap's 64 channels go into fresh accumulators added to the sum in fp32,
//     and the epilogue writes fp32 y, residual and moments as in bf16;
//   - #11 takes s (unsplit, NCHW fp32, nchw_f32_kernel) as register A with
//     the tap's shift, split in registers by integer rounding, and dy split
//     into hi and lo NCHW planes as the K-major B: M = 64 input channels, N
//     = 64 output channels, all 9 taps a block, a warpgroup's three taps in
//     turn through one fresh accumulator over each 64-pixel unit, the
//     splits' partials added in order by a second pass
//     (conv3x3_dw_f32_kernel has the design).
//     Redesigned from M 64 x N 32 (three fresh and three summed accumulators
//     a thread, 128-pixel units, cvt.rna splits): on the H100 its m64n32k8
//     products alone, without the loads and splits, took 0.738 ms of the
//     loop's 1.025 at the 256px step's shape, 63% of the bound; at N = 64
//     a MAC takes half the wgmma instructions and half the A splits.
// What bounds them: 3 x 77.3 GFLOP at the 495 TFLOP/s TF32 rate, 0.469 ms at
// the 256px step's shape (the fp32 SIMT rate's bound would be 1.154 ms).
//
// Plain C interface for ctypes: pointers and the stream are void*; every
// activation is bf16 NCHW (fp32 for the _f32 entries; the scratch s NHWC),
// a and o fp32 (N, Cin), bias fp32 or null. Each
// function returns cudaGetLastError() after its launches; it launches on the
// caller's stream, allocates nothing and does not synchronise.

#include "sm90_conv3x3.cuh"
#include "sm90_mma.cuh"

#include <cooperative_groups.h>

namespace {

using namespace vcd;
using namespace vcd::sm90;
namespace c3 = vcd::conv3x3;

constexpr int THREADS = 256;  // sum_tiles_kernel's block

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// z = x*a + o as two rounded operations, like the plain version's x*a + o
__device__ __forceinline__ float affine(float x, float a, float o) {
  return __fadd_rn(__fmul_rn(x, a), o);
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

// ---- the NHWC pre-pass (#9, #10 and #11) ---------------------------------- //
// s (N, H, W, Cin) bf16 = silu(a*x + o) rounded, from x (N, Cin, H, W): the
// input of #9's conv and of the weight gradient, computed once and laid out
// pixel-major so that a tap's operand is one TMA box. With IDENTITY (#10's
// input), s = x unchanged: no affine, no SiLU, no tap, a and o unused. A block
// transposes 64 channels x 64 pixels through shared memory, 16 bytes a load
// and a store (H*W is a multiple of 16). With tap_part, the block also writes
// its channels' sum |z| over its own pixels to tap_part (N, blocks, Cin): each
// thread sums its 8 pixels in order, then the channel's 8 threads (lanes 8q
// .. 8q + 7) add theirs by shuffles in a fixed order. Grid (ceil(H*W / 64),
// Cin / 64, N).
constexpr int SILU_PIXELS = 64;  // pixels (and channels) of one pre-pass block

template <bool IDENTITY>
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
      if (IDENTITY) {
#pragma unroll
        for (int j = 0; j < 8; ++j) tile[pv + j][c] = v[j];
      } else {
        const float ap = a[plane], op = o[plane];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float z = affine(__bfloat162float(v[j]), ap, op);
          tap += fabsf(z);
          tile[pv + j][c] = __float2bfloat16(z * sigmoid(z));
        }
      }
    }
    if (!IDENTITY && tap_part != nullptr) {
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

template <bool IDENTITY>
cudaError_t silu_nhwc(const void* x, const void* a, const void* o, void* s, void* tap_part,
                      int n, int cin, int hw, cudaStream_t stream) {
  silu_nhwc_kernel<IDENTITY><<<dim3(silu_chunks(hw), cin / 64, n), 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(o),
      static_cast<bf16*>(s), static_cast<float*>(tap_part), cin, hw);
  return cudaGetLastError();
}

// ---- fused_gn_silu_conv3x3 --------------------------------------------------- //
// 8 consecutive values of a bf16 or fp32 row as fp32 (through the read-only
// path), and back.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const bf16* rb = reinterpret_cast<const bf16*>(&r);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(rb[e]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 out;
  bf16* ob = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) ob[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(p) = out;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// #9's epilogue on #12's loop (and on the fp32 loop, with T = float): y (N,
// Cout, H, W) = acc + bias (+ residual), in fp32, rounded once to T; per-tile
// sum y and sum y^2 of that fp32 y into mom_part (2, N, tiles, Cout). acc +
// bias is staged [channel][pixel] in the free ring (rows of 128 + 4 floats:
// the fragment's stores hit 32 banks), then each consumer thread takes 8
// pixels of one channel's row of the rectangle: a 16- (or 32-) byte residual
// load and y store, masked to the image. bias and residual are read with
// __ldg, so that they need not wait for the stores to y.
template <class T>
struct NchwEpilogue {
  const float* bias;
  const T* residual;
  T* y;
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
          float r[8];
          load8(residual + off, r);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += r[e];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sum += v[e];
          sq += v[e] * v[e];
        }
        store8(y + off, v);
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
                                 const NchwEpilogue<bf16> epi, int wd, int cin, int bw) {
  c3::conv3x3_wgmma<64>(&smap, &wmap, wd, cin, bw, epi);
}

// #10: the same loop and epilogue on the identity pre-pass's copy of x, with
// neither residual nor moments.
__global__ void __launch_bounds__(c3::THREADS, 2)
    conv3x3_nchw_kernel(const __grid_constant__ CUtensorMap smap,
                        const __grid_constant__ CUtensorMap wmap, const NchwEpilogue<bf16> epi,
                        int wd, int cin, int bw) {
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

// A launch configuration of conv3x3_dw's grid (ci blocks, co blocks,
// splits), the splits of a channel block one cluster.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster;

  ClusterLaunch(dim3 grid, int threads, int smem, int splits, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = splits;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
};

// How many clusters of `splits` blocks of `kernel` (conv3x3_dw's, at
// `threads` threads and `smem` bytes) the card runs at once (each block
// holds an SM; a cluster's blocks share one GPC, so fewer than 132 / splits
// where a GPC's SMs do not divide by it), or -(CUDA error).
template <class Kernel>
int max_clusters(Kernel kernel, int threads, int smem, int splits) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const ClusterLaunch launch(dim3(1, 1, splits), threads, smem, splits, nullptr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &launch.cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

template <int BW>
int dw_max_clusters(int splits) {
  return max_clusters(conv3x3_dw_kernel<BW>, DW_THREADS, DwTile<BW>::SMEM, splits);
}

template <int BW>
cudaError_t launch_dw(const void* x, const void* a, const void* o, const void* dy, void* s,
                      void* dw, int n, int cin, int cout, int h, int w, int splits,
                      cudaStream_t stream) {
  using T = DwTile<BW>;
  const int hw = h * w;
  cudaError_t err = silu_nhwc<false>(x, a, o, s, nullptr, n, cin, hw, stream);
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
  const ClusterLaunch launch(dim3(cin / DW_CI, cout / DW_CO, splits), DW_THREADS, T::SMEM,
                             splits, stream);
  err = cudaLaunchKernelEx(&launch.cfg, conv3x3_dw_kernel<BW>, smap, dymap,
                           static_cast<float*>(dw), n, cin, cout, h, w);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shapes the wgmma/TMA loop and the NCHW epilogue take: cin a multiple of
// 64 (the loop's K chunk), cout of 128 (the epilogue stores whole channel
// blocks), w of 16 (16-byte rows), bw a power of two from 16 to 128.
bool loop_shape_ok(int n, int cin, int cout, int h, int wd, int bw) {
  return n >= 1 && n <= 65535 && cin >= 64 && cin % 64 == 0 && cout >= c3::BN &&
         cout % c3::BN == 0 && h >= 1 && wd >= 16 && wd % 16 == 0 && bw >= 16 &&
         bw <= c3::BM && (bw & (bw - 1)) == 0;
}

cudaError_t sum_tiles(const float* part, float* out, int rows, int tiles, int c,
                      cudaStream_t s) {
  const int total = rows * c;
  sum_tiles_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>(part, out, rows, tiles,
                                                                       c);
  return cudaGetLastError();
}

cudaError_t launch_conv(const void* x, const void* w, const void* bias, void* y, void* s,
                        int n, int cin, int cout, int h, int wd, int bw, cudaStream_t stream) {
  cudaError_t err = silu_nhwc<true>(x, nullptr, nullptr, s, nullptr, n, cin, h * wd, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap smap, wmap;
  err = c3::make_maps(&smap, &wmap, s, w, n, h, wd, cin, cout, bw, 64);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_nchw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             c3::SMEM);
  if (err != cudaSuccess) return err;
  const NchwEpilogue<bf16> epi = {static_cast<const float*>(bias), nullptr,
                                  static_cast<bf16*>(y), nullptr, h, wd, cout};
  conv3x3_nchw_kernel<<<c3::grid(n, h, wd, cout, bw), c3::THREADS, c3::SMEM, stream>>>(
      smap, wmap, epi, wd, cin, bw);
  return cudaGetLastError();
}

cudaError_t launch_fused(const void* x, const void* a, const void* o, const void* w,
                         const void* bias, const void* residual, void* y, void* s, void* tap_part,
                         void* mom_part, int n, int cin, int cout, int h, int wd, int bw,
                         cudaStream_t stream) {
  cudaError_t err = silu_nhwc<false>(x, a, o, s, tap_part, n, cin, h * wd, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap smap, wmap;
  err = c3::make_maps(&smap, &wmap, s, w, n, h, wd, cin, cout, bw, 64);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_gn_silu_conv3x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, c3::SMEM);
  if (err != cudaSuccess) return err;
  const NchwEpilogue<bf16> epi = {static_cast<const float*>(bias),
                                  static_cast<const bf16*>(residual), static_cast<bf16*>(y),
                                  static_cast<float*>(mom_part), h, wd, cout};
  fused_gn_silu_conv3x3_kernel<<<c3::grid(n, h, wd, cout, bw), c3::THREADS, c3::SMEM, stream>>>(
      smap, wmap, epi, wd, cin, bw);
  return cudaGetLastError();
}

// ---- fp32: #9, #10 and #11 in 3xTF32 ---------------------------------------- //
// fp32 hi = tf32(v) and lo = tf32(v - hi), four at a time.
__device__ __forceinline__ float4 tf32_hi4(float4 v) {
  return make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
}

__device__ __forceinline__ float4 tf32_lo4(float4 v, float4 hi) {
  return make_float4(to_tf32(v.x - hi.x), to_tf32(v.y - hi.y), to_tf32(v.z - hi.z),
                     to_tf32(v.w - hi.w));
}

// The NHWC pre-pass at fp32 (#9 and #10): s = silu(a*x + o) in fp32, not
// rounded (with IDENTITY, x), split into hi and lo, s (2, N, H, W, Cin): the
// hi images, then the lo ones, the fp32 loop's A. As silu_nhwc_kernel
// otherwise: 64 channels x 64 pixels a block through shared memory, the |z|
// partials the same, in the same order.
template <bool IDENTITY>
__global__ void __launch_bounds__(256)
    split_nhwc_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ o, float* __restrict__ s,
                          float* __restrict__ tap_part, int cin, int hw) {
  __shared__ __align__(16) float tile[64][64 + 4];
  const int p0 = blockIdx.x * SILU_PIXELS, c0 = blockIdx.y * 64, n = blockIdx.z;
  for (int i = threadIdx.x; i < 64 * 8; i += 256) {  // two rounds, every thread in both
    const int c = i / 8, pv = (i % 8) * 8;
    const int plane = n * cin + c0 + c;
    float tap = 0.0f;
    if (p0 + pv < hw) {
      const float4* src = reinterpret_cast<const float4*>(x + static_cast<size_t>(plane) * hw +
                                                          p0 + pv);
      const float4 v0 = src[0], v1 = src[1];
      const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      if (IDENTITY) {
#pragma unroll
        for (int j = 0; j < 8; ++j) tile[pv + j][c] = v[j];
      } else {
        const float ap = a[plane], op = o[plane];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float z = affine(v[j], ap, op);
          tap += fabsf(z);
          tile[pv + j][c] = z * sigmoid(z);
        }
      }
    }
    if (!IDENTITY && tap_part != nullptr) {
      tap += __shfl_xor_sync(0xffffffffu, tap, 1);
      tap += __shfl_xor_sync(0xffffffffu, tap, 2);
      tap += __shfl_xor_sync(0xffffffffu, tap, 4);
      if (i % 8 == 0)
        tap_part[(static_cast<size_t>(n) * gridDim.x + blockIdx.x) * cin + c0 + c] = tap;
    }
  }
  __syncthreads();
  const size_t lo = static_cast<size_t>(gridDim.z) * hw * cin;
  for (int i = threadIdx.x; i < 64 * 16; i += 256) {
    const int p = i / 16, cv = (i % 16) * 4;
    if (p0 + p >= hw) continue;
    const float4 v = *reinterpret_cast<const float4*>(&tile[p][cv]);
    const float4 hi = tf32_hi4(v);
    const size_t off = (static_cast<size_t>(n) * hw + p0 + p) * cin + c0 + cv;
    *reinterpret_cast<float4*>(s + off) = hi;
    *reinterpret_cast<float4*>(s + lo + off) = tf32_lo4(v, hi);
  }
}

template <bool IDENTITY>
cudaError_t split_nhwc_f32(const void* x, const void* a, const void* o, void* s, void* tap_part,
                           int n, int cin, int hw, cudaStream_t stream) {
  split_nhwc_f32_kernel<IDENTITY><<<dim3(silu_chunks(hw), cin / 64, n), 256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(o),
      static_cast<float*>(s), static_cast<float*>(tap_part), cin, hw);
  return cudaGetLastError();
}

// The NCHW pre-pass at fp32 (#11), four elements a thread: with SILU, out =
// silu(a*x + o) in fp32 over x (N, C, H, W); else x split, out (2, N, C, H,
// W) = (hi, lo). H*W is a multiple of 16, so four never straddle a plane.
template <bool SILU>
__global__ void __launch_bounds__(256)
    nchw_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ o, float* __restrict__ out, int hw,
                    long long quads) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= quads) return;
  const float4 v = reinterpret_cast<const float4*>(x)[i];
  float4* dst = reinterpret_cast<float4*>(out);
  if (SILU) {
    const int plane = static_cast<int>(i * 4 / hw);
    const float ap = a[plane], op = o[plane];
    const float z0 = affine(v.x, ap, op), z1 = affine(v.y, ap, op);
    const float z2 = affine(v.z, ap, op), z3 = affine(v.w, ap, op);
    dst[i] = make_float4(z0 * sigmoid(z0), z1 * sigmoid(z1), z2 * sigmoid(z2), z3 * sigmoid(z3));
  } else {
    const float4 hi = tf32_hi4(v);
    dst[i] = hi;
    dst[quads + i] = tf32_lo4(v, hi);
  }
}

template <bool SILU>
cudaError_t nchw_f32(const void* x, const void* a, const void* o, void* out, int n, int c,
                     int hw, cudaStream_t stream) {
  const long long quads = static_cast<long long>(n) * c * hw / 4;
  nchw_f32_kernel<SILU><<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(o),
      static_cast<float*>(out), hw, quads);
  return cudaGetLastError();
}

// #9 and #10 at fp32: the fp32 loop (sm90_conv3x3.cuh) on the split s and
// the split K-major weight, then #9's epilogue writing fp32. One block an SM.
__global__ void __launch_bounds__(c3::THREADS, 1)
    fused_gn_silu_conv3x3_f32_kernel(const __grid_constant__ CUtensorMap smap,
                                     const __grid_constant__ CUtensorMap wmap,
                                     const NchwEpilogue<float> epi, int n, int wd, int cin,
                                     int bw) {
  c3::conv3x3_tf32x3(&smap, &wmap, n, wd, cin, bw, epi);
}

__global__ void __launch_bounds__(c3::THREADS, 1)
    conv3x3_nchw_f32_kernel(const __grid_constant__ CUtensorMap smap,
                            const __grid_constant__ CUtensorMap wmap,
                            const NchwEpilogue<float> epi, int n, int wd, int cin, int bw) {
  c3::conv3x3_tf32x3(&smap, &wmap, n, wd, cin, bw, epi);
}

template <bool FUSED>
cudaError_t launch_conv_f32(const void* x, const void* a, const void* o, const void* w,
                            const void* bias, const void* residual, void* y, void* s,
                            void* tap_part, void* mom_part, int n, int cin, int cout, int h,
                            int wd, int bw, cudaStream_t stream) {
  cudaError_t err = split_nhwc_f32<!FUSED>(x, a, o, s, tap_part, n, cin, h * wd, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap smap, wmap;
  err = c3::make_maps_f32(&smap, &wmap, s, w, n, h, wd, cin, cout, bw);
  if (err != cudaSuccess) return err;
  auto kernel = FUSED ? fused_gn_silu_conv3x3_f32_kernel : conv3x3_nchw_f32_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c3::F32_SMEM);
  if (err != cudaSuccess) return err;
  const NchwEpilogue<float> epi = {static_cast<const float*>(bias),
                                   static_cast<const float*>(residual), static_cast<float*>(y),
                                   static_cast<float*>(mom_part), h, wd, cout};
  kernel<<<c3::grid(n, h, wd, cout, bw), c3::THREADS, c3::F32_SMEM, stream>>>(smap, wmap, epi, n,
                                                                            wd, cin, bw);
  return cudaGetLastError();
}

// #11 at fp32. dW^T[ci][co] per tap = sum over pixels of s[ci][p + shift] *
// dy[co][p], K = pixels, on wgmma m64n64k8 tf32: M = 64 input channels, N =
// 64 output channels, all 9 taps a block. tf32 wgmma's B must be K-major: dy
// is NCHW, pixels contiguous, and the NCHW pre-pass splits it into hi and lo
// planes, (2, N, Cout, H, W). The tap shifts are arbitrary pixel offsets that
// no descriptor expresses, so A comes from registers: the pre-pass writes s =
// silu(a*x + o) NCHW in fp32 (unsplit), thread 0 loads per unit one
// unswizzled TMA box of it, 64 channels x WR rows x WW columns at (w0 - 4,
// h0 - 1) (TMA takes an inner coordinate of whole 16 bytes only), zero-filled
// outside the image (the conv's padding); each thread loads its four elements
// of a 64 x 8 fragment with plain shared loads at the tap's shift and splits
// them into hi and lo in registers by integer rounding (split_rna, bit-equal
// to cvt.rna). Per k-step and tap: lo hi, hi lo, hi hi.
//
// Warpgroup g owns the taps of kernel row g. A thread holds one summed
// accumulator a tap (3 x 32 fp32) and one fresh accumulator (32 fp32) that
// the taps take in turn: per unit (64 pixels, 8 k-steps), tap dx = 0 runs its
// 8 k-steps of 3 products into the fresh accumulator (the tensor cores
// truncate their accumulation, so it stays short), which is added to the
// tap's sum in fp32; then dx = 1, then dx = 2. The splits of a channel block
// are independent blocks, not a cluster (a cluster's blocks share a GPC, and
// the H100 holds only 30 clusters of 4 one-SM blocks at once): each writes
// its sums, staged in shared memory, as whole rows of its partial, and
// sum_tiles_kernel adds the partials in order of the split. Grid (Cin / 64,
// Cout / 64, splits).
constexpr int DWF_CI = 64;    // input channels per block: wgmma's M, from registers
constexpr int DWF_CO = 64;    // output channels per block: wgmma's N
constexpr int DWF_PIX = 64;   // pixels per unit: RS rows x BW columns
constexpr int DWF_STAGES = 2;

template <int BW>
struct DwF32Tile {
  static constexpr int RS = DWF_PIX / BW;      // rows per unit
  // window columns from w0 - 4: the BW + 2 the taps read from w0 - 1, and
  // the rest pad the plane; window rows RS + 2, and one to pad the plane
  static constexpr int WW = BW == 32 ? 44 : 28;
  static constexpr int WR = RS + 3;
  static constexpr int PLANE = WR * WW;        // one channel of the window, floats
  static constexpr int WIN_BYTES = DWF_CI * PLANE * 4;
  static constexpr int WIN_ALIGNED = (WIN_BYTES + 1023) / 1024 * 1024;
  static constexpr int SUB_BYTES = DWF_CO * BW * 4;  // dy, one row, hi or lo: [co][BW pixels]
  static constexpr int STAGE = WIN_ALIGNED + 2 * RS * SUB_BYTES;
  static constexpr int SMEM = DWF_STAGES * STAGE + 1024 + 2 * DWF_STAGES * 8;
  static_assert(WW >= BW + 5 && WW % 4 == 0, "the window holds the halo in 16-byte rows");
  static_assert(DWF_STAGES * STAGE >= DWF_CO * (9 * DWF_CI + 1) * 4,
                "the ring holds the block's sums");
  // a fragment's 8 channels x 4 columns fall on 32 banks: the plane is an
  // odd multiple of 4 banks on
  static_assert(PLANE % 8 == 4, "the fragment loads are free of bank conflicts");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// The columns of one pixel unit of conv3x3_dw_f32: 32 where they divide W,
// else 16 (W is a multiple of 16).
int dw_f32_cols(int w) { return w % 32 == 0 ? 32 : 16; }

// v's hi and lo as tf32 bits, rounded to nearest with ties away from zero by
// integer arithmetic on the bits (add half of TF32's last place to the
// magnitude, clear the 13 bits TF32 drops): cvt.rna.tf32.f32's result for
// every finite value, in two integer operations, where ptxas expands the
// conversion into compares and selects.
__device__ __forceinline__ uint32_t rna_tf32_bits(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_rna(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32_bits(__float_as_uint(v));
  lo = rna_tf32_bits(__float_as_uint(v - __uint_as_float(hi)));
}

template <int BW>
__global__ void __launch_bounds__(DW_THREADS, 1)
    conv3x3_dw_f32_kernel(const __grid_constant__ CUtensorMap smap,
                          const __grid_constant__ CUtensorMap dymap, float* __restrict__ out,
                          int n_batch, int cin, int cout, int h, int w) {
  using T = DwF32Tile<BW>;
  constexpr int KPR = BW / 8;           // k-steps of 8 pixels a unit row
  constexpr int STEPS = T::RS * KPR;    // k-steps a unit: 8
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DWF_STAGES * T::STAGE);
  uint64_t* empty = full + DWF_STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ci0 = blockIdx.x * DWF_CI, co0 = blockIdx.y * DWF_CO;
  const int units_w = w / BW, units_img = ((h + T::RS - 1) / T::RS) * units_w;
  const long long total = static_cast<long long>(n_batch) * units_img;
  const int g_begin = static_cast<int>(blockIdx.z * total / gridDim.z);
  const int g_end = static_cast<int>((blockIdx.z + 1) * total / gridDim.z);

  if (tid == 0) {
    for (int s = 0; s < DWF_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0 is also the producer, as in the bf16 kernel
  auto issue = [&](int g) {
    const int k = g - g_begin, s = k % DWF_STAGES;
    const int nn = g / units_img, u = g % units_img;
    const int h0 = (u / units_w) * T::RS, w0 = (u % units_w) * BW;
    uint8_t* st = smem + s * T::STAGE;
    mbar_arrive_expect_tx(&full[s], T::WIN_BYTES + 2 * T::RS * T::SUB_BYTES);
    tma_load_4d(st, &smap, &full[s], w0 - 4, h0 - 1, ci0, nn);
    for (int r = 0; r < T::RS; ++r) {
      uint8_t* sub = st + T::WIN_ALIGNED + r * T::SUB_BYTES;
      tma_load_4d(sub, &dymap, &full[s], w0, h0 + r, co0, nn);                        // hi
      tma_load_4d(sub + T::RS * T::SUB_BYTES, &dymap, &full[s], w0, h0 + r, co0,
                  nn + n_batch);                                                       // lo
    }
  };
  if (tid == 0)
    for (int g = g_begin; g < g_end && g < g_begin + DWF_STAGES; ++g) issue(g);

  // ---- the consumer warpgroups: M = 64 input channels, N = 64 outputs ----
  const int wg = warp / 4, wq = warp % 4, gid = lane / 4, tig = lane % 4;
  // this thread's fragment elements: channels wq*16 + gid (+ 8), columns tig
  // (+ 4) of the k-step, at the window row of kernel row wg; pixel column c
  // at tap column dx is window column c + dx + 3
  const int a_off = ((wq * 16 + gid) * T::WR + wg) * T::WW + tig + 3;
  constexpr int CH8 = 8 * T::PLANE;
  float acc[32], sum[3][32];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[dx][i] = 0.0f;
  uint32_t ahi[2][4], alo[2][4];

  for (int g = g_begin; g < g_end; ++g) {
    const int k = g - g_begin, s = k % DWF_STAGES;
    mbar_wait(&full[s], (k / DWF_STAGES) & 1);
    const float* win = reinterpret_cast<const float*>(smem + s * T::STAGE) + a_off;
    const uint8_t* dys = smem + s * T::STAGE + T::WIN_ALIGNED;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int t = 0; t < STEPS; ++t) {
        const int r = t / KPR, kk = t % KPR, b = t & 1;
        const uint64_t dh = make_desc(dys + r * T::SUB_BYTES, BW * 4) + 2 * kk;
        const uint64_t dl = make_desc(dys + (T::RS + r) * T::SUB_BYTES, BW * 4) + 2 * kk;
        const float* p = win + r * T::WW + kk * 8 + dx;
        split_rna(p[0], ahi[b][0], alo[b][0]);
        split_rna(p[CH8], ahi[b][1], alo[b][1]);
        split_rna(p[4], ahi[b][2], alo[b][2]);
        split_rna(p[CH8 + 4], ahi[b][3], alo[b][3]);
        wgmma_fence();
        wgmma_tf32_rs_m64n64k8(acc, alo[b], dh, t == 0 ? 0 : 1);
        wgmma_tf32_rs_m64n64k8(acc, ahi[b], dl);
        wgmma_tf32_rs_m64n64k8(acc, ahi[b], dh);
        wgmma_commit();
        // step t - 1's products are done: its fragments may be loaded again
        wgmma_wait<1>();
        fence_regs(ahi[b ^ 1]);
        fence_regs(alo[b ^ 1]);
      }
      // the tap's fresh sum is done: into its summed accumulator, in fp32
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ahi[0]);
      fence_regs(alo[0]);
      fence_regs(ahi[1]);
      fence_regs(alo[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[dx][i] += acc[i];
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage goes back to the producer
    if (tid == 0 && g + DWF_STAGES < g_end) {
      mbar_wait(&empty[s], (k / DWF_STAGES) & 1);
      issue(g + DWF_STAGES);
    }
    __syncwarp();
  }

  // The block's sums, staged in the free ring as [co][ci][tap] (rows of
  // 64 x 9 floats a co, and one to pad), then written as 64 runs of 576
  // floats, one a co: into dW, or (more than one split) into the split's
  // partial, which sum_tiles_kernel adds in order of the split. No atomics:
  // two runs give the same bits.
  constexpr int RUN = DWF_CI * 9, ROW = RUN + 1;
  float* staged = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warpgroup is done with the ring
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        staged[(8 * j + 2 * tig + (e & 1)) * ROW + (wq * 16 + gid + (e >> 1) * 8) * 9 + wg * 3 +
               dx] = sum[dx][4 * j + e];
  __syncthreads();
  float* dst = out + (static_cast<size_t>(blockIdx.z) * cout + co0) * cin * 9 + ci0 * 9;
  for (int i = tid; i < DWF_CO * RUN; i += DW_THREADS)
    dst[static_cast<size_t>(i / RUN) * cin * 9 + i % RUN] = staged[(i / RUN) * ROW + i % RUN];
}

template <int BW>
cudaError_t launch_dw_f32(const void* x, const void* a, const void* o, const void* dy, void* s,
                          void* dy_split, void* dw_part, void* dw, int n, int cin, int cout,
                          int h, int w, int splits, cudaStream_t stream) {
  using T = DwF32Tile<BW>;
  const int hw = h * w;
  cudaError_t err = nchw_f32<true>(x, a, o, s, n, cin, hw, stream);
  if (err != cudaSuccess) return err;
  err = nchw_f32<false>(dy, nullptr, nullptr, dy_split, n, cout, hw, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap smap, dymap;
  const uint64_t sdims[4] = {static_cast<uint64_t>(w), static_cast<uint64_t>(h),
                             static_cast<uint64_t>(cin), static_cast<uint64_t>(n)};
  const uint64_t sstrides[3] = {4ull * w, 4ull * hw, 4ull * hw * cin};
  const uint32_t sbox[4] = {T::WW, T::WR, DWF_CI, 1};
  err = make_tensor_map(&smap, s, 4, sdims, sstrides, sbox, 0, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;
  const uint64_t ddims[4] = {static_cast<uint64_t>(w), static_cast<uint64_t>(h),
                             static_cast<uint64_t>(cout), 2ull * n};
  const uint64_t dstrides[3] = {4ull * w, 4ull * hw, 4ull * hw * cout};
  const uint32_t dbox[4] = {BW, 1, DWF_CO, 1};
  err = make_tensor_map(&dymap, dy_split, 4, ddims, dstrides, dbox, BW * 4,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_dw_f32_kernel<BW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  float* out = static_cast<float*>(splits == 1 ? dw : dw_part);
  conv3x3_dw_f32_kernel<BW><<<dim3(cin / DWF_CI, cout / DWF_CO, splits), DW_THREADS, T::SMEM,
                              stream>>>(smap, dymap, out, n, cin, cout, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_tiles(out, static_cast<float*>(dw), 1, splits, cout * cin * 9, stream);
}

// #9's partial counts are the kernels' own: chunks = ceil(h*w / 64) for the
// tap, tiles = the loop's pixel tiles for the moments.
bool partials_ok(const void* tap_part, const void* mom_part, int n, int cout, int h, int wd,
                 int bw, int chunks, int tiles) {
  return (tap_part == nullptr || chunks == silu_chunks(h * wd)) &&
         (mom_part == nullptr || tiles == static_cast<int>(c3::grid(n, h, wd, cout, bw).x));
}

// #9's second pass: the tap and the moments from their partials, each added
// in a fixed order by sum_tiles_kernel.
cudaError_t sum_partials(const void* tap_part, void* tap, const void* mom_part, void* ysum,
                         void* ysq, int n, int cin, int cout, int chunks, int tiles,
                         cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (tap_part != nullptr) {
    err = sum_tiles(static_cast<const float*>(tap_part), static_cast<float*>(tap), n, chunks, cin,
                    st);
    if (err != cudaSuccess) return err;
  }
  if (mom_part != nullptr) {
    const float* mp = static_cast<const float*>(mom_part);
    const size_t one = static_cast<size_t>(n) * tiles * cout;
    err = sum_tiles(mp, static_cast<float*>(ysum), n, tiles, cout, st);
    if (err != cudaSuccess) return err;
    err = sum_tiles(mp + one, static_cast<float*>(ysq), n, tiles, cout, st);
  }
  return err;
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
  if (!loop_shape_ok(n, cin, cout, h, wd, bw) || !partials_ok(tap_part, mom_part, n, cout, h,
                                                               wd, bw, chunks, tiles))
    return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_fused(x, a, o, w, bias, residual, y, s, tap_part, mom_part, n, cin,
                                 cout, h, wd, bw, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sum_partials(tap_part, tap, mom_part, ysum, ysq, n, cin, cout, chunks, tiles, st));
}

// The same at fp32: x, residual and y fp32; w (2, 3, 3, cout, cin) fp32,
// the K-major weight split into hi, then lo; s (2, n, h, w, cin) fp32
// scratch. The same shapes and partial counts.
int vcd_fused_gn_silu_conv3x3_f32(const void* x, const void* a, const void* o, const void* w,
                                  const void* bias, const void* residual, void* y, void* s,
                                  void* tap_part, void* tap, void* mom_part, void* ysum,
                                  void* ysq, int n, int cin, int cout, int h, int wd, int bw,
                                  int chunks, int tiles, void* stream) {
  if (!loop_shape_ok(n, cin, cout, h, wd, bw) || !partials_ok(tap_part, mom_part, n, cout, h,
                                                               wd, bw, chunks, tiles))
    return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_conv_f32<true>(x, a, o, w, bias, residual, y, s, tap_part, mom_part,
                                          n, cin, cout, h, wd, bw, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sum_partials(tap_part, tap, mom_part, ysum, ysq, n, cin, cout, chunks, tiles, st));
}

// y (n, cout, h, w) bf16 = conv3x3(x (n, cin, h, w) bf16) + bias; w (3, 3,
// cin, cout) bf16, the HWIO weight (for the backward's ds, the flipped,
// channel-swapped weight); bias (cout) fp32 or null; s (n, h, w, cin) bf16
// scratch, x's NHWC copy. cin a multiple of 64, cout of 128, w of 16; bw the
// pixel rectangle's width, a power of two from 16 to 128.
int vcd_conv3x3(const void* x, const void* w, const void* bias, void* y, void* s, int n,
                int cin, int cout, int h, int wd, int bw, void* stream) {
  if (!loop_shape_ok(n, cin, cout, h, wd, bw)) return kInvalid;
  return static_cast<int>(launch_conv(x, w, bias, y, s, n, cin, cout, h, wd, bw,
                                      static_cast<cudaStream_t>(stream)));
}

// The same at fp32: x and y fp32; w (2, 3, 3, cout, cin) fp32, the K-major
// weight split into hi, then lo; s (2, n, h, w, cin) fp32 scratch, x split.
int vcd_conv3x3_f32(const void* x, const void* w, const void* bias, void* y, void* s, int n,
                    int cin, int cout, int h, int wd, int bw, void* stream) {
  if (!loop_shape_ok(n, cin, cout, h, wd, bw)) return kInvalid;
  return static_cast<int>(launch_conv_f32<false>(x, nullptr, nullptr, w, bias, nullptr, y, s,
                                                 nullptr, nullptr, n, cin, cout, h, wd, bw,
                                                 static_cast<cudaStream_t>(stream)));
}

// dw (cout, cin, 3, 3) fp32 = sum over n, h, w of dy (n, cout, h, w) bf16
// times silu(a*x + o) shifted, x (n, cin, h, w) bf16, a, o (n, cin) fp32;
// s (n, h, w, cin) bf16 scratch; 1 <= splits <= DW_MAX_SPLITS (a cluster)
// and <= the pixel units, n * ceil(h / (128 / cols)) * (w / cols) with
// cols = dw_cols(w).
int vcd_conv3x3_dw(const void* x, const void* a, const void* o, const void* dy, void* s,
                   void* dw, int n, int cin, int cout, int h, int w, int splits, void* stream) {
  if (n < 1 || n > 65535 || cin < DW_CI || cin % DW_CI != 0 || cout < DW_CO ||
      cout % DW_CO != 0 || h < 1 || w < 16 || w % 16 != 0)
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

// dw (cout, cin, 3, 3) fp32 = sum over n, h, w of dy (n, cout, h, w) fp32
// times silu(a*x + o) shifted, x (n, cin, h, w) fp32; s (n, cin, h, w) fp32
// and dy_split (2, n, cout, h, w) fp32 scratch; dw_part (splits, cout, cin,
// 3, 3) fp32 scratch for more than one split, else null; cin and cout
// multiples of 64, w of 16; 1 <= splits <= DW_MAX_SPLITS and <= the pixel
// units, n * ceil(h / (64 / cols)) * (w / cols) with cols = dw_f32_cols(w).
int vcd_conv3x3_dw_f32(const void* x, const void* a, const void* o, const void* dy, void* s,
                       void* dy_split, void* dw_part, void* dw, int n, int cin, int cout, int h,
                       int w, int splits, void* stream) {
  if (n < 1 || cin < DWF_CI || cin % DWF_CI != 0 || cout < DWF_CO || cout % DWF_CO != 0 ||
      h < 1 || w < 16 || w % 16 != 0)
    return kInvalid;
  const int cols = dw_f32_cols(w), rows = DWF_PIX / cols;
  const long long units = static_cast<long long>(n) * ((h + rows - 1) / rows) * (w / cols);
  if (splits < 1 || splits > units || splits > DW_MAX_SPLITS ||
      (splits > 1) != (dw_part != nullptr))
    return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cols == 32 ? launch_dw_f32<32>(x, a, o, dy, s, dy_split, dw_part, dw, n, cin, cout, h, w,
                                     splits, st)
                 : launch_dw_f32<16>(x, a, o, dy, s, dy_split, dw_part, dw, n, cin, cout, h, w,
                                     splits, st);
  return static_cast<int>(err);
}

// conv3x3_dw_f32's dynamic shared memory a block at width w (a multiple of
// 16), bytes: the ring of two units (the window and dy's hi and lo rows), the
// 1024-byte alignment and the barriers; or -1 for another width.
int vcd_conv3x3_dw_f32_smem(int w) {
  if (w < 16 || w % 16 != 0) return -1;
  return dw_f32_cols(w) == 32 ? DwF32Tile<32>::SMEM : DwF32Tile<16>::SMEM;
}

const char* vcd_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
