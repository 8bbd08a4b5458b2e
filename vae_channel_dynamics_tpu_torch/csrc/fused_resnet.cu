// The fused GroupNorm+SiLU+conv3x3 resnet kernels, hand-written for Hopper
// (sm_90a), over NCHW tensors with no layout transposes.
//
// Replaces the Pallas TPU kernels of vae_channel_dynamics_tpu/ops/
// pallas_resnet.py:
//   fused_gn_silu_conv3x3 <- _fused_fwd_kernel (:173): y = conv3x3(silu(a*x + o))
//                            + bias (+ residual), the optional sum |z| tap over
//                            the tile's own pixels and the optional sum y,
//                            sum y^2 of the fp32 output;
//   conv3x3               <- _plain_conv_kernel (:361): conv3x3(x) + bias, which
//                            the backward runs on dy with the flipped,
//                            channel-swapped weight (:348-358);
//   conv3x3_dw            <- _dw_kernel (:423): dW = sum over N, H, W of
//                            silu(a*x + o) shifted, times dy, with s recomputed
//                            from x in the load.
//
// What bounds them on the H100: at the 256px step's 32x32 mid-level resnets
// (16, 512, 32, 32), each is 2*N*H*W*9*Cin*Cout = 77.3 GFLOP against about
// 55 MB of device memory, some 1,400 FLOPs a byte: tensor-core bound (0.078
// ms at 989 TFLOP/s; the bytes need 0.016 ms). The design keeps every
// operand of the products in shared memory and every accumulator in
// registers, and feeds bf16 mma.sync (m16n8k16, fp32 accumulate) from
// ldmatrix loads; wgmma/TMA and a pipelined K loop are later work.
//
// The convolution is an implicit GEMM. Forward and input gradient: M = output
// channels, N = a tile of output pixels, K = 9 * input channels. A block owns
// 128 output channels of one sample and an 8-row by 16-column pixel tile, so
// any W that is a multiple of 16 and any H work (rows past H are masked).
// Per chunk of 32 input channels it
//   1. copies the weights, laid out [tap][out][in] by the wrapper, with
//      cp.async into shared memory (9 x 128 x 32, rows padded to 40);
//   2. reads the 10 x 18 halo window of x for those channels, applies
//      z = a*x + o in fp32, zeroes the out-of-image rows and columns after the
//      affine (a zero x would otherwise normalise to o), takes s = z*sigmoid(z),
//      rounds s to bf16 and stores it pixel-major, [pixel][channel]: a shifted
//      tap is then only another pixel row, so every ldmatrix address stays
//      16-byte aligned whatever the shift;
//   3. runs 9 taps x 2 k-steps of 16 on eight warps, each 64 channels x 32
//      pixels (4 x 4 mma tiles, 64 fp32 accumulators a thread).
// The epilogue adds bias and residual in fp32, stores bf16, and writes the
// tile's sum y and sum y^2 per channel; the |z| tap sums only the tile's own
// pixels, never the halo. Those per-tile partials are written without
// atomics and a second kernel sums them over tiles in a fixed order.
// conv3x3 is the same kernel with s = x (no affine, no SiLU).
//
// conv3x3_dw: M = output channels, N = 9 taps x input channels, K = pixels.
// A block owns 64 output x 32 input channels for all 9 taps and loops over a
// contiguous range of 8 x 16 pixel tiles (a split of N*tiles); per tile it
// copies dy [channel][pixel] with cp.async (zero-filled past H), recomputes
// the s window as above, and runs 8 k-steps of 16 pixels, B read with
// ldmatrix.trans. Each split writes its fp32 dW partial; a second kernel sums
// the splits in a fixed order into OIHW fp32. Two runs give the same bits.
//
// Plain C interface for ctypes: pointers and the stream are void*; every
// activation is bf16 NCHW, a and o fp32 (N, Cin), bias fp32 or null. Each
// function returns cudaGetLastError() after its launches; it launches on the
// caller's stream, allocates nothing and does not synchronise.

#include "sm90_mma.cuh"

namespace {

using namespace vcd;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TR = 8, TC = 16;            // output pixel tile: 8 rows x 16 columns
constexpr int WR = TR + 2, WC = TC + 2;   // its halo window: 10 x 18
constexpr int WIN_PX = WR * WC;
constexpr int KC = 32;                    // input channels per window
constexpr int LDW = KC + PAD;             // window row stride: [pixel][channel]
constexpr int WIN_ITEMS = WR * KC;        // (window row, channel) pairs

// forward / input-gradient conv
constexpr int BM = 128;                   // output channels per block
constexpr int LDA = KC + PAD;             // weight rows [tap][out][in chunk]
constexpr int A_BYTES = 9 * BM * LDA * 2;
constexpr int W_BYTES = WIN_PX * LDW * 2;
constexpr int TAP_BYTES = WARPS * 32 * 4;
constexpr int CONV_SMEM = A_BYTES + W_BYTES + TAP_BYTES;

// weight gradient
constexpr int DW_BM = 64;                 // output channels per block
constexpr int LDD = TR * TC + PAD;        // dy tile [channel][pixel]

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// z = x*a + o as two rounded operations, like the plain version's x*a + o
__device__ __forceinline__ float affine(float x, float a, float o) {
  return __fadd_rn(__fmul_rn(x, a), o);
}

// Fills the [pixel][channel] halo window for KC channels starting at plane
// `plane0` (= sample * C + first channel) around the tile whose top-left
// output pixel is (row0, col0). With GN, s = silu(a*x + o) rounded to bf16,
// zero outside the image; without, s = x, zero outside. Returns this thread's
// sum |z| over the tile's own pixels of channel (tid % KC); KC = 32 and 256
// threads put one channel on each lane.
template <bool GN>
__device__ __forceinline__ float fill_window(bf16* __restrict__ win, const bf16* __restrict__ x,
                                             const float* __restrict__ a,
                                             const float* __restrict__ o, int plane0, int h,
                                             int w, int row0, int col0, int tid) {
  float tap = 0.0f;
  for (int i = tid; i < WIN_ITEMS; i += THREADS) {
    const int ch = i % KC, wr = i / KC;
    const int row = row0 - 1 + wr;
    const bool row_ok = row >= 0 && row < h;
    const bool left_ok = row_ok && col0 > 0;
    const bool right_ok = row_ok && col0 + TC < w;
    bf16 raw[WC];
    const bf16 zero = __float2bfloat16(0.0f);
    if (row_ok) {
      const bf16* xp = x + (static_cast<size_t>(plane0 + ch) * h + row) * w + col0;
      const uint4 lo = *reinterpret_cast<const uint4*>(xp);
      const uint4 hi = *reinterpret_cast<const uint4*>(xp + 8);
      const bf16* l8 = reinterpret_cast<const bf16*>(&lo);
      const bf16* h8 = reinterpret_cast<const bf16*>(&hi);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        raw[1 + j] = l8[j];
        raw[9 + j] = h8[j];
      }
      raw[0] = left_ok ? xp[-1] : zero;
      raw[WC - 1] = right_ok ? xp[TC] : zero;
    } else {
#pragma unroll
      for (int j = 0; j < WC; ++j) raw[j] = zero;
    }
    bf16* dst = win + (wr * WC) * LDW + ch;
    if (GN) {
      const float ap = a[plane0 + ch], op = o[plane0 + ch];
      const bool own = row_ok && wr >= 1 && wr <= TR;
#pragma unroll
      for (int j = 0; j < WC; ++j) {
        const bool ok = (j == 0) ? left_ok : (j == WC - 1) ? right_ok : row_ok;
        const float z = ok ? affine(__bfloat162float(raw[j]), ap, op) : 0.0f;
        if (own && j >= 1 && j <= TC) tap += fabsf(z);
        dst[j * LDW] = __float2bfloat16(z * sigmoid(z));
      }
    } else {
#pragma unroll
      for (int j = 0; j < WC; ++j) dst[j * LDW] = raw[j];
    }
  }
  return tap;
}

// y (N, Cout, H, W) = conv3x3(s) + bias (+ residual), s = silu(a*x + o) with
// GN or x without; see the header. Grid (tiles, Cout / BM, N).
template <bool GN>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ o, const bf16* __restrict__ w9,
                   const float* __restrict__ bias, const bf16* __restrict__ residual,
                   bf16* __restrict__ y, float* __restrict__ tap_part,
                   float* __restrict__ mom_part, int cin, int cout, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sW = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* sTap = reinterpret_cast<float*>(smem + A_BYTES + W_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int gid = lane / 4, tig = lane % 4;
  const int tiles_w = w / TC;
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int row0 = (tile / tiles_w) * TR, col0 = (tile % tiles_w) * TC;
  const int co0 = blockIdx.y * BM;
  const int n = blockIdx.z;
  const bool emit_tap = GN && tap_part != nullptr && blockIdx.y == 0;

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
    // 2. the s window
    const float tap = fill_window<GN>(sW, x, a, o, n * cin + ci0, h, w, row0, col0, tid);
    if (emit_tap) sTap[tid] = tap;
    cp_async_wait<0>();
    __syncthreads();
    if (emit_tap && warp == 0) {
      float t = 0.0f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) t += sTap[k * 32 + lane];
      tap_part[(static_cast<size_t>(n) * tiles + tile) * cin + ci0 + lane] = t;
    }
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

  // epilogue: bias, residual, bf16 store, per-tile moments
  const bool moments = mom_part != nullptr;
  __syncthreads();  // sA is reused for the moments' cross-warp sums
  float* sSum = reinterpret_cast<float*>(smem);
  float* sSq = sSum + 4 * BM;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cl = warp_m * 64 + mt * 16 + gid + half * 8;
      const int co = co0 + cl;
      const float bc = bias != nullptr ? bias[co] : 0.0f;
      float msum = 0.0f, msq = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int row = row0 + 2 * warp_n + nt / 2;
        if (row >= h) continue;
        const int col = col0 + (nt % 2) * 8 + 2 * tig;
        const size_t off = (static_cast<size_t>(n * cout + co) * h + row) * w + col;
        float y0 = acc[mt][nt][2 * half] + bc, y1 = acc[mt][nt][2 * half + 1] + bc;
        if (residual != nullptr) {
          const float2 rv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(residual + off));
          y0 += rv.x;
          y1 += rv.y;
        }
        msum += y0 + y1;
        msq += y0 * y0 + y1 * y1;
        *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(y0, y1);
      }
      if (moments) {
        msum += __shfl_xor_sync(0xffffffffu, msum, 1);
        msum += __shfl_xor_sync(0xffffffffu, msum, 2);
        msq += __shfl_xor_sync(0xffffffffu, msq, 1);
        msq += __shfl_xor_sync(0xffffffffu, msq, 2);
        if (tig == 0) {
          sSum[warp_n * BM + cl] = msum;
          sSq[warp_n * BM + cl] = msq;
        }
      }
    }
  }
  if (moments) {
    __syncthreads();
    if (tid < BM) {
      float s = 0.0f, q = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s += sSum[k * BM + tid];
        q += sSq[k * BM + tid];
      }
      const size_t off = (static_cast<size_t>(n) * tiles + tile) * cout + co0 + tid;
      mom_part[off] = s;
      mom_part[static_cast<size_t>(gridDim.z) * tiles * cout + off] = q;
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

// dW partial of one split: part[split][co][tap][ci] = sum over the split's
// pixel tiles of dy[co][p] * s[ci][p + tap shift]. Grid (Cin / KC,
// Cout / DW_BM, splits).
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_dw_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ o, const bf16* __restrict__ dy,
                      float* __restrict__ part, int n_batch, int cin, int cout, int h, int w) {
  __shared__ __align__(16) bf16 sDy[DW_BM * LDD];
  __shared__ __align__(16) bf16 sW[WIN_PX * LDW];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int gid = lane / 4, tig = lane % 4;
  const int ci0 = blockIdx.x * KC, co0 = blockIdx.y * DW_BM;
  const int tiles_w = w / TC, tiles = ((h + TR - 1) / TR) * tiles_w;
  const int total = n_batch * tiles, splits = gridDim.z;
  const int g_begin = static_cast<int>(static_cast<long long>(blockIdx.z) * total / splits);
  const int g_end = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * total / splits);

  float acc[2][9][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

  for (int g = g_begin; g < g_end; ++g) {
    const int nn = g / tiles, tile = g % tiles;
    const int row0 = (tile / tiles_w) * TR, col0 = (tile % tiles_w) * TC;
    __syncthreads();  // the previous tile's products are done with sDy, sW
    // dy [co0 .. co0+63][8 rows x 16 columns], zero past H
    for (int i = tid; i < DW_BM * TR * 2; i += THREADS) {
      const int co = i / (TR * 2), r = (i / 2) % TR, part16 = i % 2;
      const int row = row0 + r;
      const bool ok = row < h;
      const bf16* src =
          dy + (static_cast<size_t>(nn * cout + co0 + co) * h + (ok ? row : 0)) * w + col0 +
          part16 * 8;
      cp_async16_zfill(sDy + co * LDD + r * TC + part16 * 8, src, ok);
    }
    cp_async_commit();
    fill_window<true>(sW, x, a, o, nn * cin + ci0, h, w, row0, col0, tid);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < TR; ++r) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], sDy + (warp_m * 32 + mt * 16 + (lane & 15)) * LDD + r * TC +
                                (lane >> 4) * 8);
      // k = the 16 pixels of tile row r; lanes 0-7 pixels 0-7, 8-15 pixels 8-15
      const int c = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, sW + ((r + j / 3) * WC + c + j % 3) * LDW + warp_n * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][j], af[mt], bf[0], bf[1]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int co = co0 + warp_m * 32 + mt * 16 + gid + half * 8;
        const int ci = ci0 + warp_n * 8 + 2 * tig;
        const size_t off = ((static_cast<size_t>(blockIdx.z) * cout + co) * 9 + j) * cin + ci;
        *reinterpret_cast<float2*>(part + off) =
            make_float2(acc[mt][j][2 * half], acc[mt][j][2 * half + 1]);
      }
}

// dw[co][ci][tap] (OIHW) = sum over splits of part[split][co][tap][ci], in
// order of the split.
__global__ void sum_dw_kernel(const float* __restrict__ part, float* __restrict__ dw,
                              int splits, int cin, int cout) {
  const size_t n_out = static_cast<size_t>(cout) * 9 * cin;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int ci = static_cast<int>(idx % cin);
  const int tap = static_cast<int>((idx / cin) % 9);
  const int co = static_cast<int>(idx / (static_cast<size_t>(cin) * 9));
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += part[k * n_out + idx];
  dw[(static_cast<size_t>(co) * cin + ci) * 9 + tap] = s;
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

template <bool GN>
cudaError_t launch_conv(const void* x, const void* a, const void* o, const void* w9,
                        const void* bias, const void* residual, void* y, void* tap_part,
                        void* mom_part, int n, int cin, int cout, int h, int w,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<GN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CONV_SMEM);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<GN><<<dim3(tile_count(h, w), cout / BM, n), THREADS, CONV_SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(o),
      static_cast<const bf16*>(w9), static_cast<const float*>(bias),
      static_cast<const bf16*>(residual), static_cast<bf16*>(y), static_cast<float*>(tap_part),
      static_cast<float*>(mom_part), cin, cout, h, w);
  return cudaGetLastError();
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

// x (n, cin, h, w) bf16; a, o (n, cin) fp32; w9 (9, cout, cin) bf16, the OIHW
// weight as [kh*3 + kw][out][in]; bias (cout) fp32 or null; residual (n, cout,
// h, w) bf16 or null; y (n, cout, h, w) bf16. For the |z| tap, tap_part
// (n, tiles, cin) fp32 scratch and tap (n, cin) fp32, else both null; for the
// moments, mom_part (2, n, tiles, cout) fp32 scratch and ysum, ysq (n, cout)
// fp32, else all null. tiles = ceil(h / 8) * (w / 16).
int vcd_fused_gn_silu_conv3x3(const void* x, const void* a, const void* o, const void* w9,
                              const void* bias, const void* residual, void* y, void* tap_part,
                              void* tap, void* mom_part, void* ysum, void* ysq, int n, int cin,
                              int cout, int h, int w, void* stream) {
  if (!conv_shape_ok(n, cin, cout, h, w)) return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_conv<true>(x, a, o, w9, bias, residual, y, tap_part, mom_part, n, cin,
                                      cout, h, w, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = tile_count(h, w);
  if (tap_part != nullptr) {
    err = sum_tiles(static_cast<const float*>(tap_part), static_cast<float*>(tap), n, tiles, cin,
                    s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (mom_part != nullptr) {
    const float* mp = static_cast<const float*>(mom_part);
    const size_t one = static_cast<size_t>(n) * tiles * cout;
    err = sum_tiles(mp, static_cast<float*>(ysum), n, tiles, cout, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = sum_tiles(mp + one, static_cast<float*>(ysq), n, tiles, cout, s);
  }
  return static_cast<int>(err);
}

// y (n, cout, h, w) bf16 = conv3x3(x (n, cin, h, w) bf16) + bias; w9 and bias
// as above.
int vcd_conv3x3(const void* x, const void* w9, const void* bias, void* y, int n, int cin,
                int cout, int h, int w, void* stream) {
  if (!conv_shape_ok(n, cin, cout, h, w)) return kInvalid;
  return static_cast<int>(launch_conv<false>(x, nullptr, nullptr, w9, bias, nullptr, y, nullptr,
                                             nullptr, n, cin, cout, h, w,
                                             static_cast<cudaStream_t>(stream)));
}

// dw (cout, cin, 3, 3) fp32 = sum over n, h, w of dy (n, cout, h, w) bf16
// times silu(a*x + o) shifted, x (n, cin, h, w) bf16, a, o (n, cin) fp32;
// part (splits, cout, 9, cin) fp32 scratch; 1 <= splits <= n * tiles.
int vcd_conv3x3_dw(const void* x, const void* a, const void* o, const void* dy, void* part,
                   void* dw, int n, int cin, int cout, int h, int w, int splits, void* stream) {
  if (!conv_shape_ok(n, cin, cout, h, w) || cout % DW_BM != 0 || splits < 1 ||
      splits > n * tile_count(h, w) || splits > 65535)
    return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv3x3_dw_kernel<<<dim3(cin / KC, cout / DW_BM, splits), THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(o),
      static_cast<const bf16*>(dy), static_cast<float*>(part), n, cin, cout, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(cout) * 9 * cin;
  sum_dw_kernel<<<static_cast<unsigned>((n_out + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

const char* vcd_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
