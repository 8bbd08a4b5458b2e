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
// limit and has no counterpart: the halo is a predicated zero-fill load.
//
// x (N, H, W, Cin) bf16, w HWIO (3, 3, Cin, Cout) bf16, b (Cout) fp32,
// y (N, H, W, Cout) bf16; fp32 accumulation, the bias added in the fp32
// epilogue, y rounded once.
//
// What bounds it on the H100: 2*N*H*W*9*Cin*Cout FLOPs against
// 2*N*H*W*(Cin + Cout) bytes of activations, 9*Cin/2 or more FLOPs a byte
// (576 at Cin = 128): tensor-core bound at every shape of the bench (0.156
// ms at 989 TFLOP/s for its shapes A-C). The design keeps both operands of
// each product in shared memory and the accumulators in registers, and feeds
// bf16 mma.sync (m16n8k16, fp32 accumulate) from ldmatrix loads, with the
// next K chunk's copy in flight behind the current chunk's products
// (cp.async, two stages); wgmma/TMA are later work.
//
// The implicit GEMM: M = 128 consecutive output pixels of one image (in
// row-major (h, w) order, so any H and W work; pixels past H*W are masked),
// N = 64 output channels, K in chunks of 32 input channels of one tap. Per
// chunk a block of 4 warps
//   1. copies the 128 x 32 input window for the tap, [pixel][channel], with
//      16-byte cp.async along the contiguous Cin, zero-filled where the
//      shifted pixel lies outside the image (the halo; the row never wraps
//      into its neighbour) or past H*W;
//   2. copies the 32 x 64 weight tile, [channel][out], along the contiguous
//      Cout;
//   3. runs 2 k-steps of 16 on the 4 warps, each 64 pixels x 32 channels
//      (4 x 4 mma tiles, 64 fp32 accumulators a thread), A read with
//      ldmatrix and B with ldmatrix.trans.
// No atomics: each output is written once by one block, so runs are
// bit-equal.
//
// Plain C interface for ctypes: pointers and the stream are void*; the
// function returns cudaGetLastError() after its launch. It launches on the
// caller's stream, allocates nothing and does not synchronise.

#include "sm90_mma.cuh"

namespace {

using namespace vcd;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = 128;           // output pixels per block
constexpr int BN = 64;            // output channels per block
constexpr int KC = 32;            // input channels per K chunk
constexpr int LDA = KC + PAD;     // window rows [pixel][channel]
constexpr int LDB = BN + PAD;     // weight rows [channel][out]
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = KC * LDB;

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// Stage one K chunk (tap, ci0 .. ci0+31) into sA and sB.
__device__ __forceinline__ void load_chunk(bf16* __restrict__ sA, bf16* __restrict__ sB,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int n, int h, int wd,
                                           int cin, int cout, int p0, int co0, int tap, int ci0,
                                           int tid) {
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int hw = h * wd;
  // the window: 128 pixels x 4 parts of 8 channels
#pragma unroll
  for (int it = 0; it < BM * (KC / 8) / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int px = i / (KC / 8), part = i % (KC / 8);
    const int p = p0 + px;
    const int row = p / wd + dy, col = p % wd + dx;
    const bool ok = p < hw && row >= 0 && row < h && col >= 0 && col < wd;
    const bf16* src =
        ok ? x + ((static_cast<size_t>(n) * h + row) * wd + col) * cin + ci0 + part * 8 : x;
    cp_async16_zfill(sA + px * LDA + part * 8, src, ok);
  }
  // the weight: 32 channels x 8 parts of 8 outputs
#pragma unroll
  for (int it = 0; it < KC * (BN / 8) / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int kr = i / (BN / 8), part = i % (BN / 8);
    cp_async16(sB + kr * LDB + part * 8,
               w + (static_cast<size_t>(tap) * cin + ci0 + kr) * cout + co0 + part * 8);
  }
}

// Grid (ceil(H*W / BM), Cout / BN, N).
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_nhwc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ bias, bf16* __restrict__ y, int h, int wd,
                        int cin, int cout) {
  __shared__ __align__(16) bf16 sA[2][A_ELEMS];
  __shared__ __align__(16) bf16 sB[2][B_ELEMS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 2, warp_n = warp % 2;  // 64 pixels x 32 channels each
  const int gid = lane / 4, tig = lane % 4;
  const int p0 = blockIdx.x * BM, co0 = blockIdx.y * BN, n = blockIdx.z;
  const int chunks_per_tap = cin / KC;
  const int nchunks = 9 * chunks_per_tap;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  load_chunk(sA[0], sB[0], x, w, n, h, wd, cin, cout, p0, co0, 0, 0, tid);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    const int next = kc + 1;
    if (next < nchunks)
      load_chunk(sA[next & 1], sB[next & 1], x, w, n, h, wd, cin, cout, p0, co0,
                 next / chunks_per_tap, (next % chunks_per_tap) * KC, tid);
    cp_async_commit();  // committed even when empty, so the wait count stays uniform
    cp_async_wait<1>();  // chunk kc has landed
    __syncthreads();
    const bf16* a = sA[kc & 1];
    const bf16* b = sB[kc & 1];
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], a + (warp_m * 64 + mt * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
      const int m = lane >> 3;
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(
            bfr, b + (kk + (lane & 7) + (m & 1) * 8) * LDB + warp_n * 32 + nt * 8 + (m >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][nt], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][nt + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the chunk after next
  }

  // epilogue: bias in fp32, one bf16 rounding
  const int hw = h * wd;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int co = co0 + warp_n * 32 + nt * 8 + 2 * tig;
    const float b0 = bias[co], b1 = bias[co + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + warp_m * 64 + mt * 16 + gid + half * 8;
        if (p >= hw) continue;
        const size_t off = (static_cast<size_t>(n) * hw + p) * cout + co;
        *reinterpret_cast<__nv_bfloat162*>(y + off) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half] + b0, acc[mt][nt][2 * half + 1] + b1);
      }
    }
  }
}

}  // namespace

extern "C" {

// x (n, h, w, cin) bf16, w (3, 3, cin, cout) bf16, bias (cout) fp32, y (n, h,
// w, cout) bf16, all contiguous and 16-byte aligned; cin a multiple of 32,
// cout of 64, 1 <= n <= 65535.
int vcd_conv3x3_nhwc(const void* x, const void* w, const void* bias, void* y, int n, int h,
                     int wd, int cin, int cout, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || wd < 1 || cin < KC || cin % KC != 0 || cout < BN ||
      cout % BN != 0 || cout / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks_m = (static_cast<long long>(h) * wd + BM - 1) / BM;
  if (blocks_m > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_nhwc_kernel<<<dim3(static_cast<unsigned>(blocks_m), cout / BN, n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(y), h, wd, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

const char* vcd_conv_nhwc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
