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
// The design is the implicit GEMM of sm90_conv3x3.cuh (shared with kernel
// #9, fused_resnet.cu), whose header has it; this kernel's epilogue adds the
// bias in fp32 and stores bf16 pairs, masked to the image and to Cout.
// No atomics: each output is written once by one block, so runs are
// bit-equal.
//
// Plain C interface for ctypes: pointers and the stream are void*; the
// function returns cudaGetLastError() after its launch. It launches on the
// caller's stream, allocates nothing and does not synchronise.

#include "sm90_conv3x3.cuh"

namespace {

using namespace vcd::sm90;
namespace c3 = vcd::conv3x3;
typedef __nv_bfloat16 bf16;

// y (N, H, W, Cout) = acc + bias, one bf16 rounding, masked to the image and
// Cout. The bias is read with __ldg: read-only loads may move ahead of the
// stores to y, which plain loads through these struct pointers may not
// (interleaved with the stores they made the kernel up to 20% slower at the
// conv bench's shape C).
struct NhwcBias {
  const float* bias;
  bf16* y;
  int h, wd, cout;

  __device__ __forceinline__ void operator()(float (&acc)[64], uint8_t* /*smem*/,
                                             const c3::Tile& t, int wg, int warp,
                                             int lane) const {
    const int gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wg * 64 + (warp % 4) * 16 + gid + half * 8;
      const int ph = t.h0 + m / t.bw, pw = t.w0 + m % t.bw;
      if (ph >= h || pw >= wd) continue;
      bf16* yp = y + ((static_cast<size_t>(t.n) * h + ph) * wd + pw) * cout;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int co = t.co0 + 8 * j + 2 * tig;
        if (co >= cout) continue;
        *reinterpret_cast<__nv_bfloat162*>(yp + co) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] + __ldg(bias + co),
                                  acc[4 * j + 2 * half + 1] + __ldg(bias + co + 1));
      }
    }
  }
};

template <int KC>
__global__ void __launch_bounds__(c3::THREADS, 2)
    conv3x3_nhwc_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const NhwcBias epi, int wd,
                        int cin, int bw) {
  c3::conv3x3_wgmma<KC>(&xmap, &wmap, wd, cin, bw, epi);
}

template <int KC>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, int n, int h, int wd,
                   int cin, int cout, int bw, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  cudaError_t err = c3::make_maps(&xmap, &wmap, x, w, n, h, wd, cin, cout, bw, KC);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_nhwc_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             c3::SMEM);
  if (err != cudaSuccess) return err;
  const NhwcBias epi = {static_cast<const float*>(bias), static_cast<bf16*>(y), h, wd, cout};
  conv3x3_nhwc_kernel<KC><<<c3::grid(n, h, wd, cout, bw), c3::THREADS, c3::SMEM, stream>>>(
      xmap, wmap, epi, wd, cin, bw);
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
      cout % 64 != 0 || bw < 1 || bw > c3::BM || (bw & (bw - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = c3::BM / bw;
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
