// GroupNorm(+SiLU) forward and backward passes for NCHW tensors, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vae_channel_dynamics_tpu/ops/
// pallas_group_norm.py:
//   gn_fwd_reduce     <- _reduce_kernel (:83): fp32 sum x and sum x^2 per
//                        (sample, channel);
//   gn_fwd_normalize  <- _normalize_kernel (:126) and _normalize_stats_kernel
//                        (:134): y = x*a + b, optional SiLU, cast to x's
//                        type, and optionally the fp32 sum |z| of the pre-SiLU
//                        z per (sample, channel), the paper's activity tap;
//   gn_bwd_reduce     <- _bwd_reduce_kernel (:222): sum g_eff and sum g_eff*x
//                        per (sample, channel), SiLU' folded into g_eff with z
//                        recomputed from x, a and b;
//   gn_bwd_dx         <- _bwd_dx_kernel (:245): dx = g_eff*ca + x*cb + cc.
// The small (B, C) algebra between them (the group combine, mean and rstd,
// the affine fold, the backward's coefficients) stays in PyTorch, as the JAX
// package keeps it in XLA between its kernels.
//
// What bounds them on the H100: each does a few flops per element against 2
// (bf16) or 4 (fp32) bytes read and as many written, far below the card's
// ~295 flops/byte ridge, so all four are bound by device-memory bandwidth.
// The design makes exactly one pass over its inputs: the port is NCHW, so a
// (sample, channel) plane is HW contiguous elements, and one thread block of
// 256 threads owns one plane. It streams the plane in 16-byte vectors
// (8 bf16 or 4 fp32 per load, a warp covers 512 contiguous bytes), computes
// in fp32, and reduces with warp shuffles and one shared-memory step. Each
// per-plane output is written once by thread 0, with no atomics, so the sums
// are identical from run to run. At the 256px batch-16 step's shapes B*C is
// 2048 to 8192 planes, enough blocks to fill the 132 SMs.
//
// gn_fwd_normalize also takes the 1024px batch-1 step's shapes, where B*C is
// 128 to 512 planes of up to 1M elements: one block a plane put 128 blocks
// of 8 warps on 132 SMs, each thread with one 16-byte load in flight, about
// 4 KB an SM where the memory's latency asks for some 20 KB (0.98 TB/s at
// (1, 128, 1024, 1024)). So its grid is planes x S:
//   - each of a plane's S splits owns a contiguous chunk of it, a multiple of
//     8 elements, the last one ragged (split_chunk; norm_splits picks S, the
//     smallest power of two that makes at least 8 blocks for each of the 132
//     SMs, halved while a chunk would hold less than one round of loads or
//     the last chunk would be empty; S = 1 wherever the planes alone reach
//     that count, which is the one-block-a-plane grid);
//   - each thread keeps LOADS 16-byte loads in flight: it loads LOADS
//     vectors, then computes, then stores them (16 KB a block in bf16);
//   - with S > 1 the |z| tap is written as one partial per (plane, split)
//     into a scratch (planes, S), which sum_splits_kernel adds in order of
//     the split: no atomics, so two runs give the same bits.
// y is the same function of each element as before, so it does not depend on S.
//
// gn_bwd_reduce reads two tensors, x and g, at the same shapes and splits
// the same way, with a larger least split (reduce_splits): a split takes at
// least REDUCE_ROUNDS rounds of one 16-byte load a thread, 32 KB of x and
// of g. A smaller split saves less than its second pass and second launch
// cost: at (1, 512, 128, 128), S = 2 (16 KB a split) measured slower than
// one block a plane on the H100, so there S = 1. With S > 1 one pair of
// partials (sum g_eff, sum g_eff*x) per (plane, split) into a (planes, S, 2)
// scratch that sum_splits2_kernel adds in order of the split. Each thread
// keeps one 16-byte load of each tensor in flight, not LOADS: at 34
// registers a thread, against 55 with four of each, more blocks share an SM,
// and on the H100 that was as fast at the 1024px step's shapes and kept the
// 256px batch-16 ones at one block a plane's speed. With S = 1 each thread
// sums the same elements in the same order as one block a plane did, so
// there the sums keep their bits.
//
// gn_bwd_dx reads x and g and writes dx at the same shapes. Once the caller
// has the per-plane coefficients it is elementwise, so it splits each plane
// over dx_splits blocks with no partials, no scratch and no second pass: its
// least split is one round of its DX_LOADS loads a thread, like the
// normalize's, and S = 1 wherever the planes fill the card (every 256px
// batch-16 shape, and the fused path's), the one-block-a-plane grid. Each
// thread keeps DX_LOADS 16-byte loads of x and DX_LOADS of g in flight before
// it computes and stores them (one block a plane with one load of each in
// flight ran (1, 128, 1024, 1024) at 39% of its bound on the H100). Every
// element is written once, by one thread, with the same operations whatever
// S is, so dx does not depend on S, bit for bit.
//
// y = x*a + b is computed as a rounded product and a rounded sum, the same
// two operations as the plain PyTorch version, so the normalised values
// agree bit for bit before the SiLU and the cast.
//
// Plain C interface for ctypes: pointers and the stream are void*; dtype 0 is
// fp32 and 1 is bf16; hw must be a multiple of 8 (the 16-byte vectors of
// bf16, which also keeps every plane 16-byte aligned) and the tensors
// contiguous and 16-byte aligned. Each function returns cudaGetLastError()
// after its launch; it launches on the caller's stream, allocates nothing and
// does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS = 4;                  // 16-byte loads in flight a thread (normalize)
// gn_bwd_reduce's least split: 8 rounds of one 16-byte load a thread, 32 KB
// of x and of g (see the header)
constexpr int REDUCE_ROUNDS = 8;
// gn_bwd_dx's 16-byte loads of x, and as many of g, in flight a thread: on
// the H100 one ran 8% slower than two at (1, 128, 1024, 1024) and (16, 128,
// 256, 256), and four (64 registers against 50) no faster
constexpr int DX_LOADS = 2;
constexpr int TARGET_BLOCKS = 8 * 132;    // 2048 resident threads on each of 132 SMs

// 16-byte vector loads and stores, converted to and from fp32; a raw load
// keeps the 16 bytes unconverted, so that several can be in flight
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  typedef float4 Raw;
  __device__ __forceinline__ static Raw load_raw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    unpack(load_raw(p), v);
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  typedef uint4 Raw;
  __device__ __forceinline__ static Raw load_raw(const bf16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const bf16* p, float (&v)[8]) {
    unpack(load_raw(p), v);
  }
  __device__ __forceinline__ static void store(bf16* p, const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// z = x*a + b as two rounded operations, like the plain version's x*a + b
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// g_eff: the incoming gradient times SiLU'(z) = s(z)(1 + z(1 - s(z)))
template <bool SILU>
__device__ __forceinline__ float grad_eff(float g, float x, float a, float b) {
  if (!SILU) return g;
  const float z = affine(x, a, b);
  const float s = sigmoid(z);
  return g * (s * (1.0f + z * (1.0f - s)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums u and v over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& u, float& v) {
  __shared__ float su[WARPS], sv[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u = warp_sum(u);
  v = warp_sum(v);
  if (lane == 0) {
    su[warp] = u;
    sv[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    u = lane < WARPS ? su[lane] : 0.0f;
    v = lane < WARPS ? sv[lane] : 0.0f;
    u = warp_sum(u);
    v = warp_sum(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_fwd_reduce_kernel(const T* __restrict__ x, float* __restrict__ sum,
                         float* __restrict__ sq, int hw) {
  constexpr int N = Vec<T>::N;
  const int plane = blockIdx.x;
  const T* xp = x + static_cast<size_t>(plane) * hw;
  float s = 0.0f, q = 0.0f;
  for (int i = threadIdx.x * N; i < hw; i += THREADS * N) {
    float v[N];
    Vec<T>::load(xp + i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s += v[j];
      q += v[j] * v[j];
    }
  }
  block_sum2(s, q);
  if (threadIdx.x == 0) {
    sum[plane] = s;
    sq[plane] = q;
  }
}

// Split k of a plane of hw elements, split into chunks of `chunk`: [begin, end).
__device__ __forceinline__ void split_range(int hw, int chunk, int k, int& begin, int& end) {
  begin = min(k * chunk, hw);
  end = min(begin + chunk, hw);
}

// Grid planes * splits, block b the split b % splits of plane b / splits.
// abs_out is indexed by the block: with one split the (planes,) tap itself,
// else the (planes, splits) partials.
template <typename T, bool SILU, bool STATS>
__global__ void __launch_bounds__(THREADS)
    gn_fwd_normalize_kernel(const T* __restrict__ x, const float* __restrict__ a,
                            const float* __restrict__ b, T* __restrict__ y,
                            float* __restrict__ abs_out, int hw, int splits, int chunk) {
  constexpr int N = Vec<T>::N;
  constexpr int STEP = THREADS * N;  // elements of one load by every thread
  const int plane = blockIdx.x / splits;
  int begin, end;
  split_range(hw, chunk, blockIdx.x % splits, begin, end);
  const T* xp = x + static_cast<size_t>(plane) * hw;
  T* yp = y + static_cast<size_t>(plane) * hw;
  const float ap = a[plane], bp = b[plane];
  float s = 0.0f;
  for (int i0 = begin + threadIdx.x * N; i0 < end; i0 += LOADS * STEP) {
    typename Vec<T>::Raw raw[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (i0 + u * STEP < end) raw[u] = Vec<T>::load_raw(xp + i0 + u * STEP);
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      if (i0 + u * STEP >= end) break;
      float v[N];
      Vec<T>::unpack(raw[u], v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float z = affine(v[j], ap, bp);
        if (STATS) s += fabsf(z);
        v[j] = SILU ? z * sigmoid(z) : z;
      }
      Vec<T>::store(yp + i0 + u * STEP, v);
    }
  }
  if (STATS) {
    float unused = 0.0f;
    block_sum2(s, unused);
    if (threadIdx.x == 0) abs_out[blockIdx.x] = s;
  }
}

// out[p] = sum over k < splits of part[p][k], in order of k.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int planes, int splits) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  const float* pp = part + static_cast<size_t>(p) * splits;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += pp[k];
  out[p] = s;
}

// out0[p], out1[p] = the sums over k < splits of part[p][k].x and .y, in
// order of k.
__global__ void sum_splits2_kernel(const float2* __restrict__ part, float* __restrict__ out0,
                                   float* __restrict__ out1, int planes, int splits) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  const float2* pp = part + static_cast<size_t>(p) * splits;
  float s0 = 0.0f, s1 = 0.0f;
  for (int k = 0; k < splits; ++k) {
    s0 += pp[k].x;
    s1 += pp[k].y;
  }
  out0[p] = s0;
  out1[p] = s1;
}

// Grid planes * splits, block b the split b % splits of plane b / splits:
// sum g_eff and sum g_eff*x over the split's chunk, into gsum and gxsum
// with one split, else as the pair part[b].
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ a, const float* __restrict__ b,
                         float* __restrict__ gsum, float* __restrict__ gxsum,
                         float2* __restrict__ part, int hw, int splits, int chunk) {
  constexpr int N = Vec<T>::N;
  const int plane = blockIdx.x / splits;
  int begin, end;
  split_range(hw, chunk, blockIdx.x % splits, begin, end);
  const size_t off = static_cast<size_t>(plane) * hw;
  const float ap = a[plane], bp = b[plane];
  float sg = 0.0f, sgx = 0.0f;
  for (int i = begin + threadIdx.x * N; i < end; i += THREADS * N) {
    float xv[N], gv[N];
    Vec<T>::load(x + off + i, xv);
    Vec<T>::load(g + off + i, gv);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float ge = grad_eff<SILU>(gv[j], xv[j], ap, bp);
      sg += ge;
      sgx += ge * xv[j];
    }
  }
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) {
    if (splits == 1) {
      gsum[plane] = sg;
      gxsum[plane] = sgx;
    } else {
      part[blockIdx.x] = make_float2(sg, sgx);
    }
  }
}

// Grid planes * splits, block b the split b % splits of plane b / splits:
// dx over the split's chunk, DX_LOADS loads of x and of g in flight a thread.
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ ca, const float* __restrict__ cb,
                     const float* __restrict__ cc, T* __restrict__ dx, int hw, int splits,
                     int chunk) {
  constexpr int N = Vec<T>::N;
  constexpr int STEP = THREADS * N;  // elements of one load by every thread
  const int plane = blockIdx.x / splits;
  int begin, end;
  split_range(hw, chunk, blockIdx.x % splits, begin, end);
  const size_t off = static_cast<size_t>(plane) * hw;
  const T* xp = x + off;
  const T* gp = g + off;
  T* dp = dx + off;
  const float ap = a[plane], bp = b[plane];
  const float cap = ca[plane], cbp = cb[plane], ccp = cc[plane];
  for (int i0 = begin + threadIdx.x * N; i0 < end; i0 += DX_LOADS * STEP) {
    typename Vec<T>::Raw xr[DX_LOADS], gr[DX_LOADS];
#pragma unroll
    for (int u = 0; u < DX_LOADS; ++u) {
      if (i0 + u * STEP < end) {
        xr[u] = Vec<T>::load_raw(xp + i0 + u * STEP);
        gr[u] = Vec<T>::load_raw(gp + i0 + u * STEP);
      }
    }
#pragma unroll
    for (int u = 0; u < DX_LOADS; ++u) {
      if (i0 + u * STEP >= end) break;
      float xv[N], gv[N];
      Vec<T>::unpack(xr[u], xv);
      Vec<T>::unpack(gr[u], gv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float ge = grad_eff<SILU>(gv[j], xv[j], ap, bp);
        xv[j] = ge * cap + xv[j] * cbp + ccp;
      }
      Vec<T>::store(dp + i0 + u * STEP, xv);
    }
  }
}

bool bad_shape(int planes, int hw) { return planes < 1 || hw < 8 || hw % 8 != 0; }

template <typename T>
cudaError_t fwd_reduce(const void* x, void* sum, void* sq, int planes, int hw, cudaStream_t s) {
  gn_fwd_reduce_kernel<T><<<planes, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(sum), static_cast<float*>(sq), hw);
  return cudaGetLastError();
}

// A plane's chunk under `splits` splits: ceil(hw / splits) rounded up to a
// multiple of 8 elements (16 bytes of bf16), so every split starts aligned.
int split_chunk(int hw, int splits) { return ((hw + splits - 1) / splits + 7) / 8 * 8; }

// The splits of a plane: the smallest power of two S with planes * S >=
// TARGET_BLOCKS, halved while a chunk would hold less than `rounds` 16-byte
// loads by every thread or the last split would be empty. vec is the
// elements of one 16-byte load.
int splits_for(int planes, int hw, int vec, int rounds) {
  int s = 1;
  while (static_cast<long long>(planes) * s < TARGET_BLOCKS) s *= 2;
  while (s > 1 && (split_chunk(hw, s) < THREADS * vec * rounds ||
                   static_cast<long long>(s - 1) * split_chunk(hw, s) >= hw))
    s /= 2;
  return s;
}

// gn_fwd_normalize's: at least one round of its LOADS loads a thread
int norm_splits(int planes, int hw, int vec) { return splits_for(planes, hw, vec, LOADS); }

// gn_bwd_reduce's: at least REDUCE_ROUNDS rounds of its one load a thread
int reduce_splits(int planes, int hw, int vec) {
  return splits_for(planes, hw, vec, REDUCE_ROUNDS);
}

// gn_bwd_dx's: at least one round of its DX_LOADS loads a thread
int dx_splits(int planes, int hw, int vec) { return splits_for(planes, hw, vec, DX_LOADS); }

template <typename T, bool SILU, bool STATS>
cudaError_t fwd_normalize(const void* x, const void* a, const void* b, void* y, void* abs_sum,
                          void* part, int planes, int hw, int splits, cudaStream_t s) {
  gn_fwd_normalize_kernel<T, SILU, STATS><<<planes * splits, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(splits > 1 ? part : abs_sum), hw, splits,
      split_chunk(hw, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !STATS || splits == 1) return err;
  sum_splits_kernel<<<(planes + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(abs_sum), planes, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_normalize_t(const void* x, const void* a, const void* b, void* y, void* abs_sum,
                            void* part, int planes, int hw, int silu, int splits,
                            cudaStream_t s) {
  if (abs_sum != nullptr) {
    return silu ? fwd_normalize<T, true, true>(x, a, b, y, abs_sum, part, planes, hw, splits, s)
                : fwd_normalize<T, false, true>(x, a, b, y, abs_sum, part, planes, hw, splits, s);
  }
  return silu ? fwd_normalize<T, true, false>(x, a, b, y, abs_sum, part, planes, hw, splits, s)
              : fwd_normalize<T, false, false>(x, a, b, y, abs_sum, part, planes, hw, splits, s);
}

template <typename T, bool SILU>
cudaError_t bwd_reduce(const void* x, const void* g, const void* a, const void* b, void* gsum,
                       void* gxsum, void* part, int planes, int hw, int splits, cudaStream_t s) {
  gn_bwd_reduce_kernel<T, SILU><<<planes * splits, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(gsum), static_cast<float*>(gxsum),
      static_cast<float2*>(part), hw, splits, split_chunk(hw, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  sum_splits2_kernel<<<(planes + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float2*>(part), static_cast<float*>(gsum), static_cast<float*>(gxsum),
      planes, splits);
  return cudaGetLastError();
}

template <typename T, bool SILU>
cudaError_t bwd_dx(const void* x, const void* g, const void* a, const void* b, const void* ca,
                   const void* cb, const void* cc, void* dx, int planes, int hw, int splits,
                   cudaStream_t s) {
  gn_bwd_dx_kernel<T, SILU><<<planes * splits, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(ca), static_cast<const float*>(cb),
      static_cast<const float*>(cc), static_cast<T*>(dx), hw, splits, split_chunk(hw, splits));
  return cudaGetLastError();
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

// x: (planes, hw); sum, sq: (planes,) fp32.
int vcd_gn_fwd_reduce(const void* x, void* sum, void* sq, int planes, int hw, int dtype,
                      void* stream) {
  if (bad_shape(planes, hw)) return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(fwd_reduce<float>(x, sum, sq, planes, hw, s));
    case 1: return static_cast<int>(fwd_reduce<bf16>(x, sum, sq, planes, hw, s));
    default: return kInvalid;
  }
}

// x, y: (planes, hw); a, b: (planes,) fp32; abs_sum: (planes,) fp32, or null
// for no |z| tap. splits is the count the caller chose for each plane, and
// parts the partials a plane the caller sized part by: part (planes, parts)
// fp32 scratch for the tap's partials, null with parts 0 where there is no
// tap or one split. The call is refused unless splits is the kernel's own,
// norm_splits(planes, hw, 16 / element size), and parts is splits where the
// tap has partials.
int vcd_gn_fwd_normalize(const void* x, const void* a, const void* b, void* y, void* abs_sum,
                         void* part, int planes, int hw, int dtype, int silu, int splits,
                         int parts, void* stream) {
  if (bad_shape(planes, hw) || (dtype != 0 && dtype != 1)) return kInvalid;
  if (splits != norm_splits(planes, hw, dtype == 0 ? Vec<float>::N : Vec<bf16>::N))
    return kInvalid;
  const bool partials = abs_sum != nullptr && splits > 1;
  if (partials ? (part == nullptr || parts != splits) : (part != nullptr || parts != 0))
    return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? fwd_normalize_t<float>(x, a, b, y, abs_sum, part, planes, hw, silu, splits, s)
                 : fwd_normalize_t<bf16>(x, a, b, y, abs_sum, part, planes, hw, silu, splits, s));
}

// x, g: (planes, hw); a, b: (planes,) fp32; gsum, gxsum: (planes,) fp32.
// splits is the count the caller chose for each plane, and parts the
// partials a plane the caller sized part by: part (planes, parts, 2) fp32
// scratch for the per-split pairs of partials, null with parts 0 where
// there is one split. The call is refused unless splits is the kernel's
// own, reduce_splits(planes, hw, 16 / element size), and parts is splits
// where there are several.
int vcd_gn_bwd_reduce(const void* x, const void* g, const void* a, const void* b, void* gsum,
                      void* gxsum, void* part, int planes, int hw, int dtype, int silu,
                      int splits, int parts, void* stream) {
  if (bad_shape(planes, hw) || (dtype != 0 && dtype != 1)) return kInvalid;
  if (splits != reduce_splits(planes, hw, dtype == 0 ? Vec<float>::N : Vec<bf16>::N))
    return kInvalid;
  if (splits > 1 ? (part == nullptr || parts != splits) : (part != nullptr || parts != 0))
    return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (silu ? 1 : 0)) {
    case 0: return static_cast<int>(bwd_reduce<float, false>(x, g, a, b, gsum, gxsum, part, planes, hw, splits, s));
    case 1: return static_cast<int>(bwd_reduce<float, true>(x, g, a, b, gsum, gxsum, part, planes, hw, splits, s));
    case 2: return static_cast<int>(bwd_reduce<bf16, false>(x, g, a, b, gsum, gxsum, part, planes, hw, splits, s));
    case 3: return static_cast<int>(bwd_reduce<bf16, true>(x, g, a, b, gsum, gxsum, part, planes, hw, splits, s));
    default: return kInvalid;
  }
}

// x, g, dx: (planes, hw); a, b, ca, cb, cc: (planes,) fp32. splits is the
// count the caller chose for each plane; the call is refused unless it is
// the kernel's own, dx_splits(planes, hw, 16 / element size).
int vcd_gn_bwd_dx(const void* x, const void* g, const void* a, const void* b, const void* ca,
                  const void* cb, const void* cc, void* dx, int planes, int hw, int dtype,
                  int silu, int splits, void* stream) {
  if (bad_shape(planes, hw) || (dtype != 0 && dtype != 1)) return kInvalid;
  if (splits != dx_splits(planes, hw, dtype == 0 ? Vec<float>::N : Vec<bf16>::N))
    return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (silu ? 1 : 0)) {
    case 0: return static_cast<int>(bwd_dx<float, false>(x, g, a, b, ca, cb, cc, dx, planes, hw, splits, s));
    case 1: return static_cast<int>(bwd_dx<float, true>(x, g, a, b, ca, cb, cc, dx, planes, hw, splits, s));
    case 2: return static_cast<int>(bwd_dx<bf16, false>(x, g, a, b, ca, cb, cc, dx, planes, hw, splits, s));
    case 3: return static_cast<int>(bwd_dx<bf16, true>(x, g, a, b, ca, cb, cc, dx, planes, hw, splits, s));
    default: return kInvalid;
  }
}

const char* vcd_gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
