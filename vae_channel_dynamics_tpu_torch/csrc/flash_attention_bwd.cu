// Flash-attention backward for the VAE mid block, hand-written for Hopper (sm_90a).
//
// Replaces vae_channel_dynamics_tpu/ops/pallas_attention.py::_flash_bwd_dkv_kernel
// (dK, dV) and ::_flash_bwd_dq_kernel (dQ). Both rebuild each tile of the
// softmax from the forward's per-row log-sum-exp, with the JAX kernels' math
// (pallas_attention.py:262-331):
//   S  = Q K^T * scale                 fp32
//   P  = exp(S - lse)                  exact softmax, no running max
//   dP = dO V^T                        fp32
//   dS = P * (dP - delta) * scale      delta = rowsum(dO * O), computed outside
//   dV += P^T dO,  dK += dS^T Q,  dQ += dS K
// P and dS are cast to bf16 before the last three products; every
// accumulator is fp32 and dQ, dK, dV are written in bf16. Each output
// element is written once by one block, with no atomics, so the results are
// the same bits from run to run.
//
// What bounds it on the H100: dK/dV do 8*B*N^2*C FLOPs and dQ 6*B*N^2*C
// against a few B*N*C bytes of device-memory traffic, so both are
// tensor-core bound at the mid block's N = 4096 and 16384. The design keeps
// every N^2 tile (S, dP, P, dS) in shared memory and the fp32 accumulators
// in registers, and feeds the tensor cores with bf16 mma.sync (m16n8k16)
// from ldmatrix loads. wgmma/TMA and warp specialisation are later work.
//
// C = 512 is the difficulty: a (rows x 512) fp32 accumulator is 64 fp32 per
// thread for every 16 rows when split over 8 warps by columns. dK/dV carry
// two of them, so that kernel owns BKV = 16 key rows per block (dK and dV:
// 32 + 32 fp32 per thread), and dQ owns BQR = 16 query rows (32 fp32).
//
// dK/dV kernel: one block (256 threads) per 16 keys of one batch element; it
// loads its K and V rows once and loops over query tiles of 32, double-
// buffering Q and dO with cp.async so the next tile's copy overlaps the
// current tile's math. Per tile:
//   1. warps 0-3 compute S (32 x 16) and warps 4-7 dP, one 16x8 piece each,
//      contracting over C, into fp32 shared memory;
//   2. every thread turns 2 elements into P and dS and stores them
//      transposed (key-major) in bf16;
//   3. warp w adds P^T dO and dS^T Q into columns [w*C/8, (w+1)*C/8) of its
//      dV and dK registers.
// Shared memory at C = 512: 2 x 16,640 (K, V) + 4 x 33,280 (Q, dO, two
// buffers each) + 2 x 2,560 (S, dP) + 2 x 1,280 (P^T, dS^T) = 174,080 bytes.
//
// dQ kernel: one block per 16 queries; it loads its Q and dO rows once and
// loops over key tiles of 32, double-buffering K and V. Steps 1-2 as above
// on a 16 x 32 tile (dS stored query-major), then warp w adds dS K into its
// C/8 columns of dQ. Shared memory at C = 512: 2 x 16,640 (Q, dO)
// + 4 x 33,280 (K, V) + 2 x 2,304 (S, dP) + 1,280 (dS) = 172,288 bytes.
//
// Both are above 48 KB, so the launcher raises the kernels' dynamic shared-
// memory limit first. ptxas (-Xptxas -v, sm_90a, CUDA 12.8): dK/dV
// 195 registers at C = 512 (164, 122, 85 at 384, 256, 128), dQ 132 (109,
// 79, 80), no spills.
//
// Plain C interface for ctypes: pointers and the stream
// are void*, each function returns cudaGetLastError() after its launch. They
// launch on the caller's stream, allocate nothing and do not synchronise.

#include "sm90_mma.cuh"

namespace {

using namespace vcd;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BKV = 16;  // dK/dV kernel: keys per block
constexpr int TQ = 32;   // dK/dV kernel: queries per tile
constexpr int BQR = 16;  // dQ kernel: queries per block
constexpr int TK = 32;   // dQ kernel: keys per tile

// Step 1 of either kernel on an R x K logits tile (R query rows, K keys):
// warps 0-3 compute S = Q K^T * scale, warps 4-7 dP = dO V^T, each one 16x8
// piece, into fp32 tiles of row stride K + 4.
template <int C, int R, int K>
__device__ __forceinline__ void logits_pieces(const bf16* sQ, const bf16* sdO, const bf16* sK,
                                              const bf16* sV, float* sS, float* sdP,
                                              float scale, int warp, int lane) {
  static_assert(R * K == 4 * 16 * 8, "four 16x8 pieces per product");
  constexpr int LD = C + PAD, S_LD = K + 4;
  const bool is_dp = warp >= 4;  // warp-uniform
  const int piece = warp & 3;
  const int m0 = (piece / (K / 8)) * 16, n0 = (piece % (K / 8)) * 8;
  const bf16* a_src = (is_dp ? sdO : sQ) + (m0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* b_src = (is_dp ? sV : sK) + (n0 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int kk = 0; kk < C; kk += 16) {
    uint32_t a[4], b[2];
    ldmatrix_x4(a, a_src + kk);
    ldmatrix_x2(b, b_src + kk);
    mma_bf16(d, a, b[0], b[1]);
  }
  const int gid = lane >> 2, tig = lane & 3;
  const float mul = is_dp ? 1.f : scale;
  float* out = (is_dp ? sdP : sS) + (m0 + gid) * S_LD + n0 + 2 * tig;
  out[0] = d[0] * mul;
  out[1] = d[1] * mul;
  out[8 * S_LD] = d[2] * mul;
  out[8 * S_LD + 1] = d[3] * mul;
}

// acc[nt] (16 rows x 8 columns each) += a (16 x 32, row-major in shared
// memory, row stride A_LD) times the 32 rows x WC columns of b from column
// c0 (row stride C + PAD). WC = C / 8 columns per warp.
template <int C, int A_LD>
__device__ __forceinline__ void accumulate(float (&acc)[C / WARPS / 8][4], const bf16* a,
                                           const bf16* b, int c0, int lane) {
  constexpr int LD = C + PAD, NT = C / WARPS / 8;
  static_assert(NT % 2 == 0, "each ldmatrix.x4.trans feeds two 8-column n-tiles");
  const int m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 32; kk += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * A_LD + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk + (lane & 7) + (m & 1) * 8) * LD + c0 + nt * 8 + (m >> 1) * 8);
      mma_bf16(acc[nt], af, bf[0], bf[1]);
      mma_bf16(acc[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// Write a warp's 16 x WC accumulator as bf16 rows of dst (row stride C).
template <int C>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[C / WARPS / 8][4],
                                           int c0, int lane) {
  constexpr int NT = C / WARPS / 8;
  const int gid = lane >> 2, tig = lane & 3;
  bf16* r0 = dst + static_cast<size_t>(gid) * C + c0;
  bf16* r1 = r0 + 8 * static_cast<size_t>(C);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(r0 + col) = __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(r1 + col) = __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

template <int C>
struct DkvLayout {
  static constexpr int LD = C + PAD;
  static constexpr int S_LD = BKV + 4;      // fp32 S, dP: TQ rows x BKV keys
  static constexpr int T_LD = TQ + PAD;     // bf16 P^T, dS^T: BKV rows x TQ queries
  static constexpr int KV_BYTES = BKV * LD * 2;
  static constexpr int Q_BYTES = TQ * LD * 2;
  static constexpr int S_BYTES = TQ * S_LD * 4;
  static constexpr int T_BYTES = BKV * T_LD * 2;
  static constexpr int BYTES = 2 * KV_BYTES + 4 * Q_BYTES + 2 * S_BYTES + 2 * T_BYTES;
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, float scale) {
  using L = DkvLayout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::KV_BYTES);
  unsigned char* qbase = smem + 2 * L::KV_BYTES;  // [Q0, dO0, Q1, dO1]
  float* sS = reinterpret_cast<float*>(qbase + 4 * L::Q_BYTES);
  float* sdP = reinterpret_cast<float*>(qbase + 4 * L::Q_BYTES + L::S_BYTES);
  bf16* sPt = reinterpret_cast<bf16*>(qbase + 4 * L::Q_BYTES + 2 * L::S_BYTES);
  bf16* sdSt = reinterpret_cast<bf16*>(qbase + 4 * L::Q_BYTES + 2 * L::S_BYTES + L::T_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BKV;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * C;
  const float* lse_b = lse + static_cast<size_t>(blockIdx.y) * n;
  const float* delta_b = delta + static_cast<size_t>(blockIdx.y) * n;

  // cp.async groups: [K, V, Q_0, dO_0], then one [Q_j+1, dO_j+1] per tile.
  load_tile<C, BKV, THREADS>(sK, k + base + static_cast<size_t>(k0) * C, tid);
  load_tile<C, BKV, THREADS>(sV, v + base + static_cast<size_t>(k0) * C, tid);
  load_tile<C, TQ, THREADS>(reinterpret_cast<bf16*>(qbase), q + base, tid);
  load_tile<C, TQ, THREADS>(reinterpret_cast<bf16*>(qbase + L::Q_BYTES), dout + base, tid);
  cp_async_commit();

  constexpr int NT = C / WARPS / 8;
  const int c0 = warp * (C / WARPS);
  float acc_dk[NT][4], acc_dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[nt][e] = acc_dv[nt][e] = 0.f;

  const int nq = n / TQ;
  for (int j = 0; j < nq; ++j) {
    const bf16* sQ = reinterpret_cast<const bf16*>(qbase + (j & 1) * 2 * L::Q_BYTES);
    const bf16* sdO = reinterpret_cast<const bf16*>(qbase + (j & 1) * 2 * L::Q_BYTES + L::Q_BYTES);
    // The other buffer was last read in tile j-1's step 3, which every
    // thread finished before the barrier that ended that tile.
    if (j + 1 < nq) {
      unsigned char* nb = qbase + ((j + 1) & 1) * 2 * L::Q_BYTES;
      const size_t off = base + static_cast<size_t>(j + 1) * TQ * C;
      load_tile<C, TQ, THREADS>(reinterpret_cast<bf16*>(nb), q + off, tid);
      load_tile<C, TQ, THREADS>(reinterpret_cast<bf16*>(nb + L::Q_BYTES), dout + off, tid);
    }
    cp_async_commit();  // committed even when empty so the wait count stays uniform
    cp_async_wait<1>();  // tile j (and K, V) have landed
    __syncthreads();

    // 1. S and dP for these 32 queries x the block's 16 keys
    logits_pieces<C, TQ, BKV>(sQ, sdO, sK, sV, sS, sdP, scale, warp, lane);
    __syncthreads();

    // 2. P = exp(S - lse), dS = P (dP - delta) scale, stored key-major in bf16
    for (int e = tid; e < TQ * BKV; e += THREADS) {
      const int r = e / BKV, c = e % BKV;
      const int row = j * TQ + r;
      const float p = expf(sS[r * L::S_LD + c] - lse_b[row]);
      const float ds = p * (sdP[r * L::S_LD + c] - delta_b[row]) * scale;
      sPt[c * L::T_LD + r] = __float2bfloat16(p);
      sdSt[c * L::T_LD + r] = __float2bfloat16(ds);
    }
    __syncthreads();

    // 3. dV += P^T dO, dK += dS^T Q over this tile's 32 queries
    accumulate<C, L::T_LD>(acc_dv, sPt, sdO, c0, lane);
    accumulate<C, L::T_LD>(acc_dk, sdSt, sQ, c0, lane);
    __syncthreads();
  }

  store_rows<C>(dk + base + static_cast<size_t>(k0) * C, acc_dk, c0, lane);
  store_rows<C>(dv + base + static_cast<size_t>(k0) * C, acc_dv, c0, lane);
}

template <int C>
struct DqLayout {
  static constexpr int LD = C + PAD;
  static constexpr int S_LD = TK + 4;      // fp32 S, dP: BQR rows x TK keys
  static constexpr int D_LD = TK + PAD;    // bf16 dS: BQR rows x TK keys
  static constexpr int Q_BYTES = BQR * LD * 2;
  static constexpr int KV_BYTES = TK * LD * 2;
  static constexpr int S_BYTES = BQR * S_LD * 4;
  static constexpr int D_BYTES = BQR * D_LD * 2;
  static constexpr int BYTES = 2 * Q_BYTES + 4 * KV_BYTES + 2 * S_BYTES + D_BYTES;
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int n, float scale) {
  using L = DqLayout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::Q_BYTES);
  unsigned char* kbase = smem + 2 * L::Q_BYTES;  // [K0, V0, K1, V1]
  float* sS = reinterpret_cast<float*>(kbase + 4 * L::KV_BYTES);
  float* sdP = reinterpret_cast<float*>(kbase + 4 * L::KV_BYTES + L::S_BYTES);
  bf16* sdS = reinterpret_cast<bf16*>(kbase + 4 * L::KV_BYTES + 2 * L::S_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQR;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * C;
  const float* lse_b = lse + static_cast<size_t>(blockIdx.y) * n + q0;
  const float* delta_b = delta + static_cast<size_t>(blockIdx.y) * n + q0;

  // cp.async groups: [Q, dO, K_0, V_0], then one [K_j+1, V_j+1] per tile.
  load_tile<C, BQR, THREADS>(sQ, q + base + static_cast<size_t>(q0) * C, tid);
  load_tile<C, BQR, THREADS>(sdO, dout + base + static_cast<size_t>(q0) * C, tid);
  load_tile<C, TK, THREADS>(reinterpret_cast<bf16*>(kbase), k + base, tid);
  load_tile<C, TK, THREADS>(reinterpret_cast<bf16*>(kbase + L::KV_BYTES), v + base, tid);
  cp_async_commit();

  constexpr int NT = C / WARPS / 8;
  const int c0 = warp * (C / WARPS);
  float acc_dq[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[nt][e] = 0.f;

  const int nk = n / TK;
  for (int j = 0; j < nk; ++j) {
    const bf16* sK = reinterpret_cast<const bf16*>(kbase + (j & 1) * 2 * L::KV_BYTES);
    const bf16* sV = reinterpret_cast<const bf16*>(kbase + (j & 1) * 2 * L::KV_BYTES + L::KV_BYTES);
    if (j + 1 < nk) {
      unsigned char* nb = kbase + ((j + 1) & 1) * 2 * L::KV_BYTES;
      const size_t off = base + static_cast<size_t>(j + 1) * TK * C;
      load_tile<C, TK, THREADS>(reinterpret_cast<bf16*>(nb), k + off, tid);
      load_tile<C, TK, THREADS>(reinterpret_cast<bf16*>(nb + L::KV_BYTES), v + off, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // 1. S and dP for the block's 16 queries x these 32 keys
    logits_pieces<C, BQR, TK>(sQ, sdO, sK, sV, sS, sdP, scale, warp, lane);
    __syncthreads();

    // 2. dS = exp(S - lse) (dP - delta) scale, stored query-major in bf16
    for (int e = tid; e < BQR * TK; e += THREADS) {
      const int r = e / TK, c = e % TK;
      const float p = expf(sS[r * L::S_LD + c] - lse_b[r]);
      sdS[r * L::D_LD + c] = __float2bfloat16(p * (sdP[r * L::S_LD + c] - delta_b[r]) * scale);
    }
    __syncthreads();

    // 3. dQ += dS K over these 32 keys
    accumulate<C, L::D_LD>(acc_dq, sdS, sK, c0, lane);
    __syncthreads();
  }

  store_rows<C>(dq + base + static_cast<size_t>(q0) * C, acc_dq, c0, lane);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int C>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int b, int n,
                       float scale, cudaStream_t stream) {
  const int bytes = DkvLayout<C>::BYTES;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<C>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<C><<<dim3(n / BKV, b), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, scale);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int b, int n, float scale,
                      cudaStream_t stream) {
  const int bytes = DqLayout<C>::BYTES;
  cudaError_t err = prepare(flash_bwd_dq_kernel<C>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<C><<<dim3(n / BQR, b), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), n, scale);
  return cudaGetLastError();
}

bool shape_ok(int b, int n) { return b >= 1 && b <= 65535 && n >= 128 && n % 128 == 0; }

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: contiguous (b, n, c) bf16; lse, delta: contiguous
// (b, n) fp32; all on the current device. n must be a multiple of 128 and c
// one of 128, 256, 384, 512.
int vcd_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int b, int n, int c, float scale,
                                     void* stream) {
  if (!shape_ok(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, n, scale, s));
    case 256: return static_cast<int>(launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, b, n, scale, s));
    case 384: return static_cast<int>(launch_dkv<384>(q, k, v, dout, lse, delta, dk, dv, b, n, scale, s));
    case 512: return static_cast<int>(launch_dkv<512>(q, k, v, dout, lse, delta, dk, dv, b, n, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same operands; writes dq, contiguous (b, n, c) bf16.
int vcd_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int b, int n, int c, float scale, void* stream) {
  if (!shape_ok(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch_dq<128>(q, k, v, dout, lse, delta, dq, b, n, scale, s));
    case 256: return static_cast<int>(launch_dq<256>(q, k, v, dout, lse, delta, dq, b, n, scale, s));
    case 384: return static_cast<int>(launch_dq<384>(q, k, v, dout, lse, delta, dq, b, n, scale, s));
    case 512: return static_cast<int>(launch_dq<512>(q, k, v, dout, lse, delta, dq, b, n, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* vcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
