// Flash-attention forward for the VAE mid block, hand-written for Hopper (sm_90a).
//
// Replaces vae_channel_dynamics_tpu/ops/pallas_attention.py::_flash_kernel
// (the forward without the log-sum-exp output). Same function:
//   S = Q K^T * scale, accumulated in fp32;
//   online softmax with fp32 running max m and denominator l;
//   P = exp(S - m) cast to bf16 before the P V product (fp32 accumulation);
//   O = acc / l, written in bf16.
//
// What bounds it on the H100: at C = 512 the kernel does 4*B*N^2*C FLOPs
// against about 8*B*N*C bytes of q/k/v/o traffic, i.e. N/2 FLOPs per byte
// (2048 at N = 4096), far above the card's ~295 FLOPs/byte ridge: it is
// tensor-core bound. The design keeps the quadratic logits tile and the
// fp32 accumulators on chip (registers and shared memory) so device memory
// sees only the linear q/k/v/o traffic, and feeds the tensor cores with
// bf16 mma.sync (m16n8k16) from ldmatrix loads. wgmma/TMA and warp
// specialisation are left for a later, faster version.
//
// Layout of one thread block (256 threads, 8 warps), which owns BQ = 32
// query rows of one batch element and loops over key tiles of BK = 64:
//   * the head is 512 wide, so a 32x512 fp32 output accumulator is split
//     over the 8 warps by columns: each warp holds 32 rows x C/8 columns in
//     registers (64 fp32 per thread at C = 512);
//   * Q (32xC), K and V (64xC each) tiles sit in shared memory in bf16,
//     rows padded by 16 bytes so the 8 row addresses of an ldmatrix fall in
//     distinct banks; K and V have their own buffers, loaded with cp.async so
//     the next tile's copy overlaps the current tile's math;
//   * S (32x64 fp32) and P (32x64 bf16) pass through shared memory between
//     the QK^T warps (each computes a 16x16 piece), the softmax threads (8 per
//     row, which also keep that row's m and l in registers) and the PV warps.
// Shared memory at C = 512: 33,280 (Q) + 2 x 66,560 (K, V) + 8,704 (S)
// + 4,608 (P) + 256 (row stats) = 179,968 bytes, above 48 KB, so the
// launcher raises the kernel's dynamic shared-memory limit first.
//
// Plain C interface for ctypes: pointers and the stream are void*, the
// function returns cudaGetLastError() after the launch. It launches on the
// caller's stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 32;               // query rows per block
constexpr int BK = 64;               // keys per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;               // bf16 elements (16 bytes) of row padding
constexpr float MASKED = -1e30f;     // finite stand-in for -inf, as in the TPU kernel

template <int C>
struct Layout {
  static constexpr int LD = C + PAD;      // bf16 row stride of the Q/K/V tiles
  static constexpr int S_LD = BK + 4;     // fp32 row stride of the logits tile
  static constexpr int P_LD = BK + PAD;   // bf16 row stride of the probability tile
  static constexpr int Q_BYTES = BQ * LD * 2;
  static constexpr int KV_BYTES = BK * LD * 2;
  static constexpr int S_BYTES = BQ * S_LD * 4;
  static constexpr int P_BYTES = BQ * P_LD * 2;
  static constexpr int STAT_BYTES = 2 * BQ * 4;   // per-row correction and final l
  static constexpr int BYTES = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES + STAT_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy ROWS rows of C bf16 from device memory (row stride C) into a padded
// shared-memory tile, 16 bytes per cp.async.
template <int C, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int tid) {
  constexpr int CHUNKS = C / 8;
  static_assert((ROWS * CHUNKS) % THREADS == 0, "tile does not split evenly over the block");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int r = i / CHUNKS, ch = i % CHUNKS;
    cp_async16(dst + r * Layout<C>::LD + ch * 8, src + static_cast<size_t>(r) * C + ch * 8);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int n, float scale) {
  using L = Layout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::Q_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::Q_BYTES + L::KV_BYTES);
  float* sS = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES);
  float* sCorr =
      reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES + L::P_BYTES);
  float* sL = sCorr + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment row group / column pair
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * C;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  // cp.async groups, in order: [Q, K_0], [V_0], then per tile [K_j+1], [V_j+1].
  load_tile<C, BQ>(sQ, q + base + static_cast<size_t>(q0) * C, tid);
  load_tile<C, BK>(sK, kb, tid);
  cp_async_commit();
  load_tile<C, BK>(sV, vb, tid);
  cp_async_commit();

  // QK^T: warp -> one 16-row x 16-key piece of the 32x64 logits tile.
  const int s_m0 = (warp / 4) * 16, s_n0 = (warp % 4) * 16;
  // softmax: 8 threads per query row, 8 consecutive logits each.
  const int srow = tid / 8, scol = (tid % 8) * 8;
  float m_run = MASKED, l_run = 0.f;
  // PV: warp -> C/8 output columns for all 32 rows.
  constexpr int WC = C / WARPS;
  constexpr int NT = WC / 8;
  static_assert(NT % 2 == 0, "each ldmatrix.x4.trans feeds two 8-column n-tiles");
  const int o_c0 = warp * WC;
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = n / BK;
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<1>();  // K_j has landed (V_j may still be in flight)
    __syncthreads();

    // ---- S = Q K_j^T * scale (fp32) -> shared memory ----
    {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int m = lane >> 3;
#pragma unroll 8
      for (int kk = 0; kk < C; kk += 16) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, sQ + (s_m0 + (lane & 15)) * L::LD + kk + (lane >> 4) * 8);
        ldmatrix_x4(b, sK + (s_n0 + (lane & 7) + (m >> 1) * 8) * L::LD + kk + (m & 1) * 8);
        mma_bf16(s[0], a, b[0], b[1]);
        mma_bf16(s[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float* r0 = sS + (s_m0 + gid) * L::S_LD + s_n0 + t * 8 + 2 * tig;
        float* r1 = r0 + 8 * L::S_LD;
        r0[0] = s[t][0] * scale;
        r0[1] = s[t][1] * scale;
        r1[0] = s[t][2] * scale;
        r1[1] = s[t][3] * scale;
      }
    }
    __syncthreads();

    // The K buffer is free: start the next key tile behind softmax and PV.
    // The group is committed even when empty so the wait counts stay uniform.
    if (j + 1 < nk) load_tile<C, BK>(sK, kb + static_cast<size_t>(j + 1) * BK * C, tid);
    cp_async_commit();

    // ---- online softmax over this tile's 64 logits per row ----
    {
      const float* sr = sS + srow * L::S_LD + scol;
      float x[8];
      float mx = MASKED;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = sr[i];
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      bf16* pr = sP + srow * L::P_LD + scol;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = expf(x[i] - m_new);
        sum += p;
        pr[i] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if ((tid & 7) == 0) sCorr[srow] = corr;
    }
    cp_async_wait<1>();  // V_j has landed (only the K_j+1 prefetch may be in flight)
    __syncthreads();

    // ---- acc = acc * corr + P V_j ----
    {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float c0 = sCorr[mt * 16 + gid], c1 = sCorr[mt * 16 + gid + 8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[mt][nt][0] *= c0;
          acc[mt][nt][1] *= c0;
          acc[mt][nt][2] *= c1;
          acc[mt][nt][3] *= c1;
        }
      }
      const int m = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], sP + (mt * 16 + (lane & 15)) * L::P_LD + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, sV + (kk + (lane & 7) + (m & 1) * 8) * L::LD + o_c0 + nt * 8 + (m >> 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();

    // The V buffer is free: start the next value tile.
    if (j + 1 < nk) load_tile<C, BK>(sV, vb + static_cast<size_t>(j + 1) * BK * C, tid);
    cp_async_commit();
  }

  if ((tid & 7) == 0) sL[srow] = l_run;
  __syncthreads();

  // ---- O = acc / l, bf16 ----
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
    const float l0 = sL[r0], l1 = sL[r1];
    bf16* o0 = o + base + static_cast<size_t>(q0 + r0) * C + o_c0;
    bf16* o1 = o + base + static_cast<size_t>(q0 + r1) * C + o_c0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[mt][nt][0] / l0, acc[mt][nt][1] / l0);
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(acc[mt][nt][2] / l1, acc[mt][nt][3] / l1);
    }
  }
}

template <int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int n,
                   float scale, cudaStream_t stream) {
  const int bytes = Layout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BQ, b);
  flash_fwd_kernel<C><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), n, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (b, n, c) bf16 on the current device. n must be a
// multiple of 64 (the key tile) and c one of 128, 256, 384, 512.
int vcd_flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                 int n, int c, float scale, void* stream) {
  if (b < 1 || b > 65535 || n < BK || n % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch<128>(q, k, v, o, b, n, scale, s));
    case 256: return static_cast<int>(launch<256>(q, k, v, o, b, n, scale, s));
    case 384: return static_cast<int>(launch<384>(q, k, v, o, b, n, scale, s));
    case 512: return static_cast<int>(launch<512>(q, k, v, o, b, n, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* vcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
