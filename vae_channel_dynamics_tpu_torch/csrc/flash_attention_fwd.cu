// Flash-attention forward for the VAE mid block, hand-written for Hopper (sm_90a).
//
// Replaces vae_channel_dynamics_tpu/ops/pallas_attention.py::_flash_kernel,
// both its serving variant and its training variant (with_lse=True). Same
// function:
//   S = Q K^T * scale, accumulated in fp32;
//   online softmax with fp32 running max m and denominator l;
//   P = exp(S - m) cast to bf16 before the P V product (fp32 accumulation);
//   O = acc / l, written in bf16;
//   training only: lse = m + log(l) per query row, fp32 (B, N), which the
//   backward kernels (flash_attention_bwd.cu) rebuild P from.
// The LSE output is a null-or-not pointer, not a template flag: the row's
// final m and l already sit in the softmax threads' registers, so it costs
// one uniform branch and one store per row at the end, and the serving
// entry point (lse = nullptr) keeps the same instantiations and code.
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
//     row, which also keep that row's m and l in registers) and the PV warps;
//     with an LSE output, one of those 8 threads writes the row's m + log(l).
// Shared memory at C = 512: 33,280 (Q) + 2 x 66,560 (K, V) + 8,704 (S)
// + 4,608 (P) + 256 (row stats) = 179,968 bytes, above 48 KB, so the
// launcher raises the kernel's dynamic shared-memory limit first. ptxas
// (-Xptxas -v, sm_90a, CUDA 12.8): 202 registers at C = 512 (170,
// 122, 82 at 384, 256, 128), no spills.
//
// The fp32 serving forward (flash_fwd_f32_kernel, no LSE) replaces the same
// TPU kernel run in fp32 at Precision.HIGHEST: fp32 q/k/v in, fp32 out, P kept
// in fp32 before the P V product. TF32 keeps 10 mantissa bits, too few alone,
// so every product is three TF32 products (3xTF32): each fp32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest by
// cvt.rna, and x y is taken as hi hi + hi lo + lo hi on wgmma with fp32
// accumulation, an error of about 2^-22 of each product against the 2^-24
// that fp32 accumulation already costs. What bounds it on the H100: 3 x
// 4*B*N^2*C FLOPs at the 495 TFLOP/s TF32 rate (1.666 ms at (8, 4096,
// 512)); fp32 FMAs outside the tensor cores could not go below 4.10 ms at
// 67 TFLOP/s.
//
// A block owns 64 query rows of one batch element. Two warpgroups each own
// half of the channels, H = C/2, of both S's sum and O (H/2 fp32
// accumulators a thread); thread 0 also keeps a ring of 6 stages of 16 KB
// full by TMA, refilling a stage once every warp has read it (a producer
// warp of its own would make 9 warps, 3 on one of the SM's four register
// files, and cap every thread at 168 registers: O spilled). Per key tile of
// 64:
//   1. S units: 16 channels of Q and of K for each half (64 rows each,
//      64-byte swizzled). Each warpgroup splits its half's raw tiles into
//      hi and lo tiles at the same swizzled offsets in its own split buffer
//      (two, alternating), releases the raw stage, and runs the three
//      products on wgmma m64n64k8 into its partial S;
//   2. the two partial S are added through shared memory, the same sum in
//      both warpgroups, so that both hold S, m, l and P bit for bit; the
//      online softmax in fp32; warpgroup 0 writes P's hi and warpgroup 1 its
//      lo as the K-major A of P V (128-byte swizzled);
//   3. V units: 16 keys x OC channels of raw V (not swizzled). wgmma's tf32
//      B must be K-major, and P V sums over keys, so each warpgroup writes
//      its channels' V^T (OC rows of 16 keys, 64-byte swizzled), split into
//      hi and lo, and runs m64nOCk8 three times for each of the 2 k-steps.
// The tensor cores truncate each fp32 accumulation (round toward zero), so
// a sum held in a wgmma accumulator drifts low by about half an ulp a step:
// over the 1,536 steps of O at N = 4096 it broke the 1e-5 bound on the H100
// (tests/test_torch_flash_tf32x3.py models it).
// So no wgmma accumulation is long: a tile's P V goes into fresh
// accumulators (OC = 128 channels a pass at C = 512, 24 steps), added to O
// in fp32 registers, and each warpgroup's S is two sums of H/2 channels
// (48 steps each), added in fp32.
// hi and lo live only in shared memory: device memory and L2 see raw fp32
// q, k, v once per use (K and V once per 64-query block, Q once per key
// tile), and no scratch or pre-pass is needed. Shared memory: 96 KB (ring)
// + 64 KB (split buffers) + 32 KB (P) = 197,728 bytes with the barriers and
// the alignment.
//
// Plain C interface for ctypes: pointers and the stream are void*, the
// function returns cudaGetLastError() after the launch. It launches on the
// caller's stream, allocates nothing and does not synchronise.

#include "sm90_mma.cuh"
#include "sm90_wgmma.cuh"

namespace {

using namespace vcd;
using namespace vcd::sm90;

constexpr int BQ = 32;               // query rows per block
constexpr int BK = 64;               // keys per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
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

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n, float scale) {
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
  load_tile<C, BQ, THREADS>(sQ, q + base + static_cast<size_t>(q0) * C, tid);
  load_tile<C, BK, THREADS>(sK, kb, tid);
  cp_async_commit();
  load_tile<C, BK, THREADS>(sV, vb, tid);
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
    if (j + 1 < nk) load_tile<C, BK, THREADS>(sK, kb + static_cast<size_t>(j + 1) * BK * C, tid);
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
    if (j + 1 < nk) load_tile<C, BK, THREADS>(sV, vb + static_cast<size_t>(j + 1) * BK * C, tid);
    cp_async_commit();
  }

  if ((tid & 7) == 0) {
    sL[srow] = l_run;
    if (lse != nullptr) lse[static_cast<size_t>(blockIdx.y) * n + q0 + srow] = m_run + logf(l_run);
  }
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int n, float scale, cudaStream_t stream) {
  const int bytes = Layout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BQ, b);
  flash_fwd_kernel<C><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, n, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 forward: 3xTF32 on wgmma (see the header)
// ---------------------------------------------------------------------------
constexpr int F32_BQ = 64;        // query rows per block: wgmma's M
constexpr int F32_BK = 64;        // keys per tile: S's N
constexpr int F32_KC = 16;        // channels per S unit: one 64-byte swizzle row of fp32
constexpr int F32_VK = 16;        // keys per V unit: two tf32 k-steps, a 64-byte row
constexpr int F32_STAGES = 6;
constexpr int F32_THREADS = 256;  // two warpgroups, half the channels each
constexpr int F32_UNIT = 16384;   // bytes of a ring stage and of a split buffer
constexpr int F32_TILE = F32_BQ * F32_KC * 4;          // one 64 x 16 fp32 tile: 4 KB
constexpr int F32_P = F32_BQ * F32_BK * 4;             // P's hi (or lo): 16 KB
constexpr int F32_RING = F32_STAGES * F32_UNIT;
constexpr int F32_SPLIT = F32_RING;                    // 2 warpgroups x 2 buffers
constexpr int F32_PTILE = F32_SPLIT + 4 * F32_UNIT;    // P hi, then P lo
constexpr int F32_BARS = F32_PTILE + 2 * F32_P;
constexpr int F32_SMEM = F32_BARS + 2 * F32_STAGES * 8 + 1024;

template <int C>
struct F32Units {
  static constexpr int H = C / 2;                        // channels of one warpgroup
  static constexpr int NS = H / F32_KC;                  // S units per key tile
  // O's channels per pass: a tile's P V goes into fresh accumulators of OC
  // channels, then into O by an fp32 add (see the header)
  static constexpr int OC = H <= 128 ? H : (H % 128 == 0 ? 128 : 64);
  static constexpr int NP = H / OC;                      // passes
  static constexpr int NV = F32_BK / F32_VK;             // V units per pass
  static constexpr int UNITS = NS + NP * NV;
  static constexpr int S_BYTES = 4 * F32_TILE;           // Q and K, both halves
  static constexpr int V_HALF = F32_VK * OC * 4;         // 16 keys x OC channels
  static_assert(NS % 2 == 0, "S is summed in two parts");
  static_assert(2 * V_HALF <= F32_UNIT, "a V unit fits a stage and a split buffer");
};

__device__ __forceinline__ float4 tf32_hi(float4 x) {
  return make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
}

__device__ __forceinline__ float4 tf32_lo(float4 x, float4 hi) {
  return make_float4(to_tf32(x.x - hi.x), to_tf32(x.y - hi.y), to_tf32(x.z - hi.z),
                     to_tf32(x.w - hi.w));
}

// O (B, N, C) fp32 = softmax(Q K^T * scale) V over fp32 q, k, v (B, N, C).
// Grid (N / 64, B); two warpgroups, thread 0 also the producer.
template <int C>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int n,
                         float scale) {
  using U = F32Units<C>;
  constexpr int H = U::H, OC = U::OC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F32_BARS);
  uint64_t* empty = full + F32_STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * F32_BQ, b = blockIdx.y;
  const int units = (n / F32_BK) * U::UNITS;

  // Unit k of the stream, into its stage: per key tile, NS units of Q and K
  // (16 channels of each half, 64 rows each, 64-byte swizzled), then for
  // each pass NV units of V (8 keys x OC channels of each half, not
  // swizzled).
  auto issue = [&](int k) {
    const int t = k / U::UNITS, u = k % U::UNITS, s = k % F32_STAGES;
    uint8_t* st = ring + s * F32_UNIT;
    if (u < U::NS) {
      mbar_arrive_expect_tx(&full[s], U::S_BYTES);
      for (int g = 0; g < 2; ++g) {
        tma_load_3d(st + g * F32_TILE, &qmap, &full[s], g * H + u * F32_KC, q0, b);
        tma_load_3d(st + (2 + g) * F32_TILE, &kmap, &full[s], g * H + u * F32_KC, t * F32_BK,
                    b);
      }
    } else {
      const int p = (u - U::NS) / U::NV, key = t * F32_BK + ((u - U::NS) % U::NV) * F32_VK;
      mbar_arrive_expect_tx(&full[s], 2 * U::V_HALF);
      for (int g = 0; g < 2; ++g)
        tma_load_3d(st + g * U::V_HALF, &vmap, &full[s], g * H + p * OC, key, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F32_THREADS / 32);  // one arrival per warp
    }
    mbar_init_fence();
    for (int k = 0; k < units && k < F32_STAGES; ++k) issue(k);
  }
  __syncthreads();

  // Warpgroup g owns channels [g H, (g + 1) H) of S's sum and of O.
  const int g = warp / 4, wt = tid % 128, gid = lane / 4, tig = lane % 4;
  const int row0 = (warp % 4) * 16 + gid;  // this thread's rows: row0, row0 + 8
  uint8_t* mine = smem + F32_SPLIT + g * 2 * F32_UNIT;       // my two split buffers
  uint8_t* theirs = smem + F32_SPLIT + (1 - g) * 2 * F32_UNIT;
  uint8_t* ptile = smem + F32_PTILE;
  float oacc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) oacc[i] = 0.f;
  float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f};  // l: this thread's columns

  // Unit k has been read from the ring: release its stage, and thread 0
  // refills it with unit k + STAGES once every warp has released it. Then
  // the split tiles this warpgroup wrote are made visible to its wgmma.
  int k = 0;  // units consumed
  auto release = [&]() {
    const int s = k % F32_STAGES;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && k + F32_STAGES < units) {
      mbar_wait(&empty[s], (k / F32_STAGES) & 1);
      issue(k + F32_STAGES);
    }
    __syncwarp();
    fence_proxy_async();
    named_barrier(1 + g, 128);
  };

  // One S unit into acc: split this half's raw Q and K tiles into hi and lo
  // tiles at the same swizzled offsets, then hi hi + hi lo + lo hi.
  auto s_unit = [&](float (&acc)[32]) {
    const int s = k % F32_STAGES;
    mbar_wait(&full[s], (k / F32_STAGES) & 1);
    const uint8_t* st = ring + s * F32_UNIT;
    uint8_t* sp = mine + (k & 1) * F32_UNIT;  // [Q hi][Q lo][K hi][K lo]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = wt + 128 * i, which = idx / 256, off = (idx % 256) * 16;
      const float4 x = *reinterpret_cast<const float4*>(st + (2 * which + g) * F32_TILE + off);
      const float4 hi = tf32_hi(x);
      *reinterpret_cast<float4*>(sp + 2 * which * F32_TILE + off) = hi;
      *reinterpret_cast<float4*>(sp + (2 * which + 1) * F32_TILE + off) = tf32_lo(x, hi);
    }
    release();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F32_KC / 8; ++kk) {
      const uint64_t qh = make_desc(sp, 64) + 2 * kk, ql = make_desc(sp + F32_TILE, 64) + 2 * kk;
      const uint64_t kh = make_desc(sp + 2 * F32_TILE, 64) + 2 * kk;
      const uint64_t kl = make_desc(sp + 3 * F32_TILE, 64) + 2 * kk;
      wgmma_tf32<64>(acc, ql, kh);
      wgmma_tf32<64>(acc, qh, kl);
      wgmma_tf32<64>(acc, qh, kh);
    }
    wgmma_commit();
    // unit k - 1's products are done: its split buffer may be written again
    wgmma_wait<1>();
    ++k;
  };

  for (int t = 0; t < n / F32_BK; ++t) {
    // ---- S_g = Q[:, half g] K[:, half g]^T, 3xTF32, in two parts ----
    float sacc[32], sacc2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = sacc2[i] = 0.f;
    for (int u = 0; u < U::NS / 2; ++u) s_unit(sacc);
    for (int u = 0; u < U::NS / 2; ++u) s_unit(sacc2);
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(sacc2);
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] += sacc2[i];

    // ---- S = S_0 + S_1, through shared memory; both warpgroups then hold
    // the same S, m, l and P, bit for bit ----
    float* xmine = reinterpret_cast<float*>(mine);
    const float* xtheirs = reinterpret_cast<const float*>(theirs);
#pragma unroll
    for (int i = 0; i < 32; ++i) xmine[i * 128 + wt] = sacc[i];
    named_barrier(3, F32_THREADS);
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = (sacc[i] + xtheirs[i * 128 + wt]) * scale;

    // ---- online softmax over the tile's 64 logits of rows row0, row0 + 8 ----
    float mx[2] = {MASKED, MASKED};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = expf(sacc[i] - m_run[(i >> 1) & 1]);
      l_run[(i >> 1) & 1] += sacc[i];
    }
#pragma unroll
    for (int i = 0; i < H / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
    // P's hi (warpgroup 0) or lo (warpgroup 1) as the K-major A of P V:
    // two 128-byte swizzled blocks of 32 keys, 16-byte chunk c of row r at
    // c ^ (r % 8)
    uint8_t* pdst = ptile + g * F32_P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half, key = 8 * j + 2 * tig;
        const float p0 = sacc[4 * j + 2 * half], p1 = sacc[4 * j + 2 * half + 1];
        const float h0 = to_tf32(p0), h1 = to_tf32(p1);
        const float2 val = g == 0 ? make_float2(h0, h1)
                                  : make_float2(to_tf32(p0 - h0), to_tf32(p1 - h1));
        *reinterpret_cast<float2*>(pdst + (key >> 5) * (F32_BQ * 128) + row * 128 +
                                   ((((key & 31) >> 2) ^ (row & 7)) << 4) + (key & 3) * 4) = val;
      }
    }
    fence_proxy_async();
    named_barrier(3, F32_THREADS);  // P is written, and S_1-g is read

    // ---- O_g += P V[:, half g], 3xTF32: per pass, OC channels into fresh
    // accumulators over the tile's 64 keys, 16 a unit, then an fp32 add ----
#pragma unroll
    for (int p = 0; p < U::NP; ++p) {
      float tacc[OC / 2];
#pragma unroll
      for (int i = 0; i < OC / 2; ++i) tacc[i] = 0.f;
      for (int v = 0; v < U::NV; ++v) {
        const int s = k % F32_STAGES;
        mbar_wait(&full[s], (k / F32_STAGES) & 1);
        const float* raw = reinterpret_cast<const float*>(ring + s * F32_UNIT + g * U::V_HALF);
        uint8_t* sp = mine + (k & 1) * F32_UNIT;  // V^T hi, then lo: OC rows x 16 keys
        // V^T as a K-major B, 64-byte swizzled: chunk c of row ch at c ^ ((ch / 2) % 4)
#pragma unroll
        for (int ch = wt; ch < OC; ch += 128) {
          const int sw = (ch >> 1) & 3;
          uint8_t* rowp = sp + ch * 64;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 x = make_float4(raw[(4 * c) * OC + ch], raw[(4 * c + 1) * OC + ch],
                                         raw[(4 * c + 2) * OC + ch], raw[(4 * c + 3) * OC + ch]);
            const float4 hi = tf32_hi(x);
            *reinterpret_cast<float4*>(rowp + ((c ^ sw) << 4)) = hi;
            *reinterpret_cast<float4*>(rowp + OC * 64 + ((c ^ sw) << 4)) = tf32_lo(x, hi);
          }
        }
        release();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < F32_VK / 8; ++kk) {
          const int step = v * (F32_VK / 8) + kk;  // the k-step of P's 64 keys
          const int pb = (step / 4) * (F32_BQ * 128);
          const uint64_t ph = make_desc(ptile + pb, 128) + 2 * (step % 4);
          const uint64_t pl = make_desc(ptile + F32_P + pb, 128) + 2 * (step % 4);
          const uint64_t vh = make_desc(sp, 64) + 2 * kk, vl = make_desc(sp + OC * 64, 64) + 2 * kk;
          wgmma_tf32<OC>(tacc, pl, vh);
          wgmma_tf32<OC>(tacc, ph, vl);
          wgmma_tf32<OC>(tacc, ph, vh);
        }
        wgmma_commit();
        wgmma_wait<1>();
        ++k;
      }
      wgmma_wait<0>();
      fence_regs(tacc);
#pragma unroll
      for (int i = 0; i < OC / 2; ++i) oacc[p * (OC / 2) + i] += tacc[i];
    }
  }

  // ---- O = acc / l, fp32: this warpgroup's H columns of rows row0, row0 + 8 ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* orow = o + (static_cast<size_t>(b) * n + q0 + row0 + 8 * half) * C + g * H;
#pragma unroll
    for (int j = 0; j < H / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * tig) =
          make_float2(oacc[4 * j + 2 * half] / l_run[half],
                      oacc[4 * j + 2 * half + 1] / l_run[half]);
  }
}

template <int C>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int n,
                       float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(n),
                            static_cast<uint64_t>(b)};
  const uint64_t strides[2] = {4ull * C, 4ull * C * n};
  const uint32_t qkbox[3] = {F32_KC, F32_BQ, 1};
  const uint32_t vbox[3] = {F32Units<C>::OC, F32_VK, 1};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  cudaError_t err = make_tensor_map(&qmap, q, 3, dims, strides, qkbox, 64, f32);
  if (err == cudaSuccess) err = make_tensor_map(&kmap, k, 3, dims, strides, qkbox, 64, f32);
  if (err == cudaSuccess) err = make_tensor_map(&vmap, v, 3, dims, strides, vbox, 0, f32);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F32_SMEM);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<C><<<dim3(n / F32_BQ, b), F32_THREADS, F32_SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<float*>(o), n, scale);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
             int n, int c, float scale, void* stream) {
  if (b < 1 || b > 65535 || n < BK || n % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch<128>(q, k, v, o, lse, b, n, scale, s));
    case 256: return static_cast<int>(launch<256>(q, k, v, o, lse, b, n, scale, s));
    case 384: return static_cast<int>(launch<384>(q, k, v, o, lse, b, n, scale, s));
    case 512: return static_cast<int>(launch<512>(q, k, v, o, lse, b, n, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous (b, n, c) bf16 on the current device. n must be a
// multiple of 64 (the key tile) and c one of 128, 256, 384, 512.
int vcd_flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                 int n, int c, float scale, void* stream) {
  return dispatch(q, k, v, o, nullptr, b, n, c, scale, stream);
}

// The training variant: also writes lse, contiguous (b, n) fp32.
int vcd_flash_attention_fwd_lse_bf16(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int b, int n, int c, float scale, void* stream) {
  return dispatch(q, k, v, o, static_cast<float*>(lse), b, n, c, scale, stream);
}

// The fp32 serving forward: q, k, v, o contiguous (b, n, c) fp32; n a
// multiple of 64 and c one of 128, 256, 384, 512, as above.
int vcd_flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, int b,
                                int n, int c, float scale, void* stream) {
  if (b < 1 || b > 65535 || n < BK || n % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch_f32<128>(q, k, v, o, b, n, scale, s));
    case 256: return static_cast<int>(launch_f32<256>(q, k, v, o, b, n, scale, s));
    case 384: return static_cast<int>(launch_f32<384>(q, k, v, o, b, n, scale, s));
    case 512: return static_cast<int>(launch_f32<512>(q, k, v, o, b, n, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* vcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
