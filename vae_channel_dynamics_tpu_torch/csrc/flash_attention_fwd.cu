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
// TPU kernel run in fp32 at Precision.HIGHEST: fp32 q/k/v in, fp32 out, and
// P kept in fp32 before the P V product. TF32 keeps 10 mantissa bits, too
// few for that, so its products are plain fp32 FMAs on the SIMT units; at
// 4*B*N^2*C FLOPs against the card's 67 TFLOP/s fp32 rate it is bound by
// those operations. A block of 8 warps owns 32 query rows; each warp owns 4
// of them end to end (logits, online softmax, output accumulator), so the
// warps share only the K and V tiles (32 keys) and synchronise only around
// their loads. Q K^T: each lane sums a 4-row x 8-key piece over its own
// float4 columns, and a reduce-scatter over the warp's 32 lanes (31
// shuffles for 32 sums) leaves lane l with logit (row l/8, key l%8); the 8
// lanes of a row then hold its 32 logits for the softmax. P V: the lane
// owns the output columns 4*lane + 128*j of its warp's 4 rows, reading P
// rows broadcast from shared memory. Shared memory at C = 512: 65,536 (Q)
// + 2 x 65,536 (K, V) + 4,096 (P) = 200,704 bytes.
//
// Plain C interface for ctypes: pointers and the stream are void*, the
// function returns cudaGetLastError() after the launch. It launches on the
// caller's stream, allocates nothing and does not synchronise.

#include "sm90_mma.cuh"

namespace {

using namespace vcd;

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
// fp32 forward
// ---------------------------------------------------------------------------
constexpr int F32_ROWS = 4;                 // query rows per warp
constexpr int F32_BQ = WARPS * F32_ROWS;    // 32 query rows per block
constexpr int F32_BK = 32;                  // keys per tile

template <int C>
struct F32Layout {
  static constexpr int Q_BYTES = F32_BQ * C * 4;
  static constexpr int KV_BYTES = F32_BK * C * 4;
  static constexpr int P_BYTES = F32_BQ * F32_BK * 4;
  static constexpr int BYTES = Q_BYTES + 2 * KV_BYTES + P_BYTES;
};

// Copy ROWS rows of C fp32 (row stride C on both sides), 16 bytes per
// cp.async, spread over the block.
template <int C, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int tid) {
  constexpr int CHUNKS = C / 4;
  static_assert((ROWS * CHUNKS) % THREADS == 0, "tile does not split evenly over the block");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int i = it * THREADS + tid;
    cp_async16(dst + i * 4, src + static_cast<size_t>(i) * 4);
  }
}

// Sum each of the 32 values over the warp's 32 lanes; lane l returns the sum
// of v[l]. Each step trades half of the values with the partner lane.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
#pragma unroll
  for (int h = 16; h >= 1; h /= 2) {
    const bool upper = (lane & h) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  return v[0];
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int n,
                         float scale) {
  using L = F32Layout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + L::Q_BYTES);
  float* sV = reinterpret_cast<float*>(smem + L::Q_BYTES + L::KV_BYTES);
  float* sP = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES);

  constexpr int J = C / 128;  // float4 columns per lane: 4*lane + 128*j
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * F32_BQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * C;
  const float* qw = sQ + warp * F32_ROWS * C;  // this warp's 4 query rows
  float* pw = sP + warp * F32_ROWS * F32_BK;   // and their probabilities

  load_rows_f32<C, F32_BQ>(sQ, q + base + static_cast<size_t>(q0) * C, tid);
  cp_async_commit();

  float acc[F32_ROWS][J][4];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
  // the running max and denominator of row lane/8, kept by its 8 lanes
  float m_run = MASKED, l_run = 0.f;

  const int nk = n / F32_BK;
  for (int t = 0; t < nk; ++t) {
    __syncthreads();  // the previous tile's products are done with sK, sV
    load_rows_f32<C, F32_BK>(sK, k + base + static_cast<size_t>(t) * F32_BK * C, tid);
    load_rows_f32<C, F32_BK>(sV, v + base + static_cast<size_t>(t) * F32_BK * C, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ---- S = Q K_t^T * scale: s[g] = S[row lane/8][key 8g + lane%8] ----
    float s[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float part[F32_ROWS * 8];  // [row][key], this lane's columns only
#pragma unroll
      for (int i = 0; i < F32_ROWS * 8; ++i) part[i] = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 4 * lane + 128 * j;
        float4 qv[F32_ROWS];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) qv[r] = *reinterpret_cast<const float4*>(qw + r * C + c);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + (8 * g + kk) * C + c);
#pragma unroll
          for (int r = 0; r < F32_ROWS; ++r) {
            float p = part[r * 8 + kk];
            p = fmaf(qv[r].x, kv.x, p);
            p = fmaf(qv[r].y, kv.y, p);
            p = fmaf(qv[r].z, kv.z, p);
            p = fmaf(qv[r].w, kv.w, p);
            part[r * 8 + kk] = p;
          }
        }
      }
      s[g] = reduce_scatter32(part, lane) * scale;
    }

    // ---- online softmax: row lane/8's 32 logits sit on its 8 lanes ----
    float mx = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float p = expf(s[g] - m_new);
      sum += p;
      pw[(lane / 8) * F32_BK + 8 * g + lane % 8] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
    __syncwarp();  // this warp's P rows are written

    // ---- acc = acc * corr + P V_t over this lane's columns ----
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      const float cr = __shfl_sync(0xffffffffu, corr, 8 * r);
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] *= cr;
    }
#pragma unroll 4
    for (int kk = 0; kk < F32_BK; ++kk) {
      float4 vv[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        vv[j] = *reinterpret_cast<const float4*>(sV + kk * C + 4 * lane + 128 * j);
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        const float p = pw[r * F32_BK + kk];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          acc[r][j][0] = fmaf(p, vv[j].x, acc[r][j][0]);
          acc[r][j][1] = fmaf(p, vv[j].y, acc[r][j][1]);
          acc[r][j][2] = fmaf(p, vv[j].z, acc[r][j][2]);
          acc[r][j][3] = fmaf(p, vv[j].w, acc[r][j][3]);
        }
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

  // ---- O = acc / l, fp32 ----
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    const float l = __shfl_sync(0xffffffffu, l_run, 8 * r);
    float* orow = o + base + static_cast<size_t>(q0 + warp * F32_ROWS + r) * C;
#pragma unroll
    for (int j = 0; j < J; ++j)
      *reinterpret_cast<float4*>(orow + 4 * lane + 128 * j) =
          make_float4(acc[r][j][0] / l, acc[r][j][1] / l, acc[r][j][2] / l, acc[r][j][3] / l);
  }
}

template <int C>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int n,
                       float scale, cudaStream_t stream) {
  const int bytes = F32Layout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<C><<<dim3(n / F32_BQ, b), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), n, scale);
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
