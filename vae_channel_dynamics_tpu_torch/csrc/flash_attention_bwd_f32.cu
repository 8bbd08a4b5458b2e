// Flash-attention backward at fp32 for the VAE mid block, hand-written for
// Hopper (sm_90a): dK/dV and dQ, plain fp32 FMAs on the CUDA cores, the
// channels split over a thread-block cluster.
//
// Replaces vae_channel_dynamics_tpu/ops/pallas_attention.py::_flash_bwd_dkv_kernel
// (:304, dK, dV) and ::_flash_bwd_dq_kernel (:284, dQ) as the JAX model runs
// them at fp32 (Precision.HIGHEST, mixed_precision "no"). Both rebuild each
// tile of the softmax from the forward's per-row log-sum-exp, with the JAX
// kernels' math (_bwd_tile, :262-281), all in fp32:
//   S  = Q K^T * scale
//   P  = exp(S - lse)                  exact softmax, no running max
//   dP = dO V^T
//   dS = P * (dP - delta) * scale      delta = rowsum(dO * O), computed outside
//   dV += P^T dO,  dK += dS^T Q,  dQ += dS K
// P and dS stay fp32; nothing is rounded below fp32.
//
// What bounds it on the H100: dK/dV do 8*B*N^2*C FLOPs and dQ 6*B*N^2*C
// against a few B*N*C fp32 bytes, so both are bound by arithmetic. On the
// CUDA cores that is 67 TFLOP/s: 16.41 and 12.31 ms at (1, 16384, 512).
// This kernel takes the fp32 products as plain FFMA, not as 3xTF32 on the
// tensor cores (the fp32 forward's route, bound 6.66 and 5.00 ms there):
//   * every product of the backward has an operand that tf32 wgmma would
//     need transposed in shared memory (its B is K-major only): P^T dO,
//     dS^T Q and dS K all sum over the streamed rows, which are the
//     operands' outer dimension;
//   * the tensor cores truncate each fp32 accumulation, which a 3xTF32
//     kernel must keep short and a test must model; FFMA rounds to nearest;
//   * with hi and lo copies of each operand the shared memory of a 64-row
//     block of 128 channels does not close.
// A 3xTF32 backward on wgmma is later work (ROADMAP); this one is simple and
// exact.
//
// The design keeps the bf16 backward's split (flash_attention_bwd.cu): the
// channels, not the rows. A cluster of R = C/128 CTAs (4 at C = 512; 1, 2,
// 3 at 128, 256, 384) shares one block of 64 rows (keys for dK/dV, queries
// for dQ), and CTA r owns channels [128r, 128r + 128): its slice of the two
// resident operands (K and V, or Q and dO) stays in shared memory, and its
// dK and dV (or dQ) of 64 rows x 128 channels are 32 fp32 registers a thread
// each over 256 threads. Per streamed tile of 32 rows (queries for dK/dV,
// keys for dQ):
//   1. cp.async brings the tile's slice of the two streamed operands (Q and
//      dO, or K and V; dK/dV also the tile's lse and delta) into one of two
//      stages, rows padded to 132 floats so that a warp's float4 columns
//      fall on distinct banks; the next tile's loads are in flight meanwhile;
//   2. warps 0-3 form this CTA's partial S (or S^T) over its 128 channels
//      and warps 4-7 its partial dP, 4 x 4 logits a thread, one FFMA chain
//      of 128 channels each, into one of two partial buffers;
//   3. the cluster synchronises, and every CTA reads all R partials of each
//      logit through distributed shared memory and adds them in rank order
//      0, 1, ..., R-1, so every CTA holds the same bits of S and dP, and
//      forms P and dS (transposed, rows of the streamed index) in its own
//      shared memory. The partial buffers alternate by tile, so one cluster
//      barrier a tile suffices: a CTA writes a buffer again only after every
//      CTA has passed the next tile's barrier, so after its reads;
//   4. each thread adds the tile's P^T dO and dS^T Q (or dS K) over 4 rows
//      x 8 of its CTA's channels into fresh accumulators, one FFMA chain of
//      32 rows, then adds those to its dK and dV (or dQ) sums: a sum of N
//      terms in two levels, whose rounding stays far under the plain
//      matmul's own.
// No atomics; each output element is written once, by one thread: two runs
// give the same bits. One kernel template serves both: DKV picks the roles
// of the operands, lse and delta by column (dK/dV) or by row (dQ), and the
// second output.
//
// Shared memory: 66 KB resident + 66 KB of stages + 40 KB of partials + 17
// KB of P^T and dS^T = 194,048 bytes, one CTA an SM.
//
// Plain C interface for ctypes: pointers and the stream are void*, each
// function returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for a shape it does not take). They launch on the caller's stream,
// allocate nothing and do not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int SLICE = 128;         // channels of one CTA of the cluster
constexpr int ROWS = 64;           // the cluster's keys (dK/dV) or queries (dQ)
constexpr int TILE = 32;           // streamed rows a tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr int LD = SLICE + 4;      // operand row stride, floats: 4 banks on a row
constexpr int XLD = TILE + 8;      // partial-logit row stride: a warp's stores on 32 banks
constexpr int PLD = ROWS + 4;      // P^T and dS^T row stride: a quarter warp's float4s apart

// Offsets into the dynamic shared memory, in floats.
constexpr int RES = 0;                                // two resident 64-row slices
constexpr int RING = RES + 2 * ROWS * LD;             // STAGES x two streamed slices
constexpr int PART = RING + STAGES * 2 * TILE * LD;   // [buffer][S, dP][row][XLD]
constexpr int PT = PART + 2 * 2 * ROWS * XLD;         // P^T, then dS^T: [col][PLD]
constexpr int VEC = PT + 2 * TILE * PLD;              // dK/dV: [stage][lse, delta][TILE]; dQ: [lse, delta][ROWS]
constexpr int FLOATS = VEC + 2 * 2 * TILE;
constexpr int SMEM_BYTES = FLOATS * 4;
static_assert(STAGES * 2 * TILE == 2 * ROWS, "the row vectors' region fits both kernels");
static_assert(SMEM_BYTES <= 227 * 1024, "too much shared memory for a CTA");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// DKV: dK (out1), dV (out2) for the 64 keys blockIdx.y of batch blockIdx.z.
// Else dQ (out1; out2 unused) for the 64 queries blockIdx.y. q, k, v, dout,
// out1, out2: (B, N, C) fp32; lse, delta: (B, N) fp32. Grid (R, N / 64, B)
// in clusters of (R, 1, 1).
template <int C, bool DKV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ out1, float* __restrict__ out2, int n,
                         float scale) {
  constexpr int R = C / SLICE;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * ROWS, c0 = rank * SLICE, nt = n / TILE;
  const size_t base = static_cast<size_t>(blockIdx.z) * n;  // batch element's first row
  // the resident rows' operands and the streamed ones: S (or S^T) is
  // res1 str1^T, dP (or dP^T) res2 str2^T; out1 += dS str1, out2 += P str2
  const float* res1 = DKV ? k : q;
  const float* res2 = DKV ? v : dout;
  const float* str1 = DKV ? q : k;
  const float* str2 = DKV ? dout : v;
  float* pt = smem + PT;
  float* dst = pt + TILE * PLD;
  auto stage = [&](int t) { return smem + RING + (t % STAGES) * 2 * TILE * LD; };
  auto part = [&](int t) { return smem + PART + (t & 1) * 2 * ROWS * XLD; };
  auto vecs = [&](int t) { return smem + VEC + (DKV ? (t % STAGES) * 2 * TILE : 0); };

  // rows [row0, row0 + rows) of this CTA's 128 channels of src, into dst
  auto load_rows = [&](float* to, const float* src, int row0, int rows) {
    for (int i = tid; i < rows * (SLICE / 4); i += THREADS) {
      const int row = i / (SLICE / 4), c4 = i % (SLICE / 4);
      cp_async16(to + row * LD + 4 * c4, src + (base + row0 + row) * C + c0 + 4 * c4);
    }
  };
  auto load_vec = [&](float* to, const float* src, int row0, int rows) {
    if (tid < rows / 4) cp_async16(to + 4 * tid, src + base + row0 + 4 * tid);
  };
  // tile t's loads as one group (an empty group past the last tile)
  auto issue = [&](int t) {
    if (t < nt) {
      float* st = stage(t);
      load_rows(st, str1, t * TILE, TILE);
      load_rows(st + TILE * LD, str2, t * TILE, TILE);
      if (DKV) {
        load_vec(vecs(t), lse, t * TILE, TILE);
        load_vec(vecs(t) + TILE, delta, t * TILE, TILE);
      }
    }
    cp_async_commit();
  };
  load_rows(smem + RES, res1, r0, ROWS);
  load_rows(smem + RES + ROWS * LD, res2, r0, ROWS);
  if (!DKV) {
    load_vec(vecs(0), lse, r0, ROWS);
    load_vec(vecs(0) + ROWS, delta, r0, ROWS);
  }
  issue(0);
  issue(1);

  // step 2: matrix mat (0: S, 1: dP) of the partial logits, rows rg + 16 i
  // and columns cg + 8 j (i, j < 4): a warp's rows and columns are
  // consecutive, so its float4 loads fall on distinct banks
  const int mat = tid / 128, rg = (tid % 128) / 8, cg8 = tid % 8;
  const float* a_op = smem + RES + mat * ROWS * LD;
  // step 3: column col of the tile, rows rr .. rr + 7
  const int col = tid % 32, rr = 8 * (tid / 32);
  // step 4: rows 4 rq .. 4 rq + 3, channels 4 cj .. + 3 and 64 + 4 cj .. + 3
  const int rq = tid / 16, cj = tid % 16;
  float acc1[4][8], acc2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc1[i][e] = acc2[i][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<1>();  // tile t (and the resident slices) landed
    __syncthreads();
    const float* st = stage(t);

    // ---- step 2: this CTA's partial S and dP over its 128 channels ----
    {
      const float* b_op = st + mat * TILE * LD;
      float x[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < SLICE; c += 4) {
        float4 a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(a_op + (rg + 16 * i) * LD + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(b_op + (cg8 + 8 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[i][j] = fmaf(a[i].x, bv[j].x, x[i][j]);
            x[i][j] = fmaf(a[i].y, bv[j].y, x[i][j]);
            x[i][j] = fmaf(a[i].z, bv[j].z, x[i][j]);
            x[i][j] = fmaf(a[i].w, bv[j].w, x[i][j]);
          }
      }
      float* xp = part(t) + mat * ROWS * XLD;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) xp[(rg + 16 * i) * XLD + cg8 + 8 * j] = x[i][j];
    }
    cluster.sync();  // every rank's partials of tile t are visible

    // ---- step 3: the partials added in rank order; P and dS ----
    {
      float s[8], dp[8];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* xr = cluster.map_shared_rank(part(t), r);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float sv = xr[(rr + e) * XLD + col];
          const float dv = xr[(ROWS + rr + e) * XLD + col];
          s[e] = r == 0 ? sv : s[e] + sv;
          dp[e] = r == 0 ? dv : dp[e] + dv;
        }
      }
      const float* vv = vecs(t);
      float p[8], ds[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // dK/dV: the tile's columns are queries; dQ: the block's rows are
        const float l = DKV ? vv[col] : vv[rr + e];
        const float d = DKV ? vv[TILE + col] : vv[ROWS + rr + e];
        // S * scale rounded before the subtraction, as the plain version
        p[e] = expf(__fmul_rn(s[e], scale) - l);
        ds[e] = p[e] * (dp[e] - d) * scale;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float4*>(pt + col * PLD + rr + 4 * h) =
            make_float4(p[4 * h], p[4 * h + 1], p[4 * h + 2], p[4 * h + 3]);
        *reinterpret_cast<float4*>(dst + col * PLD + rr + 4 * h) =
            make_float4(ds[4 * h], ds[4 * h + 1], ds[4 * h + 2], ds[4 * h + 3]);
      }
    }
    __syncthreads();  // P^T and dS^T are written

    // ---- step 4: the tile's products into fresh accumulators, then the sums ----
    {
      float t1[4][8], t2[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) t1[i][e] = t2[i][e] = 0.f;
      const float* b1 = st;
      const float* b2 = st + TILE * LD;
#pragma unroll 4
      for (int kk = 0; kk < TILE; ++kk) {
        const float4 d4 = *reinterpret_cast<const float4*>(dst + kk * PLD + 4 * rq);
        const float4 x0 = *reinterpret_cast<const float4*>(b1 + kk * LD + 4 * cj);
        const float4 x1 = *reinterpret_cast<const float4*>(b1 + kk * LD + 64 + 4 * cj);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            t1[i][e] = fmaf(lane4(d4, i), lane4(x0, e), t1[i][e]);
            t1[i][4 + e] = fmaf(lane4(d4, i), lane4(x1, e), t1[i][4 + e]);
          }
        if (DKV) {
          const float4 p4 = *reinterpret_cast<const float4*>(pt + kk * PLD + 4 * rq);
          const float4 y0 = *reinterpret_cast<const float4*>(b2 + kk * LD + 4 * cj);
          const float4 y1 = *reinterpret_cast<const float4*>(b2 + kk * LD + 64 + 4 * cj);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              t2[i][e] = fmaf(lane4(p4, i), lane4(y0, e), t2[i][e]);
              t2[i][4 + e] = fmaf(lane4(p4, i), lane4(y1, e), t2[i][4 + e]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc1[i][e] += t1[i][e];
          if (DKV) acc2[i][e] += t2[i][e];
        }
    }
    __syncthreads();  // every thread is done with stage t and with P^T, dS^T
    issue(t + 2);
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (base + r0 + 4 * rq + i) * C + c0 + 4 * cj;
    *reinterpret_cast<float4*>(out1 + row) =
        make_float4(acc1[i][0], acc1[i][1], acc1[i][2], acc1[i][3]);
    *reinterpret_cast<float4*>(out1 + row + 64) =
        make_float4(acc1[i][4], acc1[i][5], acc1[i][6], acc1[i][7]);
    if (DKV) {
      *reinterpret_cast<float4*>(out2 + row) =
          make_float4(acc2[i][0], acc2[i][1], acc2[i][2], acc2[i][3]);
      *reinterpret_cast<float4*>(out2 + row + 64) =
          make_float4(acc2[i][4], acc2[i][5], acc2[i][6], acc2[i][7]);
    }
  }
}

// The launch over grid (R, n / 64, b) in clusters of R CTAs, with the
// shared memory; the SM's whole carveout goes to shared memory.
template <int C, bool DKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* out1, void* out2, int b, int n,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_f32_kernel<C, DKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C / SLICE, n / ROWS, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C / SLICE;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(q),
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<const float*>(dout), static_cast<const float*>(lse),
                           static_cast<const float*>(delta), static_cast<float*>(out1),
                           static_cast<float*>(out2), n, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool DKV>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* out1, void* out2, int b, int n, int c, float scale,
             void* stream) {
  // 1 <= b <= 65535 (grid z), n a positive multiple of 128 with n / 64
  // blocks within grid y
  if (b < 1 || b > 65535 || n < 128 || n % 128 != 0 || n / ROWS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch<128, DKV>(q, k, v, dout, lse, delta, out1, out2, b, n, scale, s));
    case 256: return static_cast<int>(launch<256, DKV>(q, k, v, dout, lse, delta, out1, out2, b, n, scale, s));
    case 384: return static_cast<int>(launch<384, DKV>(q, k, v, dout, lse, delta, out1, out2, b, n, scale, s));
    case 512: return static_cast<int>(launch<512, DKV>(q, k, v, dout, lse, delta, out1, out2, b, n, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: contiguous (b, n, c) fp32; lse, delta: contiguous
// (b, n) fp32; all 16-byte aligned, on the current device. n must be a
// multiple of 128 and c one of 128, 256, 384, 512.
int vcd_flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int b, int n, int c, float scale,
                                    void* stream) {
  return dispatch<true>(q, k, v, dout, lse, delta, dk, dv, b, n, c, scale, stream);
}

// The same operands; writes dq, contiguous (b, n, c) fp32.
int vcd_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int b, int n, int c, float scale, void* stream) {
  return dispatch<false>(q, k, v, dout, lse, delta, dq, nullptr, b, n, c, scale, stream);
}

const char* vcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
