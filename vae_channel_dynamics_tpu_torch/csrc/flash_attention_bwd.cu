// Flash-attention backward for the VAE mid block, hand-written for Hopper
// (sm_90a) on wgmma and TMA, its channels split over a thread-block cluster.
//
// Replaces vae_channel_dynamics_tpu/ops/pallas_attention.py::_flash_bwd_dkv_kernel
// (:304, dK, dV) and ::_flash_bwd_dq_kernel (:284, dQ). Both rebuild each tile
// of the softmax from the forward's per-row log-sum-exp, with the JAX
// kernels' math (_bwd_tile, :262-281):
//   S  = Q K^T * scale                 fp32
//   P  = exp(S - lse)                  exact softmax, no running max
//   dP = dO V^T                        fp32
//   dS = P * (dP - delta) * scale      delta = rowsum(dO * O), computed outside
//   dV += P^T dO,  dK += dS^T Q,  dQ += dS K
// P and dS are cast to bf16 before the last three products; every
// accumulator is fp32 and dQ, dK, dV are written in bf16.
//
// What bounds it on the H100: dK/dV do 8*B*N^2*C FLOPs and dQ 6*B*N^2*C
// against a few B*N*C bytes of device memory, so both would be tensor-core
// bound at the mid block's N = 4096 and 16384 (1.11 and 0.83 ms at (1,
// 16384, 512)). What stood in the way is the head: 512 channels wide, so a
// (rows x 512) fp32 accumulator costs 64 registers a thread for every 16
// rows over 8 warps. The mma.sync kernels this file held before owned 16
// keys (or queries) a block, and each of their N / 16 blocks streamed the
// whole other side, 34.4 GB through L2 a call at (1, 16384, 512): 8-9% of
// the bound.
//
// The design: the channels, not the rows, are split. A cluster of R = C/128
// CTAs (4 at the mid block's C = 512; 1 to 8 at C = 128 .. 1024, 8 the
// largest portable cluster) shares one block of 64 rows (keys for dK/dV,
// queries for dQ), and CTA r owns channels [128r, 128r + 128): it loads
// only that slice of every operand, and its dK and dV (or dQ) of 64 rows x
// 128 channels are one wgmma accumulator each, 64 fp32 a thread in one
// warpgroup. Each CTA then streams N x 128 x 2 x 2 bytes, a quarter of a
// full-width block's at C = 512, for 4x the rows.
//
// Per streamed tile (64 queries for dK/dV, 32 at R = 7; 32 keys for dQ):
//   1. TMA brings the tile's slice (Q and dO, or K and V; dK/dV also lse and
//      delta) into a ring of stages; each warp's lane 0 issues a quarter of
//      a refill (one thread issuing all of them held up the warpgroup);
//   2. wgmma (m64n64k16 or m64n32k16) forms this CTA's partial S and dP (S^T
//      and dP^T for dK/dV, M = keys) over its 128 channels: 8 k-steps each,
//      a short accumulation, as the tensor cores truncate fp32 sums;
//   3. the cluster adds the partials in rank order 0, 1, ..., R-1 through
//      distributed shared memory: a thread's logits of a tile are pairs, and
//      pair p belongs to rank p R / pairs. Every CTA stores each pair of its
//      S and dP partials in fp32 into its own slot or an outbox run for the
//      owner, and one bulk copy a rank (cp.async.bulk, shared::cta to
//      shared::cluster) sends each run to its owner's slot for this rank,
//      counted by the owner's mbarrier (a reduce-scatter); the owner adds
//      the R slots in rank order, forms P and dS in bf16, and copies its run
//      of pairs the same way into every other rank's gather buffer (an
//      all-gather). At R = 4, 36 bytes cross between SMs a logit for dK/dV
//      (30 for dQ, which gathers dS only), against 96 for a full exchange of
//      the fp32 partials; at R = 8, 84 (70) against 448. Every CTA so holds
//      the same bits of P and dS; no atomics, no fences (each barrier counts
//      the bytes it waits for). A CTA's exchange buffer holds its R slots of
//      the pairs it owns and its outbox of the other ranks' pairs, sized
//      for the rank that owns the most ((R - 1) ceil(P / R) + P pairs of
//      2 KB, Split::PAIRS_HELD): from R = 5 a buffer of R slots of the
//      largest run and an outbox of R - 1 such runs would not fit;
//   4. the gathered P and dS, in the accumulator's own layout, are wgmma's
//      register A: dV += P^T dO and dK += dS^T Q (M = keys, K = queries), or
//      dQ += dS K (M = queries, K = keys), with dO, Q or K read from the
//      stage as MN-major B (m64n128k16).
// Each output element is written once, in bf16, by one CTA: two runs give
// the same bits.
//
// What bounds the design is the exchange's latency more than its bytes:
// each tile waits twice for the other ranks, with only one warpgroup an SM
// to fill the wait, while the card's 50 MB L2 keeps every streamed slice.
// Two chains an SM hide one's waits behind the other's work, and shared
// memory sets how:
//   - dK/dV (64-query tiles, 3 stages, two gather buffers, 199,216-231,984
//     bytes for R = 1-6 and 8, one CTA an SM, 219-255 registers, no spills
//     but 12 bytes at R = 6) pipelines itself by a tile: tile t - 1's
//     products run while the cluster exchanges tile t. At R = 7 its
//     64-query tiles would need 236,080 bytes, so it streams 32-query tiles
//     there (141,104 bytes, still one CTA an SM): twice the exchanges a
//     query;
//   - dQ (32-key tiles, 2 stages, one gather buffer, 87,080-111,656 bytes
//     for R = 1-8, 122-139 registers) runs two CTAs an SM at every R, one's
//     exchange beside the other's products; its smaller tiles double the
//     exchanges, which dK/dV, that gathers P as well, did not recover when
//     it was built that way.
// A cluster of R CTAs needs R SMs of one GPC at once: from R = 5 a GPC of
// 16 to 18 SMs leaves some idle (it holds three clusters of 5, two or three
// of 6, two of 7 or 8).
// C = 128, a cluster of one with no traffic between SMs, prices the
// exchange: chip_smoke.py logs it beside C = 512.
//
// Q, dO, lse and delta hold Nq rows and K, V Nk, as in the JAX kernels:
// under a spatial group of S ranks (ops/spatial_conv.py) each rank's queries
// are its Nq = N / S rows of the image and its keys all N. dK/dV's grid runs
// over the Nk keys and its loop over the Nq queries; dQ's grid over the
// queries and its loop over the keys. At Nq == Nk nothing else differs.
//
// Plain C interface for ctypes: pointers and the stream are void*, each
// function returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for a shape it does not take). They launch on the caller's stream,
// allocate nothing and do not synchronise.

#include <cooperative_groups.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace vcd::sm90;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int SLICE = 128;             // channels of one CTA of the cluster
constexpr int ROWS = 64;               // the CTA's keys (dK/dV) or queries (dQ): wgmma's M
constexpr int THREADS = 128;           // one warpgroup
constexpr int RES_BOX = ROWS * 128;    // a resident TMA box: 64 rows x 64 channels bf16
constexpr int RESIDENT = 2 * RES_BOX;  // a resident 64-row slice of 128 channels

// Pair p of every thread (of its 2 P logits of a tile) belongs to rank
// floor(p R / P): ranks own contiguous runs of pairs, [first(r), first(r + 1)).
// A CTA's exchange buffer is sized by what its rank owns: its R slots of its
// own pairs ([rank][pair][thread] float4), then its outbox, the other ranks'
// pairs in pair order.
template <int R, int P>
struct Split {
  static constexpr int MAXP = (P + R - 1) / R;  // pairs a rank owns, at most
  __host__ __device__ static constexpr int first(int r) { return (P * r + R - 1) / R; }
  // (MAXP for every rank where R divides P: a constant, as the rank is not)
  __host__ __device__ static constexpr int own(int r) {
    return P % R == 0 ? MAXP : first(r + 1) - first(r);
  }
  // the largest exchange buffer of any rank, in pairs: R own + P - own
  static constexpr int PAIRS_HELD = (R - 1) * MAXP + P;
  // pairs before rank o's run in the outbox of rank `rank`
  __device__ static int outbox_at(int o, int rank) {
    return o < rank ? first(o) : first(o) - own(rank);
  }
};

// Each kernel's tiling and byte offsets into its 1024-aligned dynamic shared
// memory. DKV, the dK/dV kernel: streamed tiles of 64 queries (32 at R = 7,
// whose exchange buffer for 64 would not fit: 34 pairs of 2 KB), 3 stages,
// its products pipelined by a tile (two gather buffers), one CTA an SM.
// Else dQ: tiles of 32 keys, 2 stages, one gather buffer, small enough for
// two CTAs an SM at every R. DKV gathers P and dS and streams lse and delta;
// dQ gathers dS only.
template <int R, bool DKV>
struct Layout {
  static constexpr int TILE = DKV && R != 7 ? 64 : 32;  // rows of a streamed tile
  static constexpr int STAGES = DKV ? 3 : 2;
  static constexpr int GATHERS = DKV ? 2 : 1;
  static constexpr int CTAS = DKV ? 1 : 2;                // an SM
  static constexpr int PAIRS = TILE / 4;                  // a thread's TILE / 2 logits
  static constexpr int BOX = TILE * 128;                  // a streamed box: TILE x 64 channels
  static constexpr int STREAMED = 2 * BOX;                // a streamed slice of 128 channels
  static constexpr int G = DKV ? 8 : 4;                   // gathered bytes a pair
  using X = Split<R, PAIRS>;
  static constexpr int RES = 0;                                  // two resident slices
  static constexpr int RING = RES + 2 * RESIDENT;                // STAGES x two streamed
  static constexpr int EXCH = RING + STAGES * 2 * STREAMED;      // slots, outbox (Split)
  static constexpr int GATHER = EXCH + X::PAIRS_HELD * THREADS * 16;  // [buffer][pair][thread]
  static constexpr int GATHER_BYTES = PAIRS * THREADS * G;
  static constexpr int ROWVEC = GATHER + GATHERS * GATHER_BYTES;  // DKV: [stage][lse, delta]
  static constexpr int BARS = ROWVEC + (DKV ? STAGES * 2 * TILE * 4 : 0);
  static constexpr int NBARS = STAGES + 3;                       // full[], res, slots, gather
  static constexpr int BYTES = BARS + NBARS * 8 + 1024;          // + the alignment pad
  // an SM's 228 KB, less 1 KB a CTA that the system keeps
  static_assert(BYTES <= 228 * 1024 / CTAS - 1024, "too much shared memory for CTAS an SM");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Step 2: this CTA's partial S (a_s x b_s^T) and dP (a_dp x b_dp^T) over
// its 128 channels: A a resident 64-row slice, B a streamed slice of TILE
// rows, each two K-major boxes of 64 channels; 8 k-steps each.
template <int TILE>
__device__ __forceinline__ void partial_logits(float (&s)[TILE / 2], float (&dp)[TILE / 2],
                                               const uint8_t* a_s, const uint8_t* b_s,
                                               const uint8_t* a_dp, const uint8_t* b_dp) {
  // d += a b^T over the 128 channels: 64 a box, 16 a k-step (32 bytes on)
  auto product = [](float (&d)[TILE / 2], const uint8_t* a, const uint8_t* b) {
#pragma unroll
    for (int kk = 0; kk < SLICE / 16; ++kk) {
      const uint64_t da = make_desc(a + (kk / 4) * RES_BOX, 128) + 2 * (kk % 4);
      const uint64_t db = make_desc(b + (kk / 4) * TILE * 128, 128) + 2 * (kk % 4);
      if constexpr (TILE == 64)
        wgmma_ss_m64n64k16(d, da, db, kk > 0);
      else
        wgmma_ss_m64n32k16(d, da, db, kk > 0);
    }
  };
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
  product(s, a_s, b_s);
  product(dp, a_dp, b_dp);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// Step 3, first half: this thread's pairs of S and dP partials, as float4,
// into this CTA's own slot (the pairs it owns) or into the outbox run of
// their owner; once every thread has written, lane 0 of warp w sends the
// runs of ranks w, w + 4, ... each to its slot for this rank in one bulk
// copy, counted by the owner's slots barrier.
template <int R, int P>
__device__ __forceinline__ void push_partials(const float (&s)[2 * P], const float (&dp)[2 * P],
                                              float4* exch, uint64_t* slots_full, int rank,
                                              int wt) {
  using X = Split<R, P>;
  float4* outbox = exch + R * X::own(rank) * THREADS;
#pragma unroll
  for (int o = 0; o < R; ++o) {
    float4* dst = o == rank ? exch + rank * X::own(o) * THREADS
                            : outbox + X::outbox_at(o, rank) * THREADS;
#pragma unroll
    for (int p = X::first(o); p < X::first(o + 1); ++p)
      dst[(p - X::first(o)) * THREADS + wt] =
          make_float4(s[2 * p], s[2 * p + 1], dp[2 * p], dp[2 * p + 1]);
  }
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < (R + 3) / 4; ++i) {
    const int o = wt / 32 + 4 * i;
    if (wt % 32 == 0 && o < R && o != rank)
      bulk_copy_cluster(cluster_addr(exch + rank * X::own(o) * THREADS, o),
                        outbox + X::outbox_at(o, rank) * THREADS, X::own(o) * THREADS * 16,
                        cluster_addr(slots_full, o));
  }
}

// Step 3, second half, on the owner: once every rank's partials have landed,
// add the slots of each owned pair in rank order, form P and dS and store
// them (DKV: uint2 {P, dS}; else uint32 dS, bf16 pairs) at the pair's place
// in this CTA's gather buffer; lane 0 of warp w then copies the owned run
// of pairs to the same place in the gather buffers of ranks w, w + 4, ...,
// each counted by that rank's gather barrier. rowvec, rows: the pair's row
// vector entries. DKV: per column, from this stage's lse and delta (col(p)
// = 8 (p / 2) + 2 (lane % 4)); else per row, this thread's rows row0 (even
// p) and row0 + 8 (odd p), {lse, lse, delta, delta}.
template <int R, bool DKV>
__device__ __forceinline__ void reduce_and_gather(const float4* slots, uint8_t* gather,
                                                  uint64_t* slots_full, uint64_t* gather_full,
                                                  uint32_t parity, int rank, int wt,
                                                  const float* rowvec, const float (&rows)[4],
                                                  float scale) {
  using L = Layout<R, DKV>;
  using X = typename L::X;
  constexpr int G = L::G;
  mbar_wait(slots_full, parity);
  const int lo = X::first(rank), hi = X::first(rank + 1), own = X::own(rank), tig = wt % 4;
#pragma unroll
  for (int i = 0; i < X::MAXP; ++i) {
    const int p = lo + i;
    if (L::PAIRS % R == 0 || p < hi) {  // every rank owns MAXP pairs where R divides PAIRS
      float4 a = slots[i * THREADS + wt];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float4 b = slots[(r * own + i) * THREADS + wt];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      float l0, l1, d0, d1;
      if (DKV) {
        const int col = 8 * (p / 2) + 2 * tig;
        const float2 l = *reinterpret_cast<const float2*>(rowvec + col);
        const float2 d = *reinterpret_cast<const float2*>(rowvec + L::TILE + col);
        l0 = l.x;
        l1 = l.y;
        d0 = d.x;
        d1 = d.y;
      } else {
        l0 = l1 = (p & 1) ? rows[1] : rows[0];
        d0 = d1 = (p & 1) ? rows[3] : rows[2];
      }
      // S * scale rounded before the subtraction, as the plain version
      const float p0 = expf(__fmul_rn(a.x, scale) - l0);
      const float p1 = expf(__fmul_rn(a.y, scale) - l1);
      const uint32_t ds = pack_bf16(p0 * (a.z - d0) * scale, p1 * (a.w - d1) * scale);
      if (DKV)
        reinterpret_cast<uint2*>(gather)[p * THREADS + wt] = make_uint2(pack_bf16(p0, p1), ds);
      else
        reinterpret_cast<uint32_t*>(gather)[p * THREADS + wt] = ds;
    }
  }
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < (R + 3) / 4; ++i) {
    const int r = wt / 32 + 4 * i;
    if (wt % 32 == 0 && r < R && r != rank)
      bulk_copy_cluster(cluster_addr(gather + lo * THREADS * G, r), gather + lo * THREADS * G,
                        own * THREADS * G, cluster_addr(gather_full, r));
  }
}

// d (64 x 128) += A (the gathered 64 x TILE bf16 tile, TILE / 4 pairs a
// thread in the accumulator's layout) * B (a streamed TILE x 128 slice, its
// rows the K dimension: MN-major, 16 rows a k-step).
template <int TILE>
__device__ __forceinline__ void accumulate(float (&d)[64], const uint32_t (&a)[TILE / 4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_rs_m64n128k16<1>(d, frag, make_desc_mn(b + kk * 16 * 128, TILE * 128, 1024));
  }
}

// Writes a 64 x 128 accumulator as bf16 rows of dst (row stride C): rows
// 16 warp + lane / 4 (+ 8), channels 8j + 2 (lane % 4) and the one after.
template <int C>
__device__ __forceinline__ void store_slice(bf16* dst, const float (&d)[64], int warp, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* row = dst + static_cast<size_t>(16 * warp + lane / 4 + 8 * half) * C + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
  }
}

// The barriers: full[STAGES], res, slots_full, gather_full.
struct Bars {
  uint64_t* full;
  uint64_t* res;
  uint64_t* slots_full;
  uint64_t* gather_full;
};

template <int STAGES>
__device__ __forceinline__ Bars init_bars(uint8_t* at, int tid) {
  uint64_t* b = reinterpret_cast<uint64_t*>(at);
  const Bars bars = {b, b + STAGES, b + STAGES + 1, b + STAGES + 2};
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars.full[s], 1);
    mbar_init(bars.res, 1);
    // one arrival each, thread 0's expect_tx of the tile's bytes (arm())
    mbar_init(bars.slots_full, 1);
    mbar_init(bars.gather_full, 1);
    mbar_init_fence();
  }
  // every CTA's barriers are initialised before any CTA of the cluster
  // sends to them
  cg::this_cluster().sync();
  return bars;
}

// Thread 0 arms tile t's exchange barriers: the slots barrier expects the
// other ranks' partials of this rank's pairs, the gather barrier the other
// owners' pairs (this CTA's own part of each is written by its own threads
// before a __syncthreads). Called after push_partials, whose barrier every
// thread passes only after its waits on tile t - 1: at R = 1 both barriers
// expect no byte, so arming completes the phase at once, and a phase
// completed before a lagging warp's wait on the one before would leave it
// waiting on the parity forever. No byte of tile t can land before this
// CTA's partials have left (a rank sends its partials only after its
// gather is complete, and an owner gathers only after its slots are), and
// bytes that land before the arming count toward the phase it leaves
// pending.
template <int R, bool DKV>
__device__ __forceinline__ void arm(const Bars& bars, int rank, int tid) {
  using L = Layout<R, DKV>;
  if (tid == 0) {
    const int own = L::X::first(rank + 1) - L::X::first(rank);
    mbar_arrive_expect_tx(bars.slots_full, (R - 1) * own * THREADS * 16);
    mbar_arrive_expect_tx(bars.gather_full, (L::PAIRS - own) * THREADS * L::G);
  }
}

// dK, dV (B, Nk, C) bf16 for the 64 keys blockIdx.y of batch blockIdx.z;
// grid (R, Nk / 64, B) in clusters of (R, 1, 1); the loop over Nq queries.
//
// The loop is pipelined by one tile: tile t - 1's dV and dK products are
// issued once tile t's partials are sent and run while the cluster
// exchanges tile t's logits (so the gather buffer is double-buffered), and
// stage (t - 2) % STAGES, whose products are done, is refilled with tile
// t - 2 + STAGES while this CTA waits for the other ranks' partials.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap lsemap,
                         const __grid_constant__ CUtensorMap deltamap, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int nq, int nk, float scale) {
  constexpr int R = C / SLICE;
  using L = Layout<R, true>;
  constexpr int TILE = L::TILE, STAGES = L::STAGES, PAIRS = L::PAIRS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int k0 = blockIdx.y * ROWS, b = blockIdx.z, c0 = rank * SLICE, nt = nq / TILE;
  const Bars bars = init_bars<STAGES>(smem + L::BARS, tid);
  uint8_t* sK = smem + L::RES;
  uint8_t* sV = sK + RESIDENT;
  float4* slots = reinterpret_cast<float4*>(smem + L::EXCH);
  auto stage = [&](int t) { return smem + L::RING + (t % STAGES) * 2 * L::STREAMED; };  // Q, dO
  auto gather = [&](int t) { return smem + L::GATHER + (t & 1) * L::GATHER_BYTES; };
  auto rowvec = [&](int t) {  // lse, delta
    return reinterpret_cast<float*>(smem + L::ROWVEC) + (t % STAGES) * 2 * TILE;
  };

  // Part w of tile t's loads (w = 0..3, one a warp on a refill): Q's box w,
  // dO's box w - 2; part 0 also arms the barrier, part 3 brings the row
  // vectors.
  auto issue = [&](int t, int w) {
    uint64_t* full = &bars.full[t % STAGES];
    if (w == 0) mbar_arrive_expect_tx(full, 2 * L::STREAMED + 2 * TILE * 4);
    tma_load_3d(stage(t) + w * L::BOX, w < 2 ? &qmap : &domap, full, c0 + 64 * (w % 2),
                t * TILE, b);
    if (w == 3) {
      tma_load_2d(rowvec(t), &lsemap, full, t * TILE, b);
      tma_load_2d(rowvec(t) + TILE, &deltamap, full, t * TILE, b);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bars.res, 2 * RESIDENT);
    for (int box = 0; box < 2; ++box) {
      tma_load_3d(sK + box * RES_BOX, &kmap, bars.res, c0 + 64 * box, k0, b);
      tma_load_3d(sV + box * RES_BOX, &vmap, bars.res, c0 + 64 * box, k0, b);
    }
    for (int t = 0; t < STAGES && t < nt; ++t)
      for (int w = 0; w < 4; ++w) issue(t, w);
  }

  float dkacc[64], dvacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dkacc[i] = dvacc[i] = 0.f;
  uint32_t ap[PAIRS], ads[PAIRS];
  // dV += P^T dO, dK += dS^T Q over tile u's 64 queries: issued, not waited
  auto products = [&](int u) {
    const uint2* g = reinterpret_cast<const uint2*>(gather(u));
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const uint2 v = g[p * THREADS + tid];
      ap[p] = v.x;
      ads[p] = v.y;
    }
    wgmma_fence();
    accumulate<TILE>(dvacc, ap, stage(u) + L::STREAMED);
    accumulate<TILE>(dkacc, ads, stage(u));
    wgmma_commit();
  };
  const float unused[4] = {0.f, 0.f, 0.f, 0.f};
  mbar_wait(bars.res, 0);

  for (int t = 0; t < nt; ++t) {
    mbar_wait(&bars.full[t % STAGES], (t / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T over this CTA's channels (M = keys);
    // the logits' registers live only until they are pushed
    {
      float sacc[TILE / 2], dpacc[TILE / 2];
      partial_logits<TILE>(sacc, dpacc, sK, stage(t), sV, stage(t) + L::STREAMED);
      push_partials<R, PAIRS>(sacc, dpacc, slots, bars.slots_full, rank, tid);
    }
    arm<R, true>(bars, rank, tid);
    if (lane == 0 && t >= 2 && t - 2 + STAGES < nt) issue(t - 2 + STAGES, warp);
    if (t > 0) products(t - 1);
    reduce_and_gather<R, true>(slots, gather(t), bars.slots_full, bars.gather_full, t & 1, rank,
                               tid, rowvec(t), unused, scale);
    mbar_wait(bars.gather_full, t & 1);
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    fence_regs(ap);
    fence_regs(ads);
  }
  products(nt - 1);
  wgmma_wait<0>();
  fence_regs(dvacc);
  fence_regs(dkacc);
  fence_regs(ap);
  fence_regs(ads);

  const size_t out = (static_cast<size_t>(b) * nk + k0) * C + c0;
  store_slice<C>(dk + out, dkacc, warp, lane);
  store_slice<C>(dv + out, dvacc, warp, lane);
  // no CTA leaves while another may still reach its shared memory
  cg::this_cluster().sync();
}

// dQ (B, Nq, C) bf16 for the 64 queries blockIdx.y of batch blockIdx.z; grid
// (R, Nq / 64, B) and clusters as dK/dV's, the loop over Nk keys, two CTAs
// an SM: one CTA's exchange overlaps the other's products, in place of
// dK/dV's pipelining.
template <int C>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, int nq,
                        int nk, float scale) {
  constexpr int R = C / SLICE;
  using L = Layout<R, false>;
  constexpr int TILE = L::TILE, STAGES = L::STAGES, PAIRS = L::PAIRS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int q0 = blockIdx.y * ROWS, b = blockIdx.z, c0 = rank * SLICE, nt = nk / TILE;
  const Bars bars = init_bars<STAGES>(smem + L::BARS, tid);
  uint8_t* sQ = smem + L::RES;
  uint8_t* sdO = sQ + RESIDENT;
  float4* slots = reinterpret_cast<float4*>(smem + L::EXCH);
  uint8_t* gather = smem + L::GATHER;
  auto stage = [&](int t) { return smem + L::RING + (t % STAGES) * 2 * L::STREAMED; };  // K, V

  // part w of tile t's loads: K's box w, V's box w - 2; part 0 arms the barrier
  auto issue = [&](int t, int w) {
    uint64_t* full = &bars.full[t % STAGES];
    if (w == 0) mbar_arrive_expect_tx(full, 2 * L::STREAMED);
    tma_load_3d(stage(t) + w * L::BOX, w < 2 ? &kmap : &vmap, full, c0 + 64 * (w % 2),
                t * TILE, b);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bars.res, 2 * RESIDENT);
    for (int box = 0; box < 2; ++box) {
      tma_load_3d(sQ + box * RES_BOX, &qmap, bars.res, c0 + 64 * box, q0, b);
      tma_load_3d(sdO + box * RES_BOX, &domap, bars.res, c0 + 64 * box, q0, b);
    }
    for (int t = 0; t < STAGES && t < nt; ++t)
      for (int w = 0; w < 4; ++w) issue(t, w);
  }

  // this thread's rows: row0 and row0 + 8; lse and delta of both
  const size_t row0 = static_cast<size_t>(b) * nq + q0 + 16 * warp + lane / 4;
  const float rows[4] = {lse[row0], lse[row0 + 8], delta[row0], delta[row0 + 8]};
  float dqacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dqacc[i] = 0.f;
  mbar_wait(bars.res, 0);

  for (int t = 0; t < nt; ++t) {
    mbar_wait(&bars.full[t % STAGES], (t / STAGES) & 1);

    // S = Q K^T and dP = dO V^T over this CTA's channels (M = queries)
    {
      float sacc[TILE / 2], dpacc[TILE / 2];
      partial_logits<TILE>(sacc, dpacc, sQ, stage(t), sdO, stage(t) + L::STREAMED);
      push_partials<R, PAIRS>(sacc, dpacc, slots, bars.slots_full, rank, tid);
    }
    arm<R, false>(bars, rank, tid);
    // every warp has finished tile t - 1: its stage takes tile t + 1
    if (lane == 0 && t >= 1 && t + 1 < nt) issue(t + 1, warp);
    reduce_and_gather<R, false>(slots, gather, bars.slots_full, bars.gather_full, t & 1, rank,
                                tid, nullptr, rows, scale);
    mbar_wait(bars.gather_full, t & 1);

    // dQ += dS K over the tile's keys
    uint32_t ads[PAIRS];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
      ads[p] = reinterpret_cast<const uint32_t*>(gather)[p * THREADS + tid];
    wgmma_fence();
    accumulate<TILE>(dqacc, ads, stage(t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqacc);
    fence_regs(ads);
  }

  store_slice<C>(dq + (static_cast<size_t>(b) * nq + q0) * C + c0, dqacc, warp, lane);
  cg::this_cluster().sync();
}

// A (b, n, C) bf16 operand in boxes of 64 channels x `rows` rows (ROWS for a
// resident slice, the kernel's TILE for a streamed one), 128-byte swizzled;
// a (b, n) fp32 row vector in boxes of `rows`.
template <int C>
cudaError_t operand_map(CUtensorMap* map, const void* base, int b, int n, int rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(n),
                            static_cast<uint64_t>(b)};
  const uint64_t strides[2] = {2ull * C, 2ull * C * n};
  const uint32_t box[3] = {64, static_cast<uint32_t>(rows), 1};
  return make_tensor_map(map, base, 3, dims, strides, box, 128);
}

cudaError_t rowvec_map(CUtensorMap* map, const void* base, int b, int n, int rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(b)};
  const uint64_t strides[1] = {4ull * n};
  const uint32_t box[2] = {static_cast<uint32_t>(rows), 1};
  return make_tensor_map(map, base, 2, dims, strides, box, 0, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The launch of one of the kernels over grid (R, rows / 64, b) in clusters
// of R CTAs, with its shared memory; the SM's whole carveout goes to shared
// memory, so that two CTAs share an SM.
template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, int r, int b, int rows, int bytes,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(r, rows / ROWS, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = r;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int b, int nq,
                       int nk, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap, lsemap, deltamap;
  constexpr int TILE = Layout<C / SLICE, true>::TILE;
  cudaError_t err = operand_map<C>(&qmap, q, b, nq, TILE);
  if (err == cudaSuccess) err = operand_map<C>(&kmap, k, b, nk, ROWS);
  if (err == cudaSuccess) err = operand_map<C>(&vmap, v, b, nk, ROWS);
  if (err == cudaSuccess) err = operand_map<C>(&domap, dout, b, nq, TILE);
  if (err == cudaSuccess) err = rowvec_map(&lsemap, lse, b, nq, TILE);
  if (err == cudaSuccess) err = rowvec_map(&deltamap, delta, b, nq, TILE);
  if (err != cudaSuccess) return err;
  return launch_cluster(flash_bwd_dkv_kernel<C>, C / SLICE, b, nk, Layout<C / SLICE, true>::BYTES,
                        stream, qmap, kmap, vmap, domap, lsemap, deltamap,
                        static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq, nk, scale);
}

template <int C>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int b, int nq, int nk,
                      float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  constexpr int TILE = Layout<C / SLICE, false>::TILE;
  cudaError_t err = operand_map<C>(&qmap, q, b, nq, ROWS);
  if (err == cudaSuccess) err = operand_map<C>(&kmap, k, b, nk, TILE);
  if (err == cudaSuccess) err = operand_map<C>(&vmap, v, b, nk, TILE);
  if (err == cudaSuccess) err = operand_map<C>(&domap, dout, b, nq, ROWS);
  if (err != cudaSuccess) return err;
  return launch_cluster(flash_bwd_dq_kernel<C>, C / SLICE, b, nq, Layout<C / SLICE, false>::BYTES,
                        stream, qmap, kmap, vmap, domap, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<bf16*>(dq), nq, nk, scale);
}

// The shapes the kernels take: 1 <= b <= 65535 (grid z), nq and nk positive
// multiples of 128 with nq / 64 and nk / 64 blocks within grid y.
bool shape_ok(int b, int nq, int nk) {
  return b >= 1 && b <= 65535 && nq >= 128 && nq % 128 == 0 && nq / ROWS <= 65535 &&
         nk >= 128 && nk % 128 == 0 && nk / ROWS <= 65535;
}

}  // namespace

extern "C" {

// q, dout: contiguous (b, nq, c) bf16; k, v, dk, dv: contiguous (b, nk, c)
// bf16; lse, delta: contiguous (b, nq) fp32; all on the current device. nq
// and nk must be multiples of 128 and c a multiple of 128 up to 1024.
int vcd_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int b, int nq, int nk, int c,
                                     float scale, void* stream) {
  if (!shape_ok(b, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, scale, s));
    case 256: return static_cast<int>(launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, scale, s));
    case 384: return static_cast<int>(launch_dkv<384>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, scale, s));
    case 512: return static_cast<int>(launch_dkv<512>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, scale, s));
    case 640: return static_cast<int>(launch_dkv<640>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, scale, s));
    case 768: return static_cast<int>(launch_dkv<768>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, scale, s));
    case 896: return static_cast<int>(launch_dkv<896>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, scale, s));
    case 1024: return static_cast<int>(launch_dkv<1024>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same operands; writes dq, contiguous (b, nq, c) bf16.
int vcd_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int b, int nq, int nk, int c, float scale,
                                    void* stream) {
  if (!shape_ok(b, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch_dq<128>(q, k, v, dout, lse, delta, dq, b, nq, nk, scale, s));
    case 256: return static_cast<int>(launch_dq<256>(q, k, v, dout, lse, delta, dq, b, nq, nk, scale, s));
    case 384: return static_cast<int>(launch_dq<384>(q, k, v, dout, lse, delta, dq, b, nq, nk, scale, s));
    case 512: return static_cast<int>(launch_dq<512>(q, k, v, dout, lse, delta, dq, b, nq, nk, scale, s));
    case 640: return static_cast<int>(launch_dq<640>(q, k, v, dout, lse, delta, dq, b, nq, nk, scale, s));
    case 768: return static_cast<int>(launch_dq<768>(q, k, v, dout, lse, delta, dq, b, nq, nk, scale, s));
    case 896: return static_cast<int>(launch_dq<896>(q, k, v, dout, lse, delta, dq, b, nq, nk, scale, s));
    case 1024: return static_cast<int>(launch_dq<1024>(q, k, v, dout, lse, delta, dq, b, nq, nk, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a CTA of the dK/dV (dkv != 0) or dQ kernel takes
// at width c, in bytes; -1 for a width it does not take.
int vcd_flash_attention_bwd_smem(int c, int dkv) {
  switch (c) {
    case 128: return dkv ? Layout<1, true>::BYTES : Layout<1, false>::BYTES;
    case 256: return dkv ? Layout<2, true>::BYTES : Layout<2, false>::BYTES;
    case 384: return dkv ? Layout<3, true>::BYTES : Layout<3, false>::BYTES;
    case 512: return dkv ? Layout<4, true>::BYTES : Layout<4, false>::BYTES;
    case 640: return dkv ? Layout<5, true>::BYTES : Layout<5, false>::BYTES;
    case 768: return dkv ? Layout<6, true>::BYTES : Layout<6, false>::BYTES;
    case 896: return dkv ? Layout<7, true>::BYTES : Layout<7, false>::BYTES;
    case 1024: return dkv ? Layout<8, true>::BYTES : Layout<8, false>::BYTES;
    default: return -1;
  }
}

const char* vcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
