// Flash-attention backward at fp32 for the VAE mid block, hand-written for
// Hopper (sm_90a): dK/dV and dQ with TMA loads, dP and the output products
// as 3xTF32 on wgmma, S by FFMA, the channels split over a thread-block
// cluster.
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
// P and dS stay fp32 until they are split for the products.
//
// What bounds it on the H100: dK/dV do 8*B*N^2*C FLOPs and dQ 6*B*N^2*C
// against a few B*N*C fp32 bytes, so both are bound by arithmetic. TF32
// keeps 10 mantissa bits, so each output product and dP are three TF32
// products (3xTF32, as the fp32 forward's): each fp32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest, and x y
// is taken as lo hi + hi lo + hi hi on wgmma with fp32 accumulation. S alone
// is taken by FFMA on the CUDA cores (below). Bound: 3 x the FLOPs at the
// 495 TFLOP/s TF32 rate, 6.66 and 5.00 ms at (1, 16384, 512); S's FFMAs
// alone are 4.10 ms of the CUDA cores' 67 TFLOP/s in each kernel.
//
// Why S is not on the tensor cores: with P = exp(S scale - lse) rebuilt
// from the forward's lse and never renormalised, an absolute error in S is
// a relative error in P, and at logits of several hundred the plain fp32
// matmul's own rounding (one FMA chain a logit) is already about 3 ulps.
// Summed on wgmma (truncating, 48 adds) S is 1.5e-3 off plain there; summed
// exactly, still 2-4e-4; in plain's own order, one FMA chain of the
// channels in order, it keeps plain's bits
// (tests/test_torch_flash_bwd_f32.py::test_large_logits_need_plain_order).
// dP enters only through dP - delta, where its truncation error is small
// against the difference, so wgmma serves it, in four fresh accumulators of
// 32 channels (one accumulator of 48 adds reaches 1.1e-4 there on one input
// of ten). S by FFMA is shared-memory bound: 4 x 4 logits a thread load 8
// float4 for 64 FMAs, so warpgroup 0 takes all of S and warpgroup 1 all
// the rest but its own products, and the order below keeps S running while
// the cluster exchanges.
//
// The split: the channels, not the rows, as in the bf16 backward
// (flash_attention_bwd.cu). A cluster of R = C/128 CTAs (4 at C = 512; 1 to
// 8 at C = 128 .. 1024) shares one block of 64 rows (keys for dK/dV,
// queries for dQ), and CTA r owns channels [128r, 128r + 128). Two
// warpgroups a CTA.
//
// tf32 wgmma takes K-major operands only (no transpose flag), and every
// output product sums over the streamed rows, its operands' outer dimension.
// So the outputs are computed transposed, M = channels: dK^T = Q^T dS,
// dV^T = dO^T P, dQ^T = K^T dS^T. The streamed operand is wgmma's register A,
// gathered from its row-major fp32 tile by each thread's own loads (a
// transpose costs only addressing) and split in registers, and P and dS,
// which the kernel forms itself, are the K-major B in shared memory, written
// once as hi and once as lo. dP keeps both operands K-major over the
// channels: the resident one (V, or dO) is register A, split as it is
// loaded, and the streamed one B, split into a buffer of its own.
//
// Per streamed tile of 32 rows (queries for dK/dV, keys for dQ):
//   1. TMA brought the tile's slice of the two streamed operands (Q and dO,
//      or K and V; dK/dV also lse and delta) into one of two stages, four
//      128-byte swizzled boxes of 32 channels each; warpgroup 1 splits the
//      second (dO, or V) into hi and lo at the same offsets in the split
//      buffer; the stage stays fp32;
//   2. warpgroup 0 forms this CTA's partial S^T (or S) over its 128
//      channels by FFMA, 4 x 4 logits a thread (rows rg + 16 i, columns c8 +
//      8 j), one chain of the 128 channels in order each; warpgroup 1 its
//      partial dP^T (or dP) on wgmma, m64n32k8, four fresh accumulators of 4
//      k-steps of three products (12 truncating adds), added as (d0 + d1) +
//      (d2 + d3);
//   3. the cluster adds the partials in rank order 0, 1, ..., R-1 by the
//      bf16 backward's reduce-scatter: the tile's k-step j, and so the logit
//      pairs 2j and 2j + 1 of a wgmma accumulator, belongs to rank j R / 4;
//      every CTA bulk-copies each owner its partials, the owner's warpgroup
//      1 adds the R slots, forms P and dS in fp32, splits them into hi and
//      lo at their places in the B tiles and bulk-copies its run into every
//      other rank's (an all-gather). Every CTA so holds the same bits of P
//      and dS. Bytes a tile at R = 4: 12 KB of partials out of and into each
//      CTA, and 8 KB (dQ 4 KB) of hi/lo tiles to each of the three others.
//      A tile has four k-steps, so from R = 5 only four ranks own one each
//      and the others own none: they send all their partials, gather all
//      four runs, and add nothing;
//   4. warpgroup 0 adds dK^T (both 64-channel halves) and warpgroup 1 dV^T;
//      for dQ warpgroup g adds dQ^T over channels [64g, 64g + 64):
//      m64n64k8, each tile's products into fresh accumulators (4 k-steps of
//      three), then into the running sums by fp32 adds.
// The loop runs one tile ahead. Iteration t: both warpgroups load their
// products' A of tile t into registers and push tile t's partials (formed
// in iteration t - 1, one barrier for the CTA); then warpgroup 0 forms tile
// t + 1's S, while warpgroup 1 splits tile t + 1 (the partials travel),
// reduces its owned pairs of tile t and starts the gather, and forms tile t
// + 1's dP (the gather travels); then each takes tile t's products, warpgroup
// 0 once warpgroup 1's own run of the B tiles is written (named barrier 3).
// The partial logits wait in registers until the next push, so that one set
// of B tiles and of slots suffices. The tensor cores truncate each fp32
// accumulation (round toward zero), so no wgmma accumulation is long
// (tests/test_torch_flash_tf32x3.py). The splits take cvt.rna's rounding by
// integer operations, bit for bit, at the full integer rate (cvt.rna.tf32
// compiles to several instructions).
//
// The B tiles: a thread's logit pair p = 2j + h sits at rows 16w + lane/4 +
// 8h (w its warp) and columns 8j + 2(lane%4) and the next; over the
// warpgroup that is 32 rows x one k-step of 8 columns, one 1 KB block of
// 8-row core matrices (no swizzle; 256 bytes from one 8-row group to the
// next, 128 from one 4-column half to the other). The blocks are [k-step
// j][tile][h], tiles P hi, P lo, dS hi, dS lo (dQ: dS hi, dS lo): each
// tile's two halves of a k-step are the B of one m64n64k8, and a rank's run
// of k-steps is one contiguous bulk copy. The partial slots keep that
// layout: warpgroup 0 scatters its 4 x 4 logits of S to the places of the
// accumulator layout.
//
// Shared memory at R = 4 (dK/dV): 64 KB resident (two 64-row slices), 64 KB
// of stages, 32 KB of split buffer, 32 KB of B tiles, 28 KB of partial
// slots and outbox = 226,856 bytes with the barriers and the alignment (R =
// 3, whose ranks own 2, 1 and 1 k-steps: 230,952); dQ 16 KB less. At R =
// 6-8 the slots and an outbox would take 36-44 KB (235,048 bytes and more),
// so from R = 5 each outbox run sits in the B tiles, in its owner's k-steps
// (Split): the slots take 2R pairs of 2 KB, 218,664-230,952 bytes for R =
// 5-8. One CTA an SM. No atomics; each output element is written once, by one thread:
// two runs give the same bits. One kernel template serves both: DKV picks
// the roles of the operands, lse and delta by column (dK/dV) or by row
// (dQ), and the outputs.
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

constexpr int SLICE = 128;                 // channels of one CTA of the cluster
constexpr int ROWS = 64;                   // the cluster's keys (dK/dV) or queries (dQ)
constexpr int TILE = 32;                   // streamed rows a tile
constexpr int WG = 128;                    // threads of a warpgroup
constexpr int THREADS = 2 * WG;
constexpr int STAGES = 2;
constexpr int RES_BOX = ROWS * 128;        // a resident TMA box: 64 rows x 32 channels fp32
constexpr int RESIDENT = 4 * RES_BOX;      // a resident 64-row slice of 128 channels
constexpr int STR_BOX = TILE * 128;        // a streamed box: 32 rows x 32 channels
constexpr int STREAMED = 4 * STR_BOX;      // a streamed 32-row slice
constexpr int PAIRS = TILE / 4;            // a thread's 16 partial logits, in pairs
constexpr int KSTEPS = TILE / 8;           // k-steps of the products: two pairs each
constexpr int BLOCK = 1024;                // a B tile's block of one pair
constexpr int DP_PARTS = 4;                // dP's fresh accumulators, 32 channels each
static_assert(DP_PARTS == 4, "partial_dp adds its parts as (d0 + d1) + (d2 + d3)");
constexpr int DP_BUFS = 3;                 // dP's groups of A registers, loaded ahead

// The k-steps of a tile's logits, and so their pairs 2j and 2j + 1, belong
// to rank floor(j R / KSTEPS): ranks own contiguous runs [first(r),
// first(r + 1)); from R = 5 up some ranks own none. A CTA's partial slots
// are compact: its own R runs of its pairs ([rank][pair][thread] float4),
// then, up to R = 4, its outbox, a run for every other rank in rank order.
// From R = 5 the outbox runs sit in the B tiles instead, each in the k-steps
// of its owner (a run of partials, 4 KB a k-step, fits the k-step's 8 KB, or
// dQ's 4 KB, of B tiles): the owner's gather writes there only once the run
// has reached it, and the products of the tile before have read them
// (push_partials). The slots then take at most 2R pairs, 32 KB at R = 8,
// where slots and outbox would take 44 KB.
template <int R>
struct Split {
  static constexpr bool OUTBOX_IN_BT = R > 4;
  __host__ __device__ static constexpr int first(int r) { return (KSTEPS * r + R - 1) / R; }
  __host__ __device__ static constexpr int pairs(int r) { return 2 * (first(r + 1) - first(r)); }
  // float4s before rank o's run in the outbox of rank `rank` (up to R = 4)
  __device__ static int outbox_at(int o, int rank) {
    int at = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < o && r != rank) at += pairs(r);
    return at * WG;
  }
  // the largest slots region of any rank, bytes
  static constexpr int bytes() {
    int most = 0;
    for (int r = 0; r < R; ++r) {
      const int b = (OUTBOX_IN_BT ? R * pairs(r) : (R - 1) * pairs(r) + PAIRS) * WG * 16;
      most = b > most ? b : most;
    }
    return most;
  }
};

// Byte offsets into the 1024-aligned dynamic shared memory.
template <int R, bool DKV>
struct Layout {
  using X = Split<R>;
  static constexpr int NB = DKV ? 4 : 2;                     // B tiles: P hi, lo, dS hi, lo
  static constexpr int KSTEP_BYTES = NB * 2 * BLOCK;         // [tile][half][block]
  static constexpr int RES = 0;                              // two resident slices
  static constexpr int RING = RES + 2 * RESIDENT;            // STAGES x two streamed slices
  static constexpr int SPLIT = RING + STAGES * 2 * STREAMED; // hi, lo of the second streamed slice
  static constexpr int BT = SPLIT + 2 * STREAMED;            // [k-step][tile][half] blocks
  static constexpr int SLOTS = BT + KSTEPS * KSTEP_BYTES;    // partial slots and outbox
  static constexpr int VEC = SLOTS + X::bytes();             // DKV: [stage][lse, delta][TILE]
  static constexpr int BARS = VEC + (DKV ? STAGES * 2 * TILE : 2 * ROWS) * 4;
  static constexpr int NBARS = STAGES + 3;                   // full[], res, slots, gather
  static constexpr int BYTES = BARS + NBARS * 8 + 1024;      // + the alignment pad
  static_assert(BYTES <= 227 * 1024, "too much shared memory for a CTA");
};

// Keeps the compiler from hoisting what derives from x out of a loop: the
// tile loop recomputes its addresses rather than hold them in registers.
__device__ __forceinline__ int launder(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Finite x rounded to tf32 to nearest, ties away from zero, as fp32 bits:
// cvt.rna.tf32.f32's rounding as two integer operations (half of tf32's
// last place added to the magnitude's bits, then the 13 bits tf32 drops
// cleared), which issue at the full integer rate where the conversion does
// not.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// hi and lo of fp32 x as tf32 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(float4 x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

// Element (row, ch) of a slice of 128-byte swizzled boxes of 32 channels,
// `box` bytes a box: chunk c of a row at c ^ (row % 8).
__device__ __forceinline__ int swizzled(int row, int ch, int box) {
  return (ch >> 5) * box + row * 128 + ((((ch & 31) >> 2) ^ (row & 7)) << 4) + (ch & 3) * 4;
}

// Component e of v (e a constant after unrolling).
__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Step 2, warpgroup 0: this CTA's partial S^T (or S) by FFMA, a (64 rows,
// resident) times b^T (32 rows, streamed, fp32) over the slice's 128
// channels: logit (rg + 16 i, c8 + 8 j) in s[4 i + j], one chain of the
// channels in order each (plain's order). The chunk of 4 channels a step
// sits at chunk ^ (row % 8) of each row, and row % 8 is rg % 8 for all four
// a rows and c8 for all four b rows, so each step's addresses are two XORs;
// a warp's 4 a rows and 8 b rows fall on distinct chunks, so each float4
// load takes one wavefront. The 16 chains advance one channel at a time,
// 16 independent FMAs apart.
__device__ __forceinline__ void partial_s(float (&s)[16], const uint8_t* a, const uint8_t* b,
                                          int wt) {
  const int rg = launder(wt / 8), c8 = wt % 8;
  const uint8_t* ra = a + rg * 128;  // row rg + 16 i at + 16 i rows
  const uint8_t* rb = b + c8 * 128;  // row c8 + 8 j at + 8 j rows
  const int xa = (rg % 8) << 4, xb = c8 << 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
#pragma unroll 1
  for (int box = 0; box < SLICE / 32; ++box) {
#pragma unroll
    for (int chunk = 0; chunk < 8; ++chunk) {
      const uint8_t* pa = ra + box * RES_BOX + ((chunk << 4) ^ xa);
      const uint8_t* pb = rb + box * STR_BOX + ((chunk << 4) ^ xb);
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(pa + 16 * 128 * i);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(pb + 8 * 128 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[4 * i + j] = fmaf(lane(av[i], e), lane(bv[j], e), s[4 * i + j]);
    }
  }
}

// Step 2, warpgroup 1: this CTA's partial dP^T (or dP), a (64 rows,
// resident) times b^T (32 rows, streamed, split into hi and lo tiles) over
// the slice's 128 channels, in DP_PARTS fresh accumulators of 32 channels
// added at the end. A comes from registers, split as it is loaded, in
// groups of two k-steps, DP_BUFS - 1 groups ahead of their wgmmas: beside
// S's stream of shared-memory loads a load waits longer than one group's
// wgmmas take.
__device__ __forceinline__ void partial_dp(float (&d)[16], const uint8_t* a,
                                           const uint8_t* b_hi, const uint8_t* b_lo, int wt) {
  constexpr int GROUPS = SLICE / 16;
  // this thread's rows 16 warp + lane/4 (+ 8), whose row % 8 is lane/4, and
  // columns lane % 4 (+ 4) of each k-step
  const int gid = launder((wt % 32) / 4);
  const uint8_t* at = a + (16 * (wt / 32) + gid) * 128 + (wt % 4) * 4;
  uint32_t frag[DP_BUFS][2][8];  // [group % DP_BUFS][k-step][hi 0-3, lo 4-7]
  auto load = [&](int grp) {
    uint32_t(&f)[2][8] = frag[grp % DP_BUFS];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int kk = 2 * grp + s;  // channels 8 kk .. 8 kk + 7
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a[e]: row + 8 (e & 1), channel + 4 (e >> 1): chunk 2 (kk % 4) + (e >> 1)
        const int chunk = 2 * (kk % 4) + (e >> 1);
        const float x = *reinterpret_cast<const float*>(
            at + (kk / 4) * RES_BOX + (e & 1) * 1024 + ((chunk ^ gid) << 4));
        split_tf32(x, f[s][e], f[s][4 + e]);
      }
    }
  };
  float part[DP_PARTS][16];
#pragma unroll
  for (int q = 0; q < DP_PARTS; ++q) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part[q][i] = 0.f;
    fence_regs(part[q]);  // zeroed here, not between a fence and its wgmma
  }
#pragma unroll
  for (int grp = 0; grp < DP_BUFS - 1; ++grp) load(grp);
#pragma unroll
  for (int grp = 0; grp < GROUPS; ++grp) {
    uint32_t(&f)[2][8] = frag[grp % DP_BUFS];
    float(&acc)[16] = part[grp / (GROUPS / DP_PARTS)];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int kk = 2 * grp + s;
      const uint32_t hi[4] = {f[s][0], f[s][1], f[s][2], f[s][3]};
      const uint32_t lo[4] = {f[s][4], f[s][5], f[s][6], f[s][7]};
      const uint64_t bh = make_desc(b_hi + (kk / 4) * STR_BOX, 128) + 2 * (kk % 4);
      const uint64_t bl = make_desc(b_lo + (kk / 4) * STR_BOX, 128) + 2 * (kk % 4);
      wgmma_tf32_rs_m64n32k8(acc, lo, bh);
      wgmma_tf32_rs_m64n32k8(acc, hi, bl);
      wgmma_tf32_rs_m64n32k8(acc, hi, bh);
    }
    wgmma_commit();
    if (grp + DP_BUFS - 1 < GROUPS) {
      // group grp - 1's registers are free once it is done: they take
      // group grp + DP_BUFS - 1
      if (grp > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int s = 0; s < 2; ++s) fence_regs(frag[(grp + DP_BUFS - 1) % DP_BUFS][s]);
      }
      load(grp + DP_BUFS - 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < DP_BUFS; ++b)
#pragma unroll
    for (int s = 0; s < 2; ++s) fence_regs(frag[b][s]);
#pragma unroll
  for (int q = 0; q < DP_PARTS; ++q) fence_regs(part[q]);
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = (part[0][i] + part[1][i]) + (part[2][i] + part[3][i]);
}

// Step 3, first half: this thread's partials into this CTA's own slot (the
// pairs it owns) or the outbox run of their owner, float4 (S pair, dP
// pair) at [pair][accumulator thread]: warpgroup 1's dP pairs as its
// accumulator holds them, warpgroup 0's 4 x 4 logits of S scattered to the
// places of the accumulator layout (x holds either); once every thread has
// written, lane 0 of warp o sends the run of rank o to its slot for this
// rank in one bulk copy, counted by the owner's slots barrier (a rank that
// owns no pair gets none). From R = 5 the outbox runs sit in the B tiles
// (Split), once both warpgroups' products of the tile before are done.
template <int R, int KSTEP_BYTES>
__device__ __forceinline__ void push_partials(const float (&x)[16], float2* slots, uint8_t* bt,
                                              uint64_t* slots_full, int rank, int tid) {
  using X = Split<R>;
  const int g = tid / WG, wt = tid % WG;
  const int mine = X::pairs(rank);
  float2* outbox = slots + R * mine * WG * 2;
  // the outbox run of rank o
  auto run = [&](int o) {
    if constexpr (X::OUTBOX_IN_BT)
      return reinterpret_cast<float2*>(bt + X::first(o) * KSTEP_BYTES);
    else
      return outbox + X::outbox_at(o, rank) * 2;
  };
  if constexpr (X::OUTBOX_IN_BT) __syncthreads();
#pragma unroll
  for (int o = 0; o < R; ++o) {
    float2* dst = o == rank ? slots + rank * mine * WG * 2 : run(o);
    if (g == 1) {
#pragma unroll
      for (int p = 2 * X::first(o); p < 2 * X::first(o + 1); ++p)
        dst[((p - 2 * X::first(o)) * WG + wt) * 2 + 1] = make_float2(x[2 * p], x[2 * p + 1]);
    } else {
      // logit (rg + 16 i, c8 + 8 j): accumulator row 16 i + rg % 8 + 8 h
      // (h = rg / 8) of warp i, column 8 j + 2 (c8 / 2) + c8 % 2, so pair
      // 2 j + h of thread 32 i + 4 (rg % 8) + c8 / 2, half c8 % 2
      const int rg = wt / 8, c8 = wt % 8;
      float* to = reinterpret_cast<float*>(dst) + 4 * (4 * (rg % 8) + c8 / 2) + c8 % 2;
#pragma unroll
      for (int j = X::first(o); j < X::first(o + 1); ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          to[4 * ((2 * (j - X::first(o)) + rg / 8) * WG + 32 * i)] = x[4 * i + j];
    }
  }
  fence_proxy_async();
  __syncthreads();
  const int o = tid / 32;  // lane 0 of warp o sends to rank o
  if (tid % 32 == 0 && o < R && o != rank && X::pairs(o) > 0)
    bulk_copy_cluster(cluster_addr(slots + rank * X::pairs(o) * WG * 2, o), run(o),
                      X::pairs(o) * WG * 16, cluster_addr(slots_full, o));
}

// Step 3, second half, on the owner, by warpgroup 1 alone: once every
// rank's partials have landed, add the slots of each owned pair in rank
// order, form P and dS, split them into hi and lo at the pair's place in the
// B tiles; lane 0 of warpgroup 1's warp w then copies the owned run to the
// same place in the B tiles of ranks w, w + 4, ..., each counted by that
// rank's gather barrier (a rank that owns no pair sends none), and
// the warpgroup arrives at named barrier 3, where warpgroup 0 waits before
// its products read the owned run. vec: DKV, the tile's lse and delta by
// column; else the block's by row.
template <int R, bool DKV>
__device__ __forceinline__ void reduce_and_gather(const float4* slots, uint8_t* bt,
                                                  uint64_t* slots_full, uint64_t* gather_full,
                                                  uint32_t parity, int rank, int tid,
                                                  const float* vec, float scale) {
  using L = Layout<R, DKV>;
  using X = typename L::X;
  mbar_wait(slots_full, parity);
  const int mine = X::pairs(rank), p0 = 2 * X::first(rank), wt = tid % WG;
  for (int i = wt; i < mine * WG; i += WG) {
    const int pi = i / WG, p = p0 + pi;
    float4 a = slots[pi * WG + wt];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float4 b = slots[(r * mine + pi) * WG + wt];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const int warp = wt / 32, gid = (wt % 32) / 4, tig = wt % 4;
    float l0, l1, d0, d1;
    if (DKV) {  // columns: the tile's queries
      const int col = 8 * (p / 2) + 2 * tig;
      l0 = vec[col];
      l1 = vec[col + 1];
      d0 = vec[TILE + col];
      d1 = vec[TILE + col + 1];
    } else {  // rows: the block's queries
      const int row = 16 * warp + gid + 8 * (p & 1);
      l0 = l1 = vec[row];
      d0 = d1 = vec[ROWS + row];
    }
    // S * scale rounded before the subtraction, as the plain version
    const float p0v = expf(__fmul_rn(a.x, scale) - l0);
    const float p1v = expf(__fmul_rn(a.y, scale) - l1);
    const float ds0 = p0v * (a.z - d0) * scale, ds1 = p1v * (a.w - d1) * scale;
    // k-step p / 2, half p % 2: [k-step][tile][half] blocks
    uint8_t* at = bt + (p / 2) * L::KSTEP_BYTES + (p & 1) * BLOCK + warp * 256 +
                  (tig >> 1) * 128 + gid * 16 + (tig & 1) * 8;
    uint32_t h0, e0, h1, e1;
    if (DKV) {
      split_tf32(p0v, h0, e0);
      split_tf32(p1v, h1, e1);
      *reinterpret_cast<uint2*>(at) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(at + 2 * BLOCK) = make_uint2(e0, e1);
      at += 4 * BLOCK;
    }
    split_tf32(ds0, h0, e0);
    split_tf32(ds1, h1, e1);
    *reinterpret_cast<uint2*>(at) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(at + 2 * BLOCK) = make_uint2(e0, e1);
  }
  fence_proxy_async();
  named_barrier(2, WG);
  named_barrier_arrive(3, THREADS);
  const int run = X::first(rank) * L::KSTEP_BYTES;
#pragma unroll
  for (int i = 0; i < (R + 3) / 4; ++i) {
    const int r = wt / 32 + 4 * i;
    if (wt % 32 == 0 && mine > 0 && r < R && r != rank)
      bulk_copy_cluster(cluster_addr(bt + run, r), bt + run, mine / 2 * L::KSTEP_BYTES,
                        cluster_addr(gather_full, r));
  }
}

// Step 1, warpgroup 1: the streamed slice `st` split into hi at `split`
// and lo at `split` + STREAMED, at the same offsets (the swizzle kept).
__device__ __forceinline__ void split_slice(const uint8_t* st, uint8_t* split, int wt) {
#pragma unroll
  for (int i = 0; i < STREAMED / 16 / WG; ++i) {
    const int off = (wt + WG * i) * 16;
    float4 h, l;
    split_tf32(*reinterpret_cast<const float4*>(st + off), h, l);
    *reinterpret_cast<float4*>(split + off) = h;
    *reinterpret_cast<float4*>(split + STREAMED + off) = l;
  }
  fence_proxy_async();
  named_barrier(2, WG);
}

// Step 4, first half: the products' register A in fp32, the streamed
// slice's rows^T for channels [64 (mb0 + m), + 64), read transposed from
// its fp32 tile at `st`: a[e] is channel ch0 + 8 (e & 1), row 8j + lane % 4
// + 4 (e >> 1) of k-step j.
template <int MB>
__device__ __forceinline__ void load_frags(float (&frag)[MB][KSTEPS][4], const uint8_t* st,
                                           int mb0, int wt) {
  const int warp = wt / 32, gid = launder((wt % 32) / 4), tig = wt % 4;
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const int ch0 = 64 * (mb0 + m) + 16 * warp + gid;
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = swizzled(8 * j + tig + 4 * (e >> 1), ch0 + 8 * (e & 1), STR_BOX);
        frag[m][j][e] = *reinterpret_cast<const float*>(st + off);
      }
  }
}

// Step 4, second half: d[m] (channels [64 (mb0 + m), + 64) x the block's 64
// rows) += A (frag[m], split here into hi and lo) times the B tiles `tile`
// (hi) and `tile + 1` (lo), through fresh accumulators.
template <int MB, int KSTEP_BYTES>
__device__ __forceinline__ void products(float (&d)[MB][32], const float (&frag)[MB][KSTEPS][4],
                                         const uint8_t* bt, int tile) {
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    float fresh[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) fresh[i] = 0.f;
    fence_regs(fresh);  // zeroed here, not between the fence and its wgmma
    uint32_t split[KSTEPS][8];  // [k-step][hi 0-3, lo 4-7]
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(frag[m][j][e], split[j][e], split[j][4 + e]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) {
      const uint32_t hi[4] = {split[j][0], split[j][1], split[j][2], split[j][3]};
      const uint32_t lo[4] = {split[j][4], split[j][5], split[j][6], split[j][7]};
      const uint8_t* block = bt + j * KSTEP_BYTES + tile * 2 * BLOCK;
      const uint64_t bh = make_desc_interleave(block, 128, 256);
      const uint64_t bl = make_desc_interleave(block + 2 * BLOCK, 128, 256);
      wgmma_tf32_rs_m64n64k8(fresh, lo, bh);
      wgmma_tf32_rs_m64n64k8(fresh, hi, bl);
      wgmma_tf32_rs_m64n64k8(fresh, hi, bh);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) fence_regs(split[j]);
    fence_regs(fresh);
#pragma unroll
    for (int i = 0; i < 32; ++i) d[m][i] += fresh[i];
  }
}

// Writes d[m] transposed into out (rows of C channels, the block's first row
// at out, this CTA's first channel at c0): accumulator row (channel)
// 64 (mb0 + m) + 16 warp + lane/4 (+ 8), column 8j + 2 (lane % 4) (+ 1),
// which is block row 16 (j % 4) + 2 (lane % 4) (+ 1) + 8 (j / 4).
template <int C, int MB>
__device__ __forceinline__ void store_transposed(float* out, const float (&d)[MB][32], int mb0,
                                                 int wt) {
  const int warp = wt / 32, gid = (wt % 32) / 4, tig = wt % 4;
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = 64 * (mb0 + m) + 16 * warp + gid + 8 * (e >> 1);
        const int row = 16 * (j % 4) + 2 * tig + (e & 1) + 8 * (j / 4);
        out[static_cast<size_t>(row) * C + ch] = d[m][4 * j + e];
      }
}

// DKV: dK (out1), dV (out2) for the 64 keys blockIdx.y of batch blockIdx.z:
// resident K, V (res0, res1), streamed Q, dO (str0, str1) with the tile's
// lse and delta by TMA. Else dQ (out1; out2 unused) for the 64 queries
// blockIdx.y: resident Q, dO, streamed K, V, the block's lse and delta read
// once. Operand maps: (B, N, C) fp32 in boxes of 32 channels x 64 rows
// (resident) or 32 rows (streamed), 128-byte swizzled; lse and delta (B, Nq)
// fp32. The resident operands hold n_res rows (Nk keys for dK/dV, Nq
// queries for dQ) and the streamed n_str (the other count): under a spatial
// group Nq = N / S (ops/spatial_conv.py); at Nq == Nk nothing else differs.
// Grid (R, n_res / 64, B) in clusters of (R, 1, 1).
template <int C, bool DKV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap res0map,
                         const __grid_constant__ CUtensorMap res1map,
                         const __grid_constant__ CUtensorMap str0map,
                         const __grid_constant__ CUtensorMap str1map,
                         const __grid_constant__ CUtensorMap lsemap,
                         const __grid_constant__ CUtensorMap deltamap,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ out1, float* __restrict__ out2, int n_res,
                         int n_str, float scale) {
  constexpr int R = C / SLICE;
  using L = Layout<R, DKV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = tid / WG, wt = tid % WG;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int r0 = blockIdx.y * ROWS, b = blockIdx.z, c0 = rank * SLICE, nt = n_str / TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* res_full = full + STAGES;
  uint64_t* slots_full = res_full + 1;
  uint64_t* gather_full = res_full + 2;
  uint8_t* split = smem + L::SPLIT;
  uint8_t* bt = smem + L::BT;
  auto stage = [&](int t) { return smem + L::RING + (t % STAGES) * 2 * STREAMED; };
  auto vec = [&](int t) {
    return reinterpret_cast<float*>(smem + L::VEC) + (DKV ? (t % STAGES) * 2 * TILE : 0);
  };

  // part w of tile t's loads (w = 0..7, one a warp on a refill): box w % 4
  // of streamed operand w / 4; part 0 also arms the barrier, part 7 brings
  // the row vectors (dK/dV)
  auto issue = [&](int t, int w) {
    uint64_t* bar = &full[t % STAGES];
    if (w == 0) mbar_arrive_expect_tx(bar, 2 * STREAMED + (DKV ? 2 * TILE * 4 : 0));
    tma_load_3d(stage(t) + (w / 4) * STREAMED + (w % 4) * STR_BOX, w < 4 ? &str0map : &str1map,
                bar, c0 + 32 * (w % 4), t * TILE, b);
    if (DKV && w == 7) {
      tma_load_2d(vec(t), &lsemap, bar, t * TILE, b);
      tma_load_2d(vec(t) + TILE, &deltamap, bar, t * TILE, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(res_full, 1);
    // one arrival each, thread 0's expect_tx of the tile's bytes (arm below)
    mbar_init(slots_full, 1);
    mbar_init(gather_full, 1);
    mbar_init_fence();
  }
  if (!DKV && tid < ROWS) {
    const size_t row = static_cast<size_t>(b) * n_res + r0 + tid;
    vec(0)[tid] = lse[row];
    vec(0)[ROWS + tid] = delta[row];
  }
  // every CTA's barriers are initialised before any CTA of the cluster
  // sends to them
  cg::this_cluster().sync();
  if (tid == 0) {
    mbar_arrive_expect_tx(res_full, 2 * RESIDENT);
    for (int box = 0; box < 4; ++box) {
      tma_load_3d(smem + L::RES + box * RES_BOX, &res0map, res_full, c0 + 32 * box, r0, b);
      tma_load_3d(smem + L::RES + RESIDENT + box * RES_BOX, &res1map, res_full, c0 + 32 * box,
                  r0, b);
    }
  }
  if (lane == 0)
    for (int t = 0; t < STAGES && t < nt; ++t) issue(t, warp);

  // DKV: warpgroup 0 sums dK^T, 1 dV^T, both 128 channels; dQ: warpgroup g
  // sums dQ^T over channels [64g, 64g + 64)
  constexpr int MB = DKV ? 2 : 1;
  const int mb0 = DKV ? 0 : g;
  const int op = DKV ? g : 0;                  // the streamed operand of the products
  const int tile = DKV ? (g == 0 ? 2 : 0) : 0;  // their B tiles: dS, or P
  float acc[MB][32];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  mbar_wait(res_full, 0);
  // tile t's partial logits into x: warpgroup 0 S by FFMA (x[4 i + j]);
  // warpgroup 1 splits the tile's second streamed slice (split_next), then
  // forms dP on wgmma (its accumulator's layout)
  float x[16];
  auto split_next = [&](int t) {
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    split_slice(stage(t) + STREAMED, split, wt);
  };
  if (g == 0) {
    mbar_wait(&full[0], 0);
    partial_s(x, smem + L::RES, stage(0), wt);
  } else {
    split_next(0);
    partial_dp(x, smem + L::RES + RESIDENT, split, split + STREAMED, wt);
  }

  for (int t = 0; t < nt; ++t) {
    // ---- step 3: the products' A of tile t into registers, tile t's
    // partials pushed to their owners (after tile t - 1's products: the B
    // tiles are free; the push's barrier also frees stage t for tile t + 2,
    // but for the tile's lse and delta, which warp 7 refills once they are
    // read) ----
    float frag[MB][KSTEPS][4];
    load_frags<MB>(frag, stage(t) + op * STREAMED, mb0, wt);
    push_partials<R, L::KSTEP_BYTES>(x, reinterpret_cast<float2*>(smem + L::SLOTS), bt,
                                     slots_full, rank, tid);
    // then arm tile t's exchange barriers: the other ranks' partials of this
    // rank's pairs, and the other owners' runs of the B tiles. Armed only
    // once push_partials' barrier has seen every thread past tile t - 1's
    // waits: at R = 1 both expect no byte, so arming completes the phase at
    // once, and a phase completed before a lagging warpgroup's wait of the
    // one before would leave it waiting on the parity forever. No byte of
    // tile t can come before this CTA's partials have left, and bytes that
    // come before the arming count toward the phase it leaves pending.
    if (tid == 0) {
      const int own = L::X::pairs(rank);
      mbar_arrive_expect_tx(slots_full, (R - 1) * own * WG * 16);
      mbar_arrive_expect_tx(gather_full, (PAIRS - own) / 2 * L::KSTEP_BYTES);
    }
    const bool refill = lane == 0 && t + STAGES < nt;
    if (refill && warp != 7) issue(t + STAGES, warp);

    // ---- warpgroup 0 forms tile t + 1's S; warpgroup 1 splits tile t + 1
    // while the partials travel, adds the owned pairs in rank order and
    // gathers P and dS, and forms tile t + 1's dP while the gather travels;
    // then each takes tile t's products into fresh accumulators, then the
    // sums ----
    if (g == 0) {
      if (t + 1 < nt) {
        mbar_wait(&full[(t + 1) % STAGES], ((t + 1) / STAGES) & 1);
        partial_s(x, smem + L::RES, stage(t + 1), wt);
      }
      mbar_wait(gather_full, t & 1);
      named_barrier(3, THREADS);  // this CTA's own run of the B tiles is written
    } else {
      if (t + 1 < nt) split_next(t + 1);
      reduce_and_gather<R, DKV>(reinterpret_cast<const float4*>(smem + L::SLOTS), bt,
                                slots_full, gather_full, t & 1, rank, tid, vec(t), scale);
      if (refill && warp == 7) issue(t + STAGES, warp);
      if (t + 1 < nt) partial_dp(x, smem + L::RES + RESIDENT, split, split + STREAMED, wt);
      mbar_wait(gather_full, t & 1);
    }
    products<MB, L::KSTEP_BYTES>(acc, frag, bt, tile);
  }

  const size_t out = (static_cast<size_t>(b) * n_res + r0) * C + c0;
  store_transposed<C, MB>((DKV && g == 1 ? out2 : out1) + out, acc, mb0, wt);
  // no CTA leaves while another may still reach its shared memory
  cg::this_cluster().sync();
}

// A (b, n, C) fp32 operand in boxes of 32 channels x `rows` rows, 128-byte
// swizzled; a (b, n) fp32 row vector in boxes of TILE.
template <int C>
cudaError_t operand_map(CUtensorMap* map, const void* base, int b, int n, int rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(n),
                            static_cast<uint64_t>(b)};
  const uint64_t strides[2] = {4ull * C, 4ull * C * n};
  const uint32_t box[3] = {32, static_cast<uint32_t>(rows), 1};
  return make_tensor_map(map, base, 3, dims, strides, box, 128, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

cudaError_t rowvec_map(CUtensorMap* map, const void* base, int b, int n) {
  const uint64_t dims[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(b)};
  const uint64_t strides[1] = {4ull * n};
  const uint32_t box[2] = {TILE, 1};
  return make_tensor_map(map, base, 2, dims, strides, box, 0, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The launch over grid (R, n_res / 64, b) in clusters of R CTAs, with the
// shared memory; the SM's whole carveout goes to shared memory.
template <int C, bool DKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* out1, void* out2, int b, int nq,
                   int nk, float scale, cudaStream_t stream) {
  // dK/dV: K, V resident (nk rows) and Q, dO streamed (nq); dQ: Q, dO
  // resident and K, V streamed
  const int n_res = DKV ? nk : nq, n_str = DKV ? nq : nk;
  CUtensorMap res0, res1, str0, str1, lsemap, deltamap;
  cudaError_t err = operand_map<C>(&res0, DKV ? k : q, b, n_res, ROWS);
  if (err == cudaSuccess) err = operand_map<C>(&res1, DKV ? v : dout, b, n_res, ROWS);
  if (err == cudaSuccess) err = operand_map<C>(&str0, DKV ? q : k, b, n_str, TILE);
  if (err == cudaSuccess) err = operand_map<C>(&str1, DKV ? dout : v, b, n_str, TILE);
  if (err == cudaSuccess) err = rowvec_map(&lsemap, lse, b, nq);
  if (err == cudaSuccess) err = rowvec_map(&deltamap, delta, b, nq);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_f32_kernel<C, DKV>;
  constexpr int bytes = Layout<C / SLICE, DKV>::BYTES;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C / SLICE, n_res / ROWS, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C / SLICE;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, res0, res1, str0, str1, lsemap, deltamap,
                           static_cast<const float*>(lse), static_cast<const float*>(delta),
                           static_cast<float*>(out1), static_cast<float*>(out2), n_res, n_str,
                           scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool DKV>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* out1, void* out2, int b, int nq, int nk, int c,
             float scale, void* stream) {
  // 1 <= b <= 65535 (grid z), nq and nk positive multiples of 128 with
  // nq / 64 and nk / 64 blocks within grid y
  if (b < 1 || b > 65535 || nq < 128 || nq % 128 != 0 || nq / ROWS > 65535 || nk < 128 ||
      nk % 128 != 0 || nk / ROWS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch<128, DKV>(q, k, v, dout, lse, delta, out1, out2, b, nq, nk, scale, s));
    case 256: return static_cast<int>(launch<256, DKV>(q, k, v, dout, lse, delta, out1, out2, b, nq, nk, scale, s));
    case 384: return static_cast<int>(launch<384, DKV>(q, k, v, dout, lse, delta, out1, out2, b, nq, nk, scale, s));
    case 512: return static_cast<int>(launch<512, DKV>(q, k, v, dout, lse, delta, out1, out2, b, nq, nk, scale, s));
    case 640: return static_cast<int>(launch<640, DKV>(q, k, v, dout, lse, delta, out1, out2, b, nq, nk, scale, s));
    case 768: return static_cast<int>(launch<768, DKV>(q, k, v, dout, lse, delta, out1, out2, b, nq, nk, scale, s));
    case 896: return static_cast<int>(launch<896, DKV>(q, k, v, dout, lse, delta, out1, out2, b, nq, nk, scale, s));
    case 1024: return static_cast<int>(launch<1024, DKV>(q, k, v, dout, lse, delta, out1, out2, b, nq, nk, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool DKV>
int smem_bytes(int c) {
  switch (c) {
    case 128: return Layout<1, DKV>::BYTES;
    case 256: return Layout<2, DKV>::BYTES;
    case 384: return Layout<3, DKV>::BYTES;
    case 512: return Layout<4, DKV>::BYTES;
    case 640: return Layout<5, DKV>::BYTES;
    case 768: return Layout<6, DKV>::BYTES;
    case 896: return Layout<7, DKV>::BYTES;
    case 1024: return Layout<8, DKV>::BYTES;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q, dout: contiguous (b, nq, c) fp32; k, v, dk, dv: contiguous (b, nk, c)
// fp32; lse, delta: contiguous (b, nq) fp32; all 16-byte aligned, on the
// current device. nq and nk must be multiples of 128 and c a multiple of 128
// up to 1024.
int vcd_flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int b, int nq, int nk, int c,
                                    float scale, void* stream) {
  return dispatch<true>(q, k, v, dout, lse, delta, dk, dv, b, nq, nk, c, scale, stream);
}

// The same operands; writes dq, contiguous (b, nq, c) fp32.
int vcd_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int b, int nq, int nk, int c, float scale,
                                   void* stream) {
  return dispatch<false>(q, k, v, dout, lse, delta, dq, nullptr, b, nq, nk, c, scale, stream);
}

// The dynamic shared memory a CTA of the dK/dV (dkv != 0) or dQ kernel takes
// at width c, in bytes; -1 for a width it does not take.
int vcd_flash_attention_bwd_f32_smem(int c, int dkv) {
  return dkv ? smem_bytes<true>(c) : smem_bytes<false>(c);
}

const char* vcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
