// Flash-attention forward for the VAE mid block, hand-written for Hopper (sm_90a).
//
// Replaces vae_channel_dynamics_tpu/ops/pallas_attention.py::_flash_kernel,
// both its serving variant and its training variant (with_lse=True). Same
// function:
//   S = Q K^T * scale, accumulated in fp32;
//   online softmax with fp32 running max m and denominator l;
//   P = exp(S - m) cast to bf16 before the P V product (fp32 accumulation);
//   O = acc / l, written in bf16;
//   training only: lse = m + log(l) per query row, fp32 (B, Nq), which the
//   backward kernels (flash_attention_bwd.cu) rebuild P from.
// Q holds Nq rows and K, V Nk, as in the JAX kernel: under a spatial group
// of S ranks (ops/spatial_conv.py) each rank's queries are its Nq = N / S
// rows of the image and its keys all N. Nq sets the grid, Nk the key loop
// and the K/V tensor maps; at Nq == Nk nothing else differs.
// The LSE output is a null-or-not pointer, not a template flag: the row's
// final m and l already sit in the softmax threads' registers, so it costs
// one uniform branch and one store per row at the end, and the serving
// entry point (lse = nullptr) runs the same instantiations.
//
// What bounds it on the H100: at C = 512 the kernel does 4*B*N^2*C FLOPs
// against 8*B*N*C bytes of q/k/v/o in device memory, N/2 FLOPs a byte, far
// above the card's ~295: tensor-core bound, 0.5559 ms at (1, 16384, 512).
// What stands in the way is the head, 512 wide: O for 64 query rows is
// 64 x 512 fp32, half the register file, so a CTA holds 64 query rows, and
// every CTA brings all of its batch element's K and V into its SM from L2,
// 128 KB a 64-key tile for 8.4 MFLOP of products (8.6 GB a call at (1,
// 16384, 512)). Measured on the H100, that stream is the bound: about 28
// bytes a clock an SM, whether 32 or 132 SMs run, so the SM's intake, not
// L2 (chip_smoke.py logs the times).
//
// The bf16 kernel (flash_fwd_kernel<C>, wgmma and TMA on
// sm90_wgmma.cuh). A CTA owns 64 query rows of one batch element.
//   * A producer warpgroup gives up its registers (setmaxnreg, 40 a thread)
//     so that two consumer warpgroups get 232: consumer g owns half of the
//     channels, H = C/2, of S's sum and of O (H/2 fp32 accumulators a
//     thread, 128 at C = 512, as 64-channel chunks). The producer's thread 0
//     keeps the ring full in stream order, waiting on each stage's `empty`
//     barrier; the consumers never wait for it beyond the loads themselves.
//   * Q stays resident (C/64 boxes of 64 rows x 64 channels, 128-byte
//     swizzled, the K-major A of Q K^T).
//   * K and V stream through a ring of 16 KB stages, a unit a stage: one
//     64-key x 64-channel box of each half, one TMA load of a 4-D view
//     (H channels, n rows, 2 halves, b). Per 64-key tile, H/64 units of K
//     and H/64 of V, in the order the consumers read them: K_0, then K_t and
//     V_(t-1) for t = 1 .. nt - 1, then V_(nt-1).
//   * S: each consumer forms its partial S over its half (wgmma m64n64k16,
//     both operands from shared memory, H/16 k-steps: a short accumulation,
//     as the tensor cores truncate fp32 sums), writes it and adds the
//     other's: S_0 + S_1 in one warpgroup and S_1 + S_0 in the other, the
//     same bits (fp32 addition commutes), so both hold the same S, m, l and
//     P. From C = 256 the partials go into the tile's own K stages, whose
//     wgmma reads are done and which the ring hands out again only once
//     every warp has released them; at C = 128 into two slots of their
//     own. Named barrier 1 orders the writes before the reads; at C = 128,
//     2 and 3 keep a slot from being written again before it is read.
//   * The softmax works in base 2: S scale log2(e), ex2.approx on the SFU,
//     lse = m ln 2 + log(l).
//   * P (bf16) goes to P V as the register A, straight from S's accumulator
//     layout (pair p of a thread's S, columns 8(p/2) + 2(lane%4) and the
//     next, is A-fragment register p % 4 of k-step p / 4), and V's box is
//     the MN-major B (m64n64k16 per 64-channel chunk), straight from the
//     ring: P and V^T never pass through shared memory.
//   * Tile t: Q K_t^T, the exchange (K_t released), then P V of tile t - 1
//     on the tensor cores while the CUDA cores take tile t's softmax; O is
//     rescaled once P V is done (V_(t-1) released). A tile holds at most
//     one tile's K or V in the ring, so the producer runs STAGES - NCH
//     units ahead (4 at C = 512).
// O stays in its wgmma accumulators across the key tiles; their truncated
// fp32 sums drift by about 2^-23 a k-step, far inside the bf16 output's
// bounds (tests/test_torch_flash_kernel_cuda.py). Grid (N/64, B). The ring
// has 8 stages at every width: at C = 512 ten would fit, and measured a
// little slower than eight on the H100 (a power of two keeps the stage
// index a mask). Shared memory at C = 512: 64 KB (Q) + 8 stages x 16 KB,
// 197,768 bytes with the barriers and the alignment.
//
// The fp32 forward (flash_fwd_f32_kernel) replaces the same TPU kernel run
// in fp32 at Precision.HIGHEST, serving and training alike: fp32 q/k/v in,
// fp32 out, P kept in fp32 before the P V product, and the same null-or-not
// lse pointer as the bf16 kernel's (lse = m + log(l), m and l in natural
// units here: fp32 training's LSE forward, one store a row). TF32 keeps 10 mantissa bits, too few alone,
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
// Heads wider than 512 channels (C = 640 .. 1024, FwdSplit), both kernels.
// O for 64 rows of a 1024-channel head is 256 fp32 a consumer thread, past
// the register file, and 1024 channels of resident Q and a ring that holds
// a tile's K and V would not fit a CTA's shared memory. So the channels are
// split again, over a thread-block cluster of R = 2 CTAs that share one
// block of 64 query rows: rank r owns the slice [r CS, (r + 1) CS) of Q, K,
// V and O, CS = 128 ceil(C / 256), and each CTA runs the kernel above at
// width CS (its two warpgroups half the slice each: the C = 384 kernel at
// 640 and 768, the C = 512 one at 896 and 1024). Why two slices of up to
// 512, and not one per 128 channels as the backward: O's accumulators are
// what bounds the forward, and two CTAs are the fewest that hold them, so
// each CTA keeps the products of the narrower kernel, and the cluster adds
// only one exchange of S a tile. At 640 and 896 rank 1's slice ends 128
// channels past C: its Q, K and V boxes there are zero-filled by TMA (they
// add exact zeros to S) and its O is not stored, 20% and 14% more
// products than the head needs, against a second instantiation for an
// uneven split. Per tile, each CTA sums its warpgroups' partials as above
// (S_r = S_r0 + S_r1, the same bits in both warpgroups), writes S_r into a
// slot of the other CTA by remote stores to distributed shared memory
// (st.shared::cluster, two slots by tile parity, an mbarrier each way:
// xfull counts the writer's 256 stores, xempty the reader's 256 reads),
// and adds the other's: S = S_0 + S_1 in rank 0 and S_1 + S_0 in rank 1,
// the same bits (fp32 addition commutes), so both CTAs hold the same S, m,
// l and P and each scales its own slice of O. The bf16 kernel issues the
// previous tile's P V before it waits for the other CTA's partial. Each CTA
// loads only its slice of K and V (the 3-D view (C, n, b), two 64 x 64
// boxes a unit), so the SM intake a 64-key tile is 96 KB at 640 and 768 and
// 128 KB at 896 and 1024, the C = 512 kernel's, for the same products a
// CTA. Only rank 0 writes lse. Shared memory: the slice's kernel's, plus
// the two 16 KB slots (214,272 and 230,656 bytes bf16, 230,656 fp32). The
// 3xTF32 kernel keeps its fresh accumulators within each warpgroup as
// above; the cluster's sum is one fp32 add. No atomics: two runs give the
// same bits.
//
// Plain C interface for ctypes: pointers and the stream are void*, the
// function returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a shape it does not take). It launches on the
// caller's stream, allocates nothing and does not synchronise.


#include <cooperative_groups.h>

#include <type_traits>

#include "sm90_wgmma.cuh"

namespace {

using namespace vcd::sm90;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;                // keys per tile
constexpr float MASKED = -1e30f;      // finite stand-in for -inf, as in the TPU kernel

// The split of the channels at width C, both forwards (see the header): one
// CTA up to 512 channels, else a cluster of R = 2 CTAs, rank r owning the
// slice [r CS, (r + 1) CS) of CS = 128 ceil(C / 256) channels. At 640 and
// 896 the last 128 channels of rank 1's slice lie past C: TMA fills their
// boxes with zeros, which add nothing to S, and their O is not stored.
template <int C>
struct FwdSplit {
  static_assert(C % 128 == 0 && C <= 1024, "a multiple of 128 channels up to 1024");
  static constexpr int R = C <= 512 ? 1 : 2;
  static constexpr int CS = R == 1 ? C : (C + 255) / 256 * 128;
};

constexpr int XCH = 64 * 64 * 4;      // a 64 x 64 fp32 tile of S: one CTA's partial

// The cluster's exchange of S (R = 2), each CTA's partial the sum of its two
// warpgroups', the same bits in both. A CTA's shared memory holds two slots
// of XCH bytes, by tile parity, into which the other CTA writes its partial
// (remote stores, [j][thread] float4), and barriers xfull[2] (its 256
// consumer threads arrive once the stores are done) and xempty[2] (this
// CTA's 256 arrive on the other's once they have read the slot).
//
// Sends this CTA's partial s of tile t to the other CTA's slot t % 2,
// warpgroup g its float4s j = 4g .. 4g + 3, once the other CTA has read that
// slot's tile t - 2.
__device__ __forceinline__ void send_partial(const float (&s)[32], float4* xslot,
                                             uint64_t* xfull, uint64_t* xempty, int t, int g,
                                             int wt, uint32_t peer) {
  const int slot = t & 1;
  if (t >= 2) mbar_wait_cluster(&xempty[slot], ((t >> 1) - 1) & 1);
  const uint32_t dst = cluster_addr(xslot + slot * (XCH / 16), peer);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // s indexed by constants only: an index that depends on g would put s
    // in local memory
    const float4 lo = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    const float4 hi = make_float4(s[4 * i + 16], s[4 * i + 17], s[4 * i + 18], s[4 * i + 19]);
    st_cluster(dst + ((4 * g + i) * 128 + wt) * 16, g == 0 ? lo : hi);
  }
  mbar_arrive_cluster(cluster_addr(&xfull[slot], peer));
}

// S = (s + the other CTA's partial) * scale, the same bits in both CTAs (fp32
// addition commutes: rank 0 adds 0 + 1, rank 1 adds 1 + 0), once tile t's
// partial has landed in slot t % 2; then frees the slot for tile t + 2.
__device__ __forceinline__ void add_peer_partial(float (&s)[32], const float4* xslot,
                                                 uint64_t* xfull, uint64_t* xempty, int t,
                                                 int wt, uint32_t peer, float scale) {
  const int slot = t & 1;
  mbar_wait_cluster(&xfull[slot], (t >> 1) & 1);
  const float4* x = xslot + slot * (XCH / 16);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = x[j * 128 + wt];
    s[4 * j] = (s[4 * j] + v.x) * scale;
    s[4 * j + 1] = (s[4 * j + 1] + v.y) * scale;
    s[4 * j + 2] = (s[4 * j + 2] + v.z) * scale;
    s[4 * j + 3] = (s[4 * j + 3] + v.w) * scale;
  }
  mbar_arrive_cluster(cluster_addr(&xempty[slot], peer));
}

// ---------------------------------------------------------------------------
// bf16 forward: wgmma/TMA, a producer warpgroup and two consumers (see the header)
// ---------------------------------------------------------------------------
constexpr int BQ = 64;                // query rows per CTA: wgmma's M
constexpr int THREADS = 384;          // a producer warpgroup and two consumers
constexpr int CONSUMER_WARPS = 8;
// registers a thread: the producer gives up its own so that the consumers'
// accumulators (O, 128 fp32 a thread at C = 512, S and P) fit: 128 x 40 +
// 256 x 232 <= 64K
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int BOX = 64 * 128;         // 64 rows x 64 channels of bf16, 128-byte swizzled
constexpr int UNIT = 2 * BOX;         // a ring stage: one box of each warpgroup's half
constexpr int SMEM_MAX = 232448;      // the dynamic shared memory a CTA may have
constexpr int STAGES = 8;             // of the K/V ring (see the header)

template <int C>
struct Layout {
  static constexpr int R = FwdSplit<C>::R, CS = FwdSplit<C>::CS;
  static constexpr int H = CS / 2;                     // channels of a warpgroup
  static constexpr int NCH = H / 64;                   // units of K (or V) a tile
  // From two K units a tile up, the partial S are exchanged in the tile's
  // own K stages once S is formed (warpgroup g in its boxes of the first
  // two): the ring keeps the 32 KB of two slots of their own, which C = 128
  // uses.
  static constexpr bool XIN_RING = NCH >= 2;
  static constexpr int XCHG = CS * 128;                // after the CS/64 boxes of Q
  static constexpr int RING = XCHG + (XIN_RING ? 0 : 2 * XCH);
  // full[STAGES], empty[STAGES], q; a cluster's xfull[2], xempty[2]
  static constexpr int BARS = RING + STAGES * UNIT;
  static constexpr int XSLOT = BARS + 256;             // a cluster's two slots of XCH
  static constexpr int BYTES =
      (R == 1 ? BARS + (2 * STAGES + 1) * 8 : XSLOT + 2 * XCH) + 1024;  // + the alignment pad
  static_assert(H % 64 == 0 && STAGES >= 2 * NCH, "a tile's K and V units fit the ring");
  static_assert(BYTES <= SMEM_MAX, "too much shared memory");
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp; 0 below 2^-126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// O (B, N, C) bf16 = softmax(Q K^T * scale) V, and with lse non-null the
// fp32 (B, Nq) lse = m + log(l), over bf16 q (B, Nq, C) and k, v (B, Nk, C).
// Grid (R Nq / 64, B) in clusters of R (FwdSplit); a producer warpgroup and
// two consumers.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                     float* __restrict__ lse, int nq, int nk, float scale) {
  using L = Layout<C>;
  constexpr int R = L::R, CS = L::CS, H = L::H, NCH = L::NCH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + L::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  uint64_t* xfull = qbar + 1;  // R = 2 only
  uint64_t* xempty = xfull + 2;
  float4* xslot = reinterpret_cast<float4*>(smem + L::XSLOT);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int rank = 0;
  if constexpr (R > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int q0 = (blockIdx.x / R) * BQ, b = blockIdx.y, nt = nk / BK, c0 = rank * CS;
  const int units = 2 * nt * NCH;
  const float scale_log2 = scale * LOG2E;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);  // every consumer warp
    }
    mbar_init(qbar, 1);
    if constexpr (R > 1)
      for (int s = 0; s < 2; ++s) {
        mbar_init(&xfull[s], THREADS - 128);  // the other CTA's consumer threads
        mbar_init(&xempty[s], THREADS - 128);
      }
    mbar_init_fence();
  }
  // in a cluster, every CTA's barriers are initialised before the other
  // arrives on them
  if constexpr (R > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();

  if (warp < 4) {
    // ---- the producer warpgroup: its thread 0 keeps the ring full ----
    set_max_regs_dec<PRODUCER_REGS>();
    if (tid == 0) {
      mbar_arrive_expect_tx(qbar, CS * 128);
      for (int j = 0; j < CS / 64; ++j)
        tma_load_3d(smem + j * BOX, &qmap, qbar, c0 + 64 * j, q0, b);
      // Unit k of the stream: group k / NCH is K_0, then K_t and V_(t-1) for
      // t >= 1, then V_(nt-1), the order the consumers read them; chunk k %
      // NCH. A unit is one box of the 4-D view (H channels, n rows, 2
      // halves, b) of K or V: 64 channels x 64 rows x both halves (in a
      // cluster, two boxes of the 3-D view (C, n, b), one of each half of
      // the slice). Unit k goes in once every consumer warp has released
      // unit k - STAGES.
      for (int k = 0; k < units; ++k) {
        const int grp = k / NCH, chunk = k % NCH, s = k % STAGES;
        const bool is_v = grp == 2 * nt - 1 || (grp > 0 && grp % 2 == 0);
        const int tile = grp == 2 * nt - 1 ? nt - 1 : (is_v ? grp / 2 - 1 : (grp + 1) / 2);
        const CUtensorMap* map = is_v ? &vmap : &kmap;
        uint8_t* st = ring + s * UNIT;
        if (k >= STAGES) mbar_wait(&empty[s], (k / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], UNIT);
        if constexpr (R == 1)
          tma_load_4d(st, map, &full[s], chunk * 64, tile * BK, 0, b);
        else
          for (int h = 0; h < 2; ++h)
            tma_load_3d(st + h * BOX, map, &full[s], c0 + h * H + chunk * 64, tile * BK, b);
      }
    }
  } else {
    set_max_regs_inc<CONSUMER_REGS>();
    // ---- two consumer warpgroups: g owns channels [g H, (g + 1) H) of S's
    // sum and of O ----
    const int g = warp / 4 - 1, wt = tid % 128, gid = lane / 4, tig = lane % 4;
    const int row0 = (warp % 4) * 16 + gid;  // this thread's rows: row0, row0 + 8
    float oacc[NCH][32];
#pragma unroll
    for (int u = 0; u < NCH; ++u)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[u][i] = 0.f;
    float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f};  // l: this thread's columns
    uint32_t pfrag[16];  // P of the tile in P V, bf16 pairs
    int kc = 0, kr = 0;  // units consumed, units released

    // Waits until the next NCH units of the stream have landed; the first's
    // index (unit k sits in stage k % STAGES). Every wait comes before the
    // wgmma_fence of the products that read the units: a spin loop between
    // the fence and a wgmma makes ptxas serialise the wgmmas (C7520).
    auto arrived = [&]() {
      const int first = kc;
#pragma unroll
      for (int u = 0; u < NCH; ++u, ++kc) mbar_wait(&full[kc % STAGES], (kc / STAGES) & 1);
      return first;
    };
    auto stage = [&](int first, int u) { return ring + ((first + u) % STAGES) * UNIT; };

    // S_g = Q[:, half g] K_t[:, half g]^T over the K units from `first`:
    // issued and committed, not waited
    auto issue_s = [&](float (&sacc)[32], int first) {
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        const uint8_t* qb = smem + (g * NCH + u) * BOX;
        const uint8_t* kb = stage(first, u) + g * BOX;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n64k16(sacc, make_desc(qb, 128) + 2 * kk, make_desc(kb, 128) + 2 * kk,
                             u > 0 || kk > 0);
      }
      wgmma_commit();
    };

    // O_g += P V[:, half g] over the V units from `first`, 64 channels
    // each, over the tile's 64 keys: issued and committed, not waited
    auto issue_pv = [&](int first) {
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        const uint8_t* vb = stage(first, u) + g * BOX;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a[4] = {pfrag[4 * kk], pfrag[4 * kk + 1], pfrag[4 * kk + 2],
                                 pfrag[4 * kk + 3]};
          wgmma_rs_m64n64k16<1>(oacc[u], a, make_desc_mn(vb + kk * 16 * 128, BOX, 1024));
        }
      }
      wgmma_commit();
    };

    // The next NCH units have been read: release their stages (lane 0 of
    // each warp arrives).
    auto release = [&]() {
#pragma unroll
      for (int u = 0; u < NCH; ++u)
        if (lane == 0) mbar_arrive(&empty[(kr + u) % STAGES]);
      kr += NCH;
    };

    // This thread's elements 4j .. 4j + 3 of warpgroup w's partial S: in
    // the K stages of the tile (box w of the first for j < 4, of the second
    // for the rest), or in w's slot; a warp's 16-byte vectors are adjacent.
    auto slot = [&](int w, int j, int first) {
      if constexpr (L::XIN_RING)
        return reinterpret_cast<float4*>(stage(first, (j >> 2) & 1) + w * BOX) + (j & 3) * 128 +
               wt;
      else
        return reinterpret_cast<float4*>(smem + L::XCHG + w * XCH) + j * 128 + wt;
    };

    // S = S_0 + S_1 through shared memory, scaled by scale log2(e): the
    // softmax works in base 2. Both partials are written before either is
    // read (barrier 1). In the K stages, the next writes go to other stages,
    // which the ring hands out only once every warp has released them; in
    // slots of their own, a slot is written again only once the other
    // warpgroup has read it (barrier 2 + g: the reader arrives, the writer
    // waits). In a cluster, S_0 + S_1 is this CTA's partial: it is sent to
    // the other CTA, unscaled, and add_peer_partial scales the sum.
    auto exchange = [&](float (&sacc)[32], int t, int first) {
      if (!L::XIN_RING && t > 0) named_barrier(2 + g, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *slot(g, j, first) = make_float4(sacc[4 * j], sacc[4 * j + 1], sacc[4 * j + 2],
                                         sacc[4 * j + 3]);
      named_barrier(1, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = *slot(1 - g, j, first);
        if constexpr (R == 1) {
          sacc[4 * j] = (sacc[4 * j] + x.x) * scale_log2;
          sacc[4 * j + 1] = (sacc[4 * j + 1] + x.y) * scale_log2;
          sacc[4 * j + 2] = (sacc[4 * j + 2] + x.z) * scale_log2;
          sacc[4 * j + 3] = (sacc[4 * j + 3] + x.w) * scale_log2;
        } else {
          sacc[4 * j] += x.x;
          sacc[4 * j + 1] += x.y;
          sacc[4 * j + 2] += x.z;
          sacc[4 * j + 3] += x.w;
        }
      }
      if (!L::XIN_RING && t + 1 < nt) named_barrier_arrive(3 - g, 256);
      // these generic-proxy accesses come before the TMA refill of the stages
      if constexpr (L::XIN_RING) fence_proxy_async();
      if constexpr (R > 1) send_partial(sacc, xslot, xfull, xempty, t, g, wt, rank ^ 1);
    };

    // The online softmax of the tile's rows row0, row0 + 8 over its 64
    // keys, in base 2 (m is the running max of S log2(e)): P = 2^(S - m) =
    // exp(S scale - m ln 2) in place in sacc, in fp32.
    auto softmax = [&](float (&sacc)[32], float (&corr)[2]) {
      float mx[2] = {MASKED, MASKED};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        corr[r] = exp2_approx(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sacc[i] = exp2_approx(sacc[i] - m_run[(i >> 1) & 1]);
        l_run[(i >> 1) & 1] += sacc[i];
      }
    };

    // P V's A: S's accumulator layout, pair p of a thread's logits (columns
    // 8(p/2) + 2(lane%4) and the next) is A-fragment register p % 4 of
    // k-step p / 4
    auto to_frag = [&](const float (&p)[32]) {
#pragma unroll
      for (int j = 0; j < 16; ++j) pfrag[j] = pack_bf16(p[2 * j], p[2 * j + 1]);
      fence_regs(pfrag);
    };

    // Tile t: S_t, the exchange, then P V of tile t - 1 (when `pv`) beside
    // tile t's softmax, O rescaled once P V is done; P_t into pfrag. In a
    // cluster the other CTA's partial is added once P V is issued. The
    // first tile, which has no P V, is its own instantiation: a wgmma under
    // a branch makes ptxas serialise the wgmmas.
    auto step = [&](int t, auto pv) {
      float sacc[32], corr[2];
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      fence_regs(sacc);
      const int kfirst = arrived();
      wgmma_fence();
      issue_s(sacc, kfirst);
      wgmma_wait<0>();
      fence_regs(sacc);
      exchange(sacc, t, kfirst);
      release();  // K_t
      if constexpr (decltype(pv)::value) {
        const int vfirst = arrived();
        wgmma_fence();
        issue_pv(vfirst);
      }
      if constexpr (R > 1)
        add_peer_partial(sacc, xslot, xfull, xempty, t, wt, rank ^ 1, scale_log2);
      softmax(sacc, corr);
      if constexpr (decltype(pv)::value) {
        wgmma_wait<0>();
#pragma unroll
        for (int u = 0; u < NCH; ++u) fence_regs(oacc[u]);
        fence_regs(pfrag);
        release();  // V_(t-1)
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
#pragma unroll
          for (int i = 0; i < 32; ++i) oacc[u][i] *= corr[(i >> 1) & 1];
          fence_regs(oacc[u]);
        }
      }
      to_frag(sacc);
    };

    mbar_wait(qbar, 0);
    step(0, std::false_type());
    for (int t = 1; t < nt; ++t) step(t, std::true_type());
    {
      const int vfirst = arrived();
      wgmma_fence();
      issue_pv(vfirst);
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < NCH; ++u) fence_regs(oacc[u]);
      fence_regs(pfrag);
      release();
    }

    // ---- O = acc / l, bf16: this warpgroup's H columns of rows row0, row0 + 8 ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    // both warpgroups (and in a cluster both CTAs) hold the same m and l
    if (lse != nullptr && g == 0 && tig == 0 && rank == 0) {
      lse[static_cast<size_t>(b) * nq + q0 + row0] = m_run[0] * LN2 + logf(l_run[0]);
      lse[static_cast<size_t>(b) * nq + q0 + row0 + 8] = m_run[1] * LN2 + logf(l_run[1]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      bf16* orow = o + (static_cast<size_t>(b) * nq + q0 + row0 + 8 * half) * C + c0 + g * H;
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        if (R > 1 && c0 + g * H + 64 * u >= C) continue;  // a slice's padding is not stored
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * u + 8 * j + 2 * tig) =
              __floats2bfloat162_rn(oacc[u][4 * j + 2 * half] / l_run[half],
                                    oacc[u][4 * j + 2 * half + 1] / l_run[half]);
      }
    }
  }
  // no CTA of a cluster leaves while the other may still reach its shared memory
  if constexpr (R > 1) cg::this_cluster().sync();
}

// Launches `kernel` over grid (R x blocks, b) in clusters of R CTAs (R = 1:
// an ordinary launch) with `bytes` of dynamic shared memory.
template <class Kernel, class... Args>
cudaError_t launch_split(Kernel kernel, int r, int blocks, int b, int threads, int bytes,
                         cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (r == 1) {
    kernel<<<dim3(blocks, b), threads, bytes, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(r * blocks, b);
  cfg.blockDim = dim3(threads);
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int nq, int nk, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t dims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(nq),
                            static_cast<uint64_t>(b)};
  const uint64_t strides[2] = {2ull * C, 2ull * C * nq};
  const uint32_t qbox[3] = {64, BQ, 1};
  // K and V as (C/2 channels, nk rows, 2 halves, b): a unit's box lands as
  // one 64-row box of each half (see the producer); in a cluster as Q's
  // (C, nk, b), two boxes a unit
  constexpr int R = FwdSplit<C>::R;
  const uint64_t kvdims[4] = {static_cast<uint64_t>(C / 2), static_cast<uint64_t>(nk), 2,
                              static_cast<uint64_t>(b)};
  const uint64_t kvstrides[3] = {2ull * C, 1ull * C, 2ull * C * nk};
  const uint32_t kvbox[4] = {64, 64, 2, 1};
  const uint64_t kvdims3[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(nk),
                               static_cast<uint64_t>(b)};
  const uint64_t kvstrides3[2] = {2ull * C, 2ull * C * nk};
  const uint32_t kvbox3[3] = {64, BK, 1};
  cudaError_t err = make_tensor_map(&qmap, q, 3, dims, strides, qbox, 128);
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    err = R == 1 ? make_tensor_map(i ? &vmap : &kmap, i ? v : k, 4, kvdims, kvstrides, kvbox, 128)
                 : make_tensor_map(i ? &vmap : &kmap, i ? v : k, 3, kvdims3, kvstrides3, kvbox3,
                                   128);
  if (err != cudaSuccess) return err;
  return launch_split(flash_fwd_kernel<C>, R, nq / BQ, b, THREADS, Layout<C>::BYTES, stream,
                      qmap, kmap, vmap, static_cast<bf16*>(o), lse, nq, nk, scale);
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
constexpr int F32_XSLOT = F32_BARS + 256;              // a cluster's two slots of XCH

template <int C>
struct F32Units {
  static constexpr int R = FwdSplit<C>::R, CS = FwdSplit<C>::CS;
  // full[STAGES], empty[STAGES]; a cluster's xfull[2], xempty[2], then its slots
  static constexpr int SMEM =
      (R == 1 ? F32_BARS + 2 * F32_STAGES * 8 : F32_XSLOT + 2 * XCH) + 1024;
  static_assert(SMEM <= SMEM_MAX, "too much shared memory");
  static constexpr int H = CS / 2;                       // channels of one warpgroup
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

// O (B, Nq, C) fp32 = softmax(Q K^T * scale) V over fp32 q (B, Nq, C) and
// k, v (B, Nk, C), and with lse non-null the fp32 (B, Nq) lse = m + log(l).
// Grid (R Nq / 64, B) in clusters of R (FwdSplit); two warpgroups, thread 0
// also the producer.
template <int C>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, float* __restrict__ o,
                         float* __restrict__ lse, int nq, int nk, float scale) {
  using U = F32Units<C>;
  constexpr int R = U::R, H = U::H, OC = U::OC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F32_BARS);
  uint64_t* empty = full + F32_STAGES;
  uint64_t* xfull = empty + F32_STAGES;  // R = 2 only
  uint64_t* xempty = xfull + 2;
  float4* xslot = reinterpret_cast<float4*>(smem + F32_XSLOT);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int rank = 0;
  if constexpr (R > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int q0 = (blockIdx.x / R) * F32_BQ, b = blockIdx.y, c0 = rank * U::CS;
  const int units = (nk / F32_BK) * U::UNITS;

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
        tma_load_3d(st + g * F32_TILE, &qmap, &full[s], c0 + g * H + u * F32_KC, q0, b);
        tma_load_3d(st + (2 + g) * F32_TILE, &kmap, &full[s], c0 + g * H + u * F32_KC,
                    t * F32_BK, b);
      }
    } else {
      const int p = (u - U::NS) / U::NV, key = t * F32_BK + ((u - U::NS) % U::NV) * F32_VK;
      mbar_arrive_expect_tx(&full[s], 2 * U::V_HALF);
      for (int g = 0; g < 2; ++g)
        tma_load_3d(st + g * U::V_HALF, &vmap, &full[s], c0 + g * H + p * OC, key, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F32_THREADS / 32);  // one arrival per warp
    }
    if constexpr (R > 1)
      for (int s = 0; s < 2; ++s) {
        mbar_init(&xfull[s], F32_THREADS);  // the other CTA's threads
        mbar_init(&xempty[s], F32_THREADS);
      }
    mbar_init_fence();
    for (int k = 0; k < units && k < F32_STAGES; ++k) issue(k);
  }
  if constexpr (R > 1)
    cg::this_cluster().sync();
  else
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

  for (int t = 0; t < nk / F32_BK; ++t) {
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
    // the same S, m, l and P, bit for bit; in a cluster S_0 + S_1 is this
    // CTA's partial, and the other CTA's is added the same way ----
    float* xmine = reinterpret_cast<float*>(mine);
    const float* xtheirs = reinterpret_cast<const float*>(theirs);
#pragma unroll
    for (int i = 0; i < 32; ++i) xmine[i * 128 + wt] = sacc[i];
    named_barrier(3, F32_THREADS);
    if constexpr (R == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = (sacc[i] + xtheirs[i * 128 + wt]) * scale;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] += xtheirs[i * 128 + wt];
      send_partial(sacc, xslot, xfull, xempty, t, g, wt, rank ^ 1);
      add_peer_partial(sacc, xslot, xfull, xempty, t, wt, rank ^ 1, scale);
    }

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
  // both warpgroups (and in a cluster both CTAs) hold the same m and l:
  // warpgroup 0 (of rank 0) writes the rows' lse
  if (lse != nullptr && g == 0 && tig == 0 && rank == 0) {
    lse[static_cast<size_t>(b) * nq + q0 + row0] = m_run[0] + logf(l_run[0]);
    lse[static_cast<size_t>(b) * nq + q0 + row0 + 8] = m_run[1] + logf(l_run[1]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* orow = o + (static_cast<size_t>(b) * nq + q0 + row0 + 8 * half) * C + c0 + g * H;
#pragma unroll
    for (int j = 0; j < H / 8; ++j)
      if (R == 1 || c0 + g * H + 8 * j < C)  // a slice's padding is not stored
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * tig) =
            make_float2(oacc[4 * j + 2 * half] / l_run[half],
                        oacc[4 * j + 2 * half + 1] / l_run[half]);
  }
  // no CTA of a cluster leaves while the other may still reach its shared memory
  if constexpr (R > 1) cg::this_cluster().sync();
}

template <int C>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                       int nq, int nk, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(nq),
                             static_cast<uint64_t>(b)};
  const uint64_t qstrides[2] = {4ull * C, 4ull * C * nq};
  const uint64_t kvdims[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(nk),
                              static_cast<uint64_t>(b)};
  const uint64_t kvstrides[2] = {4ull * C, 4ull * C * nk};
  const uint32_t qkbox[3] = {F32_KC, F32_BQ, 1};
  const uint32_t vbox[3] = {F32Units<C>::OC, F32_VK, 1};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  cudaError_t err = make_tensor_map(&qmap, q, 3, qdims, qstrides, qkbox, 64, f32);
  if (err == cudaSuccess) err = make_tensor_map(&kmap, k, 3, kvdims, kvstrides, qkbox, 64, f32);
  if (err == cudaSuccess) err = make_tensor_map(&vmap, v, 3, kvdims, kvstrides, vbox, 0, f32);
  if (err != cudaSuccess) return err;
  return launch_split(flash_fwd_f32_kernel<C>, F32Units<C>::R, nq / F32_BQ, b, F32_THREADS,
                      F32Units<C>::SMEM, stream, qmap, kmap, vmap, static_cast<float*>(o), lse,
                      nq, nk, scale);
}

// The shapes both forwards take: 1 <= b <= 65535 (grid y), nq and nk
// positive multiples of the 64-row query block and the 64-key tile.
bool shape_ok(int b, int nq, int nk) {
  return b >= 1 && b <= 65535 && nq >= BQ && nq % BQ == 0 && nk >= BK && nk % BK == 0;
}

// The bf16 forward at width c.
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int nq,
             int nk, int c, float scale, void* stream) {
  if (!shape_ok(b, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch<128>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 256: return static_cast<int>(launch<256>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 384: return static_cast<int>(launch<384>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 512: return static_cast<int>(launch<512>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 640: return static_cast<int>(launch<640>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 768: return static_cast<int>(launch<768>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 896: return static_cast<int>(launch<896>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 1024: return static_cast<int>(launch<1024>(q, k, v, o, lse, b, nq, nk, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fp32 forward at width c.
int dispatch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int b, int nq,
                 int nk, int c, float scale, void* stream) {
  if (!shape_ok(b, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return static_cast<int>(launch_f32<128>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 256: return static_cast<int>(launch_f32<256>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 384: return static_cast<int>(launch_f32<384>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 512: return static_cast<int>(launch_f32<512>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 640: return static_cast<int>(launch_f32<640>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 768: return static_cast<int>(launch_f32<768>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 896: return static_cast<int>(launch_f32<896>(q, k, v, o, lse, b, nq, nk, scale, s));
    case 1024: return static_cast<int>(launch_f32<1024>(q, k, v, o, lse, b, nq, nk, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, o: contiguous (b, nq, c) bf16, k, v: contiguous (b, nk, c) bf16, on
// the current device. nq and nk must be multiples of 64 (the query block,
// the key tile) and c a multiple of 128 up to 1024.
int vcd_flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                 int nq, int nk, int c, float scale, void* stream) {
  return dispatch(q, k, v, o, nullptr, b, nq, nk, c, scale, stream);
}

// The training variant: also writes lse, contiguous (b, nq) fp32.
int vcd_flash_attention_fwd_lse_bf16(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int b, int nq, int nk, int c, float scale,
                                     void* stream) {
  return dispatch(q, k, v, o, static_cast<float*>(lse), b, nq, nk, c, scale, stream);
}

// The fp32 serving forward: q, o contiguous (b, nq, c) fp32, k, v (b, nk, c)
// fp32; nq and nk multiples of 64 and c a multiple of 128 up to 1024, as above.
int vcd_flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, int b,
                                int nq, int nk, int c, float scale, void* stream) {
  return dispatch_f32(q, k, v, o, nullptr, b, nq, nk, c, scale, stream);
}

// The fp32 training variant: also writes lse, contiguous (b, nq) fp32.
int vcd_flash_attention_fwd_lse_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int b, int nq, int nk, int c, float scale,
                                    void* stream) {
  return dispatch_f32(q, k, v, o, static_cast<float*>(lse), b, nq, nk, c, scale, stream);
}

// The dynamic shared memory a CTA of the bf16 (f32 == 0) or fp32 forward
// takes at width c, in bytes; -1 for a width it does not take.
int vcd_flash_attention_fwd_smem(int c, int f32) {
  switch (c) {
    case 128: return f32 ? F32Units<128>::SMEM : Layout<128>::BYTES;
    case 256: return f32 ? F32Units<256>::SMEM : Layout<256>::BYTES;
    case 384: return f32 ? F32Units<384>::SMEM : Layout<384>::BYTES;
    case 512: return f32 ? F32Units<512>::SMEM : Layout<512>::BYTES;
    case 640: return f32 ? F32Units<640>::SMEM : Layout<640>::BYTES;
    case 768: return f32 ? F32Units<768>::SMEM : Layout<768>::BYTES;
    case 896: return f32 ? F32Units<896>::SMEM : Layout<896>::BYTES;
    case 1024: return f32 ? F32Units<1024>::SMEM : Layout<1024>::BYTES;
    default: return -1;
  }
}

const char* vcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
