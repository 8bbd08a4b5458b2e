// Hopper (sm_90a) building blocks for the warpgroup-MMA kernels: mbarriers
// (also across a thread-block cluster), TMA tile loads, the wgmma
// shared-memory matrix descriptor, wgmma.mma_async (bf16 -> fp32) with B
// from shared memory and A from shared memory or from registers, the tf32
// wgmma (B from shared memory, K-major with or without swizzle; A from
// shared memory or registers) and the rounding to tf32, named barriers, and
// the host-side tensor-map encoder.
//
// Conventions. A tile loaded by TMA with a 128-, 64- or 32-byte swizzle sits
// in shared memory as rows of exactly that many bytes (the box's inner
// dimension), 8 rows to a swizzle atom; its base must be 1024-byte aligned,
// so that the atom pattern (16-byte chunk c of row r stored at chunk
// c ^ (r % 8) for 128 bytes) is a function of the address alone. Such a
// tile is a K-major wgmma operand: make_desc() describes it, and one k-step
// of 16 bf16 (32 bytes) further along K is the same descriptor built 32
// bytes on. The accumulator of a 64 x N product is the mma.sync m16n8k16
// C fragment, repeated: warp w of the warpgroup holds rows 16w + lane/4 and
// 16w + lane/4 + 8, d[4j .. 4j+3] columns 8j + 2(lane%4) and the one after.
//
// The host encodes tensor maps with cuTensorMapEncodeTiled, taken from the
// driver through cudaGetDriverEntryPoint, so the libraries need no -lcuda;
// a kernel takes the map by value as a `const __grid_constant__ CUtensorMap`.
// TMA's tiled mode takes signed coordinates and fills every element of the
// box that lies outside the tensor with zeros: the kernels' halos and ragged
// edges. The innermost coordinate must fall on whole 16 bytes (an fp32 box
// started one element before a row, at -1, stops the kernel with an illegal
// instruction): a halo one element wide is taken from a box started 16 bytes
// early.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vcd {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------- //
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA);
// then a __syncthreads before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA, wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers across a thread-block cluster ------------------------------ //
// The shared::cluster address of `p` (in this CTA's shared memory) at the
// same offset in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// One arrival on the mbarrier at `bar`, a shared::cluster address
// (cluster_addr) in this CTA or another of the cluster, releasing this
// thread's earlier memory accesses at cluster scope: a waiter that
// mbar_wait_cluster()s on the phase sees them.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait, acquiring at cluster scope what the arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes to `addr`, a shared::cluster address in another CTA of the cluster.
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Copies `bytes` (a multiple of 16) from `src` in this CTA's shared memory
// to `dst` in the shared memory of a CTA of the cluster (this CTA's own
// too), one bulk transfer counted as transactions of the mbarrier at `bar` in
// that CTA; dst and bar are shared::cluster addresses (cluster_addr). The
// writers of src make their stores visible to the copy first
// (fence_proxy_async, then a barrier).
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, const void* src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- TMA tile loads (global -> shared, completion on an mbarrier) --------- //
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------- //
// The shared-memory matrix descriptor of a K-major tile swizzled by
// `swizzle_bytes` (128, 64 or 32): start address >> 4 (bits 0-13), the
// leading byte offset (unused by swizzled K-major layouts; 1), the stride
// byte offset between 8-row groups (8 rows of swizzle_bytes) >> 4 (bits
// 32-45), base offset 0 (1024-byte aligned atoms), the layout (bits 62-63:
// 1 = 128B, 2 = 64B, 3 = 32B).
__device__ __forceinline__ uint64_t make_desc(const void* tile, int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  uint64_t d = (static_cast<uint64_t>(smem_u32(tile)) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>((8 * swizzle_bytes) >> 4) << 32;
  d |= layout << 62;
  return d;
}

// The descriptor of an MN-major tile swizzled by 128 bytes: 64-element
// columns of the N (or M) dimension in 128-byte rows, one row per k; `lbo`
// bytes from one 64-wide column block to the next, `sbo` bytes from one
// 8-row group of k to the next.
__device__ __forceinline__ uint64_t make_desc_mn(const void* tile, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (static_cast<uint64_t>(smem_u32(tile)) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// Before the first wgmma, and between other instructions' accesses to a
// register and a wgmma that reads it (an A fragment, or accumulators).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to wgmma registers across a wait:
// accumulators, and A fragments, whose registers an in-flight wgmma still
// reads (fencing them after the wait keeps them allocated until then).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128) += A (64 x 16, K-major in shared memory) * B (128 x 16 in
// shared memory: K-major, or MN-major with TRANS_B = 1), bf16 in, fp32
// accumulate.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        , "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        , "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        , "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        , "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        , "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
        , "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        , "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        , "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        , "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
        , "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 64) += A (64 x 16) * B (64 x 16), both K-major in shared memory,
// bf16 in, fp32 accumulate.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        , "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        , "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32) += A (64 x 16) * B (32 x 16), both K-major in shared memory,
// bf16 in, fp32 accumulate.
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128) += A (64 x 16 in registers: this warp's 16 rows as the
// mma.sync m16n8k16 A fragment) * B (128 x 16 in shared memory: K-major, or
// MN-major with TRANS_B = 1), bf16 in, fp32 accumulate.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        , "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        , "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        , "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        , "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        , "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
        , "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        , "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        , "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        , "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
        , "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 64) += A (64 x 16 in registers: this warp's 16 rows as the
// mma.sync m16n8k16 A fragment) * B (64 x 16 in shared memory: K-major, or
// MN-major with TRANS_B = 1), bf16 in, fp32 accumulate.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        , "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        , "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// ---- tf32 (the 3xTF32 products of the fp32 kernels) --------------------- //
// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero, as
// fp32 bits: the operands are rounded here and never left to the tensor
// cores, which would drop the low 13 bits.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d (64 x N) += A (64 x 8) * B (N x 8), tf32 in, fp32 accumulate, both
// K-major in shared memory (tf32 has no transposed operand). One k-step of 8
// tf32 is 32 bytes, as one of 16 bf16 is, so make_desc() and its 32-byte
// advance carry over. N = 64 or 128 (d[N / 2] a thread). The tensor cores
// truncate each fp32 accumulation (round toward zero), so a long sum drifts
// low: a kernel keeps each wgmma accumulation short and adds the partial
// sums in fp32 registers.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d = 1);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        , "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        , "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        , "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        , "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        , "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        , "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        , "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
        , "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        , "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        , "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        , "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
        , "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The descriptor of a K-major tile without swizzle: 8-row core matrices of
// 16 bytes a row (128 contiguous bytes), `lbo` bytes from one core matrix to
// the next along K (the two halves of a 32-byte k-step), `sbo` bytes from
// one 8-row group to the next along M or N.
__device__ __forceinline__ uint64_t make_desc_interleave(const void* tile, uint32_t lbo,
                                                         uint32_t sbo) {
  uint64_t d = (static_cast<uint64_t>(smem_u32(tile)) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  return d;  // layout 0: no swizzle
}

// d (64 x 32) += A (64 x 8 tf32 in registers) * B (32 x 8 tf32, K-major in
// shared memory), fp32 accumulate. Warp w of the warpgroup holds A's rows
// 16w + lane/4 (a[0], a[2]) and 16w + lane/4 + 8 (a[1], a[3]), columns
// lane%4 (a[0], a[1]) and lane%4 + 4 (a[2], a[3]): the mma.sync m16n8k8
// tf32 A fragment. The registers are fp32 bits already rounded to tf32.
__device__ __forceinline__ void wgmma_tf32_rs_m64n32k8(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The same with N = 64: d (64 x 64) += A (64 x 8, registers) * B (64 x 8).
__device__ __forceinline__ void wgmma_tf32_rs_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        , "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        , "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        , "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        , "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Synchronises `count` threads (a multiple of 32) on named barrier `id`
// (1-15; 0 is __syncthreads'), e.g. one warpgroup apart from the others.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Raises (INC) or lowers this warpgroup's registers a thread to N (a
// multiple of 8, 24-256), all its warps together: a producer warpgroup hands
// registers to the consumers, within the SM's 64K.
template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Arrives at named barrier `id` without waiting: the other threads of its
// `count` wait there with named_barrier (a producer-consumer handshake).
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- host: tensor maps ---------------------------------------------------- //
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn lookup_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                       &found) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
      cudaSuccess)
    return nullptr;
#endif
  return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(fn) : nullptr;
}

// A bf16 (or `type`) tensor map of `rank` dimensions, innermost first:
// dims[i] elements, byte strides of dims 1.. in strides[0 .. rank-2], a box
// of box[i] elements, swizzled by `swizzle_bytes` (128, 64 or 32; the box's
// inner dimension must span exactly that many bytes; 0: not swizzled), zero
// fill out of bounds. Returns cudaErrorInvalidValue when the CUDA driver refuses
// it.
inline cudaError_t make_tensor_map(CUtensorMap* map, const void* base, int rank,
                                   const uint64_t* dims, const uint64_t* strides,
                                   const uint32_t* box, int swizzle_bytes,
                                   CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  static const EncodeTiledFn encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUtensorMapSwizzle sw = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, type, static_cast<cuuint32_t>(rank),
                            const_cast<void*>(base), d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace vcd
