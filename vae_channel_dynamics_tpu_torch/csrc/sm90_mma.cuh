// Building blocks shared by the flash-attention kernels (sm_90a): cp.async
// tile copies into padded shared memory, ldmatrix fragment loads, and the
// bf16 m16n8k16 tensor-core product with fp32 accumulation.
//
// Tiles of C bf16 columns sit in shared memory with rows padded by PAD
// elements (16 bytes), so the 8 row addresses of one ldmatrix fall in
// distinct bank groups whenever the row stride is an odd multiple of 16
// bytes modulo 128 (C + PAD = 136, 264, 392, 520 for C = 128 ... 512).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vcd {

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;  // bf16 elements (16 bytes) of row padding

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

// Two 8x8 matrices; lanes 0-15 give the row addresses (the others' are
// ignored but must still be valid shared addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 accumulate.
// Fragment of d in each lane: rows lane/4 and lane/4 + 8, columns
// 2*(lane%4) and 2*(lane%4) + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy ROWS rows of C bf16 from device memory (row stride C) into a padded
// shared-memory tile (row stride C + PAD), 16 bytes per cp.async, spread
// over the block's THREADS threads.
template <int C, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int tid) {
  constexpr int CHUNKS = C / 8;
  static_assert((ROWS * CHUNKS) % THREADS == 0, "tile does not split evenly over the block");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int r = i / CHUNKS, ch = i % CHUNKS;
    cp_async16(dst + r * (C + PAD) + ch * 8, src + static_cast<size_t>(r) * C + ch * 8);
  }
}

}  // namespace vcd
