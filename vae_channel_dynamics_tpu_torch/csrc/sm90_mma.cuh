// The one pre-wgmma building block a Hopper kernel still uses: ldmatrix.trans,
// which kernel #11 (fused_resnet.cu, conv3x3_dw) takes to load each wgmma A
// fragment at an arbitrary pixel shift of its swizzled window, a shift no
// wgmma descriptor expresses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vcd {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices, each transposed; lanes 8i .. 8i + 7 give the row
// addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

}  // namespace vcd
