// Hopper (sm_90a) TMA loads and the mbarriers that track them, shared by
// the bf16 kernels that take their tiles by TMA (flash attention's forward
// at D 64 and 128, the SSD chunk), and the host side that encodes a tensor
// map.
//
// A tile comes in as boxes of [rows][64 bf16] (128 bytes a row), which the
// copy engine writes in the 128-byte swizzle that wgmma.cuh's descriptors
// read (chunk c of row r at c ^ (r % 8); the destination 1024-byte
// aligned), zero-filled where the box leaves the tensor. Every byte of the
// box counts towards the barrier's transaction, zero fill included.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_kernels {

// One box of a 4-D map, coordinates innermost first, into shared memory at
// dst; completion is reported to the mbarrier at bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// An mbarrier that completes a phase after `count` arrivals (and the
// transaction bytes announced by mbar_expect_tx). One thread initialises
// the block's barriers, then calls mbar_init_fence, then the block syncs.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of TMA transaction
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Spin until the phase of parity `phase` has completed. A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// A bf16 tensor of 4 dims as a TMA map: dims innermost first (the first
// contiguous), byte strides of dims 1-3 (multiples of 16), box extents,
// 128-byte swizzle (box[0] must be 64), zero fill. Fetches
// cuTensorMapEncodeTiled through the runtime, so the library needs no
// -lcuda. False if the driver refuses the geometry.
inline bool encode_tma_map(CUtensorMap* map, const void* base,
                           const long long* dims, const long long* strides,
                           const long long* box) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
  }
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t gbox[4];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    gbox[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i < 3; ++i) gstride[i] = static_cast<cuuint64_t>(strides[i]);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), gdim, gstride, gbox, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro_kernels
