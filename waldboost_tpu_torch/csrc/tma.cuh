// Copies into shared memory shared by the port's Hopper kernels
// (csrc/grad_hist_float.cu, csrc/cascade_fast.cu): 4-byte cp.async and its
// groups, mbarriers, TMA tile loads from a tensor map, and the host's
// tensor maps (cuTensorMapEncodeTiled through the runtime, so no library
// beyond cudart is linked).  csrc/*.cuh are hashed into every build
// (waldboost_tpu_torch/_build.py).

#pragma once

#include <cstdint>
#include <mutex>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace {

// cp.async of 4 bytes from global to shared memory, and its groups.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The TMA side: mbarriers in shared memory (one arrival, the copies'
// bytes), and tile loads from a tensor map, zero-filled off the tensor.
__device__ __forceinline__ unsigned smem_at(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_at(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// generic-proxy accesses of shared memory before the async proxy's
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_at(bar)),
      "r"(bytes)
      : "memory");
}
// one arrival (release: this thread's earlier shared-memory writes are
// seen by the threads its completion releases)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_at(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WB_WAIT;\n"
      "}\n" ::"r"(smem_at(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_at(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_at(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_at(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_at(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up once through the runtime.
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static std::once_flag once;
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  });
  return fn;
}

// A tiled tensor map over a row-major tensor of `rank` dims (innermost
// first, elements of `bytes` bytes); false where it cannot be made.
bool tensor_map(CUtensorMap* map, const void* base, int bytes, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  const auto encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t strides[2];
  cuuint64_t s = dims[0] * bytes;
  for (int d = 1; d < rank; ++d) {
    strides[d - 1] = s;
    s *= dims[d];
  }
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                   : CU_TENSOR_MAP_DATA_TYPE_UINT32;
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
