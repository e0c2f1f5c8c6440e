// Hopper's asynchronous building blocks, shared by the kernels that use
// them: mbarriers, TMA tile loads and stores (cp.async.bulk.tensor) with
// their tensor maps, and wgmma's fences and shared-memory descriptors.
// Users: the decode weight-streaming routine (decode_gemm.cuh: KW8, KW4
// and K2 at decode M, the whole-layer kernels' GEMM phases), KQ8's int32
// route on K-major weights (w8a8_gemm.cu) and the prefill wgmma tile
// (wgmma_wo_tile.cuh: KW4, KW8 and K2 at prefill M).
#pragma once
#include <cuda.h>

#include "common.cuh"

namespace aimet {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// spins until the phase of parity `parity` completes; more than ~2^32
// clocks (seconds: a broken pipeline) traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// one arrival that also expects `bytes` more of transactions (TMA)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// ------------------------------------------------------------------ TMA
// the box at (column c, row r) of map into dst, counted by bar; parts of
// the box past the matrix arrive as zeros (and count as bytes)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r),
      "r"(smem_addr(bar))
      : "memory");
}
// the shared box src to (column c, row r) of map (clipped at the matrix's
// edge); completion tracked by the issuing thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c), "r"(r)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the bulk stores issued so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's generic-proxy writes (global and shared) before
// later async-proxy (bulk copy) accesses; put before a barrier after which
// bulk copies read what the thread wrote, or overwrite shared memory it
// used
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// the same for this thread's shared-memory writes alone
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier `id` of the 128 threads of one warpgroup
__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rows x cols matrix of `type` (esize-byte elements), rows ld bytes
// apart, in boxes of box_rows x box_bytes, swizzled as many bytes (128 or
// 64); elements past the matrix load as zeros.
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
                      const void* p, int rows, int cols, long long ld,
                      int box_rows, int box_bytes) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || p == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / esize),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace aimet
