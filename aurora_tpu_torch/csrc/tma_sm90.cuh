// Hopper's asynchronous-copy primitives as thin wrappers of their PTX: mbarriers, the Tensor
// Memory Accelerator's tiled loads (TMA), the proxy fence between ordinary and asynchronous
// accesses of shared memory, the 128-byte swizzle, and the host side's tensor maps.
// gemm_sm90.cuh (the wgmma mainloop) and sdpa_sm90.cuh (the attention core's ring) build on it.
//
// Conventions. Shared-memory operands are 32-bit shared-space addresses (smem_u32). An
// mbarrier's phase parity: a fresh barrier is in phase 0; mbar_wait(bar, p) returns once the
// phase of parity p has completed, so a consumer starts with p = 0 and a producer waiting
// for a free buffer with p = 1 (which a fresh barrier passes at once); both flip p each
// time their ring wraps. A tensor map lives in kernel parameter space
// (`const __grid_constant__ CUtensorMap`) and is passed by address.
//
// cuTensorMapEncodeTiled lives in libcuda, which the libraries do not link (no -lcuda): the
// entry point is taken from the runtime with cudaGetDriverEntryPoint, once per process.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// After the inits, before any thread or the TMA uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic the phase has to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#ifdef MBAR_WATCHDOG  // development: a protocol fault traps instead of hanging the card
  for (long long spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins > (1ll << 24)) __trap();
#else
  while (!mbar_try_wait(bar, parity)) {
  }
#endif
}

// ------------------------------------------------------------------------------ TMA
// Tile loads: the box of `map` at the coordinates (innermost first) into shared memory at
// dst; the bytes of the whole box (parts outside the tensor arrive as zeros) complete on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The 5D form: a box of a 5D map, e.g. a whole window of the padded token grid.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Orders this thread's ordinary shared-memory accesses before later accesses by the
// asynchronous proxy (a TMA load overwriting the same bytes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The byte offset of 16-byte piece `chunk` (0-7) of row `row` in a tile of 128-byte rows
// under the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B; the tile 1024-byte aligned).
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// ------------------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 tensor map of `rank` (2 to 5) dimensions, innermost first: `dims` in elements,
// `strides` of dimensions 1.. in bytes (multiples of 16), `box` in elements (each at most
// 256) with an innermost box of 64 elements = 128 bytes, the 128-byte swizzle, zeros outside
// the tensor. Returns cudaSuccess, or cudaErrorUnknown where the encoding is refused.
inline cudaError_t make_map_bf16(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                                 const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode || rank < 2 || rank > 5) return cudaErrorUnknown;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  cuuint64_t d[5], s[4];
  cuuint32_t b[5];
  for (int i = 0; i < rank; ++i) d[i] = dims[i], b[i] = box[i];
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i];
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<void*>(base), d, s, b, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorUnknown;
}

inline int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 0;
    return v;
  }();
  return n;
}

}  // namespace sm90
