// K7 sdpa_windows: masked per-head attention over packed window rows qkv (B, nW, 144, 3D),
// features (q|k|v) x head x 64, -> (B, nW, 144, D). Replaces aurora_tpu/model/swin3d.py
// _sdpa_windows_fused_pallas (pallas_call at :651).
//
// Bound on the H100: bytes. A unit (window, head) reads 55 KB and writes 18 KB for 5.3 MFLOP:
// a stage-1 launch moves 1.06 GB (0.317 ms at 3.35 TB/s) for 76 GFLOP (0.08 ms at the
// tensor cores' peak). So the design keeps device memory busy while the core computes:
//   * blocks of 9 warps, two to an SM (18 warps are 5 on one scheduler, which leaves a
//     thread 96 registers: the core fits with 28-60 bytes of spills), each walking a
//     contiguous run of units, head fastest, so a window's heads follow each other;
//   * a ring of 2 stages of q, k, v (3 x 18 KB a stage). One thread asks the TMA for the
//     three 144 x 64 boxes of a unit (a box row is 128 bytes, one swizzle row, so fragments
//     load by ldmatrix without conflicts); they complete on the stage's mbarrier. The last
//     warp to finish with a stage issues the load of the unit two ahead into it, so no warp
//     waits for another and the next unit's bytes arrive while this one is multiplied. A
//     block asks for 2 x 55,296 bytes and nothing it does not use;
//   * the mask as a template parameter: masked launches keep, per thread, two 36-bit words
//     (which of its logits lie across groups), rebuilt from the group ids only when the
//     window changes; unmasked launches have no mask code;
//   * the core of attention_core.cuh (ldmatrix fragments, v as stored, base-2 softmax with
//     one reciprocal a row), the result leaving in 16-byte stores of whole 128-byte rows.
// Pad tokens (stage 3 pads its grid to 48 x 96) are ordinary rows of their windows here; the
// group ids keep them apart from real tokens. Every box lies inside the (B nW 144, 3D)
// tensor, so the TMA fills nothing.
#include "attention_core.cuh"

namespace {

#ifndef SDPA_RING  // tools/kernel_ablate.py builds a variant with 1: no load overlaps a product
#define SDPA_RING 2
#endif
constexpr int SDPA_STAGES = SDPA_RING;
constexpr int SDPA_STAGE_BYTES = 3 * CORE_TILE_BYTES;
constexpr int SDPA_THREADS = CORE_WARPS * 32;
constexpr size_t SDPA_SMEM = 1024 + SDPA_STAGES * SDPA_STAGE_BYTES + SDPA_STAGES * 16;

// One thread: ask the TMA for q, k and v of unit u (head u % heads of window u / heads) into
// the stage at `dst`, completing on `bar`.
__device__ __forceinline__ void sdpa_load(const CUtensorMap* map, uint32_t dst, uint32_t bar, int u,
                                          int heads, int D) {
  const int window = u / heads, head = u % heads;
  sm90::mbar_arrive_expect_tx(bar, SDPA_STAGE_BYTES);
#pragma unroll
  for (int part = 0; part < 3; ++part)
    sm90::tma_load_2d(dst + part * CORE_TILE_BYTES, map, bar, part * D + head * 64,
                      window * CORE_N);
}

template <bool MASKED>
__global__ void __launch_bounds__(SDPA_THREADS, 2) sdpa_windows_kernel(
    const __grid_constant__ CUtensorMap map_qkv, const int* __restrict__ groups,
    bf16* __restrict__ out, int nW, int D, int heads, int units, int run) {
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  const uint32_t full = tiles + SDPA_STAGES * SDPA_STAGE_BYTES;  // SDPA_STAGES mbarriers
  // Per stage, how many warps have finished with it.
  int* done = reinterpret_cast<int*>(raw + (full - raw_addr) + SDPA_STAGES * 8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u_begin = blockIdx.x * run;
  const int u_end = u_begin + run < units ? u_begin + run : units;

  if (tid == 0) {
    for (int s = 0; s < SDPA_STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      done[s] = 0;
    }
    sm90::mbar_fence_init();
    for (int s = 0; s < SDPA_STAGES; ++s)
      if (u_begin + s < u_end)
        sdpa_load(&map_qkv, tiles + s * SDPA_STAGE_BYTES, full + 8 * s, u_begin + s, heads, D);
  }
  __syncthreads();

  uint64_t neq[2] = {0, 0};
  int mask_window = -1;
  int s = 0;
  uint32_t phase = 0;
  for (int u = u_begin; u < u_end; ++u) {
    const int window = u / heads, head = u % heads;
    if constexpr (MASKED) {
#ifdef ABLATE_MASK_EVERY_UNIT
      mask_window = -1;
#endif
      if (window != mask_window) {
        core_mask_bits(neq, groups + (long long)(window % nW) * CORE_N, warp, lane);
        mask_window = window;
      }
    }
    const uint32_t q = tiles + s * SDPA_STAGE_BYTES;
#ifdef ABLATE_NO_LOADS  // only the first SDPA_STAGES units are loaded; the rest reuse them
    if (u - u_begin < SDPA_STAGES)
#endif
    sm90::mbar_wait(full + 8 * s, phase);

    float o[8][4];
#ifdef ABLATE_NO_CORE  // loads, ring and stores only: zeros leave
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#else
    float sc[18][4];
#pragma unroll
    for (int j = 0; j < 18; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    core_logits(sc, q, q + CORE_TILE_BYTES, warp, lane);
    float inv0, inv1;
    core_softmax<MASKED>(sc, neq, inv0, inv1);
    uint32_t wf[9][4];
    core_pack(wf, sc, inv0, inv1);
    core_weights_v(o, wf, q + 2 * CORE_TILE_BYTES, lane);
#endif
    core_store(o, q, (long long)window * CORE_N, D, head * 64, out, warp, lane);

    // This warp is done with the stage (its reads, and its writes over its q rows, come
    // before the TMA's next writes there). The last warp to say so refills the stage.
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[s], 1) == CORE_WARPS - 1) {
        __threadfence_block();
        done[s] = 0;
#ifndef ABLATE_NO_LOADS
        if (u + SDPA_STAGES < u_end)
          sdpa_load(&map_qkv, q, full + 8 * s, u + SDPA_STAGES, heads, D);
#endif
      }
    }
    if (++s == SDPA_STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
}

template <bool MASKED>
int launch_sdpa(const CUtensorMap& map, const int* groups, bf16* out, int nW, int D, int heads,
                int units, cudaStream_t stream) {
  // Runs of units as long as two blocks an SM need, and no block without a unit.
  const int slots = 2 * sm90::sm_count();
  if (slots <= 0) return (int)cudaErrorUnknown;
  const int run = (units + slots - 1) / slots;
  const int blocks = (units + run - 1) / run;
  cudaFuncSetAttribute(sdpa_windows_kernel<MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SDPA_SMEM);
  sdpa_windows_kernel<MASKED><<<blocks, SDPA_THREADS, SDPA_SMEM, stream>>>(map, groups, out, nW, D,
                                                                         heads, units, run);
  return (int)cudaGetLastError();
}

}  // namespace

// K7: qkv (B, nW, 144, 3D) bf16 packed (q|k|v) x head x 64 -> out (B, nW, 144, D) bf16;
// groups: (nW, 144) int32 or null. Returns cudaGetLastError(), cudaErrorInvalidValue for a
// shape it does not take, or cudaErrorUnknown where no tensor map could be encoded.
extern "C" int sdpa_windows(const void* qkv, const int* groups, void* out, int B, int nW, int D,
                            int heads, cudaStream_t stream) {
  const long long windows = (long long)B * nW;
  if (B <= 0 || nW <= 0 || D != heads * 64 || windows * heads > 0x7fffffffLL ||
      windows * CORE_N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const uint64_t dims[2] = {(uint64_t)3 * D, (uint64_t)windows * CORE_N};
  const uint64_t strides[1] = {(uint64_t)3 * D * 2};
  const uint32_t box[2] = {64, CORE_N};
  const cudaError_t e = sm90::make_map_bf16(&map, qkv, 2, dims, strides, box);
  if (e != cudaSuccess) return (int)e;
  const int units = (int)(windows * heads);
  return groups ? launch_sdpa<true>(map, groups, static_cast<bf16*>(out), nW, D, heads, units, stream)
                : launch_sdpa<false>(map, groups, static_cast<bf16*>(out), nW, D, heads, units,
                                     stream);
}
