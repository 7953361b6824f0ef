// The ring kernel of the attention core: masked per-head attention over 144-token windows of
// packed qkv rows (features (q|k|v) x head x 64). K7 (sdpa.cu) runs it on packed rows; K2 and
// K6 (window_attention.cu) run it on the qkv their projection launch wrote; K10
// (attn_probe.cu) runs it unmasked with the probe's forms of the weights; K11
// (attn5d_direct.cu) runs K2's unmasked in two work orders. How a unit's
// q, k and v boxes are found and where its result rows go is a template parameter:
//   PackedRows   window w's token t is row 144 w + t of a (windows 144, 3D) tensor, seen
//                through a 2D tensor map with boxes of {64 features, 144 rows} (K7, K6);
//   GridWindows  the windows lie in place in a padded (B, Cp, Hp, Wp, 3D) grid, seen through a
//                5D tensor map with boxes of {64, ws2, ws1, ws0, 1} (K2). A box lands in shared
//                memory innermost first, so token t = (wc ws1 + wh) ws2 + ww: window_partition's
//                order, and the same 18,432 bytes of 128-byte rows under the 128-byte swizzle
//                as the 2D box (the swizzle is a function of the shared-memory address only).
// The same struct says which (window, head) a unit u is (`unit`): head fastest, so a window's
// heads follow each other, unless the struct orders them otherwise (K11's strips).
//
// The kernel (K7's design):
//   * blocks of 9 warps, two to an SM (18 warps are 5 on one scheduler, which leaves a
//     thread 96 registers: the core fits with 28-60 bytes of spills), each walking a
//     contiguous run of units (window, head), head fastest, so a window's heads follow each
//     other;
//   * a ring of 2 stages of q, k, v (3 x 18 KB a stage). One thread asks the TMA for the
//     three 144 x 64 boxes of a unit; they complete on the stage's mbarrier. The last warp
//     to finish with a stage issues the load of the unit two ahead into it, so no warp waits
//     for another and the next unit's bytes arrive while this one is multiplied;
//   * the mask as a template parameter: masked launches keep, per thread, two 36-bit words
//     (which of its logits lie across groups), rebuilt from the group ids only when the
//     window changes; unmasked launches have no mask code;
//   * the core of attention_core.cuh (ldmatrix fragments, v as stored, base-2 softmax with
//     one reciprocal a row), the result leaving in 16-byte stores of whole 128-byte rows.
// Pad tokens (stage 3 pads its grid to 48 x 96) are ordinary rows of their windows here; the
// group ids keep them apart from real tokens. Every box lies inside the tensor (the grid is
// padded to whole windows), so the TMA fills nothing.
#pragma once

#include "attention_core.cuh"

namespace {

#ifndef SDPA_RING  // tools/kernel_ablate.py builds a variant with 1: no load overlaps a product
#define SDPA_RING 2
#endif
constexpr int SDPA_STAGES = SDPA_RING;
constexpr int SDPA_STAGE_BYTES = 3 * CORE_TILE_BYTES;
constexpr int SDPA_THREADS = CORE_WARPS * 32;
constexpr size_t SDPA_SMEM = 1024 + SDPA_STAGES * SDPA_STAGE_BYTES + SDPA_STAGES * 16;

// Window w's token t at row 144 w + t; the map is 2D, (3D features, windows 144 rows).
struct PackedRows {
  int D;
  __device__ void unit(int u, int heads, int& window, int& head) const {
    window = u / heads;
    head = u % heads;
  }
  __device__ long long base(int window) const { return (long long)window * CORE_N; }
  __device__ long long row(long long base, int t) const { return base + t; }
  __device__ void load(const CUtensorMap* map, uint32_t dst, uint32_t bar, int window,
                       int head) const {
#pragma unroll
    for (int part = 0; part < 3; ++part)
      sm90::tma_load_2d(dst + part * CORE_TILE_BYTES, map, bar, part * D + head * 64,
                        window * CORE_N);
  }
};

// Window w = b nW + (c1 H1 + h1) W1 + w1 (window_partition's order) in place in the padded
// (B, Cp, Hp, Wp, .) grid; the map is 5D, (3D, Wp, Hp, Cp, B).
struct GridWindows {
  int D, nW, H1, W1, Cp, Hp, Wp, ws0, ws1, ws2;
  __device__ void unit(int u, int heads, int& window, int& head) const {
    window = u / heads;
    head = u % heads;
  }
  // The grid coordinates of the window's token 0.
  __device__ void origin(int window, int& b, int& c, int& h, int& w) const {
    b = window / nW;
    const int wi = window % nW;
    c = (wi / (H1 * W1)) * ws0;
    h = ((wi / W1) % H1) * ws1;
    w = (wi % W1) * ws2;
  }
  // The row of the window's token 0.
  __device__ long long base(int window) const {
    int b, c, h, w;
    origin(window, b, c, h, w);
    return (((long long)b * Cp + c) * Hp + h) * Wp + w;
  }
  __device__ long long row(long long base, int t) const {
    const int wc = t / (ws1 * ws2), wh = (t / ws2) % ws1, ww = t % ws2;
    return base + ((long long)wc * Hp + wh) * Wp + ww;
  }
  __device__ void load(const CUtensorMap* map, uint32_t dst, uint32_t bar, int window,
                       int head) const {
    int b, c, h, w;
    origin(window, b, c, h, w);
#pragma unroll
    for (int part = 0; part < 3; ++part)
      sm90::tma_load_5d(dst + part * CORE_TILE_BYTES, map, bar, part * D + head * 64, w, h, c, b);
  }
};

// One thread: ask the TMA for q, k and v of unit u (the (window, head) of win.unit) into
// the stage at `dst`, completing on `bar`.
template <class Windows>
__device__ __forceinline__ void sdpa_load(const Windows& win, const CUtensorMap* map, uint32_t dst,
                                          uint32_t bar, int u, int heads) {
  int window, head;
  win.unit(u, heads, window, head);
  sm90::mbar_arrive_expect_tx(bar, SDPA_STAGE_BYTES);
  win.load(map, dst, bar, window, head);
}

template <bool MASKED, class Windows, int SM = CORE_SOFTMAX>
__global__ void __launch_bounds__(SDPA_THREADS, 2) sdpa_windows_kernel(
    const __grid_constant__ CUtensorMap map_qkv, const Windows win, const int* __restrict__ groups,
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
        sdpa_load(win, &map_qkv, tiles + s * SDPA_STAGE_BYTES, full + 8 * s, u_begin + s, heads);
  }
  __syncthreads();

  uint64_t neq[2] = {0, 0};
  int mask_window = -1;
  int s = 0;
  uint32_t phase = 0;
  for (int u = u_begin; u < u_end; ++u) {
    int window, head;
    win.unit(u, heads, window, head);
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
    uint32_t wf[9][4];
    if constexpr (SM == CORE_SOFTMAX) {
      float inv0, inv1;
      core_softmax<MASKED>(sc, neq, inv0, inv1);
      core_pack(wf, sc, inv0, inv1);
    } else if constexpr (SM == CORE_NO_SOFTMAX) {
      core_pack_scaled(wf, sc);
    } else {
      float l0, l1;
      core_softmax_bf16(sc, l0, l1);
      core_pack_div(wf, sc, l0, l1);
    }
    core_weights_v(o, wf, q + 2 * CORE_TILE_BYTES, lane);
#endif
    core_store(o, q, win, win.base(window), D, head * 64, out, warp, lane);

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
          sdpa_load(win, &map_qkv, q, full + 8 * s, u + SDPA_STAGES, heads);
#endif
      }
    }
    if (++s == SDPA_STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
}

// Launches the ring over `units` = windows x heads units; out is D wide, rows as `win` says.
// SM: the form of the weights (attention_core.cuh; the probe's forms take no mask). A
// block's run of units is a multiple of `group` (K10's batched modes: whole windows).
// Returns cudaGetLastError(), or cudaErrorUnknown where the SM count cannot be read.
template <class Windows, int SM = CORE_SOFTMAX>
int launch_sdpa(const CUtensorMap& map, const Windows& win, const int* groups, bf16* out, int nW,
                int D, int heads, int units, cudaStream_t stream, int group = 1) {
  // Runs of units as long as two blocks an SM need, and no block without a unit.
  const int slots = 2 * sm90::sm_count();
  if (slots <= 0) return (int)cudaErrorUnknown;
  int run = (units + slots - 1) / slots;
  run = (run + group - 1) / group * group;
  const int blocks = (units + run - 1) / run;
  if (groups) {
    if constexpr (SM != CORE_SOFTMAX) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(sdpa_windows_kernel<true, Windows>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SDPA_SMEM);
    sdpa_windows_kernel<true, Windows><<<blocks, SDPA_THREADS, SDPA_SMEM, stream>>>(
        map, win, groups, out, nW, D, heads, units, run);
  } else {
    cudaFuncSetAttribute(sdpa_windows_kernel<false, Windows, SM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SDPA_SMEM);
    sdpa_windows_kernel<false, Windows, SM><<<blocks, SDPA_THREADS, SDPA_SMEM, stream>>>(
        map, win, groups, out, nW, D, heads, units, run);
  }
  return (int)cudaGetLastError();
}

// The 2D map of packed rows: (3D features, rows), boxes of {64, 144}.
inline cudaError_t make_map_packed(CUtensorMap* map, const void* qkv, long long rows, int D) {
  const uint64_t dims[2] = {(uint64_t)3 * D, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)3 * D * 2};
  const uint32_t box[2] = {64, CORE_N};
  return sm90::make_map_bf16(map, qkv, 2, dims, strides, box);
}

// The 5D map of a padded (B, Cp, Hp, Wp, 3D) qkv grid: dims {3D, Wp, Hp, Cp, B}, boxes of
// {64, ws2, ws1, ws0, 1}, one window's 64 features of one part.
inline cudaError_t make_map_grid(CUtensorMap* map, const void* qkv, int B, int Cp, int Hp, int Wp,
                                 int D, int ws0, int ws1, int ws2) {
  const uint64_t row = (uint64_t)3 * D * 2;  // bytes of one token's qkv
  const uint64_t dims[5] = {(uint64_t)3 * D, (uint64_t)Wp, (uint64_t)Hp, (uint64_t)Cp,
                            (uint64_t)B};
  const uint64_t strides[4] = {row, row * Wp, row * Wp * Hp, row * Wp * Hp * Cp};
  const uint32_t box[5] = {64, (uint32_t)ws2, (uint32_t)ws1, (uint32_t)ws0, 1};
  return sm90::make_map_bf16(map, qkv, 5, dims, strides, box);
}

}  // namespace
