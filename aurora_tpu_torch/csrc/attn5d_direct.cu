// K11 attn5d_direct: unmasked window attention without tail over 144-token windows (head dim
// 64) read in place from padded 5D tokens (B, Cp, Hp, Wp, D), in the two timing modes of the
// TPU probe. Replaces tools/backbone_ablate.py make_direct (pallas_call at :877), which walks
// the (ws0, ws1, Wp) strips of W1 = Wp / ws2 windows on a (C1, H1) grid: `vec` relays a strip
// out into windows in one transpose, `loop` slices it window by window. Both compute
//   qkv = bf16(bf16(x Wqkv) + bqkv), per head softmax(q k^T / 8) in f32 -> bf16 -> @ v,
// each window's result written back in place: K2 without tail and mask, whose numbers are
// aurora_tpu_torch/ops/probes.py::attn5d_direct_plain.
//
// Bound on the H100: operations, the qkv product and the core in bf16 at 989 TF/s (stage 1 of
// the 0.25 degree model: 0.41 + 0.08 TFLOP, 0.49 ms a call).
//
// Design: K2's two launches without the tail (window_attention.cu), on the shared headers.
//   1. qkv: gemm_bias_kernel<EPI_QKV> (gemm_rows_sm90.cuh) over the grid's B Cp Hp Wp token
//      rows in their stored order, Wqkv (D, 3D) read as stored (the MN-major operand), the
//      bf16 bias between two roundings, into the (rows, 3D) scratch the wrapper allocates.
//   2. core: K7's ring kernel (sdpa_sm90.cuh) on the scratch through the 5D tensor map of the
//      padded grid (boxes of {64, ws2, ws1, ws0, 1}: a window in place, in window_partition's
//      token order), unmasked, each token's result to its own row of `out`.
// The TPU kernel's two schedules are the core's two work orders. A unit is (window, head);
// windows are numbered b nW + (c1 H1 + h1) W1 + w1, a strip s = b C1 H1 + c1 H1 + h1 holds
// windows s W1 .. s W1 + W1 - 1, and the ring's persistent blocks each walk a run of units:
//   loop: unit u is head u % heads of window u / heads: one window at a time, its heads in
//         turn, windows in the TPU loop's order (w1 fastest within a strip). Runs of any
//         length (K2's own order, so this mode is K2's core launch as it is).
//   vec:  unit u is window s W1 + u % W1 of head h, where item = u / W1 = s heads + h: a
//         whole strip for one head, then the strip's next head. Runs are whole items
//         (launch_sdpa's group = W1), so a block takes whole strips per head: W1 = 30 / 15 / 8
//         windows at stages 1 / 2 / 3, 240 / 240 / 256 blocks of 2 items on 264 slots.
//   ops/probes.py::attn5d_schedule mirrors both decodes and the runs for the tests.
// Every unit's arithmetic is the same in both orders, so both modes give K2 without tail's
// bits on the same input.
//
// tools/kernel_ablate.py builds copies with -DABLATE_ONLY_QKV (launch 1 alone) and
// -DABLATE_ONLY_CORE (launch 2 alone, on what the scratch holds), in both orders.
#include "gemm_rows_sm90.cuh"
#include "sdpa_sm90.cuh"

namespace {

// vec's work order over the windows of GridWindows: a strip's W1 windows for one head, then
// its next head (see the header).
struct GridStrips : GridWindows {
  __device__ void unit(int u, int heads, int& window, int& head) const {
    const int item = u / W1;
    window = (item / heads) * W1 + u % W1;
    head = item % heads;
  }
};

}  // namespace

// x, out: (B, Cp, Hp, Wp, D) bf16 with windows (ws0, ws1, ws2) of 144 tokens in place; wqkv:
// (D, 3D) bf16 as stored; bqkv: (3D,) bf16; qkv: scratch (B Cp Hp Wp, 3D) bf16; vec: 1 for
// mode vec, 0 for mode loop. D in {512, 1024, 2048}, D = 64 heads, every pointer 16-byte
// aligned. Returns cudaGetLastError() of the last launch, cudaErrorInvalidValue for a shape
// it does not take, or cudaErrorUnknown where no tensor map could be encoded.
extern "C" int attn5d_direct(const void* x, const void* wqkv, const void* bqkv, void* qkv,
                             void* out, int B, int Cp, int Hp, int Wp, int D, int ws0, int ws1,
                             int ws2, int heads, int vec, cudaStream_t stream) {
  const long long rows = (long long)B * Cp * Hp * Wp;
  if (B <= 0 || (D != 512 && D != 1024 && D != 2048) || D != 64 * heads || rows > (1 << 24) ||
      ws0 * ws1 * ws2 != CORE_N || Cp <= 0 || Hp <= 0 || Wp <= 0 || Cp % ws0 || Hp % ws1 ||
      Wp % ws2)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
#ifndef ABLATE_ONLY_CORE
  CUtensorMap map_x, map_wqkv;
  if ((e = RowsRing::make_map_a(&map_x, x, (int)rows, D, (int)rows)) != cudaSuccess) return (int)e;
  if ((e = RowsRing::make_map_w(&map_wqkv, wqkv, D, 3 * D)) != cudaSuccess) return (int)e;
  const int err = launch_gemm_bias<EPI_QKV>(map_x, map_wqkv, bqkv, static_cast<bf16*>(qkv),
                                            nullptr, 3 * D, make_sched((int)rows, D, 3 * D),
                                            stream);
  if (err) return err;
#endif
#ifdef ABLATE_ONLY_QKV
  return (int)cudaSuccess;
#endif
  CUtensorMap map;
  if ((e = make_map_grid(&map, qkv, B, Cp, Hp, Wp, D, ws0, ws1, ws2)) != cudaSuccess) return (int)e;
  const int H1 = Hp / ws1, W1 = Wp / ws2, nW = (Cp / ws0) * H1 * W1;
  const GridWindows win{D, nW, H1, W1, Cp, Hp, Wp, ws0, ws1, ws2};
  const int units = B * nW * heads;
  bf16* ob = static_cast<bf16*>(out);
  if (vec)
    return launch_sdpa(map, GridStrips{win}, nullptr, ob, nW, D, heads, units, stream, W1);
  return launch_sdpa(map, win, nullptr, ob, nW, D, heads, units, stream);
}
