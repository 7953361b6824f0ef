// K2 and K6: window attention over 144-token windows with a head dim of 64, with the block's
// optional tail.
//
// Replaces two TPU kernels of aurora_tpu/model/swin3d.py that share one body
// (_qkv_attn_tail_body, swin3d.py:561-596, and its core _heads_attention, :524-558):
//   K2 _attn_windows_5d_fused_pallas (pallas_call at :924): qkv, attention and the optional
//      block tail on windows read in place from the padded (B, Cp, Hp, Wp, D) tokens;
//   K6 _attn_windows_qkv_fused_pallas (pallas_call at :772): the same on pre-partitioned
//      (B, nW, 144, D) windows.
// The function:
//   qkv  = bf16(bf16(x Wqkv) + bqkv)                 the bf16 bias added after the rounding
//   attn = per head: f32 logits q.k / 8 (+0 / -100 by group id), f32 softmax, weights
//          rounded to bf16, w @ v rounded
//   tail: y = bf16(attn Wproj + bproj), bproj f32; out = bf16(x + LN(y) scale[b] + shift[b])
//         with a two-pass-equivalent f32 LayerNorm (eps 1e-5); without the tail attn is
//         the result.
//
// Bound on the H100: operations, the qkv product, logits, w @ v and proj in bf16 at
// 989 TF/s (stage 1 of the 0.25 deg model: 0.41 + 0.08 + 0.14 TFLOP, 0.63 ms a call).
//
// Design: four launches on the shared Hopper headers, all on the caller's stream.
//   1. qkv: gemm_bias_kernel<EPI_QKV> (gemm_rows_sm90.cuh), the persistent TMA + wgmma
//      ring of gemm_sm90.cuh with (2 x 64) x 256 tiles and 4 stages. A is the token rows in
//      their stored order (K2: the padded 5D grid as (B Cp Hp Wp, D) rows; K6: (B nW 144, D)),
//      a ragged last 64-row piece zero-filled by the 3D map; W is Wqkv (D, 3D) as stored, an
//      MN-major operand (3D = 768 / 1536 / 3072 / 6144 is a multiple of 256). The epilogue rounds,
//      adds the bf16 bias, rounds again and stores through each warp's swizzled staging into
//      the qkv scratch (rows, 3D) bf16 that the wrapper allocates.
//   2. core: the ring kernel of sdpa_sm90.cuh (K7's: two blocks of 9 warps an SM, a 2-stage
//      ring of q/k/v boxes refilled by the last warp to finish, the ldmatrix core with mask
//      bits). K6 reads the scratch's packed rows through a 2D map (box {64, 144}); K2 reads
//      each window in place through a 5D map of the scratch, dims {3D, Wp, Hp, Cp, B},
//      box {64, ws2, ws1, ws0, 1} at (part D + head 64, w1 ws2, h1 ws1, c1 ws0, b), which
//      lands in shared memory in window_partition's token order. Each token's result goes to
//      its own row (K2: its row of the 5D grid). Pad tokens of a padded grid are rows like any
//      other; in masked blocks their own group id keeps them apart.
//   3. tail, proj: gemm_bias_kernel<EPI_BIAS_STATS> (K3's fc2) with K = N = D: Wproj (D, D)
//      as stored, bproj f32, y into `out`, per row and 256-column tile the mean and centred
//      sum of squares into the stats scratch.
//   4. tail, rows: ln_rows_kernel (K3's) with the block input x as the residual, scale_bias
//      0 and FiLM row row / (nW 144) (K2: Cp Hp Wp rows a batch element), in place in `out`.
//
// Why qkv makes one round trip through device memory. Fusing the projection into the core
// would re-read each window's rows once per head (2.1-2.4 GB from L2 a call) and pad 144 rows
// to 192 on wgmma's 64-row tiles; the TPU kept a whole window's qkv in VMEM, which a 227 KB
// block cannot (144 x 3D bf16 is 442 KB at D = 512). The round trip costs 1.6 / 0.8 /
// 0.45 GB a call at stages 1 / 2 / 3 (~0.48 / 0.24 / 0.14 ms at 3.35 TB/s); the ablation
// build -DABLATE_ONLY_CORE measures what it costs inside the core (tools/kernel_ablate.py).
// The attention output makes a second round trip to the tail's proj (0.53 GB at stage 1),
// because LayerNorm needs whole D-wide rows over all heads.
//
// Scratch, all allocated by the wrapper: qkv (rows, 3D) bf16; with the tail, attn (rows, D)
// bf16 and stats (rows, D / 256) float2. Alignment: every pointer 16-byte aligned (the
// tensor maps' bases and the 16-byte row stores need it; the wrapper checks).
//
// tools/kernel_ablate.py builds copies with -DABLATE_ONLY_QKV, -DABLATE_ONLY_CORE (the core
// on what the scratch holds), -DABLATE_ONLY_TAIL (launches 3-4 on what attn holds) and
// -DABLATE_NO_LOADS (every TMA load of launches 1-3 off); ONLY_QKV with -DABLATE_NO_EPILOGUE
// (the product without its store) and ONLY_CORE with NO_LOADS (the core without reading the
// scratch) give the two halves of the qkv round trip.
#include "gemm_rows_sm90.cuh"
#include "sdpa_sm90.cuh"

namespace {

// The core of launch 2 over the qkv scratch; its result to attn (D-wide rows).
int launch_core(const void* qkv, const int* groups, bf16* attn, int B, int nW, int Cp, int Hp,
                int Wp, int D, int ws0, int ws1, int ws2, int heads, cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t e;
  const int units = B * nW * heads;
  if (Cp == 0) {
    if ((e = make_map_packed(&map, qkv, (long long)B * nW * CORE_N, D)) != cudaSuccess)
      return (int)e;
    return launch_sdpa(map, PackedRows{D}, groups, attn, nW, D, heads, units, stream);
  }
  if ((e = make_map_grid(&map, qkv, B, Cp, Hp, Wp, D, ws0, ws1, ws2)) != cudaSuccess) return (int)e;
  const GridWindows win{D, nW, Hp / ws1, Wp / ws2, Cp, Hp, Wp, ws0, ws1, ws2};
  return launch_sdpa(map, win, groups, attn, nW, D, heads, units, stream);
}

}  // namespace

// K2 (Cp > 0: x, attn, out are (B, Cp, Hp, Wp, D) with windows (ws0, ws1, ws2) in place) and
// K6 (Cp == 0: (B, nW, 144, D) windows). wqkv: (D, 3D) bf16 as stored; bqkv: (3D,) bf16;
// groups: (nW, 144) int32 or null; qkv: scratch (rows, 3D) bf16. With wproj set, the tail:
// wproj (D, D) bf16 as stored, bproj (D,) f32, shift/scale (B, D) f32, attn and stats
// (rows, D / 256) float2 scratch, the result in out; without it (wproj null) the result is
// attn and stats, out are unused. D in {256, 512, 1024, 2048}, D = 64 heads. Returns
// cudaGetLastError() of the last launch, cudaErrorInvalidValue for a shape it does not take,
// or cudaErrorUnknown where no tensor map could be encoded.
extern "C" int window_attention(const void* x, const void* wqkv, const void* bqkv,
                                const int* groups, const void* wproj, const float* bproj,
                                const float* shift, const float* scale, void* qkv, void* attn,
                                float* stats, void* out, int B, int nW, int Cp, int Hp, int Wp,
                                int D, int ws0, int ws1, int ws2, int heads, float eps,
                                cudaStream_t stream) {
  const long long rows = (long long)B * nW * CORE_N;
  if (B <= 0 || nW <= 0 || (D != 256 && D != 512 && D != 1024 && D != 2048) ||
      D != 64 * heads || rows > (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (Cp > 0 && (ws0 * ws1 * ws2 != CORE_N || Cp % ws0 || Hp % ws1 || Wp % ws2 ||
                 (Cp / ws0) * (Hp / ws1) * (Wp / ws2) != nW))
    return (int)cudaErrorInvalidValue;
  int err;
  cudaError_t e;
  bf16* attn_b = static_cast<bf16*>(attn);
#if !defined(ABLATE_ONLY_CORE) && !defined(ABLATE_ONLY_TAIL)
  CUtensorMap map_x, map_wqkv;
  if ((e = RowsRing::make_map_a(&map_x, x, (int)rows, D, (int)rows)) != cudaSuccess) return (int)e;
  if ((e = RowsRing::make_map_w(&map_wqkv, wqkv, D, 3 * D)) != cudaSuccess) return (int)e;
  err = launch_gemm_bias<EPI_QKV>(map_x, map_wqkv, bqkv, static_cast<bf16*>(qkv), nullptr, 3 * D,
                                  make_sched((int)rows, D, 3 * D), stream);
  if (err) return err;
#endif
#ifdef ABLATE_ONLY_QKV
  return (int)cudaSuccess;
#endif
#ifndef ABLATE_ONLY_TAIL
  err = launch_core(qkv, groups, attn_b, B, nW, Cp, Hp, Wp, D, ws0, ws1, ws2, heads, stream);
  if (err) return err;
#endif
#ifdef ABLATE_ONLY_CORE
  return (int)cudaSuccess;
#endif
  if (!wproj) return (int)cudaSuccess;
  CUtensorMap map_attn, map_wproj;
  if ((e = RowsRing::make_map_a(&map_attn, attn, (int)rows, D, (int)rows)) != cudaSuccess)
    return (int)e;
  if ((e = RowsRing::make_map_w(&map_wproj, wproj, D, D)) != cudaSuccess) return (int)e;
  bf16* ob = static_cast<bf16*>(out);
  err = launch_gemm_bias<EPI_BIAS_STATS>(map_attn, map_wproj, bproj, ob,
                                         reinterpret_cast<float2*>(stats), D,
                                         make_sched((int)rows, D, D), stream);
  if (err) return err;
  ln_rows_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      RowsResidual{static_cast<const bf16*>(x)}, ob, reinterpret_cast<const float2*>(stats),
      shift, scale, 0.f, (int)rows, 0, (long long)nW * CORE_N, D, eps);
  return (int)cudaGetLastError();
}
