// K2 and K6: window attention over 144-token windows with a head dim of 64.
//
// Replaces two TPU kernels of aurora_tpu/model/swin3d.py that share one body
// (_qkv_attn_tail_body, swin3d.py:561-596, and its core _heads_attention, :524-558):
//   K2 _attn_windows_5d_fused_pallas (pallas_call at :924): qkv, attention and the optional
//      block tail on windows read in place from the padded (B, Cp, Hp, Wp, D) tokens;
//   K6 _attn_windows_qkv_fused_pallas (pallas_call at :772): the same on pre-partitioned
//      (B, nW, N, D) windows.
// (K7, the attention core alone on packed qkv, is a kernel of its own: sdpa.cu.)
//
// Bound on the H100: operations (the qkv GEMM, logits, w@v and proj in bf16; ~0.5 ms at
// 989 TF/s for a stage-1 block of the 0.25 deg model). A 144 x D window is 590 KB at
// D = 2048, far beyond the 227 KB of shared memory a block has, and the tail's LayerNorm
// needs whole D-wide rows across all heads, so the work is split in two launches:
//
// (a) window_attn_kernel: one block of 9 warps per (window, head). Warp w owns tokens
//     16w..16w+15 of the window (144 = 9 x 16). A block first works out the row of each of
//     its tokens: in place in the 5D grid (K2) or consecutive rows of a partitioned window
//     (K6). The window rows stream through shared memory in k-steps of 32
//     together with the head's (3 x 64) x 32 weight slice; the qkv product runs on bf16
//     mma.sync with f32 accumulation and is rounded, then the bf16 bias is added and
//     rounded again (swin3d.py:573-577). q, k and v^T of the head (144 x 64 each) stay in shared
//     memory. The logits of a warp's 16 query rows live in registers (f32, scaled by
//     1/sqrt(64), plus 0 / -100 from the (nW, N) group ids), the softmax is f32 with the
//     rows reduced across each quad, the weights are rounded to bf16 and fed straight from
//     the accumulators into the w@v product as A fragments. The head's slice of the rounded
//     output goes to its token's row of a D-wide output. Neither qkv nor the logits reach
//     device memory.
// (b) with the tail only, the row kernel of row_tail.cuh: proj with the f32 bias, rounded;
//     two-pass f32 LN; FiLM scale/shift per batch element; + the block input; rounded.
//     Without the tail (swin3d.py:1286-1298, :347-352) launch (a)'s output is the result.
//
// The round trip of the attention output between (a) and (b) is the first thing a later
// design removes.
#include "row_tail.cuh"
#include "window_attention.cuh"

// K2 (Cp > 0: x, attn, out are (B, Cp, Hp, Wp, D) with windows ws in place) and K6 (Cp == 0:
// (B, nW, 144, D) windows). wqkv_t: (3D, D) bf16; bqkv: (3D,) bf16; groups: (nW, 144) int32
// or null. With wproj_t set, the tail: wproj_t (D, D) bf16, bproj (D,) f32, shift/scale
// (B, D) f32, result in out; without it (wproj_t null) the result is attn and out is unused.
// Returns cudaGetLastError().
extern "C" int window_attention(const void* x, const void* wqkv_t, const void* bqkv,
                                const int* groups, const void* wproj_t, const float* bproj,
                                const float* shift, const float* scale, void* attn, void* out,
                                int B, int nW, int Cp, int Hp, int Wp, int D, int ws0, int ws1,
                                int ws2, int heads, float eps, cudaStream_t stream) {
  if (Cp > 0 && (ws0 * ws1 * ws2 != WN || (Cp / ws0) * (Hp / ws1) * (Wp / ws2) != nW))
    return (int)cudaErrorInvalidValue;
  int err = launch_attn(x, wqkv_t, bqkv, groups, attn, B, nW, Cp, Hp, Wp, D, ws0, ws1, ws2, heads,
                        stream);
  if (err || !wproj_t) return err;
  const long long per_batch = (long long)nW * WN;
  return launch_gemm_ln_rows(static_cast<const bf16*>(attn), static_cast<const bf16*>(wproj_t),
                             bproj, static_cast<const bf16*>(x), nullptr, 0, scale, shift,
                             per_batch, B * per_batch, D, D, eps, static_cast<bf16*>(out), stream);
}
