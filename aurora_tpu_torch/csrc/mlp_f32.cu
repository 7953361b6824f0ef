// K3, K8 and K5 in float32, for the facades' default config (float32 all through):
//   K3: the MLP branch of a block, out = x + LN(fc2(GELU(fc1 x))) * (scale_bias + scale[b])
//       + shift[b];
//   K8: the MLP alone, out = fc2(GELU(fc1 x)) (mlp_impl="pallas");
//   K5: the attention tail after un-windowing, out = shortcut + LN(x W + b) * (scale_bias +
//       scale[b]) + shift[b] (attention_impl="xla", mlp_impl="fused").
//
// Replaces the float32 forms of aurora_tpu/ops/mlp.py::mlp_adaln_residual_fused (pallas_call
// at mlp.py:419), mlp_fused (pallas_call at mlp.py:278) and linear_adaln_residual_fused
// (pallas_call at mlp.py:604), which compute in x.dtype, the MLPs with the accurate erf GELU
// for float32 (mlp.py:244,375). The functions, all in f32:
//   hid = gelu_erf(x W1 + b1);  y = hid W2 + b2;  K8: out = y;
//   K3: out = x + LN(y) (scale_bias + scale) + shift;
//   K5: y = x W + b (the kernel's rounding of y to x.dtype, mlp.py:595, is the identity);
//       out = shortcut + LN(y) (scale_bias + scale) + shift
// with a two-pass LayerNorm (eps given; K5's 1e-5, mlp.py:599) and the residual added last.
//
// Bounds on the H100 (stage 1 of the 0.25 degree model, (259200, 512), hidden 2048): K3 and
// K8 operations, 4 rows D Hd flops taken as three TF32 products at 495 TF/s (6.59 ms; at the
// FFMA pipes' 67 TF/s 16.2 ms; the bytes of x, out and the weights take 0.33 ms); K5
// operations, 2 rows D^2 flops as three TF32 products (0.824 ms at every stage of the 1.3 B
// model, 0.206 at the small model's D = 256 over 259200 rows; at 67 TF/s 2.03 and 0.507; its
// bytes 0.47 ms at stage 1, 0.24 at D = 256).
//
// Design. K3 / K8 / K5 on the tensor cores, each product in three TF32 parts (gemm_tf32x3_sm90.cuh:
// a persistent TMA + wgmma ring, the tokens split into hi and lo in registers, the weights'
// split transposes in shared memory): two launches once a call, then three a chunk of rows
// (two for K8):
//   0. once a call (the chunk at row_base 0): split_tf32_t_kernel, once for each weight,
//      writes W1^T's and W2^T's hi and lo into `wsplit` (4 D Hd f32; it reads 8 D Hd bytes
//      and writes 16 D Hd, 0.12 ms of memory time at stage 3's D Hd = 2048 x 8192). Made
//      anew every call: no cache to go stale under training or a served model's load;
//   1. fc1: gemm_tf32x3_kernel<EPI_BIAS_GELU> (x rows, W1^T split) into the hidden scratch,
//      rows x Hd f32 in at most 256 MB (the wrapper sizes the chunks);
//   2. fc2: gemm_tf32x3_kernel<EPI_BIAS> (the hidden, W2^T split) into out, K8's result;
//   3. K3 only: ln_rows_f32_kernel (gemm_f32.cuh, a warp a row) with x as the residual, in
//      place in out.
//   The hidden makes one round trip through device memory in f32, as in the bf16 form
//   (mlp.cu): 2.1 GB each way at stage 1, 0.63 ms a direction against the products' 6.6 ms.
//   Each split is made where its operand is read: the weights' once a call into scratch (the
//   wgmma's B operand has to sit K-major in shared memory, which the stored (in, out) weight
//   is not), the tokens' and the hidden's in registers (wgmma's A from registers), so no
//   split copy of the activations is written.
//   -DMLP_F32_FFMA builds the earlier FFMA design instead (gemm_f32_kernel<8,
//   EPI_BIAS_GELU> and <8, EPI_BIAS>; wsplit unused): tools/kernel_ablate.py's `ffma`.
//   K5 on the same ring, three launches a call: split_tf32_t_kernel writes W^T's hi and lo
//   into `wsplit` (2 D^2 f32, 33.6 MB at D = 2048; made anew every call), then
//   gemm_tf32x3_kernel<EPI_BIAS> (x rows, W^T split) into out, then ln_rows_f32_kernel with
//   the shortcut as the residual and FiLM row row / L, in place. -DLINEAR_F32_FFMA builds the
//   earlier design instead (gemm_f32_kernel<8, EPI_BIAS> on W as stored; wsplit unused).
//
// mlp_rows_f32 and linear_adaln_residual_f32 have the C signatures of mlp.cu's mlp_rows and
// linear_adaln_residual (stats is not used: the row kernel takes the LayerNorm statistics over
// the row it holds) with the split scratch before the stream, so the wrappers drive both
// dtypes alike; K8 is mlp_rows_f32 with ln = 0.
//
// tools/kernel_ablate.py builds copies with -DMLP_F32_FFMA and -DLINEAR_F32_FFMA (the FFMA
// forms of K3 / K8 and of K5), -DABLATE_ONE_PART (the lo products off: one TF32 product),
// -DABLATE_NO_SPLIT (the tokens unrounded as both parts), -DABLATE_ONLY_FC1,
// -DABLATE_ONLY_FC2 (one product alone, fc2 on what the scratch holds), -DABLATE_ONLY_SPLIT
// (the weights' split alone) and -DABLATE_ONLY_PRODUCT (K5 without its row kernel).
#include "gemm_f32.cuh"
#include "gemm_tf32x3_sm90.cuh"

// K3 (ln != 0) or K8 (ln == 0) on one chunk of rows. x, out: (rows, D) f32; w1:
// (D, Hd), w2: (Hd, D) f32 as stored; b1: (Hd,), b2: (D,) f32; hid: scratch of rows x Hd f32.
// With ln: shift, scale (batch, D) f32, row (row_base + row) / rows_per_batch of each.
// wsplit: scratch of 4 D Hd f32, W1^T's hi and lo (Hd, D) then W2^T's (D, Hd), written when
// row_base is 0 (a call's first chunk) and read by every chunk of the call. Takes D in {256,
// 512, 1024, 2048} and Hd % 256 == 0, Hd >= 512. Returns cudaGetLastError() of the last
// launch, cudaErrorInvalidValue for a shape it does not take, or cudaErrorUnknown where no
// tensor map could be encoded.
extern "C" int mlp_rows_f32(const float* x, const float* w1, const float* b1, const float* w2,
                            const float* b2, float* hid, float* out, float* stats,
                            const float* shift, const float* scale, float scale_bias, int rows,
                            long long row_base, long long rows_per_batch, int D, int Hd, float eps,
                            int ln, float* wsplit, cudaStream_t stream) {
  (void)stats;
  if (rows <= 0 || rows > (1 << 24) || (D != 256 && D != 512 && D != 1024 && D != 2048) ||
      Hd < 512 || Hd % 256 || (ln && rows_per_batch <= 0))
    return (int)cudaErrorInvalidValue;
  int err = 0;
#ifdef MLP_F32_FFMA
  (void)wsplit;
  err = f32k::launch_gemm_f32<8, f32k::EPI_BIAS_GELU>(f32k::Rows{x, D}, w1, b1, hid, rows, D, Hd,
                                                      stream);
  if (err) return err;
  err = f32k::launch_gemm_f32<8, f32k::EPI_BIAS>(f32k::Rows{hid, Hd}, w2, b2, out, rows, Hd, D,
                                                 stream);
#else
  float* w1s = wsplit;                          // (2 Hd, D): W1^T's hi, then its lo
  float* w2s = wsplit + 2ll * (long long)D * Hd;  // (2 D, Hd): W2^T's hi, then its lo
#if !defined(ABLATE_ONLY_FC1) && !defined(ABLATE_ONLY_FC2)
  if (row_base == 0) {
    if ((err = tf32x3::launch_split(w1, w1s, D, Hd, stream))) return err;
    if ((err = tf32x3::launch_split(w2, w2s, Hd, D, stream))) return err;
  }
#endif
#ifdef ABLATE_ONLY_SPLIT
  return err;
#endif
#ifndef ABLATE_ONLY_FC2
  err = tf32x3::launch_gemm<tf32x3::EPI_BIAS_GELU>(x, w1s, b1, hid, rows, D, Hd, stream);
  if (err) return err;
#endif
#ifdef ABLATE_ONLY_FC1
  return err;
#endif
  err = tf32x3::launch_gemm<tf32x3::EPI_BIAS>(hid, w2s, b2, out, rows, Hd, D, stream);
#ifdef ABLATE_ONLY_FC2
  return err;
#endif
#endif
  if (err || !ln) return err;
  return f32k::launch_ln_rows_f32(f32k::RowsF32{x}, out, shift, scale, scale_bias, rows, row_base,
                                  rows_per_batch, D, eps, stream);
}

// K5 in float32 on rows of tokens. x, shortcut, out: (rows, D) f32, rows_per_batch rows per
// FiLM row; w: (D, D) f32 as stored; b: (D,) f32; shift, scale: (rows / rows_per_batch, D) f32.
// stats is not used. wsplit: scratch of 2 D^2 f32, W^T's hi and lo, written and read by this
// call. Three launches. Takes D in {256, 512, 1024, 2048}. Returns cudaGetLastError() of the
// last launch, cudaErrorInvalidValue for a shape it does not take, or cudaErrorUnknown where
// no tensor map could be encoded.
extern "C" int linear_adaln_residual_f32(const float* x, const float* w, const float* b,
                                         const float* shortcut, const float* shift,
                                         const float* scale, float scale_bias, float* stats,
                                         float* out, int rows, long long rows_per_batch, int D,
                                         float eps, float* wsplit, cudaStream_t stream) {
  (void)stats;
  if (rows <= 0 || rows > (1 << 24) || (D != 256 && D != 512 && D != 1024 && D != 2048) ||
      rows_per_batch <= 0)
    return (int)cudaErrorInvalidValue;
  int err;
#ifdef LINEAR_F32_FFMA
  (void)wsplit;
  err = f32k::launch_gemm_f32<8, f32k::EPI_BIAS>(f32k::Rows{x, D}, w, b, out, rows, D, D, stream);
#else
  if ((err = tf32x3::launch_split(w, wsplit, D, D, stream))) return err;
  err = tf32x3::launch_gemm<tf32x3::EPI_BIAS>(x, wsplit, b, out, rows, D, D, stream);
#endif
#ifdef ABLATE_ONLY_PRODUCT
  return err;
#endif
  if (err) return err;
  return f32k::launch_ln_rows_f32(f32k::RowsF32{shortcut}, out, shift, scale, scale_bias, rows, 0,
                                  rows_per_batch, D, eps, stream);
}
