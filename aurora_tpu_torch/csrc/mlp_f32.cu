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
// K8 operations, 4 rows D Hd f32 flops at 67 TF/s (16.2 ms; the bytes of x, out and the
// weights take 0.33 ms); K5 operations, 2 rows D^2 (2.03 ms at every stage; its bytes 0.47 ms
// at stage 1).
//
// Design, on gemm_f32.cuh (the simple FFMA design; the tensor cores would need TF32 in three
// parts to keep f32's digits, later work):
//   K3 / K8, three launches a chunk of rows (two for K8):
//   1. fc1: gemm_f32_kernel<8, EPI_BIAS_GELU> (x rows, W1 (D, Hd) as stored) into the hidden
//      scratch, rows x Hd f32 in at most 256 MB (the wrapper sizes the chunks);
//   2. fc2: gemm_f32_kernel<8, EPI_BIAS> (the hidden, W2 (Hd, D) as stored) into out, which
//      is K8's result;
//   3. K3 only: ln_rows_f32_kernel (a warp a row) with x as the residual, in place in out.
//   The hidden makes one round trip through device memory, as in the bf16 form (mlp.cu): at
//   f32 it is 2.1 GB each way at stage 1, 0.63 ms a direction against the products' 16.2 ms.
//   K5, two launches: gemm_f32_kernel<8, EPI_BIAS> (x rows, W (D, D) as stored) into out,
//   then ln_rows_f32_kernel with the shortcut as the residual and FiLM row row / L, in place.
//
// mlp_rows_f32 and linear_adaln_residual_f32 have the C signatures of mlp.cu's mlp_rows and
// linear_adaln_residual (stats is not used: the row kernel takes the LayerNorm statistics over
// the row it holds), so the wrappers drive both dtypes alike; K8 is mlp_rows_f32 with ln = 0.
#include "gemm_f32.cuh"

// K3 (ln != 0) or K8 (ln == 0) on one chunk of rows. x, out: (rows, D) f32; w1:
// (D, Hd), w2: (Hd, D) f32 as stored; b1: (Hd,), b2: (D,) f32; hid: scratch of rows x Hd f32.
// With ln: shift, scale (batch, D) f32, row (row_base + row) / rows_per_batch of each. Takes D
// in {256, 512, 1024, 2048} and Hd % 256 == 0, Hd >= 512. Returns cudaGetLastError() of the
// last launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int mlp_rows_f32(const float* x, const float* w1, const float* b1, const float* w2,
                            const float* b2, float* hid, float* out, float* stats,
                            const float* shift, const float* scale, float scale_bias, int rows,
                            long long row_base, long long rows_per_batch, int D, int Hd, float eps,
                            int ln, cudaStream_t stream) {
  (void)stats;
  if (rows <= 0 || rows > (1 << 24) || (D != 256 && D != 512 && D != 1024 && D != 2048) ||
      Hd < 512 || Hd % 256 || (ln && rows_per_batch <= 0))
    return (int)cudaErrorInvalidValue;
  int err = f32k::launch_gemm_f32<8, f32k::EPI_BIAS_GELU>(f32k::Rows{x, D}, w1, b1, hid, rows, D,
                                                          Hd, stream);
  if (err) return err;
  err = f32k::launch_gemm_f32<8, f32k::EPI_BIAS>(f32k::Rows{hid, Hd}, w2, b2, out, rows, Hd, D,
                                                 stream);
  if (err || !ln) return err;
  return f32k::launch_ln_rows_f32(f32k::RowsF32{x}, out, shift, scale, scale_bias, rows, row_base,
                                  rows_per_batch, D, eps, stream);
}

// K5 in float32 on rows of tokens. x, shortcut, out: (rows, D) f32, rows_per_batch rows per
// FiLM row; w: (D, D) f32 as stored; b: (D,) f32; shift, scale: (rows / rows_per_batch, D) f32.
// stats is not used. Two launches. Takes D in {256, 512, 1024, 2048}. Returns
// cudaGetLastError() of the last launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int linear_adaln_residual_f32(const float* x, const float* w, const float* b,
                                         const float* shortcut, const float* shift,
                                         const float* scale, float scale_bias, float* stats,
                                         float* out, int rows, long long rows_per_batch, int D,
                                         float eps, cudaStream_t stream) {
  (void)stats;
  if (rows <= 0 || rows > (1 << 24) || (D != 256 && D != 512 && D != 1024 && D != 2048) ||
      rows_per_batch <= 0)
    return (int)cudaErrorInvalidValue;
  const int err = f32k::launch_gemm_f32<8, f32k::EPI_BIAS>(f32k::Rows{x, D}, w, b, out, rows, D,
                                                           D, stream);
  if (err) return err;
  return f32k::launch_ln_rows_f32(f32k::RowsF32{shortcut}, out, shift, scale, scale_bias, rows, 0,
                                  rows_per_batch, D, eps, stream);
}
