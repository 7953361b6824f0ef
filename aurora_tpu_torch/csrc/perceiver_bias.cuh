// K4's bias inputs (aurora_tpu/ops/resampler.py:125-134: bk on the f32 k, bv on v, bout on
// the out-projection), folded once a call beside the weights' fold. resampler.cu (bf16 values)
// and resampler_f32.cu include it.
//
// bk reaches the result only through the logits and, with ln_k, through k's statistics:
//   without ln_k  logits = ctx Wkq + cb,          cb[(q, h)] = scale sum_d bk[h dh + d] qh[q, h, d]
//   with ln_k     k - mean(k) = ctx Wc + bc,      bc = bk - mean(bk)
//                 logits = rstd (ctx Wkq' + cb) + const, cb with bc lnk_w in place of bk,
//                 rstd from the sums of squares of ctx Wc + bc.
// So the kernels add cb to the raw logits (before rstd) and bc to each column of ctx Wc before
// it is squared. bv and bout are added where the TPU kernel adds them, in the epilogues of the v
// product and the out-projection.
#pragma once

#include "common.cuh"

namespace {

// One block of 256 threads. bk: (inner,) f32 or null; bv: (inner,) f32 or null; lnk_w:
// (inner,) f32 or null (no ln_k); qh: (Q, inner) f32. Writes cb (NLP,) f32 (zero past Q heads,
// and all zero without bk); bc (inner,) f32 if not null (the centred bk, zero without bk);
// bv_out (inner,) f32 if not null (bv, or zeros without it). Sums in f64.
__global__ void __launch_bounds__(256) bias_fold_kernel(
    const float* __restrict__ bk, const float* __restrict__ bv, const float* __restrict__ lnk_w,
    const float* __restrict__ qh, int inner, int dh, int QH, int heads, int NLP, float scale,
    float* __restrict__ cb, float* __restrict__ bc, float* __restrict__ bv_out) {
  extern __shared__ double bw[];  // [inner]: the (centred, lnk_w-scaled) bk
  __shared__ double red[8];
  const int tid = threadIdx.x;
  double mean = 0.0;
  if (bk && lnk_w) {
    double s = 0.0;
    for (int j = tid; j < inner; j += 256) s += bk[j];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((tid & 31) == 0) red[tid >> 5] = s;
    __syncthreads();
    for (int i = 0; i < 8; ++i) mean += red[i];
    mean /= inner;
  }
  for (int j = tid; j < inner; j += 256) {
    const double b = bk ? (double)bk[j] - mean : 0.0;
    bw[j] = lnk_w ? b * lnk_w[j] : b;
    if (bc) bc[j] = (float)b;
    if (bv_out) bv_out[j] = bv ? bv[j] : 0.f;
  }
  __syncthreads();
  for (int col = tid; col < NLP; col += 256) {
    float val = 0.f;
    if (col < QH) {
      const int q = col / heads, h = col % heads;
      const float* qv = qh + (long long)q * inner + h * dh;
      double s = 0.0;
      for (int d = 0; d < dh; ++d) s += bw[h * dh + d] * qv[d];
      val = (float)(scale * s);
    }
    cb[col] = val;
  }
}

inline int launch_bias_fold(const float* bk, const float* bv, const float* lnk_w,
                            const float* qh, int inner, int dh, int QH, int heads, int NLP,
                            float scale, float* cb, float* bc, float* bv_out,
                            cudaStream_t stream) {
  bias_fold_kernel<<<1, 256, inner * sizeof(double), stream>>>(
      bk, bv, lnk_w, qh, inner, dh, QH, heads, NLP, scale, cb, bc, bv_out);
  return (int)cudaGetLastError();
}

}  // namespace
