// K4 in float32: the shared-query perceiver attention core of the level (de-)aggregation
// with value_bf16 off, for the facades' default config (float32 all through).
//
// Replaces the value_bf16=False form of aurora_tpu/ops/resampler.py::perceiver_core_fused
// (pallas_call at resampler.py:254; the form at resampler.py:119-131). The function, per token
// column m of the k-major context ctx (K, M, D), all in f32:
//   k = ctx Wk; with ln_k, k = LN(k) over all `inner` (eps 1e-5, f32 affine)
//   logits[k, q, h] = scale sum_d k[h dh + d] qh[q, h, d]; w = softmax over K
//   v = ctx Wv; o[q, h] = sum over k, in level order, of w v (each product and partial sum
//   rounded once, as the plain version's separate multiply and add)
//   out[q] = LN(o[q] Wout) ln1_w + ln1_b + queries[q]
//
// The fold, as in the bf16 form (resampler.cu): k enters only through the logits, so
// logits = ctx Wkq with Wkq[c, (q, h)] = scale sum_d Wk[c, h dh + d] qh[q, h, d]; with ln_k,
// k - mean(k) = ctx Wc (Wc = Wk less each row's mean), logits = rstd (ctx Wkq') + const with
// lnk_w folded into Wkq' and const from lnk_b, and rstd from the sums of squares of ctx Wc,
// which here is an f32 product (the bf16 form splits it into three bf16 parts on the tensor
// cores). Sums of the fold in f64.
//
// Bound on the H100: operations at 67 TF/s, of the folded work: the logits 2 K M D Q h, v
// 2 K M D inner, the out-projection 2 M Q inner D_out (with ln_k also ctx Wc, 2 K M D inner):
// 8.7 ms at the aggregation shape ((13, 64800, 512), Q 3, 16 heads; ln_k 15.3), 33.7 ms at the
// de-aggregation's ((3, 64800, 1024), Q 13).
//
// Launches, all on the caller's stream, on gemm_f32.cuh; 0 once a call, 1-6 once for each
// chunk of columns (the wrapper sizes the chunks so that the scratch stays under a cap):
//   0. fold_f32_kernel, one block a row c of Wk: Wkq (or Wkq') into wb (D, NLP) f32, the Q h
//      logit columns padded to NLP, a multiple of 64; with ln_k also const (Q h) and Wc into
//      wc (D, inner) f32.
//   1. logits: gemm_f32_kernel<4, EPI_PLAIN> on the chunk's context rows (k, m) read in place
//      (GroupedRows: K groups of Mc rows, M D floats apart) and wb: (K Mc, NLP) f32.
//   2. with ln_k, gemm_f32_kernel<8, EPI_SUMSQ> on the same rows and wc: each row's sum of
//      squares per 128-column tile, (K Mc, inner / 128).
//   3. v: gemm_f32_kernel<8, EPI_PLAIN> on the same rows and Wv (D, inner) as stored.
//   4. mix_f32_kernel, a thread per (column, head, 8 of dh): the column's K x 8 values of v in
//      registers; per query the softmax over K (with ln_k: rstd times the raw logit plus
//      const), the level-order sum; o (Mc, Q, inner) f32. A bandwidth pass.
//   5. out-projection: gemm_f32_kernel<8, EPI_PLAIN> on o as (Mc Q, inner) rows and Wout
//      (inner, D_out) as stored, into out.
//   6. ln_rows_f32_kernel<PeriodicF32>: ln1_w as the gain (scale_bias 0, one FiLM row for all
//      rows), ln1_b as the shift, the query of the row (period Q) as the residual, in place.
// The logits product computes NLP columns of which Q h are real (48 of 64 at the
// aggregation): 4/3 of its work, 0.2 ms of f32 time at the aggregation shape.
#include "gemm_f32.cuh"

namespace {

__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// Launch 0. wk: (D, inner) f32; qh: (Q, inner) f32; lnk_w, lnk_b: (inner,) f32 or null.
// wb: (D, NLP) f32; with ln_k only: cst (Q h,) f32 and wc (D, inner) f32.
__global__ void __launch_bounds__(256) fold_f32_kernel(
    const float* __restrict__ wk, const float* __restrict__ qh, const float* __restrict__ lnk_w,
    const float* __restrict__ lnk_b, int inner, int dh, int QH, int heads, int NLP, float scale,
    float* __restrict__ wb, float* __restrict__ cst, float* __restrict__ wc) {
  extern __shared__ double w[];  // [inner]: the row's (centred, lnk_w-scaled) weights
  __shared__ double red[8];
  const int c = blockIdx.x, tid = threadIdx.x;
  const float* row = wk + (long long)c * inner;
  double mean = 0.0;
  if (lnk_w) {
    double s = 0.0;
    for (int j = tid; j < inner; j += blockDim.x) s += row[j];
    mean = block_sum(s, red) / inner;
  }
  for (int j = tid; j < inner; j += blockDim.x) {
    const double centred = (double)row[j] - mean;
    if (lnk_w) {
      wc[(long long)c * inner + j] = (float)centred;
      w[j] = centred * lnk_w[j];
    } else {
      w[j] = centred;
    }
  }
  __syncthreads();
  for (int col = tid; col < NLP; col += blockDim.x) {
    float val = 0.f;
    if (col < QH) {
      const int q = col / heads, h = col % heads;
      const float* qv = qh + (long long)q * inner + h * dh;
      double s = 0.0;
      for (int d = 0; d < dh; ++d) s += w[h * dh + d] * qv[d];
      val = (float)(scale * s);
    }
    wb[(long long)c * NLP + col] = val;
  }
  if (lnk_b && c == 0) {
    for (int col = tid; col < QH; col += blockDim.x) {
      const int q = col / heads, h = col % heads;
      const float* qv = qh + (long long)q * inner + h * dh;
      double s = 0.0;
      for (int d = 0; d < dh; ++d) s += (double)lnk_b[h * dh + d] * qv[d];
      cst[col] = (float)(scale * s);
    }
  }
}

// Launch 4. v: (K Mc, inner) f32; logits: (K Mc, NLP) f32; with ln_k sq (K Mc, n_sq) and cst
// (Q heads), else both null; o: (Mc, Q, inner) f32.
template <int K, int DH>
__global__ void __launch_bounds__(256) mix_f32_kernel(
    const float* __restrict__ v, const float* __restrict__ logits, const float* __restrict__ sq,
    const float* __restrict__ cst, int Mc, int heads, int Q, int NLP, int n_sq,
    float* __restrict__ o) {
  constexpr int G = DH / 8;  // threads a head
  const int inner = heads * DH, per_col = inner / 8, cols = 256 / per_col;
  const int tid = threadIdx.x, mi = tid / per_col, t = tid % per_col, h = t / G, g = t % G;
  const long long mb = (long long)blockIdx.x * cols, m = mb + mi;
  __shared__ float rs[K * 8];  // rstd of each (level, column of the block); cols <= 8
  if (sq) {
    for (int i = tid; i < K * cols; i += 256) {
      const int kk = i / cols, c = i % cols;
      float s = 0.f;
      if (mb + c < Mc) {
        const float* src = sq + ((long long)kk * Mc + mb + c) * n_sq;
        for (int j = 0; j < n_sq; ++j) s += src[j];
      }
      rs[i] = rsqrtf(s / inner + 1e-5f);
    }
    __syncthreads();
  }
  if (mi >= cols || m >= Mc) return;
  float4 vr[K][2];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const float* src = v + ((long long)kk * Mc + m) * inner + h * DH + 8 * g;
    vr[kk][0] = *reinterpret_cast<const float4*>(src);
    vr[kk][1] = *reinterpret_cast<const float4*>(src + 4);
  }
  for (int q = 0; q < Q; ++q) {
    const int col = q * heads + h;
    float l[K];
    float mx = -3.0e38f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float x = logits[((long long)kk * Mc + m) * NLP + col];
      if (sq) x = rs[kk * cols + mi] * x + cst[col];
      l[kk] = x;
      mx = fmaxf(mx, x);
    }
    float ssum = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      l[kk] = expf(l[kk] - mx);
      ssum += l[kk];
    }
    // w v in level order, each product and each partial sum rounded once (the _rn forms keep
    // ptxas from contracting them into an fma).
    float ov[8];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float wk = l[kk] / ssum;
      const float vv[8] = {vr[kk][0].x, vr[kk][0].y, vr[kk][0].z, vr[kk][0].w,
                           vr[kk][1].x, vr[kk][1].y, vr[kk][1].z, vr[kk][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = __fmul_rn(wk, vv[i]);
        ov[i] = kk == 0 ? p : __fadd_rn(ov[i], p);
      }
    }
    float* dst = o + (m * Q + q) * inner + h * DH + 8 * g;
    *reinterpret_cast<float4*>(dst) = make_float4(ov[0], ov[1], ov[2], ov[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(ov[4], ov[5], ov[6], ov[7]);
  }
}

template <int K, int DH>
int launch_mix_f32(const float* v, const float* logits, const float* sq, const float* cst,
                   int Mc, int heads, int Q, int NLP, int n_sq, float* o, cudaStream_t stream) {
  const int cols = 256 / (heads * DH / 8);
  mix_f32_kernel<K, DH><<<(Mc + cols - 1) / cols, 256, 0, stream>>>(v, logits, sq, cst, Mc,
                                                                    heads, Q, NLP, n_sq, o);
  return (int)cudaGetLastError();
}

}  // namespace

// ctx: (K, M, D) f32; wk, wv: (D, inner) f32 and wout: (inner, D_out) f32, all as stored; qh:
// (Q, inner) f32; ln_w, ln_b: (D_out,) f32; qres: (Q, D_out) f32; lnk_w, lnk_b: (inner,) f32,
// or both null (no ln_k). Scratch: wb (D, NLP) f32, NLP = Q heads rounded up to 64; with ln_k
// cst (Q heads) and wc (D, inner) f32; for Mc columns v (K Mc, inner), logits (K Mc, NLP), with
// ln_k sq (K Mc, inner / 128), o (Mc, Q, inner), all f32. out: (M, Q, D_out) f32. The columns
// go in chunks of Mc. Takes (K, dh) in {(13, 32), (3, 64)}, D % 64 == 0, inner % 256 == 0 up
// to 2048, D_out in {256, 512, 1024, 2048}. Returns cudaGetLastError() of the last launch, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int perceiver_core_f32(const float* ctx, const float* wk, const float* wv,
                                  const float* qh, const float* wout, const float* ln_w,
                                  const float* ln_b, const float* qres, const float* lnk_w,
                                  const float* lnk_b, float* wb, float* cst, float* wc, float* v,
                                  float* logits, float* sq, float* o, float* out, int K, int M,
                                  int Mc, int D, int heads, int dh, int Q, int D_out, float scale,
                                  float eps, cudaStream_t stream) {
  const int inner = heads * dh, QH = Q * heads, NLP = (QH + 63) / 64 * 64, n_sq = inner / 128;
  const bool kd13 = K == 13 && dh == 32, kd3 = K == 3 && dh == 64;
  if ((!kd13 && !kd3) || M <= 0 || Mc <= 0 || D <= 0 || D % 64 || inner % 256 || inner > 2048 ||
      (D_out != 256 && D_out != 512 && D_out != 1024 && D_out != 2048) ||
      (long long)Mc * Q > (1 << 24) || (lnk_w == nullptr) != (lnk_b == nullptr))
    return (int)cudaErrorInvalidValue;
  int err;
  fold_f32_kernel<<<D, 256, inner * sizeof(double), stream>>>(wk, qh, lnk_w, lnk_b, inner, dh, QH,
                                                             heads, NLP, scale, wb, cst, wc);
  if ((err = (int)cudaGetLastError())) return err;
  for (int m0 = 0; m0 < M; m0 += Mc) {
    const int mc = M - m0 < Mc ? M - m0 : Mc, R = K * mc, rows = mc * Q;
    const f32k::GroupedRows a{ctx + (long long)m0 * D, (long long)M * D, mc, D};
    if ((err = f32k::launch_gemm_f32<4, f32k::EPI_PLAIN>(a, wb, nullptr, logits, R, D, NLP,
                                                         stream)))
      return err;
    if (lnk_w && (err = f32k::launch_gemm_f32<8, f32k::EPI_SUMSQ>(a, wc, nullptr, sq, R, D, inner,
                                                                  stream)))
      return err;
    if ((err = f32k::launch_gemm_f32<8, f32k::EPI_PLAIN>(a, wv, nullptr, v, R, D, inner, stream)))
      return err;
    const float* sqp = lnk_w ? sq : nullptr;
    const float* cp = lnk_w ? cst : nullptr;
    err = kd13 ? launch_mix_f32<13, 32>(v, logits, sqp, cp, mc, heads, Q, NLP, n_sq, o, stream)
               : launch_mix_f32<3, 64>(v, logits, sqp, cp, mc, heads, Q, NLP, n_sq, o, stream);
    if (err) return err;
    float* oc = out + (long long)m0 * Q * D_out;
    if ((err = f32k::launch_gemm_f32<8, f32k::EPI_PLAIN>(f32k::Rows{o, inner}, wout, nullptr, oc,
                                                         rows, inner, D_out, stream)))
      return err;
    // The chunk starts at a column, so its row r is query r % Q; one FiLM row for all.
    if ((err = f32k::launch_ln_rows_f32(f32k::PeriodicF32{qres, Q}, oc, ln_b, ln_w, 0.f, rows, 0,
                                        1ll << 62, D_out, eps, stream)))
      return err;
  }
  return 0;
}
