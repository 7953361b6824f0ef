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
// With the bias inputs (resampler.py:125-134): k = ctx Wk + bk, v = ctx Wv + bv, o[q] Wout +
// bout.
//
// The fold, as in the bf16 form (resampler.cu): k enters only through the logits, so
// logits = ctx Wkq with Wkq[c, (q, h)] = scale sum_d Wk[c, h dh + d] qh[q, h, d]; with ln_k,
// k - mean(k) = ctx Wc (Wc = Wk less each row's mean), logits = rstd (ctx Wkq') + const with
// lnk_w folded into Wkq' and const from lnk_b, and rstd from the sums of squares of ctx Wc.
// Sums of the fold in f64.
//
// Design. The products on the tensor cores, each in three TF32 parts (gemm_tf32x3_sm90.cuh:
// a persistent TMA + wgmma ring, A split into hi and lo in registers, the weight's split
// transpose in shared memory; a_hi w_hi + a_hi w_lo + a_lo w_hi in f32 sums). Launches, all on
// the caller's stream; 0-2 once a call, 3-6 once for each chunk of columns (the wrapper sizes
// the chunks so that the scratch, the weights' split included, stays under a cap):
//   0. fold_f32_kernel<true>, one block a row c of Wk: Wkq^T (or Wkq'^T) and with ln_k Wc^T
//      straight into the split scratch, each value as its hi and lo TF32 parts (rows inner..
//      of W_ctx^T below; the Q h logit columns padded with zeros to NLP, a multiple of 128,
//      the ring's column tile); with ln_k also const (Q h).
//   1. split_tf32_t_kernel: Wv (D, inner) as stored -> rows 0..inner-1 of W_ctx^T's parts.
//   2. split_tf32_t_kernel: Wout (inner, D_out) -> Wout^T's hi and lo (2 D_out, inner).
//   3. the context product, gemm_tf32x3_kernel<EPI_PLAIN> over A = the chunk's context rows
//      read in place, grouped: K levels of Mc rows, M D floats apart (a 3D tensor map (level,
//      row, D) based at the chunk's first column; a row tile never straddles two levels and
//      its rows past the chunk's last column are loaded, never stored), against W_ctx = [Wv |
//      Wkq | Wc] (D, inner + NLP (+ inner with ln_k)): one product reads each tile of the
//      context once for v and the logits (and ctx Wc). Its first inner + NLP columns go to vl
//      (K Mc, inner + NLP): v, then the logits; the ln_k tiles store no value but each row's
//      sum of squares over the tile, sq (K Mc, inner / 128).
//   4. mix_f32_kernel, a thread per (column, head, 8 of dh): the column's K x 8 values of v in
//      registers; per query the softmax over K (with ln_k: rstd times the raw logit plus
//      const), the level-order sum; o (Mc, Q, inner) f32. A bandwidth pass.
//   5. out-projection: gemm_tf32x3_kernel<EPI_PLAIN> on o as (Mc Q, inner) rows against Wout's
//      split, into out.
//   6. ln_rows_f32_kernel<PeriodicF32> (gemm_f32.cuh): ln1_w as the gain (scale_bias 0, one
//      FiLM row for all rows), ln1_b as the shift, the query of the row (period Q) as the
//      residual, in place.
// The bias inputs (perceiver_bias.cuh): with bk or bv, bias_fold_kernel after launch 0 writes
// one bias row over W_ctx's columns, bvec (NT) = [bv | cb | the centred bk (ln_k only)], and
// launch 3 runs as EPI_BIAS: v + bv and the raw logits + cb are stored, the centred bk is added
// to ctx Wc before the squares. With bout launch 5 runs as EPI_BIAS. The FFMA build takes none.
// The logit columns past Q h are zeros in W_ctx: the ring computes NLP of which Q h are real
// (48 of 128 at the aggregation, 208 of 256 at the de-aggregation, 24 of 128 at the small
// model's D = 256): 0.42, 0.12 and 0.27 ms of three-part time a call. (A 64-column tile would
// halve that at the aggregation; one product over [Wv | Wkq] also covers the logits' odd
// width, and reads the context from device memory once instead of twice.)
//
// Bound on the H100: operations, the folded work as three TF32 products at 495 TF/s: the
// logits 2 K M D Q h, v 2 K M D inner, the out-projection 2 M Q inner D_out (with ln_k also
// ctx Wc, 2 K M D inner): 3.55 ms at the aggregation shape ((13, 64800, 512), Q 3, 16 heads;
// ln_k 6.22), 13.68 ms at the de-aggregation's ((3, 64800, 1024), Q 13), 0.89 ms at the small
// model's aggregation ((13, 64800, 256), 8 heads); at the FFMA pipes' 67 TF/s 8.73, 15.32,
// 33.69 and 2.18 ms. The mix and the row kernel move about 10 GB at the de-aggregation (the
// f32 o and out each written and read), ~3 ms of memory time beside the products' 13.7.
//
// tools/kernel_ablate.py builds copies with -DRESAMPLER_F32_FFMA (the earlier design: the
// fold as stored into (D, NLP) and (D, inner) scratch, the logits, ln_k's sums of squares, v
// and the out-projection as gemm_f32.cuh's FFMA products), -DABLATE_ONE_PART (the lo
// products off: one TF32 product), and each launch alone on what the scratch holds:
// -DABLATE_ONLY_CTX (launches 0, 1 and 3), -DABLATE_ONLY_MIX (4), -DABLATE_ONLY_OUT (2 and 5),
// -DABLATE_ONLY_ROWS (6).
#include "gemm_f32.cuh"
#include "gemm_tf32x3_sm90.cuh"
#include "perceiver_bias.cuh"

namespace {

// The launches an ablation build runs alone (tools/kernel_ablate.py), 0: all of them.
#if defined(ABLATE_ONLY_CTX)
constexpr int ONLY = 1;
#elif defined(ABLATE_ONLY_MIX)
constexpr int ONLY = 2;
#elif defined(ABLATE_ONLY_OUT)
constexpr int ONLY = 3;
#elif defined(ABLATE_ONLY_ROWS)
constexpr int ONLY = 4;
#else
constexpr int ONLY = 0;
#endif
constexpr bool runs(int part) { return ONLY == 0 || ONLY == part; }

__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// Column n, row c (c < D) of a folded weight: SPLIT, its hi and lo TF32 parts at w[n D + c]
// and w[lo + n D + c] (the transpose's split, as the ring reads it); else w[c ld + n], as
// stored (the FFMA build).
template <bool SPLIT>
__device__ __forceinline__ void put(float* w, long long lo, int ld, int D, int n, int c,
                                    float v) {
  if constexpr (SPLIT) {
    uint32_t h, l;
    tf32x3::split(v, h, l);
    w[(long long)n * D + c] = __uint_as_float(h);
    w[lo + (long long)n * D + c] = __uint_as_float(l);
  } else {
    w[(long long)c * ld + n] = v;
  }
}

// Launch 0. wk: (D, inner) f32; qh: (Q, inner) f32; lnk_w, lnk_b: (inner,) f32 or null.
// Writes Wkq's NLP columns to wb and, with ln_k, Wc's inner columns to wc (both by put<SPLIT>,
// lo parts `lo` floats on) and const (Q h,) f32 to cst.
template <bool SPLIT>
__global__ void __launch_bounds__(256) fold_f32_kernel(
    const float* __restrict__ wk, const float* __restrict__ qh, const float* __restrict__ lnk_w,
    const float* __restrict__ lnk_b, int D, int inner, int dh, int QH, int heads, int NLP,
    float scale, float* __restrict__ wb, float* __restrict__ cst, float* __restrict__ wc,
    long long lo) {
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
      put<SPLIT>(wc, lo, inner, D, j, c, (float)centred);
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
    put<SPLIT>(wb, lo, NLP, D, col, c, val);
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

// Launch 4. v: (K Mc, ldv) f32, a row's first inner values; logits: (K Mc, ldl) f32, a row's
// first Q heads values; with ln_k sq (K Mc, n_sq) and cst (Q heads), else both null; o: (Mc, Q,
// inner) f32.
template <int K, int DH>
__global__ void __launch_bounds__(256) mix_f32_kernel(
    const float* __restrict__ v, int ldv, const float* __restrict__ logits, int ldl,
    const float* __restrict__ sq, const float* __restrict__ cst, int Mc, int heads, int Q,
    int n_sq, float* __restrict__ o) {
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
    const float* src = v + ((long long)kk * Mc + m) * ldv + h * DH + 8 * g;
    vr[kk][0] = *reinterpret_cast<const float4*>(src);
    vr[kk][1] = *reinterpret_cast<const float4*>(src + 4);
  }
  for (int q = 0; q < Q; ++q) {
    const int col = q * heads + h;
    float l[K];
    float mx = -3.0e38f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float x = logits[((long long)kk * Mc + m) * ldl + col];
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
int launch_mix_f32(const float* v, int ldv, const float* logits, int ldl, const float* sq,
                   const float* cst, int Mc, int heads, int Q, int n_sq, float* o,
                   cudaStream_t stream) {
  const int cols = 256 / (heads * DH / 8);
  mix_f32_kernel<K, DH><<<(Mc + cols - 1) / cols, 256, 0, stream>>>(v, ldv, logits, ldl, sq, cst,
                                                                    Mc, heads, Q, n_sq, o);
  return (int)cudaGetLastError();
}

}  // namespace

// ctx: (K, M, D) f32; wk, wv: (D, inner) f32 and wout: (inner, D_out) f32, all as stored; qh:
// (Q, inner) f32; ln_w, ln_b: (D_out,) f32; qres: (Q, D_out) f32; lnk_w, lnk_b: (inner,) f32,
// or both null (no ln_k); bk, bv (inner,) and bout (D_out,) f32, each or null. NLP = Q heads
// rounded up to 128, NS = inner + NLP, NT = NS (+ inner with ln_k). Scratch: with ln_k cst (Q
// heads) f32; with bk or bv bvec (NT) f32; for Mc columns vl (K Mc, NS), with ln_k sq
// (K Mc, inner / 128), o (Mc, Q, inner), all f32; wsplit, 2 NT D + 2 D_out inner f32: W_ctx^T's
// hi and lo (2 NT, D), then Wout^T's (2 D_out, inner), written and read by this call. out: (M,
// Q, D_out) f32. The columns go in chunks of Mc. Takes (K, dh) in {(13, 32), (3, 64)}, D % 64
// == 0, inner % 256 == 0 up to 2048, D_out in {256, 512, 1024, 2048}. Returns
// cudaGetLastError() of the last launch, cudaErrorInvalidValue for a shape it does not take,
// or cudaErrorUnknown where no tensor map could be encoded.
extern "C" int perceiver_core_f32(const float* ctx, const float* wk, const float* wv,
                                  const float* qh, const float* wout, const float* ln_w,
                                  const float* ln_b, const float* qres, const float* lnk_w,
                                  const float* lnk_b, const float* bk, const float* bv,
                                  const float* bout, float* cst, float* bvec, float* vl,
                                  float* sq, float* o, float* out, int K, int M, int Mc, int D,
                                  int heads, int dh, int Q, int D_out, float scale, float eps,
                                  float* wsplit, cudaStream_t stream) {
  const int inner = heads * dh, QH = Q * heads, NLP = (QH + 127) / 128 * 128, n_sq = inner / 128;
  const bool kd13 = K == 13 && dh == 32, kd3 = K == 3 && dh == 64, ln_k = lnk_w != nullptr;
  if ((!kd13 && !kd3) || M <= 0 || Mc <= 0 || D <= 0 || D % 64 || inner % 256 || inner > 2048 ||
      (D_out != 256 && D_out != 512 && D_out != 1024 && D_out != 2048) ||
      (long long)Mc * Q > (1 << 24) || (lnk_w == nullptr) != (lnk_b == nullptr) ||
      ((bk || bv) && bvec == nullptr))
    return (int)cudaErrorInvalidValue;
  const int NS = inner + NLP, NT = NS + (ln_k ? inner : 0);
  const bool ctx_bias = bk || bv;
  const long long lo_ctx = (long long)NT * D;  // W_ctx^T's lo parts, floats after its hi
  float* ws_ctx = wsplit;
  float* ws_out = wsplit + 2 * lo_ctx;
  int err = 0;
  const size_t fold_smem = inner * sizeof(double);
#ifdef RESAMPLER_F32_FFMA
  if (ctx_bias || bout) return (int)cudaErrorInvalidValue;
  // As stored: Wkq (D, NLP) and Wc (D, inner) in the split scratch's room.
  float* wb = wsplit;
  float* wc = wsplit + (long long)D * NLP;
  (void)ws_ctx;
  (void)ws_out;
  if (runs(1)) {
    fold_f32_kernel<false><<<D, 256, fold_smem, stream>>>(wk, qh, lnk_w, lnk_b, D, inner, dh, QH,
                                                          heads, NLP, scale, wb, cst, wc, 0);
    if ((err = (int)cudaGetLastError())) return err;
  }
#else
  if (runs(1)) {
    fold_f32_kernel<true><<<D, 256, fold_smem, stream>>>(
        wk, qh, lnk_w, lnk_b, D, inner, dh, QH, heads, NLP, scale, ws_ctx + (long long)inner * D,
        cst, ws_ctx + (long long)NS * D, lo_ctx);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = tf32x3::launch_split_to(wv, ws_ctx, ws_ctx + lo_ctx, D, inner, stream)))
      return err;
    if (ctx_bias && (err = launch_bias_fold(bk, bv, lnk_w, qh, inner, dh, QH, heads, NLP, scale,
                                            bvec + inner, ln_k ? bvec + NS : nullptr, bvec,
                                            stream)))
      return err;
  }
  if (runs(3) && (err = tf32x3::launch_split(wout, ws_out, inner, D_out, stream))) return err;
#endif
  for (int m0 = 0; m0 < M; m0 += Mc) {
    const int mc = M - m0 < Mc ? M - m0 : Mc, R = K * mc, rows = mc * Q;
#ifdef RESAMPLER_F32_FFMA
    const f32k::GroupedRows a{ctx + (long long)m0 * D, (long long)M * D, mc, D};
    float* v = vl;                         // (R, inner)
    float* logits = vl + (long long)R * inner;  // (R, NLP)
    const int ldv = inner, ldl = NLP;
    if (runs(1)) {
      if ((err = f32k::launch_gemm_f32<4, f32k::EPI_PLAIN>(a, wb, nullptr, logits, R, D, NLP,
                                                           stream)))
        return err;
      if (ln_k && (err = f32k::launch_gemm_f32<8, f32k::EPI_SUMSQ>(a, wc, nullptr, sq, R, D,
                                                                   inner, stream)))
        return err;
      if ((err = f32k::launch_gemm_f32<8, f32k::EPI_PLAIN>(a, wv, nullptr, v, R, D, inner,
                                                           stream)))
        return err;
    }
#else
    const float* v = vl;
    const float* logits = vl + inner;
    const int ldv = NS, ldl = NS;
    if (runs(1)) {
      const float* c0 = ctx + (long long)m0 * D;
      err = ctx_bias ? tf32x3::launch_gemm_grouped<tf32x3::EPI_BIAS>(
                           c0, K, mc, M - m0, (long long)M * D, ws_ctx, bvec, vl, NS, NS, sq, D,
                           NT, stream)
                     : tf32x3::launch_gemm_grouped<tf32x3::EPI_PLAIN>(
                           c0, K, mc, M - m0, (long long)M * D, ws_ctx, nullptr, vl, NS, NS, sq,
                           D, NT, stream);
      if (err) return err;
    }
#endif
    if (runs(2)) {
      const float* sqp = ln_k ? sq : nullptr;
      const float* cp = ln_k ? cst : nullptr;
      err = kd13 ? launch_mix_f32<13, 32>(v, ldv, logits, ldl, sqp, cp, mc, heads, Q, n_sq, o,
                                          stream)
                 : launch_mix_f32<3, 64>(v, ldv, logits, ldl, sqp, cp, mc, heads, Q, n_sq, o,
                                         stream);
      if (err) return err;
    }
    float* oc = out + (long long)m0 * Q * D_out;
#ifdef RESAMPLER_F32_FFMA
    if (runs(3) && (err = f32k::launch_gemm_f32<8, f32k::EPI_PLAIN>(
                        f32k::Rows{o, inner}, wout, nullptr, oc, rows, inner, D_out, stream)))
      return err;
#else
    if (runs(3) && (err = bout ? tf32x3::launch_gemm<tf32x3::EPI_BIAS>(o, ws_out, bout, oc, rows,
                                                                       inner, D_out, stream)
                               : tf32x3::launch_gemm<tf32x3::EPI_PLAIN>(o, ws_out, nullptr, oc,
                                                                        rows, inner, D_out,
                                                                        stream)))
      return err;
#endif
    // The chunk starts at a column, so its row r is query r % Q; one FiLM row for all.
    if (runs(4) && (err = f32k::launch_ln_rows_f32(f32k::PeriodicF32{qres, Q}, oc, ln_b, ln_w,
                                                   0.f, rows, 0, 1ll << 62, D_out, eps, stream)))
      return err;
  }
  return 0;
}
