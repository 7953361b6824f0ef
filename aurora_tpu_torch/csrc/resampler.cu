// K4: the shared-query perceiver attention core of the level (de-)aggregation.
//
// Replaces aurora_tpu/ops/resampler.py::perceiver_core_fused (pallas_call at
// resampler.py:254), which ran the kv projections, logits, level softmax, weighted sum,
// out-projection and ln1 + query residual per column block in VMEM.
//
// Bound on the H100: operations. k and the logits must stay f32 (bf16 q/k cost 2e-1
// end-to-end, aurora_tpu/model/perceiver.py:145-152), so the k projection,
// K * M * D * inner multiply-adds (442 GFLOP at the aggregation shape), runs on the f32
// pipes at 67 TF/s: ~6.6 ms, against ~0.5 ms for the 1.7 GB context read.
//
// (a) perceiver_core_kernel: one block per (32 token columns, head); thread (m, dg) owns
//     column m and dims [dg * DH/8, (dg + 1) * DH/8) of the head. The context streams
//     through shared memory in steps of 32 channels with the head's slices of wk (f32)
//     and wv (bf16); each thread accumulates k (f32 products) and v (bf16-rounded
//     context times bf16 weights, f32 sums) for all K levels in registers. Then per query:
//     the logit partial sums are reduced across the 8 threads of the column, scaled,
//     soft-maxed over K in f32, the weights rounded to bf16, and the weighted sum built in
//     bf16 level by level (each product and each partial sum rounded, as
//     resampler.py:204-206). The head's slice of o (M, Q, inner) is written in bf16.
//     k, v, the logits and the weights never reach device memory. This simple design
//     also runs the v projection on the f32 pipes and re-reads the context once per head
//     (from L2).
// (b) the row kernel of row_tail.cuh: round(o @ Wout) -> LN with ln1's affine ->
//     + the f32 query of the row (period Q) -> bf16.
//
// With ln_k (stabilise_level_agg, resampler.py:169-172) the f32 k of a (level, column) is
// normalised over the whole inner axis, all heads, before the logits, and no block of (a)
// holds more than one head of it. So perceiver_k_stats runs first: the same grid and
// projection loop without v (MODE STATS), writing per (level, column, head) the head's mean
// and its centred sum of squares. Launch (a) in MODE LNK merges the heads' pairs (mean of
// the means; sum of the centred squares + DH * (mean_h - mean)^2, the exact pairwise form
// of the two-pass variance), and applies (k - mean) * rsqrt(var + 1e-5) * w + b to its k.
// Cost: a second f32 k projection.
#include "common.cuh"
#include "row_tail.cuh"

namespace {

constexpr int MB = 32;       // token columns per block
constexpr int KC = 32;       // context channels per stage
constexpr int LDC = KC + 1;  // padded stride: the 4 columns of a warp hit different banks

enum { PLAIN = 0, STATS = 1, LNK = 2 };

// stats: (K, M, heads, 2) f32, written in MODE STATS and read in MODE LNK; lnk_w, lnk_b:
// (inner,) f32, MODE LNK only.
template <int K, int DH, int MODE>
__global__ void __launch_bounds__(256) perceiver_core_kernel(
    const float* __restrict__ ctx, const float* __restrict__ wk, const bf16* __restrict__ wv,
    const float* __restrict__ qh, float* __restrict__ stats, const float* __restrict__ lnk_w,
    const float* __restrict__ lnk_b, int M, int D, int inner, int Q, float scale,
    bf16* __restrict__ o) {
  constexpr int DG = DH / 8;
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;                 // [K][MB][LDC]
  float* wks = cs + K * MB * LDC;  // [KC][DH]
  float* wvs = wks + KC * DH;      // [KC][DH]

  const int head = blockIdx.x;
  const long long m0 = (long long)blockIdx.y * MB;
  const int tid = threadIdx.x, ml = tid >> 3, dg = tid & 7;

  float kacc[K][DG], vacc[K][DG];
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < DG; ++j) kacc[kk][j] = vacc[kk][j] = 0.f;

  for (int c0 = 0; c0 < D; c0 += KC) {
    __syncthreads();
    for (int i = tid; i < K * MB * (KC / 4); i += 256) {
      const int q = i % (KC / 4), rr = i / (KC / 4);
      const int mm = rr % MB, kk = rr / MB;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + mm < M)
        v = *reinterpret_cast<const float4*>(ctx + ((long long)kk * M + m0 + mm) * D + c0 + q * 4);
      float* dst = cs + (kk * MB + mm) * LDC + q * 4;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    for (int i = tid; i < KC * DH; i += 256) {
      const int c = i / DH, d = i % DH;
      const long long src = (long long)(c0 + c) * inner + head * DH + d;
      wks[i] = wk[src];
      if constexpr (MODE != STATS) wvs[i] = __bfloat162float(wv[src]);
    }
    __syncthreads();
    for (int c = 0; c < KC; ++c) {
      float wkr[DG], wvr[DG];
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        wkr[j] = wks[c * DH + dg * DG + j];
        if constexpr (MODE != STATS) wvr[j] = wvs[c * DH + dg * DG + j];
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const float xv = cs[(kk * MB + ml) * LDC + c];
        const float xb = bf16r(xv);
#pragma unroll
        for (int j = 0; j < DG; ++j) {
          kacc[kk][j] = fmaf(xv, wkr[j], kacc[kk][j]);
          if constexpr (MODE != STATS) vacc[kk][j] = fmaf(xb, wvr[j], vacc[kk][j]);
        }
      }
    }
  }
  const long long m = m0 + ml;
  const int heads = inner / DH;
  if constexpr (MODE == STATS) {
    // This head's share of the row statistics: its mean, then its centred squares.
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < DG; ++j) sum += kacc[kk][j];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float mean = sum / DH;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < DG; ++j) sq += (kacc[kk][j] - mean) * (kacc[kk][j] - mean);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      sq += __shfl_xor_sync(0xffffffffu, sq, 4);
      if (dg == 0 && m < M) {
        float* dst = stats + (((long long)kk * M + m) * heads + head) * 2;
        dst[0] = mean;
        dst[1] = sq;
      }
    }
    return;
  }
  if constexpr (MODE == LNK) {
    // Merge the heads' (mean, centred squares) of each (level, column) of the tile.
    __syncthreads();
    float* st = cs;  // [K * MB][2]: mean, rstd
    for (int i = tid; i < K * MB; i += 256) {
      const int kk = i / MB, mm = i % MB;
      float mean = 0.f, rstd = 0.f;
      if (m0 + mm < M) {
        const float* src = stats + ((long long)kk * M + m0 + mm) * heads * 2;
        for (int hh = 0; hh < heads; ++hh) mean += src[2 * hh];
        mean /= heads;
        float sq = 0.f;
        for (int hh = 0; hh < heads; ++hh) {
          const float d = src[2 * hh] - mean;
          sq += src[2 * hh + 1] + DH * d * d;
        }
        rstd = rsqrtf(sq / inner + 1e-5f);
      }
      st[2 * i] = mean;
      st[2 * i + 1] = rstd;
    }
    __syncthreads();
    float lw[DG], lb[DG];
#pragma unroll
    for (int j = 0; j < DG; ++j) {
      lw[j] = lnk_w[head * DH + dg * DG + j];
      lb[j] = lnk_b[head * DH + dg * DG + j];
    }
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float mean = st[2 * (kk * MB + ml)], rstd = st[2 * (kk * MB + ml) + 1];
#pragma unroll
      for (int j = 0; j < DG; ++j) kacc[kk][j] = ((kacc[kk][j] - mean) * rstd) * lw[j] + lb[j];
    }
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < DG; ++j) vacc[kk][j] = bf16r(vacc[kk][j]);

  for (int q = 0; q < Q; ++q) {
    float qv[DG];
#pragma unroll
    for (int j = 0; j < DG; ++j) qv[j] = qh[q * inner + head * DH + dg * DG + j];
    float l[K];
    float mx = -3.0e38f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < DG; ++j) p = fmaf(kacc[kk][j], qv[j], p);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      p += __shfl_xor_sync(0xffffffffu, p, 4);
      l[kk] = p * scale;
      mx = fmaxf(mx, l[kk]);
    }
    float ssum = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      l[kk] = expf(l[kk] - mx);
      ssum += l[kk];
    }
    float ov[DG];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float w = bf16r(l[kk] / ssum);
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        const float p = bf16r(w * vacc[kk][j]);
        ov[j] = kk == 0 ? p : bf16r(ov[j] + p);
      }
    }
    if (m < M) {
      bf16* dst = o + (m * Q + q) * inner + head * DH + dg * DG;
#pragma unroll
      for (int j = 0; j < DG; j += 2)
        *reinterpret_cast<uint32_t*>(dst + j) = pack_bf16x2(ov[j], ov[j + 1]);
    }
  }
}

template <int K, int DH, int MODE>
int launch_core(const float* ctx, const float* wk, const bf16* wv, const float* qh, float* stats,
                const float* lnk_w, const float* lnk_b, int M, int D, int heads, int Q,
                float scale, bf16* o, cudaStream_t stream) {
  const size_t smem = (size_t)(K * MB * LDC + 2 * KC * DH) * sizeof(float);
  cudaFuncSetAttribute(perceiver_core_kernel<K, DH, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(heads, (M + MB - 1) / MB);
  perceiver_core_kernel<K, DH, MODE><<<grid, 256, smem, stream>>>(
      ctx, wk, wv, qh, stats, lnk_w, lnk_b, M, D, heads * DH, Q, scale, o);
  return (int)cudaGetLastError();
}

// Launch (a) for the (K, dh) pairs the model has: aggregation (13, 32), de-aggregation (3, 64).
template <int MODE>
int launch_core_kd(const float* ctx, const float* wk, const bf16* wv, const float* qh,
                   float* stats, const float* lnk_w, const float* lnk_b, int K, int M, int D,
                   int heads, int dh, int Q, float scale, bf16* o, cudaStream_t stream) {
  if (D % KC) return (int)cudaErrorInvalidValue;
  if (K == 13 && dh == 32)
    return launch_core<13, 32, MODE>(ctx, wk, wv, qh, stats, lnk_w, lnk_b, M, D, heads, Q, scale,
                                     o, stream);
  if (K == 3 && dh == 64)
    return launch_core<3, 64, MODE>(ctx, wk, wv, qh, stats, lnk_w, lnk_b, M, D, heads, Q, scale,
                                    o, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ctx: (K, M, D) f32; wk: (D, inner) f32; wv: (D, inner) bf16; qh: (Q, inner) f32;
// wout_t: (D_out, inner) bf16; ln_w, ln_b: (D_out,) f32; qres: (Q, D_out) f32;
// stats: (K, M, heads, 2) f32 from perceiver_k_stats with lnk_w, lnk_b: (inner,) f32, or
// all three null (no ln_k); o: (M, Q, inner) bf16 scratch; out: (M, Q, D_out) bf16.
// Returns cudaGetLastError().
extern "C" int perceiver_core(const float* ctx, const float* wk, const void* wv,
                              const float* qh, const void* wout_t, const float* ln_w,
                              const float* ln_b, const float* qres, float* stats,
                              const float* lnk_w, const float* lnk_b, void* o, void* out, int K,
                              int M, int D, int heads, int dh, int Q, int D_out, float scale,
                              float eps, cudaStream_t stream) {
  auto wvb = static_cast<const bf16*>(wv);
  auto ob = static_cast<bf16*>(o);
  const int err =
      stats ? launch_core_kd<LNK>(ctx, wk, wvb, qh, stats, lnk_w, lnk_b, K, M, D, heads, dh, Q,
                                  scale, ob, stream)
            : launch_core_kd<PLAIN>(ctx, wk, wvb, qh, nullptr, nullptr, nullptr, K, M, D, heads,
                                    dh, Q, scale, ob, stream);
  if (err) return err;
  const long long rows = (long long)M * Q;
  return launch_gemm_ln_rows(ob, static_cast<const bf16*>(wout_t), nullptr, nullptr, qres, Q,
                             ln_w, ln_b, rows + 1, rows, heads * dh, D_out, eps,
                             static_cast<bf16*>(out), stream);
}

// The first launch of the ln_k form: per (level, column, head) the mean of the head's f32 k
// and its centred sum of squares into stats (K, M, heads, 2). Returns cudaGetLastError().
extern "C" int perceiver_k_stats(const float* ctx, const float* wk, float* stats, int K, int M,
                                 int D, int heads, int dh, cudaStream_t stream) {
  return launch_core_kd<STATS>(ctx, wk, nullptr, nullptr, stats, nullptr, nullptr, K, M, D, heads,
                               dh, 0, 0.f, nullptr, stream);
}
