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
#include "common.cuh"
#include "row_tail.cuh"

namespace {

constexpr int MB = 32;       // token columns per block
constexpr int KC = 32;       // context channels per stage
constexpr int LDC = KC + 1;  // padded stride: the 4 columns of a warp hit different banks

template <int K, int DH>
__global__ void __launch_bounds__(256) perceiver_core_kernel(
    const float* __restrict__ ctx, const float* __restrict__ wk, const bf16* __restrict__ wv,
    const float* __restrict__ qh, int M, int D, int inner, int Q, float scale,
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
      wvs[i] = __bfloat162float(wv[src]);
    }
    __syncthreads();
    for (int c = 0; c < KC; ++c) {
      float wkr[DG], wvr[DG];
#pragma unroll
      for (int j = 0; j < DG; ++j) {
        wkr[j] = wks[c * DH + dg * DG + j];
        wvr[j] = wvs[c * DH + dg * DG + j];
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const float xv = cs[(kk * MB + ml) * LDC + c];
        const float xb = bf16r(xv);
#pragma unroll
        for (int j = 0; j < DG; ++j) {
          kacc[kk][j] = fmaf(xv, wkr[j], kacc[kk][j]);
          vacc[kk][j] = fmaf(xb, wvr[j], vacc[kk][j]);
        }
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < DG; ++j) vacc[kk][j] = bf16r(vacc[kk][j]);

  const long long m = m0 + ml;
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

template <int K, int DH>
int launch_core(const float* ctx, const float* wk, const bf16* wv, const float* qh, int M, int D,
                int heads, int Q, float scale, bf16* o, cudaStream_t stream) {
  const size_t smem = (size_t)(K * MB * LDC + 2 * KC * DH) * sizeof(float);
  cudaFuncSetAttribute(perceiver_core_kernel<K, DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(heads, (M + MB - 1) / MB);
  perceiver_core_kernel<K, DH><<<grid, 256, smem, stream>>>(ctx, wk, wv, qh, M, D, heads * DH,
                                                            Q, scale, o);
  return (int)cudaGetLastError();
}

}  // namespace

// ctx: (K, M, D) f32; wk: (D, inner) f32; wv: (D, inner) bf16; qh: (Q, inner) f32;
// wout_t: (D_out, inner) bf16; ln_w, ln_b: (D_out,) f32; qres: (Q, D_out) f32;
// o: (M, Q, inner) bf16 scratch; out: (M, Q, D_out) bf16. Returns cudaGetLastError().
extern "C" int perceiver_core(const float* ctx, const float* wk, const void* wv,
                              const float* qh, const void* wout_t, const float* ln_w,
                              const float* ln_b, const float* qres, void* o, void* out, int K,
                              int M, int D, int heads, int dh, int Q, int D_out, float scale,
                              float eps, cudaStream_t stream) {
  if (D % KC) return (int)cudaErrorInvalidValue;
  auto wvb = static_cast<const bf16*>(wv);
  auto ob = static_cast<bf16*>(o);
  int err;
  if (K == 13 && dh == 32)
    err = launch_core<13, 32>(ctx, wk, wvb, qh, M, D, heads, Q, scale, ob, stream);
  else if (K == 3 && dh == 64)
    err = launch_core<3, 64>(ctx, wk, wvb, qh, M, D, heads, Q, scale, ob, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  const long long rows = (long long)M * Q;
  return launch_gemm_ln_rows(ob, static_cast<const bf16*>(wout_t), nullptr, nullptr, qres, Q,
                             ln_w, ln_b, rows + 1, rows, heads * dh, D_out, eps,
                             static_cast<bf16*>(out), stream);
}
