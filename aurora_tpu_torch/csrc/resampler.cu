// K4: the shared-query perceiver attention core of the level (de-)aggregation.
//
// Replaces aurora_tpu/ops/resampler.py::perceiver_core_fused (pallas_call at
// resampler.py:254), which ran the kv projections, logits, level softmax, weighted sum,
// out-projection and ln1 + query residual per column block in VMEM.
//
// The function, per token column m of the k-major context ctx (K, M, D) f32:
//   k = ctx Wk (f32); with ln_k, k = LN(k) over all `inner` (eps 1e-5, f32 affine)
//   logits[k, q, h] = scale sum_d k[h dh + d] qh[q, h, d] (f32); w = bf16(softmax over K)
//   v = bf16(bf16(ctx) Wv); o[q, h] = sum over k, in level order, of bf16(w v), each
//   partial sum rounded (resampler.py:204-206)
//   out[q] = bf16(LN(bf16(o[q] Wout)) ln1_w + ln1_b + queries[q])
//
// The logits fold. k and the logits must stay f32 (bf16 q/k cost 2e-1 end to end,
// aurora_tpu/model/perceiver.py:145-152), but k itself is needed only through the logits:
// logits = ctx Wkq with Wkq[c, (q, h)] = scale sum_d Wk[c, h dh + d] qh[q, h, d], the JAX
// kernel's k @ wq_bd re-associated. That takes the f32 work from K M D inner multiply-adds
// to K M D Q h (442 -> 41 GFLOP at the aggregation shape, 408 -> 83 at the
// de-aggregation's). ln_k folds as well: k - mean(k) = ctx Wc with Wc = Wk less each row's
// mean (the centred weights), so logits = rstd (ctx Wkq') + const, where Wkq' folds
// lnk_w into Wc qh and const[q, h] = scale sum_d lnk_b[h dh + d] qh[q, h, d]. Only rstd =
// rsqrt(mean((ctx Wc)^2) + 1e-5) needs the full product ctx Wc, and of it only each row's
// sum of squares is kept. The eps is 1e-5, not ln_eps (resampler.py:172). That product runs
// on the tensor cores in three bf16 parts, ctx and Wc each split into a bf16 value and a
// bf16 remainder (hi + lo): hi hi + lo hi + hi lo, f32 sums; the dropped lo lo and the
// remainders' own rounding are ~2^-16 of each term, and a sum of squares over `inner`
// values averages them: tests/test_torch_resampler_redesign.py holds the logits so taken
// within 2e-6 of their largest value, as the direct f32 form (and one bf16 part outside it).
// Times in PERF.md.
//
// Bound on the H100: operations. The f32 logits at 67 TF/s, the v product and the
// out-projection (and with ln_k the three parts of ctx Wc) in bf16 at 989 TF/s: at the
// aggregation shape 0.62 ms f32 + 0.55 ms bf16 (ln_k: + 1.34 ms bf16), at the
// de-aggregation's 1.24 + 2.2 ms.
//
// Launches, all on the caller's stream; 0 once a call, 1-5 once for each chunk of columns
// (the wrapper sizes the chunks so that the scratch stays under a fixed cap):
//   0. fold_kernel, one block a row c of Wk: Wkq (or Wkq') into wb (D, NLP) f32, the Q h
//      logit columns padded to NLP, a multiple of 64; with ln_k also const (Q h) and Wc split
//      as w3 (3 D, inner) bf16 = [Wc hi; Wc hi; Wc lo]. Sums in f64.
//   1. logits_kernel: an f32 product ctx wb on the FFMA pipes, 128 x 64 tiles, K steps of 32
//      on a ring of 3 cp.async stages, 8 x 4 outputs a thread: the f32 logits (rows (k, m),
//      Q h). Column tiles are the fastest grid index, so the tiles of one row block run
//      together and the context comes from device memory once; the blocks of column tile 0
//      also write ctx hi = bf16(ctx) for launch 2 and, with ln_k, ctx lo = bf16(ctx - hi).
//      With ln_k, sumsq_kernel follows: the ring of gemm_rows_sm90.cuh over 3 D / 64 K steps,
//      A from ctx hi, lo, hi by turns against w3's thirds, and an epilogue that keeps each
//      row's sum of squares per 256-column tile.
//   2. v: gemm_bias_kernel<EPI_ROUND> (gemm_rows_sm90.cuh) on bf16(ctx) (K Mc, D) rows and Wv
//      (D, inner) bf16 as stored: v = bf16(acc), f32 sums.
//   3. mix_kernel, a thread per (column, head, 8 of dh): the column's K x 8 values of v in
//      registers; per query the f32 softmax over K (with ln_k: rstd (merged from the sums of
//      squares) times the raw logit plus const), the weights rounded, the level-order
//      sum on packed bf16x2 products and sums; o (Mc, Q, inner) bf16. A bandwidth pass.
//   4. out-projection: gemm_bias_kernel<EPI_STATS> on o as (Mc Q, inner) rows and Wout
//      (inner, D_out) as stored: y = bf16(acc) into out, and per row and 256-column tile the
//      mean and centred sum of squares.
//   5. ln_rows_kernel<PeriodicResidual>: ln1_w as the gain (scale_bias 0, one FiLM row for
//      all rows), ln1_b as the shift, the f32 query of the row (period Q) as the residual, in
//      place in out.
// Scratch, all allocated by the wrapper for the largest chunk: ctx hi (and lo), v, the
// logits, the sums of squares (ln_k), o and the statistics. Every pointer 16-byte aligned.
//
// tools/kernel_ablate.py builds copies with -DABLATE_ONLY_LOGITS (launches 0-1, with
// sumsq_kernel),
// -DABLATE_ONLY_V (2), -DABLATE_ONLY_MIX (3) and -DABLATE_ONLY_TAIL (4-5), each on what the
// scratch holds.
#include "common.cuh"
#include "gemm_rows_sm90.cuh"

namespace {

#if defined(ABLATE_ONLY_LOGITS)
constexpr unsigned RUN = 1;
#elif defined(ABLATE_ONLY_V)
constexpr unsigned RUN = 2;
#elif defined(ABLATE_ONLY_MIX)
constexpr unsigned RUN = 4;
#elif defined(ABLATE_ONLY_TAIL)
constexpr unsigned RUN = 8;
#else
constexpr unsigned RUN = 15;  // logits (with the fold), v, mix, tail
#endif

__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// Launch 0. wk: (D, inner) f32; qh: (Q, inner) f32; lnk_w, lnk_b: (inner,) f32 or null.
// wb: (D, NLP) f32; with ln_k only: cst (Q h,) f32 and w3 (3 D, inner) bf16.
__global__ void __launch_bounds__(256) fold_kernel(
    const float* __restrict__ wk, const float* __restrict__ qh, const float* __restrict__ lnk_w,
    const float* __restrict__ lnk_b, int D, int inner, int dh, int QH, int heads, int NLP,
    float scale, float* __restrict__ wb, float* __restrict__ cst, bf16* __restrict__ w3) {
  extern __shared__ double w[];  // [inner]: the row's (centred, lnk_w-scaled) weights
  __shared__ double red[8];
  const int c = blockIdx.x, tid = threadIdx.x;
  const float* row = wk + (long long)c * inner;
  float* dst = wb + (long long)c * NLP;
  double mean = 0.0;
  if (lnk_w) {
    double s = 0.0;
    for (int j = tid; j < inner; j += blockDim.x) s += row[j];
    mean = block_sum(s, red) / inner;
  }
  for (int j = tid; j < inner; j += blockDim.x) {
    const double wc = (double)row[j] - mean;
    if (lnk_w) {
      const float wcf = (float)wc;
      const bf16 hi = __float2bfloat16_rn(wcf);
      const long long at = (long long)c * inner + j, third = (long long)D * inner;
      w3[at] = w3[third + at] = hi;
      w3[2 * third + at] = __float2bfloat16_rn(wcf - __bfloat162float(hi));
      w[j] = wc * lnk_w[j];
    } else {
      w[j] = wc;
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
    dst[col] = val;
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

constexpr int LG_BM = 128, LG_BN = 64, LG_BK = 32, LG_STAGES = 3;
constexpr int LG_LDA = LG_BK + 4;  // a row of A in shared memory: 144 bytes, 16-byte aligned
constexpr int LG_A_FLOATS = LG_BM * LG_LDA, LG_B_FLOATS = LG_BK * LG_BN;
constexpr size_t LG_SMEM = (size_t)LG_STAGES * (LG_A_FLOATS + LG_B_FLOATS) * sizeof(float);

// 16 bytes from global to shared memory, asynchronously; zeros where `full` is false.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const uint32_t d = sm90::smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Launch 1 on the chunk of columns m0 .. m0 + Mc: rows r = k Mc + m (R = K Mc of them) of
// ctx (K, M, D) f32 times wb (D, NB). logits: (R, QH) f32; ctxb: (R, D) bf16, ctx hi;
// ctxlo: (R, D) bf16, ctx lo, or null.
// A 128 x 64 tile a block; K steps of 32 on a ring of 3 stages filled by cp.async (each row's
// 128 bytes by 8 neighbouring threads). A stays row-major in shared memory, so a thread's
// 8 x 4 outputs take, per 4 k, one 16-byte read of each of its 8 rows and four of B.
__global__ void __launch_bounds__(256) logits_kernel(
    const float* __restrict__ ctx, long long M, int m0, int Mc, int D, int R,
    const float* __restrict__ wb, int NB, int QH, float* __restrict__ logits,
    bf16* __restrict__ ctxb, bf16* __restrict__ ctxlo) {
  extern __shared__ __align__(16) float lg_smem[];
  float* As = lg_smem;                            // [STAGES][BM][LDA]
  float* Bs = lg_smem + LG_STAGES * LG_A_FLOATS;  // [STAGES][BK][BN]
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int n0 = blockIdx.x * LG_BN;
  const long long r0 = (long long)blockIdx.y * LG_BM;
  const bool write_ctx = blockIdx.x == 0;

  // Copies: four 16-byte pieces of A a thread (row (tid >> 3) + 32 p, piece tid & 7), two of
  // B (k (tid >> 4) + 16 p, piece tid & 15).
  const int ac = tid & 7;
  const float* asrc[4];
  bool aok[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long r = r0 + (tid >> 3) + 32 * p;
    aok[p] = r < R;
    const long long kk = aok[p] ? r / Mc : 0, m = aok[p] ? r - kk * Mc : 0;
    asrc[p] = ctx + (kk * M + m0 + m) * D + 4 * ac;
  }
  const float* bsrc = wb + (long long)(tid >> 4) * NB + n0 + 4 * (tid & 15);
  auto load_stage = [&](int kt) {
    const int st = kt % LG_STAGES, k0 = kt * LG_BK;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      cp_async16(As + st * LG_A_FLOATS + ((tid >> 3) + 32 * p) * LG_LDA + 4 * ac,
                 aok[p] ? asrc[p] + k0 : ctx, aok[p]);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      cp_async16(Bs + st * LG_B_FLOATS + ((tid >> 4) + 16 * p) * LG_BN + 4 * (tid & 15),
                 bsrc + (long long)(k0 + 16 * p) * NB, true);
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int kts = D / LG_BK;
#pragma unroll
  for (int kt = 0; kt < LG_STAGES - 1; ++kt) {
    if (kt < kts) load_stage(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < kts; ++kt) {
    cp_async_wait<LG_STAGES - 2>();
    __syncthreads();  // stage kt has landed for all; stage kt - 1 is no longer read
    if (kt + LG_STAGES - 1 < kts) load_stage(kt + LG_STAGES - 1);
    cp_async_commit();
    const float* a = As + (kt % LG_STAGES) * LG_A_FLOATS;
    const float* b = Bs + (kt % LG_STAGES) * LG_B_FLOATS;
    if (write_ctx) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int rl = (tid >> 3) + 32 * p;
        if (aok[p]) {
          const float4 v = *reinterpret_cast<const float4*>(a + rl * LG_LDA + 4 * ac);
          const long long at = (r0 + rl) * D + kt * LG_BK + 4 * ac;
          const uint2 hi = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
          *reinterpret_cast<uint2*>(ctxb + at) = hi;
          if (ctxlo)  // the remainders, exact in f32: x - hi keeps the bits below hi's
            *reinterpret_cast<uint2*>(ctxlo + at) = make_uint2(
                pack_bf16x2(v.x - __uint_as_float(hi.x << 16),
                            v.y - __uint_as_float(hi.x & 0xffff0000u)),
                pack_bf16x2(v.z - __uint_as_float(hi.y << 16),
                            v.w - __uint_as_float(hi.y & 0xffff0000u)));
        }
      }
    }
#pragma unroll
    for (int kq = 0; kq < LG_BK; kq += 4) {
      float bv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(b + (kq + j) * LG_BN + 4 * tc);
        bv[j][0] = t.x; bv[j][1] = t.y; bv[j][2] = t.z; bv[j][3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rl = i < 4 ? 4 * tr + i : 64 + 4 * tr + i - 4;
        const float4 av = *reinterpret_cast<const float4*>(a + rl * LG_LDA + kq);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ak[j], bv[j][c], acc[i][c]);
      }
    }
  }

  const int col = n0 + 4 * tc;
  if (col < QH) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = r0 + (i < 4 ? 4 * tr + i : 64 + 4 * tr + i - 4);
      if (r < R)
        *reinterpret_cast<float4*>(logits + r * QH + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// With ln_k, after launch 1: sq (R, inner / 256) f32, each row's sum of squares of ctx Wc
// per 256-column tile, ctx Wc as hi Wc_hi + lo Wc_hi + hi Wc_lo on the ring: K step ks takes
// A from ctx lo in the middle third of the 3 D / 64 steps and from ctx hi otherwise, at k
// (ks mod D / 64) 64, and w3 at k ks 64.
__global__ void __launch_bounds__(ROWS_THREADS, 1) sumsq_kernel(
    const __grid_constant__ CUtensorMap map_hi, const __grid_constant__ CUtensorMap map_lo,
    const __grid_constant__ CUtensorMap map_w, float* __restrict__ sq, int d_steps,
    const Sched s) {
  using Ring = RowsRing;
  extern __shared__ unsigned char raw[];
  const uint32_t tiles = (sm90::smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t bars = tiles + Ring::STAGES * Ring::STAGE_BYTES;
  const int tid = threadIdx.x;
  if (tid == 0) Ring::init(bars);
  __syncthreads();
  if (tid >= 256) {
    sm90::reg_dealloc<40>();
    if (tid == 256) {
      typename Ring::Pos pos;
      const int block[2] = {0, 0};
      for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
        const int p = 2 * (u / s.n_tiles);
        const int row0[2] = {64 * p, 64 * min(p + 1, s.pieces - 1)};
        for (int ks = 0; ks < s.k_steps; ++ks) {
          const CUtensorMap* a = ks / d_steps == 1 ? &map_lo : &map_hi;
          Ring::produce_step(a, &map_w, tiles, bars, pos, row0, block, (ks % d_steps) * Ring::BK,
                             ks * Ring::BK, (u % s.n_tiles) * Ring::BN, s.a_box_bytes);
        }
      }
    }
  } else {
    sm90::reg_alloc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    typename Ring::Pos pos;
    float acc[128];
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const int p = 2 * (u / s.n_tiles) + wg, nt = u % s.n_tiles;
      Ring::consume_tile(acc, tiles, bars, pos, s.k_steps, wg, lane == 0);
      if (p >= s.pieces) continue;
      float s0 = 0.f, s1 = 0.f;  // rows gq and gq + 8 of the warp's 16
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s0 += acc[4 * j] * acc[4 * j] + acc[4 * j + 1] * acc[4 * j + 1];
        s1 += acc[4 * j + 2] * acc[4 * j + 2] + acc[4 * j + 3] * acc[4 * j + 3];
      }
      s0 = quad_sum(s0);
      s1 = quad_sum(s1);
      const int r = 64 * p + 16 * warp + gq;
      if (tq == 0) {
        if (r < s.rows) sq[(long long)r * s.n_tiles + nt] = s0;
        if (r + 8 < s.rows) sq[(long long)(r + 8) * s.n_tiles + nt] = s1;
      }
    }
  }
}

// Launch 3. v: (K Mc, inner) bf16; logits: (K Mc, Q heads) f32; with ln_k sq (K Mc, n_sq)
// and cst (Q heads), else both null; o: (Mc, Q, inner) bf16.
template <int K, int DH>
__global__ void __launch_bounds__(256) mix_kernel(
    const bf16* __restrict__ v, const float* __restrict__ logits, const float* __restrict__ sq,
    const float* __restrict__ cst, int Mc, int heads, int Q, int n_sq, bf16* __restrict__ o) {
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
  uint4 vr[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    vr[kk] = *reinterpret_cast<const uint4*>(v + ((long long)kk * Mc + m) * inner + h * DH + 8 * g);
  const int QH = Q * heads;
  for (int q = 0; q < Q; ++q) {
    const int col = q * heads + h;
    float l[K];
    float mx = -3.0e38f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float x = logits[((long long)kk * Mc + m) * QH + col];
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
    // bf16x2 products and sums: each a single rounding of the exact result, as bf16r of the
    // f32 product or sum of two bf16 values is. The _rn forms keep ptxas from contracting a
    // product and the sum after it into one fma, which would skip the product's rounding.
    __nv_bfloat162 ov[4] = {};
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const __nv_bfloat162 w = __bfloat162bfloat162(__float2bfloat16_rn(l[kk] / ssum));
      const uint32_t vw[4] = {vr[kk].x, vr[kk].y, vr[kk].z, vr[kk].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(&vw[i]);
        const __nv_bfloat162 p = __hmul2_rn(w, vv);
        ov[i] = kk == 0 ? p : __hadd2_rn(ov[i], p);
      }
    }
    const uint32_t* ow = reinterpret_cast<const uint32_t*>(ov);
    *reinterpret_cast<uint4*>(o + (m * Q + q) * inner + h * DH + 8 * g) =
        make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }
}

template <int K, int DH>
int launch_mix(const bf16* v, const float* logits, const float* sq, const float* cst, int Mc,
               int heads, int Q, int n_sq, bf16* o, cudaStream_t stream) {
  const int cols = 256 / (heads * DH / 8);
  mix_kernel<K, DH><<<(Mc + cols - 1) / cols, 256, 0, stream>>>(v, logits, sq, cst, Mc, heads,
                                                                Q, n_sq, o);
  return (int)cudaGetLastError();
}

}  // namespace

// ctx: (K, M, D) f32; wk: (D, inner) f32; wv: (D, inner) bf16 and wout: (inner, D_out) bf16,
// both as stored; qh: (Q, inner) f32; ln_w, ln_b: (D_out,) f32; qres: (Q, D_out) f32;
// lnk_w, lnk_b: (inner,) f32, or both null (no ln_k). Scratch: wb (D, NLP) f32, NLP = Q heads
// rounded up to 64; with ln_k cst (Q heads) f32 and w3 (3 D, inner) bf16; for Mc columns
// ctxb (K Mc, D) bf16, with ln_k ctxlo (K Mc, D) bf16 and sq (K Mc, inner / 256) f32, v
// (K Mc, inner) bf16, logits (K Mc, Q heads) f32, o (Mc, Q, inner) bf16, stats
// (Mc Q, D_out / 256) float2.
// out: (M, Q, D_out) bf16. The columns go in chunks of Mc. Takes (K, dh) in {(13, 32),
// (3, 64)}, D % 64 == 0, inner % 256 == 0 up to 2048 (so Q heads is a multiple of 4, as the
// logits' 16-byte stores need), D_out in {512, 1024, 2048}. Returns
// cudaGetLastError() of the last launch, cudaErrorInvalidValue for a shape it does not take,
// or cudaErrorUnknown where no tensor map could be encoded.
extern "C" int perceiver_core(const float* ctx, const float* wk, const void* wv,
                              const float* qh, const void* wout, const float* ln_w,
                              const float* ln_b, const float* qres, const float* lnk_w,
                              const float* lnk_b, float* wb, float* cst, void* w3, void* ctxb,
                              void* ctxlo, void* v, float* logits, float* sq, void* o,
                              float* stats, void* out, int K,
                              int M, int Mc, int D, int heads, int dh, int Q, int D_out,
                              float scale, float eps, cudaStream_t stream) {
  const int inner = heads * dh, QH = Q * heads, NLP = (QH + 63) / 64 * 64, n_sq = inner / 256;
  const bool kd13 = K == 13 && dh == 32, kd3 = K == 3 && dh == 64;
  if ((!kd13 && !kd3) || M <= 0 || Mc <= 0 || D <= 0 || D % 64 || inner % 256 || inner > 2048 ||
      (D_out != 512 && D_out != 1024 && D_out != 2048) || (long long)K * Mc > 65535ll * LG_BM ||
      (long long)Mc * Q > (1 << 24) ||
      (lnk_w == nullptr) != (lnk_b == nullptr))
    return (int)cudaErrorInvalidValue;
  int err;
  cudaError_t e;
  if (RUN & 1) {
    fold_kernel<<<D, 256, inner * sizeof(double), stream>>>(wk, qh, lnk_w, lnk_b, D, inner, dh,
                                                           QH, heads, NLP, scale, wb, cst,
                                                           static_cast<bf16*>(w3));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  bf16* ob = static_cast<bf16*>(out);
  for (int m0 = 0; m0 < M; m0 += Mc) {
    const int mc = M - m0 < Mc ? M - m0 : Mc, R = K * mc, rows = mc * Q;
    if (RUN & 1) {
      cudaFuncSetAttribute(logits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)LG_SMEM);
      logits_kernel<<<dim3(NLP / LG_BN, (R + LG_BM - 1) / LG_BM), 256, LG_SMEM, stream>>>(
          ctx, M, m0, mc, D, R, wb, NLP, QH, logits, static_cast<bf16*>(ctxb),
          static_cast<bf16*>(lnk_w ? ctxlo : nullptr));
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      if (lnk_w) {
        CUtensorMap map_hi, map_lo, map_w3;
        if ((e = RowsRing::make_map_a(&map_hi, ctxb, R, D, R)) != cudaSuccess) return (int)e;
        if ((e = RowsRing::make_map_a(&map_lo, ctxlo, R, D, R)) != cudaSuccess) return (int)e;
        if ((e = RowsRing::make_map_w(&map_w3, w3, 3 * D, inner)) != cudaSuccess) return (int)e;
        const Sched s3 = make_sched(R, 3 * D, inner);
        const int sms = sm90::sm_count();
        if (sms <= 0) return (int)cudaErrorUnknown;
        cudaFuncSetAttribute(sumsq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ROWS_GEMM_SMEM);
        sumsq_kernel<<<s3.units < sms ? s3.units : sms, ROWS_THREADS, ROWS_GEMM_SMEM, stream>>>(
            map_hi, map_lo, map_w3, sq, D / 64, s3);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      }
    }
    if (RUN & 2) {
      CUtensorMap map_c, map_wv;
      if ((e = RowsRing::make_map_a(&map_c, ctxb, R, D, R)) != cudaSuccess) return (int)e;
      if ((e = RowsRing::make_map_w(&map_wv, wv, D, inner)) != cudaSuccess) return (int)e;
      err = launch_gemm_bias<EPI_ROUND>(map_c, map_wv, nullptr, static_cast<bf16*>(v), nullptr,
                                        inner, make_sched(R, D, inner), stream);
      if (err) return err;
    }
    if (RUN & 4) {
      const float* sqp = lnk_w ? sq : nullptr;
      const float* cp = lnk_w ? cst : nullptr;
      err = kd13 ? launch_mix<13, 32>(static_cast<const bf16*>(v), logits, sqp, cp, mc, heads, Q,
                                      n_sq, static_cast<bf16*>(o), stream)
                 : launch_mix<3, 64>(static_cast<const bf16*>(v), logits, sqp, cp, mc, heads, Q,
                                     n_sq, static_cast<bf16*>(o), stream);
      if (err) return err;
    }
    if (RUN & 8) {
      CUtensorMap map_o, map_wout;
      if ((e = RowsRing::make_map_a(&map_o, o, rows, inner, rows)) != cudaSuccess) return (int)e;
      if ((e = RowsRing::make_map_w(&map_wout, wout, inner, D_out)) != cudaSuccess) return (int)e;
      bf16* oc = ob + (long long)m0 * Q * D_out;
      err = launch_gemm_bias<EPI_STATS>(map_o, map_wout, nullptr, oc,
                                        reinterpret_cast<float2*>(stats), D_out,
                                        make_sched(rows, inner, D_out), stream);
      if (err) return err;
      // The chunk starts at a column, so its row r is query r % Q; one FiLM row for all.
      ln_rows_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
          PeriodicResidual{qres, Q}, oc, reinterpret_cast<const float2*>(stats), ln_b, ln_w, 0.f,
          rows, 0, 1ll << 62, D_out, eps);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaSuccess;
}
