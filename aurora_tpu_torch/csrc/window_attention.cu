// K2, K6 and K7: window attention over 144-token windows with a head dim of 64.
//
// Replaces three TPU kernels of aurora_tpu/model/swin3d.py that share one body
// (_qkv_attn_tail_body, swin3d.py:561-596, and its core _heads_attention, :524-558):
//   K2 _attn_windows_5d_fused_pallas (pallas_call at :924): qkv, attention and the optional
//      block tail on windows read in place from the padded (B, Cp, Hp, Wp, D) tokens;
//   K6 _attn_windows_qkv_fused_pallas (pallas_call at :772): the same on pre-partitioned
//      (B, nW, N, D) windows;
//   K7 _sdpa_windows_fused_pallas (pallas_call at :651): the attention core alone on packed
//      (B, nW, N, 3D) qkv, features (q|k|v) x head x dh.
//
// Bound on the H100: operations (the qkv GEMM, logits, w@v and proj in bf16; ~0.5 ms at
// 989 TF/s for a stage-1 block of the 0.25 deg model). A 144 x D window is 590 KB at
// D = 2048, far beyond the 227 KB of shared memory a block has, and the tail's LayerNorm
// needs whole D-wide rows across all heads, so the work is split in two launches:
//
// (a) window_attn_kernel: one block of 9 warps per (window, head). Warp w owns tokens
//     16w..16w+15 of the window (144 = 9 x 16). A block first works out the row of each of
//     its tokens: in place in the 5D grid (K2) or consecutive rows of a partitioned window
//     (K6, K7). K2/K6: the window rows stream through shared memory in k-steps of 32
//     together with the head's (3 x 64) x 32 weight slice; the qkv product runs on bf16
//     mma.sync with f32 accumulation and is rounded, then the bf16 bias is added and
//     rounded again (swin3d.py:573-577). K7 (PACKED): the head's q, k and v are read from
//     the packed rows instead. q, k and v^T of the head (144 x 64 each) stay in shared
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
#include "common.cuh"
#include "row_tail.cuh"

namespace {

constexpr int WN = 144;  // tokens per window (2 x 6 x 12)
constexpr int DH = 64;   // head dim
constexpr int NWARP = WN / 16;
constexpr int THREADS = NWARP * 32;
constexpr int KC = 32;
constexpr int LDX = KC + 8;  // staging stride (bf16)
constexpr int LDQ = DH + 8;  // q / k stride
constexpr int LDV = WN + 8;  // v^T stride
constexpr size_t SMEM = (size_t)(WN * LDX + 3 * DH * LDX + 2 * WN * LDQ + DH * LDV) * 2 +
                        WN * sizeof(long long) + WN * sizeof(int);

// The qkv of one head for the window's 144 rows: 24 n8 tiles per warp (q 0-7, k 8-15,
// v 16-23) for its 16 tokens, rounded, + the bf16 bias, rounded, into Qs, Ks and Vt.
__device__ __forceinline__ void project_qkv(const bf16* __restrict__ x, int ldx,
                                            const bf16* __restrict__ wt,
                                            const bf16* __restrict__ bqkv, const long long* rowid,
                                            int D, int head, int tid, int lane, int warp, bf16* Xs,
                                            bf16* Ws, bf16* Qs, bf16* Ks, bf16* Vt) {
  const int gq = lane >> 2, tq = lane & 3;
  float acc[24][4];
#pragma unroll
  for (int j = 0; j < 24; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < WN * 4; i += THREADS) {
      int t = i >> 2, q = i & 3;
      *reinterpret_cast<uint4*>(Xs + t * LDX + q * 8) =
          *reinterpret_cast<const uint4*>(x + rowid[t] * ldx + k0 + q * 8);
    }
    for (int i = tid; i < 3 * DH * 4; i += THREADS) {
      int n = i >> 2, q = i & 3;
      long long wrow = (long long)(n / DH) * D + head * DH + n % DH;
      *reinterpret_cast<uint4*>(Ws + n * LDX + q * 8) =
          *reinterpret_cast<const uint4*>(wt + wrow * D + k0 + q * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t af[4];
      load_a(af, Xs, LDX, warp * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        uint32_t bfr[2];
        load_b(bfr, Ws, LDX, j * 8, kk, lane);
        mma_16816(acc[j], af, bfr);
      }
    }
  }
  {
    const int r = warp * 16 + gq;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int part = j / 8, d = (j % 8) * 8 + 2 * tq;
      const int n = part * D + head * DH + d;
      const float bb0 = __bfloat162float(bqkv[n]), bb1 = __bfloat162float(bqkv[n + 1]);
      const float v00 = bf16r(acc[j][0]) + bb0, v01 = bf16r(acc[j][1]) + bb1;
      const float v10 = bf16r(acc[j][2]) + bb0, v11 = bf16r(acc[j][3]) + bb1;
      if (part < 2) {
        bf16* dst = part == 0 ? Qs : Ks;
        *reinterpret_cast<uint32_t*>(dst + r * LDQ + d) = pack_bf16x2(v00, v01);
        *reinterpret_cast<uint32_t*>(dst + (r + 8) * LDQ + d) = pack_bf16x2(v10, v11);
      } else {
        Vt[d * LDV + r] = __float2bfloat16_rn(v00);
        Vt[(d + 1) * LDV + r] = __float2bfloat16_rn(v01);
        Vt[d * LDV + r + 8] = __float2bfloat16_rn(v10);
        Vt[(d + 1) * LDV + r + 8] = __float2bfloat16_rn(v11);
      }
    }
  }
}

// x: token rows of ldx elements (D, or 3D when PACKED); attn: D-wide rows, the same row
// numbering. Cp > 0: 5D tokens (B, Cp, Hp, Wp, .) with windows (ws0, ws1, ws2) in place;
// Cp == 0: partitioned windows, row = window * 144 + token.
template <bool PACKED>
__global__ void __launch_bounds__(THREADS) window_attn_kernel(
    const bf16* __restrict__ x, int ldx, const bf16* __restrict__ wt,
    const bf16* __restrict__ bqkv, const int* __restrict__ groups, int nW, int Cp, int Hp, int Wp,
    int D, int ws0, int ws1, int ws2, bf16* __restrict__ attn) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);  // [WN][LDX]
  bf16* Ws = Xs + WN * LDX;                  // [3 DH][LDX]
  bf16* Qs = Ws + 3 * DH * LDX;              // [WN][LDQ]
  bf16* Ks = Qs + WN * LDQ;                  // [WN][LDQ]
  bf16* Vt = Ks + WN * LDQ;                  // [DH][LDV]
  long long* rowid = reinterpret_cast<long long*>(Vt + DH * LDV);  // [WN]
  int* gs = reinterpret_cast<int*>(rowid + WN);                      // [WN]

  const int head = blockIdx.x;
  const int b = blockIdx.y / nW, wi = blockIdx.y % nW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;

  for (int t = tid; t < WN; t += THREADS) {
    if (Cp > 0) {
      const int H1 = Hp / ws1, W1 = Wp / ws2;
      const int c1 = wi / (H1 * W1), h1 = (wi / W1) % H1, w1 = wi % W1;
      const int wc = t / (ws1 * ws2), wh = (t / ws2) % ws1, ww = t % ws2;
      rowid[t] = (((long long)b * Cp + c1 * ws0 + wc) * Hp + h1 * ws1 + wh) * Wp + w1 * ws2 + ww;
    } else {
      rowid[t] = (long long)blockIdx.y * WN + t;
    }
    if (groups) gs[t] = groups[(long long)wi * WN + t];
  }
  __syncthreads();

  if constexpr (PACKED) {
    // q, k and v of this head straight from the packed rows, 8 features per load.
    for (int i = tid; i < WN * 3 * (DH / 8); i += THREADS) {
      const int t = i / (3 * (DH / 8)), part = (i / (DH / 8)) % 3, d = (i % (DH / 8)) * 8;
      const uint4 v =
          *reinterpret_cast<const uint4*>(x + rowid[t] * ldx + part * D + head * DH + d);
      if (part < 2) {
        *reinterpret_cast<uint4*>((part == 0 ? Qs : Ks) + t * LDQ + d) = v;
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[(d + j) * LDV + t] = e[j];
      }
    }
  } else {
    project_qkv(x, ldx, wt, bqkv, rowid, D, head, tid, lane, warp, Xs, Ws, Qs, Ks, Vt);
  }
  __syncthreads();

  // Logits of the warp's 16 query rows against all 144 keys: 18 n8 tiles.
  float s[18][4];
#pragma unroll
  for (int j = 0; j < 18; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    uint32_t af[4];
    load_a(af, Qs, LDQ, warp * 16, kk, lane);
#pragma unroll
    for (int j = 0; j < 18; ++j) {
      uint32_t bfr[2];
      load_b(bfr, Ks, LDQ, j * 8, kk, lane);
      mma_16816(s[j], af, bfr);
    }
  }
  const float scale = 0.125f;  // 1 / sqrt(64), exact
  const int q0 = warp * 16 + gq, q1 = q0 + 8;
  float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    const int kc = j * 8 + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    if (groups) {
      const int gk0 = gs[kc], gk1 = gs[kc + 1], g0 = gs[q0], g1 = gs[q1];
      s[j][0] += (g0 == gk0) ? 0.f : -100.f;
      s[j][1] += (g0 == gk1) ? 0.f : -100.f;
      s[j][2] += (g1 == gk0) ? 0.f : -100.f;
      s[j][3] += (g1 == gk1) ? 0.f : -100.f;
    }
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    s[j][0] = expf(s[j][0] - m0);
    s[j][1] = expf(s[j][1] - m0);
    s[j][2] = expf(s[j][2] - m1);
    s[j][3] = expf(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // w @ v: the rounded weights of two neighbouring n8 tiles form one A fragment.
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < WN / 16; ++kt) {
    uint32_t af[4];
    af[0] = pack_bf16x2(s[2 * kt][0] / l0, s[2 * kt][1] / l0);
    af[1] = pack_bf16x2(s[2 * kt][2] / l1, s[2 * kt][3] / l1);
    af[2] = pack_bf16x2(s[2 * kt + 1][0] / l0, s[2 * kt + 1][1] / l0);
    af[3] = pack_bf16x2(s[2 * kt + 1][2] / l1, s[2 * kt + 1][3] / l1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bfr[2];
      load_b(bfr, Vt, LDV, j * 8, kt * 16, lane);
      mma_16816(o[j], af, bfr);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = head * DH + j * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(attn + rowid[q0] * D + col) = pack_bf16x2(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(attn + rowid[q1] * D + col) = pack_bf16x2(o[j][2], o[j][3]);
  }
}

template <bool PACKED>
int launch_attn(const void* x, int ldx, const void* wqkv_t, const void* bqkv, const int* groups,
                void* attn, int B, int nW, int Cp, int Hp, int Wp, int D, int ws0, int ws1,
                int ws2, int heads, cudaStream_t stream) {
  if (D != heads * DH || D % KC || (long long)B * nW > 65535) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(window_attn_kernel<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM);
  window_attn_kernel<PACKED><<<dim3(heads, B * nW), THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(wqkv_t),
      static_cast<const bf16*>(bqkv), groups, nW, Cp, Hp, Wp, D, ws0, ws1, ws2,
      static_cast<bf16*>(attn));
  return (int)cudaGetLastError();
}

}  // namespace

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
  int err = launch_attn<false>(x, D, wqkv_t, bqkv, groups, attn, B, nW, Cp, Hp, Wp, D, ws0, ws1,
                               ws2, heads, stream);
  if (err || !wproj_t) return err;
  const long long per_batch = (long long)nW * WN;
  return launch_gemm_ln_rows(static_cast<const bf16*>(attn), static_cast<const bf16*>(wproj_t),
                             bproj, static_cast<const bf16*>(x), nullptr, 0, scale, shift,
                             per_batch, B * per_batch, D, D, eps, static_cast<bf16*>(out), stream);
}

// K7: qkv (B, nW, 144, 3D) bf16 packed (q|k|v) x head x 64 -> out (B, nW, 144, D) bf16;
// groups: (nW, 144) int32 or null. Returns cudaGetLastError().
extern "C" int sdpa_windows(const void* qkv, const int* groups, void* out, int B, int nW, int D,
                            int heads, cudaStream_t stream) {
  return launch_attn<true>(qkv, 3 * D, nullptr, nullptr, groups, out, B, nW, 0, 0, 0, D, 0, 0, 0,
                           heads, stream);
}
