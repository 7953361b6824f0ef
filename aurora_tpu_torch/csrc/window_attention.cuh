// The window-attention body of the probe kernel K11 (probes.cu), its only user: 144-token
// windows, head dim 64, one block of 9 warps per window and head, the qkv projection of the
// head on unstaged mma.sync tiles in front of the core. (K2, K6 and K10 run on the TMA +
// wgmma ring and the core of sdpa_sm90.cuh instead: window_attention.cu, attn_probe.cu.)
// K11's redesign retires it.
//
// Pieces, each for the warp's 16 query rows (warp w owns tokens 16w..16w+15):
//   project_qkv   qkv of one 64-wide head slice for the window's 144 rows into Qs, Ks, Vt
//                 (project_step per k-step of 32, then project_finish);
//   qk_logits     s += Q K^T on the tensor cores, f32 in registers (18 n8 tiles);
//   softmax_rows  the row softmax of s (f32);
//   pack_weights  the weights rounded to bf16 as A fragments;
//   weights_v     o += w @ v from those fragments and Vt;
//   store_o       the 16 x 64 result into the tokens' rows of a D-wide output.
#pragma once

#include "common.cuh"

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

// One k-step of the qkv product of a head: the warp's 16 tokens (A from Xs, [WN][LDX])
// against the head's 3 x 64 weight rows (B from Ws, [3 DH][LDX]); 24 n8 tiles per warp
// (q 0-7, k 8-15, v 16-23).
__device__ __forceinline__ void project_step(float acc[24][4], const bf16* Xs, const bf16* Ws,
                                             int warp, int lane) {
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

// The finished product, rounded, + the bf16 bias, rounded, into Qs, Ks and Vt.
__device__ __forceinline__ void project_finish(const float acc[24][4],
                                               const bf16* __restrict__ bqkv, int D, int head,
                                               int warp, int lane, bf16* Qs, bf16* Ks, bf16* Vt) {
  const int gq = lane >> 2, tq = lane & 3;
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

// Quad q (8 values) of the k-step at k0 of row n (0..191: q, k, v rows of the head) of the
// head's slice of the (3D, D) weight.
__device__ __forceinline__ const bf16* weight_piece(const bf16* __restrict__ wt, int D, int head,
                                                    int n, int k0, int q) {
  return wt + ((long long)(n / DH) * D + head * DH + n % DH) * D + k0 + q * 8;
}

// The qkv of one head for the window's 144 rows into Qs, Ks and Vt: the rows and the head's
// weight slice stream through Xs and Ws in k-steps of 32.
__device__ __forceinline__ void project_qkv(const bf16* __restrict__ x, int ldx,
                                            const bf16* __restrict__ wt,
                                            const bf16* __restrict__ bqkv, const long long* rowid,
                                            int D, int head, int tid, int lane, int warp, bf16* Xs,
                                            bf16* Ws, bf16* Qs, bf16* Ks, bf16* Vt) {
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
      *reinterpret_cast<uint4*>(Ws + n * LDX + q * 8) =
          *reinterpret_cast<const uint4*>(weight_piece(wt, D, head, n, k0, q));
    }
    __syncthreads();
    project_step(acc, Xs, Ws, warp, lane);
  }
  project_finish(acc, bqkv, D, head, warp, lane, Qs, Ks, Vt);
}

// The row of token t of window wi of batch element b: in place in the 5D grid
// (B, Cp, Hp, Wp, .) with windows (ws0, ws1, ws2) when Cp > 0, else row wi * 144 + t of
// partitioned windows (wi then counts over batch and window).
__device__ __forceinline__ long long window_row(int b, int wi, int t, int Cp, int Hp, int Wp,
                                                int ws0, int ws1, int ws2) {
  if (Cp == 0) return (long long)wi * WN + t;
  const int H1 = Hp / ws1, W1 = Wp / ws2;
  const int c1 = wi / (H1 * W1), h1 = (wi / W1) % H1, w1 = wi % W1;
  const int wc = t / (ws1 * ws2), wh = (t / ws2) % ws1, ww = t % ws2;
  return (((long long)b * Cp + c1 * ws0 + wc) * Hp + h1 * ws1 + wh) * Wp + w1 * ws2 + ww;
}

// s += Q K^T for the warp's 16 query rows against all 144 keys: 18 n8 tiles.
__device__ __forceinline__ void qk_logits(float s[18][4], const bf16* Qs, const bf16* Ks,
                                          int warp, int lane) {
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
}

// The row softmax of the raw logits s, scale 1/sqrt(64), in f32. On return s / l are the
// weights (rows gq and gq + 8 of the warp's tile divide by l0 and l1). gs: the window's 144
// group ids (0 for equal ids, -100 otherwise), or null for no mask.
__device__ __forceinline__ void softmax_rows(float s[18][4], const int* gs, int warp, int lane,
                                             float& l0, float& l1) {
  const int gq = lane >> 2, tq = lane & 3;
  const float scale = 0.125f;  // 1 / sqrt(64), exact
  const int q0 = warp * 16 + gq, q1 = q0 + 8;
  float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    const int kc = j * 8 + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    if (gs) {
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
  l0 = 0.f;
  l1 = 0.f;
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
}

// The rounded weights s / l as A fragments: two neighbouring n8 tiles form one fragment.
__device__ __forceinline__ void pack_weights(uint32_t wf[WN / 16][4], const float s[18][4],
                                             float l0, float l1) {
#pragma unroll
  for (int kt = 0; kt < WN / 16; ++kt) {
    wf[kt][0] = pack_bf16x2(s[2 * kt][0] / l0, s[2 * kt][1] / l0);
    wf[kt][1] = pack_bf16x2(s[2 * kt][2] / l1, s[2 * kt][3] / l1);
    wf[kt][2] = pack_bf16x2(s[2 * kt + 1][0] / l0, s[2 * kt + 1][1] / l0);
    wf[kt][3] = pack_bf16x2(s[2 * kt + 1][2] / l1, s[2 * kt + 1][3] / l1);
  }
}

// o = w @ v for the warp's 16 rows and the 64 columns of Vt ([DH][LDV], v transposed).
__device__ __forceinline__ void weights_v(float o[8][4], const uint32_t wf[WN / 16][4],
                                          const bf16* Vt, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < WN / 16; ++kt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bfr[2];
      load_b(bfr, Vt, LDV, j * 8, kt * 16, lane);
      mma_16816(o[j], wf[kt], bfr);
    }
  }
}

// The warp's 16 x 64 tile, rounded, into columns col0.. of its tokens' rows of attn.
__device__ __forceinline__ void store_o(const float o[8][4], const long long* rowid, int D,
                                        int col0, bf16* __restrict__ attn, int warp, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = warp * 16 + gq, q1 = q0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + j * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(attn + rowid[q0] * D + col) = pack_bf16x2(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(attn + rowid[q1] * D + col) = pack_bf16x2(o[j][2], o[j][3]);
  }
}

// Logits, softmax, w @ v and the store for one head whose q, k and v^T sit in Qs, Ks, Vt.
__device__ __forceinline__ void attend_store(const bf16* Qs, const bf16* Ks, const bf16* Vt,
                                             const int* gs, const long long* rowid, int D,
                                             int col0, bf16* __restrict__ attn, int warp,
                                             int lane) {
  float s[18][4];
#pragma unroll
  for (int j = 0; j < 18; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  qk_logits(s, Qs, Ks, warp, lane);
  float l0, l1;
  softmax_rows(s, gs, warp, lane, l0, l1);
  uint32_t wf[WN / 16][4];
  pack_weights(wf, s, l0, l1);
  float o[8][4];
  weights_v(o, wf, Vt, lane);
  store_o(o, rowid, D, col0, attn, warp, lane);
}

// The shared-memory carve-up of one (window, head) block.
struct WindowSmem {
  bf16 *Xs, *Ws, *Qs, *Ks, *Vt;
  long long* rowid;
  int* gs;
  __device__ explicit WindowSmem(unsigned char* smem) {
    Xs = reinterpret_cast<bf16*>(smem);  // [WN][LDX]
    Ws = Xs + WN * LDX;                  // [3 DH][LDX]
    Qs = Ws + 3 * DH * LDX;              // [WN][LDQ]
    Ks = Qs + WN * LDQ;                  // [WN][LDQ]
    Vt = Ks + WN * LDQ;                  // [DH][LDV]
    rowid = reinterpret_cast<long long*>(Vt + DH * LDV);  // [WN]
    gs = reinterpret_cast<int*>(rowid + WN);               // [WN]
  }
};

}  // namespace
