// The attention core of one (window, head): 144 tokens, head dim 64, as inline pieces over
// q, k and v tiles that a TMA load has put into shared memory as they are stored:
// [token][64 features], 128-byte rows under the 128-byte swizzle (tma_sm90.cuh swz128), each
// tile 18,432 bytes and 1024-byte aligned. The ring kernel of sdpa_sm90.cuh runs it for K7
// (sdpa.cu) and for K2 / K6 after their qkv projection (window_attention.cu).
//
// Tensor cores: mma.sync m16n8k16, not wgmma. 144 = 9 x 16 fills nine warps' m16 tiles
// with nothing wasted, where wgmma's 64-row tiles would leave the third three-quarters
// empty; and the core is small in operations (5.3 MFLOP a unit) against its bytes, so what
// counts is that loads, fragment traffic and the softmax overlap, not the wgmma rate.
// Warp w owns query rows 16w..16w+15. Fragments come by ldmatrix, conflict-free under the
// swizzle: q as A (x4: one k16 step), k as B (x4: two n8 key tiles of a k16 step), v as B
// by ldmatrix.trans straight from [token][feature] rows (x4: two n8 feature tiles of a k16
// token step), so v is never transposed in shared memory.
//
// Numerics (aurora_tpu/model/swin3d.py _heads_attention): f32 logits q.k / 8 plus 0 / -100
// from the group ids, f32 softmax, weights rounded to bf16, f32-accumulated w @ v, rounded.
// The softmax runs in base 2: t = s (log2 e / 8) + (0 or -100 log2 e), p = exp2(t - max t),
// weights p (1 / sum p), one reciprocal a row. exp2 and the reciprocal differ from exp and
// the quotient by a few f32 ulps, far inside the bf16 rounding of the weights.
#pragma once

#include "common.cuh"
#include "tma_sm90.cuh"

namespace {

constexpr int CORE_N = 144;                        // tokens of a window
constexpr int CORE_WARPS = CORE_N / 16;            // 9
constexpr int CORE_TILE_BYTES = CORE_N * 64 * 2;   // one of q, k, v: 18,432

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// s += q k^T for the warp's 16 query rows against all 144 keys: 18 n8 tiles, raw (unscaled).
// Lane l addresses row l % 8 of 8 x 8 matrix l / 8 of each x4 load; every row offset is a
// multiple of 8, so the swizzle's XOR is with l % 8.
__device__ __forceinline__ void core_logits(float (&s)[18][4], uint32_t q, uint32_t k, int warp,
                                            int lane) {
  const int lr = lane & 7, lo = (lane >> 3) & 1, hi = lane >> 4;
  const uint32_t a_row = q + (warp * 16 + lo * 8 + lr) * 128;  // A: rows by lo, k half by hi
  const uint32_t b_row = k + (hi * 8 + lr) * 128;              // B: keys by hi, k half by lo
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_row + (((2 * ks + hi) ^ lr) << 4));
#pragma unroll
    for (int jp = 0; jp < 9; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, b_row + jp * 16 * 128 + (((2 * ks + lo) ^ lr) << 4));
      mma_16816(s[2 * jp], a, &b[0]);
      mma_16816(s[2 * jp + 1], a, &b[2]);
    }
  }
}

// Which of the thread's logits are masked: bit 2j + e of neq[h] is set where key column
// 8j + 2t + e is in another group than query row 16 warp + g + 8h. ids: the window's 144
// group ids in device memory.
__device__ __forceinline__ void core_mask_bits(uint64_t (&neq)[2], const int* __restrict__ ids,
                                               int warp, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int g0 = ids[warp * 16 + gq], g1 = ids[warp * 16 + gq + 8];
  neq[0] = neq[1] = 0;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    const int2 gk = *reinterpret_cast<const int2*>(ids + j * 8 + 2 * tq);
    neq[0] |= (uint64_t)((gk.x != g0) | ((gk.y != g0) << 1)) << (2 * j);
    neq[1] |= (uint64_t)((gk.x != g1) | ((gk.y != g1) << 1)) << (2 * j);
  }
}

// The row softmax of the raw logits, in place: on return s are the exponentials and inv0,
// inv1 the reciprocals of their row sums (rows g and g + 8 of the warp's tile).
template <bool MASKED>
__device__ __forceinline__ void core_softmax(float (&s)[18][4], const uint64_t (&neq)[2],
                                             float& inv0, float& inv1) {
  constexpr float C = 0.18033688011112042f;   // log2(e) / sqrt(64)
  constexpr float NEG = -144.26950408889634f;  // -100 log2(e)
  float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float bias = 0.f;
      if constexpr (MASKED) bias = ((neq[e >> 1] >> (2 * j + (e & 1))) & 1) ? NEG : 0.f;
      s[j][e] = fmaf(s[j][e], C, bias);
    }
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    s[j][0] = exp2f(s[j][0] - m0);
    s[j][1] = exp2f(s[j][1] - m0);
    s[j][2] = exp2f(s[j][2] - m1);
    s[j][3] = exp2f(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  inv0 = 1.f / quad_sum(l0);
  inv1 = 1.f / quad_sum(l1);
}

// The weights s inv, rounded to bf16, as A fragments: two neighbouring n8 tiles form one.
__device__ __forceinline__ void core_pack(uint32_t (&wf)[9][4], const float (&s)[18][4], float inv0,
                                          float inv1) {
#pragma unroll
  for (int kt = 0; kt < 9; ++kt) {
    wf[kt][0] = pack_bf16x2(s[2 * kt][0] * inv0, s[2 * kt][1] * inv0);
    wf[kt][1] = pack_bf16x2(s[2 * kt][2] * inv1, s[2 * kt][3] * inv1);
    wf[kt][2] = pack_bf16x2(s[2 * kt + 1][0] * inv0, s[2 * kt + 1][1] * inv0);
    wf[kt][3] = pack_bf16x2(s[2 * kt + 1][2] * inv1, s[2 * kt + 1][3] * inv1);
  }
}

// The probe's forms of the weights (K10, attn_probe.cu), beside the model's softmax:
// CORE_NO_SOFTMAX hands on the scaled f32 logits, rounded, as the weights; CORE_SOFTMAX_BF16
// rounds the logits to bf16 before the scale (1/8, exact) and every later value to bf16:
// the difference to the row maximum, its exponential, the row sum (summed in f32) and the
// quotient, in the order of aurora_tpu_torch/ops/probes.py::attn_probe_plain. A row's 144
// logits are all in the quad's registers, so the maximum is known before any exponential.
enum { CORE_SOFTMAX = 0, CORE_NO_SOFTMAX = 1, CORE_SOFTMAX_BF16 = 2 };

__device__ __forceinline__ void core_pack_scaled(uint32_t (&wf)[9][4], const float (&s)[18][4]) {
#pragma unroll
  for (int kt = 0; kt < 9; ++kt) {
    wf[kt][0] = pack_bf16x2(s[2 * kt][0] * 0.125f, s[2 * kt][1] * 0.125f);
    wf[kt][1] = pack_bf16x2(s[2 * kt][2] * 0.125f, s[2 * kt][3] * 0.125f);
    wf[kt][2] = pack_bf16x2(s[2 * kt + 1][0] * 0.125f, s[2 * kt + 1][1] * 0.125f);
    wf[kt][3] = pack_bf16x2(s[2 * kt + 1][2] * 0.125f, s[2 * kt + 1][3] * 0.125f);
  }
}

// CORE_SOFTMAX_BF16 in place: on return s are the rounded exponentials and l0, l1 the
// rounded row sums (rows g and g + 8). exp(d) is taken as exp2(d log2 e), a few f32 ulps
// from expf and far inside the bf16 rounding that follows.
__device__ __forceinline__ void core_softmax_bf16(float (&s)[18][4], float& l0, float& l1) {
  constexpr float L2E = 1.4426950408889634f;
  float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = bf16r(s[j][e]) * 0.125f;
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  l0 = 0.f;
  l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    s[j][0] = bf16r(exp2f(bf16r(s[j][0] - m0) * L2E));
    s[j][1] = bf16r(exp2f(bf16r(s[j][1] - m0) * L2E));
    s[j][2] = bf16r(exp2f(bf16r(s[j][2] - m1) * L2E));
    s[j][3] = bf16r(exp2f(bf16r(s[j][3] - m1) * L2E));
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  l0 = bf16r(quad_sum(l0));
  l1 = bf16r(quad_sum(l1));
}

// The weights s / l, each quotient rounded to bf16, as A fragments. The quotient is
// __fdividef's (within 2 f32 ulps for the row sums' range, 1 <= l <= 144), far inside the
// bf16 rounding that follows; an IEEE division a weight cost most of this form's time.
__device__ __forceinline__ void core_pack_div(uint32_t (&wf)[9][4], const float (&s)[18][4],
                                              float l0, float l1) {
#pragma unroll
  for (int kt = 0; kt < 9; ++kt) {
    wf[kt][0] = pack_bf16x2(__fdividef(s[2 * kt][0], l0), __fdividef(s[2 * kt][1], l0));
    wf[kt][1] = pack_bf16x2(__fdividef(s[2 * kt][2], l1), __fdividef(s[2 * kt][3], l1));
    wf[kt][2] = pack_bf16x2(__fdividef(s[2 * kt + 1][0], l0), __fdividef(s[2 * kt + 1][1], l0));
    wf[kt][3] = pack_bf16x2(__fdividef(s[2 * kt + 1][2], l1), __fdividef(s[2 * kt + 1][3], l1));
  }
}

// o = w @ v for the warp's 16 rows: 8 n8 feature tiles, v read as [token][feature].
__device__ __forceinline__ void core_weights_v(float (&o)[8][4], const uint32_t (&wf)[9][4],
                                               uint32_t v, int lane) {
  const int lr = lane & 7, lo = (lane >> 3) & 1, hi = lane >> 4;
  const uint32_t b_row = v + (lo * 8 + lr) * 128;  // tokens by lo, feature half by hi
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < 9; ++kt) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_row + kt * 16 * 128 + (((2 * np + hi) ^ lr) << 4));
      mma_16816(o[2 * np], wf[kt], &b[0]);
      mma_16816(o[2 * np + 1], wf[kt], &b[2]);
    }
  }
}

// The warp's 16 x 64 result, rounded, to columns col0.. of the D-wide output, token t of the
// window to row rows.row(base, t) (sdpa_sm90.cuh: consecutive rows, or the window's rows in
// place in a 5D grid). It goes through the warp's own 16 rows of the q tile (no other warp
// reads them, and this warp's logits are done), so that each lane stores 16 bytes and eight
// lanes a row's whole 128 bytes.
template <class Rows>
__device__ __forceinline__ void core_store(const float (&o)[8][4], uint32_t q, const Rows& rows,
                                           long long base, int D, int col0, bf16* __restrict__ out,
                                           int warp, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const uint32_t mine = q + (warp * 16 + gq) * 128 + tq * 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t p = mine + ((j ^ gq) << 4);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(p), "r"(pack_bf16x2(o[j][0], o[j][1])) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(p + 8 * 128), "r"(pack_bf16x2(o[j][2], o[j][3]))
                 : "memory");
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 16 + i * 4 + (lane >> 3), chunk = lane & 7;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(q + sm90::swz128(r, chunk))
                 : "memory");
    *reinterpret_cast<uint4*>(out + rows.row(base, r) * D + col0 + chunk * 8) = val;
  }
}

}  // namespace
