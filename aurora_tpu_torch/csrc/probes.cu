// K9-K13: the kernels of the probe tools (aurora_tpu_torch/tools/).
//
// They replace the five Pallas kernels that live in the JAX package's tools:
//   K9  mlp_t          tools/backbone_ablate.py make_mlp_t    (pallas_call at :457)
//   K10 attn_probe     tools/backbone_ablate.py make_probe     (pallas_call at :598)
//   K11 attn5d_direct  tools/backbone_ablate.py make_direct    (pallas_call at :877)
//   K12 gemm_blocked   tools/gemm_probe.py pallas_gemm         (pallas_call at :102)
//   K13 smem_probe     tools/vmem_probe.py try_size            (pallas_call at :26)
// Each computes what the TPU kernel computes; what a TPU mode meant (a Mosaic relayout, a
// sublane reduction, a VMEM ceiling) is given its reading on this card at each kernel.
// All are simple mma.sync designs; their times stand in PERF.md beside their bounds.
#include "common.cuh"
#include "window_attention.cuh"

namespace {

// ------------------------------------------------------------------------------ K12
// out = round_bf16(A @ W), f32 accumulation; A (M, K) bf16 rows, W (K, N) bf16 as stored.
// Bound: bytes at the proj shape (K = N = 512), operations at fc2 (K = 2048).
// The TPU kernel held a row block of MB rows with whole K and N in VMEM. Whole K and N do
// not fit a block's 227 KB at K = 2048, so MB keeps its meaning as the rows one block walks:
// block b owns rows [b MB, (b + 1) MB) and loops over 64-row tiles of them; per tile it
// walks N in chunks of 128 and K in steps of 32 through shared memory. 8 warps as 4 x 2,
// each a 16 x 64 tile. W is staged as stored, [k][n], and a B fragment is built from two
// 16-bit loads per register (conflict-free with the padded stride).
constexpr int G_RT = 64, G_NC = 128, G_KC = 32;
constexpr int G_LDA = G_KC + 8, G_LDB = G_NC + 8;

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// B fragment of columns n0..n0+7, k0..k0+15 of a [k][n] tile with leading dimension ld.
__device__ __forceinline__ void load_b_kn(uint32_t b[2], const bf16* base, int ld, int n0, int k0,
                                          int lane) {
  const bf16* p = base + (size_t)(k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b[0] = pack_raw(p[0], p[ld]);
  b[1] = pack_raw(p[8 * ld], p[9 * ld]);
}

__global__ void __launch_bounds__(256) gemm_blocked_kernel(const bf16* __restrict__ a,
                                                           const bf16* __restrict__ w,
                                                           long long M, int K, int N, int MB,
                                                           bf16* __restrict__ out) {
  __shared__ __align__(16) bf16 As[G_RT * G_LDA];
  __shared__ __align__(16) bf16 Bs[G_KC * G_LDB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int gq = lane >> 2, tq = lane & 3;
  const long long r_begin = (long long)blockIdx.x * MB;
  const long long r_end = r_begin + MB < M ? r_begin + MB : M;
  for (long long r0 = r_begin; r0 < r_end; r0 += G_RT) {
    for (int n0 = 0; n0 < N; n0 += G_NC) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k0 = 0; k0 < K; k0 += G_KC) {
        __syncthreads();
        {
          const int r = tid >> 2, q = tid & 3;  // 64 rows x 4 quads = 256 pieces
          uint4 v = make_uint4(0, 0, 0, 0);
          if (r0 + r < r_end) v = *reinterpret_cast<const uint4*>(a + (r0 + r) * K + k0 + q * 8);
          *reinterpret_cast<uint4*>(As + r * G_LDA + q * 8) = v;
        }
        for (int i = tid; i < G_KC * (G_NC / 8); i += 256) {
          const int kk = i / (G_NC / 8), q = i % (G_NC / 8);
          *reinterpret_cast<uint4*>(Bs + kk * G_LDB + q * 8) =
              *reinterpret_cast<const uint4*>(w + (long long)(k0 + kk) * N + n0 + q * 8);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < G_KC; kk += 16) {
          uint32_t af[4];
          load_a(af, As, G_LDA, wr * 16, kk, lane);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t bfr[2];
            load_b_kn(bfr, Bs, G_LDB, wc * 64 + j * 8, kk, lane);
            mma_16816(acc[j], af, bfr);
          }
        }
      }
      const long long row = r0 + wr * 16 + gq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wc * 64 + j * 8 + 2 * tq;
        if (row < r_end)
          *reinterpret_cast<uint32_t*>(out + row * N + n) = pack_bf16x2(acc[j][0], acc[j][1]);
        if (row + 8 < r_end)
          *reinterpret_cast<uint32_t*>(out + (row + 8) * N + n) = pack_bf16x2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// ------------------------------------------------------------------------------ K13
// out = 2 x + scratch[0][0] with scratch[0][:] = x[0][:], x (8, 128) f32, where scratch is
// `bytes` of dynamic shared memory whose last byte is written and read back. The card's
// counterpart of the TPU's VMEM ceiling is the dynamic shared memory a block may opt in to.
__global__ void __launch_bounds__(1024) smem_probe_kernel(const float* __restrict__ x,
                                                          float* __restrict__ out, int bytes) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* scratch = reinterpret_cast<float*>(raw);
  volatile unsigned char* last = raw + bytes - 1;
  const int tid = threadIdx.x;
  if (tid < 128) scratch[tid] = x[tid];
  __syncthreads();
  if (tid == 0) *last = 1;  // bytes > 512: beyond the first row
  __syncthreads();
  const float touched = (float)(*last) - 1.f;  // 0 when the byte held
  out[tid] = 2.f * x[tid] + scratch[0] + touched;
}

// ------------------------------------------------------------------------------ K10
// The qkv projection and the attention core, unmasked, on partitioned windows
// (nW, 144, D), in the probe's modes. SM picks the softmax form (window_attention.cuh);
// NO_CORE returns q, the first D features of the rounded, biased qkv. The grid's x extent
// is the schedule: `heads` gives one block per (window, head), K6's schedule (the TPU
// kernel's Python loop over heads); 1 gives one block per window that walks its heads with
// q, k and v of one head at a time in shared memory (the TPU kernel's "batched" forms,
// all heads in one batched product: the same numbers in another schedule).
template <int SM, bool NO_CORE>
__global__ void __launch_bounds__(THREADS) attn_probe_kernel(const bf16* __restrict__ x,
                                                             const bf16* __restrict__ wt,
                                                             const bf16* __restrict__ bqkv, int D,
                                                             int heads, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WindowSmem sm(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < WN; t += THREADS) sm.rowid[t] = (long long)blockIdx.y * WN + t;
  __syncthreads();
  for (int head = blockIdx.x; head < heads; head += gridDim.x) {
    project_qkv(x, D, wt, bqkv, sm.rowid, D, head, tid, lane, warp, sm.Xs, sm.Ws, sm.Qs, sm.Ks,
                sm.Vt);
    __syncthreads();
    if constexpr (NO_CORE) {
      for (int i = tid; i < WN * (DH / 8); i += THREADS) {
        const int t = i / (DH / 8), q = i % (DH / 8);
        *reinterpret_cast<uint4*>(out + sm.rowid[t] * D + head * DH + q * 8) =
            *reinterpret_cast<const uint4*>(sm.Qs + t * LDQ + q * 8);
      }
    } else {
      attend_store<SM>(sm.Qs, sm.Ks, sm.Vt, nullptr, sm.rowid, D, head * DH, out, warp, lane);
    }
  }
}

// Mode fulld: one head as wide as D (scale still 1/8). q, k and v of a window are 3 x 144 x D
// values, 442 KB at D = 512, beyond a block's shared memory, and the logits body is written
// for 64-wide operands. So one block per window tiles the head dim in chunks of 64: per
// chunk it projects q, k and v of those 64 features (a "head" of the projection), adds the
// chunk's q k^T to the f32 logits in registers, and keeps v^T of every chunk in shared
// memory ([D][LDV]); after the last chunk the softmax runs once and w @ v chunk by chunk.
constexpr size_t FULLD_FIXED =
    (size_t)(WN * LDX + 3 * DH * LDX + 2 * WN * LDQ) * 2 + WN * sizeof(long long);

__global__ void __launch_bounds__(THREADS) attn_fulld_kernel(const bf16* __restrict__ x,
                                                             const bf16* __restrict__ wt,
                                                             const bf16* __restrict__ bqkv, int D,
                                                             bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ws = Xs + WN * LDX;
  bf16* Qs = Ws + 3 * DH * LDX;
  bf16* Ks = Qs + WN * LDQ;
  long long* rowid = reinterpret_cast<long long*>(Ks + WN * LDQ);
  bf16* Vall = reinterpret_cast<bf16*>(rowid + WN);  // [D][LDV]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < WN; t += THREADS) rowid[t] = (long long)blockIdx.x * WN + t;
  __syncthreads();
  float s[18][4];
#pragma unroll
  for (int j = 0; j < 18; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const int chunks = D / DH;
  for (int c = 0; c < chunks; ++c) {
    project_qkv(x, D, wt, bqkv, rowid, D, c, tid, lane, warp, Xs, Ws, Qs, Ks,
                Vall + (size_t)c * DH * LDV);
    __syncthreads();
    qk_logits(s, Qs, Ks, warp, lane);
  }
  float l0, l1;
  softmax_rows<SOFTMAX_F32>(s, nullptr, warp, lane, l0, l1);
  uint32_t wf[WN / 16][4];
  pack_weights(wf, s, l0, l1);
  for (int c = 0; c < chunks; ++c) {
    float o[8][4];
    weights_v(o, wf, Vall + (size_t)c * DH * LDV, lane);
    store_o(o, rowid, D, c * DH, out, warp, lane);
  }
}

// ------------------------------------------------------------------------------ K11
// K2 without tail and mask where the unit of work is the TPU kernel's: the (ws0, ws1, Wp)
// strip of W1 windows of the 5D tokens, gathered on chip. A strip is 4.4 MB at stage 1, so a
// block (one per strip and head: the head axis fills the card, the TPU grid was (C1, H1))
// walks the strip's windows and holds one window's 144 x 32-channel slab at a time.
//   loop: each slab is gathered window by window from device memory through the table of
//         row numbers, with register-staged 16-byte loads, then multiplied (K2's way);
//   vec:  the slabs come in one pass of asynchronous 16-byte copies (cp.async) addressed
//         arithmetically in strip order (line of the strip, column), straight into shared
//         memory and double-buffered: the next slab and weight slice are in flight while
//         the current one is multiplied.
// Both write each window's result back in place and equal K2 without tail.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int STAGE = (WN + 3 * DH) * LDX;  // one buffer: a row slab and a weight slice

template <bool VEC>
__global__ void __launch_bounds__(THREADS) attn5d_direct_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wt, const bf16* __restrict__ bqkv, int Cp,
    int Hp, int Wp, int D, int ws0, int ws1, int ws2, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WindowSmem sm(smem);
  bf16* stage1 = reinterpret_cast<bf16*>(smem + SMEM);  // VEC: the second buffer
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head = blockIdx.x;
  const int H1 = Hp / ws1, W1 = Wp / ws2;
  const int b = blockIdx.y / ((Cp / ws0) * H1), strip = blockIdx.y % ((Cp / ws0) * H1);
  const int c1 = strip / H1, h1 = strip % H1;
  // First row of the strip; line l = (wc, wh) of it starts at ((wc * Hp) + wh) * Wp rows on.
  const long long strip0 = (((long long)b * Cp + c1 * ws0) * Hp + h1 * ws1) * Wp;
  for (int j = 0; j < W1; ++j) {
    __syncthreads();  // the previous window's stores have read rowid
    for (int t = tid; t < WN; t += THREADS)
      sm.rowid[t] = window_row(b, (c1 * H1 + h1) * W1 + j, t, Cp, Hp, Wp, ws0, ws1, ws2);
    __syncthreads();
    if constexpr (VEC) {
      auto fetch = [&](int k0, bf16* buf) {
        for (int i = tid; i < (WN + 3 * DH) * 4; i += THREADS) {
          const int r = i >> 2, q = i & 3;
          const bf16* src;
          if (r < WN) {
            const int line = r / ws2, ww = r % ws2;
            src = x + (strip0 + ((long long)(line / ws1) * Hp + line % ws1) * Wp + j * ws2 + ww) * D +
                  k0 + q * 8;
          } else {
            src = weight_piece(wt, D, head, r - WN, k0, q);
          }
          cp_async16(buf + r * LDX + q * 8, src);
        }
        cp_async_commit();
      };
      float acc[24][4];
#pragma unroll
      for (int jj = 0; jj < 24; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
      const int steps = D / KC;
      fetch(0, sm.Xs);
      for (int ks = 0; ks < steps; ++ks) {
        bf16* cur = (ks & 1) ? stage1 : sm.Xs;
        if (ks + 1 < steps) {
          fetch((ks + 1) * KC, (ks & 1) ? sm.Xs : stage1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        project_step(acc, cur, cur + WN * LDX, warp, lane);
        __syncthreads();  // before this buffer is filled again
      }
      project_finish(acc, bqkv, D, head, warp, lane, sm.Qs, sm.Ks, sm.Vt);
    } else {
      project_qkv(x, D, wt, bqkv, sm.rowid, D, head, tid, lane, warp, sm.Xs, sm.Ws, sm.Qs, sm.Ks,
                  sm.Vt);
    }
    __syncthreads();
    attend_store<SOFTMAX_F32>(sm.Qs, sm.Ks, sm.Vt, nullptr, sm.rowid, D, head * DH, out, warp,
                              lane);
  }
}

// ------------------------------------------------------------------------------ K9
// out = x + LN(round(fc2 GELU(round(fc1 x + b1)) + b2)) * sc + sh: K3's function at
// scale_bias = 0 with per-feature sc/sh, computed feature-major as the TPU kernel did.
// Bound: operations (4 rows D 4D bf16 flops). Where K3 has the tokens as the rows of its
// tensor-core tiles and each thread's registers run along a token's features, here the
// WEIGHT is the row operand: h^T (hidden x tokens) = W1^T x^T and out^T (D x tokens) =
// W2^T h^T. The A fragments come from the transposed weights (w1t (Hd, D), w2t (D, Hd),
// reduction dim contiguous), the B fragments from the token rows as stored (x is [token][k])
// and from the hidden chunk kept as [token][hidden] in shared memory. A block of 8 warps
// walks its R rows in tiles of RT = 32768 / D tokens; warp w owns features [w D/8, (w+1) D/8)
// of out^T for all RT tokens (128 f32 accumulators per thread, as K3). The hidden stays on
// chip in chunks of 64. The LayerNorm reduces down the accumulator's rows: over a thread's
// m16 tiles, across the 8 lanes that share a token column, then across the 8 warps through
// shared memory (two passes). The result is written back into the token tile in shared
// memory (the transpose back) and leaves in 16-byte row pieces.
constexpr int T_HC = 64;

template <int D>
__global__ void __launch_bounds__(256, 1) mlp_t_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1t, const float* __restrict__ b1,
    const bf16* __restrict__ w2t, const float* __restrict__ b2, const float* __restrict__ sh,
    const float* __restrict__ sc, long long L, int R, int Hd, float eps, bf16* __restrict__ out) {
  constexpr int RT = 32768 / D;  // tokens per tile: 64, 32, 16
  constexpr int NT = RT / 8;     // n8 token tiles
  constexpr int MT = D / 128;    // fc2 m16 feature tiles per warp
  constexpr int NT1 = RT / 16;   // fc1 n8 tiles per warp (4 m16 hidden tiles x NT over 8 warps)
  constexpr int LDX = D + 8, LDH = T_HC + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);           // [RT][LDX]
  bf16* Hs = Xs + RT * LDX;                           // [RT][LDH]
  float* red = reinterpret_cast<float*>(Hs + RT * LDH);  // [8][RT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const long long r_begin = (long long)blockIdx.x * R;
  const long long r_end = r_begin + R < L ? r_begin + R : L;
  const int mt1 = warp & 3, nb1 = (warp >> 2) * NT1;
  const int f_warp = warp * (D / 8);

  for (long long t0 = r_begin; t0 < r_end; t0 += RT) {
    __syncthreads();  // the previous tile has left Xs
    for (int i = tid; i < RT * (D / 8); i += 256) {
      const int r = i / (D / 8), q = i % (D / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t0 + r < r_end) v = *reinterpret_cast<const uint4*>(x + (t0 + r) * D + q * 8);
      *reinterpret_cast<uint4*>(Xs + r * LDX + q * 8) = v;
    }
    __syncthreads();

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

    for (int h0 = 0; h0 < Hd; h0 += T_HC) {
      // fc1: 16 hidden features (rows) x 8 * NT1 tokens (columns) per warp.
      float a1[NT1][4];
#pragma unroll
      for (int j = 0; j < NT1; ++j) a1[j][0] = a1[j][1] = a1[j][2] = a1[j][3] = 0.f;
      for (int k = 0; k < D; k += 16) {
        uint32_t af[4];
        load_a(af, w1t, D, h0 + mt1 * 16, k, lane);
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
          uint32_t bfr[2];
          load_b(bfr, Xs, LDX, (nb1 + j) * 8, k, lane);
          mma_16816(a1[j], af, bfr);
        }
      }
      {
        const int hid = mt1 * 16 + gq;
        const float bb0 = b1[h0 + hid], bb1 = b1[h0 + hid + 8];
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
          const int tok = (nb1 + j) * 8 + 2 * tq;
          Hs[tok * LDH + hid] = __float2bfloat16_rn(gelu_erf(bf16r(a1[j][0] + bb0)));
          Hs[(tok + 1) * LDH + hid] = __float2bfloat16_rn(gelu_erf(bf16r(a1[j][1] + bb0)));
          Hs[tok * LDH + hid + 8] = __float2bfloat16_rn(gelu_erf(bf16r(a1[j][2] + bb1)));
          Hs[(tok + 1) * LDH + hid + 8] = __float2bfloat16_rn(gelu_erf(bf16r(a1[j][3] + bb1)));
        }
      }
      __syncthreads();
      // fc2: the warp's D / 8 features (rows) x all RT tokens (columns).
#pragma unroll
      for (int k = 0; k < T_HC; k += 16) {
        uint32_t bfr[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) load_b(bfr[j], Hs, LDH, j * 8, k, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4];
          load_a(af, w2t, Hd, f_warp + i * 16, h0 + k, lane);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_16816(acc[i][j], af, bfr[j]);
        }
      }
      __syncthreads();
    }

    // y = round(acc + b2), then the LayerNorm down the feature rows of each token column.
    // A thread holds, per token tile j, tokens 2 tq and 2 tq + 1 (e = 0, 1).
    float s[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int f = f_warp + i * 16 + gq;
      const float bb0 = b2[f], bb1 = b2[f + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[i][j][0] = bf16r(acc[i][j][0] + bb0);
        acc[i][j][1] = bf16r(acc[i][j][1] + bb0);
        acc[i][j][2] = bf16r(acc[i][j][2] + bb1);
        acc[i][j][3] = bf16r(acc[i][j][3] + bb1);
        s[j][0] += acc[i][j][0] + acc[i][j][2];
        s[j][1] += acc[i][j][1] + acc[i][j][3];
      }
    }
    float mean[NT][2], rstd[NT][2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1) {
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float d;
            d = acc[i][j][0] - mean[j][0]; s[j][0] += d * d;
            d = acc[i][j][2] - mean[j][0]; s[j][0] += d * d;
            d = acc[i][j][1] - mean[j][1]; s[j][1] += d * d;
            d = acc[i][j][3] - mean[j][1]; s[j][1] += d * d;
          }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = s[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) red[warp * RT + j * 8 + 2 * tq + e] = v;
        }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < 8; ++w8) v += red[w8 * RT + j * 8 + 2 * tq + e];
          if (pass == 0) mean[j][e] = v / D;
          else rstd[j][e] = rsqrtf(v / D + eps);
        }
      __syncthreads();
    }

    // out = x + LN(y) * sc + sh, written over x in the token tile (the transpose back).
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = f_warp + i * 16 + gq + 8 * half;
        const float g = sc[f], hsh = sh[f];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bf16* px = Xs + (j * 8 + 2 * tq + e) * LDX + f;
            const float y = acc[i][j][2 * half + e];
            *px = __float2bfloat16_rn(__bfloat162float(*px) +
                                      ((y - mean[j][e]) * rstd[j][e] * g + hsh));
          }
      }
    __syncthreads();
    for (int i = tid; i < RT * (D / 8); i += 256) {
      const int r = i / (D / 8), q = i % (D / 8);
      if (t0 + r < r_end)
        *reinterpret_cast<uint4*>(out + (t0 + r) * D + q * 8) =
            *reinterpret_cast<const uint4*>(Xs + r * LDX + q * 8);
    }
  }
}

template <int D>
int launch_mlp_t(const bf16* x, const bf16* w1t, const float* b1, const bf16* w2t, const float* b2,
                 const float* sh, const float* sc, long long L, int R, int Hd, float eps, bf16* out,
                 cudaStream_t stream) {
  constexpr int RT = 32768 / D;
  const size_t smem = (size_t)RT * (D + 8) * 2 + (size_t)RT * (T_HC + 8) * 2 + 8 * RT * sizeof(float);
  cudaFuncSetAttribute(mlp_t_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const unsigned blocks = (unsigned)((L + R - 1) / R);
  mlp_t_kernel<D><<<blocks, 256, smem, stream>>>(x, w1t, b1, w2t, b2, sh, sc, L, R, Hd, eps, out);
  return (int)cudaGetLastError();
}

template <int SM, bool NO_CORE>
int launch_attn_probe(const bf16* x, const bf16* wt, const bf16* b, int nW, int D, int heads,
                      int grid_x, bf16* out, cudaStream_t stream) {
  cudaFuncSetAttribute(attn_probe_kernel<SM, NO_CORE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM);
  attn_probe_kernel<SM, NO_CORE><<<dim3(grid_x, nW), THREADS, SMEM, stream>>>(x, wt, b, D, heads,
                                                                               out);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_direct(const bf16* x, const bf16* wt, const bf16* b, int B, int Cp, int Hp, int Wp, int D,
                  int ws0, int ws1, int ws2, int heads, bf16* out, cudaStream_t stream) {
  const size_t smem = SMEM + (VEC ? (size_t)STAGE * 2 : 0);
  cudaFuncSetAttribute(attn5d_direct_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  attn5d_direct_kernel<VEC><<<dim3(heads, B * (Cp / ws0) * (Hp / ws1)), THREADS, smem, stream>>>(
      x, wt, b, Cp, Hp, Wp, D, ws0, ws1, ws2, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K12. a: (M, K) bf16; w: (K, N) bf16 as stored; out: (M, N) bf16; MB rows per block.
// Needs K % 32 == 0 and N % 128 == 0. Returns cudaGetLastError().
extern "C" int gemm_blocked(const void* a, const void* w, void* out, int M, int K, int N, int MB,
                            cudaStream_t stream) {
  if (K % G_KC || N % G_NC || MB <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + MB - 1) / MB);
  gemm_blocked_kernel<<<blocks, 256, 0, stream>>>(static_cast<const bf16*>(a),
                                                  static_cast<const bf16*>(w), M, K, N, MB,
                                                  static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// K13. x, out: (8, 128) f32; bytes of dynamic shared memory to opt in to and launch with.
// Returns the error of the refused attribute or launch (and clears it: neither is sticky),
// else cudaGetLastError() after the launch.
extern "C" int smem_probe(const float* x, float* out, int bytes, cudaStream_t stream) {
  if (bytes <= 512) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  smem_probe_kernel<<<1, 1024, bytes, stream>>>(x, out, bytes);
  return (int)cudaGetLastError();
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device into *bytes.
extern "C" int smem_optin_bytes(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// K10. x, out: (nW, 144, D) bf16; wqkv_t: (3D, D) bf16; bqkv: (3D,) bf16; heads = D / 64.
// mode: 0 baseline, 1 no_softmax, 2 no_core, 3 fulld, 4 bf16_core, 5 batched_heads,
// 6 bf16_batched. Returns cudaGetLastError().
extern "C" int attn_probe(const void* x, const void* wqkv_t, const void* bqkv, void* out, int nW,
                          int D, int heads, int mode, cudaStream_t stream) {
  if (D != heads * DH || D % KC || nW > 65535) return (int)cudaErrorInvalidValue;
  auto xb = static_cast<const bf16*>(x);
  auto wt = static_cast<const bf16*>(wqkv_t);
  auto bb = static_cast<const bf16*>(bqkv);
  auto ob = static_cast<bf16*>(out);
  switch (mode) {
    case 0: return launch_attn_probe<SOFTMAX_F32, false>(xb, wt, bb, nW, D, heads, heads, ob, stream);
    case 1: return launch_attn_probe<SOFTMAX_NONE, false>(xb, wt, bb, nW, D, heads, heads, ob, stream);
    case 2: return launch_attn_probe<SOFTMAX_F32, true>(xb, wt, bb, nW, D, heads, heads, ob, stream);
    case 3: {
      const size_t smem = FULLD_FIXED + (size_t)D * LDV * 2;
      cudaFuncSetAttribute(attn_fulld_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      attn_fulld_kernel<<<nW, THREADS, smem, stream>>>(xb, wt, bb, D, ob);
      return (int)cudaGetLastError();
    }
    case 4: return launch_attn_probe<SOFTMAX_BF16, false>(xb, wt, bb, nW, D, heads, heads, ob, stream);
    case 5: return launch_attn_probe<SOFTMAX_F32, false>(xb, wt, bb, nW, D, heads, 1, ob, stream);
    case 6: return launch_attn_probe<SOFTMAX_BF16, false>(xb, wt, bb, nW, D, heads, 1, ob, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K11. x, out: (B, Cp, Hp, Wp, D) bf16 with windows (ws0, ws1, ws2) of 144 tokens in place;
// wqkv_t: (3D, D) bf16; bqkv: (3D,) bf16; vec: 1 for mode vec, 0 for mode loop.
// Returns cudaGetLastError().
extern "C" int attn5d_direct(const void* x, const void* wqkv_t, const void* bqkv, void* out, int B,
                             int Cp, int Hp, int Wp, int D, int ws0, int ws1, int ws2, int heads,
                             int vec, cudaStream_t stream) {
  if (ws0 * ws1 * ws2 != WN || Cp % ws0 || Hp % ws1 || Wp % ws2 || D != heads * DH || D % KC ||
      (long long)B * (Cp / ws0) * (Hp / ws1) > 65535)
    return (int)cudaErrorInvalidValue;
  auto xb = static_cast<const bf16*>(x);
  auto wt = static_cast<const bf16*>(wqkv_t);
  auto bb = static_cast<const bf16*>(bqkv);
  auto ob = static_cast<bf16*>(out);
  return vec ? launch_direct<true>(xb, wt, bb, B, Cp, Hp, Wp, D, ws0, ws1, ws2, heads, ob, stream)
             : launch_direct<false>(xb, wt, bb, B, Cp, Hp, Wp, D, ws0, ws1, ws2, heads, ob, stream);
}

// K9. x, out: (L, D) bf16 rows; w1t: (Hd, D) bf16; w2t: (D, Hd) bf16; b1: (Hd,), b2, sh, sc:
// (D,) f32; R: rows per block. D in (512, 1024, 2048), Hd % 64 == 0.
// Returns cudaGetLastError().
extern "C" int mlp_t(const void* x, const void* w1t, const float* b1, const void* w2t,
                     const float* b2, const float* sh, const float* sc, void* out, int L, int R,
                     int D, int Hd, float eps, cudaStream_t stream) {
  if (Hd % T_HC || R <= 0) return (int)cudaErrorInvalidValue;
  auto xb = static_cast<const bf16*>(x);
  auto w1 = static_cast<const bf16*>(w1t);
  auto w2 = static_cast<const bf16*>(w2t);
  auto ob = static_cast<bf16*>(out);
  switch (D) {
    case 512: return launch_mlp_t<512>(xb, w1, b1, w2, b2, sh, sc, L, R, Hd, eps, ob, stream);
    case 1024: return launch_mlp_t<1024>(xb, w1, b1, w2, b2, sh, sc, L, R, Hd, eps, ob, stream);
    case 2048: return launch_mlp_t<2048>(xb, w1, b1, w2, b2, sh, sc, L, R, Hd, eps, ob, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
