// K9 mlp_t: the block's MLP branch computed feature-major, as the TPU probe did:
//   out = x + LN(round(fc2 GELU(round(fc1 x + b1)) + b2)) * sc + sh      (K3 at scale_bias 0)
// for x (L, D) bf16 rows, w1 (D, Hd) and w2 (Hd, D) bf16 as stored, b1 (Hd,), b2, sh, sc (D,) f32.
// Replaces tools/backbone_ablate.py make_mlp_t (pallas_call at :457).
//
// What the TPU kernel meant. It transposed its (R, D) row tile once so that both products
// have the WEIGHT as the row operand and the tokens as the wide N dimension, and the
// LayerNorm reduces down the features. On the card both products run on the TMA + wgmma
// ring of gemm_sm90.cuh in that form, GemmRing<S, A_MN = true>: A is the weight as stored
// (W1 (D, Hd) is W1^T's MN-major form, W2 (Hd, D) W2^T's), N the tokens:
//
//   fc1 (mlp_t_gemm_kernel<FC1>): h^T (Hd x tokens) = W1^T x^T, B = x as stored (K-major B,
//       one box of 256 token rows x 64 k a stage). Epilogue: + b1 per row (hidden feature),
//       round, erf GELU, round; the 128 x 256 tile leaves as stored (rows = hidden) into the
//       hidden scratch h^T (Hd, chunk tokens), the warps' swizzled staging of the ring.
//   fc2 (mlp_t_gemm_kernel<FC2>): y^T (D x tokens) = W2^T h^T, B = h^T (MN-major B, the ring's
//       usual B form). Epilogue: + b2 per row, round; per token (column) the mean and centred
//       sum of squares of the tile's 128 feature rows, a reduction down the accumulator's M:
//       quad rows by shuffles, the 8 warps through shared memory, two passes; then the tile
//       goes back to token-major (L, D) rows through each warp's staging (the TPU kernel's
//       final .T) in 32-byte row pieces.
//   ln_rows_kernel<RowsResidual, 128> (gemm_rows_sm90.cuh, K3's row kernel): merges a row's
//       D / 128 tile statistics exactly, normalises, FiLM as one row (sc, sh), adds x.
//
// What R sets on the card. R (the tool's row block, which must divide L) is the schedule's
// unit: R consecutive tokens. A unit's token tiles of 256 start at its first row, so no
// tile straddles two units; the last one is ragged where 256 does not divide R (1800 = 7 x
// 256 + 8) and its missing rows arrive as zeros from the 3D tensor map (token, row in unit,
// unit), whose columns are dropped. Work is (token tile, 128-feature tile) items, feature
// tile fastest, dealt round-robin to one persistent block an SM: every launch has hundreds
// to thousands of items, whatever R (ops/probes.py::mlp_t_schedule, which the CPU tests
// read). The hidden scratch holds whole units, each padded to its tiles (Rp = 256 ceil(R /
// 256) columns), under K3's cap of 256 MB, so fc1 and fc2 run chunk of units by chunk; the
// chunks are as equal as whole units allow.
//
// Bound: operations, 4 L D Hd bf16 flops (1.1 ms at 989 TF/s at every stage of the 0.25
// degree model). The hidden makes a round trip through device memory (as in K3: fc2 of a
// token tile needs all Hd), padded by Rp / R.
//
// tools/kernel_ablate.py builds copies with -DABLATE_ONLY_FC1 (fc1 alone), -DABLATE_NO_GELU
// (the hidden rounded only), -DABLATE_NO_STATS (no statistics, no row kernel) and
// -DABLATE_NO_TRANSPOSE (y^T stored as it lies in the accumulators, full tiles only): each
// computes a wrong result on purpose.
#include "common.cuh"
#include "gemm_rows_sm90.cuh"

namespace {

enum { FC1 = 0, FC2 = 1 };
constexpr int T_TILE = 256;        // tokens of a tile: the ring's N
constexpr int F_TILE = 128;        // features of a tile: two warpgroups of 64 rows
constexpr int RED_BYTES = 8 * T_TILE * 4;   // per warp, a partial sum of each token column
constexpr int MEAN_BYTES = T_TILE * 4;

template <int PHASE>
using TRing = sm90::GemmRing<4, true, PHASE == FC2>;

template <int PHASE>
constexpr size_t mlp_t_smem() {
  return 1024 + TRing<PHASE>::STAGES * TRing<PHASE>::STAGE_BYTES +
         TRing<PHASE>::CONSUMER_WARPS * TRing<PHASE>::OUT_WARP_BYTES +
         (PHASE == FC2 ? RED_BYTES + MEAN_BYTES : 0) + TRing<PHASE>::BAR_BYTES;
}

// One launch's items over a chunk of units from unit `unit0`: item i is feature tile
// i % m_tiles of token tile i / m_tiles, token tile tt = tile tt % tpu of unit tt / tpu.
struct TSched {
  int L, R, tpu, unit0, m_tiles, items, k_steps, Pc;  // Pc: the chunk's padded tokens
  uint32_t b_bytes;  // FC1: what the token box brings
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// x: the 3D map (k, row in unit, unit) of the tokens (FC1); h: the 2D map of h^T (FC2).
// FC1: out is h^T (Hd, Pc), bias b1. FC2: out is y (L, D) token-major, bias b2, stats
// (L, D / 128) float2.
template <int PHASE>
__global__ void __launch_bounds__(ROWS_THREADS, 1) mlp_t_gemm_kernel(
    const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ bias, bf16* __restrict__ out, float2* __restrict__ stats, int D,
    const TSched s) {
  using Ring = TRing<PHASE>;
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  const uint32_t staging = tiles + Ring::STAGES * Ring::STAGE_BYTES;
  const uint32_t red_addr = staging + Ring::CONSUMER_WARPS * Ring::OUT_WARP_BYTES;
  const uint32_t bars = red_addr + (PHASE == FC2 ? RED_BYTES + MEAN_BYTES : 0);
  const int tid = threadIdx.x;

  if (tid == 0) Ring::init(bars);
  __syncthreads();

  if (tid >= 256) {
    sm90::reg_dealloc<40>();
    if (tid != 256) return;
    typename Ring::Pos pos;
    for (int i = blockIdx.x; i < s.items; i += gridDim.x) {
      const int tile = i / s.m_tiles, m0 = (i % s.m_tiles) * F_TILE;
      const int u = tile / s.tpu, t0 = (tile % s.tpu) * T_TILE;
      for (int ks = 0; ks < s.k_steps; ++ks) {
        const int k = ks * Ring::BK;
        if constexpr (PHASE == FC1) {
          Ring::produce_step_wa(&map_w, tiles, bars, pos, m0, k, s.b_bytes,
                                [&](uint32_t b, uint32_t bar) {
                                  sm90::tma_load_3d(b, &map_b, bar, k, t0, s.unit0 + u);
                                });
        } else {
          const int n0 = u * s.tpu * T_TILE + t0;  // the tile's first column of h^T
          Ring::produce_step_wa(&map_w, tiles, bars, pos, m0, k, Ring::B_BYTES,
                                [&](uint32_t b, uint32_t bar) {
#pragma unroll
                                  for (int j = 0; j < 4; ++j)
                                    sm90::tma_load_2d(b + j * Ring::B_BOX_BYTES, &map_b, bar,
                                                      n0 + 64 * j, k);
                                });
        }
      }
    }
    return;
  }

  sm90::reg_alloc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, w8 = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  unsigned char* mine = raw + (staging - raw_addr) + w8 * Ring::OUT_WARP_BYTES;
  float* red = reinterpret_cast<float*>(raw + (red_addr - raw_addr));  // [8 warps][256]
  float* mean_s = red + 8 * T_TILE;                                    // [256]
  typename Ring::Pos pos;
  float acc[128];
  for (int i = blockIdx.x; i < s.items; i += gridDim.x) {
    const int tile = i / s.m_tiles, mt = i % s.m_tiles;
    const int u = tile / s.tpu, t0 = (tile % s.tpu) * T_TILE;
    Ring::consume_tile(acc, tiles, bars, pos, s.k_steps, wg, lane == 0);
    const int f0 = mt * F_TILE + wg * 64 + warp * 16;  // the warp's first feature row
    const float bb0 = bias[f0 + gq], bb1 = bias[f0 + gq + 8];
    if constexpr (PHASE == FC1) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = bf16r(acc[4 * j + e] + (e < 2 ? bb0 : bb1));
#ifdef ABLATE_NO_GELU
          acc[4 * j + e] = v;
#else
          acc[4 * j + e] = gelu_erf(v);
#endif
        }
      }
      Ring::store_warp_tile(acc, mine, out + (long long)f0 * s.Pc + u * s.tpu * T_TILE + t0,
                            s.Pc, 16, lane);
      continue;
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[4 * j] = bf16r(acc[4 * j] + bb0);
        acc[4 * j + 1] = bf16r(acc[4 * j + 1] + bb0);
        acc[4 * j + 2] = bf16r(acc[4 * j + 2] + bb1);
        acc[4 * j + 3] = bf16r(acc[4 * j + 3] + bb1);
      }
      const long long row0 = (long long)(s.unit0 + u) * s.R + t0;  // token column 0's row
      const int valid = min(T_TILE, s.R - t0);                     // token columns to keep
#ifndef ABLATE_NO_STATS
      // Column j of the thread: token 8 (j / 2) + 2 tq + (j & 1), rows gq and gq + 8.
      // Pass 1: the tile's mean of each token column.
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[4 * j + e] + acc[4 * j + 2 + e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) red[w8 * T_TILE + 8 * j + 2 * tq + e] = v;
        }
      }
      consumers_sync();
      {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) v += red[w * T_TILE + tid];
        mean_s[tid] = v * (1.f / F_TILE);
      }
      consumers_sync();
      // Pass 2: the centred sum of squares.
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 m = *reinterpret_cast<const float2*>(mean_s + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float me = e ? m.y : m.x;
          const float d0 = acc[4 * j + e] - me, d1 = acc[4 * j + 2 + e] - me;
          float v = d0 * d0 + d1 * d1;
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) red[w8 * T_TILE + 8 * j + 2 * tq + e] = v;
        }
      }
      consumers_sync();
      {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) v += red[w * T_TILE + tid];
        if (tid < valid)
          stats[(row0 + tid) * s.m_tiles + mt] = make_float2(mean_s[tid], v);
      }
      consumers_sync();  // red and mean_s are free for the next tile
#endif
#ifdef ABLATE_NO_TRANSPOSE  // y^T stored as it lies: out seen as (D, L), full tiles only
      if (valid == T_TILE)
        Ring::store_warp_tile(acc, mine, out + (long long)f0 * s.L + row0, s.L, 16, lane);
      continue;
#endif
      // Back to token-major, 64 token columns at a time: the warp's 16 features of a token
      // are 32 bytes of its staging ([token][16 features]), which two lanes store.
      bf16* st = reinterpret_cast<bf16*>(mine);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * c + jj;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = 8 * jj + 2 * tq + e;
            st[tok * 16 + gq] = __float2bfloat16_rn(acc[4 * j + e]);
            st[tok * 16 + gq + 8] = __float2bfloat16_rn(acc[4 * j + 2 + e]);
          }
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = 32 * q + lane, tok = p >> 1, half = p & 1;
          const uint4 v = *reinterpret_cast<const uint4*>(mine + tok * 32 + half * 16);
          const int col = 64 * c + tok;
          if (col < valid)
            *reinterpret_cast<uint4*>(out + (row0 + col) * D + f0 + 8 * half) = v;
        }
        __syncwarp();
      }
    }
  }
}

template <int PHASE>
int launch_mlp_t_gemm(const CUtensorMap& map_w, const CUtensorMap& map_b, const float* bias,
                      bf16* out, float2* stats, int D, const TSched& s, cudaStream_t stream) {
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorUnknown;
  constexpr size_t smem = mlp_t_smem<PHASE>();
  cudaFuncSetAttribute(mlp_t_gemm_kernel<PHASE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  mlp_t_gemm_kernel<PHASE><<<s.items < sms ? s.items : sms, ROWS_THREADS, smem, stream>>>(
      map_w, map_b, bias, out, stats, D, s);
  return (int)cudaGetLastError();
}

}  // namespace

// K9. x, out: (L, D) bf16 rows; w1: (D, Hd), w2: (Hd, D) bf16 as stored; b1: (Hd,), b2, sh,
// sc: (D,) f32; R: the row block (divides L); hid: scratch of Hd x (units_per_chunk Rp) bf16
// with Rp = 256 ceil(R / 256); stats: scratch of L x D / 128 float2. The chunks are
// units_per_chunk units each (the last the rest), as ops/probes.py::mlp_t_schedule gives
// them. D in {512, 1024, 2048}, Hd % 128 == 0. Returns cudaGetLastError() of the last
// launch, cudaErrorInvalidValue for a shape it does not take, or cudaErrorUnknown where no
// tensor map could be encoded.
extern "C" int mlp_t(const void* x, const void* w1, const float* b1, const void* w2,
                     const float* b2, const float* sh, const float* sc, void* hid, float* stats,
                     void* out, int L, int R, int D, int Hd, int units_per_chunk, float eps,
                     cudaStream_t stream) {
  if (L <= 0 || R <= 0 || L % R || (D != 512 && D != 1024 && D != 2048) || Hd <= 0 ||
      Hd % F_TILE || units_per_chunk <= 0 || L > (1 << 24))
    return (int)cudaErrorInvalidValue;
  const int n_units = L / R, tpu = (R + T_TILE - 1) / T_TILE, Rp = tpu * T_TILE;
  const int box_rows = R < T_TILE ? R : T_TILE;
  CUtensorMap map_x, map_w1, map_w2;
  cudaError_t e;
  {  // the tokens as (k, row in unit, unit): a box past a unit's end reads zeros
    const uint64_t dims[3] = {(uint64_t)D, (uint64_t)R, (uint64_t)n_units};
    const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)R * D * 2};
    const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
    if ((e = sm90::make_map_bf16(&map_x, x, 3, dims, strides, box)) != cudaSuccess) return (int)e;
  }
  if ((e = TRing<FC1>::make_map_w(&map_w1, w1, D, Hd)) != cudaSuccess) return (int)e;
  if ((e = TRing<FC2>::make_map_w(&map_w2, w2, Hd, D)) != cudaSuccess) return (int)e;
  bf16* ob = static_cast<bf16*>(out);
  int err;
  for (int u0 = 0; u0 < n_units; u0 += units_per_chunk) {
    const int uc = min(units_per_chunk, n_units - u0), Pc = uc * Rp;
    CUtensorMap map_h;
    if ((e = TRing<FC2>::make_map_w(&map_h, hid, Hd, Pc)) != cudaSuccess) return (int)e;
    const TSched s1{L, R, tpu, u0, Hd / F_TILE, uc * tpu * (Hd / F_TILE), D / 64, Pc,
                    (uint32_t)box_rows * 128};
    const TSched s2{L, R, tpu, u0, D / F_TILE, uc * tpu * (D / F_TILE), Hd / 64, Pc, 0};
#ifndef ABLATE_ONLY_FC2
    err = launch_mlp_t_gemm<FC1>(map_w1, map_x, b1, static_cast<bf16*>(hid), nullptr, D, s1,
                                 stream);
    if (err) return err;
#endif
#ifndef ABLATE_ONLY_FC1
    err = launch_mlp_t_gemm<FC2>(map_w2, map_h, b2, ob, reinterpret_cast<float2*>(stats), D, s2,
                                 stream);
    if (err) return err;
#endif
  }
#if !defined(ABLATE_ONLY_FC1) && !defined(ABLATE_NO_STATS)
  ln_rows_kernel<RowsResidual, F_TILE><<<(L + 7) / 8, 256, 0, stream>>>(
      RowsResidual{static_cast<const bf16*>(x)}, ob, reinterpret_cast<const float2*>(stats), sh,
      sc, 0.f, L, 0, L, D, eps);
#endif
  return (int)cudaGetLastError();
}
