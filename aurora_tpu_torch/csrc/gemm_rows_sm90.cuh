// A product over a chunk of token rows on the TMA + wgmma ring of gemm_sm90.cuh, with a bias
// epilogue, and the LayerNorm row kernel that follows it. mlp.cu (K3's and K8's fc2, K5),
// window_attention.cu (K2's and K6's qkv and proj) and resampler.cu (K4's v and
// out-projection; its ln_k sums of squares take the ring with an epilogue of their own) run
// them.
//
//   gemm_bias_kernel<EPI>: y = A W + bias over `rows` rows, A (rows, K) bf16 rows, W (K, N)
//     bf16 as stored (an MN-major wgmma operand, no transposed copy), one persistent block an
//     SM, (2 x 64) x 256 tiles on a ring of 4 stages. The epilogue, by EPI:
//       EPI_BIAS        y = bf16(acc + b), b f32                           (K8's fc2)
//       EPI_BIAS_STATS  the same, and per row and 256-column tile the mean and the centred sum
//                       of squares of the tile's 256 rounded values         (K3's fc2; proj; K5)
//       EPI_QKV         y = bf16(bf16(acc) + b), b bf16: the bias added after the rounding
//                       (aurora_tpu/model/swin3d.py:573-577)                 (qkv)
//       EPI_ROUND       y = bf16(acc), no bias                              (K4's v)
//       EPI_STATS       the same, with EPI_BIAS_STATS's statistics          (K4's out-projection)
//       EPI_QKV_STATS   EPI_QKV's value with EPI_BIAS_STATS's statistics    (K4's, with bout)
//     y leaves through each warp's swizzled staging (GemmRing::store_warp_tile).
//   ln_rows_kernel<Res, TILE>: a warp a row, out (holding y) = bf16(x + LN(y) (scale_bias +
//     scale[f]) + shift[f]) in place, f = (row_base + row) / rows_per_batch, x the row's
//     residual: its own row of a bf16 matrix (RowsResidual: K2, K3, K5, K6, K9) or row
//     (row_base + row) % period of an f32 matrix (PeriodicResidual: K4's queries). It merges
//     the D / TILE tile statistics exactly (equal counts: mean of means, the centred squares
//     plus TILE times the squared offsets of the means; no E[y^2] - mean^2; TILE is 256, or
//     K9's 128 feature rows), so a row's column tiles run side by side on neighbouring
//     blocks and A is read from device memory once.
// Rows past the chunk's end arrive as zeros from the TMA; they are neither stored nor enter
// any statistic (every row's values live in its own quad). A kernel boundary orders one
// launch's ordinary stores before the next launch's TMA reads, so no cross-proxy fence is
// needed between them.
#pragma once

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

using RowsRing = sm90::GemmRing<4>;
constexpr int ROWS_THREADS = 384;  // consumers 0-255, producer warpgroup 256-383
constexpr size_t ROWS_GEMM_SMEM = 1024 + RowsRing::STAGES * RowsRing::STAGE_BYTES +
                                  RowsRing::CONSUMER_WARPS * RowsRing::OUT_WARP_BYTES +
                                  RowsRing::BAR_BYTES;
enum { EPI_BIAS = 0, EPI_BIAS_STATS = 1, EPI_QKV = 2, EPI_ROUND = 3, EPI_STATS = 4,
       EPI_QKV_STATS = 5 };

// One product's schedule over a chunk of `rows` rows: pieces of 64 rows (the last ragged),
// paired into tiles; unit u is column tile u % n_tiles of tile u / n_tiles, whose warpgroup
// g takes piece 2 (u / n_tiles) + g. Units go round-robin to the blocks, column tile
// fastest, so a tile's column tiles run at the same time and its rows are read once. Past
// the last piece (an odd count) a warpgroup repeats the last piece and stores nothing.
struct Sched {
  int rows, pieces, n_tiles, units, k_steps;
  uint32_t a_box_bytes;
};

inline Sched make_sched(int rows, int K, int N) {
  Sched s;
  s.rows = rows;
  s.pieces = (rows + 63) / 64;
  s.n_tiles = N / 256;
  s.units = (s.pieces + 1) / 2 * s.n_tiles;
  s.k_steps = K / 64;
  s.a_box_bytes = RowsRing::a_box_bytes(rows);
  return s;
}

template <class Ring>
__device__ __forceinline__ void produce_units(const CUtensorMap* map_a, const CUtensorMap* map_w,
                                              uint32_t tiles, uint32_t bars, const Sched& s) {
  typename Ring::Pos pos;
  const int block[2] = {0, 0};
  for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
    const int p = 2 * (u / s.n_tiles);
    const int row0[2] = {64 * p, 64 * min(p + 1, s.pieces - 1)};
    Ring::produce_tile(map_a, map_w, tiles, bars, pos, row0, block, (u % s.n_tiles) * Ring::BN,
                       s.k_steps, s.a_box_bytes);
  }
}

// out: (rows, N) bf16. bias: (N,) f32, bf16 for EPI_QKV and EPI_QKV_STATS, unused (null) for
// EPI_ROUND and EPI_STATS. EPI_BIAS_STATS, EPI_STATS and EPI_QKV_STATS: also stats[row *
// n_tiles + column tile] = (mean, centred sum of squares) of the row's 256 rounded values in
// the tile.
template <int EPI>
__global__ void __launch_bounds__(ROWS_THREADS, 1) gemm_bias_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const void* __restrict__ bias, bf16* __restrict__ out, float2* __restrict__ stats, int N,
    const Sched s) {
  using Ring = RowsRing;
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  const uint32_t staging = tiles + Ring::STAGES * Ring::STAGE_BYTES;
  const uint32_t bars = staging + Ring::CONSUMER_WARPS * Ring::OUT_WARP_BYTES;
  const int tid = threadIdx.x;

  if (tid == 0) Ring::init(bars);
  __syncthreads();

  if (tid >= 256) {
    sm90::reg_dealloc<40>();
    if (tid == 256) produce_units<Ring>(&map_a, &map_w, tiles, bars, s);
  } else {
    sm90::reg_alloc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    unsigned char* mine = raw + (staging - raw_addr) + (tid >> 5) * Ring::OUT_WARP_BYTES;
    typename Ring::Pos pos;
    float acc[128];
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const int p = 2 * (u / s.n_tiles) + wg;
      const int nt = u % s.n_tiles, n0 = nt * Ring::BN;
      Ring::consume_tile(acc, tiles, bars, pos, s.k_steps, wg, lane == 0);
#ifdef ABLATE_NO_EPILOGUE
      if (acc[0] != 123.456f) continue;  // never equal: the product is kept, nothing stored
#endif
      if (p >= s.pieces) continue;
      const int row0 = 64 * p + 16 * warp;  // the warp's first row; this thread: + gq, + gq + 8
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int n = n0 + 8 * j + 2 * tq;
        if constexpr (EPI == EPI_QKV || EPI == EPI_QKV_STATS) {
          const float2 b =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  static_cast<const bf16*>(bias) + n));
          acc[4 * j] = bf16r(bf16r(acc[4 * j]) + b.x);
          acc[4 * j + 1] = bf16r(bf16r(acc[4 * j + 1]) + b.y);
          acc[4 * j + 2] = bf16r(bf16r(acc[4 * j + 2]) + b.x);
          acc[4 * j + 3] = bf16r(bf16r(acc[4 * j + 3]) + b.y);
        } else if constexpr (EPI == EPI_ROUND || EPI == EPI_STATS) {
          acc[4 * j] = bf16r(acc[4 * j]);
          acc[4 * j + 1] = bf16r(acc[4 * j + 1]);
          acc[4 * j + 2] = bf16r(acc[4 * j + 2]);
          acc[4 * j + 3] = bf16r(acc[4 * j + 3]);
        } else {
          const float2 b = *reinterpret_cast<const float2*>(static_cast<const float*>(bias) + n);
          acc[4 * j] = bf16r(acc[4 * j] + b.x);
          acc[4 * j + 1] = bf16r(acc[4 * j + 1] + b.y);
          acc[4 * j + 2] = bf16r(acc[4 * j + 2] + b.x);
          acc[4 * j + 3] = bf16r(acc[4 * j + 3] + b.y);
        }
      }
      if constexpr (EPI == EPI_BIAS_STATS || EPI == EPI_STATS || EPI == EPI_QKV_STATS) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          s0 += acc[4 * j] + acc[4 * j + 1];
          s1 += acc[4 * j + 2] + acc[4 * j + 3];
        }
        const float m0 = quad_sum(s0) * (1.f / 256.f), m1 = quad_sum(s1) * (1.f / 256.f);
        float q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float d;
          d = acc[4 * j] - m0; q0 += d * d;
          d = acc[4 * j + 1] - m0; q0 += d * d;
          d = acc[4 * j + 2] - m1; q1 += d * d;
          d = acc[4 * j + 3] - m1; q1 += d * d;
        }
        q0 = quad_sum(q0);
        q1 = quad_sum(q1);
        if (tq == 0) {
          const int r = row0 + gq;
          if (r < s.rows) stats[(long long)r * s.n_tiles + nt] = make_float2(m0, q0);
          if (r + 8 < s.rows) stats[(long long)(r + 8) * s.n_tiles + nt] = make_float2(m1, q1);
        }
      }
      Ring::store_warp_tile(acc, mine, out + (long long)row0 * N + n0, N, s.rows - row0, lane);
    }
  }
}

// Launches gemm_bias_kernel<EPI> on one SM each for the first min(units, SMs) blocks.
template <int EPI>
int launch_gemm_bias(const CUtensorMap& map_a, const CUtensorMap& map_w, const void* bias,
                     bf16* out, float2* stats, int N, const Sched& s, cudaStream_t stream) {
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorUnknown;
  cudaFuncSetAttribute(gemm_bias_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)ROWS_GEMM_SMEM);
  gemm_bias_kernel<EPI><<<s.units < sms ? s.units : sms, ROWS_THREADS, ROWS_GEMM_SMEM, stream>>>(
      map_a, map_w, bias, out, stats, N, s);
  return (int)cudaGetLastError();
}

// The residual x of ln_rows_kernel's row `row` (of the launch), columns n..n + 7.
// RowsResidual: the row's own row of a (rows, D) bf16 matrix (K2, K3, K5, K6).
struct RowsResidual {
  const bf16* x;
  __device__ __forceinline__ void load8(int row, long long, int D, int n, float (&v)[8]) const {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + (long long)row * D + n);
    const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(xw[i] << 16);
      v[2 * i + 1] = __uint_as_float(xw[i] & 0xffff0000u);
    }
  }
};
// PeriodicResidual: row (row_base + row) % period of a (period, D) f32 matrix (K4's queries,
// one for each of the Q rows of a token column).
struct PeriodicResidual {
  const float* x;
  int period;
  __device__ __forceinline__ void load8(int row, long long row_base, int D, int n,
                                        float (&v)[8]) const {
    const float* src = x + ((row_base + row) % period) * D + n;
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// (mean, 1 / sqrt(variance + eps)) of a row of D values from its D / TILE tiles' (mean,
// centred sum of squares) at st, merged exactly (equal counts).
template <int TILE>
__device__ __forceinline__ float2 merge_row_stats(const float2* st, int D, float eps) {
  const int n_tiles = D / TILE;
  float mean = 0.f;
  for (int i = 0; i < n_tiles; ++i) mean += st[i].x;
  mean /= n_tiles;
  float m2 = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const float d = st[i].x - mean;
    m2 += st[i].y + (float)TILE * d * d;
  }
  return make_float2(mean, rsqrtf(m2 / D + eps));
}

// A warp a row: out (holding y) = bf16(x + LN(y) * gain + shift) in place, x from `res`.
// The statistics come per TILE columns of a row: 256 (fc2 and proj tiles), or 128 (K9's
// feature tiles, mlp_t.cu).
template <class Res, int TILE = 256>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const Res res, bf16* __restrict__ out, const float2* __restrict__ stats,
    const float* __restrict__ shift, const float* __restrict__ scale, float scale_bias, int rows,
    long long row_base, long long rows_per_batch, int D, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float2 mr = merge_row_stats<TILE>(stats + (long long)row * (D / TILE), D, eps);
  const float mean = mr.x, rstd = mr.y;
  const long long film = ((row_base + row) / rows_per_batch) * D;
  for (int c = 0; c < D / 256; ++c) {
    const int n = 256 * c + 8 * lane;
    const long long at = (long long)row * D + n;
    const uint4 yv = *reinterpret_cast<const uint4*>(out + at);
    float xv[8];
    res.load8(row, row_base, D, n, xv);
    const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
    uint32_t ow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 sc = *reinterpret_cast<const float2*>(scale + film + n + 2 * i);
      const float2 sh = *reinterpret_cast<const float2*>(shift + film + n + 2 * i);
      const float y0 = __uint_as_float(yw[i] << 16), y1 = __uint_as_float(yw[i] & 0xffff0000u);
      ow[i] = pack_bf16x2(xv[2 * i] + ((y0 - mean) * rstd * (scale_bias + sc.x) + sh.x),
                          xv[2 * i + 1] + ((y1 - mean) * rstd * (scale_bias + sc.y) + sh.y));
    }
    *reinterpret_cast<uint4*>(out + at) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }
}

}  // namespace
