// fc1 of K3 and K8 (mlp.cu) and of K3's input gradient (mlp_grad.cu): hid = bf16(GELU(bf16(x W1
// + b1))) over a chunk of rows, on the ring of gemm_sm90.cuh, the GELU of each tile parked in
// shared memory and applied under the next tile's first K steps (mlp.cu's head comment
// explains the design and its measurements). STORE_PRE (the gradient's recompute) also
// stores the rounded pre-activations bf16(x W1 + b1) beside hid, for GELU's derivative.
#pragma once

#include "common.cuh"
#include "gemm_rows_sm90.cuh"

namespace {

using Ring1 = sm90::GemmRing<3>;  // fc1: a stage's room goes to the parked pre-activations
constexpr int PARK_WARP_BYTES = 16 * 512;    // a warp's 16 rows x 256 columns of bf16
constexpr int BIAS_WARP_BYTES = 256 * 4;     // a warp's copy of the tile's 256 values of b1
constexpr size_t FC1_SMEM = 1024 + Ring1::STAGES * Ring1::STAGE_BYTES +
                            Ring1::CONSUMER_WARPS * (PARK_WARP_BYTES + BIAS_WARP_BYTES) +
                            Ring1::BAR_BYTES;

// gelu_erf of 8 bf16 values packed in 16 bytes, in f32, rounded and packed again.
__device__ __forceinline__ uint4 gelu_bf16x8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
#ifdef ABLATE_NO_GELU
    o[i] = pack_bf16x2(lo, hi);
#else
    o[i] = pack_bf16x2(gelu_erf(lo), gelu_erf(hi));
#endif
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Sixteenth h (0-15) of a warp's parked 16 x 256 pre-activations: rows 4 (h & 3).. + 3 of
// the 64 columns 64 (h >> 2).. through the GELU to dst (the warp's first row at the tile's
// first column), rows below rows_left only. A parked row is 512 bytes of 16-byte pieces,
// piece q stored at q ^ (row & 7): lane l takes row 4 (h & 3) + (l >> 3) and piece
// 8 (h >> 2) + (l & 7), conflict-free, and eight lanes store one whole 128-byte line.
// STORE_PRE: the parked values themselves also to pre (as dst, in the pre-activations' scratch).
template <bool STORE_PRE>
__device__ __forceinline__ void gelu_sixteenth(const unsigned char* parked, int h, bf16* dst,
                                               bf16* pre, long long ld, int rows_left,
                                               int lane) {
  const int r = 4 * (h & 3) + (lane >> 3), q = 8 * (h >> 2) + (lane & 7);
  const uint4 p = *reinterpret_cast<const uint4*>(parked + r * 512 + ((q ^ (r & 7)) << 4));
  const uint4 v = gelu_bf16x8(p);
  if (r < rows_left) {
    *reinterpret_cast<uint4*>(dst + (long long)r * ld + 8 * q) = v;
    if constexpr (STORE_PRE) *reinterpret_cast<uint4*>(pre + (long long)r * ld + 8 * q) = p;
  }
}

// GELU_STEPS: the K steps of a tile that the parked tile's GELU is spread over, 16 /
// GELU_STEPS sixteenths a step: 8 where K = D >= 512, 4 where D = 256 (4 K steps a tile).
// STORE_PRE: pre (rows x Hd bf16) takes the rounded pre-activations too; null otherwise.
template <int GELU_STEPS, bool STORE_PRE = false>
__global__ void __launch_bounds__(ROWS_THREADS, 1) mlp_fc1_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w1,
    const float* __restrict__ b1, bf16* __restrict__ hid, int Hd, const Sched s,
    bf16* __restrict__ pre) {
  static_assert(GELU_STEPS == 4 || GELU_STEPS == 8, "16 sixteenths in whole halves a step");
  constexpr int PER_HALF = 8 / GELU_STEPS;  // sixteenths before, and after, a step's wait
  using Ring = Ring1;
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  const uint32_t park = tiles + Ring::STAGES * Ring::STAGE_BYTES;
  const uint32_t bias = park + Ring::CONSUMER_WARPS * PARK_WARP_BYTES;
  const uint32_t bars = bias + Ring::CONSUMER_WARPS * BIAS_WARP_BYTES;
  const int tid = threadIdx.x;

  if (tid == 0) Ring::init(bars);
  __syncthreads();

  if (tid >= 256) {
    sm90::reg_dealloc<40>();
    if (tid == 256) produce_units<Ring>(&map_x, &map_w1, tiles, bars, s);
  } else {
    sm90::reg_alloc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    unsigned char* parked = raw + (park - raw_addr) + (tid >> 5) * PARK_WARP_BYTES;
    float* my_b1 = reinterpret_cast<float*>(raw + (bias - raw_addr) + (tid >> 5) * BIAS_WARP_BYTES);
    typename Ring::Pos pos;
    float acc[128];
    bf16* pend = nullptr;  // where the parked tile goes: its first row and column in hid
    bf16* pend_pre = nullptr;  // and in pre (STORE_PRE)
    int pend_rows = 0;
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const int p = 2 * (u / s.n_tiles) + wg;
      const int n0 = (u % s.n_tiles) * Ring::BN;
      // The tile's 256 values of b1 into the warp's own copy, under the first products.
      const float4* b1v = reinterpret_cast<const float4*>(b1 + n0) + 2 * lane;
      const float4 bias_lo = b1v[0], bias_hi = b1v[1];
      int prev = -1;
#pragma unroll
      for (int ks = 0; ks < GELU_STEPS; ++ks) {
        Ring::consume_step(acc, tiles, bars, pos, wg, ks);
        if (ks == 0) {
          reinterpret_cast<float4*>(my_b1)[2 * lane] = bias_lo;
          reinterpret_cast<float4*>(my_b1)[2 * lane + 1] = bias_hi;
        }
        // Half of this step's share of the parked tile with two wgmma groups in flight, then
        // the stage before goes back to the producer, then the other half.
        if (pend) {
#pragma unroll
          for (int i = 0; i < PER_HALF; ++i)
            gelu_sixteenth<STORE_PRE>(parked, 2 * PER_HALF * ks + i, pend, pend_pre, Hd,
                                       pend_rows, lane);
        }
        if (prev >= 0) {
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(Ring::empty(bars, prev));
        }
        if (pend) {
#pragma unroll
          for (int i = 0; i < PER_HALF; ++i)
            gelu_sixteenth<STORE_PRE>(parked, 2 * PER_HALF * ks + PER_HALF + i, pend,
                                       pend_pre, Hd, pend_rows, lane);
        }
        prev = pos.stage;
        pos.advance();
      }
      for (int ks = GELU_STEPS; ks < s.k_steps; ++ks) {
        Ring::consume_step(acc, tiles, bars, pos, wg, ks);
        sm90::wgmma_wait<1>();
        if (lane == 0) sm90::mbar_arrive(Ring::empty(bars, prev));
        prev = pos.stage;
        pos.advance();
      }
      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(Ring::empty(bars, prev));
#ifdef ABLATE_NO_EPILOGUE
      if (acc[0] != 123.456f) continue;  // never equal: the product is kept, nothing parked
#endif
      pend = nullptr;
      if (p >= s.pieces) continue;
      // Park bf16(acc + b1) in the fragment's own rows gq and gq + 8, n8 tile j at piece j.
      __syncwarp();
      unsigned char* put = parked + gq * 512 + tq * 4;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(my_b1 + 8 * j + 2 * tq);
        unsigned char* at = put + ((j ^ gq) << 4);
        *reinterpret_cast<uint32_t*>(at) = pack_bf16x2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
        *reinterpret_cast<uint32_t*>(at + 8 * 512) =
            pack_bf16x2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
      }
      __syncwarp();
      const int row0 = 64 * p + 16 * warp;
      pend = hid + (long long)row0 * Hd + n0;
      if constexpr (STORE_PRE) pend_pre = pre + (long long)row0 * Hd + n0;
      pend_rows = s.rows - row0;
#ifdef ABLATE_LOCKSTEP
      for (int h = 0; h < 16; ++h)
        gelu_sixteenth<STORE_PRE>(parked, h, pend, pend_pre, Hd, pend_rows, lane);
      pend = nullptr;
#endif
    }
    if (pend)
      for (int h = 0; h < 16; ++h)
        gelu_sixteenth<STORE_PRE>(parked, h, pend, pend_pre, Hd, pend_rows, lane);
  }
}

// Launches mlp_fc1_kernel on one SM each for the first min(units, SMs) blocks, with the parked
// GELU spread over 4 K steps at D = 256 (4 K steps a tile) and over 8 otherwise. pre: where the
// pre-activations go (rows x Hd bf16, as hid) under STORE_PRE, else null.
template <bool STORE_PRE>
int launch_mlp_fc1(const CUtensorMap& map_x, const CUtensorMap& map_w1, const float* b1,
                   bf16* hid, bf16* pre, int D, int Hd, const Sched& s, cudaStream_t stream) {
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorUnknown;
  const unsigned grid = s.units < sms ? s.units : sms;
  if (D == 256) {
    cudaFuncSetAttribute(mlp_fc1_kernel<4, STORE_PRE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FC1_SMEM);
    mlp_fc1_kernel<4, STORE_PRE><<<grid, ROWS_THREADS, FC1_SMEM, stream>>>(map_x, map_w1, b1,
                                                                            hid, Hd, s, pre);
  } else {
    cudaFuncSetAttribute(mlp_fc1_kernel<8, STORE_PRE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FC1_SMEM);
    mlp_fc1_kernel<8, STORE_PRE><<<grid, ROWS_THREADS, FC1_SMEM, stream>>>(map_x, map_w1, b1,
                                                                            hid, Hd, s, pre);
  }
  return (int)cudaGetLastError();
}

}  // namespace
