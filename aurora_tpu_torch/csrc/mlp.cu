// K3: the MLP branch of a block, out = x + LN(fc2(GELU(fc1 x))) * (scale_bias + scale) + shift;
// K8: the MLP alone, out = fc2(GELU(fc1 x)) (mlp_impl="pallas"); and
// K5: the attention tail after un-windowing, out = shortcut + LN(x W + b) * (scale_bias + scale)
//     + shift.
//
// K3 replaces aurora_tpu/ops/mlp.py::mlp_adaln_residual_fused (pallas_call at mlp.py:419),
// K8 mlp_fused (pallas_call at mlp.py:278) and K5 linear_adaln_residual_fused (pallas_call at
// mlp.py:604). K5 is K2's tail on rows (linear_adaln_residual below): proj with the f32 bias
// and the LayerNorm statistics per 256-column tile (gemm_bias_kernel<EPI_BIAS_STATS>, W (D, D)
// as stored), then ln_rows_kernel with the shortcut as the residual, FiLM row row / L and
// eps 1e-5 (mlp.py:599). K5's bound: operations at D >= 1024, bytes at D = 512 (x and the
// shortcut read, out written once; 2 rows D^2 bf16 flops).
//
// K3 / K8. Bound on the H100: operations, 4 * rows * D * Hd bf16 flops (~1.1 TFLOP, 1.1 ms
// at 989 TF/s, for every backbone stage of the 0.25 degree model). Both TPU kernels kept the
// weights in VMEM and the hidden activations on chip. Here they are two products on the
// TMA + wgmma mainloop of gemm_sm90.cuh (one persistent block an SM, (2 x 64) x 256 tiles, W1
// (D, Hd) and W2 (Hd, D) read as stored as MN-major operands), with the hidden activations
// passed between them through device memory, rows_chunk x Hd bf16 in a scratch of at most
// 256 MB that the wrapper allocates:
//
//   mlp_fc1_kernel:  hid = bf16(gelu_erf(bf16(x W1 + b1)))            K = D,  N = Hd
//   fc2, gemm_bias_kernel:  y = bf16(hid W2 + b2), K8's result        K = Hd, N = D
//   ln_rows_kernel (K3): out = bf16(x + LN(y) * (scale_bias + scale[b]) + shift[b])
// (fc2's kernel and the row kernel live in gemm_rows_sm90.cuh: K2 and K6 run them too.)
//
// Why the hidden leaves the chip. A consumer warpgroup holds a 64 x 256 tile of f32 sums in
// 128 registers a thread. fc2 of a 64-row piece needs 64 x D sums, 2 / 4 / 8 such tiles at
// D = 512 / 1024 / 2048, beside fc1's own 128: more than the 232 registers a consumer has.
// Splitting D over blocks repeats fc1 D / 256 times, and a cluster that passes hidden chunks
// through distributed shared memory runs its blocks in lockstep, which cost K12 what it
// saved. So the hidden makes one round trip (1.06 GB written and read at stage 1, 0.63 ms
// of memory time under ~1.1 ms of tensor-core time: both products stay operation-bound,
// narrowly). That round trip is this design's known distance from the bound, which stays
// the operations'. The kernel boundary orders the hidden's ordinary stores before the next
// kernel's TMA reads, so no cross-proxy fence is needed.
//
// The GELU epilogue. At stage 1 a tile is 8 K steps, ~8,200 clocks of the SM's tensor cores,
// and its 32,768 exact-erf GELUs with two roundings are ~27 instructions each (erff picks
// the coefficients of its two ranges with selects): about as many scheduler clocks for 8
// warps on 4 schedulers. The two warpgroups share each stage's W box (a tile of 128 rows moves the
// fewest bytes from L2 for each flop), so they cannot take turns a tile apart: the ring
// would have to hold a whole tile of stages. Instead each warp overlaps its own epilogue
// with its own asynchronous products: at a tile's end it adds the bias (from a copy of the
// tile's 256 values of b1 in shared memory), rounds and parks the 16 x 256 pre-activations
// as bf16 in 8 KB of shared memory of its own (64 KB a block; that leaves room for a ring of
// 3 stages); during the first 8 K steps of the next tile, around the wait that follows each
// stage's wgmma commit, it takes an eighth of the parked values (16 a thread), applies the
// GELU and stores whole 128-byte lines. The last tile's values are finished after the loop.
// fc1 therefore needs K = D >= 512. Measured (PERF.md): arithmetic and wgmma of one SM
// hardly overlap. The GELU's time is its instruction count at one instruction a clock and
// scheduler, added to the products' time; parking saves ~0.15 ms of the ~0.7 ms that the
// epilogue adds to the products' ~0.7 ms at stage 1. Three other forms were built, measured
// slower or no faster, and taken out again: the warpgroups' tiles offset by the ring's depth
// on a fixed column tile per block, each warpgroup running the epilogue from its
// accumulators while the other multiplies on (correct, fc1 a third slower: the multiplying
// warpgroup gains nothing while the other computes); warpgroup 1 taking its share of the
// parked tile before it starts a stage's products and warpgroup 0 after (twice as slow);
// erff's small-argument polynomial alone where a warp vote allows it (13 instructions for
// 27, but a gain within the timing's spread at the test's activations, and none at stages 2-3).
//
// The LayerNorm epilogue. A row of D spans D / 256 tiles, which run side by side on
// neighbouring blocks (the hidden rows are read from device memory once). fc2's epilogue
// (once per Hd / 64 >= 32 K steps, not overlapped) rounds y = bf16(acc + b2), stores it to
// `out`, and writes per row and tile the mean and the centred sum of squares of its 256
// rounded values (two passes over registers, quad shuffles). ln_rows_kernel, a warp a
// row, merges the D / 256 pairs exactly (equal counts: mean of means, sum of the centred
// squares plus 256 times the squared mean offsets; no E[y^2] - mean^2), normalises, applies
// FiLM row (row_base + row) / rows_per_batch, adds x in f32 and overwrites y in place.
// Rows past the chunk's end arrive as zeros from the TMA; they are neither stored nor enter
// any statistic (every row's values live in its own quad).
//
// ptxas (sm_90a, CUDA 12.8): both GEMM kernels 168 registers at launch (consumers 232 after
// setmaxnreg, the producer warpgroup 40), no spills; dynamic shared memory 222,256 bytes
// (fc1: 3 stages x 48 KB + 64 KB parked + 8 KB of bias copies + barriers) and 214,080 (fc2:
// 4 stages + 16 KB of output staging); the row kernel 32 registers, no spills.
//
// tools/kernel_ablate.py builds copies with -DABLATE_NO_GELU (round only), -DABLATE_NO_LN
// (K3 with K8's epilogue and no row kernel), -DABLATE_NO_LOADS, -DABLATE_NO_EPILOGUE (both
// products, nothing parked or stored), -DABLATE_LOCKSTEP (a tile's GELU right after its last
// product, the tensor cores idle meanwhile, as in K12's epilogue) and -DABLATE_ONLY_FC1 /
// -DABLATE_ONLY_FC2 (one of the two products alone; fc2 then reads what the scratch holds).
#include "common.cuh"
#include "gemm_rows_sm90.cuh"

namespace {

using Ring1 = sm90::GemmRing<3>;  // fc1: a stage's room goes to the parked pre-activations
constexpr int PARK_WARP_BYTES = 16 * 512;    // a warp's 16 rows x 256 columns of bf16
constexpr int FC1_GELU_STEPS = 8;             // the K steps a tile's GELU is spread over
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
__device__ __forceinline__ void gelu_sixteenth(const unsigned char* parked, int h, bf16* dst,
                                               long long ld, int rows_left, int lane) {
  const int r = 4 * (h & 3) + (lane >> 3), q = 8 * (h >> 2) + (lane & 7);
  const uint4 v =
      gelu_bf16x8(*reinterpret_cast<const uint4*>(parked + r * 512 + ((q ^ (r & 7)) << 4)));
  if (r < rows_left) *reinterpret_cast<uint4*>(dst + (long long)r * ld + 8 * q) = v;
}

__global__ void __launch_bounds__(ROWS_THREADS, 1) mlp_fc1_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w1,
    const float* __restrict__ b1, bf16* __restrict__ hid, int Hd, const Sched s) {
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
    int pend_rows = 0;
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const int p = 2 * (u / s.n_tiles) + wg;
      const int n0 = (u % s.n_tiles) * Ring::BN;
      // The tile's 256 values of b1 into the warp's own copy, under the first products.
      const float4* b1v = reinterpret_cast<const float4*>(b1 + n0) + 2 * lane;
      const float4 bias_lo = b1v[0], bias_hi = b1v[1];
      int prev = -1;
#pragma unroll
      for (int ks = 0; ks < FC1_GELU_STEPS; ++ks) {
        Ring::consume_step(acc, tiles, bars, pos, wg, ks);
        if (ks == 0) {
          reinterpret_cast<float4*>(my_b1)[2 * lane] = bias_lo;
          reinterpret_cast<float4*>(my_b1)[2 * lane + 1] = bias_hi;
        }
        // Half of this step's share of the parked tile with two wgmma groups in flight, then
        // the stage before goes back to the producer, then the other half.
        if (pend) gelu_sixteenth(parked, 2 * ks, pend, Hd, pend_rows, lane);
        if (prev >= 0) {
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(Ring::empty(bars, prev));
        }
        if (pend) gelu_sixteenth(parked, 2 * ks + 1, pend, Hd, pend_rows, lane);
        prev = pos.stage;
        pos.advance();
      }
      for (int ks = FC1_GELU_STEPS; ks < s.k_steps; ++ks) {
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
      pend_rows = s.rows - row0;
#ifdef ABLATE_LOCKSTEP
      for (int h = 0; h < 16; ++h) gelu_sixteenth(parked, h, pend, Hd, pend_rows, lane);
      pend = nullptr;
#endif
    }
    if (pend)
      for (int h = 0; h < 16; ++h) gelu_sixteenth(parked, h, pend, Hd, pend_rows, lane);
  }
}

}  // namespace

// K3 (ln != 0) and K8 (ln == 0) on one chunk of rows. x, out: (rows, D) bf16; w1: (D, Hd) and
// w2: (Hd, D) bf16 as stored; b1: (Hd,), b2: (D,) f32; hid: scratch of rows x Hd bf16. K3
// only: stats, scratch of rows x D / 256 float2; shift, scale: (batch, D) f32, the row
// (row_base + row) / rows_per_batch of each. Takes D in {512, 1024, 2048}, Hd % 256 == 0,
// Hd >= 512. Returns cudaGetLastError(), cudaErrorInvalidValue for a shape it does not take,
// or cudaErrorUnknown where no tensor map could be encoded.
extern "C" int mlp_rows(const void* x, const void* w1, const float* b1, const void* w2,
                        const float* b2, void* hid, void* out, float* stats, const float* shift,
                        const float* scale, float scale_bias, int rows, long long row_base,
                        long long rows_per_batch, int D, int Hd, float eps, int ln,
                        cudaStream_t stream) {
  if (rows <= 0 || rows > (1 << 24) || (D != 512 && D != 1024 && D != 2048) || Hd < 512 ||
      Hd % 256 || (ln && rows_per_batch <= 0))
    return (int)cudaErrorInvalidValue;
#ifdef ABLATE_NO_LN
  ln = 0;
#endif
  CUtensorMap map_x, map_w1, map_hid, map_w2;
  cudaError_t e;
  if ((e = Ring1::make_map_a(&map_x, x, rows, D, rows)) != cudaSuccess) return (int)e;
  if ((e = Ring1::make_map_w(&map_w1, w1, D, Hd)) != cudaSuccess) return (int)e;
  if ((e = RowsRing::make_map_a(&map_hid, hid, rows, Hd, rows)) != cudaSuccess) return (int)e;
  if ((e = RowsRing::make_map_w(&map_w2, w2, Hd, D)) != cudaSuccess) return (int)e;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorUnknown;
  const Sched s1 = make_sched(rows, D, Hd), s2 = make_sched(rows, Hd, D);
  bf16* ob = static_cast<bf16*>(out);

#ifndef ABLATE_ONLY_FC2
  cudaFuncSetAttribute(mlp_fc1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)FC1_SMEM);
  mlp_fc1_kernel<<<s1.units < sms ? s1.units : sms, ROWS_THREADS, FC1_SMEM, stream>>>(
      map_x, map_w1, b1, static_cast<bf16*>(hid), Hd, s1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
#endif
#ifdef ABLATE_ONLY_FC1
  return (int)cudaSuccess;
#endif

  const int err = ln ? launch_gemm_bias<EPI_BIAS_STATS>(map_hid, map_w2, b2, ob,
                                                        reinterpret_cast<float2*>(stats), D, s2,
                                                        stream)
                     : launch_gemm_bias<EPI_BIAS>(map_hid, map_w2, b2, ob, nullptr, D, s2, stream);
  if (err) return err;
#ifndef ABLATE_NO_EPILOGUE
  if (ln)
    ln_rows_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
        RowsResidual{static_cast<const bf16*>(x)}, ob, reinterpret_cast<const float2*>(stats),
        shift, scale, scale_bias, rows, row_base, rows_per_batch, D, eps);
#endif
  return (int)cudaGetLastError();
}

// K5 on rows of tokens. x, shortcut, out: (rows, D) bf16, rows_per_batch rows per FiLM row;
// w: (D, D) bf16 as stored; b: (D,) f32; shift, scale: (rows / rows_per_batch, D) f32; stats:
// scratch of rows x D / 256 float2. Two launches. Takes D in {512, 1024, 2048}. Returns
// cudaGetLastError(), cudaErrorInvalidValue for a shape it does not take, or cudaErrorUnknown
// where no tensor map could be encoded.
extern "C" int linear_adaln_residual(const void* x, const void* w, const float* b,
                                     const void* shortcut, const float* shift, const float* scale,
                                     float scale_bias, float* stats, void* out, int rows,
                                     long long rows_per_batch, int D, float eps,
                                     cudaStream_t stream) {
  if (rows <= 0 || rows > (1 << 24) || (D != 512 && D != 1024 && D != 2048) ||
      rows_per_batch <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  cudaError_t e;
  if ((e = RowsRing::make_map_a(&map_x, x, rows, D, rows)) != cudaSuccess) return (int)e;
  if ((e = RowsRing::make_map_w(&map_w, w, D, D)) != cudaSuccess) return (int)e;
  bf16* ob = static_cast<bf16*>(out);
  const int err = launch_gemm_bias<EPI_BIAS_STATS>(map_x, map_w, b, ob,
                                                   reinterpret_cast<float2*>(stats), D,
                                                   make_sched(rows, D, D), stream);
  if (err) return err;
  ln_rows_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      RowsResidual{static_cast<const bf16*>(shortcut)}, ob,
      reinterpret_cast<const float2*>(stats), shift, scale, scale_bias, rows, 0, rows_per_batch,
      D, eps);
  return (int)cudaGetLastError();
}
