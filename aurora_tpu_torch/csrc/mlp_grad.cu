// K3's input gradient: dx of out = x + LN(fc2(GELU(fc1 x))) * (scale_bias + scale) + shift for
// bf16 tokens, the weights and the FiLM held constant (LoRA training: the weights are frozen
// and the FiLM comes from frozen layers). It replaces no TPU kernel: the JAX package
// differentiates K3's XLA reference (aurora_tpu/ops/ad.py:32-67), as the port's plain backward
// (ops/ad.py) still does for every other call (float32 tokens, a weight's or the FiLM's
// gradient).
//
// Five launches a chunk of rows (the wrapper's chunks: ops/mlp.py::mlp_row_chunks, each
// Hd-wide scratch at most 256 MB), every product accumulating in f32:
//
//   1. mlp_fc1_kernel<.., STORE_PRE> (mlp_fc1_sm90.cuh), K3's fc1 recomputed:
//        pre = bf16(x W1 + b1), hid = bf16(gelu_erf(pre))                     K = D,  N = Hd
//   2. gemm_bias_kernel<EPI_BIAS_STATS>, K3's fc2 recomputed: y = bf16(hid W2 + b2) and per
//        row and 256-column tile its mean and centred sum of squares           K = Hd, N = D
//   3. ln_rows_grad_kernel, a warp a row: the statistics merged exactly as the forward's row
//        kernel merges them, n = (y - mean) rstd, dn = g (scale_bias + scale[f]) with FiLM row
//        f = (row_base + row) / rows_per_batch, dy = bf16(rstd (dn - mean(dn) - n mean(dn n)))
//        in place of y
//   4. grad_gemm_kernel<GRAD_GELU>: dpre = bf16((dy W2^T) gelu_erf'(pre)) in place of pre,
//        gelu_erf'(p) = 0.5 (1 + erf(p / sqrt 2)) + p phi(p) in f32           K = D,  N = Hd
//   5. grad_gemm_kernel<GRAD_ADD>: dx = bf16(dpre W1^T + g), the residual's gradient added in
//        f32                                                                   K = Hd, N = D
//
// Bound on the H100: operations, four products of 2 rows D Hd bf16 flops (twice K3's
// forward; 2.2 ms a call at each backbone stage of the 0.25-degree model at 989 TF/s). The
// plain backward rounds dy, dpre and dx to bf16 too, and rounds dhid = dy W2^T to bf16 besides,
// which step 4 keeps in f32.
//
// Products 4 and 5 run through the transposed weights with no transposed copy: W2 (Hd, D) and
// W1 (D, Hd) as stored are (N, K) with K contiguous, the K-major B operand of
// GemmRing<3, false, false> (gemm_sm90.cuh; one TMA box of 256 n x 64 k a stage). Their
// epilogues read a tile of a bf16 matrix of the product's shape (pre; g): each consumer warp
// copies its 16 rows x 256 columns into 8 KB of shared memory of its own by cp.async when the
// tile starts, so the copy runs under the tile's products; after them each thread reads the
// values of its accumulator fragment there, writes the result in their place, and the warp
// stores whole 128-byte lines. 8 warps x 8 KB leave room for a ring of 3 stages of 48 KB.
// Step 4 writes dpre over the pre tile that it read, which no other tile reads.
//
// ptxas (sm_90a, CUDA 12.8): the product kernels 168 registers at launch, no spills; 214,064
// bytes of dynamic shared memory for steps 4 and 5; the row kernel 32 registers. Times and the
// choice of storing pre (against recomputing x W1 in step 4): PERF.md.
#include "common.cuh"
#include "gemm_rows_sm90.cuh"
#include "mlp_fc1_sm90.cuh"

namespace {

using GradRing = sm90::GemmRing<3, false, false>;
constexpr int AUX_WARP_BYTES = 16 * 512;  // a warp's 16 rows x 256 columns of bf16
constexpr size_t GRAD_SMEM = 1024 + GradRing::STAGES * GradRing::STAGE_BYTES +
                             GradRing::CONSUMER_WARPS * AUX_WARP_BYTES + GradRing::BAR_BYTES;
enum { GRAD_GELU = 0, GRAD_ADD = 1 };

// d gelu_erf / dp at p, in f32: the standard normal's distribution plus p times its density.
__device__ __forceinline__ float gelu_erf_grad(float p) {
  return 0.5f * (1.0f + erff(p * 0.70710678118654752f)) +
         p * 0.39894228040143268f * expf(-0.5f * p * p);
}

// 16 bytes from global src to shared dst, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void unpack_bf16x8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Piece i (0-15) of a warp's 16 x 256 bf16 tile: lane l takes row 4 (i & 3) + (l >> 3), 16-byte
// piece 8 (i >> 2) + (l & 7) of the row's 32, kept at piece ^ (row & 7) of the row's 512 bytes
// in shared memory (mlp_fc1_sm90.cuh's parked layout): eight lanes take a whole 128-byte line,
// and the fragment's reads and writes below are free of bank conflicts.
__device__ __forceinline__ int piece_row(int i, int lane) { return 4 * (i & 3) + (lane >> 3); }
__device__ __forceinline__ int piece_col(int i, int lane) { return 8 * (i >> 2) + (lane & 7); }
__device__ __forceinline__ int piece_at(int r, int q) { return r * 512 + ((q ^ (r & 7)) << 4); }

// The epilogue of two neighbouring accumulators a0, a1 and the two bf16 values of the tile
// packed in w (the lower column first).
template <int EPI>
__device__ __forceinline__ uint32_t grad_epilogue(float a0, float a1, uint32_t w) {
  const float v0 = __uint_as_float(w << 16), v1 = __uint_as_float(w & 0xffff0000u);
  if constexpr (EPI == GRAD_GELU)
    return pack_bf16x2(a0 * gelu_erf_grad(v0), a1 * gelu_erf_grad(v1));
  else
    return pack_bf16x2(a0 + v0, a1 + v1);
}

// out = epilogue(A W^T, aux) over s.rows rows: A (rows, K) bf16 (map_a), W (N, K) bf16 as
// stored (map_w, make_map_wk), aux and out (rows, N) bf16 (out may be aux). The tile walk
// and the producer are gemm_bias_kernel's (gemm_rows_sm90.cuh).
template <int EPI>
__global__ void __launch_bounds__(ROWS_THREADS, 1) grad_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const bf16* aux, bf16* out, int N, const Sched s) {
  using Ring = GradRing;
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  const uint32_t aux_smem = tiles + Ring::STAGES * Ring::STAGE_BYTES;
  const uint32_t bars = aux_smem + Ring::CONSUMER_WARPS * AUX_WARP_BYTES;
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
    const uint32_t mine_addr = aux_smem + (tid >> 5) * AUX_WARP_BYTES;
    unsigned char* mine = raw + (mine_addr - raw_addr);
    typename Ring::Pos pos;
    float acc[128];
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const int p = 2 * (u / s.n_tiles) + wg;
      const int n0 = (u % s.n_tiles) * Ring::BN;
      const int row0 = 64 * p + 16 * warp;  // the warp's first row; this thread: + gq, + gq + 8
      const bool live = p < s.pieces;       // past the last piece: products only, no store
      if (live) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = piece_row(i, lane), q = piece_col(i, lane);
          const bool in = row0 + r < s.rows;
          cp_async16(mine_addr + piece_at(r, q),
                     in ? aux + (long long)(row0 + r) * N + n0 + 8 * q : aux, in);
        }
      }
      Ring::consume_tile(acc, tiles, bars, pos, s.k_steps, wg, lane == 0);
      if (!live) continue;
      cp_async_wait_all();
      __syncwarp();
      unsigned char* put = mine + gq * 512 + tq * 4;  // rows gq and gq + 8, columns 2 tq..
#pragma unroll
      for (int j = 0; j < 32; ++j) {  // n8 tile j: piece j of the row
        uint32_t* lo = reinterpret_cast<uint32_t*>(put + ((j ^ gq) << 4));
        uint32_t* hi = reinterpret_cast<uint32_t*>(put + ((j ^ gq) << 4) + 8 * 512);
        *lo = grad_epilogue<EPI>(acc[4 * j], acc[4 * j + 1], *lo);
        *hi = grad_epilogue<EPI>(acc[4 * j + 2], acc[4 * j + 3], *hi);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = piece_row(i, lane), q = piece_col(i, lane);
        if (row0 + r < s.rows)
          *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * N + n0 + 8 * q) =
              *reinterpret_cast<const uint4*>(mine + piece_at(r, q));
      }
      __syncwarp();  // the next tile's copies overwrite `mine`
    }
  }
}

template <int EPI>
int launch_grad_gemm(const CUtensorMap& map_a, const CUtensorMap& map_w, const bf16* aux,
                     bf16* out, int N, const Sched& s, cudaStream_t stream) {
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorUnknown;
  cudaFuncSetAttribute(grad_gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)GRAD_SMEM);
  grad_gemm_kernel<EPI><<<s.units < sms ? s.units : sms, ROWS_THREADS, GRAD_SMEM, stream>>>(
      map_a, map_w, aux, out, N, s);
  return (int)cudaGetLastError();
}

// A warp a row: y (rows, D) bf16 holding fc2's rounded output becomes dy, the gradient of
// LN(y) * (scale_bias + scale[f]) + shift[f] at g (rows, D) bf16. Two passes over the row, 8
// columns a lane per 256: the sums of dn and dn n, then dy.
__global__ void __launch_bounds__(256) ln_rows_grad_kernel(
    bf16* __restrict__ y, const float2* __restrict__ stats, const bf16* __restrict__ g,
    const float* __restrict__ scale, float scale_bias, int rows, long long row_base,
    long long rows_per_batch, int D, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float2 mr = merge_row_stats<256>(stats + (long long)row * (D / 256), D, eps);
  const float mean = mr.x, rstd = mr.y;
  const float* sc = scale + ((row_base + row) / rows_per_batch) * D;
  bf16* yr = y + (long long)row * D;
  const bf16* gr = g + (long long)row * D;
  float s1 = 0.f, s2 = 0.f;
  for (int c = 0; c < D / 256; ++c) {
    const int n = 256 * c + 8 * lane;
    float yv[8], gv[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(yr + n), yv);
    unpack_bf16x8(*reinterpret_cast<const uint4*>(gr + n), gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dn = gv[i] * (scale_bias + sc[n + i]);
      s1 += dn;
      s2 += dn * ((yv[i] - mean) * rstd);
    }
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  for (int c = 0; c < D / 256; ++c) {
    const int n = 256 * c + 8 * lane;
    float yv[8], gv[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(yr + n), yv);
    unpack_bf16x8(*reinterpret_cast<const uint4*>(gr + n), gv);
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float d[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = 2 * i + k;
        const float dn = gv[e] * (scale_bias + sc[n + e]);
        d[k] = rstd * (dn - m1 - ((yv[e] - mean) * rstd) * m2);
      }
      o[i] = pack_bf16x2(d[0], d[1]);
    }
    *reinterpret_cast<uint4*>(yr + n) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// K3's input gradient on one chunk of rows. x, g, dx: (rows, D) bf16 (the tokens, the output's
// gradient, the tokens' gradient); w1: (D, Hd) and w2: (Hd, D) bf16 as stored; b1: (Hd,),
// b2: (D,) f32; scale: (batch, D) f32, the row (row_base + row) / rows_per_batch of each.
// Scratch: pre and hid of rows x Hd bf16, y of rows x D bf16, stats of rows x D / 256
// float2. Takes D in {256, 512, 1024, 2048}, Hd % 256 == 0, Hd >= 512; g 16-byte aligned.
// Returns cudaGetLastError(), cudaErrorInvalidValue for a shape it does not take, or
// cudaErrorUnknown where no tensor map could be encoded.
extern "C" int mlp_rows_input_grad(const void* x, const void* w1, const float* b1,
                                   const void* w2, const float* b2, const void* g,
                                   const float* scale, float scale_bias, void* pre, void* hid,
                                   void* y, float* stats, void* dx, int rows, long long row_base,
                                   long long rows_per_batch, int D, int Hd, float eps,
                                   cudaStream_t stream) {
  if (rows <= 0 || rows > (1 << 24) || (D != 256 && D != 512 && D != 1024 && D != 2048) ||
      Hd < 512 || Hd % 256 || rows_per_batch <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w1, map_hid, map_w2, map_dy, map_w2t, map_dpre, map_w1t;
  cudaError_t e;
  if ((e = Ring1::make_map_a(&map_x, x, rows, D, rows)) != cudaSuccess) return (int)e;
  if ((e = Ring1::make_map_w(&map_w1, w1, D, Hd)) != cudaSuccess) return (int)e;
  if ((e = RowsRing::make_map_a(&map_hid, hid, rows, Hd, rows)) != cudaSuccess) return (int)e;
  if ((e = RowsRing::make_map_w(&map_w2, w2, Hd, D)) != cudaSuccess) return (int)e;
  if ((e = GradRing::make_map_a(&map_dy, y, rows, D, rows)) != cudaSuccess) return (int)e;
  if ((e = GradRing::make_map_wk(&map_w2t, w2, Hd, D)) != cudaSuccess) return (int)e;
  if ((e = GradRing::make_map_a(&map_dpre, pre, rows, Hd, rows)) != cudaSuccess) return (int)e;
  if ((e = GradRing::make_map_wk(&map_w1t, w1, D, Hd)) != cudaSuccess) return (int)e;
  // fc1 and the dpre product: K = D, N = Hd; fc2 and the dx product: K = Hd, N = D.
  const Sched s1 = make_sched(rows, D, Hd), s2 = make_sched(rows, Hd, D);
  bf16 *pb = static_cast<bf16*>(pre), *yb = static_cast<bf16*>(y);
  const bf16* gb = static_cast<const bf16*>(g);
  int err;
  if ((err = launch_mlp_fc1<true>(map_x, map_w1, b1, static_cast<bf16*>(hid), pb, D, Hd, s1,
                                  stream)))
    return err;
  if ((err = launch_gemm_bias<EPI_BIAS_STATS>(map_hid, map_w2, b2, yb,
                                              reinterpret_cast<float2*>(stats), D, s2, stream)))
    return err;
  ln_rows_grad_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      yb, reinterpret_cast<const float2*>(stats), gb, scale, scale_bias, rows, row_base,
      rows_per_batch, D, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((err = launch_grad_gemm<GRAD_GELU>(map_dy, map_w2t, pb, pb, Hd, s1, stream))) return err;
  return launch_grad_gemm<GRAD_ADD>(map_dpre, map_w1t, gb, static_cast<bf16*>(dx), D, s2,
                                    stream);
}
