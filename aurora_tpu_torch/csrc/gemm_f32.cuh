// The float32 FFMA product and the float32 row kernel. The row kernel is every float32 form's
// with a LayerNorm (K2, K3, K4, K5, K6). Every float32 product of the path runs on the tensor
// cores in three TF32 parts (gemm_tf32x3_sm90.cuh: K3, K8, K4, K5 and K2's and K6's qkv and
// proj); this product builds their earlier forms under -DMLP_F32_FFMA, -DWINDOW_F32_FFMA,
// -DRESAMPLER_F32_FFMA and -DLINEAR_F32_FFMA (tools/kernel_ablate.py's `ffma`).
//
// The TPU kernels compute in the tokens' dtype; in float32 every product accumulates in f32
// from f32 operands (aurora_tpu/ops/mlp.py:244,375; aurora_tpu/model/swin3d.py:1127). Here
// that is the FFMA pipes (67 TF/s): one TF32 product on the tensor cores keeps 10 bits of the
// mantissa, about three decimal digits, which the float32 bounds (9e-5 a block) would catch;
// three TF32 products of split operands keep float32's digits (gemm_tf32x3_sm90.cuh).
//
//   gemm_f32_kernel<TN, EPI, A>: out = A W (+ epilogue) over M rows. A's rows come from a
//     row addressing (Rows: a matrix with a leading dimension; GroupedRows: groups of `per`
//     rows at a stride, K4's k-major context cut to a chunk of columns); W (K, N) f32 read
//     as stored, (in, out), no transposed copy. A block computes a 128 x (16 TN) tile with
//     256 threads, each an 8 x TN tile of f32 sums (rows 4 tr + i and 64 + 4 tr + i, columns
//     4 tc + j in each 64-column half); K steps of 32 on a ring of 3 cp.async stages (A kept
//     row-major in shared memory with rows of 36 floats, so a thread's reads per 4 k are one
//     16-byte read of each of its 8 rows and TN / 4 of each of 4 rows of W). The epilogue,
//     by EPI:
//       EPI_PLAIN      out = acc                                   (K4's v, logits, out-proj)
//       EPI_BIAS       out = acc + b                               (qkv, proj, fc2)
//       EPI_BIAS_GELU  out = gelu_erf(acc + b), the exact erf form  (fc1)
//       EPI_SUMSQ      out[row, tile] = sum of acc^2 over the tile's 16 TN columns
//                      (K4 with ln_k: the centred k's sums of squares)
//     Rows past M load as zeros (cp.async with a source size of 0) and are never stored.
//     M, K and N: K % 32 == 0, N % (16 TN) == 0, every row 16-byte aligned (the callers check).
//   ln_rows_f32_kernel<NV, Res>: a warp a row of D = 128 NV floats held in registers,
//     out (holding y) = x + LN(y) * (scale_bias + scale[f]) + shift[f] in place, the
//     LayerNorm two-pass over the row (mean, then the mean of the centred squares) as the
//     plain version computes it, f = (row_base + row) / rows_per_batch; x the row's own row
//     of an f32 matrix (RowsF32: K2, K3, K5, K6) or row (row_base + row) % period of one (PeriodicF32:
//     K4's queries).
//
// Bound of a product on the card: operations, 2 M K N at 67 TF/s. This is the simple design
// (SIMT, one tile of sums a thread, 42.6 TF/s at K2's qkv on the H100, 64% of the FFMA peak).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace f32k {

constexpr int BM = 128, BK = 32, STAGES = 3, LDA = BK + 4, THREADS = 256;
enum { EPI_PLAIN = 0, EPI_BIAS = 1, EPI_BIAS_GELU = 2, EPI_SUMSQ = 3 };

template <int TN>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BM * LDA + BK * 16 * TN) * sizeof(float);
}

// Row r of A at p + r ld.
struct Rows {
  const float* p;
  long long ld;
  __device__ __forceinline__ const float* row(long long r) const { return p + r * ld; }
};
// Row r = g per + i of A at p + g stride + i ld.
struct GroupedRows {
  const float* p;
  long long stride;
  int per;
  long long ld;
  __device__ __forceinline__ const float* row(long long r) const {
    const long long g = r / per;
    return p + g * stride + (r - g * per) * ld;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
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

// out: (M, N) f32 (EPI_SUMSQ: (M, N / (16 TN))); bias: (N,) f32 for EPI_BIAS / EPI_BIAS_GELU.
// One block a tile, column tile fastest (the tiles of one row block run together and read
// A's rows from device memory once).
template <int TN, int EPI, class A>
__global__ void __launch_bounds__(THREADS) gemm_f32_kernel(
    const A a, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, long long M, int K, int N) {
  constexpr int BN = 16 * TN, G = TN / 4;  // G column groups of 4 a thread, 64 apart
  constexpr int A_FLOATS = BM * LDA, B_FLOATS = BK * BN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                        // [STAGES][BM][LDA]
  float* Bs = smem + STAGES * A_FLOATS;    // [STAGES][BK][BN]
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int n_tiles = N / BN;
  const int nt = (int)(blockIdx.x % n_tiles);
  const int n0 = nt * BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;

  // A: four 16-byte pieces a thread (row (tid >> 3) + 32 p, piece tid & 7 of the 8 a
  // 32-float K step); W: TN / 2 pieces (piece f = tid + 256 q of the stage's BK x BN).
  const int ac = tid & 7;
  const float* asrc[4];
  bool aok[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long r = m0 + (tid >> 3) + 32 * p;
    aok[p] = r < M;
    asrc[p] = a.row(aok[p] ? r : 0) + 4 * ac;
  }
  auto load_stage = [&](int kt) {
    const int st = kt % STAGES, k0 = kt * BK;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      cp_async16(As + st * A_FLOATS + ((tid >> 3) + 32 * p) * LDA + 4 * ac, asrc[p] + k0, aok[p]);
#pragma unroll
    for (int q = 0; q < TN / 2; ++q) {
      const int f = tid + THREADS * q, kb = f / (BN / 4), cb = f % (BN / 4);
      cp_async16(Bs + st * B_FLOATS + kb * BN + 4 * cb, w + (long long)(k0 + kb) * N + n0 + 4 * cb,
                 true);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
  const int kts = K / BK;
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < kts) load_stage(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < kts; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed for all; stage kt - 1 is no longer read
    if (kt + STAGES - 1 < kts) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const float* as = As + (kt % STAGES) * A_FLOATS;
    const float* bs = Bs + (kt % STAGES) * B_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float bv[4][TN];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(bs + (kq + j) * BN + 64 * g + 4 * tc);
          bv[j][4 * g] = t.x; bv[j][4 * g + 1] = t.y; bv[j][4 * g + 2] = t.z; bv[j][4 * g + 3] = t.w;
        }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rl = i < 4 ? 4 * tr + i : 64 + 4 * tr + i - 4;
        const float4 av = *reinterpret_cast<const float4*>(as + rl * LDA + kq);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(ak[j], bv[j][c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + (i < 4 ? 4 * tr + i : 64 + 4 * tr + i - 4);
    if constexpr (EPI == EPI_SUMSQ) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) s = fmaf(acc[i][c], acc[i][c], s);
      // The row's 16 threads are lanes tc = 0..15 of one half-warp.
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      if (tc == 0 && r < M) out[r * n_tiles + nt] = s;
    } else {
      if (r >= M) continue;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int n = n0 + 64 * g + 4 * tc;
        float v[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]};
        if constexpr (EPI == EPI_BIAS || EPI == EPI_BIAS_GELU) {
          const float4 b = *reinterpret_cast<const float4*>(bias + n);
          v[0] += b.x; v[1] += b.y; v[2] += b.z; v[3] += b.w;
        }
        if constexpr (EPI == EPI_BIAS_GELU) {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = gelu_erf(v[c]);
        }
        *reinterpret_cast<float4*>(out + r * N + n) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// Launches gemm_f32_kernel<TN, EPI> over M rows: one block a 128 x 16 TN tile.
template <int TN, int EPI, class A>
int launch_gemm_f32(const A& a, const float* w, const float* bias, float* out, long long M, int K,
                    int N, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % BK || N <= 0 || N % (16 * TN)) return (int)cudaErrorInvalidValue;
  const long long blocks = (M + BM - 1) / BM * (N / (16 * TN));
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(gemm_f32_kernel<TN, EPI, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes<TN>());
  gemm_f32_kernel<TN, EPI, A><<<(unsigned)blocks, THREADS, smem_bytes<TN>(), stream>>>(
      a, w, bias, out, M, K, N);
  return (int)cudaGetLastError();
}

// The residual x of ln_rows_f32_kernel's row `row`: its own row of a (rows, D) f32 matrix
// (K2, K3, K5, K6).
struct RowsF32 {
  const float* x;
  __device__ __forceinline__ const float* row(int row, long long, int D) const {
    return x + (long long)row * D;
  }
};
// Row (row_base + row) % period of a (period, D) f32 matrix (K4's queries).
struct PeriodicF32 {
  const float* x;
  int period;
  __device__ __forceinline__ const float* row(int row, long long row_base, int D) const {
    return x + ((row_base + row) % period) * D;
  }
};

// A warp a row of D = 128 NV values: lane l holds the float4s l + 32 v, v < NV.
template <int NV, class Res>
__global__ void __launch_bounds__(256) ln_rows_f32_kernel(
    const Res res, float* __restrict__ out, const float* __restrict__ shift,
    const float* __restrict__ scale, float scale_bias, int rows, long long row_base,
    long long rows_per_batch, float eps) {
  constexpr int D = 128 * NV;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  float* y = out + (long long)row * D;
  float4 v[NV];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    v[i] = *reinterpret_cast<const float4*>(y + 4 * (lane + 32 * i));
    s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean, d = v[i].w - mean;
    q += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
  const long long film = ((row_base + row) / rows_per_batch) * D;
  const float* x = res.row(row, row_base, D);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int n = 4 * (lane + 32 * i);
    const float4 xv = *reinterpret_cast<const float4*>(x + n);
    const float4 sc = *reinterpret_cast<const float4*>(scale + film + n);
    const float4 sh = *reinterpret_cast<const float4*>(shift + film + n);
    float4 o;
    o.x = xv.x + ((v[i].x - mean) * rstd * (scale_bias + sc.x) + sh.x);
    o.y = xv.y + ((v[i].y - mean) * rstd * (scale_bias + sc.y) + sh.y);
    o.z = xv.z + ((v[i].z - mean) * rstd * (scale_bias + sc.z) + sh.z);
    o.w = xv.w + ((v[i].w - mean) * rstd * (scale_bias + sc.w) + sh.w);
    *reinterpret_cast<float4*>(y + n) = o;
  }
}

// ln_rows_f32_kernel for D in {256, 512, 1024, 2048}.
template <class Res>
int launch_ln_rows_f32(const Res& res, float* out, const float* shift, const float* scale,
                       float scale_bias, int rows, long long row_base, long long rows_per_batch,
                       int D, float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + 7) / 8);
  switch (D) {
    case 256:
      ln_rows_f32_kernel<2, Res><<<grid, 256, 0, stream>>>(res, out, shift, scale, scale_bias,
                                                           rows, row_base, rows_per_batch, eps);
      break;
    case 512:
      ln_rows_f32_kernel<4, Res><<<grid, 256, 0, stream>>>(res, out, shift, scale, scale_bias,
                                                           rows, row_base, rows_per_batch, eps);
      break;
    case 1024:
      ln_rows_f32_kernel<8, Res><<<grid, 256, 0, stream>>>(res, out, shift, scale, scale_bias,
                                                           rows, row_base, rows_per_batch, eps);
      break;
    case 2048:
      ln_rows_f32_kernel<16, Res><<<grid, 256, 0, stream>>>(res, out, shift, scale, scale_bias,
                                                            rows, row_base, rows_per_batch, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace f32k
