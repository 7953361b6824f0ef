// The row kernel shared by K4(b) and K5: a projection with a LayerNorm epilogue over whole
// rows. (K2 and K6 ran their tail on it until their redesign; their tail is now the proj
// GEMM and row kernel of gemm_rows_sm90.cuh, which K5 is to take next.)
//
//   y[r][n]   = bf16( sum_k a[r][k] * wt[n][k] + ybias[n] )        (ybias may be null)
//   out[r][n] = bf16( res[r'][n] + LN(y[r])[n] * g[r / gdiv][n] + h[r / gdiv][n] )
//
// with LN two-pass in f32 (no affine: the affine is g/h) and r' = r, or r % res_mod when
// res_mod > 0. The residual is bf16 (res_b) or f32 (res_f).
//   K5:         ybias = f32 bproj, a = the un-windowed attention output, res = the shortcut,
//               g = scale_bias + scale and h = shift, per batch element.
//   K4 tail:    no bias, res = the f32 queries (period Q), g/h = ln1 weight/bias.
//
// A block of 8 warps owns RB = 16 * RW rows. It walks the N output columns in chunks of
// NC = 32 * CW, each warp a 16 x 32 tile on bf16 mma.sync with f32 accumulation, the
// operands staged through shared memory in k-steps of 32, and keeps the rounded y of its
// rows (RB x N bf16) in shared memory until the LayerNorm pass. The A rows are re-read from
// L2 once per column chunk and the weight once per block: the simple design's cost.
#pragma once

#include "common.cuh"

template <int RW, int CW>
__global__ void __launch_bounds__(256) gemm_ln_rows_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ wt, const float* __restrict__ ybias,
    const bf16* __restrict__ res_b, const float* __restrict__ res_f, int res_mod,
    const float* __restrict__ g, const float* __restrict__ h, long long gdiv, long long M, int K,
    int N, float eps, bf16* __restrict__ out) {
  constexpr int RB = 16 * RW;
  constexpr int NC = 32 * CW;
  constexpr int KC = 32;
  constexpr int LDS = KC + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [RB][LDS]
  bf16* Bs = As + RB * LDS;                  // [NC][LDS]
  bf16* Ys = Bs + NC * LDS;                  // [RB][N + 8]
  const int ldy = N + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / CW, wc = warp % CW;
  const int gq = lane >> 2, tq = lane & 3;
  const long long r0 = (long long)blockIdx.x * RB;

  for (int n0 = 0; n0 < N; n0 += NC) {
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < RB * 4; i += 256) {
        int r = i >> 2, q = i & 3;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r0 + r < M) v = *reinterpret_cast<const uint4*>(a + (r0 + r) * K + k0 + q * 8);
        *reinterpret_cast<uint4*>(As + r * LDS + q * 8) = v;
      }
      for (int i = tid; i < NC * 4; i += 256) {
        int n = i >> 2, q = i & 3;
        *reinterpret_cast<uint4*>(Bs + n * LDS + q * 8) =
            *reinterpret_cast<const uint4*>(wt + (long long)(n0 + n) * K + k0 + q * 8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t af[4];
        load_a(af, As, LDS, wr * 16, kk, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bfr[2];
          load_b(bfr, Bs, LDS, wc * 32 + j * 8, kk, lane);
          mma_16816(acc[j], af, bfr);
        }
      }
    }
    const int r = wr * 16 + gq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + wc * 32 + j * 8 + 2 * tq;
      float b0 = ybias ? ybias[n] : 0.f, b1 = ybias ? ybias[n + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(Ys + r * ldy + n) = pack_bf16x2(acc[j][0] + b0, acc[j][1] + b1);
      *reinterpret_cast<uint32_t*>(Ys + (r + 8) * ldy + n) =
          pack_bf16x2(acc[j][2] + b0, acc[j][3] + b1);
    }
  }
  __syncthreads();

  for (int r = warp; r < RB; r += 8) {
    const long long row = r0 + r;
    if (row >= M) break;
    const bf16* y = Ys + r * ldy;
    float s = 0.f;
    for (int n = 2 * lane; n < N; n += 64) {
      float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y + n));
      s += v.x + v.y;
    }
    const float mean = warp_sum(s) / N;
    float s2 = 0.f;
    for (int n = 2 * lane; n < N; n += 64) {
      float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y + n));
      s2 += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
    }
    const float rstd = rsqrtf(warp_sum(s2) / N + eps);
    const long long grow = (row / gdiv) * N;
    const long long rr = (res_mod > 0 ? row % res_mod : row) * N;
    for (int n = 2 * lane; n < N; n += 64) {
      float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y + n));
      float x0, x1;
      if (res_b) {
        float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res_b + rr + n));
        x0 = xv.x;
        x1 = xv.y;
      } else {
        x0 = res_f[rr + n];
        x1 = res_f[rr + n + 1];
      }
      float o0 = x0 + ((v.x - mean) * rstd * g[grow + n] + h[grow + n]);
      float o1 = x1 + ((v.y - mean) * rstd * g[grow + n + 1] + h[grow + n + 1]);
      *reinterpret_cast<uint32_t*>(out + row * N + n) = pack_bf16x2(o0, o1);
    }
  }
}

// Launches the row kernel; returns cudaGetLastError(). Needs K % 32 == 0 and N a multiple
// of 64 (N <= 1024) or of 128 (N > 1024), N <= 2048.
static int launch_gemm_ln_rows(const bf16* a, const bf16* wt, const float* ybias,
                               const bf16* res_b, const float* res_f, int res_mod,
                               const float* g, const float* h, long long gdiv, long long M,
                               int K, int N, float eps, bf16* out, cudaStream_t stream) {
  if (K % 32 || N > 2048 || (N <= 1024 ? N % 64 : N % 128)) return (int)cudaErrorInvalidValue;
  if (N <= 1024) {
    constexpr int RW = 4, CW = 2, RB = 64, NC = 64;
    size_t smem = (size_t)(RB * 40 + NC * 40 + RB * (N + 8)) * sizeof(bf16);
    cudaFuncSetAttribute(gemm_ln_rows_kernel<RW, CW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    unsigned blocks = (unsigned)((M + RB - 1) / RB);
    gemm_ln_rows_kernel<RW, CW><<<blocks, 256, smem, stream>>>(
        a, wt, ybias, res_b, res_f, res_mod, g, h, gdiv, M, K, N, eps, out);
  } else {
    constexpr int RW = 2, CW = 4, RB = 32, NC = 128;
    size_t smem = (size_t)(RB * 40 + NC * 40 + RB * (N + 8)) * sizeof(bf16);
    cudaFuncSetAttribute(gemm_ln_rows_kernel<RW, CW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    unsigned blocks = (unsigned)((M + RB - 1) / RB);
    gemm_ln_rows_kernel<RW, CW><<<blocks, 256, smem, stream>>>(
        a, wt, ybias, res_b, res_f, res_mod, g, h, gdiv, M, K, N, eps, out);
  }
  return (int)cudaGetLastError();
}
