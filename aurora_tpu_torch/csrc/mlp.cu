// K3: the MLP branch of a block, out = x + LN(fc2(GELU(fc1 x))) * (scale_bias + scale) + shift;
// K8: the MLP alone, out = fc2(GELU(fc1 x)) (mlp_impl="pallas"); and
// K5: the attention tail after un-windowing, out = shortcut + LN(x @ W + b) * scale + shift.
//
// K3 replaces aurora_tpu/ops/mlp.py::mlp_adaln_residual_fused (pallas_call at mlp.py:419)
// and K8 mlp_fused (pallas_call at mlp.py:278). Both TPU kernels kept the weight matrices
// resident in VMEM and walked the hidden dimension with an in-kernel loop; here both are one
// kernel, mlp_kernel<CW, LN>, that differs only in its epilogue. K5 replaces
// linear_adaln_residual_fused (pallas_call at mlp.py:604) with the row kernel of
// row_tail.cuh, its residual read from its own pointer. Bound: bytes (x and shortcut read,
// out written once; the D x D GEMM is below the card's ~295 flop/byte balance point).
//
// Bound on the H100: operations, 4 * rows * D * 4D bf16 flops (~1.1 TFLOP, ~1.1 ms at
// 989 TF/s, for every backbone stage of the 0.25 deg model). Design: a block of 8 warps
// owns RB = 16 * 8 / CW rows (CW = D / 256 column warps) for the whole hidden dimension.
// The rows sit in shared memory; the hidden dimension is walked in chunks of 64:
//   fc1: each warp a 16 x (64 / CW) tile on bf16 mma.sync, + f32 bias, rounded,
//        exact-erf GELU in f32, rounded, into a shared 64-wide chunk;
//   fc2: each warp accumulates its 16 x 256 slice of the output in registers (128 f32 per
//        thread) from that chunk.
// The 4D hidden never reaches device memory. After the last chunk the f32 accumulators
// take the f32 bias and are rounded; the LayerNorm statistics are reduced across the CW
// warps of a row through shared memory (two-pass), then FiLM and the residual, rounded.
// K8 skips the LayerNorm: after the last chunk it adds the f32 bias and rounds.
// The B fragments are read straight from the (L2-resident) transposed weights. Measured ~19x
// over the bound, flat across the stages although the weight bytes per block grow 4x per
// stage: the limiter is this loop's issue rate (no staging, no pipelining, 255 registers,
// one block per SM), which wgmma tiles fed by TMA would replace.
#include "common.cuh"
#include "row_tail.cuh"

namespace {

constexpr int HC = 64;  // hidden chunk

template <int CW, bool LN>
__global__ void __launch_bounds__(256, 1) mlp_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1t, const float* __restrict__ b1,
    const bf16* __restrict__ w2t, const float* __restrict__ b2, const float* __restrict__ shift,
    const float* __restrict__ scale, float scale_bias, long long M, long long rows_per_batch,
    int Hd, float eps, bf16* __restrict__ out) {
  constexpr int RW = 8 / CW;
  constexpr int RB = 16 * RW;
  constexpr int D = 256 * CW;
  constexpr int LDX = D + 8;
  constexpr int LDH = HC + 8;
  constexpr int NT1 = 8 / CW;  // fc1 n8 tiles per warp
  constexpr int NT2 = 32;      // fc2 n8 tiles per warp (256 columns)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);                // [RB][LDX]
  bf16* Hs = Xs + RB * LDX;                                // [RB][LDH]
  float* red_sum = reinterpret_cast<float*>(Hs + RB * LDH);  // [RB][CW]
  float* red_sq = red_sum + RB * CW;                         // [RB][CW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / CW, wc = warp % CW;
  const int gq = lane >> 2, tq = lane & 3;
  const long long r0 = (long long)blockIdx.x * RB;

  for (int i = tid; i < RB * (D / 8); i += 256) {
    int r = i / (D / 8), q = i % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < M) v = *reinterpret_cast<const uint4*>(x + (r0 + r) * D + q * 8);
    *reinterpret_cast<uint4*>(Xs + r * LDX + q * 8) = v;
  }
  __syncthreads();

  float acc[NT2][4];
#pragma unroll
  for (int j = 0; j < NT2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int rl = wr * 16 + gq;  // local rows rl and rl + 8

  for (int h0 = 0; h0 < Hd; h0 += HC) {
    float a1[NT1][4];
#pragma unroll
    for (int j = 0; j < NT1; ++j) a1[j][0] = a1[j][1] = a1[j][2] = a1[j][3] = 0.f;
    const int c1 = wc * (HC / CW);
    for (int k = 0; k < D; k += 16) {
      uint32_t af[4];
      load_a(af, Xs, LDX, wr * 16, k, lane);
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        uint32_t bfr[2];
        load_b(bfr, w1t, D, h0 + c1 + j * 8, k, lane);
        mma_16816(a1[j], af, bfr);
      }
    }
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
      const int col = c1 + j * 8 + 2 * tq;
      const float bb0 = b1[h0 + col], bb1 = b1[h0 + col + 1];
      *reinterpret_cast<uint32_t*>(Hs + rl * LDH + col) = pack_bf16x2(
          gelu_erf(bf16r(a1[j][0] + bb0)), gelu_erf(bf16r(a1[j][1] + bb1)));
      *reinterpret_cast<uint32_t*>(Hs + (rl + 8) * LDH + col) = pack_bf16x2(
          gelu_erf(bf16r(a1[j][2] + bb0)), gelu_erf(bf16r(a1[j][3] + bb1)));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      uint32_t af[4];
      load_a(af, Hs, LDH, wr * 16, k, lane);
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        uint32_t bfr[2];
        load_b(bfr, w2t, Hd, wc * 256 + j * 8, h0 + k, lane);
        mma_16816(acc[j], af, bfr);
      }
    }
    __syncthreads();
  }

  if constexpr (!LN) {  // K8: out = round(acc + b2)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = r0 + rl + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        const int n = wc * 256 + j * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(out + row * D + n) =
            pack_bf16x2(acc[j][2 * half] + b2[n], acc[j][2 * half + 1] + b2[n + 1]);
      }
    }
    return;
  }

  // y = round(acc + b2); LayerNorm over the D columns shared by the CW warps of a row.
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    const int n = wc * 256 + j * 8 + 2 * tq;
    const float bb0 = b2[n], bb1 = b2[n + 1];
    acc[j][0] = bf16r(acc[j][0] + bb0);
    acc[j][1] = bf16r(acc[j][1] + bb1);
    acc[j][2] = bf16r(acc[j][2] + bb0);
    acc[j][3] = bf16r(acc[j][3] + bb1);
    s0 += acc[j][0] + acc[j][1];
    s1 += acc[j][2] + acc[j][3];
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  if (tq == 0) {
    red_sum[rl * CW + wc] = s0;
    red_sum[(rl + 8) * CW + wc] = s1;
  }
  __syncthreads();
  float mean0 = 0.f, mean1 = 0.f;
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    mean0 += red_sum[rl * CW + c];
    mean1 += red_sum[(rl + 8) * CW + c];
  }
  mean0 /= D;
  mean1 /= D;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    float d;
    d = acc[j][0] - mean0; q0 += d * d;
    d = acc[j][1] - mean0; q0 += d * d;
    d = acc[j][2] - mean1; q1 += d * d;
    d = acc[j][3] - mean1; q1 += d * d;
  }
  q0 = quad_sum(q0);
  q1 = quad_sum(q1);
  if (tq == 0) {
    red_sq[rl * CW + wc] = q0;
    red_sq[(rl + 8) * CW + wc] = q1;
  }
  __syncthreads();
  float var0 = 0.f, var1 = 0.f;
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    var0 += red_sq[rl * CW + c];
    var1 += red_sq[(rl + 8) * CW + c];
  }
  const float rstd0 = rsqrtf(var0 / D + eps), rstd1 = rsqrtf(var1 / D + eps);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rl + 8 * half;
    const long long row = r0 + r;
    if (row >= M) continue;
    const long long bi = (row / rows_per_batch) * D;
    const float mean = half ? mean1 : mean0, rstd = half ? rstd1 : rstd0;
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      const int n = wc * 256 + j * 8 + 2 * tq;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xs + r * LDX + n));
      const float y0 = acc[j][2 * half], y1 = acc[j][2 * half + 1];
      const float o0 =
          xv.x + ((y0 - mean) * rstd * (scale_bias + scale[bi + n]) + shift[bi + n]);
      const float o1 =
          xv.y + ((y1 - mean) * rstd * (scale_bias + scale[bi + n + 1]) + shift[bi + n + 1]);
      *reinterpret_cast<uint32_t*>(out + row * D + n) = pack_bf16x2(o0, o1);
    }
  }
}

template <int CW, bool LN>
int launch(const bf16* x, const bf16* w1t, const float* b1, const bf16* w2t, const float* b2,
           const float* shift, const float* scale, bf16* out, float scale_bias, long long M,
           long long rows_per_batch, int Hd, float eps, cudaStream_t stream) {
  constexpr int RB = 16 * (8 / CW), D = 256 * CW;
  const size_t smem = (size_t)RB * (D + 8) * 2 + (size_t)RB * (HC + 8) * 2 +
                      2 * (size_t)RB * CW * sizeof(float);
  cudaFuncSetAttribute(mlp_kernel<CW, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const unsigned blocks = (unsigned)((M + RB - 1) / RB);
  mlp_kernel<CW, LN><<<blocks, 256, smem, stream>>>(x, w1t, b1, w2t, b2, shift, scale,
                                                    scale_bias, M, rows_per_batch, Hd, eps, out);
  return (int)cudaGetLastError();
}

template <bool LN>
int launch_d(const void* x, const void* w1t, const float* b1, const void* w2t, const float* b2,
             const float* shift, const float* scale, void* out, float scale_bias, int M,
             int rows_per_batch, int D, int Hd, float eps, cudaStream_t stream) {
  if (Hd % HC) return (int)cudaErrorInvalidValue;
  auto xb = static_cast<const bf16*>(x);
  auto w1 = static_cast<const bf16*>(w1t);
  auto w2 = static_cast<const bf16*>(w2t);
  auto ob = static_cast<bf16*>(out);
  switch (D) {
    case 256:
      return launch<1, LN>(xb, w1, b1, w2, b2, shift, scale, ob, scale_bias, M, rows_per_batch,
                           Hd, eps, stream);
    case 512:
      return launch<2, LN>(xb, w1, b1, w2, b2, shift, scale, ob, scale_bias, M, rows_per_batch,
                           Hd, eps, stream);
    case 1024:
      return launch<4, LN>(xb, w1, b1, w2, b2, shift, scale, ob, scale_bias, M, rows_per_batch,
                           Hd, eps, stream);
    case 2048:
      return launch<8, LN>(xb, w1, b1, w2, b2, shift, scale, ob, scale_bias, M, rows_per_batch,
                           Hd, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (M, D) bf16 rows, rows_per_batch rows per FiLM row; w1t: (Hd, D) bf16;
// w2t: (D, Hd) bf16; b1: (Hd,), b2: (D,), shift/scale: (M / rows_per_batch, D) f32.
// Returns cudaGetLastError().
extern "C" int mlp_adaln_residual(const void* x, const void* w1t, const float* b1,
                                  const void* w2t, const float* b2, const float* shift,
                                  const float* scale, void* out, float scale_bias, int M,
                                  int rows_per_batch, int D, int Hd, float eps,
                                  cudaStream_t stream) {
  return launch_d<true>(x, w1t, b1, w2t, b2, shift, scale, out, scale_bias, M, rows_per_batch, D,
                        Hd, eps, stream);
}

// K8. x, out: (M, D) bf16 rows; w1t: (Hd, D) bf16; w2t: (D, Hd) bf16; b1: (Hd,), b2: (D,) f32.
// Returns cudaGetLastError().
extern "C" int mlp_fused(const void* x, const void* w1t, const float* b1, const void* w2t,
                         const float* b2, void* out, int M, int D, int Hd, cudaStream_t stream) {
  return launch_d<false>(x, w1t, b1, w2t, b2, nullptr, nullptr, out, 0.f, M, M, D, Hd, 0.f,
                         stream);
}

// K5. x, shortcut, out: (M, D) bf16 rows, rows_per_batch rows per FiLM row; wt: (D, D) bf16
// (transposed proj weight); b: (D,) f32; shift, gain: (M / rows_per_batch, D) f32 with
// gain = scale_bias + scale. Returns cudaGetLastError().
extern "C" int linear_adaln_residual(const void* x, const void* wt, const float* b,
                                     const void* shortcut, const float* shift, const float* gain,
                                     void* out, int M, int rows_per_batch, int D, float eps,
                                     cudaStream_t stream) {
  return launch_gemm_ln_rows(static_cast<const bf16*>(x), static_cast<const bf16*>(wt), b,
                             static_cast<const bf16*>(shortcut), nullptr, 0, gain, shift,
                             rows_per_batch, M, D, D, eps, static_cast<bf16*>(out), stream);
}
