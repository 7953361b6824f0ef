// K2, K6 and K7 in float32: window attention over 144-token windows (head dim 64), for the
// facades' default config (float32 all through). K2 reads its windows in place from the
// padded (B, Cp, Hp, Wp, D) tokens, K6 from pre-partitioned (B, nW, 144, D) windows, each with
// the block's optional tail; K7 is the attention core alone on the caller's packed qkv.
//
// Replaces the float32 forms of three kernels of aurora_tpu/model/swin3d.py, which compute in
// the tokens' dtype (swin3d.py:1127,1193-1201; the shared body _qkv_attn_tail_body, :561-596,
// and its core _heads_attention, :524-558):
//   K2 _attn_windows_5d_fused_pallas (pallas_call at :924),
//   K6 _attn_windows_qkv_fused_pallas (pallas_call at :772),
//   K7 _sdpa_windows_fused_pallas (pallas_call at :651).
// The function, all in f32:
//   qkv  = x Wqkv + bqkv                                      (K2, K6; K7 is given qkv)
//   attn = per head: logits q.k / 8 (+0 / -100 by group id), softmax, w @ v
//   tail: y = attn Wproj + bproj; out = x + LN(y) scale[b] + shift[b] (two-pass LayerNorm,
//         eps given); without the tail attn is the result.
//
// Bound on the H100: operations at 67 TF/s (stage 1 of the 0.25 degree model: qkv 0.41 TFLOP,
// the core 0.08, proj 0.14: 9.2 ms a K2 / K6 call with the tail); K7 alone 1.13 ms of
// operations against 0.63 ms of bytes at stage 1.
//
// Design: four launches with the tail, two without, one for K7, on the caller's stream:
//   1. qkv: gemm_f32_kernel<8, EPI_BIAS> (gemm_f32.cuh) over the token rows in their stored
//      order, Wqkv (D, 3D) as stored, into a (rows, 3D) f32 scratch (1.6 GB at stage 1);
//   2. core: window_core_f32<Map>, one block a (window, head), head fastest. The row map
//      gives the row of token t of window w: Grid5d (K2) the token's row of the padded 5D
//      grid, Packed (K6, K7) w 144 + t. Its 9 warps load the window's q, k and v (144 x 64
//      each, read through the map, rows of 68 floats in shared memory: conflict-free 16-byte
//      reads down a column) and the window's group ids. Warp w takes queries 16 w .. 16 w +
//      15: each lane the keys lane + 32 t (t < 5, the last half a warp), 16 x 5 logits in
//      registers from 16-byte reads of q (broadcast) and k; the mask, a warp's max and sum
//      per row, the weights to a 16 x 144 buffer of the warp's own; then w @ v with each lane
//      8 rows x 4 features (16-byte reads of the weights, broadcast, and of v). Each token's
//      result goes to its own row, through the map. Pad tokens are rows like any other; in
//      masked blocks their own group id keeps them apart. 203 KB of shared memory, one block
//      an SM.
//   3. tail, proj: gemm_f32_kernel<8, EPI_BIAS>, Wproj (D, D) as stored, into out;
//   4. tail, rows: ln_rows_f32_kernel with the block input x as the residual and FiLM row
//      row / (nW 144), in place in out.
// qkv and the attention output each make a round trip through device memory, as in the bf16
// form (window_attention.cu), at twice its bytes. K2 and K6 run one core and one GEMM on the
// same rows in another order, so K6 on window_partition(x), reversed, gives K2's bits on x.
//
// window_attention_f32 has the C signature of window_attention.cu's window_attention (stats
// is not used: the row kernel takes the LayerNorm statistics over the row it holds) and, as
// it, is K2 for Cp > 0 and K6 for Cp == 0; sdpa_windows_f32 has sdpa.cu's sdpa_windows'.
#include "gemm_f32.cuh"

namespace {

constexpr int CN = 144, DH = 64, LDQ = DH + 4, LDP = CN + 4, CORE_WARPS = 9;
constexpr int CORE_THREADS = 32 * CORE_WARPS;
constexpr size_t CORE_SMEM =
    (size_t)(3 * CN * LDQ + CORE_WARPS * 16 * LDP) * sizeof(float) + CN * sizeof(int) +
    CN * sizeof(long long);

// K2's row map, the padded grid's windows: window w of batch element b = w / nW (windows in
// (C1, H1, W1) order), token t in (wc, wh, ww) order.
struct Grid5d {
  int nW, nH1, nW1, Cp, Hp, Wp, ws0, ws1, ws2;
  __device__ __forceinline__ long long row(long long window, int t) const {
    const long long b = window / nW;
    const int r = (int)(window - b * nW);
    const int c1 = r / (nH1 * nW1), h1 = (r / nW1) % nH1, w1 = r % nW1;
    const int wc = t / (ws1 * ws2), wh = (t / ws2) % ws1, ww = t % ws2;
    return ((b * Cp + c1 * ws0 + wc) * Hp + h1 * ws1 + wh) * (long long)Wp + w1 * ws2 + ww;
  }
};

// K6's and K7's row map, packed windows: token t of window w at row w 144 + t.
struct Packed {
  int nW;
  __device__ __forceinline__ long long row(long long window, int t) const {
    return window * CN + t;
  }
};

// qkv: (rows, 3 D) f32; groups: (nW, 144) int32 or null; attn: (rows, D) f32; both read and
// written through the map g (Grid5d or Packed).
template <class Map>
__global__ void __launch_bounds__(CORE_THREADS, 1) window_core_f32(
    const float* __restrict__ qkv, const int* __restrict__ groups, float* __restrict__ attn,
    const Map g, int D, int heads) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                       // [CN][LDQ]
  float* ks = qs + CN * LDQ;            // [CN][LDQ]
  float* vs = ks + CN * LDQ;            // [CN][LDQ]
  float* ps = vs + CN * LDQ;            // [CORE_WARPS][16][LDP]
  int* gid = reinterpret_cast<int*>(ps + CORE_WARPS * 16 * LDP);  // [CN]
  long long* rowof = reinterpret_cast<long long*>(gid + CN);       // [CN]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long window = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const long long ld = 3ll * D;

  for (int t = tid; t < CN; t += CORE_THREADS) {
    rowof[t] = g.row(window, t);
    gid[t] = groups ? groups[(window % g.nW) * CN + t] : 0;
  }
  __syncthreads();
  for (int i = tid; i < 3 * CN * 16; i += CORE_THREADS) {
    const int part = i / (CN * 16), rem = i - part * CN * 16, t = rem >> 4, c4 = rem & 15;
    const float4 v = *reinterpret_cast<const float4*>(qkv + rowof[t] * ld + part * D + h * DH +
                                                      4 * c4);
    *reinterpret_cast<float4*>(sm + (part * CN + t) * LDQ + 4 * c4) = v;
  }
  __syncthreads();

  // Logits of queries i0 + i (i < 16) against keys lane + 32 t (t < 5; t = 4 only lanes < 16).
  const int i0 = 16 * warp;
  const bool has4 = lane < 16;
  float s[16][5];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int t = 0; t < 5; ++t) s[i][t] = 0.f;
  for (int d = 0; d < DH; d += 4) {
    float4 kv[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int j = t < 4 ? lane + 32 * t : (has4 ? 128 + lane : CN - 1);
      kv[t] = *reinterpret_cast<const float4*>(ks + j * LDQ + d);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(qs + (i0 + i) * LDQ + d);
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        float a = s[i][t];
        a = fmaf(q.x, kv[t].x, a);
        a = fmaf(q.y, kv[t].y, a);
        a = fmaf(q.z, kv[t].z, a);
        a = fmaf(q.w, kv[t].w, a);
        s[i][t] = a;
      }
    }
  }
  float* pw = ps + warp * 16 * LDP;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int gi = gid[i0 + i];
    float mx = -3.0e38f;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int j = lane + 32 * t;
      if (t < 4 || has4) {
        float x = s[i][t] * 0.125f;
        if (groups) x += gid[j] == gi ? 0.f : -100.f;
        s[i][t] = x;
        mx = fmaxf(mx, x);
      }
    }
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      if (t < 4 || has4) {
        s[i][t] = expf(s[i][t] - mx);
        sum += s[i][t];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < 5; ++t)
      if (t < 4 || has4) pw[i * LDP + lane + 32 * t] = s[i][t] / sum;
  }
  __syncwarp();

  // w @ v: lane = 16 rh + dq takes rows 8 rh .. 8 rh + 7 and features 4 dq .. 4 dq + 3.
  const int rh = lane >> 4, dq = lane & 15;
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  for (int j = 0; j < CN; j += 4) {
    float4 vv[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      vv[jj] = *reinterpret_cast<const float4*>(vs + (j + jj) * LDQ + 4 * dq);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(pw + (8 * rh + i) * LDP + j);
      const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        o[i][0] = fmaf(pj[jj], vv[jj].x, o[i][0]);
        o[i][1] = fmaf(pj[jj], vv[jj].y, o[i][1]);
        o[i][2] = fmaf(pj[jj], vv[jj].z, o[i][2]);
        o[i][3] = fmaf(pj[jj], vv[jj].w, o[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = i0 + 8 * rh + i;
    *reinterpret_cast<float4*>(attn + rowof[t] * D + h * DH + 4 * dq) =
        make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
  }
}

// The core over `windows` windows of the map g, one block a (window, head).
template <class Map>
int launch_core(const float* qkv, const int* groups, float* attn, const Map& g, long long windows,
                int D, int heads, cudaStream_t stream) {
  if (windows * heads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(window_core_f32<Map>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)CORE_SMEM);
  window_core_f32<Map><<<(unsigned)(windows * heads), CORE_THREADS, CORE_SMEM, stream>>>(
      qkv, groups, attn, g, D, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// K2 (Cp > 0) and K6 (Cp == 0) in float32. K2: x, attn, out (B, Cp, Hp, Wp, D) f32 with
// windows (ws0, ws1, ws2) in place; K6: x, attn, out (B, nW, 144, D) f32 (Hp, Wp and ws are
// not read). wqkv: (D, 3D) f32 as stored; bqkv: (3D,) f32; groups: (nW, 144) int32 or null
// (nW windows a batch element); qkv: scratch (rows, 3D) f32. With wproj set, the tail: wproj
// (D, D) f32 as stored, bproj (D,) f32, shift/scale (B, D) f32, the result in out; without it
// (wproj null) the result is attn and out is unused. stats is not used. D in {256, 512, 1024,
// 2048}, D = 64 heads. Returns cudaGetLastError() of the last launch, or cudaErrorInvalidValue
// for a shape it does not take.
extern "C" int window_attention_f32(const float* x, const float* wqkv, const float* bqkv,
                                    const int* groups, const float* wproj, const float* bproj,
                                    const float* shift, const float* scale, float* qkv,
                                    float* attn, float* stats, float* out, int B, int nW, int Cp,
                                    int Hp, int Wp, int D, int ws0, int ws1, int ws2, int heads,
                                    float eps, cudaStream_t stream) {
  (void)stats;
  const long long rows = (long long)B * nW * CN;
  if (B <= 0 || nW <= 0 || (D != 256 && D != 512 && D != 1024 && D != 2048) ||
      D != DH * heads || rows > (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (Cp > 0 && (ws0 * ws1 * ws2 != CN || Cp % ws0 || Hp % ws1 || Wp % ws2 ||
                 (Cp / ws0) * (Hp / ws1) * (Wp / ws2) != nW))
    return (int)cudaErrorInvalidValue;
  int err = f32k::launch_gemm_f32<8, f32k::EPI_BIAS>(f32k::Rows{x, D}, wqkv, bqkv, qkv, rows, D,
                                                     3 * D, stream);
  if (err) return err;
  const long long windows = (long long)B * nW;
  if (Cp > 0)
    err = launch_core(qkv, groups, attn, Grid5d{nW, Hp / ws1, Wp / ws2, Cp, Hp, Wp, ws0, ws1, ws2},
                      windows, D, heads, stream);
  else
    err = launch_core(qkv, groups, attn, Packed{nW}, windows, D, heads, stream);
  if (err || !wproj) return err;
  err = f32k::launch_gemm_f32<8, f32k::EPI_BIAS>(f32k::Rows{attn, D}, wproj, bproj, out, rows, D,
                                                 D, stream);
  if (err) return err;
  return f32k::launch_ln_rows_f32(f32k::RowsF32{x}, out, shift, scale, 0.f, (int)rows, 0,
                                  (long long)nW * CN, D, eps, stream);
}

// K7 in float32: qkv (B, nW, 144, 3D) f32 packed (q|k|v) x head x 64 -> out (B, nW, 144, D) f32;
// groups: (nW, 144) int32 or null. One launch: the core on the caller's rows. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int sdpa_windows_f32(const float* qkv, const int* groups, float* out, int B, int nW,
                                int D, int heads, cudaStream_t stream) {
  const long long windows = (long long)B * nW;
  if (B <= 0 || nW <= 0 || D != heads * DH || D % 128 || windows * CN > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return launch_core(qkv, groups, out, Packed{nW}, windows, D, heads, stream);
}
