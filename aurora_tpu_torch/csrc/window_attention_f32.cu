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
// The qkv and proj products each as three TF32 products (gemm_tf32x3_sm90.cuh: about 22 of
// float32's 24 bits), the core's products in f32 FMAs.
//
// Bound on the H100 (stage 1 of the 0.25 degree model, 259,200 rows of D = 512): the qkv
// (0.41 TFLOP) and proj (0.14) products as three TF32 products at 495 TF/s, 2.47 + 0.82 ms, and
// the core's 0.08 TFLOP at the FFMA pipes' 67 TF/s, 1.14 ms: 4.44 ms a K2 / K6 call with the
// tail (all at 67 TF/s: 9.2 ms); K7 alone 1.13 ms of operations against 0.63 ms of bytes.
//
// Design: six launches with the tail, three without, one for K7, on the caller's stream:
//   1. qkv: split_tf32_t_kernel writes Wqkv^T's hi and lo (3D, D each) into wsplit, then
//      gemm_tf32x3_kernel<EPI_BIAS> (gemm_tf32x3_sm90.cuh: a persistent TMA + wgmma ring,
//      each product a_hi w_hi + a_hi w_lo + a_lo w_hi, the tokens split in registers, the sums
//      promoted to f32 every 128 values of k) over the token rows in their stored order (K2:
//      the padded grid's rows; K6: the packed windows), into a (rows, 3D) f32 scratch (1.6 GB
//      at stage 1). Only the core reads through a row map;
//   2. core: window_core_f32<Map>, one block of 8 warps a (window, head), head fastest, two
//      blocks an SM, so that one block's loads and stores run under the other's products. The
//      row map gives the row of token t of window w: Grid5d (K2) the token's row of the
//      padded 5D grid, Packed (K6, K7) w 144 + t.
//      - Loads: the window's q, k and v (144 x 64 each, 110.6 KB, no padding) come by 16-byte
//        cp.async copies through the map, q and k as one group, v as a second that lands
//        under the logits. q's and k's 16-byte chunks are swizzled within their row
//        (q_chunk, k_chunk below) and v is kept as stored, so that every read below takes
//        the fewest bank passes.
//      - Logits: warp w takes queries 18 w .. 18 w + 17; lane = 16 half + kg the 9 queries
//        18 w + 9 half + i and the 9 keys kg + 16 c, 81 sums in registers (no idle lane),
//        over d by 16-byte reads of k (16 lanes, 16 keys) and of q (broadcast), in two passes
//        of the keys (c < 5, then c >= 5) to keep the registers under two blocks' share.
//      - Softmax as the bf16 core runs it (attention_core.cuh): t = s (log2 e / 8) + (0 or
//        -100 log2 e) by group id, the row's max and sum by shuffles over the 16 lanes of the
//        half, p = exp2(t - max), weights p (1 / sum), one reciprocal a row.
//      - w @ v, a third of the keys (48) at a time: the warp's own 18 rows of q and of k, which
//        no warp reads any more, take its weights (18 x 48 floats a third: keys 0-47 in q's
//        rows, 48-95 in k's, then 96-143 in q's again); each lane accumulates 9 rows x 4
//        features over the keys in order, from broadcast 16-byte reads of the weights and
//        16-byte reads of v.
//      - Each token's result goes to its own row, through the map, in 16-byte stores. Pad
//        tokens are rows like any other; in masked blocks their own group id keeps them apart.
//      112,320 bytes of shared memory a block (q, k, v, the rows and the group ids), at most
//      128 registers a thread (__launch_bounds__(256, 2)).
//      The core keeps its FFMA products (64 and 144 deep per (window, head)): it took 4-15% of
//      a launch at the three stages before qkv and proj moved to the tensor cores, 15-35%
//      after (PERF.md §5);
//   3. tail, proj: split_tf32_t_kernel writes Wproj^T's hi and lo (D, D each) into wsplit
//      behind Wqkv's, then gemm_tf32x3_kernel<EPI_BIAS> over attn's rows into out;
//   4. tail, rows: ln_rows_f32_kernel with the block input x as the residual and FiLM row
//      row / (nW 144), in place in out.
// The weights' split is made anew every call (it moves each weight's bytes three times; no
// cache to go stale under training or a served model's load): TF32 wgmma takes its
// shared-memory operand only K-major, which the stored (in, out) weight is not. qkv and the
// attention output each make a round trip through device memory, as in the bf16 form
// (window_attention.cu), at twice its bytes.
// K2 and K6 run one core and the same products on the same rows in another order, so K6 on
// window_partition(x), reversed, gives K2's bits on x.
//
// window_attention_f32 has the C signature of window_attention.cu's window_attention with the
// split scratch wsplit before the stream (stats is not used: the row kernel takes the
// LayerNorm statistics over the row it holds) and, as it, is K2 for Cp > 0 and K6 for Cp == 0;
// sdpa_windows_f32 has sdpa.cu's sdpa_windows'.
//
// tools/kernel_ablate.py builds copies with -DWINDOW_F32_FFMA (the products on gemm_f32.cuh's
// FFMA kernel, the design before the tensor cores; wsplit unused), -DABLATE_ONE_PART (the
// header's: a_hi w_hi alone, one TF32 product), -DABLATE_ONLY_QKV (launch 1 alone, with its
// split), -DABLATE_ONLY_CORE (launch 2 alone, on what the qkv scratch holds) and
// -DABLATE_ONLY_TAIL (launches 3-4 alone, on what attn holds); ONLY_CORE with
// -DABLATE_NO_LOADS runs the core without its copies of q, k and v (what the loads cost).
// Everything the entries use of the core lives in the anonymous namespace below, which the
// tool can take from another version of this file.
#include "gemm_f32.cuh"
#include "gemm_tf32x3_sm90.cuh"

namespace {

constexpr int CN = 144, DH = 64, CORE_WARPS = 8, ROWS = CN / CORE_WARPS;  // 18 queries a warp
constexpr int CORE_THREADS = 32 * CORE_WARPS;
constexpr int TILE4 = CN * DH / 4;  // 16-byte chunks of one of q, k, v
constexpr size_t CORE_SMEM =
    3 * TILE4 * sizeof(float4) + CN * sizeof(long long) + CN * sizeof(int);

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

// Where chunk c4 (4 floats) of token t sits in its tile, in chunks (tests/test_torch_f32_core.py
// mirrors the maps). k: t 16 + (c4 ^ (t & 7)), so the 16 keys kg + 16 c of a read take each
// bank group twice (the least for 256 bytes). q: t 16 + (c4 ^ 4 h), h = (t % 18 >= 9) the half
// of the warp that reads row t, so the two rows a warp reads at once never share a bank group
// and a row's address is the same offset from the half's first row for every row. v is not
// swizzled: 16 lanes read one key's 256 bytes.
__device__ __forceinline__ int k_chunk(int t, int c4) { return t * 16 + (c4 ^ (t & 7)); }
__device__ __forceinline__ int q_chunk(int t, int c4) {
  return t * 16 + (c4 ^ (t % ROWS >= ROWS / 2 ? 4 : 0));
}

// s[i][C0 + c] = q[r0 + i] . k[kg + 16 (C0 + c)] for i < 9, c < NC, summed over d in order;
// qrow: row r0 of q, qx = 4 h.
template <int C0, int NC>
__device__ __forceinline__ void logits(float (&s)[9][9], const float4* qrow, const float4* ks,
                                       int qx, int kg) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) s[i][C0 + c] = 0.f;
  const int kx = kg & 7;
#pragma unroll 1
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    float4 kv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) kv[c] = ks[(kg + 16 * (C0 + c)) * 16 + (d4 ^ kx)];
    const int dq = d4 ^ qx;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float4 q = qrow[i * 16 + dq];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float a = s[i][C0 + c];
        a = fmaf(q.x, kv[c].x, a);
        a = fmaf(q.y, kv[c].y, a);
        a = fmaf(q.z, kv[c].z, a);
        a = fmaf(q.w, kv[c].w, a);
        s[i][C0 + c] = a;
      }
    }
  }
}

// The lane's weights of keys 48 T .. 48 T + 47 to pw: row i at float i 64, key kg + 16 c.
template <int T>
__device__ __forceinline__ void stage(float* pw, const float (&s)[9][9], int kg) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) pw[i * 64 + kg + 16 * c] = s[i][3 * T + c];
}

// o[i] += sum over keys 48 T + j (j < 48, in order) of pw[i 64 + j] v[key][4 dq .. 4 dq + 3].
template <int T>
__device__ __forceinline__ void weights_v(float4 (&o)[9], const float* pw, const float4* vs,
                                          int dq) {
#pragma unroll 1
  for (int j = 0; j < 48; j += 4) {
    float4 vv[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) vv[jj] = vs[(48 * T + j + jj) * 16 + dq];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(pw + i * 64 + j);
      const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        o[i].x = fmaf(pj[jj], vv[jj].x, o[i].x);
        o[i].y = fmaf(pj[jj], vv[jj].y, o[i].y);
        o[i].z = fmaf(pj[jj], vv[jj].z, o[i].z);
        o[i].w = fmaf(pj[jj], vv[jj].w, o[i].w);
      }
    }
  }
}

// qkv: (rows, 3 D) f32; groups: (nW, 144) int32 or null; attn: (rows, D) f32; both read and
// written through the map g (Grid5d or Packed).
template <class Map>
__global__ void __launch_bounds__(CORE_THREADS, 2) window_core_f32(
    const float* __restrict__ qkv, const int* __restrict__ groups, float* __restrict__ attn,
    const Map g, int D, int heads) {
  extern __shared__ __align__(16) float4 sm4[];
  float4* qs = sm4;         // [CN][16] chunks, q_chunk
  float4* ks = qs + TILE4;  // k_chunk
  float4* vs = ks + TILE4;  // as stored
  long long* rowof = reinterpret_cast<long long*>(vs + TILE4);  // [CN]
  int* gid = reinterpret_cast<int*>(rowof + CN);                 // [CN]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long window = blockIdx.x / heads;
  const int h = (int)(blockIdx.x - window * heads);
  const long long ld = 3ll * D;

  for (int t = tid; t < CN; t += CORE_THREADS) {
    rowof[t] = g.row(window, t);
    gid[t] = groups ? groups[(window % g.nW) * CN + t] : 0;
  }
  __syncthreads();
  // q and k as the first group of copies, v as the second; token t's 16 chunks on 16
  // neighbouring lanes.
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    for (int i = tid; i < TILE4; i += CORE_THREADS) {
      const int t = i >> 4, c4 = i & 15;
      const int at = part * TILE4 + (part == 0 ? q_chunk(t, c4) : part == 1 ? k_chunk(t, c4)
                                                                              : t * 16 + c4);
#ifndef ABLATE_NO_LOADS  // kernel_ablate: the core on whatever shared memory holds
      f32k::cp_async16(reinterpret_cast<float*>(sm4 + at),
                       qkv + rowof[t] * ld + part * D + h * DH + 4 * c4, true);
#endif
    }
    if (part > 0) f32k::cp_async_commit();
  }
  f32k::cp_async_wait<1>();
  __syncthreads();

  // Logits: lane = 16 half + kg, queries r0 + i (i < 9), keys kg + 16 c (c < 9).
  const int half = lane >> 4, kg = lane & 15;
  const int r0 = ROWS * warp + (ROWS / 2) * half;
  float s[9][9];
  logits<0, 5>(s, qs + r0 * 16, ks, 4 * half, kg);
  logits<5, 4>(s, qs + r0 * 16, ks, 4 * half, kg);

  // Softmax in base 2 over each row's 144 keys, held by the 16 lanes of the half.
  constexpr float SCALE = 0.18033688011112042f;  // log2(e) / 8
  constexpr float MASKED = -144.26950408889634f;  // -100 log2(e)
  int gk[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) gk[c] = gid[kg + 16 * c];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int gi = gid[r0 + i];
    float mx = -3.0e38f;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      s[i][c] = fmaf(s[i][c], SCALE, gk[c] == gi ? 0.f : MASKED);
      mx = fmaxf(mx, s[i][c]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      s[i][c] = exp2f(s[i][c] - mx);
      sum += s[i][c];
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = __frcp_rn(sum);
#pragma unroll
    for (int c = 0; c < 9; ++c) s[i][c] *= inv;
  }

  // v has landed, and no warp reads q or k any more.
  f32k::cp_async_wait<0>();
  __syncthreads();

  // w @ v, a third of the keys at a time: the warp's own 18 rows of q take the weights of keys
  // 0-47, then of 96-143; its 18 rows of k those of keys 48-95. Row i of half h at float
  // h (9 64 + 16) + i 64 of the region, so the two halves never share a bank. Lane = 16 half +
  // dq accumulates rows r0 + i and features 4 dq .. 4 dq + 3 in key order.
  float* pq = reinterpret_cast<float*>(qs + ROWS * 16 * warp) + half * ((ROWS / 2) * 64 + 16);
  float* pk = reinterpret_cast<float*>(ks + ROWS * 16 * warp) + half * ((ROWS / 2) * 64 + 16);
  const int dq = kg;
  float4 o[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  stage<0>(pq, s, kg);
  stage<1>(pk, s, kg);
  __syncwarp();
  weights_v<0>(o, pq, vs, dq);
  weights_v<1>(o, pk, vs, dq);
  __syncwarp();
  stage<2>(pq, s, kg);
  __syncwarp();
  weights_v<2>(o, pq, vs, dq);
#pragma unroll
  for (int i = 0; i < 9; ++i)
    *reinterpret_cast<float4*>(attn + rowof[r0 + i] * D + h * DH + 4 * dq) = o[i];
}

// The core over `windows` windows of the map g, one block a (window, head).
template <class Map>
int launch_core(const float* qkv, const int* groups, float* attn, const Map& g, long long windows,
                int D, int heads, cudaStream_t stream) {
  if (windows * heads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(window_core_f32<Map>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)CORE_SMEM);
  // the largest shared-memory carveout, so that two blocks fit an SM
  cudaFuncSetAttribute(window_core_f32<Map>, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  window_core_f32<Map><<<(unsigned)(windows * heads), CORE_THREADS, CORE_SMEM, stream>>>(
      qkv, groups, attn, g, D, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// out (rows, N) = a (rows, K) W + bias for W (K, N) f32 as stored: W^T's split written into
// ws (2 N K f32), then the three-part TF32 product; with -DWINDOW_F32_FFMA the FFMA product
// (ws unused). Outside the anonymous namespace, which kernel_ablate may take from an older file.
static int product(const float* a, const float* w, float* ws, const float* bias, float* out,
                   long long rows, int K, int N, cudaStream_t stream) {
#ifdef WINDOW_F32_FFMA
  (void)ws;
  return f32k::launch_gemm_f32<8, f32k::EPI_BIAS>(f32k::Rows{a, K}, w, bias, out, rows, K, N,
                                                  stream);
#else
  const int err = tf32x3::launch_split(w, ws, K, N, stream);
  if (err) return err;
  return tf32x3::launch_gemm<tf32x3::EPI_BIAS>(a, ws, bias, out, (int)rows, K, N, stream);
#endif
}

// K2 (Cp > 0) and K6 (Cp == 0) in float32. K2: x, attn, out (B, Cp, Hp, Wp, D) f32 with
// windows (ws0, ws1, ws2) in place; K6: x, attn, out (B, nW, 144, D) f32 (Hp, Wp and ws are
// not read). wqkv: (D, 3D) f32 as stored; bqkv: (3D,) f32; groups: (nW, 144) int32 or null
// (nW windows a batch element); qkv: scratch (rows, 3D) f32. With wproj set, the tail: wproj
// (D, D) f32 as stored, bproj (D,) f32, shift/scale (B, D) f32, the result in out; without it
// (wproj null) the result is attn and out is unused. stats is not used. wsplit: scratch of
// 8 D^2 f32, Wqkv^T's hi and lo (3D, D each), then Wproj^T's (D, D each), written and read by
// this call. x, attn, out, wsplit 16-byte aligned. D in {256, 512, 1024, 2048}, D = 64 heads.
// Returns cudaGetLastError() of the last launch, cudaErrorInvalidValue for a shape it does not
// take, or cudaErrorUnknown where no tensor map could be encoded.
extern "C" int window_attention_f32(const float* x, const float* wqkv, const float* bqkv,
                                    const int* groups, const float* wproj, const float* bproj,
                                    const float* shift, const float* scale, float* qkv,
                                    float* attn, float* stats, float* out, int B, int nW, int Cp,
                                    int Hp, int Wp, int D, int ws0, int ws1, int ws2, int heads,
                                    float eps, float* wsplit, cudaStream_t stream) {
  (void)stats;
  const long long rows = (long long)B * nW * CN;
  if (B <= 0 || nW <= 0 || (D != 256 && D != 512 && D != 1024 && D != 2048) ||
      D != DH * heads || rows > (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (Cp > 0 && (ws0 * ws1 * ws2 != CN || Cp % ws0 || Hp % ws1 || Wp % ws2 ||
                 (Cp / ws0) * (Hp / ws1) * (Wp / ws2) != nW))
    return (int)cudaErrorInvalidValue;
  float* const wproj_split = wsplit + 6ll * D * D;  // behind Wqkv^T's hi and lo
  int err = 0;
#if !defined(ABLATE_ONLY_CORE) && !defined(ABLATE_ONLY_TAIL)
  err = product(x, wqkv, wsplit, bqkv, qkv, rows, D, 3 * D, stream);
  if (err) return err;
#endif
#ifdef ABLATE_ONLY_QKV
  return err;
#endif
#ifndef ABLATE_ONLY_TAIL
  const long long windows = (long long)B * nW;
  if (Cp > 0)
    err = launch_core(qkv, groups, attn, Grid5d{nW, Hp / ws1, Wp / ws2, Cp, Hp, Wp, ws0, ws1, ws2},
                      windows, D, heads, stream);
  else
    err = launch_core(qkv, groups, attn, Packed{nW}, windows, D, heads, stream);
#endif
#ifdef ABLATE_ONLY_CORE
  return err;
#endif
  if (err || !wproj) return err;
  err = product(attn, wproj, wproj_split, bproj, out, rows, D, D, stream);
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

// Blocks of the core that one SM holds at once, as the runtime computes it for this build
// (kernel_ablate prints it beside the times). Uses only names that every version of the
// namespace above has.
extern "C" int window_core_f32_blocks_per_sm(int* blocks) {
  cudaFuncSetAttribute(window_core_f32<Packed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)CORE_SMEM);
  cudaFuncSetAttribute(window_core_f32<Packed>, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, window_core_f32<Packed>,
                                                           CORE_THREADS, CORE_SMEM);
}
