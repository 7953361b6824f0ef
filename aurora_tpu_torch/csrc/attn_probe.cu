// K10 attn_probe: the qkv projection and the unmasked attention core on partitioned windows
// (nW, 144, D), in the seven timing modes of the TPU probe. Replaces tools/backbone_ablate.py
// make_probe (pallas_call at :598). The numbers of each mode are
// aurora_tpu_torch/ops/probes.py::attn_probe_plain's.
//
// Bound: operations, the qkv product and the core in bf16 at 989 TF/s (stage 1 of the 0.25
// degree model: 0.41 + 0.08 + 0.08 TFLOP, 0.49 ms; no_core 0.41 ms).
//
// Design: K6 without its tail and mask, on the same shared headers, with the probe's
// modes as compile-time forms of its core:
//   1. qkv: gemm_bias_kernel<EPI_QKV> (gemm_rows_sm90.cuh) over the 144 nW token rows, Wqkv
//      (D, 3D) read as stored, the bf16 bias between two roundings, into the (rows, 3D)
//      scratch, exactly as K6 launches it. no_core stops here: the wrapper returns the
//      scratch's first D columns (the TPU mode computed the whole product too).
//   2. core: K7's ring kernel (sdpa_sm90.cuh) on the scratch's packed rows, unmasked, with
//      the weights in one of three forms (attention_core.cuh): the f32 softmax (baseline,
//      batched_heads), the scaled logits rounded (no_softmax), or the softmax rounded to
//      bf16 at every step (bf16_core, bf16_batched). The TPU kernel's per-head loop is the
//      ring's unit (window, head); its "all heads at once" forms (batched_heads,
//      bf16_batched) make a window the unit: a block's run of units is whole windows, each
//      walking its heads with the same per-head arithmetic. So batched_heads gives
//      baseline's bits, bf16_batched bf16_core's, and baseline K6-without-tail's.
//   fulld (one head as wide as D, scale 1/8): a core of its own on wgmma (fulld_core_kernel
//      below), since q, k and v of a window (442 KB at D = 512) do not fit a block.
//
// tools/kernel_ablate.py builds copies with -DABLATE_ONLY_QKV (launch 1 alone) and
// -DABLATE_ONLY_CORE (launch 2 alone, on what the scratch holds).
#include "gemm_rows_sm90.cuh"
#include "sdpa_sm90.cuh"

namespace {

// d (the warpgroup's 64 query rows x 144 keys, f32; d[j][0..3] the m16n8 fragment of keys
// 8j..8j+7, as the mma.sync core's logits) += A (64 x 16, K-major: q) B (16 x 144, K-major:
// the keys as stored, [token][feature]).
__device__ __forceinline__ void wgmma_m64n144k16(float (&d)[18][4], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1, 0, 0;\n"  // A and B K-major
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 f32, d[j][0..3] the m16n8 fragment of columns 8j..8j+7) = A (64 x 16 from
// registers: each warp's 16 rows as an mma.sync m16n8k16 A fragment) B (16 x 64, MN-major:
// v as stored, [token][feature]) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"  // B MN-major
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// fulld: one block an SM walks windows. Three consumer warpgroups own 64 query rows each
// (144 = 64 + 64 + 16: the third multiplies 48 rows that are never stored); warpgroup 3's
// first thread is the producer of a ring of FD_STAGES stages. Per window:
//   * D / 64 stages of (q, k) chunks of 64 features (TMA boxes {64, 144} of the packed rows):
//     the logits s (64 x 144 f32 a warpgroup, 72 registers a thread, the mma.sync core's
//     fragment layout) accumulate over the head dim by wgmma m64n144k16, A = q and B = k
//     both as stored (K-major);
//   * the softmax once (core_softmax: f32, base 2, one reciprocal a row; a row's 144 keys
//     lie in one quad), the weights rounded into A fragments in registers (core_pack);
//   * D / 64 stages of v chunks: o = w @ v by wgmma m64n64k16 with A from registers and B =
//     v as stored (MN-major), stored rounded as 64 columns of the window's rows.
// Nothing of a window is held beyond one chunk: k and v stream through the ring.
constexpr int FD_Q_BYTES = 192 * 128;  // 144 rows loaded; the third warpgroup reads 48 more
constexpr int FD_STAGE_BYTES = FD_Q_BYTES + CORE_TILE_BYTES;  // 43,008
constexpr int FD_STAGES = 4;
constexpr int FD_CONSUMER_WARPS = 12;
constexpr int FD_THREADS = 512;
constexpr size_t FD_SMEM = 1024 + FD_STAGES * FD_STAGE_BYTES + 2 * FD_STAGES * 8;

__global__ void __launch_bounds__(FD_THREADS, 1) fulld_core_kernel(
    const __grid_constant__ CUtensorMap map_qkv, bf16* __restrict__ out, int nW, int D) {
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  const uint32_t bars = tiles + FD_STAGES * FD_STAGE_BYTES;  // full[s], then empty[s]
  const int tid = threadIdx.x, chunks = D / 64;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (FD_STAGES + s); };
  if (tid == 0) {
    for (int s = 0; s < FD_STAGES; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), FD_CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == FD_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  if (tid >= 384) {
    sm90::reg_dealloc<24>();
    if (tid != 384) return;
    for (int w = blockIdx.x; w < nW; w += gridDim.x) {
      for (int c = 0; c < 2 * chunks; ++c) {
        sm90::mbar_wait(empty(stage), phase ^ 1);
        const uint32_t dst = tiles + stage * FD_STAGE_BYTES;
        if (c < chunks) {  // q and k of features 64c..
          sm90::mbar_arrive_expect_tx(full(stage), 2 * CORE_TILE_BYTES);
          sm90::tma_load_2d(dst, &map_qkv, full(stage), 64 * c, w * CORE_N);
          sm90::tma_load_2d(dst + FD_Q_BYTES, &map_qkv, full(stage), D + 64 * c, w * CORE_N);
        } else {  // v of features 64 (c - chunks)..
          sm90::mbar_arrive_expect_tx(full(stage), CORE_TILE_BYTES);
          sm90::tma_load_2d(dst, &map_qkv, full(stage), 2 * D + 64 * (c - chunks), w * CORE_N);
        }
        advance();
      }
    }
    return;
  }

  sm90::reg_alloc<160>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = wg * 64 + warp * 16 + gq;  // this thread's query rows r0 and r0 + 8
  const uint64_t no_mask[2] = {0, 0};
  for (int w = blockIdx.x; w < nW; w += gridDim.x) {
    float s[18][4];
    int prev = -1;
    for (int c = 0; c < chunks; ++c) {
      sm90::mbar_wait(full(stage), phase);
      const uint32_t q = tiles + stage * FD_STAGE_BYTES, k = q + FD_Q_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n144k16(s, sm90::desc_sw128(q + wg * 8192 + kk * 32, 16, 1024),
                         sm90::desc_sw128(k + kk * 32, 16, 1024), c | kk);
      sm90::wgmma_commit();
      if (prev >= 0) {
        sm90::wgmma_wait<1>();
        if (lane == 0) sm90::mbar_arrive(empty(prev));
      }
      prev = stage;
      advance();
    }
    sm90::wgmma_wait<0>();
    if (lane == 0) sm90::mbar_arrive(empty(prev));

    float inv0, inv1;
    core_softmax<false>(s, no_mask, inv0, inv1);
    uint32_t wf[9][4];
    core_pack(wf, s, inv0, inv1);

    for (int c = 0; c < chunks; ++c) {
      sm90::mbar_wait(full(stage), phase);
      const uint32_t v = tiles + stage * FD_STAGE_BYTES;
      float o[8][4];
      sm90::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 9; ++kt)
        wgmma_m64n64k16_rs(o, wf[kt], sm90::desc_sw128(v + kt * 2048, 8192, 1024), kt);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(empty(stage));
      advance();
      bf16* dst = out + ((long long)w * CORE_N + r0) * D + 64 * c + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (r0 < CORE_N)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16x2(o[j][0], o[j][1]);
        if (r0 + 8 < CORE_N)
          *reinterpret_cast<uint32_t*>(dst + 8 * D + 8 * j) = pack_bf16x2(o[j][2], o[j][3]);
      }
    }
  }
}

int launch_fulld(const CUtensorMap& map, bf16* out, int nW, int D, cudaStream_t stream) {
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorUnknown;
  cudaFuncSetAttribute(fulld_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)FD_SMEM);
  fulld_core_kernel<<<nW < sms ? nW : sms, FD_THREADS, FD_SMEM, stream>>>(map, out, nW, D);
  return (int)cudaGetLastError();
}

}  // namespace

// K10. x: (nW, 144, D) bf16 windows; wqkv: (D, 3D) bf16 as stored; bqkv: (3D,) bf16; qkv:
// scratch (nW 144, 3D) bf16, no_core's result in its first D columns; out: (nW, 144, D) bf16
// (unused by no_core). heads = D / 64. mode: 0 baseline, 1 no_softmax, 2 no_core, 3 fulld,
// 4 bf16_core, 5 batched_heads, 6 bf16_batched. D % 256 == 0. Returns cudaGetLastError() of
// the last launch, cudaErrorInvalidValue for a shape or mode it does not take, or
// cudaErrorUnknown where no tensor map could be encoded.
extern "C" int attn_probe(const void* x, const void* wqkv, const void* bqkv, void* qkv, void* out,
                          int nW, int D, int heads, int mode, cudaStream_t stream) {
  const long long rows = (long long)nW * CORE_N;
  if (nW <= 0 || D <= 0 || D % 256 || D != 64 * heads || rows > (1 << 24) || mode < 0 ||
      mode > 6)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  int err;
#ifndef ABLATE_ONLY_CORE
  CUtensorMap map_x, map_w;
  if ((e = RowsRing::make_map_a(&map_x, x, (int)rows, D, (int)rows)) != cudaSuccess) return (int)e;
  if ((e = RowsRing::make_map_w(&map_w, wqkv, D, 3 * D)) != cudaSuccess) return (int)e;
  err = launch_gemm_bias<EPI_QKV>(map_x, map_w, bqkv, static_cast<bf16*>(qkv), nullptr, 3 * D,
                                  make_sched((int)rows, D, 3 * D), stream);
  if (err) return err;
#endif
#ifdef ABLATE_ONLY_QKV
  return (int)cudaSuccess;
#endif
  if (mode == 2) return (int)cudaSuccess;
  CUtensorMap map;
  if ((e = make_map_packed(&map, qkv, rows, D)) != cudaSuccess) return (int)e;
  bf16* ob = static_cast<bf16*>(out);
  const PackedRows win{D};
  const int units = nW * heads;
  switch (mode) {
    case 0: return launch_sdpa<PackedRows, CORE_SOFTMAX>(map, win, nullptr, ob, nW, D, heads,
                                                         units, stream);
    case 1: return launch_sdpa<PackedRows, CORE_NO_SOFTMAX>(map, win, nullptr, ob, nW, D, heads,
                                                            units, stream);
    case 3: return launch_fulld(map, ob, nW, D, stream);
    case 4: return launch_sdpa<PackedRows, CORE_SOFTMAX_BF16>(map, win, nullptr, ob, nW, D,
                                                              heads, units, stream);
    case 5: return launch_sdpa<PackedRows, CORE_SOFTMAX>(map, win, nullptr, ob, nW, D, heads,
                                                         units, stream, heads);
    default: return launch_sdpa<PackedRows, CORE_SOFTMAX_BF16>(map, win, nullptr, ob, nW, D,
                                                               heads, units, stream, heads);
  }
}
