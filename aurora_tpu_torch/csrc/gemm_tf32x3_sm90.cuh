// A float32 product on Hopper's tensor cores, each operand taken in two TF32 parts so that
// the sum keeps float32's digits: the products of float32 K3 and K8 (mlp_f32.cu), K5
// (mlp_f32.cu), K4 (resampler_f32.cu) and the qkv and proj products of float32 K2 and K6
// (window_attention_f32.cu).
//
// One TF32 product keeps 11 significant bits of each operand (10 of the mantissa), about
// three decimal digits; the float32 bound of a block (9e-5) catches it. Each operand v is
// split as hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest with ties away from
// zero (cvt.rna.tf32.f32's rounding; the tensor cores would ignore an unrounded operand's low
// 13 bits, so an unrounded hi would lose what lo carries), lo = 0 where v is not finite, and
//     acc += a_hi b_hi + a_hi b_lo + a_lo b_hi            (a_lo b_lo, ~2^-22 of a b, dropped)
// in the f32 accumulators: about 22 of float32's 24 bits ("3xTF32"). Three TF32 products run
// at 495 / 3 = 165 TF/s on the H100, 2.46x the 67 TF/s of the FFMA pipes.
//
//   gemm_tf32x3_kernel<EPI>: out = A W (+ bias, + the exact erf GELU) over the rows of A.
//     A, K contiguous: the tokens (fc1, qkv, K5), the hidden (fc2), the attention output
//       (proj), K4's context and its o. Its rows come in groups: `groups` groups of `per`
//       rows, group_stride floats apart (a 3D tensor map (group, row, K)); one group for a
//       plain matrix. K4's context is grouped: a chunk of columns is K levels of Mc rows, M D
//       floats apart, read in place. A row tile never straddles two groups: a group's last
//       tile reads on past its rows (real rows of the next chunk, or zeros past the tensor)
//       and stores none of them. Output row g per + r is row r of group g.
//     W given as its split transpose: (2 N, K) f32, rows 0..N-1 W^T's hi, rows N..2N-1 its
//       lo, K contiguous (split_tf32_t_kernel writes it from W (K, N) as stored; K4's fold
//       writes its folded columns so itself). wgmma takes TF32 operands only K-major, so the
//       (in, out) weight cannot be read as stored the way the bf16 ring reads it (an
//       MN-major operand through the transpose bit, gemm_rows_sm90.cuh).
//     One persistent block an SM (384 threads: a producer warpgroup, two consumer
//     warpgroups); tiles of 128 rows x 128 columns, column tile fastest, round-robin over the
//     blocks; K in steps of BK = 32 floats on a ring of STAGES = 4 stages of 48 KB: A's
//     128 x 128-byte rows (16 KB) and W's hi and lo, 128 x 128-byte rows each (16 KB), three
//     TMA boxes under the 128-byte swizzle (16-byte piece c of row r at piece c ^ (r & 7)).
//     (Steps of 16 floats under the 64-byte swizzle, 8 stages of 24 KB, ran slower.)
//     Consumer warpgroup g owns rows 64 g.. of the tile: per k8 step each thread reads its 4
//     values of A (rows 16 w + q, + 8; k t, t + 4 of the step; q = lane / 4, t = lane % 4:
//     the m64k8 TF32 register fragment), splits them into hi and lo in registers and issues
//     three m64n128k8 wgmma with A from registers (a_hi W_hi, a_hi W_lo, a_lo W_hi), one
//     commit group a step, a register set of A for each of a stage's BK / 8 steps, so that
//     up to BK / 8 groups are in flight while the next step's A is split (with one group in
//     flight each step waited out the previous group's latency).
//     The sums. The tensor cores add each product to the f32 accumulators rounding towards
//     zero, so over a whole K the error has a bias that grows with K: with one accumulator
//     over all of K (-DTF32X3_CHUNK_K=8192, tools/kernel_ablate.py's `one_chunk`) K8 ran
//     8.4e-5 of the output from the full f32 result at K = 8192, against 9e-5 allowed, and
//     2.5e-6 in 128-value chunks (PERF.md). So the wgmma accumulators (64 a thread) sum 128
//     values of k at a time, starting from zero, and each such chunk is added to 64 f32
//     sums in registers with round-to-nearest adds, after a wait for the chunk's last group
//     (the other warpgroup's products keep the tensor cores busy meanwhile). Twice 64
//     registers of sums is why a warpgroup's tile is 64 x 128, not 64 x 256.
//     Epilogue, from the sums straight to device memory (8-byte stores; a quad writes 32
//     contiguous bytes of a row; out's row stride `ld` may exceed N), rows past a group's
//     `per` never stored:
//       EPI_BIAS       out = sum + b                          (fc2, qkv, proj, K5)
//       EPI_BIAS_GELU  out = gelu_erf(sum + b)                (fc1, into the hidden scratch)
//       EPI_PLAIN      out = sum                              (K4's context product, its
//                                                              out-projection)
//     and for the column tiles from `n_store` on (K4 with ln_k: ctx Wc), no value but each
//     row's sum of squares over the tile's 128 columns, into sq (a row's 32 values in each
//     thread, then a quad's four threads by shuffles).
//   split_tf32_t_kernel: W (K, N) -> its transpose's hi and lo (N, K), 32 x 32 tiles through
//     shared memory.
//
// Ring protocol as gemm_sm90.cuh's: full[s] (1 arrival + the stage's bytes; a box that runs
// past the last row arrives filled with zeros and counts whole) and empty[s] (one arrival per
// consumer warp, once the wgmma that read the stage have completed). The producer runs up to
// STAGES stages ahead, across tiles, so the next tile's loads overlap this tile's epilogue.
//
// Bound on the H100: operations, 3 x 2 M K N at 495 TF/s. The bytes from device memory (A,
// the split W, out) are far below it at every shape K2-K6 and K8 take; the bytes from L2 into
// shared memory are not (48 KB a stage: 50 GB a K3 call at stage 1), and one TF32 product a
// step (ABLATE_ONE_PART) runs at 1/3 the tensor work in ~70% of the time (PERF.md). A form
// in clusters of two blocks that multicast W's hi and lo parts to both (half the W traffic)
// ran slower than this one, the pair in lockstep, and was taken out.
//
// tools/kernel_ablate.py builds copies with -DABLATE_ONE_PART (a_hi W_hi alone: one TF32
// product, the accuracy the split buys back) and -DABLATE_NO_SPLIT (the tokens' bits as both
// parts, unrounded: the split's cost).
#pragma once

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace tf32x3 {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int ROW_BYTES = BK * 4;  // 128: the 128-byte swizzle's rows
constexpr int A_BYTES = BM * ROW_BYTES;
constexpr int B_BYTES = BN * ROW_BYTES;  // one part of W
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int STAGES = (200 * 1024) / STAGE_BYTES;
// K steps whose products the wgmma accumulators sum before they are added to the f32 sums
// in registers (128 values of k; -DTF32X3_CHUNK_K= another multiple of BK).
#ifndef TF32X3_CHUNK_K
#define TF32X3_CHUNK_K 128
#endif
constexpr int PROMOTE = TF32X3_CHUNK_K / BK;
static_assert(PROMOTE >= 1 && PROMOTE * BK == TF32X3_CHUNK_K, "whole K steps a chunk");
// Register sets of A, one a k8 step of a stage: up to SETS commit groups in flight.
constexpr int SETS = BK / 8;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 384;  // consumers 0-255, producer warpgroup 256-383
constexpr int BAR_BYTES = 2 * STAGES * 8;
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + BAR_BYTES;
enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_PLAIN = 2 };

// 16-byte piece c of row r under the 128-byte swizzle, and a shared-memory matrix descriptor
// of K-major 128-byte rows (8-row atoms; stride offset 1024; leading offset unused; 128-byte
// swizzle). A k8 step adds 32 bytes to the start address.
__device__ __forceinline__ int swz_piece(int r, int c) { return c ^ (r & 7); }
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return sm90::desc_sw128(addr, 16, 8 * ROW_BYTES);
}

// hi = tf32(v), lo = tf32(v - hi) (0 where v is not finite; hi keeps an inf or a NaN), both to
// nearest with ties away from zero: a finite value's bits plus half the unit of the 13 bits
// dropped, those bits cleared (no carry reaches the sign). Integer and FP32 operations, which
// have room beside the wgmma: the consumers split 8 values a thread a k8 step.
// aurora_tpu_torch/ops/mlp.py::tf32_split gives the same bits.
__device__ __forceinline__ uint32_t tf32_round(uint32_t b) { return (b + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t b = __float_as_uint(v);
  const bool finite = (b & 0x7fffffffu) < 0x7f800000u;
  hi = finite ? tf32_round(b) : b;
  lo = finite ? tf32_round(__float_as_uint(__fsub_rn(v, __uint_as_float(hi)))) : 0u;
}

// d (64 x 128 f32) = A (64 x 8 TF32, registers) B (8 x 128 TF32, K-major in shared memory)
// + (accumulate ? d : 0). A's fragment: a[0] (row q, k t), a[1] (q + 8, t), a[2] (q, t + 4),
// a[3] (q + 8, t + 4), rows 16 w.. for warp w of the warpgroup (CuTe's ALayout_64x8). d:
// d[4j..4j+3] the m16n8 accumulator of columns 8j..8j+7 (rows q and q + 8, columns 2t, 2t + 1),
// as gemm_sm90.cuh's wgmma_m64n256k16 (its first 16 n8 tiles).
__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// A product's schedule: units are (128-row tile, 128-column tile), column tile fastest,
// round-robin over the blocks. A's rows come in `groups` groups of `per` rows (one group for a
// plain matrix); a row tile never straddles two groups, so a group's last tile may run past
// its rows (loaded, never stored). Output row g per + r is the group's row r. Column tiles
// from n_store on are not stored: each row's sum of squares over the tile goes to sq instead.
struct Sched {
  int groups, per, tpg, n_tiles, units, k_steps, n_store, n_sq;
  long long ld;  // out's row stride in floats
};

inline Sched make_sched(int groups, int per, int K, int N, int n_store, long long ld) {
  Sched s;
  s.groups = groups;
  s.per = per;
  s.tpg = (per + BM - 1) / BM;
  s.n_tiles = N / BN;
  s.units = groups * s.tpg * s.n_tiles;
  s.k_steps = K / BK;
  s.n_store = n_store;
  s.n_sq = (N - n_store) / BN;
  s.ld = ld;
  return s;
}

// The unit's group, first row in the group and first column.
struct Unit {
  int g, m0, n0;
  __device__ __forceinline__ Unit(const Sched& s, int u) {
    const int ti = u / s.n_tiles;
    g = ti / s.tpg;
    m0 = (ti - g * s.tpg) * BM;
    n0 = (u - ti * s.n_tiles) * BN;
  }
};

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (STAGES + s);
}

struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Thread (warp w of warpgroup wg, lane) reads its A values of k8 step kk of the stage at
// `a` (the 1024-byte aligned 128-row tile) and splits them: hi[i], lo[i] in the fragment's
// order. Rows 64 wg + 16 w + q (+ 8), pieces 2 kk (k t) and 2 kk + 1 (k t + 4), word t.
__device__ __forceinline__ void load_split_a(const unsigned char* a, int row, int t, int kk,
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row + 8 * (i & 1), c = 2 * kk + (i >> 1);
    const float v = *reinterpret_cast<const float*>(a + r * ROW_BYTES + (swz_piece(r, c) << 4) +
                                                    4 * t);
#ifdef ABLATE_NO_SPLIT
    hi[i] = lo[i] = __float_as_uint(v);
#else
    split(v, hi[i], lo[i]);
#endif
  }
}

// Ties each accumulator to this point of the program: the adds that read them after a
// wgmma wait cannot be scheduled above it (the wait's asm names no registers). Emits nothing.
__device__ __forceinline__ void fence_operands(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// One k8 step: the three products (one with ABLATE_ONE_PART) as one commit group.
__device__ __forceinline__ void mma_step(float (&acc)[64], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], uint32_t b, int kk,
                                         int accumulate) {
  const uint64_t b_hi = desc_k_major(b + 32 * kk), b_lo = desc_k_major(b + B_BYTES + 32 * kk);
  (void)b_lo;
  (void)lo;
  sm90::wgmma_fence();
  wgmma_m64n128k8_rs(acc, hi, b_hi, accumulate);
#ifndef ABLATE_ONE_PART
  wgmma_m64n128k8_rs(acc, hi, b_lo, 1);
  wgmma_m64n128k8_rs(acc, lo, b_hi, 1);
#endif
  sm90::wgmma_commit();
}

// out: (groups per, ld) f32, its first n_store columns written; bias: (N,) f32 (not read under
// EPI_PLAIN); sq: (groups per, n_sq) f32, the sums of squares of the tiles from n_store on (of
// A W + bias under EPI_BIAS).
// map_a: A as (groups, rows, K) in boxes of BK x 128 rows x 1 group; map_w: the split W^T
// (2 N, K) in boxes of BK x 128 rows.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1) gemm_tf32x3_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ sq,
    const Sched s) {
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  const unsigned char* tiles_ptr = raw + (tiles - raw_addr);
  const uint32_t bars = tiles + STAGES * STAGE_BYTES;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full_bar(bars, st), 1);
      sm90::mbar_init(empty_bar(bars, st), CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    sm90::reg_dealloc<40>();
    if (tid != 256) return;
    Pos pos;
    const int N = s.n_tiles * BN;
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const Unit un(s, u);
      for (int ks = 0; ks < s.k_steps; ++ks) {
        sm90::mbar_wait(empty_bar(bars, pos.stage), pos.phase ^ 1);
        const uint32_t bar = full_bar(bars, pos.stage);
        const uint32_t st = tiles + pos.stage * STAGE_BYTES;
        sm90::mbar_arrive_expect_tx(bar, STAGE_BYTES);
        sm90::tma_load_3d(st, &map_a, bar, ks * BK, un.m0, un.g);
        sm90::tma_load_2d(st + A_BYTES, &map_w, bar, ks * BK, un.n0);
        sm90::tma_load_2d(st + A_BYTES + B_BYTES, &map_w, bar, ks * BK, N + un.n0);
        pos.advance();
      }
    }
    return;
  }

  sm90::reg_alloc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane >> 2, t = lane & 3;
  const int row = 64 * wg + 16 * warp + q;  // this thread's first row in the tile (and + 8)
  Pos pos;
  float acc[64], sum[64];
  uint32_t hi[SETS][4], lo[SETS][4];
  for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
    const Unit un(s, u);
    const int n0 = un.n0;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int c0 = 0; c0 < s.k_steps; c0 += PROMOTE) {
      // A chunk of 128 values of k: the wgmma accumulators start from zero.
      const int c1 = min(c0 + PROMOTE, s.k_steps);
      int prev = -1;  // the stage to release once its last group has completed
      for (int ks = c0; ks < c1; ++ks) {
        sm90::mbar_wait(full_bar(bars, pos.stage), pos.phase);
        const unsigned char* a = tiles_ptr + pos.stage * STAGE_BYTES;
        const uint32_t b = tiles + pos.stage * STAGE_BYTES + A_BYTES;
#pragma unroll
        for (int kk = 0; kk < SETS; ++kk) {
          // Register set kk was last read by the group SETS steps back; the wait after the
          // previous step left at most SETS - 1 groups pending, so that one has completed.
          load_split_a(a, row, t, kk, hi[kk], lo[kk]);
          mma_step(acc, hi[kk], lo[kk], b, kk, ks > c0 || kk > 0);
          sm90::wgmma_wait<SETS - 1>();
          // The previous stage's last group is SETS - 1 steps back from step SETS - 2.
          if (kk == SETS - 2 && prev >= 0 && lane == 0)
            sm90::mbar_arrive(empty_bar(bars, prev));
        }
        prev = pos.stage;
        pos.advance();
      }
      // The chunk's products are done: release its last stage and add the chunk to the sums
      // with round-to-nearest adds (the tensor cores' own accumulation rounds towards zero:
      // "The sums" above).
      sm90::wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) sm90::mbar_arrive(empty_bar(bars, prev));
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }

    const int r0 = un.m0 + row;  // rows r0 and r0 + 8 of the unit's group
    const bool w0 = r0 < s.per, w1 = r0 + 8 < s.per;
    const long long o = (long long)un.g * s.per + r0;  // row r0's row of out (and of sq)
    if (n0 >= s.n_store) {
      if constexpr (EPI == EPI_BIAS) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 bj = *reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * t);
          sum[4 * j] += bj.x;
          sum[4 * j + 1] += bj.y;
          sum[4 * j + 2] += bj.x;
          sum[4 * j + 3] += bj.y;
        }
      }
      // Each row's sum of squares over the tile: a thread's 32 values of each of its two rows,
      // then the quad's four threads (t = 0..3) of the row.
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        q0 = fmaf(sum[4 * j], sum[4 * j], q0);
        q0 = fmaf(sum[4 * j + 1], sum[4 * j + 1], q0);
        q1 = fmaf(sum[4 * j + 2], sum[4 * j + 2], q1);
        q1 = fmaf(sum[4 * j + 3], sum[4 * j + 3], q1);
      }
      q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
      float* p = sq + o * s.n_sq + (n0 - s.n_store) / BN;
      if (t == 0 && w0) p[0] = q0;
      if (t == 0 && w1) p[8ll * s.n_sq] = q1;
      continue;
    }
    float* o0 = out + o * s.ld + n0 + 2 * t;
    float* o1 = o0 + 8ll * s.ld;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float2 bj = make_float2(0.f, 0.f);
      if constexpr (EPI != EPI_PLAIN)
        bj = *reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * t);
      float v0 = sum[4 * j] + bj.x, v1 = sum[4 * j + 1] + bj.y;
      float v2 = sum[4 * j + 2] + bj.x, v3 = sum[4 * j + 3] + bj.y;
      if constexpr (EPI == EPI_BIAS_GELU) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
        v2 = gelu_erf(v2);
        v3 = gelu_erf(v3);
      }
      if (w0) *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(v0, v1);
      if (w1) *reinterpret_cast<float2*>(o1 + 8 * j) = make_float2(v2, v3);
    }
  }
}

// W (K, N) f32 as stored -> hi, lo (N, K) f32: the split of W^T. K, N multiples of 32;
// blocks of 32 x 8 threads, one 32 x 32 tile each.
__global__ void __launch_bounds__(256) split_tf32_t_kernel(const float* __restrict__ w,
                                                           float* __restrict__ hi,
                                                           float* __restrict__ lo, int K,
                                                           int N) {
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32, tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    tile[ty + 8 * i][tx] = w[(long long)(k0 + ty + 8 * i) * N + n0 + tx];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h, l;
    split(tile[tx][ty + 8 * i], h, l);
    const long long at = (long long)(n0 + ty + 8 * i) * K + k0 + tx;
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// ------------------------------------------------------------------------------ host
// An f32 tensor map with the inner dimension contiguous, boxes of BK x box_outer (x 1 group)
// under the 128-byte swizzle, zeros outside the tensor: (outer, inner), or with `groups`
// (groups, outer, inner), groups group_stride floats apart.
inline cudaError_t make_map(CUtensorMap* map, const float* base, uint64_t inner, uint64_t outer,
                            uint32_t box_outer, uint64_t groups = 0, uint64_t group_stride = 0) {
  sm90::EncodeTiledFn encode = sm90::encode_tiled_fn();
  if (!encode) return cudaErrorUnknown;
  const cuuint32_t rank = groups ? 3 : 2;
  const cuuint64_t dims[3] = {inner, outer, groups};
  const cuuint64_t strides[2] = {inner * 4, group_stride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)BK, box_outer, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base), dims, strides, box,
      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorUnknown;
}

// W (K, N) as stored -> the split of its transpose: hi (N, K) at hi, lo (N, K) at lo. K, N
// multiples of 32.
inline int launch_split_to(const float* w, float* hi, float* lo, int K, int N,
                           cudaStream_t stream) {
  if (K % 32 || N % 32) return (int)cudaErrorInvalidValue;
  split_tf32_t_kernel<<<dim3(N / 32, K / 32), dim3(32, 8), 0, stream>>>(w, hi, lo, K, N);
  return (int)cudaGetLastError();
}

// The split of W (K, N) into ws (2 N, K): hi rows 0..N-1, lo rows N..2N-1.
inline int launch_split(const float* w, float* ws, int K, int N, cudaStream_t stream) {
  return launch_split_to(w, ws, ws + (long long)N * K, K, N, stream);
}

// The grouped product: A's row r of group g at a + g group_stride + r K (K floats a row; rows
// up to map_rows of a group may be read, rows from `per` on are never stored), W given as its
// split ws (2 N, K). Output row g per + r: its columns 0..n_store-1 EPI(A W + bias) into out
// (row stride ld), and for each 128-column tile from n_store on the row's sum of squares of
// A W (+ bias under EPI_BIAS) over the tile into sq (row stride (N - n_store) / 128). K % BK == 0, N and n_store
// multiples of 128, a, ws, out 16-byte aligned, ld and group_stride multiples of 4. One block
// an SM for the first min(units, SMs).
template <int EPI>
int launch_gemm_grouped(const float* a, int groups, int per, long long map_rows,
                        long long group_stride, const float* ws, const float* bias, float* out,
                        long long ld, int n_store, float* sq, int K, int N, cudaStream_t stream) {
  if (groups <= 0 || per <= 0 || map_rows < per || K % BK || N % BN || n_store % BN ||
      n_store > N || (n_store < N && sq == nullptr) || ld % 4 || group_stride % 4 ||
      (long long)groups * ((per + BM - 1) / BM) * (N / BN) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  cudaError_t e;
  if ((e = make_map(&map_a, a, K, map_rows, BM, groups, group_stride)) != cudaSuccess)
    return (int)e;
  if ((e = make_map(&map_w, ws, K, 2ull * N, BN)) != cudaSuccess) return (int)e;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorUnknown;
  const Sched s = make_sched(groups, per, K, N, n_store, ld);
  cudaFuncSetAttribute(gemm_tf32x3_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM);
  gemm_tf32x3_kernel<EPI><<<s.units < sms ? s.units : sms, THREADS, SMEM, stream>>>(
      map_a, map_w, bias, out, sq, s);
  return (int)cudaGetLastError();
}

// out (rows, N) = EPI(a (rows, K) W + bias), W given as its split ws (2 N, K): one group.
template <int EPI>
int launch_gemm(const float* a, const float* ws, const float* bias, float* out, int rows, int K,
                int N, cudaStream_t stream) {
  return launch_gemm_grouped<EPI>(a, 1, rows, rows, (long long)rows * K, ws, bias, out, N, N,
                                  nullptr, K, N, stream);
}

}  // namespace tf32x3
