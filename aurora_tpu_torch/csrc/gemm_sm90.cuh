// A bf16 GEMM mainloop for Hopper: a ring of shared-memory stages that one producer thread
// fills by TMA and that consumer warpgroups multiply with wgmma, f32 sums in registers.
// A kernel puts its own tile walk and epilogue around it: gemm.cu (K12) and mlp.cu (K3, K8:
// two products with a GELU and a LayerNorm-statistics epilogue); the fused projection and
// attention kernels are meant to take it with their epilogues.
//
// The tile of one block is 2 x 64 rows x BN columns, K in steps of 64:
//   A  (rows x K, K contiguous): two TMA boxes of 64 k x 64 rows per stage, one for each
//      consumer warpgroup, 128-byte rows under the 128-byte swizzle: a K-major wgmma
//      operand. The two boxes need not be neighbours in memory. The map has three dimensions
//      (k, row in the row block, row block), so that a box that runs over the end of a row
//      block is filled with zeros there and never reads the next block's rows.
//   B  (K x N as stored, N contiguous): BN / 64 TMA boxes of 64 n x 64 k per stage, each
//      row one k with 64 n = 128 bytes, swizzled: an MN-major operand, which wgmma takes
//      for bf16 through the instruction's transpose bit. No transposed copy of the weight.
// Two consumer warpgroups each own 64 rows of the tile: m64nBNk16, four per K step, with
// 128 f32 accumulators a thread at BN = 256. A stage is 48 KB at BN = 256.
//
// Shared-memory matrix descriptors (64 bits: start address >> 4 in bits 0-13, leading byte
// offset >> 4 in 16-29, stride byte offset >> 4 in 32-45, swizzle mode in 62-63, 1 = 128 B):
//   K-major A: 8 rows x 128 bytes form a 1024-byte swizzle atom; stride offset 1024 (the
//      next 8 rows), leading offset unused; a k16 step adds 32 bytes to the start address.
//   MN-major B: 8 k x 128 bytes (64 n) form the atom; stride offset 1024 (the next 8 k),
//      leading offset 8192 (the next 64 n: the next box); a k16 step adds 2048 bytes.
// Every stage and box starts on a 1024-byte boundary, as the swizzle requires.
//
// The operand forms are template parameters of the ring (A_MN, B_MN); the form above,
// GemmRing<S> = GemmRing<S, false, true>, is every kernel's but K9's. K9 (mlp_t.cu) makes
// the WEIGHT the A operand and the tokens the N dimension, so both of its forms have an
// MN-major A:
//   MN-major A (A_MN): warpgroup g's box is 64 m x 64 k of a weight W (K x M) as stored,
//      columns m0 + 64 g..: each row one k with 64 m = 128 bytes, swizzled. The atom is
//      8 k x 64 m; stride offset 1024 (the next 8 k), leading offset the next 64 m (one box:
//      unused at m64); a k16 step adds 2048 bytes. wgmma's transpose bit for A is set.
//   K-major B (!B_MN): the tokens as stored, (N x K, K contiguous): one box of up to 256 rows
//      (n) x 64 k, 128-byte rows under the swizzle, as the K-major A: stride offset 1024,
//      a k16 step adds 32 bytes, transpose bit clear.
// The producer of those forms is produce_step_wa; the caller loads B's part of the stage.
// mlp_grad.cu (K3's input gradient) takes GemmRing<S, false, false>: the tokens K-major as
// A, and as B a weight W (N, K) as stored, so that its products run through W^T: produce_step
// loads B as one box of BN n x 64 k (make_map_wk); the descriptors are the K-major B above.
//
// Ring protocol: full[s] (1 arrival + the stage's bytes) and empty[s] (one arrival per
// consumer warp, after the warp's wgmma reading the stage have completed). The producer
// runs ahead by up to STAGES stages, across tiles. The consumers keep one wgmma group in
// flight: the group of step k is committed before the group of step k - 1 is waited for.
#pragma once

#include "common.cuh"
#include "tma_sm90.cuh"

namespace sm90 {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers per thread: consumers take what the producer warpgroup gives up. Each must be
// reached by its whole warpgroup, inside the one if / else that separates the roles.
template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t leading_bytes,
                                               uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(leading_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (1ull << 62);
}

// d (64 x 256 f32, 128 registers a thread) = A (64 x 16, K-major) B (16 x 256, MN-major)
// + (accumulate ? d : 0). Thread layout of d: warp w of the warpgroup holds rows 16w..16w+15;
// d[4j..4j+3] are the m16n8 accumulator of columns 8j..8j+7 (rows g and g + 8, columns 2t,
// 2t + 1 with g = lane / 4, t = lane % 4).
// TA, TB: the transpose bits (0 K-major, 1 MN-major); A K-major and B MN-major by default.
template <int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"  // scale-a, scale-b = 1; the transpose bits
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// The ring of a (2 x 64) x 256 tile with K steps of 64. `tiles` is the 1024-byte aligned
// shared-space address of STAGES stages of STAGE_BYTES; `bars` that of 2 STAGES mbarriers
// (8 bytes each): full[0..STAGES), then empty[0..STAGES).
template <int STAGES_, bool A_MN = false, bool B_MN = true>
struct GemmRing {
  static constexpr int BM = 128, BN = 256, BK = 64, STAGES = STAGES_;
  static constexpr int CONSUMER_WARPS = 8;         // two warpgroups of 64 rows each
  static constexpr int A_BOX_BYTES = 64 * BK * 2;  // 8 KB: 64 rows (A_MN: 64 k) of 128 bytes
  static constexpr int A_BYTES = 2 * A_BOX_BYTES;
  static constexpr int B_BOX_BYTES = BK * 64 * 2;  // 8 KB: 64 k of 64 n (!B_MN: 64 n of 64 k)
  static constexpr int B_BYTES = B_BOX_BYTES * (BN / 64);
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_BYTES = 2 * STAGES * 8;

  // Where a thread stands in the ring; producer and consumers each keep their own.
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

  __device__ static uint32_t full(uint32_t bars, int s) { return bars + 8 * s; }
  __device__ static uint32_t empty(uint32_t bars, int s) { return bars + 8 * (STAGES + s); }

  // One thread, before the block's first barrier.
  __device__ static void init(uint32_t bars) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(bars, s), 1);
      mbar_init(empty(bars, s), CONSUMER_WARPS);
    }
    mbar_fence_init();
  }

  // Producer, one thread: the stage at `pos`, once it is free. Warpgroup g's A box is taken
  // at k ka, rows row0[g].. of row block block[g]; a_box_bytes is a box's size (a box cut to
  // a short row block is smaller than A_BOX_BYTES). The B boxes are k kb, columns n0.. of the
  // weight.
  __device__ static void produce_step(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                      uint32_t tiles, uint32_t bars, Pos& pos,
                                      const int (&row0)[2], const int (&block)[2], int ka, int kb,
                                      int n0, uint32_t a_box_bytes) {
    mbar_wait(empty(bars, pos.stage), pos.phase ^ 1);
    const uint32_t bar = full(bars, pos.stage);
    const uint32_t a = tiles + pos.stage * STAGE_BYTES;
#ifdef ABLATE_NO_LOADS  // tools/kernel_ablate.py: the consumers multiply what the stage holds
    mbar_arrive(bar);
#else
    mbar_arrive_expect_tx(bar, 2 * a_box_bytes + B_BYTES);
    tma_load_3d(a, map_a, bar, ka, row0[0], block[0]);
    tma_load_3d(a + A_BOX_BYTES, map_a, bar, ka, row0[1], block[1]);
    if constexpr (B_MN) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load_2d(a + A_BYTES + j * B_BOX_BYTES, map_b, bar, n0 + 64 * j, kb);
    } else {  // one box of BN n x 64 k of a weight (N, K) as stored (make_map_wk)
      tma_load_2d(a + A_BYTES, map_b, bar, kb, n0);
    }
#endif
    pos.advance();
  }

  // Producer, one thread, weight-as-A forms (A_MN): the stage at `pos`, once it is free.
  // Warpgroup g's A box is columns m0 + 64 g.. of map_w (W (K, M) as stored, boxes of 64 m
  // x 64 k) at k; load_b(address, barrier) asks for B's part of the stage, b_bytes of it.
  template <class LoadB>
  __device__ static void produce_step_wa(const CUtensorMap* map_w, uint32_t tiles, uint32_t bars,
                                         Pos& pos, int m0, int k, uint32_t b_bytes,
                                         const LoadB& load_b) {
    static_assert(A_MN, "the weight is the A operand");
    mbar_wait(empty(bars, pos.stage), pos.phase ^ 1);
    const uint32_t bar = full(bars, pos.stage);
    const uint32_t a = tiles + pos.stage * STAGE_BYTES;
#ifdef ABLATE_NO_LOADS
    mbar_arrive(bar);
#else
    mbar_arrive_expect_tx(bar, A_BYTES + b_bytes);
    tma_load_2d(a, map_w, bar, m0, k);
    tma_load_2d(a + A_BOX_BYTES, map_w, bar, m0 + 64, k);
    load_b(a + A_BYTES, bar);
#endif
    pos.advance();
  }

  // Producer, one thread: the k_steps stages of one tile, A and B both at k ks * BK.
  __device__ static void produce_tile(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                      uint32_t tiles, uint32_t bars, Pos& pos,
                                      const int (&row0)[2], const int (&block)[2], int n0,
                                      int k_steps, uint32_t a_box_bytes) {
    for (int ks = 0; ks < k_steps; ++ks)
      produce_step(map_a, map_b, tiles, bars, pos, row0, block, ks * BK, ks * BK, n0,
                   a_box_bytes);
  }

  // Consumer warpgroup wg (0 or 1), all 128 threads: the four wgmma of the stage at `pos`
  // into acc (the warpgroup's 64 x 256 part of the tile), committed as one group and not
  // waited for. `accumulate` is 0 for a tile's first stage. The caller advances `pos`,
  // waits for the group and releases the stage; between this and the wait it may do work
  // that leaves acc alone (mlp.cu runs the previous tile's GELU there).
  __device__ static void consume_step(float (&acc)[128], uint32_t tiles, uint32_t bars,
                                      const Pos& pos, int wg, int accumulate) {
    mbar_wait(full(bars, pos.stage), pos.phase);
    const uint32_t a = tiles + pos.stage * STAGE_BYTES + wg * A_BOX_BYTES;
    const uint32_t b = tiles + pos.stage * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16<A_MN, B_MN>(acc, A_MN ? desc_sw128(a + kk * 2048, A_BOX_BYTES, 1024)
                                              : desc_sw128(a + kk * 32, 16, 1024),
                                   B_MN ? desc_sw128(b + kk * 2048, B_BOX_BYTES, 1024)
                                        : desc_sw128(b + kk * 32, 16, 1024),
                                   accumulate | kk);
    wgmma_commit();
  }

  // Consumer warpgroup wg (0 or 1), all 128 threads: acc = the warpgroup's 64 x 256 part of
  // the tile's product over k_steps stages. On return every wgmma has completed and every
  // stage is released. `elected`: one lane per warp (it makes the warp's arrivals).
  __device__ static void consume_tile(float (&acc)[128], uint32_t tiles, uint32_t bars, Pos& pos,
                                      int k_steps, int wg, bool elected) {
    int prev = -1;
    for (int ks = 0; ks < k_steps; ++ks) {
      consume_step(acc, tiles, bars, pos, wg, ks);
      if (prev >= 0) {
        wgmma_wait<1>();
        if (elected) mbar_arrive(empty(bars, prev));
      }
      prev = pos.stage;
      pos.advance();
    }
    wgmma_wait<0>();
    if (elected && prev >= 0) mbar_arrive(empty(bars, prev));
  }

  // Epilogue store, one warp: its 16 x 256 accumulators, rounded to bf16, to rows
  // dst, dst + ld, .. (dst: the warp's first row at the tile's first column), the first
  // `rows_left` of the 16 only. 64 columns at a time pass through OUT_WARP_BYTES of shared
  // memory of the warp's own (`mine`; 4-byte stores, conflict-free under the 128-byte
  // swizzle), which turns the wgmma fragment layout into 16-byte stores of whole 128-byte
  // row pieces. Only the warp synchronises.
  static constexpr int OUT_WARP_BYTES = 16 * 128;
  __device__ static void store_warp_tile(const float (&acc)[128], unsigned char* mine, bf16* dst,
                                         long long ld, int rows_left, int lane) {
    const int gq = lane >> 2, tq = lane & 3;
    unsigned char* put = mine + gq * 128 + tq * 4;  // this thread's rows gq and gq + 8
    const int get_row = lane >> 3, get_chunk = lane & 7;
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * (8 * c + j);  // the accumulators of n8 tile 8c + j
        unsigned char* at = put + ((j ^ gq) << 4);
        *reinterpret_cast<uint32_t*>(at) = pack_bf16x2(acc[i], acc[i + 1]);
        *reinterpret_cast<uint32_t*>(at + 8 * 128) = pack_bf16x2(acc[i + 2], acc[i + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * i + get_row;
        const uint4 v = *reinterpret_cast<const uint4*>(mine + swz128(r, get_chunk));
        if (r < rows_left)
          *reinterpret_cast<uint4*>(dst + (long long)r * ld + 64 * c + get_chunk * 8) = v;
      }
      __syncwarp();
    }
  }

  // Host: the tensor map of A, (M, K) bf16 rows seen as M / MB row blocks of MB rows
  // (dimensions k, row in block, block; boxes of 64 k x min(MB, 64) rows), and of W, (K, N)
  // bf16 as stored (boxes of 64 n x 64 k). a_box_bytes(MB) is what one A box brings.
  static cudaError_t make_map_a(CUtensorMap* map, const void* a, int M, int K, int MB) {
    const uint64_t dims[3] = {(uint64_t)K, (uint64_t)MB, (uint64_t)(M / MB)};
    const uint64_t strides[2] = {(uint64_t)K * 2, (uint64_t)MB * K * 2};
    const uint32_t box[3] = {BK, (uint32_t)(MB < 64 ? MB : 64), 1};
    return make_map_bf16(map, a, 3, dims, strides, box);
  }
  static cudaError_t make_map_w(CUtensorMap* map, const void* w, int K, int N) {
    const uint64_t dims[2] = {(uint64_t)N, (uint64_t)K};
    const uint64_t strides[1] = {(uint64_t)N * 2};
    const uint32_t box[2] = {64, BK};
    return make_map_bf16(map, w, 2, dims, strides, box);
  }
  // Host: the tensor map of W, (N, K) bf16 as stored (K contiguous), as the K-major B
  // operand of the !B_MN forms: boxes of 64 k x BN n, so that the product runs through W^T
  // with no transposed copy.
  static cudaError_t make_map_wk(CUtensorMap* map, const void* w, int N, int K) {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)N};
    const uint64_t strides[1] = {(uint64_t)K * 2};
    const uint32_t box[2] = {BK, BN};
    return make_map_bf16(map, w, 2, dims, strides, box);
  }
  static uint32_t a_box_bytes(int MB) { return (uint32_t)(MB < 64 ? MB : 64) * BK * 2; }
};

}  // namespace sm90
