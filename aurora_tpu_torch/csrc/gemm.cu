// K12 gemm_blocked: out = round_bf16(A @ W), f32 accumulation; A (M, K) bf16 rows, W (K, N)
// bf16 as stored. Replaces tools/gemm_probe.py pallas_gemm (pallas_call at :102), the
// hand-blocked GEMM whose row block MB the tool sweeps.
//
// Bound on the H100: at the proj shape (259200 x 512 x 512) bytes, A read and the output
// written once (0.159 ms at 3.35 TB/s) with the operations close behind (0.137 ms at
// 989 TF/s); at fc2 (64800 x 2048 x 512) operations (0.137 ms). Both need the tensor cores
// near their wgmma rate and device memory read once, so the design is the Hopper GEMM
// pipeline of gemm_sm90.cuh:
//   * one persistent block per SM: two consumer warpgroups (64 x 256 each, 128 f32
//     accumulators a thread) and a producer warpgroup of which one thread issues TMA loads
//     into a ring of 4 stages x 48 KB (K in steps of 64). A tile is (2 x 64) x 256: the
//     widest wgmma, 85 flops per byte of shared-memory fill; N = 512 is two tiles. Four
//     stages keep ~150 KB in flight per SM and, with 16 KB of output staging, take 209 KB of
//     the 227 KB a block may have; a fifth does not fit (three stages cost 4-10%, two
//     25-80%, measured). Pairs of blocks that share W's boxes by TMA multicast were tried:
//     the pair's lockstep cost what the saved L2 traffic gained, so blocks run alone.
//   * W is read as stored, as an MN-major operand (no transposed copy).
//   * What MB means here. On the TPU MB rows sat in VMEM per step of a sequential grid. Here
//     it is the unit of the schedule: each row block of MB rows is cut into pieces of 64
//     rows (one warpgroup's wgmma height), the last one ragged; the pieces of all row blocks
//     in order are paired into tiles (a tile's two pieces may lie in two row blocks), and
//     the (tile, column tile) units are dealt round-robin to the blocks, column tile
//     fastest, so the two column tiles of a tile run at the same time on neighbouring
//     blocks and A comes from device memory once. The number of working SMs is
//     min(SMs, units) whatever MB is. A is seen through a 3D tensor map (k, row in block,
//     block): the TMA fills a ragged piece's missing rows with zeros, so no row of the next
//     block is read, and the epilogue stores a piece's own rows only. A row's sum runs
//     over K in one order whatever piece holds it: the result is the same bits for every MB. What MB costs is the ragged pieces' empty rows (MB = 540: 9 pieces,
//     576 rows' work for 540) and with them the number of waves of units over the SMs.
//   * Epilogue: each warp rounds its 16 x 256 accumulators to bf16 and passes them, 64
//     columns at a time, through 2 KB of shared memory of its own (4-byte stores,
//     conflict-free under the 128-byte swizzle) to turn the wgmma fragment layout into
//     16-byte stores of whole 128-byte row pieces. Only the warp synchronises, and the
//     producer already loads the next tile's stages. The tensor cores idle meanwhile: at
//     the proj shape (an epilogue every 8 K steps) that is 22% of the kernel, the same
//     whether the tile leaves so or through TMA stores of 64 x 64 boxes (both measured).
//     Hiding it takes a schedule in which one warpgroup stores while the other multiplies.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

#ifndef GEMM_STAGES  // tools/kernel_ablate.py builds variants with fewer
#define GEMM_STAGES 4
#endif
using Ring = sm90::GemmRing<GEMM_STAGES>;
constexpr int OUT_BYTES = Ring::CONSUMER_WARPS * Ring::OUT_WARP_BYTES;
constexpr int GEMM_THREADS = 384;                 // consumers 0-255, producer warpgroup 256-383
constexpr size_t GEMM_SMEM = 1024 + Ring::STAGES * Ring::STAGE_BYTES + OUT_BYTES + Ring::BAR_BYTES;

// Unit u of the schedule: column tile u % n_tiles of tile u / n_tiles, whose warpgroup g
// takes piece p = 2 (u / n_tiles) + g: rows 64 (p % pieces_per_block).. of row block
// p / pieces_per_block. Past the last piece (an odd total) a warpgroup repeats the last
// piece's product and stores nothing.
__global__ void __launch_bounds__(GEMM_THREADS, 1) gemm_blocked_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    bf16* __restrict__ out, int MB, int N, int pieces_per_block, int pieces, int n_tiles, int units,
    int k_steps, uint32_t a_box_bytes) {
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = sm90::smem_u32(raw);
  const uint32_t tiles = (raw_addr + 1023u) & ~1023u;
  const uint32_t staging = tiles + Ring::STAGES * Ring::STAGE_BYTES;
  const uint32_t bars = staging + OUT_BYTES;
  const int tid = threadIdx.x;

  if (tid == 0) Ring::init(bars);
  __syncthreads();

  if (tid >= 256) {
    sm90::reg_dealloc<40>();
    if (tid == 256) {
      Ring::Pos pos;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int row0[2], block[2];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int p = min(2 * (u / n_tiles) + g, pieces - 1);
          row0[g] = (p % pieces_per_block) * 64;
          block[g] = p / pieces_per_block;
        }
        Ring::produce_tile(&map_a, &map_w, tiles, bars, pos, row0, block, (u % n_tiles) * Ring::BN,
                           k_steps, a_box_bytes);
      }
    }
  } else {
    sm90::reg_alloc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    // The warp's staging rows (16 x 128 bytes, swizzled as a TMA box would be).
    unsigned char* mine = raw + (staging - raw_addr) + (tid >> 5) * Ring::OUT_WARP_BYTES;
    Ring::Pos pos;
    float acc[128];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int p = 2 * (u / n_tiles) + wg;
      const int n0 = (u % n_tiles) * Ring::BN;
      Ring::consume_tile(acc, tiles, bars, pos, k_steps, wg, lane == 0);
#ifdef ABLATE_NO_EPILOGUE
      if (acc[0] != 123.456f) continue;  // never equal: the product is kept, nothing stored
#endif
      if (p >= pieces) continue;
      const int row0 = (p % pieces_per_block) * 64 + warp * 16;  // the warp's first row in its block
      bf16* dst = out + ((long long)(p / pieces_per_block) * MB + row0) * N + n0;
      Ring::store_warp_tile(acc, mine, dst, N, MB - row0, lane);
    }
  }
}

}  // namespace

// K12. a: (M, K) bf16; w: (K, N) bf16 as stored; out: (M, N) bf16. MB: the row block, a
// divisor of M; pieces_per_block = ceil(MB / 64) and units = ceil((M / MB) pieces_per_block
// / 2) (N / 256) as the caller worked them out. Needs K % 64 == 0 and N % 256 == 0. Returns
// cudaGetLastError(), cudaErrorInvalidValue for a shape it does not take, or
// cudaErrorUnknown where no tensor map could be encoded.
extern "C" int gemm_blocked(const void* a, const void* w, void* out, int M, int K, int N, int MB,
                            int pieces_per_block, int units, cudaStream_t stream) {
  if (K <= 0 || K % Ring::BK || N <= 0 || N % Ring::BN || MB <= 0 || M % MB ||
      pieces_per_block != (MB + 63) / 64)
    return (int)cudaErrorInvalidValue;
  const long long pieces = (long long)(M / MB) * pieces_per_block;
  if (pieces > 0x7fffffffLL || (long long)units != (pieces + 1) / 2 * (N / Ring::BN))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  cudaError_t e;
  if ((e = Ring::make_map_a(&map_a, a, M, K, MB)) != cudaSuccess) return (int)e;
  if ((e = Ring::make_map_w(&map_w, w, K, N)) != cudaSuccess) return (int)e;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorUnknown;
  cudaFuncSetAttribute(gemm_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)GEMM_SMEM);
  gemm_blocked_kernel<<<units < sms ? units : sms, GEMM_THREADS, GEMM_SMEM, stream>>>(
      map_a, map_w, static_cast<bf16*>(out), MB, N, pieces_per_block, (int)pieces, N / Ring::BN, units, K / Ring::BK,
      Ring::a_box_bytes(MB));
  return (int)cudaGetLastError();
}
