// K7 sdpa_windows: masked per-head attention over packed window rows qkv (B, nW, 144, 3D),
// features (q|k|v) x head x 64, -> (B, nW, 144, D). Replaces aurora_tpu/model/swin3d.py
// _sdpa_windows_fused_pallas (pallas_call at :651).
//
// Bound on the H100: bytes. A unit (window, head) reads 55 KB and writes 18 KB for 5.3 MFLOP:
// a stage-1 launch moves 1.06 GB (0.317 ms at 3.35 TB/s) for 76 GFLOP (0.08 ms at the
// tensor cores' peak). So the design keeps device memory busy while the core computes: the
// ring kernel of sdpa_sm90.cuh (blocks of 9 warps, two to an SM, a 2-stage ring of q, k, v
// boxes that the last warp to finish a stage refills by TMA, the mask as bits in registers,
// the ldmatrix core of attention_core.cuh) on the packed rows (PackedRows: a 2D map, boxes
// of {64, 144}). A block asks for 2 x 55,296 bytes and nothing it does not use. K2 and K6
// run the same kernel behind their qkv projection (window_attention.cu).
#include "sdpa_sm90.cuh"

// K7: qkv (B, nW, 144, 3D) bf16 packed (q|k|v) x head x 64 -> out (B, nW, 144, D) bf16;
// groups: (nW, 144) int32 or null. Returns cudaGetLastError(), cudaErrorInvalidValue for a
// shape it does not take, or cudaErrorUnknown where no tensor map could be encoded.
extern "C" int sdpa_windows(const void* qkv, const int* groups, void* out, int B, int nW, int D,
                            int heads, cudaStream_t stream) {
  const long long windows = (long long)B * nW;
  if (B <= 0 || nW <= 0 || D != heads * 64 || windows * heads > 0x7fffffffLL ||
      windows * CORE_N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t e = make_map_packed(&map, qkv, windows * CORE_N, D);
  if (e != cudaSuccess) return (int)e;
  return launch_sdpa(map, PackedRows{D}, groups, static_cast<bf16*>(out), nW, D, heads,
                     (int)(windows * heads), stream);
}
