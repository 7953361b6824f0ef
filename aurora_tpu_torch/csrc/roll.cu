// K1: 3-axis cyclic roll of (B, C, H, W, D) tokens over (C, H, W) in one pass.
//
// Replaces aurora_tpu/ops/roll.py::roll3d_pallas (pallas_call at roll.py:81), which
// handled the C/H shifts by block index maps and rotated W inside VMEM.
// Bound on the H100: bytes. The roll reads the tensor once and writes it once
// (2 x 265 MB at stage 1 of the 0.25 deg model, ~0.16 ms at 3.35 TB/s). Design: a flat
// gather copy, one 16-byte vector per thread; neighbouring threads move neighbouring
// vectors of a token row, so both the reads and the writes are fully coalesced.
// It is a pure copy and so bit-exact for any element type.
#include "common.cuh"

__global__ void roll3d_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                              long long total, int C, int H, int W, int vpr, int s0, int s1,
                              int s2) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int v = (int)(i % vpr);
  long long row = i / vpr;
  int w = (int)(row % W);
  long long r = row / W;
  int h = (int)(r % H);
  r /= H;
  int c = (int)(r % C);
  long long b = r / C;
  int cs = c - s0 < 0 ? c - s0 + C : c - s0;
  int hs = h - s1 < 0 ? h - s1 + H : h - s1;
  int wsrc = w - s2 < 0 ? w - s2 + W : w - s2;
  long long src = (((b * C + cs) * H + hs) * W + wsrc) * vpr + v;
  out[i] = x[src];
}

// Shifts arrive normalised to [0, C), [0, H), [0, W). Returns cudaGetLastError().
extern "C" int roll3d(const void* x, void* out, int B, int C, int H, int W, int row_bytes,
                      int s0, int s1, int s2, cudaStream_t stream) {
  int vpr = row_bytes / 16;
  long long total = (long long)B * C * H * W * vpr;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  roll3d_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), total, C, H, W, vpr, s0, s1, s2);
  return (int)cudaGetLastError();
}
