// K11 and K13: kernels of the probe tools (aurora_tpu_torch/tools/); K12 gemm_blocked is in
// gemm.cu, K9 mlp_t in mlp_t.cu and K10 attn_probe in attn_probe.cu.
//
// They replace two of the five Pallas kernels that live in the JAX package's tools:
//   K11 attn5d_direct  tools/backbone_ablate.py make_direct    (pallas_call at :877)
//   K13 smem_probe     tools/vmem_probe.py try_size            (pallas_call at :26)
// Each computes what the TPU kernel computes; what a TPU mode meant (a Mosaic relayout, a
// VMEM ceiling) is given its reading on this card at each kernel. K11 is the first
// mma.sync design of window_attention.cuh, which no other kernel includes; its time stands
// in PERF.md beside its bound.
#include "common.cuh"
#include "window_attention.cuh"

namespace {

// ------------------------------------------------------------------------------ K13
// out = 2 x + scratch[0][0] with scratch[0][:] = x[0][:], x (8, 128) f32, where scratch is
// `bytes` of dynamic shared memory whose last byte is written and read back. The card's
// counterpart of the TPU's VMEM ceiling is the dynamic shared memory a block may opt in to.
__global__ void __launch_bounds__(1024) smem_probe_kernel(const float* __restrict__ x,
                                                          float* __restrict__ out, int bytes) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* scratch = reinterpret_cast<float*>(raw);
  volatile unsigned char* last = raw + bytes - 1;
  const int tid = threadIdx.x;
  if (tid < 128) scratch[tid] = x[tid];
  __syncthreads();
  if (tid == 0) *last = 1;  // bytes > 512: beyond the first row
  __syncthreads();
  const float touched = (float)(*last) - 1.f;  // 0 when the byte held
  out[tid] = 2.f * x[tid] + scratch[0] + touched;
}

// ------------------------------------------------------------------------------ K11
// K2 without tail and mask where the unit of work is the TPU kernel's: the (ws0, ws1, Wp)
// strip of W1 windows of the 5D tokens, gathered on chip. A strip is 4.4 MB at stage 1, so a
// block (one per strip and head: the head axis fills the card, the TPU grid was (C1, H1))
// walks the strip's windows and holds one window's 144 x 32-channel slab at a time.
//   loop: each slab is gathered window by window from device memory through the table of
//         row numbers, with register-staged 16-byte loads, then multiplied (K2's way);
//   vec:  the slabs come in one pass of asynchronous 16-byte copies (cp.async) addressed
//         arithmetically in strip order (line of the strip, column), straight into shared
//         memory and double-buffered: the next slab and weight slice are in flight while
//         the current one is multiplied.
// Both write each window's result back in place: K2 without tail's function, its qkv
// projected on mma.sync where K2's is on wgmma, so the two may round apart.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int STAGE = (WN + 3 * DH) * LDX;  // one buffer: a row slab and a weight slice

template <bool VEC>
__global__ void __launch_bounds__(THREADS) attn5d_direct_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wt, const bf16* __restrict__ bqkv, int Cp,
    int Hp, int Wp, int D, int ws0, int ws1, int ws2, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WindowSmem sm(smem);
  bf16* stage1 = reinterpret_cast<bf16*>(smem + SMEM);  // VEC: the second buffer
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head = blockIdx.x;
  const int H1 = Hp / ws1, W1 = Wp / ws2;
  const int b = blockIdx.y / ((Cp / ws0) * H1), strip = blockIdx.y % ((Cp / ws0) * H1);
  const int c1 = strip / H1, h1 = strip % H1;
  // First row of the strip; line l = (wc, wh) of it starts at ((wc * Hp) + wh) * Wp rows on.
  const long long strip0 = (((long long)b * Cp + c1 * ws0) * Hp + h1 * ws1) * Wp;
  for (int j = 0; j < W1; ++j) {
    __syncthreads();  // the previous window's stores have read rowid
    for (int t = tid; t < WN; t += THREADS)
      sm.rowid[t] = window_row(b, (c1 * H1 + h1) * W1 + j, t, Cp, Hp, Wp, ws0, ws1, ws2);
    __syncthreads();
    if constexpr (VEC) {
      auto fetch = [&](int k0, bf16* buf) {
        for (int i = tid; i < (WN + 3 * DH) * 4; i += THREADS) {
          const int r = i >> 2, q = i & 3;
          const bf16* src;
          if (r < WN) {
            const int line = r / ws2, ww = r % ws2;
            src = x + (strip0 + ((long long)(line / ws1) * Hp + line % ws1) * Wp + j * ws2 + ww) * D +
                  k0 + q * 8;
          } else {
            src = weight_piece(wt, D, head, r - WN, k0, q);
          }
          cp_async16(buf + r * LDX + q * 8, src);
        }
        cp_async_commit();
      };
      float acc[24][4];
#pragma unroll
      for (int jj = 0; jj < 24; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
      const int steps = D / KC;
      fetch(0, sm.Xs);
      for (int ks = 0; ks < steps; ++ks) {
        bf16* cur = (ks & 1) ? stage1 : sm.Xs;
        if (ks + 1 < steps) {
          fetch((ks + 1) * KC, (ks & 1) ? sm.Xs : stage1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        project_step(acc, cur, cur + WN * LDX, warp, lane);
        __syncthreads();  // before this buffer is filled again
      }
      project_finish(acc, bqkv, D, head, warp, lane, sm.Qs, sm.Ks, sm.Vt);
    } else {
      project_qkv(x, D, wt, bqkv, sm.rowid, D, head, tid, lane, warp, sm.Xs, sm.Ws, sm.Qs, sm.Ks,
                  sm.Vt);
    }
    __syncthreads();
    attend_store(sm.Qs, sm.Ks, sm.Vt, nullptr, sm.rowid, D, head * DH, out, warp,
                              lane);
  }
}

template <bool VEC>
int launch_direct(const bf16* x, const bf16* wt, const bf16* b, int B, int Cp, int Hp, int Wp, int D,
                  int ws0, int ws1, int ws2, int heads, bf16* out, cudaStream_t stream) {
  const size_t smem = SMEM + (VEC ? (size_t)STAGE * 2 : 0);
  cudaFuncSetAttribute(attn5d_direct_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  attn5d_direct_kernel<VEC><<<dim3(heads, B * (Cp / ws0) * (Hp / ws1)), THREADS, smem, stream>>>(
      x, wt, b, Cp, Hp, Wp, D, ws0, ws1, ws2, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K13. x, out: (8, 128) f32; bytes of dynamic shared memory to opt in to and launch with.
// Returns the error of the refused attribute or launch (and clears it: neither is sticky),
// else cudaGetLastError() after the launch.
extern "C" int smem_probe(const float* x, float* out, int bytes, cudaStream_t stream) {
  if (bytes <= 512) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  smem_probe_kernel<<<1, 1024, bytes, stream>>>(x, out, bytes);
  return (int)cudaGetLastError();
}

// A kernel that does nothing, one thread: what a launch costs, the yardstick of K13's time.
__global__ void empty_kernel() {}
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 1, 0, stream>>>();
  return (int)cudaGetLastError();
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device into *bytes.
extern "C" int smem_optin_bytes(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// K11. x, out: (B, Cp, Hp, Wp, D) bf16 with windows (ws0, ws1, ws2) of 144 tokens in place;
// wqkv_t: (3D, D) bf16; bqkv: (3D,) bf16; vec: 1 for mode vec, 0 for mode loop.
// Returns cudaGetLastError().
extern "C" int attn5d_direct(const void* x, const void* wqkv_t, const void* bqkv, void* out, int B,
                             int Cp, int Hp, int Wp, int D, int ws0, int ws1, int ws2, int heads,
                             int vec, cudaStream_t stream) {
  if (ws0 * ws1 * ws2 != WN || Cp % ws0 || Hp % ws1 || Wp % ws2 || D != heads * DH || D % KC ||
      (long long)B * (Cp / ws0) * (Hp / ws1) > 65535)
    return (int)cudaErrorInvalidValue;
  auto xb = static_cast<const bf16*>(x);
  auto wt = static_cast<const bf16*>(wqkv_t);
  auto bb = static_cast<const bf16*>(bqkv);
  auto ob = static_cast<bf16*>(out);
  return vec ? launch_direct<true>(xb, wt, bb, B, Cp, Hp, Wp, D, ws0, ws1, ws2, heads, ob, stream)
             : launch_direct<false>(xb, wt, bb, B, Cp, Hp, Wp, D, ws0, ws1, ws2, heads, ob, stream);
}
