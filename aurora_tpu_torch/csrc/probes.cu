// K13 smem_probe: the kernel of the probe tool aurora_tpu_torch/tools/smem_probe.py; K9
// mlp_t is in mlp_t.cu, K10 attn_probe in attn_probe.cu, K11 attn5d_direct in
// attn5d_direct.cu and K12 gemm_blocked in gemm.cu.
//
// Replaces the Pallas kernel of tools/vmem_probe.py try_size (pallas_call at :26). What the
// TPU's VMEM ceiling meant is given its reading on this card at the kernel. Its time is a
// launch's floor: empty_launch below is the yardstick, timed the same way.
#include "common.cuh"

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
