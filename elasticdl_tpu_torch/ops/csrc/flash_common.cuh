// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_dq.cu,
// flash_dkv.cu): the finite minus infinity, the block size, stores of f32
// or bf16 pairs, the visibility test and the launch. Their tensor-core
// pieces are in flash_mma.cuh.
//
// Layout: q, k, v, out and their gradients are contiguous [B*H, S, D] with
// D in {32, 64, 128}; lse and delta are compact [B*H, S] float32 (the TPU
// kernel's 128-lane replication is a TPU tiling artifact and is not kept).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edl_flash {

constexpr float kNegInf = -1e30f;  // finite "minus infinity", as the TPU kernel
constexpr int kThreads = 256;  // threads per block (8 warps)

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Whether query row `q` may attend to key column `k` in a sequence of `s`.
__device__ __forceinline__ bool visible(int q, int k, int s, int causal) {
  return q < s && k < s && (!causal || k <= q);
}

// Opts a kernel into more than 48 KB of dynamic shared memory, then
// launches it; returns the launch's error code (0 on success).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace edl_flash

extern "C" const char* edl_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
