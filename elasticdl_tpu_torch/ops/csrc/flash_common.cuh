// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_dq.cu,
// flash_dkv.cu): tile sizes, the forward kernel's thread layout, loads and
// stores of f32 or bf16 vectors, and half-warp row reductions. The backward
// kernels' tensor-core pieces are in flash_mma.cuh.
//
// Layout: q, k, v, out and their gradients are contiguous [B*H, S, D] with
// D in {32, 64, 128}; lse and delta are compact [B*H, S] float32 (the TPU
// kernel's 128-lane replication is a TPU tiling artifact and is not kept).
//
// Thread layout of the forward kernel: 256 threads as a 16 x 16 grid,
// tx = threadIdx.x % 16, ty = threadIdx.x / 16. In a 64 x 64 score tile a
// thread owns rows ty + 16*i and columns tx + 16*j (i, j < 4); in a 64 x D
// output tile it owns rows ty + 16*i and the float4 columns 4*tx + 64*h
// (h < D/64), or for D = 32 the float2 columns 2*tx (out_col). The 16
// threads that share a row are one half-warp, so row reductions are four
// xor-shuffles. Arithmetic is plain f32 FMA on the CUDA cores, accumulating
// in f32 for both input types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace edl_flash {

constexpr float kNegInf = -1e30f;  // finite "minus infinity", as the TPU kernel
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLdS = kBlockK + 4;  // padded row stride of score tiles in smem

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(lo));
  memcpy(&raw.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// First output column of a thread's group h in a 64 x D tile (see above).
template <int D>
__device__ __forceinline__ int out_col(int tx, int h) {
  return D == 32 ? 2 * tx : 4 * tx + 64 * h;
}

// The columns of one group from a float row (D = 32: .z and .w are 0).
template <int D>
__device__ __forceinline__ float4 load_cols(const float* p) {
  if (D == 32) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    return make_float4(x.x, x.y, 0.f, 0.f);
  }
  return load4(p);
}

template <int D, typename T>
__device__ __forceinline__ void store_cols(T* p, float4 x) {
  if (D == 32)
    store2(p, x.x, x.y);
  else
    store4(p, x);
}

__device__ __forceinline__ float comp(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc += w * x, component-wise.
__device__ __forceinline__ void axpy4(float w, const float4& x, float4& acc) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ float4 scale4(const float4& x, float w) {
  return make_float4(x.x * w, x.y * w, x.z * w, x.w * w);
}

// Copies rows [row0, row0 + ROWS) of a row-major [s, D] matrix into shared
// memory with row stride LD floats, multiplied by `mul`. Rows at or past `s`
// (the ragged edge) are written as zeros. Each thread moves 16 (f32) or 8
// (bf16) bytes at a time; neighbouring threads read neighbouring addresses.
template <int ROWS, int D, int LD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int s, float mul) {
  constexpr int kVecPerRow = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx - r * kVecPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s) x = scale4(load4(src + (size_t)(row0 + r) * D + c), mul);
    store4(dst + r * LD + c, x);
  }
}

// Max and sum over the 16 threads of a half-warp (the threads sharing a row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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
