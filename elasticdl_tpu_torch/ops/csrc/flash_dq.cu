// Flash-attention backward, dQ pass, on Hopper (sm_90a). For each q tile:
//   P  = exp(scale * Q K^T - lse)          (recomputed per k tile)
//   dS = P * (dO V^T - delta)               delta = rowsum(dO * O)
//   dQ = scale * sum over k tiles of dS K
//
// Replaces the TPU kernel elasticdl_tpu/ops/flash_attention.py:_dq_kernel
// (pallas_call at :353, launcher _flash_backward). As there, dQ is written
// by exactly one block per q tile (no atomics, so results are
// deterministic); the TPU's sequential k grid axis becomes a loop inside
// the block with the dQ accumulator in registers.
//
// Bound: three S x S x D products per head (QK^T, dO V^T, dS K), so
// arithmetic, done here as f32 FMA on the CUDA cores. Both score-side
// products share one pass over D (a 4 x 4 micro-tile each per thread); the
// dS tile goes through shared memory for the dS K product. Causal tiles
// above the diagonal are skipped and q tiles are issued heaviest first.
#include "flash_common.cuh"

namespace edl_flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s,
                    int causal, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kNh = D / 64;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBlockQ][D]
  float* sdO = sQ + kBlockQ * D;                // [kBlockQ][D]
  float* sK = sdO + kBlockQ * D;                // [kBlockK][kLd]
  float* sV = sK + kBlockK * kLd;               // [kBlockK][kLd]
  float* sdS = sV + kBlockK * kLd;              // [kBlockQ][kLdS]

  const int num_q = (s + kBlockQ - 1) / kBlockQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * kBlockQ;
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t row_base = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<kBlockQ, D, D>(sQ, q + base, q0, s, 1.f);
  load_tile<kBlockQ, D, D>(sdO, dout + base, q0, s, 1.f);
  float lse_r[4], delta_r[4];
  float4 acc[4][kNh];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < s ? lse[row_base + row] : 0.f;
    delta_r[i] = row < s ? delta[row_base + row] : 0.f;
#pragma unroll
    for (int h = 0; h < kNh; ++h) acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int num_k = (s + kBlockK - 1) / kBlockK;
  const int last_k =
      causal ? min((q0 + kBlockQ - 1) / kBlockK, num_k - 1) : num_k - 1;
  for (int kb = 0; kb <= last_k; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tile<kBlockK, D, kLd>(sK, k + base, k0, s, 1.f);
    load_tile<kBlockK, D, kLd>(sV, v + base, k0, s, 1.f);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = load4(sQ + (ty + 16 * i) * D + d);
        g[i] = load4(sdO + (ty + 16 * i) * D + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 bk = load4(sK + (tx + 16 * j) * kLd + d);
        const float4 bv = load4(sV + (tx + 16 * j) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[i][j] = dot4(a[i], bk, sc[i][j]);
          dp[i][j] = dot4(g[i], bv, dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds = 0.f;
        if (visible(row, k0 + tx + 16 * j, s, causal)) {
          const float p = expf(scale * sc[i][j] - lse_r[i]);
          ds = p * (dp[i][j] - delta_r[i]);
        }
        sdS[(ty + 16 * i) * kLdS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s4[i] = load4(sdS + (ty + 16 * i) * kLdS + kk);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int h = 0; h < kNh; ++h) {
          const float4 kv = load4(sK + (kk + c) * kLd + 4 * tx + 64 * h);
#pragma unroll
          for (int i = 0; i < 4; ++i) axpy4(comp(s4[i], c), kv, acc[i][h]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int h = 0; h < kNh; ++h)
      store4(dq + base + (size_t)row * D + 4 * tx + 64 * h,
             scale4(acc[i][h], scale));
  }
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int s, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kBlockQ * D +
                                       2 * kBlockK * (D + 4) + kBlockQ * kLdS);
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  return launch(flash_dq_kernel<T, D>, grid, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dq), s, causal, scale);
}

}  // namespace edl_flash

// dtype: 0 = float32, 1 = bfloat16; lse and delta are float32 [bh, s].
// Returns a cudaError_t code; 0 means the kernel was launched.
extern "C" int edl_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int s, int d,
                            int dtype, int causal, float scale, void* stream) {
  using namespace edl_flash;
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == 0 && d == 128)
    return run_dq<float, 128>(q, k, v, dout, l, dl, dq, bh, s, causal, scale,
                              st);
  if (dtype == 0 && d == 64)
    return run_dq<float, 64>(q, k, v, dout, l, dl, dq, bh, s, causal, scale,
                             st);
  if (dtype == 1 && d == 128)
    return run_dq<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dq, bh, s, causal,
                                      scale, st);
  if (dtype == 1 && d == 64)
    return run_dq<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dq, bh, s, causal,
                                     scale, st);
  return cudaErrorInvalidValue;
}
