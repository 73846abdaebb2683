// Flash-attention backward, dK/dV pass, on Hopper (sm_90a). For each k
// tile, over the q tiles that see it:
//   P  = exp(scale * Q K^T - lse)           (recomputed, held transposed)
//   dV = sum of P^T dO
//   dS = P * (dO V^T - delta)
//   dK = scale * sum of dS^T Q
//
// Replaces the TPU kernel elasticdl_tpu/ops/flash_attention.py:_dkv_kernel
// (pallas_call at :387, launcher _flash_backward). Each k tile's dK and dV
// are written by exactly one block (no atomics, deterministic); the TPU's
// sequential q grid axis becomes a loop inside the block starting at the
// first q tile that sees this k tile (_first_qi), with dK and dV in
// registers.
//
// Bound: four S x S x D products per head, so arithmetic, done here as f32
// FMA on the CUDA cores. The block computes the transposed score tiles
// (k rows, q columns) so that P^T and dS^T come out in the layout the dV
// and dK products read; both score-side products share one pass over D,
// and both output products share one pass over the q tile.
#include "flash_common.cuh"

namespace edl_flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int s, int causal, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kNh = D / 64;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [kBlockK][D]
  float* sV = sK + kBlockK * D;                 // [kBlockK][D]
  float* sQ = sV + kBlockK * D;                 // [kBlockQ][kLd]
  float* sdO = sQ + kBlockQ * kLd;              // [kBlockQ][kLd]
  float* sP = sdO + kBlockQ * kLd;              // [kBlockK][kLdS]: P^T
  float* sdS = sP + kBlockK * kLdS;             // [kBlockK][kLdS]: dS^T
  float* sLse = sdS + kBlockK * kLdS;           // [kBlockQ]
  float* sDelta = sLse + kBlockQ;               // [kBlockQ]

  const int k0 = (int)blockIdx.x * kBlockK;  // causal: heaviest tiles first
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t row_base = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<kBlockK, D, D>(sK, k + base, k0, s, 1.f);
  load_tile<kBlockK, D, D>(sV, v + base, k0, s, 1.f);
  float4 dk_acc[4][kNh], dv_acc[4][kNh];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < kNh; ++h)
      dk_acc[i][h] = dv_acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int num_q = (s + kBlockQ - 1) / kBlockQ;
  const int first_q = causal ? k0 / kBlockQ : 0;
  for (int qb = first_q; qb < num_q; ++qb) {
    const int q0 = qb * kBlockQ;
    __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are done
    load_tile<kBlockQ, D, kLd>(sQ, q + base, q0, s, 1.f);
    load_tile<kBlockQ, D, kLd>(sdO, dout + base, q0, s, 1.f);
    if (threadIdx.x < kBlockQ) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < s ? lse[row_base + row] : 0.f;
      sDelta[threadIdx.x] = row < s ? delta[row_base + row] : 0.f;
    }
    __syncthreads();

    // st[i][j] = K[k0+ty+16i] . Q[q0+tx+16j]; dpt likewise with V and dO.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 ak[4], av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i] = load4(sK + (ty + 16 * i) * D + d);
        av[i] = load4(sV + (ty + 16 * i) * D + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 bq = load4(sQ + (tx + 16 * j) * kLd + d);
        const float4 bg = load4(sdO + (tx + 16 * j) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          st[i][j] = dot4(ak[i], bq, st[i][j]);
          dpt[i][j] = dot4(av[i], bg, dpt[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (visible(q0 + qc, krow, s, causal)) {
          p = expf(scale * st[i][j] - sLse[qc]);
          ds = p * (dpt[i][j] - sDelta[qc]);
        }
        sP[(ty + 16 * i) * kLdS + qc] = p;
        sdS[(ty + 16 * i) * kLdS + qc] = ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < kBlockQ; qq += 4) {
      float4 p4[4], s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p4[i] = load4(sP + (ty + 16 * i) * kLdS + qq);
        s4[i] = load4(sdS + (ty + 16 * i) * kLdS + qq);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int h = 0; h < kNh; ++h) {
          const float4 g4 = load4(sdO + (qq + c) * kLd + 4 * tx + 64 * h);
          const float4 q4 = load4(sQ + (qq + c) * kLd + 4 * tx + 64 * h);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            axpy4(comp(p4[i], c), g4, dv_acc[i][h]);
            axpy4(comp(s4[i], c), q4, dk_acc[i][h]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int h = 0; h < kNh; ++h) {
      const size_t off = base + (size_t)row * D + 4 * tx + 64 * h;
      store4(dk + off, scale4(dk_acc[i][h], scale));
      store4(dv + off, dv_acc[i][h]);
    }
  }
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int bh, int s, int causal, float scale,
                    cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kBlockK * D + 2 * kBlockQ * (D + 4) +
                       2 * kBlockK * kLdS + 2 * kBlockQ);
  const dim3 grid((s + kBlockK - 1) / kBlockK, bh);
  return launch(flash_dkv_kernel<T, D>, grid, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dk), static_cast<T*>(dv), s, causal,
                scale);
}

}  // namespace edl_flash

// dtype: 0 = float32, 1 = bfloat16; lse and delta are float32 [bh, s].
// Returns a cudaError_t code; 0 means the kernel was launched.
extern "C" int edl_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int s, int d, int dtype, int causal, float scale,
                             void* stream) {
  using namespace edl_flash;
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == 0 && d == 128)
    return run_dkv<float, 128>(q, k, v, dout, l, dl, dk, dv, bh, s, causal,
                               scale, st);
  if (dtype == 0 && d == 64)
    return run_dkv<float, 64>(q, k, v, dout, l, dl, dk, dv, bh, s, causal,
                              scale, st);
  if (dtype == 1 && d == 128)
    return run_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dk, dv, bh, s,
                                       causal, scale, st);
  if (dtype == 1 && d == 64)
    return run_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dk, dv, bh, s,
                                      causal, scale, st);
  return cudaErrorInvalidValue;
}
