// Flash-attention forward on Hopper (sm_90a): O = softmax(scale * Q K^T) V
// with online softmax, and optionally lse = m + log(l) per row for the
// backward pass.
//
// Replaces the TPU kernel elasticdl_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_forward, pallas_call at :210). The TPU kernel walks a
// sequential (bh, q_block, k_block) grid and carries (m, l, acc) in VMEM
// scratch from one k step to the next; here one block owns one (bh, q tile)
// and the k walk is a loop inside it, with (m, l, acc) in registers.
//
// Bound: at the training shape (S=4096, D=128, causal) the kernel does
// 4*S*S*D/2 FLOPs per head against 4*S*D*4 bytes of compulsory traffic, so
// it is bound by arithmetic. This first version does that arithmetic as f32
// FMA on the CUDA cores (no tensor cores), so its ceiling is the card's f32
// rate, not its TF32 or bf16 tensor-core rate. Each 64 x 64 tile product
// keeps a 4 x 4 register micro-tile per thread and reads operands as float4
// from shared memory (padded K rows avoid bank conflicts). Causal tiles
// above the diagonal are skipped, and q tiles are issued heaviest first so
// the long causal rows do not trail at the end of the grid.
#include "flash_common.cuh"

namespace edl_flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int s, int causal, float scale) {
  constexpr int kLd = D + 4;                // padded K/V row stride
  constexpr int kNh = D >= 64 ? D / 64 : 1;  // column groups per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBlockQ][D], times scale
  float* sKV = sQ + kBlockQ * D;                // [kBlockK][kLd]: K, then V
  float* sP = sKV + kBlockK * kLd;              // [kBlockQ][kLdS]

  const int num_q = (s + kBlockQ - 1) / kBlockQ;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * kBlockQ;  // heaviest first
  const size_t base = (size_t)blockIdx.y * s * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<kBlockQ, D, D>(sQ, q + base, q0, s, scale);

  float m[4], l[4];
  float4 acc[4][kNh];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int h = 0; h < kNh; ++h) acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int num_k = (s + kBlockK - 1) / kBlockK;
  const int last_k =
      causal ? min((q0 + kBlockQ - 1) / kBlockK, num_k - 1) : num_k - 1;
  for (int kb = 0; kb <= last_k; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the previous tile's V and P are no longer read
    load_tile<kBlockK, D, kLd>(sKV, k + base, k0, s, 1.f);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(sQ + (ty + 16 * i) * D + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = load4(sKV + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dot4(a[i], b[j], sc[i][j]);
    }

    // Online softmax over this tile. Invisible entries (above the causal
    // diagonal, or past the ragged edge) get probability exactly 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (visible(row, k0 + tx + 16 * j, s, causal))
          mx = fmaxf(mx, sc[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(row, k0 + tx + 16 * j, s, causal)
                            ? expf(sc[i][j] - m_new)
                            : 0.f;
        rs += p;
        sP[(ty + 16 * i) * kLdS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int h = 0; h < kNh; ++h) acc[i][h] = scale4(acc[i][h], alpha);
    }
    __syncthreads();  // K is no longer read; P is complete
    load_tile<kBlockK, D, kLd>(sKV, v + base, k0, s, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = load4(sP + (ty + 16 * i) * kLdS + kk);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int h = 0; h < kNh; ++h) {
          const float4 vv =
              load_cols<D>(sKV + (kk + c) * kLd + out_col<D>(tx, h));
#pragma unroll
          for (int i = 0; i < 4; ++i) axpy4(comp(p4[i], c), vv, acc[i][h]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    // Rows that saw no visible column keep l == 0; guard as the TPU kernel.
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int h = 0; h < kNh; ++h) {
      const float4 a = acc[i][h];
      store_cols<D>(o + base + (size_t)row * D + out_col<D>(tx, h),
                    make_float4(a.x / l_safe, a.y / l_safe, a.z / l_safe,
                                a.w / l_safe));
    }
    if (lse != nullptr && tx == 0)
      lse[(size_t)blockIdx.y * s + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, int bh, int s, int causal, float scale,
                    cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBlockQ * D + kBlockK * (D + 4) + kBlockQ * kLdS);
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  return launch(flash_fwd_kernel<T, D>, grid, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), lse, s, causal,
                scale);
}

}  // namespace edl_flash

// dtype: 0 = float32, 1 = bfloat16. lse may be null (inference: no lse).
// Returns a cudaError_t code; 0 means the kernel was launched.
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int s, int d,
                             int dtype, int causal, float scale,
                             void* stream) {
  using namespace edl_flash;
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  if (dtype == 0 && d == 128)
    return run_fwd<float, 128>(q, k, v, o, l, bh, s, causal, scale, st);
  if (dtype == 0 && d == 64)
    return run_fwd<float, 64>(q, k, v, o, l, bh, s, causal, scale, st);
  if (dtype == 0 && d == 32)
    return run_fwd<float, 32>(q, k, v, o, l, bh, s, causal, scale, st);
  if (dtype == 1 && d == 128)
    return run_fwd<__nv_bfloat16, 128>(q, k, v, o, l, bh, s, causal, scale,
                                       st);
  if (dtype == 1 && d == 64)
    return run_fwd<__nv_bfloat16, 64>(q, k, v, o, l, bh, s, causal, scale,
                                      st);
  if (dtype == 1 && d == 32)
    return run_fwd<__nv_bfloat16, 32>(q, k, v, o, l, bh, s, causal, scale,
                                      st);
  return cudaErrorInvalidValue;
}
