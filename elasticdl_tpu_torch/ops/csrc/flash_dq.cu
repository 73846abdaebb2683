// Flash-attention backward, dQ pass, on Hopper (sm_90a). For each q tile:
//   P  = exp(scale * Q K^T - lse)          (recomputed per k tile)
//   dS = P * (dO V^T - delta)               delta = rowsum(dO * O)
//   dQ = scale * sum over k tiles of dS K
//
// Replaces the TPU kernel elasticdl_tpu/ops/flash_attention.py:_dq_kernel
// (pallas_call at :353, launcher _flash_backward). As there, dQ is written
// by exactly one block per q tile (no atomics, so results are bitwise
// deterministic); the TPU's sequential k grid axis becomes a loop inside
// the block with the dQ accumulator in registers.
//
// Bound: three S x S x D products per head (Q K^T, dO V^T, dS K), so
// arithmetic. The products run on the tensor cores as 3xTF32
// mma.sync.m16n8k8 (flash_mma.cuh): f32 accuracy at a ceiling of 495 / 3
// TFLOP/s, against 67 TFLOP/s for f32 FMA on the CUDA cores. Where the Q,
// dO tile and a K, V tile are exact in TF32 (the flagship LM's bfloat16
// activations in f32 tensors), the zero small parts are skipped: 4 MMAs
// per tile step in place of 9, with bitwise the same result.
//
// Tiling: a block of 8 warps holds 128 q rows of Q and dO in shared memory;
// each warp owns 16 of them, with their lse and delta in registers. It
// streams k tiles of 32 rows (D = 128) or 64 (D <= 64) of K and V,
// double-buffered with cp.async so that tile n + 1 loads while tile n is
// multiplied. Per k tile a warp computes S and dP (16 x k-tile) in
// registers, turns them into dS in place and feeds dS straight from
// registers as the A operand of dS K: no score tile goes through shared
// memory, and the only barrier is one per streamed tile. Causal k tiles
// past a warp's rows are skipped, whole tiles past the block's rows are
// never loaded, and q tiles are issued heaviest first. Occupancy: one
// block (8 warps) per SM. Shared memory (f32) is 203 KB at D = 128 (Q, dO
// 2 x 128 x 132 floats; K, V 2 stages x 2 x 32 x 132) and 139 KB at
// D = 64. Registers (-Xptxas -v): 211 per thread at D = 128 f32, 162-254
// over the six instantiations, no spills.
#include "flash_mma.cuh"

namespace edl_flash {

template <typename T, int D>
struct DqTiles {
  static constexpr int kRowsQ = 128;                 // resident, 8 warps x 16
  static constexpr int kRowsK = D == 128 ? 32 : 64;  // streamed
  static constexpr int kLd = mma_ld<D, T>();
  static constexpr size_t kSmem =
      sizeof(T) * (size_t)(2 * kRowsQ + 4 * kRowsK) * kLd;
};

// One warp's work on one k tile: S and dP for its 16 q rows, then dS in
// place, then dQ += dS K. kSmall: whether Q, dO, K and V need their small
// parts (false when they are TF32-exact).
template <bool kSmall, int kBk, int D, int kLd, typename T>
__device__ __forceinline__ void dq_tile(float (&dq_acc)[D / 8][4],
                                        const T* wq, const T* wdo,
                                        const T* tk, const T* tv,
                                        const float (&lse_r)[2],
                                        const float (&delta_r)[2], int k0,
                                        int qrow0, int s, int causal,
                                        float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x * log2(e))
  // S and dP, rows (q) of this warp; sc[j]: columns (k) [8j, 8j + 8).
  float sdp[2][kBk / 8][4] = {};
  const T* const rows[2] = {wq, wdo};
  const T* const cols[2] = {tk, tv};
  score_products<2, kBk, D, kLd, kSmall>(sdp, rows, cols, lane);
  float(&sc)[kBk / 8][4] = sdp[0];
  float(&dp)[kBk / 8][4] = sdp[1];
  // Whether every (q, k) of this warp's tile is visible.
  const bool full = qrow0 + 16 <= s && k0 + kBk <= s &&
                    (!causal || k0 + kBk - 1 <= qrow0);
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qrow0 + g + 8 * (e >> 1);
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      float ds = 0.f;
      if (full || visible(row, col, s, causal)) {
        const float p = exp2f(fmaf(scale_log2, sc[j][e], -lse_r[e >> 1]));
        ds = p * (dp[j][e] - delta_r[e >> 1]);
      }
      sc[j][e] = ds;
    }
  }
  out_product<kBk, D, kLd, kSmall, 4>(dq_acc, sc, tk, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s,
                    int causal, float scale) {
  using Tiles = DqTiles<T, D>;
  constexpr int kBq = Tiles::kRowsQ, kBk = Tiles::kRowsK, kLd = Tiles::kLd;
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // [kBq][kLd]
  T* sdO = sQ + kBq * kLd;              // [kBq][kLd]
  T* sK = sdO + kBq * kLd;              // [2][kBk][kLd]
  T* sV = sK + 2 * kBk * kLd;           // [2][kBk][kLd]

  const int num_q = (s + kBq - 1) / kBq;
  const int q0 = (num_q - 1 - (int)blockIdx.x) * kBq;  // heaviest first
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t row_base = (size_t)blockIdx.y * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qrow0 = q0 + 16 * warp;  // this warp's first q row

  auto load_k_tile = [&](int kb, int stage) {
    cp_async_tile<kBk, D, kLd>(sK + stage * kBk * kLd, k + base, kb * kBk, s);
    cp_async_tile<kBk, D, kLd>(sV + stage * kBk * kLd, v + base, kb * kBk, s);
  };

  cp_async_tile<kBq, D, kLd>(sQ, q + base, q0, s);
  cp_async_tile<kBq, D, kLd>(sdO, dout + base, q0, s);
  load_k_tile(0, 0);
  cp_async_commit();

  // lse (in log2 units) and delta of this thread's rows qrow0 + g and
  // qrow0 + g + 8.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qrow0 + g + 8 * h;
    lse_r[h] = row < s ? kLog2e * lse[row_base + row] : 0.f;
    delta_r[h] = row < s ? delta[row_base + row] : 0.f;
  }

  const int num_k = (s + kBk - 1) / kBk;
  const int last_k =
      causal ? min((q0 + kBq - 1) / kBk, num_k - 1) : num_k - 1;
  float dq_acc[D / 8][4] = {};
  bool q_exact = true;
  for (int kb = 0; kb <= last_k; ++kb) {
    const int stage = kb & 1;
    const T* tk = sK + stage * kBk * kLd;
    const T* tv = sV + stage * kBk * kLd;
    cp_async_wait<0>();  // tile kb (and Q, dO) have landed
    // One barrier per tile: tile kb is visible to all, every warp is done
    // with tile kb - 1 (whose stage the next load refills), and all agree
    // whether the tile's operands are exact in TF32.
    bool exact = true;
    if constexpr (IsF32<T>::value) {
      if (kb == 0)
        q_exact = __syncthreads_and(tile_exact<kBq, D, kLd>(sQ) &&
                                    tile_exact<kBq, D, kLd>(sdO)) != 0;
      const bool tile_ok = __syncthreads_and(
          tile_exact<kBk, D, kLd>(tk) && tile_exact<kBk, D, kLd>(tv)) != 0;
      exact = q_exact && tile_ok;
    } else {
      __syncthreads();
    }
    if (kb + 1 <= last_k) load_k_tile(kb + 1, stage ^ 1);
    cp_async_commit();

    const int k0 = kb * kBk;
    if (qrow0 < s && (!causal || k0 <= qrow0 + 15)) {
      const T* wq = sQ + 16 * warp * kLd;
      const T* wdo = sdO + 16 * warp * kLd;
      if (exact)
        dq_tile<false, kBk, D, kLd>(dq_acc, wq, wdo, tk, tv, lse_r, delta_r,
                                    k0, qrow0, s, causal, scale, lane);
      else if constexpr (IsF32<T>::value)
        dq_tile<true, kBk, D, kLd>(dq_acc, wq, wdo, tk, tv, lse_r, delta_r,
                                   k0, qrow0, s, causal, scale, lane);
    }
  }

  store_rows<D>(dq + base, dq_acc, qrow0, s, scale, g, t);
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int bh, int s, int causal, float scale,
                   cudaStream_t stream) {
  using Tiles = DqTiles<T, D>;
  const dim3 grid((s + Tiles::kRowsQ - 1) / Tiles::kRowsQ, bh);
  return launch(flash_dq_kernel<T, D>, grid, Tiles::kSmem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dq), s, causal, scale);
}

template <typename T>
cudaError_t dispatch_dq(int d, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int bh, int s, int causal, float scale,
                        cudaStream_t stream) {
  switch (d) {
    case 32:
      return run_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale,
                           stream);
    case 64:
      return run_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale,
                           stream);
    case 128:
      return run_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, s, causal,
                            scale, stream);
  }
  return cudaErrorInvalidValue;
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
  if (dtype == 0)
    return dispatch_dq<float>(d, q, k, v, dout, l, dl, dq, bh, s, causal,
                              scale, st);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(d, q, k, v, dout, l, dl, dq, bh, s,
                                      causal, scale, st);
  return cudaErrorInvalidValue;
}
