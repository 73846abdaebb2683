// Flash-attention backward, dK/dV pass, on Hopper (sm_90a). For each k
// tile, over the q tiles that see it:
//   P^T  = exp(scale * K Q^T - lse)          (recomputed, held transposed)
//   dV  += P^T dO
//   dS^T = P^T * (V dO^T - delta)
//   dK  += scale * dS^T Q
//
// Replaces the TPU kernel elasticdl_tpu/ops/flash_attention.py:_dkv_kernel
// (pallas_call at :387, launcher _flash_backward). Each k tile's dK and dV
// are written by exactly one block (no atomics, so results are bitwise
// deterministic); the TPU's sequential q grid axis becomes a loop inside
// the block, starting at the first q tile that sees this k tile.
//
// Bound: four S x S x D products per head, so arithmetic. The products run
// on the tensor cores as 3xTF32 mma.sync.m16n8k8 (flash_mma.cuh), which
// keeps f32 accuracy at a ceiling of 495 / 3 TFLOP/s, against 67 TFLOP/s
// for f32 FMA on the CUDA cores. Where a q tile and the K, V tile are exact
// in TF32 (the flagship LM's bfloat16 activations in f32 tensors), the
// zero small parts are skipped: 6 MMAs per tile step in place of 12, with
// bitwise the same result.
//
// Tiling: a block of 8 warps holds 128 k rows of K and V in shared memory;
// each warp owns 16 of them. It streams q tiles of 32 rows (D = 128) or 64
// (D <= 64) of Q, dO, lse and delta, double-buffered with cp.async so that
// tile n + 1 loads while tile n is multiplied. Per q tile a warp computes
// its S^T and dP^T (16 x q-tile) in registers, turns them into P^T and dS^T
// in place, and feeds them straight from registers as the A operands of
// the dV and dK products; no score tile goes through shared memory, and
// the only barrier is one per streamed tile. dK and dV (16 x D per warp)
// stay in registers. Warps whose 16 rows the causal mask hides from a
// whole q tile skip it. Occupancy: one block (8 warps) per SM. Shared
// memory (f32) is 203 KB at D = 128 (K, V 2 x 128 x 132 floats; Q, dO
// 2 stages x 2 x 32 x 132) and 139 KB at D = 64. Registers (-Xptxas -v):
// 255 per thread for f32, 182-255 for bf16; the D = 128 accumulators alone
// (dK, dV: 128; S^T, dP^T: 32) take 160, which is what sets the q-tile
// height. f32 at D = 128 spills 16 bytes. The variants measured without
// that spill were slower on the H100: a 16-row q tile by 6%, and TF32
// rounding by cvt.rna with expf by 15%; so the spill stays.
#include "flash_mma.cuh"

namespace edl_flash {

template <typename T, int D>
struct DkvTiles {
  static constexpr int kRowsK = 128;                 // resident, 8 warps x 16
  static constexpr int kRowsQ = D == 128 ? 32 : 64;  // streamed
  static constexpr int kLd = mma_ld<D, T>();
  static constexpr size_t kSmem =
      sizeof(T) * (size_t)(2 * kRowsK + 4 * kRowsQ) * kLd +
      sizeof(float) * 4 * kRowsQ;
};

// One warp's work on one q tile: S^T and dP^T for its 16 k rows, then P^T
// and dS^T in place, then dV += P^T dO and dK += dS^T Q. kSmall: whether
// Q, dO, K and V need their small parts (false when they are TF32-exact).
template <bool kSmall, int kBq, int D, int kLd, typename T>
__device__ __forceinline__ void dkv_tile(float (&dk_acc)[D / 8][4],
                                         float (&dv_acc)[D / 8][4],
                                         const T* wk, const T* wv,
                                         const T* tq, const T* tdo,
                                         const float* tl, const float* td,
                                         int q0, int krow0, int s, int causal,
                                         float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x * log2(e))
  // S^T and dP^T, rows (k) of this warp; st[j]: columns (q) [8j, 8j + 8).
  float sdpt[2][kBq / 8][4] = {};
  const T* const rows[2] = {wk, wv};
  const T* const cols[2] = {tq, tdo};
  score_products<2, kBq, D, kLd, kSmall>(sdpt, rows, cols, lane);
  float(&st)[kBq / 8][4] = sdpt[0];
  float(&dpt)[kBq / 8][4] = sdpt[1];
  // Whether every (q, k) of this warp's tile is visible.
  const bool full = q0 + kBq <= s && krow0 + 16 <= s &&
                    (!causal || q0 >= krow0 + 15);
#pragma unroll
  for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int krow = krow0 + g + 8 * (e >> 1);
      const int qc = 8 * j + 2 * t + (e & 1);
      float p = 0.f, ds = 0.f;
      if (full || visible(q0 + qc, krow, s, causal)) {
        p = exp2f(fmaf(scale_log2, st[j][e], -kLog2e * tl[qc]));
        ds = p * (dpt[j][e] - td[qc]);
      }
      st[j][e] = p;
      dpt[j][e] = ds;
    }
  }
  // D = 128: groups of two keep dK, dV, P^T, dS^T and the partials in 255
  // registers without spilling.
  constexpr int kGroup = D == 128 ? 2 : 4;
  out_product<kBq, D, kLd, kSmall, kGroup>(dv_acc, st, tdo, lane);
  out_product<kBq, D, kLd, kSmall, kGroup>(dk_acc, dpt, tq, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int s, int causal, float scale) {
  using Tiles = DkvTiles<T, D>;
  constexpr int kBk = Tiles::kRowsK, kBq = Tiles::kRowsQ, kLd = Tiles::kLd;
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);  // [kBk][kLd]
  T* sV = sK + kBk * kLd;               // [kBk][kLd]
  T* sQ = sV + kBk * kLd;               // [2][kBq][kLd]
  T* sdO = sQ + 2 * kBq * kLd;          // [2][kBq][kLd]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kBq * kLd);  // [2][kBq]
  float* sDelta = sLse + 2 * kBq;                               // [2][kBq]

  const int k0 = (int)blockIdx.x * kBk;  // causal: heaviest tiles first
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t row_base = (size_t)blockIdx.y * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int krow0 = k0 + 16 * warp;  // this warp's first k row

  auto load_q_tile = [&](int qb, int stage) {
    const int q0 = qb * kBq;
    cp_async_tile<kBq, D, kLd>(sQ + stage * kBq * kLd, q + base, q0, s);
    cp_async_tile<kBq, D, kLd>(sdO + stage * kBq * kLd, dout + base, q0, s);
    cp_async_rows<kBq>(sLse + stage * kBq, lse + row_base, q0, s);
    cp_async_rows<kBq>(sDelta + stage * kBq, delta + row_base, q0, s);
  };

  const int num_q = (s + kBq - 1) / kBq;
  const int first_q = causal ? k0 / kBq : 0;
  cp_async_tile<kBk, D, kLd>(sK, k + base, k0, s);
  cp_async_tile<kBk, D, kLd>(sV, v + base, k0, s);
  load_q_tile(first_q, 0);
  cp_async_commit();

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  bool kv_exact = true;
  for (int qb = first_q; qb < num_q; ++qb) {
    const int stage = (qb - first_q) & 1;
    const T* tq = sQ + stage * kBq * kLd;
    const T* tdo = sdO + stage * kBq * kLd;
    cp_async_wait<0>();  // tile qb (and K, V) have landed
    // One barrier per tile: tile qb is visible to all, every warp is done
    // with tile qb - 1 (whose stage the next load refills), and all agree
    // whether the tile's operands are exact in TF32.
    bool exact = true;
    if constexpr (IsF32<T>::value) {
      if (qb == first_q)
        kv_exact = __syncthreads_and(tile_exact<kBk, D, kLd>(sK) &&
                                     tile_exact<kBk, D, kLd>(sV)) != 0;
      const bool tile_ok = __syncthreads_and(
          tile_exact<kBq, D, kLd>(tq) && tile_exact<kBq, D, kLd>(tdo)) != 0;
      exact = kv_exact && tile_ok;
    } else {
      __syncthreads();
    }
    if (qb + 1 < num_q) load_q_tile(qb + 1, stage ^ 1);
    cp_async_commit();

    const int q0 = qb * kBq;
    if (krow0 < s && (!causal || q0 + kBq - 1 >= krow0)) {
      const T* wk = sK + 16 * warp * kLd;
      const T* wv = sV + 16 * warp * kLd;
      const float* tl = sLse + stage * kBq;
      const float* td = sDelta + stage * kBq;
      if (exact)
        dkv_tile<false, kBq, D, kLd>(dk_acc, dv_acc, wk, wv, tq, tdo, tl, td,
                                     q0, krow0, s, causal, scale, lane);
      else if constexpr (IsF32<T>::value)
        dkv_tile<true, kBq, D, kLd>(dk_acc, dv_acc, wk, wv, tq, tdo, tl, td,
                                    q0, krow0, s, causal, scale, lane);
    }
  }

  const int g = lane >> 2, t = lane & 3;
  store_rows<D>(dk + base, dk_acc, krow0, s, scale, g, t);
  store_rows<D>(dv + base, dv_acc, krow0, s, 1.f, g, t);
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int bh, int s, int causal, float scale,
                    cudaStream_t stream) {
  using Tiles = DkvTiles<T, D>;
  const dim3 grid((s + Tiles::kRowsK - 1) / Tiles::kRowsK, bh);
  return launch(flash_dkv_kernel<T, D>, grid, Tiles::kSmem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dk), static_cast<T*>(dv), s, causal,
                scale);
}

template <typename T>
cudaError_t dispatch_dkv(int d, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int bh, int s,
                         int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return run_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal,
                            scale, stream);
    case 64:
      return run_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal,
                            scale, stream);
    case 128:
      return run_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal,
                             scale, stream);
  }
  return cudaErrorInvalidValue;
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
  if (dtype == 0)
    return dispatch_dkv<float>(d, q, k, v, dout, l, dl, dk, dv, bh, s, causal,
                               scale, st);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(d, q, k, v, dout, l, dl, dk, dv, bh, s,
                                       causal, scale, st);
  return cudaErrorInvalidValue;
}
