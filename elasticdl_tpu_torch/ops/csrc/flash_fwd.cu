// Flash-attention forward on Hopper (sm_90a): O = softmax(scale * Q K^T) V
// by online softmax, and for training lse = m + log(l) per row (natural
// log), which the backward kernels read.
//
// Replaces the TPU kernel elasticdl_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_forward, pallas_call at :210). The TPU kernel walks a
// sequential (bh, q_block, k_block) grid and carries (m, l, acc) in VMEM
// scratch from one k step to the next; here one block owns one (bh, q tile)
// and the k walk is a loop inside it, with (m, l, acc) in registers. The
// TPU kernel multiplies Q by the scale before Q K^T; here the scale is
// applied to the scores in f32, so that Q stays as given (bfloat16 values
// stay exact in TF32, see below). The two differ by rounding only.
//
// Bound: two S x S x D products per head (Q K^T and P V, half of each
// under the causal mask) against 4 S D elements of compulsory traffic, so
// arithmetic. Both products run on the tensor cores as 3xTF32
// mma.sync.m16n8k8 (flash_mma.cuh): f32 accuracy at a ceiling of 495 / 3
// TFLOP/s, against 67 TFLOP/s for f32 FMA on the CUDA cores. Where Q and a
// K, V tile are exact in TF32 (the flagship LM's bfloat16 activations in
// f32 tensors, and all bfloat16 inputs), their zero small parts are
// skipped: 1 MMA per step of Q K^T in place of 3, and 2 per step of P V in
// place of 3 (P is never exact), with bitwise the same result.
//
// Tiling (FwdTiles, the same at every D): a block holds 128 q rows of Q in
// shared memory, one warp for each 16 of them; a warp keeps their O
// accumulator (16 x D), row maxima m and row sums l in registers. K and V
// stream in tiles of 64 rows, double-buffered with cp.async so that tile
// n + 1 loads while tile n is multiplied, with one barrier per tile. Per
// tile a warp computes S = Q K^T (16 x tile) into registers and takes the
// online softmax in the mma fragment layout: a thread holds rows g and
// g + 8, a row is spread over the 4 lanes of a quad, and row maxima take two
// xor-shuffles (row sums are kept per lane and summed over the quad once, at
// the end). m is kept in log2 units, with log2(e) folded into the scale, so
// p and the rescale factor alpha are single exp2s. Masked entries get p = 0
// by the visibility test, never through the exponent (kNegInf is finite). O
// is rescaled by alpha and P feeds O += P V straight from registers as the A
// operand: no score tile goes through shared memory. Causal tiles past a
// warp's rows are skipped, tiles past the block's rows never loaded, and q
// tiles are issued heaviest first across all heads (blockIdx.x walks the
// heads, blockIdx.y the q tiles), so the grid ends on light tiles; with the
// heads outermost it ended on each last head's heavy ones, 11% slower on the
// H100 at [4, 8, 4096, 128]. Shared memory (f32): 203 KB at D = 128 (Q
// 128 x 132 floats; K, V 2 stages x 2 x 64 x 132), one block per SM.
// Registers (-Xptxas -v): f32 255 / 208 / 168 at D = 128 / 64 / 32, bf16
// 253 / 193 / 124, no spills.
#include "flash_mma.cuh"

namespace edl_flash {

constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D>
struct FwdTiles {
  static constexpr int kRowsQ = 128;  // resident, 8 warps x 16
  static constexpr int kRowsK = 64;   // streamed
  static constexpr int kGroup = 4;    // output tiles per P V partial
  static constexpr int kLd = mma_ld<D, T>();
  static constexpr size_t kSmem =
      sizeof(T) * (size_t)(kRowsQ + 4 * kRowsK) * kLd;
};

// One warp's work on one K, V tile: S = Q K^T for its 16 q rows, the
// online-softmax update of (m, l, O), then O += P V. m is in log2 units
// and l holds this lane's share of the row sums. kSmall: whether Q, K and
// V need their small parts (false when they are TF32-exact).
template <bool kSmall, int kBk, int kGroup, int D, int kLd, typename T>
__device__ __forceinline__ void fwd_tile(float (&o_acc)[D / 8][4],
                                         float (&m_r)[2], float (&l_r)[2],
                                         const T* wq, const T* tk,
                                         const T* tv, int k0, int qrow0,
                                         int s, int causal, float scale_log2,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  // S, rows (q) of this warp; sc[j]: columns (k) [8j, 8j + 8).
  float s1[1][kBk / 8][4] = {};
  const T* const rows[1] = {wq};
  const T* const cols[1] = {tk};
  score_products<1, kBk, D, kLd, kSmall>(s1, rows, cols, lane);
  float(&sc)[kBk / 8][4] = s1[0];
  // Whether every (q, k) of this warp's tile is visible.
  const bool full = qrow0 + 16 <= s && k0 + kBk <= s &&
                    (!causal || k0 + kBk - 1 <= qrow0);
  // Scores in log2 units, and their row maxima over the visible entries;
  // element e of a fragment lies in row g + 8 * (e >> 1).
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] *= scale_log2;
      const int row = qrow0 + g + 8 * (e >> 1);
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      if (full || visible(row, col, s, causal))
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_r[h], mx[h]);
    alpha[h] = exp2f(m_r[h] - m_new);  // 0 when m_r is still kNegInf
    m_r[h] = m_new;
    l_r[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qrow0 + g + 8 * (e >> 1);
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      float p = 0.f;
      if (full || visible(row, col, s, causal))
        p = exp2f(sc[j][e] - m_r[e >> 1]);
      sc[j][e] = p;
      l_r[e >> 1] += p;
    }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] *= alpha[e >> 1];
  out_product<kBk, D, kLd, kSmall, kGroup>(o_acc, sc, tv, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int s, int causal,
                     float scale) {
  using Tiles = FwdTiles<T, D>;
  constexpr int kBq = Tiles::kRowsQ, kBk = Tiles::kRowsK, kLd = Tiles::kLd;
  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);  // [kBq][kLd]
  T* sK = sQ + kBq * kLd;               // [2][kBk][kLd]
  T* sV = sK + 2 * kBk * kLd;           // [2][kBk][kLd]

  const int num_q = (s + kBq - 1) / kBq;
  const int q_tile = blockIdx.y, bh = blockIdx.x;
  const int q0 = (num_q - 1 - q_tile) * kBq;  // heaviest first
  const size_t base = (size_t)bh * s * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qrow0 = q0 + 16 * warp;  // this warp's first q row
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x * log2(e))

  auto load_kv_tile = [&](int kb, int stage) {
    cp_async_tile<kBk, D, kLd>(sK + stage * kBk * kLd, k + base, kb * kBk,
                               s);
    cp_async_tile<kBk, D, kLd>(sV + stage * kBk * kLd, v + base, kb * kBk,
                               s);
  };

  cp_async_tile<kBq, D, kLd>(sQ, q + base, q0, s);
  load_kv_tile(0, 0);
  cp_async_commit();

  const int num_k = (s + kBk - 1) / kBk;
  const int last_k =
      causal ? min((q0 + kBq - 1) / kBk, num_k - 1) : num_k - 1;
  float o_acc[D / 8][4] = {};
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  bool q_exact = true;
  for (int kb = 0; kb <= last_k; ++kb) {
    const int stage = kb & 1;
    const T* tk = sK + stage * kBk * kLd;
    const T* tv = sV + stage * kBk * kLd;
    cp_async_wait<0>();  // tile kb (and Q) have landed
    // One barrier per tile: tile kb is visible to all, every warp is done
    // with tile kb - 1 (whose stage the next load refills), and all agree
    // whether the tile's operands are exact in TF32.
    bool exact = true;
    if constexpr (IsF32<T>::value) {
      if (kb == 0)
        q_exact = __syncthreads_and(tile_exact<kBq, D, kLd>(sQ)) != 0;
      // Once Q is not exact (block-uniform), the tiles are not read.
      exact = __syncthreads_and(q_exact && tile_exact<kBk, D, kLd>(tk) &&
                                tile_exact<kBk, D, kLd>(tv)) != 0;
    } else {
      __syncthreads();
    }
    if (kb + 1 <= last_k) load_kv_tile(kb + 1, stage ^ 1);
    cp_async_commit();

    const int k0 = kb * kBk;
    if (qrow0 < s && (!causal || k0 <= qrow0 + 15)) {
      const T* wq = sQ + 16 * warp * kLd;
      if (exact)
        fwd_tile<false, kBk, Tiles::kGroup, D, kLd>(
            o_acc, m_r, l_r, wq, tk, tv, k0, qrow0, s, causal, scale_log2,
            lane);
      else if constexpr (IsF32<T>::value)
        fwd_tile<true, kBk, Tiles::kGroup, D, kLd>(
            o_acc, m_r, l_r, wq, tk, tv, k0, qrow0, s, causal, scale_log2,
            lane);
    }
  }

  // Row sums over the quad; rows that saw no visible column (past s) keep
  // l == 0 and are guarded as in the TPU kernel.
  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    l_safe[h] = l_r[h] == 0.f ? 1.f : l_r[h];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] /= l_safe[e >> 1];
  store_rows<D>(o + base, o_acc, qrow0, s, 1.f, g, t);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qrow0 + g + 8 * h;
      if (row < s)  // back to natural-log units
        lse[(size_t)bh * s + row] =
            kLn2 * (m_r[h] + log2f(l_safe[h]));
    }
  }
}

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, int bh, int s, int causal, float scale,
                    cudaStream_t stream) {
  using Tiles = FwdTiles<T, D>;
  const dim3 grid(bh, (s + Tiles::kRowsQ - 1) / Tiles::kRowsQ);
  return launch(flash_fwd_kernel<T, D>, grid, Tiles::kSmem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), lse, s, causal,
                scale);
}

template <typename T>
cudaError_t dispatch_fwd(int d, const void* q, const void* k, const void* v,
                         void* o, float* lse, int bh, int s, int causal,
                         float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return run_fwd<T, 32>(q, k, v, o, lse, bh, s, causal, scale, stream);
    case 64:
      return run_fwd<T, 64>(q, k, v, o, lse, bh, s, causal, scale, stream);
    case 128:
      return run_fwd<T, 128>(q, k, v, o, lse, bh, s, causal, scale, stream);
  }
  return cudaErrorInvalidValue;
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
  if (dtype == 0)
    return dispatch_fwd<float>(d, q, k, v, o, l, bh, s, causal, scale, st);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(d, q, k, v, o, l, bh, s, causal, scale,
                                       st);
  return cudaErrorInvalidValue;
}
