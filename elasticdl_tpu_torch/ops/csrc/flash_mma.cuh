// Tensor-core building blocks of the flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): the 3xTF32 split, mma.sync.m16n8k8 TF32,
// fragment loads from padded shared memory, accumulators reused as A
// fragments, and cp.async tile copies.
//
// 3xTF32. An f32 value x splits in registers into big = tf32(x) (round to
// nearest, ties away, as cvt.rna) and small = x - big; the tensor core
// reads only the top 19 bits of small, so its own truncation is below
// 2^-21 |x|. A product is a_small*b_big + a_big*b_small + a_big*b_big,
// accumulated in f32: three TF32 MMAs per tile step, relative error near
// 2^-21 (TF32 alone: 2^-11).
// An operand that is exact in TF32 (bfloat16 inputs, and f32 tiles whose
// low 13 mantissa bits are all zero, tile_exact) has a zero small part:
// its split is skipped and the MMA that would multiply its small part is
// not issued (kSmall = false). Adding zero products leaves an accumulator
// unchanged, so the result is bitwise the same as the full 3xTF32 path.
// The flagship LM casts bfloat16 activations to f32 before attention, so
// its Q, K, V and dO tiles all take this path.
//
// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4):
//   A 16 x 8 (row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8 x 8 (k x n):      b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C 16 x 8:             c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                         c3 (g+8, 2t+1)
// An accumulator feeds the next product as its A fragment without any
// shuffle: the contraction index k is taken in the order 2t, 2t+1 in place
// of t, t+4 (a0 = c0, a1 = c2, a2 = c1, a3 = c3), and the B fragment of
// that product reads its rows in the same order (load_b_cols). A sum over k
// does not depend on the order of its terms' indices, only on both operands
// agreeing on it.
//
// Shared-memory tiles are [rows][D] of the input type T with a row stride
// of D elements plus 16 bytes, i.e. 4 words more than a multiple of 32
// banks. Every fragment load below is then free of bank conflicts: an
// ldmatrix tile's eight 16-byte rows fall in eight distinct 16-byte bank
// groups; 32-bit loads of rows g (8 of them) and columns 2t (4) touch
// words 4g + t, and loads of rows 2t, 2t+1 and columns g banks 8t + g and
// 8t+4 + g (for bfloat16, pairs of lanes share a word).
#pragma once

#include "flash_common.cuh"

namespace edl_flash {

template <typename T>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

constexpr float kLog2e = 1.4426950408889634f;

// Row stride, in elements, of a [rows][D] tile of T in shared memory.
template <int D, typename T>
constexpr int mma_ld() {
  return D + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Two neighbouring bfloat16 values (4-byte aligned) as floats.
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// tf32(x) rounded to nearest, ties away from zero: the bits of
// cvt.rna.tf32.f32 for finite x (a NaN or Inf input still yields NaN
// outputs). sm_90 has no single instruction for that cvt, and ptxas
// expands it with NaN and Inf checks; two integer operations do the same
// rounding (measured on the H100: dQ and dK/dV 12.5% faster, outputs
// bitwise equal).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// x = big + small; with kSmall false, x must be exact in TF32.
template <bool kSmall>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  if (kSmall) {
    big = tf32_rna(x);
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}


__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32; the small terms go first, as CUTLASS's
// OpMultiplyAddFastF32 orders them.
template <bool kSmallA, bool kSmallB>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  if (kSmallA) mma_tf32(d, a.small, b.big);
  if (kSmallB) mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// ldmatrix.x4 reads four 8 x 8 matrices of 16-bit elements, which are four
// 8 x 4 tiles of f32: lane l gives the address of row l % 8 of tile l / 8
// and receives in r[m] element (l / 4, l % 4) of tile m, the (g, t) of an
// mma fragment. One instruction in place of four 32-bit loads; each tile's
// eight 16-byte rows fall in distinct banks with the padded row stride.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment: rows [0, 16) and columns [k, k + 8) of a tile (row stride LD).
template <bool kSmall, int LD, typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* tile, int k,
                                       int lane) {
  if constexpr (IsF32<T>::value) {
    const int m = lane >> 3, r = lane & 7;
    uint32_t x[4];
    ldsm_x4(x, tile + (r + 8 * (m & 1)) * LD + k + 4 * (m >> 1));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split<kSmall>(__uint_as_float(x[i]), f.big[i], f.small[i]);
  } else {
    // bfloat16: one 32-bit load per row takes columns 2t and 2t + 1, used
    // as k = t and t + 4 (the same order as load_b_rows2's).
    const T* p = tile + (lane >> 2) * LD + k + 2 * (lane & 3);
    const float2 lo = load_pair(p), hi = load_pair(p + 8 * LD);
    split<kSmall>(lo.x, f.big[0], f.small[0]);
    split<kSmall>(hi.x, f.big[1], f.small[1]);
    split<kSmall>(lo.y, f.big[2], f.small[2]);
    split<kSmall>(hi.y, f.big[3], f.small[3]);
  }
}

// B fragments of X Y^T for columns [n0, n0 + 8) and [n0 + 8, n0 + 16):
// B[k][n] = Y[n0 + n][k0 + k], Y a row-major tile.
template <bool kSmall, int LD, typename T>
__device__ __forceinline__ void load_b_rows2(FragB (&f)[2], const T* tile,
                                             int n0, int k0, int lane) {
  if constexpr (IsF32<T>::value) {
    const int m = lane >> 3, r = lane & 7;
    uint32_t x[4];
    ldsm_x4(x, tile + (n0 + r + 8 * (m >> 1)) * LD + k0 + 4 * (m & 1));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split<kSmall>(__uint_as_float(x[i]), f[i >> 1].big[i & 1],
                    f[i >> 1].small[i & 1]);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = load_pair(tile + (n0 + 8 * h + (lane >> 2)) * LD + k0 +
                                 2 * (lane & 3));
      split<kSmall>(x.x, f[h].big[0], f[h].small[0]);
      split<kSmall>(x.y, f[h].big[1], f[h].small[1]);
    }
  }
}

// B fragment of X Y with k in the accumulator order (see the note):
// B[k][n] = Y[k0 + 2t (+1)][n0 + n], Y a row-major tile.
template <bool kSmall, int LD, typename T>
__device__ __forceinline__ void load_b_cols(FragB& f, const T* tile, int k0,
                                            int n0, int g, int t) {
  const T* p = tile + (k0 + 2 * t) * LD + n0 + g;
  split<kSmall>(to_f32(p[0]), f.big[0], f.small[0]);
  split<kSmall>(to_f32(p[LD]), f.big[1], f.small[1]);
}

// An m16n8 accumulator as the A fragment (16 x 8) of the next product.
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split<true>(c[0], f.big[0], f.small[0]);
  split<true>(c[2], f.big[1], f.small[1]);
  split<true>(c[1], f.big[2], f.small[2]);
  split<true>(c[3], f.big[3], f.small[3]);
}

// A long chain of MMAs into one accumulator loses accuracy: the tensor
// core does not round its f32 sums to nearest. On the H100, dQ at S = 1000
// erred 1.8e-5 relative with chains of 375 MMAs, and 3.7e-6 with the
// partials below. The products therefore run each short chain (16 of the
// contraction index in score_products, one streamed tile in out_product)
// into a zeroed partial and add the partial to the accumulator in f32 with
// round-to-nearest.

// Score-side products of one warp, sharing a pass over D:
//   acc[i] += R_i C_i^T for i < kP
// (the forward takes one, the backward kernels two), R_i pointing at the
// warp's 16 rows, C_i at N rows; each acc[i][j] is the m16n8 tile of
// columns [8j, 8j + 8). The products' loads and MMAs are interleaved.
template <int kP, int N, int D, int LD, bool kSmall, typename T>
__device__ __forceinline__ void score_products(float (&acc)[kP][N / 8][4],
                                               const T* const (&r)[kP],
                                               const T* const (&c)[kP],
                                               int lane) {
  static_assert(D % 16 == 0 && N % 16 == 0, "tiles of 16");
#pragma unroll 1
  for (int k = 0; k < D; k += 16) {
    FragA a[kP][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kP; ++i)
        load_a<kSmall, LD>(a[i][h], r[i], k + 8 * h, lane);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      float p[kP][2][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        FragB b[kP][2];
#pragma unroll
        for (int i = 0; i < kP; ++i)
          load_b_rows2<kSmall, LD>(b[i], c[i], 8 * j, k + 8 * h, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < kP; ++i)
            mma_3xtf32<kSmall, kSmall>(p[i][jj], a[i][h], b[i][jj]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < kP; ++i) acc[i][j + jj][e] += p[i][jj][e];
    }
  }
}

// Output-side product of one warp: out += X Y, X the 16 x N accumulators
// `x` (f32, from registers), Y the first N rows of a [N][D] tile. Output
// tiles go in groups of kGroup, whose partials are independent MMA chains;
// X is split again for each group rather than held split.
template <int N, int D, int LD, bool kSmall, int kGroup, typename T>
__device__ __forceinline__ void out_product(float (&out)[D / 8][4],
                                            const float (&x)[N / 8][4],
                                            const T* y, int lane) {
  static_assert((D / 8) % kGroup == 0, "whole groups");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j0 = 0; j0 < D / 8; j0 += kGroup) {
    float part[kGroup][4] = {};
#pragma unroll
    for (int ks = 0; ks < N / 8; ++ks) {
      FragA a;
      acc_to_a(a, x[ks]);
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        FragB b;
        load_b_cols<kSmall, LD>(b, y, 8 * ks, 8 * (j0 + jj), g, t);
        mma_3xtf32<true, kSmall>(part[jj], a, b);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kGroup; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[j0 + jj][e] += part[jj][e];
  }
}

// ---------- cp.async ----------

// 16 bytes global -> shared; zero-filled when !valid (the ragged edge),
// with `gmem` still a valid address.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a row-major [s, D] matrix into a tile with
// row stride LD; rows at or past s are zero-filled. 16 bytes per copy,
// neighbouring threads on neighbouring addresses.
template <int ROWS, int D, int LD, typename T>
__device__ __forceinline__ void cp_async_tile(T* dst, const T* src, int row0,
                                              int s) {
  constexpr int kChunk = 16 / (int)sizeof(T);
  constexpr int kPerRow = D / kChunk;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * kChunk;
    const bool valid = row0 + r < s;
    cp_async16(dst + r * LD + c, src + (size_t)(valid ? row0 + r : 0) * D + c,
               valid);
  }
}

// Whether the 16-byte chunks of a tile that this thread copied with
// cp_async_tile (visible to it after cp_async_wait) are exact in TF32.
template <int ROWS, int D, int LD>
__device__ __forceinline__ bool tile_exact(const float* tile) {
  constexpr int kPerRow = D / 4;
  uint32_t bits = 0;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const uint4 x = *reinterpret_cast<const uint4*>(
        tile + r * LD + (idx - r * kPerRow) * 4);
    bits |= x.x | x.y | x.z | x.w;
  }
  return (bits & 0x1fffu) == 0;
}

// Entries [row0, row0 + ROWS) of a float vector of length s; zeros past s.
template <int ROWS>
__device__ __forceinline__ void cp_async_rows(float* dst, const float* src,
                                              int row0, int s) {
  if (threadIdx.x < ROWS) {
    const int r = row0 + (int)threadIdx.x;
    const bool valid = r < s;
    cp_async4(dst + threadIdx.x, src + (valid ? r : 0), valid);
  }
}

// ---------- epilogue ----------

// Writes a warp's 16 x D accumulators, times `mul`, to rows [row0, row0+16)
// of a row-major [s, D] matrix; rows at or past s are not written.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4],
                                           int row0, int s, float mul, int g,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + (size_t)row * D + 8 * j + 2 * t, acc[j][2 * half] * mul,
             acc[j][2 * half + 1] * mul);
  }
}

}  // namespace edl_flash
