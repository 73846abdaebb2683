// Host optimizer kernels of the parameter-server store: a copy of
// elasticdl_tpu/native/kernels.cc (without its record reader), so the two
// packages apply the same updates bit for bit when built with the same flags.
//
// Embedding tables live in one contiguous [capacity, dim] float buffer per
// table, so a sparse update is a single C call taking (row_indices, k, dim)
// and looping rows natively. Dense updates are plain restrict-qualified
// loops that g++ -O3 vectorizes.

#include <cmath>
#include <cstdint>

extern "C" {

// ---------- dense ----------

void edl_sgd(const float* __restrict g, float* __restrict p, float lr,
             int64_t n) {
  for (int64_t i = 0; i < n; ++i) p[i] -= lr * g[i];
}

void edl_momentum(const float* __restrict g, float* __restrict p,
                  float* __restrict vel, float lr, float mu, int nesterov,
                  int64_t n) {
  if (nesterov) {
    for (int64_t i = 0; i < n; ++i) {
      vel[i] = mu * vel[i] + g[i];
      p[i] -= lr * (g[i] + mu * vel[i]);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      vel[i] = mu * vel[i] + g[i];
      p[i] -= lr * vel[i];
    }
  }
}

// step is 1-based; lr is pre-scaled here by the bias correction so the hot
// loop stays multiply-add only. max_sq == nullptr means plain Adam; non-null
// enables amsgrad.
void edl_adam(const float* __restrict g, float* __restrict p,
              float* __restrict m, float* __restrict v,
              float* __restrict max_sq, float lr, int64_t step, float b1,
              float b2, float eps, int64_t n) {
  const float corrected_lr =
      lr * std::sqrt(1.0f - std::pow(b2, (float)step)) /
      (1.0f - std::pow(b1, (float)step));
  const float one_m_b1 = 1.0f - b1;
  const float one_m_b2 = 1.0f - b2;
  if (max_sq) {
    for (int64_t i = 0; i < n; ++i) {
      m[i] = b1 * m[i] + one_m_b1 * g[i];
      v[i] = b2 * v[i] + one_m_b2 * g[i] * g[i];
      max_sq[i] = max_sq[i] > v[i] ? max_sq[i] : v[i];
      p[i] -= corrected_lr * m[i] / (std::sqrt(max_sq[i]) + eps);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      m[i] = b1 * m[i] + one_m_b1 * g[i];
      v[i] = b2 * v[i] + one_m_b2 * g[i] * g[i];
      p[i] -= corrected_lr * m[i] / (std::sqrt(v[i]) + eps);
    }
  }
}

void edl_adagrad(const float* __restrict g, float* __restrict p,
                 float* __restrict accum, float lr, float eps, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    accum[i] += g[i] * g[i];
    p[i] -= lr * g[i] / (std::sqrt(accum[i]) + eps);
  }
}

// ---------- row-indexed (sparse) over a [capacity, dim] table slab ----------
// grads: [k, dim]; rows[j] selects the slab row updated by grads[j].
// Duplicate rows are legal and applied sequentially in order.

void edl_sgd_indexed(const float* __restrict grads,
                     const int64_t* __restrict rows, int64_t k, int64_t dim,
                     float* __restrict table, float lr) {
  for (int64_t j = 0; j < k; ++j) {
    float* p = table + rows[j] * dim;
    const float* g = grads + j * dim;
    for (int64_t i = 0; i < dim; ++i) p[i] -= lr * g[i];
  }
}

void edl_momentum_indexed(const float* __restrict grads,
                          const int64_t* __restrict rows, int64_t k,
                          int64_t dim, float* __restrict table,
                          float* __restrict vel_table, float lr, float mu,
                          int nesterov) {
  for (int64_t j = 0; j < k; ++j) {
    const int64_t off = rows[j] * dim;
    float* p = table + off;
    float* vel = vel_table + off;
    const float* g = grads + j * dim;
    if (nesterov) {
      for (int64_t i = 0; i < dim; ++i) {
        vel[i] = mu * vel[i] + g[i];
        p[i] -= lr * (g[i] + mu * vel[i]);
      }
    } else {
      for (int64_t i = 0; i < dim; ++i) {
        vel[i] = mu * vel[i] + g[i];
        p[i] -= lr * vel[i];
      }
    }
  }
}

void edl_adam_indexed(const float* __restrict grads,
                      const int64_t* __restrict rows, int64_t k, int64_t dim,
                      float* __restrict table, float* __restrict m_table,
                      float* __restrict v_table,
                      float* __restrict max_sq_table, float lr, int64_t step,
                      float b1, float b2, float eps) {
  const float corrected_lr =
      lr * std::sqrt(1.0f - std::pow(b2, (float)step)) /
      (1.0f - std::pow(b1, (float)step));
  const float one_m_b1 = 1.0f - b1;
  const float one_m_b2 = 1.0f - b2;
  for (int64_t j = 0; j < k; ++j) {
    const int64_t off = rows[j] * dim;
    float* p = table + off;
    float* m = m_table + off;
    float* v = v_table + off;
    const float* g = grads + j * dim;
    if (max_sq_table) {
      float* ms = max_sq_table + off;
      for (int64_t i = 0; i < dim; ++i) {
        m[i] = b1 * m[i] + one_m_b1 * g[i];
        v[i] = b2 * v[i] + one_m_b2 * g[i] * g[i];
        ms[i] = ms[i] > v[i] ? ms[i] : v[i];
        p[i] -= corrected_lr * m[i] / (std::sqrt(ms[i]) + eps);
      }
    } else {
      for (int64_t i = 0; i < dim; ++i) {
        m[i] = b1 * m[i] + one_m_b1 * g[i];
        v[i] = b2 * v[i] + one_m_b2 * g[i] * g[i];
        p[i] -= corrected_lr * m[i] / (std::sqrt(v[i]) + eps);
      }
    }
  }
}

void edl_adagrad_indexed(const float* __restrict grads,
                         const int64_t* __restrict rows, int64_t k,
                         int64_t dim, float* __restrict table,
                         float* __restrict accum_table, float lr, float eps) {
  for (int64_t j = 0; j < k; ++j) {
    const int64_t off = rows[j] * dim;
    float* p = table + off;
    float* a = accum_table + off;
    const float* g = grads + j * dim;
    for (int64_t i = 0; i < dim; ++i) {
      a[i] += g[i] * g[i];
      p[i] -= lr * g[i] / (std::sqrt(a[i]) + eps);
    }
  }
}

// ---------- table maintenance ----------

// Gather rows out of a slab into out[k, dim] (embedding lookup hot path).
void edl_gather_rows(const float* __restrict table,
                     const int64_t* __restrict rows, int64_t k, int64_t dim,
                     float* __restrict out) {
  for (int64_t j = 0; j < k; ++j) {
    const float* src = table + rows[j] * dim;
    float* dst = out + j * dim;
    for (int64_t i = 0; i < dim; ++i) dst[i] = src[i];
  }
}

// Scatter rows into a slab (checkpoint restore / worker re-seed path).
void edl_scatter_rows(float* __restrict table,
                      const int64_t* __restrict rows, int64_t k, int64_t dim,
                      const float* __restrict values) {
  for (int64_t j = 0; j < k; ++j) {
    float* dst = table + rows[j] * dim;
    const float* src = values + j * dim;
    for (int64_t i = 0; i < dim; ++i) dst[i] = src[i];
  }
}

// xorshift64* uniform init in [lo, hi) — the lazy per-id embedding init
// (reference lazily seeds rows uniform [-0.05, 0.05],
// go/pkg/common/embedding_table.go:41-58).
void edl_uniform_init(float* __restrict dst, int64_t n, float lo, float hi,
                      uint64_t seed) {
  uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
  const float scale = (hi - lo) / 16777216.0f;  // 2^24
  for (int64_t i = 0; i < n; ++i) {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    uint64_t r = s * 0x2545F4914F6CDD1Dull;
    dst[i] = lo + scale * (float)(r >> 40);  // top 24 bits
  }
}

}  // extern "C"
