// Id->row map, bulk row initializers and the sparse-gradient dedup-sum of
// the parameter-server store: a copy of elasticdl_tpu/native/idmap.cc, so
// both packages map the same ids to the same rows and create the same rows
// bit for bit.
//
// EdlIdMap is an open-addressing (linear probe, power-of-two, splitmix64)
// int64 -> row-index hash map that also keeps the insertion-ordered id list:
// row i was created by the i-th distinct id ever seen, so exporting a page
// of rows is a straight slab slice. INT64_MIN is the reserved empty-slot
// sentinel (embedding ids are hashes/offsets, never INT64_MIN).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int64_t kEmpty = INT64_MIN;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct IdMap {
  std::vector<int64_t> slot_ids;   // kEmpty or the id stored in this slot
  std::vector<int64_t> slot_rows;  // row index parallel to slot_ids
  std::vector<int64_t> order;      // insertion-ordered ids (row i -> order[i])
  uint64_t mask = 0;

  explicit IdMap(int64_t cap_hint) {
    uint64_t cap = 64;
    while ((int64_t)cap < cap_hint * 2) cap <<= 1;
    slot_ids.assign(cap, kEmpty);
    slot_rows.assign(cap, 0);
    mask = cap - 1;
  }

  void grow() {
    const uint64_t cap = (mask + 1) << 1;
    std::vector<int64_t> ids(cap, kEmpty), rows(cap, 0);
    const uint64_t m = cap - 1;
    for (uint64_t i = 0; i <= mask; ++i) {
      if (slot_ids[i] == kEmpty) continue;
      uint64_t j = splitmix64((uint64_t)slot_ids[i]) & m;
      while (ids[j] != kEmpty) j = (j + 1) & m;
      ids[j] = slot_ids[i];
      rows[j] = slot_rows[i];
    }
    slot_ids.swap(ids);
    slot_rows.swap(rows);
    mask = m;
  }

  // Row index for id, creating the next row if absent (and allowed).
  int64_t row_for(int64_t id, bool create) {
    uint64_t j = splitmix64((uint64_t)id) & mask;
    while (slot_ids[j] != kEmpty) {
      if (slot_ids[j] == id) return slot_rows[j];
      j = (j + 1) & mask;
    }
    if (!create) return -1;
    const int64_t row = (int64_t)order.size();
    slot_ids[j] = id;
    slot_rows[j] = row;
    order.push_back(id);
    // Keep load factor under 1/2 so probes stay short.
    if ((uint64_t)order.size() * 2 > mask) grow();
    return row;
  }
};

}  // namespace

extern "C" {

void* edl_idmap_new(int64_t cap_hint) {
  return new IdMap(cap_hint > 0 ? cap_hint : 1);
}

void edl_idmap_free(void* h) { delete (IdMap*)h; }

int64_t edl_idmap_size(void* h) { return (int64_t)((IdMap*)h)->order.size(); }

// rows_out[i] = row index of ids[i]; unseen ids get fresh sequential rows
// when create_missing, else -1. Returns the map size AFTER the call, so the
// caller knows the new rows are exactly [old_size, returned_size).
int64_t edl_idmap_rows_for_ids(void* h, const int64_t* ids, int64_t n,
                               int create_missing, int64_t* rows_out) {
  IdMap* m = (IdMap*)h;
  const bool create = create_missing != 0;
  for (int64_t i = 0; i < n; ++i) rows_out[i] = m->row_for(ids[i], create);
  return (int64_t)m->order.size();
}

// Insertion-ordered ids [start, start+count) -> out (checkpoint export).
void edl_idmap_export_ids(void* h, int64_t start, int64_t count,
                          int64_t* out) {
  IdMap* m = (IdMap*)h;
  for (int64_t i = 0; i < count; ++i) out[i] = m->order[start + i];
}

// ---------- bulk lazy row init ----------
// Same per-row seed schedule as EmbeddingTable._init_row (table_seed *
// 0x9E3779B1 + row + 1) feeding the same xorshift64* generator as
// edl_uniform_init (kernels.cc), so one bulk call over the fresh row range
// is bitwise-identical to the old one-ctypes-call-per-row path.

void edl_uniform_init(float*, int64_t, float, float, uint64_t);  // kernels.cc

void edl_uniform_init_rows(float* slab, int64_t dim, int64_t start_row,
                           int64_t n_rows, float lo, float hi,
                           uint64_t table_seed) {
  for (int64_t r = start_row; r < start_row + n_rows; ++r) {
    const uint64_t seed = table_seed * 0x9E3779B1ull + (uint64_t)r + 1;
    edl_uniform_init(slab + r * dim, dim, lo, hi, seed);
  }
}

// Box-Muller over the same xorshift64* stream; truncated resamples outside
// mean +/- 2*stddev (the reference's truncated_normal contract,
// go/pkg/common/initializer.go).
void edl_normal_init_rows(float* slab, int64_t dim, int64_t start_row,
                          int64_t n_rows, float mean, float stddev,
                          uint64_t table_seed, int truncated) {
  const double two_pi = 6.283185307179586;
  for (int64_t r = start_row; r < start_row + n_rows; ++r) {
    uint64_t s = table_seed * 0x9E3779B1ull + (uint64_t)r + 1;
    if (!s) s = 0x9E3779B97F4A7C15ull;
    float* dst = slab + r * dim;
    auto next_u01 = [&s]() {
      s ^= s >> 12;
      s ^= s << 25;
      s ^= s >> 27;
      const uint64_t v = s * 0x2545F4914F6CDD1Dull;
      // (0, 1]: avoid log(0).
      return ((double)(v >> 40) + 1.0) / 16777216.0;
    };
    for (int64_t i = 0; i < dim; ++i) {
      double z;
      do {
        const double u1 = next_u01(), u2 = next_u01();
        z = std::sqrt(-2.0 * std::log(u1)) * std::cos(two_pi * u2);
      } while (truncated && std::fabs(z) > 2.0);
      dst[i] = (float)(mean + stddev * z);
    }
  }
}

// ---------- IndexedSlices dedup/merge ----------
// Sum rows with duplicate ids; output ids sorted ascending (the np.unique
// contract the Python codec had). out_ids/out_vals are caller-allocated at
// worst-case size n. Returns the number of unique ids.
//
// Sort is an adaptive LSD radix (11-bit digits) over sign-flipped keys:
// embedding ids live in a few-million-wide vocabulary, so 2-3 counting
// passes beat a comparator sort by ~3x on the 640k-id pushes the DeepFM
// bench generates.

namespace {

void radix_argsort(const int64_t* keys, int64_t n, std::vector<int64_t>& idx) {
  idx.resize(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  // Order-preserving rebase: key - min fits uint64 for any int64 range and
  // keeps the digit count proportional to the actual id spread, not the
  // type width.
  int64_t mn = keys[0], mx = keys[0];
  for (int64_t i = 1; i < n; ++i) {
    if (keys[i] < mn) mn = keys[i];
    if (keys[i] > mx) mx = keys[i];
  }
  const uint64_t span = (uint64_t)mx - (uint64_t)mn;
  constexpr int kBits = 11;
  constexpr int64_t kBuckets = 1 << kBits;
  std::vector<int64_t> tmp(n), hist(kBuckets);
  for (int shift = 0; shift == 0 || (shift < 64 && (span >> shift));
       shift += kBits) {
    std::fill(hist.begin(), hist.end(), 0);
    for (int64_t i = 0; i < n; ++i) {
      const uint64_t k = (uint64_t)keys[idx[i]] - (uint64_t)mn;
      ++hist[(k >> shift) & (kBuckets - 1)];
    }
    int64_t sum = 0;
    for (int64_t b = 0; b < kBuckets; ++b) {
      const int64_t c = hist[b];
      hist[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      const uint64_t k = (uint64_t)keys[idx[i]] - (uint64_t)mn;
      tmp[hist[(k >> shift) & (kBuckets - 1)]++] = idx[i];
    }
    idx.swap(tmp);
  }
}

}  // namespace

int64_t edl_dedup_sum(const int64_t* ids, const float* vals, int64_t n,
                      int64_t dim, int64_t* out_ids, float* out_vals) {
  if (n == 0) return 0;
  std::vector<int64_t> idx;
  radix_argsort(ids, n, idx);
  int64_t u = -1, last = 0;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = idx[k];
    const float* src = vals + i * dim;
    if (u < 0 || ids[i] != last) {
      ++u;
      last = ids[i];
      out_ids[u] = last;
      float* dst = out_vals + u * dim;
      for (int64_t d = 0; d < dim; ++d) dst[d] = src[d];
    } else {
      float* dst = out_vals + u * dim;
      for (int64_t d = 0; d < dim; ++d) dst[d] += src[d];
    }
  }
  return u + 1;
}

}  // extern "C"
