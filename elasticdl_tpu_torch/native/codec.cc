// Host codecs of the port: the columnar decode of serialized Example records
// and the float32 -> bfloat16 rounding of the wire.
//
// edl_decode_examples parses a batch of Example records (proto3 wire format,
// elasticdl_tpu.proto) and writes each feature's values straight into one
// [batch, ...] array per feature, with no per-record objects. It accepts
// exactly the bytes proto/messages.py accepts and rejects exactly the bytes
// it rejects: unknown fields are skipped, the last of a repeated singular
// field or map key wins, varints are at most ten bytes, strings must be
// valid UTF-8. Records whose features differ from the schema the caller
// passes (another feature set, dtype, shape or content size) are not
// decoded here: the call reports it, and the caller decodes the batch with
// the Python codec, which gives the same arrays or raises the same error.

#include <cstdint>
#include <cstring>

namespace {

enum Status : int64_t {
  kOk = 0,
  kNotColumnar = 1,
  kTruncatedVarint = -1,
  kLongVarint = -2,
  kTruncatedFixed = -3,
  kTruncatedLength = -4,
  kBadWireType = -5,
  kFieldWireType = -6,
  kBadUtf8 = -7,
};

constexpr int kVarint = 0, kFixed64 = 1, kLen = 2, kFixed32 = 5;

struct Span {
  const uint8_t* p;
  const uint8_t* end;
};

// A varint of at most ten bytes. `overflow` is set when bits past the 64th
// are set (Python's integers keep them; a field number that large matches no
// field, and values are masked to 64 bits as proto/messages.py masks them).
inline int64_t get_varint(const uint8_t*& p, const uint8_t* end,
                          uint64_t& value, bool& overflow) {
  value = 0;
  overflow = false;
  for (int shift = 0;; shift += 7) {
    if (shift >= 70) return kLongVarint;
    if (p >= end) return kTruncatedVarint;
    const uint64_t byte = *p++;
    if (shift == 63 && (byte & 0x7E)) overflow = true;
    if (shift < 64) value |= (byte & 0x7F) << shift;
    if (!(byte & 0x80)) return kOk;
  }
}

// One field's payload after its tag: a varint's value, or the bytes of a
// length-delimited field.
inline int64_t read_field(const uint8_t*& p, const uint8_t* end, int wire,
                          uint64_t& value, Span& bytes) {
  bool overflow;
  switch (wire) {
    case kVarint:
      return get_varint(p, end, value, overflow);
    case kFixed64:
      if (end - p < 8) return kTruncatedFixed;
      p += 8;
      return kOk;
    case kFixed32:
      if (end - p < 4) return kTruncatedFixed;
      p += 4;
      return kOk;
    case kLen: {
      uint64_t n;
      int64_t st = get_varint(p, end, n, overflow);
      if (st) return st;
      if (overflow || n > static_cast<uint64_t>(end - p))
        return kTruncatedLength;
      bytes = {p, p + n};
      p += n;
      return kOk;
    }
    default:
      return kBadWireType;
  }
}

// Strict UTF-8, as Python's decoder: no overlong forms, no surrogates,
// nothing past U+10FFFF.
bool valid_utf8(const uint8_t* p, const uint8_t* end) {
  while (p < end) {
    const uint8_t c = *p;
    if (c < 0x80) {
      ++p;
      continue;
    }
    int n;
    uint8_t lo = 0x80, hi = 0xBF;
    if (c >= 0xC2 && c <= 0xDF) {
      n = 1;
    } else if (c >= 0xE0 && c <= 0xEF) {
      n = 2;
      if (c == 0xE0) lo = 0xA0;
      if (c == 0xED) hi = 0x9F;
    } else if (c >= 0xF0 && c <= 0xF4) {
      n = 3;
      if (c == 0xF0) lo = 0x90;
      if (c == 0xF4) hi = 0x8F;
    } else {
      return false;
    }
    if (end - p <= n) return false;
    if (p[1] < lo || p[1] > hi) return false;
    for (int i = 2; i <= n; ++i)
      if (p[i] < 0x80 || p[i] > 0xBF) return false;
    p += n + 1;
  }
  return true;
}

// A repeated int64 field, packed or not: counts its values into `count` and
// keeps the first `cap` of them in `out`.
int64_t read_int64s(int wire, uint64_t value, Span bytes, int64_t* out,
                    int64_t cap, int64_t& count) {
  if (wire == kVarint) {
    if (count < cap) out[count] = static_cast<int64_t>(value);
    ++count;
    return kOk;
  }
  if (wire != kLen) return kFieldWireType;
  const uint8_t* p = bytes.p;
  while (p < bytes.end) {
    uint64_t v;
    bool overflow;
    int64_t st = get_varint(p, bytes.end, v, overflow);
    if (st) return st;
    if (count < cap) out[count] = static_cast<int64_t>(v);
    ++count;
  }
  return kOk;
}

constexpr int64_t kMaxDims = 16;

struct Tensor {
  int64_t dtype = 0;
  int64_t ndims = 0;
  int64_t dims[kMaxDims];
  Span content = {nullptr, nullptr};
};

// A Tensor message: name (1), dims (2), dtype (3), content (4),
// string_lengths (5).
int64_t parse_tensor(Span msg, Tensor& t) {
  t = Tensor();
  int64_t n_lengths = 0;
  const uint8_t* p = msg.p;
  while (p < msg.end) {
    uint64_t tag, value = 0;
    bool overflow;
    int64_t st = get_varint(p, msg.end, tag, overflow);
    if (st) return st;
    const int wire = static_cast<int>(tag & 7);
    Span bytes = {nullptr, nullptr};
    st = read_field(p, msg.end, wire, value, bytes);
    if (st) return st;
    const uint64_t number = overflow ? 0 : tag >> 3;
    switch (number) {
      case 1:
        if (wire != kLen) return kFieldWireType;
        if (!valid_utf8(bytes.p, bytes.end)) return kBadUtf8;
        break;
      case 2:
        st = read_int64s(wire, value, bytes, t.dims, kMaxDims, t.ndims);
        if (st) return st;
        break;
      case 3:
        if (wire != kVarint) return kFieldWireType;
        // An enum is an int32: the low 32 bits, signed.
        t.dtype = static_cast<int32_t>(static_cast<uint32_t>(value));
        break;
      case 4:
        if (wire != kLen) return kFieldWireType;
        t.content = bytes;
        break;
      case 5:
        st = read_int64s(wire, value, bytes, nullptr, 0, n_lengths);
        if (st) return st;
        break;
      default:
        break;  // unknown field: skipped
    }
  }
  return kOk;
}

struct Schema {
  int64_t nfeat;
  const uint8_t* names;
  const int64_t* name_offsets;
  const int64_t* dtypes;
  const int64_t* dims;
  const int64_t* dims_offsets;
  const int64_t* content_bytes;
  const int64_t* widen;  // 1: bfloat16 on the wire, float32 out
  uint8_t* const* outs;
};

int64_t find_feature(const Schema& s, Span key, int64_t guess) {
  const int64_t len = key.end - key.p;
  for (int64_t k = 0; k < s.nfeat; ++k) {
    const int64_t f = (guess + k) % s.nfeat;
    const int64_t lo = s.name_offsets[f], hi = s.name_offsets[f + 1];
    if (hi - lo == len && std::memcmp(s.names + lo, key.p, len) == 0)
      return f;
  }
  return -1;
}

// One record: every feature of the schema, each once or more (the last
// wins), written at row `row` of its output.
int64_t decode_record(const Schema& s, Span rec, int64_t row,
                      int64_t* seen_at) {
  int64_t seen = 0, guess = 0;
  const uint8_t* p = rec.p;
  while (p < rec.end) {
    uint64_t tag, value = 0;
    bool overflow;
    int64_t st = get_varint(p, rec.end, tag, overflow);
    if (st) return st;
    const int wire = static_cast<int>(tag & 7);
    Span entry = {nullptr, nullptr};
    st = read_field(p, rec.end, wire, value, entry);
    if (st) return st;
    if (overflow || (tag >> 3) != 1) continue;  // unknown field
    if (wire != kLen) return kFieldWireType;
    // A map entry: key (1) and value (2), the last of each kept.
    Span key = {nullptr, nullptr};
    bool has_key = false, has_value = false;
    Tensor t;
    const uint8_t* q = entry.p;
    while (q < entry.end) {
      uint64_t etag, evalue = 0;
      st = get_varint(q, entry.end, etag, overflow);
      if (st) return st;
      const int ewire = static_cast<int>(etag & 7);
      Span ebytes = {nullptr, nullptr};
      st = read_field(q, entry.end, ewire, evalue, ebytes);
      if (st) return st;
      const uint64_t number = overflow ? 0 : etag >> 3;
      if (number == 1) {
        if (ewire != kLen) return kFieldWireType;
        if (!valid_utf8(ebytes.p, ebytes.end)) return kBadUtf8;
        key = ebytes;
        has_key = true;
      } else if (number == 2) {
        if (ewire != kLen) return kFieldWireType;
        st = parse_tensor(ebytes, t);
        if (st) return st;
        has_value = true;
      }
    }
    if (!has_key || !has_value) return kNotColumnar;
    const int64_t f = find_feature(s, key, guess);
    if (f < 0) return kNotColumnar;
    guess = f + 1;
    const int64_t d0 = s.dims_offsets[f], nd = s.dims_offsets[f + 1] - d0;
    if (t.dtype != s.dtypes[f] || t.ndims != nd ||
        std::memcmp(t.dims, s.dims + d0, nd * sizeof(int64_t)) != 0 ||
        t.content.end - t.content.p != s.content_bytes[f])
      return kNotColumnar;
    const int64_t nbytes = s.content_bytes[f];
    if (s.widen[f]) {
      // bfloat16 bits -> float32 (every bfloat16 is a float32).
      float* out = reinterpret_cast<float*>(s.outs[f]) + row * (nbytes / 2);
      for (int64_t i = 0; i < nbytes / 2; ++i) {
        const uint32_t bits =
            (static_cast<uint32_t>(t.content.p[2 * i + 1]) << 24) |
            (static_cast<uint32_t>(t.content.p[2 * i]) << 16);
        std::memcpy(out + i, &bits, 4);
      }
    } else {
      std::memcpy(s.outs[f] + row * nbytes, t.content.p, nbytes);
    }
    if (seen_at[f] != row) {
      seen_at[f] = row;
      ++seen;
    }
  }
  return seen == s.nfeat ? kOk : kNotColumnar;
}

}  // namespace

extern "C" {

// Decodes records [offsets[i], offsets[i+1]) of `data`, i < n, into the
// schema's outputs. Returns 0 when every record was decoded, 1 when some
// record does not fit the schema (the outputs are then incomplete), or a
// negative error code for bytes that are not an Example, with the record's
// index in *where.
int64_t edl_decode_examples(const uint8_t* data, const int64_t* offsets,
                            int64_t n, int64_t nfeat, const uint8_t* names,
                            const int64_t* name_offsets,
                            const int64_t* dtypes, const int64_t* dims,
                            const int64_t* dims_offsets,
                            const int64_t* content_bytes,
                            const int64_t* widen, uint8_t* const* outs,
                            int64_t* seen_at, int64_t* where) {
  const Schema s = {nfeat,  names,         name_offsets,
                    dtypes, dims,          dims_offsets,
                    content_bytes, widen,  outs};
  for (int64_t f = 0; f < nfeat; ++f) seen_at[f] = -1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t st =
        decode_record(s, {data + offsets[i], data + offsets[i + 1]}, i,
                      seen_at);
    if (st != kOk) {
      *where = i;
      return st;
    }
  }
  return kOk;
}

// float32 bits -> bfloat16 bits, rounded to nearest with ties to even;
// NaN -> the quiet NaN of the same sign (0x7FC0 | sign), as ml_dtypes.
void edl_f32_to_bf16(const uint32_t* __restrict in, uint16_t* __restrict out,
                     int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t b = in[i];
    const uint32_t rounded = (b + 0x7FFFu + ((b >> 16) & 1u)) >> 16;
    const uint32_t nan = ((b >> 16) & 0x8000u) | 0x7FC0u;
    out[i] = static_cast<uint16_t>((b & 0x7FFFFFFFu) > 0x7F800000u ? nan
                                                                   : rounded);
  }
}

}  // extern "C"
