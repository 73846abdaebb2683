// Native batch range-reads for .edlr record files (data/recordfile.py);
// counterpart of elasticdl_tpu/native/recordio.cc, with the same entry point,
// layout and error codes.
//
// One mmap, one sequential scan over the requested record range, CRC32
// verification (format v2) and payload copy-out, in C instead of per-record
// Python struct unpacking. The CRC is zlib's (reflected polynomial
// 0xEDB88320), computed here slicing-by-8 so the library needs no zlib
// headers where it is built.
//
// Layout (little-endian; see recordfile.py):
//   [magic "EDLR"][u32 version]
//   v1 record: [u32 len][payload]
//   v2 record: [u32 len][u32 crc32(payload)][payload]
//   footer: [u64 offset]*num  [u64 num][u64 index_offset][magic "EDLI"]
//
// Error codes (negative returns): -1 io/open, -2 corrupt header/footer,
// -3 range out of bounds, -4 output buffer too small, -5 crc mismatch,
// -6 unsupported version.

#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr long long kErrIo = -1;
constexpr long long kErrCorrupt = -2;
constexpr long long kErrRange = -3;
constexpr long long kErrBuffer = -4;
constexpr long long kErrCrc = -5;
constexpr long long kErrVersion = -6;

constexpr size_t kHeaderSize = 8;    // magic + u32 version
constexpr size_t kFooterTail = 20;   // u64 num + u64 index_offset + magic

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0xEDB88320u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      for (int s = 1; s < 8; ++s) {
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
      }
    }
  }
};

const CrcTables kCrc;

// zlib's crc32(0, p, n).
uint32_t crc32(const unsigned char* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^
        kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
        kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
        kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ kCrc.t[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

struct Mapped {
  const unsigned char* p = nullptr;
  size_t n = 0;
  int fd = -1;

  ~Mapped() {
    if (p != nullptr) munmap(const_cast<unsigned char*>(p), n);
    if (fd >= 0) close(fd);
  }
};

uint32_t le32(const unsigned char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts (x86-64, aarch64)
}

uint64_t le64(const unsigned char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

bool map_file(const char* path, Mapped* m) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) return false;
  struct stat st;
  if (fstat(m->fd, &st) != 0 || st.st_size < 0) return false;
  m->n = static_cast<size_t>(st.st_size);
  if (m->n == 0) return false;
  void* p = mmap(nullptr, m->n, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p == MAP_FAILED) return false;
  m->p = static_cast<const unsigned char*>(p);
  return true;
}

struct Parsed {
  uint32_t version;
  uint64_t num_records;
  uint64_t index_offset;
};

long long parse(const Mapped& m, Parsed* out) {
  if (m.n < kHeaderSize + kFooterTail) return kErrCorrupt;
  if (std::memcmp(m.p, "EDLR", 4) != 0) return kErrCorrupt;
  out->version = le32(m.p + 4);
  if (out->version != 1 && out->version != 2) return kErrVersion;
  const unsigned char* tail = m.p + m.n - kFooterTail;
  if (std::memcmp(tail + 16, "EDLI", 4) != 0) return kErrCorrupt;
  out->num_records = le64(tail);
  out->index_offset = le64(tail + 8);
  // The whole offset index must sit between the records and the tail.
  if (out->index_offset > m.n - kFooterTail ||
      out->num_records > (m.n - kFooterTail - out->index_offset) / 8) {
    return kErrCorrupt;
  }
  return 0;
}

}  // namespace

extern "C" {

// Copies the payloads of records [start, start+count) contiguously into
// out_buf (capacity cap bytes) and each payload length into out_lens
// (count entries). Returns total payload bytes, or a negative error code.
long long edl_records_read(const char* path, long long start,
                           long long count, unsigned char* out_buf,
                           long long cap, long long* out_lens) {
  if (start < 0 || count < 0) return kErrRange;
  Mapped m;
  if (!map_file(path, &m)) return kErrIo;
  Parsed f;
  long long rc = parse(m, &f);
  if (rc < 0) return rc;
  if (static_cast<uint64_t>(start) + static_cast<uint64_t>(count) >
      f.num_records) {
    return kErrRange;
  }
  if (count == 0) return 0;

  const unsigned char* index = m.p + f.index_offset;
  uint64_t off = le64(index + 8 * static_cast<uint64_t>(start));
  const uint64_t rec_header = (f.version == 2) ? 8 : 4;
  long long total = 0;
  for (long long i = 0; i < count; ++i) {
    // Subtract-form bounds checks: `off + len` could wrap uint64 on a
    // corrupt index/length and slip past an addition-form comparison.
    if (off >= f.index_offset || rec_header > f.index_offset - off) {
      return kErrCorrupt;
    }
    uint32_t len = le32(m.p + off);
    uint32_t want_crc = (f.version == 2) ? le32(m.p + off + 4) : 0;
    off += rec_header;
    if (len > f.index_offset - off) return kErrCorrupt;
    if (f.version == 2 && crc32(m.p + off, len) != want_crc) return kErrCrc;
    if (total + static_cast<long long>(len) > cap) return kErrBuffer;
    std::memcpy(out_buf + total, m.p + off, len);
    out_lens[i] = static_cast<long long>(len);
    total += len;
    off += len;
  }
  return total;
}

}  // extern "C"
