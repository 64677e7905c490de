// A Zstandard decoder (RFC 8878) and CRC-32C, for the port's checkpoint
// readers: Orbax writes a run as an OCDBT key-value store whose B-tree
// nodes are zstd frames and whose zarr chunks are zstd frames, and OCDBT
// closes every node with a CRC-32C (data/ocdbt.py, train/orbax_reader.py).
//
// Host code, built with the host C++ compiler at first use
// (textgcn_tpu_torch/zstd.py, by native.build); the card is not involved.
//
// What it decodes: a buffer of concatenated frames, zstd frames and
// skippable frames in any order; frames with and without a content size,
// with and without an XXH64 content checksum (verified); raw, RLE and
// compressed blocks; literals raw, RLE, Huffman-coded in one or four
// streams (the tree described directly or FSE-compressed) or treeless;
// sequences whose literal-length, offset and match-length codes are
// predefined, RLE, FSE-compressed or repeated, with the three repeat
// offsets.  A frame that names a dictionary is refused.
//
// Corrupt input raises an error with the input offset at which it was
// found: every read is bounds-checked, every loop is bounded by the input
// or by the output it must produce, and the output is capped by the
// caller's limit (and by a frame's declared content size).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error {
  int64_t offset;
  std::string message;
};

[[noreturn]] void fail(int64_t offset, const std::string& message) {
  throw Error{offset, message};
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// --- XXH64 (seed 0) ---------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (end - p >= 8) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --- CRC-32C (Castagnoli, reflected 0x82F63B78) -----------------------------

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable tab;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t v = rd64(p) ^ c;
    c = tab.t[7][v & 0xFF] ^ tab.t[6][(v >> 8) & 0xFF] ^ tab.t[5][(v >> 16) & 0xFF] ^
        tab.t[4][(v >> 24) & 0xFF] ^ tab.t[3][(v >> 32) & 0xFF] ^
        tab.t[2][(v >> 40) & 0xFF] ^ tab.t[1][(v >> 48) & 0xFF] ^ tab.t[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ tab.t[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// --- bit readers --------------------------------------------------------------

// A backward bit stream (RFC 8878 4.1, "FSE bitstreams"): the last byte's
// highest set bit marks the start, and bits are read from there towards
// the first byte, each field most significant bit first.  Bits read past
// the first byte are zeros; `pos < 0` tells that it happened.
struct BackwardBits {
  const uint8_t* p;
  int64_t n;       // bytes
  int64_t pos;     // bits not yet read, [0, pos) of the little-endian array
  int64_t origin;  // the stream's offset in the input, for errors

  BackwardBits(const uint8_t* data, int64_t size, int64_t at) : p(data), n(size), origin(at) {
    if (size <= 0) fail(at, "empty bit stream");
    uint8_t last = data[size - 1];
    if (last == 0) fail(at + size - 1, "bit stream without its end mark");
    pos = (size - 1) * 8 + highbit(last);
  }

  // bits [lo, lo + count) of the little-endian array, count <= 56,
  // bits outside [0, 8n) read as zeros
  uint64_t window(int64_t lo, int count) const {
    if (count == 0) return 0;
    if (lo < 0) {
      if (lo + count <= 0) return 0;
      return window(0, int(lo + count)) << (-lo);
    }
    int64_t byte = lo >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n) {
      v = rd64(p + byte);
    } else {
      for (int64_t k = byte; k < n && k < byte + 8; ++k) v |= uint64_t(p[k]) << (8 * (k - byte));
    }
    v >>= (lo & 7);
    return v & ((uint64_t(1) << count) - 1);
  }

  uint64_t read(int count) {
    pos -= count;
    return window(pos, count);
  }
  uint64_t peek(int count) const { return window(pos - count, count); }
  void skip(int count) { pos -= count; }
};

// --- FSE tables -----------------------------------------------------------------

struct FseEntry {
  uint8_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
};

// FSE decoding table from a normalized distribution (RFC 8878 4.1.1)
void fse_build(FseTable& t, const int16_t* norm, int n_symbols, int log, int64_t at) {
  int size = 1 << log;
  t.log = log;
  t.e.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(n_symbols);
  int high = size - 1;
  for (int s = 0; s < n_symbols; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail(at, "FSE distribution overflows its table");
      t.e[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, position = 0;
  for (int s = 0; s < n_symbols; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[position].symbol = uint8_t(s);
      do position = (position + step) & mask;
      while (position > high);
    }
  }
  if (position != 0) fail(at, "FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    int s = t.e[u].symbol;
    uint32_t state = next[s]++;
    if (state == 0) fail(at, "FSE distribution is inconsistent");
    int bits = log - highbit(state);
    t.e[u].bits = uint8_t(bits);
    t.e[u].base = uint16_t((state << bits) - size);
  }
}

// A table description (RFC 8878 4.1.1): reads it from [p, p + n) and
// returns the bytes it took.
int64_t fse_read(FseTable& t, const uint8_t* p, int64_t n, int max_symbol, int max_log, int64_t at) {
  if (n < 1) fail(at, "truncated FSE table description");
  int log = (p[0] & 15) + 5;
  if (log > max_log) fail(at, "FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
  int16_t norm[256] = {0};
  int64_t bitpos = 4;
  auto bits = [&](int count) -> uint32_t {  // peek, forward little-endian
    uint32_t v = 0;
    for (int k = 0; k < count; ++k) {
      int64_t b = bitpos + k;
      if ((b >> 3) >= n) fail(at, "truncated FSE table description");
      v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << k;
    }
    return v;
  };
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int repeat;
      do {
        repeat = int(bits(2));
        bitpos += 2;
        symbol += repeat;
        if (symbol > max_symbol + 1) fail(at, "FSE table description has too many symbols");
      } while (repeat == 3);
      if (symbol > max_symbol) break;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = bits(nbits - 1);
    if (int(low & (threshold - 1)) < max) {
      count = int(low & (threshold - 1));
      bitpos += nbits - 1;
    } else {
      count = int(bits(nbits) & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bitpos += nbits;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || symbol > max_symbol + 1) fail(at, "corrupt FSE table description");
  int64_t used = (bitpos + 7) >> 3;
  if (used > n) fail(at, "truncated FSE table description");
  fse_build(t, norm, symbol, log, at);
  return used;
}

void fse_rle(FseTable& t, int symbol) {
  t.log = 0;
  t.e.assign(1, FseEntry{uint8_t(symbol), 0, 0});
}

// --- Huffman --------------------------------------------------------------------

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;  // indexed by the next max_bits bits
};

// The tree description (RFC 8878 4.2.1); returns the bytes it took.
int64_t huf_read(HufTable& h, const uint8_t* p, int64_t n, int64_t at) {
  if (n < 1) fail(at, "truncated Huffman tree description");
  uint8_t weights[256] = {0};
  int count = 0;
  int64_t used;
  int header = p[0];
  if (header >= 128) {
    count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) fail(at, "truncated Huffman tree description");
    for (int i = 0; i < count; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    used = 1 + header;
    if (used > n || header == 0) fail(at, "truncated Huffman tree description");
    FseTable t;
    int64_t desc = fse_read(t, p + 1, header, 255, 6, at + 1);
    if (desc >= header) fail(at, "Huffman weights without a bit stream");
    BackwardBits br(p + 1 + desc, header - desc, at + 1 + desc);
    uint32_t s1 = uint32_t(br.read(t.log)), s2 = uint32_t(br.read(t.log));
    auto step = [&](uint32_t& s) {
      const FseEntry& e = t.e[s];
      if (count >= 255) fail(at, "too many Huffman weights");
      weights[count++] = e.symbol;
      s = e.base + uint32_t(br.read(e.bits));
    };
    for (;;) {
      step(s1);
      if (br.pos < 0) {
        if (count >= 255) fail(at, "too many Huffman weights");
        weights[count++] = t.e[s2].symbol;
        break;
      }
      step(s2);
      if (br.pos < 0) {
        if (count >= 255) fail(at, "too many Huffman weights");
        weights[count++] = t.e[s1].symbol;
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > 11) fail(at, "Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(at, "Huffman tree without weights");
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail(at, "Huffman code longer than 11 bits");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(at, "Huffman weights do not complete a tree");
  if (count >= 256) fail(at, "too many Huffman weights");
  weights[count++] = uint8_t(highbit(rest) + 1);
  uint32_t rank[13] = {0}, start[13] = {0};
  for (int i = 0; i < count; ++i) rank[weights[i]]++;
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = next;
    next += rank[w] << (w - 1);
  }
  h.max_bits = max_bits;
  h.symbol.assign(size_t(1) << max_bits, 0);
  h.bits.assign(size_t(1) << max_bits, 0);
  for (int s = 0; s < count; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = 1u << (w - 1);
    for (uint32_t k = 0; k < len; ++k) {
      h.symbol[start[w] + k] = uint8_t(s);
      h.bits[start[w] + k] = uint8_t(max_bits + 1 - w);
    }
    start[w] += len;
  }
  return used;
}

void huf_stream(const HufTable& h, const uint8_t* p, int64_t n, uint8_t* out, int64_t count, int64_t at) {
  BackwardBits br(p, n, at);
  for (int64_t i = 0; i < count; ++i) {
    uint32_t k = uint32_t(br.peek(h.max_bits));
    out[i] = h.symbol[k];
    br.skip(h.bits[k]);
    if (br.pos < 0) fail(at, "Huffman stream overrun");
  }
  if (br.pos != 0) fail(at, "Huffman stream not consumed");
}

// --- sequences --------------------------------------------------------------------

constexpr int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
constexpr uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,    9,    10,   11,
                                  12, 13, 14, 15, 16, 18,  20,  22,  24,   28,   32,   40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t ML_BASE[53] = {3,   4,   5,    6,    7,    8,    9,     10,    11,   12,   13,
                                  14,  15,  16,   17,   18,   19,   20,    21,    22,   23,   24,
                                  25,  26,  27,   28,   29,   30,   31,    32,    33,   34,   35,
                                  37,  39,  41,   43,   47,   51,   59,    67,    83,   99,   131,
                                  259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr int64_t BLOCK_MAX = 128 * 1024;

struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  int64_t frame_start = 0;  // of this frame's output
};

class Decoder {
 public:
  Decoder(const uint8_t* src, int64_t n, int64_t limit) : src_(src), n_(n), limit_(limit) {}

  void run() {
    int64_t at = 0;
    if (n_ == 0) fail(0, "no zstd frame");
    while (at < n_) {
      if (n_ - at < 4) fail(at, "truncated frame magic");
      uint32_t magic = rd32(src_ + at);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n_ - at < 8) fail(at, "truncated skippable frame");
        uint64_t size = rd32(src_ + at + 4);
        if (uint64_t(n_ - at - 8) < size) fail(at, "truncated skippable frame");
        at += 8 + int64_t(size);
      } else if (magic == 0xFD2FB528u) {
        at = frame(at);
      } else {
        char buf[64];
        std::snprintf(buf, sizeof buf, "not a zstd frame (magic %08x)", magic);
        fail(at, buf);
      }
    }
  }

  std::vector<uint8_t> out;

 private:
  const uint8_t* src_;
  int64_t n_;
  int64_t limit_;

  void need(int64_t at, int64_t count, const char* what) {
    if (count < 0 || n_ - at < count) fail(at, std::string("truncated ") + what);
  }

  void grow(int64_t at, int64_t count) {
    if (limit_ >= 0 && int64_t(out.size()) + count > limit_)
      fail(at, "decoded size exceeds the limit of " + std::to_string(limit_) + " bytes");
  }

  int64_t frame(int64_t at) {
    int64_t start = at;
    need(at, 5, "frame header");
    at += 4;
    uint8_t fhd = src_[at++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    if (fhd & 8) fail(at - 1, "reserved bit set in the frame header");
    uint64_t window = 0;
    if (!single) {
      need(at, 1, "frame header");
      uint8_t wd = src_[at++];
      int exponent = wd >> 3, mantissa = wd & 7;
      if (exponent > 31 - 10) fail(at - 1, "window too large");
      uint64_t base = uint64_t(1) << (10 + exponent);
      window = base + (base / 8) * mantissa;
    }
    static const int did_size[4] = {0, 1, 2, 4};
    need(at, did_size[did_flag], "frame header");
    uint64_t did = 0;
    for (int k = 0; k < did_size[did_flag]; ++k) did |= uint64_t(src_[at + k]) << (8 * k);
    if (did != 0) fail(at, "the frame names dictionary " + std::to_string(did) + ": dictionaries are not supported");
    at += did_size[did_flag];
    int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    need(at, fcs_size, "frame header");
    bool has_size = fcs_size > 0;
    uint64_t content = 0;
    for (int k = 0; k < fcs_size; ++k) content |= uint64_t(src_[at + k]) << (8 * k);
    if (fcs_size == 2) content += 256;
    at += fcs_size;
    if (single) window = content;
    if (has_size) {
      grow(start, int64_t(content > uint64_t(INT64_MAX / 2) ? INT64_MAX / 2 : content));
      // a corrupt size is found out by the blocks: reserve what they can hold
      uint64_t bound = uint64_t(n_ - at) * BLOCK_MAX;
      out.reserve(out.size() + size_t(content < bound ? content : bound));
    }
    FrameState fs;
    fs.frame_start = int64_t(out.size());
    int64_t block_max = window < uint64_t(BLOCK_MAX) ? int64_t(window) : BLOCK_MAX;
    for (;;) {
      need(at, 3, "block header");
      uint32_t bh = uint32_t(src_[at]) | uint32_t(src_[at + 1]) << 8 | uint32_t(src_[at + 2]) << 16;
      int64_t block = at;
      at += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (type == 3) fail(block, "reserved block type");
      if (type == 1) {
        need(at, 1, "RLE block");
        if (size > block_max) fail(block, "block larger than the window");
        grow(block, size);
        out.insert(out.end(), size_t(size), src_[at]);
        at += 1;
      } else {
        need(at, size, type == 0 ? "raw block" : "compressed block");
        if (size > block_max) fail(block, "block larger than the window");
        if (type == 0) {
          grow(block, size);
          out.insert(out.end(), src_ + at, src_ + at + size);
        } else {
          compressed_block(fs, at, size, block_max);
        }
        at += size;
      }
      if (last) break;
    }
    uint64_t produced = out.size() - size_t(fs.frame_start);
    if (has_size && produced != content)
      fail(start, "frame declares " + std::to_string(content) + " bytes and holds " + std::to_string(produced));
    if (checksum) {
      need(at, 4, "content checksum");
      uint32_t want = rd32(src_ + at);
      uint32_t got = uint32_t(xxh64(out.data() + fs.frame_start, size_t(produced)));
      if (want != got) fail(at, "content checksum mismatch");
      at += 4;
    }
    return at;
  }

  void compressed_block(FrameState& fs, int64_t at, int64_t size, int64_t block_max) {
    const uint8_t* p = src_ + at;
    int64_t end = size;
    std::vector<uint8_t> lit;
    int64_t pos = literals(fs, p, end, at, lit, block_max);
    sequences(fs, p + pos, end - pos, at + pos, lit, int64_t(out.size()) + block_max);
  }

  int64_t literals(FrameState& fs, const uint8_t* p, int64_t n, int64_t at, std::vector<uint8_t>& lit,
                   int64_t block_max) {
    if (n < 1) fail(at, "truncated literals section");
    int type = p[0] & 3, format = (p[0] >> 2) & 3;
    if (type <= 1) {
      int64_t regen, hsize;
      if (format == 0 || format == 2) {
        regen = p[0] >> 3;
        hsize = 1;
      } else if (format == 1) {
        if (n < 2) fail(at, "truncated literals header");
        regen = (p[0] >> 4) + (int64_t(p[1]) << 4);
        hsize = 2;
      } else {
        if (n < 3) fail(at, "truncated literals header");
        regen = (p[0] >> 4) + (int64_t(p[1]) << 4) + (int64_t(p[2]) << 12);
        hsize = 3;
      }
      if (regen > block_max) fail(at, "literals larger than a block");
      if (type == 0) {
        if (n - hsize < regen) fail(at, "truncated raw literals");
        lit.assign(p + hsize, p + hsize + regen);
        return hsize + regen;
      }
      if (n - hsize < 1) fail(at, "truncated RLE literals");
      lit.assign(size_t(regen), p[hsize]);
      return hsize + 1;
    }
    int64_t regen, comp, hsize;
    int streams = format == 0 ? 1 : 4;
    if (format <= 1) {
      if (n < 3) fail(at, "truncated literals header");
      uint32_t c = p[0] | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
      regen = (c >> 4) & 0x3FF;
      comp = (c >> 14) & 0x3FF;
      hsize = 3;
    } else if (format == 2) {
      if (n < 4) fail(at, "truncated literals header");
      uint32_t c = rd32(p);
      regen = (c >> 4) & 0x3FFF;
      comp = (c >> 18) & 0x3FFF;
      hsize = 4;
    } else {
      if (n < 5) fail(at, "truncated literals header");
      uint64_t c = rd32(p) | uint64_t(p[4]) << 32;
      regen = (c >> 4) & 0x3FFFF;
      comp = (c >> 22) & 0x3FFFF;
      hsize = 5;
    }
    if (regen > block_max) fail(at, "literals larger than a block");
    if (n - hsize < comp) fail(at, "truncated compressed literals");
    const uint8_t* q = p + hsize;
    int64_t qat = at + hsize, qn = comp;
    if (type == 2) {
      int64_t used = huf_read(fs.huf, q, qn, qat);
      fs.have_huf = true;
      q += used;
      qat += used;
      qn -= used;
    } else if (!fs.have_huf) {
      fail(at, "treeless literals without an earlier Huffman tree");
    }
    lit.resize(size_t(regen));
    if (streams == 1) {
      huf_stream(fs.huf, q, qn, lit.data(), regen, qat);
    } else {
      if (qn < 6) fail(qat, "truncated jump table");
      int64_t s1 = q[0] | q[1] << 8, s2 = q[2] | q[3] << 8, s3 = q[4] | q[5] << 8;
      int64_t s4 = qn - 6 - s1 - s2 - s3;
      if (s4 < 1) fail(qat, "corrupt jump table");
      int64_t each = (regen + 3) / 4, last = regen - 3 * each;
      if (last < 0) fail(qat, "too few literals for four streams");
      const uint8_t* s = q + 6;
      int64_t sat = qat + 6;
      int64_t sizes[4] = {s1, s2, s3, s4};
      for (int k = 0; k < 4; ++k) {
        huf_stream(fs.huf, s, sizes[k], lit.data() + k * each, k < 3 ? each : last, sat);
        s += sizes[k];
        sat += sizes[k];
      }
    }
    return hsize + comp;
  }

  int64_t table(int mode, FseTable& t, bool& have, const int16_t* def, int def_n, int def_log,
                int max_symbol, int max_log, const uint8_t* p, int64_t n, int64_t at, const char* what) {
    switch (mode) {
      case 0:
        fse_build(t, def, def_n, def_log, at);
        have = true;
        return 0;
      case 1:
        if (n < 1) fail(at, std::string("truncated RLE ") + what + " code");
        if (p[0] > max_symbol) fail(at, std::string("RLE ") + what + " code out of range");
        fse_rle(t, p[0]);
        have = true;
        return 1;
      case 2: {
        int64_t used = fse_read(t, p, n, max_symbol, max_log, at);
        have = true;
        return used;
      }
      default:
        if (!have) fail(at, std::string("repeated ") + what + " table without an earlier one");
        return 0;
    }
  }

  // `cap`: the output size the block may not pass
  void sequences(FrameState& fs, const uint8_t* p, int64_t n, int64_t at, const std::vector<uint8_t>& lit,
                 int64_t cap) {
    if (n < 1) fail(at, "truncated sequences section");
    int64_t nseq, pos;
    if (p[0] < 128) {
      nseq = p[0];
      pos = 1;
    } else if (p[0] < 255) {
      if (n < 2) fail(at, "truncated sequences header");
      nseq = ((int64_t(p[0]) - 128) << 8) + p[1];
      pos = 2;
    } else {
      if (n < 3) fail(at, "truncated sequences header");
      nseq = p[1] + (int64_t(p[2]) << 8) + 0x7F00;
      pos = 3;
    }
    int64_t used_lit = 0;
    if (nseq == 0) {
      if (pos != n) fail(at, "bytes after an empty sequences section");
    } else {
      if (n - pos < 1) fail(at, "truncated sequences header");
      uint8_t modes = p[pos++];
      if (modes & 3) fail(at + pos - 1, "reserved bits set in the compression modes");
      pos += table(modes >> 6, fs.ll, fs.have_ll, LL_DEFAULT, 36, 6, 35, 9, p + pos, n - pos, at + pos,
                   "literal length");
      pos += table((modes >> 4) & 3, fs.of, fs.have_of, OF_DEFAULT, 29, 5, 31, 8, p + pos, n - pos, at + pos,
                   "offset");
      pos += table((modes >> 2) & 3, fs.ml, fs.have_ml, ML_DEFAULT, 53, 6, 52, 9, p + pos, n - pos, at + pos,
                   "match length");
      if (pos >= n) fail(at, "sequences without a bit stream");
      BackwardBits br(p + pos, n - pos, at + pos);
      uint32_t sll = uint32_t(br.read(fs.ll.log));
      uint32_t sof = uint32_t(br.read(fs.of.log));
      uint32_t sml = uint32_t(br.read(fs.ml.log));
      for (int64_t i = 0; i < nseq; ++i) {
        const FseEntry& eo = fs.of.e[sof];
        const FseEntry& em = fs.ml.e[sml];
        const FseEntry& el = fs.ll.e[sll];
        int ofc = eo.symbol, mlc = em.symbol, llc = el.symbol;
        if (ofc > 31 || mlc > 52 || llc > 35) fail(br.origin, "sequence code out of range");
        uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
        uint64_t ml = ML_BASE[mlc] + br.read(ML_BITS[mlc]);
        uint64_t ll = LL_BASE[llc] + br.read(LL_BITS[llc]);
        if (br.pos < 0) fail(br.origin, "sequence bit stream overrun");
        uint64_t offset;
        if (ofv > 3) {
          offset = ofv - 3;
          fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        } else {
          int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
          if (idx == 0) {
            offset = fs.rep[0];
          } else if (idx == 3) {
            offset = fs.rep[0] - 1;
            if (offset == 0) fail(br.origin, "repeat offset of zero");
            fs.rep[2] = fs.rep[1];
            fs.rep[1] = fs.rep[0];
            fs.rep[0] = offset;
          } else {
            offset = fs.rep[idx];
            if (idx == 2) fs.rep[2] = fs.rep[1];
            fs.rep[1] = fs.rep[0];
            fs.rep[0] = offset;
          }
        }
        if (ll > uint64_t(lit.size()) - uint64_t(used_lit))
          fail(br.origin, "sequence takes more literals than the block has");
        if (int64_t(out.size() + ll + ml) > cap) fail(at, "block decodes to more than its maximum size");
        grow(br.origin, int64_t(ll + ml));
        out.insert(out.end(), lit.begin() + used_lit, lit.begin() + used_lit + int64_t(ll));
        used_lit += int64_t(ll);
        uint64_t have = out.size() - size_t(fs.frame_start);
        if (offset > have) fail(br.origin, "match offset " + std::to_string(offset) + " before the frame's start");
        size_t from = out.size() - size_t(offset);
        out.resize(out.size() + size_t(ml));
        uint8_t* o = out.data();
        size_t to = out.size() - size_t(ml);
        for (uint64_t k = 0; k < ml; ++k) o[to + k] = o[from + k];
        if (i + 1 < nseq) {
          sll = el.base + uint32_t(br.read(el.bits));
          sml = em.base + uint32_t(br.read(em.bits));
          sof = eo.base + uint32_t(br.read(eo.bits));
          if (br.pos < 0) fail(br.origin, "sequence bit stream overrun");
        }
      }
      if (br.pos != 0) fail(br.origin, "sequence bit stream not consumed");
    }
    int64_t rest = int64_t(lit.size()) - used_lit;
    if (int64_t(out.size()) + rest > cap) fail(at, "block decodes to more than its maximum size");
    grow(at, rest);
    out.insert(out.end(), lit.begin() + used_lit, lit.end());
  }
};

struct Result {
  std::vector<uint8_t> data;
  bool ok = true;
  int64_t offset = 0;
  std::string message;
};

}  // namespace

extern "C" {

// Decodes the frames of [src, src + n) into a new result; `limit` caps the
// decoded bytes (negative: no cap).  Never returns null unless memory runs
// out.
void* zstd_decode(const uint8_t* src, int64_t n, int64_t limit) {
  Result* r = new (std::nothrow) Result();
  if (!r) return nullptr;
  try {
    Decoder d(src, n, limit);
    d.run();
    r->data.swap(d.out);
  } catch (const Error& e) {
    r->ok = false;
    r->offset = e.offset;
    r->message = e.message;
  } catch (const std::bad_alloc&) {
    r->ok = false;
    r->message = "out of memory";
  } catch (const std::length_error&) {
    r->ok = false;
    r->message = "out of memory";
  }
  return r;
}

// 1 and the error's input offset, or 0
int32_t zstd_failed(void* h, int64_t* offset) {
  Result* r = static_cast<Result*>(h);
  *offset = r->offset;
  return r->ok ? 0 : 1;
}

const char* zstd_message(void* h) { return static_cast<Result*>(h)->message.c_str(); }

int64_t zstd_size(void* h) { return int64_t(static_cast<Result*>(h)->data.size()); }

void zstd_copy(void* h, uint8_t* dst) {
  Result* r = static_cast<Result*>(h);
  if (!r->data.empty()) std::memcpy(dst, r->data.data(), r->data.size());
}

void zstd_free(void* h) { delete static_cast<Result*>(h); }

uint32_t crc32c_of(const uint8_t* p, int64_t n) { return crc32c(p, size_t(n)); }

}  // extern "C"
