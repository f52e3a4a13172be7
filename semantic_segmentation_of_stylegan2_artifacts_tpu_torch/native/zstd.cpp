// A Zstandard decoder (RFC 8878) and CRC-32C, for the orbax checkpoint
// reader (train/ocdbt.py, train/zarr.py).
//
// An orbax checkpoint is an OCDBT key-value store whose B-tree nodes and
// manifests are zstd frames, holding zarr v2 arrays whose chunks are zstd
// frames too; every OCDBT file ends in a CRC-32C.  The machine that hosts
// the card has no libzstd headers, so this file decodes the format itself
// and needs nothing but a C++ compiler:
//   * frames, with or without a content size, window or single segment;
//     skippable frames; several frames one after another;
//   * raw, RLE and compressed blocks;
//   * raw, RLE, Huffman and treeless literals, one stream or four; Huffman
//     weights written directly or FSE-coded;
//   * sequences with predefined, RLE, FSE and repeat tables, and the three
//     repeat offsets;
//   * the XXH64 content checksum, verified when the frame carries one.
// A frame with a dictionary ID other than 0 is refused.  Any malformed,
// truncated or checksum-failing input returns -1 with a message and no
// partial result: every read is bounds-checked, so no input crashes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 zstd.cpp (native/zstd.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
int64_t ssa_zstd_bound(const uint8_t *src, int64_t n, char *err, int64_t err_len);
int64_t ssa_zstd_decompress(const uint8_t *src, int64_t n, uint8_t *dst, int64_t cap,
                            char *err, int64_t err_len);
uint32_t ssa_crc32c(const uint8_t *p, int64_t n, uint32_t crc);
}

namespace {

struct Error {
  const char *msg;
};

[[noreturn]] void fail(const char *msg) { throw Error{msg}; }
inline void check(bool ok, const char *msg) {
  if (!ok) fail(msg);
}

const uint32_t kMagic = 0xFD2FB528u;
const size_t kBlockMax = 128 * 1024;  // Block_Maximum_Size's ceiling

inline uint32_t le16(const uint8_t *p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t le24(const uint8_t *p) { return le16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t le32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t le64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint64_t le_n(const uint8_t *p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}
inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }  // v > 0
inline uint64_t mask(int n) { return n >= 64 ? ~0ull : (1ull << n) - 1; }

// ---- XXH64 ---------------------------------------------------------------
const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
               P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
               P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxmerge(uint64_t acc, uint64_t v) { return (acc ^ xxround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t *p, size_t n, uint64_t seed) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t *limit = end - 32;
    do {
      v1 = xxround(v1, le64(p));
      v2 = xxround(v2, le64(p + 8));
      v3 = xxround(v3, le64(p + 16));
      v4 = xxround(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1);
    h = xxmerge(h, v2);
    h = xxmerge(h, v3);
    h = xxmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- CRC-32C (Castagnoli, reflected 0x82F63B78), eight bytes a step -------
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t *p, size_t n, uint32_t crc) {
  static const CrcTables T;
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t v = le64(p) ^ crc;
    crc = T.t[7][v & 0xFF] ^ T.t[6][(v >> 8) & 0xFF] ^ T.t[5][(v >> 16) & 0xFF] ^
          T.t[4][(v >> 24) & 0xFF] ^ T.t[3][(v >> 32) & 0xFF] ^ T.t[2][(v >> 40) & 0xFF] ^
          T.t[1][(v >> 48) & 0xFF] ^ T.t[0][v >> 56];
  }
  for (; n; --n, ++p) crc = (crc >> 8) ^ T.t[0][(crc ^ *p) & 0xFF];
  return ~crc;
}

// ---- bit readers -----------------------------------------------------------
// Forward, least significant bit first: the FSE table descriptions.  Bits
// past the end read as 0; the caller checks how far it read.
struct ForwardBits {
  const uint8_t *p;
  size_t n;
  size_t pos = 0;  // bits read
  uint32_t peek(int nb) const {
    size_t byte = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & mask(nb));
  }
  void skip(int nb) { pos += nb; }
};

// Backward, from the last byte's end mark down to bit 0: Huffman streams,
// FSE-coded weights and sequences.  Reading past bit 0 yields zeros and
// leaves `pos` negative, which the caller reads as an overflow.
struct BackBits {
  const uint8_t *p = nullptr;
  int64_t n = 0;
  int64_t pos = 0;  // bits left
  void init(const uint8_t *src, int64_t size) {
    check(size >= 1, "empty bitstream");
    check(src[size - 1] != 0, "bitstream without its end mark");
    p = src;
    n = size;
    pos = 8 * (size - 1) + highbit(src[size - 1]);
  }
  uint64_t load(int64_t byte) const {
    if (byte + 8 <= n) return le64(p + byte);
    uint64_t v = 0;
    for (int i = 0; i < 8 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return v;
  }
  uint64_t peek(int nb) const {  // nb <= 56
    if (nb == 0) return 0;
    int64_t start = pos - nb;
    if (start >= 0) return (load(start >> 3) >> (start & 7)) & mask(nb);
    if (pos <= 0) return 0;
    return (load(0) & mask(int(pos))) << (-start);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
  bool overflow() const { return pos < 0; }
};

// ---- FSE -------------------------------------------------------------------
struct FseCell {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct Fse {
  int log = 0;
  bool valid = false;
  FseCell t[512];
};

// Reads an FSE table description (RFC 8878 4.1.1) into `norm`; returns the
// bytes it took.
size_t read_ncount(const uint8_t *src, size_t n, int16_t *norm, int max_symbol, int max_log,
                   int &log, int &nsym) {
  check(n >= 1, "truncated FSE table description");
  ForwardBits br{src, n};
  int acc = int(br.peek(4)) + 5;
  br.skip(4);
  check(acc <= max_log, "FSE accuracy log too large");
  log = acc;
  int remaining = (1 << acc) + 1;
  int threshold = 1 << acc;
  int nb = acc + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_symbol) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = br.peek(2);
        br.skip(2);
        n0 += int(r);
        if (r != 3) break;
        check(br.pos <= 8 * n, "truncated FSE table description");
      }
      check(n0 <= max_symbol, "FSE table description: symbol out of range");
      while (sym < n0) norm[sym++] = 0;
    }
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = br.peek(nb);
    int count;
    if (int(v & uint32_t(threshold - 1)) < max) {
      count = int(v & uint32_t(threshold - 1));
      br.skip(nb - 1);
    } else {
      count = int(v & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(nb);
    }
    count--;
    remaining -= count < 0 ? -count : count;
    check(remaining >= 1, "corrupt FSE table description");
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nb--;
      threshold >>= 1;
    }
  }
  check(remaining == 1, "corrupt FSE table description");
  size_t bytes = (br.pos + 7) / 8;
  check(bytes <= n, "truncated FSE table description");
  nsym = sym;
  return bytes;
}

void build_fse(Fse &f, const int16_t *norm, int nsym, int log) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      f.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, pos = 0;
  for (int s = 0; s < nsym; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].symbol = uint16_t(s);
      do pos = (pos + step) & (size - 1);
      while (pos > high);
    }
  check(pos == 0, "corrupt FSE table");
  for (int u = 0; u < size; ++u) {
    int x = next[f.t[u].symbol]++;
    int bits = log - highbit(uint64_t(x));
    f.t[u].bits = uint8_t(bits);
    f.t[u].base = uint16_t((x << bits) - size);
  }
  f.log = log;
  f.valid = true;
}

void rle_fse(Fse &f, int symbol) {
  f.t[0] = FseCell{uint16_t(symbol), 0, 0};
  f.log = 0;
  f.valid = true;
}

// The predefined distributions (RFC 8878 3.1.1.3.2.2).
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,   5,   6,   7,   8,    9,    10,   11,
                              12, 13, 14, 15, 16,  18,  20,  22,  24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22,  23,  24,  25,   26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37,  39,  41,  43,   47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Defaults {
  Fse ll, ml, of;
  Defaults() {
    build_fse(ll, kLLNorm, 36, 6);
    build_fse(ml, kMLNorm, 53, 6);
    build_fse(of, kOFNorm, 29, 5);
  }
};

// ---- Huffman ---------------------------------------------------------------
struct Huf {
  int bits = 0;  // Max_Number_of_Bits
  bool valid = false;
  uint8_t symbol[1 << 11];
  uint8_t length[1 << 11];
};

void build_huf(Huf &h, uint8_t *w, int nw) {
  check(nw >= 1 && nw <= 255, "bad Huffman weight count");
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    check(w[i] <= 11, "Huffman weight too large");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  check(total > 0, "Huffman weights all zero");
  int bits = highbit(total) + 1;
  check(bits <= 11, "Huffman code longer than 11 bits");
  uint32_t rest = (1u << bits) - total;
  check((rest & (rest - 1)) == 0, "Huffman weights do not complete a tree");
  w[nw] = uint8_t(highbit(rest) + 1);
  int nsym = nw + 1;
  uint32_t pos = 0;
  for (int weight = 1; weight <= bits; ++weight)
    for (int s = 0; s < nsym; ++s)
      if (w[s] == weight) {
        uint32_t len = 1u << (weight - 1);
        memset(h.symbol + pos, s, len);
        memset(h.length + pos, bits + 1 - weight, len);
        pos += len;
      }
  check(pos == (1u << bits), "corrupt Huffman table");
  h.bits = bits;
  h.valid = true;
}

// FSE-coded Huffman weights (RFC 8878 4.2.1.2): two interleaved states.
int fse_weights(const uint8_t *src, size_t n, uint8_t *w) {
  int16_t norm[256];
  int log, nsym;
  size_t hdr = read_ncount(src, n, norm, 255, 6, log, nsym);
  check(hdr < n, "truncated Huffman weights");
  static thread_local Fse f;
  build_fse(f, norm, nsym, log);
  BackBits br;
  br.init(src + hdr, int64_t(n - hdr));
  uint32_t s1 = uint32_t(br.read(log)), s2 = uint32_t(br.read(log));
  int out = 0;
  for (;;) {
    check(out + 2 <= 255, "too many Huffman weights");
    w[out++] = uint8_t(f.t[s1].symbol);
    s1 = f.t[s1].base + uint32_t(br.read(f.t[s1].bits));
    if (br.overflow()) {
      w[out++] = uint8_t(f.t[s2].symbol);
      break;
    }
    w[out++] = uint8_t(f.t[s2].symbol);
    s2 = f.t[s2].base + uint32_t(br.read(f.t[s2].bits));
    if (br.overflow()) {
      w[out++] = uint8_t(f.t[s1].symbol);
      break;
    }
  }
  return out;
}

size_t read_huf(Huf &h, const uint8_t *src, size_t n) {
  check(n >= 1, "truncated Huffman tree description");
  uint8_t w[257];
  int nw;
  size_t used;
  int head = src[0];
  if (head >= 128) {
    nw = head - 127;
    size_t bytes = (size_t(nw) + 1) / 2;
    check(1 + bytes <= n, "truncated Huffman weights");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  } else {
    check(head >= 1 && size_t(1 + head) <= n, "truncated Huffman weights");
    nw = fse_weights(src + 1, size_t(head), w);
    used = 1 + size_t(head);
  }
  build_huf(h, w, nw);
  return used;
}

void huf_stream(const Huf &h, const uint8_t *src, size_t n, uint8_t *out, size_t count) {
  BackBits br;
  br.init(src, int64_t(n));
  for (size_t i = 0; i < count; ++i) {
    uint32_t v = uint32_t(br.peek(h.bits));
    out[i] = h.symbol[v];
    br.pos -= h.length[v];
  }
  check(br.pos == 0, "corrupt Huffman stream");
}

// ---- frames and blocks -----------------------------------------------------
struct Frame {
  Huf huf;
  Fse ll, ml, of;
  uint64_t rep[3] = {1, 4, 8};
  uint8_t lit[kBlockMax];
  size_t nlit = 0;
};

struct Out {
  uint8_t *dst;
  size_t cap;
  size_t pos;
  size_t frame_start;
  void need(size_t k) const { check(k <= cap - pos, "decoded data larger than its bound"); }
};

size_t decode_literals(Frame &fr, const uint8_t *src, size_t n) {
  check(n >= 1, "truncated literals section");
  int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  if (type <= 1) {  // raw or RLE
    size_t hs, regen;
    if ((sf & 1) == 0) {
      hs = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      check(n >= 2, "truncated literals header");
      hs = 2;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      check(n >= 3, "truncated literals header");
      hs = 3;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    check(regen <= kBlockMax, "literals larger than a block");
    fr.nlit = regen;
    if (type == 0) {
      check(hs + regen <= n, "truncated raw literals");
      memcpy(fr.lit, src + hs, regen);
      return hs + regen;
    }
    check(hs + 1 <= n, "truncated RLE literals");
    memset(fr.lit, src[hs], regen);
    return hs + 1;
  }
  // Huffman (2) or treeless (3)
  int hs = sf <= 1 ? 3 : sf + 2;
  int bits = sf <= 1 ? 10 : (sf == 2 ? 14 : 18);
  bool four = sf != 0;
  check(n >= size_t(hs), "truncated literals header");
  uint64_t head = le_n(src, hs);
  size_t regen = size_t((head >> 4) & mask(bits));
  size_t comp = size_t((head >> (4 + bits)) & mask(bits));
  check(regen <= kBlockMax, "literals larger than a block");
  check(size_t(hs) + comp <= n, "truncated compressed literals");
  const uint8_t *p = src + hs;
  size_t rem = comp;
  if (type == 2) {
    size_t used = read_huf(fr.huf, p, rem);
    p += used;
    rem -= used;
  } else {
    check(fr.huf.valid, "treeless literals with no earlier Huffman table");
  }
  fr.nlit = regen;
  if (!four) {
    huf_stream(fr.huf, p, rem, fr.lit, regen);
  } else {
    check(rem >= 6, "truncated jump table");
    size_t s1 = le16(p), s2 = le16(p + 2), s3 = le16(p + 4);
    check(6 + s1 + s2 + s3 <= rem, "corrupt jump table");
    size_t s4 = rem - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    check(3 * seg <= regen, "too few literals for four streams");
    const uint8_t *q = p + 6;
    huf_stream(fr.huf, q, s1, fr.lit, seg);
    huf_stream(fr.huf, q + s1, s2, fr.lit + seg, seg);
    huf_stream(fr.huf, q + s1 + s2, s3, fr.lit + 2 * seg, seg);
    huf_stream(fr.huf, q + s1 + s2 + s3, s4, fr.lit + 3 * seg, regen - 3 * seg);
  }
  return size_t(hs) + comp;
}

size_t read_table(Fse &f, int mode, const uint8_t *src, size_t n, const Fse &predefined,
                  int max_symbol, int max_log) {
  switch (mode) {
    case 0:
      f = predefined;
      return 0;
    case 1:
      check(n >= 1, "truncated RLE sequence table");
      check(src[0] <= max_symbol, "RLE sequence symbol out of range");
      rle_fse(f, src[0]);
      return 1;
    case 2: {
      int16_t norm[64];
      int log, nsym;
      size_t used = read_ncount(src, n, norm, max_symbol, max_log, log, nsym);
      build_fse(f, norm, nsym, log);
      return used;
    }
    default:
      check(f.valid, "repeat sequence table with no earlier table");
      return 0;
  }
}

void copy_match(Out &o, uint64_t offset, size_t len) {
  check(offset >= 1 && offset <= o.pos - o.frame_start, "match offset before the frame start");
  o.need(len);
  uint8_t *d = o.dst + o.pos;
  const uint8_t *s = d - offset;
  if (offset >= len) {
    memcpy(d, s, len);
  } else {
    for (size_t i = 0; i < len; ++i) d[i] = s[i];
  }
  o.pos += len;
}

void decode_sequences(Frame &fr, const uint8_t *src, size_t n, Out &o) {
  static const Defaults D;
  check(n >= 1, "truncated sequences section");
  size_t nseq, used;
  if (src[0] < 128) {
    nseq = src[0];
    used = 1;
  } else if (src[0] < 255) {
    check(n >= 2, "truncated sequences header");
    nseq = ((size_t(src[0]) - 128) << 8) + src[1];
    used = 2;
  } else {
    check(n >= 3, "truncated sequences header");
    nseq = src[1] + (size_t(src[2]) << 8) + 0x7F00;
    used = 3;
  }
  const uint8_t *lit = fr.lit;
  size_t nlit = fr.nlit;
  if (nseq == 0) {
    check(used == n, "bytes after an empty sequences section");
  } else {
    check(used < n, "truncated sequences header");
    int modes = src[used++];
    check((modes & 3) == 0, "reserved sequence mode bits set");
    used += read_table(fr.ll, modes >> 6, src + used, n - used, D.ll, 35, 9);
    used += read_table(fr.of, (modes >> 4) & 3, src + used, n - used, D.of, 31, 8);
    used += read_table(fr.ml, (modes >> 2) & 3, src + used, n - used, D.ml, 52, 9);
    check(used < n, "truncated sequences bitstream");
    BackBits br;
    br.init(src + used, int64_t(n - used));
    uint32_t sll = uint32_t(br.read(fr.ll.log));
    uint32_t sof = uint32_t(br.read(fr.of.log));
    uint32_t sml = uint32_t(br.read(fr.ml.log));
    uint64_t *rep = fr.rep;
    for (size_t i = 0; i < nseq; ++i) {
      int ofc = fr.of.t[sof].symbol, llc = fr.ll.t[sll].symbol, mlc = fr.ml.t[sml].symbol;
      check(ofc <= 31 && llc <= 35 && mlc <= 52, "sequence code out of range");
      uint64_t ofv = (1ull << ofc) + br.read(ofc);
      size_t ml = kMLBase[mlc] + size_t(br.read(kMLBits[mlc]));
      size_t ll = kLLBase[llc] + size_t(br.read(kLLBits[llc]));
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        uint64_t idx = ofv + (ll == 0 ? 1 : 0);  // 1..4
        if (idx == 1) {
          offset = rep[0];
        } else {
          offset = idx == 4 ? rep[0] - 1 : rep[idx - 1];
          if (idx != 2) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = fr.ll.t[sll].base + uint32_t(br.read(fr.ll.t[sll].bits));
        sml = fr.ml.t[sml].base + uint32_t(br.read(fr.ml.t[sml].bits));
        sof = fr.of.t[sof].base + uint32_t(br.read(fr.of.t[sof].bits));
      }
      check(ll <= nlit, "literal length past the literals");
      o.need(ll);
      memcpy(o.dst + o.pos, lit, ll);
      o.pos += ll;
      lit += ll;
      nlit -= ll;
      copy_match(o, offset, ml);
    }
    check(br.pos == 0, "corrupt sequences bitstream");
  }
  o.need(nlit);
  memcpy(o.dst + o.pos, lit, nlit);
  o.pos += nlit;
}

struct Header {
  size_t size;  // bytes of magic and header
  bool checksum;
  bool has_fcs;
  uint64_t fcs;
  uint64_t window;
};

Header read_header(const uint8_t *p, size_t n) {
  check(n >= 5, "truncated frame header");
  int fhd = p[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  check(((fhd >> 3) & 1) == 0, "reserved frame header bit set");
  Header h{5, bool((fhd >> 2) & 1), false, 0, 0};
  if (!single) {
    check(n >= h.size + 1, "truncated frame header");
    int wd = p[h.size++];
    int wlog = 10 + (wd >> 3);
    check(wlog <= 41, "window too large");
    uint64_t base = 1ull << wlog;
    h.window = base + (base >> 3) * uint64_t(wd & 7);
  }
  static const int kDid[4] = {0, 1, 2, 4};
  static const int kFcs[4] = {0, 2, 4, 8};
  int did_size = kDid[did_flag];
  int fcs_size = fcs_flag == 0 ? single : kFcs[fcs_flag];
  check(n >= h.size + did_size + fcs_size, "truncated frame header");
  uint64_t did = le_n(p + h.size, did_size);
  check(did == 0, "frame needs a dictionary");
  h.size += did_size;
  if (fcs_size) {
    h.has_fcs = true;
    h.fcs = le_n(p + h.size, fcs_size) + (fcs_size == 2 ? 256 : 0);
    h.size += fcs_size;
  }
  if (single) h.window = h.fcs;
  return h;
}

// Returns the bytes of frame (or skippable frame) at `p`; adds its decoded
// size, or an upper bound of it, to `out_size`.
size_t walk_frame(const uint8_t *p, size_t n, uint64_t &out_size) {
  check(n >= 4, "truncated frame");
  uint32_t magic = le32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    check(n >= 8, "truncated skippable frame");
    uint64_t size = le32(p + 4);
    check(8 + size <= n, "truncated skippable frame");
    return size_t(8 + size);
  }
  check(magic == kMagic, "not a zstd frame (bad magic)");
  Header h = read_header(p, n);
  uint64_t bound = 0;
  uint64_t block_max = h.window < kBlockMax ? h.window : kBlockMax;
  size_t pos = h.size;
  for (;;) {
    check(n - pos >= 3, "truncated block header");
    uint32_t bh = le24(p + pos);
    pos += 3;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    check(type != 3, "reserved block type");
    size_t body = type == 1 ? 1 : size;
    check(n - pos >= body, "truncated block");
    bound += type == 2 ? block_max : size;
    pos += body;
    if (bh & 1) break;
  }
  if (h.checksum) {
    check(n - pos >= 4, "truncated frame checksum");
    pos += 4;
  }
  out_size += h.has_fcs ? h.fcs : bound;
  return pos;
}

size_t decode_frame(Frame &fr, const uint8_t *p, size_t n, Out &o) {
  uint32_t magic = le32(p);
  if (magic != kMagic) {  // a skippable frame, checked by walk_frame
    return size_t(8 + le32(p + 4));
  }
  Header h = read_header(p, n);
  fr.huf.valid = fr.ll.valid = fr.ml.valid = fr.of.valid = false;
  fr.rep[0] = 1;
  fr.rep[1] = 4;
  fr.rep[2] = 8;
  o.frame_start = o.pos;
  size_t pos = h.size;
  for (;;) {
    uint32_t bh = le24(p + pos);
    pos += 3;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    check(size <= kBlockMax, "block larger than 128 KiB");
    size_t start = o.pos;
    if (type == 0) {
      o.need(size);
      memcpy(o.dst + o.pos, p + pos, size);
      o.pos += size;
      pos += size;
    } else if (type == 1) {
      o.need(size);
      memset(o.dst + o.pos, p[pos], size);
      o.pos += size;
      pos += 1;
    } else {
      size_t lit = decode_literals(fr, p + pos, size);
      decode_sequences(fr, p + pos + lit, size - lit, o);
      pos += size;
    }
    check(o.pos - start <= kBlockMax, "block decodes to more than 128 KiB");
    if (bh & 1) break;
  }
  size_t content = o.pos - o.frame_start;
  if (h.has_fcs) check(content == h.fcs, "frame content size mismatch");
  if (h.checksum) {
    uint32_t want = le32(p + pos);
    pos += 4;
    check(uint32_t(xxh64(o.dst + o.frame_start, content, 0)) == want,
          "frame checksum mismatch");
  }
  return pos;
}

void set_error(char *err, int64_t err_len, const char *msg) {
  if (err && err_len > 0) snprintf(err, size_t(err_len), "%s", msg);
}

}  // namespace

// An upper bound of the decoded size of the frames in src[0, n), from their
// headers and block headers; -1 with a message when they are malformed.
int64_t ssa_zstd_bound(const uint8_t *src, int64_t n, char *err, int64_t err_len) {
  try {
    check(n > 0, "no zstd frame");
    uint64_t total = 0;
    size_t pos = 0;
    while (pos < size_t(n)) pos += walk_frame(src + pos, size_t(n) - pos, total);
    check(total < (1ull << 62), "decoded size too large");
    return int64_t(total);
  } catch (const Error &e) {
    set_error(err, err_len, e.msg);
    return -1;
  }
}

// Decodes the frames in src[0, n) into dst[0, cap); returns the decoded
// size, or -1 with a message.
int64_t ssa_zstd_decompress(const uint8_t *src, int64_t n, uint8_t *dst, int64_t cap,
                            char *err, int64_t err_len) {
  try {
    check(n > 0, "no zstd frame");
    check(cap >= 0, "bad argument");
    uint64_t ignored = 0;
    std::vector<Frame> fr(1);
    Out o{dst, size_t(cap), 0, 0};
    size_t pos = 0;
    while (pos < size_t(n)) {
      size_t len = walk_frame(src + pos, size_t(n) - pos, ignored);  // bounds first
      size_t used = decode_frame(fr[0], src + pos, len, o);
      check(used == len, "corrupt frame");
      pos += len;
    }
    return int64_t(o.pos);
  } catch (const Error &e) {
    set_error(err, err_len, e.msg);
    return -1;
  }
}

uint32_t ssa_crc32c(const uint8_t *p, int64_t n, uint32_t crc) {
  return crc32c(p, size_t(n), crc);
}
