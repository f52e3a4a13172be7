// Native PNG decode for the host data pipeline (counterpart of the JAX
// package's native/decode.cpp).
//
// The loader's worker threads (data/pipeline.py) decode through this file:
// ctypes calls its plain C functions with the GIL released, so the decodes
// of several threads run in parallel, where PIL's chunk loop takes the GIL
// every block.  The JAX package's decoder links libpng and libjpeg; the
// machine that hosts the card has neither library's headers, so this one
// needs nothing but a C++ compiler and splits a PNG decode in three steps,
// the middle one the caller's:
//   1. ssa_png_header parses the chunks (IHDR, PLTE, the run of IDAT),
//      checks the CRC of every chunk before the first IDAT (as PIL does) and
//      copies the IDAT payloads into one buffer;
//   2. the caller inflates that zlib stream (native/__init__.py: Python's
//      zlib, whose inflate runs with the GIL released);
//   3. ssa_png_decode undoes the row filters (None, Sub, Up, Average,
//      Paeth) and converts each row to RGB or to luma.
//
// Contract: for 8-bit, non-interlaced gray, gray+alpha, RGB, RGBA and
// palette PNGs the output equals PIL's `Image.open(p).convert("RGB")`
// (alpha stripped, tRNS ignored, as PIL does) or `.convert("L")` (ITU-R
// 601-2 in PIL's fixed point, (R*19595 + G*38470 + B*7471 + 0x8000) >> 16)
// byte for byte.  Anything else (16-bit or sub-byte samples, interlacing, a
// palette index past the PLTE, a malformed chunk, a JPEG) returns a
// non-zero code, and the caller hands the file to PIL.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 decode.cpp (native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

struct SsaPng {
  int32_t width;
  int32_t height;
  int32_t color_type;  // 0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA
  int32_t n_palette;   // entries in PLTE
  int64_t idat_bytes;  // length of the concatenated IDAT payloads
  int64_t raw_bytes;   // height * (1 + width * bytes a pixel): the inflated size
  uint8_t palette[256 * 3];
};

extern "C" {
int ssa_png_header(const uint8_t *buf, int64_t n, SsaPng *png, uint8_t *idat);
int ssa_png_decode(const uint8_t *raw, int64_t raw_len, const SsaPng *png,
                   uint8_t *out, int channels);
}

// Return codes, named in native/__init__.py::_ERRORS.
enum {
  kOk = 0,
  kNotPng = 1,
  kMalformed = 2,
  kBadCrc = 3,
  kUnsupported = 4,
  kBadPalette = 5,
  kNoIdat = 6,
  kBadFilter = 7,
  kBadIndex = 8,
  kBadArgument = 9,
};

// PIL's Image.MAX_IMAGE_PIXELS: larger images go to PIL, whose own check
// warns or refuses.
static const int64_t kMaxPixels = 89478485;
static const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};

static uint32_t be32(const uint8_t *p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

static uint32_t crc32(const uint8_t *p, int64_t n) {
  static uint32_t table[256];
  static const bool filled = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)filled;
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

static int bytes_per_pixel(int color_type) {
  switch (color_type) {
    case 0: case 3: return 1;
    case 4: return 2;
    case 2: return 3;
    case 6: return 4;
    default: return 0;
  }
}

static bool is_type(const uint8_t *t, const char *name) { return memcmp(t, name, 4) == 0; }

int ssa_png_header(const uint8_t *buf, int64_t n, SsaPng *png, uint8_t *idat) {
  if (n < 8 || memcmp(buf, kSignature, 8) != 0) return kNotPng;
  memset(png, 0, sizeof *png);
  bool have_ihdr = false, in_idat = false;
  int64_t pos = 8;
  while (pos < n) {
    if (n - pos < 12) return kMalformed;
    const uint32_t len = be32(buf + pos);
    if (len > 0x7FFFFFFFu || (int64_t)len > n - pos - 12) return kMalformed;
    const uint8_t *type = buf + pos + 4, *data = buf + pos + 8;
    for (int k = 0; k < 4; ++k) {
      const uint8_t c = type[k] | 0x20;
      if (c < 'a' || c > 'z') return kMalformed;
    }
    const bool is_idat = is_type(type, "IDAT");
    if (in_idat && !is_idat) break;  // the run of IDAT is over: PIL reads no more pixels
    if (!is_idat && crc32(type, (int64_t)len + 4) != be32(data + len)) return kBadCrc;
    if (!have_ihdr && !is_type(type, "IHDR")) return kMalformed;
    if (is_type(type, "IHDR")) {
      if (have_ihdr || len != 13) return kMalformed;
      const uint32_t w = be32(data), h = be32(data + 4);
      if (w == 0 || h == 0 || w > 0x7FFFFFFFu || h > 0x7FFFFFFFu) return kMalformed;
      const int depth = data[8], color = data[9];
      // data[10..12]: compression, filter method, interlace
      if (depth != 8 || bytes_per_pixel(color) == 0 || data[10] != 0 || data[11] != 0 ||
          data[12] != 0 || (int64_t)w * h > kMaxPixels)
        return kUnsupported;
      png->width = (int32_t)w;
      png->height = (int32_t)h;
      png->color_type = color;
      have_ihdr = true;
    } else if (is_type(type, "PLTE")) {
      if (png->n_palette != 0 || len == 0 || len % 3 != 0 || len > 256 * 3) return kBadPalette;
      memcpy(png->palette, data, len);
      png->n_palette = (int32_t)(len / 3);
    } else if (is_idat) {
      memcpy(idat + png->idat_bytes, data, len);
      png->idat_bytes += len;
      in_idat = true;
    } else if (is_type(type, "IEND")) {
      break;
    }
    pos += 12 + (int64_t)len;
  }
  if (!have_ihdr) return kMalformed;
  if (!in_idat) return kNoIdat;
  if (png->color_type == 3 && png->n_palette == 0) return kBadPalette;
  png->raw_bytes =
      (int64_t)png->height * (1 + (int64_t)png->width * bytes_per_pixel(png->color_type));
  return kOk;
}

static inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// One row of `n` bytes from filter type `f`, the filtered bytes `src` and
// the previous unfiltered row `prev` (zeros above the first row).
template <int BPP>
static bool unfilter(int f, const uint8_t *src, const uint8_t *prev, uint8_t *cur, int64_t n) {
  switch (f) {
    case 0:
      memcpy(cur, src, n);
      return true;
    case 1:
      for (int64_t i = 0; i < BPP; ++i) cur[i] = src[i];
      for (int64_t i = BPP; i < n; ++i) cur[i] = (uint8_t)(src[i] + cur[i - BPP]);
      return true;
    case 2:
      for (int64_t i = 0; i < n; ++i) cur[i] = (uint8_t)(src[i] + prev[i]);
      return true;
    case 3:
      for (int64_t i = 0; i < BPP; ++i) cur[i] = (uint8_t)(src[i] + (prev[i] >> 1));
      for (int64_t i = BPP; i < n; ++i)
        cur[i] = (uint8_t)(src[i] + ((cur[i - BPP] + prev[i]) >> 1));
      return true;
    case 4:
      for (int64_t i = 0; i < BPP; ++i) cur[i] = (uint8_t)(src[i] + prev[i]);
      for (int64_t i = BPP; i < n; ++i)
        cur[i] = (uint8_t)(src[i] + paeth(cur[i - BPP], prev[i], prev[i - BPP]));
      return true;
    default:
      return false;
  }
}

static inline uint8_t luma(unsigned r, unsigned g, unsigned b) {
  return (uint8_t)((r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
}

// One unfiltered row to `channels` (3: RGB, 1: luma) bytes a pixel.
static bool convert(const SsaPng *png, const uint8_t *row, uint8_t *out, int channels) {
  const int64_t w = png->width;
  switch (png->color_type) {
    case 0:
      if (channels == 1) {
        memcpy(out, row, w);
      } else {
        for (int64_t x = 0; x < w; ++x) out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = row[x];
      }
      return true;
    case 4:
      for (int64_t x = 0; x < w; ++x) {
        if (channels == 1) {
          out[x] = row[2 * x];
        } else {
          out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = row[2 * x];
        }
      }
      return true;
    case 2:
      if (channels == 3) {
        memcpy(out, row, 3 * w);
      } else {
        for (int64_t x = 0; x < w; ++x) out[x] = luma(row[3 * x], row[3 * x + 1], row[3 * x + 2]);
      }
      return true;
    case 6:
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t *p = row + 4 * x;
        if (channels == 1) {
          out[x] = luma(p[0], p[1], p[2]);
        } else {
          out[3 * x] = p[0];
          out[3 * x + 1] = p[1];
          out[3 * x + 2] = p[2];
        }
      }
      return true;
    case 3:
      for (int64_t x = 0; x < w; ++x) {
        if (row[x] >= png->n_palette) return false;
        const uint8_t *p = png->palette + 3 * row[x];
        if (channels == 1) {
          out[x] = luma(p[0], p[1], p[2]);
        } else {
          out[3 * x] = p[0];
          out[3 * x + 1] = p[1];
          out[3 * x + 2] = p[2];
        }
      }
      return true;
    default:
      return false;
  }
}

int ssa_png_decode(const uint8_t *raw, int64_t raw_len, const SsaPng *png, uint8_t *out,
                   int channels) {
  if ((channels != 1 && channels != 3) || raw_len != png->raw_bytes) return kBadArgument;
  const int bpp = bytes_per_pixel(png->color_type);
  if (bpp == 0) return kBadArgument;
  const int64_t row_bytes = (int64_t)png->width * bpp;
  std::vector<uint8_t> rows(2 * row_bytes, 0);
  uint8_t *prev = rows.data(), *cur = rows.data() + row_bytes;
  for (int64_t y = 0; y < png->height; ++y) {
    const uint8_t *line = raw + y * (row_bytes + 1);
    bool ok = false;
    switch (bpp) {
      case 1: ok = unfilter<1>(line[0], line + 1, prev, cur, row_bytes); break;
      case 2: ok = unfilter<2>(line[0], line + 1, prev, cur, row_bytes); break;
      case 3: ok = unfilter<3>(line[0], line + 1, prev, cur, row_bytes); break;
      case 4: ok = unfilter<4>(line[0], line + 1, prev, cur, row_bytes); break;
    }
    if (!ok) return kBadFilter;
    if (!convert(png, cur, out + y * png->width * channels, channels)) return kBadIndex;
    std::swap(prev, cur);
  }
  return kOk;
}
