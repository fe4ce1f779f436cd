// Native baseline-TIFF decoder for the C3VD depth maps (16-bit grayscale
// tiffs, which the reference's c3vd.py reads via OpenCV). The port's copy
// of the JAX package's data/native/tiffdec.cpp, built by the port's
// utils/cbuild.py with the same flags.
//
// Supported: single-IFD striped TIFF, 8/16-bit, 1..4 samples/pixel,
// chunky planar config, compression none(1)/LZW(5)/PackBits(32773),
// horizontal-differencing predictor(2), both byte orders. Tiled TIFFs and
// other compressions return an error.
//
// C ABI (ctypes bindings in data/native.py):
//   e3d_tiff_info(path, &h, &w, &channels, &bits) -> 0 ok
//   e3d_tiff_decode(path, out, out_capacity_bytes) -> 0 ok

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tag {
  uint16_t type = 0;
  uint32_t count = 0;
  uint32_t inline_val = 0;  // raw 4 bytes (already endian-correct per-type)
  size_t offset = 0;        // absolute file offset of the value area
};

struct Tiff {
  std::vector<uint8_t> data;
  bool big_endian = false;

  uint16_t u16(size_t off) const {
    if (off + 2 > data.size()) return 0;
    return big_endian ? (data[off] << 8) | data[off + 1]
                      : (data[off + 1] << 8) | data[off];
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > data.size()) return 0;
    return big_endian
               ? (uint32_t(data[off]) << 24) | (uint32_t(data[off + 1]) << 16) |
                     (uint32_t(data[off + 2]) << 8) | data[off + 3]
               : (uint32_t(data[off + 3]) << 24) |
                     (uint32_t(data[off + 2]) << 16) |
                     (uint32_t(data[off + 1]) << 8) | data[off];
  }
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    fclose(f);
    return false;
  }
  out.resize(size_t(n));
  size_t got = fread(out.data(), 1, size_t(n), f);
  fclose(f);
  return got == size_t(n);
}

int type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;  // BYTE/ASCII/SBYTE/UNDEF
    case 3: case 8: return 2;                  // SHORT
    case 4: case 9: case 11: return 4;         // LONG/FLOAT
    case 5: case 10: case 12: return 8;        // RATIONAL/DOUBLE
    default: return 0;
  }
}

// Read the i-th value of a tag as uint32.
uint32_t tag_value(const Tiff& tf, const Tag& tag, uint32_t i) {
  int sz = type_size(tag.type);
  size_t base = tag.offset + size_t(i) * sz;
  if (sz == 2) return tf.u16(base);
  if (sz == 4) return tf.u32(base);
  if (sz == 1) return base < tf.data.size() ? tf.data[base] : 0;
  return 0;
}

struct Info {
  uint32_t width = 0, height = 0, spp = 1, bits = 1, comp = 1, pred = 1,
           rows_per_strip = 0xFFFFFFFFu;
  Tag strip_offsets, strip_counts;
  bool tiled = false;
};

int parse(const char* path, Tiff& tf, Info& info) {
  if (!read_file(path, tf.data) || tf.data.size() < 8) return 1;
  if (tf.data[0] == 'I' && tf.data[1] == 'I')
    tf.big_endian = false;
  else if (tf.data[0] == 'M' && tf.data[1] == 'M')
    tf.big_endian = true;
  else
    return 2;
  if (tf.u16(2) != 42) return 2;
  size_t ifd = tf.u32(4);
  if (ifd + 2 > tf.data.size()) return 3;
  uint16_t n = tf.u16(ifd);
  for (uint16_t i = 0; i < n; i++) {
    size_t e = ifd + 2 + size_t(i) * 12;
    if (e + 12 > tf.data.size()) return 3;
    uint16_t id = tf.u16(e);
    Tag t;
    t.type = tf.u16(e + 2);
    t.count = tf.u32(e + 4);
    size_t val_bytes = size_t(type_size(t.type)) * t.count;
    t.offset = val_bytes <= 4 ? e + 8 : tf.u32(e + 8);
    switch (id) {
      case 256: info.width = tag_value(tf, t, 0); break;
      case 257: info.height = tag_value(tf, t, 0); break;
      case 258: info.bits = tag_value(tf, t, 0); break;
      case 259: info.comp = tag_value(tf, t, 0); break;
      case 273: info.strip_offsets = t; break;
      case 277: info.spp = tag_value(tf, t, 0); break;
      case 278: info.rows_per_strip = tag_value(tf, t, 0); break;
      case 279: info.strip_counts = t; break;
      case 317: info.pred = tag_value(tf, t, 0); break;
      case 284:
        if (tag_value(tf, t, 0) != 1) return 4;  // planar unsupported
        break;
      case 322: case 323: info.tiled = true; break;
      default: break;
    }
  }
  if (info.tiled) return 5;
  if (!info.width || !info.height) return 3;
  if (info.bits != 8 && info.bits != 16) return 6;
  if (info.spp < 1 || info.spp > 4) return 6;
  if (info.comp != 1 && info.comp != 5 && info.comp != 32773) return 7;
  if (info.pred != 1 && info.pred != 2) return 7;
  return 0;
}

// TIFF-variant LZW (MSB-first, early code-width change).
int lzw_decode(const uint8_t* in, size_t in_len, uint8_t* out,
               size_t out_len) {
  constexpr int kClear = 256, kEoi = 257, kMax = 4096;
  std::vector<int> prev(kMax, -1);
  std::vector<uint8_t> suffix(kMax, 0);
  std::vector<uint8_t> stack(kMax);
  int next = 258, width = 9, old_code = -1;
  size_t bitpos = 0, out_pos = 0;
  uint8_t first_byte = 0;

  auto get_code = [&]() -> int {
    if ((bitpos + width) > in_len * 8) return kEoi;
    size_t byte = bitpos >> 3;
    uint32_t acc = 0;
    for (int i = 0; i < 4; i++)
      acc = (acc << 8) | (byte + i < in_len ? in[byte + i] : 0);
    int shift = 32 - int(bitpos & 7) - width;
    bitpos += width;
    return int((acc >> shift) & ((1u << width) - 1));
  };
  auto emit = [&](int code) -> int {  // returns first byte, or -1 overflow
    int n = 0;
    for (int c = code; c >= 0; c = prev[c]) {
      if (n >= kMax) return -1;
      stack[n++] = suffix[c];
      if (prev[c] < 0) break;
    }
    first_byte = stack[n - 1];
    if (out_pos + size_t(n) > out_len) n = int(out_len - out_pos);
    for (int i = n - 1; i >= 0; i--) out[out_pos++] = stack[i];
    return 0;
  };

  for (int c = 0; c < 256; c++) suffix[c] = uint8_t(c);
  while (out_pos < out_len) {
    int code = get_code();
    if (code == kEoi) break;
    if (code == kClear) {
      next = 258;
      width = 9;
      old_code = -1;
      continue;
    }
    if (old_code < 0) {
      if (code > 255) return 1;
      if (emit(code)) return 1;
      old_code = code;
      continue;
    }
    if (code < next) {
      if (emit(code)) return 1;
    } else if (code == next) {
      // KwKwK case: old string + its first byte.
      prev[next] = old_code;
      suffix[next] = first_byte;  // first byte of old string
      if (emit(code)) return 1;
      old_code = code;
      if (++next >= (1 << width) - 1 && width < 12) width++;
      continue;
    } else {
      return 1;
    }
    if (next < kMax) {
      prev[next] = old_code;
      suffix[next] = first_byte;
      if (++next >= (1 << width) - 1 && width < 12) width++;
    }
    old_code = code;
  }
  return out_pos == out_len ? 0 : 2;
}

int packbits_decode(const uint8_t* in, size_t in_len, uint8_t* out,
                    size_t out_len) {
  size_t ip = 0, op = 0;
  while (op < out_len && ip < in_len) {
    int8_t n = int8_t(in[ip++]);
    if (n >= 0) {
      size_t cnt = size_t(n) + 1;
      if (ip + cnt > in_len || op + cnt > out_len) return 1;
      memcpy(out + op, in + ip, cnt);
      ip += cnt;
      op += cnt;
    } else if (n != -128) {
      size_t cnt = size_t(-n) + 1;
      if (ip >= in_len || op + cnt > out_len) return 1;
      memset(out + op, in[ip++], cnt);
      op += cnt;
    }
  }
  return op == out_len ? 0 : 2;
}

}  // namespace

extern "C" int e3d_tiff_info(const char* path, int* h, int* w, int* ch,
                             int* bits) {
  Tiff tf;
  Info info;
  int rc = parse(path, tf, info);
  if (rc) return rc;
  *h = int(info.height);
  *w = int(info.width);
  *ch = int(info.spp);
  *bits = int(info.bits);
  return 0;
}

extern "C" int e3d_tiff_decode(const char* path, uint8_t* out,
                               long long capacity) {
  Tiff tf;
  Info info;
  int rc = parse(path, tf, info);
  if (rc) return rc;
  const size_t bytes_pp = info.bits / 8;
  const size_t row_bytes = size_t(info.width) * info.spp * bytes_pp;
  const size_t total = row_bytes * info.height;
  if (capacity < 0 || size_t(capacity) < total) return 10;

  uint32_t rps = info.rows_per_strip ? info.rows_per_strip : info.height;
  if (rps > info.height) rps = info.height;
  uint32_t n_strips = (info.height + rps - 1) / rps;
  if (info.strip_offsets.count < n_strips ||
      info.strip_counts.count < n_strips)
    return 11;

  for (uint32_t s = 0; s < n_strips; s++) {
    size_t src_off = tag_value(tf, info.strip_offsets, s);
    size_t src_len = tag_value(tf, info.strip_counts, s);
    if (src_off + src_len > tf.data.size()) return 12;
    uint32_t rows =
        (s == n_strips - 1) ? info.height - s * rps : rps;
    size_t dst_off = size_t(s) * rps * row_bytes;
    size_t dst_len = size_t(rows) * row_bytes;
    const uint8_t* src = tf.data.data() + src_off;
    if (info.comp == 1) {
      if (src_len < dst_len) return 13;
      memcpy(out + dst_off, src, dst_len);
    } else if (info.comp == 5) {
      if (lzw_decode(src, src_len, out + dst_off, dst_len)) return 14;
    } else {  // PackBits
      if (packbits_decode(src, src_len, out + dst_off, dst_len)) return 15;
    }
  }

  // 16-bit byte order: output is host (little-endian) uint16.
  if (info.bits == 16 && tf.big_endian) {
    for (size_t i = 0; i + 1 < total; i += 2) {
      uint8_t t = out[i];
      out[i] = out[i + 1];
      out[i + 1] = t;
    }
  }
  // Horizontal-differencing predictor (applied after byte swap).
  if (info.pred == 2) {
    for (uint32_t r = 0; r < info.height; r++) {
      uint8_t* row = out + size_t(r) * row_bytes;
      if (info.bits == 8) {
        for (size_t i = info.spp; i < row_bytes; i++) row[i] += row[i - info.spp];
      } else {
        uint16_t* row16 = reinterpret_cast<uint16_t*>(row);
        size_t n = size_t(info.width) * info.spp;
        for (size_t i = info.spp; i < n; i++)
          row16[i] = uint16_t(row16[i] + row16[i - info.spp]);
      }
    }
  }
  return 0;
}
