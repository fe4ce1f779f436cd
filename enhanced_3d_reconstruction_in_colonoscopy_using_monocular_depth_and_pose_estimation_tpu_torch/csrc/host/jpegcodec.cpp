// Baseline JPEG (ITU-T T.81 sequential DCT, 8-bit) decoder + encoder.
//
// The port's copy of the JAX package's media/native/jpegcodec.cpp, built
// by the port's utils/cbuild.py with the same flags, so decoded pixels and
// encoded bytes are the same. The reference shells frame extraction and
// AVI re-encode out to OpenCV (its video_to_images.py and
// data_processing/convert_avi_to_mp4.py); here the MJPEG payloads inside
// AVI/MP4 containers are decoded/encoded natively. Other codecs are
// refused by the port's media/video.py.
//
// Scope: baseline sequential (SOF0/SOF1), 1 or 3 components, sampling
// factors 1..2, restart markers, missing-DHT MJPEG streams (Annex K default
// tables). Progressive/arithmetic/12-bit return an error. Encoder emits
// JFIF 4:2:0 (3ch) or grayscale with Annex K tables.
//
// C ABI only (ctypes-loaded; see media/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ----------------------------- shared tables --------------------------------

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1 quantisation tables (spec constants).
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 typical Huffman tables (spec constants): BITS then HUFFVAL.
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// 8x8 DCT-II basis, C[k][n] = c(k)/2 * cos((2n+1) k pi / 16).
struct DctBasis {
  float c[8][8];
  DctBasis() {
    for (int k = 0; k < 8; ++k)
      for (int n = 0; n < 8; ++n)
        c[k][n] = static_cast<float>(
            (k == 0 ? std::sqrt(0.125) : 0.5) *
            std::cos((2 * n + 1) * k * M_PI / 16.0));
  }
};
const DctBasis kDct;

// X = C^T F C  (separable inverse DCT; exact floats, vectorises fine).
void idct8x8(const float in[64], float out[64]) {
  float tmp[64];
  for (int n = 0; n < 8; ++n)        // rows of tmp = C^T * F
    for (int j = 0; j < 8; ++j) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += kDct.c[k][n] * in[k * 8 + j];
      tmp[n * 8 + j] = s;
    }
  for (int n = 0; n < 8; ++n)
    for (int m = 0; m < 8; ++m) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += tmp[n * 8 + k] * kDct.c[k][m];
      out[n * 8 + m] = s;
    }
}

// F = C X C^T (forward).
void fdct8x8(const float in[64], float out[64]) {
  float tmp[64];
  for (int k = 0; k < 8; ++k)
    for (int j = 0; j < 8; ++j) {
      float s = 0.f;
      for (int n = 0; n < 8; ++n) s += kDct.c[k][n] * in[n * 8 + j];
      tmp[k * 8 + j] = s;
    }
  for (int k = 0; k < 8; ++k)
    for (int l = 0; l < 8; ++l) {
      float s = 0.f;
      for (int n = 0; n < 8; ++n) s += tmp[k * 8 + n] * kDct.c[l][n];
      out[k * 8 + l] = s;
    }
}

inline uint8_t clamp_u8(float v) {
  int i = static_cast<int>(v + 0.5f);
  return static_cast<uint8_t>(i < 0 ? 0 : (i > 255 ? 255 : i));
}

// ------------------------------- decoder ------------------------------------

// Canonical Huffman decode table with an 8-bit fast lookup front end.
struct HuffTable {
  uint8_t fast_sym[256];   // symbol when code length <= 8
  uint8_t fast_len[256];   // 0 = not in fast table
  int32_t maxcode[17];     // largest code of each length (-1 if none)
  int32_t valptr[17];      // index of first symbol of each length
  int32_t mincode[17];
  uint8_t vals[256];
  bool present = false;

  void build(const uint8_t bits[17], const uint8_t* huffval) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l];
    std::memcpy(vals, huffval, total);
    std::memset(fast_len, 0, sizeof fast_len);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= 8) {
          int shift = 8 - l;
          for (int f = 0; f < (1 << shift); ++f) {
            fast_sym[(code << shift) | f] = huffval[k];
            fast_len[(code << shift) | f] = static_cast<uint8_t>(l);
          }
        }
      }
      maxcode[l] = code - 1;
      code <<= 1;
    }
    for (int l = 1; l <= 16; ++l)
      if (bits[l] == 0) maxcode[l] = -1;
    present = true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  void refill() {
    while (nbits <= 24) {
      if (p >= end || hit_marker) {
        acc |= 0;  // feed zeros past the end (spec-permitted padding)
        nbits += 8;
        continue;
      }
      uint8_t b = *p;
      if (b == 0xFF) {
        if (p + 1 < end && p[1] == 0x00) {
          p += 2;
        } else {
          hit_marker = true;  // a real marker terminates entropy data
          nbits += 8;
          continue;
        }
      } else {
        ++p;
      }
      acc |= static_cast<uint32_t>(b) << (24 - nbits);
      nbits += 8;
    }
  }
  int peek8() {
    if (nbits < 8) refill();
    return (acc >> 24) & 0xFF;
  }
  void consume(int n) {
    acc <<= n;
    nbits -= n;
  }
  int get_bits(int n) {  // receive n bits MSB-first
    if (n == 0) return 0;
    if (nbits < n) refill();
    int v = static_cast<int>(acc >> (32 - n));
    consume(n);
    return v;
  }
  // Re-align to a byte boundary and step past an RSTn marker.
  bool sync_restart() {
    acc = 0;
    nbits = 0;
    hit_marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        return true;
      }
      ++p;
    }
    return false;
  }
};

int decode_huff(BitReader& br, const HuffTable& t) {
  int look = br.peek8();
  if (t.fast_len[look]) {
    br.consume(t.fast_len[look]);
    return t.fast_sym[look];
  }
  int code = 0;
  for (int l = 1; l <= 16; ++l) {
    code = (code << 1) | br.get_bits(1);
    if (t.maxcode[l] >= 0 && code <= t.maxcode[l])
      return t.vals[t.valptr[l] + code - t.mincode[l]];
  }
  return -1;
}

inline int extend_receive(BitReader& br, int size) {
  if (size == 0) return 0;
  int v = br.get_bits(size);
  if (v < (1 << (size - 1))) v += -(1 << size) + 1;
  return v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int plane_w = 0, plane_h = 0;  // padded to MCU multiples
  std::vector<uint8_t> plane;
  int dc_pred = 0;
};

struct Decoder {
  const uint8_t* buf;
  long len;
  int width = 0, height = 0, ncomp = 0;
  Component comp[3];
  uint16_t qtab[4][64] = {};
  HuffTable dc_tab[4], ac_tab[4];
  int restart_interval = 0;
  int hmax = 1, vmax = 1;

  int parse_headers(long* sos_off) {
    long i = 0;
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -1;  // SOI
    i = 2;
    while (i + 4 <= len) {
      if (buf[i] != 0xFF) return -2;
      int marker = buf[i + 1];
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) {
        i += 2;
        continue;
      }
      if (marker == 0xD9) return -3;  // EOI before SOS
      int seglen = (buf[i + 2] << 8) | buf[i + 3];
      const uint8_t* seg = buf + i + 4;
      long segend = i + 2 + seglen;
      if (seglen < 2 || segend > len) return -4;
      switch (marker) {
        case 0xC0:
        case 0xC1: {  // SOF0 / SOF1 (both baseline-decodable)
          if (seglen < 8) return -4;
          if (seg[0] != 8) return -5;  // 12-bit unsupported
          height = (seg[1] << 8) | seg[2];
          width = (seg[3] << 8) | seg[4];
          ncomp = seg[5];
          if (width < 1 || height < 1) return -5;
          if (ncomp != 1 && ncomp != 3) return -6;
          if (seglen < 8 + 3 * ncomp) return -4;
          for (int c = 0; c < ncomp; ++c) {
            comp[c].id = seg[6 + 3 * c];
            comp[c].h = seg[7 + 3 * c] >> 4;
            comp[c].v = seg[7 + 3 * c] & 15;
            comp[c].tq = seg[8 + 3 * c];
            if (comp[c].h < 1 || comp[c].h > 2 || comp[c].v < 1 ||
                comp[c].v > 2)
              return -7;
            if (comp[c].tq > 3) return -7;
            hmax = comp[c].h > hmax ? comp[c].h : hmax;
            vmax = comp[c].v > vmax ? comp[c].v : vmax;
          }
          break;
        }
        case 0xC2:
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return -8;  // progressive / lossless / arithmetic: unsupported
        case 0xC4: {  // DHT
          const uint8_t* q = seg;
          const uint8_t* qend = buf + segend;
          while (q < qend) {
            if (q + 17 > qend) return -10;
            int tc = q[0] >> 4, th = q[0] & 15;
            if (th > 3 || tc > 1) return -9;
            uint8_t bits[17] = {0};
            int total = 0;
            for (int l = 1; l <= 16; ++l) {
              bits[l] = q[l];
              total += bits[l];
            }
            if (total > 256 || q + 17 + total > qend) return -10;
            (tc == 0 ? dc_tab[th] : ac_tab[th]).build(bits, q + 17);
            q += 17 + total;
          }
          break;
        }
        case 0xDB: {  // DQT
          const uint8_t* q = seg;
          const uint8_t* qend = buf + segend;
          while (q < qend) {
            int pq = q[0] >> 4, tq = q[0] & 15;
            if (tq > 3) return -11;
            ++q;
            if (q + (pq ? 128 : 64) > qend) return -11;
            for (int k = 0; k < 64; ++k) {
              qtab[tq][k] =
                  pq ? static_cast<uint16_t>((q[0] << 8) | q[1]) : *q;
              q += pq ? 2 : 1;
            }
          }
          break;
        }
        case 0xDD:  // DRI
          if (seglen < 4) return -4;
          restart_interval = (seg[0] << 8) | seg[1];
          break;
        case 0xDA: {  // SOS
          if (seglen < 3) return -4;
          int ns = seg[0];
          if (ns != ncomp) return -12;
          if (seglen < 3 + 2 * ns) return -4;
          for (int s = 0; s < ns; ++s) {
            int cs = seg[1 + 2 * s];
            int found = -1;
            for (int c = 0; c < ncomp; ++c)
              if (comp[c].id == cs) found = c;
            if (found < 0) return -13;
            comp[found].td = seg[2 + 2 * s] >> 4;
            comp[found].ta = seg[2 + 2 * s] & 15;
            if (comp[found].td > 3 || comp[found].ta > 3) return -13;
          }
          *sos_off = segend;
          return 0;
        }
        default:
          break;  // APPn / COM / others: skip
      }
      i = segend;
    }
    return -14;
  }

  int decode_block(BitReader& br, Component& c, uint8_t* dst, int stride) {
    const HuffTable& dt = dc_tab[c.td];
    const HuffTable& at = ac_tab[c.ta];
    const uint16_t* q = qtab[c.tq];
    float coef[64] = {0};
    int s = decode_huff(br, dt);
    if (s < 0 || s > 15) return -1;
    c.dc_pred += extend_receive(br, s);
    coef[0] = static_cast<float>(c.dc_pred * q[0]);
    for (int k = 1; k < 64;) {
      int rs = decode_huff(br, at);
      if (rs < 0) return -1;
      int r = rs >> 4, sz = rs & 15;
      if (sz == 0) {
        if (r == 15) {
          k += 16;
          continue;
        }
        break;  // EOB
      }
      k += r;
      if (k > 63) return -1;
      coef[kZigzag[k]] = static_cast<float>(extend_receive(br, sz) * q[k]);
      ++k;
    }
    float px[64];
    idct8x8(coef, px);
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        dst[y * stride + x] = clamp_u8(px[y * 8 + x] + 128.f);
    return 0;
  }

  int decode_scan(long sos_off) {
    // Default MJPEG tables (Annex K) if the stream carries no DHT.
    if (!dc_tab[0].present) dc_tab[0].build(kDcLumaBits, kDcLumaVals);
    if (!ac_tab[0].present) ac_tab[0].build(kAcLumaBits, kAcLumaVals);
    if (ncomp == 3) {
      if (!dc_tab[1].present) dc_tab[1].build(kDcChromaBits, kDcChromaVals);
      if (!ac_tab[1].present) ac_tab[1].build(kAcChromaBits, kAcChromaVals);
    }
    for (int c = 0; c < ncomp; ++c)
      if (!dc_tab[comp[c].td].present || !ac_tab[comp[c].ta].present)
        return -15;  // scan references an undefined Huffman table
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      comp[c].plane_w = mcux * 8 * comp[c].h;
      comp[c].plane_h = mcuy * 8 * comp[c].v;
      comp[c].plane.assign(
          static_cast<size_t>(comp[c].plane_w) * comp[c].plane_h, 0);
      comp[c].dc_pred = 0;
    }
    BitReader br{buf + sos_off, buf + len};
    int mcu_count = 0;
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && mcu_count == restart_interval) {
          if (!br.sync_restart()) return -20;
          for (int c = 0; c < ncomp; ++c) comp[c].dc_pred = 0;
          mcu_count = 0;
        }
        for (int c = 0; c < ncomp; ++c)
          for (int by = 0; by < comp[c].v; ++by)
            for (int bx = 0; bx < comp[c].h; ++bx) {
              int px = (mx * comp[c].h + bx) * 8;
              int py = (my * comp[c].v + by) * 8;
              uint8_t* dst =
                  comp[c].plane.data() +
                  static_cast<size_t>(py) * comp[c].plane_w + px;
              if (decode_block(br, comp[c], dst, comp[c].plane_w)) return -21;
            }
        ++mcu_count;
      }
    return 0;
  }

  // Centered bilinear upsample of one chroma row to full width — for
  // factor 2 this is exactly libjpeg's "fancy" (triangular 3:1) filter,
  // which keeps decode output within ~1 LSB of libjpeg/cv2.
  void upsample_row(const Component& c, int r, float* dst) const {
    int sx = hmax / c.h, sy = vmax / c.v;
    int cw = (width + sx - 1) / sx;
    int ch = (height + sy - 1) / sy;
    float cy = (r + 0.5f) / sy - 0.5f;
    int r0 = static_cast<int>(std::floor(cy));
    float wy = cy - r0;
    int r1 = r0 + 1;
    r0 = r0 < 0 ? 0 : (r0 >= ch ? ch - 1 : r0);
    r1 = r1 < 0 ? 0 : (r1 >= ch ? ch - 1 : r1);
    const uint8_t* row0 = c.plane.data() + static_cast<size_t>(r0) * c.plane_w;
    const uint8_t* row1 = c.plane.data() + static_cast<size_t>(r1) * c.plane_w;
    for (int x = 0; x < width; ++x) {
      float cx = (x + 0.5f) / sx - 0.5f;
      int x0 = static_cast<int>(std::floor(cx));
      float wx = cx - x0;
      int x1 = x0 + 1;
      x0 = x0 < 0 ? 0 : (x0 >= cw ? cw - 1 : x0);
      x1 = x1 < 0 ? 0 : (x1 >= cw ? cw - 1 : x1);
      float top = row0[x0] + wx * (row0[x1] - row0[x0]);
      float bot = row1[x0] + wx * (row1[x1] - row1[x0]);
      dst[x] = top + wy * (bot - top);
    }
  }

  void emit_rgb(uint8_t* out) const {
    if (ncomp == 1) {
      const Component& y = comp[0];
      for (int r = 0; r < height; ++r)
        std::memcpy(out + static_cast<size_t>(r) * width,
                    y.plane.data() + static_cast<size_t>(r) * y.plane_w,
                    width);
      return;
    }
    const Component& Y = comp[0];
    const Component& Cb = comp[1];
    const Component& Cr = comp[2];
    std::vector<float> cbline(width), crline(width);
    for (int r = 0; r < height; ++r) {
      const uint8_t* yrow = Y.plane.data() + static_cast<size_t>(r) * Y.plane_w;
      upsample_row(Cb, r, cbline.data());
      upsample_row(Cr, r, crline.data());
      uint8_t* o = out + static_cast<size_t>(r) * width * 3;
      for (int x = 0; x < width; ++x) {
        float y = yrow[x];
        float cb = cbline[x] - 128.f;
        float cr = crline[x] - 128.f;
        o[3 * x + 0] = clamp_u8(y + 1.402f * cr);
        o[3 * x + 1] = clamp_u8(y - 0.344136f * cb - 0.714136f * cr);
        o[3 * x + 2] = clamp_u8(y + 1.772f * cb);
      }
    }
  }
};

// ------------------------------- encoder ------------------------------------

struct HuffEnc {
  uint16_t code[256];
  uint8_t len[256];
  void build(const uint8_t bits[17], const uint8_t* huffval) {
    std::memset(len, 0, sizeof len);
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++c) {
        code[huffval[k]] = static_cast<uint16_t>(c);
        len[huffval[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) put(0x7F, 8 - nbits);  // pad with 1s per spec
  }
};

inline int bit_size(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const float* block, const uint16_t* q,
                  const HuffEnc& dc, const HuffEnc& ac, int& dc_pred) {
  float coef[64];
  fdct8x8(block, coef);
  int zz[64];
  for (int k = 0; k < 64; ++k) {
    float v = coef[kZigzag[k]] / q[k];
    zz[k] = static_cast<int>(v < 0 ? v - 0.5f : v + 0.5f);
  }
  int diff = zz[0] - dc_pred;
  dc_pred = zz[0];
  int s = bit_size(diff);
  bw.put(dc.code[s], dc.len[s]);
  if (s) bw.put(diff < 0 ? diff + (1 << s) - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    if (zz[k] == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.len[0xF0]);
      run -= 16;
    }
    int sz = bit_size(zz[k]);
    int rs = (run << 4) | sz;
    bw.put(ac.code[rs], ac.len[rs]);
    bw.put(zz[k] < 0 ? zz[k] + (1 << sz) - 1 : zz[k], sz);
    run = 0;
  }
  if (run) bw.put(ac.code[0x00], ac.len[0x00]);
}

void scale_qtab(const uint8_t* base, int quality, uint16_t* out_zz) {
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int k = 0; k < 64; ++k) {
    int v = (base[kZigzag[k]] * scale + 50) / 100;  // base is row-major
    out_zz[k] = static_cast<uint16_t>(v < 1 ? 1 : (v > 255 ? 255 : v));
  }
}

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void emit_dht(std::vector<uint8_t>& o, int tc, int th, const uint8_t bits[17],
              const uint8_t* vals) {
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put_u16(o, 2 + 1 + 16 + total);
  o.push_back(static_cast<uint8_t>((tc << 4) | th));
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  o.insert(o.end(), vals, vals + total);
}

}  // namespace

extern "C" {

// (w, h, ncomp) of a JPEG byte stream. Returns 0 or a negative error.
int e3d_jpeg_info(const uint8_t* buf, long len, int* w, int* h, int* ncomp) {
  Decoder d{buf, len};
  long sos = 0;
  int rc = d.parse_headers(&sos);
  if (rc) return rc;
  *w = d.width;
  *h = d.height;
  *ncomp = d.ncomp;
  return 0;
}

// Decode into out (H*W for gray, H*W*3 RGB otherwise). Returns 0 on success.
int e3d_jpeg_decode(const uint8_t* buf, long len, uint8_t* out, long out_cap) {
  Decoder d{buf, len};
  long sos = 0;
  int rc = d.parse_headers(&sos);
  if (rc) return rc;
  long need = static_cast<long>(d.width) * d.height * (d.ncomp == 1 ? 1 : 3);
  if (out_cap < need) return -30;
  rc = d.decode_scan(sos);
  if (rc) return rc;
  d.emit_rgb(out);
  return 0;
}

// Encode HxWx{1,3} 8-bit pixels (gray or RGB) as baseline JFIF. 3-channel
// input is written 4:2:0. Returns bytes written, or negative on error.
long e3d_jpeg_encode(const uint8_t* pix, int h, int w, int ch, int quality,
                     uint8_t* out, long out_cap) {
  if ((ch != 1 && ch != 3) || w <= 0 || h <= 0) return -1;
  uint16_t qy[64], qc[64];
  scale_qtab(kStdLumaQ, quality, qy);
  scale_qtab(kStdChromaQ, quality, qc);
  HuffEnc dcy, acy, dcc, acc_;
  dcy.build(kDcLumaBits, kDcLumaVals);
  acy.build(kAcLumaBits, kAcLumaVals);
  dcc.build(kDcChromaBits, kDcChromaVals);
  acc_.build(kAcChromaBits, kAcChromaVals);

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(w) * h / 2 + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);  // SOI
  // APP0 JFIF
  const uint8_t app0[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,
                          1,    1,    0, 0,  1,   0,   1,   0,   0};
  o.insert(o.end(), app0, app0 + sizeof app0);
  // DQT (zigzag order as stored)
  for (int t = 0; t < (ch == 3 ? 2 : 1); ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put_u16(o, 2 + 1 + 64);
    o.push_back(static_cast<uint8_t>(t));
    const uint16_t* q = t == 0 ? qy : qc;
    for (int k = 0; k < 64; ++k) o.push_back(static_cast<uint8_t>(q[k]));
  }
  // SOF0
  o.push_back(0xFF);
  o.push_back(0xC0);
  put_u16(o, 8 + 3 * ch);
  o.push_back(8);
  put_u16(o, h);
  put_u16(o, w);
  o.push_back(static_cast<uint8_t>(ch));
  if (ch == 1) {
    o.push_back(1);
    o.push_back(0x11);
    o.push_back(0);
  } else {
    o.push_back(1);
    o.push_back(0x22);
    o.push_back(0);  // Y 2x2, qtab 0
    o.push_back(2);
    o.push_back(0x11);
    o.push_back(1);  // Cb
    o.push_back(3);
    o.push_back(0x11);
    o.push_back(1);  // Cr
  }
  emit_dht(o, 0, 0, kDcLumaBits, kDcLumaVals);
  emit_dht(o, 1, 0, kAcLumaBits, kAcLumaVals);
  if (ch == 3) {
    emit_dht(o, 0, 1, kDcChromaBits, kDcChromaVals);
    emit_dht(o, 1, 1, kAcChromaBits, kAcChromaVals);
  }
  // SOS
  o.push_back(0xFF);
  o.push_back(0xDA);
  put_u16(o, 6 + 2 * ch);
  o.push_back(static_cast<uint8_t>(ch));
  o.push_back(1);
  o.push_back(0x00);
  if (ch == 3) {
    o.push_back(2);
    o.push_back(0x11);
    o.push_back(3);
    o.push_back(0x11);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw(o);
  auto sample = [&](int y, int x, int c) -> float {
    y = y < h ? y : h - 1;
    x = x < w ? x : w - 1;  // edge-replicate padding
    return static_cast<float>(pix[(static_cast<size_t>(y) * w + x) * ch + c]);
  };
  if (ch == 1) {
    int dc = 0;
    for (int by = 0; by < h; by += 8)
      for (int bx = 0; bx < w; bx += 8) {
        float blk[64];
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            blk[y * 8 + x] = sample(by + y, bx + x, 0) - 128.f;
        encode_block(bw, blk, qy, dcy, acy, dc);
      }
  } else {
    int dcY = 0, dcCb = 0, dcCr = 0;
    int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    std::vector<float> Y(16 * 16), Cb(8 * 8), Cr(8 * 8);
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        int oy = my * 16, ox = mx * 16;
        for (int y = 0; y < 16; ++y)
          for (int x = 0; x < 16; ++x) {
            float r = sample(oy + y, ox + x, 0);
            float g = sample(oy + y, ox + x, 1);
            float b = sample(oy + y, ox + x, 2);
            Y[y * 16 + x] = 0.299f * r + 0.587f * g + 0.114f * b - 128.f;
          }
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) {
            float r = 0, g = 0, b = 0;
            for (int dy = 0; dy < 2; ++dy)
              for (int dx = 0; dx < 2; ++dx) {
                r += sample(oy + 2 * y + dy, ox + 2 * x + dx, 0);
                g += sample(oy + 2 * y + dy, ox + 2 * x + dx, 1);
                b += sample(oy + 2 * y + dy, ox + 2 * x + dx, 2);
              }
            r *= 0.25f;
            g *= 0.25f;
            b *= 0.25f;
            Cb[y * 8 + x] = -0.168736f * r - 0.331264f * g + 0.5f * b;
            Cr[y * 8 + x] = 0.5f * r - 0.418688f * g - 0.081312f * b;
          }
        float blk[64];
        for (int by = 0; by < 2; ++by)
          for (int bx = 0; bx < 2; ++bx) {
            for (int y = 0; y < 8; ++y)
              for (int x = 0; x < 8; ++x)
                blk[y * 8 + x] = Y[(by * 8 + y) * 16 + bx * 8 + x];
            encode_block(bw, blk, qy, dcy, acy, dcY);
          }
        encode_block(bw, Cb.data(), qc, dcc, acc_, dcCb);
        encode_block(bw, Cr.data(), qc, dcc, acc_, dcCr);
      }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);  // EOI
  if (static_cast<long>(o.size()) > out_cap) return -2;
  std::memcpy(out, o.data(), o.size());
  return static_cast<long>(o.size());
}

}  // extern "C"
