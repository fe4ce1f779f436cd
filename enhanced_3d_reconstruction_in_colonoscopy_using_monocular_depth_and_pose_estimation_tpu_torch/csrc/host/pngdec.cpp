// Native PNG decoder + threaded batch loader.
//
// The port's copy of the JAX package's data/native/pngdec.cpp, built by the
// port's utils/cbuild.py with the same flags and linked with zlib. The
// reference decodes images with PIL in its CPU workers (its
// data_processing/simcol.py). Decodes non-interlaced 8-bit RGB/RGBA/gray
// and 16-bit gray/RGB PNGs (the SimCol FrameBuffer_*.png and Depth_*.png
// formats) straight into caller-provided contiguous batch buffers, with a
// thread pool for file IO + inflate. Only external dependency: zlib.
//
// C ABI for ctypes (see data/native.py).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PngImage {
  uint32_t width = 0, height = 0;
  int bit_depth = 0;
  int channels = 0;  // after decode (palette unsupported)
  std::vector<uint8_t> pixels;  // big-endian 16-bit as in PNG
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int channels_for_color_type(int ct) {
  switch (ct) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
    default: return 0; // palette unsupported
  }
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

bool decode_png(const uint8_t* data, size_t len, PngImage* out) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || std::memcmp(data, kSig, 8) != 0) return false;
  size_t pos = 8;
  std::vector<uint8_t> idat;
  int color_type = -1, interlace = -1;
  while (pos + 8 <= len) {
    uint32_t chunk_len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + chunk_len > len) return false;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      out->width = be32(body);
      out->height = be32(body + 4);
      out->bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
      out->channels = channels_for_color_type(color_type);
      if (out->channels == 0 || interlace != 0) return false;
      if (out->bit_depth != 8 && out->bit_depth != 16) return false;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + chunk_len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + chunk_len;
  }
  if (idat.empty() || out->width == 0 || out->height == 0) return false;

  const int bpp = out->channels * out->bit_depth / 8;  // bytes per pixel
  const size_t stride = size_t(out->width) * bpp;
  std::vector<uint8_t> raw((stride + 1) * out->height);
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END && rc != Z_OK) return false;

  out->pixels.resize(stride * out->height);
  const uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < out->height; ++y) {
    const uint8_t* src = raw.data() + y * (stride + 1);
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = out->pixels.data() + y * stride;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (i >= size_t(bpp) ? dst[i - bpp] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int left = i >= size_t(bpp) ? dst[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          dst[i] = uint8_t(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int left = i >= size_t(bpp) ? dst[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          int ul = (prev && i >= size_t(bpp)) ? prev[i - bpp] : 0;
          dst[i] = uint8_t(src[i] + paeth(left, up, ul));
        }
        break;
      default:
        return false;
    }
    prev = dst;
  }
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(size_t(size));
  size_t got = std::fread(out->data(), 1, size_t(size), f);
  std::fclose(f);
  return got == size_t(size);
}

}  // namespace

extern "C" {

// Probe dimensions: returns 0 on success.
int e3d_png_info(const char* path, int* width, int* height, int* channels,
                 int* bit_depth) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data) || data.size() < 33) return 1;
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (std::memcmp(data.data(), kSig, 8) != 0) return 1;
  *width = int(be32(data.data() + 16));
  *height = int(be32(data.data() + 20));
  *bit_depth = data[24];
  *channels = channels_for_color_type(data[25]);
  return *channels == 0 ? 1 : 0;
}

// Decode `n` same-shape PNGs into a contiguous (n, H, W, C) buffer.
// For bit_depth 16 the output is uint16 native-endian; for 8, uint8.
// Returns the number of failures (0 == all good).
int e3d_png_decode_batch(const char** paths, int n, int height, int width,
                         int channels, int bit_depth, void* out,
                         int num_threads) {
  const size_t px_bytes = size_t(bit_depth / 8);
  const size_t img_elems = size_t(height) * width * channels;
  std::atomic<int> failures{0};
  std::atomic<int> next{0};

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      std::vector<uint8_t> data;
      PngImage img;
      if (!read_file(paths[i], &data) || !decode_png(data.data(),
                                                     data.size(), &img) ||
          int(img.width) != width || int(img.height) != height ||
          img.channels != channels || img.bit_depth != bit_depth) {
        failures.fetch_add(1);
        continue;
      }
      if (bit_depth == 8) {
        std::memcpy(static_cast<uint8_t*>(out) + i * img_elems,
                    img.pixels.data(), img_elems);
      } else {
        // PNG 16-bit is big-endian; output native little-endian uint16.
        uint16_t* dst = static_cast<uint16_t*>(out) + i * img_elems;
        const uint8_t* src = img.pixels.data();
        for (size_t e = 0; e < img_elems; ++e)
          dst[e] = uint16_t((src[2 * e] << 8) | src[2 * e + 1]);
      }
      (void)px_bytes;
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failures.load();
}

}  // extern "C"
