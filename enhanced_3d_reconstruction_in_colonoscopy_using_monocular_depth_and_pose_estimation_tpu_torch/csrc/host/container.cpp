// Native video containers: AVI (RIFF) demux/mux and MP4 (ISO BMFF)
// demux/mux for MJPEG streams.
//
// The port's copy of the JAX package's media/native/container.cpp, built
// by the port's utils/cbuild.py. It replaces the cv2.VideoCapture /
// cv2.VideoWriter container path of the reference (its video_to_images.py
// and data_processing/convert_avi_to_mp4.py) for MJPEG payloads: frames
// are stored JPEG chunks, so AVI -> MP4 becomes a lossless remux (no
// transcode) and frame extraction without crop is a byte copy. Non-MJPEG
// codecs are detected (fourcc/sample-entry) and reported, and the port's
// media/video.py refuses them by name.
//
// Readers index (offset, size) per frame with seeks only — multi-GB files
// are never loaded into memory.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

uint32_t rd_u32le(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint32_t rd_u32be(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}
uint64_t rd_u64be(const uint8_t* p) {
  return (uint64_t(rd_u32be(p)) << 32) | rd_u32be(p + 4);
}

struct Reader {
  FILE* f = nullptr;
  std::vector<uint64_t> offs;
  std::vector<uint32_t> sizes;
  int width = 0, height = 0;
  uint32_t fps_num = 30, fps_den = 1;
  char fourcc[5] = {0};
  bool is_mjpeg = false;
};

// ------------------------------ AVI demux -----------------------------------

bool read_at(FILE* f, uint64_t off, void* dst, size_t n) {
  if (fseeko(f, static_cast<off_t>(off), SEEK_SET)) return false;
  return fread(dst, 1, n, f) == n;
}

// Walk chunks in [pos, end); collect stream-0 video data chunks and headers.
bool avi_walk(Reader* r, uint64_t pos, uint64_t end, int depth) {
  uint8_t hdr[12];
  while (pos + 8 <= end) {
    if (!read_at(r->f, pos, hdr, 8)) return false;
    uint32_t sz = rd_u32le(hdr + 4);
    if (!std::memcmp(hdr, "LIST", 4) || !std::memcmp(hdr, "RIFF", 4)) {
      if (!read_at(r->f, pos + 8, hdr + 8, 4)) return false;
      uint64_t body = pos + 12, bend = pos + 8 + sz;
      if (bend > end) bend = end;
      // Descend into hdrl/strl/movi/rec /AVI lists only.
      if (!std::memcmp(hdr + 8, "hdrl", 4) ||
          !std::memcmp(hdr + 8, "strl", 4) ||
          !std::memcmp(hdr + 8, "movi", 4) ||
          !std::memcmp(hdr + 8, "rec ", 4) ||
          !std::memcmp(hdr + 8, "AVI ", 4)) {
        if (depth < 8 && !avi_walk(r, body, bend, depth + 1)) return false;
      }
    } else if (!std::memcmp(hdr, "avih", 4)) {
      uint8_t b[40];
      if (sz >= 40 && read_at(r->f, pos + 8, b, 40)) {
        r->width = static_cast<int>(rd_u32le(b + 32));
        r->height = static_cast<int>(rd_u32le(b + 36));
        uint32_t usec = rd_u32le(b);
        if (usec) {
          r->fps_num = 1000000;
          r->fps_den = usec;
        }
      }
    } else if (!std::memcmp(hdr, "strh", 4)) {
      uint8_t b[40];
      if (sz >= 40 && read_at(r->f, pos + 8, b, 40)) {
        if (!std::memcmp(b, "vids", 4)) {
          std::memcpy(r->fourcc, b + 4, 4);
          uint32_t scale = rd_u32le(b + 20), rate = rd_u32le(b + 24);
          if (scale && rate) {
            r->fps_num = rate;
            r->fps_den = scale;
          }
        }
      }
    } else if ((hdr[0] == '0' && hdr[1] == '0' &&
                ((hdr[2] == 'd' && (hdr[3] == 'c' || hdr[3] == 'b')) ||
                 (hdr[2] == 'w' && hdr[3] == 'b')))) {
      if (hdr[2] == 'd' && sz > 0) {  // 00dc / 00db: stream-0 video frame
        r->offs.push_back(pos + 8);
        r->sizes.push_back(sz);
      }
    }
    pos += 8 + sz + (sz & 1);  // chunks are word-aligned
  }
  return true;
}

int open_avi(Reader* r) {
  uint8_t hdr[12];
  if (!read_at(r->f, 0, hdr, 12)) return -2;
  if (std::memcmp(hdr, "RIFF", 4) || std::memcmp(hdr + 8, "AVI ", 4))
    return -3;
  uint64_t fsz = 0;
  if (fseeko(r->f, 0, SEEK_END) == 0)
    fsz = static_cast<uint64_t>(ftello(r->f));
  // Walk every top-level RIFF chunk: the first is "AVI ", files beyond
  // the 32-bit RIFF limit append OpenDML "RIFF AVIX" extension chunks
  // (long recordings — ffmpeg/cv2 write these past ~1 GB).
  uint64_t pos = 0;
  bool first = true;
  while (pos + 12 <= fsz && read_at(r->f, pos, hdr, 12) &&
         !std::memcmp(hdr, "RIFF", 4) &&
         (first ? !std::memcmp(hdr + 8, "AVI ", 4)
                : !std::memcmp(hdr + 8, "AVIX", 4))) {
    uint64_t end = pos + 8 + rd_u32le(hdr + 4);
    if (end > fsz) end = fsz;  // tolerate truncated size fields
    if (!avi_walk(r, pos + 12, end, 0)) return -4;
    first = false;
    pos = end + (end & 1);
  }
  char fc[5];
  for (int i = 0; i < 4; ++i)
    fc[i] = static_cast<char>(
        r->fourcc[i] >= 'a' && r->fourcc[i] <= 'z' ? r->fourcc[i] - 32
                                                   : r->fourcc[i]);
  fc[4] = 0;
  r->is_mjpeg = !std::memcmp(fc, "MJPG", 4) || !std::memcmp(fc, "JPEG", 4) ||
                r->fourcc[0] == 0;  // some writers leave handler empty
  // Trust the payload over the header: JPEG frames start FF D8.
  if (!r->offs.empty()) {
    uint8_t sig[2];
    if (read_at(r->f, r->offs[0], sig, 2))
      r->is_mjpeg = sig[0] == 0xFF && sig[1] == 0xD8;
  }
  return r->offs.empty() ? -5 : 0;
}

// ------------------------------ MP4 demux -----------------------------------

struct Box {
  const uint8_t* p;
  uint64_t size;  // payload size
};

// Find first child box `name` within payload [p, p+n).
bool find_box(const uint8_t* p, uint64_t n, const char* name, Box* out) {
  uint64_t pos = 0;
  while (pos + 8 <= n) {
    uint64_t sz = rd_u32be(p + pos);
    const uint8_t* body = p + pos + 8;
    uint64_t hdr = 8;
    if (sz == 1 && pos + 16 <= n) {
      sz = rd_u64be(p + pos + 8);
      body = p + pos + 16;
      hdr = 16;
    } else if (sz == 0) {
      sz = n - pos;
    }
    if (sz < hdr || sz > n - pos) return false;  // no pos+sz overflow
    if (!std::memcmp(p + pos + 4, name, 4)) {
      out->p = body;
      out->size = sz - hdr;
      return true;
    }
    pos += sz;
  }
  return false;
}

int open_mp4(Reader* r) {
  // Scan top-level boxes for moov (load it fully — it is small).
  if (fseeko(r->f, 0, SEEK_END)) return -2;
  uint64_t fsz = static_cast<uint64_t>(ftello(r->f));
  uint64_t pos = 0;
  std::vector<uint8_t> moov;
  uint8_t h[16];
  while (pos + 8 <= fsz) {
    if (!read_at(r->f, pos, h, 8)) return -3;
    uint64_t sz = rd_u32be(h);
    uint64_t hdr = 8;
    if (sz == 1) {
      if (!read_at(r->f, pos + 8, h + 8, 8)) return -3;
      sz = rd_u64be(h + 8);
      hdr = 16;
    } else if (sz == 0) {
      sz = fsz - pos;
    }
    if (sz < hdr || sz > fsz - pos) return -3;  // also blocks pos overflow
    if (!std::memcmp(h + 4, "moov", 4)) {
      moov.resize(sz - hdr);  // bounded by fsz via the check above
      if (!read_at(r->f, pos + hdr, moov.data(), moov.size())) return -3;
      break;
    }
    pos += sz;
  }
  if (moov.empty()) return -4;

  // moov -> (each) trak -> mdia -> minf -> stbl with a video sample entry.
  uint64_t tpos = 0;
  while (tpos + 8 <= moov.size()) {
    uint64_t sz = rd_u32be(moov.data() + tpos);
    if (sz < 8 || tpos + sz > moov.size()) break;
    if (!std::memcmp(moov.data() + tpos + 4, "trak", 4)) {
      const uint8_t* trak = moov.data() + tpos + 8;
      uint64_t trak_n = sz - 8;
      Box mdia, minf, stbl, mdhd, stsd, hdlr;
      if (find_box(trak, trak_n, "mdia", &mdia) &&
          find_box(mdia.p, mdia.size, "hdlr", &hdlr) &&
          hdlr.size >= 12 && !std::memcmp(hdlr.p + 8, "vide", 4) &&
          find_box(mdia.p, mdia.size, "minf", &minf) &&
          find_box(minf.p, minf.size, "stbl", &stbl) &&
          find_box(stbl.p, stbl.size, "stsd", &stsd) && stsd.size >= 16) {
        std::memcpy(r->fourcc, stsd.p + 12, 4);
        r->fourcc[4] = 0;
        r->is_mjpeg = !std::memcmp(r->fourcc, "jpeg", 4) ||
                      !std::memcmp(r->fourcc, "mjpa", 4);
        if (stsd.size >= 16 + 78) {  // VisualSampleEntry width/height
          r->width = (stsd.p[16 + 24] << 8) | stsd.p[16 + 25];
          r->height = (stsd.p[16 + 26] << 8) | stsd.p[16 + 27];
        }
        // Timing: mdhd timescale + stts average delta.
        if (find_box(mdia.p, mdia.size, "mdhd", &mdhd) && mdhd.size >= 20) {
          uint32_t timescale = (mdhd.p[0] == 1 && mdhd.size >= 24)
                                   ? rd_u32be(mdhd.p + 20)
                                   : rd_u32be(mdhd.p + 12);
          Box stts;
          if (timescale && find_box(stbl.p, stbl.size, "stts", &stts) &&
              stts.size >= 16) {
            uint32_t delta = rd_u32be(stts.p + 12);
            if (delta) {
              r->fps_num = timescale;
              r->fps_den = delta;
            }
          }
        }
        // Sample sizes.
        Box stsz, stsc, stco;
        bool co64 = false;
        if (!find_box(stbl.p, stbl.size, "stsz", &stsz) || stsz.size < 12)
          return -6;
        uint32_t fixed = rd_u32be(stsz.p + 4);
        uint32_t nsamp = rd_u32be(stsz.p + 8);
        // Bound every table count by its box payload (fuzzed counts must
        // not drive OOB reads or allocation bombs).
        if (nsamp > (1u << 28)) return -6;
        if (!fixed && stsz.size < 12ull + 4ull * nsamp) return -6;
        r->sizes.resize(nsamp);
        for (uint32_t i = 0; i < nsamp; ++i)
          r->sizes[i] = fixed ? fixed : rd_u32be(stsz.p + 12 + 4 * i);
        // Chunk offsets.
        if (!find_box(stbl.p, stbl.size, "stco", &stco)) {
          if (!find_box(stbl.p, stbl.size, "co64", &stco)) return -7;
          co64 = true;
        }
        if (stco.size < 8) return -7;
        uint32_t nchunk = rd_u32be(stco.p + 4);
        if (stco.size < 8ull + (co64 ? 8ull : 4ull) * nchunk) return -7;
        std::vector<uint64_t> chunk_off(nchunk);
        for (uint32_t i = 0; i < nchunk; ++i)
          chunk_off[i] = co64 ? rd_u64be(stco.p + 8 + 8 * i)
                              : rd_u32be(stco.p + 8 + 4 * i);
        // stsc runs -> samples per chunk.
        if (!find_box(stbl.p, stbl.size, "stsc", &stsc)) return -8;
        if (stsc.size < 8) return -8;
        uint32_t nrun = rd_u32be(stsc.p + 4);
        if (stsc.size < 8ull + 12ull * nrun) return -8;
        r->offs.clear();
        uint32_t s = 0;
        for (uint32_t run = 0; run < nrun && s < nsamp; ++run) {
          uint32_t first = rd_u32be(stsc.p + 8 + 12 * run);
          uint32_t spc = rd_u32be(stsc.p + 8 + 12 * run + 4);
          uint32_t next_first = run + 1 < nrun
                                    ? rd_u32be(stsc.p + 8 + 12 * (run + 1))
                                    : nchunk + 1;
          for (uint32_t c = first; c < next_first && s < nsamp; ++c) {
            if (c - 1 >= nchunk) break;
            uint64_t off = chunk_off[c - 1];
            for (uint32_t k = 0; k < spc && s < nsamp; ++k, ++s) {
              r->offs.push_back(off);
              off += r->sizes[s];
            }
          }
        }
        return r->offs.empty() ? -9 : 0;
      }
    }
    tpos += sz;
  }
  return -5;
}

// ------------------------------- writers ------------------------------------

struct AviWriter {
  FILE* f = nullptr;
  int w = 0, h = 0;
  uint32_t fps_num = 30, fps_den = 1;
  std::vector<uint32_t> sizes;
  std::vector<uint64_t> offs;  // absolute offset of each 00dc header
  uint64_t movi_start = 0;
};

void wr_u32le(FILE* f, uint32_t v) {
  uint8_t b[4] = {uint8_t(v), uint8_t(v >> 8), uint8_t(v >> 16),
                  uint8_t(v >> 24)};
  fwrite(b, 1, 4, f);
}
void wr_u16le(FILE* f, uint32_t v) {
  uint8_t b[2] = {uint8_t(v), uint8_t(v >> 8)};
  fwrite(b, 1, 2, f);
}

// Header layout is fixed-size, so placeholder fields are patched on close.
void avi_write_headers(AviWriter* a, uint32_t nframes, uint32_t max_size,
                       uint32_t movi_size) {
  FILE* f = a->f;
  fseeko(f, 0, SEEK_SET);
  // "AVI " + LIST hdrl (incl. 8-byte header) + LIST movi (movi_size
  // already counts the 'movi' fourcc) + idx1 chunk.
  uint64_t riff_size = 4 + (8 + 4 + 8 + 56 + 8 + 4 + 8 + 56 + 8 + 40) + 8 +
                       movi_size + 8 + 16 * nframes;
  fwrite("RIFF", 1, 4, f);
  wr_u32le(f, static_cast<uint32_t>(riff_size));
  fwrite("AVI ", 1, 4, f);
  // LIST hdrl
  fwrite("LIST", 1, 4, f);
  wr_u32le(f, 4 + 8 + 56 + 8 + 4 + 8 + 56 + 8 + 40);
  fwrite("hdrl", 1, 4, f);
  // avih (56 bytes)
  fwrite("avih", 1, 4, f);
  wr_u32le(f, 56);
  wr_u32le(f, static_cast<uint32_t>(1000000ull * a->fps_den / a->fps_num));
  wr_u32le(f, 0);                 // max bytes/s
  wr_u32le(f, 0);                 // padding
  wr_u32le(f, 0x10 | 0x100);      // HASINDEX | ISINTERLEAVED
  wr_u32le(f, nframes);
  wr_u32le(f, 0);  // initial frames
  wr_u32le(f, 1);  // streams
  wr_u32le(f, max_size);
  wr_u32le(f, static_cast<uint32_t>(a->w));
  wr_u32le(f, static_cast<uint32_t>(a->h));
  for (int i = 0; i < 4; ++i) wr_u32le(f, 0);
  // LIST strl
  fwrite("LIST", 1, 4, f);
  wr_u32le(f, 4 + 8 + 56 + 8 + 40);
  fwrite("strl", 1, 4, f);
  // strh (56)
  fwrite("strh", 1, 4, f);
  wr_u32le(f, 56);
  fwrite("vids", 1, 4, f);
  fwrite("MJPG", 1, 4, f);
  wr_u32le(f, 0);  // flags
  wr_u16le(f, 0);  // priority
  wr_u16le(f, 0);  // language
  wr_u32le(f, 0);  // initial frames
  wr_u32le(f, a->fps_den);   // scale
  wr_u32le(f, a->fps_num);   // rate
  wr_u32le(f, 0);            // start
  wr_u32le(f, nframes);      // length
  wr_u32le(f, max_size);     // suggested buffer
  wr_u32le(f, 0xFFFFFFFFu);  // quality
  wr_u32le(f, 0);            // sample size
  wr_u16le(f, 0);
  wr_u16le(f, 0);
  wr_u16le(f, static_cast<uint32_t>(a->w));
  wr_u16le(f, static_cast<uint32_t>(a->h));
  // strf: BITMAPINFOHEADER (40)
  fwrite("strf", 1, 4, f);
  wr_u32le(f, 40);
  wr_u32le(f, 40);
  wr_u32le(f, static_cast<uint32_t>(a->w));
  wr_u32le(f, static_cast<uint32_t>(a->h));
  wr_u16le(f, 1);
  wr_u16le(f, 24);
  fwrite("MJPG", 1, 4, f);
  wr_u32le(f, static_cast<uint32_t>(a->w * a->h * 3));
  wr_u32le(f, 0);
  wr_u32le(f, 0);
  wr_u32le(f, 0);
  wr_u32le(f, 0);
  // LIST movi
  fwrite("LIST", 1, 4, f);
  wr_u32le(f, movi_size);
  fwrite("movi", 1, 4, f);
}

struct Mp4Writer {
  FILE* f = nullptr;
  int w = 0, h = 0;
  uint32_t fps_num = 30, fps_den = 1;
  std::vector<uint32_t> sizes;
  std::vector<uint64_t> offs;
  uint64_t mdat_size_pos = 0;
};

void wr_u32be(FILE* f, uint32_t v) {
  uint8_t b[4] = {uint8_t(v >> 24), uint8_t(v >> 16), uint8_t(v >> 8),
                  uint8_t(v)};
  fwrite(b, 1, 4, f);
}
void wr_u16be(FILE* f, uint32_t v) {
  uint8_t b[2] = {uint8_t(v >> 8), uint8_t(v)};
  fwrite(b, 1, 2, f);
}

// An in-memory ISO box writer for moov (small, simplest to assemble).
struct BoxBuf {
  std::vector<uint8_t> d;
  void u8(uint32_t v) { d.push_back(static_cast<uint8_t>(v)); }
  void u16(uint32_t v) {
    u8(v >> 8);
    u8(v);
  }
  void u32(uint32_t v) {
    u16(v >> 16);
    u16(v);
  }
  void u64(uint64_t v) {
    u32(static_cast<uint32_t>(v >> 32));
    u32(static_cast<uint32_t>(v));
  }
  void tag(const char* t) { d.insert(d.end(), t, t + 4); }
  void raw(const void* p, size_t n) {
    const uint8_t* q = static_cast<const uint8_t*>(p);
    d.insert(d.end(), q, q + n);
  }
  size_t begin(const char* t) {
    size_t at = d.size();
    u32(0);
    tag(t);
    return at;
  }
  void end(size_t at) {
    uint32_t sz = static_cast<uint32_t>(d.size() - at);
    d[at] = sz >> 24;
    d[at + 1] = sz >> 16;
    d[at + 2] = sz >> 8;
    d[at + 3] = sz;
  }
};

}  // namespace

extern "C" {

// ------------------------------ reader ABI ----------------------------------

// Open an AVI or MP4. Returns a handle or nullptr.
void* e3d_video_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t sig[12];
  if (fread(sig, 1, 12, f) != 12) {
    fclose(f);
    return nullptr;
  }
  Reader* r = new Reader;
  r->f = f;
  int rc;
  if (!std::memcmp(sig, "RIFF", 4))
    rc = open_avi(r);
  else if (!std::memcmp(sig + 4, "ftyp", 4) || !std::memcmp(sig + 4, "moov", 4))
    rc = open_mp4(r);
  else
    rc = -1;
  if (rc) {
    fclose(f);
    delete r;
    return nullptr;
  }
  return r;
}

int e3d_video_info(void* h, int* w, int* ht, int* nframes, int* fps_num,
                   int* fps_den, int* is_mjpeg, char* fourcc4) {
  Reader* r = static_cast<Reader*>(h);
  *w = r->width;
  *ht = r->height;
  *nframes = static_cast<int>(r->offs.size());
  *fps_num = static_cast<int>(r->fps_num);
  *fps_den = static_cast<int>(r->fps_den);
  *is_mjpeg = r->is_mjpeg ? 1 : 0;
  std::memcpy(fourcc4, r->fourcc, 4);
  return 0;
}

long e3d_video_frame_size(void* h, int idx) {
  Reader* r = static_cast<Reader*>(h);
  if (idx < 0 || static_cast<size_t>(idx) >= r->sizes.size()) return -1;
  return r->sizes[idx];
}

// Copy raw (JPEG) sample bytes for frame idx into buf.
int e3d_video_frame(void* h, int idx, uint8_t* buf, long cap) {
  Reader* r = static_cast<Reader*>(h);
  if (idx < 0 || static_cast<size_t>(idx) >= r->offs.size()) return -1;
  if (cap < static_cast<long>(r->sizes[idx])) return -2;
  return read_at(r->f, r->offs[idx], buf, r->sizes[idx]) ? 0 : -3;
}

void e3d_video_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (r->f) fclose(r->f);
  delete r;
}

// ---------------------------- AVI writer ABI --------------------------------

void* e3d_avi_writer_open(const char* path, int w, int h, int fps_num,
                          int fps_den) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  AviWriter* a = new AviWriter;
  a->f = f;
  a->w = w;
  a->h = h;
  a->fps_num = static_cast<uint32_t>(fps_num);
  a->fps_den = static_cast<uint32_t>(fps_den);
  avi_write_headers(a, 0, 0, 4);  // placeholders; patched on close
  a->movi_start = static_cast<uint64_t>(ftello(f));
  return a;
}

int e3d_avi_writer_frame(void* h, const uint8_t* jpeg, long len) {
  AviWriter* a = static_cast<AviWriter*>(h);
  uint64_t at = static_cast<uint64_t>(ftello(a->f));
  // This writer emits a single classic RIFF (no AVIX continuation
  // lists); refuse frames that would push the RIFF size or idx1 offsets
  // past 32 bits instead of writing a silently corrupt file.
  if (at + static_cast<uint64_t>(len) + 16ull * (a->sizes.size() + 1) + 64 >
      0xFFFFFFF0ull)
    return -2;
  a->offs.push_back(at);
  fwrite("00dc", 1, 4, a->f);
  wr_u32le(a->f, static_cast<uint32_t>(len));
  fwrite(jpeg, 1, static_cast<size_t>(len), a->f);
  if (len & 1) fputc(0, a->f);  // word alignment
  a->sizes.push_back(static_cast<uint32_t>(len));
  return ferror(a->f) ? -1 : 0;
}

int e3d_avi_writer_close(void* h) {
  AviWriter* a = static_cast<AviWriter*>(h);
  uint64_t movi_end = static_cast<uint64_t>(ftello(a->f));
  // idx1: offsets are relative to the start of the movi LIST payload - 4
  // (i.e. relative to the 'movi' tag position), per convention.
  fwrite("idx1", 1, 4, a->f);
  wr_u32le(a->f, static_cast<uint32_t>(16 * a->sizes.size()));
  uint64_t movi_tag = a->movi_start - 4;
  uint32_t maxsz = 0;
  for (size_t i = 0; i < a->sizes.size(); ++i) {
    fwrite("00dc", 1, 4, a->f);
    wr_u32le(a->f, 0x10);  // AVIIF_KEYFRAME
    wr_u32le(a->f, static_cast<uint32_t>(a->offs[i] - movi_tag));
    wr_u32le(a->f, a->sizes[i]);
    if (a->sizes[i] > maxsz) maxsz = a->sizes[i];
  }
  uint32_t movi_size = static_cast<uint32_t>(movi_end - a->movi_start + 4);
  avi_write_headers(a, static_cast<uint32_t>(a->sizes.size()), maxsz,
                    movi_size);
  int bad = ferror(a->f);
  int rc = (fclose(a->f) || bad) ? -1 : 0;
  delete a;
  return rc;
}

// ---------------------------- MP4 writer ABI --------------------------------

void* e3d_mp4_writer_open(const char* path, int w, int h, int fps_num,
                          int fps_den) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Mp4Writer* m = new Mp4Writer;
  m->f = f;
  m->w = w;
  m->h = h;
  m->fps_num = static_cast<uint32_t>(fps_num);
  m->fps_den = static_cast<uint32_t>(fps_den);
  // ftyp
  wr_u32be(f, 20);
  fwrite("ftyp", 1, 4, f);
  fwrite("isom", 1, 4, f);
  wr_u32be(f, 512);
  fwrite("isom", 1, 4, f);
  // mdat in the 64-bit form (size=1 + largesize): >4 GiB MJPEG remuxes
  // are legal input (the AVI reader handles OpenDML AVIX), so the output
  // must not wrap; the largesize is patched on close.
  m->mdat_size_pos = static_cast<uint64_t>(ftello(f));
  wr_u32be(f, 1);
  fwrite("mdat", 1, 4, f);
  wr_u32be(f, 0);  // largesize placeholder (hi)
  wr_u32be(f, 16);  // largesize placeholder (lo)
  return m;
}

int e3d_mp4_writer_frame(void* h, const uint8_t* jpeg, long len) {
  Mp4Writer* m = static_cast<Mp4Writer*>(h);
  m->offs.push_back(static_cast<uint64_t>(ftello(m->f)));
  fwrite(jpeg, 1, static_cast<size_t>(len), m->f);
  m->sizes.push_back(static_cast<uint32_t>(len));
  // fwrite failures (disk full, EIO) latch the stream error flag; report
  // them here so the muxer never records sizes for bytes never written.
  return ferror(m->f) ? -1 : 0;
}

int e3d_mp4_writer_close(void* h) {
  Mp4Writer* m = static_cast<Mp4Writer*>(h);
  FILE* f = m->f;
  uint64_t mdat_end = static_cast<uint64_t>(ftello(f));
  uint32_t n = static_cast<uint32_t>(m->sizes.size());
  uint32_t timescale = m->fps_num, delta = m->fps_den;
  uint32_t duration = n * delta;

  BoxBuf b;
  size_t moov = b.begin("moov");
  {
    size_t mvhd = b.begin("mvhd");
    b.u32(0);  // version/flags
    b.u32(0);
    b.u32(0);  // creation/modification
    b.u32(timescale);
    b.u32(duration);
    b.u32(0x00010000);  // rate 1.0
    b.u16(0x0100);      // volume
    b.u16(0);
    b.u32(0);
    b.u32(0);
    const uint32_t mat[9] = {0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                             0x40000000};
    for (uint32_t v : mat) b.u32(v);
    for (int i = 0; i < 6; ++i) b.u32(0);  // pre_defined
    b.u32(2);                              // next track id
    b.end(mvhd);

    size_t trak = b.begin("trak");
    {
      size_t tkhd = b.begin("tkhd");
      b.u32(3);  // version 0, flags: enabled | in-movie
      b.u32(0);
      b.u32(0);
      b.u32(1);  // track id
      b.u32(0);
      b.u32(duration);
      b.u32(0);
      b.u32(0);
      b.u16(0);  // layer
      b.u16(0);  // alternate group
      b.u16(0);  // volume (video)
      b.u16(0);
      for (uint32_t v : {0x00010000u, 0u, 0u, 0u, 0x00010000u, 0u, 0u, 0u,
                         0x40000000u})
        b.u32(v);
      b.u32(static_cast<uint32_t>(m->w) << 16);
      b.u32(static_cast<uint32_t>(m->h) << 16);
      b.end(tkhd);

      size_t mdia = b.begin("mdia");
      {
        size_t mdhd = b.begin("mdhd");
        b.u32(0);
        b.u32(0);
        b.u32(0);
        b.u32(timescale);
        b.u32(duration);
        b.u16(0x55C4);  // language 'und'
        b.u16(0);
        b.end(mdhd);

        size_t hdlr = b.begin("hdlr");
        b.u32(0);
        b.u32(0);
        b.tag("vide");
        b.u32(0);
        b.u32(0);
        b.u32(0);
        b.raw("VideoHandler", 13);  // includes NUL
        b.end(hdlr);

        size_t minf = b.begin("minf");
        {
          size_t vmhd = b.begin("vmhd");
          b.u32(1);  // flags 1
          b.u16(0);
          b.u16(0);
          b.u16(0);
          b.u16(0);
          b.end(vmhd);

          size_t dinf = b.begin("dinf");
          {
            size_t dref = b.begin("dref");
            b.u32(0);
            b.u32(1);
            size_t url = b.begin("url ");
            b.u32(1);  // self-contained
            b.end(url);
            b.end(dref);
          }
          b.end(dinf);

          size_t stbl = b.begin("stbl");
          {
            size_t stsd = b.begin("stsd");
            b.u32(0);
            b.u32(1);
            {
              size_t entry = b.begin("jpeg");  // VisualSampleEntry
              for (int i = 0; i < 6; ++i) b.u8(0);
              b.u16(1);  // data ref index
              b.u16(0);
              b.u16(0);
              for (int i = 0; i < 3; ++i) b.u32(0);
              b.u16(static_cast<uint32_t>(m->w));
              b.u16(static_cast<uint32_t>(m->h));
              b.u32(0x00480000);  // 72 dpi
              b.u32(0x00480000);
              b.u32(0);
              b.u16(1);  // frame count
              uint8_t name[32] = {6, 'M', 'o', 't', 'i', 'o', 'n'};
              b.raw(name, 32);
              b.u16(24);      // depth
              b.u16(0xFFFF);  // pre_defined -1
              b.end(entry);
            }
            b.end(stsd);

            size_t stts = b.begin("stts");
            b.u32(0);
            b.u32(1);
            b.u32(n);
            b.u32(delta);
            b.end(stts);

            size_t stsc = b.begin("stsc");
            b.u32(0);
            b.u32(1);
            b.u32(1);  // first chunk
            b.u32(1);  // samples per chunk
            b.u32(1);  // sample description index
            b.end(stsc);

            size_t stsz = b.begin("stsz");
            b.u32(0);
            b.u32(0);
            b.u32(n);
            for (uint32_t s : m->sizes) b.u32(s);
            b.end(stsz);

            // 64-bit chunk offsets whenever any sample sits past 4 GiB
            // (stco would silently truncate); readers that handle AVIX
            // input all read co64.
            bool need64 =
                !m->offs.empty() && m->offs.back() > 0xFFFFFFFFull;
            size_t stco = b.begin(need64 ? "co64" : "stco");
            b.u32(0);
            b.u32(n);
            for (uint64_t o : m->offs) {
              if (need64)
                b.u64(o);
              else
                b.u32(static_cast<uint32_t>(o));
            }
            b.end(stco);
          }
          b.end(stbl);
        }
        b.end(minf);
      }
      b.end(mdia);
    }
    b.end(trak);
  }
  b.end(moov);
  fwrite(b.d.data(), 1, b.d.size(), f);
  // Patch the mdat largesize (64-bit; header is size=1 + fourcc + u64).
  fseeko(f, static_cast<off_t>(m->mdat_size_pos + 8), SEEK_SET);
  uint64_t mdat_size = mdat_end - m->mdat_size_pos;
  wr_u32be(f, static_cast<uint32_t>(mdat_size >> 32));
  wr_u32be(f, static_cast<uint32_t>(mdat_size));
  int bad = ferror(f);
  int rc = (fclose(f) || bad) ? -1 : 0;
  delete m;
  return rc;
}

}  // extern "C"
