// Align-corners bilinear resize as a 2-tap lerp (kernel K6), Hopper sm_90a.
//
// Replaces ops/resize.py::_lerp_resize_pallas of the JAX package
// (_lerp_rows_kernel, then _lerp_cols_kernel). There, an H pass writes a
// (B, H2, W, C) array in x's dtype and a W pass reads it back:
//   t[y, c]  = x[lo_y, c] if fy == 0
//              else round(x[lo_y, c] w0_y + x[lo_y + 1, c] w1_y)
//   out[y, x] = t[y, lo_x] if fx == 0
//              else round(t[y, lo_x] w0_x + t[y, lo_x + 1] w1_x)
// with w0 = f32(1 - frac), w1 = f32(frac), each product and the sum
// rounded to f32 (no fused multiply-add) and round() to x's dtype. A pass
// whose size does not change is skipped: its tables make every output a
// copy of its source (w1 = 0).
//
// Bound: the bytes, each input element read once and each output written
// once (three quarters of them the output at the decoder's 2x upsamples);
// its arithmetic (6 flops per output) is far below the card's rate. At
// the decoder's largest resize (vitl, batch 8: 296 -> 518 at 128
// channels, bf16) that is 179 MB in and 550 MB out, 0.22 ms at 3.35 TB/s.
//
// Design. The memory is channels-last (NHWC, the decoder's tensors and
// the JAX package's layout), so a span of one source row, all channels,
// is one contiguous run of bytes. The output is cut into tiles (image,
// band of output rows, span of output columns) by the host's plan
// (ops/resize.py::_lerp_plan), which also lists the source rows a band
// needs ("stages": rows that no output row reads, as in an align-corners
// downscale, are left out), the source columns of each span (its taps
// plus one halo column) and the ring's depth. A persistent grid walks the
// tiles. A block's warps each take one role, and pass their work on
// through mbarriers, with no block-wide barrier:
//  - a producer warp keeps a ring of stages in shared memory full with
//    1-D TMA bulk copies, each completing on its slot's "full" mbarrier,
//    and refills a slot once the H warps free it on its "empty" mbarrier;
//    it runs ahead across output rows and into the block's next tile, so
//    the next source rows are in flight while the current ones are used,
//    no other warp waits on its table reads, and each source element
//    comes from device memory once per band;
//  - kHWarps H warps blend each output row's two stages into an H row in
//    x's dtype, once, in a ring of kHRing H rows ("h_full" when made,
//    "h_empty" when written out);
//  - kWWarps W warps write the row's span from its H row as coalesced
//    16-byte vectors, each thread on fixed channels and a stride of
//    pixels, the span's taps in shared memory (one 16-byte load a pixel):
//    no division and no table load from device memory in the loop. They
//    keep the store stream going while the H warps make the next rows.
// bf16 pairs convert to and from f32 two at a time. Channel counts whose
// pixel is not a multiple of 16 bytes (or unaligned memory) take the same
// tiles with one element per access and stages copied by the H warps
// instead of TMA, without the producer warp.

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive channels of one pixel, moved as one access (16 bytes on
// the vector path).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// a w0 + b w1 in f32, the two products and the sum each rounded on their
// own (as the plain version's separate multiplies and add), then to T.
// bf16 pairs convert two at a time (one cvt.rn.bf16x2.f32 each), with
// the same rounding element by element.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> blend(const Vec<T, V>& a,
                                           const Vec<T, V>& b, float w0,
                                           float w1) {
  Vec<T, V> o;
  if constexpr (std::is_same<T, bf16>::value && V % 2 == 0) {
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a.v);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b.v);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o.v);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const float2 fa = __bfloat1622float2(a2[j]);
      const float2 fb = __bfloat1622float2(b2[j]);
      o2[j] = __floats2bfloat162_rn(
          __fadd_rn(__fmul_rn(fa.x, w0), __fmul_rn(fb.x, w1)),
          __fadd_rn(__fmul_rn(fa.y, w0), __fmul_rn(fb.y, w1)));
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      o.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(to_f32(a.v[j]), w0),
                                     __fmul_rn(to_f32(b.v[j]), w1)));
  }
  return o;
}

struct Args {
  const void* x;
  void* y;
  int c, h, w, h2, w2;
  // Rows: the sorted source rows that some output row reads (stages),
  // each output row's first stage (its lo_y), and its weights.
  const int* stage_row;
  const int* first_stage;
  const float* w0_y;
  const float* w1_y;
  // Columns: each output column's lo_x and weights.
  const int* lo_x;
  const float* w0_x;
  const float* w1_x;
  // The plan: output columns a tile spans, output rows a band holds,
  // stages the ring holds, source columns a slot holds, tiles in all.
  int span, spans, band, bands, ring, src_cols;
  long long tiles;
};

// One tile's extent: image, output rows [oy0, oy1), columns [ox0, ox1),
// source columns [sx0, sx1) and stages [s0, s1).
struct Tile {
  long long img;
  int oy0, oy1, ox0, ox1, sx0, sx1, s0, s1;
};

__device__ __forceinline__ Tile tile_at(const Args& a, long long t) {
  Tile g;
  const int k = static_cast<int>(t % a.spans);
  const long long rest = t / a.spans;
  const int b = static_cast<int>(rest % a.bands);
  g.img = rest / a.bands;
  g.oy0 = b * a.band;
  g.oy1 = min(a.h2, g.oy0 + a.band);
  g.ox0 = k * a.span;
  g.ox1 = min(a.w2, g.ox0 + a.span);
  g.sx0 = a.lo_x[g.ox0];
  g.sx1 = a.lo_x[g.ox1 - 1] + (a.w1_x[g.ox1 - 1] != 0.f) + 1;
  g.s0 = a.first_stage[g.oy0];
  g.s1 = a.first_stage[g.oy1 - 1] + (a.w1_y[g.oy1 - 1] != 0.f) + 1;
  return g;
}

// Where the stages of the block's tiles (t, t + grid, ...) go, in order:
// one sequence number each, slot seq % ring.
struct StageWalk {
  long long tile;
  Tile g;
  int s;  // the next stage of `tile`

  __device__ __forceinline__ void start(const Args& a) {
    tile = blockIdx.x;
    g = tile_at(a, tile);
    s = g.s0;
  }
  __device__ __forceinline__ bool more(const Args& a) const {
    return tile < a.tiles;
  }
  // Source of the current stage, its bytes; then step to the next.
  template <typename T>
  __device__ __forceinline__ const T* next(const Args& a, int* bytes) {
    const T* src = static_cast<const T*>(a.x) +
                   ((g.img * a.h + a.stage_row[s]) * a.w + g.sx0) *
                       static_cast<long long>(a.c);
    *bytes = (g.sx1 - g.sx0) * a.c * static_cast<int>(sizeof(T));
    if (++s == g.s1) {
      tile += gridDim.x;
      if (tile < a.tiles) {
        g = tile_at(a, tile);
        s = g.s0;
      }
    }
    return src;
  }
};

// The warps of a block: kWWarps write output rows (the W pass), kHWarps
// make H rows, and on the TMA path one producer warp after them loads the
// stages. H rows pass from the H warps to the W warps through a ring of
// kHRing buffers.
constexpr int kWWarps = 8;
constexpr int kHWarps = 4;
constexpr int kWThreads = 32 * kWWarps;
constexpr int kHThreads = 32 * kHWarps;
constexpr int kHRing = 3;

// One output column's tap: its offset into the H row (lo_x - the tile's
// first source column, in vectors) and weights, read as one 16-byte load.
struct alignas(16) Tap {
  int off;
  float w0, w1;
  int pad;
};

template <typename T, int V, bool kBulk>
__global__ void __launch_bounds__(kWThreads + kHThreads + 32, 2)
lerp_resize_kernel(const Args a) {
  typedef Vec<T, V> VT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::aligned_smem(smem_raw);
  const int cv = a.c / V;  // vectors a pixel
  const int slot_bytes = (a.src_cols * a.c * static_cast<int>(sizeof(T)) +
                          127) & ~127;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // stage arrived
  uint64_t* empty = full + 8;                          // stage dead
  uint64_t* h_full = full + 16;                        // H row made
  uint64_t* h_empty = full + 24;                       // H row written out
  unsigned char* slots = smem + 256;
  unsigned char* hrows = slots + a.ring * slot_bytes;
  Tap* taps = reinterpret_cast<Tap*>(hrows + kHRing * slot_bytes);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < a.ring; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kHThreads);
    }
    for (int i = 0; i < kHRing; ++i) {
      hopper::mbar_init(&h_full[i], kHThreads);
      hopper::mbar_init(&h_empty[i], kWThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid < kWThreads) {
    // ---- W warps: per output row, its span from the H row, as 16-byte
    // vectors: ct channel vectors of each of np pixels at a time.
    const int ct = min(cv, kWThreads);
    const int np = kWThreads / ct;
    const int lane_c = tid % ct;
    const int lane_p = tid / ct;
    int row = 0;
    for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const Tile g = tile_at(a, t);
      const int sk = g.ox1 - g.ox0;
      hopper::bar_sync(1, kWThreads);  // the last tile's taps are done
      for (int p = tid; p < sk; p += kWThreads) {
        Tap tap;
        tap.off = (a.lo_x[g.ox0 + p] - g.sx0) * cv;
        tap.w0 = a.w0_x[g.ox0 + p];
        tap.w1 = a.w1_x[g.ox0 + p];
        tap.pad = 0;
        taps[p] = tap;
      }
      hopper::bar_sync(1, kWThreads);
      for (int oy = g.oy0; oy < g.oy1; ++oy, ++row) {
        const int slot = row % kHRing;
        hopper::mbar_wait(&h_full[slot],
                          static_cast<uint32_t>(row / kHRing) & 1);
        const VT* hb = reinterpret_cast<const VT*>(hrows + slot * slot_bytes);
        VT* out = reinterpret_cast<VT*>(
            static_cast<T*>(a.y) + ((g.img * a.h2 + oy) * a.w2 + g.ox0) *
                                       static_cast<long long>(a.c));
        if (lane_p < np) {
          for (int p = lane_p; p < sk; p += np) {
            const Tap tap = taps[p];
            const VT* src = hb + tap.off;
            VT* dst = out + p * cv;
            if (tap.w1 == 0.f) {
              for (int q = lane_c; q < cv; q += ct) dst[q] = src[q];
            } else {
              for (int q = lane_c; q < cv; q += ct)
                dst[q] = blend<T, V>(src[q], src[q + cv], tap.w0, tap.w1);
            }
          }
        }
        hopper::mbar_arrive(&h_empty[slot]);
      }
    }
    return;
  }

  if (tid >= kWThreads + kHThreads) {
    // ---- The producer warp (TMA path): every stage of the block, in
    // order, into its slot once the H warps have freed its last stage.
    if constexpr (kBulk) {
      if (tid == kWThreads + kHThreads) {
        StageWalk walk;
        walk.start(a);
        for (int seq = 0; walk.more(a); ++seq) {
          const int slot = seq % a.ring;
          if (seq >= a.ring)
            hopper::mbar_wait(&empty[slot],
                              static_cast<uint32_t>(seq / a.ring - 1) & 1);
          int bytes;
          const T* src = walk.next<T>(a, &bytes);
          hopper::mbar_expect_tx(&full[slot], bytes);
          hopper::bulk_load(slots + slot * slot_bytes, src, bytes,
                            &full[slot]);
        }
      }
    }
    return;
  }

  // ---- H warps: per output row, its two stages blended into an H row.
  const int hid = tid - kWThreads;
  // Without TMA the H warps copy the stages themselves: [filled,
  // released + ring), made visible by their named barrier.
  [[maybe_unused]] StageWalk walk;
  [[maybe_unused]] int filled = 0;
  auto copy_stages = [&](int released) {
    for (; walk.more(a) && filled < released + a.ring; ++filled) {
      int bytes;
      const T* src = walk.next<T>(a, &bytes);
      T* dst = reinterpret_cast<T*>(slots + (filled % a.ring) * slot_bytes);
      const int n = bytes / static_cast<int>(sizeof(T));
      for (int i = hid; i < n; i += kHThreads) dst[i] = src[i];
    }
  };
  if constexpr (!kBulk) {
    walk.start(a);
    copy_stages(0);
  }
  int waited = 0;  // stages seen arriving (TMA path)
  int freed = 0;   // stages given back to the producer
  int base = 0;    // sequence number of the tile's first stage
  int row = 0;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile g = tile_at(a, t);
    const int nv = (g.sx1 - g.sx0) * cv;
    for (int oy = g.oy0; oy < g.oy1; ++oy, ++row) {
      const float wy0 = a.w0_y[oy], wy1 = a.w1_y[oy];
      const int sa = base + (a.first_stage[oy] - g.s0);
      const int sb = sa + (wy1 != 0.f);
      const int released =
          oy + 1 < g.oy1 ? base + (a.first_stage[oy + 1] - g.s0)
                         : base + (g.s1 - g.s0);
      if constexpr (kBulk) {
        for (; waited <= sb; ++waited)
          hopper::mbar_wait(&full[waited % a.ring],
                            static_cast<uint32_t>(waited / a.ring) & 1);
      } else {
        hopper::bar_sync(2, kHThreads);  // the copies are done
      }
      const int slot = row % kHRing;
      if (row >= kHRing)
        hopper::mbar_wait(&h_empty[slot],
                          static_cast<uint32_t>(row / kHRing - 1) & 1);
      const VT* ra = reinterpret_cast<const VT*>(slots +
                                                 (sa % a.ring) * slot_bytes);
      const VT* rb = reinterpret_cast<const VT*>(slots +
                                                 (sb % a.ring) * slot_bytes);
      VT* hb = reinterpret_cast<VT*>(hrows + slot * slot_bytes);
      if (wy1 == 0.f) {
        for (int i = hid; i < nv; i += kHThreads) hb[i] = ra[i];
      } else {
        for (int i = hid; i < nv; i += kHThreads)
          hb[i] = blend<T, V>(ra[i], rb[i], wy0, wy1);
      }
      hopper::mbar_arrive(&h_full[slot]);
      // This thread is done with the stages before `released`.
      if constexpr (kBulk) {
        for (; freed < released; ++freed)
          hopper::mbar_arrive(&empty[freed % a.ring]);
      } else {
        hopper::bar_sync(2, kHThreads);
        copy_stages(released);
      }
    }
    base += g.s1 - g.s0;
  }
}

template <typename T, int V, bool kBulk>
cudaError_t launch(const Args& a, int threads, int grid, int smem,
                   cudaStream_t stream) {
  // The plan (ops/resize.py::_lerp_smem) must have sized the block as
  // the kernel lays it out: 1 KB of alignment slack, the barriers, the
  // ring and H rows, the taps.
  const int slot = (a.src_cols * a.c * static_cast<int>(sizeof(T)) + 127) &
                   ~127;
  if (threads != kWThreads + kHThreads + (kBulk ? 32 : 0) || a.ring < 2 ||
      a.ring > 8 ||
      smem < 1024 + 256 + (a.ring + kHRing) * slot + 16 * a.span)
    return cudaErrorInvalidValue;
  auto kernel = lerp_resize_kernel<T, V, kBulk>;
  const cudaError_t err = hopper::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int threads, int grid, int smem,
                     cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = (a.c * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  return vec ? launch<T, kV, true>(a, threads, grid, smem, stream)
             : launch<T, 1, false>(a, threads, grid, smem, stream);
}

}  // namespace

// x: an (n, c, h, w) tensor of `dtype` (0 float32, 1 bfloat16) in
// channels-last (NHWC) memory; y: the (n, c, h2, w2) output in the same
// memory format. Row tables: stage_row (int32, the source rows read, in
// order), first_stage (int32, h2: the index in stage_row of each output
// row's lo_y), w0_y, w1_y (f32, h2); column tables lo_x (int32), w0_x,
// w1_x (f32), w2 each. The plan (ops/resize.py::_lerp_plan): span, band,
// ring, src_cols, threads a block, grid and dynamic shared memory (the
// plan's vector choice assumes 16-byte aligned x and y where the pixel
// is a multiple of 16 bytes; the caller ensures it). Launches on
// `stream`, allocates nothing, and returns the launch's error
// (cudaErrorInvalidValue for another dtype, or a plan whose threads, ring
// or shared memory do not fit the kernel).
extern "C" int e3d_lerp_resize(const void* x, void* y, long long n, int c,
                               int h, int w, int h2, int w2,
                               const void* stage_row, const void* first_stage,
                               const void* w0_y, const void* w1_y,
                               const void* lo_x, const void* w0_x,
                               const void* w1_x, int span, int band, int ring,
                               int src_cols, int threads, int grid, int smem,
                               int dtype, void* stream) {
  if (n <= 0 || c <= 0 || h2 <= 0 || w2 <= 0) return cudaSuccess;
  Args a;
  a.x = x;
  a.y = y;
  a.c = c;
  a.h = h;
  a.w = w;
  a.h2 = h2;
  a.w2 = w2;
  a.stage_row = static_cast<const int*>(stage_row);
  a.first_stage = static_cast<const int*>(first_stage);
  a.w0_y = static_cast<const float*>(w0_y);
  a.w1_y = static_cast<const float*>(w1_y);
  a.lo_x = static_cast<const int*>(lo_x);
  a.w0_x = static_cast<const float*>(w0_x);
  a.w1_x = static_cast<const float*>(w1_x);
  a.span = span;
  a.spans = (w2 + span - 1) / span;
  a.band = band;
  a.bands = (h2 + band - 1) / band;
  a.ring = ring;
  a.src_cols = src_cols;
  a.tiles = n * a.spans * a.bands;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(a, threads, grid, smem, s);
    case 1:
      return dispatch<bf16>(a, threads, grid, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}
