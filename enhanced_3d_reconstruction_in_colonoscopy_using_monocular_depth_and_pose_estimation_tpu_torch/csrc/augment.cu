// The training augmentation of a whole batch in two launches, Hopper sm_90a:
// ops/augment.py::apply_augment on float32 CUDA images.
//
// It replaces no TPU kernel: the JAX package augments with XLA ops under
// vmap (ops/augment.py::augment_batch), which XLA fuses. The port's plain
// version (apply_augment_reference) runs the same ops image by image, about
// 70 op calls an image, 18 000 a fine-tuning step of 256 images, each a
// launch of microseconds on mostly idle memory. These two kernels take the
// whole batch at once, with every draw as data.
//
// Per image: horizontal flip, the four ColorJitter ops in the image's drawn
// order, RandomAffine (nearest, fill 0), ImageNet normalisation. The
// arithmetic is the plain version's as PyTorch runs it on the card: every
// multiply, add, subtract and divide is its own __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn (nvcc would otherwise contract a * b + c into one
// fma, which the plain chain of separate ops does not do, and divide
// approximately under fast math); the hue's division by 6 is a multiply by
// the f32 reciprocal, as PyTorch's CUDA division by a CPU scalar is;
// remainder is fmod with the divisor added to a negative result; clamp,
// maximum and minimum are fminf/fmaxf on finite values. What may differ
// from the plain version: the contrast mean's summation order (below), and
// the order in which the three products of a pixel's gray are summed.
//
// The host (ops/augment.py::augment_tables) makes one int32 table a call,
// copied to the card in one piece:
//   [B][kHeader] per image: order[4], then as float bits brightness,
//                contrast, f32(1 - contrast), saturation,
//                f32(1 - saturation), hue shift; the rest 0;
//   [B][H]       each output row's source row, -1 where the affine fills;
//   [B][W]       each output column's source column, the flip folded in
//                (W - 1 - column), -1 where the affine fills.
//
// The colour ops act on each pixel alone once the image's contrast mean is
// known, and the flip and the affine only move pixels. So the order of
// work can change: kernel A (contrast_sums_kernel) sums, for each image,
// gray(ops before contrast in its order) over its un-warped pixels (a flip
// does not change a sum), in chunks of kMeanTiles tiles a block, one
// partial a block; kernel B (augment_kernel) sums an image's partials in a
// fixed order, reads each output pixel's source through the two tables (or
// takes 0 where the affine fills), applies the four ops in the image's
// order and normalises. No atomics: the same inputs give the same bits.
// The chunking depends on H x W alone, so an image's mean does not depend
// on the batch it comes in.
//
// Bound: bytes. The least is the input read once and the output written
// once: at a fine-tuning step (256 x 518 x 518 x 3 f32) 824 MB each, 0.49
// ms at 3.35 TB/s. Kernel A reads the input once; kernel B reads the part
// the affine keeps (scale^2 of it, 30% on average over scale ~ U(0.1,
// 0.9)) and writes the output once.
//
// Design. A block takes pixels of one image (blockIdx.x is the image, so
// the draws, the order's branches and the tables are the same for the
// whole block). Kernel A reads its chunk as groups of four pixels, three
// 16-byte loads a group, where the chunk's start is 16-byte aligned (every
// chunk of an image whose H x W is a multiple of 4), with the next group's
// loads in flight while a thread works on the current one. Kernel B walks
// tiles of kTile pixels, neighbouring threads on neighbouring pixels, so a
// warp's gathers fall in a few sectors of one source row: it gathers each
// pixel's three floats (a pixel is 12 bytes, and neighbouring output
// pixels read source pixels 1 / scale apart, so no vector fits), runs the
// ops on the pixels the affine keeps (a filled pixel's output is the same
// for the whole block), stages the tile's output in shared memory and
// writes it out with 16-byte stores where the tile's start is aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                 // pixels a thread takes a tile
constexpr int kTile = kThreads * kPerThread;  // 1024 pixels
constexpr int kMeanTiles = 8;                 // tiles a kernel-A block sums
constexpr int kOutTiles = 4;                  // tiles a kernel-B block writes
constexpr int kHeader = 16;                   // int32 words of an image's draws
// ops/augment.py::IMAGENET_MEAN and IMAGENET_STD.
__constant__ float kMeanRgb[3] = {0.485f, 0.456f, 0.406f};
__constant__ float kStdRgb[3] = {0.229f, 0.224f, 0.225f};

// Colour ops as numbered in ops/augment.py::COLOR_OPS.
constexpr int kBrightness = 0;
constexpr int kContrast = 1;
constexpr int kSaturation = 2;  // and 3, the hue

struct Draws {
  int ops;  // the order, op k in bits 2k and 2k + 1
  float brightness, contrast, contrast_c, saturation, saturation_c, hue;
};

__device__ __forceinline__ Draws load_draws(const int* __restrict__ table,
                                            long long image) {
  const int* h = table + image * kHeader;
  Draws d;
  d.ops = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) d.ops |= __ldg(h + k) << (2 * k);
  d.brightness = __int_as_float(__ldg(h + 4));
  d.contrast = __int_as_float(__ldg(h + 5));
  d.contrast_c = __int_as_float(__ldg(h + 6));
  d.saturation = __int_as_float(__ldg(h + 7));
  d.saturation_c = __int_as_float(__ldg(h + 8));
  d.hue = __int_as_float(__ldg(h + 9));
  return d;
}

struct Rgb {
  float r, g, b;
};

// torch.clamp(x, 0, 1): NaN passes through.
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.f), 1.f);
}

// torch.remainder(x, 1.0) in float: fmod(x, 1), plus 1 where negative.
// fmod(x, 1) is x - trunc(x), exactly (the fraction of a float is
// representable), up to the sign of a zero result.
__device__ __forceinline__ float remainder1(float x) {
  const float m = __fsub_rn(x, truncf(x));
  return m < 0.f ? __fadd_rn(m, 1.f) : m;
}

// torchvision's rgb_to_grayscale weights, each product rounded.
__device__ __forceinline__ float gray(Rgb p) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p.r, 0.2989f), __fmul_rn(p.g, 0.587f)),
                   __fmul_rn(p.b, 0.114f));
}

// x f + c, clamped: contrast (c = (1 - f) mean) and saturation (c = (1 - f)
// gray), each a multiply, an add and a clamp of the plain version.
__device__ __forceinline__ Rgb blend(Rgb p, float f, float c) {
  return {clamp01(__fadd_rn(__fmul_rn(p.r, f), c)),
          clamp01(__fadd_rn(__fmul_rn(p.g, f), c)),
          clamp01(__fadd_rn(__fmul_rn(p.b, f), c))};
}

// ops/augment.py::adjust_hue: RGB -> HSV, the hue shifted, HSV -> RGB.
__device__ __forceinline__ Rgb hue(Rgb p, float shift) {
  const float r = clamp01(p.r), g = clamp01(p.g), b = clamp01(p.b);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = __fsub_rn(maxc, minc);
  const float s = maxc > 0.f ? __fdiv_rn(delta, fmaxf(maxc, 1e-12f)) : 0.f;
  const float safe = delta > 0.f ? delta : 1.f;
  // h = bc - gc where maxc == r, else (2 + rc) - bc where maxc == g, else
  // (4 + gc) - rc, with xc = (maxc - x) / safe: two of the three divisions
  // (0 + bc is bc).
  const bool is_r = maxc == r, is_g = !is_r && maxc == g;
  const float base = is_r ? 0.f : (is_g ? 2.f : 4.f);
  const float plus = is_r ? b : (is_g ? r : g);
  const float minus = is_r ? g : (is_g ? b : r);
  float h = __fsub_rn(
      __fadd_rn(base, __fdiv_rn(__fsub_rn(maxc, plus), safe)),
      __fdiv_rn(__fsub_rn(maxc, minus), safe));
  h = delta > 0.f ? h : 0.f;
  h = remainder1(__fmul_rn(h, 1.f / 6.f));
  h = remainder1(__fadd_rn(h, shift));
  const float v = maxc;
  const float h6 = __fmul_rn(h, 6.f);
  const float fi = floorf(h6);
  const float f = __fsub_rn(h6, fi);
  const float pp = __fmul_rn(v, __fsub_rn(1.f, s));
  const float q = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(f, s)));
  const float t = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(__fsub_rn(1.f, f), s)));
  switch (static_cast<int>(fi) % 6) {
    case 0: return {v, t, pp};
    case 1: return {q, v, pp};
    case 2: return {pp, v, t};
    case 3: return {pp, q, v};
    case 4: return {t, pp, v};
    default: return {v, pp, q};
  }
}

// One colour op; `cm` is f32(1 - contrast) x the image's contrast mean.
__device__ __forceinline__ Rgb colour_op(int op, Rgb p, const Draws& d,
                                         float cm) {
  switch (op) {
    case kBrightness:
      return {clamp01(__fmul_rn(p.r, d.brightness)),
              clamp01(__fmul_rn(p.g, d.brightness)),
              clamp01(__fmul_rn(p.b, d.brightness))};
    case kContrast:
      return blend(p, d.contrast, cm);
    case kSaturation:
      return blend(p, d.saturation, __fmul_rn(d.saturation_c, gray(p)));
    default:  // the hue
      return hue(p, d.hue);
  }
}

// Copy n floats from src (shared) to dst, 16 bytes at a time where dst is
// aligned.
__device__ __forceinline__ void store_tile(const float* src, int n,
                                           float* __restrict__ dst) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += kThreads) d4[i] = s4[i];
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Sum over the block in a fixed order (a shuffle tree in each warp, then
// the warps' sums in order); the result in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w)
      total = __fadd_rn(total, scratch[w]);
  return total;
}

// gray(the ops before contrast in the image's order) of one pixel.
__device__ __forceinline__ float prefix_gray(Rgb p, const Draws& d) {
  for (int o = 0; o < 4; ++o) {
    const int op = (d.ops >> (2 * o)) & 3;
    if (op == kContrast) break;
    p = colour_op(op, p, d, 0.f);
  }
  return gray(p);
}

// Kernel A: partial[b][chunk] = the sum of prefix_gray over the chunk's
// kMeanTiles x kTile pixels of image b. Grid (B, chunks). Where the
// chunk's start is 16-byte aligned, each thread reads groups of four
// pixels as three 16-byte loads, the next group's in flight while it works
// on the current one; the rest pixel by pixel.
__global__ void __launch_bounds__(kThreads)
    contrast_sums_kernel(const float* __restrict__ x,
                         const int* __restrict__ table,
                         float* __restrict__ partial, int hw) {
  __shared__ float scratch[kThreads / 32];
  const long long image = blockIdx.x;
  const Draws d = load_draws(table, image);
  const int start = blockIdx.y * kMeanTiles * kTile;
  const int count = min(hw - start, kMeanTiles * kTile);
  const float* src = x + (image * hw + start) * 3;
  float sum = 0.f;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int groups = count / 4;
    int g = threadIdx.x;
    float4 a, b, c;
    if (g < groups) {
      a = __ldg(s4 + 3 * g);
      b = __ldg(s4 + 3 * g + 1);
      c = __ldg(s4 + 3 * g + 2);
    }
    for (; g < groups; g += kThreads) {
      const float4 pa = a, pb = b, pc = c;
      if (g + kThreads < groups) {
        a = __ldg(s4 + 3 * (g + kThreads));
        b = __ldg(s4 + 3 * (g + kThreads) + 1);
        c = __ldg(s4 + 3 * (g + kThreads) + 2);
      }
      sum = __fadd_rn(sum, prefix_gray(Rgb{pa.x, pa.y, pa.z}, d));
      sum = __fadd_rn(sum, prefix_gray(Rgb{pa.w, pb.x, pb.y}, d));
      sum = __fadd_rn(sum, prefix_gray(Rgb{pb.z, pb.w, pc.x}, d));
      sum = __fadd_rn(sum, prefix_gray(Rgb{pc.y, pc.z, pc.w}, d));
    }
    done = groups * 4;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) {
    const float* px = src + i * 3;
    sum = __fadd_rn(sum, prefix_gray(Rgb{__ldg(px), __ldg(px + 1),
                                         __ldg(px + 2)}, d));
  }
  const float total = block_sum(sum, scratch);
  if (threadIdx.x == 0) partial[image * gridDim.y + blockIdx.y] = total;
}

// Kernel B: out[b] = normalise(colour ops(source pixel)), or normalise(0)
// where the affine fills. Grid (B, blocks of kOutTiles tiles).
__global__ void __launch_bounds__(kThreads)
    augment_kernel(const float* __restrict__ x, const int* __restrict__ table,
                   const float* __restrict__ partial, float* __restrict__ out,
                   int batch, int h, int w, int chunks) {
  __shared__ __align__(16) float tile[kTile * 3];
  __shared__ float mean;
  const long long image = blockIdx.x;
  const int hw = h * w;
  const Draws d = load_draws(table, image);
  if (threadIdx.x < 32) {
    // The image's sum, its chunks in a fixed order, times 1 / (H W) as
    // torch.mean scales its sum.
    float s = 0.f;
    for (int i = threadIdx.x; i < chunks; i += 32)
      s = __fadd_rn(s, partial[image * chunks + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(~0u, s, o));
    if (threadIdx.x == 0)
      mean = __fmul_rn(s, __fdiv_rn(1.f, static_cast<float>(hw)));
  }
  __syncthreads();
  const float cm = __fmul_rn(d.contrast_c, mean);
  const long long heads = static_cast<long long>(batch) * kHeader;
  const int* rows = table + heads + image * h;
  const int* cols = table + heads + static_cast<long long>(batch) * h +
                    image * w;
  const float* src = x + image * hw * 3;
  float* dst = out + image * hw * 3;
  // A filled pixel's output, (0 - mean) / std, the same for the block.
  float fill[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    fill[i] = __fdiv_rn(__fsub_rn(0.f, kMeanRgb[i]), kStdRgb[i]);
  // This thread's pixel (y, col) of each tile, stepped kThreads pixels at
  // a time: one division a block.
  const int step_y = kThreads / w, step_x = kThreads - step_y * w;
  int pix = blockIdx.y * kOutTiles * kTile + threadIdx.x;
  int y = pix / w, col = pix - y * w;
  for (int t = 0; t < kOutTiles; ++t) {
    const int t0 = (blockIdx.y * kOutTiles + t) * kTile;
    if (t0 >= hw) break;
    const int n = min(kTile, hw - t0);
    // Gather first, so that a thread's loads are in flight together.
    Rgb p[kPerThread];
    bool kept[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      kept[k] = false;
      p[k] = Rgb{0.f, 0.f, 0.f};
      if (k * kThreads + static_cast<int>(threadIdx.x) < n) {
        const int sy = __ldg(rows + y), sx = __ldg(cols + col);
        if (sy >= 0 && sx >= 0) {
          const float* s = src + (static_cast<long long>(sy) * w + sx) * 3;
          p[k] = Rgb{__ldg(s), __ldg(s + 1), __ldg(s + 2)};
          kept[k] = true;
        }
      }
      y += step_y;
      col += step_x;
      if (col >= w) {
        col -= w;
        ++y;
      }
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (j < n) {
        float c[3] = {fill[0], fill[1], fill[2]};
        if (kept[k]) {
          Rgb q = p[k];
          for (int o = 0; o < 4; ++o)
            q = colour_op((d.ops >> (2 * o)) & 3, q, d, cm);
          c[0] = q.r;
          c[1] = q.g;
          c[2] = q.b;
#pragma unroll
          for (int i = 0; i < 3; ++i)
            c[i] = __fdiv_rn(__fsub_rn(c[i], kMeanRgb[i]), kStdRgb[i]);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) tile[j * 3 + i] = c[i];
      }
    }
    __syncthreads();
    store_tile(tile, n * 3, dst + static_cast<long long>(t0) * 3);
    __syncthreads();
  }
}

}  // namespace

// x: (batch, h, w, 3) float32, contiguous, on the card; out: the same
// shape, contiguous; table: augment_tables' int32 words; partial: `chunks`
// floats an image (chunks = ceil(h w / (kMeanTiles kTile)), checked here).
// Launches kernel A, then kernel B, on `stream`; returns the CUDA error of
// the launches (0 when both were accepted).
extern "C" int e3d_augment(const void* x, void* out, const void* table,
                           void* partial, int batch, int h, int w, int chunks,
                           void* stream) {
  const long long hw = static_cast<long long>(h) * w;
  const int per_chunk = kMeanTiles * kTile;
  const int per_block = kOutTiles * kTile;
  const long long blocks = (hw + per_block - 1) / per_block;
  if (batch <= 0 || h <= 0 || w <= 0 || hw * 3 > INT32_MAX ||
      chunks != (hw + per_chunk - 1) / per_chunk || chunks > 65535 ||
      blocks > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int* tp = static_cast<const int*>(table);
  float* pp = static_cast<float*>(partial);
  contrast_sums_kernel<<<dim3(batch, chunks), kThreads, 0, s>>>(
      xp, tp, pp, static_cast<int>(hw));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  augment_kernel<<<dim3(batch, static_cast<unsigned>(blocks)), kThreads, 0,
                   s>>>(xp, tp, pp, static_cast<float*>(out), batch, h, w,
                        chunks);
  return cudaGetLastError();
}
