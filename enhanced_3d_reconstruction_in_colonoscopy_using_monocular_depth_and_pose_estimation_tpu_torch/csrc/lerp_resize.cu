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
// whose size does not change is skipped.
//
// Design. One kernel where the JAX package has two passes: each output
// pixel computes the two H-pass values it needs (at columns lo_x and
// lo_x + 1), rounds them to x's dtype as the intermediate array is
// rounded, and blends them along W. So the intermediate never goes to
// device memory, and the result equals the two-pass one. The port's
// decoder is NCHW, but its tensors lie in channels-last memory (the
// reassembled tokens are a transposed view, and the convolutions keep
// that format), which is the JAX package's NHWC layout: the kernel reads
// and writes that memory. One block per output row of one image, its
// threads across (column, channel) with the channels fastest and 16-byte
// loads and stores, so stores are coalesced and the row's two source rows
// stay in L1. Taps and weights come from (out,)-sized tables that the
// host builds from f64 coordinates once per shape.
//
// Bound: the bytes, each input element read once and each output written
// once. At the decoder's largest resize (vitl, batch 8: 296 -> 518 at 128
// channels, bf16) that is 179 MB in and 550 MB out, 0.22 ms at 3.35 TB/s;
// its arithmetic (6 flops per output) is far below the card's rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

// a w0 + b w1 in f32, the two products and the sum each rounded on their
// own (as the plain version's separate multiplies and add), then to T.
template <typename T>
__device__ __forceinline__ T blend(T a, T b, float w0, float w1) {
  return from_f32<T>(
      __fadd_rn(__fmul_rn(to_f32(a), w0), __fmul_rn(to_f32(b), w1)));
}

// V consecutive channels of one pixel, loaded or stored as one vector
// (16 bytes where the channels and the base addresses allow).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The H pass's V values at offset `off` of source rows r0 (lo) and r1
// (lo + 1), rounded to T; a copy of r0's where the row's frac is 0.
template <typename T, int V>
__device__ __forceinline__ void h_values(T (&out)[V], const T* __restrict__ r0,
                                         const T* __restrict__ r1,
                                         long long off, float w0, float w1,
                                         bool copy) {
  const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(r0 + off);
  if (copy) {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = a.v[j];
    return;
  }
  const Vec<T, V> b = *reinterpret_cast<const Vec<T, V>*>(r1 + off);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = blend<T>(a.v[j], b.v[j], w0, w1);
}

template <typename T, int V>
__global__ void lerp_resize_kernel(const T* __restrict__ x,
                                   T* __restrict__ y, int c, int h, int w,
                                   int h2, int w2,
                                   const int* __restrict__ lo_y,
                                   const float* __restrict__ w0_y,
                                   const float* __restrict__ w1_y,
                                   const int* __restrict__ lo_x,
                                   const float* __restrict__ w0_x,
                                   const float* __restrict__ w1_x) {
  const long long row = blockIdx.x;  // image * h2 + oy
  const int oy = static_cast<int>(row % h2);
  const long long pitch = (long long)w * c;  // one input row
  const T* src = x + (row / h2) * h * pitch;
  T* dst = y + row * w2 * (long long)c;

  const T* r0;
  const T* r1;
  float wy0 = 1.f, wy1 = 0.f;
  if (lo_y != nullptr) {
    r0 = src + lo_y[oy] * pitch;
    r1 = r0 + pitch;
    wy0 = w0_y[oy];
    wy1 = w1_y[oy];
  } else {
    r0 = r1 = src + oy * pitch;
  }
  const bool y_copy = wy1 == 0.f;

  const int cv = c / V;  // vectors per pixel
  for (int i = threadIdx.x; i < w2 * cv; i += blockDim.x) {
    const int ox = i / cv;
    const int ch = (i - ox * cv) * V;
    Vec<T, V> out;
    if (lo_x != nullptr) {
      const int lx = lo_x[ox];
      const float wx1 = w1_x[ox];
      h_values<T, V>(out.v, r0, r1, (long long)lx * c + ch, wy0, wy1,
                     y_copy);
      if (wx1 != 0.f) {
        T b[V];
        h_values<T, V>(b, r0, r1, (long long)(lx + 1) * c + ch, wy0, wy1,
                       y_copy);
        const float wx0 = w0_x[ox];
#pragma unroll
        for (int j = 0; j < V; ++j) out.v[j] = blend<T>(out.v[j], b[j], wx0, wx1);
      }
    } else {
      h_values<T, V>(out.v, r0, r1, (long long)ox * c + ch, wy0, wy1, y_copy);
    }
    *reinterpret_cast<Vec<T, V>*>(dst + (long long)ox * c + ch) = out;
  }
}

int block_threads(long long work) {
  return work >= 256 ? 256 : static_cast<int>(((work + 31) / 32) * 32);
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, int c, int h, int w,
                   int h2, int w2, const int* lo_y, const float* w0_y,
                   const float* w1_y, const int* lo_x, const float* w0_x,
                   const float* w1_x, cudaStream_t stream) {
  const long long blocks = n * h2;
  if (blocks <= 0 || w2 <= 0 || c <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  constexpr int kV = 16 / sizeof(T);
  const bool vec = c % kV == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec) {
    lerp_resize_kernel<T, kV>
        <<<(unsigned)blocks, block_threads((long long)w2 * c / kV), 0,
           stream>>>(xp, yp, c, h, w, h2, w2, lo_y, w0_y, w1_y, lo_x, w0_x,
                     w1_x);
  } else {
    lerp_resize_kernel<T, 1>
        <<<(unsigned)blocks, block_threads((long long)w2 * c), 0, stream>>>(
            xp, yp, c, h, w, h2, w2, lo_y, w0_y, w1_y, lo_x, w0_x, w1_x);
  }
  return cudaGetLastError();
}

}  // namespace

// x: an (n, c, h, w) tensor of `dtype` (0 float32, 1 bfloat16) in
// channels-last (NHWC) memory; y: the (n, c, h2, w2) output in the same
// memory format. Row tables lo_y (int32), w0_y, w1_y (f32) of length h2,
// or all null when h2 == h; column tables likewise of length w2. Launches
// on `stream`, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for another dtype).
extern "C" int e3d_lerp_resize(const void* x, void* y, long long n, int c,
                               int h, int w, int h2, int w2,
                               const void* lo_y, const void* w0_y,
                               const void* w1_y, const void* lo_x,
                               const void* w0_x, const void* w1_x, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ly = static_cast<const int*>(lo_y);
  const float* ay = static_cast<const float*>(w0_y);
  const float* by = static_cast<const float*>(w1_y);
  const int* lx = static_cast<const int*>(lo_x);
  const float* ax = static_cast<const float*>(w0_x);
  const float* bx = static_cast<const float*>(w1_x);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, n, c, h, w, h2, w2, ly, ay, by, lx, ax, bx,
                           s);
    case 1:
      return launch<bf16>(x, y, n, c, h, w, h2, w2, ly, ay, by, lx, ax, bx,
                          s);
    default:
      return cudaErrorInvalidValue;
  }
}
