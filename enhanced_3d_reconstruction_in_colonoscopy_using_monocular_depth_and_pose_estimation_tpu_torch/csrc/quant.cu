// The int8 W8A8 passes around torch._int_mm, Hopper sm_90a:
//   Q1 quantize_rows: symmetric int8 per row (kernels quantize_rows_kernel,
//      and row_absmax_kernel + quantize_long_kernel for long rows);
//   Q2 dequant: the int32 accumulator rescaled to bf16 or f32
//      (dequant_kernel).
//
// They replace what XLA fuses around each int8 dot of the JAX package's
// ops/quant.py (plain XLA there, no Pallas kernel): Q1 the activation and
// weight quantizers (quantize_axes :76-102, quantize_cols :153-162, the
// weight side of int8_conv :206-208); Q2 the rescale of int8_dense
// :177-180, int8_einsum :191-192 and int8_conv :218-221. Eager PyTorch
// would run each as a chain of about seven (Q1) and five (Q2) elementwise
// passes over f32 copies; each kernel is one pass.
//
// Arithmetic, bit for bit as the plain versions in ops/quant.py:
//   Q1: amax = max |x| over the row (exact in any order); scale =
//       max(amax, 1e-8) / 127, or a given per-tensor scale (frozen
//       calibration); q = clip(rint(x / scale), -127, 127). The divides
//       are __fdiv_rn (IEEE, not the approximate divide) and rintf rounds
//       half to even, as torch.round and jnp.round do.
//   Q2: out = (f32(acc) * xs[row]) * ws[col]; then either + bias in f32
//       and one rounding to the output type (int8_dense, int8_conv), or
//       the rounding first and + bias in f32 with a second rounding (the
//       fused attention branch, which adds a bias of the output type).
//       Every multiply and add is its own __fmul_rn / __fadd_rn: nvcc would
//       otherwise contract a * b + c into one fma, which the plain chain
//       of separate torch ops does not do.
//
// Bound: bytes. Q1 reads x once and writes q and one f32 per row; Q2 reads
// the int32 accumulator once and writes the output (scales and bias are
// read once per row or column and stay in L1/L2). At vitl, batch 8, 518 px
// the largest Q1 is the fc2 input (10 960 x 4096 bf16: 90 MB in, 45 MB
// out, 0.04 ms at 3.35 TB/s) and the largest Q2 the fc1 output (10 960 x
// 4096: 180 MB in, 90 MB out, 0.08 ms).
//
// Design. Q1 on rows of at most 4096 elements (every token row and weight
// row of the encoders): one block per row holds the row in registers, so
// x is read once; the block's max is a shuffle reduction. Longer rows (a
// whole image of a decoder convolution, up to 22 M elements) are cut into
// chunks of a 2-D grid: one pass takes each chunk's max into the row's
// slot by atomicMax on the float's bits (non-negative floats order as
// their bits, so the result does not depend on the order), a second pass
// quantizes. Q2 is a grid-stride pass over 4-column groups: one 16-byte
// load of the accumulator and one 8- or 16-byte store; the accumulator may
// be a strided 3-D grid of rows (the crop of a padded convolution) and
// the row scale may cover a group of rows (one image).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kEps = 1e-8f;
constexpr int kThreads = 256;
constexpr int kPerThread = 16;  // row elements a thread holds (Q1, short)
constexpr int kShortMax = kThreads * kPerThread;  // 4096
constexpr int kLongIters = 8;   // vectors per thread and chunk (Q1, long)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <int V>
struct alignas(V) QVec {
  int8_t v[V];
};

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, kEps), 127.f);
}

__device__ __forceinline__ float block_max(float v, float* shared) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i)
    v = fmaxf(v, shared[i]);
  return v;
}

// Q1, rows of K <= kShortMax elements: one block per row, the row held in
// registers (kPerThread / V vectors a thread).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const T* __restrict__ x, long long ld, int K,
                         const float* __restrict__ given,
                         int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecs = kPerThread / V;
  __shared__ float shared[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * ld;
  int8_t* qr = q + row * K;
  const int nvec = K / V;
  float v[kPerThread];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int vi = threadIdx.x + i * blockDim.x;
    if (vi < nvec) {
      const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(xr + vi * V);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i * V + j] = to_f32(a.v[j]);
        amax = fmaxf(amax, fabsf(v[i * V + j]));
      }
    }
  }
  float s;
  if (given != nullptr) {
    s = given[0];
  } else {
    s = row_scale(block_max(amax, shared));
    if (threadIdx.x == 0) scale[row] = s;
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int vi = threadIdx.x + i * blockDim.x;
    if (vi < nvec) {
      QVec<V> out;
#pragma unroll
      for (int j = 0; j < V; ++j) out.v[j] = quantize(v[i * V + j], s);
      *reinterpret_cast<QVec<V>*>(qr + vi * V) = out;
    }
  }
}

// Q1, long rows, pass 1: each block's max of its chunk of row blockIdx.y,
// into amax_bits[row] (zeroed by the host) by atomicMax on the bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_absmax_kernel(const T* __restrict__ x, long long ld, long long K,
                      unsigned* __restrict__ amax_bits) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float shared[kThreads / 32];
  const T* xr = x + blockIdx.y * ld;
  const long long nvec = K / V;
  const long long first = (long long)blockIdx.x * kThreads * kLongIters;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kLongIters; ++i) {
    const long long vi = first + threadIdx.x + (long long)i * kThreads;
    if (vi < nvec) {
      const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(xr + vi * V);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(to_f32(a.v[j])));
    }
  }
  amax = block_max(amax, shared);
  if (threadIdx.x == 0) atomicMax(amax_bits + blockIdx.y, __float_as_uint(amax));
}

// Q1, long rows, pass 2: quantize chunk blockIdx.x of row blockIdx.y with
// the row's scale (from pass 1, or the given one).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_long_kernel(const T* __restrict__ x, long long ld, long long K,
                         const unsigned* __restrict__ amax_bits,
                         const float* __restrict__ given,
                         int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int V = 16 / sizeof(T);
  const long long row = blockIdx.y;
  const T* xr = x + row * ld;
  int8_t* qr = q + row * K;
  float s;
  if (given != nullptr) {
    s = given[0];
  } else {
    s = row_scale(__uint_as_float(amax_bits[row]));
    if (blockIdx.x == 0 && threadIdx.x == 0) scale[row] = s;
  }
  const long long nvec = K / V;
  const long long first = (long long)blockIdx.x * kThreads * kLongIters;
#pragma unroll
  for (int i = 0; i < kLongIters; ++i) {
    const long long vi = first + threadIdx.x + (long long)i * kThreads;
    if (vi < nvec) {
      const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(xr + vi * V);
      QVec<V> out;
#pragma unroll
      for (int j = 0; j < V; ++j) out.v[j] = quantize(to_f32(a.v[j]), s);
      *reinterpret_cast<QVec<V>*>(qr + vi * V) = out;
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* xv, long long ld, long long R,
                            long long K, const float* given, int8_t* q,
                            float* scale, unsigned* work, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  if (R <= 0 || K <= 0) return cudaSuccess;
  if (K % V || ld % V || reinterpret_cast<uintptr_t>(xv) % 16)
    return cudaErrorInvalidValue;
  if (K <= kShortMax) {
    if (R > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const long long per = kPerThread / V;  // vectors a thread holds
    const long long need = (K / V + per - 1) / per;
    const int threads = static_cast<int>(need <= 32 ? 32 : (need + 31) / 32 * 32);
    quantize_rows_kernel<T><<<(unsigned)R, threads, 0, s>>>(
        x, ld, static_cast<int>(K), given, q, scale);
    return cudaGetLastError();
  }
  if (R > 65535) return cudaErrorInvalidConfiguration;
  const long long chunk = (long long)kThreads * kLongIters * V;
  const dim3 grid((unsigned)((K + chunk - 1) / chunk), (unsigned)R);
  if (given == nullptr) {
    cudaError_t err = cudaMemsetAsync(work, 0, R * sizeof(unsigned), s);
    if (err != cudaSuccess) return err;
    row_absmax_kernel<T><<<grid, kThreads, 0, s>>>(x, ld, K, work);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  quantize_long_kernel<T><<<grid, kThreads, 0, s>>>(x, ld, K, work, given, q,
                                                    scale);
  return cudaGetLastError();
}

template <typename OutT>
__device__ __forceinline__ OutT from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Q2: out[r, c] for 4-column groups, grid-stride. Row r of the (R, N)
// output reads accumulator row (i0, i1, i2) = (r / (d1 d2), r / d2 % d1,
// r % d2) at i0 s0 + i1 s1 + i2 s2, and the row scale xs[r / xs_div].
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int* __restrict__ acc, long long d1, long long d2,
                   long long s0, long long s1, long long s2, long long R,
                   int N, const float* __restrict__ xs, long long xs_div,
                   const float* __restrict__ ws,
                   const float* __restrict__ bias, int cast_first,
                   OutT* __restrict__ out) {
  const int groups = N / 4;
  const long long total = R * groups;
  for (long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       item < total; item += (long long)gridDim.x * blockDim.x) {
    const long long r = item / groups;
    const int c = static_cast<int>(item - r * groups) * 4;
    const long long i0 = r / (d1 * d2);
    const long long rem = r - i0 * d1 * d2;
    const long long i1 = rem / d2;
    const long long i2 = rem - i1 * d2;
    const int4 a = *reinterpret_cast<const int4*>(acc + i0 * s0 + i1 * s1 +
                                                  i2 * s2 + c);
    const float x = xs[r / xs_div];
    const float av[4] = {__int2float_rn(a.x), __int2float_rn(a.y),
                         __int2float_rn(a.z), __int2float_rn(a.w)};
    Vec<OutT, 4> o;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t = __fmul_rn(__fmul_rn(av[j], x), ws[c + j]);
      if (cast_first) t = to_f32(from_f32<OutT>(t));
      if (bias != nullptr) t = __fadd_rn(t, bias[c + j]);
      o.v[j] = from_f32<OutT>(t);
    }
    *reinterpret_cast<Vec<OutT, 4>*>(out + r * N + c) = o;
  }
}

template <typename OutT>
cudaError_t launch_dequant(const int* acc, long long d0, long long d1,
                           long long d2, long long s0, long long s1,
                           long long s2, int N, const float* xs,
                           long long xs_div, const float* ws,
                           const float* bias, int cast_first, void* out,
                           cudaStream_t s) {
  const long long R = d0 * d1 * d2;
  if (R <= 0 || N <= 0) return cudaSuccess;
  if (N % 4 || s0 % 4 || s1 % 4 || s2 % 4 || xs_div <= 0 ||
      reinterpret_cast<uintptr_t>(acc) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  const long long work = R * (N / 4);
  const long long blocks = (work + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
  dequant_kernel<OutT><<<grid, kThreads, 0, s>>>(
      acc, d1, d2, s0, s1, s2, R, N, xs, xs_div, ws, bias, cast_first,
      static_cast<OutT*>(out));
  return cudaGetLastError();
}

}  // namespace

// Q1. x: R rows of K elements of `dtype` (0 float32, 1 bfloat16), row i at
// x + i * ld elements, 16-byte aligned, K and ld multiples of 16 bytes'
// worth of elements. q: (R, K) int8, contiguous. given: one f32 scale for
// every row, or null for per-row scales written to scale (R,). work: R
// unsigned of scratch for rows longer than 4096 elements (R at most 65535
// then). Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a layout it does not take).
extern "C" int e3d_quantize_rows(const void* x, long long ld, long long R,
                                 long long K, int dtype, const void* given,
                                 void* q, void* scale, void* work,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(given);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  unsigned* wp = static_cast<unsigned*>(work);
  switch (dtype) {
    case 0:
      return launch_quantize<float>(x, ld, R, K, g, qp, sp, wp, s);
    case 1:
      return launch_quantize<bf16>(x, ld, R, K, g, qp, sp, wp, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Q2. acc: int32 rows of N (a multiple of 4) with unit column stride, row
// (i0, i1, i2) of the (d0, d1, d2) row grid at i0 s0 + i1 s1 + i2 s2
// elements (strides multiples of 4, 16-byte aligned base). xs: f32 row
// scales, row r takes xs[r / xs_div]; ws: (N,) f32; bias: (N,) f32 or
// null; cast_first rounds the product to the output type before the bias.
// out: (d0 d1 d2, N) contiguous of `out_dtype` (0 float32, 1 bfloat16).
extern "C" int e3d_dequant(const void* acc, long long d0, long long d1,
                           long long d2, long long s0, long long s1,
                           long long s2, int N, const void* xs,
                           long long xs_div, const void* ws, const void* bias,
                           int cast_first, int out_dtype, void* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(acc);
  const float* x = static_cast<const float*>(xs);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  switch (out_dtype) {
    case 0:
      return launch_dequant<float>(a, d0, d1, d2, s0, s1, s2, N, x, xs_div, w,
                                   b, cast_first, out, s);
    case 1:
      return launch_dequant<bf16>(a, d0, d1, d2, s0, s1, s2, N, x, xs_div, w,
                                  b, cast_first, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}
