// Flash-attention forward for the ViT encoder (kernel K1), Hopper sm_90a.
//
// Replaces the TPU kernel ops/flash_attention.py::_fwd_kernel /
// _fwd_one_head of the JAX package. Per (batch, head) it computes
//   S   = Q K^T / sqrt(D)            (bf16 operands, f32 accumulation)
//   S[:, j] = -1e30 for key j >= N   (ragged key edge, masked by index)
//   O   = (bf16(P) V) / l,  P = exp(S - m),  m = rowmax S,  l = sum P
//   LSE = m + log l
// with O written as (B, N, H, D) bf16 and LSE as (B, H, N) f32.
//
// Design. The TPU kernel keeps a head's whole K and V resident in VMEM.
// At N = 1370, D = 64 that is 351 KB, more than the 227 KB a block can
// have, so here K and V stream through shared memory in tiles of 64 keys
// with an online softmax: a running row max m, a running sum l, and a
// rescale of the f32 O accumulator whenever m grows. One block of four
// warps owns one (batch*head, 64-query tile); each warp owns 16 query
// rows, and nothing is carried across blocks. Q, K and V are read through
// explicit strides, so the caller passes views of the packed qkv
// projection (B, N, 3, H, D) without copies; rows past N are zero-filled
// in shared memory, and no padding to a block multiple exists anywhere.
// The products run on the tensor cores through mma.sync m16n8k16 (bf16
// in, f32 accumulate) fed by ldmatrix; the next K/V tile is fetched with
// cp.async while the current one is consumed (two stages). As on the TPU,
// P is rounded to bf16 before the PV product and the division by l happens
// after it, in f32.
//
// Bound at the flagship shape (B 8, N 1370, H 16, D 64), per launch:
//   4 B H N^2 D = 61.5 GFLOP of tensor-core work -> 62 us at 989 TFLOP/s;
//   Q, K, V, O = 4 x 22.4 MB = 90 MB             -> 27 us at 3.35 TB/s;
//   B H N^2 = 240 M exponentials, of the same order as the FLOP time on
//   the special-function units.
// So the kernel is compute-bound, about 60 us at best, and a vitl forward
// launches it 24 times. This first version uses mma.sync, not wgmma/TMA,
// and no warp specialisation; those come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per shared-memory tile
constexpr int kWarps = 4;     // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of a (rows, D) strided slab into a padded
// shared tile; rows >= n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    const bf16* g = src + (long long)(valid ? row : 0) * row_stride + c * 8;
    cp_async_16(tile + r * kStride + c * 8, g, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int n_tok, int n_heads,
                      long long q_sb, long long q_sn, long long q_sh,
                      long long k_sb, long long k_sn, long long k_sh,
                      long long v_sb, long long v_sn, long long v_sh,
                      float scale_log2) {
  // Row pitch D + 8 keeps ldmatrix's eight 16-byte row reads on distinct
  // banks and every row 16-byte aligned.
  constexpr int kStride = D + 8;
  constexpr int kDSteps = D / 16;        // k-steps of Q K^T
  constexpr int kDTiles = D / 8;         // n-tiles of P V
  constexpr int kKeyTiles = kBlockN / 8; // n-tiles of Q K^T
  constexpr int kKeySteps = kBlockN / 16;

  __shared__ __align__(16) bf16 s_q[kBlockM * kStride];
  __shared__ __align__(16) bf16 s_k[2][kBlockN * kStride];
  __shared__ __align__(16) bf16 s_v[2][kBlockN * kStride];

  const int n_qtiles = (n_tok + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockM;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row within the warp's 8-row half
  const int t = lane % 4;  // accumulator column pair

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_tile<D>(s_q, qb, q_sn, q0, n_tok);
  load_tile<D>(s_k[0], kb, k_sn, 0, n_tok);
  load_tile<D>(s_v[0], vb, v_sn, 0, n_tok);
  cp_async_commit();

  uint32_t q_frag[kDSteps][4];
  float o_acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  }
  // Rows g and g + 8 of this warp's 16; m is kept in the log2 domain.
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};  // this lane's share of l

  const int n_ktiles = (n_tok + kBlockN - 1) / kBlockN;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_ktiles) {
      load_tile<D>(s_k[stage ^ 1], kb, k_sn, (kt + 1) * kBlockN, n_tok);
      load_tile<D>(s_v[stage ^ 1], vb, v_sn, (kt + 1) * kBlockN, n_tok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        ldmatrix_x4(q_frag[kk], s_q + (warp * 16 + lane % 16) * kStride +
                                    kk * 16 + (lane / 16) * 8);
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    const bf16* sk = s_k[stage];
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; j += 2) {
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sk + (j * 8 + (lane / 16) * 8 + lane % 8) * kStride +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[j], q_frag[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], q_frag[kk], kf[2], kf[3]);
      }
    }

    // Scale into the log2 domain, mask keys >= N, update the row max.
    const int key0 = kt * kBlockN;
    float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * t + (e & 1);
        const float x = key < n_tok ? s[j][e] * scale_log2 : kMaskValue;
        s[j][e] = x;
        m_new[e / 2] = fmaxf(m_new[e / 2], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m_row[r] - m_new[r]);
      m_row[r] = m_new[r];
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }

    // P = exp(S - m): l sums the f32 values, the PV product takes bf16(P).
    // The accumulator layout of key tiles 2kk and 2kk+1 is exactly the A
    // operand layout of k-step kk.
    uint32_t p_frag[kKeySteps][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      const float p0 = exp2f(s[j][0] - m_row[0]);
      const float p1 = exp2f(s[j][1] - m_row[0]);
      const float p2 = exp2f(s[j][2] - m_row[1]);
      const float p3 = exp2f(s[j][3] - m_row[1]);
      l_part[0] += p0 + p1;
      l_part[1] += p2 + p3;
      p_frag[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      p_frag[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V.
    const bf16* sv = s_v[stage];
#pragma unroll
    for (int kk = 0; kk < kKeySteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                       kStride + j * 8 + (lane / 16) * 8);
        mma_bf16(o_acc[j], p_frag[kk], vf[0], vf[1]);
        mma_bf16(o_acc[j + 1], p_frag[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_part[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= n_tok) continue;
    bf16* orow = o + (((long long)b * n_tok + row[r]) * n_heads + h) * D;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(o_acc[j][2 * r] / l[r], o_acc[j][2 * r + 1] / l[r]);
    }
    if (t == 0) {
      lse[(long long)bh * n_tok + row[r]] = m_row[r] * kLn2 + logf(l[r]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int n_tok, int n_heads,
                   const long long* qs, const long long* ks,
                   const long long* vs, float scale, cudaStream_t stream) {
  const long long n_qtiles = (n_tok + kBlockM - 1) / kBlockM;
  const long long blocks = (long long)batch * n_heads * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_attn_fwd_kernel<D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), n_tok, n_heads, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 with unit stride on D and element strides
// (batch, token, head) given; o: contiguous (B, N, H, D) bf16; lse:
// contiguous (B, H, N) f32. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported D).
extern "C" int e3d_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_tok, int n_heads, int head_dim, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    float scale, void* stream) {
  const long long qs[3] = {q_sb, q_sn, q_sh};
  const long long ks[3] = {k_sb, k_sn, k_sh};
  const long long vs[3] = {v_sb, v_sn, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, o, lse, batch, n_tok, n_heads, qs, ks, vs,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, o, lse, batch, n_tok, n_heads, qs, ks, vs,
                        scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
