// Flash-attention forward for the ViT encoder, Hopper sm_90a: kernel K1
// and its two schedule variants K4 (paired heads) and K5 (head-looped).
//
// All three compute, per (batch, head),
//   S   = Q K^T / sqrt(D)            (bf16 operands, f32 accumulation)
//   S[:, j] = -1e30 for key j >= N   (ragged key edge, masked by index)
//   O   = (bf16(P) V) / l,  P = exp(S - m),  m = rowmax S,  l = sum P
//   LSE = m + log l
// with O written as (B, N, H, D) bf16 and LSE as (B, H, N) f32. Each warp
// owns 16 query rows of one head and runs the same per-tile code
// (tile_scores, tile_softmax_pv, store_rows), so the three kernels give
// bit-identical O and LSE; they differ only in which heads a block owns
// and in how its copies overlap its arithmetic.
//
// K1 replaces ops/flash_attention.py::_fwd_kernel / _fwd_one_head of the
// JAX package. The TPU kernel keeps a head's whole K and V resident in
// VMEM. At N = 1370, D = 64 that is 351 KB, more than the 227 KB a block
// can have, so here K and V stream through shared memory in tiles of 64
// keys with an online softmax: a running row max m, a running sum l, and a
// rescale of the f32 O accumulator whenever m grows. One block of four
// warps owns one (batch*head, 64-query tile); nothing is carried across
// blocks. Q, K and V are read through explicit strides, so the caller
// passes views of the packed qkv projection (B, N, 3, H, D) without
// copies; rows past N are zero-filled in shared memory, and no padding to
// a block multiple exists anywhere. The products run on the tensor cores
// through mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix;
// the next K/V tile is fetched with cp.async while the current one is
// consumed (two stages). As on the TPU, P is rounded to bf16 before the PV
// product and the division by l happens after it, in f32.
//
// K4 replaces _fwd_pair / _fwd_pair_kernel (E3D_FLASH_PAIR=1). On the TPU
// two heads share one program so that the score product, made block
// diagonal, fills the MXU's 128-deep contraction; on Hopper that trick
// would double the FLOPs, so it is not copied. What pairing buys here is
// the load: heads 2p and 2p+1 of the flattened B*H axis sit side by side
// in the packed projection, so one block of eight warps (four per head)
// fetches each K and V tile of both heads as one 64-row x 2*D*2-byte
// cp.async copy, and the two heads' arithmetic is K1's.
//
// K5 replaces _fwd_kernel with hb heads per program under E3D_FLASH_PIPE=1
// (_fwd_kernel_pipe / _fwd_scores / _fwd_finish) and E3D_FLASH_HLOOP=1
// (the fori_loop over heads). One block of four warps owns (a block of hb
// consecutive heads of the B*H axis, a 64-query tile) and walks its heads'
// key tiles as one stream. kPipe = true: head h+1's Q and first K/V tile
// are already in flight by cp.async while head h's last tile is consumed,
// and head h+1's first Q K^T is started before head h's last softmax, PV
// and normalisation. kPipe = false (HLOOP): the same loop, but a head's
// first tile is fetched only once the previous head is written.
//
// Bound at the flagship shape (B 8, N 1370, H 16, D 64), per launch, the
// same for the three:
//   4 B H N^2 D = 61.5 GFLOP of tensor-core work -> 62 us at 989 TFLOP/s;
//   Q, K, V, O = 4 x 22.4 MB = 90 MB             -> 27 us at 3.35 TB/s;
//   B H N^2 = 240 M exponentials, of the same order as the FLOP time on
//   the special-function units.
// So they are compute-bound, about 60 us at best, and a vitl forward
// launches one of them 24 times. These first versions use mma.sync, not
// wgmma/TMA, and no warp specialisation; those come later. What limits
// them now is how many warps an SM holds: the register file. So K4 and K5
// ask ptxas (__launch_bounds__) for two 8-warp blocks, or three (pipelined)
// and four (looped) 4-warp blocks per SM, trading a few spills for warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block (per head)
constexpr int kBlockN = 64;   // keys per shared-memory tile
constexpr int kWarps = 4;     // warps per head; each owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTiles = kBlockN / 8;  // n-tiles of Q K^T
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

// Row pitch D + 8 keeps ldmatrix's eight 16-byte row reads on distinct
// banks and every row 16-byte aligned.
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;
  static constexpr int kElems = kBlockM * kStride;  // one 64-row tile
  static constexpr int kBytes = kElems * 2;
};

// Copy rows [row0, row0 + 64) of a (rows, D) strided slab into a padded
// shared tile with a block's four warps; rows >= n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    const bf16* g = src + (long long)(valid ? row : 0) * row_stride + c * 8;
    cp_async_16(tile + r * Tile<D>::kStride + c * 8, g, valid);
  }
}

// The same rows of two heads into two consecutive tiles, by all 256
// threads of a K4 block. Chunks run head-fastest within a row, so where
// the two heads are adjacent in memory (the packed projection) a row of
// both is one contiguous 2*D*2-byte segment.
template <int D>
__device__ __forceinline__ void load_pair_tile(bf16* tiles, const bf16* src0,
                                               const bf16* src1,
                                               long long row_stride, int row0,
                                               int n_rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBlockN * 2 * kChunks; i += 2 * kThreads) {
    const int r = i / (2 * kChunks);
    const int hd = (i / kChunks) % 2;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    const bf16* g = (hd ? src1 : src0) +
                    (long long)(valid ? row : 0) * row_stride + c * 8;
    cp_async_16(tiles + hd * Tile<D>::kElems + r * Tile<D>::kStride + c * 8,
                g, valid);
  }
}

// One warp's running state for its 16 query rows of one head.
template <int D>
struct WarpState {
  static constexpr int kDSteps = D / 16;  // k-steps of Q K^T
  static constexpr int kDTiles = D / 8;   // n-tiles of P V
  uint32_t q[kDSteps][4];
  float o[kDTiles][4];
  // Rows g and g + 8 of the warp's 16; m is kept in the log2 domain.
  float m[2];
  float l[2];  // this lane's share of l

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    }
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

// The warp's Q fragments (rows row0 .. row0 + 15 of the tile).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&q)[D / 16][4],
                                       const bf16* s_q, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(q[kk], s_q + (row0 + lane % 16) * Tile<D>::kStride + kk * 16 +
                           (lane / 16) * 8);
  }
}

// S = Q K^T for the warp's 16 rows and the tile's 64 keys.
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[kKeyTiles][4],
                                            const uint32_t (&q)[D / 16][4],
                                            const bf16* sk, int lane) {
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kKeyTiles; j += 2) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sk + (j * 8 + (lane / 16) * 8 + lane % 8) *
                               Tile<D>::kStride +
                           kk * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(s[j], q[kk], kf[0], kf[1]);
      mma_bf16(s[j + 1], q[kk], kf[2], kf[3]);
    }
  }
}

// Online-softmax update with one tile's scores, then O += bf16(P) V. The
// running sum l and the LSE are rounded operation by operation (the _rn
// intrinsics), so the compiler contracts them alike in every kernel and
// K1, K4 and K5 give bit-identical LSE.
template <int D>
__device__ __forceinline__ void tile_softmax_pv(WarpState<D>& st,
                                                float (&s)[kKeyTiles][4],
                                                const bf16* sv, int key0,
                                                int n_tok, float scale_log2,
                                                int lane) {
  constexpr int kKeySteps = kBlockN / 16;
  const int t = lane % 4;  // accumulator column pair
  // Scale into the log2 domain, mask keys >= N, update the row max.
  float m_new[2] = {st.m[0], st.m[1]};
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
    alpha[r] = exp2f(st.m[r] - m_new[r]);
    st.m[r] = m_new[r];
    st.l[r] = __fmul_rn(st.l[r], alpha[r]);
  }
#pragma unroll
  for (int j = 0; j < WarpState<D>::kDTiles; ++j) {
    st.o[j][0] *= alpha[0];
    st.o[j][1] *= alpha[0];
    st.o[j][2] *= alpha[1];
    st.o[j][3] *= alpha[1];
  }

  // P = exp(S - m): l sums the f32 values, the PV product takes bf16(P).
  // The accumulator layout of key tiles 2kk and 2kk+1 is exactly the A
  // operand layout of k-step kk.
  uint32_t p_frag[kKeySteps][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    const float p0 = exp2f(s[j][0] - st.m[0]);
    const float p1 = exp2f(s[j][1] - st.m[0]);
    const float p2 = exp2f(s[j][2] - st.m[1]);
    const float p3 = exp2f(s[j][3] - st.m[1]);
    st.l[0] = __fadd_rn(st.l[0], __fadd_rn(p0, p1));
    st.l[1] = __fadd_rn(st.l[1], __fadd_rn(p2, p3));
    p_frag[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
    p_frag[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }

  // O += P V.
#pragma unroll
  for (int kk = 0; kk < kKeySteps; ++kk) {
#pragma unroll
    for (int j = 0; j < WarpState<D>::kDTiles; j += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sv + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                     Tile<D>::kStride +
                                 j * 8 + (lane / 16) * 8);
      mma_bf16(st.o[j], p_frag[kk], vf[0], vf[1]);
      mma_bf16(st.o[j + 1], p_frag[kk], vf[2], vf[3]);
    }
  }
}

// Normalise and write the warp's rows row0 .. row0 + 15 of head (b, h):
// O into contiguous (B, N, H, D), LSE into contiguous (B, H, N).
template <int D>
__device__ __forceinline__ void store_rows(const WarpState<D>& st,
                                           bf16* __restrict__ o,
                                           float* __restrict__ lse, int b,
                                           int h, int n_tok, int n_heads,
                                           int row0, int lane) {
  const int g = lane / 4;  // accumulator row within the warp's 8-row half
  const int t = lane % 4;
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = st.l[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row[2] = {row0 + g, row0 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= n_tok) continue;
    bf16* orow = o + (((long long)b * n_tok + row[r]) * n_heads + h) * D;
#pragma unroll
    for (int j = 0; j < WarpState<D>::kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(st.o[j][2 * r] / l[r], st.o[j][2 * r + 1] / l[r]);
    }
    if (t == 0) {
      lse[((long long)b * n_heads + h) * n_tok + row[r]] =
          __fadd_rn(__fmul_rn(st.m[r], kLn2), logf(l[r]));
    }
  }
}

struct Strides {
  long long q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh;
};

// ---------------------------------------------------------------- K1

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int n_tok, int n_heads,
                      Strides st_, float scale_log2) {
  __shared__ __align__(16) bf16 s_q[Tile<D>::kElems];
  __shared__ __align__(16) bf16 s_k[2][Tile<D>::kElems];
  __shared__ __align__(16) bf16 s_v[2][Tile<D>::kElems];

  const int n_qtiles = (n_tok + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockM;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const bf16* qb = q + b * st_.q_sb + h * st_.q_sh;
  const bf16* kb = k + b * st_.k_sb + h * st_.k_sh;
  const bf16* vb = v + b * st_.v_sb + h * st_.v_sh;

  load_tile<D>(s_q, qb, st_.q_sn, q0, n_tok);
  load_tile<D>(s_k[0], kb, st_.k_sn, 0, n_tok);
  load_tile<D>(s_v[0], vb, st_.v_sn, 0, n_tok);
  cp_async_commit();

  WarpState<D> st;
  st.reset();
  const int n_ktiles = (n_tok + kBlockN - 1) / kBlockN;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_ktiles) {
      load_tile<D>(s_k[stage ^ 1], kb, st_.k_sn, (kt + 1) * kBlockN, n_tok);
      load_tile<D>(s_v[stage ^ 1], vb, st_.v_sn, (kt + 1) * kBlockN, n_tok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) load_q<D>(st.q, s_q, warp * 16, lane);
    float s[kKeyTiles][4];
    tile_scores<D>(s, st.q, s_k[stage], lane);
    tile_softmax_pv<D>(st, s, s_v[stage], kt * kBlockN, n_tok, scale_log2,
                       lane);
    __syncthreads();  // the next iteration refills this stage
  }
  store_rows<D>(st, o, lse, b, h, n_tok, n_heads, q0 + warp * 16, lane);
}

// ---------------------------------------------------------------- K4

// Dynamic shared memory: Q of both heads, then two stages of K (both
// heads), then two stages of V.
template <int D>
constexpr int pair_smem_bytes() {
  return 10 * Tile<D>::kBytes;
}

template <int D>
__global__ void __launch_bounds__(2 * kThreads, 2)
flash_attn_fwd_pair_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int n_tok, int n_heads,
                           Strides st_, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = Tile<D>::kElems;
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // [head][tile]
  bf16* s_k = s_q + 2 * kT;                   // [stage][head][tile]
  bf16* s_v = s_k + 4 * kT;

  const int n_qtiles = (n_tok + kBlockM - 1) / kBlockM;
  const int pair = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hd = warp / kWarps;      // which head of the pair
  const int row0 = (warp % kWarps) * 16;

  // Heads 2 pair and 2 pair + 1 of the flattened B*H axis (they may lie
  // in two batch rows when H is odd).
  int bs[2], hs[2];
  const bf16 *qb[2], *kb[2], *vb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int bh = 2 * pair + j;
    bs[j] = bh / n_heads;
    hs[j] = bh % n_heads;
    qb[j] = q + bs[j] * st_.q_sb + hs[j] * st_.q_sh;
    kb[j] = k + bs[j] * st_.k_sb + hs[j] * st_.k_sh;
    vb[j] = v + bs[j] * st_.v_sb + hs[j] * st_.v_sh;
  }

  load_pair_tile<D>(s_q, qb[0], qb[1], st_.q_sn, q0, n_tok);
  load_pair_tile<D>(s_k, kb[0], kb[1], st_.k_sn, 0, n_tok);
  load_pair_tile<D>(s_v, vb[0], vb[1], st_.v_sn, 0, n_tok);
  cp_async_commit();

  WarpState<D> st;
  st.reset();
  const int n_ktiles = (n_tok + kBlockN - 1) / kBlockN;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_ktiles) {
      const int next = (stage ^ 1) * 2 * kT;
      load_pair_tile<D>(s_k + next, kb[0], kb[1], st_.k_sn,
                        (kt + 1) * kBlockN, n_tok);
      load_pair_tile<D>(s_v + next, vb[0], vb[1], st_.v_sn,
                        (kt + 1) * kBlockN, n_tok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) load_q<D>(st.q, s_q + hd * kT, row0, lane);
    const int tile = (stage * 2 + hd) * kT;
    float s[kKeyTiles][4];
    tile_scores<D>(s, st.q, s_k + tile, lane);
    tile_softmax_pv<D>(st, s, s_v + tile, kt * kBlockN, n_tok, scale_log2,
                       lane);
    __syncthreads();
  }
  store_rows<D>(st, o, lse, bs[hd], hs[hd], n_tok, n_heads, q0 + row0, lane);
}

// ---------------------------------------------------------------- K5

// Dynamic shared memory: Q by head parity (two), two stages of K, two of V.
template <int D>
constexpr int heads_smem_bytes() {
  return 6 * Tile<D>::kBytes;
}

template <int D, bool kPipe>
__global__ void __launch_bounds__(kThreads, kPipe ? 3 : 4)
flash_attn_fwd_heads_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            float* __restrict__ lse, int n_tok, int n_heads,
                            int hb, Strides st_, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = Tile<D>::kElems;
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // [head parity][tile]
  bf16* s_k = s_q + 2 * kT;                   // [stage][tile]
  bf16* s_v = s_k + 2 * kT;

  const int n_qtiles = (n_tok + kBlockM - 1) / kBlockM;
  const int head0 = (blockIdx.x / n_qtiles) * hb;  // first head of B*H
  const int q0 = (blockIdx.x % n_qtiles) * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_ktiles = (n_tok + kBlockN - 1) / kBlockN;
  const int n_steps = hb * n_ktiles;  // (head, key tile) in one stream

  // Step t's K and V tile into stage t & 1, and its head's Q with the
  // head's first tile; one commit group per step.
  auto fetch = [&](int t) {
    const int hh = t / n_ktiles;
    const int kt = t % n_ktiles;
    const int bh = head0 + hh;
    const int b = bh / n_heads;
    const int h = bh % n_heads;
    if (kt == 0) {
      load_tile<D>(s_q + (hh & 1) * kT, q + b * st_.q_sb + h * st_.q_sh,
                   st_.q_sn, q0, n_tok);
    }
    load_tile<D>(s_k + (t & 1) * kT, k + b * st_.k_sb + h * st_.k_sh,
                 st_.k_sn, kt * kBlockN, n_tok);
    load_tile<D>(s_v + (t & 1) * kT, v + b * st_.v_sb + h * st_.v_sh,
                 st_.v_sn, kt * kBlockN, n_tok);
    cp_async_commit();
  };

  WarpState<D> st;
  st.reset();
  float s[kKeyTiles][4];
  bool have_s = false;  // kPipe: the head's first scores are already done
  fetch(0);
  for (int t = 0; t < n_steps; ++t) {
    const int hh = t / n_ktiles;
    const int kt = t % n_ktiles;
    const int stage = t & 1;
    const bool last = kt == n_ktiles - 1;
    const bool more = t + 1 < n_steps;
    if (!kPipe && kt == 0 && t > 0) fetch(t);
    if (more && (kPipe || !last)) {
      fetch(t + 1);
      // At a head's last tile the pipelined loop needs the next head's
      // first tile too.
      if (kPipe && last) {
        cp_async_wait<0>();
      } else {
        cp_async_wait<1>();
      }
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!have_s) {
      if (kt == 0) load_q<D>(st.q, s_q + (hh & 1) * kT, warp * 16, lane);
      tile_scores<D>(s, st.q, s_k + stage * kT, lane);
    }
    have_s = false;
    if (kPipe && last && more) {
      // Head hh + 1: its Q K^T on the tensor cores before this head's
      // softmax, PV and normalisation.
      uint32_t q_next[D / 16][4];
      float s_next[kKeyTiles][4];
      load_q<D>(q_next, s_q + ((hh + 1) & 1) * kT, warp * 16, lane);
      tile_scores<D>(s_next, q_next, s_k + (stage ^ 1) * kT, lane);
      tile_softmax_pv<D>(st, s, s_v + stage * kT, kt * kBlockN, n_tok,
                         scale_log2, lane);
      const int bh = head0 + hh;
      store_rows<D>(st, o, lse, bh / n_heads, bh % n_heads, n_tok, n_heads,
                    q0 + warp * 16, lane);
      st.reset();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st.q[kk][e] = q_next[kk][e];
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s_next[j][e];
      }
      have_s = true;
    } else {
      tile_softmax_pv<D>(st, s, s_v + stage * kT, kt * kBlockN, n_tok,
                         scale_log2, lane);
      if (last) {
        const int bh = head0 + hh;
        store_rows<D>(st, o, lse, bh / n_heads, bh % n_heads, n_tok, n_heads,
                      q0 + warp * 16, lane);
        st.reset();
      }
    }
    __syncthreads();  // the next steps refill this stage and Q buffer
  }
}

// ---------------------------------------------------------------- launch

enum Variant { kK1 = 0, kK4 = 1, kK5Pipe = 2, kK5Loop = 3 };

// Dynamic shared memory above 48 KB only after opting in (per kernel and
// device; set before every launch, a host-side call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch(Variant variant, const void* q, const void* k,
                   const void* v, void* o, void* lse, int batch, int n_tok,
                   int n_heads, int hb, const Strides& strides, float scale,
                   cudaStream_t stream) {
  const long long n_qtiles = (n_tok + kBlockM - 1) / kBlockM;
  const long long bh = (long long)batch * n_heads;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  switch (variant) {
    case kK1: {
      const long long blocks = bh * n_qtiles;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
      flash_attn_fwd_kernel<D><<<(unsigned)blocks, kThreads, 0, stream>>>(
          qp, kp, vp, op, lp, n_tok, n_heads, strides, scale_log2);
      break;
    }
    case kK4: {
      if (bh % 2) return cudaErrorInvalidValue;
      const long long blocks = bh / 2 * n_qtiles;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
      constexpr int bytes = pair_smem_bytes<D>();
      err = allow_smem(flash_attn_fwd_pair_kernel<D>, bytes);
      if (err != cudaSuccess) return err;
      flash_attn_fwd_pair_kernel<D>
          <<<(unsigned)blocks, 2 * kThreads, bytes, stream>>>(
              qp, kp, vp, op, lp, n_tok, n_heads, strides, scale_log2);
      break;
    }
    case kK5Pipe:
    case kK5Loop: {
      if (hb < 1 || bh % hb) return cudaErrorInvalidValue;
      const long long blocks = bh / hb * n_qtiles;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
      constexpr int bytes = heads_smem_bytes<D>();
      if (variant == kK5Pipe) {
        err = allow_smem(flash_attn_fwd_heads_kernel<D, true>, bytes);
        if (err != cudaSuccess) return err;
        flash_attn_fwd_heads_kernel<D, true>
            <<<(unsigned)blocks, kThreads, bytes, stream>>>(
                qp, kp, vp, op, lp, n_tok, n_heads, hb, strides, scale_log2);
      } else {
        err = allow_smem(flash_attn_fwd_heads_kernel<D, false>, bytes);
        if (err != cudaSuccess) return err;
        flash_attn_fwd_heads_kernel<D, false>
            <<<(unsigned)blocks, kThreads, bytes, stream>>>(
                qp, kp, vp, op, lp, n_tok, n_heads, hb, strides, scale_log2);
      }
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int dispatch(Variant variant, const void* q, const void* k, const void* v,
             void* o, void* lse, int batch, int n_tok, int n_heads,
             int head_dim, int hb, long long q_sb, long long q_sn,
             long long q_sh, long long k_sb, long long k_sn, long long k_sh,
             long long v_sb, long long v_sn, long long v_sh, float scale,
             void* stream) {
  const Strides strides = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(variant, q, k, v, o, lse, batch, n_tok, n_heads, hb,
                        strides, scale, s);
    case 64:
      return launch<64>(variant, q, k, v, o, lse, batch, n_tok, n_heads, hb,
                        strides, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 with unit stride on D and element strides
// (batch, token, head) given; o: contiguous (B, N, H, D) bf16; lse:
// contiguous (B, H, N) f32. Each entry launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported D, an odd B*H for K4, or an hb that does not divide B*H).

// K1: one block per (head, query tile).
extern "C" int e3d_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_tok, int n_heads, int head_dim, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    float scale, void* stream) {
  return dispatch(kK1, q, k, v, o, lse, batch, n_tok, n_heads, head_dim, 1,
                  q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                  scale, stream);
}

// K4: one block per (pair of heads of the B*H axis, query tile).
extern "C" int e3d_flash_attn_fwd_pair(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_tok, int n_heads, int head_dim, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    float scale, void* stream) {
  return dispatch(kK4, q, k, v, o, lse, batch, n_tok, n_heads, head_dim, 2,
                  q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                  scale, stream);
}

// K5: one block per (hb consecutive heads of the B*H axis, query tile);
// pipe != 0 overlaps each head's end with the next head's start.
extern "C" int e3d_flash_attn_fwd_heads(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_tok, int n_heads, int head_dim, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    float scale, int hb, int pipe, void* stream) {
  return dispatch(pipe ? kK5Pipe : kK5Loop, q, k, v, o, lse, batch, n_tok,
                  n_heads, head_dim, hb, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                  v_sb, v_sn, v_sh, scale, stream);
}
