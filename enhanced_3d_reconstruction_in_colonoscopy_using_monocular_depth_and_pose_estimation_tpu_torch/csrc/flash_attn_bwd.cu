// Flash-attention backward for the ViT encoder, Hopper sm_90a: kernel K2
// (fused, one pass over key blocks) and kernel K3 (split into a dQ pass
// and a dK/dV pass).
//
// Replaces the TPU kernels of the JAX package's ops/flash_attention.py:
//   K2  _bwd_fused / _bwd_fused_kernel              (the default backward)
//   K3  _bwd / _bwd_dq_kernel + _bwd_dkv_kernel     (E3D_FLASH_BWD_FUSED=0)
// Per (batch, head), from q, k, v, dO (B, N, H, D) bf16, the forward's
// natural-log LSE (B, H, N) f32 and delta = rowsum(dO * O) (B, H, N) f32:
//   P  = exp(Q K^T * scale - LSE)           (f32, recomputed)
//   dV = bf16(P)^T dO
//   dS = P * (dO V^T - delta)               (f32)
//   dK = bf16(dS)^T Q * scale
//   dQ = bf16(dS) K * scale
// As on the TPU, P and dS are rounded to bf16 before the products that
// consume them and every product accumulates in f32. Key columns and
// query rows at or past N are masked by index (their tiles are zero-filled
// by cp.async with a source size of 0), and only rows < N are written, so
// no caller pads the token axis.
//
// Design. The TPU kernels hold a whole head's Q and dO (or K and V) in
// VMEM and carry dQ across a sequential key-block grid. A Hopper block has
// 227 KB of shared memory and blocks run in parallel in no order, so:
//   - The dK/dV pass (K2, and K3's second kernel) gives one block of four
//     warps to one (batch*head, 64-key block). Each warp owns 16 key rows
//     and keeps their dK and dV in f32 registers while 64-query tiles of
//     Q, dO, LSE and delta stream through shared memory (two stages,
//     cp.async). Each tile recomputes P^T and dS^T once.
//   - K2 also needs dQ, a sum over key blocks. Each block stores its
//     bf16(dS^T) tile in shared memory, forms the tile's dQ share with one
//     more product, and adds it into an f32 (B, N, H, D) scratch with
//     atomicAdd; the caller zeroes the scratch and casts it to bf16. The
//     order of the atomics changes from run to run, so dQ may differ from
//     one run to the next by f32 rounding (about 1e-7 relative before the
//     bf16 cast, at most one bf16 ulp after it).
//   - K3's dQ kernel gives one block to one (batch*head, 64-query block)
//     and streams key tiles of K and V, recomputing P a second time. It
//     has no atomics and is deterministic: 7 score-sized products against
//     K2's 5, by design.
// All products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
// f32 accumulate) fed by ldmatrix, as in flash_attn_fwd.cu.
//
// Bound at the flagship shape (B 8, N 1370, H 16, D 64), per backward:
//   5 score-sized products x 2 B H N^2 D = 153.8 GFLOP -> 156 us at
//   989 TFLOP/s; q, k, v, dO, dq, dk, dv (bf16) and LSE, delta (f32):
//   about 181 MB -> 54 us at 3.35 TB/s. Compute-bound; K3 is held to the
//   same bound (it computes the same function). This first version uses
//   mma.sync, not wgmma/TMA, and no warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // queries per tile
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;    // each warp owns 16 rows of the block's 64
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; valid = false zero-fills the destination.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// 4-byte async copy; valid = false zero-fills the destination.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// Fragment helpers. A shared tile is 64 rows of D (or 64) bf16 at a row
// pitch of kStride = width + 8 elements, which keeps ldmatrix's eight
// 16-byte row reads on distinct banks.
//
// A operand (16x16, rows m, cols k) of a tile stored [m][k].
template <int kStride>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile,
                                       int row0, int col0, int lane) {
  ldmatrix_x4(r, tile + (row0 + lane % 16) * kStride + col0 + (lane / 16) * 8);
}

// A operand (16x16, rows m, cols k) of a tile stored transposed, [k][m].
template <int kStride>
__device__ __forceinline__ void load_a_trans(uint32_t (&r)[4],
                                             const bf16* tile, int m0, int k0,
                                             int lane) {
  ldmatrix_x4_trans(r, tile + (k0 + (lane / 16) * 8 + lane % 8) * kStride +
                           m0 + ((lane / 8) % 2) * 8);
}

// B operands of n-tiles n0/8 and n0/8 + 1 (k-step at k0) of a tile stored
// [n][k]: r[0], r[1] for the first, r[2], r[3] for the second.
template <int kStride>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile,
                                       int n0, int k0, int lane) {
  ldmatrix_x4(r, tile + (n0 + (lane / 16) * 8 + lane % 8) * kStride + k0 +
                     ((lane / 8) % 2) * 8);
}

// The same B operands from a tile stored [k][n].
template <int kStride>
__device__ __forceinline__ void load_b_trans(uint32_t (&r)[4],
                                             const bf16* tile, int n0, int k0,
                                             int lane) {
  ldmatrix_x4_trans(r, tile + (k0 + ((lane / 8) % 2) * 8 + lane % 8) *
                                  kStride + n0 + (lane / 16) * 8);
}

// Copy rows [row0, row0 + 64) of a (rows, D) strided slab into a padded
// shared tile; rows >= n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < kBlockM * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    const bf16* g = src + (long long)(valid ? row : 0) * row_stride + c * 8;
    cp_async_16(tile + r * kStride + c * 8, g, valid);
  }
}

// Copy entries [row0, row0 + 64) of a contiguous f32 vector; entries past
// n_rows are zero-filled.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n_rows) {
  for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
    const int row = row0 + i;
    const bool valid = row < n_rows;
    cp_async_4(dst + i, src + (valid ? row : 0), valid);
  }
}

// Row pitch of the fused kernel's (64 keys, 64 queries) dS^T tile.
constexpr int kDsStride = kBlockM + 8;

// Strides in elements, (batch, token, head) for each tensor.
struct Strides {
  long long sb, sn, sh;
};

// dK and dV of one 64-key block (K3's dK/dV kernel), and with kFused (K2)
// also this block's share of dQ, added atomically into dq_acc.
template <int D, bool kFused>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dq_acc, int n_tok, int n_heads,
                          Strides qs, Strides ks, Strides vs, Strides ds,
                          Strides dks, Strides dvs, float scale,
                          float scale_log2) {
  constexpr int kStride = D + 8;
  constexpr int kTile = kBlockN * kStride;  // elements of one 64-row tile
  constexpr int kDSteps = D / 16;           // k-steps over D
  constexpr int kDTiles = D / 8;            // n-tiles over D
  constexpr int kQTiles = kBlockM / 8;      // n-tiles over a query tile
  constexpr int kQSteps = kBlockM / 16;     // k-steps over a query tile
  constexpr int kKeySteps = kBlockN / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_v = s_k + kTile;
  bf16* s_q = s_v + kTile;         // [2][kTile]
  bf16* s_do = s_q + 2 * kTile;    // [2][kTile]
  bf16* s_ds = s_do + 2 * kTile;   // [kBlockN][kDsStride], fused only
  float* s_lse =
      reinterpret_cast<float*>(s_ds + (kFused ? kBlockN * kDsStride : 0));
  float* s_dl = s_lse + 2 * kBlockM;  // delta, [2][kBlockM]

  const int n_kblocks = (n_tok + kBlockN - 1) / kBlockN;
  const int bh = blockIdx.x / n_kblocks;
  const int k0 = (blockIdx.x % n_kblocks) * kBlockN;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row within the warp's 8-row half
  const int t = lane % 4;  // accumulator column pair

  const bf16* qb = q + b * qs.sb + h * qs.sh;
  const bf16* kb = k + b * ks.sb + h * ks.sh;
  const bf16* vb = v + b * vs.sb + h * vs.sh;
  const bf16* dob = dout + b * ds.sb + h * ds.sh;
  const float* lse_bh = lse + (long long)bh * n_tok;
  const float* delta_bh = delta + (long long)bh * n_tok;

  load_tile<D>(s_k, kb, ks.sn, k0, n_tok);
  load_tile<D>(s_v, vb, vs.sn, k0, n_tok);
  load_tile<D>(s_q, qb, qs.sn, 0, n_tok);
  load_tile<D>(s_do, dob, ds.sn, 0, n_tok);
  load_vec(s_lse, lse_bh, 0, n_tok);
  load_vec(s_dl, delta_bh, 0, n_tok);
  cp_async_commit();

  float dk_acc[kDTiles][4];
  float dv_acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }
  // This lane's two key rows (accumulator rows g and g + 8).
  const bool key_ok[2] = {k0 + warp * 16 + g < n_tok,
                          k0 + warp * 16 + g + 8 < n_tok};

  const int n_qtiles = (n_tok + kBlockM - 1) / kBlockM;
  for (int qt = 0; qt < n_qtiles; ++qt) {
    const int stage = qt & 1;
    if (qt + 1 < n_qtiles) {
      const int nxt = stage ^ 1;
      const int q1 = (qt + 1) * kBlockM;
      load_tile<D>(s_q + nxt * kTile, qb, qs.sn, q1, n_tok);
      load_tile<D>(s_do + nxt * kTile, dob, ds.sn, q1, n_tok);
      load_vec(s_lse + nxt * kBlockM, lse_bh, q1, n_tok);
      load_vec(s_dl + nxt * kBlockM, delta_bh, q1, n_tok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* sq = s_q + stage * kTile;
    const bf16* sdo = s_do + stage * kTile;
    const float* sl = s_lse + stage * kBlockM;
    const float* sd = s_dl + stage * kBlockM;
    const int q0 = qt * kBlockM;

    // S^T = K Q^T: this warp's 16 keys x the tile's 64 queries.
    float p[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      uint32_t kf[4];
      load_a<kStride>(kf, s_k, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kQTiles; j += 2) {
        uint32_t qf[4];
        load_b<kStride>(qf, sq, j * 8, kk * 16, lane);
        mma_bf16(p[j], kf, qf[0], qf[1]);
        mma_bf16(p[j + 1], kf, qf[2], qf[3]);
      }
    }

    // P^T = exp(S^T scale - LSE), zero for queries or keys >= N.
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const bool ok = key_ok[e / 2] && q0 + col < n_tok;
        p[j][e] = ok ? exp2f(fmaf(p[j][e], scale_log2, -sl[col] * kLog2e))
                     : 0.f;
      }
    }

    // dV += bf16(P^T) dO. The accumulator layout of query tiles 2kk and
    // 2kk+1 is exactly the A operand layout of k-step kk.
    {
      uint32_t pf[kQSteps][4];
#pragma unroll
      for (int j = 0; j < kQTiles; ++j) {
        pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[j][0], p[j][1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[j][2], p[j][3]);
      }
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
#pragma unroll
        for (int j = 0; j < kDTiles; j += 2) {
          uint32_t f[4];
          load_b_trans<kStride>(f, sdo, j * 8, kk * 16, lane);
          mma_bf16(dv_acc[j], pf[kk], f[0], f[1]);
          mma_bf16(dv_acc[j + 1], pf[kk], f[2], f[3]);
        }
      }
    }

    // dP^T = V dO^T.
    float dp[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      uint32_t vf[4];
      load_a<kStride>(vf, s_v, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kQTiles; j += 2) {
        uint32_t of[4];
        load_b<kStride>(of, sdo, j * 8, kk * 16, lane);
        mma_bf16(dp[j], vf, of[0], of[1]);
        mma_bf16(dp[j + 1], vf, of[2], of[3]);
      }
    }

    // dS^T = P^T (dP^T - delta), f32; then bf16 fragments.
    uint32_t dsf[kQSteps][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
      const int col = j * 8 + 2 * t;
      const float d0 = p[j][0] * (dp[j][0] - sd[col]);
      const float d1 = p[j][1] * (dp[j][1] - sd[col + 1]);
      const float d2 = p[j][2] * (dp[j][2] - sd[col]);
      const float d3 = p[j][3] * (dp[j][3] - sd[col + 1]);
      dsf[j / 2][(j % 2) * 2 + 0] = pack_bf16(d0, d1);
      dsf[j / 2][(j % 2) * 2 + 1] = pack_bf16(d2, d3);
    }

    // dK += bf16(dS^T) Q.
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        uint32_t f[4];
        load_b_trans<kStride>(f, sq, j * 8, kk * 16, lane);
        mma_bf16(dk_acc[j], dsf[kk], f[0], f[1]);
        mma_bf16(dk_acc[j + 1], dsf[kk], f[2], f[3]);
      }
    }

    if constexpr (kFused) {
      // dS^T of the whole block to shared memory ([key][query]), then each
      // warp forms dQ for 16 of the tile's queries over all 64 keys.
#pragma unroll
      for (int j = 0; j < kQTiles; ++j) {
        const int col = j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(s_ds + (warp * 16 + g) * kDsStride +
                                     col) = dsf[j / 2][(j % 2) * 2 + 0];
        *reinterpret_cast<uint32_t*>(s_ds + (warp * 16 + g + 8) * kDsStride +
                                     col) = dsf[j / 2][(j % 2) * 2 + 1];
      }
      __syncthreads();
      float dq[kDTiles][4];
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeySteps; ++kk) {
        uint32_t a[4];
        load_a_trans<kDsStride>(a, s_ds, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < kDTiles; j += 2) {
          uint32_t f[4];
          load_b_trans<kStride>(f, s_k, j * 8, kk * 16, lane);
          mma_bf16(dq[j], a, f[0], f[1]);
          mma_bf16(dq[j + 1], a, f[2], f[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row >= n_tok) continue;
        float* dst = dq_acc + (((long long)b * n_tok + row) * n_heads + h) * D;
#pragma unroll
        for (int j = 0; j < kDTiles; ++j) {
          atomicAdd(dst + j * 8 + 2 * t, dq[j][2 * r] * scale);
          atomicAdd(dst + j * 8 + 2 * t + 1, dq[j][2 * r + 1] * scale);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage (and dS^T)
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const int row = k0 + warp * 16 + g + 8 * r;
    bf16* dkr = dk + b * dks.sb + row * dks.sn + h * dks.sh;
    bf16* dvr = dv + b * dvs.sb + row * dvs.sn + h * dvs.sh;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(dkr + j * 8 + 2 * t) = pack_bf16(
          dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + j * 8 + 2 * t) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// K3's dQ kernel: dQ of one 64-query block, streaming key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int n_tok, int n_heads,
                         Strides qs, Strides ks, Strides vs, Strides ds,
                         Strides dqs, float scale, float scale_log2) {
  constexpr int kStride = D + 8;
  constexpr int kTile = kBlockN * kStride;
  constexpr int kDSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kKeyTiles = kBlockN / 8;
  constexpr int kKeySteps = kBlockN / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_do = s_q + kTile;
  bf16* s_k = s_do + kTile;   // [2][kTile]
  bf16* s_v = s_k + 2 * kTile;  // [2][kTile]

  const int n_qtiles = (n_tok + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockM;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const bf16* qb = q + b * qs.sb + h * qs.sh;
  const bf16* kb = k + b * ks.sb + h * ks.sh;
  const bf16* vb = v + b * vs.sb + h * vs.sh;
  const bf16* dob = dout + b * ds.sb + h * ds.sh;

  load_tile<D>(s_q, qb, qs.sn, q0, n_tok);
  load_tile<D>(s_do, dob, ds.sn, q0, n_tok);
  load_tile<D>(s_k, kb, ks.sn, 0, n_tok);
  load_tile<D>(s_v, vb, vs.sn, 0, n_tok);
  cp_async_commit();

  // This lane's two query rows: LSE (log2 domain) and delta.
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < n_tok;
    lse2[r] = ok ? lse[(long long)bh * n_tok + row[r]] * kLog2e : 0.f;
    dl[r] = ok ? delta[(long long)bh * n_tok + row[r]] : 0.f;
  }

  uint32_t q_frag[kDSteps][4];
  uint32_t do_frag[kDSteps][4];
  float dq_acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;
  }

  const int n_ktiles = (n_tok + kBlockN - 1) / kBlockN;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_ktiles) {
      load_tile<D>(s_k + (stage ^ 1) * kTile, kb, ks.sn, (kt + 1) * kBlockN,
                   n_tok);
      load_tile<D>(s_v + (stage ^ 1) * kTile, vb, vs.sn, (kt + 1) * kBlockN,
                   n_tok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        load_a<kStride>(q_frag[kk], s_q, warp * 16, kk * 16, lane);
        load_a<kStride>(do_frag[kk], s_do, warp * 16, kk * 16, lane);
      }
    }
    const bf16* sk = s_k + stage * kTile;
    const bf16* sv = s_v + stage * kTile;

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x 64 keys.
    float p[kKeyTiles][4];
    float dp[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; j += 2) {
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        uint32_t kf[4];
        load_b<kStride>(kf, sk, j * 8, kk * 16, lane);
        mma_bf16(p[j], q_frag[kk], kf[0], kf[1]);
        mma_bf16(p[j + 1], q_frag[kk], kf[2], kf[3]);
        uint32_t vf[4];
        load_b<kStride>(vf, sv, j * 8, kk * 16, lane);
        mma_bf16(dp[j], do_frag[kk], vf[0], vf[1]);
        mma_bf16(dp[j + 1], do_frag[kk], vf[2], vf[3]);
      }
    }

    // P = exp(S scale - LSE) (zero for keys >= N), dS = P (dP - delta).
    const int key0 = kt * kBlockN;
    uint32_t dsf[kKeySteps][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * t + (e & 1);
        const float pe =
            key < n_tok ? exp2f(fmaf(p[j][e], scale_log2, -lse2[e / 2])) : 0.f;
        d[e] = pe * (dp[j][e] - dl[e / 2]);
      }
      dsf[j / 2][(j % 2) * 2 + 0] = pack_bf16(d[0], d[1]);
      dsf[j / 2][(j % 2) * 2 + 1] = pack_bf16(d[2], d[3]);
    }

    // dQ += bf16(dS) K.
#pragma unroll
    for (int kk = 0; kk < kKeySteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        uint32_t f[4];
        load_b_trans<kStride>(f, sk, j * 8, kk * 16, lane);
        mma_bf16(dq_acc[j], dsf[kk], f[0], f[1]);
        mma_bf16(dq_acc[j + 1], dsf[kk], f[2], f[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= n_tok) continue;
    bf16* dqr = dq + b * dqs.sb + row[r] * dqs.sn + h * dqs.sh;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(dqr + j * 8 + 2 * t) =
          pack_bf16(dq_acc[j][2 * r] * scale, dq_acc[j][2 * r + 1] * scale);
    }
  }
}

template <int D, bool kFused>
constexpr int dkv_smem() {
  // K, V, two stages each of Q and dO, the dS^T tile (fused), and two
  // stages each of LSE and delta.
  return (6 * kBlockN * (D + 8) + (kFused ? kBlockN * kDsStride : 0)) * 2 +
         4 * kBlockM * 4;
}

template <int D>
constexpr int dq_smem() {
  return 6 * kBlockN * (D + 8) * 2;  // Q, dO, two stages each of K and V
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int batch, int n_tok,
                   int n_heads, const long long* st, bool fused, float scale,
                   cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ds{st[9], st[10], st[11]},
      dqs{st[12], st[13], st[14]}, dks{st[15], st[16], st[17]},
      dvs{st[18], st[19], st[20]};
  const long long n_tiles = (n_tok + kBlockN - 1) / kBlockN;
  const long long blocks = (long long)batch * n_heads * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const float scale_log2 = scale * kLog2e;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* dl_ = static_cast<const float*>(delta);
  cudaError_t err;
  if (fused) {
    constexpr int smem = dkv_smem<D, true>();
    auto kernel = flash_attn_bwd_dkv_kernel<D, true>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
        q_, k_, v_, do_, lse_, dl_, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), static_cast<float*>(dq), n_tok, n_heads, qs,
        ks, vs, ds, dks, dvs, scale, scale_log2);
    return cudaGetLastError();
  }
  constexpr int smem_dq = dq_smem<D>();
  auto dq_kernel = flash_attn_bwd_dq_kernel<D>;
  err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<(unsigned)blocks, kThreads, smem_dq, stream>>>(
      q_, k_, v_, do_, lse_, dl_, static_cast<bf16*>(dq), n_tok, n_heads,
      qs, ks, vs, ds, dqs, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = dkv_smem<D, false>();
  auto kernel = flash_attn_bwd_dkv_kernel<D, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      q_, k_, v_, do_, lse_, dl_, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), nullptr, n_tok, n_heads, qs, ks, vs, ds, dks,
      dvs, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: (B, N, H, D) bf16 with unit stride on D; lse, delta:
// contiguous (B, H, N) f32; dk, dv: (B, N, H, D) bf16 with unit stride on
// D. `strides` holds 21 element strides, (batch, token, head) of q, k, v,
// dout, dq, dk, dv in that order.
//   fused = 1 (K2): dq is a zeroed, contiguous (B, N, H, D) f32 scratch
//     that the kernel adds into; its strides are not read.
//   fused = 0 (K3): dq is (B, N, H, D) bf16 with the given strides.
// Launches on `stream`, allocates nothing, writes only rows < N, and
// returns the first CUDA error (cudaErrorInvalidValue for an unsupported D).
extern "C" int e3d_flash_attn_bwd(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, int batch,
                                  int n_tok, int n_heads, int head_dim,
                                  const long long* strides, int fused,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, dq, dk, dv, batch, n_tok,
                        n_heads, strides, fused != 0, scale, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, batch, n_tok,
                        n_heads, strides, fused != 0, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
