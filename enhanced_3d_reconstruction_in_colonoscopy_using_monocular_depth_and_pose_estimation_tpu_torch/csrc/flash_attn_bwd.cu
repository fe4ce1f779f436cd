// Flash-attention backward for the ViT encoder, Hopper sm_90a: kernel K2
// (fused, one pass over key blocks) and kernel K3 (split into a dQ pass
// and a dK/dV pass).
//
// Replaces the TPU kernels of the JAX package's ops/flash_attention.py:
//   K2  _bwd_fused / _bwd_fused_kernel              (E3D_FLASH_BWD_FUSED=1)
//   K3  _bwd / _bwd_dq_kernel + _bwd_dkv_kernel     (E3D_FLASH_BWD_FUSED=0)
// Per (batch, head), from q, k, v, O, dO (B, N, H, D) bf16 and the
// forward's natural-log LSE (B, H, N) f32:
//   P  = exp(Q K^T * scale - LSE)           (f32, recomputed)
//   dV = bf16(P)^T dO
//   dS = P * (dO V^T - delta),  delta = rowsum(dO * O) in f32
//   dK = bf16(dS)^T Q * scale
//   dQ = bf16(dS) K * scale
// As on the TPU, P and dS are rounded to bf16 before the products that
// consume them and every product accumulates in f32. Rows at or past N
// are zero-filled by TMA, masked by index, and never written, so no
// caller pads the token axis.
//
// Bound at the flagship shape (B 8, N 1370, H 16, D 64), per backward:
// 5 score-sized products x 2 B H N^2 D = 153.8 GFLOP -> 156 us at 989
// TFLOP/s; q, k, v, O, dO, dq, dk, dv (bf16) and LSE (f32) about 180 MB
// -> 54 us at 3.35 TB/s. Compute-bound, so the design feeds the tensor
// cores with wgmma and keeps the copies off the threads that issue it:
//
// 1. flash_attn_bwd_prep_kernel: one pass over O and dO writes delta and
//    LSE * log2(e) into padded (B, H, Np) f32 rows, Np = N rounded up to
//    the 64-query tile, with delta = 0 and LSE = +inf past N (so P = 0
//    there); under K2 it also zeroes the f32 dQ accumulator. The padding
//    makes every 64-entry tile 256-byte aligned, which the bulk copies
//    need ((B, H, 1370) rows start at odd multiples of 8 bytes).
// 2. flash_attn_bwd_dkv_kernel<D, kFused>, shared by K2 and K3: one block
//    per (batch*head, 128-key block) of three warpgroups. Warpgroup 0 is
//    the producer: it drops to 24 registers (setmaxnreg) and one thread
//    loads the block's K and V once and streams 64-query tiles of Q, dO
//    (TMA, rank-4 tensor maps over the strided (B, N, H, D) views, 128B
//    swizzle at D 64, 64B at D 32) and of LSE2, delta (bulk copies)
//    through a two-stage ring of full/empty mbarriers. Warpgroups 1 and 2
//    are consumers at 240 registers, each owning 64 keys: per query tile
//    S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory, P^T and
//    dS^T in registers, then dV += bf16(P^T) dO and dK += bf16(dS^T) Q by
//    wgmma with A from registers and B read MN-major from the same tiles.
//    128 keys per block: at vitl 11 key blocks per head (the last holding
//    90), 1408 blocks of one per SM (130 KB of shared memory and 64K
//    registers each); 64-key blocks would double the dQ traffic of K2.
//    Under K2 (kFused) the block also forms the tile's dQ share: both
//    consumers store bf16(dS^T) into a 128B-swizzled (128 keys x 64
//    queries) tile, fence the async proxy and meet at a named barrier;
//    one of them (alternating by tile, so each forms every other share)
//    runs dQ = dS K over the 128 keys as one wgmma chain (A read
//    MN-major from the dS^T tile), writes the f32 result to shared memory
//    and issues one cp.reduce.async.bulk .add.f32 of the 64 x D tile into
//    the accumulator, laid out (B, H, Np, D): one contiguous 16 KB block
//    per tile at D 64, in place of 4096 scalar atomics. The dS^T tile and
//    the f32 tile are double-buffered; the f32 tile's 8-float chunks are
//    XOR-swizzled by row % 4 (conflict-free stores), which the conversion
//    undoes. The bulk reductions land in another order from run to run,
//    so K2's dQ may move by one bf16 ulp between runs; dK and dV do not.
// 3. K2: flash_attn_bwd_convert_kernel reads the accumulator, scales it
//    and writes bf16 dq into its strided view, rows < N.
//    K3: flash_attn_bwd_dq_kernel<D>, one block per (batch*head,
//    128-query block), the same three warpgroups: each consumer keeps its
//    64 queries of Q and dO in shared memory while the producer streams
//    64-key tiles of K and V by TMA; S = Q K^T and dP = dO V^T by wgmma
//    from shared memory, dS in registers, dQ += bf16(dS) K by wgmma with
//    A from registers. No atomics: bit for bit the same from run to run.
// A K2 call launches prep, dK/dV (fused) and convert; a K3 call prep, dQ
// and dK/dV.
//
// Each wgmma group is waited for before normal code touches any of the
// warpgroup's accumulators again. Issuing dV while dS^T is formed, K2's
// dQ behind dV and dK and the next tile's scores before a tile's last
// wait, tried together, made ptxas serialize the wgmma chain (C7514,
// C7515, C7518) and cost K2 and K3 a fifth of their time on the H100; a
// third pipeline stage changed nothing (PERF.md, Findings).

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTileQ = kTileRows;  // queries per tile: one wgmma's 64 rows
constexpr int kTileK = kTileRows;  // keys per consumer warpgroup / dQ tile
constexpr int kConsumers = 2;  // consumer warpgroups per block
constexpr int kBlockK = kConsumers * kTileK;  // keys per dK/dV block
constexpr int kBlockQ = kConsumers * kTileQ;  // queries per dQ block
constexpr int kThreads = 128 * (1 + kConsumers);  // producer warpgroup first
constexpr int kStages = 2;

// Named barriers (0 is __syncthreads).
constexpr int kBarDsFull = 1;   // + buffer: both consumers stored dS^T
constexpr int kBarDsEmpty = 3;  // + buffer: the dQ product has read it
constexpr int kBarGroup = 5;    // + consumer: within one warpgroup

// Strides in elements, (batch, token, head) for each tensor.
struct Strides {
  long long sb, sn, sh;
};

template <int D>
using Tile = SwizzledTile<D>;

// The (128 keys x 64 queries) bf16 dS^T tile of K2: 128-byte rows.
constexpr int kDsRowBytes = kTileQ * 2;
constexpr uint32_t kDsAtom = 8 * kDsRowBytes;

// 64 token rows of one head of a (B, N, H, D) view; rows >= N are zeros.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int row,
                                         int b) {
  tma_load_4d(dst, map, bar, 0, h, row, b);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n"
      :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ------------------------------------------------------------- prep

// delta and LSE * log2(e) into padded (B, H, Np) rows (+inf and 0 past
// N), one thread a row; with dq_acc, zero its (B, H, Np, D) f32 values,
// D / 4 float4 a thread, neighbouring threads on neighbouring float4.
template <int D>
__global__ void __launch_bounds__(256)
flash_attn_bwd_prep_kernel(const bf16* __restrict__ o,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ lse2,
                           float* __restrict__ delta,
                           float* __restrict__ dq_acc, int n_tok, int n_pad,
                           int n_heads, Strides os, Strides ds,
                           long long rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int bh = static_cast<int>(i / n_pad);
  const int n = static_cast<int>(i % n_pad);
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  float l = INFINITY;
  float dl = 0.f;
  if (n < n_tok) {
    const uint4* po =
        reinterpret_cast<const uint4*>(o + b * os.sb + n * os.sn + h * os.sh);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + b * ds.sb +
                                                     n * ds.sn + h * ds.sh);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 x = po[c];
      const uint4 y = pd[c];
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
        const float2 yf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
        dl = fmaf(xf.x, yf.x, dl);
        dl = fmaf(xf.y, yf.y, dl);
      }
    }
    l = lse[(long long)bh * n_tok + n] * kLog2e;
  }
  lse2[i] = l;
  delta[i] = dl;
  if (dq_acc != nullptr) {
    float4* z = reinterpret_cast<float4*>(dq_acc);
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      z[c * rows + i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ------------------------------------------------------------- dK, dV

template <int D, bool kFused>
struct DkvSmem {
  static constexpr int kKv = kBlockK * Tile<D>::kRowBytes;  // K or V
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKv;
  static constexpr int kQ = kV + kKv;  // [kStages] 64-query tiles
  static constexpr int kDo = kQ + kStages * Tile<D>::kBytes;
  static constexpr int kDs = kDo + kStages * Tile<D>::kBytes;
  static constexpr int kDsBytes = kBlockK * kDsRowBytes;  // [2], fused
  static constexpr int kDq = kDs + (kFused ? 2 * kDsBytes : 0);
  static constexpr int kDqBytes = kTileQ * D * 4;  // [kConsumers], fused
  static constexpr int kLse = kDq + (kFused ? kConsumers * kDqBytes : 0);
  static constexpr int kDelta = kLse + kStages * kTileQ * 4;
  static constexpr int kBars = kDelta + kStages * kTileQ * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// dK and dV of one (batch*head, 128-key block); with kFused (K2) also the
// block's share of dQ, reduced into dq_acc (B, H, Np, D) f32.
template <int D, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          float* __restrict__ dq_acc, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int n_tok, int n_pad,
                          int n_heads, Strides dks, Strides dvs, float scale,
                          float scale_log2) {
  using L = DkvSmem<D, kFused>;
  using T = Tile<D>;
  constexpr int kAcc = D / 2;  // registers of a 64 x D accumulator

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStages;

  const int n_kblocks = (n_tok + kBlockK - 1) / kBlockK;
  const int bh = blockIdx.x / n_kblocks;
  const int k0 = (blockIdx.x % n_kblocks) * kBlockK;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int n_qtiles = n_pad / kTileQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread issues every copy.
    setmaxnreg_producer();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_bar, 2 * L::kKv);
      for (int half = 0; half < kConsumers; ++half) {
        tma_rows(smem + L::kK + half * T::kBytes, &tm_k, kv_bar, h,
                 k0 + half * kTileK, b);
        tma_rows(smem + L::kV + half * T::kBytes, &tm_v, kv_bar, h,
                 k0 + half * kTileK, b);
      }
      const float* lse_bh = lse2 + (long long)bh * n_pad;
      const float* dl_bh = delta + (long long)bh * n_pad;
      for (int qt = 0; qt < n_qtiles; ++qt) {
        const int s = qt % kStages;
        if (qt >= kStages) mbar_wait(&empty[s], ((qt / kStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * T::kBytes + 2 * kTileQ * 4);
        tma_rows(smem + L::kQ + s * T::kBytes, &tm_q, &full[s], h,
                 qt * kTileQ, b);
        tma_rows(smem + L::kDo + s * T::kBytes, &tm_do, &full[s], h,
                 qt * kTileQ, b);
        bulk_load(smem + L::kLse + s * kTileQ * 4, lse_bh + qt * kTileQ,
                  kTileQ * 4, &full[s]);
        bulk_load(smem + L::kDelta + s * kTileQ * 4, dl_bh + qt * kTileQ,
                  kTileQ * 4, &full[s]);
      }
    }
  } else {
    setmaxnreg_consumer();
    const int w = threadIdx.x / 128 - 1;  // this consumer's 64 keys
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    // This thread's accumulator rows: keys key_row and key_row + 8.
    const int key_row = w * kTileK + warp * 16 + g;
    const bool key_ok[2] = {k0 + key_row < n_tok, k0 + key_row + 8 < n_tok};
    const uint32_t s_kblock = smem_u32(smem + L::kK);
    const uint32_t s_k = s_kblock + w * T::kBytes;
    const uint32_t s_v = smem_u32(smem + L::kV) + w * T::kBytes;

    float dk_acc[kAcc], dv_acc[kAcc], s_acc[32], dp_acc[32];
    zero(dk_acc);
    zero(dv_acc);
    zero(s_acc);
    zero(dp_acc);
    mbar_wait(kv_bar, 0);

    for (int qt = 0; qt < n_qtiles; ++qt) {
      const int s = qt % kStages;
      const int q0 = qt * kTileQ;
      mbar_wait(&full[s], (qt / kStages) & 1);
      const uint32_t s_q = smem_u32(smem + L::kQ + s * T::kBytes);
      const uint32_t s_do = smem_u32(smem + L::kDo + s * T::kBytes);
      const float* s_lse =
          reinterpret_cast<const float*>(smem + L::kLse + s * kTileQ * 4);
      const float* s_dl =
          reinterpret_cast<const float*>(smem + L::kDelta + s * kTileQ * 4);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries over D, both
      // operands K-major; the k16 steps advance 32 bytes along a row.
      fence_regs(s_acc);
      fence_regs(dp_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<64, 0, 0>(s_acc, make_desc(s_k + kk * 32, T::kAtom, T::kMode),
                           make_desc(s_q + kk * 32, T::kAtom, T::kMode), kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<64, 0, 0>(dp_acc,
                           make_desc(s_v + kk * 32, T::kAtom, T::kMode),
                           make_desc(s_do + kk * 32, T::kAtom, T::kMode), kk);
      }
      wgmma_commit();

      // P^T = exp2(S^T scale log2(e) - LSE2), zero for keys or queries
      // >= N, while dP^T is still in flight.
      wgmma_wait<1>();
      fence_regs(s_acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const bool ok = key_ok[e / 2] && q0 + col < n_tok;
          s_acc[4 * j + e] =
              ok ? exp2f(fmaf(s_acc[4 * j + e], scale_log2, -s_lse[col]))
                 : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp_acc);
      // dS^T = P^T (dP^T - delta).
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          dp_acc[4 * j + e] = s_acc[4 * j + e] * (dp_acc[4 * j + e] - s_dl[col]);
        }
      }
      uint32_t pa[4][4], da[4][4];
      to_a_operand(s_acc, pa);
      to_a_operand(dp_acc, da);

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: A from registers, B
      // the same tiles read MN-major; a k16 step is 16 query rows.
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D, 1>(dv_acc, pa[kk],
                       make_desc(s_do + kk * 16 * T::kRowBytes, T::kAtom,
                                 T::kMode), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D, 1>(dk_acc, da[kk],
                       make_desc(s_q + kk * 16 * T::kRowBytes, T::kAtom,
                                 T::kMode), 1);
      }
      wgmma_commit();

      const int buf = qt & 1;
      const bool mine = kFused && buf == w;  // this consumer forms dQ
      unsigned char* s_ds = smem + L::kDs + buf * L::kDsBytes;
      if constexpr (kFused) {
        // bf16(dS^T) into the 128B-swizzled [key][query] tile: row r,
        // 16-byte chunk c at r * 128 + ((c ^ r % 8) * 16). Wait first
        // until the other consumer's dQ product of two tiles ago has
        // read this buffer.
        if (!mine && qt >= 2) bar_sync(kBarDsEmpty + buf, 2 * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = key_row + 8 * (r % 2);
            const int chunk = (2 * kk + r / 2) ^ g;  // row % 8 == g
            *reinterpret_cast<uint32_t*>(s_ds + row * kDsRowBytes +
                                         chunk * 16 + 4 * t) = da[kk][r];
          }
        }
        fence_proxy_async();
        if (!mine) bar_arrive(kBarDsFull + buf, 2 * 128);
      }

      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // Q, dO, LSE2, delta read

      if constexpr (kFused) {
        if (mine) {
          // dQ share of this query tile over the block's 128 keys:
          // dS (64 queries x 128 keys) read MN-major from the dS^T tile,
          // K (128 keys x D) read MN-major; a k16 step is 16 key rows.
          bar_sync(kBarDsFull + buf, 2 * 128);
          const uint32_t ds_addr = smem_u32(s_ds);
          float dq[kAcc];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBlockK / 16; ++kk) {
            wgmma_ss<D, 1, 1>(
                dq, make_desc(ds_addr + kk * 16 * kDsRowBytes, kDsAtom, 1),
                make_desc(s_kblock + kk * 16 * T::kRowBytes, T::kAtom,
                          T::kMode),
                kk);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
          if (qt + 2 < n_qtiles) bar_arrive(kBarDsEmpty + buf, 2 * 128);

          // The f32 tile, 8-float chunks swizzled by row % 4, then one
          // bulk reduction into the accumulator. Its previous reduction
          // (two tiles ago) must have read the buffer first.
          float* s_dq = reinterpret_cast<float*>(smem + L::kDq +
                                                 w * L::kDqBytes);
          if (tid == 0) bulk_wait_read();
          bar_sync(kBarGroup + w, 128);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int row = warp * 16 + g + 8 * i;  // row % 4 == g % 4
              *reinterpret_cast<float2*>(s_dq + row * D +
                                         ((j ^ (g & 3)) * 8) + 2 * t) =
                  make_float2(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
            }
          }
          fence_proxy_async();
          bar_sync(kBarGroup + w, 128);
          if (tid == 0) {
            bulk_reduce_add(dq_acc + ((long long)bh * n_pad + q0) * D, s_dq,
                            L::kDqBytes);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!key_ok[i]) continue;
      const int row = k0 + key_row + 8 * i;
      bf16* dkr = dk + b * dks.sb + row * dks.sn + h * dks.sh;
      bf16* dvr = dv + b * dvs.sb + row * dvs.sn + h * dvs.sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * j + 2 * t) =
            pack_bf16(dk_acc[4 * j + 2 * i] * scale,
                      dk_acc[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvr + 8 * j + 2 * t) =
            pack_bf16(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
      }
    }
    if (kFused && tid == 0) bulk_wait();
  }
}

// ------------------------------------------------------------- dQ (K3)

template <int D>
struct DqSmem {
  static constexpr int kQ = 0;  // this block's 128 queries of Q
  static constexpr int kDo = kQ + kBlockQ * Tile<D>::kRowBytes;
  static constexpr int kK = kDo + kBlockQ * Tile<D>::kRowBytes;  // [kStages]
  static constexpr int kV = kK + kStages * Tile<D>::kBytes;      // [kStages]
  static constexpr int kBars = kV + kStages * Tile<D>::kBytes;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// K3's dQ of one (batch*head, 128-query block), streaming 64-key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse2,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int n_tok, int n_pad,
                         int n_heads, Strides dqs, float scale,
                         float scale_log2) {
  using L = DqSmem<D>;
  using T = Tile<D>;
  constexpr int kAcc = D / 2;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int n_qblocks = (n_tok + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * kBlockQ;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int n_ktiles = (n_tok + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_producer();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * kConsumers * T::kBytes);
      for (int half = 0; half < kConsumers; ++half) {
        tma_rows(smem + L::kQ + half * T::kBytes, &tm_q, q_bar, h,
                 q0 + half * kTileQ, b);
        tma_rows(smem + L::kDo + half * T::kBytes, &tm_do, q_bar, h,
                 q0 + half * kTileQ, b);
      }
      for (int kt = 0; kt < n_ktiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * T::kBytes);
        tma_rows(smem + L::kK + s * T::kBytes, &tm_k, &full[s], h,
                 kt * kTileK, b);
        tma_rows(smem + L::kV + s * T::kBytes, &tm_v, &full[s], h,
                 kt * kTileK, b);
      }
    }
  } else {
    setmaxnreg_consumer();
    const int w = threadIdx.x / 128 - 1;  // this consumer's 64 queries
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = q0 + w * kTileQ + warp * 16 + g;  // and row0 + 8
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const bool ok = row < n_tok;
      lse_r[i] = ok ? lse2[(long long)bh * n_pad + row] : INFINITY;
      dl_r[i] = ok ? delta[(long long)bh * n_pad + row] : 0.f;
    }
    const uint32_t s_q = smem_u32(smem + L::kQ) + w * T::kBytes;
    const uint32_t s_do = smem_u32(smem + L::kDo) + w * T::kBytes;

    float dq_acc[kAcc], s_acc[32], dp_acc[32];
    zero(dq_acc);
    zero(s_acc);
    zero(dp_acc);
    mbar_wait(q_bar, 0);

    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint32_t s_k = smem_u32(smem + L::kK + s * T::kBytes);
      const uint32_t s_v = smem_u32(smem + L::kV + s * T::kBytes);

      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys, K-major.
      fence_regs(s_acc);
      fence_regs(dp_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<64, 0, 0>(s_acc, make_desc(s_q + kk * 32, T::kAtom, T::kMode),
                           make_desc(s_k + kk * 32, T::kAtom, T::kMode), kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<64, 0, 0>(dp_acc,
                           make_desc(s_do + kk * 32, T::kAtom, T::kMode),
                           make_desc(s_v + kk * 32, T::kAtom, T::kMode), kk);
      }
      wgmma_commit();

      // P = exp2(S scale log2(e) - LSE2) (zero for keys >= N; LSE2 is
      // +inf for queries >= N), then dS = P (dP - delta).
      const int key0 = kt * kTileK;
      wgmma_wait<1>();
      fence_regs(s_acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key0 + 8 * j + 2 * t + (e & 1) < n_tok;
          s_acc[4 * j + e] =
              ok ? exp2f(fmaf(s_acc[4 * j + e], scale_log2, -lse_r[e / 2]))
                 : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp_acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp_acc[4 * j + e] = s_acc[4 * j + e] * (dp_acc[4 * j + e] - dl_r[e / 2]);
        }
      }
      uint32_t da[4][4];
      to_a_operand(dp_acc, da);

      // dQ += bf16(dS) K: K (64 keys x D) read MN-major.
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D, 1>(dq_acc, da[kk],
                       make_desc(s_k + kk * 16 * T::kRowBytes, T::kAtom,
                                 T::kMode), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= n_tok) continue;
      bf16* dqr = dq + b * dqs.sb + row * dqs.sn + h * dqs.sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dqr + 8 * j + 2 * t) =
            pack_bf16(dq_acc[4 * j + 2 * i] * scale,
                      dq_acc[4 * j + 2 * i + 1] * scale);
      }
    }
  }
}

// ------------------------------------------------------------- convert

// K2's dq: the f32 accumulator (B, H, Np, D), chunks swizzled by row % 4,
// scaled and rounded into the bf16 (B, N, H, D) view. One thread per
// 8-value chunk of a row < N.
template <int D>
__global__ void __launch_bounds__(256)
flash_attn_bwd_convert_kernel(const float* __restrict__ dq_acc,
                              bf16* __restrict__ dq, int n_tok, int n_pad,
                              int n_heads, Strides dqs, float scale,
                              long long chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const int c = static_cast<int>(i % (D / 8));
  const long long row = i / (D / 8);
  const int n = static_cast<int>(row % n_tok);
  const int bh = static_cast<int>(row / n_tok);
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + ((long long)bh * n_pad + n) * D + (c ^ (n & 3)) * 8);
  const float4 x = src[0];
  const float4 y = src[1];
  uint4 out;
  out.x = pack_bf16(x.x * scale, x.y * scale);
  out.y = pack_bf16(x.z * scale, x.w * scale);
  out.z = pack_bf16(y.x * scale, y.y * scale);
  out.w = pack_bf16(y.z * scale, y.w * scale);
  *reinterpret_cast<uint4*>(dq + b * dqs.sb + n * dqs.sn + h * dqs.sh +
                            8 * c) = out;
}

// ------------------------------------------------------------- host

// A (B, N, H, D) bf16 view as a rank-4 (D, H, N, B) tensor map read in
// boxes of 64 token rows of one head, swizzled for wgmma.
template <int D>
CUresult encode_rows(EncodeTiled fn, CUtensorMap* map, const void* base,
                     int batch, int n_tok, int n_heads, const long long* st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(n_tok),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, kTileQ, 1};
  return encode_bf16_4d(fn, map, base, dims, strides, box, Tile<D>::kTma);
}

inline unsigned blocks_of(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* o, const void* lse, void* lse2, void* delta,
           void* dq_acc, void* dq, void* dk, void* dv, int batch, int n_tok,
           int n_pad, int n_heads, const long long* st, bool fused,
           float scale, cudaStream_t stream) {
  const Strides ds{st[9], st[10], st[11]}, os{st[12], st[13], st[14]},
      dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]},
      dvs{st[21], st[22], st[23]};
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const void* bases[4] = {q, k, v, dout};
  CUtensorMap* maps[4] = {&tm_q, &tm_k, &tm_v, &tm_do};
  for (int i = 0; i < 4; ++i) {
    const CUresult r = encode_rows<D>(fn, maps[i], bases[i], batch, n_tok,
                                      n_heads, st + 3 * i);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const long long heads = static_cast<long long>(batch) * n_heads;
  const long long key_blocks = heads * ((n_tok + kBlockK - 1) / kBlockK);
  const long long query_blocks = heads * ((n_tok + kBlockQ - 1) / kBlockQ);
  if (key_blocks > 0x7fffffffLL || query_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const float scale_log2 = scale * kLog2e;
  const float* lse2_ = static_cast<const float*>(lse2);
  const float* delta_ = static_cast<const float*>(delta);
  float* acc = fused ? static_cast<float*>(dq_acc) : nullptr;

  const long long rows = heads * n_pad;
  flash_attn_bwd_prep_kernel<D><<<blocks_of(rows, 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(lse2),
      static_cast<float*>(delta), acc, n_tok, n_pad, n_heads, os, ds, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (fused) {
    auto kernel = flash_attn_bwd_dkv_kernel<D, true>;
    constexpr int smem = DkvSmem<D, true>::kAlloc;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(key_blocks), kThreads, smem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, lse2_, delta_, acc, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), n_tok, n_pad, n_heads, dks, dvs, scale,
        scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long chunks = heads * n_tok * (D / 8);
    flash_attn_bwd_convert_kernel<D>
        <<<blocks_of(chunks, 256), 256, 0, stream>>>(
            acc, static_cast<bf16*>(dq), n_tok, n_pad, n_heads, dqs, scale,
            chunks);
    return cudaGetLastError();
  }
  auto dq_kernel = flash_attn_bwd_dq_kernel<D>;
  constexpr int smem_dq = DqSmem<D>::kAlloc;
  if ((err = allow_smem(dq_kernel, smem_dq)) != cudaSuccess) return err;
  dq_kernel<<<static_cast<unsigned>(query_blocks), kThreads, smem_dq,
              stream>>>(tm_q, tm_k, tm_v, tm_do, lse2_, delta_,
                        static_cast<bf16*>(dq), n_tok, n_pad, n_heads, dqs,
                        scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto kernel = flash_attn_bwd_dkv_kernel<D, false>;
  constexpr int smem = DkvSmem<D, false>::kAlloc;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(key_blocks), kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse2_, delta_, nullptr,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_tok, n_pad, n_heads,
      dks, dvs, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, o: (B, N, H, D) bf16 views, unit stride on D, the other
// strides multiples of 16 bytes, bases 16-byte aligned (q, k, v and dout
// are read by TMA); lse: contiguous (B, H, N) f32; lse2, delta: (B, H,
// n_pad) f32 scratch, n_pad = N rounded up to 64; dq, dk, dv: bf16
// (B, N, H, D) views with 16-byte aligned rows. `strides` holds 24 element
// strides, (batch, token, head) of q, k, v, dout, o, dq, dk, dv.
//   fused = 1 (K2): dq_acc is a (B, H, n_pad, D) f32 scratch (the prep
//     kernel zeroes it); launches prep, dK/dV with the dQ share, convert.
//   fused = 0 (K3): dq_acc is not read; launches prep, dQ, dK/dV.
// Launches on `stream`, allocates nothing, writes only rows < N. Returns
// 0, a CUDA runtime error, or minus the driver's error when a tensor map
// cannot be encoded (cudaErrorInvalidValue for an unsupported D or n_pad).
extern "C" int e3d_flash_attn_bwd(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* o, const void* lse, void* lse2,
                                  void* delta, void* dq_acc, void* dq,
                                  void* dk, void* dv, int batch, int n_tok,
                                  int n_pad, int n_heads, int head_dim,
                                  const long long* strides, int fused,
                                  float scale, void* stream) {
  if (n_tok < 1 || n_pad % kTileQ != 0 || n_pad < n_tok ||
      n_pad - n_tok >= kTileQ)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, dout, o, lse, lse2, delta, dq_acc, dq, dk,
                        dv, batch, n_tok, n_pad, n_heads, strides, fused != 0,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, dout, o, lse, lse2, delta, dq_acc, dq, dk,
                        dv, batch, n_tok, n_pad, n_heads, strides, fused != 0,
                        scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
