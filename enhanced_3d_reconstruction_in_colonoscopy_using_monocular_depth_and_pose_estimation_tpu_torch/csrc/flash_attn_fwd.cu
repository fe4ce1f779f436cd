// Flash-attention forward for the ViT encoder, Hopper sm_90a: kernel K1
// and its two schedule variants K4 (paired heads) and K5 (head-looped).
//
// All three compute, per (batch, head),
//   S   = Q K^T / sqrt(D)            (bf16 operands, f32 accumulation)
//   S[:, j] = -1e30 for key j >= N   (ragged key edge, masked by index)
//   O   = (bf16(P) V) / l,  P = exp(S - m),  m = rowmax S,  l = sum P
//   LSE = m + log l
// in the log2 domain, with an online softmax over 128-key tiles: a
// running row max m, a running sum l and a rescale of the f32 O
// accumulator whenever m grows. As on the TPU, P is rounded to bf16
// unnormalised before the PV product and the division by l follows it,
// in f32; LSE = m ln2 + log l is rounded operation by operation (the _rn
// intrinsics). O is written (B, N, H, D) bf16 and LSE (B, H, N) f32. q, k
// and v are read through their strides, so the caller passes views of
// the packed qkv projection (B, N, 3, H, D) without copies; nothing is
// padded, and rows at or past N are never written.
//
// All three are warp-specialised: a producer warpgroup and two consumer
// warpgroups (three in K1). Warpgroup 0 is the producer: it drops to 24
// registers (setmaxnreg) and one thread issues every TMA load (rank-4
// tensor maps over the strided (B, N, H, D) views, dims (D, N, H, B),
// 128B swizzle at D 64 and 64B at D 32), K and V streaming in 128-key
// tiles through a two-stage ring of full/empty mbarriers (at N = 1370, 11
// tiles, the last holding 90 keys). The consumers (240 registers each,
// 160 in K1) own 64 query rows each: S = Q K^T by wgmma from shared
// memory (both tiles K-major), the mask, running max, rescale and P in
// registers, then O += bf16(P) V by wgmma with A from registers (the S
// accumulator's layout is the A operand's, so P never touches shared
// memory) and V read MN-major. TMA zero-fills rows at or past N; keys
// there are still masked by index, since a zero K row gives S = 0, not
// -inf. A finished head's O leaves through the consumer's own swizzled
// staging tile by one TMA store, which clips at N; LSE from the thread
// that holds the row. No register of a wgmma group in flight is read or
// fenced before the wait that retires it (else ptxas serializes the
// chain: notes C7514, C7515, C7518). The three take their sums in
// different orders, so their O and LSE agree to within rounding, not bit
// for bit.
//
// K1 replaces ops/flash_attention.py::_fwd / _fwd_kernel / _fwd_one_head
// of the JAX package, the default forward. The TPU kernel keeps a head's
// whole K and V resident in VMEM; at N = 1370, D = 64 that is 351 KB, more
// than the 227 KB a block can have, so K and V stream through the ring,
// each with its own full and empty barrier per stage. Three consumers
// own a (batch*head, 192-query tile); a persistent grid of one block per
// SM walks the tiles (1024 at vitl, 7.76 a block), so one tile's last
// products and output store overlap the next tile's loads. Two consumers
// (1408 tiles of 128 queries) measured slower despite padding less
// (PERF.md). Consumers whose rows all lie past N only pass their turns
// and release the stages. Its bound at vitl is two near-equal parts
// (below), so K1 is built to run the exponentials and the products at
// once. In each consumer, key tile j's scores and tile j-1's PV are
// issued together and only the scores are waited for (wgmma wait depth
// 1): tile j's softmax runs on the special-function units while PV j-1
// runs on the tensor cores, and O's rescale and bf16(P) follow the wait
// for PV j-1 (so one score buffer suffices: tile j's scores become P
// before tile j+1's are issued). Between the consumers, named barriers
// make them take turns at issuing their products, so each one's softmax
// also runs under the others'. Each P is one fma and one ex2.approx; the
// mask runs on the last key tile only.
//
// K4 replaces _fwd_pair / _fwd_pair_kernel (E3D_FLASH_PAIR=1): one block
// per (heads 2p and 2p+1 of the B*H axis, 64-query tile), consumer g
// owning head 2p+g. On the TPU the two heads share a program so that the
// score product, made block diagonal, fills the MXU's 128-deep
// contraction; on Hopper that would double the FLOPs, so it is not copied.
// What pairing buys here is the load: where both heads lie in one batch
// row, one TMA box of (D, rows, 2 heads) brings each Q, K and V tile of
// both; where the pair straddles two batch rows (odd H), two boxes land in
// the same stage under one transaction count. Per key tile
// (consumer_step) a consumer waits for its scores before its softmax and
// for PV before its next scores.
//
// K5 replaces _fwd_kernel with hb heads per program under E3D_FLASH_PIPE=1
// (_fwd_kernel_pipe / _fwd_scores / _fwd_finish) and E3D_FLASH_HLOOP=1
// (the fori_loop over heads): one block per (hb consecutive heads of the
// B*H axis, 128-query tile), both consumers on the same head. The
// producer streams the block's (head, key tile) sequence through the
// ring, each head's Q (128 rows) into a buffer chosen by head parity; at
// a head's last tile each consumer normalises, writes its rows, resets
// and goes on with the next head. kPipe = true (PIPE): the producer never
// waits at a head boundary, so head h+1's Q and first K/V tile are in
// flight during head h's last tile, and each consumer issues head h+1's
// first Q K^T group before head h's last softmax, PV and write.
// kPipe = false (HLOOP): the producer loads head h+1's Q and first tile
// only after both consumers have written head h.
//
// Bound at the flagship shape (B 8, N 1370, H 16, D 64), per launch, the
// same for the three:
//   4 B H N^2 D = 61.5 GFLOP of tensor-core work -> 62 us at 989 TFLOP/s;
//   Q, K, V, O = 4 x 22.4 MB = 90 MB             -> 27 us at 3.35 TB/s;
//   B H N^2 = 240 M exponentials, about 65 us at 16 a clock per SM on
//   the special-function units.
// So they are compute-bound, and only a schedule that runs the
// exponentials under the products (K1's) can approach the larger part.
// K4 runs 1408 blocks at vitl and K5 704 (hb = 2), one block per SM (its
// 384 threads hold the register file), so 10.7 and 5.3 waves on 132 SMs.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kMaskValue = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh;
};

// ----------------------------------------------------- K1, K4, K5: shared

constexpr int kWgConsumers = 2;  // consumer warpgroups per block
constexpr int kWgThreads = 128 * (1 + kWgConsumers);  // producer first
constexpr int kWgStages = 2;
constexpr int kWgRows = kTileRows;  // query rows per consumer
// Keys per K/V tile: 128 (S in 64 registers a thread) halves the ring's
// barrier round trips against 64 and measured about a tenth faster on
// the H100 (PERF.md); the code takes either.
constexpr int kWgKeys = 128;
constexpr int kScores = kWgKeys / 2;  // registers of a 64-row score tile
constexpr int kBarStore = 1;  // + consumer: named barrier of its O store

template <int D>
using STile = SwizzledTile<D>;

// One consumer warpgroup's running state for its 64 query rows of one
// head. A thread holds rows warp * 16 + lane / 4 and that + 8.
template <int D>
struct RowState {
  float o[D / 2];  // the 64 x D f32 accumulator of bf16(P) V
  float m[2];      // running max, log2 domain
  float l[2];      // this thread's share of the running sum

  __device__ __forceinline__ void reset() {
    zero(o);
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

// Issue S = Q K^T for the consumer's 64 query rows and one key tile as
// one wgmma group (both operands K-major in shared memory; a k16 step
// advances 32 bytes along a row). Not waited for.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[kScores],
                                             uint32_t s_q, uint32_t s_k) {
  using T = STile<D>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<kWgKeys, 0, 0>(s, make_desc(s_q + kk * 32, T::kAtom, T::kMode),
                            make_desc(s_k + kk * 32, T::kAtom, T::kMode), kk);
  }
  wgmma_commit();
}

// Issue O += bf16(P) V for one key tile as one wgmma group, with P from
// registers (the score accumulator's layout is the A operand's, so P
// never touches shared memory) and V (a tile of keys x D) read MN-major,
// a k16 step being 16 key rows. Not waited for: until the wait that
// retires it, neither o nor p may be touched.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[kWgKeys / 16][4],
                                         uint32_t s_v) {
  using T = STile<D>;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgKeys / 16; ++kk) {
    wgmma_rs<D, 1>(o, p[kk],
                   make_desc(s_v + kk * 16 * T::kRowBytes, T::kAtom, T::kMode),
                   1);
  }
  wgmma_commit();
}

// The rest of a consumer step, on scores already waited for: scale into
// the log2 domain, mask keys >= N, update the running max, rescale O and
// l, form P (l sums the f32 values), then O += bf16(P) V (issue_pv).
// Waits for every group of the warpgroup, so one issued before it (the
// next head's scores) has completed on return too.
template <int D>
__device__ __forceinline__ void softmax_pv(RowState<D>& st,
                                           float (&s)[kScores], uint32_t s_v,
                                           int key0, int n_tok,
                                           float scale_log2, int t) {
  float m_new[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * j + 2 * t + (e & 1);
      const float x = key < n_tok ? s[4 * j + e] * scale_log2 : kMaskValue;
      s[4 * j + e] = x;
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
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j + 0] *= alpha[0];
    st.o[4 * j + 1] *= alpha[0];
    st.o[4 * j + 2] *= alpha[1];
    st.o[4 * j + 3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
    const float p0 = exp2f(s[4 * j + 0] - st.m[0]);
    const float p1 = exp2f(s[4 * j + 1] - st.m[0]);
    const float p2 = exp2f(s[4 * j + 2] - st.m[1]);
    const float p3 = exp2f(s[4 * j + 3] - st.m[1]);
    st.l[0] = __fadd_rn(st.l[0], __fadd_rn(p0, p1));
    st.l[1] = __fadd_rn(st.l[1], __fadd_rn(p2, p3));
    s[4 * j + 0] = p0;
    s[4 * j + 1] = p1;
    s[4 * j + 2] = p2;
    s[4 * j + 3] = p3;
  }
  uint32_t p[kWgKeys / 16][4];
  to_a_operand(s, p);
  issue_pv<D>(st.o, p, s_v);
  wgmma_wait<0>();
  fence_regs(st.o);
}

// One whole consumer step: scores of the tile, their wait, softmax and PV.
template <int D>
__device__ __forceinline__ void consumer_step(RowState<D>& st, uint32_t s_q,
                                              uint32_t s_k, uint32_t s_v,
                                              int key0, int n_tok,
                                              float scale_log2, int t) {
  float s[kScores];
  issue_scores<D>(s, s_q, s_k);
  wgmma_wait<0>();
  fence_regs(s);
  softmax_pv<D>(st, s, s_v, key0, n_tok, scale_log2, t);
}

// This warp has read the stage (or Q buffer) guarded by `bar`.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Normalise the consumer's 64 rows of head (b, h), from token row0, and
// write them: O through the consumer's staging tile (swizzled as TMA
// reads it, so a warp's stores hit 32 distinct banks) and one TMA store,
// which clips at N; LSE into (B, H, N) from the thread that holds the
// row. `tid` is the thread's index in its warpgroup.
template <int D>
__device__ __forceinline__ void store_head(const RowState<D>& st,
                                           unsigned char* s_o,
                                           const CUtensorMap* map_o,
                                           float* __restrict__ lse, int b,
                                           int h, int n_tok, int n_heads,
                                           int row0, int w, int tid) {
  using T = STile<D>;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = st.l[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // The previous store from this tile must have read it.
  if (tid == 0) bulk_wait_read();
  bar_sync(kBarStore + w, 128);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(
          s_o + T::swizzle(row * T::kRowBytes + j * 16 + 4 * t)) =
          pack_bf16(st.o[4 * j + 2 * r] / l[r],
                    st.o[4 * j + 2 * r + 1] / l[r]);
    }
    if (t == 0 && row0 + row < n_tok) {
      lse[((long long)b * n_heads + h) * n_tok + row0 + row] =
          __fadd_rn(__fmul_rn(st.m[r], kLn2), logf(l[r]));
    }
  }
  fence_proxy_async();
  bar_sync(kBarStore + w, 128);
  if (tid == 0) tma_store_4d(map_o, s_o, 0, row0, h, b);
}

// ---------------------------------------------------------------- K1

// Three consumers of 64 rows (192 queries a tile) measured faster than
// two on the H100, and a third stage bought nothing (PERF.md).
constexpr int kK1Consumers = 3;
constexpr int kK1Threads = 128 * (1 + kK1Consumers);
constexpr int kK1Regs = 160;  // 24 x 128 + 160 x 384 <= 64K
constexpr int kK1Stages = 2;
constexpr int kBarTurn = kBarStore + kK1Consumers;  // + consumer: its turn

template <int D>
struct K1Smem {
  static constexpr int kTile = STile<D>::kBytes;  // 64 rows: Q or O
  static constexpr int kKv = kWgKeys * STile<D>::kRowBytes;  // K or V
  static constexpr int kQ = 0;                               // [consumer]
  static constexpr int kK = kQ + kK1Consumers * kTile;       // [stage]
  static constexpr int kV = kK + kK1Stages * kKv;            // [stage]
  static constexpr int kO = kV + kK1Stages * kKv;            // [consumer]
  static constexpr int kBars = kO + kK1Consumers * kTile;
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty per stage.
  static constexpr int kBytes = kBars + (2 + 4 * kK1Stages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// 2^x by the special-function unit alone (ex2.approx, flushing
// subnormal results to zero): one instruction where exp2f adds range
// handling around it.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile's scores, in place: keys >= N masked
// by index (only the last, ragged tile has any), the running max m (log2
// domain) and sum l updated, and S replaced by P = exp2(S scale - m) in
// f32 (l sums those). Returns in alpha each row's rescale exp2(m_old -
// m_new), which O still needs. Scaling is monotone, so the tile's row max
// is scaled once, and each P is one fma and one ex2.
__device__ __forceinline__ void softmax_tile(float (&s)[kScores],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int key0,
                                             int n_tok, float scale_log2,
                                             int t) {
  if (key0 + kWgKeys > n_tok) {
#pragma unroll
    for (int j = 0; j < kWgKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + 8 * j + 2 * t + (e & 1) >= n_tok) s[4 * j + e] = kMaskValue;
      }
    }
  }
  // Four running maxima per row (by key parity and tile half), so the
  // reduction is four short chains, not one long one.
  float mx4[2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    mx4[e / 2][e % 2] = s[e];
    mx4[e / 2][2 + e % 2] = s[4 * (kWgKeys / 16) + e];
  }
#pragma unroll
  for (int j = 1; j < kWgKeys / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mx4[e / 2][e % 2] = fmaxf(mx4[e / 2][e % 2], s[4 * j + e]);
      mx4[e / 2][2 + e % 2] =
          fmaxf(mx4[e / 2][2 + e % 2], s[4 * (j + kWgKeys / 16) + e]);
    }
  }
  float mx[2], neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = exp2_sfu(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  // The tile's row sums in two chains per row, then l = l alpha + sum.
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
    const float p0 = exp2_sfu(fmaf(s[4 * j + 0], scale_log2, neg_m[0]));
    const float p1 = exp2_sfu(fmaf(s[4 * j + 1], scale_log2, neg_m[0]));
    const float p2 = exp2_sfu(fmaf(s[4 * j + 2], scale_log2, neg_m[1]));
    const float p3 = exp2_sfu(fmaf(s[4 * j + 3], scale_log2, neg_m[1]));
    sum[0][j % 2] = __fadd_rn(sum[0][j % 2], __fadd_rn(p0, p1));
    sum[1][j % 2] = __fadd_rn(sum[1][j % 2], __fadd_rn(p2, p3));
    s[4 * j + 0] = p0;
    s[4 * j + 1] = p1;
    s[4 * j + 2] = p2;
    s[4 * j + 3] = p3;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]),
                     __fadd_rn(sum[r][0], sum[r][1]));
  }
}

// O's two rows of this thread times their alpha.
template <int R>
__device__ __forceinline__ void rescale(float (&o)[R],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// A persistent grid, at most one block per SM, walks the (batch*head,
// 192-query tile) list: block i takes tiles i, i + grid, ... The producer
// streams each tile's Q (one 64-row tile per consumer, reloaded once every
// consumer has issued the tile's last scores) and its K and V tiles
// through one ring that runs on across tiles, K and V each with their own
// full and empty barrier per stage: a K tile is refilled once its scores
// have retired and a V tile once its PV has, so the next tile's loads run
// under this tile's last products and its output store. Each consumer
// issues key tile j's scores and tile j-1's PV as two groups, waits for
// the scores only (depth 1), and runs tile j's softmax while PV j-1 runs;
// O's rescale and bf16(P) follow the wait for PV j-1. The consumers take
// turns at issuing, round robin from consumer 0 (named barrier kBarTurn +
// w opens consumer w's turn), so each one's softmax also runs under the
// others' products.
template <int D>
__global__ void __launch_bounds__(kK1Threads, 1)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      float* __restrict__ lse, int n_tok, int n_heads,
                      int n_tiles, float scale_log2) {
  using L = K1Smem<D>;
  constexpr int S = kK1Stages;
  constexpr int kBlockRows = kK1Consumers * kWgRows;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const int n_qtiles = (n_tok + kBlockRows - 1) / kBlockRows;
  const int n_ktiles = (n_tok + kWgKeys - 1) / kWgKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kK1Consumers * 4);  // one arrival per warp
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kK1Consumers * 4);
      mbar_init(&v_empty[s], kK1Consumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_producer();
    if (threadIdx.x == 0) {
      int it = 0;  // key tiles streamed so far, over all of the block's tiles
      for (int tile = blockIdx.x, i = 0; tile < n_tiles;
           tile += gridDim.x, ++i) {
        const int bh = tile / n_qtiles;
        const int b = bh / n_heads;
        const int h = bh % n_heads;
        const int q0 = (tile % n_qtiles) * kBlockRows;
        if (i > 0) mbar_wait(q_empty, (i - 1) & 1);
        mbar_expect_tx(q_full, kK1Consumers * L::kTile);
        for (int c = 0; c < kK1Consumers; ++c) {
          tma_load_4d(smem + L::kQ + c * L::kTile, &tm_q, q_full, 0,
                      q0 + c * kWgRows, h, b);
        }
        for (int kt = 0; kt < n_ktiles; ++kt, ++it) {
          const int s = it % S;
          const uint32_t parity = ((it / S) + 1) & 1;
          if (it >= S) mbar_wait(&k_empty[s], parity);
          mbar_expect_tx(&k_full[s], L::kKv);
          tma_load_4d(smem + L::kK + s * L::kKv, &tm_k, &k_full[s], 0,
                      kt * kWgKeys, h, b);
          if (it >= S) mbar_wait(&v_empty[s], parity);
          mbar_expect_tx(&v_full[s], L::kKv);
          tma_load_4d(smem + L::kV + s * L::kKv, &tm_v, &v_full[s], 0,
                      kt * kWgKeys, h, b);
        }
      }
    }
  } else {
    setmaxnreg_consumer<kK1Regs>();
    const int w = threadIdx.x / 128 - 1;  // rows q0 + 64 w of each tile
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int t = lane % 4;
    const uint32_t s_q = smem_u32(smem + L::kQ + w * L::kTile);
    const uint32_t s_k = smem_u32(smem + L::kK);
    const uint32_t s_v = smem_u32(smem + L::kV);
    // A turn waits until the previous consumer has issued its products;
    // the last consumer opens consumer 0's first turn and not the one
    // after its own last, so every arrival meets a wait.
    auto turn_begin = [&] { bar_sync(kBarTurn + w, 2 * 128); };
    auto turn_end = [&](bool last) {
      if (!(last && w == kK1Consumers - 1)) {
        bar_arrive(kBarTurn + (w + 1) % kK1Consumers, 2 * 128);
      }
    };
    if (w == kK1Consumers - 1) bar_arrive(kBarTurn, 2 * 128);

    RowState<D> st;
    float s[kScores];
    uint32_t p[kWgKeys / 16][4];
    float alpha[2];
    int it = 0;  // key tiles consumed so far, as the producer counts them
    for (int tile = blockIdx.x, i = 0; tile < n_tiles;
         tile += gridDim.x, ++i, it += n_ktiles) {
      const bool last_tile = tile + static_cast<int>(gridDim.x) >= n_tiles;
      const int bh = tile / n_qtiles;
      const int row0 = (tile % n_qtiles) * kBlockRows + w * kWgRows;
      if (row0 >= n_tok) {
        // No row of this consumer lies before N (the last query tile's
        // trailing consumers): pass the turns and release Q and each
        // stage in the others' order, with no products.
        for (int kt = 0; kt < n_ktiles; ++kt) {
          const int cur = (it + kt) % S;
          const uint32_t parity = ((it + kt) / S) & 1;
          mbar_wait(&k_full[cur], parity);
          turn_begin();
          turn_end(false);
          release(&k_empty[cur], lane);
          mbar_wait(&v_full[cur], parity);
          release(&v_empty[cur], lane);
        }
        release(q_empty, lane);
        turn_begin();
        turn_end(last_tile);
        continue;
      }
      st.reset();
      mbar_wait(q_full, i & 1);
      // Key tile 0: its scores alone.
      mbar_wait(&k_full[it % S], (it / S) & 1);
      turn_begin();
      issue_scores<D>(s, s_q, s_k + (it % S) * L::kKv);
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(s);
      release(&k_empty[it % S], lane);
      softmax_tile(s, st.m, st.l, alpha, 0, n_tok, scale_log2, t);
      to_a_operand(s, p);
      for (int kt = 1; kt < n_ktiles; ++kt) {
        const int j = it + kt;
        const int cur = j % S;
        const int prev = (j - 1) % S;
        mbar_wait(&k_full[cur], (j / S) & 1);
        mbar_wait(&v_full[prev], ((j - 1) / S) & 1);
        turn_begin();
        issue_scores<D>(s, s_q, s_k + cur * L::kKv);
        issue_pv<D>(st.o, p, s_v + prev * L::kKv);
        turn_end(false);
        wgmma_wait<1>();  // the scores; PV j-1 runs on
        fence_regs(s);
        release(&k_empty[cur], lane);
        softmax_tile(s, st.m, st.l, alpha, kt * kWgKeys, n_tok, scale_log2,
                     t);
        wgmma_wait<0>();
        fence_regs(st.o);
        fence_regs(p);
        release(&v_empty[prev], lane);
        rescale(st.o, alpha);
        to_a_operand(s, p);
      }
      release(q_empty, lane);  // every score group of the tile has retired
      const int last = it + n_ktiles - 1;
      mbar_wait(&v_full[last % S], (last / S) & 1);
      turn_begin();
      issue_pv<D>(st.o, p, s_v + (last % S) * L::kKv);
      turn_end(last_tile);
      wgmma_wait<0>();
      fence_regs(st.o);
      release(&v_empty[last % S], lane);
      store_head<D>(st, smem + L::kO + w * L::kTile, &tm_o, lse, bh / n_heads,
                    bh % n_heads, n_tok, n_heads, row0, w, tid);
    }
    if (tid == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------- K4

template <int D>
struct PairSmem {
  static constexpr int kTile = STile<D>::kBytes;  // 64 rows: Q or O
  static constexpr int kKv = kWgKeys * STile<D>::kRowBytes;  // K or V
  static constexpr int kQ = 0;  // [head of the pair]
  static constexpr int kK = kQ + 2 * kTile;              // [stage][head]
  static constexpr int kV = kK + kWgStages * 2 * kKv;    // [stage][head]
  static constexpr int kO = kV + kWgStages * 2 * kKv;    // [consumer]
  static constexpr int kBars = kO + kWgConsumers * kTile;
  static constexpr int kBytes = kBars + (1 + 2 * kWgStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// tm_*2: boxes of two heads' 64 rows; tm_*1 and tm_o: one head's.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_fwd_pair_kernel(const __grid_constant__ CUtensorMap tm_q2,
                           const __grid_constant__ CUtensorMap tm_k2,
                           const __grid_constant__ CUtensorMap tm_v2,
                           const __grid_constant__ CUtensorMap tm_q1,
                           const __grid_constant__ CUtensorMap tm_k1,
                           const __grid_constant__ CUtensorMap tm_v1,
                           const __grid_constant__ CUtensorMap tm_o,
                           float* __restrict__ lse, int n_tok, int n_heads,
                           float scale_log2) {
  using L = PairSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWgStages;

  const int n_qtiles = (n_tok + kWgRows - 1) / kWgRows;
  const int bh0 = 2 * (blockIdx.x / n_qtiles);  // heads bh0, bh0 + 1
  const int q0 = (blockIdx.x % n_qtiles) * kWgRows;
  const int n_ktiles = (n_tok + kWgKeys - 1) / kWgKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers * 4);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_producer();
    if (threadIdx.x == 0) {
      const int b0 = bh0 / n_heads;
      const int h0 = bh0 % n_heads;
      // Where head bh0 + 1 is head 0 of the next batch row (odd H), two
      // boxes of one head each; else one box of both.
      const bool straddle = h0 == n_heads - 1;
      auto both = [&](int off, int bytes, const CUtensorMap* two,
                      const CUtensorMap* one, uint64_t* bar, int row) {
        if (!straddle) {
          tma_load_4d(smem + off, two, bar, 0, row, h0, b0);
        } else {
          tma_load_4d(smem + off, one, bar, 0, row, h0, b0);
          tma_load_4d(smem + off + bytes, one, bar, 0, row, 0, b0 + 1);
        }
      };
      mbar_expect_tx(q_full, 2 * L::kTile);
      both(L::kQ, L::kTile, &tm_q2, &tm_q1, q_full, q0);
      for (int kt = 0; kt < n_ktiles; ++kt) {
        const int s = kt % kWgStages;
        if (kt >= kWgStages) mbar_wait(&empty[s], ((kt / kWgStages) + 1) & 1);
        mbar_expect_tx(&full[s], 4 * L::kKv);
        both(L::kK + s * 2 * L::kKv, L::kKv, &tm_k2, &tm_k1, &full[s],
             kt * kWgKeys);
        both(L::kV + s * 2 * L::kKv, L::kKv, &tm_v2, &tm_v1, &full[s],
             kt * kWgKeys);
      }
    }
  } else {
    setmaxnreg_consumer();
    const int w = threadIdx.x / 128 - 1;  // head bh0 + w
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const uint32_t s_q = smem_u32(smem + L::kQ + w * L::kTile);
    const uint32_t s_k = smem_u32(smem + L::kK + w * L::kKv);
    const uint32_t s_v = smem_u32(smem + L::kV + w * L::kKv);

    RowState<D> st;
    st.reset();
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_ktiles; ++kt) {
      const int s = kt % kWgStages;
      mbar_wait(&full[s], (kt / kWgStages) & 1);
      consumer_step<D>(st, s_q, s_k + s * 2 * L::kKv, s_v + s * 2 * L::kKv,
                       kt * kWgKeys, n_tok, scale_log2, lane % 4);
      release(&empty[s], lane);
    }
    const int bh = bh0 + w;
    store_head<D>(st, smem + L::kO + w * L::kTile, &tm_o, lse, bh / n_heads,
                  bh % n_heads, n_tok, n_heads, q0, w, tid);
    if (tid == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------- K5

template <int D>
struct HeadsSmem {
  static constexpr int kTile = STile<D>::kBytes;  // 64 rows: Q or O
  static constexpr int kKv = kWgKeys * STile<D>::kRowBytes;  // K or V
  static constexpr int kQ = 0;  // [head parity][consumer]
  static constexpr int kK = kQ + 2 * kWgConsumers * kTile;  // [stage]
  static constexpr int kV = kK + kWgStages * kKv;           // [stage]
  static constexpr int kO = kV + kWgStages * kKv;           // [consumer]
  static constexpr int kBars = kO + kWgConsumers * kTile;
  // q_full[2], q_empty[2] (by head parity), full and empty per stage.
  static constexpr int kBytes = kBars + (4 + 2 * kWgStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

template <int D, bool kPipe>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_fwd_heads_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o,
                            float* __restrict__ lse, int n_tok, int n_heads,
                            int hb, float scale_log2) {
  using L = HeadsSmem<D>;
  constexpr int kBlockRows = kWgConsumers * kWgRows;  // 128 queries
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kWgStages;

  const int n_qtiles = (n_tok + kBlockRows - 1) / kBlockRows;
  const int head0 = (blockIdx.x / n_qtiles) * hb;  // first head of B*H
  const int q0 = (blockIdx.x % n_qtiles) * kBlockRows;
  const int n_ktiles = (n_tok + kWgKeys - 1) / kWgKeys;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kWgConsumers * 4);
    }
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Head hh's Q lies in buffer hh & 1; q_empty[hh & 1] completes its
  // phase hh / 2 when the consumers are done with it: PIPE after the
  // head's last scores, HLOOP once the head is written.
  if (threadIdx.x < 128) {
    setmaxnreg_producer();
    if (threadIdx.x == 0) {
      int t = 0;  // (head, key tile) step of the stream
      for (int hh = 0; hh < hb; ++hh) {
        const int bh = head0 + hh;
        const int b = bh / n_heads;
        const int h = bh % n_heads;
        const int qb = hh & 1;
        if (kPipe && hh >= 2) mbar_wait(&q_empty[qb], ((hh - 2) >> 1) & 1);
        if (!kPipe && hh >= 1) {
          mbar_wait(&q_empty[qb ^ 1], ((hh - 1) >> 1) & 1);
        }
        mbar_expect_tx(&q_full[qb], kWgConsumers * L::kTile);
        for (int c = 0; c < kWgConsumers; ++c) {
          tma_load_4d(smem + L::kQ + (kWgConsumers * qb + c) * L::kTile,
                      &tm_q, &q_full[qb], 0, q0 + c * kWgRows, h, b);
        }
        for (int kt = 0; kt < n_ktiles; ++kt, ++t) {
          const int s = t % kWgStages;
          if (t >= kWgStages) mbar_wait(&empty[s], ((t / kWgStages) + 1) & 1);
          mbar_expect_tx(&full[s], 2 * L::kKv);
          tma_load_4d(smem + L::kK + s * L::kKv, &tm_k, &full[s], 0,
                      kt * kWgKeys, h, b);
          tma_load_4d(smem + L::kV + s * L::kKv, &tm_v, &full[s], 0,
                      kt * kWgKeys, h, b);
        }
      }
    }
  } else {
    setmaxnreg_consumer();
    const int w = threadIdx.x / 128 - 1;  // rows q0 + 64 w of every head
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row0 = q0 + w * kWgRows;
    const uint32_t s_k = smem_u32(smem + L::kK);
    const uint32_t s_v = smem_u32(smem + L::kV);
    auto q_tile = [&](int qb) {
      return smem_u32(smem + L::kQ + (kWgConsumers * qb + w) * L::kTile);
    };

    RowState<D> st;
    st.reset();
    float s[kScores];
    bool have_s = false;  // PIPE: the head's first scores are formed
    int t = 0;
    for (int hh = 0; hh < hb; ++hh) {
      const int qb = hh & 1;
      if (!have_s) mbar_wait(&q_full[qb], (hh >> 1) & 1);
      for (int kt = 0; kt < n_ktiles; ++kt, ++t) {
        const int stage = t % kWgStages;
        const bool last = kt == n_ktiles - 1;
        if (!have_s) {
          mbar_wait(&full[stage], (t / kWgStages) & 1);
          issue_scores<D>(s, q_tile(qb), s_k + stage * L::kKv);
          wgmma_wait<0>();
          fence_regs(s);
        }
        have_s = false;
        if (kPipe && last) release(&q_empty[qb], lane);
        if (kPipe && last && hh + 1 < hb) {
          // Head hh + 1's first Q K^T on the tensor cores while this
          // head's last softmax, PV and write run.
          const int next = (t + 1) % kWgStages;
          float s_next[kScores];
          mbar_wait(&q_full[qb ^ 1], ((hh + 1) >> 1) & 1);
          mbar_wait(&full[next], ((t + 1) / kWgStages) & 1);
          issue_scores<D>(s_next, q_tile(qb ^ 1), s_k + next * L::kKv);
          softmax_pv<D>(st, s, s_v + stage * L::kKv, kt * kWgKeys, n_tok,
                        scale_log2, lane % 4);
          fence_regs(s_next);
#pragma unroll
          for (int i = 0; i < kScores; ++i) s[i] = s_next[i];
          have_s = true;
        } else {
          softmax_pv<D>(st, s, s_v + stage * L::kKv, kt * kWgKeys, n_tok,
                        scale_log2, lane % 4);
        }
        release(&empty[stage], lane);
        if (last) {
          const int bh = head0 + hh;
          store_head<D>(st, smem + L::kO + w * L::kTile, &tm_o, lse,
                        bh / n_heads, bh % n_heads, n_tok, n_heads, row0, w,
                        tid);
          st.reset();
          if (!kPipe) release(&q_empty[qb], lane);
        }
      }
    }
    if (tid == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------- launch

enum Variant { kK1 = 0, kK4 = 1, kK5Pipe = 2, kK5Loop = 3 };

// The kernel, grid, block size and dynamic shared memory of the last
// launch, read back by e3d_flash_attn_fwd_last_launch.
struct LastLaunch {
  const void* kernel;
  long long blocks;
  int threads;
  int smem;
};
LastLaunch g_last = {nullptr, 0, 0, 0};

template <typename Kernel>
void note_launch(Kernel kernel, long long blocks, int threads, int smem) {
  g_last = {reinterpret_cast<const void*>(kernel), blocks, threads, smem};
}

// A (B, N, H, D) bf16 view with element strides (sb, sn, sh) as a rank-4
// tensor map of dims (D, N, H, B), read or written in boxes of `rows`
// token rows of `heads` consecutive heads: a box lands as `heads`
// swizzled tiles of `rows` rows one after another.
template <int D>
CUresult encode_rows(EncodeTiled fn, CUtensorMap* map, const void* base,
                     int batch, int n_tok, int n_heads, long long sb,
                     long long sn, long long sh, int rows, int heads) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(n_tok),
                              static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D),
                             static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(heads), 1};
  return encode_bf16_4d(fn, map, base, dims, strides, box, STile<D>::kTma);
}

// The tensor maps of q (64-row boxes), k and v (key-tile boxes) by one
// head and, for K4, by two, and of the contiguous o, then the launch of
// the variant's kernel. Returns minus the driver's error when a map cannot
// be encoded.
template <int D>
int launch(Variant variant, const void* q, const void* k, const void* v,
           void* o, void* lse_out, int batch, int n_tok, int n_heads, int hb,
           const Strides& st, float scale, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  float* lse = static_cast<float*>(lse_out);
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long o_sn = (long long)n_heads * D;
  const long long o_sb = o_sn * n_tok;
  const bool pair = variant == kK4;
  CUtensorMap maps[7];  // q, k, v, o by one head; q, k, v by two (K4)
  const void* bases[3] = {q, k, v};
  const long long sbs[3] = {st.q_sb, st.k_sb, st.v_sb};
  const long long sns[3] = {st.q_sn, st.k_sn, st.v_sn};
  const long long shs[3] = {st.q_sh, st.k_sh, st.v_sh};
  for (int i = 0; i < 3; ++i) {
    for (int heads = 1; heads <= (pair ? 2 : 1); ++heads) {
      const CUresult r = encode_rows<D>(
          fn, &maps[heads == 1 ? i : 4 + i], bases[i], batch, n_tok, n_heads,
          sbs[i], sns[i], shs[i], i == 0 ? kWgRows : kWgKeys, heads);
      if (r != CUDA_SUCCESS) return -static_cast<int>(r);
    }
  }
  const CUresult r = encode_rows<D>(fn, &maps[3], o, batch, n_tok, n_heads,
                                    o_sb, o_sn, D, kWgRows, 1);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  const long long bh = (long long)batch * n_heads;
  constexpr int kBlockRows = kWgConsumers * kWgRows;
  cudaError_t err;
  if (variant == kK1) {
    // A persistent grid: one block per SM, or one per tile if fewer.
    constexpr int kRows = kK1Consumers * kWgRows;
    const long long tiles = bh * ((n_tok + kRows - 1) / kRows);
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    int device = 0, sms = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess) {
      return err;
    }
    const long long blocks = tiles < sms ? tiles : sms;
    auto kernel = flash_attn_fwd_kernel<D>;
    constexpr int smem = K1Smem<D>::kAlloc;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    note_launch(kernel, blocks, kK1Threads, smem);
    kernel<<<static_cast<unsigned>(blocks), kK1Threads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, n_tok, n_heads,
        static_cast<int>(tiles), scale_log2);
    return cudaGetLastError();
  }
  if (pair) {
    if (bh % 2) return cudaErrorInvalidValue;
    const long long blocks = bh / 2 * ((n_tok + kWgRows - 1) / kWgRows);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    auto kernel = flash_attn_fwd_pair_kernel<D>;
    constexpr int smem = PairSmem<D>::kAlloc;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    note_launch(kernel, blocks, kWgThreads, smem);
    kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(
        maps[4], maps[5], maps[6], maps[0], maps[1], maps[2], maps[3], lse,
        n_tok, n_heads, scale_log2);
    return cudaGetLastError();
  }
  if (hb < 1 || bh % hb) return cudaErrorInvalidValue;
  const long long blocks = bh / hb * ((n_tok + kBlockRows - 1) / kBlockRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kernel = flash_attn_fwd_heads_kernel<D, false>;
  if (variant == kK5Pipe) kernel = flash_attn_fwd_heads_kernel<D, true>;
  constexpr int smem = HeadsSmem<D>::kAlloc;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  note_launch(kernel, blocks, kWgThreads, smem);
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, n_tok, n_heads, hb,
      scale_log2);
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
// contiguous (B, H, N) f32. Every kernel reads q, k and v by TMA (strides
// multiples of 16 bytes, 16-byte aligned bases) and stores o by TMA. Each
// entry launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported D, an odd
// B*H for K4, or an hb that does not divide B*H), or minus the driver's
// error when a tensor map cannot be encoded.

// K1: a persistent grid over (head of the B*H axis, 192-query tile).
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

// K4: one block per (pair of heads of the B*H axis, 64-query tile).
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

// K5: one block per (hb consecutive heads of the B*H axis, 128-query
// tile); pipe != 0 overlaps each head's end with the next head's start.
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

// The last launch of the entries above: its grid in `blocks`, and in
// `per_sm` the blocks of its kernel that one SM holds at once (the
// occupancy calculator at its block size and dynamic shared memory).
// Returns the calculator's error, or cudaErrorInvalidValue before any
// launch.
extern "C" int e3d_flash_attn_fwd_last_launch(long long* blocks,
                                              int* per_sm) {
  if (g_last.kernel == nullptr) return cudaErrorInvalidValue;
  *blocks = g_last.blocks;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, g_last.kernel, g_last.threads, g_last.smem);
}
