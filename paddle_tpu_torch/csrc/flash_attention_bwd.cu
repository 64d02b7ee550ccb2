// Flash-attention backward for Hopper (sm_90a): the three passes of the
// FlashAttention-2 backward of softmax(q k^T * scale + bias) v.
//
// Replaces the TPU kernels of paddle_tpu/fluid/ops/pallas_ops.py that
// _flash_backward (:300) launches:
//   K3  dq_kernel     <- _dq_kernel (:115, pallas_call :334):
//       dq = sum_j ds_ij k_j, ds = p * (dp - delta) * scale
//   K4  dkv_kernel    <- _dkv_kernel (:152, pallas_call :367):
//       dv = sum_i p_ij do_i, dk = sum_i ds_ij q_i
//   K5  dbias_kernel  <- _dbias_kernel (:196, pallas_call :389):
//       dbias = p * (dp - delta), unscaled, written tile by tile
// with p = exp(s - lse) recomputed from the forward's saved logsumexp and
// dp = do v^T.  The caller passes the LSE and delta = rowsum(do * o)
// (pallas_ops.py:307) in; no kernel computes them, so a ring sequence-
// parallel backward can hand in a global LSE.
//
// The same functions, not the same blocks.  On the TPU each pallas_call
// walks a sequential grid and keeps whole [S, D] operands in VMEM.  Here
// all three run on the tensor cores, mma.sync with split TF32 in fp32 and
// bf16 mma in bf16 (attention_mma.cuh):
//   * K3 and K5: one thread block per (bh, 64 query rows), each of the 4
//     warps owning 16 of them (K2's layout); a loop over 32-row K/V tiles,
//     double-buffered by cp.async together with the tile's [64 q, 32 keys]
//     bias.  Q and dO come in once; lse and delta of a thread's two rows
//     stay in registers, so no global load is left in the loop.  s = q k^T
//     and dp = dO v^T land in the mma accumulators, ds = p (dp - delta) is
//     formed there, and K3 takes ds * scale as the A operand of dq += ds k
//     in place (a_from_c); K5 writes ds out as dbias.
//   * K4: one thread block per (bh, 64 K/V rows), a loop over 32-row Q/dO
//     tiles; s^T = k q^T and dp^T = v dO^T, then dv += p^T dO and dk +=
//     ds^T q with the accumulators as A operands.
//   * Every block owns its output rows outright: no atomics, and a result
//     is the same bits from run to run.
//   * In fp32 each K/V (K3, K5) or Q/dO (K4, at D = 64) tile that all 4
//     warps read as a B operand is split into its TF32 halves once, in
//     shared memory; what a warp reads alone is split as it is loaded.
//   * Under causal, tiles that lie wholly above the diagonal are skipped
//     (pallas_ops.py:144-148, :186-189, :223-227); K5 writes zeros there.
//   * Ragged edges are masked in the kernel, so every S_q and S_kv is
//     taken (the TPU kernels need multiples of the block and JAX falls
//     back to the composition for the rest, :234).
//   * The bias is read through strides, as K2 reads it: BERT's
//     [B, 1, S, S] mask is never expanded to [B*H, S, S].  Each bias tile
//     comes in by cp.async with its K/V (K3, K5) or Q/dO (K4) tile.
//
// What bounds it on an H100 SXM.  At the BERT-base training shape
// (BH = 384, S = 128, D = 64, fp32) K3 does 3 products of 2*S*S*D per
// head (s, dp, ds k) = 2.42 GFLOP, K4 4 (s, dp, p^T do, ds^T q) = 3.22
// GFLOP and K5 2 = 1.61 GFLOP: 0.010-0.020 ms in split TF32 at 495 / 3
// TFLOP/s.  They move 65-78 MB (q, k, v, dO read, the outputs written;
// K5's output is the [S, S] gradient itself, 25 MB) at 3.35 TB/s:
// 0.020-0.023 ms, so all three are bound by bytes, in bf16 too (989
// TFLOP/s, half the bytes).  Nothing else of [S, S] size reaches device
// memory.
//
// Choices, from same-call A/B probes on the card: 32-row K/V tiles in
// K3/K5 (64 rows put one block on an SM and were slower); dO read and
// split per k-step in fp32 K3 (kept in registers beside Q's it spilled);
// K5 stores two columns a thread with store2 (a quad fills whole 32-byte
// sectors; staging the tile through shared memory for 16-byte stores
// was slower in fp32); a minimum of one block per SM in the launch
// bounds (ptxas then spends more registers, spills nowhere, and K3 runs
// faster); s and dp in one loop over D (two loops were slower in K3).
//
// Numerics follow the TPU kernels: scores, p, dp, ds and all sums in fp32;
// for bf16 inputs p is rounded to bf16 before p^T do (:180) and ds before
// ds k and ds^T q (:141, :182); do is read in q's dtype (:138).  Causal
// positions above the diagonal and columns past S_kv give p = 0.

#include "attention_mma.cuh"

#include <math.h>

namespace {

constexpr int NUM_WARPS = 4;
constexpr int THREADS = NUM_WARPS * 32;
constexpr int BLOCK_Q = 64;               // K3/K5: query rows per block, 16 per warp
constexpr int Q_ROWS_BN = 32;             // K3/K5: K/V rows per tile
constexpr int Q_ROWS_BIAS_LD = Q_ROWS_BN + 8;  // K3/K5: bias tile row stride
// K3/K5 keep the block's Q fragments in registers (split once in fp32)
// except in fp32 at D = 128, and dO's too except in fp32 K3 (beside dq's
// 32 accumulators they spill at D = 64) and fp32 at D = 128
template <typename T, int D>
__host__ __device__ constexpr bool q_rows_qreg() { return sizeof(T) == 2 || D == 64; }
template <typename T, int D, bool DQ>
__host__ __device__ constexpr bool q_rows_doreg() {
  return sizeof(T) == 2 || (D == 64 && !DQ);
}
#ifdef PADDLE_ATTN_BWD_PLANTED_FAULT
// faults planted on purpose, which the backward check must catch: K3
// pairs K's rows 2t and 2t + 1 with the wrong columns of ds in ds k, K5
// swaps the two columns of each pair it writes
constexpr int DS_K_ROW_XOR = 1;
constexpr int DBIAS_PAIR_SWAP = 1;
#else
constexpr int DS_K_ROW_XOR = 0;
constexpr int DBIAS_PAIR_SWAP = 0;
#endif
constexpr int DKV_ROWS = 64;              // K4: K/V rows per block, 16 per warp
// K4: query rows per Q/dO tile.  32 keeps two blocks on an SM in fp32 at
// D = 64 (106 KB of shared memory each; 64 rows would take 157 KB) and
// the fp32 s^T, dp^T, dk and dv accumulators in registers at D = 128.
constexpr int DKV_Q_TILE = 32;
// K4 in fp32 at D = 64 splits each Q/dO tile into its TF32 halves once;
// at D = 128 the pre-split fragments do not fit in registers beside dk's
// and dv's 128 accumulators (ptxas spills), so each warp splits what it
// loads.
template <typename T, int D>
__host__ __device__ constexpr bool dkv_presplit() { return sizeof(T) == 4 && D == 64; }
// K4's shared memory: K and V, then 2 stages of {Q, dO}, of the bias tile
// and of {lse, delta}, then (pre-split) the small TF32 halves of the
// current Q and dO tiles
template <typename T, int D, int BQ>
constexpr size_t dkv_smem() {
  return sizeof(T) * (attn::ld<T, D>() * (2 * DKV_ROWS + 4 * BQ) +
                      2 * BQ * (DKV_ROWS + attn::Mma<T>::PAD)) +
         sizeof(float) * 4 * BQ +
         (dkv_presplit<T, D>() ? sizeof(float) * attn::ld<T, D>() * 2 * BQ : 0);
}

// The Q (which = 0) or dO (1) tile t as K4's warps read it: as loaded,
// or (dkv_presplit) split into TF32 halves once per tile, the small halves
// in `small`, every warp's fragments then loaded without a conversion
template <typename T, int D, int BQ>
__device__ __forceinline__ auto b_tile(T* t, float* small, int which) {
  if constexpr (dkv_presplit<T, D>()) {
    float* sm = small + which * BQ * attn::ld<float, D>();
    attn::split_tile<D, BQ, THREADS>(t, sm);
    return attn::SplitTile{t, sm};
  } else {
    return static_cast<const T*>(t);
  }
}

using attn::bf16;
using attn::from_f;
using attn::to_f;

struct Args {
  const void* q; const void* k; const void* v; const void* bias;
  int64_t bs_b, bs_h, bs_q, bs_k; int heads;
  const void* dout; const float* lse; const float* delta;
  void* out0; void* out1;                 // dq | dk, dv | dbias
  int S_q, S_kv; float scale; int causal;
};

template <typename T>
__device__ __forceinline__ const T* bias_base(const Args& a, int bh) {
  return a.bias ? static_cast<const T*>(a.bias) + (int64_t)(bh / a.heads) * a.bs_b +
                      (int64_t)(bh % a.heads) * a.bs_h
                : nullptr;
}

// K3/K5: the K (which = 0) or V (1) tile t as the warps read it: in fp32
// split into TF32 halves once per tile (the small halves in `small`), in
// bf16 as loaded
template <typename T, int D>
__device__ __forceinline__ auto kv_tile(T* t, float* small, int which) {
  if constexpr (sizeof(T) == 4) {
    float* sm = small + which * Q_ROWS_BN * attn::ld<float, D>();
    attn::split_tile<D, Q_ROWS_BN, THREADS>(t, sm);
    return attn::SplitTile{t, sm};
  } else {
    return static_cast<const T*>(t);
  }
}

// K3 and K5 share their tile loop: one block per (bh, 64 query rows), each
// of the 4 warps owning 16 of them (K2's layout); a loop over BN-row K/V
// tiles, double-buffered by cp.async together with the [64 q, BN keys]
// bias tile.  The block's Q and dO tiles come in once, and lse and delta
// of a thread's two rows (g, g + 8) stay in registers.  Per tile: s = q
// k^T and dp = dO v^T by mma, then ds = p (dp - delta) formed in the
// accumulators.  DQ (K3): dq += (ds * scale) k with the accumulator as
// the A operand, written once at the end; else (K5) ds goes out as dbias.
// Shared memory keeps these blocks at one or two on an SM, so ptxas is
// told one is enough (else it held K5 in fp32 at D = 128 to 128 registers
// and spilled).
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(THREADS, 1)
q_rows_kernel(Args a) {
  constexpr int BN = Q_ROWS_BN;
  constexpr int LD = attn::ld<T, D>();
  constexpr int KS = attn::Mma<T>::K;
  constexpr int NT = BN / 8;                      // score n-tiles per warp
  constexpr int DT = D / 8;                       // dq n-tiles per warp
  constexpr bool QREG = q_rows_qreg<T, D>();
  constexpr bool DOREG = q_rows_doreg<T, D, DQ>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);         // [BLOCK_Q][LD]
  T* dOs = Qs + BLOCK_Q * LD;                     // [BLOCK_Q][LD]
  T* KV = dOs + BLOCK_Q * LD;                     // stage s: K at KV + 2s tiles, V after
  float* SMALL = reinterpret_cast<float*>(KV + 4 * BN * LD);  // fp32: K's, V's small halves
  T* BS = reinterpret_cast<T*>(SMALL + (sizeof(T) == 4 ? 2 * BN * LD : 0));
  // stage s: the bias tile at BS + s * BLOCK_Q * Q_ROWS_BIAS_LD

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = (threadIdx.x >> 5) * 16;         // this warp's first query row
  const int S_q = a.S_q, S_kv = a.S_kv;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)bh * S_kv * D;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)bh * S_kv * D;
  const T* biasb = bias_base<T>(a, bh);

  // causal: tiles starting at or past q0 + BLOCK_Q lie wholly above the
  // diagonal for every row of the block and are skipped
  const int kv_live = a.causal ? min(S_kv, q0 + BLOCK_Q) : S_kv;
  const int ntiles = (kv_live + BN - 1) / BN;
  const bool vec = biasb != nullptr && attn::bias_vec(biasb, a.bs_q, a.bs_k);
  auto issue = [&](int i) {
    T* Ks = KV + (i & 1) * 2 * BN * LD;
    attn::load_tile_async<T, D, BN, THREADS>(Ks, kb, i * BN, S_kv);
    attn::load_tile_async<T, D, BN, THREADS>(Ks + BN * LD, vb, i * BN, S_kv);
    if (biasb != nullptr)
      attn::load_bias_async<T, BLOCK_Q, BN, Q_ROWS_BIAS_LD - BN, THREADS>(
          BS + (i & 1) * BLOCK_Q * Q_ROWS_BIAS_LD, biasb, a.bs_q, a.bs_k, q0, i * BN, S_q,
          S_kv, vec);
    attn::cp_async_commit();
  };
  attn::load_tile_async<T, D, BLOCK_Q, THREADS>(
      Qs, static_cast<const T*>(a.q) + (int64_t)bh * S_q * D, q0, S_q);
  attn::load_tile_async<T, D, BLOCK_Q, THREADS>(
      dOs, static_cast<const T*>(a.dout) + (int64_t)bh * S_q * D, q0, S_q);
  issue(0);                                       // one group: Q, dO and tile 0
  if (ntiles > 1) issue(1);

  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rw + g + 8 * r;
    lse[r] = qi < S_q ? a.lse[(int64_t)bh * S_q + qi] : 0.f;
    delta[r] = qi < S_q ? a.delta[(int64_t)bh * S_q + qi] : 0.f;
  }
  T* db = DQ ? nullptr : static_cast<T*>(a.out0) + (int64_t)bh * S_q * S_kv;
  if (!DQ && ntiles * BN < S_kv) {
    // K5 writes the columns of the skipped tiles as zeros, as
    // _dbias_kernel does
    const int z0 = ntiles * BN, w = S_kv - z0;
    for (int e = threadIdx.x; e < BLOCK_Q * w; e += THREADS) {
      const int qi = q0 + e / w;
      if (qi < S_q) db[(int64_t)qi * S_kv + z0 + e % w] = from_f<T>(0.f);
    }
  }

  attn::FragA<T> qf[QREG ? D / KS : 1], df[DOREG ? D / KS : 1];
  float dq[DQ ? DT : 1][4];
#pragma unroll
  for (int d = 0; d < (DQ ? DT : 1); ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) attn::cp_async_wait<1>(); else attn::cp_async_wait<0>();
    __syncthreads();                              // tile i (and Q, dO) landed
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / KS; ++kk) {
        if constexpr (QREG) attn::load_a(qf[kk], Qs, LD, rw, kk * KS, lane);
        if constexpr (DOREG) attn::load_a(df[kk], dOs, LD, rw, kk * KS, lane);
      }
    }
    T* Kraw = KV + (i & 1) * 2 * BN * LD;
    const auto Ks = kv_tile<T, D>(Kraw, SMALL, 0);
    const auto Vs = kv_tile<T, D>(Kraw + BN * LD, SMALL, 1);
    if constexpr (sizeof(T) == 4) __syncthreads();  // the split tiles are written
    T* Bs = BS + (i & 1) * BLOCK_Q * Q_ROWS_BIAS_LD;
    const int k0 = i * BN;

    // s = q k^T and dp = dO v^T for the warp's 16 rows and the tile's keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / KS; ++kk) {
      attn::FragA<T> qa, da;
      if constexpr (QREG) qa = qf[kk];
      else attn::load_a(qa, Qs, LD, rw, kk * KS, lane);
      if constexpr (DOREG) da = df[kk];
      else attn::load_a(da, dOs, LD, rw, kk * KS, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        attn::FragB<T> b;
        attn::load_bt(b, Ks, LD, n * 8, kk * KS, lane);
        attn::mma(s[n], qa, b);
        attn::load_bt(b, Vs, LD, n * 8, kk * KS, lane);
        attn::mma(dp[n], da, b);
      }
    }

    // ds into dp: element e of n-tile n is query row g + 8 (e >> 1), key
    // column n * 8 + 2t + (e & 1); the bias pair read in one load
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + rw + g + 8 * r;
        float bb[2] = {0.f, 0.f};
        if (biasb != nullptr)
          attn::load2(Bs + (rw + g + 8 * r) * Q_ROWS_BIAS_LD + n * 8 + 2 * t, bb[0], bb[1]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = k0 + n * 8 + 2 * t + c;
          float p = 0.f;
          if (qi < S_q && kj < S_kv && !(a.causal && qi < kj))
            p = expf(s[n][2 * r + c] * a.scale + bb[c] - lse[r]);
          const float ds = p * (dp[n][2 * r + c] - delta[r]);
          dp[n][2 * r + c] = DQ ? ds * a.scale : ds;
        }
      }

    if constexpr (DQ) {
      // dq += ds k (bf16: ds rounded in a_from_c, the TPU kernel's
      // ds.astype(q.dtype))
#pragma unroll
      for (int kk = 0; kk < BN / KS; ++kk) {
        attn::FragA<T> dsa;
        attn::a_from_c(dsa, dp, kk);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          attn::FragB<T> b;
          attn::load_b(b, Ks, LD, kk * KS, d * 8, lane, DS_K_ROW_XOR);
          attn::mma(dq[d], dsa, b);
        }
      }
    } else {
      // ds as dbias, two columns a store where the row allows
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 + rw + g + 8 * r, kj = k0 + n * 8 + 2 * t;
          if (qi >= S_q || kj >= S_kv) continue;
          T* dst = db + (int64_t)qi * S_kv + kj;
          const float x = dp[n][2 * r + DBIAS_PAIR_SWAP], y = dp[n][2 * r + !DBIAS_PAIR_SWAP];
          if (S_kv % 2 == 0) {
            attn::store2(dst, x, y);
          } else {
            dst[0] = from_f<T>(x);
            if (kj + 1 < S_kv) dst[1] = from_f<T>(y);
          }
        }
    }
    __syncthreads();                              // every warp is done with this stage
    if (i + 2 < ntiles) issue(i + 2);
  }

  if constexpr (DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + rw + g + 8 * r;
      if (qi >= S_q) continue;
      T* row = static_cast<T*>(a.out0) + ((int64_t)bh * S_q + qi) * D + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) attn::store2(row + d * 8, dq[d][2 * r], dq[d][2 * r + 1]);
    }
  }
}

// K4 on the tensor cores: one block per (bh, 64 K/V rows), each of the 4
// warps owning 16 of them; a loop over BQ-row Q/dO tiles, double-buffered
// by cp.async together with the tile's bias, lse and delta (read from
// device memory inside the loop, they left every tile waiting on them).
// Per tile: s^T = k q^T and dp^T = v dO^T by mma (Q and dO as B operands
// from shared memory), p^T and ds^T formed in the accumulators with lse
// and delta per query column, then dv += p^T dO and dk += ds^T q with
// those accumulators as A operands (attention_mma.cuh).
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(Args a) {
  constexpr int BR = DKV_ROWS;
  constexpr int LD = attn::ld<T, D>();
  constexpr int KS = attn::Mma<T>::K;
  constexpr int NQ = BQ / 8;                      // s^T n-tiles per warp
  constexpr int DT = D / 8;                       // dk/dv n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);         // [BR][LD]
  T* Vs = Ks + BR * LD;                           // [BR][LD]
  T* QD = Vs + BR * LD;                           // stage s: Q at QD + 2s tiles, dO after
  constexpr int LDB = BR + attn::Mma<T>::PAD;     // bias tile [BQ q][BR keys] row stride
  T* BS = QD + 4 * BQ * LD;                       // stage s: bias tile at BS + s tiles
  float* LS = reinterpret_cast<float*>(BS + 2 * BQ * LDB);
  // stage s: lse at LS + 2s * BQ, delta after
  float* SMALL = LS + 4 * BQ;                     // pre-split: Q's, then dO's small halves

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * BR;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = (threadIdx.x >> 5) * 16;         // this warp's first K/V row
  const int S_q = a.S_q, S_kv = a.S_kv;
  const T* qb = static_cast<const T*>(a.q) + (int64_t)bh * S_q * D;
  const T* dob = static_cast<const T*>(a.dout) + (int64_t)bh * S_q * D;
  const float* lseb = a.lse + (int64_t)bh * S_q;
  const float* deltab = a.delta + (int64_t)bh * S_q;
  const T* biasb = bias_base<T>(a, bh);

  // causal: Q tiles that end at or before kv0 see none of these keys
  const int q_first = a.causal ? kv0 / BQ * BQ : 0;
  const int ntiles = (S_q - q_first + BQ - 1) / BQ;
  const bool vec = biasb != nullptr && attn::bias_vec(biasb, a.bs_q, a.bs_k);
  auto issue = [&](int i) {
    const int q0 = q_first + i * BQ;
    T* Qs = QD + (i & 1) * 2 * BQ * LD;
    attn::load_tile_async<T, D, BQ, THREADS>(Qs, qb, q0, S_q);
    attn::load_tile_async<T, D, BQ, THREADS>(Qs + BQ * LD, dob, q0, S_q);
    if (biasb != nullptr)
      attn::load_bias_async<T, BQ, BR, attn::Mma<T>::PAD, THREADS>(
          BS + (i & 1) * BQ * LDB, biasb, a.bs_q, a.bs_k, q0, kv0, S_q, S_kv, vec);
    if (threadIdx.x < 2 * BQ) {
      const int j = threadIdx.x % BQ;
      const float* src = threadIdx.x < BQ ? lseb : deltab;
      attn::cp_async4(LS + (i & 1) * 2 * BQ + threadIdx.x, src + (q0 + j < S_q ? q0 + j : 0),
                      q0 + j < S_q);
    }
    attn::cp_async_commit();
  };
  attn::load_tile_async<T, D, BR, THREADS>(
      Ks, static_cast<const T*>(a.k) + (int64_t)bh * S_kv * D, kv0, S_kv);
  attn::load_tile_async<T, D, BR, THREADS>(
      Vs, static_cast<const T*>(a.v) + (int64_t)bh * S_kv * D, kv0, S_kv);
  issue(0);                                       // one group: K, V and tile 0
  if (ntiles > 1) issue(1);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) attn::cp_async_wait<1>(); else attn::cp_async_wait<0>();
    __syncthreads();                              // tile i (and K, V) landed
    const int q0 = q_first + i * BQ;
    T* Qraw = QD + (i & 1) * 2 * BQ * LD;
    const auto Qs = b_tile<T, D, BQ>(Qraw, SMALL, 0);
    const auto dOs = b_tile<T, D, BQ>(Qraw + BQ * LD, SMALL, 1);
    if constexpr (dkv_presplit<T, D>()) __syncthreads();  // the split tiles are written
    const T* Bs = BS + (i & 1) * BQ * LDB;
    const float* Ls = LS + (i & 1) * 2 * BQ;

    // transposed: [key][query]
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / KS; ++kk) {
      attn::FragA<T> ka, va;
      attn::load_a(ka, Ks, LD, rw, kk * KS, lane);
      attn::load_a(va, Vs, LD, rw, kk * KS, lane);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        attn::FragB<T> b;
        attn::load_bt(b, Qs, LD, n * 8, kk * KS, lane);
        attn::mma(s[n], ka, b);
        attn::load_bt(b, dOs, LD, n * 8, kk * KS, lane);
        attn::mma(dp[n], va, b);
      }
    }

    // p^T into s, ds^T into dp: element e of n-tile n is key row
    // g + 8 (e >> 1), query column n * 8 + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qq = n * 8 + 2 * t + c, qi = q0 + qq;
        const float lse = Ls[qq], delta = Ls[BQ + qq];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kj = kv0 + rw + g + 8 * r;
          float p = 0.f;
          if (qi < S_q && kj < S_kv && !(a.causal && qi < kj)) {
            float x = s[n][2 * r + c] * a.scale;
            if (biasb != nullptr) x += to_f(Bs[qq * LDB + rw + g + 8 * r]);
            p = expf(x - lse);
          }
          s[n][2 * r + c] = p;
          dp[n][2 * r + c] = p * (dp[n][2 * r + c] - delta) * a.scale;
        }
      }

    // dv += p^T dO, dk += ds^T q (bf16: p and ds rounded in a_from_c)
#pragma unroll
    for (int kk = 0; kk < BQ / KS; ++kk) {
      attn::FragA<T> pa, dsa;
      attn::a_from_c(pa, s, kk);
      attn::a_from_c(dsa, dp, kk);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        attn::FragB<T> b;
        attn::load_b(b, dOs, LD, kk * KS, d * 8, lane);
        attn::mma(dv[d], pa, b);
        attn::load_b(b, Qs, LD, kk * KS, d * 8, lane);
        attn::mma(dk[d], dsa, b);
      }
    }
    __syncthreads();                              // every warp is done with this stage
    if (i + 2 < ntiles) issue(i + 2);
  }

  T* dkp = static_cast<T*>(a.out0);
  T* dvp = static_cast<T*>(a.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kv0 + rw + g + 8 * r;
    if (kj >= S_kv) continue;
    const int64_t off = ((int64_t)bh * S_kv + kj) * D + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      attn::store2(dkp + off + d * 8, dk[d][2 * r], dk[d][2 * r + 1]);
      attn::store2(dvp + off + d * 8, dv[d][2 * r], dv[d][2 * r + 1]);
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream, const Args& a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool DQ>
cudaError_t launch_q_rows(const Args& a, int BH, cudaStream_t stream) {
  // Q and dO, 2 stages of K and V, (fp32) the small halves of the current
  // K and V tiles, then 2 stages of the bias tile (K5 always has a bias)
  constexpr int LD = attn::ld<T, D>(), BN = Q_ROWS_BN;
  const bool bias = a.bias != nullptr || !DQ;
  const size_t smem = sizeof(T) * (LD * (2 * BLOCK_Q + 4 * BN) +
                                   (bias ? 2 * BLOCK_Q * Q_ROWS_BIAS_LD : 0)) +
                      (sizeof(T) == 4 ? sizeof(float) * 2 * BN * LD : 0);
  return launch(q_rows_kernel<T, D, DQ>, dim3((a.S_q + BLOCK_Q - 1) / BLOCK_Q, BH), smem,
                stream, a);
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, int BH, cudaStream_t stream) {
  constexpr int BQ = DKV_Q_TILE;
  constexpr size_t smem = dkv_smem<T, D, BQ>();
  return launch(dkv_kernel<T, D, BQ>, dim3((a.S_kv + DKV_ROWS - 1) / DKV_ROWS, BH), smem,
                stream, a);
}

// which: 0 = dq (K3), 1 = dk/dv (K4), 2 = dbias (K5)
template <typename T, int D>
cudaError_t dispatch_which(int which, const Args& a, int BH, cudaStream_t stream) {
  if (which == 0) return launch_q_rows<T, D, true>(a, BH, stream);
  if (which == 1) return launch_dkv<T, D>(a, BH, stream);
  if (which == 2) return launch_q_rows<T, D, false>(a, BH, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(int which, int D, const Args& a, int BH, cudaStream_t stream) {
  if (D == 64) return dispatch_which<T, 64>(which, a, BH, stream);
  if (D == 128) return dispatch_which<T, 128>(which, a, BH, stream);
  return cudaErrorInvalidValue;
}

int run(int which, int dtype, const void* q, const void* k, const void* v, const void* bias,
        int64_t bs_b, int64_t bs_h, int64_t bs_q, int64_t bs_k, int heads, const void* dout,
        const void* lse, const void* delta, void* out0, void* out1, int BH, int S_q, int S_kv,
        int D, float scale, int causal, void* stream) {
  cudaGetLastError();  // clear a stale non-sticky error so the code below is this launch's
  Args a{q, k, v, bias, bs_b, bs_h, bs_q, bs_k, heads, dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta), out0, out1,
         S_q, S_kv, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(which, D, a, BH, st);
  if (dtype == 1) return (int)dispatch_d<bf16>(which, D, a, BH, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Common arguments: dtype 0 = float32, 1 = bfloat16 (q, k, v, bias, dout
// and the outputs share it); q/dout [BH, S_q, D], k/v [BH, S_kv, D], all
// contiguous; bias may be null, element (bh, i, j) at bias + (bh / heads)
// * bs_b + (bh % heads) * bs_h + i * bs_q + j * bs_k; lse and delta fp32
// [BH, S_q].  Each returns the launch's cudaError_t (0 on success) and
// does not synchronise.
#define BWD_ARGS                                                                          \
  int dtype, const void *q, const void *k, const void *v, const void *bias, int64_t bs_b, \
      int64_t bs_h, int64_t bs_q, int64_t bs_k, int heads, const void *dout,              \
      const void *lse, const void *delta
#define BWD_TAIL int BH, int S_q, int S_kv, int D, float scale, int causal, void *stream

// K3: dq [BH, S_q, D]
extern "C" int paddle_flash_attention_bwd_dq(BWD_ARGS, void* dq, BWD_TAIL) {
  return run(0, dtype, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, heads, dout, lse, delta, dq,
             nullptr, BH, S_q, S_kv, D, scale, causal, stream);
}

// K4: dk, dv [BH, S_kv, D]
extern "C" int paddle_flash_attention_bwd_dkv(BWD_ARGS, void* dk, void* dv, BWD_TAIL) {
  return run(1, dtype, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, heads, dout, lse, delta, dk, dv,
             BH, S_q, S_kv, D, scale, causal, stream);
}

// K5: dbias [BH, S_q, S_kv], unscaled
extern "C" int paddle_flash_attention_bwd_dbias(BWD_ARGS, void* dbias, BWD_TAIL) {
  return run(2, dtype, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, heads, dout, lse, delta, dbias,
             nullptr, BH, S_q, S_kv, D, scale, causal, stream);
}

extern "C" const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
