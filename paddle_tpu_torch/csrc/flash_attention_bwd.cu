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
// walks a sequential grid and keeps whole [S, D] operands in VMEM.  Here:
//   * K3 and K5: one thread block per (bh, 64 query rows), a loop over
//     64-row K/V tiles inside it.  Each of the 4 warps owns 16 query rows
//     (K2's layout), so a row's values never leave its warp.
//   * K4: one thread block per (bh, K/V tile), a loop over 64-row Q tiles.
//     The block owns its dK/dV rows outright: no atomics, and the result
//     is the same bits from run to run.  At D = 128 a block takes 32 K/V
//     rows, so its two fp32 [rows, D] accumulators stay in registers.
//   * Under causal, tiles that lie wholly above the diagonal are skipped
//     (pallas_ops.py:144-148, :186-189, :223-227); K5 writes zeros there.
//   * Ragged edges are masked in the kernel, so every S_q and S_kv is
//     taken (the TPU kernels need multiples of the block and JAX falls
//     back to the composition for the rest, :234).
//   * The bias is read through strides, as K2 reads it: BERT's
//     [B, 1, S, S] mask is never expanded to [B*H, S, S].  K4 stages each
//     [64 q, rows] bias tile in shared memory with coalesced loads.
//
// What bounds it on an H100 SXM.  At the BERT-base training shape
// (BH = 384, S = 128, D = 64, fp32) K3 does 3 products of 2*S*S*D per
// head (s, dp, ds k) = 2.42 GFLOP, K4 4 (s, dp, p^T do, ds^T q) = 3.22
// GFLOP and K5 2 = 1.61 GFLOP, on the CUDA cores at 67 TFLOP/s fp32
// (TF32 tensor cores would change the numbers): 0.036, 0.048 and 0.024 ms.
// They move 38-78 MB at 3.35 TB/s (0.011-0.023 ms), so all three are
// bound by operations in fp32; in bf16 (989 TFLOP/s on the tensor cores,
// half the bytes) by bytes.  What the design does about it: nothing of
// [S, S] size reaches device memory except K5's output, which is the
// gradient itself; scores stay in registers, p and ds in per-warp shared
// strips; fp32 FMA is register-blocked (16 x 2 score tiles per thread)
// with every shared-memory read a broadcast or 32 consecutive words.  This
// first version is simple and correct; mma/wgmma, TMA and warp
// specialisation are later work.
//
// Numerics follow the TPU kernels: scores, p, dp, ds and all sums in fp32;
// for bf16 inputs p is rounded to bf16 before p^T do (:180) and ds before
// ds k and ds^T q (:141, :182); do is read in q's dtype (:138).  Causal
// positions above the diagonal and columns past S_kv give p = 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_WARPS = 4;
constexpr int THREADS = NUM_WARPS * 32;
constexpr int TILE = 64;                  // columns per tile; a lane owns 2
constexpr int TS = TILE + 1;              // padded stride of transposed tiles
constexpr int BLOCK_Q = 64;               // K3/K5: query rows per block

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

// x rounded to T and back (the TPU kernels' astype(q.dtype) before a dot)
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

struct Args {
  const void* q; const void* k; const void* v; const void* bias;
  int64_t bs_b, bs_h, bs_q, bs_k; int heads;
  const void* dout; const float* lse; const float* delta;
  void* out0; void* out1;                 // dq | dk, dv | dbias
  int S_q, S_kv; float scale; int causal;
};

// rows [row0, row0 + rows) of a [n, D] matrix into shared memory, fp32
// row-major, zero past row n
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0, int rows, int n) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D;
    dst[e] = (row0 + r < n) ? to_f(src[(int64_t)row0 * D + e]) : 0.f;
  }
}

// rows [row0, row0 + TILE) of a [n, D] matrix into shared memory
// transposed, dst[d * TS + r], zero past row n
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* src, int row0, int n) {
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    dst[c * TS + r] = (row0 + r < n) ? to_f(src[(int64_t)row0 * D + e]) : 0.f;
  }
}

// s[r][c] = A[r0 + r] . Bt[:, lane + 32 c] and t[r][c] = A2[r0 + r] .
// B2t[:, lane + 32 c]: two [ROWS x 2] score tiles per thread, A rows read
// as broadcasts, Bt columns as 32 consecutive words
template <int D, int ROWS>
__device__ __forceinline__ void two_products(const float* A, const float* Bt,
                                             const float* A2, const float* B2t,
                                             int r0, int lane, float (&s)[ROWS][2],
                                             float (&t)[ROWS][2]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = t[r][0] = t[r][1] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    const float b0 = Bt[d * TS + lane], b1 = Bt[d * TS + lane + 32];
    const float c0 = B2t[d * TS + lane], c1 = B2t[d * TS + lane + 32];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float a = A[(r0 + r) * D + d], a2 = A2[(r0 + r) * D + d];
      s[r][0] = fmaf(a, b0, s[r][0]);
      s[r][1] = fmaf(a, b1, s[r][1]);
      t[r][0] = fmaf(a2, c0, t[r][0]);
      t[r][1] = fmaf(a2, c1, t[r][1]);
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* bias_base(const Args& a, int bh) {
  return a.bias ? static_cast<const T*>(a.bias) + (int64_t)(bh / a.heads) * a.bs_b +
                      (int64_t)(bh % a.heads) * a.bs_h
                : nullptr;
}

// K3 and K5 share their tile: one block per (bh, 64 query rows); per K/V
// tile, p and ds for the block's rows.  DQ accumulates ds k (K3); else the
// unscaled ds is written out as dbias (K5).
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(THREADS)
q_rows_kernel(Args a) {
  constexpr int ROWS = BLOCK_Q / NUM_WARPS;       // query rows per warp
  constexpr int DV = D / 32;                      // dq dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                               // [BLOCK_Q][D]
  float* dOs = Qs + BLOCK_Q * D;                  // [BLOCK_Q][D]
  float* Kt = dOs + BLOCK_Q * D;                  // [D][TS], K transposed
  float* Vt = Kt + D * TS;                        // [D][TS], V transposed
  float* Ps = Vt + D * TS;                        // [BLOCK_Q][TILE], ds (K3)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * ROWS;
  const int S_q = a.S_q, S_kv = a.S_kv;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)bh * S_kv * D;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)bh * S_kv * D;
  const T* biasb = bias_base<T>(a, bh);

  load_rows<T, D>(Qs, static_cast<const T*>(a.q) + (int64_t)bh * S_q * D, q0, BLOCK_Q, S_q);
  load_rows<T, D>(dOs, static_cast<const T*>(a.dout) + (int64_t)bh * S_q * D, q0, BLOCK_Q,
                  S_q);
  float lse[ROWS], delta[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + r0 + r;
    lse[r] = qi < S_q ? a.lse[(int64_t)bh * S_q + qi] : 0.f;
    delta[r] = qi < S_q ? a.delta[(int64_t)bh * S_q + qi] : 0.f;
  }
  float acc[DQ ? ROWS : 1][DV];
  if (DQ) {
#pragma unroll
    for (int r = 0; r < (DQ ? ROWS : 1); ++r)
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[r][j] = 0.f;
  }
  T* db = DQ ? nullptr : static_cast<T*>(a.out0) + (int64_t)bh * S_q * S_kv;

  // causal: tiles starting at or past q0 + BLOCK_Q are above the diagonal
  // for every row of the block
  const int kv_live = a.causal ? min(S_kv, q0 + BLOCK_Q) : S_kv;
  if (!DQ) {
    // K5 writes those dead tiles as zeros, as _dbias_kernel does
    for (int k0 = (kv_live + TILE - 1) / TILE * TILE; k0 < S_kv; k0 += TILE)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = q0 + r0 + r, kj = k0 + lane + 32 * c;
          if (qi < S_q && kj < S_kv) db[(int64_t)qi * S_kv + kj] = from_f<T>(0.f);
        }
  }
  for (int k0 = 0; k0 < kv_live; k0 += TILE) {
    __syncthreads();  // Qs/dOs written; previous tile's Kt/Vt/Ps reads done
    load_t<T, D>(Kt, kb, k0, S_kv);
    load_t<T, D>(Vt, vb, k0, S_kv);
    __syncthreads();

    float s[ROWS][2], dp[ROWS][2];
    two_products<D, ROWS>(Qs, Kt, dOs, Vt, r0, lane, s, dp);

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + lane + 32 * c;
        float p = 0.f;
        if (qi < S_q && kj < S_kv && !(a.causal && qi < kj)) {
          float x = s[r][c] * a.scale;
          if (biasb != nullptr) x += to_f(biasb[(int64_t)qi * a.bs_q + (int64_t)kj * a.bs_k]);
          p = expf(x - lse[r]);
        }
        const float ds = p * (dp[r][c] - delta[r]);
        if (DQ) {
          Ps[(r0 + r) * TILE + lane + 32 * c] = round_t<T>(ds * a.scale);
        } else if (qi < S_q && kj < S_kv) {
          db[(int64_t)qi * S_kv + kj] = from_f<T>(ds);
        }
      }
    }
    if (DQ) {
      __syncwarp();  // each warp reads back only its own Ps rows
#pragma unroll 2
      for (int kk = 0; kk < TILE; ++kk) {
        float kv[DV];
#pragma unroll
        for (int j = 0; j < DV; ++j) kv[j] = Kt[(lane + 32 * j) * TS + kk];
#pragma unroll
        for (int r = 0; r < (DQ ? ROWS : 1); ++r) {
          const float ds = Ps[(r0 + r) * TILE + kk];
#pragma unroll
          for (int j = 0; j < DV; ++j) acc[r][j] = fmaf(ds, kv[j], acc[r][j]);
        }
      }
    }
  }
  if (DQ) {
    T* dq = static_cast<T*>(a.out0);
#pragma unroll
    for (int r = 0; r < (DQ ? ROWS : 1); ++r) {
      const int qi = q0 + r0 + r;
      if (qi >= S_q) continue;
      T* row = dq + ((int64_t)bh * S_q + qi) * D;
#pragma unroll
      for (int j = 0; j < DV; ++j) row[lane + 32 * j] = from_f<T>(acc[r][j]);
    }
  }
}

// K4: one block per (bh, BR K/V rows); per 64-row Q tile, the transposed
// scores p^T and ds^T of the block's rows, then dv += p^T do, dk += ds^T q.
template <typename T, int D, int BR>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(Args a) {
  constexpr int ROWS = BR / NUM_WARPS;            // K/V rows per warp
  constexpr int DV = D / 32;
  extern __shared__ float smem[];
  float* Ks = smem;                               // [BR][D]
  float* Vs = Ks + BR * D;                        // [BR][D]
  float* Qt = Vs + BR * D;                        // [D][TS], Q tile transposed
  float* dOt = Qt + D * TS;                       // [D][TS], dO tile transposed
  float* PsT = dOt + D * TS;                      // [BR][TILE] p^T, rounded to T
  float* DsT = PsT + BR * TILE;                   // [BR][TILE] ds^T, rounded
  float* BsT = DsT + BR * TILE;                   // [BR][TS] bias tile^T

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * BR;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * ROWS;
  const int S_q = a.S_q, S_kv = a.S_kv;
  const T* qb = static_cast<const T*>(a.q) + (int64_t)bh * S_q * D;
  const T* dob = static_cast<const T*>(a.dout) + (int64_t)bh * S_q * D;
  const float* lseb = a.lse + (int64_t)bh * S_q;
  const float* deltab = a.delta + (int64_t)bh * S_q;
  const T* biasb = bias_base<T>(a, bh);

  load_rows<T, D>(Ks, static_cast<const T*>(a.k) + (int64_t)bh * S_kv * D, kv0, BR, S_kv);
  load_rows<T, D>(Vs, static_cast<const T*>(a.v) + (int64_t)bh * S_kv * D, kv0, BR, S_kv);
  float dk[ROWS][DV], dv[ROWS][DV];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DV; ++j) dk[r][j] = dv[r][j] = 0.f;

  // causal: Q tiles that end at or before kv0 see none of these keys
  const int q_first = a.causal ? kv0 / TILE * TILE : 0;
  for (int q0 = q_first; q0 < S_q; q0 += TILE) {
    __syncthreads();  // Ks/Vs written; previous tile's reads done
    load_t<T, D>(Qt, qb, q0, S_q);
    load_t<T, D>(dOt, dob, q0, S_q);
    if (biasb != nullptr) {
      // consecutive threads take consecutive keys: coalesced when bs_k = 1
      for (int e = threadIdx.x; e < TILE * BR; e += THREADS) {
        const int qq = e / BR, rr = e - qq * BR;
        const int qi = q0 + qq, kj = kv0 + rr;
        BsT[rr * TS + qq] = (qi < S_q && kj < S_kv)
                                ? to_f(biasb[(int64_t)qi * a.bs_q + (int64_t)kj * a.bs_k])
                                : 0.f;
      }
    }
    float lse[2], delta[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int qi = q0 + lane + 32 * c;
      lse[c] = qi < S_q ? lseb[qi] : 0.f;
      delta[c] = qi < S_q ? deltab[qi] : 0.f;
    }
    __syncthreads();

    float s[ROWS][2], dp[ROWS][2];                // transposed: [key][query]
    two_products<D, ROWS>(Ks, Qt, Vs, dOt, r0, lane, s, dp);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int kj = kv0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = q0 + lane + 32 * c;
        float p = 0.f;
        if (qi < S_q && kj < S_kv && !(a.causal && qi < kj)) {
          float x = s[r][c] * a.scale;
          if (biasb != nullptr) x += BsT[(r0 + r) * TS + lane + 32 * c];
          p = expf(x - lse[c]);
        }
        PsT[(r0 + r) * TILE + lane + 32 * c] = round_t<T>(p);
        DsT[(r0 + r) * TILE + lane + 32 * c] =
            round_t<T>(p * (dp[r][c] - delta[c]) * a.scale);
      }
    }
    __syncwarp();  // each warp reads back only its own PsT/DsT rows
#pragma unroll 2
    for (int qq = 0; qq < TILE; ++qq) {
      float dov[DV], qv[DV];
#pragma unroll
      for (int j = 0; j < DV; ++j) {
        dov[j] = dOt[(lane + 32 * j) * TS + qq];
        qv[j] = Qt[(lane + 32 * j) * TS + qq];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = PsT[(r0 + r) * TILE + qq];
        const float ds = DsT[(r0 + r) * TILE + qq];
#pragma unroll
        for (int j = 0; j < DV; ++j) {
          dv[r][j] = fmaf(p, dov[j], dv[r][j]);
          dk[r][j] = fmaf(ds, qv[j], dk[r][j]);
        }
      }
    }
  }
  T* dkp = static_cast<T*>(a.out0);
  T* dvp = static_cast<T*>(a.out1);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int kj = kv0 + r0 + r;
    if (kj >= S_kv) continue;
    const int64_t off = ((int64_t)bh * S_kv + kj) * D;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      dkp[off + lane + 32 * j] = from_f<T>(dk[r][j]);
      dvp[off + lane + 32 * j] = from_f<T>(dv[r][j]);
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
  const size_t smem = sizeof(float) * (2 * BLOCK_Q * D + 2 * D * TS + (DQ ? BLOCK_Q * TILE : 0));
  return launch(q_rows_kernel<T, D, DQ>, dim3((a.S_q + BLOCK_Q - 1) / BLOCK_Q, BH), smem,
                stream, a);
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, int BH, cudaStream_t stream) {
  constexpr int BR = D == 128 ? 32 : 64;
  const size_t smem = sizeof(float) * (2 * BR * D + 2 * D * TS + 2 * BR * TILE + BR * TS);
  return launch(dkv_kernel<T, D, BR>, dim3((a.S_kv + BR - 1) / BR, BH), smem, stream, a);
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
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(which, D, a, BH, st);
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
