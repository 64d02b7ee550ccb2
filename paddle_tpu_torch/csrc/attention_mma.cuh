// Tensor-core building blocks of the flash-attention kernels for Hopper
// (sm_90a): mma.sync fragments, the split-TF32 product, cp.async tile
// loads.  Used by K2 (flash_attention_fwd.cu), and by K3/K5
// (q_rows_kernel) and K4 (dkv_kernel) in flash_attention_bwd.cu.
//
// Every product is one warp's mma.sync on a 16-row tile:
//   * float32: m16n8k8 TF32 with a split-TF32 product.  Each operand x is
//     taken as big + small, big = x rounded to TF32 (10 explicit mantissa
//     bits) and small = (x - big) rounded again, and a b is summed as
//     a_s b_b + a_b b_s + a_b b_b, small terms first.  That keeps ~22
//     mantissa bits of each product (one TF32 pass keeps 11), at three
//     tensor-core products for one: 495 / 3 TFLOP/s on an H100 SXM
//     against 67 TFLOP/s for fp32 FMA on the CUDA cores.
//   * bfloat16: m16n8k16 bf16 -> fp32, one pass (bf16 inputs multiply
//     exactly, so it is the same sum as fp32 FMA on them).
//
// Fragments (lane = 4 g + t; "c" is an m16n8 accumulator): thread holds
// c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1].
// A TF32 A fragment holds A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; a
// bf16 one A[g][2t..2t+1], A[g+8][2t..2t+1], A[g][2t+8..], A[g+8][2t+8..].
//
// The second product of attention (p v in K2, ds k in K3, p^T dO and
// ds^T q in K4) takes the first product's accumulator as its A operand
// without moving data between lanes (a_from_c):
//   * bf16: the accumulators of n-tiles 2j and 2j+1 are A's k-step j as
//     they stand (the FlashAttention-2 layout);
//   * TF32: n-tile j is k-step j with its summed index permuted: A's
//     column t is C's column 2t and A's column t + 4 is C's column 2t + 1,
//     so load_b reads B's rows 2t and 2t + 1 of the k-step.
// No probability strip goes through shared memory.
//
// Shared tiles are row-major with a padded row stride (ld: D + 4 floats,
// D + 8 bf16; 16 bytes of padding), so that the 8 rows x 4 columns of a
// fragment load fall on 32 distinct banks, and each row starts on a
// 16-byte boundary for cp.async.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

// the mma's depth (k per instruction) and the padded row stride of a
// [rows][D] shared tile of T
template <typename T> struct Mma;
template <> struct Mma<float> { static constexpr int K = 8, PAD = 4; };
template <> struct Mma<bf16> { static constexpr int K = 16, PAD = 8; };
template <typename T, int D> __host__ __device__ constexpr int ld() { return D + Mma<T>::PAD; }

// ---------------------------------------------------------------------------
// cp.async: 16 bytes a thread, zero fill past the matrix
// ---------------------------------------------------------------------------

// 16 bytes from src, of which the first `bytes` are read and the rest
// zero filled (0: the whole chunk is zeros and src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a row-major [n, D] matrix into a shared tile
// of stride ld<T, D>(); rows past n are zero filled (their source address
// stays in row 0, and no byte of it is read).  Not committed here.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int row0, int n) {
  constexpr int CH = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int PER_ROW = D / CH;
  constexpr int CHUNKS = ROWS * PER_ROW;
#pragma unroll
  for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
    const int c = i * THREADS + threadIdx.x;
    if (CHUNKS % THREADS != 0 && c >= CHUNKS) break;
    const int r = c / PER_ROW, col = (c - r * PER_ROW) * CH;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * ld<T, D>() + col, src + (int64_t)(ok ? row0 + r : 0) * D + col,
               ok ? 16 : 0);
  }
}

// Rows [r0, r0 + R) and columns [c0, c0 + C) of a bias b, element (i, j)
// at b[i * bs_q + j * bs_k], into a shared tile of row stride C + PAD,
// zero outside rows < n_r and columns < n_c.  vec (bs_k == 1, rows
// 16-byte aligned): 16 bytes a thread, the last chunk of a row cut at
// n_c; otherwise an element a thread, by cp.async in fp32 and by plain
// loads in bf16 (cp.async moves 4 bytes at least).  Not committed here.
template <typename T, int R, int C, int PAD, int THREADS>
__device__ __forceinline__ void load_bias_async(T* dst, const T* b, int64_t bs_q, int64_t bs_k,
                                                int r0, int c0, int n_r, int n_c, bool vec) {
  if (vec) {
    constexpr int CH = 16 / sizeof(T), PER_ROW = C / CH;
    static_assert(R * PER_ROW % THREADS == 0, "bias tile chunks per thread");
#pragma unroll
    for (int i = 0; i < R * PER_ROW / THREADS; ++i) {
      const int c = i * THREADS + threadIdx.x;
      const int r = c / PER_ROW, col = (c - r * PER_ROW) * CH;
      const int row = r0 + r, left = n_c - (c0 + col);
      const int bytes = row < n_r ? max(0, min(CH, left)) * (int)sizeof(T) : 0;
      cp_async16(dst + r * (C + PAD) + col, bytes ? b + (int64_t)row * bs_q + c0 + col : b,
                 bytes);
    }
  } else {
    static_assert(R * C % THREADS == 0, "bias tile elements per thread");
#pragma unroll 4
    for (int i = 0; i < R * C / THREADS; ++i) {
      const int e = i * THREADS + threadIdx.x;
      const int r = e / C, col = e - r * C;
      const bool ok = r0 + r < n_r && c0 + col < n_c;
      const T* src = ok ? b + (int64_t)(r0 + r) * bs_q + (int64_t)(c0 + col) * bs_k : b;
      if constexpr (sizeof(T) == 4) cp_async4(dst + r * (C + PAD) + col, src, ok);
      else dst[r * (C + PAD) + col] = ok ? *src : from_f<T>(0.f);
    }
  }
}

// whether load_bias_async may move 16 bytes a thread
template <typename T>
__device__ __forceinline__ bool bias_vec(const T* b, int64_t bs_q, int64_t bs_k) {
  return bs_k == 1 && (bs_q * (int64_t)sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// ---------------------------------------------------------------------------
// mma.sync and split TF32
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 values (their low 13 bits are 0)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one k-step's operands: fp32 as split-TF32 halves, bf16 as they are
template <typename T> struct FragA;
template <> struct FragA<float> { uint32_t big[4], small[4]; };
template <> struct FragA<bf16> { uint32_t x[4]; };
template <typename T> struct FragB;
template <> struct FragB<float> { uint32_t big[2], small[2]; };
template <> struct FragB<bf16> { uint32_t x[2]; };

// c += a b
__device__ __forceinline__ void mma(float (&c)[4], const FragA<float>& a, const FragB<float>& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

__device__ __forceinline__ void mma(float (&c)[4], const FragA<bf16>& a, const FragB<bf16>& b) {
  mma_bf16(c, a.x, b.x[0], b.x[1]);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A: rows [r0, r0 + 16), columns [k0, k0 + K) of a row-major shared tile
__device__ __forceinline__ void load_a(FragA<float>& a, const float* s, int ldm, int r0, int k0,
                                       int lane) {
  const float* p = s + (r0 + (lane >> 2)) * ldm + k0 + (lane & 3);
  split(p[0], a.big[0], a.small[0]);
  split(p[8 * ldm], a.big[1], a.small[1]);
  split(p[4], a.big[2], a.small[2]);
  split(p[8 * ldm + 4], a.big[3], a.small[3]);
}

__device__ __forceinline__ void load_a(FragA<bf16>& a, const bf16* s, int ldm, int r0, int k0,
                                       int lane) {
  const bf16* p = s + (r0 + (lane >> 2)) * ldm + k0 + 2 * (lane & 3);
  a.x[0] = ld32(p);
  a.x[1] = ld32(p + 8 * ldm);
  a.x[2] = ld32(p + 8);
  a.x[3] = ld32(p + 8 * ldm + 8);
}

// B[k][n] = s[n0 + n][k0 + k]: the k index runs along a row of s (K in
// q k^T; Q and dO in k q^T and v dO^T)
__device__ __forceinline__ void load_bt(FragB<float>& b, const float* s, int ldm, int n0, int k0,
                                        int lane) {
  const float* p = s + (n0 + (lane >> 2)) * ldm + k0 + (lane & 3);
  split(p[0], b.big[0], b.small[0]);
  split(p[4], b.big[1], b.small[1]);
}

__device__ __forceinline__ void load_bt(FragB<bf16>& b, const bf16* s, int ldm, int n0, int k0,
                                        int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * ldm + k0 + 2 * (lane & 3);
  b.x[0] = ld32(p);
  b.x[1] = ld32(p + 8);
}

// B[k][n] = s[k0 + k][n0 + n]: the k index runs down the rows of s (V in
// p v; K in ds k; dO and Q in p^T dO and ds^T q), with A from a_from_c.  TF32 reads
// the k-step's rows 2t and 2t + 1 (the permuted order); bf16 transposes
// two 8 x 8 tiles with ldmatrix.  row_xor is 0; 1 pairs each row with its
// neighbour's column of A, a fault planted on purpose by a check.
__device__ __forceinline__ void load_b(FragB<float>& b, const float* s, int ldm, int k0, int n0,
                                       int lane, int row_xor = 0) {
  const int r = 2 * (lane & 3);
  const float* p = s + k0 * ldm + n0 + (lane >> 2);
  split(p[(r ^ row_xor) * ldm], b.big[0], b.small[0]);
  split(p[((r + 1) ^ row_xor) * ldm], b.big[1], b.small[1]);
}

__device__ __forceinline__ void load_b(FragB<bf16>& b, const bf16* s, int ldm, int k0, int n0,
                                       int lane, int row_xor = 0) {
  // lanes 0-7 address rows k0..k0+7 (b.x[0]), lanes 8-15 rows k0+8..k0+15
  const bf16* p = s + (k0 + ((lane & 15) ^ row_xor)) * ldm + n0;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b.x[0]), "=r"(b.x[1])
               : "r"(addr));
}

// A shared tile that several warps read as a B operand, split into its
// TF32 halves once (split_tile) instead of at every fragment load: big in
// the tile's own place, small in a tile beside it of the same layout
struct SplitTile {
  const float* big;
  const float* small;
};

// split_tile for the ROWS x D tile t: x -> tf32 big in place, the small
// half to `small`.  The caller synchronises before and after.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void split_tile(float* t, float* small) {
  static_assert(ROWS * D % THREADS == 0, "tile elements per thread");
#pragma unroll 8
  for (int i = 0; i < ROWS * D / THREADS; ++i) {
    const int e = i * THREADS + threadIdx.x;
    const int o = (e / D) * ld<float, D>() + e % D;
    uint32_t big, sm;
    split(t[o], big, sm);
    t[o] = __uint_as_float(big);
    small[o] = __uint_as_float(sm);
  }
}

__device__ __forceinline__ void load_bt(FragB<float>& b, const SplitTile& s, int ldm, int n0,
                                        int k0, int lane) {
  const int o = (n0 + (lane >> 2)) * ldm + k0 + (lane & 3);
  b.big[0] = __float_as_uint(s.big[o]);
  b.big[1] = __float_as_uint(s.big[o + 4]);
  b.small[0] = __float_as_uint(s.small[o]);
  b.small[1] = __float_as_uint(s.small[o + 4]);
}

__device__ __forceinline__ void load_b(FragB<float>& b, const SplitTile& s, int ldm, int k0,
                                       int n0, int lane, int row_xor = 0) {
  const int r = 2 * (lane & 3);
  const int o0 = (k0 + (r ^ row_xor)) * ldm + n0 + (lane >> 2);
  const int o1 = (k0 + ((r + 1) ^ row_xor)) * ldm + n0 + (lane >> 2);
  b.big[0] = __float_as_uint(s.big[o0]);
  b.big[1] = __float_as_uint(s.big[o1]);
  b.small[0] = __float_as_uint(s.small[o0]);
  b.small[1] = __float_as_uint(s.small[o1]);
}

// A of k-step j of the second product from the first product's
// accumulators c[n-tile][4] (see the top of this file); in bf16 packing
// rounds p (or ds) to bf16, the TPU kernels' rounding before the dot
template <int NT>
__device__ __forceinline__ void a_from_c(FragA<float>& a, const float (&c)[NT][4], int j) {
  split(c[j][0], a.big[0], a.small[0]);
  split(c[j][2], a.big[1], a.small[1]);
  split(c[j][1], a.big[2], a.small[2]);
  split(c[j][3], a.big[3], a.small[3]);
}

template <int NT>
__device__ __forceinline__ void a_from_c(FragA<bf16>& a, const float (&c)[NT][4], int j) {
  a.x[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a.x[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a.x[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a.x[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// two consecutive elements of a shared tile, as floats, in one load
__device__ __forceinline__ void load2(const float* p, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x;
  y = v.y;
}

__device__ __forceinline__ void load2(const bf16* p, float& x, float& y) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  x = __low2float(v);
  y = __high2float(v);
}

// two values of one accumulator row to consecutive elements of T
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace attn
