// K1: 3x3, stride-1, pad-1 convolution with a per-channel affine and relu
// epilogue, as an implicit GEMM for Hopper (sm_90a):
//   out[n,h,w,o] = act(scale[o] * sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,c] * w[dy,dx,c,o]
//                      + shift[o])
// over NHWC x [N,H,W,C] and the weights as a [9C, O] matrix whose rows are
// ordered (dy, dx, c); float32 accumulation; float32 or bfloat16 x and w,
// output in their dtype; scale/shift may be null (identity), relu optional.
//
// Replaces the TPU kernel _conv3x3_kernel (paddle_tpu/fluid/ops/
// conv_pallas.py:33, launched by conv3x3_bn_relu's pallas_call at :80).  It
// computes the same function, not the same blocks: the TPU keeps a whole
// zero-padded image in VMEM (after a jnp.pad copy in device memory) and
// builds a [bh*W, 9C] patch matrix per row block for one MXU product.  Here
// the GEMM is M = N*H*W output pixels, K = 9*C, N = O: one thread block owns
// a pixel tile (NB images x RH rows x TW columns) and 64 output channels, and
// walks K in chunks of 16 input channels.  For each chunk it loads the
// tile's halo (RH+2 rows x TW+2 columns x 16 channels) into shared memory
// once, zero where the halo leaves the image (the padding is predicated,
// never materialised), with the chunk's 9 x 16 x 64 weights; the nine taps
// then read shifted windows of the same halo, so each input element is
// read from device memory about (RH+2)/RH times per output-channel block
// instead of nine.
//
// What bounds it on an H100 SXM.  ResNet-50's 3x3 stride-1 convs at batch
// 256 (56x56x64, 28x28x128, 14x14x256, 7x7x512; O = C) are 59.2 GFLOP
// each and move 26-103 MB in bfloat16: on the tensor cores (989 TFLOP/s
// bf16 dense) they are bound by operations at ~0.060 ms.  Two simple,
// correct kernels, one per dtype:
//   * bfloat16 (the training path): the tensor cores through mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate), 128-pixel tiles, 8 warps of
//     32 x 32 outputs each, halo and weights in shared memory as padded
//     bf16 rows that the fragment loads read without bank conflicts;
//   * float32: fp32 FMA on the CUDA cores (67 TFLOP/s peak; the tensor
//     cores would need TF32, which rounds the inputs), 256-pixel tiles,
//     8 pixels x 8 channels per thread, every shared-memory read either a
//     broadcast (weights) or 32 neighbouring words (pixels).
// One shared-memory stage and a barrier per chunk: cp.async / TMA
// pipelines and wgmma are later work.
//
// Small images: where one tile holds a whole image (7x7 at the last
// stage), a block takes several images, so the tile is not mostly empty;
// the 64-channel split over O gives the grid the rest of its width.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CK = 16;              // input channels per K chunk (both kernels)
constexpr int HALO_BUDGET = 1024;   // halo pixels a multi-image tile may hold

// float32 kernel: fp32 FMA on the CUDA cores
constexpr int THREADS = 256;
constexpr int TM = 32;              // threads along pixels (one warp)
constexpr int TN = THREADS / TM;    // threads along output channels
constexpr int PM = 8;               // pixels per thread
constexpr int PN = 8;               // output channels per thread
constexpr int BM = TM * PM;         // pixels per block (256)
constexpr int BN = TN * PN;         // output channels per block (64)

struct Params {
  const void* x;          // [N, H, W, C]
  const void* w;          // [9C, O], rows (dy, dx, c)
  const float* scale;     // [O] or null
  const float* shift;     // [O] or null
  void* out;              // [N, H, W, O]
  int N, H, W, C, O;
  int TW, RH, NB;         // pixel tile: NB images x RH rows x TW columns
  int n_cb, n_rb;         // column blocks, row blocks per image
  int relu;
};

// Output pixel n*H*W + h*W + w of tile slot s (slots run over columns,
// then rows, then images), or -1 past the tile or the image.
__device__ __forceinline__ int64_t out_pixel(const Params& p, int s, int n0, int h0,
                                             int w0) {
  const int tile_px = p.RH * p.TW;
  const int img = s / tile_px, r = (s / p.TW) % p.RH, c = s % p.TW;
  const int n = n0 + img, h = h0 + r, w = w0 + c;
  if (img >= p.NB || n >= p.N || h >= p.H || w >= p.W) return -1;
  return ((int64_t)n * p.H + h) * p.W + w;
}

__global__ void __launch_bounds__(THREADS)
conv3x3_fp32_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int HW2 = (p.RH + 2) * (p.TW + 2);    // halo pixels per image
  const int halo = p.NB * HW2;
  float* xs = smem;                           // [CK][halo], halo pixel fastest
  float* ws = smem + CK * halo;               // [9][CK][BN]
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wg = static_cast<const float*>(p.w);

  int bx = blockIdx.x;
  const int cb = bx % p.n_cb;
  bx /= p.n_cb;
  const int rb = bx % p.n_rb;
  const int n0 = (bx / p.n_rb) * p.NB;
  const int h0 = rb * p.RH, w0 = cb * p.TW;
  const int o0 = blockIdx.y * BN;

  const int tid = threadIdx.x;
  const int tm = tid % TM, tn = tid / TM;
  const int tile_px = p.RH * p.TW;

  // this thread's pixels are tile slots s = tm + TM * i; a slot past the
  // tile or the image computes on halo pixel 0 and is not stored
  int base[PM];           // halo offset of the pixel's (dy=0, dx=0) tap
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    const int64_t pix = out_pixel(p, tm + TM * i, n0, h0, w0);
    const int s = tm + TM * i;
    const int img = s / tile_px, r = (s / p.TW) % p.RH, c = s % p.TW;
    base[i] = pix >= 0 ? (img * (p.RH + 2) + r) * (p.TW + 2) + c : 0;
  }

  float acc[PM][PN];
#pragma unroll
  for (int i = 0; i < PM; ++i)
#pragma unroll
    for (int j = 0; j < PN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < p.C; c0 += CK) {
    // the halo tile of channels [c0, c0+CK): zero outside the image
    for (int e = tid; e < halo * CK; e += THREADS) {
      const int cc = e % CK, hp = e / CK;
      const int img = hp / HW2, rem = hp % HW2;
      const int hr = rem / (p.TW + 2), hc = rem % (p.TW + 2);
      const int n = n0 + img, h = h0 - 1 + hr, w = w0 - 1 + hc, c = c0 + cc;
      float v = 0.f;
      if (n < p.N && h >= 0 && h < p.H && w >= 0 && w < p.W && c < p.C)
        v = x[(((int64_t)n * p.H + h) * p.W + w) * p.C + c];
      xs[cc * halo + hp] = v;
    }
    // the chunk's weights, ws[(tap * CK + cc) * BN + oo]
    for (int e = tid; e < 9 * CK * BN; e += THREADS) {
      const int oo = e % BN, t = e / BN;
      const int cc = t % CK, tap = t / CK;
      const int c = c0 + cc, o = o0 + oo;
      float v = 0.f;
      if (c < p.C && o < p.O) v = wg[((int64_t)tap * p.C + c) * p.O + o];
      ws[e] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * (p.TW + 2) + (tap % 3);
#pragma unroll 4
      for (int cc = 0; cc < CK; ++cc) {
        const float* xr = xs + cc * halo + toff;
        const float4* wr = reinterpret_cast<const float4*>(
            ws + (tap * CK + cc) * BN + tn * PN);
        const float4 wa = wr[0], wb = wr[1];
        const float wv[PN] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < PM; ++i) {
          const float xv = xr[base[i]];
#pragma unroll
          for (int j = 0; j < PN; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* __restrict__ out = static_cast<float*>(p.out);
#pragma unroll
  for (int j = 0; j < PN; ++j) {
    const int o = o0 + tn * PN + j;
    if (o >= p.O) continue;
    const float s = p.scale != nullptr ? p.scale[o] : 1.f;
    const float b = p.shift != nullptr ? p.shift[o] : 0.f;
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      const int64_t pix = out_pixel(p, tm + TM * i, n0, h0, w0);
      if (pix < 0) continue;
      // acc * scale + shift as two roundings, as the plain version and the
      // TPU kernel compute it (no fused multiply-add)
      float v = __fadd_rn(__fmul_rn(acc[i][j], s), b);
      if (p.relu) v = fmaxf(v, 0.f);
      out[pix * p.O + o] = v;
    }
  }
}

// Tile geometry for tiles of bm pixels: TW columns (the whole row when
// W <= bm), RH rows (as many as fit bm pixels, balanced over the image's
// row blocks), and several images per tile when one tile holds a whole
// image.
Params make_params(const void* x, const void* w, const void* scale, const void* shift,
                   void* out, int N, int H, int W, int C, int O, int relu, int bm) {
  Params p;
  p.x = x;
  p.w = w;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = out;
  p.N = N; p.H = H; p.W = W; p.C = C; p.O = O;
  p.relu = relu;
  p.TW = W < bm ? W : bm;
  p.n_cb = (W + p.TW - 1) / p.TW;
  int rows = bm / p.TW;
  if (rows > H) rows = H;
  p.n_rb = (H + rows - 1) / rows;
  p.RH = (H + p.n_rb - 1) / p.n_rb;
  p.NB = 1;
  if (p.RH == H && p.TW == W) {
    int fit = bm / (H * W);
    const int cap = HALO_BUDGET / ((H + 2) * (W + 2));
    if (fit > cap) fit = cap;
    if (fit > N) fit = N;
    if (fit > 1) p.NB = fit;
  }
  return p;
}

// ---------------------------------------------------------------------------
// bfloat16: the same implicit GEMM on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate).  One block owns 128 tile pixels x 64 output
// channels with 8 warps, each a 32 x 32 sub-tile (2 x 4 mma tiles).  Per
// 16-channel chunk the halo and the weights sit in shared memory as bf16
// rows of 16 channels padded to 24 (48 bytes), so that a fragment load of
// 8 neighbouring pixels (or output channels) x 4 words hits 32 different
// banks; the weights are stored transposed ([tap][o][c]), which is the
// layout the B fragment reads.
// ---------------------------------------------------------------------------

constexpr int MM_THREADS = 256;     // 8 warps: 4 along pixels x 2 along channels
constexpr int MM_BM = 128;          // tile pixels per block
constexpr int MM_BN = 64;           // output channels per block
constexpr int MM_SK = CK + 8;       // bf16 per shared-memory row (16 channels + pad)

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(MM_THREADS)
conv3x3_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HW2 = (p.RH + 2) * (p.TW + 2);
  const int halo = p.NB * HW2;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [halo][MM_SK]
  __nv_bfloat16* ws = xs + (size_t)halo * MM_SK;                     // [9][MM_BN][MM_SK]
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* __restrict__ wg = static_cast<const __nv_bfloat16*>(p.w);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  int bx = blockIdx.x;
  const int cb = bx % p.n_cb;
  bx /= p.n_cb;
  const int rb = bx % p.n_rb;
  const int n0 = (bx / p.n_rb) * p.NB;
  const int h0 = rb * p.RH, w0 = cb * p.TW;
  const int o0 = blockIdx.y * MM_BN;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % 4, wn = warp / 4;
  const int tile_px = p.RH * p.TW;
  // 16-byte vector loads when every pixel's channels and every weight row
  // start on a 16-byte boundary
  const bool vec = p.C % 8 == 0 && p.O % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.w) % 16 == 0;

  // the halo offsets of this thread's four A-fragment rows: slots
  // wm*32 + mt*16 + g (+8)
  int base[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int s = wm * 32 + mt * 16 + hi * 8 + g;
      const int img = s / tile_px, r = (s / p.TW) % p.RH, c = s % p.TW;
      base[mt][hi] = out_pixel(p, s, n0, h0, w0) >= 0
                         ? (img * (p.RH + 2) + r) * (p.TW + 2) + c : 0;
    }

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

  for (int c0 = 0; c0 < p.C; c0 += CK) {
    if (vec) {
      for (int e = tid; e < halo * 2; e += MM_THREADS) {
        const int v = e % 2, hp = e / 2;
        const int img = hp / HW2, rem = hp % HW2;
        const int hr = rem / (p.TW + 2), hc = rem % (p.TW + 2);
        const int n = n0 + img, h = h0 - 1 + hr, w = w0 - 1 + hc, c = c0 + v * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n < p.N && h >= 0 && h < p.H && w >= 0 && w < p.W && c < p.C)
          val = *reinterpret_cast<const uint4*>(
              x + (((int64_t)n * p.H + h) * p.W + w) * p.C + c);
        *reinterpret_cast<uint4*>(xs + hp * MM_SK + v * 8) = val;
      }
      for (int e = tid; e < 9 * CK * (MM_BN / 8); e += MM_THREADS) {
        const int ov = e % (MM_BN / 8), t2 = e / (MM_BN / 8);
        const int cc = t2 % CK, tap = t2 / CK;
        const int c = c0 + cc, o = o0 + ov * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (c < p.C && o < p.O)
          val = *reinterpret_cast<const uint4*>(wg + ((int64_t)tap * p.C + c) * p.O + o);
        const uint32_t words[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ws[(tap * MM_BN + ov * 8 + i) * MM_SK + cc] = __ushort_as_bfloat16(
              (unsigned short)(words[i / 2] >> (16 * (i % 2))));
      }
    } else {
      for (int e = tid; e < halo * CK; e += MM_THREADS) {
        const int cc = e % CK, hp = e / CK;
        const int img = hp / HW2, rem = hp % HW2;
        const int hr = rem / (p.TW + 2), hc = rem % (p.TW + 2);
        const int n = n0 + img, h = h0 - 1 + hr, w = w0 - 1 + hc, c = c0 + cc;
        __nv_bfloat16 val = zero;
        if (n < p.N && h >= 0 && h < p.H && w >= 0 && w < p.W && c < p.C)
          val = x[(((int64_t)n * p.H + h) * p.W + w) * p.C + c];
        xs[hp * MM_SK + cc] = val;
      }
      for (int e = tid; e < 9 * CK * MM_BN; e += MM_THREADS) {
        const int oo = e % MM_BN, t2 = e / MM_BN;
        const int cc = t2 % CK, tap = t2 / CK;
        const int c = c0 + cc, o = o0 + oo;
        __nv_bfloat16 val = zero;
        if (c < p.C && o < p.O) val = wg[((int64_t)tap * p.C + c) * p.O + o];
        ws[(tap * MM_BN + oo) * MM_SK + cc] = val;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * (p.TW + 2) + (tap % 3);
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* r0 =
            reinterpret_cast<const uint32_t*>(xs + (base[mt][0] + toff) * MM_SK);
        const uint32_t* r1 =
            reinterpret_cast<const uint32_t*>(xs + (base[mt][1] + toff) * MM_SK);
        a[mt][0] = r0[t];
        a[mt][1] = r1[t];
        a[mt][2] = r0[t + 4];
        a[mt][3] = r1[t + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* wr = reinterpret_cast<const uint32_t*>(
            ws + (tap * MM_BN + wn * 32 + nt * 8 + g) * MM_SK);
        const uint32_t b0 = wr[t], b1 = wr[t + 4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int64_t pix = out_pixel(p, wm * 32 + mt * 16 + hi * 8 + g, n0, h0, w0);
      if (pix < 0) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = o0 + wn * 32 + nt * 8 + t * 2 + j;
          if (o >= p.O) continue;
          const float s = p.scale != nullptr ? p.scale[o] : 1.f;
          const float b = p.shift != nullptr ? p.shift[o] : 0.f;
          float v = __fadd_rn(__fmul_rn(acc[mt][nt][hi * 2 + j], s), b);
          if (p.relu) v = fmaxf(v, 0.f);
          out[pix * p.O + o] = __float2bfloat16(v);  // round to nearest even
        }
    }
}

cudaError_t launch_fp32(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)CK * p.NB * (p.RH + 2) * (p.TW + 2) + 9 * CK * BN);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fp32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)p.n_cb * p.n_rb * ((p.N + p.NB - 1) / p.NB);
  const int o_blocks = (p.O + BN - 1) / BN;
  if (blocks > 0x7fffffff || o_blocks > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks, o_blocks);
  conv3x3_fp32_kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * MM_SK *
                      ((size_t)p.NB * (p.RH + 2) * (p.TW + 2) + 9 * MM_BN);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)p.n_cb * p.n_rb * ((p.N + p.NB - 1) / p.NB);
  const int o_blocks = (p.O + MM_BN - 1) / MM_BN;
  if (blocks > 0x7fffffff || o_blocks > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks, o_blocks);
  conv3x3_mma_kernel<<<grid, MM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); x NHWC
// contiguous, w [9C, O] contiguous with rows (dy, dx, c); scale and shift
// float32 [O] or null; relu 0/1.  Returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int paddle_conv3x3_bn_relu(int dtype, const void* x, const void* w,
                                      const void* scale, const void* shift, void* out,
                                      int N, int H, int W, int C, int O, int relu,
                                      void* stream) {
  cudaGetLastError();  // clear a stale non-sticky error so the code below is this launch's
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fp32(
        make_params(x, w, scale, shift, out, N, H, W, C, O, relu, BM), st);
  if (dtype == 1)
    return (int)launch_bf16(
        make_params(x, w, scale, shift, out, N, H, W, C, O, relu, MM_BM), st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
