// K1: 3x3, stride-1, pad-1 convolution with a per-channel affine and relu
// epilogue, as an implicit GEMM for Hopper (sm_90a):
//   out[n,h,w,o] = act(scale[o] * sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,c] * w[dy,dx,c,o]
//                      + shift[o])
// over NHWC x [N,H,W,C]; float32 accumulation; float32 or bfloat16 x and
// w, output in their dtype; scale/shift may be null (identity), relu
// optional.
//
// Replaces the TPU kernel _conv3x3_kernel (paddle_tpu/fluid/ops/
// conv_pallas.py:33, launched by conv3x3_bn_relu's pallas_call at :80).  It
// computes the same function, not the same blocks: the TPU keeps a whole
// zero-padded image in VMEM (after a jnp.pad copy in device memory) and
// builds a [bh*W, 9C] patch matrix per row block for one MXU product.  Here
// the GEMM is M = N*H*W output pixels, K = 9*C, N = O: one thread block owns
// a tile of output pixels and BN output channels.  For each chunk of input
// channels it holds the tile's halo (its rows and columns and one more on
// every side) in shared memory, zero where the halo leaves the image (the
// padding is never materialised); the nine taps read shifted windows of
// the same halo, so each input element is read about (halo pixels / tile
// pixels) times per output-channel block instead of nine.
//
// What bounds it on an H100 SXM.  ResNet-50's 3x3 stride-1 convs at batch
// 256 (56x56x64, 28x28x128, 14x14x256, 7x7x512; O = C) are 59.2 GFLOP
// each and move 26-103 MB in bfloat16: on the tensor cores (989 TFLOP/s
// bf16 dense) they take at least ~0.060 ms (bytes at 56x56, operations at
// the others).
//
// Three variants; the launch plan (variant, tiling, tile, BN, ring stages,
// shared memory, grid) is computed in Python (conv_ops.k1_plan) and passed
// in, and the entry point checks it against its own arithmetic before it
// launches:
//   * wgmma (every bfloat16 call with C % 8 == 0, O % 8 == 0 and 16-byte
//     aligned x and w; all of ResNet-50's): a warp-specialised kernel.
//     One producer warp issues TMA loads into two shared-memory rings,
//     each stage with a full and an empty mbarrier: the halo of each
//     64-channel chunk (a 4-D box over NHWC x whose out-of-bounds zero
//     fill is the padding) and, per (chunk, tap), a [BN x 64] K-major
//     weight tile (a 3-D box over w laid out [O][9][C]), both with the
//     128-byte swizzle.  Two consumer warpgroups own 64 tile pixels each;
//     per tap every warp ldmatrix-es its 16 pixel rows of A from the
//     shifted halo window (a shifted window is no tile a shared-memory
//     descriptor can describe, so A comes from registers) and issues
//     wgmma m64nBNk16 with B read through a descriptor, one commit group
//     in flight.  The epilogue stages each warp's rows in shared memory
//     and writes whole 16-byte pieces of output rows.  Tiles are 128
//     consecutive pixels of N*H*W where their halo box fits (every slot
//     but the last tile's computes a pixel: a rectangle of 128 idles 30
//     of its slots at 7x7 and 14x14), rectangles otherwise.  What the chip runs
//     chose (PERF.md): 4 weight stages, BN 64 for O <= 64 (two blocks on
//     an SM) and 128 above (one block).
//   * mma_sync (the other bfloat16 shapes, e.g. C = 20, where TMA's
//     16-byte global strides do not hold): mma.sync m16n8k16, one
//     shared-memory stage of 16 channels, 128-pixel x 64-channel tiles.
//   * fp32: fp32 FMA on the CUDA cores (67 TFLOP/s peak; the tensor cores
//     would need TF32, which rounds the inputs), 256-pixel tiles, 8
//     pixels x 8 channels per thread.
//
// Small images: in the rectangular tiles of all three, where one tile
// holds a whole image, a block takes several images, so the tile is not
// mostly empty.

#include <cuda.h>            // CUtensorMap and the encoder's types only: no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int CK = 16;              // input channels per K chunk (fp32, mma_sync)

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
  const void* w;          // fp32, mma_sync: [9C, O], rows (dy, dx, c); wgmma: [O, 9C]
  const float* scale;     // [O] or null
  const float* shift;     // [O] or null
  void* out;              // [N, H, W, O]
  int N, H, W, C, O;
  int TW, RH, NB;         // pixel tile: NB images x RH rows x TW columns
  int n_cb, n_rb;         // column blocks, row blocks per image
  int relu;
  // wgmma only
  int flat;               // 1: a tile is 128 consecutive pixels of N*H*W
  int pitch;              // halo pixels per halo row (the box's width): TW + 2
  int box_rows;           // halo rows in the box
  int halo_stages, w_stages;
  int halo_bytes;         // one halo box: NB * box_rows * pitch * 128
  int halo_stride;        // its stage in shared memory, 1024-aligned
  int n_chunks;           // ceil(C / 64)
};

thread_local char g_detail[256] = "";

cudaError_t fail(cudaError_t err, const char* what) {
  snprintf(g_detail, sizeof(g_detail), "%s", what);
  return err;
}

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

// ---------------------------------------------------------------------------
// bfloat16 on Hopper's tensor cores: wgmma fed by a TMA / mbarrier ring.
//
// Block: warps 0-3 and 4-7 are the two consumer warpgroups (wgmma needs
// warpgroup-aligned warps), warp 8 the producer.  Two tilings of the
// output pixels into blocks of 128 slots:
//   * rect: slot s is pixel (img, r, c) = (s / (RH*TW), s / TW % RH,
//     s % TW) of the block's NB x RH x TW tile, its halo a 4-D box over
//     [N][H][W][C];
//   * flat: slot s is pixel 128 * block + s of the N*H*W
//     pixels in order, so no slot idles where a tile would overhang the
//     image; the halo is a box of whole rows of x viewed as [N*H][W][C],
//     and a tap that leaves its image vertically (the row above row 0 or
//     below row H-1, which in that view belongs to the next image) reads
//     a zero row in shared memory instead.
// Warpgroup g owns slots 64g..64g+63 and its warp w the 16 rows
// 64g+16w.. of the m64 tile.  Shared memory, from a 1024-aligned base:
// halo_stages halo boxes, then w_stages weight tiles of BN rows x 128
// bytes, then a 128-byte zero row and the mbarriers; the epilogue reuses
// the rings for its staging once every consumer is past its last wgmma.
// ---------------------------------------------------------------------------

namespace wg {
constexpr int SLOTS = 128;                    // tile pixels per block
constexpr int CONSUMER_WARPS = 8;             // two warpgroups
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);
constexpr int CHUNK = 64;                     // channels per halo row (128 bytes)
constexpr int ROW_BYTES = CHUNK * 2;
}  // namespace wg

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase with this parity completes.  A wait that
// never ends (a plan the rings cannot serve) traps after ~2^26 polls, so a
// fault surfaces as a launch error instead of a hung device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// rows of 128 bytes (64 bf16 of K), 8-row core groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);   // start address
  d |= (uint64_t)1 << 16;                            // leading offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;                  // stride offset: 8 rows
  d |= (uint64_t)1 << 62;                            // 128-byte swizzle
  return d;
}

// D[64 x N] += A[64 x 16] (registers, the mma.sync A fragment layout per
// warp) * B[16 x N] (shared memory, descriptor), fp32 accumulators in
// the wgmma D fragment layout.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

// 288 threads; BN <= 64 fits two blocks on an SM: ptxas then caps a
// thread at 96 registers, so that each SM sub-partition's 16K registers
// hold the five warps it may get.
template <int BN_>
__global__ void __launch_bounds__(wg::THREADS, BN_ <= 64 ? 2 : 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, Params p) {
  constexpr uint32_t WBYTES = BN_ * wg::ROW_BYTES;   // one weight tile
  constexpr int SP = 2 * BN_ + 16;                   // epilogue staging row pitch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // the swizzle needs 1024
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t halo_s = base;
  const uint32_t w_s = base + p.halo_stages * p.halo_stride;
  const uint32_t ring = p.halo_stages * p.halo_stride + p.w_stages * WBYTES;
  const uint32_t staging = wg::CONSUMER_WARPS * 16 * SP;
  const uint32_t zero_row = base + (ring > staging ? ring : staging);
  const uint32_t bars = zero_row + wg::ROW_BYTES;
  // halo_full[hs], halo_empty[hs], w_full[ws], w_empty[ws], 8 bytes each
  const uint32_t halo_full = bars, halo_empty = bars + 8 * p.halo_stages;
  const uint32_t w_full = bars + 16 * p.halo_stages;
  const uint32_t w_empty = w_full + 8 * p.w_stages;

  // the block's tile: rect (n0, h0, w0) of [N][H][W]; flat pixels
  // P0.. and the halo's first row h0 - 1 of [N*H] (n0 = w0 = 0)
  const int64_t n_px = (int64_t)p.N * p.H * p.W;
  const int64_t P0 = (int64_t)blockIdx.x * wg::SLOTS;
  int n0 = 0, h0, w0 = 0;
  if (p.flat) {
    h0 = (int)(P0 / p.W);
  } else {
    int bx = blockIdx.x;
    const int cb = bx % p.n_cb;
    bx /= p.n_cb;
    const int rb = bx % p.n_rb;
    n0 = (bx / p.n_rb) * p.NB;
    h0 = rb * p.RH;
    w0 = cb * p.TW;
  }
  const int o0 = blockIdx.y * BN_;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x < wg::ROW_BYTES / 16)
    reinterpret_cast<uint4*>(base_ptr + (zero_row - base))[threadIdx.x] =
        make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.halo_stages; ++s) {
      mbar_init(halo_full + 8 * s, 1);
      mbar_init(halo_empty + 8 * s, wg::CONSUMER_WARPS);
    }
    for (int s = 0; s < p.w_stages; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, wg::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == wg::CONSUMER_WARPS) {
    // producer: one lane walks the chunks; per chunk the halo box (its
    // corner at (c0, w0-1, h0-1, n0): out-of-bounds coordinates read as
    // zeros, which is the padding), then the nine taps' weight tiles
    if (lane == 0) {
      int hs = 0, hph = 0, ws = 0, wph = 0;
      for (int ck = 0; ck < p.n_chunks; ++ck) {
        const int c0 = ck * wg::CHUNK;
        mbar_wait(halo_empty + 8 * hs, hph ^ 1);
        mbar_arrive_expect_tx(halo_full + 8 * hs, p.halo_bytes);
        tma_load_4d(halo_s + hs * p.halo_stride, &xmap, halo_full + 8 * hs, c0, w0 - 1,
                    h0 - 1, n0);
        if (++hs == p.halo_stages) { hs = 0; hph ^= 1; }
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(w_empty + 8 * ws, wph ^ 1);
          mbar_arrive_expect_tx(w_full + 8 * ws, WBYTES);
          tma_load_3d(w_s + ws * WBYTES, &wmap, w_full + 8 * ws, c0, tap, o0);
          if (++ws == p.w_stages) { ws = 0; wph ^= 1; }
        }
      }
    }
    return;
  }

  // consumers
  const int wgi = warp / 4, wiw = warp % 4;
  const int pitch = p.pitch;
  // this lane's ldmatrix row: slot wgi*64 + wiw*16 + lane%16, channels
  // 8*(lane/16).. of each 16-channel step; its halo pixel at tap (0, 0),
  // and which rows dy of the tap window lie in its image (bit dy): a row
  // outside it reads the zero row
  int pbase = 0, rows_in = 7;
  {
    const int s = wgi * 64 + wiw * 16 + (lane & 15);
    if (p.flat) {
      if (P0 + s < n_px) {
        const int64_t P = P0 + s;
        const int R = (int)(P / p.W), c = (int)(P % p.W), h = R % p.H;
        pbase = (R - h0) * pitch + c;
        rows_in = (h > 0 ? 1 : 0) | 2 | (h < p.H - 1 ? 4 : 0);
      }
    } else {
      const int tile_px = p.RH * p.TW;
      const int img = s / tile_px, r = (s / p.TW) % p.RH, c = s % p.TW;
      if (img < p.NB) pbase = (img * p.box_rows + r) * pitch + c;
    }
  }
  const int khalf = lane >> 4;

  float acc[BN_ / 2];
#pragma unroll
  for (int i = 0; i < BN_ / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4][4];                               // A of two taps

  int hs = 0, hph = 0, ws = 0, wph = 0;
  for (int ck = 0; ck < p.n_chunks; ++ck) {
    // recompute the taps' addresses every chunk: hoisted out of the loop
    // they would hold 9 x 4 registers for its whole length
    asm volatile("" : "+r"(pbase), "+r"(rows_in));
    mbar_wait(halo_full + 8 * hs, hph);
    const uint32_t hb = halo_s + hs * p.halo_stride;
    int prev = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      // the tap's window: halo pixel pbase + dy*pitch + dx; row chunk j
      // of halo pixel q sits at 16 * (j ^ (q % 8)) (128-byte swizzle)
      const int q = pbase + (tap / 3) * pitch + (tap % 3);
      const bool in = (rows_in >> (tap / 3)) & 1;
      const uint32_t row = in ? hb + q * wg::ROW_BYTES : zero_row;
      const int sw = in ? q & 7 : 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(a[tap & 1][kk], row + (((2 * kk + khalf) ^ sw) << 4));

      if (tap == 8) {                                // the chunk's halo is read
        __syncwarp();
        if (lane == 0) mbar_arrive(halo_empty + 8 * hs);
      }
      mbar_wait(w_full + 8 * ws, wph);
      const uint64_t desc = sw128_desc(w_s + ws * WBYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)                 // 16 channels = 32 bytes
        Wgmma<BN_>::mma(acc, a[tap & 1][kk], desc + 2 * kk);
      wgmma_commit();
      if (tap > 0) {                                 // the previous tap's tile is read
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(w_empty + 8 * prev);
      }
      prev = ws;
      if (++ws == p.w_stages) { ws = 0; wph ^= 1; }
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(w_empty + 8 * prev);
    if (++hs == p.halo_stages) { hs = 0; hph ^= 1; }
  }

  // epilogue: every consumer is past its last wgmma and every TMA load
  // has landed, so the rings are free for staging
  asm volatile("bar.sync 1, %0;\n" ::"n"(wg::CONSUMER_WARPS * 32) : "memory");
  unsigned char* stage = base_ptr + warp * 16 * SP;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN_ / 8; ++j) {
    const int o = o0 + 8 * j + 2 * t;
    float s0 = 1.f, s1 = 1.f, b0 = 0.f, b1 = 0.f;
    if (o < p.O) {                                   // O % 8 == 0: o + 1 < O too
      if (p.scale != nullptr) { s0 = p.scale[o]; s1 = p.scale[o + 1]; }
      if (p.shift != nullptr) { b0 = p.shift[o]; b1 = p.shift[o + 1]; }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      // acc * scale + shift as two roundings, as the plain version and the
      // TPU kernel compute it (no fused multiply-add)
      float v0 = __fadd_rn(__fmul_rn(acc[4 * j + 2 * hi], s0), b0);
      float v1 = __fadd_rn(__fmul_rn(acc[4 * j + 2 * hi + 1], s1), b1);
      if (p.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
      *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * hi) * SP + (8 * j + 2 * t) * 2) =
          __floats2bfloat162_rn(v0, v1);             // round to nearest even
    }
  }
  __syncwarp();
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(p.out);
  constexpr int CPR = BN_ / 8;                       // 16-byte pieces per row
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, qc = i % CPR;
    const int s = wgi * 64 + wiw * 16 + r;
    const int64_t P = (int64_t)blockIdx.x * wg::SLOTS + s;
    const int64_t pix =
        p.flat ? (P < (int64_t)p.N * p.H * p.W ? P : -1) : out_pixel(p, s, n0, h0, w0);
    const int o = o0 + 8 * qc;
    if (pix >= 0 && o < p.O)
      *reinterpret_cast<uint4*>(out + pix * p.O + o) =
          *reinterpret_cast<const uint4*>(stage + r * SP + qc * 16);
  }
}


// ---------------------------------------------------------------------------
// Launch: the plan comes from conv_ops.k1_plan; each launcher recomputes
// what it can (grid, shared memory) and refuses a plan that disagrees.
// ---------------------------------------------------------------------------

enum Variant { FP32 = 0, MMA_SYNC = 1, WGMMA = 2 };

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int64_t round_up(int64_t a, int64_t b) { return ceil_div(a, b) * b; }

cudaError_t launch_fp32(const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fp32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return fail(err, "cudaFuncSetAttribute (fp32)");
  conv3x3_fp32_kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_mma(const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return fail(err, "cudaFuncSetAttribute (mma_sync)");
  conv3x3_mma_kernel<<<grid, MM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links against no libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Tensor maps of the halo (4-D over NHWC x, [N][H][W][C] for rect tiles
// and [1][N*H][W][C] for flat ones: box 64 channels x pitch x box_rows x
// NB) and the weights (3-D over [O][9][C]: box 64 x 1 x BN), both bf16
// with the 128-byte swizzle and zero fill out of bounds.
cudaError_t encode_maps(const Params& p, int bn, CUtensorMap* xmap, CUtensorMap* wmap) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr)
    return fail(cudaErrorNotSupported, "cuTensorMapEncodeTiled not found in the driver");
  const cuuint64_t e = 2;   // bytes per element
  const cuuint64_t rows = p.flat ? (cuuint64_t)p.N * p.H : (cuuint64_t)p.H;
  const cuuint64_t xdim[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W, rows,
                              p.flat ? 1 : (cuuint64_t)p.N};
  const cuuint64_t xstride[3] = {e * p.C, e * p.C * p.W, e * p.C * p.W * rows};
  const cuuint32_t xbox[4] = {(cuuint32_t)wg::CHUNK, (cuuint32_t)p.pitch,
                              (cuuint32_t)p.box_rows, (cuuint32_t)p.NB};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p.x),
                      xdim, xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    snprintf(g_detail, sizeof(g_detail), "cuTensorMapEncodeTiled (halo) returned %d",
             (int)r);
    return cudaErrorInvalidValue;
  }
  const cuuint64_t wdim[3] = {(cuuint64_t)p.C, 9, (cuuint64_t)p.O};
  const cuuint64_t wstride[2] = {e * p.C, e * p.C * 9};
  const cuuint32_t wbox[3] = {(cuuint32_t)wg::CHUNK, 1, (cuuint32_t)bn};
  r = encode(wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p.w), wdim,
             wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    snprintf(g_detail, sizeof(g_detail), "cuTensorMapEncodeTiled (weights) returned %d",
             (int)r);
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <int BN_>
cudaError_t launch_wgmma(const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  cudaError_t err = encode_maps(p, BN_, &xmap, &wmap);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<BN_>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return fail(err, "cudaFuncSetAttribute (wgmma)");
  conv3x3_wgmma_kernel<BN_><<<grid, wg::THREADS, smem, stream>>>(xmap, wmap, p);
  return cudaGetLastError();
}

// Shared memory of a wgmma plan: 1024 bytes of alignment slack, the rings
// or the epilogue's staging (the larger), the mbarriers.
int64_t wgmma_smem(const Params& p, int bn) {
  const int64_t ring = (int64_t)p.halo_stages * p.halo_stride +
                       (int64_t)p.w_stages * bn * wg::ROW_BYTES;
  const int64_t staging = (int64_t)wg::CONSUMER_WARPS * 16 * (2 * bn + 16);
  return 1024 + (ring > staging ? ring : staging) + wg::ROW_BYTES +
         16 * (p.halo_stages + p.w_stages);
}

}  // namespace

// variant: 0 = fp32, 1 = mma_sync (bf16), 2 = wgmma (bf16), as
// conv_ops.k1_plan chose it; x NHWC contiguous; w contiguous, [9C, O] with
// rows (dy, dx, c) for fp32 and mma_sync, [O, 9C] (K-major, columns (dy,
// dx, c)) for wgmma; scale and shift float32 [O] or null; relu 0/1; the
// plan's tiling (0 rect, 1 flat: wgmma only), tile (NB, RH, TW; for flat
// tiles 1, the rows a tile may span, W), BN, ring stages, shared-memory bytes and grid.  Returns the launch's
// cudaError_t (0 on success); does not synchronise.  On a refusal
// paddle_conv3x3_error_detail says why.
extern "C" int paddle_conv3x3_bn_relu(int variant, const void* x, const void* w,
                                      const void* scale, const void* shift, void* out,
                                      int N, int H, int W, int C, int O, int relu,
                                      int flat, int NB, int RH, int TW, int bn,
                                      int halo_stages, int w_stages, int smem_bytes,
                                      int grid_x, int grid_y, void* stream) {
  cudaGetLastError();  // clear a stale non-sticky error so the code below is this launch's
  g_detail[0] = '\0';
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || NB <= 0 || RH <= 0 || TW <= 0 ||
      bn <= 0)
    return (int)fail(cudaErrorInvalidValue, "non-positive shape or tile");
  Params p;
  p.x = x;
  p.w = w;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.out = out;
  p.N = N; p.H = H; p.W = W; p.C = C; p.O = O;
  p.relu = relu;
  p.TW = TW; p.RH = RH; p.NB = NB;
  p.n_cb = (int)ceil_div(W, TW);
  p.n_rb = (int)ceil_div(H, RH);
  p.flat = flat;
  p.pitch = TW + 2;
  p.box_rows = RH + 2;
  p.halo_stages = halo_stages;
  p.w_stages = w_stages;
  p.n_chunks = (int)ceil_div(C, wg::CHUNK);
  p.halo_bytes = NB * p.box_rows * p.pitch * wg::ROW_BYTES;
  p.halo_stride = (int)round_up(p.halo_bytes, 1024);
  const int64_t n_px = (int64_t)N * H * W;
  if (flat != 0 && (variant != WGMMA || flat != 1 || NB != 1 || TW != W ||
                    RH < (wg::SLOTS - 1 + W - 1) / W + 1))
    return (int)fail(cudaErrorInvalidValue,
                     "flat plan: wgmma, NB 1, TW = W, RH >= the rows a tile spans");
  const int64_t blocks = flat ? ceil_div(n_px, wg::SLOTS) : ceil_div(N, NB) * p.n_rb * p.n_cb;
  if (blocks != grid_x || ceil_div(O, bn) != grid_y || grid_y > 65535)
    return (int)fail(cudaErrorInvalidConfiguration, "grid disagrees with the tile and BN");
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t smem = -1;
  if (variant == FP32) {
    if (bn != BN || TW * RH * NB > BM)
      return (int)fail(cudaErrorInvalidValue, "fp32 plan: BN 64, at most 256 tile pixels");
    smem = (int64_t)sizeof(float) * ((int64_t)CK * NB * (RH + 2) * (TW + 2) + 9 * CK * BN);
  } else if (variant == MMA_SYNC) {
    if (bn != MM_BN || TW * RH * NB > MM_BM)
      return (int)fail(cudaErrorInvalidValue,
                       "mma_sync plan: BN 64, at most 128 tile pixels");
    smem = (int64_t)sizeof(__nv_bfloat16) * MM_SK *
           ((int64_t)NB * (RH + 2) * (TW + 2) + 9 * MM_BN);
  } else if (variant == WGMMA) {
    if (C % 8 != 0 || O % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)fail(cudaErrorInvalidValue,
                       "wgmma plan: C and O multiples of 8, 16-byte aligned x, w, out");
    if ((!flat && TW * RH * NB > wg::SLOTS) || p.pitch > 256 ||
        RH + 2 > 256 || NB > 256 || halo_stages < 1 || w_stages < 1)
      return (int)fail(cudaErrorInvalidValue, "wgmma plan: tile or stages out of range");
    smem = wgmma_smem(p, bn);
  } else {
    return (int)fail(cudaErrorInvalidValue, "unknown variant");
  }
  if (smem != smem_bytes || smem > 232448)
    return (int)fail(cudaErrorInvalidValue, "shared memory disagrees with the plan");
  if (variant == FP32) return (int)launch_fp32(p, grid, (size_t)smem, st);
  if (variant == MMA_SYNC) return (int)launch_mma(p, grid, (size_t)smem, st);
  switch (bn) {
    case 16: return (int)launch_wgmma<16>(p, grid, (size_t)smem, st);
    case 32: return (int)launch_wgmma<32>(p, grid, (size_t)smem, st);
    case 64: return (int)launch_wgmma<64>(p, grid, (size_t)smem, st);
    case 128: return (int)launch_wgmma<128>(p, grid, (size_t)smem, st);
    default: return (int)fail(cudaErrorInvalidValue, "wgmma plan: BN not 16, 32, 64 or 128");
  }
}

extern "C" const char* paddle_conv3x3_error_detail() { return g_detail; }

extern "C" const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
