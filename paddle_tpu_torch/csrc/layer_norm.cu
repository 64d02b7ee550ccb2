// K6: row layer norm for Hopper (sm_90a): for each row of x2d [M, D],
//   y = (x - mean) * rsqrt(var + eps) * scale + bias
// with mean and the centred (population) variance in float32; float32 or
// bfloat16 x and y, float32 scale and bias [D].
//
// Replaces the TPU kernel _layer_norm_kernel (paddle_tpu/fluid/ops/
// pallas_ops.py:706, launched by _pallas_layer_norm's pallas_call at :726).
// The TPU takes block_m rows per grid step and halves block_m until it
// divides M; here one warp owns one row and a block holds eight warps, so
// every M and every D is taken, and the ragged last block just has idle
// warps.  Nothing carries over between blocks.
//
// What bounds it on an H100 SXM: bytes.  At BERT-base's training hidden
// state (x2d [4096, 768] float32) it must read 12.6 MB and write 12.6 MB,
// 7.5 us at 3.35 TB/s, against ~25 MFLOP.  The warp reads its row three
// times (sum, centred sum of squares, normalise): the first read comes from
// device memory with neighbouring lanes on neighbouring words, the two
// re-reads of a 3 KB row from L1/L2.  Vector loads and keeping the row in
// registers are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;             // rows (warps) per block

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(ROWS * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int M, int D,
                  float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float s = 0.f;
  for (int j = lane; j < D; j += 32) s += to_f(xr[j]);
  const float mean = warp_sum(s) / D;
  float v = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float d = to_f(xr[j]) - mean;
    v = fmaf(d, d, v);
  }
  const float inv = rsqrtf(warp_sum(v) / D + eps);
  for (int j = lane; j < D; j += 32) {
    const float d = to_f(xr[j]) - mean;
    // (x - mean) * inv, then * scale + bias: three roundings, as the TPU
    // kernel and the plain version compute them (no fused multiply-add)
    yr[j] = from_f<T>(__fadd_rn(__fmul_rn(__fmul_rn(d, inv), scale[j]), bias[j]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y, int M,
                   int D, float eps, cudaStream_t stream) {
  const int64_t blocks = ((int64_t)M + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  layer_norm_kernel<T><<<(unsigned)blocks, ROWS * 32, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), M, D, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it); x and y [M, D]
// contiguous; scale and bias float32 [D].  Returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int paddle_layer_norm(int dtype, const void* x, const void* scale,
                                 const void* bias, void* y, int M, int D, float eps,
                                 void* stream) {
  cudaGetLastError();  // clear a stale non-sticky error so the code below is this launch's
  if (M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0) return (int)launch<float>(x, sc, bi, y, M, D, eps, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, sc, bi, y, M, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paddle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
