// RMS norm (and Mamba2's gated RMS norm) whose every output row has bits
// that depend only on that row: one CTA a row, whatever the row count.
//
// Replaces no TPU kernel.  The JAX package leaves the norm to XLA
// (src/repro/models/layers.py rms_norm / gated_rms_norm); the port's
// plain version is torch's `x.float().square().mean(-1)`, whose reduction
// on the card is laid out by the tensor's shape, so a row's mean square
// can round otherwise at another row count (a chunk of another length,
// another bucket).  Here the reduction is fixed: thread t sums the squares
// of elements t, t + 256, t + 512, ... in that order (FFMA), the 32 lanes
// of a warp combine by a fixed xor-shuffle tree, and warp 0 combines the
// 8 warps' sums by the same tree.  Then, as the plain version does, in
// float32: x * rsqrt(ms + eps) * scale, rounded to x's dtype.
//
// With a gate z (same shape and dtype as x) the output is
// norm(x) * silu(z), silu in XLA's form with each op rounded to z's dtype
// (exp(-z), 1 + e, 1 / d, z * r) and the product rounded once more, as
// src/repro_torch/models/layers.py gated_rms_norm computes it.
//
// Bound on the card: bytes (each element is read twice from L2 at most
// and written once; a few flops an element).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float tree_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ z,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int n, float inv_n, float eps) {
  __shared__ float part[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = (long long)blockIdx.x * n;
  const T* xr = x + row;
  float ss = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = tree_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? part[lane] : 0.f;
    v = tree_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float r = rsqrtf(part[0] * inv_n + eps);
  T* o = out + row;
  for (int i = tid; i < n; i += kThreads) {
    const float y = rnd<T>(to_f(xr[i]) * r * scale[i]);
    if (z == nullptr) {
      o[i] = from_f<T>(y);
    } else {
      const float zv = to_f(z[row + i]);
      const float e = rnd<T>(expf(-zv));
      const float d = rnd<T>(1.f + e);
      const float rc = rnd<T>(1.f / d);
      const float g = rnd<T>(zv * rc);
      o[i] = from_f<T>(y * g);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, z and out share it); scale is
// float32 (n,); z null for the plain norm.  rows x n, rows contiguous.
extern "C" int rms_norm_launch(int dtype, const void* x, const void* z,
                               const void* scale, void* out, int rows, int n,
                               float eps, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float inv_n = 1.f / (float)n;
  if (dtype == 0)
    rms_norm_kernel<float><<<rows, kThreads, 0, s>>>(
        (const float*)x, (const float*)z, (const float*)scale, (float*)out,
        n, inv_n, eps);
  else if (dtype == 1)
    rms_norm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)z,
        (const float*)scale, (__nv_bfloat16*)out, n, inv_n, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
