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
// Bound on the card: bytes (each element read once and written once; a
// few flops an element).  So a row is read from device memory once, in
// 16-byte loads: each thread loads CPT 16-byte chunks of the row into
// registers and shared memory, sums the squares of its elements t, t +
// 256, ... from shared memory in that order, and writes the outputs of
// its own chunks in 16-byte stores (`rms_norm_vec`; rows of 16-byte
// multiples up to 48 KB, every width the configurations use; the row in
// registers by 2-byte loads took 1.04x F.rms_norm's device time at
// granite's width: PERF.md, PR 31).  Other rows take the two-pass loop
// (`rms_norm_loop`, which reads the row twice), with the same sums and
// outputs.  The scale comes in its own dtype (float32 or bf16; bf16 ->
// float32 is exact), so a model's bf16 norm weight needs no cast kernel a
// call.
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

// the CTA's sum of its threads' ss, lanes then warps by the xor tree;
// every thread gets rsqrt(sum / n + eps)
__device__ __forceinline__ float inv_rms(float ss, float inv_n, float eps) {
  __shared__ float part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = tree_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? part[lane] : 0.f;
    v = tree_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return rsqrtf(part[0] * inv_n + eps);
}

// one output element: x * r * scale rounded to T, times the gate zv
template <typename T>
__device__ __forceinline__ T norm_gate(float xv, float r, float sv,
                                       bool gated, float zv) {
  const float y = rnd<T>(xv * r * sv);
  if (!gated) return from_f<T>(y);
  const float e = rnd<T>(expf(-zv));
  const float d = rnd<T>(1.f + e);
  const float rc = rnd<T>(1.f / d);
  const float g = rnd<T>(zv * rc);
  return from_f<T>(y * g);
}
template <typename T>
__device__ __forceinline__ T norm_out(float xv, float r, float sv,
                                      const T* z, long long at) {
  return norm_gate<T>(xv, r, sv, z != nullptr,
                      z == nullptr ? 0.f : to_f(z[at]));
}

// the row in 16-byte chunks: CPT a thread (chunk tid + 256 k), kept in
// registers and in shared memory (n values), from which each thread sums
// its elements t, t + 256, ... in order
template <typename T, typename S, int CPT>
__global__ void __launch_bounds__(kThreads)
    rms_norm_vec(const T* __restrict__ x, const T* __restrict__ z,
                 const S* __restrict__ scale, T* __restrict__ out, int n,
                 float inv_n, float eps) {
  constexpr int VEC = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char sm[];
  T* srow = reinterpret_cast<T*>(sm);
  const int tid = threadIdx.x, nch = n / VEC;
  const long long row = (long long)blockIdx.x * n;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row);
  uint4 xv[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int ch = tid + k * kThreads;
    if (ch < nch) {
      xv[k] = xr[ch];
      reinterpret_cast<uint4*>(srow)[ch] = xv[k];
    }
  }
  __syncthreads();
  float ss = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float v = to_f(srow[i]);
    ss = fmaf(v, v, ss);
  }
  const float r = inv_rms(ss, inv_n, eps);
  const uint4* zr =
      z == nullptr ? nullptr : reinterpret_cast<const uint4*>(z + row);
  uint4* orow = reinterpret_cast<uint4*>(out + row);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int ch = tid + k * kThreads;
    if (ch >= nch) continue;
    uint4 zv = make_uint4(0u, 0u, 0u, 0u);
    if (zr != nullptr) zv = zr[ch];
    const T* xs = reinterpret_cast<const T*>(&xv[k]);
    const T* zs = reinterpret_cast<const T*>(&zv);
    uint4 ov;
    T* os = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      os[u] = norm_gate<T>(to_f(xs[u]), r, to_f(scale[ch * VEC + u]),
                           zr != nullptr, to_f(zs[u]));
    orow[ch] = ov;
  }
}

// any width: the row read twice, the same sums
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    rms_norm_loop(const T* __restrict__ x, const T* __restrict__ z,
                  const S* __restrict__ scale, T* __restrict__ out, int n,
                  float inv_n, float eps) {
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * n;
  const T* xr = x + row;
  float ss = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float r = inv_rms(ss, inv_n, eps);
  T* o = out + row;
  for (int i = tid; i < n; i += kThreads)
    o[i] = norm_out<T>(to_f(xr[i]), r, to_f(scale[i]), z, row + i);
}

// two_pass: the loop kernel at every width (the order's oracle)
template <typename T, typename S>
int launch(const void* x, const void* z, const void* scale, void* out,
           int rows, int n, float eps, bool two_pass, cudaStream_t s) {
  const float inv_n = 1.f / (float)n;
  const T* xp = (const T*)x;
  const T* zp = (const T*)z;
  const S* sp = (const S*)scale;
  T* op = (T*)out;
  constexpr int VEC = 16 / (int)sizeof(T);
  const size_t row_bytes = (size_t)n * sizeof(T);
  const bool vec = !two_pass && row_bytes % 16 == 0 && row_bytes <= 49152 &&
                   ((uintptr_t)x | (uintptr_t)out | (uintptr_t)z) % 16 == 0;
  const int cpt = (n / VEC + kThreads - 1) / kThreads;
#define RMS_VEC(C)                                                       \
  if (vec && cpt <= C) {                                                 \
    rms_norm_vec<T, S, C><<<rows, kThreads, row_bytes, s>>>(             \
        xp, zp, sp, op, n, inv_n, eps);                                  \
    return (int)cudaGetLastError();                                      \
  }
  RMS_VEC(1)
  RMS_VEC(2)
  RMS_VEC(4)
  RMS_VEC(8)
  RMS_VEC(12)
#undef RMS_VEC
  rms_norm_loop<T, S><<<rows, kThreads, 0, s>>>(xp, zp, sp, op, n, inv_n,
                                                eps);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, int scale_dtype, const void* x, const void* z,
             const void* scale, void* out, int rows, int n, float eps,
             bool two_pass, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, z, scale, out, rows, n, eps, two_pass, s);
  if (dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, z, scale, out, rows, n, eps,
                                        two_pass, s);
  if (dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, z, scale, out, rows, n, eps,
                                        two_pass, s);
  if (dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, z, scale, out, rows, n,
                                                 eps, two_pass, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, z and out share it); scale_dtype
// the same codes for scale (n,); z null for the plain norm.  rows x n,
// rows contiguous.
extern "C" int rms_norm_launch(int dtype, int scale_dtype, const void* x,
                               const void* z, const void* scale, void* out,
                               int rows, int n, float eps, void* stream) {
  return dispatch(dtype, scale_dtype, x, z, scale, out, rows, n, eps, false,
                  stream);
}

// the same norm by the two-pass loop kernel at every width: the oracle the
// card's tests hold the register kernel to, bitwise
extern "C" int rms_norm_two_pass_launch(int dtype, int scale_dtype,
                                        const void* x, const void* z,
                                        const void* scale, void* out,
                                        int rows, int n, float eps,
                                        void* stream) {
  return dispatch(dtype, scale_dtype, x, z, scale, out, rows, n, eps, true,
                  stream);
}
