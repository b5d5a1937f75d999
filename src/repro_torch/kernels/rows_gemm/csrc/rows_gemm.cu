// y = x @ w (+ b) whose every output row has bits that depend only on
// that row of x, the weights and the bias: not on how many rows the call
// holds, nor on where the row sits among them.
//
// Replaces no TPU kernel.  The JAX package leaves its projections to
// XLA's dot (src/repro/models/layers.py linear / unembed, the SSD einsums
// of src/repro/models/ssm.py); the port's plain version is torch's matmul,
// which on the card is cuBLAS, and cuBLAS picks its kernel, tile and
// split of the reduction by shape.  A prompt then rounds otherwise when it
// is admitted in other chunks, padded into another bucket or batched
// beside other prompts, and a bitwise contract of the reference (chunked
// = recompute = blocking admission) breaks.  Here one kernel serves every
// shape: the tile and the K loop are the same for every M, the K axis is
// walked once in order (no split-K, no atomics), and a row's sum never
// meets another row's.
//
// Bound on the card: operations for the prefill's projections (2 M N K
// flops against (M K + K N + M N) elements moved; at M = 2048 that is far
// above the card's balance), bytes for a few rows.
//
// Two kernels, by dtype:
// * bfloat16: CTA tile 128 x 128, K tile 32, 8 warps of 64 x 32 each, on
//   the tensor cores through mma.sync m16n8k16 (f32 accumulate).  Tiles
//   arrive by 16-byte cp.async copies into a four-stage ring (three K
//   tiles in flight while one is multiplied) and are read into
//   fragments with ldmatrix (.trans for a weight stored k-major, as
//   linear's (d_in, d_out) weights are; plain for one stored n-major, as
//   unembed's embedding table is, read in place).  Rows, columns and K
//   past the end are zero-filled, never read.  The f32 sum is rounded to
//   bf16 once, then the bias is added and rounded as torch's `y + b` does.
//   The row tiles are the grid's fastest axis, so the CTAs in flight
//   share a few columns of the weight, which is read from memory about
//   once (a weight wider than the L2 would otherwise be read once per
//   row tile).
// * float32: CTA tile 64 x 64, K tile 16, each thread 4 x 4 outputs, each
//   a chain of FFMAs over k in order (no TF32), so float32 stays float32.
//   Any strides, and two batch axes, so the SSD's einsums read their
//   operands where they lie.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  int G2, M, N, K;
  long long sx1, sx2, sxm, sxk;  // x strides: batch (two axes), row, k
  long long sw1, sw2, swk, swn;  // w strides: batch (two axes), k, column
};

// ----------------------------------------------------------- bfloat16

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kPad = 8;                       // bf16 of row padding
constexpr int kALd = kBK + kPad;              // A tile: [128][40]
constexpr int kAStage = kBM * kALd;
constexpr int kBLdN = kBN + kPad;             // B k-major: [32][136]
constexpr int kBLdK = kBK + kPad;             // B n-major: [128][40]
constexpr int kBStage = kBM * kALd;           // max of 32*136, 128*40
constexpr int kStages = 4;
constexpr int kSmemBytes = 2 * kStages * (kAStage + kBStage);

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // bytes < 16 zero-fills the rest; 0 reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// WK: the weight is stored k-major, w[k * swk + n] (linear's (K, N));
// otherwise n-major, w[n * swn + k] (the embedding table read as its
// transpose).
template <bool WK>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kStages * kAStage;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;    // warp tile: 64 rows x 32
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int g1 = blockIdx.z / a.G2, g2 = blockIdx.z % a.G2;
  const __nv_bfloat16* x = (const __nv_bfloat16*)a.x + g1 * a.sx1 +
                           g2 * a.sx2;
  const __nv_bfloat16* w = (const __nv_bfloat16*)a.w + g1 * a.sw1 +
                           g2 * a.sw2;
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(sA);
  const uint32_t sb = (uint32_t)__cvta_generic_to_shared(sB);

  // each thread copies two 16-byte chunks of A and two of B per K tile
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;       // 512 chunks: 128 rows x 4
      const int r = c >> 2, kc = (c & 3) * 8;
      const bool ok = m0 + r < a.M && k0 + kc < a.K;
      cp_async16(sa + 2 * (stage * kAStage + r * kALd + kc),
                 ok ? x + (m0 + r) * a.sxm + k0 + kc : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      if (WK) {                               // 32 k rows x 16 chunks
        const int r = c >> 4, nc = (c & 15) * 8;
        const bool ok = k0 + r < a.K && n0 + nc < a.N;
        cp_async16(sb + 2 * (stage * kBStage + r * kBLdN + nc),
                   ok ? w + (k0 + r) * a.swk + n0 + nc : w, ok ? 16 : 0);
      } else {                                // 128 n rows x 4 chunks
        const int r = c >> 2, kc = (c & 3) * 8;
        const bool ok = n0 + r < a.N && k0 + kc < a.K;
        cp_async16(sb + 2 * (stage * kBStage + r * kBLdK + kc),
                   ok ? w + (n0 + r) * a.swn + k0 + kc : w, ok ? 16 : 0);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (a.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    cp_async_wait<kStages - 2>();             // tile kt has landed
    __syncthreads();                          // and tile kt - 1 is done
    const int kn = kt + kStages - 1;          // refill tile kt - 1's stage
    if (kn < nk) load(kn % kStages, kn * kBK);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        ldsm_x4(af[i], sa + 2 * (st * kAStage + r * kALd + c));
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {        // two n8 tiles a load
        uint32_t t[4];
        if (WK) {
          const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = wn * 32 + j * 8 + (lane >> 4) * 8;
          ldsm_x4_t(t, sb + 2 * (st * kBStage + k * kBLdN + n));
        } else {
          const int n = wn * 32 + j * 8 + (lane & 7) + (lane >> 4) * 8;
          const int k = kk + ((lane >> 3) & 1) * 8;
          ldsm_x4(t, sb + 2 * (st * kBStage + n * kBLdK + k));
        }
        bf[j][0] = t[0];
        bf[j][1] = t[1];
        bf[j + 1][0] = t[2];
        bf[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }

  __nv_bfloat16* y = (__nv_bfloat16*)a.y + (long long)blockIdx.z * a.M * a.N;
  const __nv_bfloat16* bias = (const __nv_bfloat16*)a.b;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + (lane >> 2) + h * 8;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
        if (n >= a.N) continue;               // N % 8 == 0: n + 1 < N too
        __nv_bfloat16 v0 = __float2bfloat16(acc[i][j][2 * h]);
        __nv_bfloat16 v1 = __float2bfloat16(acc[i][j][2 * h + 1]);
        if (bias) {
          v0 = __float2bfloat16(__bfloat162float(v0) +
                                __bfloat162float(bias[n]));
          v1 = __float2bfloat16(__bfloat162float(v1) +
                                __bfloat162float(bias[n + 1]));
        }
        __nv_bfloat162 v;
        v.x = v0;
        v.y = v1;
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)m * a.N + n) = v;
      }
    }
}

// ------------------------------------------------------------ float32

constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(Args a) {
  __shared__ float sA[kFK][kFM + 4];          // A tile, k-major
  __shared__ float sB[kFK][kFN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int g1 = blockIdx.z / a.G2, g2 = blockIdx.z % a.G2;
  const float* x = (const float*)a.x + g1 * a.sx1 + g2 * a.sx2;
  const float* w = (const float*)a.w + g1 * a.sw1 + g2 * a.sw2;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {             // 1024 elements of each tile
      const int e = tid + i * kThreads;
      const int am = e >> 4, ak = e & 15;     // neighbours along k
      const int bk = e >> 6, bn = e & 63;     // neighbours along n
      const int m = m0 + am, k = k0 + ak;
      sA[ak][am] = (m < a.M && k < a.K) ? x[m * a.sxm + k * a.sxk] : 0.f;
      const int kb = k0 + bk, n = n0 + bn;
      sB[bk][bn] = (kb < a.K && n < a.N) ? w[kb * a.swk + n * a.swn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* y = (float*)a.y + (long long)blockIdx.z * a.M * a.N;
  const float* bias = (const float*)a.b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < a.N)
        y[(long long)m * a.N + n] = bias ? acc[i][j] + bias[n] : acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and y share it).  y is
// contiguous (G1 * G2, M, N); b (N,) or null.  bfloat16 needs sxk == 1,
// either swn == 1 (k-major weight) or swk == 1 (n-major), K and N
// multiples of 8, the other strides multiples of 8 and 16-byte aligned
// bases: the wrapper checks.
extern "C" int rows_gemm_launch(int dtype, const void* x, const void* w,
                                const void* b, void* y, int G1, int G2,
                                int M, int N, int K, long long sx1,
                                long long sx2, long long sxm, long long sxk,
                                long long sw1, long long sw2, long long swk,
                                long long swn, void* stream) {
  if (G1 <= 0 || G2 <= 0 || M <= 0 || N <= 0 || K <= 0 ||
      (long long)G1 * G2 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Args a{x, w, b, y, G2, M, N, K, sx1, sx2, sxm, sxk, sw1, sw2, swk, swn};
  if (dtype == 0) {
    dim3 grid((M + kFM - 1) / kFM, (N + kFN - 1) / kFN, G1 * G2);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    gemm_f32_kernel<<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    if (sxk != 1 || (swn != 1 && swk != 1) || K % 8 || N % 8)
      return (int)cudaErrorInvalidValue;
    static bool sized = false;   // the attribute is set once per kernel
    if (!sized) {
      cudaError_t e = cudaFuncSetAttribute(
          gemm_bf16_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemBytes);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(gemm_bf16_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
      if (e != cudaSuccess) return (int)e;
      sized = true;
    }
    dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, G1 * G2);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (swn == 1)
      gemm_bf16_kernel<true><<<grid, kThreads, kSmemBytes, s>>>(a);
    else
      gemm_bf16_kernel<false><<<grid, kThreads, kSmemBytes, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
