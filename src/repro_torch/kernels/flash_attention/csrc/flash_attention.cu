// Causal (or full) flash attention with GQA for Hopper: the prefill's
// self-attention, normalized output in q's dtype.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_flash_kernel /
// flash_attention_pallas).  The Pallas grid (B, H, q_tiles, kv_tiles) ran
// the kv axis in order and carried the softmax state in VMEM scratch; it
// asserted that S divides the 128-row tiles.  Here one CTA owns one
// (b, h, query tile) and loops over key tiles staged in shared memory with
// an f32 online softmax.  KV tiles wholly above the diagonal are skipped,
// and the ragged edges (S not a multiple of the tile, e.g. an 8-token
// prefill bucket) are masked instead of asserted.  kv head = h / (H / KV).
//
// Bound on the card: operations.  Causal attention does 4 * D flops per
// (query, key) pair with k <= q while reading each q, k, v and writing each
// output once; at prefill lengths that is far above the card's
// flops-per-byte balance, so the products belong on the tensor cores.
//
// Two kernels, by dtype:
// * bfloat16 (the serving path): 64-query tiles, one warp per 16 rows,
//   both products as 16x16x16 bf16 tensor-core MMAs (WMMA) with f32
//   accumulators; the running output lives in shared memory, rescaled per
//   key tile, and P is rounded to bf16 for the second product (as FA2 does).
// * float32: 32-query tiles with both products as f32 FMAs on the CUDA
//   cores, so float32 stays float32; warp w owns query rows w, w+4, ...,
//   each lane one key, so row max and sum are warp shuffles.
// wgmma tiles fed by TMA (Hopper's full tensor-core rate) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per CTA
constexpr int kBK = 32;  // keys per tile (one per lane)
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  // sQ and sK padded to D + 1 (conflict-free column reads), sV, sP, sRow
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) + kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / 4;  // output columns per thread
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * D;
  float* sRow = sP + kBQ * (kBK + 1);

  const int q0 = qt * kBQ;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D, qp = q0 + r;
    sQ[r * DP + d] =
        qp < Sq ? to_f(q[(((long long)b * Sq + qp) * H + h) * D + d]) : 0.f;
  }

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  const int orow = tid >> 2, dg = tid & 3;  // PV mapping: row, column group
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  int n_kv = (Skv + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);  // skip above diag
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D, kpos = k0 + r;
      const long long off = (((long long)b * Skv + kpos) * KV + hk) * D + d;
      sK[r * DP + d] = kpos < Skv ? to_f(k[off]) : 0.f;
      sV[r * D + d] = kpos < Skv ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T: this thread's key column `lane`, rows warp + 4 i
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[lane * DP + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] += sQ[(warp + 4 * i) * DP + d] * kd;
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + 4 * i, qpos = q0 + r;
      const bool valid = kpos < Skv && (!causal || kpos <= qpos);
      const float sv = valid ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m_r[i], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float corr = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * corr + warp_sum(p);
      m_r[i] = m_new;
      sP[r * (kBK + 1) + lane] = p;
      if (lane == 0) sRow[r] = corr;
    }
    __syncthreads();

    // O = O * corr + P V
    const float corr = sRow[orow];
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= corr;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = sP[orow * (kBK + 1) + kk];
      const float* vr = sV + kk * D + dg;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[c] += p * vr[4 * c];
    }
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sRow[warp + 4 * i] = l_r[i];
  }
  __syncthreads();
  const int qp = q0 + orow;
  if (qp < Sq) {
    const float l = fmaxf(sRow[orow], 1e-30f);
    T* out = o + (((long long)b * Sq + qp) * H + h) * D + dg;
#pragma unroll
    for (int c = 0; c < DPT; ++c) out[4 * c] = from_f<T>(acc[c] / l);
  }
}

// ---------------------------------------------- bfloat16: tensor cores

constexpr int kTcBQ = 64;  // query rows per CTA: 4 warps x 16 rows
constexpr int kTcBK = 64;  // keys per tile

template <int D>
struct TcLayout {
  // row strides (elements): bf16 multiples of 8, f32 multiples of 4, as
  // WMMA requires; the padding also spreads rows over the smem banks
  static constexpr int LDH = D + 8;       // sQ, sK, sV (bf16)
  static constexpr int LDS = kTcBK + 4;   // sS scores (f32)
  static constexpr int LDP = kTcBK + 8;   // sP probabilities (bf16)
  static constexpr int LDO = D + 4;       // sO running output (f32)
  // byte offsets; every one a multiple of 32 (WMMA's pointer alignment)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + 2 * kTcBQ * LDH;
  static constexpr size_t kV = kK + 2 * kTcBK * LDH;
  static constexpr size_t kS = kV + 2 * kTcBK * LDH;
  static constexpr size_t kP = kS + 4 * kTcBQ * LDS;
  static constexpr size_t kO = kP + 2 * kTcBQ * LDP;
  static constexpr size_t kM = kO + 4 * kTcBQ * LDO;
  static constexpr size_t bytes = kM + 4 * 2 * kTcBQ;
};

// Copy a (rows, D) bf16 tile from global rows (stride `gstride` elements)
// into shared memory (stride LDH), 16 bytes per thread per step; rows at or
// past `valid` are zero-filled.
template <int D, int LDH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long gstride, int rows,
                                          int valid, int tid) {
  constexpr int kChunks = D / 8;
  for (int e = tid; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e - r * kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * gstride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                    int KV, int causal, float scale) {
  using namespace nvcuda;
  using L = TcLayout<D>;
  using bf16 = __nv_bfloat16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + L::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem_raw + L::kV);
  float* sS = reinterpret_cast<float*>(smem_raw + L::kS);
  bf16* sP = reinterpret_cast<bf16*>(smem_raw + L::kP);
  float* sO = reinterpret_cast<float*>(smem_raw + L::kO);
  float* sM = reinterpret_cast<float*>(smem_raw + L::kM);
  float* sL = sM + kTcBQ;

  const int q0 = qt * kTcBQ;
  load_tile<D, L::LDH>(sQ, q + (((long long)b * Sq + q0) * H + h) * D,
                       (long long)H * D, kTcBQ, Sq - q0, tid);
  for (int e = tid; e < kTcBQ * D; e += kThreads)
    sO[(e / D) * L::LDO + e % D] = 0.f;
  for (int r = tid; r < kTcBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  const int r0 = warp * 16;  // this warp's query rows
  int n_kv = (Skv + kTcBK - 1) / kTcBK;
  if (causal) n_kv = min(n_kv, (q0 + kTcBQ - 1) / kTcBK + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTcBK;
    __syncthreads();  // the previous tile's sK / sV reads are done
    const long long kv_off = (((long long)b * Skv + k0) * KV + hk) * D;
    load_tile<D, L::LDH>(sK, k + kv_off, (long long)KV * D, kTcBK,
                         Skv - k0, tid);
    load_tile<D, L::LDH>(sV, v + kv_off, (long long)KV * D, kTcBK,
                         Skv - k0, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[kTcBK / 16];
#pragma unroll
    for (int c = 0; c < kTcBK / 16; ++c) wmma::fill_fragment(sf[c], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sQ + r0 * L::LDH + kk, L::LDH);
#pragma unroll
      for (int c = 0; c < kTcBK / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, sK + c * 16 * L::LDH + kk, L::LDH);
        wmma::mma_sync(sf[c], a, bk, sf[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTcBK / 16; ++c)
      wmma::store_matrix_sync(sS + r0 * L::LDS + c * 16, sf[c], L::LDS,
                              wmma::mem_row_major);
    __syncwarp();

    // online softmax over the warp's rows: lane holds keys lane, lane + 32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, qpos = q0 + r;
      const int ka = k0 + lane, kb = ka + 32;
      const bool va = ka < Skv && (!causal || ka <= qpos);
      const bool vb = kb < Skv && (!causal || kb <= qpos);
      const float sa = va ? sS[r * L::LDS + lane] * scale : kNegInf;
      const float sb = vb ? sS[r * L::LDS + lane + 32] * scale : kNegInf;
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sa, sb)));
      const float pa = va ? expf(sa - m_new) : 0.f;
      const float pb = vb ? expf(sb - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float lsum = warp_sum(pa + pb);
      sP[r * L::LDP + lane] = __float2bfloat16(pa);
      sP[r * L::LDP + lane + 32] = __float2bfloat16(pb);
      for (int d = lane; d < D; d += 32) sO[r * L::LDO + d] *= corr;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + lsum;
      }
    }
    __syncwarp();

    // O += P V for this warp's rows
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
        pf[kTcBK / 16];
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], sP + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, sO + r0 * L::LDO + c * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sV + kk * 16 * L::LDH + c * 16, L::LDH);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(sO + r0 * L::LDO + c * 16, of, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, qp = q0 + r;
    if (qp >= Sq) break;
    const float l = fmaxf(sL[r], 1e-30f);
    bf16* out = o + (((long long)b * Sq + qp) * H + h) * D;
    for (int d = lane; d < D; d += 32)
      out[d] = __float2bfloat16(sO[r * L::LDO + d] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int causal, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = TcLayout<D>::bytes;
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Sq + kTcBQ - 1) / kTcBQ, H, B);
    flash_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Sq, Skv, H, KV, causal,
        scale);
  } else {
    const size_t smem = sizeof(float) * smem_floats<D>();
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, KV, causal,
        scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Skv, int H, int KV, int causal,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, causal, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KV, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it)
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int H, int KV,
                                      int D, int causal, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, Sq, Skv, H, KV, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, H, KV, causal,
                                   s);
  return (int)cudaErrorInvalidValue;
}
