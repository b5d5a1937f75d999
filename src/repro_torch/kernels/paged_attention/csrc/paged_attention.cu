// Paged attention over the hybrid KV pool for Hopper: each row's queries
// attend its translated pool blocks with an online softmax, returning the
// UNNORMALIZED (o, m, l) so partial results over disjoint KV ranges merge.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py
// (_paged_attn_kernel / paged_attention_pallas).  There the grid (B, nblk)
// ran in order on one core and carried the softmax state in VMEM scratch
// across the block axis, and a hole block was DMA'd from slot 0 and then
// masked.  Here the block axis is split into chunks of kBlocksPerSplit
// blocks (flash-decoding): one CTA owns one (row, query, KV head, chunk),
// stages each of its blocks' K and V rows in shared memory with coalesced
// loads, and keeps m, l and the weighted sum of the g query heads of its KV
// head; a second kernel merges the chunks' partials.  A hole block
// (slot < 0) and a block wholly past the extent are skipped without a
// load.  As in the Pallas kernel the mask is applied after the exp, so a
// query whose extent is 0 comes out with l == 0 and m == -1e30.  The split
// depends on nblk only, so a row's result does not depend on the batch or
// on the number of queries.
//
// Bound on the card: bytes.  A decode step reads every valid K/V token of
// every row once (bs * KV * D * 2 values per block) and does 4 flops per
// value, far below the card's flops-per-byte balance.  Splitting the block
// axis puts B * Q * KV * ceil(nblk / 2) CTAs in flight instead of
// B * Q * KV, so a decode batch of 4 keeps the SMs busy; staging whole
// blocks lets every thread issue its loads back to back.
//
// Positions: token t of block j sits at j * block_tokens + tok_offset +
// t * tok_stride; extents are ctx[b] (one per row) or ctx[b, q] (one per
// query).  Pools are float32 or bfloat16; q arrives as float32 and every
// sum is float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;            // query heads per KV head
constexpr int kBlocksPerSplit = 2;  // pool blocks per CTA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

size_t smem_bytes(int g, int D, int bs) {
  // sq, sacc (g, D); sK (bs, D + 1); sV (bs, D); ss (g, bs); sm, sl, scorr
  return sizeof(float) *
         (2 * g * D + bs * (D + 1) + bs * D + g * bs + 3 * g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const int* __restrict__ slots,
                      const int* __restrict__ ctx, float* __restrict__ o_part,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      int B, int Q, int H, int KV, int D, int bs, int nblk,
                      int n_split, int block_tokens, int tok_offset,
                      int tok_stride, int ctx_per_query, float scale) {
  const int kvh = blockIdx.x / n_split, split = blockIdx.x % n_split;
  const int qi = blockIdx.y, b = blockIdx.z;
  const int g = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int DP = D + 1;
  extern __shared__ float smem[];
  float* sq = smem;             // (g, D) queries of this KV head
  float* sacc = sq + g * D;     // (g, D) weighted values
  float* sK = sacc + g * D;     // (bs, D + 1) staged K rows
  float* sV = sK + bs * DP;     // (bs, D) staged V rows
  float* ss = sV + bs * D;      // (g, bs) scores, then weights
  float* sm = ss + g * bs;      // (g,) running max
  float* sl = sm + g;           // (g,) running sum
  float* scorr = sl + g;        // (g,) this block's rescale

  const long long row = (long long)b * Q + qi;
  const long long head0 = row * H + (long long)kvh * g;
  for (int e = tid; e < g * D; e += kThreads) {
    sq[e] = q[head0 * D + e];
    sacc[e] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    sm[i] = kNegInf;
    sl[i] = 0.f;
  }
  const int extent = ctx[ctx_per_query ? row : (long long)b];
  const long long tok_elems = (long long)KV * D;
  const int j_end = min(nblk, (split + 1) * kBlocksPerSplit);
  __syncthreads();

  for (int j = split * kBlocksPerSplit; j < j_end; ++j) {
    // uniform across the CTA: every thread reads the same slot and extent
    const int slot = slots[(long long)b * nblk + j];
    const int p0 = j * block_tokens + tok_offset;
    if (slot < 0) continue;                          // hole
    if (tok_stride >= 0 && p0 >= extent) continue;   // wholly masked
    const T* kblk = kp + ((long long)slot * bs * KV + kvh) * D;
    const T* vblk = vp + ((long long)slot * bs * KV + kvh) * D;
    for (int e = tid; e < bs * D; e += kThreads) {
      const int t = e / D, d = e - t * D;
      sK[t * DP + d] = to_f(kblk[t * tok_elems + d]);
      sV[e] = to_f(vblk[t * tok_elems + d]);
    }
    __syncthreads();

    // scores: one thread per (head, token)
    for (int e = tid; e < g * bs; e += kThreads) {
      const int i = e / bs, t = e - i * bs;
      if (p0 + t * tok_stride < extent) {
        const float* qr = sq + i * D;
        const float* kr = sK + t * DP;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc += qr[d] * kr[d];
        ss[e] = acc * scale;
      } else {
        ss[e] = kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, mask after the exp
    for (int i = warp; i < g; i += kWarps) {
      float bm = kNegInf;
      for (int t = lane; t < bs; t += 32) bm = fmaxf(bm, ss[i * bs + t]);
      bm = warp_max(bm);
      const float m_prev = sm[i];
      const float m_new = fmaxf(m_prev, bm);
      float lsum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const bool valid = p0 + t * tok_stride < extent;
        const float p = valid ? expf(ss[i * bs + t] - m_new) : 0.f;
        ss[i * bs + t] = p;
        lsum += p;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sl[i] = sl[i] * corr + lsum;
        sm[i] = m_new;
        scorr[i] = corr;
      }
    }
    __syncthreads();

    // weighted values: one thread per dim, all g heads at once
    for (int d = tid; d < D; d += kThreads) {
      float acc[kMaxG];
#pragma unroll
      for (int i = 0; i < kMaxG; ++i)
        acc[i] = i < g ? sacc[i * D + d] * scorr[i] : 0.f;
      for (int t = 0; t < bs; ++t) {
        const float vv = sV[t * D + d];
#pragma unroll
        for (int i = 0; i < kMaxG; ++i)
          if (i < g) acc[i] += ss[i * bs + t] * vv;
      }
#pragma unroll
      for (int i = 0; i < kMaxG; ++i)
        if (i < g) sacc[i * D + d] = acc[i];
    }
    __syncthreads();
  }

  const long long rows = (long long)B * Q * H;
  const long long part = split * rows + head0;
  for (int e = tid; e < g * D; e += kThreads) o_part[part * D + e] = sacc[e];
  for (int i = tid; i < g; i += kThreads) {
    m_part[part + i] = sm[i];
    l_part[part + i] = sl[i];
  }
}

// Merge the chunks' partials: one CTA per (row, query, head).
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ o_part,
                   const float* __restrict__ m_part,
                   const float* __restrict__ l_part, float* __restrict__ o,
                   float* __restrict__ m, float* __restrict__ l, int rows,
                   int D, int n_split) {
  const int r = blockIdx.x;
  float mg = kNegInf;
  for (int s = 0; s < n_split; ++s) mg = fmaxf(mg, m_part[s * rows + r]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s)
      acc += o_part[((long long)s * rows + r) * D + d] *
             expf(m_part[s * rows + r] - mg);
    o[(long long)r * D + d] = acc;
  }
  if (threadIdx.x == 0) {
    float lsum = 0.f;
    for (int s = 0; s < n_split; ++s)
      lsum += l_part[s * rows + r] * expf(m_part[s * rows + r] - mg);
    m[r] = mg;
    l[r] = lsum;
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* slots,
           const void* ctx, void* o, void* m, void* l, void* o_part,
           void* m_part, void* l_part, int B, int Q, int H, int KV, int D,
           int bs, int nblk, int block_tokens, int tok_offset,
           int tok_stride, int ctx_per_query, cudaStream_t stream) {
  const int g = H / KV;
  const size_t smem = smem_bytes(g, D, bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_split = (nblk + kBlocksPerSplit - 1) / kBlocksPerSplit;
  const float scale = (float)(1.0 / sqrt((double)D));
  const bool merge = n_split > 1;
  dim3 grid(KV * n_split, Q, B);
  paged_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const T*)kp, (const T*)vp, (const int*)slots,
      (const int*)ctx, (float*)(merge ? o_part : o),
      (float*)(merge ? m_part : m), (float*)(merge ? l_part : l), B, Q, H,
      KV, D, bs, nblk, n_split, block_tokens, tok_offset, tok_stride,
      ctx_per_query, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !merge) return (int)e;
  const int rows = B * Q * H;
  combine_kernel<<<rows, kThreads, 0, stream>>>(
      (const float*)o_part, (const float*)m_part, (const float*)l_part,
      (float*)o, (float*)m, (float*)l, rows, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Partials the caller must allocate: o_part (n_split, B, Q, H, D) and
// m_part, l_part (n_split, B, Q, H), float32, n_split as returned here.
extern "C" int paged_attention_splits(int nblk) {
  return (nblk + kBlocksPerSplit - 1) / kBlocksPerSplit;
}

// dtype: 0 = float32 pools, 1 = bfloat16 pools
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* kp, const void* vp,
    const void* slots, const void* ctx, void* o, void* m, void* l,
    void* o_part, void* m_part, void* l_part, int B, int Q, int H, int KV,
    int D, int bs, int nblk, int block_tokens, int tok_offset, int tok_stride,
    int ctx_per_query, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kp, vp, slots, ctx, o, m, l, o_part, m_part,
                         l_part, B, Q, H, KV, D, bs, nblk, block_tokens,
                         tok_offset, tok_stride, ctx_per_query, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, slots, ctx, o, m, l, o_part,
                                 m_part, l_part, B, Q, H, KV, D, bs, nblk,
                                 block_tokens, tok_offset, tok_stride,
                                 ctx_per_query, s);
  return (int)cudaErrorInvalidValue;
}
