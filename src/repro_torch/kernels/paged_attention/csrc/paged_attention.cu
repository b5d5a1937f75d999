// Paged attention over the hybrid KV pool for Hopper: each row's queries
// attend its translated pool blocks with an online softmax, returning the
// UNNORMALIZED (o, m, l) so partial results over disjoint KV ranges merge.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py
// (_paged_attn_kernel / paged_attention_pallas).  There the grid (B, nblk)
// ran in order on one core and carried the softmax state in VMEM scratch
// across the block axis, and a hole block was DMA'd from slot 0 and then
// masked.
//
// Bound on the card: bytes.  A decode step reads every valid K/V token of
// every row once (bs * KV * D values per block and matrix) and does 4
// flops per value, far below the card's flops-per-byte balance.  So the
// design is about keeping many bytes in flight and launching once:
//
// * Split.  The block axis is cut into n_split chunks of blocks_per_split
//   blocks (the plan is `split_plan` in ops.py, a function of nblk alone,
//   so a row's result does not depend on its batch neighbours or on the
//   number of queries).  One CTA owns one (row, query, KV head, chunk); the
//   n_split <= 8 CTAs of one (row, query, KV head) form a thread-block
//   cluster.
// * Staging.  K and V stay in the pool's dtype in shared memory: each tile
//   (up to 16 KB of K and as much of V) arrives by 16-byte cp.async copies
//   into a ring of two stages, so the next tile's copy is in flight while
//   the current one is computed.  A hole block (slot < 0) and a tile
//   wholly past the extent are never loaded.
// * Math, chosen per call by dtype (TensorMath / CoreMath below).  With
//   bf16 q and pool (the decode path) the g query heads are the rows of
//   16x8x16 tensor-core MMAs: a warp scores 16 tokens at a time and adds
//   P V from the same registers (P split into bf16 hi and lo parts, two
//   MMAs each, so it keeps float32's precision as in the Pallas kernel),
//   K and V read by ldmatrix from a swizzled tile.  Otherwise (float32 q or pool) the CUDA cores do it in
//   f32, a token per D / 8 lanes (bf16; D / 4 for f32).  Either way each
//   warp (or token group) keeps its own online-softmax state, and, as in
//   the Pallas kernel, masked positions add nothing, so a query whose
//   extent is 0 comes out with l == 0 and m == -1e30.
// * Merge in the same launch.  The token groups of a CTA merge through
//   shared memory; the CTAs of a cluster then merge through distributed
//   shared memory: each rank takes a slice of the outputs and reads every
//   rank's partial for it in rank order, so the result is deterministic
//   run to run.
//
// Positions: token t of block j sits at j * block_tokens + tok_offset +
// t * tok_stride; extents are ctx[b] (one per row) or ctx[b, q] (one per
// query).  Pools are float32 or bfloat16, q float32 or bfloat16; every sum
// is float32.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;          // portable cluster size
constexpr int kStages = 2;            // cp.async ring depth
constexpr int kTileBytes = 16 * 1024; // one stage of K (and as much of V)

template <typename T, int DP>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);      // values per chunk
  static constexpr int CPR = DP / VEC;                  // chunks per row
  static constexpr int LPT = CPR < 32 ? CPR : 32;       // lanes per token
  static constexpr int CPL = CPR / LPT;                 // chunks per lane
  static constexpr int TPW = 32 / LPT;                  // tokens per warp
  static constexpr int NGRP = kWarps * TPW;             // token groups
  static constexpr int TT = kTileBytes / (DP * (int)sizeof(T));  // tile rows
  static constexpr int EPL = CPL * VEC;                 // values per lane
  static constexpr int TPG = TT / NGRP;                 // tokens per group
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void to_f32(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void to_f32(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const int* slots;
  const int* ctx;
  float* o;
  float* m;
  float* l;
  int B, Q, H, KV, D, bs, nblk, n_split, per_split;
  int block_tokens, tok_offset, tok_stride, ctx_per_query, q_bf16, vec16;
  float scale;
};

// The CTA's tiles are numbered k = (block - first block) * tiles_per_block
// + tile within the block.  Returns the first tile >= k that has a slot and
// a position inside the extent, or -1.  Uniform across the CTA.  A hole
// skips its block; so does a tile starting at or past the extent (with a
// non-negative stride the block's later tiles lie further out).
__device__ __forceinline__ int next_tile(const Params& P, int k, int n_tiles,
                                         int tpb, int tt, int j0,
                                         const int* row_slots, int extent) {
  while (k < n_tiles) {
    const int j = j0 + k / tpb, t0 = (k % tpb) * tt;
    const int p0 = j * P.block_tokens + P.tok_offset + t0 * P.tok_stride;
    if (row_slots[j] >= 0 && (P.tok_stride < 0 || p0 < extent)) return k;
    k = (k / tpb + 1) * tpb;
  }
  return -1;
}

// Chunk c (16 bytes) of staged row r sits at chunk position c ^ (r & 7)
// when the tile is read by ldmatrix (8 rows at a time, conflict-free).
template <int DP, bool SWZ>
__device__ __forceinline__ int chunk_at(int c, int r) {
  constexpr int kMask = (DP / 8 < 8 ? DP / 8 : 8) - 1;
  return SWZ ? c ^ (r & kMask) : c;
}

template <typename T, int DP, bool SWZ>
__device__ __forceinline__ void stage_tile(const Params& P, T* sk, T* sv,
                                           int slot, int kvh, int t0,
                                           int rows, int tid) {
  using G = Geo<T, DP>;
  const long long tok = (long long)P.KV * P.D;   // elements between tokens
  const long long base =
      ((long long)slot * P.bs + t0) * tok + (long long)kvh * P.D;
  const T* ks = reinterpret_cast<const T*>(P.kp) + base;
  const T* vs = reinterpret_cast<const T*>(P.vp) + base;
  if (P.vec16) {
    const int cpr = P.D / G::VEC;
    for (int e = tid; e < rows * cpr; e += kThreads) {
      const int r = e / cpr, c = e - r * cpr;
      const int at = r * DP + chunk_at<DP, SWZ>(c, r) * G::VEC;
      cp_async16(sk + at, ks + r * tok + c * G::VEC);
      cp_async16(sv + at, vs + r * tok + c * G::VEC);
    }
  } else {  // rows not 16-byte aligned: plain loads (padding stays zero)
    for (int e = tid; e < rows * P.D; e += kThreads) {
      const int r = e / P.D, d = e - r * P.D;
      sk[r * DP + d] = ks[r * tok + d];
      sv[r * DP + d] = vs[r * tok + d];
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d (rows 0..7 of 16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x
// 8, bf16).  Rows 8..15 of a are zero here (at most 8 query heads), so
// rows 8..15 of the product are zero and are not kept: d holds 2 floats.
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a2,
                                         uint32_t b0, uint32_t b1) {
  float z0 = 0.f, z1 = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(z0), "+f"(z1)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// (a, b) as the sum of two bf16 pairs: hi = bf16(a, b) and lo = bf16 of
// the remainders, so hi + lo carries 16 significant bits of each float32
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// One tile's arithmetic on the CUDA cores, any dtype.  A token group
// (LPT lanes of a warp, one 16-byte chunk of the row each) keeps its own
// online-softmax state for the g heads and scores NB of its tokens before
// one max and one rescale, so the shuffles and exps of those tokens
// overlap.
template <typename T, int DP, int G>
struct CoreMath {
  using Ge = Geo<T, DP>;
  static constexpr int VEC = Ge::VEC, LPT = Ge::LPT, CPL = Ge::CPL;
  static constexpr int EPL = Ge::EPL, NGRP = Ge::NGRP;
  // tokens scored together: as many as a tile gives a group, at most 32
  // score registers
  static constexpr int NB = Ge::TPG < 32 / G ? Ge::TPG : 32 / G;
  static constexpr bool kSwizzle = false;
  static constexpr int kGroups = NGRP;
  float qv[G][EPL], mr[G], lr[G], acc[G][EPL];
  int grp, sub;

  __device__ __forceinline__ void init(const Params& P, long long head0,
                                       int g, int tid) {
    const int lane = tid & 31;
    grp = (tid >> 5) * Ge::TPW + lane / LPT;
    sub = lane % LPT;
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int d = (sub + c * LPT) * VEC + e;
          float x = 0.f;
          if (i < g && d < P.D) {
            const long long at = (head0 + i) * P.D + d;
            x = P.q_bf16
                    ? __bfloat162float(
                          reinterpret_cast<const __nv_bfloat16*>(P.q)[at])
                    : reinterpret_cast<const float*>(P.q)[at];
          }
          qv[i][c * VEC + e] = x * P.scale;
        }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      mr[i] = kNegInf;
      lr[i] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
    }
  }

  __device__ __forceinline__ void tile(const Params& P, const T* tk,
                                       const T* tv, int rows, int p0,
                                       int extent) {
    const int iters = (rows + NGRP - 1) / NGRP;
    for (int it0 = 0; it0 < iters; it0 += NB) {
      float s[NB][G];
      bool valid[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int r = grp + (it0 + n) * NGRP;
        const bool in_tile = it0 + n < iters && r < rows;
        valid[n] = in_tile && p0 + r * P.tok_stride < extent;
#pragma unroll
        for (int i = 0; i < G; ++i) s[n][i] = 0.f;
        if (in_tile) {
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float kf[VEC];
            to_f32(tk + r * DP + (sub + c * LPT) * VEC, kf);
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                s[n][i] = fmaf(qv[i][c * VEC + e], kf[e], s[n][i]);
          }
        }
      }
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < G; ++i)
            s[n][i] += __shfl_xor_sync(0xffffffffu, s[n][i], off);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float bm = kNegInf;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          if (valid[n]) bm = fmaxf(bm, s[n][i]);
        const float m_new = fmaxf(mr[i], bm);
        const float corr = exp2f((mr[i] - m_new) * kLog2e);
        mr[i] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          s[n][i] = valid[n] ? exp2f((s[n][i] - m_new) * kLog2e) : 0.f;
          psum += s[n][i];
        }
        lr[i] = fmaf(lr[i], corr, psum);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] *= corr;
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (!valid[n]) continue;
        const int r = grp + (it0 + n) * NGRP;
        float vf[EPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          to_f32(tv + r * DP + (sub + c * LPT) * VEC, vf + c * VEC);
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[i][e] = fmaf(s[n][i], vf[e], acc[i][e]);
      }
    }
  }

  // the group's partial: m (natural log units), l, o for each head
  __device__ __forceinline__ void store(float* gm, float* gl,
                                        float* go) const {
    if (sub == 0) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        gm[grp * G + i] = mr[i];
        gl[grp * G + i] = lr[i];
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(go + (grp * G + i) * DP +
                                     (sub + c * LPT) * VEC + e) =
              make_float4(acc[i][c * VEC + e], acc[i][c * VEC + e + 1],
                          acc[i][c * VEC + e + 2], acc[i][c * VEC + e + 3]);
  }
};

// One tile's arithmetic on the tensor cores, for bf16 q and pool (the
// decode path): the g query heads are the rows of 16x8x16 bf16 MMAs
// (padded to 16), so a warp scores 16 tokens of the tile in 2 * D / 16
// MMAs, takes the row max and sum over the 4 threads that share a head,
// and adds P V in D / 4 more, P re-packed from the score fragment in
// registers as bf16 hi + lo parts.  K and V come out of the swizzled tile by ldmatrix.  Each
// warp keeps its own state: the CTA merges 4 partials.
template <int DP, int G>
struct TensorMath {
  static constexpr int KS = DP / 16;                   // k16 steps over D
  static constexpr bool kSwizzle = true;
  static constexpr int kGroups = kWarps;
  uint32_t qa[KS][2];     // q fragment (rows 0..7 = heads), cols k, k + 8
  float o[DP / 8][2];     // rows 0..7 (the heads) of the P V fragment
  float m2, ls, scale_log2;
  int lane, warp;

  __device__ __forceinline__ void init(const Params& P, long long head0,
                                       int g, int tid) {
    lane = tid & 31;
    warp = tid >> 5;
    scale_log2 = P.scale * kLog2e;
    const int r = lane >> 2, c0 = 2 * (lane & 3);
    const __nv_bfloat16* qh =
        reinterpret_cast<const __nv_bfloat16*>(P.q) + (head0 + r) * P.D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = ks * 16 + h * 8 + c0;
        qa[ks][h] = r < g && d < P.D
                        ? *reinterpret_cast<const uint32_t*>(qh + d)
                        : 0u;
      }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = 0.f;
    m2 = -INFINITY;
    ls = 0.f;
  }

  __device__ __forceinline__ void tile(const Params& P,
                                       const __nv_bfloat16* tk,
                                       const __nv_bfloat16* tv, int rows,
                                       int p0, int extent) {
    const uint32_t kb = (uint32_t)__cvta_generic_to_shared(tk);
    const uint32_t vb = (uint32_t)__cvta_generic_to_shared(tv);
    const int c0 = 2 * (lane & 3);
    const int mi = lane >> 3, ri = lane & 7;          // ldmatrix: matrix, row
    for (int t0 = warp * 16; t0 < rows; t0 += kWarps * 16) {
      // S = Q K^T for tokens t0 .. t0 + 15 (two n8 tiles)
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      const int tk_row = t0 + (mi >> 1) * 8 + ri;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        const int ch = 2 * ks + (mi & 1);
        ldsm_x4(kb + (tk_row * DP + chunk_at<DP, true>(ch, tk_row) * 8) * 2,
                b);
        mma_bf16(s[0], qa[ks][0], qa[ks][1], b[0], b[1]);
        mma_bf16(s[1], qa[ks][0], qa[ks][1], b[2], b[3]);
      }
      // online softmax of this thread's head (row lane / 4) over its 4
      // tokens; rows 8..15 are padding and are left at zero
      float x[2][2], mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + n * 8 + c0 + e;
          const bool valid = t < rows && p0 + t * P.tok_stride < extent;
          x[n][e] = valid ? s[n][e] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x[n][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m2, mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(m2 - mu);
      m2 = m_new;
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[n][e] = ex2(x[n][e] - mu);
          psum += x[n][e];
        }
      ls = fmaf(ls, corr, psum);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[n][0] *= corr;
        o[n][1] *= corr;
      }
      // P as hi + lo bf16 parts, so P V keeps P's float32 precision (V is
      // bf16 already, and the products accumulate in f32)
      uint32_t h0, l0, h2, l2;
      split_bf16(x[0][0], x[0][1], h0, l0);
      split_bf16(x[1][0], x[1][1], h2, l2);
      // O += P V: V rows t0 .. t0 + 15 read transposed, two n8 tiles each
      const int tv_row = t0 + (mi & 1) * 8 + ri;
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t b[4];
        const int ch = 2 * nn + (mi >> 1);
        ldsm_x4_trans(
            vb + (tv_row * DP + chunk_at<DP, true>(ch, tv_row) * 8) * 2, b);
        mma_bf16(o[2 * nn], h0, h2, b[0], b[1]);
        mma_bf16(o[2 * nn], l0, l2, b[0], b[1]);
        mma_bf16(o[2 * nn + 1], h0, h2, b[2], b[3]);
        mma_bf16(o[2 * nn + 1], l0, l2, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void store(float* gm, float* gl, float* go) {
    const int r = lane >> 2, c0 = 2 * (lane & 3);
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    if (r < G) {
      if ((lane & 3) == 0) {
        gm[warp * G + r] = m2 == -INFINITY ? kNegInf : m2 / kLog2e;
        gl[warp * G + r] = ls;
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        go[(warp * G + r) * DP + n * 8 + c0] = o[n][0];
        go[(warp * G + r) * DP + n * 8 + c0 + 1] = o[n][1];
      }
    }
  }
};

template <typename T, int DP, int G, typename Math>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const __grid_constant__ Params P) {
  constexpr int TT = Geo<T, DP>::TT, NG = Math::kGroups;
  constexpr bool SWZ = Math::kSwizzle;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x % P.n_split, kvh = blockIdx.x / P.n_split;
  const int qi = blockIdx.y, b = blockIdx.z;
  const int g = P.H / P.KV;
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);                  // (stages, TT, DP)
  T* sV = sK + kStages * TT * DP;
  // after the loop the ring is reused for the merge:
  float* gm = reinterpret_cast<float*>(smem);          // (NG, G)
  float* gl = gm + NG * G;                             // (NG, G)
  float* go = gl + NG * G;                             // (NG, G, DP)
  float* cm = go + NG * G * DP;                        // (G,) CTA partial
  float* cl = cm + G;
  float* co = cl + G;                                  // (G, DP)
  float* am = co + G * DP;                 // (n_split, G): every rank's m
  float* al = am + kMaxSplit * G;          // and l, for the cluster merge

  // zero the row padding (copies never touch it) and, where the tensor
  // cores read whole 16-token chunks, the rows a short block leaves unset
  if (P.D != DP || (SWZ && P.bs % 16)) {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n = 2 * kStages * TT * DP * (int)sizeof(T) / 16;
    for (int e = tid; e < n; e += kThreads) z[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  const long long row = (long long)b * P.Q + qi;
  const int extent = P.ctx[P.ctx_per_query ? row : (long long)b];
  const int* row_slots = P.slots + (long long)b * P.nblk;
  const int j0 = split * P.per_split;
  const int nb = min(P.nblk - j0, P.per_split);
  const int tt = min(TT, P.bs);
  const int tpb = (P.bs + tt - 1) / tt;
  const int n_tiles = nb > 0 ? nb * tpb : 0;

  // start the first two tiles' copies before touching q
  int k_cur = next_tile(P, 0, n_tiles, tpb, tt, j0, row_slots, extent);
  int k_nxt = -1;
  if (k_cur >= 0) {
    const int t0 = (k_cur % tpb) * tt;
    stage_tile<T, DP, SWZ>(P, sK, sV, row_slots[j0 + k_cur / tpb], kvh, t0,
                           min(tt, P.bs - t0), tid);
    k_nxt = next_tile(P, k_cur + 1, n_tiles, tpb, tt, j0, row_slots,
                      extent);
  }
  cp_async_commit();
  if (k_nxt >= 0) {
    const int t0 = (k_nxt % tpb) * tt;
    stage_tile<T, DP, SWZ>(P, sK + TT * DP, sV + TT * DP,
                           row_slots[j0 + k_nxt / tpb], kvh, t0,
                           min(tt, P.bs - t0), tid);
  }
  cp_async_commit();

  const long long head0 = row * P.H + (long long)kvh * g;
  Math math;
  math.init(P, head0, g, tid);

  int stage = 0;
  while (k_cur >= 0) {
    cp_async_wait<1>();
    __syncthreads();
    const int j = j0 + k_cur / tpb, t0 = (k_cur % tpb) * tt;
    const int p0 = j * P.block_tokens + P.tok_offset + t0 * P.tok_stride;
    math.tile(P, sK + stage * TT * DP, sV + stage * TT * DP,
              min(tt, P.bs - t0), p0, extent);
    __syncthreads();   // every thread is done with this stage
    int k_new = -1;
    if (k_nxt >= 0) {
      k_new = next_tile(P, k_nxt + 1, n_tiles, tpb, tt, j0, row_slots,
                        extent);
      if (k_new >= 0) {
        const int nt0 = (k_new % tpb) * tt;
        stage_tile<T, DP, SWZ>(P, sK + stage * TT * DP,
                               sV + stage * TT * DP,
                               row_slots[j0 + k_new / tpb], kvh, nt0,
                               min(tt, P.bs - nt0), tid);
      }
    }
    cp_async_commit();
    k_cur = k_nxt;
    k_nxt = k_new;
    stage ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the partials of this CTA (fixed order)
  math.store(gm, gl, go);
  __syncthreads();
  for (int e = tid; e < G * DP; e += kThreads) {
    const int i = e / DP, d = e - i * DP;
    float M = kNegInf;
#pragma unroll
    for (int q = 0; q < NG; ++q) M = fmaxf(M, gm[q * G + i]);
    float O = 0.f, L = 0.f;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const float w = exp2f((gm[q * G + i] - M) * kLog2e);
      O = fmaf(go[(q * G + i) * DP + d], w, O);
      L = fmaf(gl[q * G + i], w, L);
    }
    co[e] = O;
    if (d == 0) {
      cm[i] = M;
      cl[i] = L;
    }
  }

  // merge the CTAs of the cluster: each rank takes a slice of the g * D
  // outputs and reads every rank's partial for it, in rank order
  cluster.sync();
  const int n = P.n_split;
  for (int e = tid; e < n * G; e += kThreads) {
    am[e] = *cluster.map_shared_rank(cm + e % G, e / G);
    al[e] = *cluster.map_shared_rank(cl + e % G, e / G);
  }
  __syncthreads();
  for (int e = (int)cluster.block_rank() * kThreads + tid; e < g * P.D;
       e += n * kThreads) {
    const int i = e / P.D, d = e - i * P.D;
    float M = kNegInf;
    for (int r = 0; r < n; ++r) M = fmaxf(M, am[r * G + i]);
    float part[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      part[r] = r < n ? *cluster.map_shared_rank(co + i * DP + d, r) : 0.f;
    float O = 0.f, L = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r >= n) break;
      const float w = exp2f((am[r * G + i] - M) * kLog2e);
      O = fmaf(part[r], w, O);
      L = fmaf(al[r * G + i], w, L);
    }
    P.o[(head0 + i) * P.D + d] = O;
    if (d == 0) {
      P.m[head0 + i] = M;
      P.l[head0 + i] = L;
    }
  }
  cluster.sync();   // keep every rank's shared memory alive until read
}

template <typename T, int DP, int G, typename Math>
int launch_kernel(const Params& P, cudaStream_t stream) {
  const size_t ring =
      2 * (size_t)kStages * Geo<T, DP>::TT * DP * sizeof(T);
  const size_t merge =
      sizeof(float) * ((size_t)Math::kGroups * G * (DP + 2) +
                       G * (DP + 2) + 2 * kMaxSplit * G);
  const size_t smem = ring > merge ? ring : merge;
  auto kern = paged_attn_kernel<T, DP, G, Math>;
  static bool sized = false;   // the attribute is set once per kernel
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.KV * P.n_split, P.Q, P.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int DP, int G>
int launch_math(const Params& P, cudaStream_t s) {
  if constexpr (sizeof(T) == 2 && DP >= 16) {
    // the tensor cores when q is bf16 too and every row is whole 16-value
    // chunks (q rounded to bf16 would not hold float32 q's precision)
    if (P.q_bf16 && P.vec16 && P.D % 16 == 0)
      return launch_kernel<T, DP, G, TensorMath<DP, G>>(P, s);
  }
  return launch_kernel<T, DP, G, CoreMath<T, DP, G>>(P, s);
}

template <typename T, int DP>
int launch_g(const Params& P, cudaStream_t s) {
  const int g = P.H / P.KV;
  if (g <= 1) return launch_math<T, DP, 1>(P, s);
  if (g <= 2) return launch_math<T, DP, 2>(P, s);
  if (g <= 4) return launch_math<T, DP, 4>(P, s);
  return launch_math<T, DP, 8>(P, s);
}

template <typename T>
int launch_d(const Params& P, cudaStream_t s) {
  if (P.D <= 16) return launch_g<T, 16>(P, s);
  if (P.D <= 32) return launch_g<T, 32>(P, s);
  if (P.D <= 64) return launch_g<T, 64>(P, s);
  if (P.D <= 128) return launch_g<T, 128>(P, s);
  return launch_g<T, 256>(P, s);
}

}  // namespace

// dtype: 0 = float32 pools, 1 = bfloat16 pools; q_bf16: q's dtype.  The
// split plan (n_split <= 8 chunks of per_split blocks) comes from the
// caller; vec16 says every K/V row starts on a 16-byte boundary.
extern "C" int paged_attention_launch(
    int dtype, int q_bf16, const void* q, const void* kp, const void* vp,
    const void* slots, const void* ctx, void* o, void* m, void* l, int B,
    int Q, int H, int KV, int D, int bs, int nblk, int n_split,
    int per_split, int block_tokens, int tok_offset, int tok_stride,
    int ctx_per_query, int vec16, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > 8 || D <= 0 || D > 256 ||
      n_split < 1 || n_split > kMaxSplit || per_split < 1 ||
      (long long)n_split * per_split < nblk)
    return (int)cudaErrorInvalidValue;
  Params P = {q, kp, vp, (const int*)slots, (const int*)ctx, (float*)o,
              (float*)m, (float*)l, B, Q, H, KV, D, bs, nblk, n_split,
              per_split, block_tokens, tok_offset, tok_stride,
              ctx_per_query, q_bf16, vec16,
              (float)(1.0 / sqrt((double)D))};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(P, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(P, s);
  return (int)cudaErrorInvalidValue;
}
