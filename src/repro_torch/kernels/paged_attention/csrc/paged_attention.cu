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
//   number of queries).  One CTA owns one (row, query tile, KV head,
//   chunk); the n_split <= 8 CTAs of one (row, query tile, KV head) form a
//   thread-block cluster.
// * Query tiles.  With Q > 1 (the prefix-KV prefill's read, the verify
//   step's) a CTA takes QT consecutive queries (`query_tile` in ops.py:
//   32 (query, head) rows at D <= 128 and 16 above on the tensor cores, 8
//   on the CUDA cores), so a row's K/V tiles are staged once per query
//   tile and not once per query.  The decode read (Q = 1) is a query tile
//   of one.
// * Staging.  K and V stay in the pool's dtype in shared memory: each tile
//   (up to 16 KB of K and as much of V) arrives by 16-byte cp.async copies
//   into a ring of two stages, so the next tile's copy is in flight while
//   the current one is computed.  A hole block (slot < 0) and a tile past
//   the extent of every query of the tile are never loaded.
// * Math, chosen per call by dtype (TensorMath / CoreMath below).  With
//   bf16 q and pool (the decode path) the (query, head) pairs are the rows
//   of 16x8x16 tensor-core MMAs (at Q = 1 the g heads, padded to 16; with
//   a query tile whole m16 tiles, one or two a warp): a warp scores 16
//   tokens at a time and adds P V from the same registers (P split into
//   bf16 hi and lo parts, two MMAs each, so it keeps float32's precision
//   as in the Pallas kernel), K and V (and a query tile's q) read by
//   ldmatrix from swizzled tiles, each K and V fragment once for every
//   m16 tile.  Otherwise (float32 q or pool) the CUDA cores do it in f32,
//   a token per D / 8 lanes (bf16; D / 4 for f32), one query after the
//   other against the staged tile (QT * G <= 8 rows, their state in
//   registers).  Either way each warp (or token group)
//   keeps its own online-softmax state, and, as in the Pallas kernel,
//   masked positions add nothing, so a query whose extent is 0 comes out
//   with l == 0 and m == -1e30.
// * Merge in the same launch.  The token groups of a CTA merge through
//   shared memory; the CTAs of a cluster then merge through distributed
//   shared memory: each rank takes a slice of the outputs and reads every
//   rank's partial for it in rank order, so the result is deterministic
//   run to run.
//
// The contract the query tiles keep: a (query, head) row's arithmetic is
// the same wherever the row sits in an m16 tile or a query tile, and the
// same as in a Q = 1 launch at that query's extent: the split, the tokens
// each warp or token group takes and their order, the masking by the
// query's own extent, the online-softmax update order, the P hi/lo split
// and the merge order.  A tile that lies past one query's extent but not
// past another's leaves the first query's state as it is (every position
// masked: the rescale is by exp2(0) == 1 and P is 0; on the CUDA cores
// the query skips the tile).  A row no token reached is m == -1e30, l ==
// 0, o == 0 in every partial, and adds exactly nothing to a merge, so a
// query tile's merge skips reading it.  So query i of any launch is bitwise a Q = 1
// launch at its extent, which speculative decoding's losslessness needs.
//
// Fold (the fold kernel, at D = 64 and D = 256: `read_plan` in ops.py).
// The cluster kernel's split, a function of nblk alone, gives paligemma's
// one KV head 8 CTAs a row (32 for B = 4 on 132 SMs), each walking 128
// tokens through a two-stage ring, then a CTA merge and two cluster syncs
// (together ~13,000 cycles of its ~28,000: chip_smoke.py --paged-reads);
// whisper's 512 CTAs move 32 KB each, so fixed costs dominate.  Here a
// chunk is a block, and at Q <= 8 (the decode and verify reads) each chunk
// has its own CTA, on the tensor cores at D = 256 two: each computes the
// chunk's scores whole and P V for half of the columns, which gives a
// column the bits of a CTA that computes them all.  So the decode read
// has nblk * 2 CTAs a (row, KV head) at paligemma's geometry (128 at B =
// 4) and nblk a KV head at whisper's (1,024).  A chunk's tiles arrive by
// 16-byte cp.async copies into rows padded by 16 bytes, so ldmatrix reads
// them without bank conflicts and without a swizzle.  Each chunk starts
// from a fresh state; its warps' (token groups') partials merge as in the
// cluster kernel; then the chunks fold in chunk order:
//   M' = max(M, m_c), a = 2^((M - M') log2 e), w = 2^((m_c - M') log2 e),
//   l' = l_c w + l a, o' = o_c w + o a   (one rounding each: fmaf(x, w, y a))
// from M = -1e30, l = 0, o = 0, skipping a chunk no token reached.  A CTA
// writes its chunk's partial to a workspace and adds one to a counter of
// its (row, query tile, KV head, column half); the CTA that brings it to
// n_split folds every partial and sets it back to 0, so it is one launch
// and its result does not depend on which CTA came last.  At Q > 8 (the
// prefix read, whose partials would take hundreds of MB) one CTA takes
// every chunk of its (row, query tile, KV head) in order and folds as it
// goes, by the same arithmetic; so query i of any launch is still bitwise
// a Q = 1 launch, and a row alone bitwise the row in a batch.
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
// row stride (floats) of the token groups' o partials in shared memory: 8
// floats of padding put the rows of one MMA fragment store in other banks
template <int DP>
constexpr int kOStride = DP + 8;

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
  // the fold kernel's plan: chunk c is block c; cta_split CTAs a (row,
  // query tile, KV head[, column half]): n_split (one chunk each, partials
  // in ws, counters) or 1 (every chunk in order)
  int cta_split;
  float* ws;
  int* counters;
  // where non-null, kStamps stamps of each CTA (in blockIdx order): the
  // stage breakdown of chip_smoke.py --paged-reads (see `mark`)
  unsigned long long* stamps;
};

// A CTA's stamps: %globaltimer (ns) at its start and end (slots 0, 1), its
// SM's clock64 at stages 0..5 (slots 2..7: start, first tile in, tiles
// done, CTA merge done, partial written or cluster merge done, end), 1
// where it wrote the result (slot 8), the tiles it computed (slot 9); the
// fold kernel's folding CTA also its clock64 after the counter and the
// fence, after its m and l arrived, after the weights (slots 10..12).
constexpr int kStamps = 13;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp_at(const Params& P, int slot,
                                         unsigned long long v) {
  if (P.stamps != nullptr && threadIdx.x == 0) {
    const long long cta =
        blockIdx.x + (long long)gridDim.x *
                         (blockIdx.y + (long long)gridDim.y * blockIdx.z);
    P.stamps[cta * kStamps + slot] = v;
  }
}
__device__ __forceinline__ void mark(const Params& P, int stage) {
  if (P.stamps == nullptr) return;
  stamp_at(P, 2 + stage, (unsigned long long)clock64());
  if (stage == 0) stamp_at(P, 0, global_ns());
  if (stage == 5) stamp_at(P, 1, global_ns());
}

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
// d (16 x 8, f32: rows r and r + 8 of this lane) += a (16 x 16) * b, all
// 16 rows kept (a query tile's (query, head) rows)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The CTA's query tile: queries qt0 .. qt0 + nq - 1 of row b.
struct QTile {
  long long head0;   // q/o head index of query qt0's first head of the KV head
  const int* ctx;    // query qt0's extent; query qt0 + j's at ctx[j * cstep]
  int cstep, nq, g;
};

// One tile's arithmetic on the CUDA cores, any dtype.  A token group
// (LPT lanes of a warp, one 16-byte chunk of the row each) keeps its own
// online-softmax state for the g heads and scores NB of its tokens before
// one max and one rescale, so the shuffles and exps of those tokens
// overlap.  A query tile (QT * G <= 8 rows, so the state stays in as many
// registers as eight heads take) goes query after query over the staged
// tile, each query skipping a tile that lies past its own extent.
template <typename T, int DP, int G, int QT, int RS = DP>
struct CoreMath {
  using Ge = Geo<T, DP>;
  static constexpr int VEC = Ge::VEC, LPT = Ge::LPT, CPL = Ge::CPL;
  static constexpr int EPL = Ge::EPL, NGRP = Ge::NGRP;
  // tokens scored together: as many as a tile gives a group, at most 32
  // score registers
  static constexpr int NB = Ge::TPG < 32 / G ? Ge::TPG : 32 / G;
  static constexpr int R = QT * G;                     // row = query * G + head
  static_assert(R <= 8, "the CUDA cores keep at most 8 rows' state");
  static constexpr bool kSwizzle = false;
  static constexpr int kQBytes = 0;
  static constexpr int kGroups = NGRP;
  static constexpr int kDV = DP;           // every output column
  int dv0 = 0;
  float qv[R][EPL], mr[R], lr[R], acc[R][EPL];
  int ext[QT];                                         // each query's extent
  int grp, sub, nq;

  __device__ __forceinline__ void init(const Params& P, const QTile& qt,
                                       int tid, unsigned char*) {
    const int lane = tid & 31;
    grp = (tid >> 5) * Ge::TPW + lane / LPT;
    sub = lane % LPT;
    nq = qt.nq;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      ext[j] = j < qt.nq ? qt.ctx[j * qt.cstep] : 0;
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int d = (sub + c * LPT) * VEC + e;
            float x = 0.f;
            if (j < qt.nq && i < qt.g && d < P.D) {
              const long long at =
                  (qt.head0 + (long long)j * P.H + i) * P.D + d;
              x = P.q_bf16
                      ? __bfloat162float(
                            reinterpret_cast<const __nv_bfloat16*>(P.q)[at])
                      : reinterpret_cast<const float*>(P.q)[at];
            }
            qv[j * G + i][c * VEC + e] = x * P.scale;
          }
    }
    reset();
  }

  // a fresh online-softmax state (a new chunk of the fold kernel)
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      mr[i] = kNegInf;
      lr[i] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
    }
  }

  // query j's arithmetic over one staged tile, masked by its extent
  __device__ __forceinline__ void tile_one(const Params& P, const T* tk,
                                           const T* tv, int rows, int p0,
                                           int j) {
    const int iters = (rows + NGRP - 1) / NGRP;
    for (int it0 = 0; it0 < iters; it0 += NB) {
      float s[NB][G];
      bool valid[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int r = grp + (it0 + n) * NGRP;
        const bool in_tile = it0 + n < iters && r < rows;
        valid[n] = in_tile && p0 + r * P.tok_stride < ext[j];
#pragma unroll
        for (int i = 0; i < G; ++i) s[n][i] = 0.f;
        if (in_tile) {
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float kf[VEC];
            to_f32(tk + r * RS + (sub + c * LPT) * VEC, kf);
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                s[n][i] = fmaf(qv[j * G + i][c * VEC + e], kf[e], s[n][i]);
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
        const int w = j * G + i;
        float bm = kNegInf;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          if (valid[n]) bm = fmaxf(bm, s[n][i]);
        const float m_new = fmaxf(mr[w], bm);
        const float corr = exp2f((mr[w] - m_new) * kLog2e);
        mr[w] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          s[n][i] = valid[n] ? exp2f((s[n][i] - m_new) * kLog2e) : 0.f;
          psum += s[n][i];
        }
        lr[w] = fmaf(lr[w], corr, psum);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[w][e] *= corr;
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (!valid[n]) continue;
        const int r = grp + (it0 + n) * NGRP;
        float vf[EPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          to_f32(tv + r * RS + (sub + c * LPT) * VEC, vf + c * VEC);
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[j * G + i][e] = fmaf(s[n][i], vf[e], acc[j * G + i][e]);
      }
    }
  }

  __device__ __forceinline__ void tile(const Params& P, const T* tk,
                                       const T* tv, int rows, int p0,
                                       int = 0) {
#pragma unroll
    for (int j = 0; j < QT; ++j)
      // a Q = 1 launch at query j's extent never loads a tile past it
      if (j < nq && (P.tok_stride < 0 || p0 < ext[j]))
        tile_one(P, tk, tv, rows, p0, j);
  }

  // the group's partial: m (natural log units), l, o for each row
  __device__ __forceinline__ void store(float* gm, float* gl,
                                        float* go) const {
    if (sub == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        gm[grp * R + i] = mr[i];
        gl[grp * R + i] = lr[i];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(go + (grp * R + i) * kOStride<DP> +
                                     (sub + c * LPT) * VEC + e) =
              make_float4(acc[i][c * VEC + e], acc[i][c * VEC + e + 1],
                          acc[i][c * VEC + e + 2], acc[i][c * VEC + e + 3]);
  }
};

// One tile's arithmetic on the tensor cores, for bf16 q and pool (the
// decode path): the (query, head) rows are the rows of 16x8x16 bf16 MMAs,
// so a warp scores 16 tokens of the tile in 2 * D / 16 MMAs an m16 tile,
// takes the row max and sum over the 4 threads that share a row, and adds
// P V in D / 4 more, P re-packed from the score fragment in registers as
// bf16 hi + lo parts.  K and V come out of the swizzled tile by ldmatrix,
// each fragment once for all of the warp's m16 tiles.  At Q = 1 the g
// heads are rows 0..7 (rows 8..15 zero, not kept) and q's fragment stays
// in registers; a query tile's QT * G rows fill MT whole m16 tiles, its q
// staged in shared memory and read by ldmatrix.  Each warp keeps its own
// state: the CTA merges 4 partials.
// DV: the output columns this CTA's P V computes (DP, or half of it in
// the fold kernel's D-halves), from column dv0
template <int DP, int G, int QT, int RS = DP, bool SWZ = true, int DV = DP>
struct TensorMath {
  static constexpr int KS = DP / 16;                   // k16 steps over D
  static constexpr int R = QT * G;
  static constexpr bool kFull = R > 8;
  static_assert(kFull ? R % 16 == 0 : QT == 1,
                "a query tile fills whole m16 tiles");
  static constexpr int MT = kFull ? R / 16 : 1;        // m16 tiles a warp
  static constexpr int NH = kFull ? 2 : 1;   // rows a lane holds: r, r + 8
  static constexpr bool kSwizzle = SWZ;
  static constexpr int kQBytes = kFull ? R * DP * 2 : 0;  // staged q tile
  static constexpr int kGroups = kWarps;
  static constexpr int kDV = DV;
  uint32_t qa[kFull ? 1 : KS][2];  // Q = 1: q fragment, cols k, k + 8
  float o[MT][DV / 8][2 * NH];     // the P V fragments of this lane's rows
  int dv0 = 0;                     // the first of the DV output columns
  float m2[MT][NH], ls[MT][NH], scale_log2;
  int ext[MT][NH];                 // the extent of each row's query
  uint32_t qs;                     // the staged q tile (shared address)
  int lane, warp;

  __device__ __forceinline__ void init(const Params& P, const QTile& qt,
                                       int tid, unsigned char* extra) {
    lane = tid & 31;
    warp = tid >> 5;
    scale_log2 = P.scale * kLog2e;
    const int r = lane >> 2, c0 = 2 * (lane & 3);
    if constexpr (!kFull) {
      const __nv_bfloat16* qh =
          reinterpret_cast<const __nv_bfloat16*>(P.q) + (qt.head0 + r) * P.D;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = ks * 16 + h * 8 + c0;
          qa[ks][h] = r < qt.g && d < P.D
                          ? *reinterpret_cast<const uint32_t*>(qh + d)
                          : 0u;
        }
      ext[0][0] = qt.ctx[0];
    } else {
      // row = query * G + head, chunk c of a row at chunk_at(c, row) as in
      // the K tile (rows of absent queries and heads are zero)
      __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(extra);
      const uint32_t* q32 = reinterpret_cast<const uint32_t*>(P.q);
      for (int e = tid; e < R * (DP / 8); e += kThreads) {
        const int row = e / (DP / 8), c = e - row * (DP / 8);
        const int j = row / G, i = row - j * G;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (j < qt.nq && i < qt.g && c * 8 < P.D) {
          const long long at =
              ((qt.head0 + (long long)j * P.H + i) * P.D + c * 8) / 2;
          v = make_uint4(q32[at], q32[at + 1], q32[at + 2], q32[at + 3]);
        }
        *reinterpret_cast<uint4*>(sq + row * DP +
                                  chunk_at<DP, true>(c, row) * 8) = v;
      }
      qs = (uint32_t)__cvta_generic_to_shared(sq);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const int j = min((mt * 16 + h * 8 + r) / G, qt.nq - 1);
          ext[mt][h] = qt.ctx[j * qt.cstep];
        }
    }
    reset();
  }

  // a fresh online-softmax state (a new chunk of the fold kernel)
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2 * NH; ++e) o[mt][n][e] = 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        m2[mt][h] = -INFINITY;
        ls[mt][h] = 0.f;
      }
    }
  }

  // goff: the tile's first token in 16-token groups of the chunk; warp w
  // takes the chunk's groups w, w + 4, ... (0 in the cluster kernel, whose
  // tiles start each warp at its own group)
  __device__ __forceinline__ void tile(const Params& P,
                                       const __nv_bfloat16* tk,
                                       const __nv_bfloat16* tv, int rows,
                                       int p0, int goff = 0) {
    const uint32_t kb = (uint32_t)__cvta_generic_to_shared(tk);
    const uint32_t vb = (uint32_t)__cvta_generic_to_shared(tv);
    const int c0 = 2 * (lane & 3);
    const int mi = lane >> 3, ri = lane & 7;          // ldmatrix: matrix, row
    for (int t0 = ((warp - goff) & (kWarps - 1)) * 16; t0 < rows;
         t0 += kWarps * 16) {
      // S = Q K^T for tokens t0 .. t0 + 15 (two n8 tiles)
      float s[MT][2][2 * NH];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2 * NH; ++e) s[mt][n][e] = 0.f;
      const int tk_row = t0 + (mi >> 1) * 8 + ri;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        const int ch = 2 * ks + (mi & 1);
        ldsm_x4(kb + (tk_row * RS + chunk_at<DP, SWZ>(ch, tk_row) * 8) * 2,
                b);
        if constexpr (kFull) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            const int qr = mt * 16 + (mi & 1) * 8 + ri;
            ldsm_x4(qs + (qr * DP +
                          chunk_at<DP, true>(2 * ks + (mi >> 1), qr) * 8) * 2,
                    a);
            mma_bf16(s[mt][0], a, b[0], b[1]);
            mma_bf16(s[mt][1], a, b[2], b[3]);
          }
        } else {
          mma_bf16(s[0][0], qa[ks][0], qa[ks][1], b[0], b[1]);
          mma_bf16(s[0][1], qa[ks][0], qa[ks][1], b[2], b[3]);
        }
      }
      // online softmax of each row this thread holds over its 4 tokens
      // (at Q = 1 rows 8..15 are padding and are left at zero); P's A
      // fragment: ph/pl[mt][h + NH * n] for row half h, token half n
      uint32_t ph[MT][2 * NH], pl[MT][2 * NH];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          float x[2][2], mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = t0 + n * 8 + c0 + e;
              const bool valid =
                  t < rows && p0 + t * P.tok_stride < ext[mt][h];
              x[n][e] = valid ? s[mt][n][2 * h + e] * scale_log2 : -INFINITY;
              mx = fmaxf(mx, x[n][e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m2[mt][h], mx);
          const float mu = m_new == -INFINITY ? 0.f : m_new;
          const float corr = ex2(m2[mt][h] - mu);
          m2[mt][h] = m_new;
          float psum = 0.f;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              x[n][e] = ex2(x[n][e] - mu);
              psum += x[n][e];
            }
          ls[mt][h] = fmaf(ls[mt][h], corr, psum);
#pragma unroll
          for (int n = 0; n < DV / 8; ++n) {
            o[mt][n][2 * h] *= corr;
            o[mt][n][2 * h + 1] *= corr;
          }
          // P as hi + lo bf16 parts, so P V keeps P's float32 precision
          // (V is bf16 already, and the products accumulate in f32)
          split_bf16(x[0][0], x[0][1], ph[mt][h], pl[mt][h]);
          split_bf16(x[1][0], x[1][1], ph[mt][h + NH], pl[mt][h + NH]);
        }
      // O += P V: V rows t0 .. t0 + 15 read transposed, two n8 tiles each
      const int tv_row = t0 + (mi & 1) * 8 + ri;
#pragma unroll
      for (int nn = 0; nn < DV / 16; ++nn) {
        uint32_t b[4];
        const int ch = dv0 / 8 + 2 * nn + (mi >> 1);
        ldsm_x4_trans(
            vb + (tv_row * RS + chunk_at<DP, SWZ>(ch, tv_row) * 8) * 2, b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (kFull) {
            mma_bf16(o[mt][2 * nn], ph[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * nn], pl[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * nn + 1], ph[mt], b[2], b[3]);
            mma_bf16(o[mt][2 * nn + 1], pl[mt], b[2], b[3]);
          } else {
            mma_bf16(o[0][2 * nn], ph[0][0], ph[0][1], b[0], b[1]);
            mma_bf16(o[0][2 * nn], pl[0][0], pl[0][1], b[0], b[1]);
            mma_bf16(o[0][2 * nn + 1], ph[0][0], ph[0][1], b[2], b[3]);
            mma_bf16(o[0][2 * nn + 1], pl[0][0], pl[0][1], b[2], b[3]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* gm, float* gl, float* go) {
    const int r = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int row = mt * 16 + h * 8 + r;
        float l = ls[mt][h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (row < R) {
          if ((lane & 3) == 0) {
            gm[warp * R + row] =
                m2[mt][h] == -INFINITY ? kNegInf : m2[mt][h] / kLog2e;
            gl[warp * R + row] = l;
          }
#pragma unroll
          for (int n = 0; n < DV / 8; ++n)
            *reinterpret_cast<float2*>(go + (warp * R + row) * kOStride<DV> +
                                       n * 8 + c0) =
                make_float2(o[mt][n][2 * h], o[mt][n][2 * h + 1]);
        }
      }
  }
};

template <typename T, int DP, int G, int QT, typename Math>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const __grid_constant__ Params P) {
  constexpr int TT = Geo<T, DP>::TT, NG = Math::kGroups, R = QT * G;
  constexpr int OS = kOStride<DP>;
  constexpr bool SWZ = Math::kSwizzle;
  constexpr int kRing = 2 * kStages * TT * DP * (int)sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x % P.n_split, kvh = blockIdx.x / P.n_split;
  const int qt0 = blockIdx.y * QT, b = blockIdx.z;
  const int g = P.H / P.KV;
  const int tid = threadIdx.x;
  mark(P, 0);

  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);                  // (stages, TT, DP)
  T* sV = sK + kStages * TT * DP;
  // after the loop the ring (and the q tile) is reused for the merge:
  float* gm = reinterpret_cast<float*>(smem);  // (NG, R); then the weights
  float* gl = gm + NG * R;                             // (NG, R)
  float* go = gl + NG * R;                             // (NG, R, OS)
  float* cm = go + NG * R * OS;                        // (R,) CTA partial
  float* cl = cm + R;
  float* co = cl + R;                                  // (R, DP)
  float* am = co + R * DP;                 // (n_split, R): every rank's m
  float* al = am + kMaxSplit * R;          // and l, for the cluster merge
  float* aw = al + kMaxSplit * R;          // (n_split, R): rank weights
  float* aM = aw + kMaxSplit * R;          // (R,): the merged m
  float* aL = aM + R;                      // (R,): and l

  // zero the row padding (copies never touch it) and, where the tensor
  // cores read whole 16-token chunks, the rows a short block leaves unset
  if (P.D != DP || (SWZ && P.bs % 16)) {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n = kRing / 16;
    for (int e = tid; e < n; e += kThreads) z[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  QTile qt;
  qt.nq = min(QT, P.Q - qt0);
  qt.g = g;
  qt.cstep = P.ctx_per_query;
  qt.ctx = P.ctx + (P.ctx_per_query ? (long long)b * P.Q + qt0 : (long long)b);
  qt.head0 = ((long long)b * P.Q + qt0) * P.H + (long long)kvh * g;
  // a tile is loaded when it reaches into the extent of any of the queries
  int extent = qt.ctx[0];
  for (int j = 1; j < qt.nq; ++j) extent = max(extent, qt.ctx[j * qt.cstep]);
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

  // a query tile's CTA that loads no tile has nothing to merge (below)
  const bool idle = QT > 1 && k_cur < 0;
  Math math;
  if (!idle) math.init(P, qt, tid, smem + kRing);

  int stage = 0;
  bool first = true;
  while (k_cur >= 0) {
    cp_async_wait<1>();
    __syncthreads();
    if (first) mark(P, 1);
    first = false;
    const int j = j0 + k_cur / tpb, t0 = (k_cur % tpb) * tt;
    const int p0 = j * P.block_tokens + P.tok_offset + t0 * P.tok_stride;
    math.tile(P, sK + stage * TT * DP, sV + stage * TT * DP,
              min(tt, P.bs - t0), p0);
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
  if (P.stamps != nullptr) {
    if (first) mark(P, 1);
    mark(P, 2);
  }

  // merge the partials of this CTA (fixed order), over the rows of the
  // tile's queries.  A row no token reached comes out with m == -1e30, l ==
  // 0 and o == 0, so the cluster merge reads no o of such a row; an idle
  // CTA's rows are all such rows
  if (idle) {
    for (int e = tid; e < R; e += kThreads) {
      cm[e] = kNegInf;
      cl[e] = 0.f;
    }
  } else {
    math.store(gm, gl, go);
    __syncthreads();
  }
  // each row's max over the groups, their weights (in place of their m)
  // and l, once a row; then o, d by d, in group order
  const int live = idle ? 0 : qt.nq * G;
  for (int i = tid; i < live; i += kThreads) {
    float M = kNegInf;
#pragma unroll
    for (int q = 0; q < NG; ++q) M = fmaxf(M, gm[q * R + i]);
    float L = 0.f;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const float w = exp2f((gm[q * R + i] - M) * kLog2e);
      gm[q * R + i] = w;
      L = fmaf(gl[q * R + i], w, L);
    }
    cm[i] = M;
    cl[i] = L;
  }
  __syncthreads();
  for (int e = tid; e < live * DP; e += kThreads) {
    const int i = e / DP, d = e - i * DP;
    float O = 0.f;
#pragma unroll
    for (int q = 0; q < NG; ++q)
      O = fmaf(go[(q * R + i) * OS + d], gm[q * R + i], O);
    co[e] = O;
  }

  // merge the CTAs of the cluster: every rank's m and l, each row's max
  // and the ranks' weights and l, once a row; then each rank takes a slice
  // of the nq * g * D outputs and reads every rank's o for it, in rank
  // order (a row no token of a rank reached has nothing to read there)
  if (P.stamps != nullptr) {
    __syncthreads();
    mark(P, 3);
  }
  cluster.sync();
  const int n = P.n_split;
  for (int e = tid; e < n * R; e += kThreads) {
    am[e] = *cluster.map_shared_rank(cm + e % R, e / R);
    al[e] = *cluster.map_shared_rank(cl + e % R, e / R);
  }
  __syncthreads();
  for (int i = tid; i < R; i += kThreads) {
    float M = kNegInf;
    for (int r = 0; r < n; ++r) M = fmaxf(M, am[r * R + i]);
    float L = 0.f;
    for (int r = 0; r < n; ++r) {
      const float w = exp2f((am[r * R + i] - M) * kLog2e);
      aw[r * R + i] = w;
      L = fmaf(al[r * R + i], w, L);
    }
    aM[i] = M;
    aL[i] = L;
  }
  __syncthreads();
  const int per_q = g * P.D;
  for (int e = (int)cluster.block_rank() * kThreads + tid; e < qt.nq * per_q;
       e += n * kThreads) {
    const int jq = e / per_q, hd = e - jq * per_q;
    const int i = hd / P.D, d = hd - i * P.D;
    const int row = jq * G + i;
    float part[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      part[r] = r < n && am[r * R + row] != kNegInf
                    ? *cluster.map_shared_rank(co + row * DP + d, r)
                    : 0.f;
    float O = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r >= n) break;
      O = fmaf(part[r], aw[r * R + row], O);
    }
    const long long head = qt.head0 + (long long)jq * P.H + i;
    P.o[head * P.D + d] = O;
    if (d == 0) {
      P.m[head] = aM[row];
      P.l[head] = aL[row];
    }
  }
  cluster.sync();   // keep every rank's shared memory alive until read
  if (P.stamps != nullptr) {
    mark(P, 4);
    mark(P, 5);
    stamp_at(P, 8, cluster.block_rank() == 0);
  }
}

// ------------------------------------------------------------------ fold
// The design at D = 64 and D = 256 (whisper-medium's 16 / 16 heads,
// paligemma-3b's 8 / 1): see the header's "Fold" paragraph.

constexpr int kMaxFold = 64;   // chunks one CTA folds from the workspace

template <typename T, int DP>
struct FoldGeo {
  static constexpr int RS = DP + 16 / (int)sizeof(T);  // padded row stride
  static constexpr int TRW = 16384 / (DP * (int)sizeof(T));
  static constexpr int TR = TRW < 16 ? 16 : (TRW > 64 ? 64 : TRW);  // rows
  // rows a stage: TR, or with column halves (the tensor cores at D = 256)
  // a whole 64-token block, so the four warps compute together (the rows
  // a warp takes, and its bits, do not depend on the stage's rows)
  template <int DH>
  __host__ __device__ static constexpr int rows() {
    return DH > 1 ? 64 : TR;
  }
};

__host__ __device__ constexpr size_t round128(size_t b) {
  return (b + 127) / 128 * 128;
}

// Bytes of the fold kernel's dynamic shared memory: region A (the ring of
// `nst` stages; after a chunk's tiles the CTA merge's scratch; in the
// folding CTA every chunk's m and l, the fold's weights and each row's
// list of the chunks it folds), the staged q tile, and, with every chunk
// in one CTA, the running fold (m, l, two weights a row, o).
template <typename T, int DP, int DV, int R, int NG>
__host__ __device__ constexpr size_t fold_region_a(int nst, bool serial) {
  using FG = FoldGeo<T, DP>;
  const size_t ring = (size_t)nst * 2 * FG::template rows<DP / DV>() *
                      FG::RS * sizeof(T);
  const size_t scratch =
      4 * ((size_t)NG * R * (kOStride<DV> + 2) + (size_t)R * (DV + 2));
  // the folding CTA's arrays and the partials of 16 chunks of 8 rows,
  // or of one row at 64 chunks (not with every chunk in one CTA)
  const size_t staged = 4 * (size_t)16 * (R < 8 ? R : 8) * DV;
  const size_t weights =
      serial ? 0
             : round128(4 * (8 * (size_t)kMaxFold * R + R + 4)) +
                   (staged > 4 * (size_t)kMaxFold * DV
                        ? staged
                        : 4 * (size_t)kMaxFold * DV);
  const size_t a = ring > scratch ? ring : scratch;
  return round128(a > weights ? a : weights);
}
template <typename T, int DP, int DV, int R, int NG, int QB>
__host__ __device__ constexpr size_t fold_smem(int nst, bool serial) {
  return fold_region_a<T, DP, DV, R, NG>(nst, serial) + round128(QB) +
         (serial ? 4 * (size_t)R * (DV + 4) : 0);
}

// One tile (`rows` tokens from t0 of pool slot `slot`) into a stage: a
// token's KV head is D contiguous values, copied by 16-byte cp.async into
// a row of RS values (the 16-byte pad puts the 8 rows an ldmatrix reads
// in distinct banks, without a swizzle), V only in the columns [v0, v0 +
// vn) the CTA's P V reads; rows that do not start on 16 bytes take plain
// loads.  (One cp.async.bulk a row, tried first, took ~10,000 cycles to
// land 32 KB, three times these copies: PERF.md, PR 31.)
template <typename T, int DP>
__device__ __forceinline__ void stage_fold(const Params& P, T* sk, T* sv,
                                           int slot, int kvh, int t0,
                                           int rows, int v0, int vn,
                                           int tid) {
  constexpr int RS = FoldGeo<T, DP>::RS, VEC = 16 / (int)sizeof(T);
  const long long tok = (long long)P.KV * P.D;   // elements between tokens
  const long long base =
      ((long long)slot * P.bs + t0) * tok + (long long)kvh * P.D;
  const T* ks = reinterpret_cast<const T*>(P.kp) + base;
  const T* vs = reinterpret_cast<const T*>(P.vp) + base + v0;
  if (P.vec16) {
    const int cpr = P.D / VEC, vpr = vn / VEC;
    for (int e = tid; e < rows * cpr; e += kThreads) {
      const int r = e / cpr, c = e - r * cpr;
      cp_async16(sk + r * RS + c * VEC, ks + r * tok + c * VEC);
    }
    for (int e = tid; e < rows * vpr; e += kThreads) {
      const int r = e / vpr, c = e - r * vpr;
      cp_async16(sv + r * RS + v0 + c * VEC, vs + r * tok + c * VEC);
    }
  } else {
    for (int e = tid; e < rows * P.D; e += kThreads) {
      const int r = e / P.D, d = e - r * P.D;
      sk[r * RS + d] = ks[r * tok + d];
      if (d >= v0 && d < v0 + vn) sv[r * RS + d] = vs[r * tok + d - v0];
    }
  }
}

// o = o_c w + o a, one rounding each, as the serial fold computes it
__device__ __forceinline__ float fold_o(float o, float oc, float a,
                                        float w) {
  return fmaf(oc, w, __fmul_rn(o, a));
}

// The fold kernel.  With cta_split == n_split, one CTA a (row, query
// tile, KV head, chunk, column half): each chunk (a block) computed from a
// fresh state (its tiles through a cp.async ring, the warps' or token
// groups' partials merged as in the cluster kernel) into a partial in the
// workspace, then folded in chunk order by the CTA that arrives last.  On
// the tensor cores at D = 256 each chunk takes two CTAs, each computing
// the scores whole and P V on half of the columns (Math::kDV), which gives
// a column the bits that a CTA computing every column gives it.  With
// cta_split == 1 one CTA a (row, query tile, KV head) takes every chunk in
// order and every column, folding as it goes by the same arithmetic, so
// the result does not depend on which of the two ran.  Both skip an empty
// chunk (a hole, or past every extent of the tile's queries; folding it
// would change nothing).
template <typename T, int DP, int G, int QT, typename Math>
__global__ void __launch_bounds__(kThreads)
    paged_fold_kernel(const __grid_constant__ Params P) {
  using FG = FoldGeo<T, DP>;
  constexpr int NG = Math::kGroups, R = QT * G, DV = Math::kDV;
  constexpr int DH = DP / DV, OS = kOStride<DV>;
  constexpr int TR = FG::template rows<DH>(), STAGE = TR * FG::RS;
  const int tid = threadIdx.x;
  mark(P, 0);
  const int cs = P.cta_split;
  const bool serial = cs == 1;
  const int dh = blockIdx.x % DH, xq = blockIdx.x / DH;
  const int kvh = xq / cs;
  const int c_lo = serial ? 0 : xq - kvh * cs;
  const int c_hi = serial ? P.n_split : c_lo + 1;
  const int qt0 = blockIdx.y * QT, b = blockIdx.z;
  const int g = P.H / P.KV;
  const int dv0 = dh * DV, dw = min(DV, P.D - dv0);  // this CTA's columns
  const int bs = P.bs, tt = min(TR, bs);
  const int tpb = (bs + tt - 1) / tt;
  const int nst = (serial || tpb > 1) ? 2 : 1;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int folds;
  T* sK = reinterpret_cast<T*>(smem);          // stage s: K, then V
  float* gm = reinterpret_cast<float*>(smem);  // (NG, R), then the weights
  float* gl = gm + NG * R;                     // (NG, R)
  float* go = gl + NG * R;                     // (NG, R, OS)
  float* cm = go + NG * R * OS;                // (R,): the chunk's partial
  float* cl = cm + R;
  float* co = cl + R;                          // (R, DV)
  unsigned char* qbuf = smem + fold_region_a<T, DP, DV, R, NG>(nst, serial);
  float* FM = reinterpret_cast<float*>(qbuf + round128(Math::kQBytes));
  float* FL = FM + R;                          // the running fold (serial)
  float* FA = FL + R;
  float* FW = FA + R;
  float* FO = FW + R;                          // (R, DV)

  QTile qt;
  qt.nq = min(QT, P.Q - qt0);
  qt.g = g;
  qt.cstep = P.ctx_per_query;
  qt.ctx = P.ctx + (P.ctx_per_query ? (long long)b * P.Q + qt0 : (long long)b);
  qt.head0 = ((long long)b * P.Q + qt0) * P.H + (long long)kvh * g;
  int extent = qt.ctx[0];
  for (int j = 1; j < qt.nq; ++j) extent = max(extent, qt.ctx[j * qt.cstep]);
  const int* row_slots = P.slots + (long long)b * P.nblk;
  const int live = qt.nq * G;

  // padding columns and the rows past a short tile are read by the math:
  // zero them once (and again after a chunk's merge wrote over the ring)
  const bool zero = P.D != DP || (bs % 16);
  const int ring_vec = (int)(nst * 2 * STAGE * sizeof(T) / 16);
  if (zero)
    for (int e = tid; e < ring_vec; e += kThreads)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  if (serial)
    for (int e = tid; e < R * (DV + 4); e += kThreads)
      FM[e] = e < R ? kNegInf : 0.f;
  __syncthreads();

  // with a CTA a chunk, its partial goes to the workspace: o (n, R, DV)
  // of each (row, query tile, KV head, column half), then every one's m
  // and l (n, MLS: m of R rows, then l); the last CTA of the (row, query
  // tile, KV head, column half) to arrive folds them in chunk order
  const int n = P.n_split;
  constexpr int MLS = (2 * R + 3) / 4 * 4;            // 16-byte multiple
  const long long po = (long long)R * DV;             // floats of a partial o
  const long long groups = (long long)P.B * gridDim.y * P.KV * DH;
  const long long grp =
      (((long long)b * gridDim.y + blockIdx.y) * P.KV + kvh) * DH + dh;
  float* wo = P.ws + grp * n * po;
  float* wml = P.ws + groups * n * po + grp * n * MLS;

  Math math;
  bool have_q = false, first = true;
  int tiles = 0;
  for (int c = c_lo; c < c_hi; ++c) {
    const int slot = row_slots[c];
    const int pos0 = c * P.block_tokens + P.tok_offset;
    // tile k is live when it starts inside the extent (with a
    // non-negative stride the later tiles lie further out)
    auto next = [&](int k) {
      return k < tpb && slot >= 0 &&
                     (P.tok_stride < 0 ||
                      pos0 + k * tt * P.tok_stride < extent)
                 ? k
                 : -1;
    };
    int kc = next(0);
    if (kc < 0) {
      if (!serial)                  // the one chunk: an empty partial
        for (int i = tid; i < live; i += kThreads) {
          cm[i] = kNegInf;
          cl[i] = 0.f;
        }
      continue;
    }
    auto issue = [&](int k, int s) {
      stage_fold<T, DP>(P, sK + s * 2 * STAGE, sK + s * 2 * STAGE + STAGE,
                        slot, kvh, k * tt, min(tt, bs - k * tt), dv0, dw,
                        tid);
    };
    // the copies first, then q (its loads overlap them)
    int st = 0, kn = -1;
    issue(kc, 0);
    cp_async_commit();
    if (nst == 2) {
      kn = next(kc + 1);
      if (kn >= 0) issue(kn, 1);
      cp_async_commit();
    }
    if (!have_q) {
      math.init(P, qt, tid, qbuf);
      math.dv0 = dv0;
      have_q = true;
    } else {
      math.reset();
    }
    while (kc >= 0) {
      if (nst == 2)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if (first) mark(P, 1);
      first = false;
      math.tile(P, sK + st * 2 * STAGE, sK + st * 2 * STAGE + STAGE,
                min(tt, bs - kc * tt), pos0 + kc * tt * P.tok_stride,
                kc * tt / 16);
      ++tiles;
      __syncthreads();   // every thread is done with this stage
      if (nst == 2) {
        const int kw = kn >= 0 ? next(kn + 1) : -1;
        if (kw >= 0) issue(kw, st);
        cp_async_commit();
        kc = kn;
        kn = kw;
        st ^= 1;
      } else {
        kc = next(kc + 1);
        if (kc >= 0) issue(kc, 0);
        cp_async_commit();
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    mark(P, 2);

    // the chunk's partial: the groups merged as in the cluster kernel
    math.store(gm, gl, go);
    __syncthreads();
    for (int i = tid; i < live; i += kThreads) {
      float M = kNegInf;
#pragma unroll
      for (int q = 0; q < NG; ++q) M = fmaxf(M, gm[q * R + i]);
      float L = 0.f;
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float w = exp2f((gm[q * R + i] - M) * kLog2e);
        gm[q * R + i] = w;
        L = fmaf(gl[q * R + i], w, L);
      }
      cm[i] = M;
      cl[i] = L;
    }
    __syncthreads();
    for (int e = tid; e < live * DV; e += kThreads) {
      const int i = e / DV, d = e - i * DV;
      float O = 0.f;
#pragma unroll
      for (int q = 0; q < NG; ++q)
        O = fmaf(go[(q * R + i) * OS + d], gm[q * R + i], O);
      if (serial)
        co[e] = O;
      else if (cm[i] != kNegInf)   // the partial, straight to the workspace
        wo[c * po + e] = O;
    }
    __syncthreads();
    if (serial) {
      // fold the chunk into the running state: the scalars once a row,
      // then o element by element
      for (int i = tid; i < live; i += kThreads) {
        const float m = cm[i];
        if (m == kNegInf) continue;
        const float Mn = fmaxf(FM[i], m);
        const float a = exp2f((FM[i] - Mn) * kLog2e);
        const float w = exp2f((m - Mn) * kLog2e);
        FL[i] = fmaf(cl[i], w, __fmul_rn(FL[i], a));
        FM[i] = Mn;
        FA[i] = a;
        FW[i] = w;
      }
      __syncthreads();
      for (int e = tid; e < live * DV; e += kThreads) {
        const int i = e / DV;
        if (cm[i] != kNegInf) FO[e] = fold_o(FO[e], co[e], FA[i], FW[i]);
      }
      __syncthreads();
      if (zero)
        for (int e = tid; e < ring_vec; e += kThreads)
          reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
      __syncthreads();
    }
  }
  if (P.stamps != nullptr) {
    __syncthreads();
    if (first) {
      mark(P, 1);
      mark(P, 2);
    }
    mark(P, 3);
  }
  const int per_q = g * dw;
  if (serial) {
    for (int e = tid; e < qt.nq * per_q; e += kThreads) {
      const int jq = e / per_q, hd = e - jq * per_q;
      const int h = hd / dw, d = hd - h * dw;
      const int i = jq * G + h;
      const long long head = qt.head0 + (long long)jq * P.H + h;
      P.o[head * P.D + dv0 + d] = FO[i * DV + d];
      if (d == 0 && dh == 0) {
        P.m[head] = FM[i];
        P.l[head] = FL[i];
      }
    }
    if (P.stamps != nullptr) {
      mark(P, 4);
      mark(P, 5);
      stamp_at(P, 8, 1);
      stamp_at(P, 9, tiles);
    }
    return;
  }

  // one chunk a CTA: its m and l after its o (written by the merge above)
  __syncthreads();
  for (int i = tid; i < live; i += kThreads) {
    wml[c_lo * MLS + i] = cm[i];
    wml[c_lo * MLS + R + i] = cl[i];
  }
  __syncthreads();
  if (P.stamps != nullptr) mark(P, 4);
  if (tid == 0) {
    __threadfence();   // the CTA's partial (ordered by the barrier) first
    folds = atomicAdd(P.counters + grp, 1) == n - 1;
    __threadfence();
  }
  __syncthreads();
  if (!folds) {
    if (P.stamps != nullptr) {
      mark(P, 5);
      stamp_at(P, 8, 0);
      stamp_at(P, 9, tiles);
    }
    return;
  }
  if (P.stamps != nullptr) stamp_at(P, 10, (unsigned long long)clock64());
  // region A (the ring and the merge's scratch are done with): every
  // chunk's m and l; for each row the running max before each chunk and
  // the chunk's two weights; then the staged partials
  float* aml = gm;                     // (n, MLS): every chunk's m and l
  float* mp = aml + n * MLS;           // (R, n): the running max before
  float* wa = mp + n * R;              // chunk c, then its two weights
  float* wb = wa + n * R;
  float* so = reinterpret_cast<float*>(
      smem + round128((size_t)((unsigned char*)(wb + n * R) - smem)));
  const bool vec = dw % 4 == 0;
  const int q4 = dw / 4;
  const size_t a_bytes = fold_region_a<T, DP, DV, R, NG>(nst, false);
  const int room = (int)((a_bytes - ((unsigned char*)so - smem)) /
                         (sizeof(float) * (size_t)n * dw));
  const int rows = room < 1 ? 1 : room;      // rows a pass
  // every chunk's m and l, and the partials of every chunk of the first
  // pass's rows (an empty chunk's, never written, are never read), in
  // flight together
  auto stage = [&](int r0, int r1) {
    for (int e = tid; e < (r1 - r0) * n * q4; e += kThreads) {
      const int ri = e / (n * q4), k = e - ri * n * q4;
      const int c = k / q4, d4 = k - c * q4;
      cp_async16(so + ((size_t)ri * n + c) * dw + d4 * 4,
                 wo + c * po + (long long)(r0 + ri) * DV + d4 * 4);
    }
    cp_async_commit();
  };
  for (int e = tid; e < n * MLS / 4; e += kThreads)
    cp_async16(aml + 4 * e, wml + 4 * e);
  cp_async_commit();
  if (vec) stage(0, min(live, rows));
  cp_async_wait<1>();
  __syncthreads();
  if (P.stamps != nullptr) stamp_at(P, 11, (unsigned long long)clock64());
  // a row's running max in chunk order (an empty chunk leaves it as it
  // is), then each live chunk's two weights, all at once, and l in chunk
  // order, as the serial fold computes them (a warp a row, with a prefix
  // max over the lanes, was slower at 16 rows: PERF.md, PR 31)
  for (int i = tid; i < live; i += kThreads) {
    float M = kNegInf;
    for (int c = 0; c < n; ++c) {
      const float m = aml[c * MLS + i];
      mp[i * n + c] = M;
      if (m != kNegInf) M = fmaxf(M, m);
    }
  }
  __syncthreads();
  for (int e = tid; e < live * n; e += kThreads) {
    const int i = e / n, c = e - i * n;
    const float m = aml[c * MLS + i];
    if (m == kNegInf) continue;
    const float Mn = fmaxf(mp[e], m);
    wa[e] = exp2f((mp[e] - Mn) * kLog2e);
    wb[e] = exp2f((m - Mn) * kLog2e);
  }
  __syncthreads();
  for (int i = tid; i < live; i += kThreads) {
    float L = 0.f, M = kNegInf;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float m = aml[c * MLS + i];
      if (m == kNegInf) continue;
      L = fmaf(aml[c * MLS + R + i], wb[i * n + c],
               __fmul_rn(L, wa[i * n + c]));
      M = fmaxf(M, m);
    }
    const int jq = i / G, h = i - jq * G;
    if (h < g && dh == 0) {
      const long long head = qt.head0 + (long long)jq * P.H + h;
      P.m[head] = M;
      P.l[head] = L;
    }
  }
  if (P.stamps != nullptr) stamp_at(P, 12, (unsigned long long)clock64());
  // o: each output element folded in chunk order from the staged
  // partials, `rows` rows a pass
  if (vec) {
    const float4* so4 = reinterpret_cast<const float4*>(so);
    for (int r0 = 0; r0 < live; r0 += rows) {
      const int r1 = min(live, r0 + rows);
      if (r0 > 0) {
        __syncthreads();
        stage(r0, r1);
      }
      cp_async_wait<0>();
      __syncthreads();
      for (int e = tid; e < (r1 - r0) * q4; e += kThreads) {
        const int ri = e / q4, d4 = e - ri * q4, i = r0 + ri;
        const int jq = i / G, h = i - jq * G;
        if (h >= g) continue;
        const float4* src = so4 + (size_t)ri * n * q4 + d4;
        float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = 0; c < n; ++c) {
          if (aml[c * MLS + i] == kNegInf) continue;
          const float4 v = src[c * q4];
          const float a = wa[i * n + c], w = wb[i * n + c];
          O.x = fold_o(O.x, v.x, a, w);
          O.y = fold_o(O.y, v.y, a, w);
          O.z = fold_o(O.z, v.z, a, w);
          O.w = fold_o(O.w, v.w, a, w);
        }
        reinterpret_cast<float4*>(
            P.o + (qt.head0 + (long long)jq * P.H + h) * P.D + dv0)[d4] = O;
      }
    }
  } else {
    cp_async_wait<0>();
    for (int e = tid; e < qt.nq * per_q; e += kThreads) {
      const int jq = e / per_q, hd = e - jq * per_q;
      const int h = hd / dw, d = hd - h * dw;
      const int i = jq * G + h;
      const float* src = wo + (long long)i * DV + d;
      float O = 0.f;
      for (int c = 0; c < n; ++c)
        if (aml[c * MLS + i] != kNegInf)
          O = fold_o(O, __ldcg(src + c * po), wa[i * n + c], wb[i * n + c]);
      P.o[(qt.head0 + (long long)jq * P.H + h) * P.D + dv0 + d] = O;
    }
  }
  if (tid == 0) P.counters[grp] = 0;   // ready for the next launch
  if (P.stamps != nullptr) {
    mark(P, 5);
    stamp_at(P, 8, 1);
    stamp_at(P, 9, tiles);
  }
}

// the fold kernel with Math M, CTAs as cta_split says (SERIAL: one a (row,
// query tile, KV head)); its shared-memory attribute covers both modes
template <typename T, int DP, int G, int QT, typename M, bool SERIAL>
int launch_fold_as(const Params& P, cudaStream_t stream) {
  constexpr int R = QT * G, DV = M::kDV, NG = M::kGroups;
  constexpr size_t ser = fold_smem<T, DP, DV, R, NG, M::kQBytes>(2, true);
  constexpr size_t spl = fold_smem<T, DP, DV, R, NG, M::kQBytes>(2, false);
  constexpr size_t most = ser > spl ? ser : spl;   // either mode's
  static_assert(most <= 232448, "more shared memory than a CTA can have");
  constexpr int TR = FoldGeo<T, DP>::template rows<DP / DV>();
  const int tt = P.bs < TR ? P.bs : TR;
  const int nst = SERIAL || (P.bs + tt - 1) / tt > 1 ? 2 : 1;
  auto kern = paged_fold_kernel<T, DP, G, QT, M>;
  static bool sized = false;   // the attribute is set once per kernel
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(P.KV * P.cta_split * (DP / DV), (P.Q + QT - 1) / QT, P.B);
  kern<<<grid, kThreads, fold_smem<T, DP, DV, R, NG, M::kQBytes>(nst, SERIAL),
         stream>>>(P);
  return (int)cudaGetLastError();
}

// Split: the fold kernel's Math with a CTA a chunk (column halves on the
// tensor cores at D = 256); Serial: every chunk in one CTA, every column
template <typename T, int DP, int G, int QT, typename Split, typename Serial>
int launch_fold(const Params& P, cudaStream_t stream) {
  if (P.cta_split == 1)
    return launch_fold_as<T, DP, G, QT, Serial, true>(P, stream);
  return launch_fold_as<T, DP, G, QT, Split, false>(P, stream);
}

template <typename T, int DP, int G, int QT, typename Math>
int launch_kernel(const Params& P, cudaStream_t stream) {
  constexpr int R = QT * G;
  constexpr size_t ring =
      2 * (size_t)kStages * Geo<T, DP>::TT * DP * sizeof(T);
  constexpr size_t parts =
      sizeof(float) * (size_t)Math::kGroups * R * (kOStride<DP> + 2);
  constexpr size_t cta =
      sizeof(float) * ((size_t)R * (DP + 4) + 3 * kMaxSplit * R);
  constexpr size_t smem = ring + Math::kQBytes > parts + cta
                              ? ring + Math::kQBytes
                              : parts + cta;
  static_assert(smem <= 232448, "more shared memory than a CTA can have");
  auto kern = paged_attn_kernel<T, DP, G, QT, Math>;
  static bool sized = false;   // the attribute is set once per kernel
  cudaError_t e;
  if (!sized) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.KV * P.n_split, (P.Q + QT - 1) / QT, P.B);
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

// qt: queries a CTA, 1 or the query tile of `query_tile` in ops.py: on
// the tensor cores 32 (query, head) rows at D <= 128 and 16 above, on the
// CUDA cores 8, with g padded to G
// the fold kernel (cta_split > 0) at DP = 64 and 256, else the cluster one
template <typename T, int DP, int G, int QT, typename Cluster, typename Split,
          typename Serial>
int launch_one(const Params& P, cudaStream_t s) {
  if constexpr (DP == 64 || DP == 256) {
    if (P.cta_split > 0)
      return launch_fold<T, DP, G, QT, Split, Serial>(P, s);
  }
  if (P.cta_split > 0) return (int)cudaErrorInvalidValue;
  return launch_kernel<T, DP, G, QT, Cluster>(P, s);
}

template <typename T, int DP, int G>
int launch_math(const Params& P, int qt, cudaStream_t s) {
  constexpr int RS = FoldGeo<T, DP>::RS;   // the fold kernel's staged rows
  if constexpr (sizeof(T) == 2 && DP >= 16) {
    // the tensor cores when q is bf16 too and every row is whole 16-value
    // chunks (q rounded to bf16 would not hold float32 q's precision)
    if (P.q_bf16 && P.vec16 && P.D % 16 == 0) {
      constexpr int QM = (DP <= 128 ? 32 : 16) / G;
      // the fold kernel's column halves at D = 256 (DV = 128; quarters
      // were no faster: PERF.md, PR 31)
      constexpr int DV = DP == 256 ? 128 : DP;
      if (qt == 1)
        return launch_one<T, DP, G, 1, TensorMath<DP, G, 1>,
                          TensorMath<DP, G, 1, RS, false, DV>,
                          TensorMath<DP, G, 1, RS, false>>(P, s);
      if (qt == QM)
        return launch_one<T, DP, G, QM, TensorMath<DP, G, QM>,
                          TensorMath<DP, G, QM, RS, false, DV>,
                          TensorMath<DP, G, QM, RS, false>>(P, s);
      return (int)cudaErrorInvalidValue;
    }
  }
  constexpr int QM = 8 / G;
  if (qt == 1)
    return launch_one<T, DP, G, 1, CoreMath<T, DP, G, 1>,
                      CoreMath<T, DP, G, 1, RS>, CoreMath<T, DP, G, 1, RS>>(
        P, s);
  if (qt == QM)
    return launch_one<T, DP, G, QM, CoreMath<T, DP, G, QM>,
                      CoreMath<T, DP, G, QM, RS>,
                      CoreMath<T, DP, G, QM, RS>>(P, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int DP>
int launch_g(const Params& P, int qt, cudaStream_t s) {
  const int g = P.H / P.KV;
  if (g <= 1) return launch_math<T, DP, 1>(P, qt, s);
  if (g <= 2) return launch_math<T, DP, 2>(P, qt, s);
  if (g <= 4) return launch_math<T, DP, 4>(P, qt, s);
  return launch_math<T, DP, 8>(P, qt, s);
}

template <typename T>
int launch_d(const Params& P, int qt, cudaStream_t s) {
  if (P.D <= 16) return launch_g<T, 16>(P, qt, s);
  if (P.D <= 32) return launch_g<T, 32>(P, qt, s);
  if (P.D <= 64) return launch_g<T, 64>(P, qt, s);
  if (P.D <= 128) return launch_g<T, 128>(P, qt, s);
  return launch_g<T, 256>(P, qt, s);
}

}  // namespace

// dtype: 0 = float32 pools, 1 = bfloat16 pools; q_bf16: q's dtype.  The
// plan and the query tile qt come from the caller (`read_plan`,
// `fold_ctas` and `query_tile` in ops.py): with cta_split == 0 the cluster
// kernel's (n_split <= 8 chunks of per_split blocks), else the fold
// kernel's (n_split = nblk chunks of one block, per_split 1; cta_split =
// n_split <= 64, with a workspace `ws` of B * ceil(Q / qt) * KV * dh *
// n_split * (R * DP / dh + MLS) floats, R = qt * G and MLS = 2 R rounded
// up to a multiple of 4, and `counters` of B * ceil(Q / qt) * KV * dh
// zeros, dh = 2 on the tensor cores at D = 256 and 1 otherwise, or
// cta_split = 1); vec16 says every K/V row starts on a
// 16-byte boundary; stamps, when not null, takes kStamps values a CTA.
extern "C" int paged_attention_launch(
    int dtype, int q_bf16, const void* q, const void* kp, const void* vp,
    const void* slots, const void* ctx, void* o, void* m, void* l, int B,
    int Q, int H, int KV, int D, int bs, int nblk, int n_split,
    int per_split, int block_tokens, int tok_offset, int tok_stride,
    int ctx_per_query, int vec16, int qt, int cta_split, void* ws,
    void* counters, void* stamps, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > 8 || D <= 0 || D > 256 ||
      n_split < 1 || per_split < 1 || (long long)n_split * per_split < nblk)
    return (int)cudaErrorInvalidValue;
  if (cta_split == 0 ? n_split > kMaxSplit
                     : (per_split != 1 || n_split != nblk ||
                        (cta_split != 1 && (cta_split != n_split ||
                                            n_split > kMaxFold ||
                                            ws == nullptr ||
                                            counters == nullptr))))
    return (int)cudaErrorInvalidValue;
  Params P = {q, kp, vp, (const int*)slots, (const int*)ctx, (float*)o,
              (float*)m, (float*)l, B, Q, H, KV, D, bs, nblk, n_split,
              per_split, block_tokens, tok_offset, tok_stride,
              ctx_per_query, q_bf16, vec16,
              (float)(1.0 / sqrt((double)D)), cta_split,
              (float*)ws, (int*)counters, (unsigned long long*)stamps};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(P, qt, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(P, qt, s);
  return (int)cudaErrorInvalidValue;
}
