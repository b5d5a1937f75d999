// Causal (or full) flash attention with GQA for Hopper: the prefill's
// self-attention, whisper's encoder and cross-attention; normalized
// output in q's dtype.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_flash_kernel /
// flash_attention_pallas).  The Pallas grid (B, H, q_tiles, kv_tiles) ran
// the kv axis in order and carried the softmax state in VMEM scratch; it
// asserted that S divides the 128-row tiles.  Here a CTA owns one (b, h)
// and 64 or 128 queries and loops over 64-key tiles with an f32 online
// softmax.  KV tiles wholly above the diagonal are skipped, and the ragged
// edges (S not a multiple of the tile, e.g. an 8-token prefill bucket, or
// whisper's 1500 = 23 x 64 + 28 frames) come in as zeros and are masked
// instead of asserted.  kv head = h / (H / KV).  An optional per-row
// q_offset (B,) places each row's queries inside the causal mask (the
// prefix-KV prefill's chunk over its prefix at absolute positions).  Key
// tiles always start at position 0 and a query folds its tiles in order
// from tile 0; a tile wholly past its diagonal adds exact zeros (the
// rescale is exp(0) = 1, every weight 0), so a query's bits depend on its
// row of q and the keys up to it, not on its offset, on Sq, on how many
// masked keys lie past it, or on the CTA its row falls in.
//
// Bound on the card: operations at long prefills (4 D flops a (query,
// key) pair against each q, k, v read and each output written once), but
// bytes or latency at the serving path's short ones: paligemma-3b's (2,
// 512, 8, 1, 256) causal is bounded by 0.00217 ms of operations and
// 0.00282 ms of bytes, whisper-medium's cross-attention (2, 256 vs 1500,
// 16, 16, 64) by 0.00429 ms of bytes, its encoder (2, 1500, 16, 16, 64) by
// 0.0186 ms of operations.  What holds a kernel back at these shapes is
// idle SMs (a 128-query CTA gives 64 of them work at the first two) and
// the latency of a key tile's steps run one after another; at D = 64 also
// the shared memory each tile's products read, and the exponentials
// (4,096 a 64 x 64 tile, 16 a clock on an SM).
//
// Three kernels:
// * bfloat16 at D = 64 (and 16, 32, padded to 64 columns) and D = 256, and
//   at D = 128 where the plan gives 64 rows: flash_tma_kernel.  The plan
//   (ops.py flash_plan, passed in as the query rows a CTA and the CTAs)
//   gives a CTA one consumer warpgroup of 64 query rows, so that the grid
//   of B * H * ceil(Sq / 64) covers the SMs: paligemma's and whisper's
//   cross shapes go from 64 CTAs to 128.  A producer warp's one elected
//   thread loads the Q tile once and each K/V tile with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, 64 x 64 boxes; rows past Skv
//   and columns past D are zero-filled) into a ring of stages with a full
//   and an empty mbarrier each; no __syncthreads() in the key loop.
//   Stages by shared memory: at D = 256 a CTA holds its 32 KB Q tile and
//   three 64 KB K/V stages (230,456 bytes with the barriers and the
//   alignment slack), so the producer runs a tile ahead of the two the
//   consumer holds.  At D = 64 four 16 KB stages, and three CTAs an SM,
//   whose warpgroups overlap one another; Q's A fragments are read into
//   registers once (16 a thread), so S reads only K from shared memory.
//   At D = 128 two 32 KB stages and two CTAs an SM.
//   The consumer warpgroup overlaps its softmax with the tensor cores
//   (FA3's intra-warpgroup pipelining): it issues tile j's S = Q K^T and
//   tile j-1's O += P V back to back, waits for S alone, runs tile j's
//   softmax while P V runs, then waits for P V, releases tile j-1's stage,
//   rescales O and packs tile j's P.
// * bfloat16 at D = 128 where the plan gives 128 rows (its 128-row tiles
//   fill the card): flash_pp_kernel, two consumer warpgroups of 64 rows
//   sharing each TMA-fed K/V tile, taking the tensor cores in turn (a
//   ping-pong on named barriers: one's softmax runs beside the other's
//   products), each pipelined as above, on a persistent grid of one CTA an
//   SM whose producer warpgroup hands its registers to the consumers.
// * float32: 32-query tiles with both products as f32 FMAs on the CUDA
//   cores, so float32 stays float32; warp w owns query rows w, w+4, ...,
//   each lane one key, so row max and sum are warp shuffles.
// Every bf16 row sees one arithmetic in one order (PR 12's cp.async
// kernel's, kept since): S is one m64n64k16 wgmma per 16 columns of D (K
// read K-major), the masked ex2/fmaf softmax, the bf16 packing of P in
// registers, then P V as m64nDk16 wgmmas with V read MN-major; O *=
// corr_j before P_j V_j is added; key tiles of 64 from position 0, those
// wholly above a warpgroup's 64 rows skipped.  So a row's bits are the
// same in either bf16 kernel, whatever the plan, the grid or the tile
// order.  The key axis is never split: a row's bits would depend on the
// split.
// Causal query tiles are launched longest first so the short ones fill
// the tail.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per CTA
constexpr int kBK = 32;  // keys per tile (one per lane)
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);


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
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ q_offset, int Sq, int Skv, int H,
                 int KV, int causal, float scale) {
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
  const int off = q_offset ? q_offset[b] : 0;  // the rows' first position
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D, qp = q0 + r;
    sQ[r * DP + d] =
        qp < Sq ? (q[(((long long)b * Sq + qp) * H + h) * D + d]) : 0.f;
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
  if (causal)  // skip tiles above the diagonal
    n_kv = min(n_kv, (off + q0 + kBQ - 1) / kBK + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D, kpos = k0 + r;
      const long long g = (((long long)b * Skv + kpos) * KV + hk) * D + d;
      sK[r * DP + d] = kpos < Skv ? k[g] : 0.f;
      sV[r * D + d] = kpos < Skv ? v[g] : 0.f;
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
      const int r = warp + 4 * i, qpos = off + q0 + r;
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
    for (int c = 0; c < DPT; ++c) out[4 * c] = acc[c] / l;
  }
}

// ------------------------------------------------- bfloat16: wgmma

constexpr int kBlk = 64 * 128;   // one 64-row x 64-column swizzled block

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
  // keep the compiler from moving accumulator reads across a wgmma wait
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// waits until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// one 64 x 64 box of a 4-D tensor map into shared memory; completes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

#define F8(b)                                                          \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),       \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// D (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (64 x 16, smem,
// K-major); scale_d == 0 ignores D's old value
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 16, registers) * B (16 x 64, smem; TB =
// 1: MN-major, the tile stored keys x columns; 0: K-major); scale_d == 0
// ignores D's old value
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem,
// MN-major: the tile is stored keys x columns)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, registers) * B (16 x 256, smem,
// MN-major: the tile is stored keys x columns)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef F8

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64<1>(o, a, db, 1);
  else if constexpr (DP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q K^T for one warpgroup's 64 rows and one key tile, started and
// committed, not waited for.  qw: the warpgroup's Q column block 0, the
// blocks qblk bytes apart; tk: the K tile (column block a at a * BK * 128).
template <int DP, int BK>
__device__ __forceinline__ void start_s(float* sc, uint32_t qw, int qblk,
                                        uint32_t tk) {
  static_assert(BK == 64, "S is one m64n64k16 wgmma per 16 columns of D");
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;   // 16 columns = 32 bytes
    const uint64_t da = desc(qw + (kk >> 2) * qblk + off, 16, 1024);
    const uint64_t db = desc(tk + (kk >> 2) * (BK * 128) + off, 16, 1024);
    wgmma_ss_n64(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// This warp's A fragments of the warpgroup's 64 x DP Q tile (column
// blocks of 64 at qw + a * kBlk, swizzled), 4 registers a 16-column step:
// rows lane / 4 and + 8, columns 2 (lane % 4) and + 8, as P's
template <int DP>
__device__ __forceinline__ void load_q(uint32_t* qf, uint32_t qw, int warp,
                                       int lane) {
  const int mi = lane >> 3;                        // ldmatrix's matrix
  const int row = warp * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int chunk = 2 * (kk & 3) + (mi >> 1);
    const uint32_t addr =
        qw + (kk >> 2) * kBlk + row * 128 + ((chunk ^ (row & 7)) << 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(qf[4 * kk]), "=r"(qf[4 * kk + 1]), "=r"(qf[4 * kk + 2]),
          "=r"(qf[4 * kk + 3])
        : "r"(addr));
  }
}

// S = Q K^T as start_s, Q's fragments from registers (D = 64: one read of
// Q, not one a key tile)
template <int DP, int BK>
__device__ __forceinline__ void start_s_rs(float* sc, const uint32_t* qf,
                                           uint32_t tk) {
  static_assert(BK == 64, "S is one m64n64k16 wgmma per 16 columns of D");
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_rs_n64<0>(sc, qf + 4 * kk,
                    desc(tk + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16,
                         1024),
                    kk > 0);
  wgmma_commit();
}

// O += P V for one key tile (V read MN-major), started and committed.
template <int DP, int BK>
__device__ __forceinline__ void start_pv(float* acc, const uint32_t* pk,
                                         uint32_t tv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<DP>(acc, pk + 4 * kk, desc(tv + kk * 16 * 128, BK * 128, 1024));
  wgmma_commit();
}

// Online softmax of one S tile in registers: masks (diagonal and ragged
// tiles only), updates the row max and sum, turns S into P in place and
// returns each row's rescale of O.  Row r0 = row0 holds sc[i] with
// ((i >> 1) & 1) == 0, row row0 + 8 the others; a row's 4 threads are
// lanes 4k .. 4k+3.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* sc, float* m_r,
                                             float* l_r, float* corr,
                                             int k0, int wq0, int row0,
                                             int col0, int Skv, int causal,
                                             float scale_log2) {
  if ((causal && k0 + BK - 1 > wq0) || k0 + BK > Skv) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + (i >> 2) * 8 + col0 + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (col >= Skv || (causal && col > row)) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
    corr[r] = ex2(m_r[r] - mu[r]);
    m_r[r] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = ex2(fmaf(sc[i], scale_log2, -mu[r]));
    ls[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_r[r] = fmaf(l_r[r], corr[r], ls[r]);
}

// O *= corr (each row's rescale), then P packed to bf16 in place as the
// A fragment of P V
template <int DP, int BK>
__device__ __forceinline__ void rescale_pack(float* acc, const float* corr,
                                             const float* sc, uint32_t* pk) {
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) pk[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// The normalised output of a warpgroup's 64 rows (this thread's rows row0
// and row0 + 8, columns col0 + 8 c and the next), rows >= Sq dropped.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ o,
                                           const float* acc, float* l_r,
                                           int b, int h, int row0, int col0,
                                           int Sq, int H, int D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* out = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = c * 8 + col0;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] * inv,
                                  acc[4 * c + 2 * r + 1] * inv);
    }
  }
}

// flash_pp_kernel's (WGS = 2 consumer warpgroups): the Q tile holds one
// warpgroup's 64 rows after the other's, then come the ST stages, the
// barriers (full and empty a stage and for Q) and the tile order's keys
// and slots; 384 threads, the third warpgroup the producer's.
constexpr int kMaxClasses = 256;   // (row, query tile) classes sorted
template <int DP, int ST, int CPS, int WGS = 1>
struct TmaCfg {
  static constexpr int kBlocks = DP / 64;
  static constexpr int kKV = kBlocks * kBlk;   // 64 rows of Q, a K or V tile
  static constexpr int kQ = WGS * kKV;
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBar = kQ + ST * kStage;
  // flash_pp_kernel's tile order by length: a key and a slot a class
  static constexpr int kOrder = kBar + (2 * ST + 2) * 8;
  static constexpr int bytes =
      kOrder + (WGS == 1 ? 0 : 12 * kMaxClasses) + 1024;  // + align
  static constexpr int kThreads = WGS == 1 ? 160 : 128 * (WGS + 1);
  static_assert(bytes <= 232448 && CPS * (bytes + 1024) <= 233472,
                "CPS CTAs fit in an SM's shared memory");
};

template <int DP, int ST, int CPS>
__global__ void __launch_bounds__(160, CPS)
    flash_tma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o,
                     const int* __restrict__ q_offset, int B, int Sq,
                     int Skv, int H, int KV, int D, int causal,
                     float scale_log2) {
  using C = TmaCfg<DP, ST, CPS>;
  constexpr int BK = 64, kOut = DP / 2;
  // D = 64 holds Q's A fragments in registers (16 a thread)
  constexpr bool kQRegs = DP == 64;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_tma) + 1023u) & ~1023u;
  const uint32_t sKV = base + C::kKV;
  const uint32_t full = base + C::kBar, empty = full + 8 * ST;
  const uint32_t qbar = empty + 8 * ST;
  // the q-tile index varies slowest, longest (causal) tiles first
  const int n_qt = (Sq + 63) / 64;
  const int hb = blockIdx.x % (H * B), rank = blockIdx.x / (H * B);
  const int qt = causal ? n_qt - 1 - rank : rank;
  const int h = hb % H, b = hb / H, hk = h / (H / KV);
  const int q0 = qt * 64;
  const int off = q_offset ? q_offset[b] : 0;  // the rows' first position
  int n_kv = (Skv + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (off + q0 + 63) / BK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);        // the producer's expect_tx
      mbar_init(empty + 8 * s, 4);       // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: one thread loads Q, then keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tk))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tv))
                   : "memory");
      mbar_expect_tx(qbar, C::kKV);        // zero-filled bytes count
#pragma unroll
      for (int a = 0; a < C::kBlocks; ++a)
        tma_load(base + a * kBlk, &tq, qbar, 64 * a, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % ST;
        mbar_wait(empty + 8 * s, ((uint32_t)(j / ST) & 1u) ^ 1u);
        const uint32_t bar = full + 8 * s;
        const uint32_t sk = sKV + s * C::kStage, sv = sk + C::kKV;
        mbar_expect_tx(bar, C::kStage);
#pragma unroll
        for (int a = 0; a < C::kBlocks; ++a) {
          tma_load(sk + a * kBlk, &tk, bar, 64 * a, hk, j * BK, b);
          tma_load(sv + a * kBlk, &tv, bar, 64 * a, hk, j * BK, b);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows q0 .. q0 + 63
  float acc[kOut], sc[BK / 2], corr[2];
  uint32_t pk[BK / 4];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + (lane >> 2);     // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);

  // tile 0: S, softmax, P
  mbar_wait(qbar, 0);
  uint32_t qf[kQRegs ? DP / 4 : 1];
  if constexpr (kQRegs) load_q<DP>(qf, base, warp, lane);
  mbar_wait(full, 0);
  wgmma_fence();
  if constexpr (kQRegs)
    start_s_rs<DP, BK>(sc, qf, sKV);
  else
    start_s<DP, BK>(sc, base, kBlk, sKV);
  wgmma_wait<0>();
  fence_regs<BK / 2>(sc);
  softmax_tile<BK>(sc, m_r, l_r, corr, 0, off + q0, off + row0, col0, Skv,
                   causal, scale_log2);
  rescale_pack<DP, BK>(acc, corr, sc, pk);
  // tile j's S beside tile j-1's P V; tile j's softmax while P V runs
  for (int j = 1; j < n_kv; ++j) {
    const int s = j % ST, sp = (j - 1) % ST;
    mbar_wait(full + 8 * s, (uint32_t)(j / ST) & 1u);
    fence_regs<kOut>(acc);
    wgmma_fence();
    if constexpr (kQRegs)
      start_s_rs<DP, BK>(sc, qf, sKV + s * C::kStage);
    else
      start_s<DP, BK>(sc, base, kBlk, sKV + s * C::kStage);
    start_pv<DP, BK>(acc, pk, sKV + sp * C::kStage + C::kKV);
    wgmma_wait<1>();                   // S has landed; P V still runs
    fence_regs<BK / 2>(sc);
    softmax_tile<BK>(sc, m_r, l_r, corr, j * BK, off + q0, off + row0,
                     col0, Skv, causal, scale_log2);
    wgmma_wait<0>();
    fence_regs<kOut>(acc);
    if (lane == 0) mbar_arrive(empty + 8 * sp);   // tile j-1 is done
    rescale_pack<DP, BK>(acc, corr, sc, pk);
  }
  {
    const int sp = (n_kv - 1) % ST;
    fence_regs<kOut>(acc);
    wgmma_fence();
    start_pv<DP, BK>(acc, pk, sKV + sp * C::kStage + C::kKV);
    wgmma_wait<0>();
    fence_regs<kOut>(acc);
  }
  store_rows<DP>(o, acc, l_r, b, h, row0, col0, Sq, H, D);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(m))
               : "memory");
}

// The ping-pong of two consumer warpgroups (named barriers 1 and 2, 256
// threads each): a warpgroup issues its wgmmas between bar.sync on its own
// barrier and bar.arrive on the other's, so the two issue in turn and one's
// softmax runs while the other's products hold the tensor cores.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// bfloat16 at D = 128.  A CTA of two consumer warpgroups (rows q0 .. q0 +
// 63 and q0 + 64 .. q0 + 127 of a 128-row query tile) and a producer
// warpgroup, one CTA an SM: the producer gives up its registers
// (setmaxnreg, 168 a thread at entry down to 24) and the consumers take
// them (240), so that O (64 floats), S (32), P (16) and Q's fragments (32)
// live in registers.  The grid is persistent: CTA c takes tiles c, 2G - 1
// - c, 2G + c, ... of the longest-first order (G CTAs; the snake evens out
// the causal tiles' lengths; with q_offset the (row, query tile) classes
// are sorted by length first), and with G = the tile count each CTA runs
// one.  The producer's one elected thread loads each tile's Q and every
// K/V tile of every tile in turn into the ring, so each K/V tile is read
// once for 128 queries and the ring runs on across tiles.  The consumers
// read their Q's A fragments into registers (32 a thread) and free the Q
// tile at once, so the next tile's Q lands while they work on this one;
// S = Q K^T then reads only K from shared memory.  A warpgroup's rows see
// flash_tma_kernel's arithmetic and tiles: tiles 0 .. na - 1 of its 64
// rows (causal: the CTA's last tile may lie wholly above the first
// warpgroup's rows, which skips it as a 64-row CTA would not have loaded
// it), so each output is bitwise that of a 64-row CTA.  Both warpgroups
// wait on every K/V tile, release every stage and take their ping-pong
// turn on every tile of the CTA, whether or not they have rows there.
template <int ST>
__global__ void __launch_bounds__(384, 1)
    flash_pp_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o,
                    const int* __restrict__ q_offset, int B, int Sq,
                    int Skv, int H, int KV, int D, int causal,
                    float scale_log2) {
  constexpr int DP = 128, BK = 64, kOut = DP / 2;
  using C = TmaCfg<DP, ST, 1, 2>;
  extern __shared__ __align__(1024) unsigned char smem_pp[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_pp) + 1023u) & ~1023u;
  const uint32_t sKV = base + C::kQ;
  const uint32_t full = base + C::kBar, empty = full + 8 * ST;
  const uint32_t qfull = empty + 8 * ST, qempty = qfull + 8;
  const int n_qt = (Sq + 127) / 128, G = gridDim.x, c = blockIdx.x;
  const int n_tiles = n_qt * H * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);        // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);       // one arrival a consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Tiles go longest first.  Without offsets a query tile's rank says its
  // length; with them each (row, query tile) class of H tiles is sorted by
  // its key tiles (then query tile, then row, so that equal offsets keep
  // the rank order), up to kMaxClasses classes.
  const int n_cls = B * n_qt;
  const bool by_length = q_offset && causal && n_cls <= kMaxClasses;
  long long* key = reinterpret_cast<long long*>(
      smem_pp + (base - (uint32_t)__cvta_generic_to_shared(smem_pp)) +
      C::kOrder);
  int* cls = reinterpret_cast<int*>(key + kMaxClasses);
  if (by_length) {
    const int n_all = (Skv + BK - 1) / BK;
    for (int i = threadIdx.x; i < n_cls; i += blockDim.x) {
      const int qt = i % n_qt, b = i / n_qt;
      const int len = min(n_all, (q_offset[b] + qt * 128 + 127) / BK + 1);
      key[i] = ((long long)len << 16) | (qt << 8) | (255 - b);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_cls; i += blockDim.x) {
      int r = 0;
      for (int j = 0; j < n_cls; ++j) r += key[j] > key[i];
      cls[r] = i;
    }
  }
  __syncthreads();
  // tile t's (row, head, first query)
  auto tile_of = [&](int t, int& b, int& h, int& q0) {
    int qt;
    if (by_length) {
      const int ci = cls[t / H];
      h = t % H;
      b = ci / n_qt;
      qt = ci % n_qt;
    } else {
      const int hb = t % (H * B), rank = t / (H * B);
      qt = causal ? n_qt - 1 - rank : rank;
      h = hb % H;
      b = hb / H;
    }
    q0 = qt * 128;
  };

  if (warp >= 8) {
    // ---- producer: each tile's Q, then its K/V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      int it = 0;                        // K/V tiles loaded so far
      for (int n = 0;; ++n) {
        const int t = n * G + (n & 1 ? G - 1 - c : c);
        if (t >= n_tiles) break;
        int b, h, q0;
        tile_of(t, b, h, q0);
        const int hk = h / (H / KV);
        const int off = q_offset ? q_offset[b] : 0;
        int n_kv = (Skv + BK - 1) / BK;
        if (causal) n_kv = min(n_kv, (off + q0 + 127) / BK + 1);
        const int nq = q0 + 64 < Sq ? 2 : 1;   // Q blocks holding a row
        if (n) mbar_wait(qempty, (uint32_t)(n - 1) & 1u);
        mbar_expect_tx(qfull, nq * C::kKV);
        for (int w = 0; w < nq; ++w)
#pragma unroll
          for (int a = 0; a < 2; ++a)
            tma_load(base + w * C::kKV + a * kBlk, &tq, qfull, 64 * a, h,
                     q0 + 64 * w, b);
        for (int j = 0; j < n_kv; ++j, ++it) {
          const int s = it % ST;
          mbar_wait(empty + 8 * s, ((uint32_t)(it / ST) & 1u) ^ 1u);
          const uint32_t bar = full + 8 * s;
          const uint32_t sk = sKV + s * C::kStage, sv = sk + C::kKV;
          mbar_expect_tx(bar, C::kStage);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            tma_load(sk + a * kBlk, &tk, bar, 64 * a, hk, j * BK, b);
            tma_load(sv + a * kBlk, &tv, bar, 64 * a, hk, j * BK, b);
          }
        }
      }
    }
  } else {
    // ---- the consumer warpgroups: wg's rows q0 + 64 wg .. q0 + 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp >> 2, w4 = warp & 3;
    const int col0 = 2 * (lane & 3);
    if (wg == 1) named_arrive(1);          // the first warpgroup issues first
    int it = 0;                            // K/V tiles consumed so far
    for (int n = 0;; ++n) {
      const int t = n * G + (n & 1 ? G - 1 - c : c);
      if (t >= n_tiles) break;
      const int tn = (n + 1) * G + (n & 1 ? c : G - 1 - c);
      const bool last = tn >= n_tiles;     // this CTA's last tile
      int b, h, q0;
      tile_of(t, b, h, q0);
      const int off = q_offset ? q_offset[b] : 0;
      int n_kv = (Skv + BK - 1) / BK;
      if (causal) n_kv = min(n_kv, (off + q0 + 127) / BK + 1);
      const int wq0 = q0 + 64 * wg;
      // this warpgroup's key tiles: a prefix of the CTA's.  Every wgmma is
      // issued on every path (ptxas serialises wgmmas issued in a divergent
      // branch), so a warpgroup whose rows lie past Sq runs tile 0 on a stale
      // Q buffer and stores nothing.
      const int na = wq0 >= Sq ? 1
                     : causal ? min(n_kv, (off + wq0 + 63) / BK + 1) : n_kv;
      float acc[kOut], sc[BK / 2], corr[2];
      uint32_t pk[BK / 4], qf[DP / 4];
#pragma unroll
      for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
      const int row0 = wq0 + w4 * 16 + (lane >> 2);   // rows row0, row0 + 8
      // Q's A fragments into registers (32 a thread); the Q tile is then
      // free for the CTA's next tile
      mbar_wait(qfull, (uint32_t)n & 1u);
      load_q<DP>(qf, base + wg * C::kKV, w4, lane);
      if (lane == 0) mbar_arrive(qempty);
      // tile 0: S, softmax, P
      mbar_wait(full + 8 * (it % ST), (uint32_t)(it / ST) & 1u);
      named_sync(1 + wg);
      wgmma_fence();
      start_s_rs<DP, BK>(sc, qf, sKV + (it % ST) * C::kStage);
      if (wg == 0 || !(last && n_kv == 1)) named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs<BK / 2>(sc);
      softmax_tile<BK>(sc, m_r, l_r, corr, 0, off + wq0, off + row0, col0, Skv,
                       causal, scale_log2);
      rescale_pack<DP, BK>(acc, corr, sc, pk);
      // tiles 1 .. na - 1: tile j's S beside tile j-1's P V, tile j's
      // softmax while P V runs
      for (int j = 1; j < na; ++j) {
        const int s = (it + j) % ST, sp = (it + j - 1) % ST;
        mbar_wait(full + 8 * s, (uint32_t)((it + j) / ST) & 1u);
        named_sync(1 + wg);
        fence_regs<kOut>(acc);
        wgmma_fence();
        start_s_rs<DP, BK>(sc, qf, sKV + s * C::kStage);
        start_pv<DP, BK>(acc, pk, sKV + sp * C::kStage + C::kKV);
        if (wg == 0 || !(last && j == n_kv - 1)) named_arrive(2 - wg);
        wgmma_wait<1>();                   // S has landed; P V still runs
        fence_regs<BK / 2>(sc);
        softmax_tile<BK>(sc, m_r, l_r, corr, j * BK, off + wq0, off + row0,
                         col0, Skv, causal, scale_log2);
        wgmma_wait<0>();
        fence_regs<kOut>(acc);
        if (lane == 0) mbar_arrive(empty + 8 * sp);   // tile j-1 is done
        rescale_pack<DP, BK>(acc, corr, sc, pk);
      }
      // the last P V: after the loop, or in the turn of tile na when this
      // warpgroup's tiles end before the CTA's
      const bool short_rows = na < n_kv;
      if (short_rows) {
        mbar_wait(full + 8 * ((it + na) % ST), (uint32_t)((it + na) / ST) & 1u);
        named_sync(1 + wg);
      }
      fence_regs<kOut>(acc);
      wgmma_fence();
      start_pv<DP, BK>(acc, pk,
                       sKV + ((it + na - 1) % ST) * C::kStage + C::kKV);
      if (short_rows && (wg == 0 || !(last && na == n_kv - 1)))
        named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs<kOut>(acc);
      // release the stages of tiles na - 1 and na (the latter waited for but
      // not read)
      if (lane == 0) {
        mbar_arrive(empty + 8 * ((it + na - 1) % ST));
        if (short_rows) mbar_arrive(empty + 8 * ((it + na) % ST));
      }
      // the turns of the CTA's tiles past those: no row of this warpgroup
      for (int j = na + 1; j < n_kv; ++j) {
        mbar_wait(full + 8 * ((it + j) % ST), (uint32_t)((it + j) / ST) & 1u);
        named_sync(1 + wg);
        if (wg == 0 || !(last && j == n_kv - 1)) named_arrive(2 - wg);
        if (lane == 0) mbar_arrive(empty + 8 * ((it + j) % ST));
      }
      if (wq0 < Sq) store_rows<DP>(o, acc, l_r, b, h, row0, col0, Sq, H, D);
      it += n_kv;
    }
  }
}

// ------------------------------------------------------ the host side

constexpr int kMaxDevices = 64;

float scale_log2_of(int D) {
  return (float)(1.4426950408889634 / sqrt((double)D));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous bf16 (B, S, heads, D) tensor over (D, heads, S,
// B), with a 64 x 64 box of (columns, 1 head, rows, 1 batch row): columns
// past D and rows past S are zero-filled.  0 on success.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int heads,
           int D) {
  EncodeTiled fn = encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP, int ST, int CPS>
int launch_tma(const void* q, const void* k, const void* v, void* o,
               const int* q_offset, int B, int Sq, int Skv, int H, int KV,
               int D, int causal, int ctas, cudaStream_t stream) {
  using C = TmaCfg<DP, ST, CPS>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static bool sized[kMaxDevices];      // the attribute, once a device
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(flash_tma_kernel<DP, ST, CPS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::bytes);
    // all of the SM's 228 KB as shared memory, so that CPS CTAs fit
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_tma_kernel<DP, ST, CPS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  const long long n_qt = (Sq + 63) / 64;
  const long long grid = n_qt * H * B;
  if (grid > 0x7fffffffLL || Sq > 0x7fffffff - 64 || grid != ctas)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int r = encode(&mq, q, B, Sq, H, D);
  if (!r) r = encode(&mk, k, B, Skv, KV, D);
  if (!r) r = encode(&mv, v, B, Skv, KV, D);
  if (r) return r;
  flash_tma_kernel<DP, ST, CPS><<<(unsigned)grid, C::kThreads, C::bytes,
                                  stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, q_offset, B, Sq, Skv, H, KV, D, causal,
      scale_log2_of(D));
  return (int)cudaGetLastError();
}

template <int ST>
int launch_pp(const void* q, const void* k, const void* v, void* o,
              const int* q_offset, int B, int Sq, int Skv, int H, int KV,
              int D, int causal, int ctas, cudaStream_t stream) {
  using C = TmaCfg<128, ST, 1, 2>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static bool sized[kMaxDevices];      // the attribute, once a device
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(flash_pp_kernel<ST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::bytes);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  const long long n_tiles = (long long)((Sq + 127) / 128) * H * B;
  // the tile loop's indices stay below n_tiles + 2 G
  if (ctas < 1 || ctas > n_tiles || n_tiles + 2LL * ctas > 0x7fffffffLL ||
      Sq > 0x7fffffff - 128)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int r = encode(&mq, q, B, Sq, H, D);
  if (!r) r = encode(&mk, k, B, Skv, KV, D);
  if (!r) r = encode(&mv, v, B, Skv, KV, D);
  if (r) return r;
  flash_pp_kernel<ST><<<ctas, C::kThreads, C::bytes, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, q_offset, B, Sq, Skv, H, KV, D, causal,
      scale_log2_of(D));
  return (int)cudaGetLastError();
}

// bfloat16 by the plan's query rows a CTA and CTAs (ops.py flash_plan):
// D = 128 takes the ping-pong kernel at 128 rows (any grid up to its tile
// count); D = 16, 32, 64 (padded to 64), 128 and 256 the TMA kernel at 64
// rows, one CTA a tile, with (K/V stages, CTAs an SM) by D
int launch_bf16(int D, int rows, int ctas, const void* q, const void* k,
                const void* v, void* o, const int* qo, int B, int Sq,
                int Skv, int H, int KV, int causal, cudaStream_t s) {
  const int DP = D < 64 ? 64 : D;
  if (DP == 128 && rows == 128)
    return launch_pp<4>(q, k, v, o, qo, B, Sq, Skv, H, KV, D, causal, ctas,
                        s);
  if (DP == 64 && rows == 64)
    return launch_tma<64, 4, 3>(q, k, v, o, qo, B, Sq, Skv, H, KV, D,
                                causal, ctas, s);
  if (DP == 128 && rows == 64)
    return launch_tma<128, 2, 2>(q, k, v, o, qo, B, Sq, Skv, H, KV, D,
                                 causal, ctas, s);
  if (DP == 256 && rows == 64)
    return launch_tma<256, 3, 1>(q, k, v, o, qo, B, Sq, Skv, H, KV, D,
                                 causal, ctas, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const int* q_offset, int B, int Sq, int Skv, int H, int KV,
               int causal, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, q_offset,
      Sq, Skv, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

int launch_f32_d(int D, const void* q, const void* k, const void* v,
                 void* o, const int* qo, int B, int Sq, int Skv, int H,
                 int KV, int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_f32<16>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    case 32:
      return launch_f32<32>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    case 64:
      return launch_f32<64>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    case 128:
      return launch_f32<128>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    case 256:
      return launch_f32<256>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it),
// each contiguous (B, S, heads, D) with a 16-byte aligned base.
// q_offset: null, or (B,) int32, each row's position of its first query
// in the causal mask (key tiles stay at absolute position 0, and a
// query's tiles past its diagonal add exact zeros, so its bits do not
// depend on the offset, Sq or Skv).  rows, ctas: the bf16 plan's query
// rows a CTA and grid (ops.py flash_plan), ignored in float32.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      const void* q_offset, int B, int Sq,
                                      int Skv, int H, int KV, int D,
                                      int causal, int rows, int ctas,
                                      void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* qo = (const int*)q_offset;
  if (dtype == 0)
    return launch_f32_d(D, q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
  if (dtype == 1 && (D == 16 || D == 32 || D == 64 || D == 128 || D == 256))
    return launch_bf16(D, rows, ctas, q, k, v, o, qo, B, Sq, Skv, H, KV,
                       causal, s);
  return (int)cudaErrorInvalidValue;
}

// The host time of the three tensor maps a bf16 TMA launch encodes (q's,
// k's and v's), in microseconds a launch over `iters` launches' worth, or
// -1 if an encoding fails: a part of the wrapper's host time, which
// chip_smoke.py reports beside it.
extern "C" double flash_attention_encode_us(const void* q, const void* k,
                                            const void* v, int B, int Sq,
                                            int Skv, int H, int KV, int D,
                                            int iters) {
  CUtensorMap m[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (encode(&m[0], q, B, Sq, H, D) || encode(&m[1], k, B, Skv, KV, D) ||
        encode(&m[2], v, B, Skv, KV, D))
      return -1.0;
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / (iters > 0 ? iters : 1);
}
