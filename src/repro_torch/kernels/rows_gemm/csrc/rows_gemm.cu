// y = x @ w (+ b) whose every output row has bits that depend only on
// that row of x, the weights and the bias: not on how many rows the call
// holds, nor on where the row sits among them.
//
// The invariant, which every choice below keeps: each output element is
// the f32 sum over k = 0 ... K-1 in order, computed by the same
// instruction sequence whatever M is, wherever the row sits in its tile
// and whichever CTA computes it.  So there is no split-K or stream-K and
// no atomic.  bf16 sums 16 k a wgmma, so its kernel, tile, stage count and
// instructions are not chosen by M: its column tile is chosen by N alone
// (a weight's shape never changes with the load).  bf16 results are
// rounded once from the f32 sum; a bias is then added and rounded again,
// as torch's `y + b` does.  float32 sums one k an FFMA, so any tile keeps
// the bits (below).
//
// Replaces no TPU kernel.  The JAX package leaves its projections to
// XLA's dot (src/repro/models/layers.py linear / unembed, the SSD einsums
// of src/repro/models/ssm.py); the port's plain version is torch's matmul,
// which on the card is cuBLAS, and cuBLAS picks its kernel, tile and
// split of the reduction by shape.  A prompt then rounds otherwise when it
// is admitted in other chunks, padded into another bucket or batched
// beside other prompts, and a bitwise contract of the reference (chunked
// = recompute = blocking admission) breaks.
//
// Bound on the card: operations for the prefill's projections (2 M N K
// flops against (M K + K N + M N) elements moved; at M = 2048 that is far
// above the card's balance), bytes for a few rows.
//
// Two kernels, by dtype:
// * bfloat16, for Hopper: a persistent grid of one CTA per SM walks the
//   output tiles (128 rows x BN columns, BN = 256, or 128 for N <= 2048 so
//   that narrow weights still fill the SMs), row tiles fastest inside
//   each column tile and the (G1, G2) batch slowest, so the CTAs in
//   flight share a few columns of the weight, which is read from memory
//   about once.  Three warpgroups: one producer warp issues TMA loads of
//   64-k slices of x and w (128-byte swizzle, one 4-D tensor map each over
//   (inner, outer, batch 2, batch 1)) into a ring of stages, each with a
//   full and an empty mbarrier; two consumer warpgroups of 64 rows each
//   run wgmma.m64nBNk16 with both operands read from shared memory
//   (x K-major; a weight stored k-major, linear's (K, N), read MN-major
//   with the transpose bit; one stored n-major, the embedding table read
//   in place as its transpose, read K-major) and release a stage once the
//   wgmma that read it has retired.  Rows, columns and k past the end
//   are TMA's zero fill: a zero product adds exactly nothing.  setmaxnreg
//   moves registers from the producer to the consumers' 128 f32
//   accumulators.  Each consumer rounds its 64-row half through shared
//   memory (swizzled, conflict-free) into 16-byte stores that never write
//   a row >= M or a column >= N, while the producer already loads the
//   next tile.
// * float32 (the MoE router, the SSD's products, every float32 model's
//   projections), on the CUDA cores.  The invariant here is stronger than
//   the rows': every output is one chain y = fmaf(x[K-1], w[K-1], ...
//   fmaf(x[0], w[0], +0.f)) in float32, k in increasing order, then the
//   bias added; no TF32, no tensor cores, no split of k across CTAs,
//   warps or threads, no atomics, and no FFMA past K.  No output's bits
//   then depend on the tile, so the tile is chosen by the whole shape, M
//   included (ops.py f32_tile), so that the grid covers the SMs wherever
//   the outputs allow: 128 x 128 (8 x 8 outputs a thread), 64 x 64 and
//   64 x 32 (4 x 4), and for N <= 32 128 x 16 (8 x 2), or 16 x 16 (2 x
//   1) where few outputs must still spread over the SMs (the routers at
//   an admission chunk).  Bound: operations for the SSD's larger products
//   and the qwen3-moe router; bytes for jamba's router (16 experts) and
//   the short-K products.  Each operand sits in shared memory as it
//   lies: a k-contiguous one k-contiguous ([rows][k + 4]: a thread reads
//   4 k of a row in one 128-bit load, the pad puts 8 neighbouring rows in
//   8 bank quads), an m- or n-contiguous one row-contiguous ([k][rows +
//   4]: a thread reads 4 neighbouring rows at one k), so both are copied
//   along their contiguous axis, 16 bytes a cp.async where the base and
//   the other strides are 16-byte aligned, else 4 (4 along k where
//   neither axis is contiguous).  The copies fill a ring of k slices
//   while the FFMAs run on an earlier one, and each thread loads its next
//   4 k's fragments while it runs the FFMAs of these.  Rows, columns and k
//   past the end are the copies' zero fill, never multiplied in.  Any
//   strides and two batch axes (one may have stride 0), so the SSD's
//   einsums read their operands where they lie.  `gemm_f32_ordered`, one
//   thread an output and no shared memory, is the order's oracle: the
//   tiled kernel equals it bitwise (tests and chip_smoke.py call it; the
//   wrappers never do).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

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

// ------------------------------------------ bfloat16: TMA ring + wgmma

constexpr int kBM = 128;         // rows a tile: two consumer warpgroups
constexpr int kBK = 64;          // k a stage: one 128-byte swizzle row
constexpr int kThreads3 = 384;   // producer warpgroup + two consumers
constexpr int kOutCols = 128;    // columns an epilogue pass stages

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int kA = kBM * kBK * 2;             // 16 KB
  static constexpr int kB = BN * kBK * 2;              // 32 or 16 KB
  static constexpr int kStage = kA + kB;
  static constexpr int kOut = 64 * kOutCols * 2;       // a consumer's 16 KB
  static constexpr int kBar = STAGES * kStage + 2 * kOut;
  static constexpr int bytes = kBar + 2 * STAGES * 8 + 1024;  // + align
};
static_assert(Cfg<256>::bytes <= 232448 && Cfg<128>::bytes <= 232448,
              "the ring and the staging fit in an SM's shared memory");

struct Bf16Args {
  const __nv_bfloat16* b;  // bias (N,) or null
  __nv_bfloat16* y;        // (G1 * G2, M, N)
  int G2, M, N, K;
  int tm, tn, tiles;       // row tiles, column tiles, tiles in all
  int xg1, xg2, wg1, wg2;  // 1: the map has the batch axis, else coord 0
};

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

// one box of a 4-D tensor map into shared memory; completes on `bar`
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

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major: rows
// of 128 bytes, 8-row groups at sbo (lbo unused).  MN-major: 64 columns of
// a k row in 128 bytes, 8-k-row groups at sbo, 64-column blocks at lbo.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

#define F8(b)                                                          \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),       \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// D (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem;
// TB = 1: MN-major, the tile stored k rows x columns; 0: K-major);
// scale_d == 0 ignores D's old value
template <int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 256, f32) (+)= A (64 x 16) * B (16 x 256), as wgmma_n128
template <int TB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}
#undef F8

template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 256)
    wgmma_n256<TB>(d, da, db, scale_d);
  else
    wgmma_n128<TB>(d, da, db, scale_d);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// output tile t: the batch g slowest, then the column tile, the row tile
// fastest
template <int BN>
struct TileAt {
  int g, m0, n0;
  __device__ __forceinline__ TileAt(int t, const Bf16Args& a) {
    const int per = a.tm * a.tn, r = t % per;
    g = t / per;
    m0 = (r % a.tm) * kBM;
    n0 = (r / a.tm) * BN;
  }
};

// WK: the weight is stored k-major, w[k * swk + n] (linear's (K, N)), and
// is read MN-major; otherwise n-major, w[n * swn + k] (the embedding table
// read as its transpose), read K-major.
template <int BN, bool WK>
__global__ void __launch_bounds__(kThreads3, 1)
    gemm_bf16_wgmma(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw, const Bf16Args a) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;
  const uint32_t full = base + C::kBar, empty = full + 8 * C::STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);     // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = (a.K + kBK - 1) / kBK;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tw))
                   : "memory");
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const TileAt<BN> tl(t, a);
        const int m0 = tl.m0, n0 = tl.n0;
        const int g1 = tl.g / a.G2, g2 = tl.g % a.G2;
        const int xc2 = a.xg2 ? g2 : 0, xc3 = a.xg1 ? g1 : 0;
        const int wc2 = a.wg2 ? g2 : 0, wc3 = a.wg1 ? g1 : 0;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % C::STAGES;
          const uint32_t ph = (uint32_t)(it / C::STAGES) & 1u;
          mbar_wait(empty + 8 * s, ph ^ 1u);   // the first round passes
          const uint32_t bar = full + 8 * s;
          const uint32_t sa = base + s * C::kStage, sb = sa + C::kA;
          mbar_expect_tx(bar, C::kStage);      // zero-filled bytes count
          tma_load(sa, &tx, bar, kt * kBK, m0, xc2, xc3);
          if constexpr (WK) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)  // 64-column blocks
              tma_load(sb + j * (kBK * 128), &tw, bar, n0 + 64 * j, kt * kBK,
                       wc2, wc3);
          } else {
            tma_load(sb, &tw, bar, kt * kBK, n0, wc2, wc3);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows 64 c .. 64 c + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t out = base + C::STAGES * C::kStage + c * C::kOut;
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const TileAt<BN> tl(t, a);
      const int m0 = tl.m0, n0 = tl.n0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % C::STAGES;
        mbar_wait(full + 8 * s, (uint32_t)(it / C::STAGES) & 1u);
        const uint32_t sa = base + s * C::kStage + c * (64 * 128);
        const uint32_t sb = base + s * C::kStage + C::kA;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = desc(sa + kk * 32, 16, 1024);
          const uint64_t db = WK ? desc(sb + kk * (16 * 128), kBK * 128, 1024)
                                 : desc(sb + kk * 32, 16, 1024);
          wgmma_tile<BN, WK ? 1 : 0>(acc, da, db, kt > 0 || kk > 0);
        }
        wgmma_commit();
        // the previous k slice's wgmmas have retired: release its stage
        wgmma_wait<1>();
        if (kt > 0 && lane == 0)
          mbar_arrive(empty + 8 * ((it - 1) % C::STAGES));
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % C::STAGES));

      // ---- epilogue: 128 columns a pass through the staging tile (64
      // rows of 256 bytes, 16-byte chunk q of row r at (q ^ (r & 7)))
      const __nv_bfloat16* bias = a.b;
      __nv_bfloat16* y = a.y + (long long)tl.g * a.M * a.N;
#pragma unroll
      for (int p = 0; p < BN / kOutCols; ++p) {
#pragma unroll
        for (int jj = 0; jj < kOutCols / 8; ++jj) {
          const int j = p * (kOutCols / 8) + jj;      // n8 block of acc
          const int n = n0 + p * kOutCols + jj * 8 + (lane & 3) * 2;
          float2 bv = make_float2(0.f, 0.f);
          if (bias && n < a.N)                        // N % 8 == 0
            bv = make_float2(__bfloat162float(bias[n]),
                             __bfloat162float(bias[n + 1]));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + (lane >> 2) + h * 8;
            __nv_bfloat16 v0 = __float2bfloat16(acc[4 * j + 2 * h]);
            __nv_bfloat16 v1 = __float2bfloat16(acc[4 * j + 2 * h + 1]);
            if (bias) {
              v0 = __float2bfloat16(__bfloat162float(v0) + bv.x);
              v1 = __float2bfloat16(__bfloat162float(v1) + bv.y);
            }
            __nv_bfloat162 v;
            v.x = v0;
            v.y = v1;
            const uint32_t addr = out + row * 256 +
                                  ((jj ^ (row & 7)) << 4) + (lane & 3) * 4;
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                         "r"(*reinterpret_cast<uint32_t*>(&v))
                         : "memory");
          }
        }
        bar_sync(1 + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {                 // 1024 chunks
          const int q = tid + i * 128, row = q >> 4, ch = q & 15;
          const int m = m0 + c * 64 + row;
          const int n = n0 + p * kOutCols + ch * 8;
          uint4 v;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                       : "r"(out + row * 256 + ((ch ^ (row & 7)) << 4))
                       : "memory");
          if (m < a.M && n < a.N)
            *reinterpret_cast<uint4*>(y + (long long)m * a.N + n) = v;
        }
        bar_sync(1 + c);                              // staging free again
      }
    }
  }
}

// ------------------------------------------------------------ float32

// One tile of the float32 kernel: rows BM, columns BN, rows and columns a
// thread TM and TN, k a slice BK, slices in the ring ST.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int ST_>
struct F32Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int ST = ST_;
  static constexpr int TY = BM / TM, TX = BN / TN, NT = TX * TY;
  static_assert(((BK + 4) / 4) % 2 == 1, "8 neighbouring rows, 8 bank quads");
  static_assert(BM % 8 == 0 && BN % 8 == 0 && BK % 4 == 0, "copy shapes");
};

// An operand's slice in shared memory: ROWS rows (x's m, w's n) by BK k,
// either k-contiguous, [ROWS][BK + 4] (a thread reads 4 k of a row in one
// 128-bit load; the pad puts 8 neighbouring rows in 8 bank quads), or,
// for an operand contiguous along its rows, row-contiguous, [BK][ROWS + 4]
// (a thread reads 4 rows at one k).  A thread with TR rows owns, in the
// first, rows t + i * ROWS / TR (neighbouring threads on neighbouring
// rows), in the second groups of 4 neighbouring rows, t * 4 + i % 4 + (i
// / 4) * 4 * ROWS / TR (TR >= 4), else rows t * TR + i.
template <int ROWS, int BK, int TR, bool OUTER>
struct Slice {
  static constexpr int LD = OUTER ? ROWS + 4 : BK + 4;
  static constexpr int size = OUTER ? BK * LD : ROWS * LD;   // floats
  static __device__ __forceinline__ int row(int t, int i) {
    if constexpr (!OUTER) return t + i * (ROWS / TR);
    else if constexpr (TR >= 4)
      return (i / 4) * (4 * ROWS / TR) + t * 4 + i % 4;
    else return t * TR + i;
  }
};

// how an operand's slices are copied (f32_mode): along k or along its
// rows (which also picks the layout), 16 or 4 bytes a copy
enum { kAlongK16 = 0, kAlongK4 = 1, kAlongRows16 = 2, kAlongRows4 = 3 };

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + ROWS - 1 (of R) and k k0 .. k0 + BK - 1 (of K) of the
// operand at g (element strides sr a row, sk a k) into the slice at dst;
// zeros past R and K.  Neighbouring threads copy neighbouring elements
// of the axis the copies run along.
template <class S, int ROWS, int BK, int NT, bool OUTER>
__device__ __forceinline__ void load_slice(uint32_t dst, const float* g,
                                           long long sr, long long sk,
                                           int r0, int R, int k0, int K,
                                           bool wide, int tid) {
  constexpr int A = OUTER ? ROWS : BK;   // the axis the copies run along
  if (wide) {
    constexpr int C = ROWS * BK / 4;     // 16-byte chunks
    static_assert(C % NT == 0, "whole chunks a thread");
#pragma unroll
    for (int i = 0; i < C / NT; ++i) {
      const int e = tid + i * NT, o = e / (A / 4), a = 4 * (e % (A / 4));
      const int r = OUTER ? a : o, k = OUTER ? o : a;
      const int m = r0 + r, kk = k0 + k;
      const int n = OUTER ? (kk < K ? min(max(R - m, 0), 4) : 0)
                          : (m < R ? min(max(K - kk, 0), 4) : 0);
      cp_async16(dst + 4 * (o * S::LD + a),
                 n ? g + m * sr + kk * sk : g, 4 * n);
    }
  } else {
    constexpr int C = ROWS * BK;
    static_assert(C % NT == 0, "whole elements a thread");
#pragma unroll
    for (int i = 0; i < C / NT; ++i) {
      const int e = tid + i * NT, o = e / A, a = e % A;
      const int r = OUTER ? a : o, k = OUTER ? o : a;
      const int m = r0 + r, kk = k0 + k;
      const bool ok = m < R && kk < K;
      cp_async4(dst + 4 * (o * S::LD + a), ok ? g + m * sr + kk * sk : g,
                ok ? 4 : 0);
    }
  }
}

// a thread's TR rows at k = 4 q .. 4 q + 3 of the slice at s: v[i][c]
template <class S, int TR, bool OUTER>
__device__ __forceinline__ void fragment(float (&v)[TR][4], const float* s,
                                         int t, int q) {
  if constexpr (!OUTER) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 f =
          *reinterpret_cast<const float4*>(s + S::row(t, i) * S::LD + 4 * q);
      v[i][0] = f.x, v[i][1] = f.y, v[i][2] = f.z, v[i][3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float* k = s + (4 * q + c) * S::LD;
      if constexpr (TR >= 4) {
#pragma unroll
        for (int i = 0; i < TR; i += 4) {
          const float4 f = *reinterpret_cast<const float4*>(k + S::row(t, i));
          v[i][c] = f.x, v[i + 1][c] = f.y, v[i + 2][c] = f.z;
          v[i + 3][c] = f.w;
        }
      } else if constexpr (TR == 2) {
        const float2 f = *reinterpret_cast<const float2*>(k + S::row(t, 0));
        v[0][c] = f.x, v[1][c] = f.y;
      } else {
        v[0][c] = k[S::row(t, 0)];
      }
    }
  }
}

// one slice's FFMAs, k in order; with TAIL only its first kv k (the last
// slice).  Below 64 outputs a thread the next 4 k's fragments load while
// the FFMAs of these run (at 64 the registers would not hold both).
template <class T, class SA, class SB, bool AO, bool BO, bool TAIL>
__device__ __forceinline__ void slice_ffma(float (&acc)[T::TM][T::TN],
                                           const float* sa, const float* sb,
                                           int tx, int ty, int kv) {
  constexpr int NB = T::TM * T::TN < 64 ? 2 : 1;   // fragment buffers
  float a[NB][T::TM][4], b[NB][T::TN][4];
  if constexpr (NB == 2) {
    fragment<SA, T::TM, AO>(a[0], sa, ty, 0);
    fragment<SB, T::TN, BO>(b[0], sb, tx, 0);
  }
#pragma unroll
  for (int q = 0; q < T::BK / 4; ++q) {
    if (TAIL && 4 * q >= kv) break;
    const int f = (q + NB - 1) % NB;   // the buffer loaded now
    if (NB == 1 || q + 1 < T::BK / 4) {
      fragment<SA, T::TM, AO>(a[f], sa, ty, q + NB - 1);
      fragment<SB, T::TN, BO>(b[f], sb, tx, q + NB - 1);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (TAIL && 4 * q + c >= kv) break;
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(a[q % NB][i][c], b[q % NB][j][c], acc[i][j]);
    }
  }
}

// AO, BO: x, w stored row-contiguous (copied along m, n)
template <class T, bool AO, bool BO>
__global__ void __launch_bounds__(T::NT)
    gemm_f32_tiled(const Args a, bool awide, bool bwide) {
  using SA = Slice<T::BM, T::BK, T::TM, AO>;
  using SB = Slice<T::BN, T::BK, T::TN, BO>;
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int g1 = blockIdx.z / a.G2, g2 = blockIdx.z % a.G2;
  const float* x = (const float*)a.x + g1 * a.sx1 + g2 * a.sx2;
  const float* w = (const float*)a.w + g1 * a.sw1 + g2 * a.sw2;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(fsm);
  constexpr int STAGE = SA::size + SB::size;   // floats a slice
  const int nk = (a.K + T::BK - 1) / T::BK;
  auto load = [&](int s, int kt) {
    const uint32_t sa = base + 4 * s * STAGE, sb = sa + 4 * SA::size;
    load_slice<SA, T::BM, T::BK, T::NT, AO>(sa, x, a.sxm, a.sxk, m0, a.M,
                                            kt * T::BK, a.K, awide, tid);
    load_slice<SB, T::BN, T::BK, T::NT, BO>(sb, w, a.swn, a.swk, n0, a.N,
                                            kt * T::BK, a.K, bwide, tid);
  };
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < T::ST - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();                 // empty groups keep the count
  }
  for (int kt = 0; kt < nk; ++kt) {
    // slice kt has landed, and every thread is done with slice kt - 1,
    // whose buffer the next copy overwrites
    cp_async_wait<T::ST - 2>();
    __syncthreads();
    const int nx = kt + T::ST - 1;
    if (nx < nk) load(nx % T::ST, nx);
    cp_async_commit();
    const float* sa = fsm + (kt % T::ST) * STAGE;
    const float* sb = sa + SA::size;
    const int kv = a.K - kt * T::BK;
    if (kv >= T::BK)
      slice_ffma<T, SA, SB, AO, BO, false>(acc, sa, sb, tx, ty, kv);
    else
      slice_ffma<T, SA, SB, AO, BO, true>(acc, sa, sb, tx, ty, kv);
  }

  float* y = (float*)a.y + (long long)blockIdx.z * a.M * a.N;
  const float* bias = (const float*)a.b;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + SA::row(ty, i);
    if (m >= a.M) continue;
    float* yr = y + (long long)m * a.N;
#pragma unroll
    for (int j = 0; j < T::TN; j += 4) {
      // row-contiguous w: 4 neighbouring columns, one 16-byte store
      const int n = n0 + SB::row(tx, j);
      if (BO && T::TN >= 4 && a.N % 4 == 0 && n + 3 < a.N) {
        float4 v = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                               acc[i][j + 3]);
        if (bias) {
          v.x += bias[n], v.y += bias[n + 1];
          v.z += bias[n + 2], v.w += bias[n + 3];
        }
        *reinterpret_cast<float4*>(yr + n) = v;
        continue;
      }
#pragma unroll
      for (int jj = j; jj < j + 4 && jj < T::TN; ++jj) {
        const int nn = n0 + SB::row(tx, jj);
        if (nn < a.N) yr[nn] = bias ? acc[i][jj] + bias[nn] : acc[i][jj];
      }
    }
  }
}

// The order's oracle: one thread an output, the same chain and bias.
__global__ void gemm_f32_ordered(const Args a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.M * a.N) return;
  const int m = (int)(i / a.N), n = (int)(i % a.N);
  const int g = blockIdx.y, g1 = g / a.G2, g2 = g % a.G2;
  const float* x = (const float*)a.x + g1 * a.sx1 + g2 * a.sx2 + m * a.sxm;
  const float* w = (const float*)a.w + g1 * a.sw1 + g2 * a.sw2 + n * a.swn;
  float acc = 0.f;
  for (int k = 0; k < a.K; ++k) acc = fmaf(x[k * a.sxk], w[k * a.swk], acc);
  const float* bias = (const float*)a.b;
  ((float*)a.y)[(long long)g * a.M * a.N + i] = bias ? acc + bias[n] : acc;
}

// how the operand at p (element strides: two batch axes, its rows, k) is
// copied: along its contiguous axis, k (kept k-contiguous) or its rows (an
// m-contiguous x, an n-contiguous weight: kept row-contiguous), 16 bytes a
// copy where the base and the other strides are 16-byte aligned, else 4;
// 4 bytes along k where neither axis is contiguous
int f32_mode(const void* p, long long s1, long long s2, long long sr,
             long long sk) {
  const bool aligned = (uintptr_t)p % 16 == 0 && s1 % 4 == 0 && s2 % 4 == 0;
  if (sk == 1) return aligned && sr % 4 == 0 ? kAlongK16 : kAlongK4;
  if (sr == 1) return aligned && sk % 4 == 0 ? kAlongRows16 : kAlongRows4;
  return kAlongK4;
}

constexpr int kMaxDevices = 64;

template <class T, bool AO, bool BO>
int launch_f32_as(const Args& a, int G1, bool awide, bool bwide,
                  cudaStream_t s) {
  constexpr int bytes =
      4 * T::ST * (Slice<T::BM, T::BK, T::TM, AO>::size +
                   Slice<T::BN, T::BK, T::TN, BO>::size);
  static_assert(bytes <= 232448, "the ring fits in shared memory");
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static bool sized[kMaxDevices];      // the attribute, once a device
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(gemm_f32_tiled<T, AO, BO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  const dim3 grid((a.M + T::BM - 1) / T::BM, (a.N + T::BN - 1) / T::BN,
                  G1 * a.G2);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gemm_f32_tiled<T, AO, BO><<<grid, T::NT, bytes, s>>>(a, awide, bwide);
  return (int)cudaGetLastError();
}

template <class T>
int launch_f32(const Args& a, int G1, cudaStream_t s) {
  const int amode = f32_mode(a.x, a.sx1, a.sx2, a.sxm, a.sxk);
  const int bmode = f32_mode(a.w, a.sw1, a.sw2, a.swn, a.swk);
  const bool ao = amode >= kAlongRows16, bo = bmode >= kAlongRows16;
  const bool aw = amode == kAlongK16 || amode == kAlongRows16;
  const bool bw = bmode == kAlongK16 || bmode == kAlongRows16;
  if (ao)
    return bo ? launch_f32_as<T, true, true>(a, G1, aw, bw, s)
              : launch_f32_as<T, true, false>(a, G1, aw, bw, s);
  return bo ? launch_f32_as<T, false, true>(a, G1, aw, bw, s)
            : launch_f32_as<T, false, false>(a, G1, aw, bw, s);
}

// ------------------------------------------------- the bf16 host side

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

// A bf16 map over dims (inner, outer, batch 2, batch 1) of sizes d and
// element strides s (s[0] == 1), with a box of (64, box1, 1, 1).  A batch
// axis of size 1 or stride 0 is left out (size 1; the kernel passes
// coordinate 0), and a size-1 axis gets the packed stride, which is never
// used.  0 on success.
int encode(CUtensorMap* map, const void* ptr, const long long d[4],
           const long long s[4], int box1, int* has2, int* has1) {
  EncodeTiled fn = encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  if (d[1] > 1 && s[1] == 0) return (int)cudaErrorInvalidValue;
  cuuint64_t dims[4] = {(cuuint64_t)d[0], 1, 1, 1};
  cuuint64_t strides[3];
  long long packed = 2 * d[0];   // bytes: a packed stride of the next axis
  for (int i = 1; i < 4; ++i) {
    const bool keep = d[i] > 1 && s[i] != 0;
    if (keep) dims[i] = (cuuint64_t)d[i];
    const long long st = keep ? 2 * s[i] : packed;
    strides[i - 1] = (cuuint64_t)st;
    packed = st * (long long)dims[i];
  }
  *has2 = dims[2] > 1;
  *has1 = dims[3] > 1;
  const cuuint32_t box[4] = {64, (cuuint32_t)box1, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a weight's map depends only on its pointer, shape, strides and the box:
// cached under those
struct WeightMap {
  CUtensorMap map;
  int has2, has1;
};
std::mutex g_mu;
std::map<std::array<long long, 9>, WeightMap> g_weights;

int weight_map(WeightMap* out, const void* ptr, const long long d[4],
               const long long s[4], int box1) {
  const std::array<long long, 9> key{(long long)(uintptr_t)ptr, d[0], d[1],
                                     d[2], d[3], s[1], s[2], s[3], box1};
  std::lock_guard<std::mutex> lock(g_mu);
  auto hit = g_weights.find(key);
  if (hit != g_weights.end()) {
    *out = hit->second;
    return 0;
  }
  WeightMap m;
  const int e = encode(&m.map, ptr, d, s, box1, &m.has2, &m.has1);
  if (e) return e;
  if (g_weights.size() >= 4096) g_weights.clear();
  g_weights.emplace(key, m);
  *out = m;
  return 0;
}

template <int BN, bool WK>
int launch_bf16(const Args& h, int G1, cudaStream_t s) {
  using C = Cfg<BN>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  // the attribute is set once per kernel and device; the SM count read once
  static bool sized[kMaxDevices];
  static int sms[kMaxDevices];
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(gemm_bf16_wgmma<BN, WK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::bytes);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  CUtensorMap tx;
  const long long xd[4] = {h.K, h.M, h.G2, G1};
  const long long xs[4] = {1, h.sxm, h.sx2, h.sx1};
  Bf16Args a{(const __nv_bfloat16*)h.b, (__nv_bfloat16*)h.y, h.G2, h.M, h.N,
             h.K, (h.M + kBM - 1) / kBM, (h.N + BN - 1) / BN, 0, 0, 0, 0, 0};
  int r = encode(&tx, h.x, xd, xs, kBM, &a.xg2, &a.xg1);
  if (r) return r;
  WeightMap wm;
  if (WK) {
    const long long wd[4] = {h.N, h.K, h.G2, G1};
    const long long ws[4] = {1, h.swk, h.sw2, h.sw1};
    r = weight_map(&wm, h.w, wd, ws, kBK);
  } else {
    const long long wd[4] = {h.K, h.N, h.G2, G1};
    const long long ws[4] = {1, h.swn, h.sw2, h.sw1};
    r = weight_map(&wm, h.w, wd, ws, BN);
  }
  if (r) return r;
  a.wg2 = wm.has2;
  a.wg1 = wm.has1;
  const long long tiles = (long long)G1 * h.G2 * a.tm * a.tn;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  const int grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  gemm_bf16_wgmma<BN, WK><<<grid, kThreads3, C::bytes, s>>>(tx, wm.map, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and y share it).  y is
// contiguous (G1 * G2, M, N); b (N,) or null.  float32: any strides, the
// tile by ``tile`` (ops.py F32_TILES: 0 128 x 128, 1 64 x 64, 2 64 x 32,
// 3 128 x 16, 4 16 x 16), x's and w's copies by their strides (f32_mode).
// bfloat16 needs sxk == 1, either swn == 1 (k-major weight) or swk == 1
// (n-major), K and N multiples of 8, the other strides multiples of 8 and
// 16-byte aligned bases: the wrapper checks.
extern "C" int rows_gemm_launch(int dtype, const void* x, const void* w,
                                const void* b, void* y, int G1, int G2,
                                int M, int N, int K, long long sx1,
                                long long sx2, long long sxm, long long sxk,
                                long long sw1, long long sw2, long long swk,
                                long long swn, int tile, void* stream) {
  if (G1 <= 0 || G2 <= 0 || M <= 0 || N <= 0 || K <= 0 ||
      (long long)G1 * G2 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Args a{x, w, b, y, G2, M, N, K, sx1, sx2, sxm, sxk, sw1, sw2, swk, swn};
  if (dtype == 0) {
    // F32Tile<rows, columns, a thread's rows, columns, k a slice, slices>
    using Large = F32Tile<128, 128, 8, 8, 16, 3>;
    using Wide = F32Tile<64, 64, 4, 4, 16, 3>;
    using Mid = F32Tile<64, 32, 4, 4, 32, 3>;
    using Narrow = F32Tile<128, 16, 8, 2, 32, 3>;
    using Small = F32Tile<16, 16, 2, 1, 64, 6>;
    switch (tile) {
      case 0: return launch_f32<Large>(a, G1, s);
      case 1: return launch_f32<Wide>(a, G1, s);
      case 2: return launch_f32<Mid>(a, G1, s);
      case 3: return launch_f32<Narrow>(a, G1, s);
      case 4: return launch_f32<Small>(a, G1, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || sxk != 1 || (swn != 1 && swk != 1) || K % 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  // the column tile by N alone: a narrow weight takes 128 columns so that
  // its tiles still fill the SMs
  if (N > 2048)
    return swn == 1 ? launch_bf16<256, true>(a, G1, s)
                    : launch_bf16<256, false>(a, G1, s);
  return swn == 1 ? launch_bf16<128, true>(a, G1, s)
                  : launch_bf16<128, false>(a, G1, s);
}

// float32 through the oracle (gemm_f32_ordered), the arguments as above
extern "C" int rows_gemm_f32_ordered_launch(
    const void* x, const void* w, const void* b, void* y, int G1, int G2,
    int M, int N, int K, long long sx1, long long sx2, long long sxm,
    long long sxk, long long sw1, long long sw2, long long swk,
    long long swn, void* stream) {
  if (G1 <= 0 || G2 <= 0 || M <= 0 || N <= 0 || K <= 0 ||
      (long long)G1 * G2 > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, b, y, G2, M, N, K, sx1, sx2, sxm, sxk, sw1, sw2, swk, swn};
  const long long blocks = ((long long)M * N + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gemm_f32_ordered<<<dim3((unsigned)blocks, G1 * G2), 256, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
