// y = x @ w (+ b) whose every output row has bits that depend only on
// that row of x, the weights and the bias: not on how many rows the call
// holds, nor on where the row sits among them.
//
// The invariant, which every choice below keeps: each output element is
// the f32 sum over k = 0 ... K-1, 16 k at a time, in order, computed by
// the same instruction sequence whatever M is, wherever the row sits in
// its tile and whichever CTA computes it.  So there is no split-K or
// stream-K, no atomic, and no choice of kernel, tile, stage count or
// instruction by M.  The column tile is chosen by N alone (a weight's
// shape never changes with the load).  bf16 results are rounded once from
// the f32 sum; a bias is then added and rounded again, as torch's
// `y + b` does.
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
// * float32: CTA tile 64 x 64, K tile 16, each thread 4 x 4 outputs, each
//   a chain of FFMAs over k in order (no TF32), so float32 stays float32.
//   Any strides, and two batch axes, so the SSD's einsums read their
//   operands where they lie.
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

constexpr int kThreads = 256;
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

constexpr int kMaxDevices = 64;

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
    return (int)cudaGetLastError();
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
