// Causal (or full) flash attention with GQA for Hopper: the prefill's
// self-attention, normalized output in q's dtype.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_flash_kernel /
// flash_attention_pallas).  The Pallas grid (B, H, q_tiles, kv_tiles) ran
// the kv axis in order and carried the softmax state in VMEM scratch; it
// asserted that S divides the 128-row tiles.  Here one CTA owns one
// (b, h, query tile) and loops over key tiles with an f32 online softmax.
// KV tiles wholly above the diagonal are skipped, and the ragged edges (S
// not a multiple of the tile, e.g. an 8-token prefill bucket) come in as
// zeros and are masked instead of asserted.  kv head = h / (H / KV).
// An optional per-row q_offset (B,) places each row's queries inside the
// causal mask (the prefix-KV prefill's chunk over its prefix at absolute
// positions).  Key tiles always start at position 0 and a query folds its
// tiles in order from tile 0; a tile wholly past its diagonal adds exact
// zeros (the rescale is exp(0) = 1, every weight 0), so a query's bits
// depend on its row of q and the keys up to it, not on its offset, on Sq
// or on how many masked keys lie past it.
//
// Bound on the card: operations.  Causal attention does 4 * D flops per
// (query, key) pair with k <= q while reading each q, k, v and writing each
// output once; at prefill lengths that is far above the card's
// flops-per-byte balance, so the products belong on the tensor cores at
// Hopper's full rate, which only wgmma reaches.
//
// Two kernels, by dtype:
// * bfloat16 (the serving path), FA3-shaped and simplified: a CTA of two
//   warpgroups owns 128 queries (64 rows each) and walks 64-key tiles.
//   S = Q K^T is one wgmma per 16 columns of D with Q and K read from
//   shared memory through matrix descriptors (128-byte swizzle, K-major).
//   The f32 S fragment is masked (diagonal and ragged tiles only), turned
//   into probabilities in registers (row max and sum over the 4 threads
//   that share a row, exp2 with scale * log2(e) folded in) and re-packed in
//   place to bf16 as the A operand of O += P V, whose B operand is the V
//   tile read MN-major.  O stays in registers for the whole key loop and
//   is normalised once.  K/V tiles arrive by 16-byte cp.async copies
//   (each thread's offsets computed once) into a two-stage ring, so the
//   next tile's copy is in flight while this one is computed; rows past
//   the end are zero-filled, never read.  96 KB of shared memory and at
//   most 128 registers a thread at D = 128 let two CTAs share an SM, so
//   one CTA's softmax runs beside the other's products.  Causal query
//   tiles are launched longest first so the short ones fill the tail.
//   Head dims below 64 are padded to 64 columns in shared memory.
// * float32: 32-query tiles with both products as f32 FMAs on the CUDA
//   cores, so float32 stays float32; warp w owns query rows w, w+4, ...,
//   each lane one key, so row max and sum are warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int kWgBQ = 128;       // query rows per CTA: two warpgroups
constexpr int kWgThreads = 256;

template <int DP>
struct WgCfg {
  static constexpr int BK = 64;                        // keys per tile
  static constexpr int STAGES = 2;                     // cp.async ring
  // every tile is stored in 128-byte swizzled column blocks of 64 values:
  // block a of a tile of R rows at a * R * 128 bytes, row r at r * 128,
  // 16-byte chunk c at ((c ^ r) & 7) * 16
  static constexpr int kQBytes = kWgBQ * DP * 2;
  static constexpr int kTileBytes = BK * DP * 2;       // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + STAGES * kTileBytes;
  static constexpr int bytes = kV + STAGES * kTileBytes + 1024;  // + align
};

template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * (R * 128) + r * 128 + (((c ^ r) & 7) << 4));
}

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
__device__ __forceinline__ void fence_async_smem() {
  // make the generic-proxy (cp.async) writes visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
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

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem,
// MN-major: the tile is stored keys x columns)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q K^T for this warpgroup's 64 rows and one key tile, started and
// committed, not waited for.
template <int DP, int BK>
__device__ __forceinline__ void start_s(float* sc, uint32_t sQ, uint32_t tk,
                                        int wg) {
  static_assert(BK == 64, "S is one m64n64k16 wgmma per 16 columns of D");
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;   // 16 columns = 32 bytes
    const uint64_t da = desc(sQ + (kk >> 2) * (kWgBQ * 128) +
                                 wg * (64 * 128) + off, 16, 1024);
    const uint64_t db = desc(tk + (kk >> 2) * (BK * 128) + off, 16, 1024);
    wgmma_ss_n64(sc, da, db, kk > 0);
  }
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

// The cp.async copies of one R-row tile (Q, K or V): thread `tid` always
// copies the same column chunk of rows lr, lr + RS, ..., so its shared and
// global offsets are computed once.
template <int DP, int R>
struct TileCopy {
  static constexpr int kChunks = DP / 8;               // 16-byte chunks
  static constexpr int RS = kWgThreads / kChunks;      // row step
  static constexpr int N = R / RS;                     // copies per thread
  uint32_t soff;
  int lr;
  long long goff;
  bool col_ok;
  __device__ __forceinline__ TileCopy(int tid, long long stride, int D) {
    const int lc = tid % kChunks;
    lr = tid / kChunks;
    soff = swz<R>(lr, lc);
    goff = lr * stride + lc * 8;
    col_ok = lc * 8 < D;
  }
  // rows at or past `valid` are zero-filled without a read
  __device__ __forceinline__ void copy(uint32_t dst,
                                       const __nv_bfloat16* src,
                                       const __nv_bfloat16* any,
                                       long long stride, int valid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool ok = col_ok && lr + i * RS < valid;
      cp_async16(dst + soff + i * RS * 128,
                 ok ? src + goff + i * RS * stride : any, ok ? 16 : 0);
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(kWgThreads, DP <= 128 ? 2 : 1)
    flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o,
                       const int* __restrict__ q_offset, int B, int Sq,
                       int Skv, int H, int KV, int D, int causal,
                       float scale_log2) {
  using C = WgCfg<DP>;
  constexpr int BK = C::BK, ST = C::STAGES;
  constexpr int kOut = DP / 2;          // O accumulator floats per thread
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  // the q-tile index varies slowest, longest (causal) tiles first
  const int n_qt = (Sq + kWgBQ - 1) / kWgBQ;
  const int hb = blockIdx.x % (H * B), rank = blockIdx.x / (H * B);
  const int qt = causal ? n_qt - 1 - rank : rank;
  const int h = hb % H, b = hb / H, hk = h / (H / KV);
  const int q0 = qt * kWgBQ;
  const int off = q_offset ? q_offset[b] : 0;  // the rows' first position

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  const uint32_t sQ = base;
  const uint32_t sK = base + C::kK, sV = base + C::kV;

  int n_kv = (Skv + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (off + q0 + kWgBQ - 1) / BK + 1);
  const int wq0 = q0 + wg * 64;                      // warpgroup's first row
  // this warpgroup's key tiles: a prefix of the CTA's (causal: the last
  // one may lie wholly above its 64 rows)
  const int n_act = causal ? min(n_kv, (off + wq0 + 63) / BK + 1) : n_kv;
  const long long kv_stride = (long long)KV * D;
  const __nv_bfloat16* kb = k + ((long long)b * Skv * KV + hk) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * KV + hk) * D;
  const TileCopy<DP, BK> cp(tid, kv_stride, D);

  const long long q_stride = (long long)H * D;
  TileCopy<DP, kWgBQ>(tid, q_stride, D)
      .copy(sQ, q + (((long long)b * Sq + q0) * H + h) * D, q, q_stride,
            Sq - q0);
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    if (s < n_kv) {
      const int k0 = s * BK;
      cp.copy(sK + s * C::kTileBytes, kb + k0 * kv_stride, k, kv_stride,
              Skv - k0);
      cp.copy(sV + s * C::kTileBytes, vb + k0 * kv_stride, v, kv_stride,
              Skv - k0);
    }
    cp_async_commit();
  }

  float acc[kOut], sc[BK / 2], corr[2];
  uint32_t pk[BK / 4];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int row0 = wq0 + warp * 16 + (lane >> 2);    // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % ST;
    cp_async_wait<ST - 1>();            // tile j has landed
    fence_async_smem();
    __syncthreads();
    if (j < n_act) {                    // warpgroup-uniform
      wgmma_fence();
      start_s<DP, BK>(sc, sQ, sK + st * C::kTileBytes, wg);
      wgmma_wait<0>();
      fence_regs<BK / 2>(sc);
      softmax_tile<BK>(sc, m_r, l_r, corr, j * BK, off + wq0, off + row0,
                       col0, Skv, causal, scale_log2);
#pragma unroll
      for (int i = 0; i < kOut; ++i) acc[i] *= corr[(i >> 1) & 1];
      // the S fragment re-read as the A fragment of P V, in place
#pragma unroll
      for (int i = 0; i < BK / 4; ++i)
        pk[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      fence_regs<kOut>(acc);
      wgmma_fence();
      start_pv<DP, BK>(acc, pk, sV + st * C::kTileBytes);
      wgmma_wait<0>();
      fence_regs<kOut>(acc);
    }
    __syncthreads();   // both warpgroups are done with this stage
    const int jn = j + ST;
    if (jn < n_kv) {
      const int k0n = jn * BK;
      cp.copy(sK + st * C::kTileBytes, kb + k0n * kv_stride, k, kv_stride,
              Skv - k0n);
      cp.copy(sV + st * C::kTileBytes, vb + k0n * kv_stride, v, kv_stride,
              Skv - k0n);
    }
    cp_async_commit();
  }

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

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const int* q_offset, int B, int Sq, int Skv, int H, int KV,
                 int D, int causal, cudaStream_t stream) {
  constexpr int smem = WgCfg<DP>::bytes;
  static bool sized = false;   // the attribute is set once per kernel
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const long long n_qt = (Sq + kWgBQ - 1) / kWgBQ;
  const long long grid = n_qt * H * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_wgmma_kernel<DP><<<(unsigned)grid, kWgThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, q_offset, B, Sq, Skv, H,
      KV, D, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* q_offset, int B, int Sq, int Skv, int H, int KV,
           int causal, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    constexpr int DP = D < 64 ? 64 : D;
    return launch_wgmma<DP>(q, k, v, o, q_offset, B, Sq, Skv, H, KV, D,
                            causal, stream);
  } else {
    const float scale = (float)(1.0 / sqrt((double)D));
    const size_t smem = sizeof(float) * smem_floats<D>();
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, q_offset, Sq, Skv, H,
        KV, causal, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             const int* qo, int B, int Sq, int Skv, int H, int KV, int causal,
             cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    case 256:
      return launch<T, 256>(q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
// q_offset: null, or (B,) int32, each row's position of its first query
// in the causal mask (key tiles stay at absolute position 0, and a
// query's tiles past its diagonal add exact zeros, so its bits do not
// depend on the offset, Sq or Skv).
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      const void* q_offset, int B, int Sq,
                                      int Skv, int H, int KV, int D,
                                      int causal, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* qo = (const int*)q_offset;
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, qo, B, Sq, Skv, H, KV, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, qo, B, Sq, Skv, H, KV,
                                   causal, s);
  return (int)cudaErrorInvalidValue;
}
