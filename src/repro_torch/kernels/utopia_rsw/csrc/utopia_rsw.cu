// Hybrid RestSeg walk (RSW) for Hopper: the decode step's whole
// translation in one launch, and the vpn-list walk it is built from.
//
// Replaces the Pallas TPU kernel src/repro/kernels/utopia_rsw/utopia_rsw.py
// (_rsw_kernel / rsw_pallas).  That kernel gathered TAR rows with a one-hot
// MXU matmul split into 16-bit tag halves, because the TPU vector unit has
// no fast data-dependent row gather.  A GPU thread loads its set's row
// directly, so neither workaround is carried over: one thread per query
// reads the SF counter and the `assoc` int32 tags of its set (16-byte
// vector loads) and, unless the SF filtered the set, compares `vpn + 1`
// against them (the first matching way wins, as argmax does); on a miss
// it takes the flat flex table's entry.
//
// Bound on the card: latency, not bytes.  A decode step asks a few
// thousand queries at most, each moving a few dozen bytes (SF word, TAR
// row, flex entry); the bytes bound is well under a microsecond, below
// the cost of a launch.  So a walk issues its three loads together (one
// memory round trip), and the step entry
// (`utopia_translate_step_launch`) does in ONE launch everything the decode
// step derives from the translation: it builds the query grid itself
// (query i is vpn i; row b's write block, as the JAX package's
// `_translate_queries` picks it, is one of row b's own queries), walks
// it, and writes the telemetry, the
// resolved slots and, per row, the write validity, the flat pool row of the
// new token's K/V (the sink slot's row when the write is invalid or the row
// inactive) and the attention extent.  The step then runs no other device
// op for its translation, and the layer loop none to prepare its writes.
//
// Hash arithmetic follows src/repro_torch/core/hashes.py on int32 with
// wrap-around; the multiplies run in uint32 (signed overflow is undefined
// in C++, and the low 31 bits agree).  `%` and `/` on possibly negative
// values are floor-mod and floor-division, as numpy's and torch's are.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMix = 73244475u;  // 0x045D9F3B
constexpr int kThreads = 128;

__device__ __forceinline__ int floor_mod(int x, int n) {
  int r = x % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int floor_div(int x, int n) {
  return (x - floor_mod(x, n)) / n;
}

__device__ __forceinline__ int shr(int x, int s) {
  // arithmetic shift; shifting an int32 by >= 32 gives its sign fill
  return s >= 32 ? (x < 0 ? -1 : 0) : (x >> s);
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x * kMix) & 0x7FFFFFFFu;
  x ^= x >> 15;
  x = (x * kMix) & 0x7FFFFFFFu;
  return x ^ (x >> 13);
}

// hash ids: 0 modulo, 1 xor_fold, 2 prime_displacement, 3 mersenne,
// 4 multiplicative.  `p` is the set-bit count (1, 2) or k (3).
__device__ __forceinline__ int set_index(int v, int n_sets, int hash_id,
                                         int p) {
  switch (hash_id) {
    case 1: {
      int folded = v ^ shr(v, p) ^ shr(v, 2 * p);
      return floor_mod(folded, n_sets);
    }
    case 2: {
      int tag = shr(v, p);
      int idx0 = floor_mod(v, n_sets);
      int x = (int)((uint32_t)tag * 17u + (uint32_t)idx0);
      return floor_mod(x, n_sets);
    }
    case 3: {
      int m = (1 << p) - 1;
      int x = (v & m) + shr(v, p);
      x = (x & m) + shr(x, p);
      return floor_mod(x, n_sets);
    }
    case 4:
      return floor_mod((int)mix32((uint32_t)v), n_sets);
    default:
      return floor_mod(v, n_sets);
  }
}

// The translation tables and the hash, as both entries pass them.
struct Tables {
  const int* tar;   // (n_sets, assoc)
  const int* sf;    // (n_sets,)
  const int* flex;  // (flex_len,)
  int n_sets, assoc, flex_len, hash_id, p;
};

struct Walk {
  int slot;      // resolved pool slot, -1 when unmapped
  int hit;       // resolved by the RestSeg
  int mapped;
  int accesses;  // SF probe + TAR set read unless filtered + flex on a miss
};

__device__ __forceinline__ int first_way(int4 t, int tag) {
  return t.x == tag ? 0 : t.y == tag ? 1 : t.z == tag ? 2
       : t.w == tag ? 3 : -1;
}

__device__ __forceinline__ Walk rsw_walk(int v, const Tables& T) {
  int s = set_index(v, T.n_sets, T.hash_id, T.p);
  // tags store vpn + 1 (0 marks an empty way); wrap as int32 does
  int tag = (int)((uint32_t)v + 1u);
  // A miss reads the flat flex table as JAX indexes it: a negative vpn
  // counts from the end once, then the index clamps into the table.
  int fi = v < 0 ? v + T.flex_len : v;
  fi = min(max(fi, 0), T.flex_len - 1);
  // The SF word, the set's TAR row and the flex entry are issued together:
  // no address depends on another load's value, so the walk costs one
  // memory round trip instead of three.  The SF still decides whether the
  // row's tags count, and a hit whether the flex entry does; all three
  // addresses lie inside their tables whatever the values.
  int cnt = __ldg(T.sf + s);
  int flex_slot = T.flex_len > 0 ? __ldg(T.flex + fi) : -1;
  const int* row = T.tar + (long long)s * T.assoc;
  int way = -1;
  if (T.assoc == 8 && ((uintptr_t)row & 15) == 0) {
    // the engine's associativity: both halves of the row in flight at once
    const int4* row4 = reinterpret_cast<const int4*>(row);
    int4 ta = __ldg(row4), tb = __ldg(row4 + 1);
    int wa = first_way(ta, tag), wb = first_way(tb, tag);
    way = wa >= 0 ? wa : (wb >= 0 ? 4 + wb : -1);
  } else if ((T.assoc & 3) == 0 && ((uintptr_t)row & 15) == 0) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll 4
    for (int w4 = 0; w4 < (T.assoc >> 2); ++w4) {
      int w = first_way(__ldg(row4 + w4), tag);
      if (way < 0 && w >= 0) way = 4 * w4 + w;
    }
  } else {
    for (int w = 0; w < T.assoc; ++w)
      if (way < 0 && __ldg(row + w) == tag) way = w;
  }
  Walk r;
  r.hit = cnt > 0 && way >= 0;
  if (r.hit) flex_slot = -1;
  r.mapped = r.hit || flex_slot >= 0;
  r.slot = r.hit ? s * T.assoc + way : (r.mapped ? flex_slot : -1);
  r.accesses = 1 + (cnt > 0) + (r.hit ? 0 : 1);
  return r;
}

__global__ void rsw_kernel(const int* __restrict__ vpns, Tables T, int n,
                           int* __restrict__ slot, int* __restrict__ in_rest,
                           int* __restrict__ mapped,
                           int* __restrict__ accesses) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Walk r = rsw_walk(__ldg(vpns + i), T);
  slot[i] = r.slot;
  in_rest[i] = r.hit;
  mapped[i] = r.mapped;
  accesses[i] = r.accesses;
}

// The step's geometry, bound once on the host (see StepParams below).
struct Step {
  int batch, nblk, block_size, sink;
};

// Output layout of the step entry, in int32 words of one buffer:
//   [0, 2B)           w_row    int64 (B,) flat pool row of the write
//   [2B, 3B)          w_slot   (B,) slot of the write block, -1 unmapped
//   [3B, 4B)          w_valid  (B,) mapped, in range and active
//   [4B, 5B)          extent   (B,) ctx_len + 1
//   [5B, 5B + 3N)     in_rest, accesses, mapped, (N,) each, N = B * nblk
//   [5B + 3N, 5B + 4N) slots  (N,)
// The telemetry block is what the engine fetches, as it lies.
__global__ void translate_step_kernel(Tables T, Step S,
                                      const int* __restrict__ ctx_len,
                                      const unsigned char* __restrict__ active,
                                      int* __restrict__ out) {
  const int B = S.batch, n = B * S.nblk;
  long long* w_row = reinterpret_cast<long long*>(out);
  int* w_slot = out + 2 * B;
  int* w_valid = w_slot + B;
  int* extent = w_valid + B;
  int* in_rest = extent + B;
  int* accesses = in_rest + n;
  int* mapped = accesses + n;
  int* slots = mapped + n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    // query i is vpn i, block j of row b.  Row b's write block is one of
    // its own grid blocks (the JAX package walks it as an extra query), so
    // the thread of that block writes the row's outputs too: its context
    // length is loaded beside the walk's loads, and the step costs one
    // memory round trip.
    const int b = i / S.nblk, j = i - b * S.nblk;
    const int pos = __ldg(ctx_len + b);
    const int act = active == nullptr || __ldg(active + b) != 0;
    Walk r = rsw_walk(i, T);
    slots[i] = r.slot;
    in_rest[i] = r.hit;
    accesses[i] = r.accesses;
    mapped[i] = r.mapped;
    // an idle row's position can run past its vpn range; without the
    // clamp its write block would alias ANOTHER row's block
    const int cur = floor_div(pos, S.block_size);
    if (j != min(max(cur, 0), S.nblk - 1)) continue;
    const int valid = r.mapped && cur < S.nblk && act;
    w_slot[b] = r.slot;
    w_valid[b] = valid;
    w_row[b] = (long long)(valid ? r.slot : S.sink) * S.block_size
               + floor_mod(pos, S.block_size);
    extent[b] = pos + 1;
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// The step entry's fixed arguments, filled once by the host when the step
// is bound, and passed by address on every call.
struct StepParams {
  int n_sets, assoc, flex_len, hash_id, p;
  int batch, nblk, block_size, sink;
};

int utopia_translate_step_launch(const void* tar, const void* sf,
                                 const void* flex, const void* ctx_len,
                                 const void* active, void* out,
                                 const StepParams* prm, void* stream) {
  Tables T{(const int*)tar, (const int*)sf, (const int*)flex, prm->n_sets,
           prm->assoc, prm->flex_len, prm->hash_id, prm->p};
  Step S{prm->batch, prm->nblk, prm->block_size, prm->sink};
  int total = prm->batch * prm->nblk;
  int blocks = (total + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  translate_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      T, S, (const int*)ctx_len, (const unsigned char*)active, (int*)out);
  return (int)cudaGetLastError();
}

int utopia_rsw_launch(const void* vpns, const void* tar, const void* sf,
                      const void* flex, int n, int n_sets, int assoc,
                      int flex_len, int hash_id, int p, void* slot,
                      void* in_rest, void* mapped, void* accesses,
                      void* stream) {
  Tables T{(const int*)tar, (const int*)sf, (const int*)flex, n_sets, assoc,
           flex_len, hash_id, p};
  int blocks = (n + kThreads - 1) / kThreads;
  rsw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)vpns, T, n, (int*)slot, (int*)in_rest, (int*)mapped,
      (int*)accesses);
  return (int)cudaGetLastError();
}

// An empty kernel: the latency floor the step entry is measured against.
int utopia_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
