// Hybrid RestSeg walk (RSW) for Hopper: vpn -> (slot, in_rest, mapped,
// accesses), the decode step's one translation dispatch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/utopia_rsw/utopia_rsw.py
// (_rsw_kernel / rsw_pallas).  That kernel gathered TAR rows with a one-hot
// MXU matmul split into 16-bit tag halves, because the TPU vector unit has
// no fast data-dependent row gather.  A GPU thread loads its set's row
// directly, so neither workaround is carried over: one thread per vpn
// reads the SF counter and the `assoc` int32 tags of its set, compares
// `vpn + 1` against them (first matching way wins, as argmax does), and on
// a miss reads the flat flex table.
//
// Bound on the card: bytes.  Each query moves 4 B in, 16 B out and at most
// one SF word, one TAR row and one flex entry; a few hundred queries per
// step are far below one wave of the card, so launch latency dominates.
// The design keeps it to one launch over the whole query list (read grid
// plus the write-block queries) and emits the access counts in the same
// pass, so the engine's telemetry needs no second kernel.
//
// Hash arithmetic follows src/repro_torch/core/hashes.py on int32 with
// wrap-around; the multiplies run in uint32 (signed overflow is undefined
// in C++, and the low 31 bits agree).  `%` is floor-mod, as numpy's and
// torch's are.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMix = 73244475u;  // 0x045D9F3B

__device__ __forceinline__ int floor_mod(int x, int n) {
  int r = x % n;
  return r < 0 ? r + n : r;
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

__global__ void rsw_kernel(const int* __restrict__ vpns,
                           const int* __restrict__ tar,
                           const int* __restrict__ sf,
                           const int* __restrict__ flex, int n, int n_sets,
                           int assoc, int flex_len, int hash_id, int p,
                           int* __restrict__ slot, int* __restrict__ in_rest,
                           int* __restrict__ mapped,
                           int* __restrict__ accesses) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = vpns[i];
  int s = set_index(v, n_sets, hash_id, p);
  int cnt = sf[s];
  int hit = 0, way = 0;
  if (cnt > 0) {
    const int* row = tar + (long long)s * assoc;
    for (int w = 0; w < assoc; ++w) {
      if (row[w] == v + 1) {
        hit = 1;
        way = w;
        break;
      }
    }
  }
  // on a miss, read the flat flex table as JAX indexes it: a negative
  // vpn counts from the end once, then the index clamps into the table
  int fi = v < 0 ? v + flex_len : v;
  fi = min(max(fi, 0), flex_len - 1);
  int flex_slot = (!hit && flex_len > 0) ? flex[fi] : -1;
  int out = hit ? s * assoc + way : flex_slot;
  int mp = hit || flex_slot >= 0;
  slot[i] = mp ? out : -1;
  in_rest[i] = hit;
  mapped[i] = mp;
  // SF probe + TAR set read unless the SF filtered it + flex walk on a miss
  accesses[i] = 1 + (cnt > 0) + (hit ? 0 : 1);
}

}  // namespace

extern "C" int utopia_rsw_launch(const void* vpns, const void* tar,
                                 const void* sf, const void* flex, int n,
                                 int n_sets, int assoc, int flex_len,
                                 int hash_id, int p, void* slot,
                                 void* in_rest, void* mapped, void* accesses,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  rsw_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)vpns, (const int*)tar, (const int*)sf, (const int*)flex, n,
      n_sets, assoc, flex_len, hash_id, p, (int*)slot, (int*)in_rest,
      (int*)mapped, (int*)accesses);
  return (int)cudaGetLastError();
}
