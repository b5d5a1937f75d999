// Hybrid RestSeg walk (RSW) for Hopper: the decode step's whole
// translation in one launch, the vpn-list walk it is built from, and the
// sharded step's two entries (a rank's contributions, and their combine
// after the caller's all-reduce; see "the sharded step" below).
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
// resolved slots and, per row and window position, the write validity, the
// flat pool row of that position's K/V (the sink slot's row when the write
// is invalid or the row inactive) and the attention extent.  The window is
// W positions from the row's context length: W = 1 for a decode step,
// K + 1 for a speculative verify step, whose positions' write blocks are
// read from the same walk (the JAX package gathers them from the step's
// one translation).  The step then runs no other device op for its
// translation, and the layer loop none to prepare its writes.
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
  // n > 0; no intermediate leaves the int32 range
  int q = x / n;
  return (x % n != 0 && x < 0) ? q - 1 : q;
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
  const int* flex;  // (flex_len,), or (flex_len / flex_cols, flex_cols)
  int n_sets, assoc, flex_len, hash_id, p;
  int flex_cols;    // 0: a flat table; else its row length (2-D reads)
};

// The flex entry a miss reads, as JAX indexes the table.  Flat: a negative
// vpn counts from the end once, then the index clamps into the table.
// 2-D (core/translate.py's FlexTable read, table[vpn // cols, vpn % cols]):
// the column is in range by the floor mod; the row counts from the end
// once when negative, then clamps into the rows.  Both agree for vpns
// inside the table.
__device__ __forceinline__ int flex_index(int v, const Tables& T) {
  if (T.flex_cols > 0) {
    const int rows = T.flex_len / T.flex_cols;
    int row = floor_div(v, T.flex_cols);
    row = row < 0 ? row + rows : row;
    row = min(max(row, 0), rows - 1);
    return row * T.flex_cols + floor_mod(v, T.flex_cols);
  }
  int fi = v < 0 ? v + T.flex_len : v;
  return min(max(fi, 0), T.flex_len - 1);
}

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
  const int fi = flex_index(v, T);
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

// The step's geometry, bound once on the host (see StepParams below), and
// the token-split layout of a rank of a (data, model) mesh: G groups, this
// rank's group g, striped (global block b on group b % G at local block
// b / G), TP token shards of a block and this rank's shard m.  One device
// is G = TP = 1, g = m = 0, not striped.
struct Step {
  int batch, nblk, block_size, sink, window;
  int groups, group, striped, tok_shards, tok_index;
};

// A position's block, local to its group in striped mode.
__device__ __forceinline__ int local_block(int p, const Step& S) {
  const int b = floor_div(p, S.block_size);
  return S.striped ? floor_div(b, S.groups) : b;
}

// Output layout of the step entry, in int32 words of one buffer, with
// W = window and N = B * nblk; entry (b, i) is row b's position
// ctx_len[b] + i:
//   [0, 2BW)          w_row    int64 (B, W) flat pool row of the write
//   [2BW, 3BW)        w_slot   (B, W) slot of the write block, -1 unmapped
//   [3BW, 4BW)        w_valid  (B, W) mapped, in range and active
//   [4BW, 5BW)        extent   (B, W) ctx_len + i + 1
//   [5BW, 5BW + 3N)   in_rest, accesses, mapped, (N,) each
//   [5BW + 3N, +N)    slots    (N,)
// At W = 1 this is the decode step's layout.  The telemetry block is what
// the engine fetches, as it lies.  On a rank of the token-split layout a
// write is valid only on the group that owns its block (striped mode),
// and lands only on the token shard that holds its position: its row is
// slot * (bs / TP) + pos % (bs / TP), else the sink's; the extent stays
// the global pos + 1.  At G = TP = 1 every output is the one device's.
__global__ void translate_step_kernel(Tables T, Step S,
                                      const int* __restrict__ ctx_len,
                                      const unsigned char* __restrict__ active,
                                      int* __restrict__ out) {
  const int B = S.batch, W = S.window, n = B * S.nblk, bw = B * W;
  long long* w_row = reinterpret_cast<long long*>(out);
  int* w_slot = out + 2 * bw;
  int* w_valid = w_slot + bw;
  int* extent = w_valid + bw;
  int* in_rest = extent + bw;
  int* accesses = in_rest + n;
  int* mapped = accesses + n;
  int* slots = mapped + n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    // query i is vpn i, block j of row b.  Each window position's write
    // block is one of its row's own grid blocks (the JAX package walks it
    // as an extra query, or gathers it from the walk), so the thread of
    // that block writes the position's outputs too: its context length is
    // loaded beside the walk's loads, and the step costs one memory round
    // trip.
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
    if (j < min(max(local_block(pos, S), 0), S.nblk - 1)) continue;
    const int bs_loc = S.block_size / S.tok_shards;
    for (int k = 0; k < W; ++k) {
      const int p = pos + k;
      const int cur = local_block(p, S);
      if (j != min(max(cur, 0), S.nblk - 1)) continue;
      const int owner = !S.striped
          || floor_mod(floor_div(p, S.block_size), S.groups) == S.group;
      const int valid = r.mapped && cur < S.nblk && act && owner;
      const int tok = floor_mod(p, S.block_size);
      const int e = b * W + k;
      w_slot[e] = r.slot;
      w_valid[e] = valid;
      w_row[e] = (long long)(valid && tok / bs_loc == S.tok_index
                             ? r.slot : S.sink) * bs_loc + tok % bs_loc;
      extent[e] = p + 1;
    }
  }
}

// ---- the sharded step (sharded serving, DESIGN.md §sharded-serving) ----
//
// Replaces the JAX package's `_hybrid_lookup_sharded` and
// `translate_step_sharded` (src/repro/serve/decode.py), which probe a
// shard's local TAR/SF rows and flex range under shard_map and combine the
// shards' verdicts with integer psums.  Here a rank launches the shard
// entry over its local slices, the caller sums its one packed int32
// output over the model group (one all-reduce), and the combine entry
// turns the sums into the step's translation, in the step entry's layout.
// Like the step entry, both are bound by latency: a step's grid is a few
// thousand queries of a few dozen bytes each.

// A rank's shard of the tables and the partition's geometry (the C
// struct ShardParams below, minus the step's fields).
struct Shard {
  int m, spm, vpm;             // this shard, sets and flex vpns per shard
  int rest_slots, fpm, cps;    // for the logical -> physical slot map
};

// core/partition.py's Partition.phys: a logical pool slot -> its
// shard-contiguous physical slot (negative slots pass through).
__device__ __forceinline__ int phys_slot(int slot, int assoc,
                                         const Shard& P) {
  if (slot < 0) return slot;
  if (slot < P.rest_slots) {
    const int i_r = (slot / assoc) / P.spm;
    return i_r * P.cps + (slot - i_r * P.spm * assoc);
  }
  const int f_off = slot - P.rest_slots, i_f = f_off / P.fpm;
  return i_f * P.cps + P.spm * assoc + (f_off - i_f * P.fpm);
}

// The rank's ownership-masked contributions for query i (vpn i), as the
// JAX package's sharded lookup forms them: (hit, way + 1, sf_skipped,
// flex entry + 2), each 0 where this shard does not own the query's set
// (the first three) or its vpn (the last).  Exactly one shard owns each,
// so the sums over the group are the unsharded lookup's verdicts.  Padded
// TAR rows are zero and padded flex entries -1, and the clamped local
// index of a query this shard does not own reads a row whose result is
// masked out.
__global__ void translate_shard_kernel(Tables T, Shard P, int n,
                                       int* __restrict__ contrib) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int s = set_index(i, T.n_sets, T.hash_id, T.p);
    const int tag = i + 1;
    const int mine = floor_div(s, P.spm) == P.m;
    const int loc = min(max(s - P.m * P.spm, 0), P.spm - 1);
    const int mine_f = floor_div(i, P.vpm) == P.m;
    const int fl = min(max(i - P.m * P.vpm, 0), P.vpm - 1);
    // the SF word, the TAR row and the flex entry load together
    const int cnt = __ldg(T.sf + loc);
    const int ent = __ldg(T.flex + fl);
    const int* row = T.tar + (long long)loc * T.assoc;
    int way = -1;
    for (int w = 0; w < T.assoc; ++w)
      if (way < 0 && __ldg(row + w) == tag) way = w;
    const int hit = mine && cnt > 0 && way >= 0;
    contrib[i] = hit;
    contrib[n + i] = hit ? way + 1 : 0;
    contrib[2 * n + i] = mine && cnt <= 0;
    contrib[3 * n + i] = mine_f ? ent + 2 : 0;
  }
}

// The combine: the summed contributions -> the step's translation, in the
// step entry's output layout and with its window, except that `w_row` is
// the row of THIS rank's pool chunk: the write block's physical slot
// rebased to the chunk where this rank owns it, else the chunk's sink
// slot (`S.sink`, the chunk's last slot).  Slots stay logical.
__global__ void combine_shard_kernel(Tables T, Shard P, Step S,
                                     const int* __restrict__ sums,
                                     const int* __restrict__ ctx_len,
                                     const unsigned char* __restrict__ active,
                                     int* __restrict__ out) {
  const int B = S.batch, W = S.window, n = B * S.nblk, bw = B * W;
  long long* w_row = reinterpret_cast<long long*>(out);
  int* w_slot = out + 2 * bw;
  int* w_valid = w_slot + bw;
  int* extent = w_valid + bw;
  int* in_rest = extent + bw;
  int* accesses = in_rest + n;
  int* mapped = accesses + n;
  int* slots = mapped + n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int b = i / S.nblk, j = i - b * S.nblk;
    const int pos = __ldg(ctx_len + b);
    const int act = active == nullptr || __ldg(active + b) != 0;
    const int hit = __ldg(sums + i) > 0;
    const int way = __ldg(sums + n + i) - 1;
    const int skipped = __ldg(sums + 2 * n + i) > 0;
    const int flex_slot = __ldg(sums + 3 * n + i) - 2;
    const int s = set_index(i, T.n_sets, T.hash_id, T.p);
    const int map = hit || flex_slot >= 0;
    const int slot = hit ? s * T.assoc + max(way, 0) : (map ? flex_slot : -1);
    slots[i] = slot;
    in_rest[i] = hit;
    accesses[i] = 1 + (skipped ? 0 : 1) + (hit ? 0 : 1);
    mapped[i] = map;
    if (j < min(max(floor_div(pos, S.block_size), 0), S.nblk - 1)) continue;
    const int ph = phys_slot(slot, T.assoc, P);
    const int own = map && floor_div(ph, P.cps) == P.m;
    for (int k = 0; k < W; ++k) {
      const int p = pos + k;
      const int cur = floor_div(p, S.block_size);
      if (j != min(max(cur, 0), S.nblk - 1)) continue;
      const int valid = map && cur < S.nblk && act;
      const int e = b * W + k;
      w_slot[e] = slot;
      w_valid[e] = valid;
      w_row[e] = (long long)(valid && own ? ph - P.m * P.cps : S.sink)
                 * S.block_size + floor_mod(p, S.block_size);
      extent[e] = p + 1;
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// The step entry's fixed arguments, filled once by the host when the step
// is bound, and passed by address on every call.
struct StepParams {
  int n_sets, assoc, flex_len, hash_id, p;
  int batch, nblk, block_size, sink, window;
  int groups, group, striped, tok_shards, tok_index;
};

int utopia_translate_step_launch(const void* tar, const void* sf,
                                 const void* flex, const void* ctx_len,
                                 const void* active, void* out,
                                 const StepParams* prm, void* stream) {
  Tables T{(const int*)tar, (const int*)sf, (const int*)flex, prm->n_sets,
           prm->assoc, prm->flex_len, prm->hash_id, prm->p, 0};
  Step S{prm->batch,  prm->nblk,  prm->block_size, prm->sink,
         prm->window, prm->groups, prm->group, prm->striped,
         prm->tok_shards, prm->tok_index};
  int total = prm->batch * prm->nblk;
  int blocks = (total + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  translate_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      T, S, (const int*)ctx_len, (const unsigned char*)active, (int*)out);
  return (int)cudaGetLastError();
}

int utopia_rsw_launch(const void* vpns, const void* tar, const void* sf,
                      const void* flex, int n, int n_sets, int assoc,
                      int flex_len, int hash_id, int p, int flex_cols,
                      void* slot, void* in_rest, void* mapped,
                      void* accesses, void* stream) {
  Tables T{(const int*)tar, (const int*)sf, (const int*)flex, n_sets, assoc,
           flex_len, hash_id, p, flex_cols};
  int blocks = (n + kThreads - 1) / kThreads;
  rsw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)vpns, T, n, (int*)slot, (int*)in_rest, (int*)mapped,
      (int*)accesses);
  return (int)cudaGetLastError();
}

// The sharded step's fixed arguments, filled once by the host when the
// step is bound: the tables' hash, the step's geometry (`sink` is the
// rank's chunk's sink slot) and the rank's shard of the partition.
struct ShardParams {
  int n_sets, assoc, hash_id, p;
  int batch, nblk, block_size, sink, window;
  int m, spm, vpm, rest_slots, fpm, cps;
};

static void shard_args(const ShardParams* prm, const void* tar,
                       const void* sf, const void* flex, Tables* T, Shard* P,
                       int* blocks) {
  *T = Tables{(const int*)tar, (const int*)sf, (const int*)flex, prm->n_sets,
              prm->assoc, prm->vpm, prm->hash_id, prm->p, 0};
  *P = Shard{prm->m, prm->spm, prm->vpm, prm->rest_slots, prm->fpm,
             prm->cps};
  int b = (prm->batch * prm->nblk + kThreads - 1) / kThreads;
  *blocks = b < 1 ? 1 : (b > 1024 ? 1024 : b);
}

// The shard entry: tar (spm, assoc), sf (spm,), flex (vpm,) are the rank's
// local slices; `contrib` receives (4, batch * nblk) int32.
int utopia_translate_shard_launch(const void* tar, const void* sf,
                                  const void* flex, void* contrib,
                                  const ShardParams* prm, void* stream) {
  Tables T;
  Shard P;
  int blocks;
  shard_args(prm, tar, sf, flex, &T, &P, &blocks);
  translate_shard_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      T, P, prm->batch * prm->nblk, (int*)contrib);
  return (int)cudaGetLastError();
}

// The combine entry: `sums` is the shard entry's output summed over the
// model group; `out` receives the step entry's layout (StepTranslation).
int utopia_combine_shard_launch(const void* sums, const void* ctx_len,
                                const void* active, void* out,
                                const ShardParams* prm, void* stream) {
  Tables T;
  Shard P;
  int blocks;
  shard_args(prm, nullptr, nullptr, nullptr, &T, &P, &blocks);
  Step S{prm->batch, prm->nblk, prm->block_size, prm->sink, prm->window,
         1, 0, 0, 1, 0};
  combine_shard_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      T, P, S, (const int*)sums, (const int*)ctx_len,
      (const unsigned char*)active, (int*)out);
  return (int)cudaGetLastError();
}

// An empty kernel: the latency floor the step entry is measured against.
int utopia_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
