// 6-D kernel-map builder, kernel E (sm_90a).
//
// Builds the dense int32 maps of a 6-D coordinate pyramid (eval/dgr.py's
// correspondence tensors): for every output row i and kernel offset c of a
// problem,
//
//     out[i, c] = the least table row whose key equals key[i] + scale * delta[c],
//                 or -1                      (key[i] a sentinel: -1, no probe)
//
// with the keys of sparse/coords.py::make_keys (an in-range 6-D row's key plus
// an offset's key delta is the neighbour's key, no borrow or carry: KEY6_MARGIN).
// Keys at or above PAD_QUERY_KEY (2^63 - 2) are sentinels: padding rows, rows
// out of the key's range. It replaces, on the card, the chain of
// sparse/kernel_map.py::offset_map6_plain (int64 query keys, torch.searchsorted's
// int64 positions, a clamp, a gather, a compare, a where and an int32 copy into a
// strided slice: about 100-120 bytes of traffic an entry). It replaces no TPU
// kernel: the JAX package's maps are 3-D, found by a binary search in XLA
// (imfnet_tpu/sparse/coords.py::lookup).
//
// What bounds it on the H100: the maps' bytes. DGR's pyramid writes 10 maps of
// 131 072 x 729 int32, 3.82 GB, 1.14 ms at 3.35 TB/s; the level tables add
// under 5 MB of reads.
//
// Design:
//  - One open-addressed hash a level table, built once and read by every map
//    that searches that level (its own "same" map, the finer level's "up" and
//    the coarser level's "down"). A bucket is one 32-byte sector of four int64
//    keys; its rows (uint32) lie in a second array, read on a hit alone. A
//    key's home bucket is Fibonacci hashing of its prefix, the key without its
//    last two axes' fields (key >> 20). Linear probing over buckets; at least
//    4 slots a table row (load <= 0.25), so a miss, 99.75 % of DGR's queries,
//    reads one bucket.
//  - Insertion claims a slot by atomicCAS, slot 0 first; an equal key already
//    there keeps the least row (atomicMin), as searchsorted's left bound does in
//    a sorted table. Slots fill in order, so a bucket is full when its last slot
//    is, and which buckets are full does not depend on the order of insertion
//    (linear probing's occupied cells do not). A lookup reads buckets from its
//    home to the first one that is not full: its result and its count of reads
//    are the same whatever order the racing inserts took.
//  - One launch inserts every table, one launch writes every map (up to 16, in
//    the way kernel D's word_match_many groups its problems). Persistent blocks
//    take tiles of 16 rows x 729 columns (a wider row in chunks of 729) in a
//    grid-stride order; a tile's row keys and its columns' scaled deltas are
//    read once into shared memory. A thread takes a group of 9 columns of one
//    row: in the product order of the k3 offsets they differ in the last two
//    axes alone, so one home bucket serves them, and an entry is matched on
//    the low 20 bits of the home's keys of its prefix. The tile's results are
//    staged in shared memory and written with 16-byte streaming (evict-first)
//    stores, so the 3.8 GB of maps do not push the hashes out of L2. A tile of
//    sentinel rows alone streams -1s.
//  - The scratch (hashes) and the two counters are reset by memsets inside each
//    call: a CUDA graph replays them; nothing is allocated and nothing syncs.
//  - Counters on the card: words[0] the queries probed (entries of live rows),
//    words[1] the buckets they read (a home bucket counted once an entry), for
//    sparse/map6_kernel.py's map6.queries and map6.probes.
//
//    Chosen by measurement (DGR's ten maps at 131 072 rows, 67 000 valid;
//    H100 80GB HBM3 at 700 W, graph-timed; PERF.md): 2.21 ms against the
//    1.14 ms bound, the -1s alone streaming in 1.38 ms, the plain chain 67.4.
//    A thread taking 4 consecutive entries, its last home kept in registers
//    for the next entry of its prefix, 2.76 ms (lanes of a warp diverge
//    between a probe and a reuse); a lane an entry, every home read, 3.4-5.4
//    ms; tiles of 8 or 32 rows 2.44 / 2.72 ms; the homes of 2-3 groups
//    loaded at once 3.3-4.1 ms. What is left over the stores is the 51 M
//    scattered home sectors: every home at one address takes 1.68 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 4;                  // keys a bucket: one 32-byte sector
constexpr int DROP_BITS = 20;             // the last two axes' fields, out of the prefix
constexpr unsigned long long EMPTY = ~0ull;
constexpr long long SENTINEL = 0x7FFFFFFFFFFFFFFELL;  // PAD_QUERY_KEY; PAD_TABLE_KEY above
constexpr unsigned long long GOLDEN = 0x9E3779B97F4A7C15ull;
constexpr int MAX_TABLES = 8;
constexpr int MAX_PROBLEMS = 16;
constexpr int NT = 256;
constexpr int GROUP = 9;                 // columns a thread takes: the last two axes' offsets
constexpr int CHUNK = 729;               // columns of a tile at most, a multiple of GROUP
constexpr int TILE_INTS = 16 * CHUNK;    // results of a tile, staged in shared memory
constexpr int MAX_TILE_ROWS = 64;
constexpr int SMEM_BYTES = TILE_INTS * 4 + CHUNK * 8;
constexpr int BLOCKS_PER_SM = 4;         // as many as the shared memory holds

struct Table {
  const long long* keys;        // [rows] make_keys of the level table
  unsigned long long* hkeys;    // [buckets * SLOTS], EMPTY where free
  unsigned* hrows;              // [buckets * SLOTS], the least row of the slot's key
  long long rows;
  int log2_buckets;             // 1..28
  unsigned first_block;         // of this table in the insert grid
};

struct Tables {
  Table t[MAX_TABLES];
  int count;
};

struct Problem {
  const long long* qkeys;       // [rows] the output rows' keys
  const long long* deltas;      // [k] key deltas of the offsets at scale 1
  int* out;                     // [rows, k]
  long long rows;
  long long scale;
  int k;
  int table;
  int tile_rows;                // rows of a tile: TILE_INTS / width, at most MAX_TILE_ROWS
  int width;                    // columns of a tile: min(k, CHUNK)
  int chunks;                   // tiles across a row
  unsigned first_tile;          // of this problem in the tile order
};

struct Problems {
  Problem p[MAX_PROBLEMS];
  int count;
  unsigned tiles;
};

__device__ __forceinline__ unsigned home_bucket(unsigned long long key, int log2_buckets) {
  return static_cast<unsigned>(((key >> DROP_BITS) * GOLDEN) >> (64 - log2_buckets));
}

__global__ void __launch_bounds__(NT) map6_insert(const __grid_constant__ Tables tables) {
  int ti = 0;
  while (ti + 1 < tables.count && blockIdx.x >= tables.t[ti + 1].first_block) ++ti;
  const Table& t = tables.t[ti];
  const long long r = static_cast<long long>(blockIdx.x - t.first_block) * NT + threadIdx.x;
  if (r >= t.rows) return;
  const long long key = __ldg(t.keys + r);
  if (key >= SENTINEL) return;
  const unsigned long long k = static_cast<unsigned long long>(key);
  const unsigned mask = (1u << t.log2_buckets) - 1u;
  unsigned b = home_bucket(k, t.log2_buckets);
  for (;;) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const size_t at = static_cast<size_t>(b) * SLOTS + s;
      const unsigned long long old = atomicCAS(t.hkeys + at, EMPTY, k);
      if (old == EMPTY || old == k) {
        atomicMin(t.hrows + at, static_cast<unsigned>(r));
        return;
      }
    }
    b = (b + 1u) & mask;
  }
}

// The least row of key q in table t, or -1: the buckets from q's home to
// the first that is not full, each counted in `probes`.
__device__ __forceinline__ int lookup(const Table& t, unsigned long long q,
                                      unsigned long long& probes) {
  const unsigned mask = (1u << t.log2_buckets) - 1u;
  unsigned b = home_bucket(q, t.log2_buckets);
  long long slot = -1;
  for (;;) {
    const ulonglong2* at =
        reinterpret_cast<const ulonglong2*>(t.hkeys + static_cast<size_t>(b) * SLOTS);
    const ulonglong2 lo = __ldg(at), hi = __ldg(at + 1);
    ++probes;
    const unsigned long long k[SLOTS] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (k[s] == q) slot = static_cast<long long>(b) * SLOTS + s;
    if (k[SLOTS - 1] == EMPTY) break;  // slots fill in order: this bucket is not full
    b = (b + 1u) & mask;
  }
  return slot < 0 ? -1 : static_cast<int>(__ldg(t.hrows + slot));
}

// The n <= GROUP entries of one group: key + deltas[j] for each j. In the
// product order of the k3 offsets a group's columns differ in the last two
// axes alone, so they share a prefix and one home bucket, read once; where
// it is not full, an entry of that prefix is found by the low 20 bits of
// the home's keys of that prefix. An entry of another prefix, or of a full
// home, takes lookup.
__device__ __forceinline__ void lookup_group(const Table& t, long long key,
                                             const long long* deltas, int n, int* dst,
                                             unsigned long long& probes) {
  const unsigned long long q0 = key + deltas[0];
  const unsigned long long prefix = q0 >> DROP_BITS;
  const unsigned bucket = home_bucket(q0, t.log2_buckets);
  const ulonglong2* at =
      reinterpret_cast<const ulonglong2*>(t.hkeys + static_cast<size_t>(bucket) * SLOTS);
  const ulonglong2 lo = __ldg(at), hi = __ldg(at + 1);
  if (hi.y != EMPTY) {
    for (int j = 0; j < n; ++j)
      dst[j] = lookup(t, static_cast<unsigned long long>(key + deltas[j]), probes);
    return;
  }
  constexpr unsigned LOW = (1u << DROP_BITS) - 1u;
  const unsigned long long k[SLOTS] = {lo.x, lo.y, hi.x, hi.y};
  unsigned low[SLOTS];  // a value no low 20 bits take, for a key of another prefix
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    low[s] = (k[s] >> DROP_BITS) == prefix ? static_cast<unsigned>(k[s]) & LOW : ~0u;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    if (j < n) {
      const unsigned long long q = key + deltas[j];
      int v = -1;
      if ((q >> DROP_BITS) != prefix) {
        v = lookup(t, q, probes);
      } else {
        ++probes;
        const unsigned lq = static_cast<unsigned>(q) & LOW;
        if (low[0] == lq || low[1] == lq || low[2] == lq || low[3] == lq) {
          int s = 0;
          while (low[s] != lq) ++s;
          v = static_cast<int>(__ldg(t.hrows + static_cast<size_t>(bucket) * SLOTS + s));
        }
      }
      dst[j] = v;
    }
  }
}

// Writes n entries at out, each staged[e] (or -1 with no staging), as
// 16-byte streaming stores where out is aligned, 4-byte ones at the ends.
__device__ __forceinline__ void stream_out(int* __restrict__ out, int n, const int* staged) {
  const int head = min(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4));
  if (static_cast<int>(threadIdx.x) < head) __stcs(out + threadIdx.x, staged ? staged[threadIdx.x] : -1);
  const int body = (n - head) & ~3;
  const bool whole = staged && (reinterpret_cast<uintptr_t>(staged + head) & 15) == 0;
  for (int e = head + threadIdx.x * 4; e < head + body; e += NT * 4) {
    const int4 v = !staged ? make_int4(-1, -1, -1, -1)
                   : whole ? *reinterpret_cast<const int4*>(staged + e)
                           : make_int4(staged[e], staged[e + 1], staged[e + 2], staged[e + 3]);
    __stcs(reinterpret_cast<int4*>(out + e), v);
  }
  const int e = head + body + threadIdx.x;
  if (e < n) __stcs(out + e, staged ? staged[e] : -1);
}

__global__ void __launch_bounds__(NT)
map6_probe(const __grid_constant__ Tables tables, const __grid_constant__ Problems problems,
           unsigned long long* __restrict__ words) {
  extern __shared__ __align__(16) int dyn[];
  int* staged = dyn;                                                 // [TILE_INTS]
  long long* deltas = reinterpret_cast<long long*>(dyn + TILE_INTS);  // [CHUNK], scaled
  __shared__ long long row_keys[MAX_TILE_ROWS];
  __shared__ unsigned long long reduce[2][NT / 32];
  unsigned long long queries = 0, probes = 0;
  for (unsigned tile = blockIdx.x; tile < problems.tiles; tile += gridDim.x) {
    int pi = 0;
    while (pi + 1 < problems.count && tile >= problems.p[pi + 1].first_tile) ++pi;
    const Problem& p = problems.p[pi];
    const Table& t = tables.t[p.table];
    const unsigned at = tile - p.first_tile;
    const long long row0 = static_cast<long long>(at / p.chunks) * p.tile_rows;
    const int col0 = static_cast<int>(at % p.chunks) * p.width;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.rows - row0));
    const int cols = min(p.width, p.k - col0);
    int* __restrict__ out = p.out + row0 * p.k + col0;
    const bool flat = cols == p.k;                       // the tile's rows lie end to end
    __syncthreads();  // the last tile's row keys, deltas and results are read
    int live = 0;
    if (static_cast<int>(threadIdx.x) < p.tile_rows) {
      const long long key =
          static_cast<int>(threadIdx.x) < rows ? __ldg(p.qkeys + row0 + threadIdx.x) : SENTINEL;
      row_keys[threadIdx.x] = key;
      live = key < SENTINEL;
    }
    if (!__syncthreads_or(live)) {
      if (flat) {
        stream_out(out, rows * cols, nullptr);
      } else {
        for (int r = 0; r < rows; ++r) stream_out(out + static_cast<long long>(r) * p.k, cols, nullptr);
      }
      continue;
    }
    for (int c = threadIdx.x; c < cols; c += NT) deltas[c] = p.scale * __ldg(p.deltas + col0 + c);
    __syncthreads();
    // a thread a group of GROUP columns of one row
    const int per_row = (cols + GROUP - 1) / GROUP;
    for (int g = threadIdx.x; g < rows * per_row; g += NT) {
      const int r = g / per_row, c0 = (g - r * per_row) * GROUP;
      const int n = min(GROUP, cols - c0);
      const long long key = row_keys[r];
      int* dst = staged + r * cols + c0;
      if (key >= SENTINEL) {
        for (int j = 0; j < n; ++j) dst[j] = -1;
      } else {
        queries += n;
        lookup_group(t, key, deltas + c0, n, dst, probes);
      }
    }
    __syncthreads();
    if (flat) {
      stream_out(out, rows * cols, staged);
    } else {
      for (int r = 0; r < rows; ++r)
        stream_out(out + static_cast<long long>(r) * p.k, cols, staged + r * cols);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    queries += __shfl_down_sync(0xffffffffu, queries, o);
    probes += __shfl_down_sync(0xffffffffu, probes, o);
  }
  if (lane == 0) {
    reduce[0][warp] = queries;
    reduce[1][warp] = probes;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    for (int w = 0; w < NT / 32; ++w) {
      a += reduce[0][w];
      b += reduce[1][w];
    }
    if (a) atomicAdd(words, a);
    if (b) atomicAdd(words + 1, b);
  }
}

int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace

// One level table, as the caller lays it out: keys int64 [rows] (make_keys;
// sentinels at or above PAD_QUERY_KEY are not inserted), its hash in the
// scratch: hkeys uint64 [2^log2_buckets * 4] (32-byte aligned) and hrows
// uint32 [2^log2_buckets * 4]; log2_buckets in 1..28.
struct Map6Table {
  const void* keys;
  void* hkeys;
  void* hrows;
  long long rows;
  int log2_buckets;
};

// One map: qkeys int64 [rows] (the output rows' keys; sentinel rows give -1s),
// deltas int64 [k] (the offsets' key deltas at scale 1, multiplied by scale),
// out int32 [rows, k], the table it searches by index.
struct Map6Problem {
  const void* qkeys;
  const void* deltas;
  void* out;
  long long rows;
  long long scale;
  int k;
  int table;
};

// Resets the scratch [scratch, scratch + scratch_bytes) to 0xFF (every slot
// free) and words uint64 [2] to 0, inserts every table (one launch), then
// writes every map (one launch), on `stream`. Returns a CUDA error code
// (cudaErrorInvalidValue for a count, size, index or alignment out of range).
extern "C" int map6_many(const Map6Table* tables, int ntables, const Map6Problem* problems,
                         int nproblems, void* scratch, long long scratch_bytes, void* words,
                         void* stream) {
  if (ntables < 1 || ntables > MAX_TABLES || nproblems < 0 || nproblems > MAX_PROBLEMS ||
      scratch_bytes < 0 || reinterpret_cast<uintptr_t>(words) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables tt;
  tt.count = ntables;
  unsigned long long blocks = 0;
  for (int i = 0; i < ntables; ++i) {
    const Map6Table& m = tables[i];
    if (m.rows < 0 || m.log2_buckets < 1 || m.log2_buckets > 28 ||
        reinterpret_cast<uintptr_t>(m.hkeys) % 32 != 0 ||
        reinterpret_cast<uintptr_t>(m.hrows) % 16 != 0 ||
        (1ll << m.log2_buckets) * SLOTS < m.rows)
      return static_cast<int>(cudaErrorInvalidValue);
    Table& t = tt.t[i];
    t.keys = static_cast<const long long*>(m.keys);
    t.hkeys = static_cast<unsigned long long*>(m.hkeys);
    t.hrows = static_cast<unsigned*>(m.hrows);
    t.rows = m.rows;
    t.log2_buckets = m.log2_buckets;
    t.first_block = static_cast<unsigned>(blocks);
    blocks += static_cast<unsigned long long>((m.rows + NT - 1) / NT);
    if (blocks >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  Problems pp;
  pp.count = nproblems;
  unsigned long long tiles = 0;
  for (int i = 0; i < nproblems; ++i) {
    const Map6Problem& m = problems[i];
    if (m.rows < 1 || m.k < 1 || m.table < 0 || m.table >= ntables ||
        reinterpret_cast<uintptr_t>(m.out) % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    Problem& p = pp.p[i];
    p.qkeys = static_cast<const long long*>(m.qkeys);
    p.deltas = static_cast<const long long*>(m.deltas);
    p.out = static_cast<int*>(m.out);
    p.rows = m.rows;
    p.scale = m.scale;
    p.k = m.k;
    p.table = m.table;
    p.width = m.k < CHUNK ? m.k : CHUNK;
    p.tile_rows = TILE_INTS / p.width < MAX_TILE_ROWS ? TILE_INTS / p.width : MAX_TILE_ROWS;
    p.chunks = (m.k + CHUNK - 1) / CHUNK;
    p.first_tile = static_cast<unsigned>(tiles);
    tiles += static_cast<unsigned long long>((m.rows + p.tile_rows - 1) / p.tile_rows) * p.chunks;
    if (tiles >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  pp.tiles = static_cast<unsigned>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(words, 0, 2 * sizeof(unsigned long long), s);
  if (e == cudaSuccess && scratch_bytes > 0) e = cudaMemsetAsync(scratch, 0xFF, scratch_bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks > 0) map6_insert<<<static_cast<unsigned>(blocks), NT, 0, s>>>(tt);
  if (tiles > 0) {
    static bool sized = false;
    if (!sized) {
      e = cudaFuncSetAttribute(map6_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (e != cudaSuccess) return static_cast<int>(e);
      sized = true;
    }
    const unsigned long long grid = static_cast<unsigned long long>(multiprocessors()) * BLOCKS_PER_SM;
    map6_probe<<<static_cast<unsigned>(tiles < grid ? tiles : grid), NT, SMEM_BYTES, s>>>(
        tt, pp, static_cast<unsigned long long*>(words));
  }
  return static_cast<int>(cudaGetLastError());
}
