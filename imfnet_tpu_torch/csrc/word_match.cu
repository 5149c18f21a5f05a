// Sorted word-table match for the banded kernel maps (sm_90a).
//
// Replaces the TPU kernel imfnet_tpu/sparse/pallas_word_map.py::
// word_match_planned (:122, call :162, body _kernel :50), reached from
// imfnet_tpu/sparse/grid.py::banded_word_t4(match_impl="pallas") under
// build_pyramid_grid(map_impl="banded"). For every query q[i]:
//
//     out[i] = sum of payload[j] over j with keys[j] == q[i]    (q[i] < 0: 0)
//
// keys int32 [m] sorted, each key at most twice (compact_words' anchor entry
// and its zero-payload companion); payload int32 [m, 4] (bits, bits1, rank,
// rank1); out int32 [n, 4]; zeros where the key is absent. Sums wrap.
//
// The TPU kernel keeps the table in VMEM, plans a 128-aligned key window per
// block of queries and matches by one-hot dots, with an exactness flag for a
// window that is too narrow. Here the table lives in device memory (the
// main path's largest, level 0, is 131 072 entries, 2.6 MB, which stays in
// the 50 MB L2) and every query is searched for in all of its entries in
// use: no window, no planner, no flag.
//
// What bounds it on the H100: bytes. A pyramid's ten maps must read their
// queries (4 bytes each) and the tables' entries in use (20 bytes each, not
// the WORD_PAD tail) once and write 16 bytes a query: 33 MB for the level-0
// k5 map alone (65 536 rows x 25 columns, 32 916 entries in use), 10 us at
// 3.35 TB/s. The nine other maps are small, and a kernel launch costs a
// couple of microseconds whatever it does.
//
// Design:
//  - One launch for up to 16 problems (a pyramid's maps). The problem table
//    (pointers, sizes, each problem's first block) is a kernel parameter by
//    value: nothing is allocated or copied for it, and nothing syncs. A
//    block finds its problem from its index.
//  - The search covers only the entries in use: the kernel reads each
//    problem's count from the device scalar compact_words returns.
//  - A block of 15 warps takes 3 (k5 maps), 5 (k3 maps) or 15 (any other
//    query tensor) chunks of 32 consecutive rows and stages their queries
//    and results in shared memory as they lie in device memory, so its
//    loads and 16-byte stores are contiguous: with no table to search, the
//    level-0 k5 map streams in 10.9 us, its byte bound.
//  - A warp takes one chunk's (dx) group of `group` dy columns, one lane a
//    row. Rows are in scan order and so is the table, so the 32 lanes
//    search neighbouring entries and a load names one or two cache lines,
//    where a warp that holds a row's columns side by side searches five to
//    ten distant parts of the table at once.
//  - The warp first finds, all lanes together, the lower bounds of its least
//    and its greatest key: 32 evenly spaced probes a round, three dependent
//    loads for the 32 916 entries of level 0. Every lane's answers lie
//    between the two, close together since the rows are neighbours.
//  - Inside that bracket a lane finds the lower bounds of its `group` keys
//    in step, by a search without branches whose count of steps depends on
//    the bracket alone: the loads of one step are independent and no lane
//    waits for another.
//    Chosen by measurement (level-0 k5 map, H100 80GB HBM3 at 700 W,
//    chip_smoke.py's kernel phase on each design; PERF.md): one thread a
//    query over the whole table 29.8 us; one thread per (row, dx) group
//    with a gallop from each dy column's position to the next 32.5 us; that
//    gallop with lanes along the rows 25.1 us; lock-step searches of all
//    entries in use 23.8 us; with the warp's bracket first 20.0 us, of
//    which the stream alone is 10.9. What is left over the stream is the
//    searches' instructions, not their loads: one key for every query, all
//    loads hitting one line, takes 17.4 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 15;      // 3 chunks x 5 groups, 5 chunks x 3, or 15 x 1
constexpr int NT = WARPS * 32;
constexpr int MAX_PROBLEMS = 16;
constexpr int TILE = 32 * WARPS * 5;  // queries a block stages at most (3 chunks x 25)
constexpr unsigned MAX_BLOCKS = 1u << 28;  // chunk indices stay 32-bit

struct Problem {
  const int* keys;       // [m] sorted
  const int4* payload;   // [m]
  const int* n_words;    // device scalar: entries in use; null = m
  const int* q;          // [rows, ncol]
  int4* out;             // [rows, ncol]
  long long rows;
  int m;
  int group;             // 5: rows of 25 queries; 3: rows of 9; 1: rows of 1
  unsigned first_block;  // of this problem in the grid
};

struct Problems {
  Problem p[MAX_PROBLEMS];
  int count;
};

// First position in [0, used) whose key is not below `key`, else `used`, found
// by a whole warp for one key: 32 evenly spaced probes a round narrow the
// range to a 33rd, so 32 916 entries take three dependent loads.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys, int used,
                                                int key, int lane) {
  int lo = 0, n = used;  // the position lies in [lo, lo + n]
  while (n >= 32) {
    const int s = n >> 5;  // probe l at lo + (l + 1) * s - 1, all below lo + n
    const bool below = __ldg(keys + lo + (lane + 1) * s - 1) < key;
    const int c = __popc(__ballot_sync(0xffffffffu, below));  // sorted: a prefix
    lo += c * s;
    n = c < 32 ? s - 1 : n - 32 * s;
  }
  const bool below = lane < n && __ldg(keys + lo + lane) < key;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// One block's work on a problem whose rows hold GROUP * GROUP queries: its
// WARPS / GROUP chunks of 32 consecutive rows. The chunks' queries and
// results are staged in shared memory as they lie in device memory, so the
// block's loads and 16-byte stores are contiguous; warp (u, g) takes chunk
// u's column group g, one lane a row.
template <int GROUP>
__device__ __forceinline__ void match_block(const Problem& p, unsigned block,
                                            int* qs, int4* os) {
  constexpr int NCOL = GROUP * GROUP;
  constexpr int CHUNKS = WARPS / GROUP;
  const long long row0 = (long long)block * (32 * CHUNKS);
  const int rows = (int)min((long long)(32 * CHUNKS), p.rows - row0);
  const int total = rows * NCOL;
  const int* __restrict__ q = p.q + row0 * NCOL;
  for (int e = threadIdx.x; e < total; e += NT) qs[e] = __ldg(q + e);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = (warp / GROUP) * 32 + lane;          // in the block's tile
  const int at = row * NCOL + (warp % GROUP) * GROUP;  // the lane's first query
  int key[GROUP];
  bool any = false;
#pragma unroll
  for (int c = 0; c < GROUP; ++c) {
    key[c] = row < rows ? qs[at + c] : -1;
    any |= key[c] >= 0;
  }
  if (__any_sync(0xffffffffu, any)) {
    int used = p.m;
    if (p.n_words != nullptr) used = max(0, min(used, __ldg(p.n_words)));
    const int* __restrict__ keys = p.keys;
    // the warp's least and greatest key, and their lower bounds by a search
    // of the whole warp: every lane's lower bounds lie between them
    int kmin = INT32_MAX, kmax = -1;
#pragma unroll
    for (int c = 0; c < GROUP; ++c) {
      if (key[c] >= 0) kmin = min(kmin, key[c]);
      kmax = max(kmax, key[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
    }
    const int first = warp_lower_bound(keys, used, kmin, lane);
    int n = warp_lower_bound(keys, used, kmax, lane) - first;
    // lower bounds of the lane's GROUP keys in step: the first entry not
    // below key[c] lies in [pos[c], pos[c] + n]
    int pos[GROUP];
#pragma unroll
    for (int c = 0; c < GROUP; ++c) pos[c] = first;
    while (n > 1) {
      const int half = n >> 1;
#pragma unroll
      for (int c = 0; c < GROUP; ++c)
        pos[c] += __ldg(keys + pos[c] + half - 1) < key[c] ? half : 0;
      n -= half;
    }
    if (n == 1) {
#pragma unroll
      for (int c = 0; c < GROUP; ++c) pos[c] += __ldg(keys + pos[c]) < key[c] ? 1 : 0;
    }
#pragma unroll
    for (int c = 0; c < GROUP; ++c) {
      unsigned a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      if (key[c] >= 0) {
        int j = pos[c];
        for (const int end = j + 2; j < end && j < used && __ldg(keys + j) == key[c]; ++j) {
          const int4 v = __ldg(p.payload + j);
          a0 += (unsigned)v.x;
          a1 += (unsigned)v.y;
          a2 += (unsigned)v.z;
          a3 += (unsigned)v.w;
        }
      }
      if (row < rows) os[at + c] = make_int4((int)a0, (int)a1, (int)a2, (int)a3);
    }
  } else if (row < rows) {
#pragma unroll
    for (int c = 0; c < GROUP; ++c) os[at + c] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  int4* __restrict__ out = p.out + row0 * NCOL;
  for (int e = threadIdx.x; e < total; e += NT) out[e] = os[e];
}

__global__ void __launch_bounds__(NT)
word_match_kernel(const __grid_constant__ Problems problems) {
  __shared__ int qs[TILE];
  __shared__ int4 os[TILE];
  int pi = 0;
  while (pi + 1 < problems.count && blockIdx.x >= problems.p[pi + 1].first_block) ++pi;
  const Problem& p = problems.p[pi];
  const unsigned block = blockIdx.x - p.first_block;
  if (p.group == 5) {
    match_block<5>(p, block, qs, os);
  } else if (p.group == 3) {
    match_block<3>(p, block, qs, os);
  } else {
    match_block<1>(p, block, qs, os);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// One problem of word_match_many, as the caller lays it out: keys int32 [m]
// sorted, payload int32 [m, 4] and out int32 [rows, group * group, 4]
// (16-byte aligned), q int32 [rows, group * group], all contiguous; n_words
// a device int32 scalar (entries in use, the rest of the table matching
// nothing) or null for m; group is 1, 3 or 5.
struct WordProblem {
  const void* keys;
  const void* payload;
  const void* n_words;
  const void* q;
  void* out;
  long long rows;
  int m;
  int group;
};

// Launches one kernel for `count` problems (1..16, each with rows > 0) on
// `stream` and returns a CUDA error code (cudaErrorInvalidValue for a count,
// a group or a size out of range).
extern "C" int word_match_many(const WordProblem* problems, int count, void* stream) {
  if (count < 1 || count > MAX_PROBLEMS) return static_cast<int>(cudaErrorInvalidValue);
  Problems table;
  table.count = count;
  unsigned long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const WordProblem& w = problems[i];
    if ((w.group != 1 && w.group != 3 && w.group != 5) || w.rows < 1 || w.m < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    Problem& p = table.p[i];
    p.keys = static_cast<const int*>(w.keys);
    p.payload = static_cast<const int4*>(w.payload);
    p.n_words = static_cast<const int*>(w.n_words);
    p.q = static_cast<const int*>(w.q);
    p.out = static_cast<int4*>(w.out);
    p.rows = w.rows;
    p.m = w.m;
    p.group = w.group;
    p.first_block = (unsigned)blocks;
    const long long block_rows = 32 * (WARPS / w.group);
    blocks += (unsigned long long)((w.rows + block_rows - 1) / block_rows);
    if (blocks > MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidValue);
  }
  word_match_kernel<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `stream`: what a launch costs before any work, for the
// measurement scripts.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
