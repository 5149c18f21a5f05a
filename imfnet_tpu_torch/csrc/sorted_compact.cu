// Sorted-run compaction for voxel quantization (sm_90a).
//
// Replaces the TPU kernel imfnet_tpu/sparse/pallas_quant.py::sorted_compact
// (:122, call :139, body _kernel :55), reached from
// imfnet_tpu/sparse/grid.py::quantize_grid(compact_impl="pallas"). For a
// key-sorted stream (sk, order):
//
//     start[i] = sk[i] != INVALID && sk[i] != (i == 0 ? -1 : sk[i-1])
//     sel[j]   = order[i] for the j-th i with start[i], j < n_out; -1 beyond
//     count    = min(#starts, n_out)
//
// int64 keys (INVALID = 2^63 - 1, sorted last) and int64 rows. The TPU kernel
// walks the stream in order on one core, carries the previous key in SMEM and
// compacts each block with a one-hot matmul. Blocks on Hopper run in no
// order, so the carry becomes a read of the element before each thread's
// rows and the running offset a chained scan across blocks, in ONE launch
// and one pass over sk:
//
//   1  a block takes a ticket (one atomic add); ticket % num_tiles is its
//      tile, so a block only ever waits for tiles whose blocks have started,
//      in whatever order the blocks are scheduled;
//   2  it loads its TILE keys once (16-byte loads, with them the rows'
//      `order` entries, so that no load waits for the scan) and the key
//      before each thread's eight rows, flags the run starts and counts them;
//   3  it publishes the count in its tile's status word, then sums the words
//      of the tiles before it, nearest first, NT of them a round (one a
//      thread), down to the nearest tile that has already published its
//      inclusive prefix (decoupled look-back), and publishes its own;
//   4  it scans its flags in thread order and writes each start's row to its
//      slot; the block of the last tile knows the total, fills the slots
//      from the total up to n_out with -1 and writes the clamped count.
//
// A status word is one 64-bit value: tag (24 bits) | state (2) | count (38),
// written and read whole, so the count needs no ordering against a separate
// flag and relaxed gpu-scope accesses suffice. Nothing is reset between
// calls: the ticket counter only grows, call c of a scratch draws the
// tickets [c * num_tiles, (c + 1) * num_tiles), and a word counts only if
// its tag is that of this call (c + 1; a word left by the call before
// carries c, the zeros of a new scratch 0). So a scratch serves one
// num_tiles and calls that run one after another (one stream, or the nodes
// of one captured graph), every replay of a graph included; the wrapper
// owns the scratch accordingly (sparse/quant_kernel.py).
//
// What bounds it on the H100: bytes, and below them the launch. Each call
// must read sk once (8 bytes a row), order only at the run starts it keeps
// (8 bytes each) and write n_out int64 slots: 3.1 MB at the main path's
// 262 144 rows, 58 858 runs and 65 536 slots, 0.92 us at 3.35 TB/s, less
// than an empty kernel's launch. What the design spends beyond that is one
// chain of dependent round trips to L2: ticket, keys, status words. Timed
// on the H100 (PERF.md): loading and scanning alone take as long as one
// pass of the two-pass kernel this replaces; tiles of 2048 rows beat 1024
// and 4096; a cooperative launch without the ticket was slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 2048;           // rows per block (TILE in quant_kernel.py)
constexpr int NT = 256;              // threads per block
constexpr int PER = TILE / NT;       // rows per thread
constexpr int NW = NT / 32;          // warps per block

static_assert(PER % 2 == 0, "a thread loads its rows as 16-byte pairs");
constexpr long long INVALID = 0x7FFFFFFFFFFFFFFFLL;

typedef unsigned long long u64;

// status word: tag << 40 | state << 38 | count
constexpr int TAG_SHIFT = 40, STATE_SHIFT = 38;
constexpr u64 TAG_MASK = (1ULL << 24) - 1, COUNT_MASK = (1ULL << STATE_SHIFT) - 1;
constexpr u64 AGGREGATE = 1, INCLUSIVE = 2;   // the tile's own count / with all before it


__device__ __forceinline__ void publish(u64* word, u64 tag, u64 state, u64 count) {
  const u64 v = (tag << TAG_SHIFT) | (state << STATE_SHIFT) | count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(word), "l"(v) : "memory");
}

// Spin until the word carries this call's tag; returns it.
__device__ __forceinline__ u64 await(const u64* word, u64 tag) {
  u64 v;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
  } while ((v >> TAG_SHIFT) != tag);
  return v;
}

// One tile: flags and counts its run starts, chains its count to the tiles
// before it through the status words, scatters the starts' rows; the last
// tile also fills the unused slots and writes the count.
__device__ __forceinline__ void compact_tile(
    int tile, u64 tag, const long long* __restrict__ sk,
    const long long* __restrict__ order, long long n, int num_tiles,
    int vector_loads, u64* __restrict__ status, long long* __restrict__ sel,
    long long n_out, int* __restrict__ count) {
  __shared__ int warp_starts[NW];      // run starts of each warp's rows
  __shared__ u64 warp_before[NW];      // look-back: a warp's sum, nearest tiles first
  __shared__ int warp_stop[NW];        // look-back: the warp met an inclusive prefix
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // each thread owns PER consecutive rows, so thread order is stream order.
  // Their `order` entries are loaded with the keys, not after the scan: a
  // row that starts no run costs 8 bytes, a dependent load a round trip.
  const long long row0 = ((long long)tile * NT + tid) * PER;
  long long key[PER], row[PER];
  long long prev = -1;
  if (row0 + PER <= n && vector_loads) {
#pragma unroll
    for (int e = 0; e < PER; e += 2) {
      const longlong2 a = *reinterpret_cast<const longlong2*>(sk + row0 + e);
      const longlong2 b = *reinterpret_cast<const longlong2*>(order + row0 + e);
      key[e] = a.x; key[e + 1] = a.y;
      row[e] = b.x; row[e + 1] = b.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      key[e] = row0 + e < n ? sk[row0 + e] : INVALID;
      row[e] = row0 + e < n ? order[row0 + e] : -1;
    }
  }
  if (row0 > 0 && row0 < n) prev = sk[row0 - 1];
  bool flag[PER];
  int mine = 0;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    flag[e] = key[e] != INVALID && key[e] != prev;   // rows >= n hold INVALID
    prev = key[e];
    mine += flag[e];
  }

  // run starts before this thread within the block
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_starts[warp] = incl;
  __syncthreads();
  int before = 0, block_total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    if (w < warp) before += warp_starts[w];
    block_total += warp_starts[w];
  }
  before += incl - mine;

  // run starts before this tile: the status words of the tiles before it
  u64 exclusive = 0;
  if (tile == 0) {
    if (tid == 0) publish(status, tag, INCLUSIVE, (u64)block_total);
  } else {
    if (tid == 0) publish(status + tile, tag, AGGREGATE, (u64)block_total);
    for (int nearest = tile - 1; nearest >= 0; nearest -= NT) {
      const int p = nearest - tid;      // thread 0 looks at the nearest tile
      u64 v = 0;
      bool stop = false;
      if (p >= 0) {
        const u64 word = await(status + p, tag);
        v = word & COUNT_MASK;
        stop = ((word >> STATE_SHIFT) & 3) == INCLUSIVE;
      }
      // within the warp: the words up to the first inclusive prefix count
      const unsigned stops = __ballot_sync(0xffffffffu, stop);
      const int first = stops ? __ffs(stops) - 1 : 31;
      if (lane > first) v = 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      __syncthreads();                  // the round before has been read
      if (lane == 0) {
        warp_before[warp] = v;
        warp_stop[warp] = stops != 0;
      }
      __syncthreads();
      bool done = false;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (!done) exclusive += warp_before[w];
        done = done || warp_stop[w];
      }
      if (done) break;                  // tile 0 always stops a round
    }
    if (tid == 0)
      publish(status + tile, tag, INCLUSIVE, exclusive + (u64)block_total);
  }

  long long pos = (long long)exclusive + before;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    if (flag[e]) {
      if (pos < n_out) sel[pos] = row[e];
      ++pos;
    }
  }

  if (tile == num_tiles - 1) {
    const long long total = (long long)exclusive + block_total;
    for (long long j = total + tid; j < n_out; j += NT) sel[j] = -1;
    if (tid == 0) *count = (int)(total < n_out ? total : n_out);
  }
}

// state: [0] the ticket counter, which only grows; status words from [1].
__global__ void __launch_bounds__(NT)
compact_single_pass(const long long* __restrict__ sk,
                    const long long* __restrict__ order, long long n,
                    int num_tiles, int vector_loads, u64* __restrict__ state,
                    long long* __restrict__ sel, long long n_out,
                    int* __restrict__ count) {
  __shared__ u64 s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(state, 1ULL);
  __syncthreads();
  const int tile = (int)(s_ticket % (u64)num_tiles);
  const u64 tag = (s_ticket / (u64)num_tiles + 1) & TAG_MASK;
  compact_tile(tile, tag, sk, order, n, num_tiles, vector_loads, state + 1, sel,
               n_out, count);
}

}  // namespace

// sk, order int64 [n] contiguous, sk sorted, n >= 1; num_tiles =
// ceil(n / TILE); state: u64[1 + num_tiles], the ticket counter and the
// status words, zero when new and from then on touched by nothing but this
// kernel, at this num_tiles, one call after another; sel int64 [n_out];
// count int32 [1]. One launch on `stream`; returns cudaGetLastError().
extern "C" int sorted_compact(const void* sk, const void* order, long long n,
                              void* state, int num_tiles, void* sel,
                              long long n_out, void* count, void* stream) {
  const int vector_loads = reinterpret_cast<uintptr_t>(sk) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(order) % 16 == 0;
  compact_single_pass<<<num_tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sk), static_cast<const long long*>(order), n,
      num_tiles, vector_loads, static_cast<u64*>(state),
      static_cast<long long*>(sel), n_out, static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// The id of the capture `stream` is recording into, 0 when it records none,
// -1 on an error: the wrapper gives every captured graph a scratch of its
// own.
extern "C" long long sorted_compact_capture_id(void* stream) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id)
      != cudaSuccess) {
    cudaGetLastError();   // reported here, not by the next launch
    return -1;
  }
  return status == cudaStreamCaptureStatusActive ? (long long)id : 0;
}
