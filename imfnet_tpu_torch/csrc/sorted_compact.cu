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
// order, so the carry becomes a read of the element before each tile and the
// running offset becomes a second pass:
//
//   pass 1  one block per tile of TILE rows counts the tile's run starts;
//   pass 2  one block per tile sums the counts of the tiles before it (and of
//           all tiles, for the total), scans its tile's flags in order and
//           writes each start's row to its slot; the slots from the total up
//           to n_out get -1, and block 0 writes the count.
//
// What bounds it on the H100: bytes. Each call must read sk once (8 bytes a
// row), order only at the run starts it keeps (8 bytes each) and write n_out
// int64 slots: 3.1 MB at the main path's 262 144 rows, 58 858 runs and
// 65 536 slots, 0.92 us at 3.35 TB/s. Pass 2 reads sk again (8 bytes a row,
// from L2 at this size) and each block reads the tile counts (1 KB at 256
// tiles); the rest is two launches' fixed cost, which at this size
// outweighs the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;           // rows per block (TILE in quant_kernel.py)
constexpr int NT = 256;              // threads per block
constexpr int PER = TILE / NT;       // rows per thread
constexpr int NW = NT / 32;          // warps per block
constexpr long long INVALID = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ bool is_start(const long long* __restrict__ sk,
                                         long long i) {
  const long long k = sk[i];
  const long long prev = i == 0 ? -1LL : sk[i - 1];
  return k != INVALID && k != prev;
}

// Sum over the block; every thread gets the result.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[w];
  return s;
}

// Exclusive prefix sum over the block in thread order.
__device__ __forceinline__ int block_exclusive_scan(int v, int* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += red[w];
  return before + incl - v;
}

__global__ void __launch_bounds__(NT)
count_starts(const long long* __restrict__ sk, long long n,
             int* __restrict__ tile_counts) {
  __shared__ long long red[NW];
  const long long base = (long long)blockIdx.x * TILE;
  long long c = 0;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const long long i = base + e * NT + threadIdx.x;  // coalesced
    if (i < n) c += is_start(sk, i);
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = (int)c;
}

__global__ void __launch_bounds__(NT)
scatter_starts(const long long* __restrict__ sk,
               const long long* __restrict__ order, long long n,
               const int* __restrict__ tile_counts, int num_tiles,
               long long* __restrict__ sel, int n_out,
               int* __restrict__ count) {
  __shared__ long long red64[NW];
  __shared__ int red32[NW];
  long long before = 0, total = 0;
  for (int t = threadIdx.x; t < num_tiles; t += NT) {
    const long long c = tile_counts[t];
    total += c;
    if (t < (int)blockIdx.x) before += c;
  }
  before = block_sum(before, red64);
  total = block_sum(total, red64);

  // each thread owns PER consecutive rows, so thread order is stream order
  const long long row0 = (long long)blockIdx.x * TILE + threadIdx.x * PER;
  bool flag[PER];
  int local = 0;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    flag[e] = row0 + e < n && is_start(sk, row0 + e);
    local += flag[e];
  }
  long long pos = before + block_exclusive_scan(local, red32);
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    if (flag[e]) {
      if (pos < n_out) sel[pos] = order[row0 + e];
      ++pos;
    }
  }
  const long long stride = (long long)gridDim.x * NT;
  for (long long j = total + (long long)blockIdx.x * NT + threadIdx.x; j < n_out;
       j += stride)
    sel[j] = -1;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *count = (int)(total < n_out ? total : n_out);
}

}  // namespace

// sk, order int64 [n] contiguous, sk sorted; tile_counts int32 [num_tiles]
// scratch with num_tiles = ceil(n / TILE) >= 1; sel int64 [n_out]; count
// int32 [1]. Launches both passes on `stream` and returns cudaGetLastError().
extern "C" int sorted_compact(const void* sk, const void* order, long long n,
                              void* tile_counts, int num_tiles, void* sel,
                              int n_out, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(sk);
  int* tc = static_cast<int*>(tile_counts);
  count_starts<<<num_tiles, NT, 0, s>>>(k, n, tc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_starts<<<num_tiles, NT, 0, s>>>(
      k, static_cast<const long long*>(order), n, tc, num_tiles,
      static_cast<long long*>(sel), n_out, static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
