// Flash nearest-neighbour search (sm_90a).
//
// Replaces the TPU kernel imfnet_tpu/match/pallas_nn.py::nn_pallas (:54,
// call :84, body _nn_kernel :25): for each query, the nearest valid
// reference and its squared distance, without ever writing the [N, M]
// distance matrix to device memory.
//
//     idx[i] = argmin_j (|r_j|^2 - 2 q_i . r_j)   over valid j,
//     d2[i]  = max(best + |q_i|^2, 0)
//
// Invalid references carry |r|^2 = +inf; ties go to the lowest index; when
// every reference is invalid the result is index 0 and distance +inf, as in
// both JAX versions. Everything is f32 on the CUDA cores (no TF32, no bf16)
// so that indices agree with the plain version; each dot is summed over
// c = 0 .. D-1 in that order with fmaf.
//
// What bounds it on the H100: the 5000 x 5000 x 32 descriptor matching of the
// main path is 2*N*M*D = 1.6 GFLOP on 1.3 MB of input, so it is bound by
// operations, at the f32 CUDA-core rate (24 us a call at 67 TFLOP/s): the
// inner loop must be nearly all FFMA, and all 132 SMs must have work.
//
// Design, two CUDA kernels a call:
//  1. A pre-pass lays queries and references k-major in scratch that the
//     wrapper allocates, [D + 1][rows padded to 128]: row c holds component c
//     of every row, row D the squared norm, with +inf for a reference that is
//     invalid or past the end. Padding rows are zeros (norm +inf for
//     references), so the main kernel has no ragged edge to mask but the
//     final store.
//  2. The main kernel gives a block of GY x GX threads a tile of GY*TQ
//     queries and walks tiles of GX*TR references, each thread a TQ x TR
//     micro-tile of dots in registers. Both tiles sit k-major in shared
//     memory, so one step of k reads a thread's TQ query and TR reference
//     values as 16-byte loads: 4 loads for 64 fmaf at TQ = TR = 8, and the
//     loads of step k + 1 are issued before step k's products. A warp is
//     4 x 8 threads, so its loads name 4 and 8 distinct 16-byte words.
//     Reference tiles (their norms with them) stream through a ring of three
//     stages by 16-byte cp.async, the next tiles loading while this one is
//     multiplied, one __syncthreads a tile. After a tile's D steps each
//     thread folds its TQ x TR products into TQ running (d, index) pairs,
//     references in increasing index with a strict `<`; the GX threads of a
//     query row merge by (d, index) once, after the block's last tile.
//  3. 5000 queries are 79 tiles of 64, too few blocks of four warps to keep
//     132 SMs busy: the reference tiles are split over the `split` blocks
//     of a thread-block cluster (part p takes tiles [p*T/split,
//     (p+1)*T/split)), and after a cluster barrier the parts' (d, index)
//     pairs are merged by (distance, lowest index) through distributed
//     shared memory in rank order: no atomics, no second pass, two calls
//     bit-equal.
// match/nn_kernel.py::nn_plan chooses the instance and the split from the
// shape; chip_smoke.py sweeps them all (PERF.md has the table).
//
// Valid spans. A caller pads its rows to a fixed capacity (eval-kitti's
// 131 072 a side hold about 67 000 voxels, a prefix), and one CUDA graph
// replays every pair whatever its counts, so the work is bounded on the
// device, inside the call's own launches, with no host read:
//  - the call's words (8 ints the wrapper allocates, cleared by a memset at
//    the call's start) receive from the pre-pass the span of the valid
//    queries, [q_lo, q_hi), and of the valid references, [r_lo, r_hi): the
//    lowest and one past the highest valid row, reduced a warp at a time
//    into two atomicMax words each (n_pad - lowest, highest + 1; 0: none);
//  - a block whose query tile lies wholly outside [q_lo, q_hi) writes
//    (0, +inf) and leaves; the others walk only the reference tiles that
//    overlap [r_lo, r_hi), split over the cluster's parts as [0, T) was.
//    Tiles outside hold no valid reference, which could never be chosen,
//    so no valid query's answer changes; with every row valid the spans
//    are the whole range and each block walks the tiles it walked before;
//  - a query that is not valid gets (0, +inf) at the store;
//  - each walking block adds the query rows x reference rows its tiles
//    cover to a 64-bit tally in words 4-5, which the host reads only while
//    it traces (match/nn_kernel.py, utils/timer.py::count_device).
//
// D = 3 (the positive search of a training step, ICP's 30 calls a KITTI
// pair, compute-overlap) is bound by the fold, not the dot: a pair's dot is
// 3 FFMA, while folding it into a running (d, index) costs an fmaf, a
// compare and two selects, so the kernel above ran at 3.4-3.5x the bound
// there, which counts the dot alone; it now serves D = 32 only. The min
// fold (flash_nn3_kernel, D = 3) keeps the pair's work at 4 instructions, a
// floor near 4/3 of the bound:
//  - the distance is accumulated directly, d = |r|^2 + sum_c (-2 q_c) r_c,
//    three fmaf from the reference's norm, with the queries pre-scaled by
//    -2 (exact) and held in registers for the whole walk;
//  - each (query, thread column) keeps only its running minimum, one fminf
//    a pair, and, once per reference tile, the last tile that lowered it
//    (strictly: an equal value in a later tile does not move it);
//  - after the walk each thread re-walks that one tile's TR references from
//    device memory in increasing index, evaluating d by the same three fmaf,
//    and takes the first whose d equals the minimum: the lowest index of the
//    column at that distance, as the (d, index) fold gives;
//  - the columns, then the cluster's parts, merge by (d, index) as above.
// The distance rounds differently from the (d, index) fold (three roundings
// against one), so near-tie choices are held to their exact distances.
//
// Every other width (a model_n_out other than 32: 16, 64, 256, ...) takes the
// chunk fold (flash_nnk_kernel, D a runtime value): the TPU kernel pads D to
// a multiple of 8 (pallas_nn.py:71), and so does this one's pre-pass
// (nn_transpose_any_kernel), whose zero columns leave every |r|^2 - 2 q.r
// unchanged. The contraction runs over the padded width DP in chunks of KC =
// 8 rows: a ring stage holds one chunk of the query tile and of the
// reference tile (and, with a tile's last chunk, the references' norms), so
// shared memory is the same at every D, where the pair fold keeps the whole
// (D + 1) x BQ query tile. Each thread's TQ x TR dots stay in registers
// across a tile's chunks, summed over c = 0 .. DP-1 in order by fmaf as in
// the pair fold (at D = 32 the two are bit-equal), then fold into (d, index)
// and merge across threads and the cluster exactly as the pair fold does.
// Queries are re-read from L2 for every reference tile: right before fast.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int PAD = 128;     // scratch rows are padded to a multiple of this
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int MAX_SPLIT = 8; // portable thread-block cluster size
constexpr int PRE_NT = 128;  // threads of a pre-pass block (divides PAD)
constexpr int K_UNROLL = 8;  // k steps unrolled together (even: the operand
                             // registers alternate)
constexpr int KC = 8;        // the chunk fold's rows of the contraction a stage
                             // holds; D is padded to a multiple of it
constexpr int WORDS = 8;     // ints of a call's words: the query span's two, the
                             // reference span's two, the 64-bit tally, two spare

// Row j of the queries (is_ref false) or the references is valid: inside
// its count and, with a mask, marked in it.
__device__ __forceinline__ bool row_valid(const uint8_t* mask, int j, int rows) {
  return j < rows && (mask == nullptr || mask[j] != 0);
}

// The pre-pass's share of the spans: a warp's valid rows, all of one
// operand (PRE_NT divides the padding), into the operand's two words with
// one atomicMax each: pad - the lowest row, and the highest row + 1.
__device__ __forceinline__ void reduce_span(int* words, bool is_ref, bool ok, int j,
                                            int pad) {
  const unsigned lo = __reduce_max_sync(0xffffffffu, ok ? (unsigned)(pad - j) : 0u);
  const unsigned hi = __reduce_max_sync(0xffffffffu, ok ? (unsigned)(j + 1) : 0u);
  if ((threadIdx.x & 31) == 0 && hi != 0u) {
    int* w = words + (is_ref ? 2 : 0);
    atomicMax(w, (int)lo);
    atomicMax(w + 1, (int)hi);
  }
}

// Pre-pass: thread j transposes row j of q (j < n_pad) or of r into the
// k-major scratch, writes its squared norm into row D, and adds the row to
// its operand's valid span.
template <int D>
__global__ void __launch_bounds__(PRE_NT)
nn_transpose_kernel(const float* __restrict__ q, const float* __restrict__ r,
                    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ qvalid,
                    int n, int m, int n_pad, int m_pad, float* __restrict__ qt,
                    float* __restrict__ rt, int* __restrict__ words) {
  int j = blockIdx.x * PRE_NT + threadIdx.x;
  const bool is_ref = j >= n_pad;
  if (is_ref) j -= n_pad;
  const float* src = is_ref ? r : q;
  float* dst = is_ref ? rt : qt;
  const int rows = is_ref ? m : n;
  const int pad = is_ref ? m_pad : n_pad;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float v = j < rows ? __ldg(src + (size_t)j * D + c) : 0.f;
    dst[(size_t)c * pad + j] = v;
    s = fmaf(v, v, s);
  }
  const bool ok = row_valid(is_ref ? valid : qvalid, j, rows);
  if (is_ref) s = ok ? s : INFINITY;
  dst[(size_t)D * pad + j] = s;
  reduce_span(words, is_ref, ok, j, pad);
}

// The same for any width: d components, zero-padded to dp rows, and the
// squared norm (summed over the d components in order) in row dp.
__global__ void __launch_bounds__(PRE_NT)
nn_transpose_any_kernel(const float* __restrict__ q, const float* __restrict__ r,
                        const uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ qvalid, int n, int m, int d, int dp,
                        int n_pad, int m_pad, float* __restrict__ qt,
                        float* __restrict__ rt, int* __restrict__ words) {
  int j = blockIdx.x * PRE_NT + threadIdx.x;
  const bool is_ref = j >= n_pad;
  if (is_ref) j -= n_pad;
  const float* src = is_ref ? r : q;
  float* dst = is_ref ? rt : qt;
  const int rows = is_ref ? m : n;
  const int pad = is_ref ? m_pad : n_pad;
  float s = 0.f;
  for (int c = 0; c < dp; ++c) {
    const float v = j < rows && c < d ? __ldg(src + (size_t)j * d + c) : 0.f;
    dst[(size_t)c * pad + j] = v;
    s = fmaf(v, v, s);
  }
  const bool ok = row_valid(is_ref ? valid : qvalid, j, rows);
  if (is_ref) s = ok ? s : INFINITY;
  dst[(size_t)dp * pad + j] = s;
  reduce_span(words, is_ref, ok, j, pad);
}

// What one block of a main kernel does, from the pre-pass's spans: whether
// its query tile [q0, q0 + bq) meets the valid queries, and the reference
// tiles it walks, [t_begin, t_begin + count): its part of the T tiles that
// meet the valid references, from tile t_lo, part p taking [t_lo + p*T/split,
// t_lo + (p+1)*T/split). With every row valid, t_lo = 0 and T is every tile.
struct Walk {
  bool live;
  int t_begin, count;
};

__device__ __forceinline__ Walk plan_walk(const int* words, int q0, int bq, int br,
                                          int n_pad, int m_pad, int part, int split) {
  const int q_lo = n_pad - words[0], q_hi = words[1];
  const int r_lo = m_pad - words[2], r_hi = words[3];
  const int t_lo = r_lo / br;
  const int tiles = r_hi > r_lo ? (r_hi + br - 1) / br - t_lo : 0;
  Walk w;
  w.live = q0 < q_hi && q0 + bq > q_lo;
  w.t_begin = t_lo + (int)((long long)part * tiles / split);
  w.count = t_lo + (int)((long long)(part + 1) * tiles / split) - w.t_begin;
  return w;
}

// A block outside the valid queries: (0, +inf) for its rows, the parts of
// the cluster taking every split-th row (they all leave, none waits).
__device__ __forceinline__ void store_none(int q0, int bq, int n, int part, int split,
                                           int tid, int nt, int* out_i, float* out_d) {
  for (int row = part + tid * split; row < bq; row += nt * split)
    if (q0 + row < n) {
      out_i[q0 + row] = 0;
      out_d[q0 + row] = INFINITY;
    }
}

// The block's walked query rows x reference rows, into the call's tally.
__device__ __forceinline__ void tally_walk(int* words, const Walk& w, int q0, int bq, int br,
                                           int n, int m) {
  if (threadIdx.x != 0 || w.count == 0) return;
  const long long rows_q = min(q0 + bq, n) - q0;
  const long long rows_r = min((w.t_begin + w.count) * br, m) - min(w.t_begin * br, m);
  atomicAdd(reinterpret_cast<unsigned long long*>(words + 4),
            (unsigned long long)(rows_q * rows_r));
}

// One query's result: its nearest valid reference, or (0, +inf) for a query
// that is not valid.
__device__ __forceinline__ void store_row(const uint8_t* qvalid, int i, int bi, float d,
                                          int* out_i, float* out_d) {
  const bool ok = qvalid == nullptr || qvalid[i] != 0;
  out_i[i] = ok ? bi : 0;
  out_d[i] = ok ? d : INFINITY;
}

__device__ __forceinline__ void ld4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// true where (d, i) comes before (bd, bi): nearer, or as near at a lower index
__device__ __forceinline__ bool nearer(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// A block is GY x GX threads, each with a TQ x TR micro-tile of dots; its
// tile is GY*TQ queries x GX*TR references.
template <int D, int TQ, int TR, int GY, int GX>
struct NnTile {
  static_assert(TQ % 4 == 0 && TR % 4 == 0 && GY % 4 == 0 && GX % 8 == 0 && GX <= 16,
                "16-byte operand loads; a warp is 4 x 8 threads");
  static constexpr int NT = GY * GX;
  static constexpr int BQ = GY * TQ;
  static constexpr int BR = GX * TR;
  static constexpr int ROWS = D + 1;  // D components and the squared norm
  // the ring of reference tiles; the per-thread bests of each query row, up
  // to 16 (d, index) pairs, reuse it after the last tile
  static constexpr int RING = STAGES * ROWS * BR > 32 * BQ ? STAGES * ROWS * BR : 32 * BQ;
  // query tile, ring, one (d, index) per query
  static constexpr size_t smem_bytes() {
    return (ROWS * BQ + RING + 2 * BQ) * sizeof(float);
  }
};

// ROWS x W floats, W contiguous in each row of a [ROWS][pad] scratch, into
// shared memory [ROWS][W] by 16-byte cp.async
template <int ROWS, int W, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int pad,
                                          int tid) {
  constexpr int C4 = W / 4;
  for (int e = tid; e < ROWS * C4; e += NT) {
    const int row = e / C4, c4 = e % C4;
    cp_async_16(smem_u32(dst + row * W + c4 * 4), src + (size_t)row * pad + c4 * 4, 16);
  }
}

template <int D, int TQ, int TR, int GY, int GX>
__global__ void __launch_bounds__(GY * GX)
flash_nn_kernel(const float* __restrict__ qt, const float* __restrict__ rt,
                const uint8_t* __restrict__ qvalid, int* __restrict__ words,
                int n, int m, int n_pad, int m_pad, int split,
                int* __restrict__ out_i, float* __restrict__ out_d) {
  using T = NnTile<D, TQ, TR, GY, GX>;
  constexpr int NT = T::NT, BQ = T::BQ, BR = T::BR, ROWS = T::ROWS;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [ROWS][BQ]
  float* ring = qs + ROWS * BQ;              // [STAGES][ROWS][BR]
  float* part_d = ring + T::RING;            // [BQ] this block's bests
  int* part_i = reinterpret_cast<int*>(part_d + BQ);

  const int tid = threadIdx.x;
  // a warp is 4 (queries) x 8 (references) threads, the block GY/4 x GX/8 warps
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / (GX / 8)) * 4 + lane / 8;
  const int tx = (warp % (GX / 8)) * 8 + lane % 8;
  const int q0 = blockIdx.x * BQ;
  const int part = blockIdx.y;               // rank in the (1, split, 1) cluster
  const Walk w = plan_walk(words, q0, BQ, BR, n_pad, m_pad, part, split);
  if (!w.live) {
    store_none(q0, BQ, n, part, split, tid, NT, out_i, out_d);
    return;
  }
  tally_walk(words, w, q0, BQ, BR, n, m);
  const int t_begin = w.t_begin, count = w.count;

  load_tile<ROWS, BQ, NT>(qs, qt + q0, n_pad, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count)
      load_tile<ROWS, BR, NT>(ring + s * ROWS * BR, rt + (size_t)(t_begin + s) * BR,
                              m_pad, tid);
    cp_async_commit();
  }

  float best[TQ];
  int best_i[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    best[i] = INFINITY;
    best_i[i] = 0;
  }

  for (int it = 0; it < count; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed (this thread's part)
    __syncthreads();              // ... everyone's; and tile it-1 is done with
    const int nxt = it + STAGES - 1;
    if (nxt < count)
      load_tile<ROWS, BR, NT>(ring + (nxt % STAGES) * ROWS * BR,
                              rt + (size_t)(t_begin + nxt) * BR, m_pad, tid);
    cp_async_commit();

    const float* rs = ring + (it % STAGES) * ROWS * BR;
    float acc[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;
    // operands of step k + 1 are loaded before step k's products: the
    // loads' latency hides behind 64 fmaf
    float qv[2][TQ], rv[2][TR];
    auto load_step = [&](int k) {
#pragma unroll
      for (int h = 0; h < TQ / 4; ++h)
        ld4(qv[k % 2] + 4 * h, qs + k * BQ + (h * GY + ty) * 4);
#pragma unroll
      for (int h = 0; h < TR / 4; ++h)
        ld4(rv[k % 2] + 4 * h, rs + k * BR + (h * GX + tx) * 4);
    };
    load_step(0);
#pragma unroll K_UNROLL
    for (int k = 0; k < D; ++k) {
      if (k + 1 < D) load_step(k + 1);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j)
          acc[i][j] = fmaf(qv[k % 2][i], rv[k % 2][j], acc[i][j]);
    }
    float rq[TR];
#pragma unroll
    for (int h = 0; h < TR / 4; ++h) ld4(rq + 4 * h, rs + D * BR + (h * GX + tx) * 4);
    const int j0 = (t_begin + it) * BR + tx * 4;
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {  // increasing reference index
        const float d = fmaf(-2.f, acc[i][j], rq[j]);  // one rounding: 2 * dot is exact
        if (d < best[i]) {
          best[i] = d;
          best_i[i] = j0 + (j / 4) * (GX * 4) + j % 4;
        }
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // the query tile has landed; the ring is free

  // the GX threads of a query row, merged in reference order
  float* red_d = ring;                                  // [BQ][GX]
  int* red_i = reinterpret_cast<int*>(ring + GX * BQ);  // [BQ][GX]
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int row = ((i / 4) * GY + ty) * 4 + i % 4;
    red_d[row * GX + tx] = best[i];
    red_i[row * GX + tx] = best_i[i];
  }
  __syncthreads();
  for (int row = tid; row < BQ; row += NT) {
    float bd = red_d[row * GX];
    int bi = red_i[row * GX];
    for (int x = 1; x < GX; ++x) {
      const float d = red_d[row * GX + x];
      const int i = red_i[row * GX + x];
      if (nearer(d, i, bd, bi)) {
        bd = d;
        bi = i;
      }
    }
    part_d[row] = bd;
    part_i[row] = bi;
  }

  if (split == 1) {
    for (int row = tid; row < BQ; row += NT)  // the rows this thread merged
      if (q0 + row < n)
        store_row(qvalid, q0 + row, part_i[row], fmaxf(part_d[row] + qs[D * BQ + row], 0.f),
                  out_i, out_d);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every part's bests are in place
  for (int row = part + tid * split; row < BQ; row += NT * split) {
    float bd = INFINITY;
    int bi = 0;
    for (int p = 0; p < split; ++p) {  // rank order: deterministic
      const float d = cluster.map_shared_rank(part_d, p)[row];
      const int i = cluster.map_shared_rank(part_i, p)[row];
      if (nearer(d, i, bd, bi)) {
        bd = d;
        bi = i;
      }
    }
    if (q0 + row < n)
      store_row(qvalid, q0 + row, bi, fmaxf(bd + qs[D * BQ + row], 0.f), out_i, out_d);
  }
  cluster.sync();  // no block leaves while a peer still reads its bests
}

// d = |r|^2 + sum_c a_c r_c with a = -2 q, three fmaf in component order:
// the min fold and its index re-walk must evaluate it identically
__device__ __forceinline__ float dist3(const float (&a)[3], float r0, float r1, float r2,
                                       float rr) {
  return fmaf(a[2], r2, fmaf(a[1], r1, fmaf(a[0], r0, rr)));
}

// D = 3 with the min fold: a block is GY x GX threads, each with TQ queries
// in registers and TR references a tile; the tile is GY*TQ x GX*TR.
template <int TQ, int TR, int GY, int GX>
struct Nn3Tile {
  static_assert(TQ % 4 == 0 && TR % 4 == 0 && GY % 4 == 0 && GX % 8 == 0 && GX <= 16,
                "16-byte operand loads; a warp is 4 x 8 threads");
  static constexpr int NT = GY * GX;
  static constexpr int BQ = GY * TQ;
  static constexpr int BR = GX * TR;
  static constexpr int ROWS = 4;  // three components and the squared norm
  static_assert(PAD % BR == 0, "reference tiles must not pass the scratch's padding");
  // the ring of reference tiles; the per-thread bests of each query row, up
  // to 16 (d, index) pairs, reuse it after the last tile
  static constexpr int RING = STAGES * ROWS * BR > 32 * BQ ? STAGES * ROWS * BR : 32 * BQ;
  // keep in step with nn_smem_bytes(..., fold="min") in match/nn_kernel.py
  static constexpr size_t smem_bytes() { return (RING + 2 * BQ) * sizeof(float); }
};

template <int TQ, int TR, int GY, int GX>
__global__ void __launch_bounds__(GY * GX, 2)
flash_nn3_kernel(const float* __restrict__ qt, const float* __restrict__ rt,
                 const uint8_t* __restrict__ qvalid, int* __restrict__ words,
                 int n, int m, int n_pad, int m_pad, int split,
                 int* __restrict__ out_i, float* __restrict__ out_d) {
  using T = Nn3Tile<TQ, TR, GY, GX>;
  constexpr int NT = T::NT, BQ = T::BQ, BR = T::BR, ROWS = T::ROWS;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                // [STAGES][ROWS][BR]
  float* part_d = ring + T::RING;    // [BQ] this block's bests
  int* part_i = reinterpret_cast<int*>(part_d + BQ);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / (GX / 8)) * 4 + lane / 8;
  const int tx = (warp % (GX / 8)) * 8 + lane % 8;
  const int q0 = blockIdx.x * BQ;
  const int part = blockIdx.y;
  const Walk w = plan_walk(words, q0, BQ, BR, n_pad, m_pad, part, split);
  if (!w.live) {
    store_none(q0, BQ, n, part, split, tid, NT, out_i, out_d);
    return;
  }
  tally_walk(words, w, q0, BQ, BR, n, m);
  // the walk's tiles are absolute: the index re-walk below adds t_begin
  const int t_begin = w.t_begin, count = w.count;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count)
      load_tile<ROWS, BR, NT>(ring + s * ROWS * BR, rt + (size_t)(t_begin + s) * BR, m_pad,
                              tid);
    cp_async_commit();
  }

  // this thread's queries, rows ((i / 4) * GY + ty) * 4 + i % 4, times -2;
  // groups of four past n_pad (a query tile wider than the padding) are 0
  float qa[TQ][3];
#pragma unroll
  for (int h = 0; h < TQ / 4; ++h) {
    const int q = q0 + (h * GY + ty) * 4;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (q < n_pad) ld4(v, qt + (size_t)c * n_pad + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[4 * h + e][c] = -2.f * v[e];
    }
  }

  float run[TQ];  // the running minimum of d over this thread's references
  int tile_of[TQ];  // the walk's last tile that lowered it; -1: none did
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    run[i] = INFINITY;
    tile_of[i] = -1;
  }

  for (int it = 0; it < count; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < count)
      load_tile<ROWS, BR, NT>(ring + (nxt % STAGES) * ROWS * BR,
                              rt + (size_t)(t_begin + nxt) * BR, m_pad, tid);
    cp_async_commit();

    const float* rs = ring + (it % STAGES) * ROWS * BR;
    float rv[ROWS][TR];
#pragma unroll
    for (int c = 0; c < ROWS; ++c)
#pragma unroll
      for (int h = 0; h < TR / 4; ++h) ld4(rv[c] + 4 * h, rs + c * BR + (h * GX + tx) * 4);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      float d[TR];
#pragma unroll
      for (int j = 0; j < TR; ++j) d[j] = dist3(qa[i], rv[0][j], rv[1][j], rv[2][j], rv[3][j]);
      // the tile's minimum as a tree (a minimum is exact in any order)
#pragma unroll
      for (int w = 1; w < TR; w *= 2)
#pragma unroll
        for (int j = 0; j + w < TR; j += 2 * w) d[j] = fminf(d[j], d[j + w]);
      tile_of[i] = d[0] < run[i] ? it : tile_of[i];
      run[i] = fminf(run[i], d[0]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // each query's index: the first reference of its tile at the minimum,
  // from the k-major scratch (refs in increasing index as j falls)
  float* red_d = ring;                                  // [BQ][GX]
  int* red_i = reinterpret_cast<int*>(ring + GX * BQ);  // [BQ][GX]
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    int bi = 0;
    if (tile_of[i] >= 0) {
      const int j0 = (t_begin + tile_of[i]) * BR + tx * 4;
#pragma unroll
      for (int j = TR - 1; j >= 0; --j) {
        const int idx = j0 + (j / 4) * (GX * 4) + j % 4;
        const float d = dist3(qa[i], __ldg(rt + idx), __ldg(rt + (size_t)m_pad + idx),
                              __ldg(rt + 2 * (size_t)m_pad + idx),
                              __ldg(rt + 3 * (size_t)m_pad + idx));
        if (d == run[i]) bi = idx;
      }
    }
    const int row = ((i / 4) * GY + ty) * 4 + i % 4;
    red_d[row * GX + tx] = run[i];
    red_i[row * GX + tx] = bi;
  }
  __syncthreads();
  for (int row = tid; row < BQ; row += NT) {
    float bd = red_d[row * GX];
    int bi = red_i[row * GX];
    for (int x = 1; x < GX; ++x) {
      const float d = red_d[row * GX + x];
      const int i = red_i[row * GX + x];
      if (nearer(d, i, bd, bi)) {
        bd = d;
        bi = i;
      }
    }
    part_d[row] = bd;
    part_i[row] = bi;
  }

  if (split == 1) {
    for (int row = tid; row < BQ; row += NT)
      if (q0 + row < n)
        store_row(qvalid, q0 + row, part_i[row],
                  fmaxf(part_d[row] + qt[(size_t)3 * n_pad + q0 + row], 0.f), out_i, out_d);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int row = part + tid * split; row < BQ; row += NT * split) {
    float bd = INFINITY;
    int bi = 0;
    for (int p = 0; p < split; ++p) {
      const float d = cluster.map_shared_rank(part_d, p)[row];
      const int i = cluster.map_shared_rank(part_i, p)[row];
      if (nearer(d, i, bd, bi)) {
        bd = d;
        bi = i;
      }
    }
    if (q0 + row < n)
      store_row(qvalid, q0 + row, bi, fmaxf(bd + qt[(size_t)3 * n_pad + q0 + row], 0.f),
                out_i, out_d);
  }
  cluster.sync();
}

// The chunk fold at any padded width dp: a block is GY x GX threads with a
// TQ x TR micro-tile each, as in NnTile; a ring stage holds KC rows of the
// query tile, KC rows of a reference tile and that tile's norms.
template <int TQ, int TR, int GY, int GX>
struct NnkTile {
  static_assert(TQ % 4 == 0 && TR % 4 == 0 && GY % 4 == 0 && GX % 8 == 0 && GX <= 16,
                "16-byte operand loads; a warp is 4 x 8 threads");
  static constexpr int NT = GY * GX;
  static constexpr int BQ = GY * TQ;
  static constexpr int BR = GX * TR;
  static_assert(PAD % BQ == 0 && PAD % BR == 0, "tiles must not pass the scratch's padding");
  static constexpr int STAGE = KC * BQ + (KC + 1) * BR;
  // the ring; the per-thread bests of each query row, up to 16 (d, index)
  // pairs, reuse it after the last step
  static constexpr int RING = STAGES * STAGE > 32 * BQ ? STAGES * STAGE : 32 * BQ;
  // keep in step with nn_smem_bytes(..., fold="chunk") in match/nn_kernel.py
  static constexpr size_t smem_bytes() { return (RING + 2 * BQ) * sizeof(float); }
};

template <int TQ, int TR, int GY, int GX>
__global__ void __launch_bounds__(GY * GX)
flash_nnk_kernel(const float* __restrict__ qt, const float* __restrict__ rt,
                 const uint8_t* __restrict__ qvalid, int* __restrict__ words,
                 int n, int m, int n_pad, int m_pad, int dp, int split,
                 int* __restrict__ out_i, float* __restrict__ out_d) {
  using T = NnkTile<TQ, TR, GY, GX>;
  constexpr int NT = T::NT, BQ = T::BQ, BR = T::BR, STAGE = T::STAGE;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                // [STAGES][KC x BQ | KC x BR | BR]
  float* part_d = ring + T::RING;    // [BQ] this block's bests
  int* part_i = reinterpret_cast<int*>(part_d + BQ);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / (GX / 8)) * 4 + lane / 8;
  const int tx = (warp % (GX / 8)) * 8 + lane % 8;
  const int q0 = blockIdx.x * BQ;
  const int part = blockIdx.y;
  const Walk w = plan_walk(words, q0, BQ, BR, n_pad, m_pad, part, split);
  if (!w.live) {
    store_none(q0, BQ, n, part, split, tid, NT, out_i, out_d);
    return;
  }
  tally_walk(words, w, q0, BQ, BR, n, m);
  const int t_begin = w.t_begin, count = w.count;
  const int chunks = dp / KC;
  const int steps = count * chunks;  // step s: chunk s % chunks of tile s / chunks

  auto load_step = [&](int s) {
    float* st = ring + (s % STAGES) * STAGE;
    const int c = s % chunks;
    const size_t r0 = (size_t)(t_begin + s / chunks) * BR;
    load_tile<KC, BQ, NT>(st, qt + (size_t)c * KC * n_pad + q0, n_pad, tid);
    load_tile<KC, BR, NT>(st + KC * BQ, rt + (size_t)c * KC * m_pad + r0, m_pad, tid);
    if (c == chunks - 1)
      load_tile<1, BR, NT>(st + KC * (BQ + BR), rt + (size_t)dp * m_pad + r0, m_pad, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }

  float best[TQ];
  int best_i[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    best[i] = INFINITY;
    best_i[i] = 0;
  }
  float acc[TQ][TR];

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed (this thread's part)
    __syncthreads();              // ... everyone's; and step s-1 is done with
    if (s + STAGES - 1 < steps) load_step(s + STAGES - 1);
    cp_async_commit();

    const int c = s % chunks;
    const float* qs = ring + (s % STAGES) * STAGE;
    const float* rs = qs + KC * BQ;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float qv[TQ], rv[TR];
#pragma unroll
      for (int h = 0; h < TQ / 4; ++h) ld4(qv + 4 * h, qs + k * BQ + (h * GY + ty) * 4);
#pragma unroll
      for (int h = 0; h < TR / 4; ++h) ld4(rv + 4 * h, rs + k * BR + (h * GX + tx) * 4);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(qv[i], rv[j], acc[i][j]);
    }
    if (c == chunks - 1) {  // the tile's dots are whole: fold them
      float rq[TR];
#pragma unroll
      for (int h = 0; h < TR / 4; ++h) ld4(rq + 4 * h, rs + KC * BR + (h * GX + tx) * 4);
      const int j0 = (t_begin + s / chunks) * BR + tx * 4;
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) {  // increasing reference index
          const float d = fmaf(-2.f, acc[i][j], rq[j]);
          if (d < best[i]) {
            best[i] = d;
            best_i[i] = j0 + (j / 4) * (GX * 4) + j % 4;
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  const float* qnorm = qt + (size_t)dp * n_pad + q0;
  float* red_d = ring;                                  // [BQ][GX]
  int* red_i = reinterpret_cast<int*>(ring + GX * BQ);  // [BQ][GX]
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int row = ((i / 4) * GY + ty) * 4 + i % 4;
    red_d[row * GX + tx] = best[i];
    red_i[row * GX + tx] = best_i[i];
  }
  __syncthreads();
  for (int row = tid; row < BQ; row += NT) {
    float bd = red_d[row * GX];
    int bi = red_i[row * GX];
    for (int x = 1; x < GX; ++x) {
      const float d = red_d[row * GX + x];
      const int i = red_i[row * GX + x];
      if (nearer(d, i, bd, bi)) {
        bd = d;
        bi = i;
      }
    }
    part_d[row] = bd;
    part_i[row] = bi;
  }

  if (split == 1) {
    for (int row = tid; row < BQ; row += NT)
      if (q0 + row < n)
        store_row(qvalid, q0 + row, part_i[row], fmaxf(part_d[row] + qnorm[row], 0.f), out_i,
                  out_d);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int row = part + tid * split; row < BQ; row += NT * split) {
    float bd = INFINITY;
    int bi = 0;
    for (int p = 0; p < split; ++p) {
      const float d = cluster.map_shared_rank(part_d, p)[row];
      const int i = cluster.map_shared_rank(part_i, p)[row];
      if (nearer(d, i, bd, bi)) {
        bd = d;
        bi = i;
      }
    }
    if (q0 + row < n)
      store_row(qvalid, q0 + row, bi, fmaxf(bd + qnorm[row], 0.f), out_i, out_d);
  }
  cluster.sync();
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, size_t smem, int bq, int threads, int n, int split,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + bq - 1) / bq, split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;  // the parts of one query tile: one cluster
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int TQ, int TR, int GY, int GX>
cudaError_t launch_nn3(const float* qt, const float* rt, const uint8_t* qvalid, int* words,
                       int n, int m, int n_pad, int m_pad, int split, int* out_i, float* out_d,
                       cudaStream_t stream) {
  using T = Nn3Tile<TQ, TR, GY, GX>;
  auto kernel = flash_nn3_kernel<TQ, TR, GY, GX>;
  static bool smem_allowed = false;  // per instance
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem_bytes());
    if (e != cudaSuccess) return e;
    smem_allowed = true;
  }
  return launch_cluster(kernel, T::smem_bytes(), T::BQ, T::NT, n, split, stream, qt, rt,
                        qvalid, words, n, m, n_pad, m_pad, split, out_i, out_d);
}

template <int D, int TQ, int TR, int GY, int GX>
cudaError_t launch_nn(const float* qt, const float* rt, const uint8_t* qvalid, int* words,
                      int n, int m, int n_pad, int m_pad, int split, int* out_i, float* out_d,
                      cudaStream_t stream) {
  using T = NnTile<D, TQ, TR, GY, GX>;
  auto kernel = flash_nn_kernel<D, TQ, TR, GY, GX>;
  static bool smem_allowed = false;  // per instance
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem_bytes());
    if (e != cudaSuccess) return e;
    smem_allowed = true;
  }
  return launch_cluster(kernel, T::smem_bytes(), T::BQ, T::NT, n, split, stream, qt, rt,
                        qvalid, words, n, m, n_pad, m_pad, split, out_i, out_d);
}

template <int TQ, int TR, int GY, int GX>
cudaError_t launch_nnk(const float* qt, const float* rt, const uint8_t* qvalid, int* words,
                       int n, int m, int n_pad, int m_pad, int dp, int split, int* out_i,
                       float* out_d, cudaStream_t stream) {
  using T = NnkTile<TQ, TR, GY, GX>;
  auto kernel = flash_nnk_kernel<TQ, TR, GY, GX>;
  static bool smem_allowed = false;  // per instance
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem_bytes());
    if (e != cudaSuccess) return e;
    smem_allowed = true;
  }
  return launch_cluster(kernel, T::smem_bytes(), T::BQ, T::NT, n, split, stream, qt, rt,
                        qvalid, words, n, m, n_pad, m_pad, dp, split, out_i, out_d);
}

// the chunk fold (fold 2) at any width d >= 1, padded to dp, a multiple of KC
cudaError_t launch_any(int d, int bq, int br, int threads, const float* q, const float* r,
                       const uint8_t* valid, const uint8_t* qvalid, float* scratch,
                       int* words, int n, int m, int split, int* out_i, float* out_d,
                       cudaStream_t stream) {
  const int dp = (d + KC - 1) / KC * KC;
  const int n_pad = (n + PAD - 1) / PAD * PAD, m_pad = (m + PAD - 1) / PAD * PAD;
  float* qt = scratch;
  float* rt = scratch + (size_t)(dp + 1) * n_pad;
  nn_transpose_any_kernel<<<(n_pad + m_pad) / PRE_NT, PRE_NT, 0, stream>>>(
      q, r, valid, qvalid, n, m, d, dp, n_pad, m_pad, qt, rt, words);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
#define NNK_INSTANCE(TQ, TR, GY, GX)                                                   \
  if (bq == GY * TQ && br == GX * TR && threads == GY * GX)                            \
    return launch_nnk<TQ, TR, GY, GX>(qt, rt, qvalid, words, n, m, n_pad, m_pad, dp, split, \
                                      out_i, out_d, stream);
  // keep in step with NN_CHUNK_TILES in match/nn_kernel.py
  NNK_INSTANCE(8, 8, 8, 16)   // 64 x 128, 128 threads: the plan's
  NNK_INSTANCE(8, 8, 16, 16)  // 128 x 128, 256 threads
#undef NNK_INSTANCE
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_d(int bq, int br, int threads, int fold, const float* q, const float* r,
                     const uint8_t* valid, const uint8_t* qvalid, float* scratch, int* words,
                     int n, int m, int split, int* out_i, float* out_d, cudaStream_t stream) {
  const int n_pad = (n + PAD - 1) / PAD * PAD, m_pad = (m + PAD - 1) / PAD * PAD;
  float* qt = scratch;
  float* rt = scratch + (size_t)(D + 1) * n_pad;
  nn_transpose_kernel<D><<<(n_pad + m_pad) / PRE_NT, PRE_NT, 0, stream>>>(
      q, r, valid, qvalid, n, m, n_pad, m_pad, qt, rt, words);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (D == 3) {  // the min fold
    if (fold != 1) return cudaErrorInvalidValue;
#define NN3_INSTANCE(TQ, TR, GY, GX)                                                \
  if (bq == GY * TQ && br == GX * TR && threads == GY * GX)                         \
    return launch_nn3<TQ, TR, GY, GX>(qt, rt, qvalid, words, n, m, n_pad, m_pad, split, \
                                      out_i, out_d, stream);
    // keep in step with NN_MIN_GEOMETRY in match/nn_kernel.py
    NN3_INSTANCE(8, 8, 8, 16)    // 64 x 128, 128 threads
    NN3_INSTANCE(8, 8, 16, 16)   // 128 x 128, 256 threads
    NN3_INSTANCE(8, 16, 16, 8)   // 128 x 128, 128 threads
    NN3_INSTANCE(8, 16, 32, 8)   // 256 x 128, 256 threads
    NN3_INSTANCE(16, 16, 16, 8)  // 256 x 128, 128 threads: the plan's
#undef NN3_INSTANCE
  } else {  // the (d, index) fold
    if (fold != 0) return cudaErrorInvalidValue;
#define NN_INSTANCE(TQ, TR, GY, GX)                                                   \
  if (bq == GY * TQ && br == GX * TR && threads == GY * GX)                           \
    return launch_nn<D, TQ, TR, GY, GX>(qt, rt, qvalid, words, n, m, n_pad, m_pad, split, \
                                        out_i, out_d, stream);
    // keep in step with NN_TILES in match/nn_kernel.py
    NN_INSTANCE(8, 8, 8, 16)    // 64 x 128, 128 threads: the plan's
    NN_INSTANCE(8, 8, 16, 16)   // 128 x 128, 256 threads
    NN_INSTANCE(8, 4, 16, 16)   // 128 x 64, 256 threads
    NN_INSTANCE(4, 8, 16, 16)   // 64 x 128, 256 threads
    NN_INSTANCE(4, 4, 16, 16)   // 64 x 64, 256 threads
#undef NN_INSTANCE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q f32 [n, d], r f32 [m, d], valid uint8 [m] or null (every reference
// valid), qvalid uint8 [n] or null (every query valid), all contiguous;
// out_i int32 [n], out_d f32 [n], n > 0, d >= 1. A query that is not valid
// gets (0, +inf). Fold 0, the (d, index) fold of flash_nn_kernel, serves
// d = 32; fold 1, the min fold of flash_nn3_kernel, d = 3; fold 2, the chunk
// fold of flash_nnk_kernel, any d. scratch: (w + 1) * (n padded to 128 + m
// padded to 128) floats, 16-byte aligned, where w is d (folds 0 and 1) or d
// padded to a multiple of 8 (fold 2). words: 8 ints, 8-byte aligned, which
// the call clears and then holds the valid spans and, in words 4-5, the
// uint64 tally of the query x reference rows walked. bq x br is the block's
// tile of queries x references and threads its size (one of the instances of
// launch_d), split the blocks of a cluster that share a query tile's
// references (1..8). Clears the words, launches the pre-pass and the main
// kernel on `stream` and returns a CUDA error code (cudaErrorInvalidValue
// for a combination with no kernel).
extern "C" int flash_nn(const void* q, const void* r, const void* valid, const void* qvalid,
                        void* scratch, void* words, void* out_i, void* out_d, int n, int m,
                        int d, int bq, int br, int threads, int split, int fold,
                        void* stream) {
  if (n <= 0 || m < 0 || d < 1 || split < 1 || split > MAX_SPLIT ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(words) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* rf = static_cast<const float*>(r);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  const uint8_t* qv = static_cast<const uint8_t*>(qvalid);
  float* sf = static_cast<float*>(scratch);
  int* wf = static_cast<int*>(words);
  int* oi = static_cast<int*>(out_i);
  float* od = static_cast<float*>(out_d);
  cudaError_t e = cudaMemsetAsync(wf, 0, WORDS * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fold == 2) {
    e = launch_any(d, bq, br, threads, qf, rf, vf, qv, sf, wf, n, m, split, oi, od, s);
  } else if (d == 32) {
    e = launch_d<32>(bq, br, threads, fold, qf, rf, vf, qv, sf, wf, n, m, split, oi, od, s);
  } else if (d == 3) {
    e = launch_d<3>(bq, br, threads, fold, qf, rf, vf, qv, sf, wf, n, m, split, oi, od, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
