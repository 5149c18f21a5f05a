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

// Pre-pass: thread j transposes row j of q (j < n_pad) or of r into the
// k-major scratch and writes its squared norm into row D.
template <int D>
__global__ void __launch_bounds__(PRE_NT)
nn_transpose_kernel(const float* __restrict__ q, const float* __restrict__ r,
                    const uint8_t* __restrict__ valid, int n, int m, int n_pad,
                    int m_pad, float* __restrict__ qt, float* __restrict__ rt) {
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
  if (is_ref) {
    const bool ok = j < m && (valid == nullptr || valid[j] != 0);
    s = ok ? s : INFINITY;
  }
  dst[(size_t)D * pad + j] = s;
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
  const int tiles = (m + BR - 1) / BR;
  const int t_begin = (int)((long long)part * tiles / split);
  const int count = (int)((long long)(part + 1) * tiles / split) - t_begin;

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
      if (q0 + row < n) {
        out_i[q0 + row] = part_i[row];
        out_d[q0 + row] = fmaxf(part_d[row] + qs[D * BQ + row], 0.f);
      }
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
    if (q0 + row < n) {
      out_i[q0 + row] = bi;
      out_d[q0 + row] = fmaxf(bd + qs[D * BQ + row], 0.f);
    }
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
  const int tiles = (m + BR - 1) / BR;
  const int t_begin = (int)((long long)part * tiles / split);
  const int count = (int)((long long)(part + 1) * tiles / split) - t_begin;

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
      if (q0 + row < n) {
        out_i[q0 + row] = part_i[row];
        out_d[q0 + row] = fmaxf(part_d[row] + qt[(size_t)3 * n_pad + q0 + row], 0.f);
      }
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
    if (q0 + row < n) {
      out_i[q0 + row] = bi;
      out_d[q0 + row] = fmaxf(bd + qt[(size_t)3 * n_pad + q0 + row], 0.f);
    }
  }
  cluster.sync();
}

template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, size_t smem, int bq, int threads, const float* qt,
                           const float* rt, int n, int m, int n_pad, int m_pad, int split,
                           int* out_i, float* out_d, cudaStream_t stream) {
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
  return cudaLaunchKernelEx(&cfg, kernel, qt, rt, n, m, n_pad, m_pad, split, out_i, out_d);
}

template <int TQ, int TR, int GY, int GX>
cudaError_t launch_nn3(const float* qt, const float* rt, int n, int m, int n_pad, int m_pad,
                       int split, int* out_i, float* out_d, cudaStream_t stream) {
  using T = Nn3Tile<TQ, TR, GY, GX>;
  auto kernel = flash_nn3_kernel<TQ, TR, GY, GX>;
  static bool smem_allowed = false;  // per instance
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem_bytes());
    if (e != cudaSuccess) return e;
    smem_allowed = true;
  }
  return launch_cluster(kernel, T::smem_bytes(), T::BQ, T::NT, qt, rt, n, m, n_pad, m_pad,
                        split, out_i, out_d, stream);
}

template <int D, int TQ, int TR, int GY, int GX>
cudaError_t launch_nn(const float* qt, const float* rt, int n, int m, int n_pad,
                      int m_pad, int split, int* out_i, float* out_d,
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
  return launch_cluster(kernel, T::smem_bytes(), T::BQ, T::NT, qt, rt, n, m, n_pad, m_pad,
                        split, out_i, out_d, stream);
}

template <int D>
cudaError_t launch_d(int bq, int br, int threads, int fold, const float* q, const float* r,
                     const uint8_t* valid, float* scratch, int n, int m, int split,
                     int* out_i, float* out_d, cudaStream_t stream) {
  const int n_pad = (n + PAD - 1) / PAD * PAD, m_pad = (m + PAD - 1) / PAD * PAD;
  float* qt = scratch;
  float* rt = scratch + (size_t)(D + 1) * n_pad;
  nn_transpose_kernel<D><<<(n_pad + m_pad) / PRE_NT, PRE_NT, 0, stream>>>(
      q, r, valid, n, m, n_pad, m_pad, qt, rt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (D == 3) {  // the min fold
    if (fold != 1) return cudaErrorInvalidValue;
#define NN3_INSTANCE(TQ, TR, GY, GX)                                              \
  if (bq == GY * TQ && br == GX * TR && threads == GY * GX)                       \
    return launch_nn3<TQ, TR, GY, GX>(qt, rt, n, m, n_pad, m_pad, split, out_i, out_d, stream);
    // keep in step with NN_MIN_GEOMETRY in match/nn_kernel.py
    NN3_INSTANCE(8, 8, 8, 16)    // 64 x 128, 128 threads
    NN3_INSTANCE(8, 8, 16, 16)   // 128 x 128, 256 threads
    NN3_INSTANCE(8, 16, 16, 8)   // 128 x 128, 128 threads
    NN3_INSTANCE(8, 16, 32, 8)   // 256 x 128, 256 threads
    NN3_INSTANCE(16, 16, 16, 8)  // 256 x 128, 128 threads: the plan's
#undef NN3_INSTANCE
  } else {  // the (d, index) fold
    if (fold != 0) return cudaErrorInvalidValue;
#define NN_INSTANCE(TQ, TR, GY, GX)                                              \
  if (bq == GY * TQ && br == GX * TR && threads == GY * GX)                      \
    return launch_nn<D, TQ, TR, GY, GX>(qt, rt, n, m, n_pad, m_pad, split, out_i, \
                                        out_d, stream);
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

// q f32 [n, d], r f32 [m, d], valid uint8 [m] or null (all valid), all
// contiguous; out_i int32 [n], out_d f32 [n], n > 0. d must be 3 or 32:
// d = 32 takes fold 0, the (d, index) fold of flash_nn_kernel, d = 3 fold 1,
// the min fold of flash_nn3_kernel.
// scratch: (d + 1) * (n padded to 128 + m padded to 128) floats, 16-byte
// aligned. bq x br is the block's tile of queries x references and threads
// its size (one of the instances of launch_d), split the blocks of a cluster
// that share a query tile's references (1..8). Launches the pre-pass and the main kernel on `stream` and returns a
// CUDA error code (cudaErrorInvalidValue for a combination with no kernel).
extern "C" int flash_nn(const void* q, const void* r, const void* valid,
                        void* scratch, void* out_i, void* out_d, int n, int m,
                        int d, int bq, int br, int threads, int split, int fold,
                        void* stream) {
  if (n <= 0 || m < 0 || split < 1 || split > MAX_SPLIT ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* rf = static_cast<const float*>(r);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  float* sf = static_cast<float*>(scratch);
  int* oi = static_cast<int*>(out_i);
  float* od = static_cast<float*>(out_d);
  cudaError_t e;
  if (d == 32) {
    e = launch_d<32>(bq, br, threads, fold, qf, rf, vf, sf, n, m, split, oi, od, s);
  } else if (d == 3) {
    e = launch_d<3>(bq, br, threads, fold, qf, rf, vf, sf, n, m, split, oi, od, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
