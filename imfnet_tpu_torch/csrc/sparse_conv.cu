// Sparse-convolution forward as one gather-GEMM (sm_90a).
//
// Replaces the TPU kernels of imfnet_tpu/sparse/pallas_conv.py:
//   banded_conv_pallas_union   (:318, call :379, body _kernel_union :186),
//   banded_conv_pallas_planned (:485, call :580, bodies _kernel_merged_t :117,
//                               _kernel_merged :36, _kernel :392),
//   banded_conv_pallas         (:595, the jit wrapper: plan + planned kernel),
// reached from imfnet_tpu/sparse/ops.py::_pallas_banded_apply. Those kernels
// select rows from contiguous input windows with one-hot matmuls because
// Mosaic cannot gather. Hopper can, so this kernel computes the function
// directly, with no windows and no exactness flag:
//
//     out[i, :] = sum_k x[nbr[i, k], :] @ W[k]      nbr = -1 contributes 0,
//
// operands bf16 (or f32), products exact, sums in f32, out f32 [n_out, cout].
// A row whose K entries are all -1 comes out as exact 0.0.
//
// What bounds it on the H100. By the roofline every conv of the main path is
// bound by bytes: 2*nnz*cin*cout operations at the bf16 tensor-core rate take
// less time than moving the int32 map [n_out, 27] once, the input rows the
// map names and the W[k] of its live offsets once, and the f32 output once
// (capacity padding of x is never read, so it is not counted). At level 0
// (65 536 rows) that is a 7 MB map and an 8-17 MB output. What the kernel moves is more: each (row, live offset)
// gathers a row of x, and each tile reads the W[k] slices of its live
// offsets, so the traffic from L2 (where x, at most 5.6 MB, and W, at most
// 3.5 MB, stay) is several times the bound's bytes; at the "up" maps a row
// has about 3 live offsets of 27 while its tile has nearly all of them live,
// so most of a tile's steps multiply zero rows. At levels 2 and 3 every
// array is small and few tiles are live (a compacted prefix of each level's
// capacity), so what bounds a call there is how long one tile's walk over
// its offsets takes. chip_smoke.py measures each shape against its bound,
// and conv_sweep.py every tile and split (PERF.md).
//
// Three variants, chosen by the wrapper's plan
// (sparse/conv_kernel.py::conv_plan) from dtype and shape, never by a failed
// launch:
//
// * Tensor cores (bf16, cin % 8 == 0, cout % 8 == 0, 16-byte aligned x, w and
//   out; every conv of the main path). One block per 128 x BN output tile
//   (BN 32, 64 or 128: one warp per 32 rows, one or two across), for each
//   part of a split of the offsets. Its shared memory grows with K (the map
//   block); the plan narrows BK, then BN, to stay within the H100's 227 KB
//   per block, and sends a K that fits no tile (K > 351) to the wide-K form
//   below (the map block staged in chunks). The tile:
//   - the map is read once per tile: the tile's [128, K] int32 block, which
//     is contiguous, in one coalesced pass into shared memory, and the
//     offsets with a live row are listed from it; only those are walked
//     (capacity padding costs one map read, a dead tile writes zeros and
//     exits);
//   - each step (one live offset, BK input channels: 64 for a 128-wide tile
//     of a wide product, else 32) stages the
//     gathered rows and the W[k] slice with 16-byte cp.async into a ring of 4
//     shared-memory stages, so the copies of the next three steps overlap
//     this step's math; a -1 entry zero-fills its row (src-size 0) and reads
//     nothing;
//   - the products are mma.sync m16n8k16 bf16 -> f32, fed by ldmatrix
//     (.trans for the [cin, cout] row-major W[k]); the accumulators stay in
//     registers across all live offsets of the tile. Rows of the stages are
//     padded by 16 bytes, so ldmatrix reads are free of bank conflicts;
//   - enough blocks at the coarse levels: the plan splits the live offsets
//     over S = 1..8 blocks of one thread-block cluster (part p takes live
//     offsets p, p + S, ...). Each part leaves its f32 partial tile in its own
//     shared memory; after a cluster barrier part p sums rows p*128/S.. of
//     all S partials in rank order through distributed shared memory and
//     writes them. No atomics, no second pass and one fixed order: two calls
//     give bit-equal output.
// * One input channel (cin = 1, bf16 or f32: conv1 of every training step
//   and of SimpleNet, k 125). There is no reduction over channels:
//   out[i, :] = sum_k x[nbr[i, k]] * W[k, 0, :]. What bounds it is bytes:
//   the int32 map [n_out, k_vol] read once (32.8 MB at the training conv1,
//   65 536 x 125), x (128 KB, L2-resident) and the f32 output written once
//   (8.4 MB): 0.0123 ms at 3.35 TB/s, against 32 FMAs per map entry, which
//   the CUDA cores do in about as long. So one thread per output row with
//   its 32 f32 accumulators in registers (a wider cout in passes of 32);
//   the block's [bm, k_vol] map block staged once, coalesced (16-byte
//   cp.async where the rows start aligned), and read back with an odd k_vol
//   stride free of bank conflicts; W[:, 0, 32-wide pass] staged once per
//   pass as f32 and read as broadcasts; x[nbr] one scalar gather per offset,
//   a -1 entry contributing 0. Products are exact in f32 (bf16 operands) or
//   fused (f32), summed in offset order k = 0 .. k_vol-1: two calls are
//   bit-equal, and a dead row is exact 0. The pass's tile goes out through
//   shared memory, one 128-byte row segment a warp store.
// * Scalar (f32 operands at cin > 1, whose 1e-4 parity TF32 would break, and
//   widths that are not multiples of 8): one block of 256 threads per 64 x 64
//   tile; for each offset with a live row it stages the gathered rows and
//   W[k] slice in shared memory as f32 and accumulates 4 x 4 outputs a
//   thread with FMAs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- scalar

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels staged per step
constexpr int NT = 256;  // threads per block: 16 x 16, 4 x 4 outputs each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gather_gemm_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                   const T* __restrict__ w, float* __restrict__ out,
                   int n_out, int k_vol, int cin, int cout) {
  __shared__ float xs[BK][BM + 1];  // +1: the transposed store is conflict-free
  __shared__ float ws[BK][BN];
  __shared__ int rows[BM];

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // this thread's rows: tr + 16 * i
  const int tc = tid % 16;  // this thread's channels: tc + 16 * j
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < k_vol; ++k) {
    int live = 0;
    if (tid < BM) {
      const int r = row0 + tid;
      const int src = r < n_out ? nbr[(size_t)r * k_vol + k] : -1;
      rows[tid] = src;
      live = src >= 0;
    }
    // barrier + vote: skip offsets with no live row in this tile
    if (!__syncthreads_or(live)) continue;

    for (int c0 = 0; c0 < cin; c0 += BK) {
      // gathered input rows; one warp per row, consecutive channels
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, c = e % BK, ch = c0 + c;
        const int src = rows[r];
        xs[c][r] = (src >= 0 && ch < cin)
                       ? to_float(x[(size_t)src * cin + ch]) : 0.f;
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int c = e / BN, n = e % BN, ch = c0 + c, co = col0 + n;
        ws[c][n] = (ch < cin && co < cout)
                       ? to_float(w[((size_t)k * cin + ch) * cout + co]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][tr + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + tr + 16 * i;
    if (r >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = col0 + tc + 16 * j;
      if (co < cout) out[(size_t)r * cout + co] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- cin = 1

constexpr int C1_BN = 32;        // output channels of a pass: a thread's accumulators
constexpr int C1_MAX_BM = 128;   // rows (threads) of a block at most
constexpr int C1_OUT_LD = C1_BN + 1;  // staged output row: conflict-free transpose

// keep in step with cin1_smem_bytes in sparse/conv_kernel.py: the map
// block, one pass's W slice as f32, the pass's staged output tile
size_t cin1_smem_bytes(int bm, int k_vol) {
  return ((size_t)bm * k_vol + (size_t)k_vol * C1_BN + (size_t)bm * C1_OUT_LD) * 4;
}

template <typename T>
__global__ void __launch_bounds__(C1_MAX_BM)
gather_gemm_cin1(const T* __restrict__ x, const int* __restrict__ nbr,
                 const T* __restrict__ w, float* __restrict__ out, int n_out,
                 int k_vol, int cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bm = blockDim.x;
  int* map_s = reinterpret_cast<int*>(smem);                  // [bm, k_vol]
  float* w_s = reinterpret_cast<float*>(map_s + bm * k_vol);  // [k_vol, C1_BN]
  float* o_s = w_s + k_vol * C1_BN;                           // [bm, C1_OUT_LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * bm;
  const int rows = min(bm, n_out - row0);

  // 1. the block's map rows: contiguous, so one coalesced pass
  {
    const int* src = nbr + (size_t)row0 * k_vol;
    const int n = rows * k_vol;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int e = tid; e < n / 4; e += bm)
        cp_async_16(smem_u32(map_s + 4 * e), src + 4 * e, 16);
      done = n / 4 * 4;
    }
    for (int e = done + tid; e < n; e += bm) map_s[e] = __ldg(src + e);
    cp_async_commit();
  }

  const int* my_map = map_s + tid * k_vol;
  for (int c0 = 0; c0 < cout; c0 += C1_BN) {
    __syncthreads();  // the last pass's readers of w_s and o_s are done
    // 2. this pass's W[:, 0, c0 .. c0+31] as f32, zero past cout
    for (int e = tid; e < k_vol * C1_BN; e += bm) {
      const int k = e / C1_BN, c = c0 + e % C1_BN;
      w_s[e] = c < cout ? to_float(w[(size_t)k * cout + c]) : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // 3. this thread's row: offsets in order, one gathered scalar each
    float acc[C1_BN];
#pragma unroll
    for (int c = 0; c < C1_BN; ++c) acc[c] = 0.f;
    if (tid < rows) {
#pragma unroll 4
      for (int k = 0; k < k_vol; ++k) {
        const int s = my_map[k];
        const float v = s >= 0 ? to_float(x[s]) : 0.f;
        const float4* wk = reinterpret_cast<const float4*>(w_s + k * C1_BN);
#pragma unroll
        for (int q = 0; q < C1_BN / 4; ++q) {
          const float4 ww = wk[q];  // the same address in every lane: a broadcast
          acc[4 * q] = fmaf(v, ww.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v, ww.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, ww.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, ww.w, acc[4 * q + 3]);
        }
      }
    }
    // 4. out through shared memory: each warp stores its 32 rows, a row's
    // 32 channels in one 128-byte store
#pragma unroll
    for (int c = 0; c < C1_BN; ++c) o_s[tid * C1_OUT_LD + c] = acc[c];
    __syncwarp();
    const int c = c0 + lane;
    for (int i = 0; i < 32; ++i) {
      const int r = warp * 32 + i;
      if (r < rows && c < cout) out[(size_t)(row0 + r) * cout + c] = o_s[r * C1_OUT_LD + c - c0];
    }
  }
}

template <typename T>
cudaError_t launch_cin1(const void* x, const void* nbr, const void* w, void* out,
                        int n_out, int k_vol, int cout, int bm, cudaStream_t stream) {
  auto kernel = gather_gemm_cin1<T>;
  const size_t smem = cin1_smem_bytes(bm, k_vol);
  static size_t smem_allowed = 0;  // per instance; raised once per size
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  kernel<<<(n_out + bm - 1) / bm, bm, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(nbr), static_cast<const T*>(w),
      static_cast<float*>(out), n_out, k_vol, cout);
  return cudaGetLastError();
}

// ---------------------------------------------------------- tensor cores

constexpr int TC_STAGES = 4;     // cp.async ring depth
constexpr int TC_MAX_SPLIT = 8;  // portable cluster size

// A tile of TBM x TBN outputs: one warp per 32 rows, one or two warps
// across the columns (32-wide tiles take one), so a warp holds 32 x 32 or
// 32 x 64 f32 accumulators.
template <int TBM, int TBN, int TBK>
struct TcTile {
  static constexpr int WM = TBM / 32, WN = TBN == 32 ? 1 : 2;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = TBM / WM, TN = TBN / WN;  // a warp's tile
  static constexpr int MT = TM / 16, NTL = TN / 8;    // its mma tiles
  static constexpr int A_LD = TBK + 8;  // bf16 per staged row: +16 bytes
  static constexpr int B_LD = TBN + 8;  // keeps ldmatrix conflict-free
  static constexpr int A_ELEMS = TBM * A_LD, B_ELEMS = TBK * B_LD;
  static constexpr int A_CH = TBK / 8, B_CH = TBN / 8;  // 16-byte chunks a row
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
  static constexpr int RED_LD = TBN + 4;  // f32 partial tile row
  static constexpr int RED_BYTES = TBM * RED_LD * 4;
  static constexpr int BUF_BYTES = TC_STAGES * STAGE_BYTES > RED_BYTES
                                       ? TC_STAGES * STAGE_BYTES : RED_BYTES;
  static_assert(TBM % 32 == 0 && NTL % 2 == 0 && TBK % 16 == 0, "mma tiles");
  static_assert(STAGE_BYTES % 16 == 0, "stages must stay 16-byte aligned");

  // keep in step with tc_smem_bytes in sparse/conv_kernel.py
  static size_t smem_bytes(int k_vol) {
    return BUF_BYTES + (size_t)(TBM * k_vol + k_vol + 1) * sizeof(int);
  }
};

template <int TBM, int TBN, int TBK>
__global__ void __launch_bounds__(TcTile<TBM, TBN, TBK>::THREADS)
gather_gemm_tc(const __nv_bfloat16* __restrict__ x, const int* __restrict__ nbr,
               const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
               int n_out, int k_vol, int cin, int cout) {
  using T = TcTile<TBM, TBN, TBK>;
  constexpr int NTH = T::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  int* map_s = reinterpret_cast<int*>(smem + T::BUF_BYTES);  // [TBM, k_vol]
  int* live_s = map_s + TBM * k_vol;                          // live offsets
  int* n_live_s = live_s + k_vol;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TBM, col0 = blockIdx.y * TBN;
  const int split = gridDim.z, part = blockIdx.z;

  // 1. the tile's map block: contiguous, one coalesced pass
  {
    const int* src = nbr + (size_t)row0 * k_vol;
    const int n_have = min(TBM, n_out - row0) * k_vol;
#pragma unroll 4
    for (int e = tid; e < TBM * k_vol; e += NTH)
      map_s[e] = e < n_have ? __ldg(src + e) : -1;
  }
  __syncthreads();
  // 2. the offsets with a live row, in order
  for (int k = warp; k < k_vol; k += NTH / 32) {
    bool live = false;
    for (int r = lane; r < TBM; r += 32) live |= map_s[r * k_vol + k] >= 0;
    live = __any_sync(0xffffffffu, live);
    if (lane == 0) live_s[k] = live;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < k_vol; ++k)
      if (live_s[k]) live_s[n++] = k;  // n <= k: compacts in place
    *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;

  const int rows_per_part = TBM / split;
  if (n_live == 0) {
    // dead tile (every part sees the same map): this part's rows are zeros
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = tid; e < rows_per_part * (TBN / 4); e += NTH) {
      const int r = row0 + part * rows_per_part + e / (TBN / 4);
      const int c = col0 + (e % (TBN / 4)) * 4;
      if (r < n_out && c < cout)
        *reinterpret_cast<float4*>(out + (size_t)r * cout + c) = z;
    }
    return;
  }

  // 3. this part's steps: its live offsets p, p + split, ..., each in
  // slices of TBK input channels; loads are issued in step order, so the
  // next load's (offset, slice) is carried from one load to the next
  const int csteps = (cin + TBK - 1) / TBK;
  const int my_offsets = n_live > part ? (n_live - part + split - 1) / split : 0;
  const int n_steps = my_offsets * csteps;
  int next_k = part, next_c0 = 0;  // the next load's live index and slice

  auto stage_a = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * T::STAGE_BYTES);
  };
  auto stage_b = [&](int s) { return stage_a(s) + T::A_ELEMS; };

  auto load_next = [&](int s) {
    const int k = live_s[next_k];
    const int c0 = next_c0;
    next_c0 += TBK;
    if (next_c0 >= cin) {
      next_c0 = 0;
      next_k += split;
    }
    __nv_bfloat16* as = stage_a(s);
    __nv_bfloat16* bs = stage_b(s);
#pragma unroll
    for (int i = 0; i < (TBM * T::A_CH + NTH - 1) / NTH; ++i) {
      const int e = tid + i * NTH;
      if ((TBM * T::A_CH) % NTH != 0 && e >= TBM * T::A_CH) break;
      const int r = e / T::A_CH, ch = (e % T::A_CH) * 8;
      const int src = map_s[r * k_vol + k];
      const bool ok = src >= 0 && c0 + ch < cin;
      const __nv_bfloat16* g = ok ? x + (size_t)src * cin + c0 + ch : x;
      cp_async_16(smem_u32(as + r * T::A_LD + ch), g, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < (TBK * T::B_CH + NTH - 1) / NTH; ++i) {
      const int e = tid + i * NTH;
      if ((TBK * T::B_CH) % NTH != 0 && e >= TBK * T::B_CH) break;
      const int kr = e / T::B_CH, ch = (e % T::B_CH) * 8;
      const bool ok = c0 + kr < cin && col0 + ch < cout;
      const __nv_bfloat16* g =
          ok ? w + ((size_t)k * cin + c0 + kr) * cout + col0 + ch : w;
      cp_async_16(smem_u32(bs + kr * T::B_LD + ch), g, ok ? 16 : 0);
    }
  };

  const int wm = warp / T::WN, wn = warp % T::WN;
  float acc[T::MT][T::NTL][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto compute = [&](int s) {
    const __nv_bfloat16* as = stage_a(s);
    const __nv_bfloat16* bs = stage_b(s);
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const int r = wm * T::TM + i * 16 + (lane & 15);
        ldmatrix_x4(a[i], smem_u32(as + r * T::A_LD + kk + (lane >> 4) * 8));
      }
      uint32_t b[T::NTL][2];
#pragma unroll
      for (int j = 0; j < T::NTL; j += 2) {
        const int kr = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn * T::TN + j * 8 + (lane >> 4) * 8;
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, smem_u32(bs + kr * T::B_LD + c));
        b[j][0] = r4[0];
        b[j][1] = r4[1];
        b[j + 1][0] = r4[2];
        b[j + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NTL; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  };

  // 4. the ring: steps t+1..t+3 in flight while step t multiplies
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_steps) load_next(s);
    cp_async_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<TC_STAGES - 2>();  // step t has landed (this thread's part)
    __syncthreads();                 // ... everyone's; slot t-1 is free
    if (t + TC_STAGES - 1 < n_steps) load_next((t + TC_STAGES - 1) % TC_STAGES);
    cp_async_commit();
    compute(t % TC_STAGES);
  }
  cp_async_wait<0>();

  // 5. epilogue. accumulator q of tile (i, j): row g + 8 * (q / 2), column
  // 2 * (lane % 4) + q % 2 of the 16 x 8 tile, g = lane / 4
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NTL; ++j) {
        const int c = col0 + wn * T::TN + j * 8 + c2;
        if (c >= cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + wm * T::TM + i * 16 + g + 8 * h;
          if (r < n_out)
            *reinterpret_cast<float2*>(out + (size_t)r * cout + c) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    return;
  }

  // split: partial tile into this block's shared memory (the stages are done)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::TM + i * 16 + g + 8 * h;
        const int c = wn * T::TN + j * 8 + c2;
        *reinterpret_cast<float2*>(red + r * T::RED_LD + c) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every part's partial is in place
  for (int e = tid; e < rows_per_part * (TBN / 4); e += NTH) {
    const int r = part * rows_per_part + e / (TBN / 4);
    const int c = (e % (TBN / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < split; ++q) {  // rank order: deterministic
      const float* peer = cluster.map_shared_rank(red, q);
      const float4 v = *reinterpret_cast<const float4*>(peer + r * T::RED_LD + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (row0 + r < n_out && col0 + c < cout)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * cout + col0 + c) = s;
  }
  cluster.sync();  // no block leaves while a peer still reads its partial
}

// ------------------------------------ tensor cores, a wide kernel volume

// The tensor-core tile above for a K whose [TBM, K] map block does not fit
// shared memory (K = 3^6 = 729 at the 6-D k3 convs: 373 KB a block). The map
// block is staged in chunks of WK_CHUNK offsets instead; each chunk lists its
// live offsets (those with a live row in the tile) and walks them through the
// same cp.async ring and mma.sync products, the accumulators staying in
// registers across all chunks. A chunk with no live offset costs its map read
// alone; a tile with none writes zeros. The ring drains at each chunk's end,
// since the next chunk's map rewrites the block the loads index.
//
// With `words` given, part 0 of each tile's first column block adds the
// (row-tile x live offset) steps it walked, as TBM rows each, to words[0]
// and the live map entries of its rows to words[1]: the share of the walk
// that gathers a live row.

constexpr int WK_CHUNK = 128;              // offsets a staged map chunk holds
constexpr int WK_LD = WK_CHUNK + 1;        // its row stride: conflict-free columns

template <int TBM, int TBN, int TBK>
struct TcwTile {
  using T = TcTile<TBM, TBN, TBK>;
  // keep in step with tcw_smem_bytes in sparse/conv_kernel.py: the ring (or
  // the split's partial tile), the map chunk, its live flags and list, and
  // three counters
  static constexpr size_t SMEM_BYTES =
      T::BUF_BYTES + (size_t)(TBM * WK_LD + 2 * WK_CHUNK + 4) * sizeof(int);
};

template <int TBM, int TBN, int TBK>
__global__ void __launch_bounds__(TcTile<TBM, TBN, TBK>::THREADS)
gather_gemm_tcw(const __nv_bfloat16* __restrict__ x, const int* __restrict__ nbr,
                const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                int n_out, int k_vol, int cin, int cout,
                unsigned long long* __restrict__ words) {
  using T = TcTile<TBM, TBN, TBK>;
  constexpr int NTH = T::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  int* map_s = reinterpret_cast<int*>(smem + T::BUF_BYTES);  // [TBM, WK_LD]
  int* flag_s = map_s + TBM * WK_LD;                          // live flags
  int* list_s = flag_s + WK_CHUNK;                            // live columns
  int* n_live_s = list_s + WK_CHUNK;
  int* entries_s = n_live_s + 1;                              // live entries

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TBM, col0 = blockIdx.y * TBN;
  const int split = gridDim.z, part = blockIdx.z;
  const int rows_here = min(TBM, n_out - row0);
  const bool counting = words != nullptr && blockIdx.y == 0 && part == 0;
  const int csteps = (cin + TBK - 1) / TBK;
  if (tid == 0) *entries_s = 0;

  auto stage_a = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * T::STAGE_BYTES);
  };
  auto stage_b = [&](int s) { return stage_a(s) + T::A_ELEMS; };

  const int wm = warp / T::WN, wn = warp % T::WN;
  float acc[T::MT][T::NTL][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto compute = [&](int s) {
    const __nv_bfloat16* as = stage_a(s);
    const __nv_bfloat16* bs = stage_b(s);
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const int r = wm * T::TM + i * 16 + (lane & 15);
        ldmatrix_x4(a[i], smem_u32(as + r * T::A_LD + kk + (lane >> 4) * 8));
      }
      uint32_t b[T::NTL][2];
#pragma unroll
      for (int j = 0; j < T::NTL; j += 2) {
        const int kr = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn * T::TN + j * 8 + (lane >> 4) * 8;
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, smem_u32(bs + kr * T::B_LD + c));
        b[j][0] = r4[0];
        b[j][1] = r4[1];
        b[j + 1][0] = r4[2];
        b[j + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NTL; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  };

  long long walked = 0;
  for (int k0 = 0; k0 < k_vol; k0 += WK_CHUNK) {
    const int kc = min(WK_CHUNK, k_vol - k0);
    // 1. the chunk's map block: each row's kc entries are contiguous
    for (int c = tid; c < WK_CHUNK; c += NTH) flag_s[c] = 0;
    __syncthreads();
    int mine = 0;
    for (int e = tid; e < TBM * WK_CHUNK; e += NTH) {
      const int r = e / WK_CHUNK, c = e % WK_CHUNK;
      if (c >= kc) continue;
      const int v = r < rows_here ? __ldg(nbr + (size_t)(row0 + r) * k_vol + k0 + c) : -1;
      map_s[r * WK_LD + c] = v;
      if (v >= 0) {
        flag_s[c] = 1;  // every writer stores the same value
        ++mine;
      }
    }
    if (counting && mine) atomicAdd(entries_s, mine);
    __syncthreads();
    // 2. its live columns, in order (one warp, a ballot a 32 columns)
    if (warp == 0) {
      int n = 0;
      for (int c0 = 0; c0 < WK_CHUNK; c0 += 32) {
        const int c = c0 + lane;
        const bool live = c < kc && flag_s[c];
        const unsigned m = __ballot_sync(0xffffffffu, live);
        if (live) list_s[n + __popc(m & ((1u << lane) - 1u))] = c;
        n += __popc(m);
      }
      if (lane == 0) *n_live_s = n;
    }
    __syncthreads();
    const int n_live = *n_live_s;
    walked += n_live;

    // 3. this part's steps of the chunk: live columns p, p + split, ...,
    // each in slices of TBK input channels, through the ring
    const int my_offsets = n_live > part ? (n_live - part + split - 1) / split : 0;
    const int n_steps = my_offsets * csteps;
    int next_i = part, next_c0 = 0;
    auto load_next = [&](int s) {
      const int c = list_s[next_i];
      const int k = k0 + c;
      const int c0 = next_c0;
      next_c0 += TBK;
      if (next_c0 >= cin) {
        next_c0 = 0;
        next_i += split;
      }
      __nv_bfloat16* as = stage_a(s);
      __nv_bfloat16* bs = stage_b(s);
#pragma unroll
      for (int i = 0; i < (TBM * T::A_CH + NTH - 1) / NTH; ++i) {
        const int e = tid + i * NTH;
        if ((TBM * T::A_CH) % NTH != 0 && e >= TBM * T::A_CH) break;
        const int r = e / T::A_CH, ch = (e % T::A_CH) * 8;
        const int src = map_s[r * WK_LD + c];
        const bool ok = src >= 0 && c0 + ch < cin;
        const __nv_bfloat16* g = ok ? x + (size_t)src * cin + c0 + ch : x;
        cp_async_16(smem_u32(as + r * T::A_LD + ch), g, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < (TBK * T::B_CH + NTH - 1) / NTH; ++i) {
        const int e = tid + i * NTH;
        if ((TBK * T::B_CH) % NTH != 0 && e >= TBK * T::B_CH) break;
        const int kr = e / T::B_CH, ch = (e % T::B_CH) * 8;
        const bool ok = c0 + kr < cin && col0 + ch < cout;
        const __nv_bfloat16* g =
            ok ? w + ((size_t)k * cin + c0 + kr) * cout + col0 + ch : w;
        cp_async_16(smem_u32(bs + kr * T::B_LD + ch), g, ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int s = 0; s < TC_STAGES - 1; ++s) {
      if (s < n_steps) load_next(s);
      cp_async_commit();
    }
    for (int t = 0; t < n_steps; ++t) {
      cp_async_wait<TC_STAGES - 2>();
      __syncthreads();
      if (t + TC_STAGES - 1 < n_steps) load_next((t + TC_STAGES - 1) % TC_STAGES);
      cp_async_commit();
      compute(t % TC_STAGES);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the chunk's map are free again
  }
  if (counting && tid == 0) {
    atomicAdd(words, (unsigned long long)walked * TBM);
    atomicAdd(words + 1, (unsigned long long)*entries_s);
  }

  // 4. epilogue, as the tensor-core tile's
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NTL; ++j) {
        const int c = col0 + wn * T::TN + j * 8 + c2;
        if (c >= cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + wm * T::TM + i * 16 + g + 8 * h;
          if (r < n_out)
            *reinterpret_cast<float2*>(out + (size_t)r * cout + c) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    return;
  }
  const int rows_per_part = TBM / split;
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NTL; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::TM + i * 16 + g + 8 * h;
        const int c = wn * T::TN + j * 8 + c2;
        *reinterpret_cast<float2*>(red + r * T::RED_LD + c) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = tid; e < rows_per_part * (TBN / 4); e += NTH) {
    const int r = part * rows_per_part + e / (TBN / 4);
    const int c = (e % (TBN / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < split; ++q) {
      const float* peer = cluster.map_shared_rank(red, q);
      const float4 v = *reinterpret_cast<const float4*>(peer + r * T::RED_LD + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (row0 + r < n_out && col0 + c < cout)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * cout + col0 + c) = s;
  }
  cluster.sync();
}

template <int TBM, int TBN, int TBK>
cudaError_t launch_tcw(const void* x, const void* nbr, const void* w, void* out,
                       int n_out, int k_vol, int cin, int cout, int split,
                       unsigned long long* words, cudaStream_t stream) {
  using T = TcTile<TBM, TBN, TBK>;
  const size_t smem = TcwTile<TBM, TBN, TBK>::SMEM_BYTES;
  auto kernel = gather_gemm_tcw<TBM, TBN, TBK>;
  static bool smem_allowed = false;  // per instance, once
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_out + TBM - 1) / TBM, (cout + TBN - 1) / TBN, split);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const int*>(nbr),
                            static_cast<const __nv_bfloat16*>(w),
                            static_cast<float*>(out), n_out, k_vol, cin, cout, words);
}

template <int TBM, int TBN, int TBK>
cudaError_t launch_tc(const void* x, const void* nbr, const void* w, void* out,
                      int n_out, int k_vol, int cin, int cout, int split,
                      cudaStream_t stream) {
  using T = TcTile<TBM, TBN, TBK>;
  const size_t smem = T::smem_bytes(k_vol);
  auto kernel = gather_gemm_tc<TBM, TBN, TBK>;
  static size_t smem_allowed = 0;  // per instance; raised once per size
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_out + TBM - 1) / TBM, (cout + TBN - 1) / TBN, split);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;  // the parts of one tile: one cluster
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const int*>(nbr),
                            static_cast<const __nv_bfloat16*>(w),
                            static_cast<float*>(out), n_out, k_vol, cin, cout);
}

using TcLaunch = cudaError_t (*)(const void*, const void*, const void*, void*,
                                 int, int, int, int, int, cudaStream_t);
using TcwLaunch = cudaError_t (*)(const void*, const void*, const void*, void*,
                                  int, int, int, int, int, unsigned long long*,
                                  cudaStream_t);

// the tensor-core instances: (bm, bn, bk) -> launchers of the tile and of
// its wide-K form. Keep in step with TC_TILES in sparse/conv_kernel.py.
struct TcInstance {
  int bm, bn, bk;
  TcLaunch launch;
  TcwLaunch launch_wide;
};
constexpr TcInstance TC_INSTANCES[] = {
    {128, 32, 32, launch_tc<128, 32, 32>, launch_tcw<128, 32, 32>},
    {128, 64, 32, launch_tc<128, 64, 32>, launch_tcw<128, 64, 32>},
    {128, 128, 32, launch_tc<128, 128, 32>, launch_tcw<128, 128, 32>},
    {128, 128, 64, launch_tc<128, 128, 64>, launch_tcw<128, 128, 64>},
};

}  // namespace

// x [n_in, cin], nbr int32 [n_out, k_vol], w [k_vol, cin, cout], all
// row-major and contiguous; out f32 [n_out, cout]. Map entries must be -1 or
// a row of x. `variant` 0 is the scalar kernel (is_bf16 selects bf16 or f32
// operands; bm, bn, bk and split are ignored); 1 the tensor-core kernel
// (bf16, cin and cout multiples of 8, x, w and out 16-byte aligned) with a
// bm x bn tile of one of TC_INSTANCES, bk input channels a step, and the
// live offsets split over `split` blocks of a cluster (1..8, dividing bm);
// 2 the cin = 1 kernel (bf16 or f32) with bm rows a block (32, 64 or 128;
// bn, bk and split are ignored) and out 16-byte aligned; 3 the tensor-core
// kernel's wide-K form (as 1, the map staged in chunks of offsets), which
// adds its walked steps and live entries to `words` (two uint64, or null).
// Launches on `stream` and returns a CUDA error code (cudaErrorInvalidValue
// for a combination that has no kernel).
extern "C" int sparse_conv_gather_gemm(const void* x, const void* nbr,
                                       const void* w, void* out, int n_out,
                                       int k_vol, int cin, int cout,
                                       int is_bf16, int variant, int bm, int bn,
                                       int bk, int split, void* words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
    if (is_bf16) {
      gather_gemm_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(nbr),
          static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out),
          n_out, k_vol, cin, cout);
    } else {
      gather_gemm_kernel<float><<<grid, NT, 0, s>>>(
          static_cast<const float*>(x), static_cast<const int*>(nbr),
          static_cast<const float*>(w), static_cast<float*>(out),
          n_out, k_vol, cin, cout);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 2) {
    if (cin != 1 || (bm != 32 && bm != 64 && bm != C1_MAX_BM))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        is_bf16 ? launch_cin1<__nv_bfloat16>(x, nbr, w, out, n_out, k_vol, cout, bm, s)
                : launch_cin1<float>(x, nbr, w, out, n_out, k_vol, cout, bm, s));
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if ((variant != 1 && variant != 3) || !is_bf16 || cin % 8 != 0 || cout % 8 != 0 ||
      !aligned || split < 1 || split > TC_MAX_SPLIT || bm % split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const TcInstance& inst : TC_INSTANCES) {
    if (inst.bm != bm || inst.bn != bn || inst.bk != bk) continue;
    const cudaError_t e =
        variant == 1
            ? inst.launch(x, nbr, w, out, n_out, k_vol, cin, cout, split, s)
            : inst.launch_wide(x, nbr, w, out, n_out, k_vol, cin, cout, split,
                               static_cast<unsigned long long*>(words), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
