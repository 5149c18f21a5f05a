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
// Four variants, chosen by the wrapper's plan
// (sparse/conv_kernel.py::conv_plan) from dtype and shape, never by a failed
// launch:
//
// * Tensor cores (bf16, cin % 8 == 0, cout % 8 == 0, 16-byte aligned x, w and
//   out; every conv of the main path). One block per 128 x BN output tile
//   (BN 32, 64 or 128: one warp per 32 rows, one or two across), for each
//   part of a split of the offsets. Its shared memory grows with K (the map
//   block); the plan narrows BK, then BN, to stay within the H100's 227 KB
//   per block, and sends a K that fits no tile (K > 351) to the wide-K walk
//   (below). The tile:
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
// * The wide-K walk (bf16, K > 351: the 6-D k3 convs, K 729): the live
//   entries listed per offset on the card, then products weight-stationary
//   per offset, each row's sum in ascending offset order (its own section
//   below says how and what bounds it).
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

// ------------------------------- tensor cores, a wide kernel volume: the walk

// A K whose [128, K] map block does not fit a tensor-core tile's shared
// memory (K = 3^6 = 729 at the 6-D k3 convs: 373 KB a block). Such maps are
// sparse (DGR's hold 0.25 % live entries), so an output-stationary tile
// would walk offsets that each gather a few live rows of 128 and reload W[k]
// at every step (95 MB at 256 x 256, over the 50 MB L2). This form is
// weight-stationary: the live entries are listed on the card by (rank,
// offset), a row's rank-r entry being its r-th live offset in ascending
// order, and each chunk of one such list is one product with W[k] staged
// once. Round r (every row's rank-r entry) holds one entry a row. The
// offsets are walked in passes of `ob` (the plan's, so that a pass's W
// slices stay in L2 across its rounds): the lists, and the chunks, run in
// (pass, rank, offset) order. Five kernels, all named gather_gemm_tcw*:
//
// 1. gather_gemm_tcw_zero: the counts, the items' words, the tickets.
// 2. gather_gemm_tcw_scan: reads the dense map once (a warp's 32 rows, 32
//    offsets a stage, staged by 4-byte cp.async two stages deep); a lane
//    per row walks its row's offsets in order, so it knows each live
//    entry's rank. The warp's entries at one offset take consecutive slots
//    of that offset's list (tmp[k * n_out ...], one entry a row at most) by
//    one integer atomicAdd, and each (rank, offset) pair counts its
//    entries. Rows with no live entry are written 0 here; every row's flag
//    is reset.
// 3. gather_gemm_tcw_order: a block an item (pass, rank), taken by ticket
//    in that order: its pairs' first entries and chunks of TW_BM entries,
//    one descriptor a chunk, after the earlier items' totals (a look-back
//    over words they publish at once, so none waits long).
// 4. gather_gemm_tcw_fill: moves every entry from its offset's list to its
//    pair's place in (pass, rank, offset) order.
// 5. gather_gemm_tcw_walk<BN>: persistent blocks claim chunks by ticket, in
//    that order. A chunk gathers its input rows, stages W[k] once (TW_BK
//    input channels a step, through a cp.async ring into mma.sync products
//    as the tile above; 16-row groups past its entries skipped), then
//    commits each row: out = (rank 0 ? 0 : out) + product. A rank-r commit
//    waits until the row's flag shows r entries in, then raises it. The
//    row's rank r-1 entry lies at a lower offset, so in the same pass or an
//    earlier one, at a lower rank: an earlier ticket. So each row sums its
//    products in ascending offset order, one writer at a time, with no
//    float atomic, and two calls are bit-equal (an mma row does not depend
//    on the other rows of its tile, so the order within a list does not
//    matter). Only running blocks hold tickets and a chunk waits only on
//    earlier tickets, so the earliest unfinished chunk never waits (a wait
//    that outlasts TW_MAX_POLLS polls traps: a broken order fails the
//    launch rather than hanging the card). Rank-major order keeps a row's
//    entries a round apart; ordered by offset, rows that share chunks
//    would chain the commits offset after offset.
//
// What bounds it: the dense map, read once a conv (0.38 GB at 131 072 x 729,
// 0.114 ms at 3.35 TB/s), against the few MB of weights, gathered rows and
// output that the live entries need. The walk reads the map once, into
// lists of the live entries alone, and a residual block's two convs share
// that read (below). The walk moves, per live entry, a gathered row and its
// f32 output row read and written, and W[k] once a chunk, from L2 while a
// pass's slices fit it.
//
// With `words` given, the launch tallies on the card: words[0] the row slots
// the products cover (each (rank, offset) list rounded up to 16-row
// groups), words[1] the live entries (both as the order kernel totals the
// lists), words[2] the entries whose commit found its row's earlier entry
// not yet in.
//
// Calls on the same map in a row may share one build (the wrapper's
// shared_lists scope): gather_gemm_tcw_reset then readies the kept lists
// (the rows' flags, the dead rows' zeros, the ticket) for the next walk.

constexpr int SC_ROWS = 32;                // rows a scan block: one warp, a lane each
constexpr int SC_CHUNK = 32;               // offsets of a stage
constexpr int SC_LD = SC_CHUNK + 1;        // staged row stride: conflict-free
constexpr int RANK_SHIFT = 22;             // a list entry: row | rank << 22
constexpr unsigned ROW_MASK = (1u << RANK_SHIFT) - 1u;
// the walk's sizes: rows and ranks fit a list entry, map slots an int32
__host__ __device__ __forceinline__ bool tcw_fits(int n_out, int k_vol) {
  return n_out >= 1 && (unsigned)n_out <= ROW_MASK + 1u && k_vol >= 1 &&
         k_vol <= (1 << (32 - RANK_SHIFT)) && (long long)n_out * k_vol < (1ll << 31);
}
constexpr int OR_THREADS = 256;            // an order block
constexpr int OR_PER = 4;                  // its pairs a thread: ob <= 1024
constexpr int FILL_THREADS = 256;
constexpr int TW_BM = 64;                  // entries a chunk
constexpr int TW_BK = 32;                  // input channels a step
constexpr int TW_GROUP = 16;               // rows of an mma tile
constexpr int TW_STAGES = 4;               // cp.async ring depth
constexpr unsigned TW_MAX_POLLS = 1u << 24;  // a commit's wait (over a second) before it traps
constexpr unsigned long long ITEM_DONE = 1ull << 63;  // an item's word: done | entries << 24 | chunks

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// the pair of an entry: (pass, rank, offset in the pass), pass-major
__host__ __device__ __forceinline__ size_t pair_of(int rank, int k, int k_vol, int ob) {
  return ((size_t)(k / ob) * k_vol + rank) * ob + k % ob;
}

// the scratch, int32 (keep in step with _tcw_layout in
// sparse/conv_kernel.py). Zeroed each call, contiguous: the items' words
// [2 * passes * K] (first: 8-byte aligned), eight words (walk ticket,
// highest rank, chunks, order ticket, entries, slots), the pairs' counts
// [passes * K * ob], each offset's count [K]. Then: the pairs' first
// entries [passes * K * ob], the offsets' first entries [K + 1], the
// chunks' descriptors (offset, first entry, entries) [3 * max_chunks], the
// rows' flags [n_out], the offsets' lists [K * n_out] and the pairs' lists
// [K * n_out]. Entries are counted in int32: n_out * K < 2^31.
struct TcwScratch {
  int *cnt2, *cnt1, *misc, *first, *off1, *desc, *done;
  unsigned long long* item;
  unsigned *tmp, *lists;
  __host__ __device__ static size_t pairs(int k_vol, int ob) {
    return (size_t)((k_vol + ob - 1) / ob) * k_vol * ob;
  }
  __host__ __device__ static size_t max_chunks(int n_out, int k_vol, int ob) {
    return (size_t)n_out * k_vol / TW_BM + pairs(k_vol, ob);
  }
  __host__ __device__ static size_t zeroed(int k_vol, int ob) {
    return pairs(k_vol, ob) + k_vol + 8 + 2 * (size_t)((k_vol + ob - 1) / ob) * k_vol;
  }
  __host__ __device__ static size_t ints(int n_out, int k_vol, int ob) {
    return zeroed(k_vol, ob) + pairs(k_vol, ob) + k_vol + 1 +
           3 * max_chunks(n_out, k_vol, ob) + n_out + 2 * (size_t)k_vol * n_out;
  }
  TcwScratch(int* s, int n_out, int k_vol, int ob) {
    item = reinterpret_cast<unsigned long long*>(s);
    misc = s + 2 * (size_t)((k_vol + ob - 1) / ob) * k_vol;
    cnt2 = misc + 8;
    cnt1 = cnt2 + pairs(k_vol, ob);
    first = s + zeroed(k_vol, ob);
    off1 = first + pairs(k_vol, ob);
    desc = off1 + k_vol + 1;
    done = desc + 3 * max_chunks(n_out, k_vol, ob);
    tmp = reinterpret_cast<unsigned*>(done + n_out);
    lists = tmp + (size_t)k_vol * n_out;
  }
};

__global__ void gather_gemm_tcw_zero(int* __restrict__ s, size_t n,
                                     unsigned long long* __restrict__ words) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x)
    s[e] = 0;
  if (blockIdx.x == 0 && words != nullptr && threadIdx.x < 3) words[threadIdx.x] = 0;
}

__global__ void __launch_bounds__(SC_ROWS)
gather_gemm_tcw_scan(const int* __restrict__ nbr, float* __restrict__ out, int n_out,
                     int k_vol, int cout, int ob, int* __restrict__ cnt2,
                     int* __restrict__ cnt1, int* __restrict__ misc,
                     unsigned* __restrict__ tmp, int* __restrict__ done) {
  __shared__ int map_s[2][SC_ROWS * SC_LD];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * SC_ROWS;
  const int rows = min(SC_ROWS, n_out - row0);
  const int i = row0 + lane;
  const int stages = (k_vol + SC_CHUNK - 1) / SC_CHUNK;

  // the warp's rows x SC_CHUNK offsets of stage s into buffer s % 2: each
  // row's entries are contiguous, the 32 lanes one row's 128 bytes
  auto issue = [&](int s) {
    const int k0 = s * SC_CHUNK, kc = min(SC_CHUNK, k_vol - k0);
    int* buf = map_s[s & 1];
    if (lane < kc)
      for (int r = 0; r < rows; ++r)
        cp_async_4(smem_u32(buf + r * SC_LD + lane), nbr + (size_t)(row0 + r) * k_vol + k0 + lane);
    cp_async_commit();
  };

  unsigned rank = 0;  // this row's live entries so far
  issue(0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int k0 = s * SC_CHUNK, kc = min(SC_CHUNK, k_vol - k0);
    const int* buf = map_s[s & 1];
    // this lane's row, offsets in order; the warp's entries at an offset
    // take consecutive slots of its list, and each rank among them counts
    for (int c = 0; c < kc; ++c) {
      const bool live = lane < rows && buf[lane * SC_LD + c] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (m == 0) continue;
      const int k = k0 + c;
      const int leader = __ffs(m) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(cnt1 + k, __popc(m));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (live) {
        const int slot = base + __popc(m & ((1u << lane) - 1u));
        tmp[(size_t)k * n_out + slot] = (unsigned)i | (rank << RANK_SHIFT);
        const unsigned same = __match_any_sync(m, rank);
        if (lane == __ffs(same) - 1)
          atomicAdd(cnt2 + pair_of((int)rank, k, k_vol, ob), __popc(same));
        ++rank;
      }
    }
    __syncwarp();  // buffer s % 2 is free for stage s + 2
  }
  if (lane < rows) done[i] = 0;
  unsigned top = rank;  // the warp's highest rank + 1
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) top = max(top, __shfl_xor_sync(0xffffffffu, top, o));
  if (lane == 0 && top > 0) atomicMax(misc + 1, (int)top - 1);
  // rows with no live entry: exact zeros (16-byte stores along each row)
  const unsigned dead = __ballot_sync(0xffffffffu, lane < rows && rank == 0);
  const int q = cout / 4;
  for (unsigned d = dead; d; d &= d - 1) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)(row0 + __ffs(d) - 1) * cout);
    for (int e = lane; e < q; e += 32) o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// block-wide exclusive scan of one value a thread (OR_THREADS threads);
// returns the thread's prefix, `total` the sum
__device__ __forceinline__ int block_scan(int v, int* warp_s, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += u;
  }
  if (lane == 31) warp_s[warp] = s;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < OR_THREADS / 32; ++w) {
    const int x = warp_s[w];
    if (w < warp) before += x;
    total += x;
  }
  __syncthreads();  // warp_s is free again
  return before + s - v;
}

// One item (pass b, rank r) a block, taken by ticket in (pass, rank) order:
// items past the highest rank have no entry and exit. The item's pairs
// (offsets b*ob .. of rank r): their entries' and chunks' totals published
// at once as the item's word, then the earlier items' words summed (each
// published before its block looks back, so none waits long), then each
// pair's first entry and its chunks' descriptors. The first item also
// lays out the offsets' lists (off1); the last sets the totals.
__global__ void __launch_bounds__(OR_THREADS)
gather_gemm_tcw_order(const int* __restrict__ cnt2, const int* __restrict__ cnt1, int k_vol,
                      int ob, int* misc, unsigned long long* item, int* __restrict__ first,
                      int* __restrict__ off1, int* __restrict__ desc) {
  __shared__ int warp_s[OR_THREADS / 32];
  __shared__ int claim_s;
  __shared__ unsigned long long sum_s[2];
  const int tid = threadIdx.x;
  if (tid == 0) claim_s = atomicAdd(misc + 3, 1);
  if (tid < 2) sum_s[tid] = 0;
  __syncthreads();
  const int j = claim_s, ranks = misc[1] + 1;
  const int passes = (k_vol + ob - 1) / ob;
  if (j >= passes * ranks) return;
  const int b = j / ranks, r = j % ranks;
  const size_t p0 = ((size_t)b * k_vol + r) * ob;
  const int kn = min(ob, k_vol - b * ob);
  // this thread's pairs: OR_PER consecutive offsets of the pass
  int cnt[OR_PER], ents = 0, chunks = 0, slots = 0;
#pragma unroll
  for (int u = 0; u < OR_PER; ++u) {
    const int kl = tid * OR_PER + u;
    cnt[u] = kl < kn ? cnt2[p0 + kl] : 0;
    ents += cnt[u];
    chunks += (cnt[u] + TW_BM - 1) / TW_BM;
    slots += (cnt[u] + TW_GROUP - 1) / TW_GROUP * TW_GROUP;
  }
  int e_total, c_total;
  const int e_before = block_scan(ents, warp_s, e_total);
  const int c_before = block_scan(chunks, warp_s, c_total);
  if (tid == 0)
    st_release(item + j, ITEM_DONE | (unsigned long long)e_total << 24 | (unsigned)c_total);
  // the earlier items' totals
  unsigned long long e_base = 0, c_base = 0;
  for (int t = tid; t < j; t += OR_THREADS) {
    unsigned long long v;
    unsigned polls = 0;
    while (!((v = ld_acquire(item + t)) & ITEM_DONE)) {
      __nanosleep(32);
      if (++polls > TW_MAX_POLLS) __trap();
    }
    e_base += (v >> 24) & 0xFFFFFFull;
    c_base += v & 0xFFFFFFull;
  }
  e_base = warp_sum(e_base);
  c_base = warp_sum(c_base);
  if ((tid & 31) == 0) {
    atomicAdd(sum_s, e_base);
    atomicAdd(sum_s + 1, c_base);
  }
  __syncthreads();
  int e0 = (int)sum_s[0] + e_before, t0 = (int)sum_s[1] + c_before;
#pragma unroll
  for (int u = 0; u < OR_PER; ++u) {
    const int kl = tid * OR_PER + u;
    if (kl >= ob) break;
    first[p0 + kl] = e0;
    for (int e = 0; e < cnt[u]; e += TW_BM, ++t0) {
      desc[3 * t0] = b * ob + kl;
      desc[3 * t0 + 1] = e0 + e;
      desc[3 * t0 + 2] = min(TW_BM, cnt[u] - e);
    }
    e0 += cnt[u];
  }
  if (j == passes * ranks - 1 && tid == 0) {
    misc[2] = (int)sum_s[1] + c_total;
    misc[4] = (int)sum_s[0] + e_total;
  }
  if (j == 0) {  // the offsets' lists: an exclusive scan of their counts
    int c1[OR_PER], n1 = 0;
#pragma unroll
    for (int u = 0; u < OR_PER; ++u) {
      const int k = tid * OR_PER + u;
      c1[u] = k < k_vol ? cnt1[k] : 0;
      n1 += c1[u];
    }
    int all;
    int at = block_scan(n1, warp_s, all);
#pragma unroll
    for (int u = 0; u < OR_PER; ++u) {
      const int k = tid * OR_PER + u;
      if (k < k_vol) off1[k] = at;
      at += c1[u];
    }
    if (tid == 0) off1[k_vol] = all;
  }
  slots = (int)warp_sum((unsigned long long)slots);
  if ((tid & 31) == 0 && slots) atomicAdd(misc + 5, slots);
}

// Every entry from its offset's list to its pair's place: a grid of blocks
// strides over the entries in offsets' order; a pair's slots are taken off
// its count (which so ends at 0).
__global__ void __launch_bounds__(FILL_THREADS)
gather_gemm_tcw_fill(int n_out, int k_vol, int ob, const int* __restrict__ off1,
                     int* __restrict__ cnt2,
                     const int* __restrict__ first, const unsigned* __restrict__ tmp,
                     unsigned* __restrict__ lists) {
  extern __shared__ int off_s[];  // [k_vol + 1]
  for (int k = threadIdx.x; k <= k_vol; k += FILL_THREADS) off_s[k] = off1[k];
  __syncthreads();
  const int total = off_s[k_vol], lane = threadIdx.x & 31;
  for (int e0 = blockIdx.x * FILL_THREADS; e0 < total; e0 += gridDim.x * FILL_THREADS) {
    const int e = e0 + threadIdx.x;
    const bool have = e < total;
    const unsigned m = __ballot_sync(0xffffffffu, have);
    if (!have) continue;
    int lo = 0, hi = k_vol;  // off_s[lo] <= e < off_s[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off_s[mid] <= e) lo = mid;
      else hi = mid;
    }
    const unsigned v = tmp[(size_t)lo * n_out + (e - off_s[lo])];
    const size_t p = pair_of((int)(v >> RANK_SHIFT), lo, k_vol, ob);
    const unsigned same = __match_any_sync(m, (unsigned long long)p);
    const int leader = __ffs(same) - 1;
    int top = 0;
    if (lane == leader) top = atomicSub(cnt2 + p, __popc(same));
    top = __shfl_sync(same, top, leader);
    lists[first[p] + top - __popc(same) + __popc(same & ((1u << lane) - 1u))] = v;
  }
}

// A chunk's product tile: TW_BM entries x BN output channels, one warp per 32
// rows and 32 (BN 32) or 64 columns.
template <int BN>
struct TwTile {
  static constexpr int WM = TW_BM / 32, WN = BN == 32 ? 1 : BN / 64;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TN = BN / WN;                 // a warp's columns
  static constexpr int MT = 2, NTL = TN / 8;         // its mma tiles
  static constexpr int A_LD = TW_BK + 8;             // +16 bytes a staged row:
  static constexpr int B_LD = BN + 8;                // ldmatrix conflict-free
  static constexpr int A_ELEMS = TW_BM * A_LD, B_ELEMS = TW_BK * B_LD;
  static constexpr int A_CH = TW_BK / 8, B_CH = BN / 8;  // 16-byte chunks a row
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
  static constexpr int RING_BYTES = TW_STAGES * STAGE_BYTES;
  static constexpr bool BATCH_READS = BN >= 256;  // the epilogue's reads, see there
  static_assert(NTL % 2 == 0 && STAGE_BYTES % 16 == 0, "mma tiles, aligned stages");
  static_assert(THREADS >= TW_BM, "a thread a chunk row");
  // keep in step with tcw_smem_bytes in sparse/conv_kernel.py: the ring,
  // the chunk's rows, ranks and sources, the claimed chunk
  static constexpr size_t SMEM_BYTES = RING_BYTES + (3 * TW_BM + 4) * sizeof(int);
};

template <int BN>
__global__ void __launch_bounds__(TwTile<BN>::THREADS)
gather_gemm_tcw_walk(const __nv_bfloat16* __restrict__ x, const int* __restrict__ nbr,
                     const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                     int k_vol, int cin, int cout, int* misc, const int* __restrict__ desc,
                     const unsigned* __restrict__ lists,
                     int* __restrict__ done, unsigned long long* __restrict__ words) {
  using T = TwTile<BN>;
  constexpr int NTH = T::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  int* row_s = reinterpret_cast<int*>(smem + T::RING_BYTES);
  int* rank_s = row_s + TW_BM;
  int* src_s = rank_s + TW_BM;
  int* claim_s = src_s + TW_BM;  // ticket, offset, first entry, entries
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = misc[2];  // misc[0] is the ticket
  const int csteps = (cin + TW_BK - 1) / TW_BK;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int g = lane >> 2, c2 = (lane & 3) * 2;

  auto stage_a = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * T::STAGE_BYTES);
  };
  auto stage_b = [&](int s) { return stage_a(s) + T::A_ELEMS; };

  if (words != nullptr && blockIdx.x == 0 && tid == 0) {  // the lists' own totals
    words[0] = (unsigned)misc[5];
    words[1] = (unsigned)misc[4];
  }
  unsigned long long waited = 0;
  for (;;) {
    // 1. claim a chunk: its offset and entries
    if (tid == 0) {
      const int t = atomicAdd(misc, 1);
      claim_s[0] = t;
      if (t < total) {
        claim_s[1] = desc[3 * t];
        claim_s[2] = desc[3 * t + 1];
        claim_s[3] = desc[3 * t + 2];
      }
    }
    __syncthreads();
    if (claim_s[0] >= total) break;
    const int k = claim_s[1], e0 = claim_s[2], n = claim_s[3];
    const int n_rows = (n + TW_GROUP - 1) / TW_GROUP * TW_GROUP;  // rows the mma tiles cover
    if (tid < TW_BM) {
      int row = 0, rank = 0, src = -1;
      if (tid < n) {
        const unsigned v = lists[e0 + tid];
        row = (int)(v & ROW_MASK);
        rank = (int)(v >> RANK_SHIFT);
        src = __ldg(nbr + (size_t)row * k_vol + k);
      }
      row_s[tid] = row;
      rank_s[tid] = rank;
      src_s[tid] = src;
    }
    __syncthreads();

    for (int col0 = 0; col0 < cout; col0 += BN) {
      // 2. the product: the chunk's gathered rows by W[k], TW_BK channels a step
      auto load = [&](int s, int step) {
        const int c0 = step * TW_BK;
        __nv_bfloat16* as = stage_a(s);
        __nv_bfloat16* bs = stage_b(s);
#pragma unroll
        for (int i = 0; i < (TW_BM * T::A_CH + NTH - 1) / NTH; ++i) {
          const int e = tid + i * NTH;
          const int r = e / T::A_CH, ch = (e % T::A_CH) * 8;
          if (r >= n_rows) break;
          const int src = src_s[r];
          const bool ok = src >= 0 && c0 + ch < cin;
          const __nv_bfloat16* gp = ok ? x + (size_t)src * cin + c0 + ch : x;
          cp_async_16(smem_u32(as + r * T::A_LD + ch), gp, ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < (TW_BK * T::B_CH + NTH - 1) / NTH; ++i) {
          const int e = tid + i * NTH;
          if ((TW_BK * T::B_CH) % NTH != 0 && e >= TW_BK * T::B_CH) break;
          const int kr = e / T::B_CH, ch = (e % T::B_CH) * 8;
          const bool ok = c0 + kr < cin && col0 + ch < cout;
          const __nv_bfloat16* gp =
              ok ? w + ((size_t)k * cin + c0 + kr) * cout + col0 + ch : w;
          cp_async_16(smem_u32(bs + kr * T::B_LD + ch), gp, ok ? 16 : 0);
        }
      };

      float acc[T::MT][T::NTL][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NTL; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

      auto compute = [&](int s) {
        if (wm * 32 >= n) return;  // none of this warp's rows holds an entry
        const __nv_bfloat16* as = stage_a(s);
        const __nv_bfloat16* bs = stage_b(s);
#pragma unroll
        for (int kk = 0; kk < TW_BK; kk += 16) {
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
          for (int i = 0; i < T::MT; ++i) {
            if (wm * 32 + i * 16 >= n) continue;  // a 16-row group past the entries
            uint32_t a[4];
            const int r = wm * 32 + i * 16 + (lane & 15);
            ldmatrix_x4(a, smem_u32(as + r * T::A_LD + kk + (lane >> 4) * 8));
#pragma unroll
            for (int j = 0; j < T::NTL; ++j) mma_bf16_16816(acc[i][j], a, b[j][0], b[j][1]);
          }
        }
      };

#pragma unroll
      for (int s = 0; s < TW_STAGES - 1; ++s) {
        if (s < csteps) load(s, s);
        cp_async_commit();
      }
      for (int st = 0; st < csteps; ++st) {
        cp_async_wait<TW_STAGES - 2>();
        __syncthreads();
        if (st + TW_STAGES - 1 < csteps)
          load((st + TW_STAGES - 1) % TW_STAGES, st + TW_STAGES - 1);
        cp_async_commit();
        compute(st % TW_STAGES);
      }
      cp_async_wait<0>();

      // 3. commit: once a chunk, wait until each row's earlier entries are in
      if (col0 == 0) {
        const int rank = tid < n ? rank_s[tid] : 0;
        if (rank > 0) {
          const int* f = done + row_s[tid];
          if (ld_acquire(f) != rank) {
            ++waited;
            unsigned polls = 0;
            while (ld_acquire(f) != rank) {
              __nanosleep(64);
              if (++polls > TW_MAX_POLLS) __trap();  // an order that cannot come
            }
          }
        }
        __syncthreads();
      }
      // accumulator q of tile (i, j): row g + 8 * (q / 2), column
      // 2 * (lane % 4) + q % 2 of the 16 x 8 tile. A rank > 0 row adds its
      // sum so far (written on another SM). The compiler cannot tell the
      // chunk's rows apart, so each read waits on the stores before it:
      // the widest tile, whose blocks an SM holds are bounded by shared
      // memory and not by registers, reads an m-tile's sums before any of
      // its stores (the other tiles lose more to registers than they gain)
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        if constexpr (T::BATCH_READS) {
#pragma unroll
          for (int j = 0; j < T::NTL; ++j) {
            const int c = col0 + wn * T::TN + j * 8 + c2;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wm * 32 + i * 16 + g + 8 * h;
              if (c < cout && r < n && rank_s[r] > 0) {
                const float2 was =
                    __ldcg(reinterpret_cast<const float2*>(out + (size_t)row_s[r] * cout + c));
                acc[i][j][2 * h] = was.x + acc[i][j][2 * h];
                acc[i][j][2 * h + 1] = was.y + acc[i][j][2 * h + 1];
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < T::NTL; ++j) {
          const int c = col0 + wn * T::TN + j * 8 + c2;
          if (c >= cout) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + i * 16 + g + 8 * h;
            if (r >= n) continue;
            float2* o = reinterpret_cast<float2*>(out + (size_t)row_s[r] * cout + c);
            float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            if (!T::BATCH_READS && rank_s[r] > 0) {
              const float2 was = __ldcg(o);
              v.x = was.x + v.x;
              v.y = was.y + v.y;
            }
            *o = v;
          }
        }
      }
      __syncthreads();  // the ring is free again
    }
    // 4. the chunk's rows are in: raise their flags
    __threadfence();
    __syncthreads();
    if (tid < n) st_release(done + row_s[tid], rank_s[tid] + 1);
  }
  if (words != nullptr) {
    const unsigned long long s = warp_sum(waited);
    if (lane == 0 && s) atomicAdd(words + 2, s);
  }
}

// Lists kept from the last call on the same map: each row's flag, which the
// last walk left at the row's live entries, back to 0, the rows with none
// written 0 in the new output, and the walk's ticket and tally reset.
__global__ void __launch_bounds__(256)
gather_gemm_tcw_reset(float* __restrict__ out, int n_out, int cout, int* __restrict__ misc,
                      int* __restrict__ done, unsigned long long* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const int q = cout / 4;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; i < n_out;
       i += (gridDim.x * blockDim.x) >> 5) {  // a warp a row
    if (done[i] == 0) {
      float4* o = reinterpret_cast<float4*>(out + (size_t)i * cout);
      for (int e = lane; e < q; e += 32) o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    if (lane == 0) done[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    misc[0] = 0;
    if (words != nullptr) words[2] = 0;
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

// the lists alone (zero, scan, order, fill): the walk's first four kernels
cudaError_t launch_tcw_lists(const void* nbr, void* out, int n_out, int k_vol, int cout, int ob,
                             int* scratch, unsigned long long* words, cudaStream_t stream) {
  const TcwScratch s(scratch, n_out, k_vol, ob);
  const size_t zeroed = TcwScratch::zeroed(k_vol, ob), blocks = (zeroed + 1023) / 1024;
  gather_gemm_tcw_zero<<<blocks < 256 ? (unsigned)blocks : 256u, 256, 0, stream>>>(
      scratch, zeroed, words);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gather_gemm_tcw_scan<<<(n_out + SC_ROWS - 1) / SC_ROWS, SC_ROWS, 0, stream>>>(
      static_cast<const int*>(nbr), static_cast<float*>(out), n_out, k_vol, cout, ob, s.cnt2,
      s.cnt1, s.misc, s.tmp, s.done);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int passes = (k_vol + ob - 1) / ob;
  gather_gemm_tcw_order<<<passes * k_vol, OR_THREADS, 0, stream>>>(
      s.cnt2, s.cnt1, k_vol, ob, s.misc, s.item, s.first, s.off1, s.desc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gather_gemm_tcw_fill<<<8 * multiprocessors(), FILL_THREADS, (k_vol + 1) * sizeof(int),
                         stream>>>(n_out, k_vol, ob, s.off1, s.cnt2, s.first, s.tmp, s.lists);
  return cudaGetLastError();
}

// the walk; `lists` 0: the lists built first, 1: kept from the last call on
// the same map, reset
template <int BN>
cudaError_t launch_tcw(const void* x, const void* nbr, const void* w, void* out, int n_out,
                       int k_vol, int cin, int cout, int ob, int lists, int* scratch,
                       unsigned long long* words, cudaStream_t stream) {
  using T = TwTile<BN>;
  const TcwScratch s(scratch, n_out, k_vol, ob);
  cudaError_t e;
  if (lists == 0) {
    e = launch_tcw_lists(nbr, out, n_out, k_vol, cout, ob, scratch, words, stream);
  } else {
    const int warps = (n_out + 31) / 32 * 4;  // a warp 8 rows
    gather_gemm_tcw_reset<<<(warps + 7) / 8, 256, 0, stream>>>(static_cast<float*>(out), n_out,
                                                              cout, s.misc, s.done, words);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  auto kernel = gather_gemm_tcw_walk<BN>;
  // per instance, once: the shared memory raised, and the persistent grid:
  // the blocks that fit an SM, times the SMs
  static int grid = 0;
  if (grid == 0) {
    int per_sm = 0;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)T::SMEM_BYTES)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::THREADS,
                                                           T::SMEM_BYTES)) != cudaSuccess)
      return e;
    grid = multiprocessors() * (per_sm > 0 ? per_sm : 1);
  }
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(nbr),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), k_vol, cin, cout, s.misc,
      s.desc, s.lists, s.done, words);
  return cudaGetLastError();
}

using TcwLaunch = cudaError_t (*)(const void*, const void*, const void*, void*, int, int,
                                  int, int, int, int, int*, unsigned long long*, cudaStream_t);

// the walk's instances: bn -> launcher. Keep in step with TCW_BNS in
// sparse/conv_kernel.py (bm TW_BM, bk TW_BK).
struct TcwInstance {
  int bn;
  TcwLaunch launch;
};
constexpr TcwInstance TCW_INSTANCES[] = {
    {32, launch_tcw<32>}, {64, launch_tcw<64>}, {128, launch_tcw<128>}, {256, launch_tcw<256>}};

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

// the tensor-core instances: (bm, bn, bk) -> launcher of the tile. Keep in
// step with TC_TILES in sparse/conv_kernel.py.
struct TcInstance {
  int bm, bn, bk;
  TcLaunch launch;
};
constexpr TcInstance TC_INSTANCES[] = {
    {128, 32, 32, launch_tc<128, 32, 32>},
    {128, 64, 32, launch_tc<128, 64, 32>},
    {128, 128, 32, launch_tc<128, 128, 32>},
    {128, 128, 64, launch_tc<128, 128, 64>},
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
// bn, bk and split are ignored) and out 16-byte aligned; 3 the wide-K walk
// (bf16, as 1; bm TW_BM, bk TW_BK, bn one of TCW_INSTANCES, `split` the
// offsets of a pass, 1..k_vol; tcw_fits), whose lists go in `scratch`
// (sparse_conv_tcw_scratch_ints int32) and which adds its tally to `words`
// (three uint64, or null). Launches on `stream` and returns a CUDA error code
// (cudaErrorInvalidValue for a combination that has no kernel).
extern "C" int sparse_conv_gather_gemm(const void* x, const void* nbr,
                                       const void* w, void* out, int n_out,
                                       int k_vol, int cin, int cout,
                                       int is_bf16, int variant, int bm, int bn,
                                       int bk, int split, void* scratch, void* words,
                                       void* stream) {
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
  if (!is_bf16 || cin % 8 != 0 || cout % 8 != 0 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 3) {
    if (bm != TW_BM || bk != TW_BK || split < 1 || split > k_vol || scratch == nullptr ||
        !tcw_fits(n_out, k_vol))
      return static_cast<int>(cudaErrorInvalidValue);
    for (const TcwInstance& inst : TCW_INSTANCES)
      if (inst.bn == bn)
        return static_cast<int>(inst.launch(x, nbr, w, out, n_out, k_vol, cin, cout, split, 0,
                                            static_cast<int*>(scratch),
                                            static_cast<unsigned long long*>(words), s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 1 || split < 1 || split > TC_MAX_SPLIT || bm % split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const TcInstance& inst : TC_INSTANCES) {
    if (inst.bm != bm || inst.bn != bn || inst.bk != bk) continue;
    const cudaError_t e = inst.launch(x, nbr, w, out, n_out, k_vol, cin, cout, split, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// int32 of scratch the wide-K walk takes at n_out x k_vol in passes of ob offsets.
extern "C" unsigned long long sparse_conv_tcw_scratch_ints(int n_out, int k_vol, int ob) {
  return TcwScratch::ints(n_out, k_vol, ob);
}

// The wide-K walk's lists alone (its first four kernels, as variant 3 runs
// them): scratch as there, `out` [n_out, cout] f32 gets its dead rows
// zeroed, `words` (three uint64, or null) zeroed; `ob` offsets a pass. For
// the card tests and the timing of the list build.
extern "C" int sparse_conv_tcw_lists(const void* nbr, void* out, int n_out, int k_vol,
                                     int cout, int ob, void* scratch, void* words,
                                     void* stream) {
  if (scratch == nullptr || cout % 4 != 0 || (reinterpret_cast<uintptr_t>(out) % 16) != 0 ||
      ob < 1 || ob > k_vol || !tcw_fits(n_out, k_vol))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_tcw_lists(nbr, out, n_out, k_vol, cout, ob,
                                           static_cast<int*>(scratch),
                                           static_cast<unsigned long long*>(words),
                                           static_cast<cudaStream_t>(stream)));
}

// The wide-K walk (variant 3, bn and ob as there) on the lists a call on the
// same map left in `scratch`: no list build; the rows' flags reset and the
// dead rows zeroed first.
extern "C" int sparse_conv_tcw_again(const void* x, const void* nbr, const void* w, void* out,
                                     int n_out, int k_vol, int cin, int cout, int bn, int ob,
                                     void* scratch, void* words, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (!aligned || cin % 8 != 0 || cout % 8 != 0 || ob < 1 || ob > k_vol || scratch == nullptr ||
      !tcw_fits(n_out, k_vol))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const TcwInstance& inst : TCW_INSTANCES)
    if (inst.bn == bn)
      return static_cast<int>(inst.launch(x, nbr, w, out, n_out, k_vol, cin, cout, ob, 1,
                                          static_cast<int*>(scratch),
                                          static_cast<unsigned long long*>(words),
                                          static_cast<cudaStream_t>(stream)));
  return static_cast<int>(cudaErrorInvalidValue);
}
