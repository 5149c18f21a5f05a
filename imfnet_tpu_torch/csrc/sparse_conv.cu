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
// operands bf16 (or f32), products and sums in f32, out f32 [n_out, cout].
// A row whose K entries are all -1 comes out as exact 0.0.
//
// What bounds it on the H100: by the roofline every conv of the main path is
// bound by bytes (the int32 map and the f32 output outweigh 2*nnz*cin*cout
// operations at the bf16 tensor-core rate), a few microseconds each. This
// first version is bound by neither: it multiplies with scalar f32 FMAs on
// the CUDA cores, computes every (row, k) of a live tile even where the
// neighbour is missing, and the coarse levels give it few tiles to spread
// over the SMs (measured per shape by chip_smoke.py, see PERF.md).
//
// Design: one block of 256 threads per tile of 64 output rows x 64 output
// channels. For each kernel offset k the block reads its 64 map entries once
// and skips k when none is live (capacity padding and dead rows cost one
// index read). For each 32-channel slice of cin it stages the gathered input
// rows (zero rows for -1) and the matching W[k] slice in shared memory,
// converted to f32, and every thread accumulates a 4x4 register tile. Each
// gathered row is read from device memory once per 64 output channels.
// Tensor cores (mma/wgmma), cp.async/TMA staging and a persistent schedule
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// x [n_in, cin], nbr int32 [n_out, k_vol], w [k_vol, cin, cout], all
// row-major and contiguous; out f32 [n_out, cout]. is_bf16 selects the
// operand type (bf16 if nonzero, else f32). Map entries must be -1 or a row
// of x. Launches on `stream` and returns cudaGetLastError().
extern "C" int sparse_conv_gather_gemm(const void* x, const void* nbr,
                                       const void* w, void* out, int n_out,
                                       int k_vol, int cin, int cout,
                                       int is_bf16, void* stream) {
  const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
