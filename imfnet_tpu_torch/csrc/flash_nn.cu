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
// both JAX versions. Everything is f32 (no TF32, no bf16) so that indices
// agree with the plain version.
//
// What bounds it on the H100: the 5000 x 5000 x 32 descriptor matching of the
// main path is 2*N*M*D = 1.6 GFLOP on 1.3 MB of input, so it is bound by
// operations, at the f32 CUDA-core rate (the comparison has to stay f32).
//
// Design: 256 threads per block = 32 queries (one per lane, its D values in
// registers) x 8 reference slices (one per warp). References are staged 256
// at a time in shared memory with |r|^2 (+inf for invalid rows); every lane
// of a warp reads the same reference, so shared-memory reads are broadcasts.
// Each thread scans its slice in increasing index order with a strict `<`,
// and the 8 per-slice bests of a query are merged by (distance, index), which
// gives the lowest index among equal minima, as the TPU kernel's argmin
// within a tile and strict `<` across tiles do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 32;   // queries per block, one per lane
constexpr int S = 8;     // reference slices per block, one per warp
constexpr int TR = 256;  // references staged per tile
constexpr int NT = QB * S;

template <int D>
__global__ void __launch_bounds__(NT)
flash_nn_kernel(const float* __restrict__ q, const float* __restrict__ r,
                const uint8_t* __restrict__ valid, int n, int m,
                int* __restrict__ out_i, float* __restrict__ out_d) {
  // odd row stride: the per-row |r|^2 pass reads rows without bank conflicts
  constexpr int DP = (D % 2 == 0) ? D + 1 : D;
  __shared__ float rs[TR][DP];
  __shared__ float rsq[TR];
  __shared__ float red_d[S][QB];
  __shared__ int red_i[S][QB];

  const int lane = threadIdx.x % QB;
  const int slice = threadIdx.x / QB;
  const int qi = blockIdx.x * QB + lane;

  float qv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qv[c] = qi < n ? q[(size_t)qi * D + c] : 0.f;

  float best = INFINITY;
  int best_i = 0;
  for (int t0 = 0; t0 < m; t0 += TR) {
    for (int e = threadIdx.x; e < TR * D; e += NT) {
      const int j = e / D, c = e % D;
      rs[j][c] = (t0 + j < m) ? r[(size_t)(t0 + j) * D + c] : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TR; e += NT) {
      const int j = t0 + e;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) s = fmaf(rs[e][c], rs[e][c], s);
      const bool ok = j < m && (valid == nullptr || valid[j] != 0);
      rsq[e] = ok ? s : INFINITY;
    }
    __syncthreads();
    const int j0 = slice * (TR / S);
    for (int jj = j0; jj < j0 + TR / S; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qv[c], rs[jj][c], dot);
      const float d = rsq[jj] - 2.f * dot;
      if (d < best) {
        best = d;
        best_i = t0 + jj;
      }
    }
    __syncthreads();
  }

  red_d[slice][lane] = best;
  red_i[slice][lane] = best_i;
  __syncthreads();
  if (slice == 0 && qi < n) {
    float bd = red_d[0][lane];
    int bi = red_i[0][lane];
#pragma unroll
    for (int s = 1; s < S; ++s) {
      const float d = red_d[s][lane];
      const int i = red_i[s][lane];
      if (d < bd || (d == bd && i < bi)) {
        bd = d;
        bi = i;
      }
    }
    float qsq = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) qsq = fmaf(qv[c], qv[c], qsq);
    out_i[qi] = bi;
    out_d[qi] = fmaxf(bd + qsq, 0.f);
  }
}

}  // namespace

// q f32 [n, d], r f32 [m, d], valid uint8 [m] or null (all valid), all
// contiguous; out_i int32 [n], out_d f32 [n]. d must be 3 or 32. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for other d).
extern "C" int flash_nn(const void* q, const void* r, const void* valid,
                        void* out_i, void* out_d, int n, int m, int d,
                        void* stream) {
  const dim3 grid((n + QB - 1) / QB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* rf = static_cast<const float*>(r);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  int* oi = static_cast<int*>(out_i);
  float* od = static_cast<float*>(out_d);
  if (d == 32) {
    flash_nn_kernel<32><<<grid, NT, 0, s>>>(qf, rf, vf, n, m, oi, od);
  } else if (d == 3) {
    flash_nn_kernel<3><<<grid, NT, 0, s>>>(qf, rf, vf, n, m, oi, od);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
