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
// the 50 MB L2) and every query binary-searches all of it: no window, no
// planner, no flag.
//
// What bounds it on the H100: bytes. Each call must read its queries (4
// bytes each) and the table's entries in use (20 bytes each, not the
// WORD_PAD tail) once and write 16 bytes a query: 33 MB for the level-0 k5
// map (65 536 rows x 25 columns, 32 916 entries in use), 10 us at 3.35 TB/s. Design: one thread per query, a lower-bound search (17-18
// dependent loads from L2, which the many resident warps hide) and one
// 16-byte store; neighbouring threads hold neighbouring columns of one row,
// whose keys are close, so their searches walk the same cache lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
word_match_kernel(const int* __restrict__ keys, const int4* __restrict__ payload,
                  int m, const int* __restrict__ q, long long n,
                  int4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int key = q[i];
  unsigned a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (key >= 0) {
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      if (__ldg(keys + mid) < key) lo = mid + 1; else hi = mid;
    }
    for (int j = lo; j < lo + 2 && j < m && __ldg(keys + j) == key; ++j) {
      const int4 p = __ldg(payload + j);
      a0 += (unsigned)p.x;
      a1 += (unsigned)p.y;
      a2 += (unsigned)p.z;
      a3 += (unsigned)p.w;
    }
  }
  out[i] = make_int4((int)a0, (int)a1, (int)a2, (int)a3);
}

}  // namespace

// keys int32 [m] sorted, payload int32 [m, 4] (16-byte aligned), q int32
// [n], out int32 [n, 4] (16-byte aligned), all contiguous. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int word_match(const void* keys, const void* payload, int m,
                          const void* q, long long n, void* out, void* stream) {
  const long long blocks = (n + NT - 1) / NT;
  word_match_kernel<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int4*>(payload), m,
      static_cast<const int*>(q), n, static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
