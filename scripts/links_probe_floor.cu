// The probe floor of K5 unitig_links (leon_tpu_torch/csrc/unitig.cu): one
// thread per directed node issues, with no dependency between them, the
// random loads that K5's design must make for that node: for each of its
// searches whose query lands at a random place in the run (counts[t]: a
// row's own orientation searches its reverse-complement forms there, the
// other orientation its forward candidates; the other searches follow the
// rows' order) one entry of the prefix table and one word of a row of the
// run, each a sector of its own, at pseudo-random
// places in arrays of the run's sizes (the table of 2^T + 1 entries, M rows
// of row_words words), 8 in flight a thread. Its time is the least the card
// takes for those loads alone. scripts/ab_kernels.py (--only links) builds
// it with nvcc into build/ab_kernels/ and times it beside K5; nothing on the
// main path calls it.
#include <cstdint>
#include <cuda_runtime.h>

#define LINKS_FLOOR_U 8

__global__ void links_floor_kernel(const int32_t* __restrict__ tab, uint32_t n_tab,
                                   const uint32_t* __restrict__ rows, uint32_t n_rows,
                                   int row_words, const int32_t* __restrict__ counts, int n,
                                   uint32_t seed, uint32_t* __restrict__ out) {
  constexpr int U = LINKS_FLOOR_U;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int c = counts[t];
  uint32_t x = seed ^ ((uint32_t)t * 0x9E3779B9u), acc = 0;
  for (int i = 0; i < c; i += U) {
    uint32_t v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      x = x * 1664525u + 1013904223u;
      const uint32_t p = __umulhi(x, n_tab), r = __umulhi(x * 0x85EBCA6Bu + 1u, n_rows);
      v[u] = i + u < c ? (uint32_t)__ldg(tab + p) +
                             __ldg(rows + (size_t)r * row_words + (row_words - 1))
                       : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += v[u];
  }
  out[t] = acc;
}

extern "C" int lt_links_floor(const void* tab, unsigned n_tab, const void* rows, unsigned n_rows,
                              int row_words, const void* counts, int n, unsigned seed, void* out,
                              void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  links_floor_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, n_tab, (const uint32_t*)rows, n_rows, row_words,
      (const int32_t*)counts, n, seed, (uint32_t*)out);
  return (int)cudaGetLastError();
}
