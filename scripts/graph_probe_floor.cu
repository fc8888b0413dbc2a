// The probe floor of the graph API's kernels K10 dbg_probe, K11 dbg_walk and
// K12 dbg_traverse (leon_tpu_torch/csrc/graph.cu): one thread per row or lane
// issues as many random 4-byte loads from the bitset as the kernel makes for
// that row or lane (counts[t]: a classic probe loads its hashes up to the
// first clear bit, a blocked probe one word; scripts/ab_kernels.py counts
// them on the kernel's own inputs), at pseudo-random words of a bitset of
// the same size, with no dependency between them, 8 in flight a thread. Its
// time is the least the card takes for those loads alone. With dep = 1 a
// thread's loads instead form one chain (each address depends on the last
// word read), and counts[t] is the number of dependent rounds the kernel's
// design leaves the lane: its time is the latency floor of the slowest
// lane, which binds when the lanes are too few to fill the card (K12 on
// 16,384 lanes). scripts/ab_kernels.py
// (--only graph) builds it with nvcc into build/ab_kernels/ and times it
// beside the kernels; nothing on the main path calls it.
#include <cstdint>
#include <cuda_runtime.h>

#define GRAPH_FLOOR_U 8

__global__ void graph_floor_kernel(const uint32_t* __restrict__ bits, uint32_t n_words,
                                   const int32_t* __restrict__ counts, long long n,
                                   uint32_t seed, int dep, uint32_t* __restrict__ out) {
  constexpr int U = GRAPH_FLOOR_U;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int c = counts[t];
  uint32_t x = seed ^ ((uint32_t)t * 0x9E3779B9u), acc = 0;
  if (dep) {
    for (int i = 0; i < c; ++i) {
      x = (x ^ acc) * 1664525u + 1013904223u;
      acc = __ldg(bits + __umulhi(x, n_words));
    }
    out[t] = acc;
    return;
  }
  for (int i = 0; i < c; i += U) {
    uint32_t v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      x = x * 1664525u + 1013904223u;
      v[u] = i + u < c ? __ldg(bits + __umulhi(x, n_words)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += (v[u] >> (x & 31u)) & 1u;
  }
  out[t] = acc;
}

extern "C" int lt_graph_floor(const void* bits, unsigned n_words, const void* counts,
                              long long n, unsigned seed, int dep, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  graph_floor_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, n_words, (const int32_t*)counts, n, seed, dep, (uint32_t*)out);
  return (int)cudaGetLastError();
}
