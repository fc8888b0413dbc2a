// The probe floor of the walk kernels K18 and K19 (leon_tpu_torch/csrc/walk.cu):
// one thread per read issues as many blocked-Bloom probes as the walk makes
// for that read (counts[t]: K18 one an anchor position and four a step, K19
// four a step) into the same bitset, at pseudo-random words, with no
// dependency between them, 8 in flight a thread: its time is the least the
// card takes for those probes alone. scripts/ab_kernels.py (--only walk)
// builds it with nvcc into build/ab_kernels/ and times it beside the
// kernels; nothing on the main path calls it.
#include <cstdint>
#include <cuda_runtime.h>

#define PROBE_FLOOR_U 8

__global__ void probe_floor_kernel(const uint32_t* __restrict__ bits, uint32_t n_words, int H,
                                   const int32_t* __restrict__ counts, int B, uint32_t seed,
                                   uint32_t* __restrict__ out) {
  constexpr int U = PROBE_FLOOR_U;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  const int n = counts[t];
  uint32_t x = seed ^ ((uint32_t)t * 0x9E3779B9u), acc = 0;
  for (int i = 0; i < n; i += U) {
    uint32_t v[U], m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      x = x * 1664525u + 1013904223u;
      const uint32_t f = x, r = (x ^ (x >> 16)) * 0x85EBCA6Bu;
      const uint32_t lo = min(f, r), hi = max(f, r);
      uint32_t mk = 0;
#pragma unroll
      for (int h = 0; h < 8; ++h)
        if (h < H) mk |= 1u << ((h < 6 ? hi >> (5 * h) : lo >> (5 * (h - 6))) & 31u);
      m[u] = mk;
      v[u] = i + u < n ? __ldg(bits + __umulhi(lo, n_words)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += (v[u] & m[u]) == m[u];
  }
  out[t] = acc;
}

extern "C" int lt_probe_floor(const void* bits, unsigned n_words, int H, const void* counts,
                              int B, unsigned seed, void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  probe_floor_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, n_words, H, (const int32_t*)counts, B, seed, (uint32_t*)out);
  return (int)cudaGetLastError();
}
