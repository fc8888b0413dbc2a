// Floors of the gathers of K9 gather_words (leon_tpu_torch/csrc/graph.cu)
// and K20 sort_ties (csrc/count.cu): the least the card takes for the
// memory traffic those kernels cannot avoid, with nothing else in the way.
//   (a) the stream alone: n int32 indices read and n int32 outputs written,
//       16 bytes a thread at a time (indices read evict-first, outputs
//       written streaming), no table load: K9's byte floor;
//   (b) random 4-byte loads from a table of n_words words that stays in the
//       50 MB L2: n loads at indices a hash makes in registers (no index
//       read), U of them in flight a thread (U = 4, 8, 16), one word a
//       thread written: what K9's table loads cannot beat;
//   (c) random row gathers from device memory: n rows of 4W bytes (W = 4,
//       8, 16: 16, 32, 64 bytes) gathered in the order of a permutation
//       (the slab's top-sort order, as K20 gathers them) and written
//       contiguously, the permutation's int64 entries read once: K20's
//       gather floor (its keys' reads and its P planes written as rows).
// scripts/ab_kernels.py (--only gather, wordsort) builds it with nvcc into
// build/ab_kernels/ and times it beside the kernels; nothing on the main
// path calls it.
#include <cstdint>
#include <cuda_runtime.h>

#define FLOOR_THREADS 256

__global__ void stream_floor_kernel(const int4* __restrict__ idx, long long groups,
                                    int4* __restrict__ out) {
  for (long long g = (long long)blockIdx.x * FLOOR_THREADS + threadIdx.x; g < groups;
       g += (long long)gridDim.x * FLOOR_THREADS)
    __stcs(out + g, __ldcs(idx + g));
}

template <int U>
__global__ void l2_floor_kernel(const uint32_t* __restrict__ table, uint32_t n_words,
                                long long n, uint32_t seed, uint32_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * FLOOR_THREADS + threadIdx.x;
  if (t * U >= n) return;
  uint32_t x = seed ^ ((uint32_t)t * 0x9E3779B9u), v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    x = x * 1664525u + 1013904223u;
    v[u] = __ldg(table + __umulhi(x, n_words));
  }
  uint32_t acc = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) acc ^= v[u];
  out[t] = acc;
}

template <int W>
__global__ void rows_floor_kernel(const uint4* __restrict__ rows,
                                  const long long* __restrict__ perm, long long n,
                                  uint4* __restrict__ out) {
  constexpr int V = W / 4;  // 16-byte chunks a row
  for (long long i = (long long)blockIdx.x * FLOOR_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * FLOOR_THREADS) {
    const long long j = perm[i];
    uint4 r[V];
#pragma unroll
    for (int c = 0; c < V; ++c) r[c] = __ldg(rows + j * V + c);
#pragma unroll
    for (int c = 0; c < V; ++c) out[i * V + c] = r[c];
  }
}

static int grid_of(long long work, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (work + FLOOR_THREADS - 1) / FLOOR_THREADS;
  const long long cap = (long long)sms * per_sm;
  return (int)(need < 1 ? 1 : (need < cap ? need : cap));
}

// (a): n a multiple of 4, idx and out 16-byte aligned
extern "C" int lt_stream_floor(const void* idx, long long n, void* out, void* stream) {
  if (n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  const long long groups = n / 4;
  stream_floor_kernel<<<grid_of(groups, 8), FLOOR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)idx, groups, (int4*)out);
  return (int)cudaGetLastError();
}

// (b): n loads, U in flight a thread; out holds n / U words
extern "C" int lt_l2_floor(const void* table, unsigned n_words, long long n, int U,
                           unsigned seed, void* out, void* stream) {
  if (n <= 0 || n_words == 0) return (int)cudaErrorInvalidValue;
  const long long threads = (n + U - 1) / U;
  const unsigned grid = (unsigned)((threads + FLOOR_THREADS - 1) / FLOOR_THREADS);
  const uint32_t* t = (const uint32_t*)table;
  cudaStream_t st = (cudaStream_t)stream;
  switch (U) {
    case 4: l2_floor_kernel<4><<<grid, FLOOR_THREADS, 0, st>>>(t, n_words, n, seed,
                                                                (uint32_t*)out); break;
    case 8: l2_floor_kernel<8><<<grid, FLOOR_THREADS, 0, st>>>(t, n_words, n, seed,
                                                                (uint32_t*)out); break;
    case 16: l2_floor_kernel<16><<<grid, FLOOR_THREADS, 0, st>>>(t, n_words, n, seed,
                                                                  (uint32_t*)out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// (c): rows (N, W) u32, 16-byte aligned; perm (n,) int64 into them; out (n, W)
extern "C" int lt_rows_floor(const void* rows, int W, const void* perm, long long n, void* out,
                             void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int grid = grid_of(n, 8);
  cudaStream_t st = (cudaStream_t)stream;
  const uint4* r = (const uint4*)rows;
  const long long* p = (const long long*)perm;
  uint4* o = (uint4*)out;
  switch (W) {
    case 4: rows_floor_kernel<4><<<grid, FLOOR_THREADS, 0, st>>>(r, p, n, o); break;
    case 8: rows_floor_kernel<8><<<grid, FLOOR_THREADS, 0, st>>>(r, p, n, o); break;
    case 16: rows_floor_kernel<16><<<grid, FLOOR_THREADS, 0, st>>>(r, p, n, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
