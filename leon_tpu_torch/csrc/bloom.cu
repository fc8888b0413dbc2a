// K3 bloom_build — the blocked Bloom bitset over the solid rows of a
// distinct (key, count) run.
//
// Replaces: leon_tpu/ops/bloom.py build_device -> _build_device_jit._build
// (hash every row from scratch with hash_words, wordbit per row, then a
// sort-dedup of the (word, bit) pairs and a scatter-add that equals OR).
//
// Bound on the H100: the k-step from-scratch hash per row (ALU) plus one
// random 4-byte atomic per solid row; the bitset (~6 MB at the bench's
// 2M solid k-mers) stays in the 50 MB L2. Design: one thread per row,
// rows below the cutoff return at once; the H mask bits of a row live in
// one word, so a single atomicOr sets them. OR is order-free: the result
// is deterministic and equals the reference's [:n_words] prefix (the
// reference pads the array to alloc_words).
#include "common.cuh"

__global__ void bloom_build_kernel(const int64_t* __restrict__ keys,
                                   const int32_t* __restrict__ counts, long long M,
                                   int32_t cutoff, uint32_t n_words, int H, int k,
                                   const __grid_constant__ HashTabs tabs,
                                   uint32_t* __restrict__ bits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M || counts[i] < cutoff) return;
  uint32_t f, r, wi, mask;
  hash_key((uint64_t)keys[i], k, tabs, &f, &r);
  wordmask(f, r, H, n_words, &wi, &mask);
  atomicOr(bits + wi, mask);
}

extern "C" int lt_bloom_build(const void* keys, const void* counts, long long M, int cutoff,
                              unsigned n_words, int H, int k, const void* tabs16,
                              void* bitset, void* stream) {
  if (H < 1 || H > 8 || k < 1 || k > 31 || n_words == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(bitset, 0, (size_t)n_words * sizeof(uint32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (M <= 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  const int threads = 256;
  bloom_build_kernel<<<(unsigned)((M + threads - 1) / threads), threads, 0, st>>>(
      (const int64_t*)keys, (const int32_t*)counts, M, cutoff, n_words, H, k, tb,
      (uint32_t*)bitset);
  return (int)cudaGetLastError();
}
