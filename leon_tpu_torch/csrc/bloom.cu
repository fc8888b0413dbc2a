// K3 bloom_build — the blocked Bloom bitset over the solid rows of a
// distinct (key, count) run; K16 bloom_build_words (below) — a blocked
// partial over (S, W) k-mer words, k <= 255.
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
#include "kmer_words.cuh"

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

// ---------------------------------------------------------------------------
// K16 bloom_build_words — a blocked Bloom partial over (S, W) k-mer words
// (k <= 255, W <= 16), the valid rows only, into n_alloc words: one
// shard's part on the tensor path (k <= 255), the whole filter over the
// solid rows on the main path's multiword route (32 <= k <= 255).
//
// Replaces: leon_tpu/parallel/mesh.py _bloom_words_local (33-49), the
// per-shard body of sharded_bloom_build, and leon_tpu/ops/bloom.py
// build_device (422) at W >= 2: wordbit of every row (hash_words from
// scratch), then a sort-dedup of the (word, bit) pairs and a scatter-add of
// single bits, which equals OR.
//
// Bound on the H100: the rows' bytes (4W a row, read once) and one random
// 4-byte atomic a valid row into a bitset that stays in the 50 MB L2; a
// base-by-base hash (hash_kmer: a select over W words, two table selects
// and two runtime rotations a base, ~4,000 instructions a row at k = 255)
// made the kernel bound by its arithmetic instead. Design: the hash a word
// at a time (hash_kmer_tab, kmer_words.cuh): each block builds the eight
// 16-entry (f, r) nibble tables in shared memory (16 KB, each entry held
// once per bank pair, so no lookup conflicts) once and walks rows with a
// grid-stride loop (as many blocks as the card holds at once), so a row
// costs 8W table loads; the row comes in 16- or 8-byte loads. The threads
// of a warp whose rows are not valid idle while the others hash: the cost
// follows the rows, not the valid rows. One atomicOr sets a row's
// H-bit mask (all H bits of a key share one word): OR is order-free, so
// the partial is exact and deterministic, with no sort. Words past n_words
// stay zero.
// ---------------------------------------------------------------------------

#define K16_THREADS 256

template <int W>
__global__ void __launch_bounds__(K16_THREADS)
    bloom_build_words_kernel(const uint32_t* __restrict__ words,
                             const uint8_t* __restrict__ valid, long long S, uint32_t n_words,
                             int H, int k, uint32_t top, uint32_t padf, uint32_t padr, bool vec,
                             const __grid_constant__ HashTabs tabs,
                             uint32_t* __restrict__ bits) {
  __shared__ NibbleTabs tab;
  build_nibble_tabs(tabs, tab);
  __syncthreads();
  const long long step = (long long)gridDim.x * K16_THREADS;
  for (long long i = (long long)blockIdx.x * K16_THREADS + threadIdx.x; i < S; i += step) {
    if (!__ldg(valid + i)) continue;
    uint32_t f, r, wi, mask;
    hash_kmer_tab<W>(load_kmer_vec<W>(words, i, vec), k, top, padf, padr, tab, &f, &r);
    wordmask(f, r, H, n_words, &wi, &mask);
    atomicOr(bits + wi, mask);
  }
}

// one instance: as many blocks as are resident on the card at once, or
// fewer for a small S
template <int W>
static cudaError_t launch_bloom_words(const uint32_t* w, const uint8_t* v, long long S,
                                      uint32_t n_words, int H, int k, const HashTabs& tb,
                                      uint32_t* b, cudaStream_t st) {
  static int resident = 0;  // blocks of this instance the card holds at once
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bloom_build_words_kernel<W>,
                                                        K16_THREADS, 0);
    if (e != cudaSuccess) return e;
    resident = max(1, sms * per_sm);
  }
  uint32_t padf, padr;
  nibble_tab_pads(tb, k, &padf, &padr);
  const uint32_t top = 2 * k - 32 * (W - 1) >= 32 ? 0xFFFFFFFFu
                                                  : (1u << (2 * k - 32 * (W - 1))) - 1u;
  const int align = W % 4 == 0 ? 16 : 8;
  const bool vec = (reinterpret_cast<uintptr_t>(w) % align) == 0;
  const long long need = (S + K16_THREADS - 1) / K16_THREADS;
  const unsigned grid = (unsigned)min(need, (long long)resident);
  bloom_build_words_kernel<W><<<grid, K16_THREADS, 0, st>>>(w, v, S, n_words, H, k, top, padf,
                                                            padr, vec, tb, b);
  return cudaGetLastError();
}

extern "C" int lt_bloom_build_words(const void* words, const void* valid, long long S, int W,
                                    unsigned n_alloc, unsigned n_words, int H, int k,
                                    const void* tabs16, void* bitset, void* stream) {
  if (H < 1 || H > 8 || k < 1 || k > 255 || W != (k + 15) / 16 || n_words == 0 ||
      n_words > n_alloc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(bitset, 0, (size_t)n_alloc * sizeof(uint32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (S <= 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  const uint32_t* w = (const uint32_t*)words;
  const uint8_t* v = (const uint8_t*)valid;
  uint32_t* b = (uint32_t*)bitset;
#define LAUNCH(W_) e = launch_bloom_words<W_>(w, v, S, n_words, H, k, tb, b, st)
  switch (W) {
    LT_W_CASE(1, LAUNCH)
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)e;
}
