// K3 bloom_build — the blocked Bloom bitset over the solid rows of a
// distinct (key, count) run; K16 bloom_build_words (below) — a blocked
// partial over (S, W) k-mer words, k <= 255.
//
// Replaces: leon_tpu/ops/bloom.py build_device -> _build_device_jit._build
// (hash every row from scratch with hash_words, wordbit per row, then a
// sort-dedup of the (word, bit) pairs and a scatter-add that equals OR).
//
// Bound on the H100: the run's bytes (a key and a count a row, read once)
// and one random 4-byte atomic a solid row into a bitset that stays in the
// 50 MB L2. A key is K16's W = 2 row (the int64's low and high words), so
// it hashes as K16 does, a word at a time from the nibble tables built in
// shared memory once per block (hash_kmer_tab<2>, 16 table loads a row;
// at k < 32 the code-0 bases k .. 31 above the key are cancelled by padf /
// padr), not base by base. Most rows are below the cutoff (four in five
// at the bench), so a warp first compacts its solid rows: it reads 128 rows
// a step (a lane's four keys and four counts in 16-byte loads), appends
// the solid keys to its queue in shared memory (ballot order; OR is
// order-free), and hashes 32 at a time, so no lane idles while another
// hashes; the rest of the queue is hashed at the end. Warps walk the run
// with a grid-stride loop over the card's resident blocks. One atomicOr
// sets a row's H-bit mask (all H bits share one word): the result is
// deterministic and equals the reference's [:n_words] prefix (the
// reference pads the array to alloc_words).
#include "common.cuh"
#include "kmer_words.cuh"

#define K3_THREADS 256
#define K3_WARPS (K3_THREADS / 32)
#define K3_TILE 128  // rows a warp reads a step: four a lane
#define K3_QUEUE (K3_TILE + 32)  // under 32 pending keys plus a tile's

static __device__ __forceinline__ void k3_set(uint64_t key, int k, uint32_t n_words, int H,
                                              uint32_t padf, uint32_t padr,
                                              const NibbleTabs& tab,
                                              uint32_t* __restrict__ bits) {
  Kmer<2> x;
  x.w[0] = (uint32_t)key;
  x.w[1] = (uint32_t)(key >> 32);
  uint32_t f, r, wi, mask;
  hash_kmer_tab<2>(x, k, 0xFFFFFFFFu, padf, padr, tab, &f, &r);
  wordmask(f, r, H, n_words, &wi, &mask);
  atomicOr(bits + wi, mask);
}

__global__ void __launch_bounds__(K3_THREADS)
    bloom_build_kernel(const int64_t* __restrict__ keys, const int32_t* __restrict__ counts,
                       long long M, int32_t cutoff, uint32_t n_words, int H, int k,
                       uint32_t padf, uint32_t padr, bool vec,
                       const __grid_constant__ HashTabs tabs, uint32_t* __restrict__ bits) {
  __shared__ NibbleTabs tab;
  __shared__ uint64_t queue[K3_WARPS][K3_QUEUE];
  build_nibble_tabs(tabs, tab);
  __syncthreads();
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  uint64_t* q = queue[wib];
  const unsigned below = (1u << lane) - 1u;
  int pending = 0;  // keys in q, the same in every lane
  const long long warps = (long long)gridDim.x * K3_WARPS;
  for (long long t = (long long)blockIdx.x * K3_WARPS + wib; t * K3_TILE < M; t += warps) {
    const long long r0 = t * K3_TILE + 4 * lane;
    int64_t key[4];
    bool solid[4];
    if (vec && r0 + 3 < M) {
      const int4 c = __ldg(reinterpret_cast<const int4*>(counts + r0));
      const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(keys + r0));
      const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(keys + r0 + 2));
      solid[0] = c.x >= cutoff, solid[1] = c.y >= cutoff;
      solid[2] = c.z >= cutoff, solid[3] = c.w >= cutoff;
      key[0] = a.x, key[1] = a.y, key[2] = b.x, key[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = r0 + j < M;
        solid[j] = in && __ldg(counts + r0 + j) >= cutoff;
        key[j] = in ? __ldg(keys + r0 + j) : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned m = __ballot_sync(0xffffffffu, solid[j]);
      if (solid[j]) q[pending + __popc(m & below)] = (uint64_t)key[j];
      pending += __popc(m);
    }
    __syncwarp();
    while (pending >= 32) {
      pending -= 32;
      const uint64_t x = q[pending + lane];
      __syncwarp();  // read before the next tile's appends overwrite the slot
      k3_set(x, k, n_words, H, padf, padr, tab, bits);
    }
  }
  if (lane < pending) k3_set(q[lane], k, n_words, H, padf, padr, tab, bits);
}

extern "C" int lt_bloom_build(const void* keys, const void* counts, long long M, int cutoff,
                              unsigned n_words, int H, int k, const void* tabs16,
                              void* bitset, void* stream) {
  if (H < 1 || H > 8 || k < 1 || k > 31 || n_words == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(bitset, 0, (size_t)n_words * sizeof(uint32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (M <= 0) return (int)cudaSuccess;
  static int resident = 0;  // blocks the card holds at once
  if (!resident && (e = resident_blocks(bloom_build_kernel, K3_THREADS, &resident)) != cudaSuccess)
    return (int)e;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  uint32_t padf, padr;
  nibble_tab_pads(tb, k, 2, &padf, &padr);
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  const long long tiles = (M + K3_TILE - 1) / K3_TILE;
  const unsigned grid = (unsigned)min((tiles + K3_WARPS - 1) / K3_WARPS, (long long)resident);
  bloom_build_kernel<<<grid, K3_THREADS, 0, st>>>((const int64_t*)keys, (const int32_t*)counts,
                                                  M, cutoff, n_words, H, k, padf, padr, vec, tb,
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
// base-by-base hash (a select over W words, two table selects and two
// runtime rotations a base, ~4,000 instructions a row at k = 255)
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
    const cudaError_t e = resident_blocks(bloom_build_words_kernel<W>, K16_THREADS, &resident);
    if (e != cudaSuccess) return e;
  }
  uint32_t padf, padr;
  nibble_tab_pads(tb, k, W, &padf, &padr);
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
