// Shared device helpers of the port's kernels: hash family v4 and blocked
// Bloom addressing, frozen by FORMAT.md §4 (reference: leon_tpu/ops/bloom.py
// tables 48-60, hash_words 97-117, mulhi32 145-160, wordmask_from_hashes
// 163-195). All arithmetic is u32 and must stay bit-identical to the
// reference: mulhi32 is __umulhi.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#define LT_SENTINEL INT64_MAX  // invalid k-mer key: sorts last

// bloom.tables(seed, k): [kind][base], kind 0=T, 1=Tc, 2=Trot, 3=Tcrot.
// Passed by value: kernel parameters live in the constant bank.
struct HashTabs {
  uint32_t t[4][4];
};

static __device__ __forceinline__ uint32_t rol1(uint32_t x) { return (x << 1) | (x >> 31); }
static __device__ __forceinline__ uint32_t ror1(uint32_t x) { return (x >> 1) | (x << 31); }
static __host__ __device__ __forceinline__ uint32_t rolr(uint32_t x, int r) {
  r &= 31;
  return r ? (x << r) | (x >> (32 - r)) : x;
}

// tab[i] for a runtime i in [0, 4) without dynamic indexing of the
// parameter array (which would copy it to local memory)
static __device__ __forceinline__ uint32_t sel4(const uint32_t* tab, int i) {
  return i == 0 ? tab[0] : i == 1 ? tab[1] : i == 2 ? tab[2] : tab[3];
}

// blocked addressing: one word, an H-bit mask inside it
static __device__ __forceinline__ void wordmask(uint32_t f, uint32_t r, int H,
                                                uint32_t n_words, uint32_t* wi,
                                                uint32_t* mask) {
  const uint32_t lo = min(f, r), hi = max(f, r);
  *wi = __umulhi(lo, n_words);
  uint32_t m = 0;
  for (int i = 0; i < H; ++i) {
    const uint32_t b = (i < 6 ? (hi >> (5 * i)) : (lo >> (5 * (i - 6)))) & 31u;
    m |= 1u << b;
  }
  *mask = m;
}

static __device__ __forceinline__ bool probe(const uint32_t* __restrict__ bits, uint32_t f,
                                             uint32_t r, int H, uint32_t n_words) {
  uint32_t wi, m;
  wordmask(f, r, H, n_words, &wi, &m);
  return (__ldg(bits + wi) & m) == m;
}

// from-scratch (f, r) of a k-mer key (base i at bits 2(k-1-i))
static __device__ __forceinline__ void hash_key(uint64_t key, int k, const HashTabs& tb,
                                                uint32_t* f, uint32_t* r) {
  uint32_t hf = 0, hr = 0;
  for (int i = 0; i < k; ++i) {
    const int b = (int)((key >> (2 * (k - 1 - i))) & 3u);
    hf ^= rolr(sel4(tb.t[0], b), (k - 1 - i) & 31);
    hr ^= rolr(sel4(tb.t[1], b), i & 31);
  }
  *f = hf;
  *r = hr;
}

// 2-bit base j of a packed row (kmer.pack_codes_np layout)
static __device__ __forceinline__ int base_at(const uint32_t* __restrict__ row, int j) {
  return (int)((__ldg(row + (j >> 4)) >> (2 * (j & 15))) & 3u);
}

// Blocks of `kern` the card holds at once at `threads` a block and `smem`
// bytes of dynamic shared memory, at most per_sm_cap an SM: the grid of a
// grid-stride or cooperative launch. An error where the kernel cannot be
// resident at all.
template <typename F>
static cudaError_t resident_blocks(F kern, int threads, int* out, int per_sm_cap = 1 << 30,
                                   size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * (per_sm < per_sm_cap ? per_sm : per_sm_cap);
  return cudaSuccess;
}

// zero bytes [0, n) of p with the block's threads: 16-byte stores between
// the head and tail bytes that lie off a 16-byte boundary
static __device__ __forceinline__ void zero_region(uint8_t* p, long long n) {
  long long head = (long long)((16u - (unsigned)(reinterpret_cast<uintptr_t>(p) & 15u)) & 15u);
  head = head < n ? head : n;
  const long long body = (n - head) >> 4;
  const long long tail = head + (body << 4);
  if (threadIdx.x < head) p[threadIdx.x] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (long long i = threadIdx.x; i < body; i += blockDim.x) q[i] = make_uint4(0, 0, 0, 0);
  if (tail + threadIdx.x < n) p[tail + threadIdx.x] = 0;
}

// A thread's row of n elements of T (1 or 4 bytes) at p, written in order,
// each element once, in the 16-byte chunks of the address space: a chunk
// wholly inside the row is one 16-byte store; the row's first and last
// chunks, which the rows beside it may share, go out a word or an element
// at a time, the row's own elements only. A warp's lanes (rows apart) so
// store a chunk where they would store an element.
template <typename T>
struct RowChunks {
  static constexpr int E = 16 / sizeof(T), EW = 4 / sizeof(T);  // elements a chunk, a word
  T* p;
  int n, off;     // off: p's element offset in its chunk
  uint32_t v[4];  // the chunk being built: element c in word c / EW

  __device__ __forceinline__ RowChunks(T* p_, int n_)
      : p(p_), n(n_), off((int)((reinterpret_cast<uintptr_t>(p_) & 15u) / sizeof(T))) {
    v[0] = v[1] = v[2] = v[3] = 0;
  }

  // element i of the row = x
  __device__ __forceinline__ void put(int i, uint32_t x) {
    const int c = (off + i) & (E - 1);
    const uint32_t y = x << (8 * sizeof(T) * (c % EW));
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] |= c / EW == t ? y : 0u;
    if (c == E - 1 || i == n - 1) flush(i);
  }

  // store the chunk that holds element i, its elements up to i
  __device__ __forceinline__ void flush(int i) {
    const int c = (off + i) & (E - 1), first = i - c;  // the chunk's element 0, as a row index
    T* q = p + first;
    if (first >= 0 && c == E - 1) {
      *reinterpret_cast<uint4*>(q) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      const int lo = first < 0 ? -first : 0;  // the row's elements are lo..c
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (EW * t >= lo && EW * t + EW - 1 <= c) {
          *reinterpret_cast<uint32_t*>(q + EW * t) = v[t];
        } else if (EW > 1) {
          for (int e = max(EW * t, lo); e <= min(EW * t + EW - 1, c); ++e)
            q[e] = (T)(v[t] >> (8 * sizeof(T) * (e % EW)));
        }
      }
    }
    v[0] = v[1] = v[2] = v[3] = 0;
  }

  // store what `count` puts left unstored (a last chunk that is not full)
  __device__ __forceinline__ void end(int count) {
    if (count > 0 && count < n && ((off + count - 1) & (E - 1)) != E - 1) flush(count - 1);
  }

  // elements i .. n - 1 = x: the chunk under way element by element, then
  // whole chunks in 16-byte stores, then the last one's elements
  __device__ __forceinline__ void fill(int i, uint32_t x) {
    for (; i < n && ((off + i) & (E - 1)) != 0; ++i) put(i, x);
    const uint32_t r = sizeof(T) == 1 ? x * 0x01010101u : x;
    for (; i + E <= n; i += E) *reinterpret_cast<uint4*>(p + i) = make_uint4(r, r, r, r);
    for (; i < n; ++i) put(i, x);
  }
};
