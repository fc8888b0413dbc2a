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
static __device__ __forceinline__ uint32_t rolr(uint32_t x, int r) {
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
