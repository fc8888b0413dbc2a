// k-mers as W = ceil(k/16) little-endian u32 words held in registers
// (FORMAT.md §3: base i of the k-mer at bits 2(k-1-i)), shared by the
// kernels that take W-word k-mers: the tensor path, the graph API and the
// main path's multiword route, all at W <= 16 (k <= 255).
#pragma once

#include "common.cuh"

// ---------------------------------------------------------------------------
// Width dispatch: a switch over W names every instance it launches; any
// other width returns cudaErrorInvalidValue (the wrapper raises). LAUNCH is
// a macro of one argument that launches the instance of that width.
// ---------------------------------------------------------------------------

#define LT_W_CASE(W_, LAUNCH) \
  case W_:                    \
    LAUNCH(W_);               \
    break;
#define LT_W_CASES_2_4(LAUNCH) LT_W_CASE(2, LAUNCH) LT_W_CASE(3, LAUNCH) LT_W_CASE(4, LAUNCH)
#define LT_W_CASES_5_16(LAUNCH)                                                        \
  LT_W_CASE(5, LAUNCH) LT_W_CASE(6, LAUNCH) LT_W_CASE(7, LAUNCH) LT_W_CASE(8, LAUNCH)  \
  LT_W_CASE(9, LAUNCH) LT_W_CASE(10, LAUNCH) LT_W_CASE(11, LAUNCH)                     \
  LT_W_CASE(12, LAUNCH) LT_W_CASE(13, LAUNCH) LT_W_CASE(14, LAUNCH)                    \
  LT_W_CASE(15, LAUNCH) LT_W_CASE(16, LAUNCH)
#define LT_W_NO_INSTANCE \
  default:               \
    return (int)cudaErrorInvalidValue;

// ---------------------------------------------------------------------------
// The multiword route's sort keys: P = ceil(W/2) int64 planes, plane q =
// (w[2q+1] << 32 | w[2q]) with its sign bit flipped (state.words_to_planes),
// so that signed order over (plane P-1, ..., plane 0) is the reference's
// MSW-first u32 order. The host passes an array of P device pointers.
// ---------------------------------------------------------------------------

#define LT_MAX_PLANES 8  // W <= 16

struct PlanePtrs {
  int64_t* p[LT_MAX_PLANES];
};

// copy P pointers from the host array; false for a P out of range or a null
static inline bool load_planes(const void* host_ptrs, int P, PlanePtrs* out) {
  if (!host_ptrs || P < 1 || P > LT_MAX_PLANES) return false;
  memset(out, 0, sizeof(*out));
  memcpy(out->p, host_ptrs, (size_t)P * sizeof(int64_t*));
  for (int q = 0; q < P; ++q)
    if (!out->p[q]) return false;
  return true;
}

// ---------------------------------------------------------------------------
// k-mer words (leon_tpu/ops/kmer.py top_mask 30-33, shl2 36-45,
// shr2_ins 48-58) and from-scratch hashing (ops/bloom.py hash_words 97-117)
// ---------------------------------------------------------------------------

template <int W>
struct Kmer {
  uint32_t w[W];
};

template <int W>
static __device__ __forceinline__ Kmer<W> load_kmer(const uint32_t* __restrict__ words,
                                                    long long row) {
  Kmer<W> x;
#pragma unroll
  for (int j = 0; j < W; ++j) x.w[j] = __ldg(words + row * W + j);
  return x;
}

// (kmer << 2 | c), top word masked to 2k bits
template <int W>
static __device__ __forceinline__ Kmer<W> shl2(const Kmer<W>& a, uint32_t c, uint32_t top) {
  Kmer<W> o;
  o.w[0] = (a.w[0] << 2) | c;
#pragma unroll
  for (int j = 1; j < W; ++j) o.w[j] = (a.w[j] << 2) | (a.w[j - 1] >> 30);
  o.w[W - 1] &= top;
  return o;
}

// (kmer >> 2) | (c << 2(k-1)); no mask (as the reference)
template <int W>
static __device__ __forceinline__ Kmer<W> shr2_ins(const Kmer<W>& a, uint32_t c, int k) {
  Kmer<W> o;
#pragma unroll
  for (int j = 0; j < W - 1; ++j) o.w[j] = (a.w[j] >> 2) | (a.w[j + 1] << 30);
  o.w[W - 1] = a.w[W - 1] >> 2;
  const int t = 2 * (k - 1);
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j == (t >> 5)) o.w[j] |= c << (t & 31);
  return o;
}

// word j of a k-mer held in registers, for a runtime j < W
template <int W>
static __device__ __forceinline__ uint32_t word_at(const Kmer<W>& a, int j) {
  uint32_t v = a.w[0];
#pragma unroll
  for (int i = 1; i < W; ++i)
    if (i == j) v = a.w[i];
  return v;
}

template <int W>
static __device__ __forceinline__ int base_of(const Kmer<W>& a, int i, int k) {
  const int t = 2 * (k - 1 - i);
  return (int)((word_at(a, t >> 5) >> (t & 31)) & 3u);
}

template <int W>
static __device__ __forceinline__ void hash_kmer(const Kmer<W>& a, int k, const HashTabs& tb,
                                                 uint32_t* f, uint32_t* r) {
  uint32_t hf = 0, hr = 0;
  for (int i = 0; i < k; ++i) {
    const int b = base_of(a, i, k);
    hf ^= rolr(sel4(tb.t[0], b), (k - 1 - i) & 31);
    hr ^= rolr(sel4(tb.t[1], b), i & 31);
  }
  *f = hf;
  *r = hr;
}

template <int W>
static __device__ __forceinline__ bool same_kmer(const Kmer<W>& a, const Kmer<W>& b) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < W; ++j) eq &= a.w[j] == b.w[j];
  return eq;
}

// a < b comparing W-word k-mers as big integers, most significant word
// first (leon_tpu/ops/kmer.py lex_less 61-69)
template <int W>
static __device__ __forceinline__ bool lex_less(const Kmer<W>& a, const Kmer<W>& b) {
  bool less = false, eq = true;
#pragma unroll
  for (int j = W - 1; j >= 0; --j) {
    less |= eq && a.w[j] < b.w[j];
    eq &= a.w[j] == b.w[j];
  }
  return less;
}

// word j of a k-mer, 0 for j >= W (the missing top half of plane ceil(W/2)-1)
template <int W>
static __device__ __forceinline__ uint32_t word_or_zero(const Kmer<W>& a, int j) {
  return j < W ? a.w[j < W ? j : 0] : 0u;
}
