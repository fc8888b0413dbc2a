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
// shr2_ins 48-58)
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

// ---------------------------------------------------------------------------
// Hashing a word at a time from nibble tables (the (f, r) of
// leon_tpu/ops/bloom.py hash_words 97-117). Base i of a k-mer sits at
// bit-pair m = k-1-i of its words: f XORs rol(T[b_m], m) and r XORs
// rol(Tc[b_m], k-1-m) =
// rol(ror(Tc[b_m], m), k-1) over m < k. With m = 16j + 2n + t (word j,
// nibble n, pair t of the nibble):
//   f = padf ^ XOR_j rol(G(w_j), 16j),  G(w) = XOR_n Tf_n[nibble n of w],
//   r = rol(padr ^ XOR_j ror(Gc(w_j), 16j), k-1),  Gc likewise with Tr_n,
//   Tf_n[x] = rol(T[x & 3], 2n) ^ rol(T[x >> 2], 2n + 1),
//   Tr_n[x] = ror(Tc[x & 3], 2n) ^ ror(Tc[x >> 2], 2n + 1),
// where the top word is masked to its 2k bits, so that m = k .. 16W-1 read
// as code 0, and padf / padr are those code-0 terms, which cancel them.
// A rotation by 16j is none for even j and 16 for odd j, so the even and
// odd words are summed apart and rotated once. Each (Tf_n, Tr_n) pair is
// one 64-bit entry, and each of the 8 x 16 entries is held 16 times, copy
// c at bank pair c: lane l reads copy l mod 16, so the 16 lanes of a
// half-warp never share a bank whatever their nibbles (random bytes into
// 256-entry tables put ~3 lanes of a half-warp on one bank pair, and ran
// 1.2-1.4x slower at W = 8 and 16). A word costs 8 table loads; the tables
// take 16 KB.
// ---------------------------------------------------------------------------

typedef uint2 NibbleTabs[8][16][16];  // [n][x][copy] = (Tf_n[x], Tr_n[x])

// fill tab from tb with the block's threads; the caller synchronises
static __device__ __forceinline__ void build_nibble_tabs(const HashTabs& tb, NibbleTabs& tab) {
  for (int e = threadIdx.x; e < 8 * 16 * 16; e += blockDim.x) {
    const int n = e >> 8, x = (e >> 4) & 15;
    uint32_t f = 0, r = 0;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int b = (x >> (2 * t)) & 3, s = 2 * n + t;
      f ^= rolr(sel4(tb.t[0], b), s);
      r ^= rolr(sel4(tb.t[1], b), 32 - s);
    }
    tab[n][x][e & 15] = make_uint2(f, r);
  }
}

// (padf, padr): the terms of code-0 bases at m = k .. 16W-1 (host), for a
// k-mer hashed as W >= ceil(k/16) words
static inline void nibble_tab_pads(const HashTabs& tb, int k, int W, uint32_t* padf,
                                   uint32_t* padr) {
  uint32_t f = 0, r = 0;
  for (int m = k; m < 16 * W; ++m) {
    f ^= rolr(tb.t[0][0], m);
    r ^= rolr(tb.t[1][0], 32 - (m & 31));
  }
  *padf = f;
  *padr = r;
}

// G(w) and Gc(w) of one word (copy c of the tables) XORed into (gf, gr)
static __device__ __forceinline__ void nibble_terms(uint32_t w, const NibbleTabs& tab, int c,
                                                    uint32_t* gf, uint32_t* gr) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint2 e = tab[n][(w >> (4 * n)) & 15u][c];
    *gf ^= e.x;
    *gr ^= e.y;
  }
}

template <int W>
static __device__ __forceinline__ void hash_kmer_tab(const Kmer<W>& a, int k, uint32_t top,
                                                     uint32_t padf, uint32_t padr,
                                                     const NibbleTabs& tab, uint32_t* f,
                                                     uint32_t* r) {
  const int c = threadIdx.x & 15;
  uint32_t fe = padf, re = padr, fo = 0, ro = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint32_t gf = 0, gr = 0;
    nibble_terms(j == W - 1 ? a.w[j] & top : a.w[j], tab, c, &gf, &gr);
    if (j & 1) {
      fo ^= gf;
      ro ^= gr;
    } else {
      fe ^= gf;
      re ^= gr;
    }
  }
  *f = fe ^ rolr(fo, 16);
  *r = rolr(re ^ rolr(ro, 16), k - 1);
}

// row `row` of (S, W) words: 16- or 8-byte loads where W allows and `vec`
// says the base is aligned to them
template <int W>
static __device__ __forceinline__ Kmer<W> load_kmer_vec(const uint32_t* __restrict__ words,
                                                        long long row, bool vec) {
  Kmer<W> x;
  if constexpr (W % 4 == 0) {
    if (vec) {
      const uint4* p = reinterpret_cast<const uint4*>(words + row * W);
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        const uint4 v = __ldg(p + j);
        x.w[4 * j] = v.x;
        x.w[4 * j + 1] = v.y;
        x.w[4 * j + 2] = v.z;
        x.w[4 * j + 3] = v.w;
      }
      return x;
    }
  } else if constexpr (W % 2 == 0) {
    if (vec) {
      const uint2* p = reinterpret_cast<const uint2*>(words + row * W);
#pragma unroll
      for (int j = 0; j < W / 2; ++j) {
        const uint2 v = __ldg(p + j);
        x.w[2 * j] = v.x;
        x.w[2 * j + 1] = v.y;
      }
      return x;
    }
  }
  return load_kmer<W>(words, row);
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
