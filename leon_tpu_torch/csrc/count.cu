// K2 runs — reduce-by-key over a sorted int64 key array; K14 runs_words /
// word_runs (below) — the same over rows of one to eight int64 key planes
// (k <= 255). Both are instances of one pair of passes (runs_pass_kernel)
// over a row policy: KeyRows for K2's keys, WordRows for K14's planes.
//
// Replaces the count programs of leon_tpu/ops/count.py that follow the
// sort: _sort_count_device's boundaries and run lengths (45-85),
// _compact_run (208-223), _merge_sorted_runs' segment sums (226-254),
// _hist_of_sorted (257-264) and compact_solid (707-719). The sort before
// them is K22 radix_sort (csrc/sort.cu), as the reference sorts in the same
// programs with lax.sort.
//
// Semantics: SENTINEL keys are ignored; a run's value is its length, or
// the u32-wrapping sum of its int32 counts clamped to 2^31-1 (exactly the
// reference's wrapping prefix-sum difference); runs with value >= cutoff
// (>= 1: zero-sum runs always drop) are written in key order, and the
// 256-bin histogram of min(value, 255) over them is bumped.
//
// Bound on the H100: device-memory traffic, 8 bytes read per key (+4 per
// count) and 12 written per emitted run. Design (K2): two passes over the
// rows, the count pass reading the keys (and counts) once to find R and
// the write pass reading them again and writing exactly the emitted runs;
// the wrapper's one host sync sits between them, to size the outputs. In
// both, each warp of a grid that fills the card reduces a contiguous
// stretch of rows, 256 at a step (eight consecutive rows a lane, 16-byte
// loads, the next step's loads in flight), and carries the open run from
// step to step in registers: heads and tails by comparing neighbours
// (across lanes by one shuffle), each run's value a segmented sum (each
// lane's rows in turn, then one warp scan of the lanes' sums), emitted at
// its tail (a run that ends on a step's last row by the next step, so a
// step needs no key after it); no thread walks a run, and a run spanning
// any number of steps costs what short runs cost. No warp waits on
// another and no block barrier sits in the loop. What a stretch does to
// the runs that cross it is a Span (below); Spans compose associatively,
// since u32 addition wraps and the clamp is applied once to the finished
// sum, so the result is exact in any order. The count pass ends with one
// Span a warp and the last block folds them into R; the write pass starts
// each warp from the fold of the warps before it. (A decoupled look-back,
// rows held across block barriers, every row in a warp scan, or one pass
// into n-row buffers and a compaction all took longer on the H100:
// PERF.md §6, PR 9.)

#include "common.cuh"
#include "kmer_words.cuh"

#include <algorithm>

#define LT_TRY(x)                              \
  do {                                         \
    cudaError_t e_ = (x);                      \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_ITEMS 8                     // consecutive rows a lane holds in a step
#define K2_STEP (32 * K2_ITEMS)        // a warp's step: 256 rows (ops/count.py RUNS_STEP)
#define K2_FOLD 16                     // Spans a thread of block_fold loads at once
#define K2_CLAMP 0x7FFFFFFFu
#define K2_FULL 0xffffffffu

// The effect of a span of rows on the state that crosses it: the carry
// (the sum so far of the run open at its end) and the count of emitted
// runs. Spans compose associatively (cat), which is what the folds of
// stretches need. flags bit 0: interior — no head and no tail in the span (the
// carry passes through, plus suf); bit 1: pending — the run entering from
// the left ends in the span and is valid, with partial sum pre, so its
// emission waits for the carry. suf: the sum of the run open at the end.
// e: runs emitted in the span whose value is known inside it. A prefix is
// a Span with no flag: (carry suf, count e).
struct Span {
  uint32_t flags, pre, suf;
  unsigned long long e;
};

static __device__ __forceinline__ uint32_t clampv(uint32_t s) { return min(s, K2_CLAMP); }

static __device__ __forceinline__ Span span_ident() { return Span{1u, 0u, 0u, 0ull}; }

// L then R
static __device__ __forceinline__ Span cat(const Span& L, const Span& R, uint32_t cut) {
  Span o;
  if (R.flags & 1u) {
    o = L;
    o.suf = L.suf + R.suf;
  } else if (L.flags & 1u) {
    o = Span{R.flags & 2u, L.suf + R.pre, R.suf, R.e};
  } else {
    const bool emit = (R.flags & 2u) && clampv(L.suf + R.pre) >= cut;
    o = Span{L.flags & 2u, L.pre, R.suf, L.e + R.e + (emit ? 1ull : 0ull)};
  }
  return o;
}

static __device__ __forceinline__ ulonglong2 span_pack(const Span& a) {
  return make_ulonglong2((unsigned long long)a.pre | ((unsigned long long)a.suf << 32),
                         (a.e << 2) | a.flags);
}

static __device__ __forceinline__ Span span_unpack(ulonglong2 v) {
  return Span{(uint32_t)(v.y & 3u), (uint32_t)v.x, (uint32_t)(v.x >> 32), v.y >> 2};
}

static __device__ __forceinline__ Span span_shfl_down(const Span& a, int off) {
  return Span{__shfl_down_sync(K2_FULL, a.flags, off), __shfl_down_sync(K2_FULL, a.pre, off),
              __shfl_down_sync(K2_FULL, a.suf, off), __shfl_down_sync(K2_FULL, a.e, off)};
}

// (f, s) <- (f, s) then (f2, s2): a segmented sum, reset at a head
static __device__ __forceinline__ void seg_cat(bool& f, uint32_t& s, bool f2, uint32_t s2) {
  s = f2 ? s2 : s + s2;
  f = f || f2;
}

static __device__ __forceinline__ int64_t key_at(const int64_t* __restrict__ keys, long long n,
                                                 long long i) {
  return i < n ? keys[i] : (int64_t)LT_SENTINEL;
}

// A warp's step: rows base + 8 lane + j, j < 8; past n: SENTINEL, count
// 0. Without COUNTS a row's value is 1 (a SENTINEL row's too: SENTINEL
// runs are never emitted and never merge with a valid run).
template <bool COUNTS>
struct Step {
  int64_t k[K2_ITEMS];
  uint32_t v[COUNTS ? K2_ITEMS : 1];
  __device__ __forceinline__ uint32_t val(int j) const { return COUNTS ? v[COUNTS ? j : 0] : 1u; }
};

template <bool COUNTS>
static __device__ __forceinline__ void step_load(const int64_t* __restrict__ keys,
                                                 const int32_t* __restrict__ counts, long long n,
                                                 long long base, bool vec, Step<COUNTS>& s) {
  const long long i = base + K2_ITEMS * (threadIdx.x & 31);
  if (vec && base + K2_STEP <= n) {  // 16-byte loads: four of two keys, two of four counts
#pragma unroll
    for (int q = 0; q < K2_ITEMS / 2; ++q) {
      const longlong2 kk = *reinterpret_cast<const longlong2*>(keys + i + 2 * q);
      s.k[2 * q] = kk.x;
      s.k[2 * q + 1] = kk.y;
    }
    if (COUNTS) {
#pragma unroll
      for (int q = 0; q < K2_ITEMS / 4; ++q) {
        const int4 cc = *reinterpret_cast<const int4*>(counts + i + 4 * q);
        s.v[COUNTS ? 4 * q : 0] = (uint32_t)cc.x, s.v[COUNTS ? 4 * q + 1 : 0] = (uint32_t)cc.y;
        s.v[COUNTS ? 4 * q + 2 : 0] = (uint32_t)cc.z, s.v[COUNTS ? 4 * q + 3 : 0] = (uint32_t)cc.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < K2_ITEMS; ++j) {
      s.k[j] = key_at(keys, n, i + j);
      if (COUNTS) s.v[COUNTS ? j : 0] = i + j < n ? (uint32_t)counts[i + j] : 0u;
    }
  }
}

// One step of a warp: heads and tails (prev: the key before the step,
// SENTINEL before row 0), segmented sums from the step's first row (each
// lane's eight rows in turn, one warp scan of the lanes' sums), and the
// step's Span, the same in every lane. A run that ends on the step's last
// row is closed by the next step (its row 0 is a head: the run entering
// from the left ends at the edge, pending with a partial sum of 0), so a
// step needs no key after it; a SENTINEL row after the last closes the
// last run. The write pass (WRITE) also writes every run that ends in the
// step at its offset, from the prefix P before the step: in order into
// the warp's staging rows (stage_k, stage_c), then out with coalesced
// stores.
template <bool WRITE, bool COUNTS>
static __device__ __forceinline__ Span step_run(const Step<COUNTS>& s, int64_t prev, uint32_t cut,
                                                const Span& P, int64_t* __restrict__ out_k,
                                                int32_t* __restrict__ out_c, int* hist,
                                                int64_t* stage_k, int32_t* stage_c) {
  const int lane = threadIdx.x & 31;
  const int64_t up = __shfl_up_sync(K2_FULL, s.k[K2_ITEMS - 1], 1);
  bool h[K2_ITEMS];
#pragma unroll
  for (int j = 0; j < K2_ITEMS; ++j) h[j] = s.k[j] != (j ? s.k[j ? j - 1 : 0] : lane ? up : prev);
  const bool next_head = __shfl_down_sync(K2_FULL, h[0], 1);
  bool tl[K2_ITEMS];  // a tail: the next row in the step is a head
#pragma unroll
  for (int j = 0; j < K2_ITEMS; ++j)
    tl[j] = j + 1 < K2_ITEMS ? h[j + 1 < K2_ITEMS ? j + 1 : 0] : lane < 31 && next_head;
  // the lane's sum, the warp's inclusive scan of the lanes', then each
  // lane's prefix (xf, xs) and the step's total (cf, cs)
  bool af = false;
  uint32_t as = 0;
#pragma unroll
  for (int j = 0; j < K2_ITEMS; ++j) seg_cat(af, as, h[j], s.val(j));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    bool pf = __shfl_up_sync(K2_FULL, af, off);
    uint32_t ps = __shfl_up_sync(K2_FULL, as, off);
    if (lane >= off) {
      seg_cat(pf, ps, af, as);
      af = pf, as = ps;
    }
  }
  const bool cf = __shfl_sync(K2_FULL, af, 31);
  const uint32_t cs = __shfl_sync(K2_FULL, as, 31);
  bool xf = __shfl_up_sync(K2_FULL, af, 1);
  uint32_t xs = __shfl_up_sync(K2_FULL, as, 1);
  if (lane == 0) xf = false, xs = 0;
  // the step's Span: runs that start and end here are emitted or not now;
  // the one entering from the left, if it ends here (or at the edge),
  // waits for the carry
  const bool edge = lane == 0 && h[0] && prev != (int64_t)LT_SENTINEL;
  unsigned ne = 0;
  bool pend = edge;
  uint32_t pre = 0;
  {
    bool f = xf;
    uint32_t t = xs;
#pragma unroll
    for (int j = 0; j < K2_ITEMS; ++j) {
      seg_cat(f, t, h[j], s.val(j));
      if (!tl[j] || s.k[j] == (int64_t)LT_SENTINEL) continue;
      if (f) ne += clampv(t) >= cut;
      else pend = true, pre = t;  // at most one row of the step, and not with edge
    }
  }
  const unsigned pm = __ballot_sync(K2_FULL, pend);
  const int src = pm ? __ffs(pm) - 1 : 0;  // the lane that holds it
  pre = __shfl_sync(K2_FULL, pre, src);
  const Span A{(cf ? 0u : 1u) | (pm ? 2u : 0u), pre, cs,
               (unsigned long long)__reduce_add_sync(K2_FULL, ne)};
  if (!WRITE) return A;
  // the runs this lane writes: those the Span counted, and the entering
  // one if its sum with the carry passes the cutoff (the same in every lane)
  const bool pend_out = pm && clampv(P.suf + pre) >= cut;
  const unsigned nw = ne + (lane == src && pend_out);
  unsigned inc = nw;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(K2_FULL, inc, off);
    if (lane >= off) inc += y;
  }
  unsigned o = inc - nw;
  if (edge && pend_out) {  // the run before the step, first
    stage_k[o] = prev;
    stage_c[o] = (int32_t)clampv(P.suf);
    ++o;
    if (hist) atomicAdd(&hist[min(clampv(P.suf), 255u)], 1);
  }
  bool f = xf;
  uint32_t t = xs;
#pragma unroll
  for (int j = 0; j < K2_ITEMS; ++j) {
    seg_cat(f, t, h[j], s.val(j));
    const uint32_t val = clampv(f ? t : P.suf + t);
    if (!tl[j] || s.k[j] == (int64_t)LT_SENTINEL || !(f ? val >= cut : pend_out)) continue;
    stage_k[o] = s.k[j];
    stage_c[o] = (int32_t)val;
    ++o;
    if (hist) atomicAdd(&hist[min(val, 255u)], 1);
  }
  __syncwarp();
  const unsigned total = __shfl_sync(K2_FULL, inc, 31);
  for (unsigned r = lane; r < total; r += 32) {
    out_k[P.e + r] = stage_k[r];
    out_c[P.e + r] = stage_c[r];
  }
  __syncwarp();  // the staging rows are free for the next step
  return A;
}

// The fold, in order, of the n Spans at a, in every thread: each thread
// folds a contiguous stretch, then the lanes and the warps fold in order.
static __device__ Span block_fold(const ulonglong2* a, long long n, uint32_t cut, Span* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = (n + K2_THREADS - 1) / K2_THREADS;
  const long long lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  Span x = span_ident();
  if (hi - lo <= K2_FOLD) {  // every load issued before the first fold
    ulonglong2 w[K2_FOLD];
#pragma unroll
    for (int i = 0; i < K2_FOLD; ++i)
      if (lo + i < hi) w[i] = __ldcg(a + lo + i);
#pragma unroll
    for (int i = 0; i < K2_FOLD; ++i)
      if (lo + i < hi) x = cat(x, span_unpack(w[i]), cut);
  } else {
    for (long long i = lo; i < hi; ++i) x = cat(x, span_unpack(__ldcg(a + i)), cut);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Span y = span_shfl_down(x, off);
    if (lane + off < 32) x = cat(x, y, cut);
  }
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  Span r = span_ident();
  for (int w = 0; w < K2_WARPS; ++w) r = cat(r, sh[w], cut);
  __syncthreads();
  return r;
}

// Both passes, over a row policy Rows (KeyRows, WordRows): global warp g
// reduces the contiguous steps [g per, (g + 1) per) of Rows::STEP rows, one
// at a time, with the next step's loads in flight; no warp waits on
// another and no block barrier sits in the loop. The count pass ends with
// the warp's Span (the fold of its steps) in aggs[g], and the last block to
// finish folds them all into *total (the runs emitted). The write pass
// starts each warp from the fold of the warps before it.
//
// A policy holds its inputs and outputs and gives: STEP; Buf, a step's rows
// in registers, and load(n, base, buf); Prev, the row before a step, with
// before(n, base) (for the first step of a stretch) and last(buf); Stage, a
// warp's staging rows in shared memory; and run<WRITE>(buf, n, base, prev,
// cut, P, hist, stage), the step's Span (and, in the write pass, its runs
// written from the prefix P).
template <class Rows, bool WRITE>
__global__ void __launch_bounds__(K2_THREADS, 2)
runs_pass_kernel(const __grid_constant__ Rows rows, long long n, uint32_t cut, long long per,
                 ulonglong2* aggs, int* done, long long* __restrict__ total) {
  __shared__ int sh_hist[256];
  __shared__ Span sh_span[K2_WARPS];
  __shared__ int sh_last;
  __shared__ typename Rows::template Stage<WRITE> stage[K2_WARPS];
  constexpr int STEP = Rows::STEP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * K2_WARPS + warp;
  const long long n_steps = (n + STEP) / STEP;  // rows 0..n, row n past the last
  const long long s0 = min(n_steps, g * per), s1 = min(n_steps, s0 + per);
  int* hp = WRITE && rows.hist ? sh_hist : nullptr;
  if (hp)
    for (int t = threadIdx.x; t < 256; t += K2_THREADS) sh_hist[t] = 0;
  Span P = span_ident();  // the count pass: the fold so far
  if (WRITE) {            // the prefix before this warp's rows
    P = cat(Span{0u, 0u, 0u, 0ull},
            block_fold(aggs, (long long)blockIdx.x * K2_WARPS, cut, sh_span), cut);
    for (int w = 0; w < warp; ++w)
      P = cat(P, span_unpack(__ldcg(aggs + (long long)blockIdx.x * K2_WARPS + w)), cut);
  }
  __syncthreads();
  if (s0 < s1) {
    // two buffers in turn, never copied (a copy would wait for its loads):
    // step st in x[st % 2], step st + 1 in flight in the other
    typename Rows::Buf x0, x1;
    rows.load(n, s0 * STEP, x0);
    if (s0 + 1 < s1) rows.load(n, (s0 + 1) * STEP, x1);
    typename Rows::Prev prev = rows.before(n, s0 * STEP);
    auto step = [&](typename Rows::Buf& cur, long long st) {
      P = cat(P, rows.template run<WRITE>(cur, n, st * STEP, prev, cut, P, hp, stage[warp]), cut);
      prev = rows.last(cur);
      if (st + 2 < s1) rows.load(n, (st + 2) * STEP, cur);
    };
    for (long long st = s0; st < s1; st += 2) {
      step(x0, st);
      if (st + 1 >= s1) break;
      step(x1, st + 1);
    }
  }
  if (WRITE) {
    if (hp) {
      __syncthreads();
      for (int t = threadIdx.x; t < 256; t += K2_THREADS)
        if (sh_hist[t]) atomicAdd(&rows.hist[t], sh_hist[t]);
    }
    return;
  }
  if (lane == 0) {
    aggs[g] = span_pack(P);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) sh_last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (sh_last) {  // every warp's Span is out
    __threadfence();
    const Span all = block_fold(aggs, (long long)gridDim.x * K2_WARPS, cut, sh_span);
    if (threadIdx.x == 0) *total = (long long)cat(Span{0u, 0u, 0u, 0ull}, all, cut).e;
  }
}

// K2's rows: one int64 key each, SENTINEL past n and before row 0
template <bool COUNTS>
struct KeyRows {
  static constexpr int STEP = K2_STEP;
  using Buf = Step<COUNTS>;
  using Prev = int64_t;
  template <bool WRITE>
  struct Stage {
    int64_t k[WRITE ? STEP : 1];
    int32_t c[WRITE ? STEP : 1];
  };
  const int64_t* keys;
  const int32_t* counts;
  int32_t* hist;
  int64_t* out_k;
  int32_t* out_c;
  bool vec;  // keys (and counts) 16-byte aligned
  __device__ __forceinline__ void load(long long n, long long base, Buf& s) const {
    step_load(keys, counts, n, base, vec, s);
  }
  __device__ __forceinline__ Prev before(long long n, long long base) const {
    return base > 0 ? key_at(keys, n, base - 1) : (int64_t)LT_SENTINEL;
  }
  __device__ __forceinline__ Prev last(const Buf& s) const {
    return __shfl_sync(K2_FULL, s.k[K2_ITEMS - 1], 31);
  }
  template <bool WRITE, class St>
  __device__ __forceinline__ Span run(const Buf& s, long long, long long, Prev prev,
                                      uint32_t cut, const Span& P, int* hp, St& stage) const {
    return step_run<WRITE, COUNTS>(s, prev, cut, P, out_k, out_c, hp, stage.k, stage.c);
  }
};

// ---------------------------------------------------------------------------
// K14 runs_words / word_runs — reduce-by-key over sorted multiword k-mer
// rows, with K2's modes: a run's value is its length, or the u32-wrapping
// sum of an int32 counts payload clamped to 2^31-1; runs with value >=
// cutoff (>= 1) are written in order; the 256-bin histogram of min(value,
// 255) over them.
//
// Replaces the post-sort half of leon_tpu/ops/count.py count_batch (88-104)
// -> _sort_count_device (45-85): boundaries over the W sorted u32 key
// columns, run lengths by a reverse min-scan, the host compaction of the
// boundary rows; and, at W = 2..16 on the main path, _compact_run (208-223),
// _merge_sorted_runs' segment sums (226-254), _hist_of_sorted (257-264) and
// compact_solid (707-719). The sort before it is K22 radix_sort of the
// rows' top 64 bits and K20 below (W >= 3), or K22 of the one plane.
//
// Input: the sorted keys as NP = ceil(W/2) int64 planes (kmer_words.cuh),
// the rows already the valid ones (no sentinel: at k = 16W a canonical
// palindrome can have an all-ones top word and must count), n < 2^32 (a
// run's length is a u32). Output: each emitted run's W words (unflipped)
// and its value: int64 run lengths, unclamped (count_batch's runs_words,
// every run) or int32 clamped values (the counter's word_runs).
//
// Bound on the H100: device-memory traffic, 8 NP bytes (+4 with counts)
// read per row and 4W + 4 or 8 written per emitted run. Design: K2's two
// passes and Spans over WordRows. A lane holds ITEMS rows of a step,
// interleaved (row base + 32 j + lane: every load of a plane is 256
// contiguous bytes a warp); a row's head bit is its planes compared, plane
// by plane, with the row before it (one shuffle a plane and item; lane 0
// takes lane 31's row of the item before, or the previous step's last row,
// carried in NP registers); each item's segmented sums are one warp scan,
// carried from item to item. The write pass gives each emitted run a slot
// in order (a ballot an item), stages its W words in shared memory in the
// output's own layout (a pad word every 32, so that the lanes' rows and the
// copy-out both hit distinct banks), then the warp copies the step's runs
// out as one contiguous stretch of u32 words: consecutive lanes write
// consecutive words. ITEMS shrinks with NP so that the staging rows stay
// within the 48 KB of static shared memory (8 rows a lane at NP = 1, 4 at
// NP <= 4, 2 past it).
//
// The row policy (ROWSIN; the WordCounter's final run, already sorted:
// finalize's reduce and its solid compaction): the same passes over (n, W)
// u32 rows as they stand, a row's "planes" read as its word pairs (words 2q
// and 2q + 1 in one 8-byte load where W is even and the rows 8-byte aligned),
// unflipped; a run boundary is any word that differs from the row before, and
// each emitted row is copied out as it stands. It takes the place of
// state.words_to_planes before K14 (PyTorch's elementwise kernels over the
// whole run). Counts payload only (the counter's runs always carry one).
// ---------------------------------------------------------------------------

template <int NP, bool COUNTS, bool ROWSIN = false>
struct WordRows {
  static constexpr int ITEMS = NP == 1 ? 8 : NP <= 4 ? 4 : 2;  // ops/count.py _word_runs_step
  static constexpr int STEP = 32 * ITEMS;
  static constexpr int STAGE_WORDS = STEP * 2 * NP + STEP * 2 * NP / 32;
  struct Buf {
    int64_t k[ITEMS][NP];
    uint32_t v[COUNTS ? ITEMS : 1];
  };
  struct Prev {
    int64_t k[NP];
  };
  template <bool WRITE>
  struct Stage {
    uint32_t w[WRITE ? STAGE_WORDS : 1];  // word i of the step's runs at i + i / 32
    uint32_t v[WRITE ? STEP : 1];         // their values (a length < 2^32, or clamped)
  };
  PlanePtrs pl;
  const int32_t* counts;
  int32_t* hist;
  uint32_t* out_w;
  int32_t* out_v32;    // word_runs: clamped values
  long long* out_v64;  // runs_words: lengths (used when not null)
  int W;
  const uint32_t* rw;  // ROWSIN: the (n, W) rows
  bool vec8;           // ROWSIN: W even and rw 8-byte aligned

  // plane q of row r: the plane, or (ROWSIN) words 2q + 1 and 2q of the row
  __device__ __forceinline__ int64_t unit(long long r, int q) const {
    if (!ROWSIN) return __ldg(pl.p[q] + r);
    if (vec8) return (int64_t)__ldg(reinterpret_cast<const unsigned long long*>(rw + r * W) + q);
    const uint32_t* p = rw + r * W + 2 * q;
    const uint32_t hi = 2 * q + 1 < W ? __ldg(p + 1) : 0u;
    return (int64_t)(((unsigned long long)hi << 32) | __ldg(p));
  }
  __device__ __forceinline__ void load(long long n, long long base, Buf& b) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long r = base + 32 * j + lane;
      const bool ok = r < n;
#pragma unroll
      for (int q = 0; q < NP; ++q) b.k[j][q] = ok ? unit(r, q) : 0;
      if (COUNTS) b.v[COUNTS ? j : 0] = ok ? (uint32_t)__ldg(counts + r) : 0u;
    }
  }
  __device__ __forceinline__ Prev before(long long, long long base) const {
    Prev p;
#pragma unroll
    for (int q = 0; q < NP; ++q) p.k[q] = base > 0 ? unit(base - 1, q) : 0;
    return p;
  }
  __device__ __forceinline__ Prev last(const Buf& b) const {
    Prev p;
#pragma unroll
    for (int q = 0; q < NP; ++q) p.k[q] = __shfl_sync(K2_FULL, b.k[ITEMS - 1][q], 31);
    return p;
  }
  // stage a run in slot: its W words (from its planes) and its value
  template <class St>
  __device__ __forceinline__ void put(St& stage, unsigned slot, const int64_t (&key)[NP],
                                      uint32_t s, int* hp) const {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const unsigned long long x = (unsigned long long)key[q] ^ (ROWSIN ? 0ull : 1ull << 63);
      const unsigned i = slot * W + 2 * q;
      stage.w[i + (i >> 5)] = (uint32_t)x;
      if (2 * q + 1 < W) stage.w[i + 1 + ((i + 1) >> 5)] = (uint32_t)(x >> 32);
    }
    stage.v[slot] = out_v64 ? s : clampv(s);
    if (hp) atomicAdd(&hp[min(clampv(s), 255u)], 1);
  }
  // A warp's step over rows base + 32 j + lane (past n: not valid, each its
  // own run, never emitted); K2's step_run over interleaved rows.
  template <bool WRITE, class St>
  __device__ __forceinline__ Span run(const Buf& b, long long n, long long base, const Prev& prev,
                                      uint32_t cut, const Span& P, int* hp, St& stage) const {
    const int lane = threadIdx.x & 31;
    bool same[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) same[j] = true;
#pragma unroll
    for (int q = 0; q < NP; ++q) {  // plane by plane: the row before is lane - 1's row
      int64_t up = prev.k[q];       // lane 0: lane 31's row of the item before
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int64_t rot = __shfl_sync(K2_FULL, b.k[j][q], (lane + 31) & 31);
        same[j] = same[j] && b.k[j][q] == (lane ? rot : up);
        up = rot;
      }
    }
    bool h[ITEMS], vd[ITEMS], nh[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long r = base + 32 * j + lane;
      vd[j] = r < n;
      h[j] = !vd[j] || r == 0 || !same[j];
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) nh[j] = __shfl_sync(K2_FULL, h[j], (lane + 1) & 31);
    bool tl[ITEMS];  // a tail: the next row in the step is a head
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      tl[j] = lane < 31 ? nh[j] : j + 1 < ITEMS && nh[j + 1 < ITEMS ? j + 1 : 0];
    // each row's segmented sum from the step's first row: a warp scan an
    // item, the carry (cf, cs) from the item before
    bool F[ITEMS], cf = false;
    uint32_t S[ITEMS], cs = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      bool af = h[j];
      uint32_t as = COUNTS ? b.v[COUNTS ? j : 0] : 1u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        bool pf = __shfl_up_sync(K2_FULL, af, off);
        uint32_t ps = __shfl_up_sync(K2_FULL, as, off);
        if (lane >= off) {
          seg_cat(pf, ps, af, as);
          af = pf, as = ps;
        }
      }
      F[j] = cf || af;
      S[j] = af ? as : cs + as;
      cf = __shfl_sync(K2_FULL, F[j], 31);
      cs = __shfl_sync(K2_FULL, S[j], 31);
    }
    // the step's Span, as K2's (step_run)
    const bool edge = lane == 0 && h[0] && base > 0;
    unsigned ne = 0;
    bool pend = edge;
    uint32_t pre = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (!tl[j] || !vd[j]) continue;
      if (F[j]) ne += clampv(S[j]) >= cut;
      else pend = true, pre = S[j];
    }
    const unsigned pm = __ballot_sync(K2_FULL, pend);
    const int src = pm ? __ffs(pm) - 1 : 0;
    pre = __shfl_sync(K2_FULL, pre, src);
    const Span A{(cf ? 0u : 1u) | (pm ? 2u : 0u), pre, cs,
                 (unsigned long long)__reduce_add_sync(K2_FULL, ne)};
    if (!WRITE) return A;
    // slots in row order: the run before the step first, then item by item
    const bool pend_out = pm && clampv(P.suf + pre) >= cut;
    if (edge && pend_out) put(stage, 0u, prev.k, P.suf, hp);
    unsigned o = __shfl_sync(K2_FULL, (unsigned)(edge && pend_out), 0);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool em = tl[j] && vd[j] && (F[j] ? clampv(S[j]) >= cut : pend_out);
      const unsigned m = __ballot_sync(K2_FULL, em);
      if (em) put(stage, o + __popc(m & ((1u << lane) - 1u)), b.k[j], F[j] ? S[j] : P.suf + S[j],
                  hp);
      o += __popc(m);
    }
    __syncwarp();
    const unsigned long long e0 = P.e;
    uint32_t* ow = out_w + e0 * (unsigned long long)W;
    const unsigned nw = o * (unsigned)W;
    for (unsigned i = lane; i < nw; i += 32) ow[i] = stage.w[i + (i >> 5)];
    for (unsigned r = lane; r < o; r += 32) {
      if (out_v64) out_v64[e0 + r] = stage.v[r];
      else out_v32[e0 + r] = (int32_t)stage.v[r];
    }
    __syncwarp();  // the staging rows are free for the next step
    return A;
  }
};

// ---------------------------------------------------------------------------
// Host side: the grid, the scratch and the two passes of any row policy
// ---------------------------------------------------------------------------

// The grid both passes of Rows use for n rows: (blocks, steps a warp), at
// most the blocks the card holds at once of either pass (found once).
template <class Rows>
static int runs_grid(long long n, long long* blocks, long long* per) {
  static int resident = 0;
  if (!resident) {
    int least = 1 << 30;
    for (auto k : {runs_pass_kernel<Rows, false>, runs_pass_kernel<Rows, true>}) {
      int b = 0;
      LT_TRY(resident_blocks(k, K2_THREADS, &b));
      least = std::min(least, b);
    }
    resident = least;
  }
  const long long steps = (n + Rows::STEP) / Rows::STEP;
  *blocks = std::min((long long)resident, (steps + K2_WARPS - 1) / K2_WARPS);
  *per = (steps + *blocks * K2_WARPS - 1) / (*blocks * K2_WARPS);
  return 0;
}

// scratch: a 16-byte Span a warp and the done counter (ops/count.py
// _runs_scratch_bytes)
static bool runs_scratch_ok(long long blocks, long long scratch_bytes) {
  return scratch_bytes >= 16 * blocks * K2_WARPS + 4;
}

static uint32_t runs_cut(int cutoff) { return (uint32_t)(cutoff < 1 ? 1 : cutoff); }

// The count pass: *total = the runs emitted for these arguments.
template <class Rows>
static int pass_count(const Rows& rows, long long n, int cutoff, void* scratch,
                      long long scratch_bytes, void* total, cudaStream_t st) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaMemsetAsync(total, 0, sizeof(long long), st);
  long long blocks, per;
  LT_TRY((cudaError_t)runs_grid<Rows>(n, &blocks, &per));
  if (!runs_scratch_ok(blocks, scratch_bytes)) return (int)cudaErrorInvalidValue;
  ulonglong2* aggs = (ulonglong2*)scratch;
  int* done = (int*)(aggs + blocks * K2_WARPS);
  LT_TRY(cudaMemsetAsync(done, 0, sizeof(int), st));
  runs_pass_kernel<Rows, false><<<(unsigned)blocks, K2_THREADS, 0, st>>>(
      rows, n, runs_cut(cutoff), per, aggs, done, (long long*)total);
  return (int)cudaGetLastError();
}

// The write pass, after the count pass on the same arguments and scratch,
// into outputs of the count's R rows (and the histogram, when rows.hist).
template <class Rows>
static int pass_write(const Rows& rows, long long n, int cutoff, void* scratch,
                      long long scratch_bytes, cudaStream_t st) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (rows.hist) LT_TRY(cudaMemsetAsync(rows.hist, 0, 256 * sizeof(int32_t), st));
  if (n == 0) return (int)cudaSuccess;
  long long blocks, per;
  LT_TRY((cudaError_t)runs_grid<Rows>(n, &blocks, &per));
  if (!runs_scratch_ok(blocks, scratch_bytes)) return (int)cudaErrorInvalidValue;
  runs_pass_kernel<Rows, true><<<(unsigned)blocks, K2_THREADS, 0, st>>>(
      rows, n, runs_cut(cutoff), per, (ulonglong2*)scratch, nullptr, nullptr);
  return (int)cudaGetLastError();
}

static bool keys_vec(const void* keys, const void* counts) {
  return !((uintptr_t)keys & 15) && !((uintptr_t)counts & 15);
}

// K2's count pass: *total = the runs K2 emits for these arguments.
extern "C" int lt_runs_count(const void* keys, const void* counts, long long n, int cutoff,
                             void* scratch, long long scratch_bytes, void* total,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* k = (const int64_t*)keys;
  const int32_t* c = (const int32_t*)counts;
  const bool vec = keys_vec(keys, counts);
  if (counts)
    return pass_count(KeyRows<true>{k, c, nullptr, nullptr, nullptr, vec}, n, cutoff, scratch,
                      scratch_bytes, total, st);
  return pass_count(KeyRows<false>{k, c, nullptr, nullptr, nullptr, vec}, n, cutoff, scratch,
                    scratch_bytes, total, st);
}

// K2's write pass, after the count pass on the same arguments and scratch:
// out_keys (R,) int64, out_counts (R,) int32 for the count's R; hist: 256
// int32 or null.
extern "C" int lt_runs_write(const void* keys, const void* counts, long long n, int cutoff,
                             void* hist, void* out_keys, void* out_counts, void* scratch,
                             long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* k = (const int64_t*)keys;
  const int32_t* c = (const int32_t*)counts;
  int32_t* hs = (int32_t*)hist;
  int64_t* ok = (int64_t*)out_keys;
  int32_t* oc = (int32_t*)out_counts;
  const bool vec = keys_vec(keys, counts);
  if (counts)
    return pass_write(KeyRows<true>{k, c, hs, ok, oc, vec}, n, cutoff, scratch, scratch_bytes,
                      st);
  return pass_write(KeyRows<false>{k, c, hs, ok, oc, vec}, n, cutoff, scratch, scratch_bytes, st);
}

// K14's two passes over n_planes = ceil(W/2) planes (the host array of
// their pointers), counts null (run lengths) or int32; out_v64 (runs_words'
// int64 lengths) or out_v32 (word_runs' int32 values) in the write pass.
static int words_pass(bool write, const void* planes, int n_planes, const void* counts,
                      long long n, int W, int cutoff, void* hist, void* out_w, void* out_v32,
                      void* out_v64, void* scratch, long long scratch_bytes, void* total,
                      void* stream) {
  if (n < 0 || n > 0xFFFFFFFFll || n_planes < 1 || n_planes > LT_MAX_PLANES)
    return (int)cudaErrorInvalidValue;
  if (write && (W < 1 || W > 16 || n_planes != (W + 1) / 2)) return (int)cudaErrorInvalidValue;
  PlanePtrs pl = {};
  if (n > 0 && !load_planes(planes, n_planes, &pl)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)counts;
  int32_t* hs = (int32_t*)hist;
  uint32_t* ow = (uint32_t*)out_w;
  int32_t* o32 = (int32_t*)out_v32;
  long long* o64 = (long long*)out_v64;
#define LAUNCH(NP_, C_)                                                                   \
  {                                                                                       \
    const WordRows<NP_, C_> rows{pl, c, hs, ow, o32, o64, W};                             \
    return write ? pass_write(rows, n, cutoff, scratch, scratch_bytes, st)                \
                 : pass_count(rows, n, cutoff, scratch, scratch_bytes, total, st);        \
  }
#define CASE(NP_)                   \
  case NP_:                         \
    if (counts) LAUNCH(NP_, true)   \
    LAUNCH(NP_, false)
  switch (n_planes) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CASE
#undef LAUNCH
}

// K14's row policy: both passes over (n, W) u32 rows (W <= 16) with int32
// counts, as words_pass over their planes.
static int rows_pass(bool write, const void* rows, int W, const void* counts, long long n,
                     int cutoff, void* hist, void* out_w, void* out_v32, void* scratch,
                     long long scratch_bytes, void* total, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFll || W < 1 || W > 16 || (n > 0 && (!rows || !counts)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* rw = (const uint32_t*)rows;
  const bool vec8 = W % 2 == 0 && (reinterpret_cast<uintptr_t>(rows) & 7) == 0;
  const int32_t* c = (const int32_t*)counts;
  int32_t* hs = (int32_t*)hist;
  uint32_t* ow = (uint32_t*)out_w;
  int32_t* o32 = (int32_t*)out_v32;
#define CASE(NP_)                                                                         \
  case NP_: {                                                                             \
    const WordRows<NP_, true, true> r{PlanePtrs{}, c, hs, ow, o32, nullptr, W, rw, vec8}; \
    return write ? pass_write(r, n, cutoff, scratch, scratch_bytes, st)                   \
                 : pass_count(r, n, cutoff, scratch, scratch_bytes, total, st);           \
  }
  switch ((W + 1) / 2) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// K14's row policy, count pass: *total = the runs emitted.
extern "C" int lt_word_runs_rows_count(const void* rows, int W, const void* counts, long long n,
                                       int cutoff, void* scratch, long long scratch_bytes,
                                       void* total, void* stream) {
  return rows_pass(false, rows, W, counts, n, cutoff, nullptr, nullptr, nullptr, scratch,
                   scratch_bytes, total, stream);
}

// K14's row policy, write pass: each emitted run's W words and its int32
// clamped value (outputs may be null when R = 0); hist: 256 int32 or null.
extern "C" int lt_word_runs_rows_write(const void* rows, int W, const void* counts, long long n,
                                       int cutoff, void* hist, void* out_words, void* out_values,
                                       void* scratch, long long scratch_bytes, void* stream) {
  return rows_pass(true, rows, W, counts, n, cutoff, hist, out_words, out_values, scratch,
                   scratch_bytes, nullptr, stream);
}

// K14's count pass (count_batch's runs_words: counts null, cutoff 1; the
// WordCounter's word_runs: counts null for run lengths, or int32):
// *total = R.
extern "C" int lt_word_runs_count(const void* planes, int n_planes, const void* counts,
                                  long long n, int cutoff, void* scratch,
                                  long long scratch_bytes, void* total, void* stream) {
  return words_pass(false, planes, n_planes, counts, n, 0, cutoff, nullptr, nullptr, nullptr,
                    nullptr, scratch, scratch_bytes, total, stream);
}

// The write pass: each emitted run's W words and value, int64 run lengths
// (values_i64: runs_words) or int32 clamped values (word_runs); the
// outputs may be null when R = 0 (an empty CUDA tensor has no storage);
// hist: 256 int32 or null.
extern "C" int lt_word_runs_write(const void* planes, int n_planes, const void* counts,
                                  long long n, int W, int cutoff, void* hist, void* out_words,
                                  void* out_values, int values_i64, void* scratch,
                                  long long scratch_bytes, void* stream) {
  return words_pass(true, planes, n_planes, counts, n, W, cutoff, hist, out_words,
                    values_i64 ? nullptr : out_values, values_i64 ? out_values : nullptr,
                    scratch, scratch_bytes, nullptr, stream);
}

// ---------------------------------------------------------------------------
// K20 sort_ties — count_batch's valid rows in the reference's order (u32
// words, MSW first) after one K22 sort of their top 64 bits, written as
// the P = ceil(W/2) sign-flipped int64 planes K14 reduces (W = 3..16).
//
// Replaces: the sort of leon_tpu/ops/count.py _sort_count_device (45-85,
// lax.sort over W key columns, called from count_batch 88-104), with K22
// radix_sort (csrc/sort.cu) of one int64 key (words W-1 and W-2,
// sign-flipped) and its row index before it. (The P-pass LSD sort it replaces gathered every
// plane sorted so far again at each pass: P(P+1)/2 random plane gathers.)
//
// Input: keys (n,) int64 sorted ascending, src (n,) int64: sorted row i is
// row src[i] of rows (N, W) u32; dst (n,) int64 or null: where sorted row
// i goes (dst[i], or i); pay (N,) int32 or null: a payload that travels
// with its row (the WordCounter's merge: each distinct row's count,
// leon_tpu/ops/count.py _merge_sorted_runs 226-254 sorts it along). Output:
// the planes of every row at its place, each run of equal keys ordered by
// its rows (MSW first, equal rows in src order: the sort is stable), and
// pay_out[place] = pay[src] wherever a row is written.
//
// Bound on the H100: device-memory bytes, keys and src read (16 n), the rows
// gathered (4W n; a row is 4W contiguous bytes; a payload 4 n more) and the
// planes written (8P n; a payload 4 n). Design: one thread a sorted
// position, whole rows gathered with 16- or 8-byte loads where W and
// alignment allow; a row's payload is gathered where the row is written. A
// position that is its own run writes its row at once. The first row of a
// longer run finds the run's end by a galloping search over the keys. Runs of up to ST_WARP_RUN
// rows are settled by their head's warp, one run after another: a lane a
// row, all rows equal (duplicates are common: at W = 4, 17.4M rows hold
// 10.0M distinct) checked by one vote, else each lane's rank counted over
// the run's rows broadcast by shuffles. Runs of up to ST_BLOCK_RUN rows are
// listed (a warp-aggregated atomic a class) for sort_ties_block_kernel: a
// block a run, its rows in shared memory, the same vote and ranks. (Runs
// wholly inside a warp settled at once instead, each lane's rank counted
// over the warp's 32 rows by shuffles, took 0.96 / 2.29 / 3.95 ms of
// device time against 0.87 / 1.78 / 3.16 at W = 4 / 8 / 16: PERF.md §6,
// row 12b.) Longer
// runs are listed for the caller, which orders them by the next plane
// (two K22 sorts: by that plane, then by run) and runs these kernels again over them with
// the finer runs as keys (ops/count.py _tie_rounds); in the last round the
// keys cover every word, so every run is of equal rows and each thread
// writes its own row (final).
// ---------------------------------------------------------------------------

#define ST_THREADS 256
#define ST_WARP_RUN 32     // runs of up to this many rows: a warp
#define ST_BLOCK_RUN 1024  // up to this many: a block, rows in shared memory
#define ST_LEN_BITS 11     // a listed block run: start << ST_LEN_BITS | length

// the payload that travels with the rows (both null without one)
struct TiePay {
  const int32_t* in;
  int32_t* out;
};

// lists: [0] block runs listed, [1] long runs listed, then cap_mid block
// runs, then (start, length) pairs of the long runs (ops/count.py
// _ties_lists)
// row c (row j of the input) at its place pos, with its payload where PAY
template <int W, bool PAY>
static __device__ __forceinline__ void st_put(const PlanePtrs& out, const TiePay& pay,
                                              long long pos, const Kmer<W>& c, long long j) {
  constexpr int NH = (W + 1) / 2;
#pragma unroll
  for (int h = 0; h < NH; ++h)
    out.p[h][pos] =
        (int64_t)((((unsigned long long)word_or_zero<W>(c, 2 * h + 1) << 32) | c.w[2 * h]) ^
                  (1ull << 63));
  if constexpr (PAY) pay.out[pos] = __ldg(pay.in + j);
}

// the first index past i whose key differs from keys[i] (keys[i + 1] equals it)
static __device__ long long st_run_end(const long long* __restrict__ keys, long long n,
                                       long long i, long long key) {
  long long lo = i + 1, step = 1;  // keys[lo] == key
  for (;;) {
    const long long hi = lo + step;
    if (hi >= n || keys[hi] != key) {
      long long b = hi < n ? hi : n;  // b == n or keys[b] != key
      while (b - lo > 1) {
        const long long m = lo + (b - lo) / 2;
        if (keys[m] == key)
          lo = m;
        else
          b = m;
      }
      return b;
    }
    lo = hi;
    step <<= 1;
  }
}

// a slot of a list for each lane that wants one (every lane calls it)
static __device__ __forceinline__ unsigned long long st_slot(bool want,
                                                             unsigned long long* counter) {
  const unsigned m = __ballot_sync(K2_FULL, want);
  if (!m) return 0;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  unsigned long long base = 0;
  if (lane == leader) base = atomicAdd(counter, (unsigned long long)__popc(m));
  base = __shfl_sync(K2_FULL, base, leader);
  return base + __popc(m & ((1u << lane) - 1u));
}

// rank of row r among the m rows of a run (ties by index t), counted over
// row(j) for j < m; all equal: its own index
template <int W, class Row>
static __device__ __forceinline__ int st_rank(const Kmer<W>& r, int t, int m, Row row) {
  int rank = 0;
  for (int j = 0; j < m; ++j) {
    const Kmer<W> o = row(j);
    rank += (int)(lex_less<W>(o, r) || (j < t && same_kmer<W>(o, r)));
  }
  return rank;
}

template <int W, bool PAY>
__global__ void __launch_bounds__(ST_THREADS)
    sort_ties_kernel(const long long* __restrict__ keys, const long long* __restrict__ src,
                     const uint32_t* __restrict__ rows, bool vec, long long n,
                     const long long* __restrict__ dst, bool final_,
                     const __grid_constant__ PlanePtrs out, const TiePay pay,
                     unsigned long long* __restrict__ lists, long long cap_mid) {
  const long long i = (long long)blockIdx.x * ST_THREADS + threadIdx.x;
  const bool in = i < n;
  if (final_) {  // every run is of equal rows
    if (in) {
      const long long j = src[i];
      st_put<W, PAY>(out, pay, dst ? dst[i] : i, load_kmer_vec<W>(rows, j, vec), j);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const long long key = in ? keys[i] : 0;
  long long kp = __shfl_up_sync(K2_FULL, key, 1), kn = __shfl_down_sync(K2_FULL, key, 1);
  if (lane == 0 && in && i > 0) kp = keys[i - 1];
  if (lane == 31 && i + 1 < n) kn = keys[i + 1];
  const bool eq_prev = in && i > 0 && kp == key, eq_next = i + 1 < n && kn == key;
  if (in && !eq_prev && !eq_next) {
    const long long j = src[i];
    st_put<W, PAY>(out, pay, dst ? dst[i] : i, load_kmer_vec<W>(rows, j, vec), j);
  }
  const bool head = in && !eq_prev && eq_next;
  const long long len = head ? st_run_end(keys, n, i, key) - i : 0;
  const bool mid = len > ST_WARP_RUN && len <= ST_BLOCK_RUN, lng = len > ST_BLOCK_RUN;
  const unsigned long long sm = st_slot(mid, lists);
  if (mid) lists[2 + sm] = ((unsigned long long)i << ST_LEN_BITS) | (unsigned long long)len;
  const unsigned long long sl = st_slot(lng, lists + 1);
  if (lng) {
    lists[2 + cap_mid + 2 * sl] = (unsigned long long)i;
    lists[2 + cap_mid + 2 * sl + 1] = (unsigned long long)len;
  }
  // the warp's runs of 2 .. ST_WARP_RUN rows, one after another
  unsigned todo = __ballot_sync(K2_FULL, head && len <= ST_WARP_RUN);
  while (todo) {
    const int h = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long s = __shfl_sync(K2_FULL, i, h);
    const int m = (int)__shfl_sync(K2_FULL, len, h);
    Kmer<W> r = {};
    const long long sj = lane < m ? src[s + lane] : 0;  // needed again only with PAY
    if (lane < m) r = load_kmer_vec<W>(rows, sj, vec);
    bool diff = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t v0 = __shfl_sync(K2_FULL, r.w[w], 0);  // every lane shuffles
      diff |= lane < m && r.w[w] != v0;
    }
    int rank = lane;
    if (__any_sync(K2_FULL, diff))
      rank = st_rank<W>(r, lane, m, [&](int j) {
        Kmer<W> o;
#pragma unroll
        for (int w = 0; w < W; ++w) o.w[w] = __shfl_sync(K2_FULL, r.w[w], j);
        return o;
      });
    if (lane < m) st_put<W, PAY>(out, pay, dst ? dst[s + rank] : s + rank, r, sj);
  }
}

// the listed runs of ST_WARP_RUN + 1 .. ST_BLOCK_RUN rows, a block a run
// (a grid of the card's resident blocks), the run's rows in dynamic shared
// memory
template <int W, bool PAY>
__global__ void __launch_bounds__(ST_THREADS)
    sort_ties_block_kernel(const long long* __restrict__ src, const uint32_t* __restrict__ rows,
                           bool vec, const long long* __restrict__ dst,
                           const __grid_constant__ PlanePtrs out, const TiePay pay,
                           const unsigned long long* __restrict__ lists) {
  extern __shared__ uint32_t s_run[];  // ST_BLOCK_RUN rows of W words
  const unsigned long long nm = lists[0];
  for (unsigned long long e = blockIdx.x; e < nm; e += gridDim.x) {
    const unsigned long long ent = lists[2 + e];
    const long long s = (long long)(ent >> ST_LEN_BITS);
    const int m = (int)(ent & ((1u << ST_LEN_BITS) - 1u));
    for (int t = threadIdx.x; t < m; t += ST_THREADS) {
      const Kmer<W> r = load_kmer_vec<W>(rows, src[s + t], vec);
#pragma unroll
      for (int w = 0; w < W; ++w) s_run[t * W + w] = r.w[w];
    }
    __syncthreads();
    bool diff = false;
    for (int t = threadIdx.x; t < m; t += ST_THREADS)
#pragma unroll
      for (int w = 0; w < W; ++w) diff |= s_run[t * W + w] != s_run[w];
    const bool any = __syncthreads_or(diff);
    for (int t = threadIdx.x; t < m; t += ST_THREADS) {
      Kmer<W> r;
#pragma unroll
      for (int w = 0; w < W; ++w) r.w[w] = s_run[t * W + w];
      const int rank = any ? st_rank<W>(r, t, m, [&](int j) {
        Kmer<W> o;  // every lane reads row j: a broadcast
#pragma unroll
        for (int w = 0; w < W; ++w) o.w[w] = s_run[j * W + w];
        return o;
      })
                           : t;
      st_put<W, PAY>(out, pay, dst ? dst[s + rank] : s + rank, r, PAY ? src[s + t] : 0);
    }
    __syncthreads();
  }
}

// K20 over n sorted keys (see above): the lists' two counters zeroed, the
// position pass, then the block pass (a grid of resident blocks reading the
// listed count). lists: 2 + cap_mid + 2 cap_long u64 (cap_mid >= n / 33 + 1,
// cap_long >= n / 1025 + 1); with final_ no run is listed. pay and pay_out:
// both (int32) or neither.
extern "C" int lt_sort_ties(const void* keys, const void* src, const void* rows, long long n,
                            int W, const void* dst, int final_, int n_planes, const void* planes,
                            const void* pay, void* pay_out, void* lists, long long cap_mid,
                            void* stream) {
  if (n < 0 || W < 3 || W > 16 || n_planes != (W + 1) / 2 ||
      cap_mid < n / (ST_WARP_RUN + 1) + 1 || (pay == nullptr) != (pay_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  PlanePtrs out;
  if (!load_planes(planes, n_planes, &out)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  LT_TRY(cudaMemsetAsync(lists, 0, 2 * sizeof(unsigned long long), st));
  const long long* k = (const long long*)keys;
  const long long* s = (const long long*)src;
  const uint32_t* r = (const uint32_t*)rows;
  const long long* d = (const long long*)dst;
  unsigned long long* ls = (unsigned long long*)lists;
  const TiePay tp = {(const int32_t*)pay, (int32_t*)pay_out};
  const uintptr_t a = reinterpret_cast<uintptr_t>(rows);
  const bool vec = W % 4 == 0 ? (a & 15) == 0 : (a & 7) == 0;
  const unsigned grid = (unsigned)((n + ST_THREADS - 1) / ST_THREADS);
  const size_t smem = (size_t)ST_BLOCK_RUN * W * sizeof(uint32_t);
#define LAUNCH_PAY(W_, P_)                                                                    \
  {                                                                                           \
    sort_ties_kernel<W_, P_><<<grid, ST_THREADS, 0, st>>>(k, s, r, vec, n, d, final_ != 0,    \
                                                          out, tp, ls, cap_mid);              \
    LT_TRY(cudaGetLastError());                                                               \
    if (!final_) {                                                                            \
      LT_TRY(cudaFuncSetAttribute(sort_ties_block_kernel<W_, P_>,                             \
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));   \
      int blocks = 0;                                                                         \
      LT_TRY(resident_blocks(sort_ties_block_kernel<W_, P_>, ST_THREADS, &blocks, 1 << 30,    \
                             smem));                                                          \
      sort_ties_block_kernel<W_, P_><<<blocks, ST_THREADS, smem, st>>>(s, r, vec, d, out, tp, \
                                                                       ls);                   \
    }                                                                                         \
  }
#define LAUNCH(W_)                 \
  if (pay) LAUNCH_PAY(W_, true)    \
  else LAUNCH_PAY(W_, false)       \
  break;
  switch (W) {
    case 3: LAUNCH(3)
    case 4: LAUNCH(4)
    case 5: LAUNCH(5)
    case 6: LAUNCH(6)
    case 7: LAUNCH(7)
    case 8: LAUNCH(8)
    case 9: LAUNCH(9)
    case 10: LAUNCH(10)
    case 11: LAUNCH(11)
    case 12: LAUNCH(12)
    case 13: LAUNCH(13)
    case 14: LAUNCH(14)
    case 15: LAUNCH(15)
    case 16: LAUNCH(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
#undef LAUNCH_PAY
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K21 plane_rows — the WordCounter's slab (K17's P = ceil(W/2) sign-flipped
// int64 planes, W = 3..16) as (n, W) u32 rows, and each row's top 64 bits
// as one sign-flipped int64 key (words W-1 and W-2, MSW first: signed order
// is their u32 order): the input of the slab's top sort and K20.
//
// Replaces no TPU program by itself: with the top sort and K20 it replaces
// the sort of the reference's slab, lax.sort over the W key columns in
// leon_tpu/ops/count.py _fused_sort_count (194-207). It is there because
// K20 gathers each row at random: a row is one or two 32-byte sectors, its
// P planes would be P.
//
// Bound on the H100: device-memory bytes, the planes read (8P n), the rows
// (4W n) and the keys (8 n) written. Design: a block takes ST_THREADS rows
// at a time (a grid of the card's resident blocks): a thread a row reads
// its P plane words (8-byte loads, coalesced across the warp) and writes
// its key (coalesced) and its W words into shared memory (a row every
// W + 1 words at even W, so that a warp's stores hit 32 banks); then the
// block writes its rows, one contiguous stretch of 4W bytes a row, in
// 16-byte stores. (A thread writing its own row in P 8-byte stores, 32
// rows of 32-64 bytes apart in a warp's store, took 1.08 / 1.46 ms at
// W = 8 / 16 against a byte bound of 0.53 / 0.52: PERF.md §6, rows 4c-8c.)
// ---------------------------------------------------------------------------

#define PR_STRIDE(W) ((W) % 2 == 0 ? (W) + 1 : (W))  // a row's words in shared memory

template <int W>
__global__ void __launch_bounds__(ST_THREADS)
    plane_rows_kernel(const __grid_constant__ PlanePtrs in, long long n,
                      uint32_t* __restrict__ rows, long long* __restrict__ top) {
  constexpr int NH = (W + 1) / 2, S = PR_STRIDE(W);
  __shared__ uint32_t s_rows[ST_THREADS * S];
  for (long long base = (long long)blockIdx.x * ST_THREADS; base < n;
       base += (long long)gridDim.x * ST_THREADS) {
    const long long i = base + threadIdx.x;
    const int m = (int)(n - base < ST_THREADS ? n - base : ST_THREADS);
    if (i < n) {
      unsigned long long u[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) u[h] = (unsigned long long)in.p[h][i] ^ (1ull << 63);
#pragma unroll
      for (int w = 0; w < W; ++w)
        s_rows[threadIdx.x * S + w] = (uint32_t)(u[w / 2] >> (32 * (w % 2)));
      const unsigned long long t =
          W % 2 == 0 ? u[NH - 1] : (u[NH - 1] << 32) | (u[NH - 2] >> 32);
      top[i] = (long long)(t ^ (1ull << 63));
    }
    __syncthreads();
    uint32_t* out = rows + base * W;  // 16-byte aligned: base is a multiple of ST_THREADS
    const int words = m * W, chunks = words / 4;
    for (int c = threadIdx.x; c < chunks; c += ST_THREADS) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * c + e;
        v[e] = s_rows[(j / W) * S + j % W];
      }
      reinterpret_cast<uint4*>(out)[c] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    for (int j = 4 * chunks + threadIdx.x; j < words; j += ST_THREADS)
      out[j] = s_rows[(j / W) * S + j % W];
    __syncthreads();
  }
}

// K21 over n rows: planes the host array of its P = (W + 1) / 2 pointers,
// rows (n, W) u32 (16-byte aligned), top (n,) int64.
extern "C" int lt_plane_rows(const void* planes, int n_planes, long long n, int W, void* rows,
                             void* top, void* stream) {
  if (n < 0 || W < 3 || W > 16 || n_planes != (W + 1) / 2 ||
      (reinterpret_cast<uintptr_t>(rows) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  PlanePtrs in;
  if (!load_planes(planes, n_planes, &in)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* r = (uint32_t*)rows;
  long long* t = (long long*)top;
  const long long need = (n + ST_THREADS - 1) / ST_THREADS;
#define LAUNCH(W_)                                                                     \
  {                                                                                    \
    int blocks = 0;                                                                    \
    LT_TRY(resident_blocks(plane_rows_kernel<W_>, ST_THREADS, &blocks));               \
    plane_rows_kernel<W_><<<(unsigned)(need < blocks ? need : blocks), ST_THREADS, 0,  \
                            st>>>(in, n, r, t);                                        \
  }                                                                                    \
  break;
  switch (W) {
    case 3: LAUNCH(3)
    case 4: LAUNCH(4)
    case 5: LAUNCH(5)
    case 6: LAUNCH(6)
    case 7: LAUNCH(7)
    case 8: LAUNCH(8)
    case 9: LAUNCH(9)
    case 10: LAUNCH(10)
    case 11: LAUNCH(11)
    case 12: LAUNCH(12)
    case 13: LAUNCH(13)
    case 14: LAUNCH(14)
    case 15: LAUNCH(15)
    case 16: LAUNCH(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
