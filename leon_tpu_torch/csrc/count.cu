// K2 runs — reduce-by-key over a sorted int64 key array; K14 runs_words
// (below) — the same over rows of one to eight int64 key planes (k <= 255).
//
// Replaces the count programs of leon_tpu/ops/count.py that follow the
// sort: _sort_count_device's boundaries and run lengths (45-85),
// _compact_run (208-223), _merge_sorted_runs' segment sums (226-254),
// _hist_of_sorted (257-264) and compact_solid (707-719). The sort itself
// stays a library call (torch.sort), as the reference leaves it to lax.sort.
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

#define RUNS_THREADS 256
#define SCAN_THREADS 1024

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

// Both passes: global warp g reduces the contiguous steps [g per, (g + 1)
// per), one at a time, with the next step's loads in flight; no warp
// waits on another and no block barrier sits in the loop. The count pass
// ends with the warp's Span (the fold of its steps) in aggs[g], and the
// last block to finish folds them all into *total (the runs emitted). The
// write pass starts each warp from the fold of the warps before it.
template <bool WRITE, bool COUNTS>
__global__ void __launch_bounds__(K2_THREADS, 2)
runs_pass_kernel(const int64_t* __restrict__ keys, const int32_t* __restrict__ counts,
                 long long n, uint32_t cut, long long per, int32_t* __restrict__ hist,
                 int64_t* __restrict__ out_k, int32_t* __restrict__ out_c, ulonglong2* aggs,
                 int* done, long long* __restrict__ total) {
  __shared__ int sh_hist[256];
  __shared__ Span sh_span[K2_WARPS];
  __shared__ int sh_last;
  __shared__ int64_t stage_k[WRITE ? K2_WARPS : 1][WRITE ? K2_STEP : 1];
  __shared__ int32_t stage_c[WRITE ? K2_WARPS : 1][WRITE ? K2_STEP : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * K2_WARPS + warp;
  const long long n_steps = (n + K2_STEP) / K2_STEP;  // rows 0..n, row n a SENTINEL
  const long long s0 = min(n_steps, g * per), s1 = min(n_steps, s0 + per);
  int* hp = WRITE && hist ? sh_hist : nullptr;
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
    const bool vec = !((uintptr_t)keys & 15) && !(COUNTS && ((uintptr_t)counts & 15));
    // two buffers in turn, never copied (a copy would wait for its loads):
    // step st in x[st % 2], step st + 1 in flight in the other
    Step<COUNTS> x0, x1;
    step_load(keys, counts, n, s0 * K2_STEP, vec, x0);
    if (s0 + 1 < s1) step_load(keys, counts, n, (s0 + 1) * K2_STEP, vec, x1);
    int64_t prev = s0 > 0 ? key_at(keys, n, s0 * K2_STEP - 1) : (int64_t)LT_SENTINEL;
    auto step = [&](Step<COUNTS>& cur, long long st) {
      P = cat(P, step_run<WRITE, COUNTS>(cur, prev, cut, P, out_k, out_c, hp,
                                         stage_k[WRITE ? warp : 0], stage_c[WRITE ? warp : 0]),
              cut);
      prev = __shfl_sync(K2_FULL, cur.k[K2_ITEMS - 1], 31);
      if (st + 2 < s1) step_load(keys, counts, n, (st + 2) * K2_STEP, vec, cur);
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
        if (sh_hist[t]) atomicAdd(&hist[t], sh_hist[t]);
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

// The grid both passes use for n rows: (blocks, steps a warp), at most
// the blocks the card holds at once (found once).
static int runs_grid(long long n, long long* blocks, long long* per) {
  static int per_sm = 0, sms = 0;
  if (!per_sm) {
    int dev = 0, least = 1 << 30;
    LT_TRY(cudaGetDevice(&dev));
    LT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    for (auto k : {runs_pass_kernel<false, false>, runs_pass_kernel<false, true>,
                   runs_pass_kernel<true, false>, runs_pass_kernel<true, true>}) {
      int b = 0;
      LT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, K2_THREADS, 0));
      least = std::min(least, b);
    }
    if (least < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm = least;
  }
  const long long steps = (n + K2_STEP) / K2_STEP;
  *blocks = std::min((long long)per_sm * sms, (steps + K2_WARPS - 1) / K2_WARPS);
  *per = (steps + *blocks * K2_WARPS - 1) / (*blocks * K2_WARPS);
  return 0;
}

// scratch: a 16-byte Span a warp and the done counter (ops/count.py
// _runs_scratch_bytes)
static bool runs_scratch_ok(long long blocks, long long scratch_bytes) {
  return scratch_bytes >= 16 * blocks * K2_WARPS + 4;
}

// The count pass: *total = the runs K2 emits for these arguments.
extern "C" int lt_runs_count(const void* keys, const void* counts, long long n, int cutoff,
                             void* scratch, long long scratch_bytes, void* total,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaMemsetAsync(total, 0, sizeof(long long), st);
  long long blocks, per;
  LT_TRY((cudaError_t)runs_grid(n, &blocks, &per));
  if (!runs_scratch_ok(blocks, scratch_bytes)) return (int)cudaErrorInvalidValue;
  ulonglong2* aggs = (ulonglong2*)scratch;
  int* done = (int*)(aggs + blocks * K2_WARPS);
  LT_TRY(cudaMemsetAsync(done, 0, sizeof(int), st));
  auto k = counts ? runs_pass_kernel<false, true> : runs_pass_kernel<false, false>;
  k<<<(unsigned)blocks, K2_THREADS, 0, st>>>((const int64_t*)keys, (const int32_t*)counts, n,
                                             (uint32_t)(cutoff < 1 ? 1 : cutoff), per, nullptr,
                                             nullptr, nullptr, aggs, done, (long long*)total);
  return (int)cudaGetLastError();
}

// The write pass, after the count pass on the same arguments and scratch:
// out_keys (R,) int64, out_counts (R,) int32 for the count's R; hist: 256
// int32 or null.
extern "C" int lt_runs_write(const void* keys, const void* counts, long long n, int cutoff,
                             void* hist, void* out_keys, void* out_counts, void* scratch,
                             long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (hist) LT_TRY(cudaMemsetAsync(hist, 0, 256 * sizeof(int32_t), st));
  if (n == 0) return (int)cudaSuccess;
  long long blocks, per;
  LT_TRY((cudaError_t)runs_grid(n, &blocks, &per));
  if (!runs_scratch_ok(blocks, scratch_bytes)) return (int)cudaErrorInvalidValue;
  auto k = counts ? runs_pass_kernel<true, true> : runs_pass_kernel<true, false>;
  k<<<(unsigned)blocks, K2_THREADS, 0, st>>>(
      (const int64_t*)keys, (const int32_t*)counts, n, (uint32_t)(cutoff < 1 ? 1 : cutoff), per,
      (int32_t*)hist, (int64_t*)out_keys, (int32_t*)out_counts, (ulonglong2*)scratch, nullptr,
      nullptr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The scan K14 uses: per-block counts -> exclusive offsets (one block)
// ---------------------------------------------------------------------------

// In place: per-block counts -> exclusive offsets; *total = their sum.
__global__ void scan_kernel(long long* __restrict__ block, long long nb,
                            long long* __restrict__ total) {
  __shared__ long long part[SCAN_THREADS];
  const int t = threadIdx.x;
  const long long per = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long lo = min(nb, t * per), hi = min(nb, lo + per);
  long long s = 0;
  for (long long i = lo; i < hi; ++i) s += block[i];
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const long long v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - s;
  for (long long i = lo; i < hi; ++i) {
    const long long c = block[i];
    block[i] = run;
    run += c;
  }
  if (t == SCAN_THREADS - 1) *total = part[t];
}

static long long n_blocks(long long n) {
  return n > 0 ? (n + RUNS_THREADS - 1) / RUNS_THREADS : 1;
}

// ---------------------------------------------------------------------------
// K14 runs_words — reduce-by-key over sorted multiword k-mer rows, with K2's
// modes: a run's value is its length, or the u32-wrapping sum of an int32
// counts payload clamped to 2^31-1; runs with value >= cutoff (>= 1) are
// written in order; the 256-bin histogram of min(value, 255) over them.
//
// Replaces the post-sort half of leon_tpu/ops/count.py count_batch (88-104)
// -> _sort_count_device (45-85): boundaries over the W sorted u32 key
// columns, run lengths by a reverse min-scan, the host compaction of the
// boundary rows; and, at W = 2..16 on the main path, _compact_run (208-223),
// _merge_sorted_runs' segment sums (226-254), _hist_of_sorted (257-264) and
// compact_solid (707-719). The sort stays torch.sort passes over int64
// plane keys.
//
// Input: the sorted keys as P = ceil(W/2) int64 planes (kmer_words.cuh), the
// rows already the valid ones (no sentinel: at k = 16W a canonical
// palindrome can have an all-ones top word and must count). Output: each
// emitted run's W words (unflipped) and its value, as int64 (count_batch's
// run lengths, lt_runs_words_*) or int32 (the counter's runs,
// lt_word_runs_*), W <= 16 for both. The entry pairs are instances of one
// template over the run test and a row accessor: the length-only one
// carries no counts, cutoff or histogram code; rows of one or two planes
// (W <= 4) are read as (hi, lo), rows of three to eight planes through the
// pointer array.
//
// Bound on the H100: device-memory traffic, 8P bytes (+4 with counts) read
// per row and 4W + 4 or 8 written per emitted run, twice (count pass and
// write pass). Design: K2's pattern with a multi-plane key: one thread per
// row, the thread at a run's head walks the run; per-block totals
// (__syncthreads_count), the histogram in shared memory, one scan_kernel
// for offsets, warp-ballot ranks in the write pass.
// ---------------------------------------------------------------------------

// rows of one or two int64 planes: lo = w1 << 32 | w0, hi = w3 << 32 | w2
// (null when W <= 2), each sign-flipped
struct HalfRows {
  const int64_t* hi;
  const int64_t* lo;
  __device__ __forceinline__ bool same(long long a, long long b) const {
    return lo[a] == lo[b] && (!hi || hi[a] == hi[b]);
  }
  __device__ __forceinline__ void words(long long i, int W, uint32_t* out) const {
    const unsigned long long sign = 1ull << 63;
    const unsigned long long l = (unsigned long long)lo[i] ^ sign;
    const unsigned long long h = hi ? (unsigned long long)hi[i] ^ sign : 0ull;
    const uint32_t w[4] = {(uint32_t)l, (uint32_t)(l >> 32), (uint32_t)h, (uint32_t)(h >> 32)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < W) out[j] = w[j];
  }
};

// rows of P = 3..8 int64 planes, plane 0 least significant
struct PlaneRows {
  PlanePtrs pl;
  int P;
  __device__ __forceinline__ bool same(long long a, long long b) const {
    for (int q = 0; q < P; ++q)
      if (pl.p[q][a] != pl.p[q][b]) return false;
    return true;
  }
  __device__ __forceinline__ void words(long long i, int W, uint32_t* out) const {
    const unsigned long long sign = 1ull << 63;
    for (int j = 0; j < W; ++j)
      out[j] = (uint32_t)((((unsigned long long)pl.p[j >> 1][i]) ^ sign) >> (32 * (j & 1)));
  }
};

// Is row i the head of a run (MODES: of an emitted run)? Sets its value.
// Without MODES (count_batch's runs_words) the value is the run's length
// and every head is emitted: the counts, cutoff and histogram branches
// compile out, so that path runs only the length walk.
template <bool MODES, class Rows>
static __device__ __forceinline__ bool word_run_at(const Rows& rows,
                                                   const int32_t* __restrict__ counts,
                                                   long long n, long long i, int32_t cutoff,
                                                   long long* value) {
  if (i > 0 && rows.same(i - 1, i)) return false;
  long long j = i;
  uint32_t s = 0;
  do {
    if (MODES && counts) s += (uint32_t)counts[j];
    ++j;
  } while (j < n && rows.same(i, j));
  if (!MODES) {
    *value = j - i;
    return true;
  }
  *value = counts ? (long long)min(s, 0x7FFFFFFFu) : j - i;
  return *value >= cutoff;
}

template <bool MODES, class Rows>
__global__ void runs_words_count_kernel(const __grid_constant__ Rows rows,
                                        const int32_t* __restrict__ counts,
                                        long long n, int32_t cutoff,
                                        int32_t* __restrict__ hist,
                                        long long* __restrict__ block_cnt) {
  __shared__ int sh[MODES ? 256 : 1];
  if (MODES && hist) {  // uniform across the block: the barrier is safe
    for (int t = threadIdx.x; t < 256; t += blockDim.x) sh[t] = 0;
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long v = 0;
  const bool e = i < n && word_run_at<MODES>(rows, counts, n, i, cutoff, &v);
  if (MODES && e && hist) atomicAdd(&sh[(int)min(v, 255ll)], 1);
  const int cnt = __syncthreads_count(e);
  if (threadIdx.x == 0) block_cnt[blockIdx.x] = cnt;
  if (MODES && hist)
    for (int t = threadIdx.x; t < 256; t += blockDim.x)
      if (sh[t]) atomicAdd(&hist[t], sh[t]);
}

// out_c64 (run lengths) without MODES, out_c32 (clamped values) with.
template <bool MODES, class Rows>
__global__ void runs_words_write_kernel(const __grid_constant__ Rows rows,
                                        const int32_t* __restrict__ counts,
                                        long long n, int W, int32_t cutoff,
                                        const long long* __restrict__ block_off,
                                        uint32_t* __restrict__ out_w,
                                        long long* __restrict__ out_c64,
                                        int32_t* __restrict__ out_c32) {
  __shared__ int warp_tot[RUNS_THREADS / 32];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long v = 0;
  const bool e = i < n && word_run_at<MODES>(rows, counts, n, i, cutoff, &v);
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, e);
  if (lane == 0) warp_tot[warp] = __popc(m);
  __syncthreads();
  if (!e) return;
  long long dst = block_off[blockIdx.x] + __popc(m & ((1u << lane) - 1u));
  for (unsigned w = 0; w < warp; ++w) dst += warp_tot[w];
  rows.words(i, W, out_w + dst * W);
  if (MODES) out_c32[dst] = (int32_t)min(v, 0x7FFFFFFFll);
  else out_c64[dst] = v;
}

template <bool MODES, class Rows>
static int words_count(const Rows& rows, const void* counts, long long n, int cutoff, void* hist,
                       void* block_off, void* total, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nb = n_blocks(n);
  if (hist) LT_TRY(cudaMemsetAsync(hist, 0, 256 * sizeof(int32_t), st));
  if (n > 0) {
    runs_words_count_kernel<MODES><<<(unsigned)nb, RUNS_THREADS, 0, st>>>(
        rows, (const int32_t*)counts, n, cutoff, (int32_t*)hist, (long long*)block_off);
  } else {
    LT_TRY(cudaMemsetAsync(block_off, 0, sizeof(long long), st));
  }
  LT_TRY(cudaGetLastError());
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>((long long*)block_off, nb, (long long*)total);
  return (int)cudaGetLastError();
}

template <bool MODES, class Rows>
static int words_write(const Rows& rows, const void* counts, long long n, int W, int cutoff,
                       const void* block_off, void* out_words, void* out_counts, void* stream) {
  if (n <= 0) return (int)cudaSuccess;  // an empty tensor's data_ptr() may be null
  if (!out_counts) return (int)cudaErrorInvalidValue;
  runs_words_write_kernel<MODES><<<(unsigned)n_blocks(n), RUNS_THREADS, 0,
                                   (cudaStream_t)stream>>>(
      rows, (const int32_t*)counts, n, W, cutoff, (const long long*)block_off,
      (uint32_t*)out_words, (long long*)out_counts, (int32_t*)out_counts);
  return (int)cudaGetLastError();
}

// f(rows) over the row accessor of n_planes planes: (hi, lo) for one or two
// (hi null for one), the pointer array for three to eight
template <class F>
static int with_rows(const PlanePtrs& pl, int n_planes, F f) {
  if (n_planes <= 2) return f(HalfRows{n_planes == 2 ? pl.p[1] : nullptr, pl.p[0]});
  return f(PlaneRows{pl, n_planes});
}

// The entry points take planes, the host array of n_planes = ceil(W/2)
// plane pointers. count_batch's K14 (run lengths, every run; W <= 16).
// Pass 1 + scan: block_off: n_blocks(n) int64 scratch; total: 1 int64.
extern "C" int lt_runs_words_count(const void* planes, int n_planes, long long n,
                                   void* block_off, void* total, void* stream) {
  PlanePtrs pl = {};
  if (n > 0 && !load_planes(planes, n_planes, &pl)) return (int)cudaErrorInvalidValue;
  return with_rows(pl, n_planes, [&](const auto& rows) {
    return words_count<false>(rows, nullptr, n, 1, nullptr, block_off, total, stream);
  });
}

// Pass 2: each run's W words and int64 length at its offset.
extern "C" int lt_runs_words_write(const void* planes, int n_planes, long long n, int W,
                                   const void* block_off, void* out_words, void* out_counts,
                                   void* stream) {
  if (W < 1 || W > 16 || n_planes != (W + 1) / 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  PlanePtrs pl;
  if (!load_planes(planes, n_planes, &pl)) return (int)cudaErrorInvalidValue;
  return with_rows(pl, n_planes, [&](const auto& rows) {
    return words_write<false>(rows, nullptr, n, W, 1, block_off, out_words, out_counts, stream);
  });
}

// K14 in K2's modes (the WordCounter's, W <= 16). Pass 1 + scan: counts
// null (run lengths) or int32; hist: 256 int32 or null.
extern "C" int lt_word_runs_count(const void* planes, int n_planes, const void* counts,
                                  long long n, int cutoff, void* hist, void* block_off,
                                  void* total, void* stream) {
  cutoff = cutoff < 1 ? 1 : cutoff;
  PlanePtrs pl = {};
  if (n > 0 && !load_planes(planes, n_planes, &pl)) return (int)cudaErrorInvalidValue;
  return with_rows(pl, n_planes, [&](const auto& rows) {
    return words_count<true>(rows, counts, n, cutoff, hist, block_off, total, stream);
  });
}

// Pass 2: each emitted run's W words and int32 value (clamped) at its offset.
extern "C" int lt_word_runs_write(const void* planes, int n_planes, const void* counts,
                                  long long n, int W, int cutoff, const void* block_off,
                                  void* out_words, void* out_counts, void* stream) {
  if (W < 1 || W > 16 || n_planes != (W + 1) / 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cutoff = cutoff < 1 ? 1 : cutoff;
  PlanePtrs pl;
  if (!load_planes(planes, n_planes, &pl)) return (int)cudaErrorInvalidValue;
  return with_rows(pl, n_planes, [&](const auto& rows) {
    return words_write<true>(rows, counts, n, W, cutoff, block_off, out_words, out_counts,
                             stream);
  });
}
