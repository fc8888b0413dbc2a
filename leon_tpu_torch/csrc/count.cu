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
// Bound on the H100: device-memory traffic, ~12 bytes read per input row
// (key, count) and 12 written per emitted run, twice (the count pass and the
// write pass both re-derive each run). Design: one thread per row; the
// thread at a run's first row walks the run (total work O(n)); per-block
// totals come from __syncthreads_count, a single-block scan turns them
// into offsets, and the write pass ranks rows inside a block with warp
// ballots. The histogram accumulates in shared memory, then globally.
#include "common.cuh"
#include "kmer_words.cuh"

#define RUNS_THREADS 256
#define SCAN_THREADS 1024

#define LT_TRY(x)                              \
  do {                                         \
    cudaError_t e_ = (x);                      \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// Is row i the first row of an emitted run? Sets its value.
static __device__ __forceinline__ bool run_at(const int64_t* __restrict__ keys,
                                              const int32_t* __restrict__ counts,
                                              long long n, long long i, int32_t cutoff,
                                              int32_t* value) {
  const int64_t key = keys[i];
  if (key == LT_SENTINEL) return false;
  if (i > 0 && keys[i - 1] == key) return false;
  uint32_t s = 0;
  long long j = i;
  do {
    s += counts ? (uint32_t)counts[j] : 1u;
    ++j;
  } while (j < n && keys[j] == key);
  const int32_t c = (int32_t)min(s, 0x7FFFFFFFu);
  *value = c;
  return c >= cutoff;
}

__global__ void runs_count_kernel(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ counts, long long n,
                                  int32_t cutoff, int32_t* __restrict__ hist,
                                  long long* __restrict__ block_cnt) {
  __shared__ int sh[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) sh[t] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t c = 0;
  const bool e = i < n && run_at(keys, counts, n, i, cutoff, &c);
  if (e && hist) atomicAdd(&sh[min(c, 255)], 1);
  const int cnt = __syncthreads_count(e);
  if (threadIdx.x == 0) block_cnt[blockIdx.x] = cnt;
  if (hist)
    for (int t = threadIdx.x; t < 256; t += blockDim.x)
      if (sh[t]) atomicAdd(&hist[t], sh[t]);
}

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

__global__ void runs_write_kernel(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ counts, long long n,
                                  int32_t cutoff, const long long* __restrict__ block_off,
                                  int64_t* __restrict__ out_k, int32_t* __restrict__ out_c) {
  __shared__ int warp_tot[RUNS_THREADS / 32];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t c = 0;
  const bool e = i < n && run_at(keys, counts, n, i, cutoff, &c);
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, e);
  if (lane == 0) warp_tot[warp] = __popc(m);
  __syncthreads();
  if (!e) return;
  long long dst = block_off[blockIdx.x] + __popc(m & ((1u << lane) - 1u));
  for (unsigned w = 0; w < warp; ++w) dst += warp_tot[w];
  out_k[dst] = keys[i];
  out_c[dst] = c;
}

static long long n_blocks(long long n) {
  return n > 0 ? (n + RUNS_THREADS - 1) / RUNS_THREADS : 1;
}

// Pass 1 + scan. block_off: n_blocks(n) int64 scratch; total: 1 int64;
// hist: 256 int32 or null.
extern "C" int lt_runs_count(const void* keys, const void* counts, long long n, int cutoff,
                             void* hist, void* block_off, void* total, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nb = n_blocks(n);
  cutoff = cutoff < 1 ? 1 : cutoff;
  if (hist) LT_TRY(cudaMemsetAsync(hist, 0, 256 * sizeof(int32_t), st));
  if (n > 0) {
    runs_count_kernel<<<(unsigned)nb, RUNS_THREADS, 0, st>>>(
        (const int64_t*)keys, (const int32_t*)counts, n, cutoff, (int32_t*)hist,
        (long long*)block_off);
  } else {
    LT_TRY(cudaMemsetAsync(block_off, 0, sizeof(long long), st));
  }
  LT_TRY(cudaGetLastError());
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>((long long*)block_off, nb, (long long*)total);
  return (int)cudaGetLastError();
}

// Pass 2: write the emitted runs at their offsets.
extern "C" int lt_runs_write(const void* keys, const void* counts, long long n, int cutoff,
                             const void* block_off, void* out_keys, void* out_counts,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cutoff = cutoff < 1 ? 1 : cutoff;
  runs_write_kernel<<<(unsigned)n_blocks(n), RUNS_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int32_t*)counts, n, cutoff,
      (const long long*)block_off, (int64_t*)out_keys, (int32_t*)out_counts);
  return (int)cudaGetLastError();
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
