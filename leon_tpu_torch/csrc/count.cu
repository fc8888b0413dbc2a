// K2 runs — reduce-by-key over a sorted int64 key array.
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
