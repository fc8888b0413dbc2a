// K5-K8 — the device unitig build over the sorted solid k-mer run, and the
// DICT lookup into it.
//
// Replaces leon_tpu/ops/unitig.py _build_dev -> _build_dev_impl (421-645,
// with _topbits 351, _bucket_starts 367 and _searchsorted_words_dev 377)
// and solid_indices_dev (938-963); _compact_dev is K2's solid mode (K14's
// at k > 31). Node ids, tie-breaks and emission order are the reference's,
// so the packed output is bit-identical:
//
//   K5 links   lt_unitig_buckets, lt_unitig_links (+ _words)
//   K6 double  lt_unitig_init, lt_unitig_double (one round), lt_unitig_break
//   K7 emit    lt_unitig_emit_mins, _heads, _lens, _bases (+ _bases_words)
//   K8 lookup  lt_solid_lookup (+ _words)
//
// Input is the solid run: sorted, distinct k-mers, every row solid (the
// wrapper compacts a counted run first; ids stay order-isomorphic, so the
// payload is the uncompacted build's). For k <= 31 a row is one int64 key;
// for 32 <= k <= 255 it is W = ceil(k/16) u32 words (held as int32, LSW
// first, sorted MSW-first as unsigned: the multiword route's rows), and
// K5, K7's bases and K8 have _words instances for W = 2..16 (K6 and the
// other K7 kernels see node ids only). Directed node d = 2*i + o is row
// i's k-mer (o = 0) or its reverse complement (o = 1), never
// materialised. Node ids are int32 (2M < 2^31).
//
// Bound on the H100: dependent random loads. K5 runs 8 bucketed binary
// searches per row (a 2^16-entry prefix table narrows each to ~log2(M/2^16)
// probes of the sorted rows); a K6 round is one 16-byte gather per node
// (pointer and both carries ride in one int4, as the reference rides them
// as columns of one matrix for a single row-gather); K7 is scatters
// (atomicMin, atomicOr) into zeroed buffers. One thread per row or node;
// OR and MIN are order-free, so results do not depend on scheduling. A
// W-word row lives in registers (Kmer<W>): K5 holds the row, its reverse
// complement, a neighbour and the probed row, 4W words.
#include "common.cuh"
#include "kmer_words.cuh"

#define UT_THREADS 256
#define UT_TBITS 16

#define LT_TRY(x)                              \
  do {                                         \
    cudaError_t e_ = (x);                      \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

static unsigned ut_blocks(long long n) {
  return (unsigned)((n + UT_THREADS - 1) / UT_THREADS);
}

// reverse complement of a 2k-bit key: complement, reverse the 2-bit
// groups of the 64-bit word, drop the 64 - 2k pad bits
static __device__ __forceinline__ uint64_t revcomp(uint64_t x, int k) {
  x = ~x;
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

// spelled form of directed node d
static __device__ __forceinline__ uint64_t node_key(const int64_t* __restrict__ keys,
                                                    int d, int k) {
  const uint64_t x = (uint64_t)keys[d >> 1];
  return (d & 1) ? revcomp(x, k) : x;
}

// the top min(16, 2k) bits of a key: its prefix-table bucket
static __device__ __forceinline__ int top_bits(int64_t key, int k) {
  const int T = min(UT_TBITS, 2 * k);
  return (int)(((uint64_t)key >> (2 * k - T)) & ((1u << T) - 1u));
}

// index of q in the sorted keys, or -1; the search stays inside q's bucket
// (an exact match lies there), so it equals a search over all M rows
static __device__ __forceinline__ int find_key(const int64_t* __restrict__ keys, int M,
                                               const int32_t* __restrict__ starts,
                                               int64_t q, int k) {
  const int p = top_bits(q, k);
  int lo = starts[p], hi = starts[p + 1];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) lo = mid + 1;
    else hi = mid;
  }
  return (lo < M && __ldg(keys + lo) == q) ? lo : -1;
}

// ---------------------------------------------------------------------------
// K5 links (unitig.py:367-418, 469-508)
// ---------------------------------------------------------------------------

// starts[b] = first row whose bucket is >= b, for b in [0, 2^T]; thread i
// writes the buckets between row i-1's and row i's (row M: the end), so
// every entry is written once and no histogram or scan is needed
__global__ void buckets_kernel(const int64_t* __restrict__ keys, int M, int k,
                               int32_t* __restrict__ starts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > M) return;
  const int T = min(UT_TBITS, 2 * k);
  const int cur = i < M ? top_bits(keys[i], k) : (1 << T);
  const int prv = i > 0 ? top_bits(keys[i - 1], k) : -1;
  for (int b = prv + 1; b <= cur; ++b) starts[b] = i;
}

// per directed node: out-degree, and the first successor (base order
// 0..3); a neighbour takes its rc form only when that is strictly smaller,
// so a palindromic neighbour keeps o = 0
__global__ void succ_kernel(const int64_t* __restrict__ keys, int M, int k,
                            const int32_t* __restrict__ starts, int32_t* __restrict__ succ,
                            int32_t* __restrict__ outc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const uint64_t mask = (1ull << (2 * k)) - 1ull;
  const uint64_t x0 = (uint64_t)keys[i];
  const uint64_t r0 = revcomp(x0, k);
  for (int o = 0; o < 2; ++o) {
    const uint64_t x = o ? r0 : x0, xr = o ? x0 : r0;
    int oc = 0, s = -1;
    for (int b = 0; b < 4; ++b) {
      const uint64_t y = ((x << 2) | (uint64_t)b) & mask;
      const uint64_t yr = (xr >> 2) | ((uint64_t)(3 - b) << (2 * (k - 1)));
      const bool take_rc = yr < y;
      const int j = find_key(keys, M, starts, (int64_t)(take_rc ? yr : y), k);
      if (j >= 0 && ++oc == 1) s = 2 * j + (int)take_rc;
    }
    succ[2 * i + o] = s;
    outc[2 * i + o] = oc;
  }
}

// nxt = succ where the edge is internal (in(s) = out(twin of s)); prev by
// scatter, where a max keeps the reference's last-writer-wins order on the
// (palindromic) case of two nodes sharing one successor
__global__ void link_kernel(int N, const int32_t* __restrict__ succ,
                            const int32_t* __restrict__ outc, int32_t* __restrict__ nxt,
                            int32_t* __restrict__ prev) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= N) return;
  const int s = succ[d];
  const bool internal = outc[d] == 1 && s >= 0 && outc[s ^ 1] == 1;
  nxt[d] = internal ? s : -1;
  if (internal) atomicMax(prev + s, d);
}

// starts: (2^T + 1) int32
extern "C" int lt_unitig_buckets(const void* keys, int M, int k, void* starts, void* stream) {
  if (k < 1 || k > 31 || M < 0) return (int)cudaErrorInvalidValue;
  buckets_kernel<<<ut_blocks((long long)M + 1), UT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, M, k, (int32_t*)starts);
  return (int)cudaGetLastError();
}

// succ, outc: (2M,) int32 scratch; nxt, prev: (2M,) int32 outputs
extern "C" int lt_unitig_links(const void* keys, int M, int k, const void* starts, void* succ,
                               void* outc, void* nxt, void* prev, void* stream) {
  if (k < 1 || k > 31 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = 2 * M;
  LT_TRY(cudaMemsetAsync(prev, 0xFF, (size_t)N * sizeof(int32_t), st));  // -1
  succ_kernel<<<ut_blocks(M), UT_THREADS, 0, st>>>(
      (const int64_t*)keys, M, k, (const int32_t*)starts, (int32_t*)succ, (int32_t*)outc);
  LT_TRY(cudaGetLastError());
  link_kernel<<<ut_blocks(N), UT_THREADS, 0, st>>>(
      N, (const int32_t*)succ, (const int32_t*)outc, (int32_t*)nxt, (int32_t*)prev);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6 pointer doubling (unitig.py:512-584)
// ---------------------------------------------------------------------------
//
// State S[d] = {P, c0, c1, 0}. Modes (fold of the carries with their
// values at P):
//   0 acyclic   P = prev or self; c0 rank (sum), c1 reached-a-head (or)
//   1 full      P = nxt or self;  c0 reached-a-tail (or), c1 min id (min)
//   2 rank      P = prev or self; c0 rank (sum), c1 unused

__global__ void init_kernel(int mode, int N, const int32_t* __restrict__ nxt,
                            const int32_t* __restrict__ prev, int4* __restrict__ S) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= N) return;
  int4 s;
  if (mode == 1) {
    const int n = nxt[d];
    s = make_int4(n >= 0 ? n : d, n < 0, d, 0);
  } else {
    const int p = prev[d];
    s = make_int4(p >= 0 ? p : d, p >= 0, mode == 0 ? (p < 0) : 0, 0);
  }
  S[d] = s;
}

// one round, S -> S2 (never in place: a round must not see its own
// writes); *changed is set when any pointer moved
__global__ void double_kernel(int mode, int N, const int4* __restrict__ S,
                              int4* __restrict__ S2, int32_t* __restrict__ changed) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  bool moved = false;
  if (d < N) {
    const int4 s = S[d];
    const int4 g = S[s.x];
    int4 o;
    o.x = g.x;
    o.w = 0;
    if (mode == 0) {
      o.y = s.y + g.y;
      o.z = s.z | g.z;
    } else if (mode == 1) {
      o.y = s.y | g.y;
      o.z = min(s.z, g.z);
    } else {
      o.y = s.y + g.y;
      o.z = s.z;
    }
    S2[d] = o;
    moved = g.x != s.x;
  }
  if (__any_sync(0xffffffffu, moved) && (threadIdx.x & 31) == 0) *changed = 1;
}

// cycle break after the full first pass: a node on no path to a tail that
// is its orbit's min id loses its incoming edge (in place; each thread
// reads only its own prev)
__global__ void break_kernel(int N, const int4* __restrict__ S, int32_t* __restrict__ nxt,
                             int32_t* __restrict__ prev) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= N) return;
  const int4 s = S[d];
  if (s.y == 0 && s.z == d) {
    const int p = prev[d];
    if (p >= 0) nxt[p] = -1;
    prev[d] = -1;
  }
}

extern "C" int lt_unitig_init(int mode, int N, const void* nxt, const void* prev, void* S,
                              void* stream) {
  if (mode < 0 || mode > 2 || N <= 0) return (int)cudaErrorInvalidValue;
  init_kernel<<<ut_blocks(N), UT_THREADS, 0, (cudaStream_t)stream>>>(
      mode, N, (const int32_t*)nxt, (const int32_t*)prev, (int4*)S);
  return (int)cudaGetLastError();
}

// changed: 1 int32, zeroed here
extern "C" int lt_unitig_double(int mode, int N, const void* S, void* S2, void* changed,
                                void* stream) {
  if (mode < 0 || mode > 2 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  LT_TRY(cudaMemsetAsync(changed, 0, sizeof(int32_t), st));
  double_kernel<<<ut_blocks(N), UT_THREADS, 0, st>>>(mode, N, (const int4*)S, (int4*)S2,
                                                      (int32_t*)changed);
  return (int)cudaGetLastError();
}

extern "C" int lt_unitig_break(int N, const void* S, void* nxt, void* prev, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  break_kernel<<<ut_blocks(N), UT_THREADS, 0, (cudaStream_t)stream>>>(
      N, (const int4*)S, (int32_t*)nxt, (int32_t*)prev);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7 emission (unitig.py:586-645)
// ---------------------------------------------------------------------------
//
// buf (u32): [n_chains, overflow, has_cycles, 0 | len_nodes (cap) |
// 2-bit bases (cap_bases/16 words, code t at bits 2t)], zeroed by the
// caller. Between the launches the wrapper takes two prefix sums: cid
// (inclusive, of the keep-head flags) and start (exclusive, of the chains'
// base counts).

// per-chain min id and min twin id, kept at the head: scatter-min over
// head; in the acyclic mode a node that reached no head flags a cycle
__global__ void emit_mins_kernel(int N, const int4* __restrict__ S, int acyclic,
                                 int32_t* __restrict__ cm, int32_t* __restrict__ tmn,
                                 uint32_t* __restrict__ buf) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= N) return;
  const int4 s = S[d];
  atomicMin(cm + s.x, d);
  atomicMin(tmn + s.x, d ^ 1);
  if (acyclic && s.z == 0) buf[2] = 1u;
}

__global__ void emit_heads_kernel(int N, const int32_t* __restrict__ prev,
                                  const int32_t* __restrict__ cm, const int32_t* __restrict__ tmn,
                                  int32_t* __restrict__ kh) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= N) return;
  kh[d] = prev[d] < 0 && cm[d] <= tmn[d];
}

// len_nodes at each kept chain's tail; the header
__global__ void emit_lens_kernel(int N, const int32_t* __restrict__ nxt,
                                 const int4* __restrict__ S,
                                 const int32_t* __restrict__ kh, const int32_t* __restrict__ cid,
                                 int cap, uint32_t* __restrict__ buf) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d == 0) {
    const uint32_t total = (uint32_t)cid[N - 1];
    buf[0] = total;
    buf[1] = total > (uint32_t)cap;
  }
  if (d >= N || nxt[d] >= 0) return;
  const int4 s = S[d];
  if (!kh[s.x]) return;
  const int c = cid[s.x] - 1;
  if (c < cap) buf[4 + c] = (uint32_t)(s.y + 1);
}

static __device__ __forceinline__ void put_base(uint32_t* __restrict__ packed, long long pos,
                                                long long cap_bases, uint32_t code) {
  if (code && pos >= 0 && pos < cap_bases)
    atomicOr(packed + (pos >> 4), code << (2 * (pos & 15)));
}

// each kept node's last base at start + (k-1) + rank; each kept head's
// k-1 prefix bases, most significant first
__global__ void emit_bases_kernel(const int64_t* __restrict__ keys, int N, int k,
                                  const int4* __restrict__ S, const int32_t* __restrict__ kh,
                                  const int32_t* __restrict__ cid,
                                  const long long* __restrict__ start, int cap,
                                  long long cap_bases, uint32_t* __restrict__ packed) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= N) return;
  const int4 s = S[d];
  if (!kh[s.x]) return;
  const int c = cid[s.x] - 1;
  if (c >= cap) return;
  const uint64_t f = node_key(keys, d, k);
  const long long st = start[c];
  put_base(packed, st + (k - 1) + s.y, cap_bases, (uint32_t)(f & 3u));
  if (s.x == d)
    for (int j = 0; j < k - 1; ++j)
      put_base(packed, st + j, cap_bases, (uint32_t)((f >> (2 * (k - 1) - 2 * j)) & 3u));
}

// cm, tmn: (N,) int32 filled with N by the caller
extern "C" int lt_unitig_emit_mins(int N, const void* S, int acyclic, void* cm, void* tmn,
                                   void* buf, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  emit_mins_kernel<<<ut_blocks(N), UT_THREADS, 0, (cudaStream_t)stream>>>(
      N, (const int4*)S, acyclic, (int32_t*)cm, (int32_t*)tmn, (uint32_t*)buf);
  return (int)cudaGetLastError();
}

extern "C" int lt_unitig_emit_heads(int N, const void* prev, const void* cm, const void* tmn,
                                    void* kh, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  emit_heads_kernel<<<ut_blocks(N), UT_THREADS, 0, (cudaStream_t)stream>>>(
      N, (const int32_t*)prev, (const int32_t*)cm, (const int32_t*)tmn, (int32_t*)kh);
  return (int)cudaGetLastError();
}

extern "C" int lt_unitig_emit_lens(int N, const void* nxt, const void* S, const void* kh,
                                   const void* cid, int cap, void* buf, void* stream) {
  if (N <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  emit_lens_kernel<<<ut_blocks(N), UT_THREADS, 0, (cudaStream_t)stream>>>(
      N, (const int32_t*)nxt, (const int4*)S, (const int32_t*)kh, (const int32_t*)cid, cap,
      (uint32_t*)buf);
  return (int)cudaGetLastError();
}

extern "C" int lt_unitig_emit_bases(const void* keys, int N, int k, const void* S,
                                    const void* kh, const void* cid, const void* start, int cap,
                                    long long cap_bases, void* buf, void* stream) {
  if (N <= 0 || cap <= 0 || k < 1 || k > 31) return (int)cudaErrorInvalidValue;
  emit_bases_kernel<<<ut_blocks(N), UT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, N, k, (const int4*)S,
      (const int32_t*)kh, (const int32_t*)cid, (const long long*)start, cap, cap_bases,
      (uint32_t*)buf + 4 + cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8 DICT lookup (unitig.py:938-963)
//
// hit = q is in the solid run; rank = its row (its index among the solid
// rows), 0 on a miss. Bound: one row per query (the search's last probe)
// plus the queries and outputs; the call reads no table over the run.
// Each block stages a splitter sample of the run in shared memory (rows
// 0, step, 2 step, ...: S rows, chosen by the wrapper, ops/unitig.py
// _lookup_split); a query's search takes its first log2(S) levels there,
// then finishes with a binary search in device memory over one step-row
// segment. One query a thread, 256 threads a block. The sample is small
// (S = 64): the next levels, which all queries of a segment share, stay
// in L1 and L2, and in a call on the H100 a sample of 2048 or 6144 rows
// cost more to stage in every block than its levels saved (PERF.md §6,
// PR 9); the time is that of the last, unshared probes.
// ---------------------------------------------------------------------------

#define K8_THREADS 256
#define K8_SMEM 49152

// the split is the wrapper's: S samples every step rows cover the run
static bool k8_split_ok(int M, int step, int S, int row_bytes) {
  return M > 0 && step >= 1 && S >= 1 && (long long)S * row_bytes <= K8_SMEM &&
         (long long)(S - 1) * step < M && (long long)S * step >= M;
}

static unsigned k8_blocks(int Q) { return (unsigned)((Q + K8_THREADS - 1) / K8_THREADS); }

__global__ void __launch_bounds__(K8_THREADS)
lookup_kernel(const int64_t* __restrict__ keys, int M, int step, int S,
              const int64_t* __restrict__ q, int Q, uint8_t* __restrict__ hit,
              int64_t* __restrict__ rank) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  int64_t* smp = reinterpret_cast<int64_t*>(k8_smem);
  for (int s = threadIdx.x; s < S; s += K8_THREADS) smp[s] = __ldg(keys + (long long)s * step);
  __syncthreads();
  const int i = blockIdx.x * K8_THREADS + threadIdx.x;
  if (i < Q) {
    const int64_t x = q[i];
    int lo = 0, hi = S;  // lo <- the samples <= x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (smp[mid] <= x) lo = mid + 1;
      else hi = mid;
    }
    int j = -1;
    if (lo > 0) {
      int a = (lo - 1) * step;  // rows[a] <= x < rows[a + step] (or the end)
      if (smp[lo - 1] == x) {
        j = a;
      } else {
        int b = min(a + step, M);
        ++a;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (__ldg(keys + mid) < x) a = mid + 1;
          else b = mid;
        }
        if (a < M && __ldg(keys + a) == x) j = a;
      }
    }
    hit[i] = j >= 0;
    rank[i] = j >= 0 ? j : 0;
  }
}

extern "C" int lt_solid_lookup(const void* keys, int M, int k, int step, int S, const void* q,
                               int Q, void* hit, void* rank, void* stream) {
  if (k < 1 || k > 31 || Q <= 0 || !k8_split_ok(M, step, S, 8)) return (int)cudaErrorInvalidValue;
  lookup_kernel<<<k8_blocks(Q), K8_THREADS, (size_t)S * 8, (cudaStream_t)stream>>>(
      (const int64_t*)keys, M, step, S, (const int64_t*)q, Q, (uint8_t*)hit, (int64_t*)rank);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5, K7's bases and K8 over W-word rows, 32 <= k <= 255 (unitig.py:351-377,
// 440-465, 469-508, 612-636, 938-963)
// ---------------------------------------------------------------------------

// the 2-bit groups of a word in reverse order (unitig.py rev2_u32, 443-447)
static __device__ __forceinline__ uint32_t rev2_u32(uint32_t x) {
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
}

// reverse complement of a W-word k-mer (unitig.py:440-459): complement,
// reverse each word's groups and the word order, then shift right by the
// 32W - 2k pad bits (even, 0..30; no shift at k = 16W)
template <int W>
static __device__ __forceinline__ Kmer<W> revcomp_w(const Kmer<W>& a, int k) {
  Kmer<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = rev2_u32(~a.w[W - 1 - j]);
  const int pad = 32 * W - 2 * k;
  if (pad) {
#pragma unroll
    for (int j = 0; j < W; ++j)
      r.w[j] = (r.w[j] >> pad) | (j + 1 < W ? r.w[j + 1 < W ? j + 1 : j] << (32 - pad) : 0u);
  }
  return r;
}

// spelled form of directed node d
template <int W>
static __device__ __forceinline__ Kmer<W> node_kmer(const uint32_t* __restrict__ rows, int d,
                                                    int k) {
  const Kmer<W> x = load_kmer<W>(rows, d >> 1);
  return (d & 1) ? revcomp_w<W>(x, k) : x;
}

// the top min(16, 2k) bits of a 2k-bit k-mer, which straddle two words
// when the shift's offset passes 16 (unitig.py _topbits, 351-364)
template <int W>
static __device__ __forceinline__ int top_bits_w(const Kmer<W>& a, int k) {
  const int T = min(UT_TBITS, 2 * k);
  const int shift = 2 * k - T, wi = shift >> 5, off = shift & 31;
  uint32_t tb = word_at(a, wi) >> off;
  if (off && wi + 1 < W) tb |= word_at(a, wi + 1) << (32 - off);
  return (int)(tb & ((1u << T) - 1u));
}

// row index of q in the sorted rows, or -1; the search stays inside q's
// bucket and compares rows as unsigned big integers, most significant word
// first (unitig.py _searchsorted_words_dev, 377-418)
template <int W>
static __device__ __forceinline__ int find_row(const uint32_t* __restrict__ rows, int M,
                                               const int32_t* __restrict__ starts,
                                               const Kmer<W>& q, int k) {
  const int p = top_bits_w<W>(q, k);
  int lo = starts[p], hi = starts[p + 1];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_less(load_kmer<W>(rows, mid), q)) lo = mid + 1;
    else hi = mid;
  }
  return (lo < M && same_kmer(load_kmer<W>(rows, lo), q)) ? lo : -1;
}

template <int W>
__global__ void buckets_words_kernel(const uint32_t* __restrict__ rows, int M, int k,
                                     int32_t* __restrict__ starts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > M) return;
  const int T = min(UT_TBITS, 2 * k);
  const int cur = i < M ? top_bits_w<W>(load_kmer<W>(rows, i), k) : (1 << T);
  const int prv = i > 0 ? top_bits_w<W>(load_kmer<W>(rows, i - 1), k) : -1;
  for (int b = prv + 1; b <= cur; ++b) starts[b] = i;
}

// succ_kernel over W-word rows: the neighbour y = x << 2 | b (top word
// masked), its twin yr = xr >> 2 | (3 - b) << 2(k-1); the rc form only
// when strictly smaller
template <int W>
__global__ void succ_words_kernel(const uint32_t* __restrict__ rows, int M, int k, uint32_t top,
                                  const int32_t* __restrict__ starts, int32_t* __restrict__ succ,
                                  int32_t* __restrict__ outc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const Kmer<W> x0 = load_kmer<W>(rows, i);
  const Kmer<W> r0 = revcomp_w<W>(x0, k);
  for (int o = 0; o < 2; ++o) {
    Kmer<W> x, xr;  // word by word: a select of whole structs goes to the stack
#pragma unroll
    for (int j = 0; j < W; ++j) {
      x.w[j] = o ? r0.w[j] : x0.w[j];
      xr.w[j] = o ? x0.w[j] : r0.w[j];
    }
    int oc = 0, s = -1;
    for (int b = 0; b < 4; ++b) {
      const Kmer<W> y = shl2<W>(x, (uint32_t)b, top);
      const Kmer<W> yr = shr2_ins<W>(xr, (uint32_t)(3 - b), k);
      const bool take_rc = lex_less(yr, y);
      Kmer<W> cy;
#pragma unroll
      for (int t = 0; t < W; ++t) cy.w[t] = take_rc ? yr.w[t] : y.w[t];
      const int j = find_row<W>(rows, M, starts, cy, k);
      if (j >= 0 && ++oc == 1) s = 2 * j + (int)take_rc;
    }
    succ[2 * i + o] = s;
    outc[2 * i + o] = oc;
  }
}

// emit_bases_kernel over W-word rows
template <int W>
__global__ void emit_bases_words_kernel(const uint32_t* __restrict__ rows, int N, int k,
                                        const int4* __restrict__ S,
                                        const int32_t* __restrict__ kh,
                                        const int32_t* __restrict__ cid,
                                        const long long* __restrict__ start, int cap,
                                        long long cap_bases, uint32_t* __restrict__ packed) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= N) return;
  const int4 s = S[d];
  if (!kh[s.x]) return;
  const int c = cid[s.x] - 1;
  if (c >= cap) return;
  const Kmer<W> f = node_kmer<W>(rows, d, k);
  const long long st = start[c];
  put_base(packed, st + (k - 1) + s.y, cap_bases, f.w[0] & 3u);
  if (s.x == d)
    for (int j = 0; j < k - 1; ++j) put_base(packed, st + j, cap_bases, (uint32_t)base_of(f, j, k));
}

// sign of (row r - x), words compared most significant first and read
// only until two differ (the top word decides almost every probe)
template <int W>
static __device__ __forceinline__ int cmp_row(const uint32_t* r, const Kmer<W>& x) {
#pragma unroll
  for (int j = W - 1; j >= 0; --j) {
    const uint32_t a = r[j];
    if (a != x.w[j]) return a < x.w[j] ? -1 : 1;
  }
  return 0;
}

// K8 over W-word rows: the sample holds whole rows (S * 4W bytes), and
// rows compare as unsigned big integers, most significant word first
template <int W>
__global__ void __launch_bounds__(K8_THREADS)
lookup_words_kernel(const uint32_t* __restrict__ rows, int M, int step, int S,
                    const uint32_t* __restrict__ q, int Q, uint8_t* __restrict__ hit,
                    int64_t* __restrict__ rank) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  uint32_t* smp = reinterpret_cast<uint32_t*>(k8_smem);
  for (int t = threadIdx.x; t < S * W; t += K8_THREADS)
    smp[t] = __ldg(rows + (long long)(t / W) * step * W + t % W);
  __syncthreads();
  const int i = blockIdx.x * K8_THREADS + threadIdx.x;
  if (i < Q) {
    const Kmer<W> x = load_kmer<W>(q, i);
    int lo = 0, hi = S;  // lo <- the samples <= x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cmp_row<W>(smp + mid * W, x) <= 0) lo = mid + 1;
      else hi = mid;
    }
    int j = -1;
    if (lo > 0) {
      int a = (lo - 1) * step;
      if (cmp_row<W>(smp + (lo - 1) * W, x) == 0) {
        j = a;
      } else {
        int b = min(a + step, M);
        ++a;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (cmp_row<W>(rows + (long long)mid * W, x) < 0) a = mid + 1;
          else b = mid;
        }
        if (a < M && cmp_row<W>(rows + (long long)a * W, x) == 0) j = a;
      }
    }
    hit[i] = j >= 0;
    rank[i] = j >= 0 ? j : 0;
  }
}

// a W-word entry point takes 32 <= k <= 255 and W = ceil(k/16)
static bool words_k_ok(int W, int k) { return k >= 32 && k <= 255 && W == (k + 15) / 16; }

// the mask of a k-mer's top word (leon_tpu/ops/kmer.py top_mask)
static uint32_t top_mask_of(int k) {
  const int bits = 2 * k - 32 * ((2 * k - 1) / 32);
  return bits < 32 ? (1u << bits) - 1u : 0xFFFFFFFFu;
}

// rows: (M, W) int32 u32 words; starts: (2^16 + 1) int32
extern "C" int lt_unitig_buckets_words(const void* rows, int M, int W, int k, void* starts,
                                       void* stream) {
  if (!words_k_ok(W, k) || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* r = (const uint32_t*)rows;
  int32_t* sp = (int32_t*)starts;
#define LAUNCH(W_) \
  buckets_words_kernel<W_><<<ut_blocks((long long)M + 1), UT_THREADS, 0, st>>>(r, M, k, sp)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// succ, outc: (2M,) int32 scratch; nxt, prev: (2M,) int32 outputs
extern "C" int lt_unitig_links_words(const void* rows, int M, int W, int k, const void* starts,
                                     void* succ, void* outc, void* nxt, void* prev,
                                     void* stream) {
  if (!words_k_ok(W, k) || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = 2 * M;
  LT_TRY(cudaMemsetAsync(prev, 0xFF, (size_t)N * sizeof(int32_t), st));  // -1
  const uint32_t* r = (const uint32_t*)rows;
  const int32_t* sp = (const int32_t*)starts;
  const uint32_t top = top_mask_of(k);
#define LAUNCH(W_)                                                               \
  succ_words_kernel<W_><<<ut_blocks(M), UT_THREADS, 0, st>>>(r, M, k, top, sp, \
                                                               (int32_t*)succ, (int32_t*)outc)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  LT_TRY(cudaGetLastError());
  link_kernel<<<ut_blocks(N), UT_THREADS, 0, st>>>(
      N, (const int32_t*)succ, (const int32_t*)outc, (int32_t*)nxt, (int32_t*)prev);
  return (int)cudaGetLastError();
}

extern "C" int lt_unitig_emit_bases_words(const void* rows, int N, int W, int k, const void* S,
                                          const void* kh, const void* cid, const void* start,
                                          int cap, long long cap_bases, void* buf,
                                          void* stream) {
  if (N <= 0 || cap <= 0 || !words_k_ok(W, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* r = (const uint32_t*)rows;
  const int4* sp = (const int4*)S;
  const int32_t* khp = (const int32_t*)kh;
  const int32_t* cp = (const int32_t*)cid;
  const long long* stp = (const long long*)start;
  uint32_t* packed = (uint32_t*)buf + 4 + cap;
#define LAUNCH(W_)                                                                 \
  emit_bases_words_kernel<W_><<<ut_blocks(N), UT_THREADS, 0, st>>>(r, N, k, sp, khp, cp, \
                                                                    stp, cap, cap_bases, packed)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// q: (Q, W) int32 u32 words
extern "C" int lt_solid_lookup_words(const void* rows, int M, int W, int k, int step, int S,
                                     const void* q, int Q, void* hit, void* rank, void* stream) {
  if (!words_k_ok(W, k) || Q <= 0 || !k8_split_ok(M, step, S, 4 * W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* r = (const uint32_t*)rows;
  const uint32_t* qp = (const uint32_t*)q;
  const unsigned nb = k8_blocks(Q);
  const size_t smem = (size_t)S * 4 * W;
#define LAUNCH(W_)                                                                   \
  lookup_words_kernel<W_><<<nb, K8_THREADS, smem, st>>>(r, M, step, S, qp, Q,      \
                                                        (uint8_t*)hit, (int64_t*)rank)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
