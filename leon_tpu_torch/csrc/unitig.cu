// K5-K8 — the device unitig build over the sorted solid k-mer run, and the
// DICT lookup into it.
//
// Replaces leon_tpu/ops/unitig.py _build_dev -> _build_dev_impl (421-645,
// with _bucket_starts 367 and _searchsorted_words_dev 377) and
// solid_indices_dev (938-963); _compact_dev is K2's solid mode. Node ids,
// tie-breaks and emission order are the reference's, so the packed output
// is bit-identical:
//
//   K5 links   lt_unitig_buckets, lt_unitig_succ, lt_unitig_link
//   K6 double  lt_unitig_init, lt_unitig_double (one round), lt_unitig_break
//   K7 emit    lt_unitig_emit_mins, _heads, _lens, _bases
//   K8 lookup  lt_solid_lookup
//
// Input is the solid run: sorted, distinct int64 k-mers (k <= 31), every
// row solid (the wrapper compacts a counted run with K2 first; ids stay
// order-isomorphic, so the payload is the uncompacted build's). Directed
// node d = 2*i + o is row i's key (o = 0) or its reverse complement
// (o = 1), never materialised. Node ids are int32 (2M < 2^31).
//
// Bound on the H100: dependent random loads. K5 runs 8 bucketed binary
// searches per row (a 2^16-entry prefix table narrows each to ~log2(M/2^16)
// probes of the sorted keys); a K6 round is one 16-byte gather per node
// (pointer and both carries ride in one int4, as the reference rides them
// as columns of one matrix for a single row-gather); K7 is scatters
// (atomicMin, atomicOr) into zeroed buffers. One thread per row or node;
// OR and MIN are order-free, so results do not depend on scheduling.
#include "common.cuh"

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
// ---------------------------------------------------------------------------

// hit = q is in the solid run; rank = its row (its index among the solid
// rows), 0 on a miss
__global__ void lookup_kernel(const int64_t* __restrict__ keys, int M, int k,
                              const int32_t* __restrict__ starts, const int64_t* __restrict__ q,
                              int Q, uint8_t* __restrict__ hit, int64_t* __restrict__ rank) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int j = find_key(keys, M, starts, q[i], k);
  hit[i] = j >= 0;
  rank[i] = j >= 0 ? j : 0;
}

extern "C" int lt_solid_lookup(const void* keys, int M, int k, const void* starts, const void* q,
                               int Q, void* hit, void* rank, void* stream) {
  if (k < 1 || k > 31 || M <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  lookup_kernel<<<ut_blocks(Q), UT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, M, k, (const int32_t*)starts, (const int64_t*)q, Q, (uint8_t*)hit,
      (int64_t*)rank);
  return (int)cudaGetLastError();
}
