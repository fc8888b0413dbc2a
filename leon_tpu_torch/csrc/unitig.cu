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
//   K6 rank    lt_unitig_rank (the whole chain ranking), lt_unitig_break
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
// probes of the sorted rows); K6 is one list-ranking pass (a few dependent
// loads a node; state int4 {P, c0, c1, 0}, as the reference rides pointer
// and carries as columns of one matrix); K7 is scatters
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
// K6 chain ranking (unitig.py:512-584)
// ---------------------------------------------------------------------------
//
// State S[d] = {P, c0, c1, 0}: the reference's _double folded over each
// node's orbit d, f(d), f(f(d)), ... until no pointer moves (at most
// D = bitlen(N-1) + 1 rounds). Modes (the carries and their folds):
//   0 acyclic   f = prev or self; c0 rank (sum), c1 reached-a-head (or)
//   1 full      f = nxt or self;  c0 reached-a-tail (or), c1 min id (min)
//   2 rank      f = prev or self; c0 rank (sum), c1 unused
//
// The reference doubles every pointer every round: O(N log L) work and a
// 16-byte gather a node a round. Here the ranking is one list-ranking pass
// over a sparse ruling set (Helman-JaJa), five launches, no host read:
//   rulers  the nodes where orbits end (f(d) = d: a head in modes 0 and 2,
//           a tail in mode 1); every node whose id a fixed hash samples at
//           one in 2^RK_RULER_LOG2 (no randomness: the result cannot
//           depend on it); in mode 1, every node d whose successor's prev
//           is not d (two nodes that share a successor: K5's atomicMax
//           keeps one as prev, so the other starts a segment of its own).
//   walk    a thread a ruler walks its segment against the orbit, along
//           nxt where prev[nxt[x]] == x (modes 0, 2: over (nxt, prev)
//           pairs it overwrites in place) or along prev (mode 1), up to
//           the next ruler, writing each node's ruler and distance to it
//           (mode 1: and the min id on the way). The longest segment,
//           about 2^RK_RULER_LOG2 ln(N / 2^RK_RULER_LOG2) dependent
//           loads, sets its time.
//   link    the rulers alone are ranked by pointer jumping, in one
//           cooperative launch (a grid barrier a round, at most
//           bitlen(rulers) + 1 rounds).
//   fold    a pass over the nodes combines each node's value with its
//           ruler's.
//   cycles  a node whose orbit never reaches a fixed point (on a cycle, or,
//           in mode 1, leading into one) has a state that depends on the
//           number of rounds the reference ran; these nodes run the
//           reference's own rounds over their list alone, in one
//           cooperative launch (int32 wraparound included). The resolved
//           nodes' pointers move while 2^(j-1) is below their longest
//           distance (rounds j <= J), so the rounds stop at the first j > J
//           that moved no pointer of the list, or at D. With no such node
//           the launch returns at once.
// A node that reaches a fixed point gets the converged state (P its head
// or tail). The link and cycle launches are cooperative, so their blocks
// are co-resident and a software grid barrier is safe; what one block
// writes there, another reads through L2 (ld.cg), never a stale L1 line.

#define RK_RULER_LOG2 5  // a node in 32 sampled as a ruler (ops/unitig.py RULER_LOG2)
#define RK_THREADS 256
#define RK_ITEMS 8  // nodes a thread of the rulers and fold passes (one atomic a block)
#define RK_COOP_THREADS 1024
#define RK_COOP_PER_SM 1  // cooperative blocks an SM: the barrier's cost grows with blocks
#define RK_BATCH 4  // rulers a thread loads at once in a link round
// the control block (int32, zeroed by the entry): ruler count, cycle-list
// length, the longest distance of a resolved node, which buffer holds the
// rulers' final state; the grid barrier's count and generation, each on a
// 128-byte line of its own (waiting blocks poll the generation); a flag a
// round of each cooperative launch
#define RK_CNT 0
#define RK_NCYC 1
#define RK_MAXD 2
#define RK_FIN 3
#define RK_BAR 32
#define RK_GEN 64
#define RK_ACT 96
#define RK_CHG 160
#define RK_CTL_INTS 256
#define RK_ALL 0xffffffffu

static __device__ __forceinline__ bool rk_sampled(int d) {
  uint32_t h = (uint32_t)d * 0x9E3779B1u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return (h >> (32 - RK_RULER_LOG2)) == 0u;
}

// the reference's round for one node: P = P[P], the carries folded (sums
// wrap as int32)
template <int MODE>
static __device__ __forceinline__ int4 rk_fold(int4 s, int4 g) {
  int4 o;
  o.x = g.x;
  o.w = 0;
  if (MODE == 0) {
    o.y = (int)((uint32_t)s.y + (uint32_t)g.y);
    o.z = s.z | g.z;
  } else if (MODE == 1) {
    o.y = s.y | g.y;
    o.z = min(s.z, g.z);
  } else {
    o.y = (int)((uint32_t)s.y + (uint32_t)g.y);
    o.z = s.z;
  }
  return o;
}

// the first of c slots a thread reserves in an append to ctl[at]: a scan
// over the block, one atomic a block; every thread of the block calls it
static __device__ __forceinline__ int rk_reserve(int c, int32_t* __restrict__ ctl, int at) {
  __shared__ int wsum[RK_THREADS / 32];
  __shared__ int base;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = c;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(RK_ALL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int i = 0; i < RK_THREADS / 32; ++i) {
      const int v = wsum[i];
      wsum[i] = t;
      t += v;
    }
    base = t ? atomicAdd(ctl + at, t) : 0;
  }
  __syncthreads();
  return base + wsum[w] + x - c;
}

// every block of a cooperative launch: the last to arrive resets the count
// and bumps the generation the others wait on. With flag >= 0 the barrier
// also returns whether any thread of the grid passed v: a block ORs its
// threads first and one thread a block sets ctl[flag] (one store to that
// address a block, not one a warp), then reads it back after the barrier
static __device__ __forceinline__ bool rk_grid_barrier(int32_t* __restrict__ ctl,
                                                       bool v = false, int flag = -1) {
  __shared__ int any;
  const int b = __syncthreads_or(v);
  if (threadIdx.x == 0) {
    if (b && flag >= 0) ctl[flag] = 1;
    volatile int32_t* gen = ctl + RK_GEN;
    const int32_t g = *gen;
    __threadfence();
    if (atomicAdd(ctl + RK_BAR, 1) == (int)gridDim.x - 1) {
      ctl[RK_BAR] = 0;
      __threadfence();
      atomicAdd(ctl + RK_GEN, 1);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
    any = flag >= 0 ? *(volatile int32_t*)(ctl + flag) : 0;
  }
  __syncthreads();
  return any != 0;
}

// T[d] after the walk: a node a walk reached, and every ruler, holds its
// ruler index o and distance l as (-o - 2, -l - 2), both <= -2; a node no
// walk reached keeps its first value, (nxt, prev) in modes 0 and 2 (its
// nxt >= 0: it lies on a cycle), (0, 0) in mode 1. A prev of -2 or less
// matches no node, so a walk never steps into a node another walk wrote
static __device__ __forceinline__ int2 rk_mark(int o, int l) { return make_int2(-o - 2, -l - 2); }
static __device__ __forceinline__ bool rk_reached(int2 t) { return t.x <= -2; }
#define RK_LISTED INT32_MIN  // T[d] = (RK_LISTED, list index) for a node of the cycle list

// rulers: RN[ruler index] = d; T[d] = (nxt[d], prev[d]) in modes 0 and 2,
// which the walk reads and rewrites in place (one 8-byte pair a step, and
// half the footprint of a separate array: 32 MB at 4M nodes stays in the
// 50 MB L2); in mode 1 T[d] = a ruler's mark or (0, 0), and aux[d] = d (a
// ruler's own min id). A block takes RK_ITEMS * RK_THREADS nodes
template <int MODE>
__global__ void __launch_bounds__(RK_THREADS)
rank_rulers_kernel(int N, const int32_t* __restrict__ nxt, const int32_t* __restrict__ prev,
                   int2* __restrict__ T, int32_t* __restrict__ RN,
                   int32_t* __restrict__ aux, int32_t* __restrict__ ctl) {
  const int d0 = blockIdx.x * (RK_THREADS * RK_ITEMS) + threadIdx.x;
  unsigned flags = 0;
#pragma unroll
  for (int j = 0; j < RK_ITEMS; ++j) {
    const int d = d0 + j * RK_THREADS;
    if (d >= N) break;
    const int n = nxt[d];
    bool ruler;
    if (MODE == 1) {
      ruler = n < 0 || rk_sampled(d) || __ldg(prev + n) != d;
      aux[d] = d;
    } else {
      const int p = prev[d];
      ruler = p < 0 || rk_sampled(d);
      T[d] = make_int2(n, p);
    }
    flags |= (unsigned)ruler << j;
  }
  int ri = rk_reserve(__popc(flags), ctl, RK_CNT);
#pragma unroll
  for (int j = 0; j < RK_ITEMS; ++j) {
    const int d = d0 + j * RK_THREADS;
    if (d >= N) break;
    const bool ruler = (flags >> j) & 1u;
    if (ruler) RN[ri] = d;
    if (MODE == 1) T[d] = ruler ? rk_mark(ri, 0) : make_int2(0, 0);
    ri += ruler;
  }
}

// walk: a thread a ruler (a grid of the card's resident blocks), against
// the orbit up to the next ruler, marking every node it reaches (and its
// ruler) in T; RS[i] = the segment's node count. A walk stops after N
// nodes: an input whose prev is not K5's could loop
template <int MODE>
__global__ void __launch_bounds__(RK_THREADS)
rank_walk_kernel(int N, const int32_t* __restrict__ prev,
                 const int32_t* __restrict__ RN, int2* __restrict__ T,
                 int32_t* __restrict__ RS, int32_t* __restrict__ aux,
                 const int32_t* __restrict__ ctl) {
  const int cnt = ctl[RK_CNT];
  const int step = gridDim.x * RK_THREADS;
  for (int i = blockIdx.x * RK_THREADS + threadIdx.x; i < cnt; i += step) {
    const int u = RN[i];
    int len = 1;
    if (MODE == 1) {
      int mn = u, y = prev[u];
      while (y >= 0 && len < N && !rk_sampled(y)) {
        const int py = prev[y];
        mn = min(mn, y);
        T[y] = rk_mark(i, len++);
        aux[y] = mn;
        y = py;
      }
    } else {
      // no walk reads a ruler's pair (a walk stops before a sampled node,
      // and a head has no prev), so this one may mark it
      int x = u, y = T[u].x;
      T[u] = rk_mark(i, 0);
      while (y >= 0 && len < N && !rk_sampled(y)) {
        const int2 e = T[y];  // (nxt, prev) of y, or a mark: one load a step
        if (e.y != x) break;
        T[y] = rk_mark(i, len++);
        x = y;
        y = e.x;
      }
    }
    RS[i] = len;
  }
}

// link (cooperative): a ruler's state {next ruler or -1, distance to it,
// head (modes 0, 2) or min id (mode 1), tail (mode 1)}, pointer jumping
// double-buffered in A[0, N) and A[N, 2N); then the longest distance of a
// node that reached a fixed point, and which buffer is final
template <int MODE>
__global__ void __launch_bounds__(RK_COOP_THREADS)
rank_link_kernel(int N, const int32_t* __restrict__ nxt, const int32_t* __restrict__ prev,
                 const int2* __restrict__ T, const int32_t* __restrict__ aux,
                 const int32_t* __restrict__ RN, const int32_t* __restrict__ RS,
                 int4* __restrict__ A, int32_t* __restrict__ ctl) {
  const int cnt = ctl[RK_CNT];
  const int t0 = blockIdx.x * RK_COOP_THREADS + threadIdx.x;
  const int step = gridDim.x * RK_COOP_THREADS;
  int4* cur = A;
  int4* nx = A + N;
  for (int i = t0; i < cnt; i += step) {
    const int u = RN[i];
    int4 s;
    // a ruler whose f-successor no walk reached (an input that is not
    // K5's) links to itself: it stays unresolved
    if (MODE == 1) {
      const int q = nxt[u];
      if (q < 0) {
        s = make_int4(-1, 0, u, u);
      } else {
        const int2 t = T[q];
        s = rk_reached(t) ? make_int4(-t.x - 2, -t.y - 1, min(u, aux[q]), 0)
                          : make_int4(i, 1, u, 0);
      }
    } else {
      const int p = prev[u];
      if (p < 0) {
        s = make_int4(-1, 0, u, 0);
      } else {
        const int2 t = T[p];
        s = rk_reached(t) ? make_int4(-t.x - 2, -t.y - 1, 0, 0) : make_int4(i, 1, 0, 0);
      }
    }
    __stcg(cur + i, s);
  }
  rk_grid_barrier(ctl);
  const int cap = 33 - __clz(max(cnt, 1));  // bitlen(cnt) + 1 rounds: past it, a ring
  for (int j = 0; j < cap; ++j) {
    bool linked = false;
    for (int i0 = t0; i0 < cnt; i0 += RK_BATCH * step) {
      int4 s[RK_BATCH], g[RK_BATCH];
#pragma unroll
      for (int b = 0; b < RK_BATCH; ++b) {
        const int i = i0 + b * step;
        s[b] = i < cnt ? __ldcg(cur + i) : make_int4(-1, 0, 0, 0);
      }
#pragma unroll
      for (int b = 0; b < RK_BATCH; ++b)
        if (s[b].x >= 0) g[b] = __ldcg(cur + s[b].x);
#pragma unroll
      for (int b = 0; b < RK_BATCH; ++b) {
        const int i = i0 + b * step;
        if (i >= cnt) break;
        if (s[b].x >= 0) {
          s[b].x = g[b].x;
          s[b].y = (int)((uint32_t)s[b].y + (uint32_t)g[b].y);
          if (MODE == 1) {
            s[b].z = min(s[b].z, g[b].z);
            s[b].w = g[b].w;
          } else {
            s[b].z = g[b].z;
          }
          linked |= s[b].x >= 0;
        }
        __stcg(nx + i, s[b]);
      }
    }
    const bool any = rk_grid_barrier(ctl, linked, RK_ACT + j);
    int4* t = cur;
    cur = nx;
    nx = t;
    if (!any) break;
  }
  int md = -1;
  for (int i = t0; i < cnt; i += step) {
    const int4 s = __ldcg(cur + i);
    if (s.x < 0) md = max(md, s.y + RS[i] - 1);
  }
  for (int o = 16; o > 0; o >>= 1) md = max(md, __shfl_xor_sync(RK_ALL, md, o));
  if ((threadIdx.x & 31) == 0 && md > 0) atomicMax(ctl + RK_MAXD, md);
  if (t0 == 0) ctl[RK_FIN] = cur != A;
}

// fold: a resolved node's state from its ruler's; every other node joins
// the cycle list U, with T[d] = (RK_LISTED, its list index). A block takes
// RK_ITEMS * RK_THREADS nodes
template <int MODE>
__global__ void __launch_bounds__(RK_THREADS)
rank_fold_kernel(int N, int2* __restrict__ T, const int32_t* __restrict__ aux,
                 const int4* __restrict__ A, int4* __restrict__ S, int32_t* __restrict__ U,
                 int32_t* __restrict__ ctl) {
  const int d0 = blockIdx.x * (RK_THREADS * RK_ITEMS) + threadIdx.x;
  const int4* RF = A + (ctl[RK_FIN] ? N : 0);
  unsigned flags = 0;
#pragma unroll
  for (int j = 0; j < RK_ITEMS; ++j) {
    const int d = d0 + j * RK_THREADS;
    if (d >= N) break;
    const int2 t = T[d];
    const int4 r = rk_reached(t) ? RF[-t.x - 2] : make_int4(0, 0, 0, 0);
    if (!rk_reached(t) || r.x >= 0) {
      flags |= 1u << j;
    } else if (MODE == 1) {
      S[d] = make_int4(r.w, 1, min(aux[d], r.z), 0);
    } else {
      S[d] = make_int4(r.z, (int)((uint32_t)r.y + (uint32_t)(-t.y - 2)), MODE == 0, 0);
    }
  }
  int c = rk_reserve(__popc(flags), ctl, RK_NCYC);
#pragma unroll
  for (int j = 0; j < RK_ITEMS; ++j) {
    if ((flags >> j) & 1u) {
      const int d = d0 + j * RK_THREADS;
      U[c] = d;
      T[d] = make_int2(RK_LISTED, c);
      ++c;
    }
  }
}

// cycles (cooperative): the reference's rounds over the list alone, from
// its start state, double-buffered in B[0, N) and B[N, 2N), pointers as
// list indices
template <int MODE>
__global__ void __launch_bounds__(RK_COOP_THREADS)
rank_cycle_kernel(int N, int D, const int32_t* __restrict__ nxt,
                  const int32_t* __restrict__ prev, const int2* __restrict__ T,
                  const int32_t* __restrict__ U, int4* __restrict__ B, int4* __restrict__ S,
                  int32_t* __restrict__ ctl) {
  const int nc = ctl[RK_NCYC];
  if (nc == 0) return;  // every block returns before any barrier
  const int md = ctl[RK_MAXD];
  const int J = md <= 1 ? 0 : 32 - __clz(md - 1);  // ceil(log2(longest distance))
  const int t0 = blockIdx.x * RK_COOP_THREADS + threadIdx.x;
  const int step = gridDim.x * RK_COOP_THREADS;
  int4* cur = B;
  int4* nx = B + N;
  for (int i = t0; i < nc; i += step) {
    const int x = U[i];
    int4 s;
    int P;
    if (MODE == 1) {
      const int n = nxt[x];
      P = n >= 0 ? n : x;
      s = make_int4(0, n < 0, x, 0);
    } else {
      const int p = prev[x];
      P = p >= 0 ? p : x;
      s = make_int4(0, p >= 0, MODE == 0 ? (p < 0) : 0, 0);
    }
    const int2 t = T[P];
    s.x = t.x == RK_LISTED ? t.y : i;  // P leaves the list only on an input that is not K5's
    __stcg(cur + i, s);
  }
  rk_grid_barrier(ctl);
  for (int j = 1; j <= D; ++j) {
    bool moved = false;
    for (int i = t0; i < nc; i += step) {
      const int4 s = __ldcg(cur + i);
      const int4 g = __ldcg(cur + s.x);
      moved |= g.x != s.x;
      __stcg(nx + i, rk_fold<MODE>(s, g));
    }
    const bool any = rk_grid_barrier(ctl, moved, RK_CHG + j);
    int4* t = cur;
    cur = nx;
    nx = t;
    if (j > J && !any) break;
  }
  for (int i = t0; i < nc; i += step) {
    const int4 s = __ldcg(cur + i);
    S[U[i]] = make_int4(U[s.x], s.y, s.z, 0);
  }
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

template <int MODE>
static int rank_launch(int N, const int32_t* nxt, const int32_t* prev, int4* S,
                       int2* T, int32_t* RN, int32_t* RS, int4* A, int32_t* U, int32_t* aux,
                       int32_t* ctl, cudaStream_t st) {
  static int walk_grid = 0, link_grid = 0, cycle_grid = 0;
  if (!walk_grid) {
    LT_TRY(resident_blocks(rank_link_kernel<MODE>, RK_COOP_THREADS, &link_grid, RK_COOP_PER_SM));
    LT_TRY(resident_blocks(rank_cycle_kernel<MODE>, RK_COOP_THREADS, &cycle_grid,
                           RK_COOP_PER_SM));
    LT_TRY(resident_blocks(rank_walk_kernel<MODE>, RK_THREADS, &walk_grid));
  }
  int D = 1;  // the reference's round cap: max(1, bitlen(N - 1)) + 1
  while ((1ll << D) <= (long long)N - 1) ++D;
  D += 1;
  LT_TRY(cudaMemsetAsync(ctl, 0, RK_CTL_INTS * sizeof(int32_t), st));
  const unsigned nb = (unsigned)((N + RK_THREADS * RK_ITEMS - 1) / (RK_THREADS * RK_ITEMS));
  rank_rulers_kernel<MODE><<<nb, RK_THREADS, 0, st>>>(N, nxt, prev, T, RN, aux, ctl);
  LT_TRY(cudaGetLastError());
  rank_walk_kernel<MODE><<<walk_grid, RK_THREADS, 0, st>>>(N, prev, RN, T, RS, aux, ctl);
  LT_TRY(cudaGetLastError());
  const int2* Tc = T;
  const int32_t *auxc = aux, *RNc = RN, *RSc = RS, *Uc = U;
  void* link_args[] = {&N, &nxt, &prev, &Tc, &auxc, &RNc, &RSc, &A, &ctl};
  LT_TRY(cudaLaunchCooperativeKernel((const void*)rank_link_kernel<MODE>, link_grid,
                                     RK_COOP_THREADS, link_args, 0, st));
  rank_fold_kernel<MODE><<<nb, RK_THREADS, 0, st>>>(N, T, aux, A, S, U, ctl);
  LT_TRY(cudaGetLastError());
  void* cycle_args[] = {&N, &D, &nxt, &prev, &Tc, &Uc, &A, &S, &ctl};
  LT_TRY(cudaLaunchCooperativeKernel((const void*)rank_cycle_kernel<MODE>, cycle_grid,
                                     RK_COOP_THREADS, cycle_args, 0, st));
  return (int)cudaGetLastError();
}

// S: (N,) int4 output. Scratch: T (N,) int2; RN, RS, U (N,) int32; A (2N,)
// int4; aux (N,) int32 in mode 1 (else unused, may be null); ctl
// RK_CTL_INTS int32
extern "C" int lt_unitig_rank(int mode, int N, const void* nxt, const void* prev,
                              void* S, void* T, void* RN, void* RS, void* A, void* U, void* aux,
                              void* ctl, void* stream) {
  if (mode < 0 || mode > 2 || N <= 0 || (mode == 1 && !aux))
    return (int)cudaErrorInvalidValue;
  const int32_t* n = (const int32_t*)nxt;
  const int32_t* p = (const int32_t*)prev;
  cudaStream_t st = (cudaStream_t)stream;
#define RK_ARGS                                                                         \
  N, n, p, (int4*)S, (int2*)T, (int32_t*)RN, (int32_t*)RS, (int4*)A, (int32_t*)U, \
      (int32_t*)aux, (int32_t*)ctl, st
  if (mode == 0) return rank_launch<0>(RK_ARGS);
  if (mode == 1) return rank_launch<1>(RK_ARGS);
  return rank_launch<2>(RK_ARGS);
#undef RK_ARGS
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
