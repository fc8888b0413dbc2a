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
//   K7 emit    lt_unitig_emit (+ _words)
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
// Bound on the H100: random loads. K5 searches a prefix table sized to the
// run, a thread a directed node with its (at most five) searches in flight
// together; K6 is one list-ranking pass (a few dependent loads a node;
// state int4 {P, c0, c1, 0}, as the reference rides pointer and carries as
// columns of one matrix); K7 is a scatter-min that reads first, then plain
// byte stores into a position-ordered plane and a pack (atomics only where
// chains collide). A W-word row lives in registers (Kmer<W>).
#include "common.cuh"
#include "kmer_words.cuh"

#define UT_THREADS 256

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

// ---------------------------------------------------------------------------
// K5 links (unitig.py:367-418, 469-508)
// ---------------------------------------------------------------------------
//
// A directed node's successor by base b is y_b = x << 2 | b (its spelled
// form x, top base dropped) or its reverse complement yr_b = xr >> 2 |
// (3 - b) << 2(k-1) (xr the twin's form), whichever is smaller, yr_b only
// when strictly smaller. The four y_b are four consecutive values, so they
// are one search: the lower bound of y_0, then the next four rows. Each
// yr_b that is taken is a search of its own (about half of them on random
// k-mers). A thread a directed node runs its (at most five) searches
// together: the prefix-table lookups first, then rounds that load every
// unfinished search's middle row at once, so that a thread keeps up to five
// independent loads in flight instead of a chain of dependent ones.
//
// The prefix table (`starts`) has 2^T + 1 entries over the top T bits,
// T sized by the wrapper to the run (about log2 M, so a bucket holds about
// one row; ops/unitig.py links_table_bits) and at most 2k - 2, so that the
// four y_b share a bucket. Any T gives the same links: an exact match lies
// in its own bucket (the reference's docstring, unitig.py:382-386), and a
// lower bound that passes a bucket's rows is the next bucket's start, the
// global lower bound. A search that probes its match records it, so a
// taken yr_b needs no final load; the forward search loads the four rows
// from its lower bound.

#define K5_SEARCHES 5  // the forward candidates' search, then yr_0 .. yr_3
#define K5_PAL 0x80    // outc's bit: the row is its own reverse complement

// the top T bits of a 2k-bit key (T <= 2k - 2; T = 0: one bucket)
static __device__ __forceinline__ int top_bits(uint64_t key, int k, int T) {
  return T ? (int)((key >> (2 * k - T)) & ((1u << T) - 1u)) : 0;
}

// starts[b] = first row whose bucket is >= b, for b in [0, 2^T]; thread i
// writes the buckets between row i-1's and row i's (row M: the end), so
// every entry is written once and no histogram or scan is needed
__global__ void buckets_kernel(const int64_t* __restrict__ keys, int M, int k, int T,
                               int32_t* __restrict__ starts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > M) return;
  const int cur = i < M ? top_bits((uint64_t)keys[i], k, T) : (1 << T);
  const int prv = i > 0 ? top_bits((uint64_t)keys[i - 1], k, T) : -1;
  for (int b = prv + 1; b <= cur; ++b) starts[b] = i;
}

// per directed node d: its first successor in base order 0..3, and its
// out-degree with K5_PAL where its row is a palindrome
__global__ void __launch_bounds__(UT_THREADS)
succ_kernel(const int64_t* __restrict__ keys, int M, int k, int T,
            const int32_t* __restrict__ starts, int32_t* __restrict__ succ,
            uint8_t* __restrict__ outc) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= 2 * M) return;
  const uint64_t x0 = (uint64_t)__ldg(keys + (d >> 1)), r0 = revcomp(x0, k);
  const uint64_t x = (d & 1) ? r0 : x0, xr = (d & 1) ? x0 : r0;
  const uint64_t fwd = (x << 2) & ((1ull << (2 * k)) - 1ull);  // y_b = fwd | b
  uint64_t q[K5_SEARCHES];
  bool act[K5_SEARCHES];
  q[0] = fwd;
  act[0] = false;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    q[1 + b] = (xr >> 2) | ((uint64_t)(3 - b) << (2 * (k - 1)));
    act[1 + b] = q[1 + b] < (fwd | (uint64_t)b);
    act[0] |= !act[1 + b];
  }
  int lo[K5_SEARCHES], hi[K5_SEARCHES], hit[K5_SEARCHES];
#pragma unroll
  for (int s = 0; s < K5_SEARCHES; ++s) {
    const int p = top_bits(q[s], k, T);
    lo[s] = act[s] ? __ldg(starts + p) : 0;
    hi[s] = act[s] ? __ldg(starts + p + 1) : 0;
    hit[s] = -1;
  }
  for (;;) {  // lower bounds: a round loads every unfinished search's middle row
    uint64_t v[K5_SEARCHES];
    bool any = false;
#pragma unroll
    for (int s = 0; s < K5_SEARCHES; ++s) {
      v[s] = lo[s] < hi[s] ? (uint64_t)__ldg(keys + ((lo[s] + hi[s]) >> 1)) : 0ull;
      any |= lo[s] < hi[s];
    }
    if (!any) break;
#pragma unroll
    for (int s = 0; s < K5_SEARCHES; ++s) {
      if (lo[s] < hi[s]) {
        const int mid = (lo[s] + hi[s]) >> 1;
        if (v[s] < q[s]) {
          lo[s] = mid + 1;
        } else {
          hi[s] = mid;
          if (v[s] == q[s]) hit[s] = mid;
        }
      }
    }
  }
  uint64_t v[4];  // the four rows from fwd's lower bound: fwd | b is among them if present
#pragma unroll
  for (int t = 0; t < 4; ++t)
    v[t] = act[0] && lo[0] + t < M ? (uint64_t)__ldg(keys + lo[0] + t) : ~0ull;
  int oc = 0, sc = -1;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int j = hit[1 + b];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (!act[1 + b] && v[t] == (fwd | (uint64_t)b)) j = lo[0] + t;
    if (j >= 0 && ++oc == 1) sc = 2 * j + (int)act[1 + b];
  }
  succ[d] = sc;
  outc[d] = (uint8_t)(oc | (x0 == r0 ? K5_PAL : 0));
}

// A row at a time, its two nodes: nxt = succ where the edge is internal
// (out(d) = 1 and in(s) = out(twin of s) = 1: a byte gathered at random,
// from N bytes that stay in L2 where N int32 would not). prev is pulled
// from the twin, with no scatter: an internal edge d -> s has the internal
// twin edge s^1 -> d^1 (the reverse complement swaps in- and out-degrees),
// so prev[s] = succ[s^1] ^ 1 where s^1's edge is internal. The odd node of
// a palindromic row spells the even one's k-mer, which every search
// returns (yr only when strictly smaller), so it has no prev; where two
// nodes share a successor (a palindromic row's two nodes) the pull names
// the larger, the reference's last writer (unitig.py:508, scatter-max in
// the plain version).
__global__ void link_kernel(int M, const int2* __restrict__ succ2,
                            const uint8_t* __restrict__ outc, int2* __restrict__ nxt2,
                            int2* __restrict__ prev2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int2 s = succ2[i];
  const uint8_t o0 = outc[2 * i], o1 = outc[2 * i + 1];
  const bool in0 =
      (o0 & ~K5_PAL) == 1 && s.x >= 0 && (__ldg(outc + (s.x ^ 1)) & ~K5_PAL) == 1;
  const bool in1 =
      (o1 & ~K5_PAL) == 1 && s.y >= 0 && (__ldg(outc + (s.y ^ 1)) & ~K5_PAL) == 1;
  nxt2[i] = make_int2(in0 ? s.x : -1, in1 ? s.y : -1);
  prev2[i] = make_int2(in1 ? s.y ^ 1 : -1, in0 && !(o0 & K5_PAL) ? s.x ^ 1 : -1);
}

// the table's bits: 0 <= T <= min(K5_TBITS_MAX, 2k - 2)
#define K5_TBITS_MAX 26
static bool k5_bits_ok(int k, int T) {
  return T >= 0 && T <= K5_TBITS_MAX && T <= (k > 1 ? 2 * k - 2 : 0);
}

// starts: (2^T + 1) int32
extern "C" int lt_unitig_buckets(const void* keys, int M, int k, int T, void* starts,
                                 void* stream) {
  if (k < 1 || k > 31 || M < 0 || !k5_bits_ok(k, T)) return (int)cudaErrorInvalidValue;
  buckets_kernel<<<ut_blocks((long long)M + 1), UT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, M, k, T, (int32_t*)starts);
  return (int)cudaGetLastError();
}

// so: (5 * 2M) bytes of scratch: succ (2M int32), then outc (2M bytes);
// nxt, prev: (2M,) int32 outputs
extern "C" int lt_unitig_links(const void* keys, int M, int k, int T, const void* starts,
                               void* so, void* nxt, void* prev, void* stream) {
  if (k < 1 || k > 31 || M <= 0 || !k5_bits_ok(k, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = 2 * M;
  int32_t* succ = (int32_t*)so;
  uint8_t* outc = (uint8_t*)(succ + N);
  succ_kernel<<<ut_blocks(N), UT_THREADS, 0, st>>>((const int64_t*)keys, M, k, T,
                                                   (const int32_t*)starts, succ, outc);
  LT_TRY(cudaGetLastError());
  link_kernel<<<ut_blocks(M), UT_THREADS, 0, st>>>(M, (const int2*)succ, outc, (int2*)nxt,
                                                   (int2*)prev);
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
// 2-bit bases (cap_bases/16 words, code t at bits 2t)]. One C entry a call
// launches everything, on scratch the wrapper allocates once (em_layout).
//   mins   the chain's min id m, kept at its head as ~m by a scatter-max
//          that reads first (nodes run in id order, so a chain's min lands
//          early and later nodes skip the atomic: no chain holds its head's
//          address for its length), over an array zeroed with the counts
//          by one memset; in the acyclic mode, the cycle flag.
//   heads  keep_head = no prev and an even m. The reference keeps a head
//          when min id <= min twin id (tmn); tmn >= m when m is even (only
//          m - 2's twin could be smaller, and m - 2 is not in the chain),
//          and tmn = m - 1 when m is odd (m's own twin), so tmn needs no
//          pass. The flags' prefix sum (the reference's cid, a jnp.cumsum)
//          as two levels: each block of EM_SCAN nodes writes its inclusive
//          counts beside the flags (cl), then one block scans the blocks'
//          totals (boff) and writes the header.
//   lens   len_nodes at each kept tail, and its chain's base count at
//          bp[c + 1]; the tails below cap are counted. bp's prefix sum
//          (the reference's start) the same two levels: start[c] is chain
//          c's first position, start[cap] the bases in all.
//   bases  each kept node's last base at start + (k-1) + rank, and each
//          kept head's k-1 prefix bases, a warp's heads one after another
//          over the warp's lanes (a base a lane, coalesced), as bytes of a
//          position-ordered plane; then a pass packs 16 bytes into a word.
// Every position below start[cap] has exactly one writer when every kept
// chain below cap has a tail (its region is its prefix and one node a
// rank), so the bytes are plain stores and the positions past start[cap]
// are zero. A chain with no tail (two nodes that share a successor, at
// even-k palindromes) writes into other chains' positions; then (a device
// flag: fewer tails than kept chains below cap) every write takes an
// atomicMax of (key << 2 | base) into a zeroed key plane in the byte
// plane's place (32-bit words where every key fits, else 64), the key its
// rank in the reference's write order (even nodes by id, odd nodes by id,
// then prefix base j = 0 .. k-2 over the chains by id: ops/unitig.py
// _node_key, _prefix_key), and the pack reads the largest: the reference's
// last writer. Bound: S read, the run, cl and start gathered, the plane
// written and read, the buffer written; the scatters land at random
// positions.

#define EM_T 256             // threads a block of the scans
#define EM_SCAN (4 * EM_T)   // items a block scans, 4 a thread
#define EM_SCAN_LOG2 10
#define EM_TAILS 0  // ctl: the kept chains below cap that have a tail
#define EM_CYC 1    // ctl: a node reached no head (the acyclic mode's cycle flag)

// The work buffer (int64 units): aux = bp (cap + 1), ctl (4 int32); a
// region that holds cm (N u32), then the byte plane (cap_bases) or, where
// chains collide, the key plane (cap_bases keys of kb bytes: 4 where every
// key << 2 fits 32 bits, else 8); cl (N int32); boff and soff (a block's
// offset each). ops/unitig.py _emit_work_words mirrors the size.
struct EmLayout {
  long long region, cl, boff, soff, words;
};

static long long em_blocks(long long n) { return (n + EM_SCAN - 1) / EM_SCAN; }

static EmLayout em_layout(int N, int cap, long long cap_bases, int kb) {
  EmLayout L;
  const long long half = ((long long)N + 1) / 2, keys = (cap_bases * kb + 7) / 8;
  L.region = (cap + 4) & ~1ll;  // 16-byte aligned: the pack's loads
  L.cl = L.region + (half > keys ? half : keys);
  L.boff = L.cl + half;
  L.soff = L.boff + em_blocks(N);
  L.words = L.soff + em_blocks((long long)cap + 1);
  return L;
}

// exclusive scan of x over the block's EM_T threads (every thread calls
// it); *total the block's sum
template <typename T>
static __device__ __forceinline__ T em_block_excl(T x, T* total) {
  __shared__ T ws[EM_T / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  T v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(RK_ALL, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) ws[w] = v;
  __syncthreads();
  if (w == 0) {
    T u = lane < EM_T / 32 ? ws[lane] : (T)0;
#pragma unroll
    for (int o = 1; o < EM_T / 32; o <<= 1) {
      const T y = __shfl_up_sync(RK_ALL, u, o);
      if (lane >= o) u += y;
    }
    if (lane < EM_T / 32) ws[lane] = u;
  }
  __syncthreads();
  const T pre = (w ? ws[w - 1] : (T)0) + v - x;
  *total = ws[EM_T / 32 - 1];
  __syncthreads();
  return pre;
}

// chain index of head h (the kept heads before it), or -1 where h is no
// kept head: cl[h] = (the block's kept heads up to h << 1) | keep_head
static __device__ __forceinline__ int em_chain(const int32_t* __restrict__ cl,
                                               const long long* __restrict__ boff, int h) {
  const int v = __ldg(cl + h);
  return (v & 1) ? (v >> 1) + (int)__ldg(boff + (h >> EM_SCAN_LOG2)) - 1 : -1;
}

// chain c's first position
static __device__ __forceinline__ long long em_start(const long long* __restrict__ bp,
                                                     const long long* __restrict__ soff, int c) {
  return __ldg(bp + c) + __ldg(soff + (c >> EM_SCAN_LOG2));
}

static __device__ __forceinline__ bool em_collide(const uint32_t* __restrict__ buf,
                                                  const int32_t* __restrict__ ctl, int cap) {
  return (unsigned)ctl[EM_TAILS] < min(buf[0], (uint32_t)cap);
}

static __device__ __forceinline__ unsigned long long em_node_key(int d, int M) {
  return 1ull + (unsigned long long)(d & 1) * (unsigned)M + (unsigned)(d >> 1);
}

static __device__ __forceinline__ unsigned long long em_prefix_key(int j, int c, int M, int cap) {
  return 1ull + 2ull * (unsigned)M + (unsigned long long)j * (unsigned)cap + (unsigned)c;
}

// K: the key plane's word (uint32_t or unsigned long long), the plane
// aliasing the byte plane
template <typename K>
static __device__ __forceinline__ void em_put(long long pos, uint32_t base,
                                              unsigned long long key, bool collide,
                                              long long cap_bases, void* __restrict__ plane) {
  if (pos < 0 || pos >= cap_bases) return;
  if (collide) atomicMax(reinterpret_cast<K*>(plane) + pos, (K)((key << 2) | base));
  else reinterpret_cast<uint8_t*>(plane)[pos] = (uint8_t)base;
}

// cm[h] = ~(min node id whose head is h), a max over a zeroed array (0:
// no node, whose head the reference keeps, as an even min); in the acyclic
// mode a node that reached no head flags a cycle (a store a block)
__global__ void __launch_bounds__(UT_THREADS)
emit_mins_kernel(int N, const int4* __restrict__ S, int acyclic, uint32_t* __restrict__ cm,
                 int32_t* __restrict__ ctl) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  bool cyc = false;
  if (d < N) {
    int h;
    if (acyclic) {
      const int4 s = S[d];
      h = s.x;
      cyc = s.z == 0;
    } else {
      h = reinterpret_cast<const int*>(S)[4 * (long long)d];
    }
    const uint32_t v = ~(uint32_t)d;
    if (v > __ldcg(cm + h)) atomicMax(cm + h, v);
  }
  if (__syncthreads_or(cyc) && threadIdx.x == 0) ctl[EM_CYC] = 1;
}

// keep_head flags, a block of EM_SCAN nodes (4 a thread) with their
// block-inclusive counts (cl) and the block's total (boff, scanned later);
// the buffer's header and lens zeroed on the way
__global__ void __launch_bounds__(EM_T)
emit_heads_kernel(int N, const int32_t* __restrict__ prev, const uint32_t* __restrict__ cm,
                  int32_t* __restrict__ cl, long long* __restrict__ boff,
                  uint32_t* __restrict__ buf, int cap) {
  for (int i = blockIdx.x * EM_T + threadIdx.x; i < 4 + cap; i += gridDim.x * EM_T) buf[i] = 0u;
  const int d0 = blockIdx.x * EM_SCAN + 4 * threadIdx.x;
  int kh[4], cnt = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = d0 + q;
    kh[q] = 0;
    if (d < N) {
      const uint32_t v = cm[d];
      kh[q] = prev[d] < 0 && (v == 0u || !(~v & 1u));  // no prev, an even min id
    }
    cnt += kh[q];
  }
  int tot;
  int pre = em_block_excl<int>(cnt, &tot);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pre += kh[q];
    if (d0 + q < N) cl[d0 + q] = (pre << 1) | kh[q];
  }
  if (threadIdx.x == 0) boff[blockIdx.x] = tot;
}

// one block: a[0, n) to its exclusive prefix sum, in place; with hdr, the
// kept heads in all (the sum) go to the header: n_chains, overflow, and
// the cycle flag from ctl
__global__ void __launch_bounds__(EM_T)
emit_top_kernel(long long* __restrict__ a, int n, uint32_t* __restrict__ hdr,
                const int32_t* __restrict__ ctl, int cap) {
  long long carry = 0;
  for (int base = 0; base < n; base += EM_SCAN) {
    long long v[4], s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = base + 4 * threadIdx.x + q;
      v[q] = i < n ? a[i] : 0;
      s += v[q];
    }
    long long tot;
    long long pre = carry + em_block_excl<long long>(s, &tot);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = base + 4 * threadIdx.x + q;
      if (i < n) a[i] = pre;
      pre += v[q];
    }
    carry += tot;
  }
  if (hdr && threadIdx.x == 0) {
    hdr[0] = (uint32_t)carry;
    hdr[1] = carry > cap;
    hdr[2] = ctl[EM_CYC] != 0;
  }
}

// len_nodes at each kept chain's tail, its base count at bp[c + 1]; ctl
// counts the tails
__global__ void __launch_bounds__(UT_THREADS)
emit_lens_kernel(int N, int k, const int32_t* __restrict__ nxt, const int2* __restrict__ S2,
                 const int32_t* __restrict__ cl, const long long* __restrict__ boff, int cap,
                 uint32_t* __restrict__ buf, long long* __restrict__ bp,
                 int32_t* __restrict__ ctl) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  int tail = 0;
  if (d < N && nxt[d] < 0) {
    const int2 s = S2[2 * (long long)d];
    const int c = em_chain(cl, boff, s.x);
    if (c >= 0 && c < cap) {
      buf[4 + c] = (uint32_t)(s.y + 1);
      bp[c + 1] = (long long)s.y + k;
      tail = 1;
    }
  }
  const int t = __syncthreads_count(tail);
  if (threadIdx.x == 0 && t) atomicAdd(ctl + EM_TAILS, t);
}

// bp[0, n) to its block-inclusive sums, a block of EM_SCAN entries, and
// each block's total (soff, scanned later)
__global__ void __launch_bounds__(EM_T)
emit_bscan_kernel(long long* __restrict__ bp, int n, long long* __restrict__ soff) {
  const int i0 = blockIdx.x * EM_SCAN + 4 * threadIdx.x;
  long long v[4], s = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = i0 + q < n ? bp[i0 + q] : 0;
    s += v[q];
  }
  long long tot;
  long long pre = em_block_excl<long long>(s, &tot);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pre += v[q];
    if (i0 + q < n) bp[i0 + q] = pre;
  }
  if (threadIdx.x == 0) soff[blockIdx.x] = tot;
}

// the key plane, zeroed only where chains collide
template <typename K>
__global__ void emit_zero_kernel(long long n, const uint32_t* __restrict__ buf,
                                 const int32_t* __restrict__ ctl, int cap, K* __restrict__ win) {
  if (!em_collide(buf, ctl, cap)) return;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    win[i] = 0;
}

// word j of row i, LSW first (W words a row; an int64 key is two words, its
// base i at bit 2(k-1-i) as in a W-word row)
template <int W, bool KEYS>
static __device__ __forceinline__ uint32_t em_word(const void* __restrict__ run, int i, int j) {
  if constexpr (KEYS)
    return __ldg(reinterpret_cast<const uint32_t*>(run) + 2 * (long long)i + j);
  else
    return __ldg(reinterpret_cast<const uint32_t*>(run) + (long long)i * W + j);
}

// base j (0 = first) of node d's spelled k-mer: base j of its row, or the
// complement of the row's base k-1-j where d spells the reverse complement
template <int W, bool KEYS>
static __device__ __forceinline__ uint32_t em_base(const void* __restrict__ run, int d, int j,
                                                   int k) {
  const int t = 2 * (k - 1 - ((d & 1) ? k - 1 - j : j));
  const uint32_t b = (em_word<W, KEYS>(run, d >> 1, t >> 5) >> (t & 31)) & 3u;
  return (d & 1) ? 3u - b : b;
}

// a thread a node: its last base (one word of its row); then the warp's
// kept heads' prefixes, a head at a time, base j on lane j mod 32 (the
// head's row read by every lane: one transaction a word)
template <int W, bool KEYS, typename K>
__global__ void __launch_bounds__(UT_THREADS)
emit_bases_kernel(const void* __restrict__ run, int N, int k, const int2* __restrict__ S2,
                  const int32_t* __restrict__ cl, const long long* __restrict__ boff,
                  const long long* __restrict__ bp, const long long* __restrict__ soff, int cap,
                  long long cap_bases, const int32_t* __restrict__ ctl,
                  const uint32_t* __restrict__ buf, void* __restrict__ plane) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, M = N >> 1;
  const bool collide = em_collide(buf, ctl, cap);
  int c = -1, h = -1, r = 0;
  if (d < N) {
    const int2 s = S2[2 * (long long)d];
    h = s.x;
    r = s.y;
    c = em_chain(cl, boff, h);
    if (c >= cap) c = -1;
  }
  long long st = 0;
  if (c >= 0) {
    st = em_start(bp, soff, c);
    em_put<K>(st + (k - 1) + r, em_base<W, KEYS>(run, d, k - 1, k), em_node_key(d, M), collide,
              cap_bases, plane);
  }
  unsigned heads = __ballot_sync(RK_ALL, c >= 0 && h == d);
  while (heads) {
    const int src = __ffs(heads) - 1;
    heads &= heads - 1;
    const long long hs = __shfl_sync(RK_ALL, st, src);
    const int hc = __shfl_sync(RK_ALL, c, src), hd = __shfl_sync(RK_ALL, d, src);
    for (int j = lane; j < k - 1; j += 32)
      em_put<K>(hs + j, em_base<W, KEYS>(run, hd, j, k), em_prefix_key(j, hc, M, cap),
                collide, cap_bases, plane);
  }
}

// word i of the packed bases from positions 16i .. 16i+15: the plane's
// bytes below start[cap] (zero past it), or the key plane's bases
template <typename K>
__global__ void emit_pack_kernel(long long n_words, const void* __restrict__ plane,
                                 const long long* __restrict__ bp,
                                 const long long* __restrict__ soff, int cap,
                                 const int32_t* __restrict__ ctl, uint32_t* __restrict__ buf) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  const long long p0 = 16 * i;
  uint32_t v = 0;
  if (em_collide(buf, ctl, cap)) {
    const K* win = reinterpret_cast<const K*>(plane);
#pragma unroll
    for (int t = 0; t < 16; ++t) v |= (uint32_t)(__ldg(win + p0 + t) & 3u) << (2 * t);
  } else {
    const long long tb = em_start(bp, soff, cap);
    if (p0 < tb) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(plane) + i);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int t = 0; t < 16; ++t)
        if (p0 + t < tb) v |= ((w[t >> 2] >> (8 * (t & 3))) & 3u) << (2 * t);
    }
  }
  buf[4 + cap + i] = v;
}

template <int W, bool KEYS, typename K>
static int em_launch(const void* run, int N, int k, const void* S, const void* nxt,
                     const void* prev, int acyclic, int cap, long long cap_bases, void* work,
                     long long work_words, void* buf, cudaStream_t st) {
  static int zero_grid = 0;
  if (!zero_grid) LT_TRY(resident_blocks(emit_zero_kernel<K>, UT_THREADS, &zero_grid));
  const EmLayout L = em_layout(N, cap, cap_bases, (int)sizeof(K));
  if (work_words < L.words) return (int)cudaErrorInvalidValue;
  long long* w = (long long*)work;
  long long* bp = w;
  int32_t* ctl = (int32_t*)(w + cap + 1);
  uint32_t* cm = (uint32_t*)(w + L.region);
  void* plane = w + L.region;  // after cm: the byte plane, or the key plane
  int32_t* cl = (int32_t*)(w + L.cl);
  long long* boff = w + L.boff;
  long long* soff = w + L.soff;
  uint32_t* b = (uint32_t*)buf;
  const int2* S2 = (const int2*)S;
  const int nb = (int)em_blocks(N), sb = (int)em_blocks((long long)cap + 1);
  LT_TRY(cudaMemsetAsync(w, 0, (size_t)L.region * sizeof(long long) + (size_t)N * 4, st));
  emit_mins_kernel<<<ut_blocks(N), UT_THREADS, 0, st>>>(N, (const int4*)S, acyclic, cm, ctl);
  LT_TRY(cudaGetLastError());
  emit_heads_kernel<<<nb, EM_T, 0, st>>>(N, (const int32_t*)prev, cm, cl, boff, b, cap);
  LT_TRY(cudaGetLastError());
  emit_top_kernel<<<1, EM_T, 0, st>>>(boff, nb, b, ctl, cap);
  LT_TRY(cudaGetLastError());
  emit_lens_kernel<<<ut_blocks(N), UT_THREADS, 0, st>>>(N, k, (const int32_t*)nxt, S2, cl, boff,
                                                       cap, b, bp, ctl);
  LT_TRY(cudaGetLastError());
  emit_bscan_kernel<<<sb, EM_T, 0, st>>>(bp, cap + 1, soff);
  LT_TRY(cudaGetLastError());
  emit_top_kernel<<<1, EM_T, 0, st>>>(soff, sb, nullptr, ctl, cap);
  LT_TRY(cudaGetLastError());
  emit_zero_kernel<K><<<zero_grid, UT_THREADS, 0, st>>>(cap_bases, b, ctl, cap, (K*)plane);
  LT_TRY(cudaGetLastError());
  emit_bases_kernel<W, KEYS, K><<<ut_blocks(N), UT_THREADS, 0, st>>>(
      run, N, k, S2, cl, boff, bp, soff, cap, cap_bases, ctl, b, plane);
  LT_TRY(cudaGetLastError());
  emit_pack_kernel<K><<<ut_blocks(cap_bases / 16), UT_THREADS, 0, st>>>(cap_bases / 16, plane,
                                                                      bp, soff, cap, ctl, b);
  return (int)cudaGetLastError();
}

// key_bits 32 where every key << 2 | base fits 32 bits (2M + (k-1) cap <
// 2^30, the wrapper's choice), else 64
template <int W, bool KEYS>
static int em_launch_keys(int key_bits, const void* run, int N, int k, const void* S,
                          const void* nxt, const void* prev, int acyclic, int cap,
                          long long cap_bases, void* work, long long work_words, void* buf,
                          cudaStream_t st) {
  if (key_bits == 32 && (long long)N + (long long)(k - 1) * cap >= (1ll << 30))
    return (int)cudaErrorInvalidValue;
  if (key_bits == 32)
    return em_launch<W, KEYS, uint32_t>(run, N, k, S, nxt, prev, acyclic, cap, cap_bases, work,
                                        work_words, buf, st);
  if (key_bits == 64)
    return em_launch<W, KEYS, unsigned long long>(run, N, k, S, nxt, prev, acyclic, cap,
                                                  cap_bases, work, work_words, buf, st);
  return (int)cudaErrorInvalidValue;
}

static bool em_args_ok(int N, int cap, long long cap_bases) {
  return N > 0 && cap > 0 && cap_bases > 0 && cap_bases % 16 == 0;
}

// keys: (M,) int64, N = 2M; S (N, 4) int32; nxt, prev (N,) int32; work:
// work_words int64 of scratch (em_layout); buf: the output
extern "C" int lt_unitig_emit(const void* keys, int N, int k, const void* S, const void* nxt,
                              const void* prev, int acyclic, int cap, long long cap_bases,
                              int key_bits, void* work, long long work_words, void* buf,
                              void* stream) {
  if (!em_args_ok(N, cap, cap_bases) || k < 1 || k > 31) return (int)cudaErrorInvalidValue;
  return em_launch_keys<2, true>(key_bits, keys, N, k, S, nxt, prev, acyclic, cap, cap_bases,
                                 work, work_words, buf, (cudaStream_t)stream);
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

// the top T bits of row i, from the one or two words that hold them
// (unitig.py _topbits, 351-364)
template <int W>
static __device__ __forceinline__ int row_top_bits(const uint32_t* __restrict__ rows,
                                                   long long i, int k, int T) {
  if (!T) return 0;
  const int shift = 2 * k - T, wi = shift >> 5, off = shift & 31;
  const uint32_t* r = rows + i * W;
  uint32_t tb = __ldg(r + wi) >> off;
  if (off && wi + 1 < W) tb |= __ldg(r + wi + 1) << (32 - off);
  return (int)(tb & ((1u << T) - 1u));
}

template <int W>
__global__ void buckets_words_kernel(const uint32_t* __restrict__ rows, int M, int k, int T,
                                     int32_t* __restrict__ starts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > M) return;
  const int cur = i < M ? row_top_bits<W>(rows, i, k, T) : (1 << T);
  const int prv = i > 0 ? row_top_bits<W>(rows, i - 1, k, T) : -1;
  for (int b = prv + 1; b <= cur; ++b) starts[b] = i;
}

// word j of search s's query in succ_words_kernel: s = 0 fwd, s = 1 + b
// yr_b = xr >> 2 | (3 - b) << ti in the top word (s and j are constants
// where it is called, so fwd and xr stay in registers)
template <int W>
static __device__ __forceinline__ uint32_t k5_qword(const Kmer<W>& fwd, const Kmer<W>& xr, int s,
                                                    int j, int ti) {
  if (s == 0) return fwd.w[j];
  const uint32_t v = (xr.w[j] >> 2) | (j + 1 < W ? xr.w[j + 1 < W ? j + 1 : j] << 30 : 0u);
  return j == W - 1 ? v | ((uint32_t)(4 - s) << ti) : v;
}

// succ_kernel over W-word rows: fwd = x << 2 (top word masked), yr_b =
// xr >> 2 | (3 - b) << 2(k-1), whose inserted base lies in the top word
// (k >= 16W - 15). The thread holds fwd and xr and makes a query's words
// where they are compared (k5_qword); a round loads each unfinished search's
// middle row's top word first, and the lower words only where the top
// words tie, a tie at a time (so that the five searches' state stays in
// registers at every W)
template <int W>
__global__ void __launch_bounds__(UT_THREADS)
succ_words_kernel(const uint32_t* __restrict__ rows, int M, int k, int T, uint32_t top,
                  const int32_t* __restrict__ starts, int32_t* __restrict__ succ,
                  uint8_t* __restrict__ outc) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= 2 * M) return;
  Kmer<W> fwd, xr;
  bool pal;
  {
    const Kmer<W> x0 = load_kmer<W>(rows, d >> 1);
    const Kmer<W> r0 = revcomp_w<W>(x0, k);
    pal = same_kmer(x0, r0);
    Kmer<W> x;  // word by word: a select of whole structs goes to the stack
#pragma unroll
    for (int j = 0; j < W; ++j) {
      x.w[j] = (d & 1) ? r0.w[j] : x0.w[j];
      xr.w[j] = (d & 1) ? x0.w[j] : r0.w[j];
    }
    fwd = shl2<W>(x, 0u, top);  // y_b = fwd | b
  }
  const int ti = (2 * (k - 1)) & 31;  // the inserted base's bit in the top word
  bool act[K5_SEARCHES];
  int lo[K5_SEARCHES], hi[K5_SEARCHES], hit[K5_SEARCHES];
  act[0] = false;
#pragma unroll
  for (int b = 0; b < 4; ++b) {  // yr_b < fwd | b, most significant word first
    int c = 0;
#pragma unroll
    for (int j = W - 1; j >= 0; --j) {
      const uint32_t q = k5_qword<W>(fwd, xr, 1 + b, j, ti);
      const uint32_t y = j ? fwd.w[j] : fwd.w[0] | (uint32_t)b;
      if (c == 0 && q != y) c = q < y ? -1 : 1;
    }
    act[1 + b] = c < 0;
    act[0] |= c >= 0;
  }
  // the top T <= 26 bits lie in the top two words (k >= 16W - 15): read
  // at fixed indices, as a word chosen by a runtime index would send fwd
  // and xr to local memory
  const int sh = 2 * k - T - 32 * (W - 2);
#pragma unroll
  for (int s = 0; s < K5_SEARCHES; ++s) {
    const uint64_t h = ((uint64_t)k5_qword<W>(fwd, xr, s, W - 1, ti) << 32) |
                       k5_qword<W>(fwd, xr, s, W - 2, ti);
    const int p = T ? (int)((h >> sh) & ((1u << T) - 1u)) : 0;
    lo[s] = act[s] ? __ldg(starts + p) : 0;
    hi[s] = act[s] ? __ldg(starts + p + 1) : 0;
    hit[s] = -1;
  }
  for (;;) {
    uint32_t tw[K5_SEARCHES];
    bool any = false;
#pragma unroll
    for (int s = 0; s < K5_SEARCHES; ++s) {
      const long long mid = (lo[s] + hi[s]) >> 1;
      tw[s] = lo[s] < hi[s] ? __ldg(rows + mid * W + (W - 1)) : 0u;
      any |= lo[s] < hi[s];
    }
    if (!any) break;
    unsigned ties = 0;  // the searches whose middle row's top word equals the query's
#pragma unroll
    for (int s = 0; s < K5_SEARCHES; ++s) {
      if (lo[s] < hi[s]) {
        const int mid = (lo[s] + hi[s]) >> 1;
        const uint32_t qt = k5_qword<W>(fwd, xr, s, W - 1, ti);
        if (tw[s] < qt) lo[s] = mid + 1;
        else if (tw[s] > qt) hi[s] = mid;
        else ties |= 1u << s;
      }
    }
    while (ties) {  // the lower words, one tie at a time (one copy of the compare)
      const int t = __ffs(ties) - 1;
      ties &= ties - 1;
      int mid = 0;
#pragma unroll
      for (int s = 0; s < K5_SEARCHES; ++s)
        if (s == t) mid = (lo[s] + hi[s]) >> 1;
      const uint32_t* r = rows + (long long)mid * W;
      int c = 0;
#pragma unroll
      for (int j = W - 2; j >= 0; --j) {
        if (c == 0) {
          const uint32_t a = __ldg(r + j), q = k5_qword<W>(fwd, xr, t, j, ti);
          if (a != q) c = a < q ? -1 : 1;
        }
      }
#pragma unroll
      for (int s = 0; s < K5_SEARCHES; ++s) {
        if (s == t) {
          if (c < 0) {
            lo[s] = mid + 1;
          } else {
            hi[s] = mid;
            if (c == 0) hit[s] = mid;
          }
        }
      }
    }
  }
  // the rows from fwd's lower bound: row t holds fwd | b[t] where its words
  // above the low two bits equal fwd's, compared from the top word; the
  // first row that differs ends the run of them (the rows are sorted)
  bool fm[4];
  uint32_t fb[4];
  bool go = act[0];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const long long j = (long long)lo[0] + t;
    fm[t] = false;
    fb[t] = 0;
    if (go && j < M) {
      const uint32_t* r = rows + j * W;
      bool same = true;
#pragma unroll
      for (int q = W - 1; q >= 1; --q) same = same && __ldg(r + q) == fwd.w[q];
      const uint32_t w0 = same ? __ldg(r) : 0u;
      fm[t] = same && (w0 & ~3u) == fwd.w[0];
      fb[t] = w0 & 3u;
    }
    go = fm[t];
  }
  int oc = 0, sc = -1;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int j = hit[1 + b];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (!act[1 + b] && fm[t] && fb[t] == (uint32_t)b) j = lo[0] + t;
    if (j >= 0 && ++oc == 1) sc = 2 * j + (int)act[1 + b];
  }
  succ[d] = sc;
  outc[d] = (uint8_t)(oc | (pal ? K5_PAL : 0));
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

// rows: (M, W) int32 u32 words; starts: (2^T + 1) int32
extern "C" int lt_unitig_buckets_words(const void* rows, int M, int W, int k, int T,
                                       void* starts, void* stream) {
  if (!words_k_ok(W, k) || M < 0 || !k5_bits_ok(k, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* r = (const uint32_t*)rows;
  int32_t* sp = (int32_t*)starts;
#define LAUNCH(W_)                                                                         \
  buckets_words_kernel<W_><<<ut_blocks((long long)M + 1), UT_THREADS, 0, st>>>(r, M, k, T, \
                                                                               sp)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// so: (5 * 2M) bytes of scratch (succ, then outc); nxt, prev: (2M,) int32
extern "C" int lt_unitig_links_words(const void* rows, int M, int W, int k, int T,
                                     const void* starts, void* so, void* nxt, void* prev,
                                     void* stream) {
  if (!words_k_ok(W, k) || M <= 0 || !k5_bits_ok(k, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = 2 * M;
  const uint32_t* r = (const uint32_t*)rows;
  const int32_t* sp = (const int32_t*)starts;
  const uint32_t top = top_mask_of(k);
  int32_t* succ = (int32_t*)so;
  uint8_t* outc = (uint8_t*)(succ + N);
#define LAUNCH(W_)                                                                  \
  succ_words_kernel<W_><<<ut_blocks(N), UT_THREADS, 0, st>>>(r, M, k, T, top, sp, succ, \
                                                             outc)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  LT_TRY(cudaGetLastError());
  link_kernel<<<ut_blocks(M), UT_THREADS, 0, st>>>(M, (const int2*)succ, outc, (int2*)nxt,
                                                   (int2*)prev);
  return (int)cudaGetLastError();
}

// rows: (M, W) int32 u32 words; the rest as lt_unitig_emit
extern "C" int lt_unitig_emit_words(const void* rows, int N, int W, int k, const void* S,
                                    const void* nxt, const void* prev, int acyclic, int cap,
                                    long long cap_bases, int key_bits, void* work,
                                    long long work_words, void* buf, void* stream) {
  if (!em_args_ok(N, cap, cap_bases) || !words_k_ok(W, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(W_)                                                                         \
  return em_launch_keys<W_, false>(key_bits, rows, N, k, S, nxt, prev, acyclic, cap, cap_bases, \
                                   work, work_words, buf, st)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
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
