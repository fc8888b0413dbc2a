// K9-K12 — the de Bruijn graph API's device programs: the bitset-word
// gather, the classic/blocked Bloom probe with its neighbour modes, the
// simple-path walk and the bubble-crossing traversal.
//
// Replace (leon_tpu, jitted XLA / Pallas programs):
//   K9  gather_words  scripts/probe_pallas_gather.py pallas_gather (41-63)
//                     and pallas_gather2d (66-93): table[idx], the table
//                     whole in VMEM;
//   K10 dbg_probe     ops/bloom.py probe (383-386) and probe_classic
//                     (257-262, wordbit_classic_from_hashes 225-244,
//                     probe_wordbit 369-374), and graph.py DBG.contains /
//                     successors / predecessors (49-72): hash_words from
//                     scratch, then one masked word (blocked) or H
//                     (word, bit) pairs by double hashing (classic);
//   K11 dbg_walk      graph.py DBG.walk (87-113): a lax.scan of max_steps
//                     unique-successor steps;
//   K12 dbg_traverse  graph.py DBG.traverse (125-237): per outer step a
//                     D-step simple walk on up to 4 branches, the
//                     convergence test and the ragged compaction.
//
// k-mers are W = ceil(k/16) little-endian u32 words (FORMAT.md §3), base
// i of the k-mer at bits 2(k-1-i); K10 and K12 are templated on W in 1..16
// (k <= 255), K11 takes W at run time.
//
// Bound on the H100: K9 by its random 4-byte table loads, which hit the 50
// MB L2 (2**24 of them take 0.118-0.128 ms alone, against 0.046-0.050 ms
// for its index and output stream: scripts/gather_floor.cu, timed by
// scripts/ab_kernels.py --only gather; K9 reaches 0.87-0.89 of that floor);
// K10-K12 by their Bloom probes, random 4-byte loads into a bitset of a few
// MB that stays in the L2 (the probe floor: scripts/graph_probe_floor.cu,
// timed by scripts/ab_kernels.py --only graph). K11 and K12 are chains of
// dependent probes (each step needs the last one's base), hidden by many
// lanes per SM.
//
// Design. A node is hashed once, a word at a time from K16's nibble tables
// in shared memory (hash_kmer_tab: 8 table loads a word, the top word masked
// to 2k bits, so it reads the k bases the reference's hash_words reads), and
// its neighbours' pairs are ROLLED from its (f, r) (tables [T, Tc, Trot,
// Tcrot] for this k):
//   out (shl2, o the leaving first base, c the new last base):
//     f' = rol1(f ^ Trot[o]) ^ T[c],   r' = ror1(r ^ Tc[o]) ^ Tcrot[c];
//   in (shr2_ins, l the leaving last base, c' the new first base):
//     f' = ror1(f ^ T[l]) ^ Trot[c'], r' = rol1(r ^ Tcrot[l]) ^ Tc[c'],
// where c' is base 0 of the shifted words, not c: shr2_ins does not mask,
// so where 2k < 32W the caller's bits 2k..2k+1 land in base 0 ORed with c.
// Each equals the reference's from-scratch hash of the neighbour's words.
// Classic probes of several candidates run in rounds, all of a round's
// loads in flight together: K10's round i loads hash i of every candidate
// still alive (the early exit's loads, H round trips at most); K12's first
// round loads hash 0 and each later one the next three hashes of every
// survivor (two round trips at H = 4, for a few more loads), since K12
// waits on its chains, not on its loads; K11's rounds are K10's. K12 gives
// a lane four threads: at a node each probes one successor, in a bubble
// each holds one branch and probes its four successors, and the loop takes
// one probe step a lane whatever the lane is doing, so a lane in a bubble
// never holds its warp's other lanes for the bubble's whole depth. It stops
// a bubble at the first converged depth or when every branch has died, and
// writes, at each depth, the live branches' bases packed in one byte of its
// row where the chosen branch's bases go; at convergence it keeps the
// chosen branch's two bits of each byte (no re-walk). A block's rows are one
// contiguous region that it zero-fills in 16-byte stores before its lanes
// write the bases they emit; its size follows the lane count, so that
// small launches spread over every SM.
#include "common.cuh"
#include "kmer_words.cuh"

#define GRAPH_THREADS 256

// argmax over 4 bools: the first set base, 0 when none is set
static __device__ __forceinline__ uint32_t first_set(unsigned m) {
  return m ? (uint32_t)(__ffs(m) - 1) : 0u;
}

static __device__ __forceinline__ uint32_t pick4(const uint32_t v[4], uint32_t i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// ---------------------------------------------------------------------------
// K9 gather_words: out[i] = table[idx[i]] with JAX's index rule (a
// negative index counts from the end, then clamps into [0, n)), which is
// table[idx] for every in-range index and never reads out of bounds. A
// thread an index: its table loads are the floor's (above), and 65,536
// blocks keep enough of them in flight. (Groups of four indices a thread
// in 16-byte evict-first loads, eight table loads in flight and 16-byte
// streaming stores over the resident blocks took 3% longer; the same
// thread an index with only the evict-first and streaming hints, the
// same time: PERF.md §6, rows 1-2.)
// ---------------------------------------------------------------------------

__global__ void gather_words_kernel(const uint32_t* __restrict__ table, long long n,
                                    const int32_t* __restrict__ idx, long long M,
                                    uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  long long j = __ldg(idx + i);
  if (j < 0) j += n;
  j = j < 0 ? 0 : (j >= n ? n - 1 : j);
  out[i] = __ldg(table + j);
}

extern "C" int lt_gather_words(const void* table, long long n, const void* idx, long long M,
                               void* out, void* stream) {
  if (n <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const long long blocks = (M + GRAPH_THREADS - 1) / GRAPH_THREADS;
  gather_words_kernel<<<(unsigned)blocks, GRAPH_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, n, (const int32_t*)idx, M, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Probes of several candidates with their loads in flight together
// ---------------------------------------------------------------------------

// classic membership of the N candidates (f[c], r[c]) whose bit c of `want`
// is set -> bit c = candidate c is a member. Round 0 loads hash 0 of every
// candidate, each later round the next G hashes of every candidate still
// alive (predicated loads, all of a round in flight); a candidate whose bit
// is clear leaves. G = 1 makes the early exit's loads (probe_classic's); a
// larger G trades a few loads for fewer dependent rounds (H = 4, G = 3: two)
template <int N, int G>
static __device__ __forceinline__ unsigned probe_classic_n(const uint32_t* __restrict__ bits,
                                                           const uint32_t* f,
                                                           const uint32_t* r, unsigned want,
                                                           int H, uint32_t n_words) {
  uint32_t h1[N], h2[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    h1[c] = min(f[c], r[c]);
    h2[c] = max(f[c], r[c]) | 1u;
  }
  unsigned alive = want;
  for (int i = 0; i < H && alive; i += (i ? G : 1)) {
    const int n = i ? G : 1;  // hashes i .. i + n - 1 this round
    uint32_t v[G][N];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const uint32_t g = h1[c] + (uint32_t)(i + j) * h2[c];
        v[j][c] = j < n && i + j < H && (alive >> c) & 1u ? __ldg(bits + __umulhi(g, n_words))
                                                          : ~0u;
      }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const uint32_t g = h1[c] + (uint32_t)(i + j) * h2[c];
        if (!((v[j][c] >> (g & 31u)) & 1u)) alive &= ~(1u << c);
      }
  }
  return alive;
}

// blocked membership of 4 candidates: one word each, the 4 loads in flight
static __device__ __forceinline__ unsigned probe_blocked_4(const uint32_t* __restrict__ bits,
                                                           const uint32_t* f,
                                                           const uint32_t* r, int H,
                                                           uint32_t n_words) {
  uint32_t wi[4], m[4], v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wordmask(f[c], r[c], H, n_words, &wi[c], &m[c]);
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = __ldg(bits + wi[c]);
  unsigned o = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) o |= (unsigned)((v[c] & m[c]) == m[c]) << c;
  return o;
}

// the rolled pairs of the 4 shl2 successors of a node (f, r) whose first
// base is o (see the header)
static __device__ __forceinline__ void roll_out(uint32_t f, uint32_t r, int o,
                                                const HashTabs& tb, uint32_t cf[4],
                                                uint32_t cr[4]) {
  const uint32_t fb = rol1(f ^ sel4(tb.t[2], o));
  const uint32_t rb = ror1(r ^ sel4(tb.t[1], o));
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cf[c] = fb ^ tb.t[0][c];
    cr[c] = rb ^ tb.t[3][c];
  }
}

// the rolled pairs of the 4 shr2_ins predecessors of a node a (f, r)
template <int W>
static __device__ __forceinline__ void roll_in(const Kmer<W>& a, uint32_t f, uint32_t r, int k,
                                               const HashTabs& tb, uint32_t cf[4],
                                               uint32_t cr[4]) {
  const int l = (int)(a.w[0] & 3u);
  // the caller's bits 2k..2k+1 that shr2_ins ORs into base 0 (0 where 2k = 32W)
  const int dirty = base_of(shr2_ins<W>(a, 0u, k), 0, k);
  const uint32_t fb = ror1(f ^ sel4(tb.t[0], l));
  const uint32_t rb = rol1(r ^ sel4(tb.t[3], l));
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cf[c] = fb ^ sel4(tb.t[2], c | dirty);
    cr[c] = rb ^ sel4(tb.t[1], c | dirty);
  }
}

// ---------------------------------------------------------------------------
// K10 dbg_probe: mode 0 = the row itself -> out (N,), mode 1 = its 4 shl2
// neighbours, mode 2 = its 4 shr2_ins neighbours -> out (N, 4); out is
// bool storage (one byte, 0 or 1). A grid of the card's resident blocks,
// each building the nibble tables once and walking rows grid-stride; a row
// is hashed once, its neighbours rolled.
// ---------------------------------------------------------------------------

template <int W, bool CLASSIC>
__global__ void __launch_bounds__(GRAPH_THREADS)
    dbg_probe_kernel(const uint32_t* __restrict__ words, long long N, int mode, int k,
                     uint32_t top, uint32_t padf, uint32_t padr, bool vec,
                     const __grid_constant__ HashTabs tabs, const uint32_t* __restrict__ bits,
                     int H, uint32_t n_words, uint8_t* __restrict__ out) {
  __shared__ NibbleTabs tab;
  build_nibble_tabs(tabs, tab);
  __syncthreads();
  const long long step = (long long)gridDim.x * GRAPH_THREADS;
  for (long long row = (long long)blockIdx.x * GRAPH_THREADS + threadIdx.x; row < N;
       row += step) {
    const Kmer<W> a = load_kmer_vec<W>(words, row, vec);
    uint32_t f, r;
    hash_kmer_tab<W>(a, k, top, padf, padr, tab, &f, &r);
    if (mode == 0) {
      out[row] = CLASSIC ? (uint8_t)probe_classic_n<1, 1>(bits, &f, &r, 1u, H, n_words)
                         : (uint8_t)probe(bits, f, r, H, n_words);
      continue;
    }
    uint32_t cf[4], cr[4];
    if (mode == 1)
      roll_out(f, r, base_of(a, 0, k), tabs, cf, cr);
    else
      roll_in<W>(a, f, r, k, tabs, cf, cr);
    const unsigned m = CLASSIC ? probe_classic_n<4, 1>(bits, cf, cr, 0xFu, H, n_words)
                               : probe_blocked_4(bits, cf, cr, H, n_words);
    // the row's 4 bools, byte c = base c
    reinterpret_cast<uint32_t*>(out)[row] =
        (m & 1u) | ((m >> 1) & 1u) << 8 | ((m >> 2) & 1u) << 16 | (m >> 3) << 24;
  }
}

// ---------------------------------------------------------------------------
// K11 dbg_walk (graph.py:87-113): at each of S steps follow the unique
// successor; bases[:, s] is the argmax of the step's successors (it repeats
// once the lane has stopped: the frozen node's successors do not change),
// n the number of steps taken before the first step whose degree != 1.
//
// Width-free: a lane's state is its (f, r), a ring of bases and two ring
// positions, whatever W. The ring is the node's sequence: column c (the
// start node's base c for c < k, the base walked at step c - k after it) at
// bit-pair (k - 1 - c) mod 16RW of RW = W + 1 words in shared memory, so
// that the start node's words go in as they are (word j = ring word j; its
// bits above 2k are never read before a walked base replaces them) and a
// step reads its leaving first base, column s, k columns behind the base it
// writes. The walked bases build a word in a register, stored when it is
// whole; at k < 16 the leaving base may lie in that word. The start node is
// hashed once from K16's nibble tables, a word at a time; a step rolls its
// 4 candidates' pairs and probes them in rounds of one hash each (the early
// exit's loads: three hashes a round after the first, and four threads a
// lane, were slower on the H100 at W = 2, 8 and 16; PERF.md §6). A row's
// bytes go out in 16-byte stores (RowChunks). The card's resident blocks
// walk the rows grid-stride, each building the tables once.
// ---------------------------------------------------------------------------

// (f, r) of the W words at w (ring words, a word every `stride`), top word
// masked to 2k bits, from the nibble tables (kmer_words.cuh hash_kmer_tab,
// with W a runtime count)
static __device__ __forceinline__ void hash_ring_tab(const uint32_t* w, int stride, int W, int k,
                                                     uint32_t top, uint32_t padf, uint32_t padr,
                                                     const NibbleTabs& tab, uint32_t* f,
                                                     uint32_t* r) {
  const int c = threadIdx.x & 15;
  uint32_t fe = padf, re = padr, fo = 0, ro = 0;
  for (int j = 0; j < W; ++j) {
    uint32_t gf = 0, gr = 0;
    nibble_terms(j == W - 1 ? w[j * stride] & top : w[j * stride], tab, c, &gf, &gr);
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

// Shared memory: the nibble tables, then a ring of RW words a thread (word
// i of thread t at ring[i * GRAPH_THREADS + t]).
__global__ void __launch_bounds__(GRAPH_THREADS)
    dbg_walk_kernel(const uint32_t* __restrict__ words, long long N, int W, int S, int k,
                    uint32_t top, uint32_t padf, uint32_t padr,
                    const __grid_constant__ HashTabs tabs, const uint32_t* __restrict__ bits,
                    int H, uint32_t n_words, int RW, uint8_t* __restrict__ bases,
                    int32_t* __restrict__ n_out) {
  __shared__ NibbleTabs tab;
  extern __shared__ uint32_t ring_smem[];
  build_nibble_tabs(tabs, tab);
  __syncthreads();
  uint32_t* ring = ring_smem + threadIdx.x;
  const int M = 16 * RW;  // bit-pairs in the ring
  const long long step = (long long)gridDim.x * GRAPH_THREADS;
  for (long long row = (long long)blockIdx.x * GRAPH_THREADS + threadIdx.x; row < N;
       row += step) {
    const uint32_t* wr = words + row * W;
    for (int j = 0; j < W; ++j) ring[j * GRAPH_THREADS] = __ldg(wr + j);
    uint32_t f, r;
    hash_ring_tab(ring, GRAPH_THREADS, W, k, top, padf, padr, tab, &f, &r);
    RowChunks<uint8_t> out(bases + row * (long long)S, S);
    int rp = k - 1, wp = M - 1;  // the pairs of the leaving base and of the next walked one
    uint32_t acc = 0;            // walked bases of ring word wp >> 4 so far
    int s = 0;
    uint32_t u = 0;
    for (; s < S; ++s) {
      const uint32_t wv = (rp >> 4) == (wp >> 4) ? acc : ring[(rp >> 4) * GRAPH_THREADS];
      uint32_t cf[4], cr[4];
      roll_out(f, r, (int)((wv >> (2 * (rp & 15))) & 3u), tabs, cf, cr);
      const unsigned m = probe_classic_n<4, 1>(bits, cf, cr, 0xFu, H, n_words);
      u = first_set(m);
      out.put(s, u);
      if (__popc(m) != 1) break;
      f = pick4(cf, u);
      r = pick4(cr, u);
      acc |= u << (2 * (wp & 15));
      if ((wp & 15) == 0) {
        ring[(wp >> 4) * GRAPH_THREADS] = acc;
        acc = 0;
      }
      wp = wp ? wp - 1 : M - 1;
      rp = rp ? rp - 1 : M - 1;
    }
    n_out[row] = s;
    out.fill(s + 1, u);
  }
}

// ---------------------------------------------------------------------------
// K12 dbg_traverse (graph.py:125-237), four threads a lane (below). An
// outer step from node cur with successor mask m:
//   deg 1: emit the base, advance;
//   deg >= 2: branch c (m bit c) starts at shl2(cur, c) and takes simple
//     steps (a branch dies at a node whose degree != 1 and never resumes);
//     depth d (0-based, after d+1 steps) converges when a branch is alive
//     and every live branch sits on the same node (all W words). At the
//     first converged depth d*, emit cbr = the first live branch, then its
//     d*+1 step bases, and continue from its node; no convergence within D
//     steps stops the lane;
//   deg 0: the lane stops.
// A stopped lane emits nothing more. Output row: the emitted bases, zeros
// after them; n the count. Depth d's byte (pos + 1 + d, inside the row: an
// outer step emits at most D + 2 bytes) holds the live branches' bases,
// branch c at bits 2c; at d* the chosen branch's bits are kept, and a lane
// that does not converge writes those bytes back to zero.
// ---------------------------------------------------------------------------

// keep branch cbr's two bits of each of the n depth bytes at p (the lane's
// own stores): the loads go 8 at a time, in flight together
static __device__ __forceinline__ void keep_branch(uint8_t* p, int n, int cbr) {
  for (int i = 0; i < n; i += 8) {
    uint8_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = i + j < n ? p[i + j] : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i + j < n) p[i + j] = (uint8_t)((v[j] >> (2 * cbr)) & 3u);
  }
}

// Four threads a lane (a quad): at a node (d < 0) all four hold it and
// thread q probes its successor by base q; in a bubble thread q holds branch
// q (slot q) and probes its 4 successors. One loop iteration is one probe
// step of the lane, so a lane in a bubble holds up the other lanes of its
// warp only for its own steps, and a lane's work spreads over four threads
// (four times the warps to hide the probes' latency). The quad shares the
// successor masks and the convergence test by shuffles; its decisions are
// the same in its four threads. Thread 0 writes the row.
#define K12_QUAD 4
#define K12_GROUP 3  // hashes a probe round loads after the first (probe_classic_n)

template <typename T>
static __device__ __forceinline__ T quad_shfl(unsigned qmask, T v, int src) {
  return __shfl_sync(qmask, v, src, K12_QUAD);
}

template <int W>
__global__ void __launch_bounds__(GRAPH_THREADS)
    dbg_traverse_kernel(const uint32_t* __restrict__ words, long long N, int S, int D, int k,
                        uint32_t top, uint32_t padf, uint32_t padr,
                        const __grid_constant__ HashTabs tabs,
                        const uint32_t* __restrict__ bits, int H, uint32_t n_words,
                        uint8_t* __restrict__ out, int32_t* __restrict__ n_out) {
  __shared__ NibbleTabs tab;
  build_nibble_tabs(tabs, tab);
  const long long cap = (long long)S * (D + 2);
  const long long row0 = (long long)blockIdx.x * (blockDim.x / K12_QUAD);
  const long long rows = min((long long)(blockDim.x / K12_QUAD), N - row0);
  zero_region(out + row0 * cap, rows * cap);
  __syncthreads();
  const int q = threadIdx.x % K12_QUAD;
  const long long row = row0 + threadIdx.x / K12_QUAD;
  if (row >= N) return;  // whole quads
  const unsigned qmask = 0xFu << ((threadIdx.x & 31) & ~3);
  uint8_t* o = out + row * cap;
  Kmer<W> node = load_kmer<W>(words, row);  // the node, or in a bubble branch q's (if live)
  uint32_t f, r;
  hash_kmer_tab<W>(node, k, top, padf, padr, tab, &f, &r);
  unsigned live = 1u;  // slots in use
  long long pos = 0;
  int s = 0, d = -1, reached = 0;  // outer step; bubble depth (-1: at a node); depth bytes
  while (s < S) {
    uint32_t cf[4], cr[4];
    if (d < 0) {  // an outer step from the node, held by all four: thread q probes base q
      roll_out(f, r, base_of(node, 0, k), tabs, cf, cr);
      const uint32_t fq = pick4(cf, q), rq = pick4(cr, q);
      const unsigned hit = probe_classic_n<1, K12_GROUP>(bits, &fq, &rq, 1u, H, n_words);
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < K12_QUAD; ++j) m |= quad_shfl(qmask, hit, j) << j;
      const int deg = __popc(m);
      if (deg == 0) break;
      if (deg == 1) {
        const uint32_t u = first_set(m);
        if (q == 0) o[pos] = (uint8_t)u;
        node = shl2<W>(node, u, top);
        f = pick4(cf, u);
        r = pick4(cr, u);
        ++pos;
        ++s;
        continue;
      }
      if (D <= 0) break;
      node = shl2<W>(node, (uint32_t)q, top);  // a bubble: branch q starts at shl2(node, q)
      f = fq;
      r = rq;
      live = m;
      d = 0;
      reached = 0;
      continue;
    }
    unsigned mq = 0;  // slot q's successors
    if ((live >> q) & 1u) {
      roll_out(f, r, base_of(node, 0, k), tabs, cf, cr);
      mq = probe_classic_n<4, K12_GROUP>(bits, cf, cr, 0xFu, H, n_words);
    }
    unsigned mm = 0;  // slot c's at bits 4c..4c+3
#pragma unroll
    for (int j = 0; j < K12_QUAD; ++j) mm |= quad_shfl(qmask, mq, j) << (4 * j);
    // depth d: each live branch takes its unique successor or dies
    unsigned next = 0, packed = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned mc = (mm >> (4 * c)) & 0xFu;
      if ((live >> c) & 1u && __popc(mc) == 1) {
        next |= 1u << c;
        packed |= first_set(mc) << (2 * c);
      }
    }
    if ((next >> q) & 1u) {
      const uint32_t u = first_set(mq);
      node = shl2<W>(node, u, top);
      f = pick4(cf, u);
      r = pick4(cr, u);
    }
    live = next;
    if (!live) break;
    if (q == 0) o[pos + 1 + d] = (uint8_t)packed;
    reached = d + 1;
    const int first = __ffs(live) - 1;
    unsigned eq = 1u;  // every live branch on the first one's node
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint32_t ref = quad_shfl(qmask, node.w[j], first);
      eq &= !((live >> q) & 1u) || node.w[j] == ref;
    }
    eq &= __shfl_xor_sync(qmask, eq, 1, K12_QUAD);
    eq &= __shfl_xor_sync(qmask, eq, 2, K12_QUAD);
    if (eq) {
      // emit cbr = the first live branch and its d+1 step bases; go on from
      // its node, in slot 0
      if (q == 0) {
        o[pos] = (uint8_t)first;
        keep_branch(o + pos + 1, d + 1, first);
      }
      pos += d + 2;
#pragma unroll
      for (int j = 0; j < W; ++j) node.w[j] = quad_shfl(qmask, node.w[j], first);
      f = quad_shfl(qmask, f, first);
      r = quad_shfl(qmask, r, first);
      live = 1u;
      d = -1;
      ++s;
      continue;
    }
    if (++d == D) break;
  }
  if (q == 0) {
    if (d >= 0)  // a bubble that did not converge: its depth bytes back to zero
      for (int t = 0; t < reached; ++t) o[pos + 1 + t] = 0;
    n_out[row] = (int32_t)pos;
  }
}

// ---------------------------------------------------------------------------
// C entry points (launch on the given stream, allocate nothing, return
// cudaGetLastError())
// ---------------------------------------------------------------------------

static bool graph_args_ok(int W, int k, int H, unsigned n_words) {
  return W >= 1 && W <= 16 && k > 16 * (W - 1) && k <= 16 * W && H >= 1 && n_words > 0;
}

static unsigned graph_blocks(long long N) {
  return (unsigned)((N + GRAPH_THREADS - 1) / GRAPH_THREADS);
}

// as many blocks as are resident on the card at once (each builds the
// tables once), or fewer for a small N
template <typename F>
static cudaError_t resident_grid(F kern, long long N, unsigned* grid) {
  static int resident = 0;  // per instance: blocks of it the card holds at once
  if (!resident) {
    const cudaError_t e = resident_blocks(kern, GRAPH_THREADS, &resident);
    if (e != cudaSuccess) return e;
  }
  *grid = (unsigned)min((long long)graph_blocks(N), (long long)resident);
  return cudaSuccess;
}

template <int W>
static cudaError_t launch_probe(const void* words, long long N, int mode, int classic, int k,
                                unsigned top, const HashTabs& tb, const void* bitset, int H,
                                unsigned n_words, void* out, cudaStream_t st) {
  uint32_t padf, padr;
  nibble_tab_pads(tb, k, W, &padf, &padr);
  const int align = W % 4 == 0 ? 16 : 8;
  const bool vec = (reinterpret_cast<uintptr_t>(words) % align) == 0;
  const uint32_t* w = (const uint32_t*)words;
  const uint32_t* b = (const uint32_t*)bitset;
  uint8_t* o = (uint8_t*)out;
  unsigned grid;
  cudaError_t e;
  if (classic) {
    if ((e = resident_grid(dbg_probe_kernel<W, true>, N, &grid)) != cudaSuccess) return e;
    dbg_probe_kernel<W, true><<<grid, GRAPH_THREADS, 0, st>>>(w, N, mode, k, top, padf, padr,
                                                              vec, tb, b, H, n_words, o);
  } else {
    if ((e = resident_grid(dbg_probe_kernel<W, false>, N, &grid)) != cudaSuccess) return e;
    dbg_probe_kernel<W, false><<<grid, GRAPH_THREADS, 0, st>>>(w, N, mode, k, top, padf, padr,
                                                               vec, tb, b, H, n_words, o);
  }
  return cudaGetLastError();
}

extern "C" int lt_dbg_probe(const void* words, long long N, int W, int mode, int classic,
                            int k, unsigned top, const void* tabs16, const void* bitset, int H,
                            unsigned n_words, void* out, void* stream) {
  if (!graph_args_ok(W, k, H, n_words) || mode < 0 || mode > 2 || N < 0 ||
      (!classic && H > 8))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define LAUNCH(W_) \
  e = launch_probe<W_>(words, N, mode, classic, k, top, tb, bitset, H, n_words, out, st)
  switch (W) {
    LT_W_CASE(1, LAUNCH)
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)e;
}

extern "C" int lt_dbg_walk(const void* words, long long N, int W, int S, int k, unsigned top,
                           const void* tabs16, const void* bitset, int H, unsigned n_words,
                           void* bases, void* n, void* stream) {
  if (!graph_args_ok(W, k, H, n_words) || N < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0) return (int)cudaMemsetAsync(n, 0, (size_t)N * sizeof(int32_t), st);
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  uint32_t padf, padr;
  nibble_tab_pads(tb, k, W, &padf, &padr);
  const int RW = W + 1;  // 16(W + 1) >= k + 16 bit-pairs: a word between reader and writer
  const size_t smem = (size_t)RW * GRAPH_THREADS * sizeof(uint32_t);
  static int resident[17];  // blocks the card holds at once, by W
  if (!resident[W]) {
    const cudaError_t e =
        resident_blocks(dbg_walk_kernel, GRAPH_THREADS, &resident[W], 1 << 30, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)min((long long)graph_blocks(N), (long long)resident[W]);
  dbg_walk_kernel<<<grid, GRAPH_THREADS, smem, st>>>(
      (const uint32_t*)words, N, W, S, k, top, padf, padr, tb, (const uint32_t*)bitset, H,
      n_words, RW, (uint8_t*)bases, (int32_t*)n);
  return (int)cudaGetLastError();
}

// K12's block size: the largest of 256, 128, 64, 32 threads (a quad a lane)
// that still gives two blocks an SM (a lane count too small for that takes
// 32), so a small launch spreads over every SM; a block zero-fills its rows'
// region
static unsigned traverse_threads(long long N) {
  static int sms = 0;  // the card's SMs (256-thread blocks until it is known)
  int dev = 0;
  if (!sms && cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  unsigned t = GRAPH_THREADS;
  while (t > 32 && (K12_QUAD * N + t - 1) / t < 2LL * sms) t >>= 1;
  return t;
}

template <int W>
static void launch_traverse(const void* words, long long N, int S, int D, int k, unsigned top,
                            const HashTabs& tb, const void* bitset, int H, unsigned n_words,
                            void* out, void* n, cudaStream_t st) {
  uint32_t padf, padr;
  nibble_tab_pads(tb, k, W, &padf, &padr);
  const unsigned t = traverse_threads(N), lanes = t / K12_QUAD;
  dbg_traverse_kernel<W><<<(unsigned)((N + lanes - 1) / lanes), t, 0, st>>>(
      (const uint32_t*)words, N, S, D, k, top, padf, padr, tb, (const uint32_t*)bitset, H,
      n_words, (uint8_t*)out, (int32_t*)n);
}

extern "C" int lt_dbg_traverse(const void* words, long long N, int W, int S, int D, int k,
                               unsigned top, const void* tabs16, const void* bitset, int H,
                               unsigned n_words, void* out, void* n, void* stream) {
  if (!graph_args_ok(W, k, H, n_words) || N < 0 || S < 0 || D < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0) return (int)cudaMemsetAsync(n, 0, (size_t)N * sizeof(int32_t), st);
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
#define LAUNCH(W_) \
  launch_traverse<W_>(words, N, S, D, k, top, tb, bitset, H, n_words, out, n, st)
  switch (W) {
    LT_W_CASE(1, LAUNCH)
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
