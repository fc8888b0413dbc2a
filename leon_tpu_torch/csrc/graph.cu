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
// i of the k-mer at bits 2(k-1-i); every kernel is templated on W in
// 1..16 (k <= 255).
//
// Bound on the H100: K9 and K10 move their inputs and outputs once (bytes
// over 3.35 TB/s), their gathers hit a bitset of a few MB that stays in
// the 50 MB L2. K11 and K12 are chains of dependent probes (4 candidates x
// H words per step, each step needing the last one's base): latency bound,
// hidden by many lanes per SM. Design: one thread per row / lane with the
// k-mer words and its (f, r) hash pair in registers; plain __ldg gathers
// into the bitset. K10 hashes every candidate from scratch (one step, so
// from-scratch costs 4k table lookups and keeps dirty high bits of the
// caller's words exactly as the reference treats them); K11 and K12 hash
// the start node from scratch and then ROLL the pair forward (walk.cu's
// identity: candidate c of a node whose first base is o has
// f' = rol1(f ^ Trot[o]) ^ T[c], r' = ror1(r ^ Tc[o]) ^ Tcrot[c]), equal to
// the reference's from-scratch hash of the shifted node. K12 keeps the 4
// branch nodes in registers, stops its inner loop at the first converged
// depth or when every branch has died, and re-walks the chosen branch to
// emit its bases instead of storing 4 x D bases per lane.
#include "common.cuh"
#include "kmer_words.cuh"

#define GRAPH_THREADS 256

// ---------------------------------------------------------------------------
// classic addressing (ops/bloom.py wordbit_classic_from_hashes 225-244):
// g_i = h1 + i*h2 (mod 2^32), h1 = min(f, r), h2 = max(f, r) | 1; word
// mulhi32(g_i, n_words), bit g_i & 31; member iff all H bits are set
// ---------------------------------------------------------------------------

static __device__ __forceinline__ bool probe_classic(const uint32_t* __restrict__ bits,
                                                     uint32_t f, uint32_t r, int H,
                                                     uint32_t n_words) {
  const uint32_t h1 = min(f, r), h2 = max(f, r) | 1u;
  for (int i = 0; i < H; ++i) {
    const uint32_t g = h1 + (uint32_t)i * h2;
    if (!((__ldg(bits + __umulhi(g, n_words)) >> (g & 31u)) & 1u)) return false;
  }
  return true;
}

template <bool CLASSIC>
static __device__ __forceinline__ bool member(const uint32_t* __restrict__ bits, uint32_t f,
                                              uint32_t r, int H, uint32_t n_words) {
  return CLASSIC ? probe_classic(bits, f, r, H, n_words) : probe(bits, f, r, H, n_words);
}

// the 4 forward candidates of a node whose pair is (f, r): rolled pairs
// (see the header) and their classic solidity mask, bit c = base c solid
template <int W>
static __device__ __forceinline__ unsigned succ_rolled(const Kmer<W>& a, uint32_t f,
                                                       uint32_t r, int k, const HashTabs& tb,
                                                       const uint32_t* __restrict__ bits,
                                                       int H, uint32_t n_words,
                                                       uint32_t cf[4], uint32_t cr[4]) {
  const int o = base_of(a, 0, k);
  const uint32_t fb = rol1(f ^ sel4(tb.t[2], o));
  const uint32_t rb = ror1(r ^ sel4(tb.t[1], o));
  unsigned m = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cf[c] = fb ^ tb.t[0][c];
    cr[c] = rb ^ tb.t[3][c];
    if (probe_classic(bits, cf[c], cr[c], H, n_words)) m |= 1u << c;
  }
  return m;
}

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
// table[idx] for every in-range index and never reads out of bounds
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
// K10 dbg_probe: mode 0 = the row itself -> out (N,), mode 1 = its 4 shl2
// neighbours, mode 2 = its 4 shr2_ins neighbours -> out (N, 4); out is
// bool storage (one byte, 0 or 1)
// ---------------------------------------------------------------------------

template <int W, bool CLASSIC>
__global__ void dbg_probe_kernel(const uint32_t* __restrict__ words, long long N, int mode,
                                 int k, uint32_t top, const __grid_constant__ HashTabs tabs,
                                 const uint32_t* __restrict__ bits, int H, uint32_t n_words,
                                 uint8_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const Kmer<W> a = load_kmer<W>(words, row);
  uint32_t f, r;
  if (mode == 0) {
    hash_kmer<W>(a, k, tabs, &f, &r);
    out[row] = member<CLASSIC>(bits, f, r, H, n_words);
    return;
  }
  uint32_t o = 0;  // the row's 4 bools, byte c = base c
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const Kmer<W> b = mode == 1 ? shl2<W>(a, (uint32_t)c, top) : shr2_ins<W>(a, (uint32_t)c, k);
    hash_kmer<W>(b, k, tabs, &f, &r);
    o |= (uint32_t)member<CLASSIC>(bits, f, r, H, n_words) << (8 * c);
  }
  reinterpret_cast<uint32_t*>(out)[row] = o;
}

// ---------------------------------------------------------------------------
// K11 dbg_walk (graph.py:87-113): at each of S steps follow the unique
// successor; bases[:, s] is the argmax of the step's successors (it repeats
// once the lane has stopped: the frozen node's successors do not change),
// n the number of steps taken before the first step whose degree != 1
// ---------------------------------------------------------------------------

template <int W>
__global__ void dbg_walk_kernel(const uint32_t* __restrict__ words, long long N, int S, int k,
                                uint32_t top, const __grid_constant__ HashTabs tabs,
                                const uint32_t* __restrict__ bits, int H, uint32_t n_words,
                                uint8_t* __restrict__ bases, int32_t* __restrict__ n_out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  Kmer<W> cur = load_kmer<W>(words, row);
  uint32_t f, r, cf[4], cr[4];
  hash_kmer<W>(cur, k, tabs, &f, &r);
  uint8_t* out = bases + row * (long long)S;
  int s = 0;
  uint32_t u = 0;
  for (; s < S; ++s) {
    const unsigned m = succ_rolled<W>(cur, f, r, k, tabs, bits, H, n_words, cf, cr);
    u = first_set(m);
    out[s] = (uint8_t)u;
    if (__popc(m) != 1) break;
    cur = shl2<W>(cur, u, top);
    f = pick4(cf, u);
    r = pick4(cr, u);
  }
  n_out[row] = s;
  for (int t = s + 1; t < S; ++t) out[t] = (uint8_t)u;
}

// ---------------------------------------------------------------------------
// K12 dbg_traverse (graph.py:125-237), one thread per lane. An outer step
// from node cur with successor mask m:
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
// after them; n the count.
// ---------------------------------------------------------------------------

template <int W>
__global__ void dbg_traverse_kernel(const uint32_t* __restrict__ words, long long N, int S,
                                    int D, int k, uint32_t top,
                                    const __grid_constant__ HashTabs tabs,
                                    const uint32_t* __restrict__ bits, int H, uint32_t n_words,
                                    uint8_t* __restrict__ out, int32_t* __restrict__ n_out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long long cap = (long long)S * (D + 2);
  uint8_t* o = out + row * cap;
  Kmer<W> cur = load_kmer<W>(words, row);
  uint32_t f, r, cf[4], cr[4];
  hash_kmer<W>(cur, k, tabs, &f, &r);
  long long pos = 0;
  for (int s = 0; s < S; ++s) {
    const unsigned m = succ_rolled<W>(cur, f, r, k, tabs, bits, H, n_words, cf, cr);
    const int deg = __popc(m);
    if (deg == 0) break;
    if (deg == 1) {
      const uint32_t u = first_set(m);
      o[pos++] = (uint8_t)u;
      cur = shl2<W>(cur, u, top);
      f = pick4(cf, u);
      r = pick4(cr, u);
      continue;
    }
    // bubble attempt: the 4 branches in registers
    Kmer<W> bn[4];
    uint32_t bf[4], br[4];
    unsigned alive = m;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bn[c] = shl2<W>(cur, (uint32_t)c, top);
      bf[c] = cf[c];
      br[c] = cr[c];
    }
    int dstar = -1;
    for (int d = 0; d < D && alive; ++d) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!((alive >> c) & 1u)) continue;
        uint32_t gf[4], gr[4];
        const unsigned mc = succ_rolled<W>(bn[c], bf[c], br[c], k, tabs, bits, H, n_words,
                                           gf, gr);
        if (__popc(mc) != 1) {
          alive &= ~(1u << c);
          continue;
        }
        const uint32_t u = first_set(mc);
        bn[c] = shl2<W>(bn[c], u, top);
        bf[c] = pick4(gf, u);
        br[c] = pick4(gr, u);
      }
      if (!alive) break;
      const int first = __ffs(alive) - 1;
      Kmer<W> ref = bn[0];
#pragma unroll
      for (int e = 1; e < 4; ++e)
        if (e == first) ref = bn[e];
      bool same = true;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if ((alive >> c) & 1u) same &= same_kmer<W>(bn[c], ref);
      if (same) {
        dstar = d;
        break;
      }
    }
    if (dstar < 0) break;
    // emit cbr and re-walk its d*+1 steps for their bases; continue from
    // its node
    const uint32_t cbr = (uint32_t)(__ffs(alive) - 1);
    o[pos++] = (uint8_t)cbr;
    Kmer<W> b = shl2<W>(cur, cbr, top);
    uint32_t gf = pick4(cf, cbr), gr = pick4(cr, cbr);
    for (int d = 0; d <= dstar; ++d) {
      uint32_t hf[4], hr[4];
      const uint32_t u = first_set(succ_rolled<W>(b, gf, gr, k, tabs, bits, H, n_words, hf, hr));
      o[pos++] = (uint8_t)u;
      b = shl2<W>(b, u, top);
      gf = pick4(hf, u);
      gr = pick4(hr, u);
    }
    cur = b;
    f = gf;
    r = gr;
  }
  n_out[row] = (int32_t)pos;
  for (long long t = pos; t < cap; ++t) o[t] = 0;
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

template <int W>
static void launch_probe(const void* words, long long N, int mode, int classic, int k,
                         unsigned top, const HashTabs& tb, const void* bitset, int H,
                         unsigned n_words, void* out, cudaStream_t st) {
  if (classic)
    dbg_probe_kernel<W, true><<<graph_blocks(N), GRAPH_THREADS, 0, st>>>(
        (const uint32_t*)words, N, mode, k, top, tb, (const uint32_t*)bitset, H, n_words,
        (uint8_t*)out);
  else
    dbg_probe_kernel<W, false><<<graph_blocks(N), GRAPH_THREADS, 0, st>>>(
        (const uint32_t*)words, N, mode, k, top, tb, (const uint32_t*)bitset, H, n_words,
        (uint8_t*)out);
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
#define LAUNCH(W_) \
  launch_probe<W_>(words, N, mode, classic, k, top, tb, bitset, H, n_words, out, st)
  switch (W) {
    LT_W_CASE(1, LAUNCH)
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <int W>
static void launch_walk(const void* words, long long N, int S, int k, unsigned top,
                        const HashTabs& tb, const void* bitset, int H, unsigned n_words,
                        void* bases, void* n, cudaStream_t st) {
  dbg_walk_kernel<W><<<graph_blocks(N), GRAPH_THREADS, 0, st>>>(
      (const uint32_t*)words, N, S, k, top, tb, (const uint32_t*)bitset, H, n_words,
      (uint8_t*)bases, (int32_t*)n);
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
#define LAUNCH(W_) launch_walk<W_>(words, N, S, k, top, tb, bitset, H, n_words, bases, n, st)
  switch (W) {
    LT_W_CASE(1, LAUNCH)
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <int W>
static void launch_traverse(const void* words, long long N, int S, int D, int k, unsigned top,
                            const HashTabs& tb, const void* bitset, int H, unsigned n_words,
                            void* out, void* n, cudaStream_t st) {
  dbg_traverse_kernel<W><<<graph_blocks(N), GRAPH_THREADS, 0, st>>>(
      (const uint32_t*)words, N, S, D, k, top, tb, (const uint32_t*)bitset, H, n_words,
      (uint8_t*)out, (int32_t*)n);
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
