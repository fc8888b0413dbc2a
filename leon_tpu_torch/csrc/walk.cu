// K4 walk — anchor search, fused right-then-left de Bruijn walk, flat event
// buffer, and the decode re-walk; K15 walk_dense (below) — the dense event
// tensors of encode_batch, k <= 255.
//
// Replaces: leon_tpu/ops/walk.py encode_batch_compact_packed ->
// _encode_compact_impl with _anchor_state/_anchor_scan/_pack_window and
// _walk_fused (walk.py:113-161, 247-381, 432-564), and
// decode_batch_flat_packed -> decode_batch_flat -> decode_batch ->
// _walk_decode_fused, pack_codes_u32 (walk.py:700-936). The walk policy
// is frozen by FORMAT.md §6; every output is bit-identical to the
// reference's.
//
// Bound on the H100: latency of the dependent random Bloom probes — 4
// one-word probes per step, ~70 steps per 100 bp read, each step needing
// the previous step's chosen base. The bitset (~6 MB at bench scale) stays
// in the 50 MB L2, and the probes go through the read-only path (__ldg).
// Design: one thread per read with the whole walk state in registers
// (k-mer as one uint64, the two rolling hash chains, event counters), so a
// step costs 4 L2 loads and no shared or device-memory traffic besides the
// read's own 2-bit row and its events. The TPU's (B, ME) event planes and
// post-scan scatters are gone: walk_encode writes each read's events in
// walk order into its own row of a (B, ME) scratch, torch.cumsum gives the
// per-read offsets, and walk_pack scatters rows into the reference's flat
// u16 layout; walk_decode walks the flat gap/errnt/bif streams from each
// read's own offsets and never builds the (B, L) error plane. Many reads
// in flight per SM (occupancy), not work inside a read, hide the latency.
#include "common.cuh"
#include "kmer_words.cuh"

#define WALK_THREADS 128

// the 4 candidate (f, r) chains of one step and their solidity (bit c set
// = base c solid), walk.py:299-313; o is the base leaving the window (the
// k-mer's first base on a right step, its last on a left step)
static __device__ __forceinline__ unsigned step_probe(bool in_r, int o, uint32_t f, uint32_t r,
                                                      const HashTabs& tb,
                                                      const uint32_t* __restrict__ bits, int H,
                                                      uint32_t n_words, uint32_t cf[4],
                                                      uint32_t cr[4]) {
  uint32_t fb, rb;
  if (in_r) {
    fb = rol1(f ^ sel4(tb.t[2], o));
    rb = ror1(r ^ sel4(tb.t[1], o));
  } else {
    fb = ror1(f ^ sel4(tb.t[0], o));
    rb = rol1(r ^ sel4(tb.t[3], o));
  }
  unsigned sm = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cf[c] = fb ^ (in_r ? tb.t[0][c] : tb.t[2][c]);
    cr[c] = rb ^ (in_r ? tb.t[3][c] : tb.t[1][c]);
    if (probe(bits, cf[c], cr[c], H, n_words)) sm |= 1u << c;
  }
  return sm;
}

// the base leaving a one-word window on a right (first base) or left step
static __device__ __forceinline__ int leaving(bool in_r, uint64_t fwd, int k) {
  return in_r ? (int)((fwd >> (2 * (k - 1))) & 3u) : (int)(fwd & 3u);
}

static __device__ __forceinline__ uint64_t advance(bool in_r, uint64_t fwd, int b, int k,
                                                   uint64_t kmask) {
  return in_r ? (((fwd << 2) | (uint64_t)b) & kmask)
              : ((fwd >> 2) | ((uint64_t)b << (2 * (k - 1))));
}

// index of the n-th (0-based) set bit of a 4-bit mask; 0 when there is none
static __device__ __forceinline__ int nth_set(unsigned m, int n) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if ((m >> c) & 1u) {
      if (n == 0) return c;
      --n;
    }
  }
  return 0;
}

static __device__ __forceinline__ uint32_t sel4v(const uint32_t v[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// ---------------------------------------------------------------------------
// encode
// ---------------------------------------------------------------------------

// meta (B, 6): anchored, apos, nbif_r, nerr_r, nbif_l, nerr_l
// tot (2, B): error events, bif events per read
// ev_gap/ev_nt/ev_bif (B, ME): the read's events in walk order
// conf (B, L16c): confirmed-position bits (L16c = 0 without with_conf)
__global__ void walk_encode_kernel(const uint32_t* __restrict__ packed,
                                   const int32_t* __restrict__ lengths, int B, int L16, int L,
                                   int k, int H, uint32_t n_words,
                                   const __grid_constant__ HashTabs tb,
                                   const uint32_t* __restrict__ bits, int L16c, int ME,
                                   int32_t* __restrict__ meta, int32_t* __restrict__ tot,
                                   uint16_t* __restrict__ ev_gap, uint8_t* __restrict__ ev_nt,
                                   uint8_t* __restrict__ ev_bif, uint16_t* __restrict__ conf) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const uint32_t* pr = packed + (size_t)row * L16;
  uint16_t* cw = conf + (size_t)row * L16c;
  for (int w = 0; w < L16c; ++w) cw[w] = 0;
  const int len = min(lengths[row], L);
  const uint64_t kmask = (1ull << (2 * k)) - 1;
  const int hs = 2 * (k - 1);

  // anchor: the member position with the smallest min(f, r); the first
  // index wins ties and an all-0xFFFFFFFF row gives 0 (walk.py:357-381).
  // Positions past len-k are never members, so the scan stops at len.
  uint32_t f = 0, r = 0, af = 0, ar = 0, best = 0xFFFFFFFFu;
  uint64_t fwd = 0, afwd = 0;
  bool anchored = false;
  int apos = 0;
  for (int j = 0; j < len; ++j) {
    const int x = base_at(pr, j);
    if (j >= k) {
      const int o = (int)((fwd >> hs) & 3u);  // base leaving the window
      f = rol1(f ^ sel4(tb.t[2], o)) ^ sel4(tb.t[0], x);
      r = ror1(r ^ sel4(tb.t[1], o)) ^ sel4(tb.t[3], x);
    } else {
      f = rol1(f) ^ sel4(tb.t[0], x);
      r = r ^ rolr(sel4(tb.t[1], x), j);
    }
    fwd = ((fwd << 2) | (uint64_t)x) & kmask;
    const int p = j - k + 1;
    if (p >= 0) {
      const bool mem = probe(bits, f, r, H, n_words);
      const uint32_t v = mem ? min(f, r) : 0xFFFFFFFFu;
      anchored |= mem;
      if (p == 0 || v < best) {
        best = v;
        apos = p;
        afwd = fwd;
        af = f;
        ar = r;
      }
    }
  }

  // fused walk: nr right steps from the anchor, then reset and apos left
  // steps (walk.py:247-354)
  int nerr_r = 0, nerr_l = 0, nbif_r = 0, nbif_l = 0;
  const int total = anchored ? max(len - k, 0) : 0;
  const int nr = max(len - k - apos, 0);
  uint16_t* eg = ev_gap + (size_t)row * ME;
  uint8_t* en = ev_nt + (size_t)row * ME;
  uint8_t* eb = ev_bif + (size_t)row * ME;
  fwd = afwd;
  f = af;
  r = ar;
  int last = -1;
  for (int s = 0; s < total; ++s) {
    const bool in_r = s < nr;
    if (s == nr) {
      fwd = afwd;
      f = af;
      r = ar;
      last = -1;
    }
    const int lidx = in_r ? s : s - nr;
    const int j = in_r ? apos + k + s : apos - 1 - lidx;
    const int b = base_at(pr, j);
    uint32_t cf[4], cr[4];
    const unsigned sm =
        step_probe(in_r, leaving(in_r, fwd, k), f, r, tb, bits, H, n_words, cf, cr);
    const int scount = __popc(sm);
    const unsigned below = (1u << b) - 1u;
    const bool solid_b = (sm >> b) & 1u;
    if (solid_b) {
      if (scount == 1) {
        if (L16c) cw[j >> 4] |= (uint16_t)(1u << (j & 15));
      } else {
        eb[nbif_r + nbif_l] = (uint8_t)__popc(sm & below);  // rank among solid
        if (in_r) ++nbif_r; else ++nbif_l;
      }
    } else {
      const int e = nerr_r + nerr_l;
      eg[e] = (uint16_t)max(lidx - last - 1, 0);
      en[e] = (uint8_t)__popc(~sm & below);  // rank among non-solid
      last = lidx;
      if (in_r) ++nerr_r; else ++nerr_l;
    }
    // on an error with a solid candidate, advance on the smallest solid base
    const int b_adv = (!solid_b && scount >= 1) ? __ffs(sm) - 1 : b;
    f = sel4v(cf, b_adv);
    r = sel4v(cr, b_adv);
    fwd = advance(in_r, fwd, b_adv, k, kmask);
  }
  int32_t* m = meta + (size_t)row * 6;
  m[0] = anchored;
  m[1] = apos;
  m[2] = nbif_r;
  m[3] = nerr_r;
  m[4] = nbif_l;
  m[5] = nerr_l;
  tot[row] = nerr_r + nerr_l;
  tot[B + row] = nbif_r + nbif_l;
}

// Scatter each read's scal, errgap and conf into the flat u16 buffer, and
// its errnt/bif symbols into byte scratch at the read's exclusive offset.
__global__ void walk_pack_rows(int B, int ME, int L16c, int scal6,
                               const int32_t* __restrict__ meta,
                               const int32_t* __restrict__ tot,
                               const long long* __restrict__ incl,
                               const uint16_t* __restrict__ ev_gap,
                               const uint8_t* __restrict__ ev_nt,
                               const uint8_t* __restrict__ ev_bif,
                               const uint16_t* __restrict__ conf, long long cap_err,
                               long long cap_bif, uint8_t* __restrict__ nt_s,
                               uint8_t* __restrict__ bif_s, uint16_t* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  if (row == 0) {
    const long long te = incl[B - 1], tbf = incl[2 * B - 1];
    out[0] = (uint16_t)(te & 0xFFFF);
    out[1] = (uint16_t)((te >> 16) & 0xFFFF);
    out[2] = (uint16_t)(tbf & 0xFFFF);
    out[3] = (uint16_t)((tbf >> 16) & 0xFFFF);
  }
  const int32_t* m = meta + (size_t)row * 6;
  if (scal6) {
    for (int c = 0; c < 6; ++c) out[4 + (size_t)row * 6 + c] = (uint16_t)m[c];
  } else {
    uint16_t* sc = out + 4 + (size_t)row * 3;
    sc[0] = (uint16_t)(m[1] | (m[0] << 15));
    sc[1] = (uint16_t)(m[3] | (m[2] << 8));
    sc[2] = (uint16_t)(m[5] | (m[4] << 8));
  }
  const long long o_err = 4 + (long long)(scal6 ? 6 : 3) * B;
  const int ne = tot[row];
  const long long ebase = incl[row] - ne;
  for (int e = 0; e < ne; ++e) {
    const long long idx = ebase + e;
    if (idx >= cap_err) break;
    out[o_err + idx] = ev_gap[(size_t)row * ME + e];
    nt_s[idx] = ev_nt[(size_t)row * ME + e];
  }
  const int nb = tot[B + row];
  const long long bbase = incl[B + row] - nb;
  for (int e = 0; e < nb; ++e) {
    const long long idx = bbase + e;
    if (idx >= cap_bif) break;
    bif_s[idx] = ev_bif[(size_t)row * ME + e];
  }
  if (L16c) {
    const long long o_conf = o_err + cap_err + cap_err / 8 + cap_bif / 8;
    for (int w = 0; w < L16c; ++w)
      out[o_conf + (size_t)row * L16c + w] = conf[(size_t)row * L16c + w];
  }
}

// 2-bit pack the errnt and bif symbols, 8 per u16 word (walk.py:481-484).
__global__ void walk_pack_2bit(int B, const long long* __restrict__ incl, long long cap_err,
                               long long cap_bif, const uint8_t* __restrict__ nt_s,
                               const uint8_t* __restrict__ bif_s, long long o_nt,
                               uint16_t* __restrict__ out) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_nt = cap_err / 8, n_bif = cap_bif / 8;
  if (w >= n_nt + n_bif) return;
  const bool is_nt = w < n_nt;
  const long long ww = is_nt ? w : w - n_nt;
  const long long total = min(is_nt ? incl[B - 1] : incl[2 * B - 1], is_nt ? cap_err : cap_bif);
  const uint8_t* s = is_nt ? nt_s : bif_s;
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long idx = ww * 8 + i;
    if (idx < total) v |= (uint32_t)(s[idx] & 3u) << (2 * i);
  }
  out[o_nt + w] = (uint16_t)v;
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// scal (B, 9+W): apos, anchored, length, nerr_r, nerr_l, nbif_r, nbif_l,
// err_base, bif_base, anchor words. out (B, L16): bases, 16 per u32.
__global__ void walk_decode_kernel(const int32_t* __restrict__ scal, int B, int W,
                                   const int32_t* __restrict__ errgaps,
                                   const uint8_t* __restrict__ errnts,
                                   const uint8_t* __restrict__ bifs, long long n_err,
                                   long long n_bif, int L, int L16, int k, int H,
                                   uint32_t n_words, const __grid_constant__ HashTabs tb,
                                   const uint32_t* __restrict__ bits,
                                   uint32_t* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const int32_t* sc = scal + (size_t)row * (9 + W);
  uint32_t* o = out + (size_t)row * L16;
  for (int w = 0; w < L16; ++w) o[w] = 0;
  if (sc[1] == 0) return;  // unanchored: the host restores raw segments
  const int apos = sc[0], len = sc[2];
  const int nerr_r = sc[3], nerr_l = sc[4], nbif_r = sc[5], nbif_l = sc[6];
  const long long err_base = sc[7], bif_base = sc[8];
  uint64_t afwd = (uint32_t)sc[9];
  if (W == 2) afwd |= (uint64_t)(uint32_t)sc[10] << 32;
  const uint64_t kmask = (1ull << (2 * k)) - 1;
  const int ME = max(1, L - k);

  for (int i = 0; i < k; ++i) {  // the anchor's own bases
    const int p = apos + i;
    if (p >= 0 && p < L) o[p >> 4] |= (uint32_t)((afwd >> (2 * (k - 1 - i))) & 3u) << (2 * (p & 15));
  }
  uint32_t af, ar;
  hash_key(afwd, k, tb, &af, &ar);
  uint32_t f = af, r = ar;
  uint64_t fwd = afwd;

  const int total = max(len - k, 0);
  const int nr = max(len - k - apos, 0);
  // this side's error run: count, base offset, next error's side-local step
  int side_n = nerr_r, ei = 0;
  long long ebase = err_base;
  long long next_err = (side_n > 0 && ebase < n_err) ? errgaps[ebase] : -1;
  int pbif = 0;
  for (int s = 0; s < total; ++s) {
    const bool in_r = s < nr;
    if (s == nr) {  // side switch: back to the anchor, left error run
      fwd = afwd;
      f = af;
      r = ar;
      side_n = nerr_l;
      ei = 0;
      ebase = err_base + nerr_r;
      next_err = (side_n > 0 && ebase < n_err) ? errgaps[ebase] : -1;
    }
    const int lidx = in_r ? s : s - nr;
    const int j = in_r ? apos + k + s : apos - 1 - lidx;
    const bool is_err = ei < side_n && lidx == next_err;
    int rank_ns = 0;
    if (is_err) {
      rank_ns = errnts[ebase + ei] & 3;
      ++ei;
      next_err = (ei < side_n && ebase + ei < n_err) ? next_err + 1 + errgaps[ebase + ei] : -1;
    }
    uint32_t cf[4], cr[4];
    const unsigned sm =
        step_probe(in_r, leaving(in_r, fwd, k), f, r, tb, bits, H, n_words, cf, cr);
    const int scount = __popc(sm);
    const int b_uniq = nth_set(sm, 0);
    int b;
    if (is_err) {
      b = nth_set(~sm & 0xFu, rank_ns);
    } else if (scount >= 2) {  // bifurcation: next rank of the read's queue
      const int q = min(pbif, 2 * ME - 1);
      int rank = 0;
      if (q < nbif_r) {
        if (bif_base + q < n_bif) rank = bifs[bif_base + q];
      } else {
        const int t = min(q - nbif_r, ME - 1);
        if (t < nbif_l && bif_base + nbif_r + t < n_bif) rank = bifs[bif_base + nbif_r + t];
      }
      b = nth_set(sm, rank & 3);
      ++pbif;
    } else {
      b = b_uniq;
    }
    if (j >= 0 && j < L) o[j >> 4] |= (uint32_t)b << (2 * (j & 15));
    const int b_adv = (is_err && scount >= 1) ? b_uniq : b;
    f = sel4v(cf, b_adv);
    r = sel4v(cr, b_adv);
    fwd = advance(in_r, fwd, b_adv, k, kmask);
  }
}

// ---------------------------------------------------------------------------
// K18 walk_encode_words and K19 walk_decode_words — K4's encode and decode
// re-walk for 17 <= k <= 255 (the main path takes them for 32 <= k <= 255;
// K4 serves k <= 31). Width-free: one instance per hash count H = 1..8.
//
// Replaces: leon_tpu/ops/walk.py encode_batch_compact_packed (554-565) ->
// _encode_compact_impl (432-545) with _anchor_state (357), _anchor_scan
// (113), _pack_window (147) and _walk_fused (247); and
// decode_batch_flat_packed (819-841) -> decode_batch_flat, decode_batch and
// _walk_decode_fused (700-796), at any W.
//
// Bound on the H100: the Bloom probes. Every anchor position costs one and
// every walk step four, each a random 4-byte word of a bitset that sits in
// L2: a 32-byte sector a probe, up to 32 L1 wavefronts a warp instruction.
// scripts/walk_probe_floor.cu times that floor (the same probes with no
// dependency between them; PERF.md §6 gives these kernels' share of it).
// Design: one thread per read (a chunk gives each SM ~16 warps, each with 4
// probes in flight a step), and no device-memory access on a step's chain
// but the probes:
// - No window. The base leaving it is the walked base k positions back,
//   read from a ring of the thread's walked bases in shared memory: RW
//   words, RW the power of two >= ceil(k/16) + 1 (4..32), so the anchor's
//   words fit; one ring a side, both starting from the anchor. Shared memory
//   does not grow with L: at most 32 KB a block.
// - K18 reads the read's own bases from its packed row in device memory, one
//   word load per 16 columns, the next word loaded a word ahead.
// - The rolling (f, r) pair is all the hashing a step does; K19 hashes the
//   anchor once, base by base from its words in order.
// - The walked word and the output word (K18's confirmed bits, K19's bases)
//   build in registers and are stored once per 16 positions: each side
//   writes its words in order. A block zeroes its output rows (contiguous)
//   first, in one coalesced pass, so no thread zeroes its own row.
// - K18's anchor scan rolls WALKW_SCAN_UNROLL positions, issues their probes
//   together, then folds them in order (the first index wins ties).
// - K19 loads the stream values a step may need (the next bif rank, the
//   next error's rank and gap) one event ahead.
// Events (a few a read) go straight to device memory, in walk order.
// Outputs are K4's: meta, tot, the event rows and the conf bits (walk_pack
// serves both); K19 takes scal (B, 9+W). K15 (below) walks with K18's code:
// anchor_scan, anchor_rings and encode_side, which writes through an event
// sink (K18's EventRows, K15's DenseSide).
// ---------------------------------------------------------------------------

#define WALKW_THREADS 128
#define WALKW_SCAN_UNROLL 4
// Registers a thread. Under __launch_bounds__(WALKW_THREADS) ptxas held both
// kernels at 48 and spilled K19 at H <= 6 (5-10% slower at W = 8, 16: PERF.md
// §6); a chunk's grid gives an SM ~16 warps, so 64 costs no occupancy.
#define WALKW_REGS 64

// the hash tables in shared memory as [kind * 4 + base] (HashTabs order)
static __device__ __forceinline__ void load_tabs(const HashTabs& tb, uint32_t* st) {
  const int i = threadIdx.x;
  if (i < 16) {
    const int kd = i >> 2, b = i & 3;
    st[i] = kd == 0 ? sel4(tb.t[0], b)
          : kd == 1 ? sel4(tb.t[1], b)
          : kd == 2 ? sel4(tb.t[2], b)
                    : sel4(tb.t[3], b);
  }
}

// table value [kind][b] (HashTabs order) for a runtime base b
static __device__ __forceinline__ uint32_t tab(const uint32_t* st, int kind, int b) {
  return st[kind * 4 + b];
}

// wordmask with H fixed: returns the word index, *mask the H-bit mask
template <int H>
static __device__ __forceinline__ uint32_t wordmask_h(uint32_t f, uint32_t r, uint32_t n_words,
                                                      uint32_t* mask) {
  const uint32_t lo = min(f, r), hi = max(f, r);
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < H; ++i) m |= 1u << ((i < 6 ? hi >> (5 * i) : lo >> (5 * (i - 6))) & 31u);
  *mask = m;
  return __umulhi(lo, n_words);
}

// One step's 4 candidate probes (walk.py:299-313) from the chains (f, r) and
// the leaving base o: bit c of the result set = base c solid. *fb, *rb are
// the chains with o rolled out (next_chains adds the base walked).
template <int H, bool RIGHT>
static __device__ __forceinline__ unsigned probe4(int o, uint32_t f, uint32_t r,
                                                  const HashTabs& tb, const uint32_t* st,
                                                  const uint32_t* __restrict__ bits,
                                                  uint32_t n_words, uint32_t* fb, uint32_t* rb) {
  *fb = RIGHT ? rol1(f ^ tab(st, 2, o)) : ror1(f ^ tab(st, 0, o));
  *rb = RIGHT ? ror1(r ^ tab(st, 1, o)) : rol1(r ^ tab(st, 3, o));
  uint32_t v[4], m[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = __ldg(bits + wordmask_h<H>(*fb ^ tb.t[RIGHT ? 0 : 2][c],
                                      *rb ^ tb.t[RIGHT ? 3 : 1][c], n_words, &m[c]));
  unsigned sm = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) sm |= (unsigned)((v[c] & m[c]) == m[c]) << c;
  return sm;
}

// the chains after a step that walked base b: fb ^ T[b], rb ^ Tcrot[b] on
// the right, fb ^ Trot[b], rb ^ Tc[b] on the left
template <bool RIGHT>
static __device__ __forceinline__ void next_chains(const uint32_t* st, uint32_t fb, uint32_t rb,
                                                   int b, uint32_t* f, uint32_t* r) {
  *f = fb ^ tab(st, RIGHT ? 0 : 2, b);
  *r = rb ^ tab(st, RIGHT ? 3 : 1, b);
}

// ring words a side for k: the power of two >= ceil(k/16) + 1
static inline int walkw_ring(int k) {
  int r = 4;
  while (r < (k + 15) / 16 + 1) r *= 2;
  return r;
}

// base at column c of a thread's ring (interleaved: its word w at ring[w * T])
static __device__ __forceinline__ int rbase(const uint32_t* ring, int T, int rm, int c) {
  return (int)((ring[((c >> 4) & rm) * T] >> (2 * (c & 15))) & 3u);
}

// the bits of a side's first word (column j0) that hold anchor bases: the
// columns below j0 on the right, above it on the left
template <bool RIGHT>
static __device__ __forceinline__ uint32_t anchor_part(int j0) {
  const int sh = 2 * (j0 & 15);
  return RIGHT ? (1u << sh) - 1u : (sh == 30 ? 0u : ~0u << (sh + 2));
}

// A thread's packed row of n words read column by column, upwards or
// downwards: one word load per 16 columns, the next word loaded a word ahead.
template <bool UP>
struct Cols {
  const uint32_t* p;
  int n;
  uint32_t cur, nxt;
  __device__ __forceinline__ uint32_t ld(int w) const {
    return (w >= 0 && w < n) ? __ldg(p + w) : 0u;
  }
  __device__ __forceinline__ Cols(const uint32_t* p_, int n_, int j) : p(p_), n(n_) {
    cur = ld(j >> 4);
    nxt = ld((j >> 4) + (UP ? 1 : -1));
  }
  // the base at column j, the column next to the last one taken
  __device__ __forceinline__ int take(int j) {
    const int b = (int)((cur >> (2 * (j & 15))) & 3u);
    if ((j & 15) == (UP ? 15 : 0)) {
      cur = nxt;
      nxt = ld((j >> 4) + (UP ? 2 : -2));
    }
    return b;
  }
};

// K18's events and conf words (one sink for both sides): the read's event
// rows in walk order, its conf row in device memory (L16c words, 0 without
// with_conf)
struct EventRows {
  uint16_t* eg;
  uint8_t* en;
  uint8_t* eb;
  uint16_t* crow;
  int L16c, ne, nb;
  __device__ __forceinline__ void bif(int rank) { eb[nb++] = (uint8_t)rank; }
  __device__ __forceinline__ void err(int j, int gap, int nt) {
    eg[ne] = (uint16_t)gap;
    en[ne++] = (uint8_t)nt;
  }
  template <bool RIGHT>
  __device__ __forceinline__ void conf(int j, uint32_t cw) {
    if (L16c && (!RIGHT || (j >> 4) < L16c)) crow[j >> 4] = (uint16_t)cw;
  }
};

// One side of the walk (walk.py:247-354) from the anchor chains (f, r),
// `steps` steps: events into the sink, confirmed bits (cw0 the first word's
// carried ones) flushed to it a word at a time, walked bases into the ring.
// NEAR: the leaving base may lie in the word being built (k < 16).
template <int H, bool RIGHT, bool NEAR, class Sink>
static __device__ __forceinline__ void encode_side(
    const uint32_t* __restrict__ pr, int L16, uint32_t* ring, int T, int rm, const uint32_t* st,
    const HashTabs& tb, const uint32_t* __restrict__ bits, uint32_t n_words, int k, int L,
    int apos, int steps, int b_last, uint32_t f, uint32_t r, uint32_t cw0, Sink& out,
    int* side_err, int* side_bif) {
  int last = -1, serr = 0, sbif = 0;
  const int j0 = RIGHT ? apos + k : apos - 1;
  Cols<RIGHT> rd(pr, L16, j0);
  uint32_t cw = cw0, hw = steps > 0 ? ring[((j0 >> 4) & rm) * T] & anchor_part<RIGHT>(j0) : 0u;
  for (int s = 0; s < steps; ++s) {
    const int j = RIGHT ? j0 + s : j0 - s;
    const int b = (RIGHT && j >= L) ? b_last : rd.take(j);
    const int c = RIGHT ? j - k : j + k;  // the column leaving the window
    const int o = NEAR && (c >> 4) == (j >> 4) ? (int)((hw >> (2 * (c & 15))) & 3u)
                                                : rbase(ring, T, rm, c);
    uint32_t fb, rb;
    const unsigned sm = probe4<H, RIGHT>(o, f, r, tb, st, bits, n_words, &fb, &rb);
    const int scount = __popc(sm);
    const unsigned below = (1u << b) - 1u;
    const bool solid_b = (sm >> b) & 1u;
    if (solid_b) {
      if (scount == 1) {
        if (!RIGHT || j < L) cw |= 1u << (j & 15);
      } else {
        out.bif(__popc(sm & below));  // rank among solid
        ++sbif;
      }
    } else {
      out.err(j, s - last - 1, __popc(~sm & below));  // rank among non-solid
      last = s;
      ++serr;
    }
    // on an error with a solid candidate, advance on the smallest solid base
    const int b_adv = (!solid_b && scount >= 1) ? __ffs(sm) - 1 : b;
    next_chains<RIGHT>(st, fb, rb, b_adv, &f, &r);
    hw |= (uint32_t)b_adv << (2 * (j & 15));
    if ((j & 15) == (RIGHT ? 15 : 0) || s == steps - 1) {
      ring[((j >> 4) & rm) * T] = hw;
      out.template conf<RIGHT>(j, cw);
      hw = cw = 0;
    }
  }
  *side_err = serr;
  *side_bif = sbif;
}

// K18's and K15's anchor (walk.py:357-381): the member position with the
// smallest min(f, r) over the len - k + 1 positions of the packed row; the
// first index wins ties and an all-0xFFFFFFFF row gives 0. WALKW_SCAN_UNROLL
// positions are rolled and probed together, then folded in order.
template <int H>
static __device__ __forceinline__ bool anchor_scan(const uint32_t* __restrict__ pr, int L16,
                                                   int len, int k, const uint32_t* st,
                                                   const uint32_t* __restrict__ bits,
                                                   uint32_t n_words, int* apos_out,
                                                   uint32_t* af, uint32_t* ar) {
  uint32_t best = 0xFFFFFFFFu;
  bool anchored = false;
  int apos = 0;
  const int P = len - k + 1;
  if (P > 0) {
    Cols<true> xs(pr, L16, 0), os(pr, L16, 0);  // the bases entering and leaving
    uint32_t f = 0, r = 0;
    for (int j = 0; j < k; ++j) {
      const int x = xs.take(j);
      f = rol1(f) ^ tab(st, 0, x);
      r ^= rolr(tab(st, 1, x), j);
    }
    constexpr int U = WALKW_SCAN_UNROLL;
    for (int p0 = 0; p0 < P; p0 += U) {
      uint32_t hf[U], hr[U], v[U], m[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u;
        if (p > 0 && p < P) {
          const int x = xs.take(p + k - 1), o = os.take(p - 1);
          f = rol1(f ^ tab(st, 2, o)) ^ tab(st, 0, x);
          r = ror1(r ^ tab(st, 1, o)) ^ tab(st, 3, x);
        }
        hf[u] = f;
        hr[u] = r;
        const uint32_t wi = wordmask_h<H>(f, r, n_words, &m[u]);
        v[u] = p < P ? __ldg(bits + wi) : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u;
        if (p < P) {
          const bool mem = (v[u] & m[u]) == m[u];
          const uint32_t val = mem ? min(hf[u], hr[u]) : 0xFFFFFFFFu;
          anchored |= mem;
          if (p == 0 || val < best) {
            best = val;
            apos = p;
            *af = hf[u];
            *ar = hr[u];
          }
        }
      }
    }
  }
  *apos_out = apos;
  return anchored;
}

// both rings start from the anchor's words (the read's own bases)
static __device__ __forceinline__ void anchor_rings(const uint32_t* __restrict__ pr, int apos,
                                                    int k, uint32_t* ring_r, uint32_t* ring_l,
                                                    int T, int rm) {
  for (int w = apos >> 4; w <= (apos + k - 1) >> 4; ++w) {
    const uint32_t v = __ldg(pr + w);
    ring_r[(w & rm) * T] = v;
    ring_l[(w & rm) * T] = v;
  }
}

// meta (B, 6): anchored, apos, nbif_r, nerr_r, nbif_l, nerr_l
// tot (2, B): error events, bif events per read
// ev_gap/ev_nt/ev_bif (B, ME): the read's events in walk order
// conf (B, L16c): confirmed-position bits (L16c = 0 without with_conf)
// Shared memory: 16 table words, two rings of RW words a thread.
template <int H>
__global__ void __maxnreg__(WALKW_REGS)
    walk_encode_words_kernel(const uint32_t* __restrict__ packed,
                             const int32_t* __restrict__ lengths, int B, int L16, int L, int k,
                             uint32_t n_words, const __grid_constant__ HashTabs tb,
                             const uint32_t* __restrict__ bits, int L16c, int ME, int RW,
                             int32_t* __restrict__ meta, int32_t* __restrict__ tot,
                             uint16_t* __restrict__ ev_gap, uint8_t* __restrict__ ev_nt,
                             uint8_t* __restrict__ ev_bif, uint16_t* __restrict__ conf) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x, tid = threadIdx.x, row0 = blockIdx.x * T;
  const int n = min(T, B - row0);
  uint32_t* st = smem;
  load_tabs(tb, st);
  // the block's conf rows, contiguous: the walk stores only the words it visits
  uint16_t* cblk = conf + (size_t)row0 * L16c;
  for (int i = tid; i < n * L16c; i += T) cblk[i] = 0;
  __syncthreads();
  if (tid >= n) return;
  const int row = row0 + tid, rm = RW - 1;
  uint32_t* ring_r = smem + 16 + tid;
  uint32_t* ring_l = ring_r + (size_t)RW * T;
  const uint32_t* pr = packed + (size_t)row * L16;
  const int lenf = lengths[row];
  const int len = min(lenf, L);

  uint32_t af = 0, ar = 0;
  int apos;
  const bool anchored = anchor_scan<H>(pr, L16, len, k, st, bits, n_words, &apos, &af, &ar);

  // the reference's fused schedule (walk.py:271-282): min(len-k, ME) steps,
  // the first len-k-apos of them on the right (past column L-1 when the
  // read is longer than the row, where the base read is column L-1's), the
  // rest on the left
  const int total = anchored ? min(max(lenf - k, 0), ME) : 0;
  const int nr = min(max(lenf - k - apos, 0), total);
  int b_last = 0;
  if (total > 0) {
    anchor_rings(pr, apos, k, ring_r, ring_l, T, rm);
    if (lenf > L) b_last = (int)((__ldg(pr + ((L - 1) >> 4)) >> (2 * ((L - 1) & 15))) & 3u);
  }
  EventRows ev{ev_gap + (size_t)row * ME, ev_nt + (size_t)row * ME, ev_bif + (size_t)row * ME,
               conf + (size_t)row * L16c, L16c, 0, 0};
  int nerr_r, nbif_r, nerr_l, nbif_l;
  encode_side<H, true, false>(pr, L16, ring_r, T, rm, st, tb, bits, n_words, k, L, apos, nr,
                              b_last, af, ar, 0u, ev, &nerr_r, &nbif_r);
  encode_side<H, false, false>(pr, L16, ring_l, T, rm, st, tb, bits, n_words, k, L, apos,
                               total - nr, b_last, af, ar, 0u, ev, &nerr_l, &nbif_l);
  const int ne = ev.ne, nb = ev.nb;
  int32_t* mt = meta + (size_t)row * 6;
  mt[0] = anchored;
  mt[1] = apos;
  mt[2] = nbif_r;
  mt[3] = nerr_r;
  mt[4] = nbif_l;
  mt[5] = nerr_l;
  tot[row] = ne;
  tot[B + row] = nb;
}

// rank at place pbif of a read's bif queue (its right events, then its
// left; the queue at q, n_q of its values in the stream)
static __device__ __forceinline__ int bif_rank(const uint8_t* __restrict__ q, int n_q, int nbif_r,
                                               int nbif_l, int ME, int pbif) {
  const int p = min(pbif, 2 * ME - 1);
  if (p < nbif_r) return p < n_q ? q[p] : 0;
  const int t = min(p - nbif_r, ME - 1);
  return (t < nbif_l && nbif_r + t < n_q) ? q[nbif_r + t] : 0;
}

// values of a stream of n from index base on, as an int (0 past its end)
static __device__ __forceinline__ int stream_left(long long n, long long base) {
  return (int)max(0LL, min(n - base, 0x7FFFFFFFLL));
}

// One side of K19's re-walk (walk.py:700-796): `steps` steps from the anchor
// chains (f, r), this side's error run (gaps eg, ranks en; n_ev events in
// the stream), the read's bif queue at *pbif; decoded bases into orow (the
// read's output row in device memory), walked ones into the ring. The stream values a step may
// need (the next bif rank, the next error's rank and the gap after it) are
// loaded one event ahead, off the step's chain.
template <int H, bool RIGHT>
static __device__ __forceinline__ void decode_side(
    uint32_t* __restrict__ orow, uint32_t* ring, int T, int rm, const uint32_t* st,
    const HashTabs& tb, const uint32_t* __restrict__ bits, uint32_t n_words, int k, int ME,
    int apos, int steps, uint32_t f, uint32_t r, const int32_t* __restrict__ eg,
    const uint8_t* __restrict__ en, int n_ev, const uint8_t* __restrict__ q, int n_q,
    int nbif_r, int nbif_l, int* pbif) {
  if (steps <= 0) return;
  const int j0 = RIGHT ? apos + k : apos - 1;
  // the side's first word keeps the anchor's bases (decoded = walked there)
  uint32_t hw = ring[((j0 >> 4) & rm) * T] & anchor_part<RIGHT>(j0), ow = hw;
  // the next error's side-local step (-1: none left) and rank, the gap
  // after it
  int ei = 0, ns_next = 0, gap_next = 0;
  long long next_err = -1;
  if (n_ev > 0) {
    next_err = eg[0];
    ns_next = en[0];
  }
  if (n_ev > 1) gap_next = eg[1];
  int rank_next = bif_rank(q, n_q, nbif_r, nbif_l, ME, *pbif);
  for (int s = 0; s < steps; ++s) {
    const int j = RIGHT ? j0 + s : j0 - s;
    const bool is_err = s == next_err;
    int rank_ns = 0;
    if (is_err) {
      rank_ns = ns_next & 3;
      ++ei;
      const bool more = ei < n_ev;
      next_err = more ? next_err + 1 + gap_next : -1;
      ns_next = more ? en[ei] : 0;
      gap_next = ei + 1 < n_ev ? eg[ei + 1] : 0;
    }
    uint32_t fb, rb;
    const unsigned sm = probe4<H, RIGHT>(rbase(ring, T, rm, RIGHT ? j - k : j + k), f, r, tb,
                                         st, bits, n_words, &fb, &rb);
    const int scount = __popc(sm);
    const int b_uniq = nth_set(sm, 0);
    int b;
    if (is_err) {
      b = nth_set(~sm & 0xFu, rank_ns);
    } else if (scount >= 2) {  // bifurcation: next rank of the read's queue
      b = nth_set(sm, rank_next & 3);
      ++*pbif;
      rank_next = bif_rank(q, n_q, nbif_r, nbif_l, ME, *pbif);
    } else {
      b = b_uniq;
    }
    const int b_adv = (is_err && scount >= 1) ? b_uniq : b;
    const int sh = 2 * (j & 15);
    ow |= (uint32_t)b << sh;
    hw |= (uint32_t)b_adv << sh;
    if ((j & 15) == (RIGHT ? 15 : 0) || s == steps - 1) {
      orow[j >> 4] = ow;
      ring[((j >> 4) & rm) * T] = hw;
      ow = hw = 0;
    }
    next_chains<RIGHT>(st, fb, rb, b_adv, &f, &r);
  }
}

// scal (B, 9+W): apos, anchored, length, nerr_r, nerr_l, nbif_r, nbif_l,
// err_base, bif_base, anchor words. out (B, L16): bases, 16 per u32. A
// read is walked over min(length, L) columns; a row whose anchor does not
// fit the batch (apos outside [0, L-k]) decodes to zeros, as an unanchored
// one. Shared memory: 16 table words, two rings of RW words a thread.
template <int H>
__global__ void __maxnreg__(WALKW_REGS)
    walk_decode_words_kernel(const int32_t* __restrict__ scal, int B, int W,
                             const int32_t* __restrict__ errgaps,
                             const uint8_t* __restrict__ errnts, const uint8_t* __restrict__ bifs,
                             long long n_err, long long n_bif, int L, int L16, int k,
                             uint32_t n_words, const __grid_constant__ HashTabs tb,
                             const uint32_t* __restrict__ bits, int RW,
                             uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x, tid = threadIdx.x, row0 = blockIdx.x * T;
  const int n = min(T, B - row0);
  uint32_t* st = smem;
  load_tabs(tb, st);
  // the block's output rows, contiguous: a read stores only the words it decodes
  uint32_t* oblk = out + (size_t)row0 * L16;
  for (int i = tid; i < n * L16; i += T) oblk[i] = 0;
  __syncthreads();
  if (tid >= n) return;
  const int32_t* sc = scal + (size_t)(row0 + tid) * (9 + W);
  if (sc[1] == 0 || sc[0] < 0 || sc[0] > L - k) return;
  const int apos = sc[0], len = min(sc[2], L), rm = RW - 1;
  uint32_t* orow = out + (size_t)(row0 + tid) * L16;
  uint32_t* ring_r = smem + 16 + tid;
  uint32_t* ring_l = ring_r + (size_t)RW * T;
  // the anchor's bases into the output row and both rings, hashed as they
  // go (base i at bit 2(k-1-i) of the words: the top word first)
  uint32_t af = 0, ar = 0, acc = 0, aw = 0;
  for (int i = 0, t = 2 * (k - 1); i < k; ++i, t -= 2) {
    if (i == 0 || (t & 31) == 30) aw = (uint32_t)sc[9 + (t >> 5)];
    const int b = (int)((aw >> (t & 31)) & 3u);
    af = rol1(af) ^ tab(st, 0, b);
    ar ^= rolr(tab(st, 1, b), i);
    const int p = apos + i;
    acc |= (uint32_t)b << (2 * (p & 15));
    if ((p & 15) == 15 || i == k - 1) {
      orow[p >> 4] = acc;
      ring_r[((p >> 4) & rm) * T] = acc;
      ring_l[((p >> 4) & rm) * T] = acc;
      acc = 0;
    }
  }
  const int nerr_r = sc[3], nerr_l = sc[4], nbif_r = sc[5], nbif_l = sc[6];
  const long long err_l = sc[7] + nerr_r, bif_base = sc[8];
  const int ME = max(1, L - k);
  const int total = max(len - k, 0);
  const int nr = min(max(len - k - apos, 0), total);
  const int n_q = stream_left(n_bif, bif_base);
  int pbif = 0;
  decode_side<H, true>(orow, ring_r, T, rm, st, tb, bits, n_words, k, ME, apos, nr, af, ar,
                       errgaps + sc[7], errnts + sc[7],
                       min(nerr_r, stream_left(n_err, sc[7])), bifs + bif_base, n_q, nbif_r,
                       nbif_l, &pbif);
  decode_side<H, false>(orow, ring_l, T, rm, st, tb, bits, n_words, k, ME, apos, total - nr, af,
                        ar, errgaps + err_l, errnts + err_l, min(nerr_l, stream_left(n_err, err_l)),
                        bifs + bif_base, n_q, nbif_r, nbif_l, &pbif);
}


// ---------------------------------------------------------------------------
// K15 walk_dense — the dense, slot-ordered event tensors of encode_batch,
// k <= 255: K18's walk with the reference's dense outputs.
//
// Replaces: leon_tpu/ops/walk.py encode_batch (621-665) -> walk_planes
// (384-402: _anchor_state 357, _anchor_scan 113, _pack_window 147, then
// _walk_side 171-244 once right and once left from the anchor state),
// slotify, _gap_plane (405-416) and _conf_mask (419-429).
//
// Bound on the H100: the Bloom probes, as K18's (one an anchor position,
// four a step), and the outputs' bytes: 20 an event slot and one a column,
// B(20 ME + L) in all, nearly all of them zeros.
// Design: the codes (B, L) uint8, taken & 3, are first packed 16 columns to
// a word (dense_pack_kernel, into the caller's (B, ceil(L/16)) scratch), so
// that the walk is K18's device code: its anchor scan (anchor_scan), its
// rings of walked bases and its row reads (encode_side), one instance per
// H. Each block zeroes its rows of the eight event planes and the confirmed
// plane (contiguous) in one pass of 16-byte stores (15 memsets cost about
// as much; each read writing its own rows whole, zeros and all, was 1.3-1.5x
// slower on the H100: PERF.md §6). Then each read walks its right side
// (min(len - k - apos, ME) steps; a base past column L-1 reads column L-1,
// as the reference's clipped gather) and its left side (apos steps) from
// the anchor, each event landing in its side's next slot (bif rank among
// solid bases, absolute errpos, errnt rank among non-solid bases, the
// side-local gap; errors, most of a walk's steps at k = 255, are built in
// registers 16 bytes at a time, RowChunks), and the confirmed columns (one
// solid candidate, the read's own base; never the anchor span) of 16
// columns built in a register and stored as 16 bytes where any is set, the
// widest stores the row's alignment allows. At k < 16 the leaving base may
// lie in the word being built (encode_side's NEAR), and at k < 15 both
// sides' first words may be one: the left side carries the right side's
// bits there.
// ---------------------------------------------------------------------------

// output pointers, in the reference's dict order: anchored, apos, nbif_r,
// nerr_r, nbif_l, nerr_l, then per side (r, l) bif, errpos, errnt, gap,
// then confirmed
struct DenseOut {
  void* p[15];
};

// Registers a thread: K18's and three chunks of error slots a side in flight
// (ptxas gives 80; under WALKW_REGS it ran 5% slower at W = 8 and 16: PERF.md
// §6). A 65,536-read grid (512 blocks) is resident at 80.
#define WALKD_REGS 96

// (B, L) codes -> (B, L16) packed words (kmer.pack_codes_np's layout, codes
// taken & 3, zero past column L-1): a thread a word
__global__ void dense_pack_kernel(const uint8_t* __restrict__ codes, int B, int L, int L16,
                                  uint32_t* __restrict__ packed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * L16) return;
  const long long row = i / L16;
  const int c0 = 16 * (int)(i - row * L16);
  const uint8_t* cr = codes + row * L + c0;
  const int n = min(16, L - c0);
  uint32_t v = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if (t < n) v |= (uint32_t)(__ldg(cr + t) & 3) << (2 * t);
  packed[i] = v;
}

// 16 column bytes of confirmed bits cw (byte t = bit t) at p, n <= 16 of
// them inside the row: the widest stores p's alignment allows
static __device__ __forceinline__ void store_conf16(uint8_t* p, uint32_t cw, int n) {
  uint32_t v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t x = cw >> (4 * t);
    v[t] = (x & 1u) | (x & 2u) << 7 | (x & 4u) << 14 | (x & 8u) << 21;
  }
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(p);
  if (n == 16 && (a & 15u) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if (n == 16 && (a & 7u) == 0) {
    reinterpret_cast<uint2*>(p)[0] = make_uint2(v[0], v[1]);
    reinterpret_cast<uint2*>(p)[1] = make_uint2(v[2], v[3]);
  } else if (n == 16 && (a & 3u) == 0) {
#pragma unroll
    for (int t = 0; t < 4; ++t) reinterpret_cast<uint32_t*>(p)[t] = v[t];
  } else if (n == 16 && (a & 1u) == 0) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      reinterpret_cast<uint16_t*>(p)[t] = (uint16_t)(v[t >> 1] >> (16 * (t & 1)));
  } else {
    for (int t = 0; t < n; ++t) p[t] = (uint8_t)((cw >> t) & 1u);
  }
}

// K15's events and confirmed columns of one side: its four (B, ME) slot
// planes at the read's row, the read's (B, L) confirmed row (zeroed first,
// so a word with no confirmed column stores nothing); `first` keeps the
// first word's bits for the other side (k < 15: a shared word)
struct DenseSide {
  uint8_t* bifs;
  RowChunks<int32_t> errpos;
  RowChunks<uint8_t> errnt;
  RowChunks<int32_t> gaps;
  uint8_t* crow;
  int L, ne, nb;
  uint32_t first;
  bool flushed;
  __device__ __forceinline__ void bif(int rank) { bifs[nb++] = (uint8_t)rank; }
  __device__ __forceinline__ void err(int j, int gap, int nt) {
    errpos.put(ne, (uint32_t)j);
    errnt.put(ne, (uint32_t)nt);
    gaps.put(ne++, (uint32_t)gap);
  }
  // the errors not yet stored (their last chunk)
  __device__ __forceinline__ void end() {
    errpos.end(ne);
    errnt.end(ne);
    gaps.end(ne);
  }
  template <bool RIGHT>
  __device__ __forceinline__ void conf(int j, uint32_t cw) {
    if (!flushed) {
      first = cw;
      flushed = true;
    }
    const int c0 = j & ~15;
    if (cw && c0 < L) store_conf16(crow + c0, cw, min(16, L - c0));
  }
};

// per row: the 15 planes' bytes (DenseOut order)
static __device__ __forceinline__ long long dense_row_bytes(int i, int ME, int L) {
  return i == 0 ? 1 : i < 6 ? 4 : i == 14 ? L : (i - 6) % 2 == 0 ? ME : 4LL * ME;
}

template <int H>
__global__ void __maxnreg__(WALKD_REGS)
    walk_dense_kernel(const uint32_t* __restrict__ packed, const int32_t* __restrict__ lengths,
                      int B, int L16, int L, int k, uint32_t n_words,
                      const __grid_constant__ HashTabs tb, const uint32_t* __restrict__ bits,
                      int ME, int RW, const __grid_constant__ DenseOut o) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x, tid = threadIdx.x, row0 = blockIdx.x * T;
  const int n = min(T, B - row0);
  uint32_t* st = smem;
  load_tabs(tb, st);
  // the block's rows of each event plane and of the confirmed plane
  // (contiguous): the walk stores only its events and confirmed words
  for (int i = 6; i < 15; ++i) {
    const long long rb = dense_row_bytes(i, ME, L);
    zero_region((uint8_t*)o.p[i] + row0 * rb, n * rb);
  }
  __syncthreads();
  if (tid >= n) return;
  const int row = row0 + tid, rm = RW - 1;
  uint32_t* ring_r = smem + 16 + tid;
  uint32_t* ring_l = ring_r + (size_t)RW * T;
  const uint32_t* pr = packed + (size_t)row * L16;
  const int lenf = lengths[row];
  uint32_t af = 0, ar = 0;
  int apos;
  const bool anchored =
      anchor_scan<H>(pr, L16, min(lenf, L), k, st, bits, n_words, &apos, &af, &ar);
  ((uint8_t*)o.p[0])[row] = anchored;
  ((int32_t*)o.p[1])[row] = apos;
  int nerr_r = 0, nbif_r = 0, nerr_l = 0, nbif_l = 0;
  if (anchored) {
    const int nr = min(max(lenf - k - apos, 0), ME);
    anchor_rings(pr, apos, k, ring_r, ring_l, T, rm);
    const int b_last =
        lenf > L ? (int)((__ldg(pr + ((L - 1) >> 4)) >> (2 * ((L - 1) & 15))) & 3u) : 0;
    const size_t ev = (size_t)row * ME;
    uint8_t* crow = (uint8_t*)o.p[14] + (size_t)row * L;
    DenseSide right{(uint8_t*)o.p[6] + ev,
                    RowChunks<int32_t>((int32_t*)o.p[7] + ev, ME),
                    RowChunks<uint8_t>((uint8_t*)o.p[8] + ev, ME),
                    RowChunks<int32_t>((int32_t*)o.p[9] + ev, ME), crow, L, 0, 0, 0u, false};
    encode_side<H, true, true>(pr, L16, ring_r, T, rm, st, tb, bits, n_words, k, L, apos, nr,
                               b_last, af, ar, 0u, right, &nerr_r, &nbif_r);
    right.end();
    const uint32_t carry = ((apos - 1) >> 4) == ((apos + k) >> 4) ? right.first : 0u;
    DenseSide left{(uint8_t*)o.p[10] + ev,
                   RowChunks<int32_t>((int32_t*)o.p[11] + ev, ME),
                   RowChunks<uint8_t>((uint8_t*)o.p[12] + ev, ME),
                   RowChunks<int32_t>((int32_t*)o.p[13] + ev, ME), crow, L, 0, 0, 0u, false};
    encode_side<H, false, true>(pr, L16, ring_l, T, rm, st, tb, bits, n_words, k, L, apos, apos,
                                b_last, af, ar, carry, left, &nerr_l, &nbif_l);
    left.end();
  }
  ((int32_t*)o.p[2])[row] = nbif_r;
  ((int32_t*)o.p[3])[row] = nerr_r;
  ((int32_t*)o.p[4])[row] = nbif_l;
  ((int32_t*)o.p[5])[row] = nerr_l;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

static inline unsigned grid_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

extern "C" int lt_walk_encode(const void* packed, const void* lengths, int B, int L16, int L,
                              int k, int H, unsigned n_words, const void* tabs16,
                              const void* bitset, int with_conf, int ME, void* meta, void* tot,
                              void* ev_gap, void* ev_nt, void* ev_bif, void* conf,
                              void* stream) {
  if (k < 1 || k > 31 || H < 1 || H > 8 || L < k + 1 || ME != L - k || L16 != (L + 15) / 16 ||
      n_words == 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  walk_encode_kernel<<<grid_for(B, WALK_THREADS), WALK_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (const int32_t*)lengths, B, L16, L, k, H, n_words, tb,
      (const uint32_t*)bitset, with_conf ? L16 : 0, ME, (int32_t*)meta, (int32_t*)tot,
      (uint16_t*)ev_gap, (uint8_t*)ev_nt, (uint8_t*)ev_bif, (uint16_t*)conf);
  return (int)cudaGetLastError();
}

extern "C" int lt_walk_pack(int B, int ME, int L16c, int with_conf, int scal6,
                            const void* meta, const void* tot, const void* incl,
                            const void* ev_gap, const void* ev_nt, const void* ev_bif,
                            const void* conf, long long cap_err, long long cap_bif,
                            void* nt_scratch, void* bif_scratch, void* out, long long out_len,
                            void* stream) {
  if (cap_err % 8 || cap_bif % 8 || (with_conf && L16c <= 0)) return (int)cudaErrorInvalidValue;
  const long long o_err = 4 + (long long)(scal6 ? 6 : 3) * B;
  const long long o_nt = o_err + cap_err;
  if (out_len != o_nt + cap_err / 8 + cap_bif / 8 + (with_conf ? (long long)B * L16c : 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)out_len * sizeof(uint16_t), st);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return (int)cudaSuccess;
  walk_pack_rows<<<grid_for(B, WALK_THREADS), WALK_THREADS, 0, st>>>(
      B, ME, with_conf ? L16c : 0, scal6, (const int32_t*)meta, (const int32_t*)tot,
      (const long long*)incl, (const uint16_t*)ev_gap, (const uint8_t*)ev_nt,
      (const uint8_t*)ev_bif, (const uint16_t*)conf, cap_err, cap_bif, (uint8_t*)nt_scratch,
      (uint8_t*)bif_scratch, (uint16_t*)out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_words16 = cap_err / 8 + cap_bif / 8;
  if (n_words16 > 0) {
    walk_pack_2bit<<<grid_for(n_words16, 256), 256, 0, st>>>(
        B, (const long long*)incl, cap_err, cap_bif, (const uint8_t*)nt_scratch,
        (const uint8_t*)bif_scratch, o_nt, (uint16_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int lt_walk_decode(const void* scal, int B, int W, const void* errgaps,
                              const void* errnts, const void* bifs, long long n_err,
                              long long n_bif, int L, int L16, int k, int H, unsigned n_words,
                              const void* tabs16, const void* bitset, void* out, void* stream) {
  if (k < 1 || k > 31 || H < 1 || H > 8 || W < 1 || W > 2 || L < k + 1 ||
      L16 != (L + 15) / 16 || n_words == 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  walk_decode_kernel<<<grid_for(B, WALK_THREADS), WALK_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)scal, B, W, (const int32_t*)errgaps, (const uint8_t*)errnts,
      (const uint8_t*)bifs, n_err, n_bif, L, L16, k, H, n_words, tb,
      (const uint32_t*)bitset, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// K18/K19 launch geometry: WALKW_THREADS threads a block, each with two
// rings of walkw_ring(k) words beside the 16 table words (at most 32 KB)
#define WALKW_H_CASES(LAUNCH)                                                                \
  LT_W_CASE(1, LAUNCH) LT_W_CASE(2, LAUNCH) LT_W_CASE(3, LAUNCH) LT_W_CASE(4, LAUNCH)      \
  LT_W_CASE(5, LAUNCH) LT_W_CASE(6, LAUNCH) LT_W_CASE(7, LAUNCH) LT_W_CASE(8, LAUNCH)

static inline size_t walkw_smem(int RW) {
  return (16 + 2 * (size_t)RW * WALKW_THREADS) * sizeof(uint32_t);
}

// outs15: the host array of the 15 output pointers (DenseOut order);
// packed: the caller's (B, ceil(L/16)) int32 scratch
extern "C" int lt_walk_dense(const void* codes, const void* lengths, int B, int L, int k, int H,
                             unsigned n_words, const void* tabs16, const void* bitset, int ME,
                             const void* outs15, void* packed, void* stream) {
  if (k < 1 || k > 255 || H < 1 || H > 8 || L < k || ME != max(L - k, 1) || n_words == 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  DenseOut od;
  memcpy(&od, outs15, sizeof(od));
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  const int L16 = (L + 15) / 16;
  uint32_t* pk = (uint32_t*)packed;
  dense_pack_kernel<<<grid_for((long long)B * L16, 256), 256, 0, st>>>((const uint8_t*)codes, B,
                                                                       L, L16, pk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int RW = walkw_ring(k);
  const unsigned grid = grid_for(B, WALKW_THREADS);
  const int32_t* ln = (const int32_t*)lengths;
  const uint32_t* bs = (const uint32_t*)bitset;
#define LAUNCH(H_)                                                                          \
  walk_dense_kernel<H_><<<grid, WALKW_THREADS, walkw_smem(RW), st>>>(pk, ln, B, L16, L, k, \
                                                                     n_words, tb, bs, ME, RW, od)
  switch (H) {
    WALKW_H_CASES(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int lt_walk_encode_words(const void* packed, const void* lengths, int B, int L16,
                                    int L, int k, int H, unsigned n_words, const void* tabs16,
                                    const void* bitset, int with_conf, int ME, void* meta,
                                    void* tot, void* ev_gap, void* ev_nt, void* ev_bif,
                                    void* conf, void* stream) {
  if (k < 17 || k > 255 || H < 1 || H > 8 || L < k + 1 || ME != L - k ||
      L16 != (L + 15) / 16 || n_words == 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  const int L16c = with_conf ? L16 : 0;
  const int RW = walkw_ring(k);
  const unsigned grid = grid_for(B, WALKW_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* p = (const uint32_t*)packed;
  const int32_t* ln = (const int32_t*)lengths;
  const uint32_t* bs = (const uint32_t*)bitset;
  int32_t* m = (int32_t*)meta;
  int32_t* tt = (int32_t*)tot;
  uint16_t* eg = (uint16_t*)ev_gap;
  uint8_t* en = (uint8_t*)ev_nt;
  uint8_t* eb = (uint8_t*)ev_bif;
  uint16_t* cf = (uint16_t*)conf;
#define LAUNCH(H_)                                                                          \
  walk_encode_words_kernel<H_><<<grid, WALKW_THREADS, walkw_smem(RW), st>>>(                \
      p, ln, B, L16, L, k, n_words, tb, bs, L16c, ME, RW, m, tt, eg, en, eb, cf)
  switch (H) {
    WALKW_H_CASES(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int lt_walk_decode_words(const void* scal, int B, int W, const void* errgaps,
                                    const void* errnts, const void* bifs, long long n_err,
                                    long long n_bif, int L, int L16, int k, int H,
                                    unsigned n_words, const void* tabs16, const void* bitset,
                                    void* out, void* stream) {
  if (k < 17 || k > 255 || H < 1 || H > 8 || W != (k + 15) / 16 || L < k + 1 ||
      L16 != (L + 15) / 16 || n_words == 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  const int RW = walkw_ring(k);
  const unsigned grid = grid_for(B, WALKW_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* sc = (const int32_t*)scal;
  const int32_t* eg = (const int32_t*)errgaps;
  const uint8_t* en = (const uint8_t*)errnts;
  const uint8_t* bf = (const uint8_t*)bifs;
  const uint32_t* bs = (const uint32_t*)bitset;
  uint32_t* o = (uint32_t*)out;
#define LAUNCH(H_)                                                                          \
  walk_decode_words_kernel<H_><<<grid, WALKW_THREADS, walkw_smem(RW), st>>>(                \
      sc, B, W, eg, en, bf, n_err, n_bif, L, L16, k, n_words, tb, bs, RW, o)
  switch (H) {
    WALKW_H_CASES(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
