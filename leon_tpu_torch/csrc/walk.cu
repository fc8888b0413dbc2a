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
// K15 walk_dense — the dense, slot-ordered event tensors of encode_batch,
// for k <= 255 (W = ceil(k/16) <= 16 words of window).
//
// Replaces: leon_tpu/ops/walk.py encode_batch (621-665) -> walk_planes
// (384-402: _anchor_state 357, _anchor_scan 113, _pack_window 147, then
// _walk_side 171-244 once right and once left from the anchor state),
// slotify, _gap_plane (405-416) and _conf_mask (419-429).
//
// Bound on the H100: latency of the dependent Bloom probes, as K4 (4
// one-word probes per step, each step needing the last one's base); the
// outputs are 20 bytes per event slot and one per base, zeroed by memsets.
// Design: one thread per read; the anchor scan rolls (f, r) from the codes
// (the leaving base read back from the row, so no window rides along), the
// anchor's window is re-packed from its k bases as W u32 words, and each
// side walks from it with the window in registers (shl2 masked to 2k bits
// on the right, the reference's unmasked shr2_ins on the left). Each event
// lands at once in its side's next slot: bif rank among solid bases,
// absolute errpos (apos+k+s right, apos-1-s left), errnt rank among
// non-solid bases and the side-local gap (s minus the side's last error
// step minus 1); confirmed bases (one solid candidate, the read's own)
// set their column, so the anchor span is never confirmed. The right side
// runs min(len - k - apos, ME) steps (a base past column L-1 reads column
// L-1, as the reference's clipped gather), the left side apos steps.
// Codes are taken & 3 (the reference's input is 0..3).
// ---------------------------------------------------------------------------

// output pointers, in the reference's dict order: anchored, apos, nbif_r,
// nerr_r, nbif_l, nerr_l, then per side (r, l) bif, errpos, errnt, gap,
// then confirmed
struct DenseOut {
  void* p[15];
};

template <int W, bool RIGHT>
static __device__ __forceinline__ void dense_side(const uint8_t* __restrict__ cr, int L, int k,
                                                  int H, uint32_t n_words, const HashTabs& tb,
                                                  const uint32_t* __restrict__ bits,
                                                  uint32_t top, Kmer<W> fwd, uint32_t f,
                                                  uint32_t r, int apos, int steps,
                                                  uint8_t* __restrict__ bif,
                                                  int32_t* __restrict__ errpos,
                                                  uint8_t* __restrict__ errnt,
                                                  int32_t* __restrict__ gap,
                                                  uint8_t* __restrict__ conf, int32_t* n_bif,
                                                  int32_t* n_err) {
  const int ho = 2 * (k - 1);
  int nb = 0, ne = 0, last = -1;
  for (int s = 0; s < steps; ++s) {
    const int j = RIGHT ? apos + k + s : apos - 1 - s;
    const int b = __ldg(cr + (RIGHT ? min(j, L - 1) : j)) & 3;
    const int o = RIGHT ? (int)((word_at<W>(fwd, ho >> 5) >> (ho & 31)) & 3u)
                        : (int)(fwd.w[0] & 3u);
    uint32_t cf[4], cr4[4];
    const unsigned sm = step_probe(RIGHT, o, f, r, tb, bits, H, n_words, cf, cr4);
    const int scount = __popc(sm);
    const unsigned below = (1u << b) - 1u;
    const bool solid_b = (sm >> b) & 1u;
    if (solid_b) {
      if (scount == 1) {
        if (j < L) conf[j] = 1;
      } else {
        bif[nb++] = (uint8_t)__popc(sm & below);  // rank among solid
      }
    } else {
      errpos[ne] = j;
      errnt[ne] = (uint8_t)__popc(~sm & below);  // rank among non-solid
      gap[ne] = s - last - 1;
      last = s;
      ++ne;
    }
    // on an error with a solid candidate, advance on the smallest solid base
    const int b_adv = (!solid_b && scount >= 1) ? __ffs(sm) - 1 : b;
    f = sel4v(cf, b_adv);
    r = sel4v(cr4, b_adv);
    fwd = RIGHT ? shl2<W>(fwd, (uint32_t)b_adv, top) : shr2_ins<W>(fwd, (uint32_t)b_adv, k);
  }
  *n_bif = nb;
  *n_err = ne;
}

template <int W>
__global__ void walk_dense_kernel(const uint8_t* __restrict__ codes,
                                  const int32_t* __restrict__ lengths, int B, int L, int k,
                                  int H, uint32_t n_words, const __grid_constant__ HashTabs tb,
                                  const uint32_t* __restrict__ bits, int ME, uint32_t top,
                                  const __grid_constant__ DenseOut o) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const uint8_t* cr = codes + (size_t)row * L;
  const int len = lengths[row];
  const int lenc = min(len, L);

  // anchor: the member position with the smallest min(f, r); the first
  // index wins ties and an all-0xFFFFFFFF row gives 0 (walk.py:357-381)
  uint32_t f = 0, r = 0, af = 0, ar = 0, best = 0xFFFFFFFFu;
  bool anchored = false;
  int apos = 0;
  for (int j = 0; j < lenc; ++j) {
    const int x = __ldg(cr + j) & 3;
    if (j >= k) {
      const int ob = __ldg(cr + j - k) & 3;  // base leaving the window
      f = rol1(f ^ sel4(tb.t[2], ob)) ^ sel4(tb.t[0], x);
      r = ror1(r ^ sel4(tb.t[1], ob)) ^ sel4(tb.t[3], x);
    } else {
      f = rol1(f) ^ sel4(tb.t[0], x);
      r = r ^ rolr(sel4(tb.t[1], x), j);
    }
    const int p = j - k + 1;
    if (p >= 0) {
      const bool mem = probe(bits, f, r, H, n_words);
      const uint32_t v = mem ? min(f, r) : 0xFFFFFFFFu;
      anchored |= mem;
      if (p == 0 || v < best) {
        best = v;
        apos = p;
        af = f;
        ar = r;
      }
    }
  }
  ((uint8_t*)o.p[0])[row] = anchored;
  ((int32_t*)o.p[1])[row] = apos;
  int32_t* nbif_r = (int32_t*)o.p[2] + row;
  int32_t* nerr_r = (int32_t*)o.p[3] + row;
  int32_t* nbif_l = (int32_t*)o.p[4] + row;
  int32_t* nerr_l = (int32_t*)o.p[5] + row;
  if (!anchored) {
    *nbif_r = *nerr_r = *nbif_l = *nerr_l = 0;
    return;
  }
  Kmer<W> afwd = {};
  for (int i = 0; i < k; ++i) afwd = shl2<W>(afwd, (uint32_t)(__ldg(cr + apos + i) & 3), top);
  const size_t ev = (size_t)row * ME;
  uint8_t* conf = (uint8_t*)o.p[14] + (size_t)row * L;
  dense_side<W, true>(cr, L, k, H, n_words, tb, bits, top, afwd, af, ar, apos,
                      min(max(len - k - apos, 0), ME), (uint8_t*)o.p[6] + ev,
                      (int32_t*)o.p[7] + ev, (uint8_t*)o.p[8] + ev, (int32_t*)o.p[9] + ev, conf,
                      nbif_r, nerr_r);
  dense_side<W, false>(cr, L, k, H, n_words, tb, bits, top, afwd, af, ar, apos, apos,
                       (uint8_t*)o.p[10] + ev, (int32_t*)o.p[11] + ev, (uint8_t*)o.p[12] + ev,
                       (int32_t*)o.p[13] + ev, conf, nbif_l, nerr_l);
}

// ---------------------------------------------------------------------------
// K18 walk_encode_words and K19 walk_decode_words — K4's encode and decode
// re-walk with the window as W = ceil(k/16) = 2..16 u32 words (17 <= k <=
// 255; the main path takes them for 32 <= k <= 255, K4 serves k <= 31).
//
// Replaces: leon_tpu/ops/walk.py encode_batch_compact_packed (554-565) ->
// _encode_compact_impl (432-545) with _anchor_state (357), _anchor_scan
// (113), _pack_window (147) and _walk_fused (247); and
// decode_batch_flat_packed (819-841) -> decode_batch_flat, decode_batch and
// _walk_decode_fused (700-796), at any W.
//
// Bound on the H100: as K4, the latency of the dependent Bloom probes (4
// one-word probes per step, each step needing the last one's base); the
// W-word window adds a few register shifts a step. Design: K4's, one thread
// per read with the walk state in registers. K18's anchor scan rolls (f, r)
// and reads the leaving base back from the packed row (no window rides
// along the scan), then re-packs the anchor's k bases as Kmer<W>; the walk
// advances with shl2 masked to 2k bits (right) and the reference's
// unmasked shr2_ins (left). The r chain's rotate while the first k bases
// enter is j & 31 (the reference's min(j, k-1) & 31 wraps at k >= 33).
// Outputs are K4's: meta, tot, the event rows in walk order and the conf
// bits, so walk_pack serves both; errpos is implied by the gaps (side-
// local), as in the flat layout. K19 takes scal (B, 9+W), hashes the anchor
// from scratch (hash_kmer<W>) and walks the flat streams as K4 does.
// ---------------------------------------------------------------------------

template <int W>
static __device__ __forceinline__ int leaving_w(bool in_r, const Kmer<W>& fwd, int hs) {
  return in_r ? (int)((word_at<W>(fwd, hs >> 5) >> (hs & 31)) & 3u) : (int)(fwd.w[0] & 3u);
}

template <int W>
static __device__ __forceinline__ Kmer<W> advance_w(bool in_r, const Kmer<W>& fwd, int b, int k,
                                                    uint32_t top) {
  return in_r ? shl2<W>(fwd, (uint32_t)b, top) : shr2_ins<W>(fwd, (uint32_t)b, k);
}

template <int W>
__global__ void walk_encode_words_kernel(const uint32_t* __restrict__ packed,
                                         const int32_t* __restrict__ lengths, int B, int L16,
                                         int L, int k, int H, uint32_t n_words, uint32_t top,
                                         const __grid_constant__ HashTabs tb,
                                         const uint32_t* __restrict__ bits, int L16c, int ME,
                                         int32_t* __restrict__ meta, int32_t* __restrict__ tot,
                                         uint16_t* __restrict__ ev_gap,
                                         uint8_t* __restrict__ ev_nt,
                                         uint8_t* __restrict__ ev_bif,
                                         uint16_t* __restrict__ conf) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const uint32_t* pr = packed + (size_t)row * L16;
  uint16_t* cw = conf + (size_t)row * L16c;
  for (int w = 0; w < L16c; ++w) cw[w] = 0;
  const int len = min(lengths[row], L);
  const int hs = 2 * (k - 1);

  // anchor: the member position with the smallest min(f, r); the first
  // index wins ties and an all-0xFFFFFFFF row gives 0 (walk.py:357-381)
  uint32_t f = 0, r = 0, af = 0, ar = 0, best = 0xFFFFFFFFu;
  bool anchored = false;
  int apos = 0;
  for (int j = 0; j < len; ++j) {
    const int x = base_at(pr, j);
    if (j >= k) {
      const int o = base_at(pr, j - k);  // base leaving the window
      f = rol1(f ^ sel4(tb.t[2], o)) ^ sel4(tb.t[0], x);
      r = ror1(r ^ sel4(tb.t[1], o)) ^ sel4(tb.t[3], x);
    } else {
      f = rol1(f) ^ sel4(tb.t[0], x);
      r = r ^ rolr(sel4(tb.t[1], x), j);
    }
    const int p = j - k + 1;
    if (p >= 0) {
      const bool mem = probe(bits, f, r, H, n_words);
      const uint32_t v = mem ? min(f, r) : 0xFFFFFFFFu;
      anchored |= mem;
      if (p == 0 || v < best) {
        best = v;
        apos = p;
        af = f;
        ar = r;
      }
    }
  }
  Kmer<W> afwd = {};
  for (int i = 0; i < k; ++i) afwd = shl2<W>(afwd, (uint32_t)base_at(pr, min(apos + i, L - 1)), top);

  // fused walk: nr right steps from the anchor, then reset and apos left
  // steps (walk.py:247-354)
  int nerr_r = 0, nerr_l = 0, nbif_r = 0, nbif_l = 0;
  const int total = anchored ? max(len - k, 0) : 0;
  const int nr = max(len - k - apos, 0);
  uint16_t* eg = ev_gap + (size_t)row * ME;
  uint8_t* en = ev_nt + (size_t)row * ME;
  uint8_t* eb = ev_bif + (size_t)row * ME;
  Kmer<W> fwd = afwd;
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
        step_probe(in_r, leaving_w<W>(in_r, fwd, hs), f, r, tb, bits, H, n_words, cf, cr);
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
    fwd = advance_w<W>(in_r, fwd, b_adv, k, top);
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

template <int W>
__global__ void walk_decode_words_kernel(const int32_t* __restrict__ scal, int B,
                                         const int32_t* __restrict__ errgaps,
                                         const uint8_t* __restrict__ errnts,
                                         const uint8_t* __restrict__ bifs, long long n_err,
                                         long long n_bif, int L, int L16, int k, int H,
                                         uint32_t n_words, uint32_t top,
                                         const __grid_constant__ HashTabs tb,
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
  Kmer<W> afwd;
#pragma unroll
  for (int j = 0; j < W; ++j) afwd.w[j] = (uint32_t)sc[9 + j];
  const int ME = max(1, L - k);
  const int hs = 2 * (k - 1);

  for (int i = 0; i < k; ++i) {  // the anchor's own bases
    const int p = apos + i;
    if (p >= 0 && p < L) o[p >> 4] |= (uint32_t)base_of<W>(afwd, i, k) << (2 * (p & 15));
  }
  uint32_t af, ar;
  hash_kmer<W>(afwd, k, tb, &af, &ar);
  uint32_t f = af, r = ar;
  Kmer<W> fwd = afwd;

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
        step_probe(in_r, leaving_w<W>(in_r, fwd, hs), f, r, tb, bits, H, n_words, cf, cr);
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
    fwd = advance_w<W>(in_r, fwd, b_adv, k, top);
  }
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

// outs15: the host array of the 15 output pointers (DenseOut order)
extern "C" int lt_walk_dense(const void* codes, const void* lengths, int B, int L, int k, int H,
                             unsigned n_words, unsigned top, const void* tabs16,
                             const void* bitset, int ME, const void* outs15, void* stream) {
  if (k < 1 || k > 255 || H < 1 || H > 8 || L < k || ME != max(L - k, 1) || n_words == 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  DenseOut od;
  memcpy(&od, outs15, sizeof(od));
  // bytes per read of each output: the (B, ME) event slots and the
  // (B, L) confirmed row must read zero past what the walk writes
  const size_t me = (size_t)ME;
  const size_t per_row[15] = {1, 4, 4, 4, 4, 4, me, 4 * me, me, 4 * me,
                              me, 4 * me, me, 4 * me, (size_t)L};
  for (int i = 0; i < 15; ++i) {
    cudaError_t e = cudaMemsetAsync(od.p[i], 0, per_row[i] * (size_t)B, st);
    if (e != cudaSuccess) return (int)e;
  }
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  const unsigned grid = grid_for(B, WALK_THREADS);
  const uint8_t* c = (const uint8_t*)codes;
  const int32_t* ln = (const int32_t*)lengths;
  const uint32_t* bs = (const uint32_t*)bitset;
#define LAUNCH(W_) \
  walk_dense_kernel<W_><<<grid, WALK_THREADS, 0, st>>>(c, ln, B, L, k, H, n_words, tb, bs, ME, \
                                                       top, od)
  switch ((k + 15) / 16) {
    LT_W_CASE(1, LAUNCH)
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int lt_walk_encode_words(const void* packed, const void* lengths, int B, int L16,
                                    int L, int k, int H, unsigned n_words, unsigned top,
                                    const void* tabs16, const void* bitset, int with_conf, int ME,
                                    void* meta, void* tot, void* ev_gap, void* ev_nt,
                                    void* ev_bif, void* conf, void* stream) {
  if (k < 17 || k > 255 || H < 1 || H > 8 || L < k + 1 || ME != L - k ||
      L16 != (L + 15) / 16 || n_words == 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  const unsigned grid = grid_for(B, WALK_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* p = (const uint32_t*)packed;
  const int32_t* ln = (const int32_t*)lengths;
  const uint32_t* bs = (const uint32_t*)bitset;
  const int L16c = with_conf ? L16 : 0;
  int32_t* m = (int32_t*)meta;
  int32_t* tt = (int32_t*)tot;
  uint16_t* eg = (uint16_t*)ev_gap;
  uint8_t* en = (uint8_t*)ev_nt;
  uint8_t* eb = (uint8_t*)ev_bif;
  uint16_t* cf = (uint16_t*)conf;
#define LAUNCH(W_)                                                                          \
  walk_encode_words_kernel<W_><<<grid, WALK_THREADS, 0, st>>>(p, ln, B, L16, L, k, H, n_words, \
                                                              top, tb, bs, L16c, ME, m, tt, eg, \
                                                              en, eb, cf)
  switch ((k + 15) / 16) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int lt_walk_decode_words(const void* scal, int B, int W, const void* errgaps,
                                    const void* errnts, const void* bifs, long long n_err,
                                    long long n_bif, int L, int L16, int k, int H,
                                    unsigned n_words, unsigned top, const void* tabs16,
                                    const void* bitset, void* out, void* stream) {
  if (k < 17 || k > 255 || H < 1 || H > 8 || W != (k + 15) / 16 || L < k + 1 ||
      L16 != (L + 15) / 16 || n_words == 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  HashTabs tb;
  memcpy(&tb, tabs16, sizeof(tb));
  const unsigned grid = grid_for(B, WALK_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* sc = (const int32_t*)scal;
  const int32_t* eg = (const int32_t*)errgaps;
  const uint8_t* en = (const uint8_t*)errnts;
  const uint8_t* bf = (const uint8_t*)bifs;
  const uint32_t* bs = (const uint32_t*)bitset;
  uint32_t* o = (uint32_t*)out;
#define LAUNCH(W_)                                                                         \
  walk_decode_words_kernel<W_><<<grid, WALK_THREADS, 0, st>>>(sc, B, eg, en, bf, n_err, n_bif, \
                                                              L, L16, k, H, n_words, top, tb,  \
                                                              bs, o)
  switch (W) {
    LT_W_CASES_2_4(LAUNCH)
    LT_W_CASES_5_16(LAUNCH)
    LT_W_NO_INSTANCE
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
