"""Unitig coding of the solid k-mer set (counterpart of
leon_tpu/ops/unitig.py).

The archive stores the solid set as unitigs and the decoder rebuilds the
bit-identical Bloom filter from them (FORMAT.md §4a; see the reference
module's docstring for the construction). Two builders give the same
payload byte for byte:

- Host half: a copy of unitig.py:49-341 and 790-936 (the native host
  builder ``build_np_payload``, the payload codec, the spelling), with the
  k-mer and Bloom imports pointed at the port, because the reference
  module reaches jax through them.
- Device half (new), kernels K5-K8 (csrc/unitig.cu), used when the solid
  count is at most ``unitig_device_max_kmers``: ``unitig_links`` (K5: the
  successor search and the internal edges), ``unitig_rank`` (K6: the
  whole chain ranking in one list-ranking pass, with ``break_cycles``),
  ``unitig_emit`` (K7: chain ids, lengths and the packed bases) and
  ``solid_lookup`` (K8: the DICT's anchor k-mers into the solid run). They
  replace _build_dev_impl, _topbits, _bucket_starts, _searchsorted_words_dev
  and solid_indices_dev (unitig.py:351-645, 938-963). The kernels read the
  solid run only, in the form the counter gives it: (M,) int64 keys for
  k <= 31, (M, W) int32 rows of u32 words for 32 <= k <= 255 (W =
  ceil(k/16) = 2..16; K5, K7's bases and K8 have an instance per W).
  ``dispatch_build`` takes the solid run the caller compacted (K2's solid
  mode, ops/count.py ``compact_solid``, the reference's _compact_dev; or
  K14's, which the multiword counter already ran for its Bloom build).
  ``dispatch_build``, ``drain_build`` and
  ``solid_indices`` keep the reference's contracts (unitig.py:699-782,
  938-963). Each wrapper has a plain PyTorch version (``build_plain`` and
  ``chain_rank_plain`` for the composites), which the wrapper takes for
  CPU tensors.

tests/test_torch_unitig.py (k <= 31) and tests/test_torch_unitig_words.py
(32 <= k <= 255) hold both builders to the reference's;
tests/test_torch_pipeline.py and test_torch_unitig_words.py compare whole
archives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from leon_tpu_torch.utils import varint
from leon_tpu_torch import kernels, state

__all__ = [
    "chains_cap", "build_np_payload", "payload_from", "parse_payload",
    "rebuild_bitset_np", "spell_canon", "sort_rows_bigint", "solid_kmers_sorted",
    "unitig_links", "unitig_rank", "unitig_emit", "solid_lookup", "chain_rank",
    "chain_rank_plain", "build", "build_plain", "dispatch_build", "drain_build",
    "solid_indices", "LinksNotChains",
]

def _bucket(n: int, floor: int = 1 << 12) -> int:
    """1/8-octave size buckets (mirrors ops.count._bucket_size)."""
    gran = max(floor, 1 << max(0, (n - 1).bit_length() - 3))
    return -(-n // gran) * gran


def chains_cap(nu: int) -> int:
    """Static chain-count capacity for a distinct-set size nu. FROZEN: the
    np and device paths must agree on the overflow rule so the section
    choice (UNITIGS vs BLOOM) is identical on both."""
    return max(4096, _bucket(max(1, nu)) >> 6)


RETRY_FACTOR = 8  # one capacity retry at cap*RETRY_FACTOR, then BLOOM


# ---------------------------------------------------------------------------
# numpy reference implementation
# ---------------------------------------------------------------------------


def _np_lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a < b over (..., W) u32 LSW-first vectors as big integers."""
    W = a.shape[-1]
    less = np.zeros(a.shape[:-1], bool)
    eq = np.ones(a.shape[:-1], bool)
    for j in range(W - 1, -1, -1):
        less |= eq & (a[..., j] < b[..., j])
        eq &= a[..., j] == b[..., j]
    return less


def _np_shl2(words: np.ndarray, base: int, k: int) -> np.ndarray:
    """((kmer << 2) | base) & mask — np mirror of kmer.shl2."""
    from leon_tpu_torch.ops.kmer import top_mask

    W = words.shape[-1]
    out = np.empty_like(words)
    out[..., 0] = (words[..., 0] << np.uint32(2)) | np.uint32(base)
    for j in range(1, W):
        out[..., j] = (words[..., j] << np.uint32(2)) | (words[..., j - 1] >> np.uint32(30))
    out[..., W - 1] &= np.uint32(top_mask(k))
    return out


def _np_shr2_ins(words: np.ndarray, base: int, k: int) -> np.ndarray:
    """(kmer >> 2) | (base << 2(k-1)) — np mirror of kmer.shr2_ins."""
    W = words.shape[-1]
    out = np.empty_like(words)
    for j in range(W - 1):
        out[..., j] = (words[..., j] >> np.uint32(2)) | (words[..., j + 1] << np.uint32(30))
    out[..., W - 1] = words[..., W - 1] >> np.uint32(2)
    t = 2 * (k - 1)
    out[..., t // 32] |= np.uint32(base) << np.uint32(t % 32)
    return out


def _np_searchsorted_words(hay: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """hay (M, W) sorted ascending as big ints -> (N,) index or -1."""
    W = hay.shape[1]
    dt = np.dtype([(f"w{j}", ">u4") for j in range(W - 1, -1, -1)])

    def rec(x):
        r = np.empty(x.shape[0], dtype=dt)
        for j in range(W):
            r[f"w{j}"] = x[:, j]
        return r

    if hay.shape[0] == 0:
        return np.full(needles.shape[0], -1, np.int64)
    h, n = rec(np.ascontiguousarray(hay)), rec(np.ascontiguousarray(needles))
    idx = np.searchsorted(h, n)
    idxc = np.clip(idx, 0, hay.shape[0] - 1)
    return np.where(h[idxc] == n, idxc, -1)


def _np_chains(words: np.ndarray, counts: np.ndarray, cutoff: int, k: int):
    """Core graph construction + list ranking. Returns per-directed-node
    arrays (nxt-final, head, rank, kept, keep_head) plus fwd forms."""
    from leon_tpu_torch.ops.kmer import revcomp_words_batch_np

    M = words.shape[0]
    solid = counts.astype(np.int64) >= cutoff
    rc = revcomp_words_batch_np(words, k) if M else words.copy()
    # F[did] = spelled form of directed node did = 2*i + o
    F = np.stack([words, rc], axis=1).reshape(2 * M, -1)
    solid2 = np.repeat(solid, 2)

    succ = np.full(2 * M, -1, np.int64)
    outc = np.zeros(2 * M, np.int32)
    for o in (0, 1):
        ids = np.arange(M) * 2 + o
        x = F[ids]
        xr = F[ids ^ 1]
        for b in range(4):
            y = _np_shl2(x, b, k)
            yr = _np_shr2_ins(xr, 3 - b, k)
            take_rc = _np_lex_less(yr, y)
            cy = np.where(take_rc[:, None], yr, y)
            j = _np_searchsorted_words(words, cy)
            hit = j >= 0
            hit &= np.where(hit, counts[np.maximum(j, 0)].astype(np.int64) >= cutoff, False)
            did = j * 2 + take_rc
            outc[ids] += hit
            first = hit & (outc[ids] == 1)
            succ[ids] = np.where(first, did, succ[ids])
    inc = outc.reshape(M, 2)[:, ::-1].reshape(-1)  # in(did) = out(twin)
    s = np.maximum(succ, 0)
    internal = solid2 & (outc == 1) & (succ >= 0) & (inc[s] == 1) & solid2[s]
    nxt = np.where(internal, succ, -1)

    ids2 = np.arange(2 * M)
    prev = np.full(2 * M, -1, np.int64)
    prev[nxt[nxt >= 0]] = ids2[nxt >= 0]

    D = max(1, int(2 * M - 1).bit_length()) + 1
    # cycle detection: does the forward orbit reach a terminal?
    P = np.where(nxt >= 0, nxt, ids2)
    reached = nxt < 0
    for _ in range(D):
        reached |= reached[P]
        P = P[P]
    cyc = ~reached
    if cyc.any():
        m = np.where(cyc, ids2, 2 * M)
        P = np.where(nxt >= 0, nxt, ids2)
        for _ in range(D):
            m = np.minimum(m, m[P])
            P = P[P]
        hv = ids2[cyc & (m == ids2)]
        pv = prev[hv]
        nxt[pv] = -1
        prev[hv] = -1

    # head + rank by pointer doubling on prev
    P = np.where(prev >= 0, prev, ids2)
    R = (prev >= 0).astype(np.int64)
    for _ in range(D):
        R = R + R[P]
        P = P[P]
    head, rank = P, R

    # component min id / min twin id (suffix mins evaluated at the head)
    P = np.where(nxt >= 0, nxt, ids2)
    m = np.where(solid2, ids2, 2 * M)
    tm = np.where(solid2, ids2 ^ 1, 2 * M)
    for _ in range(D):
        m = np.minimum(m, m[P])
        tm = np.minimum(tm, tm[P])
        P = P[P]
    keep_head = solid2 & (prev < 0) & (m <= tm)
    kept = solid2 & keep_head[head]
    return F, nxt, head, rank, kept, keep_head


def _native_chains(words: np.ndarray, counts: np.ndarray, cutoff: int,
                   k: int, nthreads: int = 0):
    """_np_chains via the native O(n) builder (leon_unitig_chains):
    serial chain walking + prefix-bucketed successor search instead of
    structured-dtype searchsorted + pointer-doubling gathers (~18 s per
    1M rows in numpy — the chr-scale 36M-row build must finish under the
    encode stage it overlaps). Bit-identical to _np_chains (tested).
    Returns None when the native lib is unavailable."""
    from leon_tpu_torch import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "leon_unitig_chains"):
        return None
    M, W = words.shape
    words_c = np.ascontiguousarray(words, dtype=np.uint32)
    counts_c = np.ascontiguousarray(counts, dtype=np.int32)
    rc = np.empty((M, W), np.uint32)
    nxt = np.empty(2 * M, np.int64)
    head = np.empty(2 * M, np.int64)
    rank = np.empty(2 * M, np.int64)
    kept = np.empty(2 * M, np.uint8)
    keep_head = np.empty(2 * M, np.uint8)
    rcode = lib.leon_unitig_chains(
        M, W, words_c.ctypes.data, counts_c.ctypes.data, int(cutoff), k,
        rc.ctypes.data, nxt.ctypes.data, head.ctypes.data, rank.ctypes.data,
        kept.ctypes.data, keep_head.ctypes.data, int(nthreads),
    )
    if rcode != 0:
        return None
    F = np.stack([words_c, rc], axis=1).reshape(2 * M, W)
    return F, nxt, head, rank, kept.astype(bool), keep_head.astype(bool)


class LinksNotChains(ValueError):
    """leon_unitig_build's -2: the rows' successor links are not chains and
    cycles, so a walk never ends (rows that are not distinct, such as the
    all-zero pad rows appended where the clamped histogram overcounts the
    solid rows). The reference's builder loops there."""


def _native_build_payload(words: np.ndarray, counts: np.ndarray, cutoff: int,
                          k: int, nu: int, nthreads: int = 0):
    """One-call native build (leon_unitig_build): parallel chain
    resolution + direct base emission, skipping the head/rank/kept
    scatter arrays and the numpy bases scatter entirely (those phases
    were ~2/3 of the host-thread build at bench scale, and they run
    under the encode loop's GIL). Returns (payload_or_None,) when the
    native path ran — payload None means the frozen chains_cap rule says
    BLOOM — or None when the native lib is unavailable (caller falls
    through to the two-phase path). Bit-identical to build_np_payload's
    numpy assembly (tested)."""
    import ctypes

    from leon_tpu_torch import native
    from leon_tpu_torch.ops.kmer import pack_2bit_np, words_to_codes_batch_np

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "leon_unitig_build"):
        return None
    M, W = words.shape
    words_c = np.ascontiguousarray(words, dtype=np.uint32)
    counts_c = np.ascontiguousarray(counts, dtype=np.int32)
    rc = np.empty((M, W), np.uint32)
    len_nodes = np.empty(M, np.int64)
    head_ids = np.empty(M, np.int64)
    interior = np.empty(M, np.uint8)
    n_chains = lib.leon_unitig_build(
        M, W, words_c.ctypes.data, counts_c.ctypes.data, int(cutoff), k,
        rc.ctypes.data, len_nodes.ctypes.data, head_ids.ctypes.data,
        interior.ctypes.data, int(nthreads),
    )
    if n_chains == -2:
        raise LinksNotChains(f"a chain walk over {M} rows never ends")
    if n_chains < 0:
        return None
    if n_chains == 0 or n_chains > chains_cap(nu) * RETRY_FACTOR:
        return (None,)
    heads = head_ids[:n_chains]
    ln = len_nodes[:n_chains]
    bases_per = ln + (k - 1)
    start = np.concatenate([[0], np.cumsum(bases_per)[:-1]])
    total = int(bases_per.sum())
    bases = np.zeros(total, np.uint8)
    # temporaries must stay referenced across the call (.ctypes.data is a
    # bare address — a freed temporary dangles)
    dst_starts = np.ascontiguousarray(start + (k - 1))
    src_starts = np.ascontiguousarray(np.concatenate([[0], np.cumsum(ln)[:-1]]))
    ln_c = np.ascontiguousarray(ln)
    lib.leon_ragged_move(
        bases.ctypes.data, dst_starts.ctypes.data,
        interior.ctypes.data, src_starts.ctypes.data,
        ln_c.ctypes.data, n_chains,
    )
    hi = (heads >> 1).astype(np.int64)
    hrows = np.where((heads & 1).astype(bool)[:, None], rc[hi], words_c[hi])
    codes = words_to_codes_batch_np(hrows, k)
    for j in range(k - 1):
        bases[start + j] = codes[:, j]
    return (payload_from(n_chains, ln, pack_2bit_np(bases), total, k),)


def build_np_payload(words: np.ndarray, counts: np.ndarray, cutoff: int,
                     k: int, nu: int | None = None,
                     nthreads: int = 0) -> bytes | None:
    """Numpy unitig build. words: (M, W) u32 LSW-first distinct canonical
    k-mers sorted ascending (pad rows, if any, must sort last with count
    0). Returns the raw (unframed) payload, or None when the chain count
    exceeds the frozen capacity rule (caller falls back to BLOOM)."""
    from leon_tpu_torch.ops.kmer import pack_2bit_np, words_to_codes_batch_np

    M = words.shape[0]
    if nu is None:
        nu = M
    if M == 0:
        return None
    fast = _native_build_payload(words, counts, cutoff, k, nu, nthreads)
    if fast is not None:
        return fast[0]
    nat = _native_chains(words, counts, cutoff, k, nthreads)
    if nat is not None:
        F, nxt, head, rank, kept, keep_head = nat
    else:
        F, nxt, head, rank, kept, keep_head = _np_chains(words, counts, cutoff, k)
    ids2 = np.arange(2 * M)
    heads = ids2[keep_head]
    n_chains = heads.size
    if n_chains == 0 or n_chains > chains_cap(nu) * RETRY_FACTOR:
        return None
    cid_of = np.full(2 * M, -1, np.int64)
    cid_of[heads] = np.arange(n_chains)
    cid = cid_of[head]

    tails = kept & (nxt < 0)
    len_nodes = np.zeros(n_chains, np.int64)
    len_nodes[cid[tails]] = rank[tails] + 1
    bases_per = len_nodes + (k - 1)
    start = np.concatenate([[0], np.cumsum(bases_per)[:-1]])
    total = int(bases_per.sum())
    bases = np.zeros(total, np.uint8)

    ku = ids2[kept]
    bases[start[cid[ku]] + (k - 1) + rank[ku]] = F[ku, 0] & 3
    codes = words_to_codes_batch_np(F[heads], k)  # (n_chains, k)
    for j in range(k - 1):
        bases[start + j] = codes[:, j]
    return payload_from(n_chains, len_nodes, pack_2bit_np(bases), total, k)


# ---------------------------------------------------------------------------
# Device half: kernels K5-K8 and their plain versions
# ---------------------------------------------------------------------------
#
# Input: the solid run, sorted distinct rows with every row solid: (M,)
# int64 keys (k <= 31) or (M, W) int32 rows holding u32 words, LSW first,
# sorted MSW-first as unsigned (32 <= k <= 255): a counted run compacted by
# K2's or K14's solid mode; ids stay order-isomorphic, so the payload is the
# uncompacted build's (unitig.py:663-669). Directed
# node d = 2*i + o spells row i's k-mer (o = 0) or its reverse complement
# (o = 1). Node arrays are int32. K6 state S is (2M, 4) int32: [P, c0, c1,
# 0] (the modes are in csrc/unitig.cu). The plain versions carry W-word
# rows as u32 values in int64.

ACYCLIC, FULL, RANK = 0, 1, 2  # K6 modes
_M32 = 0xFFFFFFFF


def _check_run(rows, k: int, name: str) -> None:
    """The run's form follows k: W-word rows past 31, one int64 key up to it."""
    if k > 31:
        from leon_tpu_torch.ops.kmer import MAX_K_WORDS, words_for_k

        kernels.need(k <= MAX_K_WORDS, f"{name}: k={k} > {MAX_K_WORDS}")
        kernels.need(rows.dtype == torch.int32 and rows.dim() == 2
                     and rows.shape[1] == words_for_k(k),
                     f"{name}: at k={k} the run must be (M, {words_for_k(k)}) int32 words")
    else:
        kernels.need(k >= 1, f"{name}: k={k} < 1")
        kernels.need(rows.dtype == torch.int64 and rows.dim() == 1,
                     f"{name}: at k={k} the run must be (M,) int64 keys")
    kernels.need(2 * rows.shape[0] < 1 << 31, f"{name}: 2M node ids overflow int32")


def _check_nodes(M: int, *arrs, name: str) -> None:
    for a in arrs:
        kernels.need(a.dtype == torch.int32 and a.shape == (2 * M,),
                     f"{name}: node arrays must be (2M,) int32")


def _check_state(S, name: str) -> None:
    kernels.need(S.dtype == torch.int32 and S.dim() == 2 and S.shape[1] == 4,
                 f"{name}: state must be (N, 4) int32")


def _rev2_u32(x: torch.Tensor) -> torch.Tensor:
    """The 2-bit groups of each u32 value (in int64) in reverse order
    (unitig.py rev2_u32, 443-447)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _M32


def _revcomp_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of (M,) int64 keys, or of (M, W) u32 words in
    int64 by the reference's identity (unitig.py:440-459): complement,
    reverse each word's groups and the word order, shift right by the
    32W - 2k pad bits."""
    if x.dim() == 1:
        rc = torch.zeros_like(x)
        for i in range(k):
            rc |= (3 - ((x >> (2 * i)) & 3)) << (2 * (k - 1 - i))
        return rc
    W = x.shape[1]
    rev = [_rev2_u32(~x[:, W - 1 - j] & _M32) for j in range(W)]
    pad = 32 * W - 2 * k
    if pad:
        rev = [(rev[j] >> pad) | ((rev[j + 1] << (32 - pad)) & _M32 if j + 1 < W else 0)
               for j in range(W)]
    return torch.stack(rev, dim=1)


def _u32_rows(rows: torch.Tensor) -> torch.Tensor:
    """The run as the plain versions carry it: int64 keys as they are,
    int32 words as u32 values in int64."""
    return rows if rows.dim() == 1 else rows.to(torch.int64) & _M32


def _node_keys_plain(rows: torch.Tensor, k: int) -> torch.Tensor:
    """Spelled form of every directed node: (2M,) keys or (2M, W) words,
    from _u32_rows' form."""
    rc = _revcomp_plain(rows, k)
    return torch.stack([rows, rc], dim=1).reshape(-1, *rows.shape[1:])


def _find_plain(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Index of each q in the sorted distinct rows (M > 0), or -1: rows and
    q as _u32_rows gives them. Keys take torch.searchsorted; W-word rows a
    lexicographic binary search (torch.searchsorted takes 1-D keys only)."""
    M = rows.shape[0]
    if rows.dim() == 1:
        j = torch.searchsorted(rows, q)
        jc = torch.clamp(j, max=M - 1)
        return torch.where((j < M) & (rows[jc] == q), jc, -1)
    from leon_tpu_torch.ops.kmer import lex_less

    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, M)
    for _ in range(M.bit_length()):
        mid = (lo + hi) >> 1
        act = lo < hi
        less = lex_less(rows[torch.clamp(mid, max=M - 1)], q)
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)
    jc = torch.clamp(lo, max=M - 1)
    return torch.where((lo < M) & (rows[jc] == q).all(dim=1), jc, -1)


LINKS_TABLE_MAX = 26  # K5's most table bits (K5_TBITS_MAX in csrc/unitig.cu)


def links_table_bits(M: int, k: int) -> int:
    """Bits T of K5's prefix table over a run of M rows: bitlen(M), so a
    bucket holds about one row, at most LINKS_TABLE_MAX and 2k - 2 (the
    four forward candidates of a node then share a bucket). Any T gives
    the same links (csrc/unitig.cu); bitlen(M) - 1 measured the same on
    the H100 (PERF.md §6)."""
    return max(0, min(M.bit_length(), LINKS_TABLE_MAX, 2 * k - 2))


def _buckets(rows: torch.Tensor, k: int, T: int) -> torch.Tensor:
    """(2^T + 1,) int32 prefix table over the top T bits (card)."""
    starts = torch.empty((1 << T) + 1, dtype=torch.int32, device=rows.device)
    lib, st = kernels.lib(), kernels.stream(rows)
    if rows.dim() == 1:
        rc = lib.lt_unitig_buckets(rows.data_ptr(), rows.shape[0], k, T, starts.data_ptr(), st)
    else:
        rc = lib.lt_unitig_buckets_words(rows.data_ptr(), rows.shape[0], rows.shape[1], k, T,
                                         starts.data_ptr(), st)
    kernels.check(rc, "unitig_buckets")
    return starts


def unitig_links(rows: torch.Tensor, k: int):
    """K5: (nxt, prev) (2M,) int32 — each directed node's successor along
    an internal edge and its predecessor, -1 where none (unitig.py:469-508).
    rows: a non-empty solid run. The search table has links_table_bits
    bits."""
    _check_run(rows, k, "unitig_links")
    kernels.need(rows.shape[0] > 0, "unitig_links: empty run")
    if not kernels.on_cuda(rows, "unitig_links"):
        return unitig_links_plain(rows, k)
    rows = rows.contiguous()
    M = rows.shape[0]
    T = links_table_bits(M, k)
    starts = _buckets(rows, k, T)
    so = torch.empty(5 * 2 * M, dtype=torch.uint8, device=rows.device)  # succ, out-degrees
    nxt, prev = (torch.empty(2 * M, dtype=torch.int32, device=rows.device) for _ in range(2))
    ptrs = (T, starts.data_ptr(), so.data_ptr(), nxt.data_ptr(), prev.data_ptr(),
            kernels.stream(rows))
    if rows.dim() == 1:
        rc = kernels.lib().lt_unitig_links(rows.data_ptr(), M, k, *ptrs)
    else:
        rc = kernels.lib().lt_unitig_links_words(rows.data_ptr(), M, rows.shape[1], k, *ptrs)
    kernels.check(rc, "unitig_links")
    kernels.launches["unitig_links"] += 1
    return nxt, prev


def _successor_plain(x: torch.Tensor, xr: torch.Tensor, b: int, k: int):
    """A node's successor by base b in canonical form, and whether that is
    its twin: y = x << 2 | b (top masked), yr = xr >> 2 | (3 - b) << 2(k-1),
    yr only when strictly smaller; over keys or words."""
    if x.dim() == 1:
        low = (1 << (2 * k - 2)) - 1  # ((x << 2) | b) & mask, without overflow
        y, yr = ((x & low) << 2) | b, (xr >> 2) | ((3 - b) << (2 * (k - 1)))
        take_rc = yr < y
        return torch.where(take_rc, yr, y), take_rc
    from leon_tpu_torch.ops.kmer import lex_less, shl2, shr2_ins

    y, yr = shl2(x, b, k), shr2_ins(xr, 3 - b, k)
    take_rc = lex_less(yr, y)
    return torch.where(take_rc[:, None], yr, y), take_rc


def unitig_links_plain(rows: torch.Tensor, k: int):
    """Plain version of unitig_links: the reference's successor loop with an
    unbucketed search (torch.searchsorted over keys, a lexicographic binary
    search over W-word rows)."""
    _check_run(rows, k, "unitig_links")
    M = rows.shape[0]
    dev = rows.device
    x0 = _u32_rows(rows)
    rc = _revcomp_plain(x0, k)
    succ = torch.full((M, 2), -1, dtype=torch.int64, device=dev)
    outc = torch.zeros((M, 2), dtype=torch.int64, device=dev)
    for o in (0, 1):
        x, xr = (x0, rc) if o == 0 else (rc, x0)
        for b in range(4):
            cy, take_rc = _successor_plain(x, xr, b, k)
            j = _find_plain(x0, cy)
            hit = j >= 0
            oc = outc[:, o] + hit
            succ[:, o] = torch.where(hit & (oc == 1), 2 * j + take_rc, succ[:, o])
            outc[:, o] = oc
    succ, outc = succ.reshape(-1), outc.reshape(-1)
    inc = outc.reshape(M, 2).flip(1).reshape(-1)  # in(d) = out(twin of d)
    internal = (outc == 1) & (succ >= 0) & (inc[torch.clamp(succ, min=0)] == 1)
    nxt = torch.where(internal, succ, -1)
    ids = torch.arange(2 * M, device=dev)
    prev = torch.full((2 * M,), -1, dtype=torch.int64, device=dev)
    prev.scatter_reduce_(0, nxt[internal], ids[internal], reduce="amax")
    return nxt.to(torch.int32), prev.to(torch.int32)


RULER_LOG2 = 5  # K6 samples a node as a ruler at one in 2^RULER_LOG2 (csrc/unitig.cu)
_RANK_CTL_INTS = 256  # K6's control block (RK_CTL_INTS)
_RANK_LAUNCHES = 5  # K6's kernels a ranking: rulers, walk, link, fold, cycles


def unitig_rank(nxt: torch.Tensor, prev: torch.Tensor, mode: int) -> torch.Tensor:
    """K6: the state (N, 4) int32 [P, c0, c1, 0] of every node for `mode`
    (csrc/unitig.cu), equal to the reference's pointer doubling run until
    no pointer moves (unitig.py:512-584), by one list-ranking pass over a
    sparse ruling set: five launches, no host read. Counts its launches
    under K6's name, unitig_double."""
    N = nxt.shape[0]
    _check_nodes(N // 2, nxt, prev, name="unitig_rank")
    kernels.need(N > 0 and mode in (ACYCLIC, FULL, RANK), "unitig_rank: bad mode or empty")
    if not kernels.on_cuda(nxt, "unitig_rank"):
        return unitig_rank_plain(nxt, prev, mode)
    nxt, prev = nxt.contiguous(), prev.contiguous()
    dev = nxt.device

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    S, T, A = i32(N, 4), i32(N, 2), i32(2 * N, 4)
    RN, RS, U, ctl = i32(N), i32(N), i32(N), i32(_RANK_CTL_INTS)
    aux = i32(N) if mode == FULL else None
    rc = kernels.lib().lt_unitig_rank(
        mode, N, nxt.data_ptr(), prev.data_ptr(), S.data_ptr(), T.data_ptr(),
        RN.data_ptr(), RS.data_ptr(), A.data_ptr(), U.data_ptr(),
        None if aux is None else aux.data_ptr(), ctl.data_ptr(), kernels.stream(nxt))
    kernels.check(rc, "unitig_double")
    kernels.launches["unitig_double"] += _RANK_LAUNCHES
    return S


def unitig_rank_plain(nxt: torch.Tensor, prev: torch.Tensor, mode: int) -> torch.Tensor:
    """Plain version of unitig_rank: the reference's rounds, stopped at the
    first round that moves no pointer, at most D = bitlen(N - 1) + 1. The
    reference's docstring (unitig.py:513-527) shows this equals D rounds."""
    N = nxt.shape[0]
    S = double_init_plain(nxt, prev, mode)
    for _ in range(max(1, (N - 1).bit_length()) + 1):
        S, changed = unitig_double_plain(S, mode)
        if not int(changed.item()):
            break
    return S


def double_init_plain(nxt: torch.Tensor, prev: torch.Tensor, mode: int) -> torch.Tensor:
    """The reference's start state (N, 4) int32 for `mode` (unitig.py:559-584)."""
    ids = torch.arange(nxt.shape[0], dtype=torch.int32, device=nxt.device)
    z = torch.zeros_like(ids)
    if mode == FULL:
        cols = (torch.where(nxt >= 0, nxt, ids), (nxt < 0).to(torch.int32), ids, z)
    else:
        c1 = (prev < 0).to(torch.int32) if mode == ACYCLIC else z
        cols = (torch.where(prev >= 0, prev, ids), (prev >= 0).to(torch.int32), c1, z)
    return torch.stack(cols, dim=1)


def unitig_double_plain(S: torch.Tensor, mode: int):
    """One of the reference's pointer-doubling rounds: (S2, changed), changed
    a (1,) int32 tensor, 1 when any pointer moved (unitig.py:537-544)."""
    G = S[S[:, 0].long()]
    if mode == ACYCLIC:
        c0, c1 = S[:, 1] + G[:, 1], S[:, 2] | G[:, 2]
    elif mode == FULL:
        c0, c1 = S[:, 1] | G[:, 1], torch.minimum(S[:, 2], G[:, 2])
    else:
        c0, c1 = S[:, 1] + G[:, 1], S[:, 2]
    S2 = torch.stack([G[:, 0], c0, c1, torch.zeros_like(c0)], dim=1)
    changed = (G[:, 0] != S[:, 0]).any().to(torch.int32).reshape(1)
    return S2, changed


def break_cycles(S: torch.Tensor, nxt: torch.Tensor, prev: torch.Tensor):
    """Cut each cycle at its min-id node, from the FULL mode's converged
    state (unitig.py:573-578). Returns new (nxt, prev)."""
    _check_state(S, "break_cycles")
    _check_nodes(S.shape[0] // 2, nxt, prev, name="break_cycles")
    if not kernels.on_cuda(S, "break_cycles"):
        return break_cycles_plain(S, nxt, prev)
    nxt, prev = nxt.clone(), prev.clone()
    rc = kernels.lib().lt_unitig_break(S.shape[0], S.contiguous().data_ptr(), nxt.data_ptr(),
                                       prev.data_ptr(), kernels.stream(S))
    kernels.check(rc, "unitig_double")
    kernels.launches["unitig_double"] += 1
    return nxt, prev


def break_cycles_plain(S: torch.Tensor, nxt: torch.Tensor, prev: torch.Tensor):
    ids = torch.arange(S.shape[0], dtype=torch.int32, device=S.device)
    ch = (S[:, 1] == 0) & (S[:, 2] == ids)
    p = prev[ch]
    nxt, prev = nxt.clone(), prev.clone()
    nxt[p[p >= 0].long()] = -1
    prev[ch] = -1
    return nxt, prev


def _chain_rank(nxt, prev, assume_acyclic: bool, rank, cut):
    if assume_acyclic:
        return nxt, prev, rank(nxt, prev, ACYCLIC)
    nxt, prev = cut(rank(nxt, prev, FULL), nxt, prev)
    return nxt, prev, rank(nxt, prev, RANK)


def chain_rank(nxt: torch.Tensor, prev: torch.Tensor, assume_acyclic: bool):
    """Head and rank of every node (K6); the full variant first cuts the
    cycles. Returns (nxt, prev, S): S[:, 0] is the head, S[:, 1] the rank,
    and in the acyclic variant S[:, 2] == 0 marks a node that reached no
    head (a cycle). One K6 pass a ranking, five launches (eleven in the
    full variant, the cut included), no host read."""
    return _chain_rank(nxt, prev, assume_acyclic, unitig_rank, break_cycles)


def chain_rank_plain(nxt: torch.Tensor, prev: torch.Tensor, assume_acyclic: bool):
    """Plain version of chain_rank (the reference's rounds on any device)."""
    return _chain_rank(nxt, prev, assume_acyclic, unitig_rank_plain, break_cycles_plain)


def _check_emit(rows, k, nxt, prev, S, cap: int, cap_bases: int) -> None:
    _check_run(rows, k, "unitig_emit")
    M = rows.shape[0]
    kernels.need(M > 0, "unitig_emit: empty run")
    _check_nodes(M, nxt, prev, name="unitig_emit")
    _check_state(S, "unitig_emit")
    kernels.need(S.shape[0] == 2 * M, "unitig_emit: state must have 2M rows")
    kernels.need(cap > 0 and cap_bases > 0 and cap_bases % 16 == 0,
                 "unitig_emit: caps must be > 0, cap_bases a multiple of 16")
    kernels.need(rows.device == nxt.device == prev.device == S.device,
                 "unitig_emit: tensors on two devices")


_EMIT_SCAN = 1024  # nodes a block of K7's prefix sums takes (EM_SCAN in csrc/unitig.cu)
EMIT_KEY32_LIMIT = 1 << 30  # K7's collision keys take 32 bits below this (2M + (k-1) cap)


def _emit_work_words(N: int, cap: int, cap_bases: int, key_bytes: int) -> int:
    """int64 words of K7's scratch (csrc/unitig.cu em_layout): the chains'
    base counts and the counts; a region for the chain minima, then the
    byte plane or the collision keys; the heads' block counts and both
    scans' block offsets."""
    half = (N + 1) // 2
    region = max(half, -(-cap_bases * key_bytes // 8))
    return (cap + 4) // 2 * 2 + region + half + -(-N // _EMIT_SCAN) + -(-(cap + 1) // _EMIT_SCAN)


def unitig_emit(rows: torch.Tensor, k: int, nxt: torch.Tensor, prev: torch.Tensor,
                S: torch.Tensor, cap: int, cap_bases: int, acyclic: bool) -> torch.Tensor:
    """K7: the reference's output buffer, u32 bits in int32: [n_chains,
    overflow, has_cycles, 0 | len_nodes (cap) | packed bases (cap_bases/16)]
    (unitig.py:586-645). One C entry a call (csrc/unitig.cu), counted
    once."""
    _check_emit(rows, k, nxt, prev, S, cap, cap_bases)
    if not kernels.on_cuda(rows, "unitig_emit"):
        return unitig_emit_plain(rows, k, nxt, prev, S, cap, cap_bases, acyclic)
    rows, S = rows.contiguous(), S.contiguous()
    nxt, prev = nxt.contiguous(), prev.contiguous()
    dev = rows.device
    N = S.shape[0]
    buf = torch.empty(4 + cap + cap_bases // 16, dtype=torch.int32, device=dev)
    key_bits = 32 if N + (k - 1) * cap < EMIT_KEY32_LIMIT else 64
    nw = _emit_work_words(N, cap, cap_bases, key_bits // 8)
    work = torch.empty(nw, dtype=torch.int64, device=dev)
    ptrs = (S.data_ptr(), nxt.data_ptr(), prev.data_ptr(), int(acyclic), cap, cap_bases,
            key_bits, work.data_ptr(), nw, buf.data_ptr(), kernels.stream(rows))
    if rows.dim() == 1:
        rc = kernels.lib().lt_unitig_emit(rows.data_ptr(), N, k, *ptrs)
    else:
        rc = kernels.lib().lt_unitig_emit_words(rows.data_ptr(), N, rows.shape[1], k, *ptrs)
    kernels.check(rc, "unitig_emit")
    kernels.launches["unitig_emit"] += 1
    return buf


def _chain_starts(len_nodes: torch.Tensor, k: int) -> torch.Tensor:
    """Exclusive prefix sum of each chain's base count (int64)."""
    ln = len_nodes.to(torch.int64)
    bp = ln + (ln > 0).to(torch.int64) * (k - 1)
    return torch.cumsum(bp, 0) - bp


def _base_at(F: torch.Tensor, t: int) -> torch.Tensor:
    """The 2-bit group at bit t of spelled keys (N,) or words (N, W)."""
    if F.dim() == 1:
        return (F >> t) & 3
    return (F[:, t // 32] >> (t % 32)) & 3


# K7's write order (unitig.py:612-636) as keys: where writes share a
# position, the largest key lands. The even nodes' last bases by id, then the
# odd nodes' by id, then the kept heads' prefixes, base j = 0 .. k-2, each j
# over the chain ids (csrc/unitig.cu em_node_key, em_prefix_key).
def _node_key(d, M: int):
    return 1 + (d & 1) * M + (d >> 1)


def _prefix_key(j: int, c, M: int, cap: int):
    return 1 + 2 * M + j * cap + c


def unitig_emit_plain(rows: torch.Tensor, k: int, nxt: torch.Tensor, prev: torch.Tensor,
                      S: torch.Tensor, cap: int, cap_bases: int, acyclic: bool) -> torch.Tensor:
    """Plain version of unitig_emit: the reference's scatters over a u8
    base plane, then the 2-bit pack. Where two writes reach one position
    (a kept chain with no tail, at even-k palindromes: ROADMAP queue 3),
    the base that lands is the reference's last writer (_node_key,
    _prefix_key): the largest key of each position by scatter-max, then
    that write's base."""
    _check_emit(rows, k, nxt, prev, S, cap, cap_bases)
    dev = rows.device
    N = S.shape[0]
    M = N // 2
    i64 = dict(dtype=torch.int64, device=dev)
    ids = torch.arange(N, **i64)
    head, rank = S[:, 0].long(), S[:, 1].long()
    cm = torch.full((N,), N, **i64).scatter_reduce(0, head, ids, reduce="amin")
    tmn = torch.full((N,), N, **i64).scatter_reduce(0, head, ids ^ 1, reduce="amin")
    keep_head = (prev < 0) & (cm <= tmn)
    kept = keep_head[head]
    incl = torch.cumsum(keep_head.to(torch.int64), 0)
    total = int(incl[-1])
    cid = incl[head] - 1
    cyc = bool(acyclic) and bool((S[:, 2] == 0).any())

    ok = kept & (cid < cap)
    tails = ok & (nxt < 0)
    len_nodes = torch.zeros(cap, **i64)
    len_nodes[cid[tails]] = rank[tails] + 1
    start = _chain_starts(len_nodes, k)

    F = _node_keys_plain(_u32_rows(rows), k)
    pos = [start[cid[ok]] + (k - 1) + rank[ok]]
    code = [_base_at(F[ok], 0)]
    key = [_node_key(ids[ok], M)]
    hd = ok & keep_head
    hc, hF = cid[hd], F[hd]
    hstart = start[hc]
    for j in range(k - 1):
        pos.append(hstart + j)
        code.append(_base_at(hF, 2 * (k - 1) - 2 * j))
        key.append(_prefix_key(j, hc, M, cap))
    pos, code, key = torch.cat(pos), torch.cat(code), torch.cat(key)
    inb = (pos >= 0) & (pos < cap_bases)
    pos, code, key = pos[inb], code[inb], key[inb]
    last = torch.zeros(cap_bases, **i64).scatter_reduce(0, pos, key, reduce="amax")
    win = key == last[pos]
    bases = torch.zeros(cap_bases, **i64)
    bases[pos[win]] = code[win]
    packed = (bases.reshape(-1, 16) << (2 * torch.arange(16, **i64))).sum(dim=1)
    hdr = torch.tensor([total, int(total > cap), int(cyc), 0], **i64)
    from leon_tpu_torch.ops.kmer import i32_bits

    return i32_bits(torch.cat([hdr, len_nodes, packed]))


def _check_lookup(rows, k: int, q) -> None:
    _check_run(rows, k, "solid_lookup")
    kernels.need(q.dtype == rows.dtype and q.dim() == rows.dim()
                 and q.shape[1:] == rows.shape[1:] and q.device == rows.device,
                 "solid_lookup: queries must take the run's form, on the run's device")


LOOKUP_SAMPLE_ROWS = 64     # K8's splitter rows a block stages (csrc/unitig.cu)
LOOKUP_SAMPLE_BYTES = 49152  # their most bytes (K8_SMEM)


def _lookup_split(M: int, row_bytes: int) -> tuple[int, int]:
    """K8's splitter sample over a run of M > 0 rows of row_bytes each:
    (S, step) with S rows (rows 0, step, 2 step, ...) in at most
    LOOKUP_SAMPLE_BYTES of shared memory, covering the run: (S - 1) * step
    < M <= S * step, so a query's segment holds at most step rows."""
    s_max = max(1, min(LOOKUP_SAMPLE_ROWS, LOOKUP_SAMPLE_BYTES // row_bytes))
    step = -(-M // s_max)
    return -(-M // step), step


def solid_lookup(rows: torch.Tensor, k: int, q: torch.Tensor):
    """K8: for queries in the run's form ((Q,) int64 keys or (Q, W) int32
    words), (hit (Q,) bool, rank (Q,) int64): hit when q is in the solid
    run, rank its row there (0 on a miss) — indices into
    solid_kmers_sorted(payload) (unitig.py:938-963). The kernel reads no
    table over the run: a splitter sample in every block's shared memory,
    then one segment of the run per query (_lookup_split)."""
    _check_lookup(rows, k, q)
    if not kernels.on_cuda(rows, "solid_lookup"):
        return solid_lookup_plain(rows, k, q)
    M, Q = rows.shape[0], q.shape[0]
    if M == 0 or Q == 0:
        return (torch.zeros(Q, dtype=torch.bool, device=rows.device),
                torch.zeros(Q, dtype=torch.int64, device=rows.device))
    rows, q = rows.contiguous(), q.contiguous()
    hit = torch.empty(Q, dtype=torch.uint8, device=rows.device)
    rank = torch.empty(Q, dtype=torch.int64, device=rows.device)
    row_bytes = rows[0].numel() * rows.element_size()
    S, step = _lookup_split(M, row_bytes)
    ptrs = (step, S, q.data_ptr(), Q, hit.data_ptr(), rank.data_ptr(), kernels.stream(rows))
    if rows.dim() == 1:
        rc = kernels.lib().lt_solid_lookup(rows.data_ptr(), M, k, *ptrs)
    else:
        rc = kernels.lib().lt_solid_lookup_words(rows.data_ptr(), M, rows.shape[1], k, *ptrs)
    kernels.check(rc, "solid_lookup")
    kernels.launches["solid_lookup"] += 1
    return hit.view(torch.bool), rank


def solid_lookup_plain(rows: torch.Tensor, k: int, q: torch.Tensor):
    _check_lookup(rows, k, q)
    if rows.shape[0] == 0:
        return (torch.zeros(q.shape[0], dtype=torch.bool, device=q.device),
                torch.zeros(q.shape[0], dtype=torch.int64, device=q.device))
    j = _find_plain(_u32_rows(rows), _u32_rows(q))
    hit = j >= 0
    return hit, torch.where(hit, j, 0)


def build(rows: torch.Tensor, k: int, cap_chains: int, cap_bases: int,
          assume_acyclic: bool = True, links=None) -> torch.Tensor:
    """The device build (K5 -> K6 -> K7) over a non-empty solid run;
    returns unitig_emit's buffer. assume_acyclic runs the optimistic
    variant, which only flags cycles (buffer word 2). `links`, K5's
    (nxt, prev) of these rows from an earlier build, skips K5."""
    nxt, prev = unitig_links(rows, k) if links is None else links
    nxt, prev, S = chain_rank(nxt, prev, assume_acyclic)
    return unitig_emit(rows, k, nxt, prev, S, cap_chains, cap_bases, assume_acyclic)


def build_plain(rows: torch.Tensor, k: int, cap_chains: int, cap_bases: int,
                assume_acyclic: bool = True) -> torch.Tensor:
    """Plain version of build, on the tensors' own device."""
    nxt, prev = unitig_links_plain(rows, k)
    nxt, prev, S = chain_rank_plain(nxt, prev, assume_acyclic)
    return unitig_emit_plain(rows, k, nxt, prev, S, cap_chains, cap_bases, assume_acyclic)


@dataclass
class _Inflight:
    buf: torch.Tensor       # build output (see unitig_emit)
    rows: torch.Tensor      # the solid run the build read
    k: int
    cap_chains: int
    cap_bases: int
    links: tuple | None     # K5's (nxt, prev) of rows, which every rebuild reuses


def _caps(M: int, k: int, cap_chains: int) -> int:
    """Base capacity (unitig.py:711-715): kept directed nodes are at most
    2M (self-twin components spell both twins)."""
    cap_bases = 2 * M + (k - 1) * cap_chains
    return -(-cap_bases // 16) * 16


def dispatch_build(solid: torch.Tensor, k: int, nu: int) -> _Inflight:
    """Run the optimistic device build, K5-K7 (unitig.py:718-745), over the
    solid run in the counter's form (K2's or K14's solid mode). `nu` is the
    exact distinct count, which sets the frozen chain capacity. K5's links
    stay with the build (8 bytes a node) until it is drained."""
    _check_run(solid, k, "dispatch_build")
    M = solid.shape[0]
    cap = chains_cap(nu)
    cb = _caps(M, k, cap)
    links = None
    if M:
        links = unitig_links(solid, k)
        buf = build(solid, k, cap, cb, links=links)
    else:
        buf = torch.zeros(4, dtype=torch.int32, device=solid.device)
    return _Inflight(buf, solid, k, cap, cb, links)


def drain_build(infl: _Inflight) -> bytes | None:
    """The payload of a dispatched build, or None (the caller writes
    BLOOM): a flagged cycle re-runs the full variant; a chain overflow
    retries once at cap * RETRY_FACTOR (unitig.py:748-782). Every rebuild
    reads the dispatched solid run and reuses its K5 links (K5 runs once a
    build)."""

    def rebuild(cap, cb, acyclic):
        return build(infl.rows, infl.k, cap, cb, acyclic, links=infl.links)

    def host(b):
        return b.cpu().numpy().view(np.uint32)

    buf = host(infl.buf)
    acyclic = True
    if buf[2]:  # cycles: the optimistic build is invalid
        acyclic = False
        buf = host(rebuild(infl.cap_chains, infl.cap_bases, False))
    if buf[1]:  # overflow: one retry with a larger cap
        cap = infl.cap_chains * RETRY_FACTOR
        cb = _caps(infl.rows.shape[0], infl.k, cap)
        buf = host(rebuild(cap, cb, acyclic))
        if buf[2]:
            buf = host(rebuild(cap, cb, False))
        if buf[1]:
            return None
        infl.cap_chains, infl.cap_bases = cap, cb
    n_chains = int(buf[0])
    if n_chains == 0:
        return None
    len_nodes = buf[4 : 4 + infl.cap_chains][:n_chains].astype(np.int64)
    total = int(len_nodes.sum()) + (infl.k - 1) * n_chains
    packed = buf[4 + infl.cap_chains :].tobytes()
    return payload_from(n_chains, len_nodes, packed, total, infl.k)


def solid_indices(infl: _Inflight, words: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """DICT-v2 lookup on the build's device (K8): for (Q, W) u32 anchor
    words, (hit bool (Q,), solid rank i64 (Q,), n_solid), as
    leon_tpu.ops.unitig.solid_indices_dev. The anchors go down in the run's
    form: int64 keys for k <= 31, the words themselves past it."""
    dev = infl.rows.device
    if infl.rows.dim() == 1:
        q = torch.from_numpy(state.words_to_keys(words)).to(dev)
    else:
        q = state.words_to_torch(words, dev)
    hit, rank = solid_lookup(infl.rows, infl.k, q)
    return hit.cpu().numpy(), rank.cpu().numpy(), infl.rows.shape[0]


def payload_from(n_chains: int, len_nodes: np.ndarray, packed: bytes,
                 total_bases: int, k: int) -> bytes:
    """Raw UNITIGS payload: varint n_chains | varint len(lens_blob) |
    lens_blob (varint base-length per chain) | 2-bit packed concatenated
    bases (pack_2bit_np bit order)."""
    out = bytearray()
    varint.encode_one(n_chains, out)
    lens_b = (np.asarray(len_nodes, np.int64) + (k - 1)).astype(np.uint64)
    blob = varint.encode_array(lens_b)
    varint.encode_one(len(blob), out)
    out += blob
    out += packed[: (total_bases + 3) // 4]
    return bytes(out)


def parse_payload(raw: bytes, k: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (base lengths (n_chains,) i64, flat base codes (total,) u8)."""
    from leon_tpu_torch.ops.kmer import unpack_2bit_np

    n_chains, pos = varint.decode_one(raw, 0)
    blob_len, pos = varint.decode_one(raw, pos)
    lens = varint.decode_array(raw[pos : pos + blob_len], n_chains).astype(np.int64)
    pos += blob_len
    total = int(lens.sum())
    codes = unpack_2bit_np(raw[pos:], total)
    return lens, codes


def rebuild_bitset_np(raw: bytes, k: int, n_words: int, n_hashes: int,
                      seed: int, canon: np.ndarray | None = None) -> np.ndarray:
    """Rebuild the encoder's exact Bloom bitset from the unitig payload:
    extract every k-mer of every unitig, canonicalize, scatter-OR with the
    container's frozen hash family. Bit-identical to the encoder's filter
    by construction (same kmer set, same n_words/H/seed). `canon`
    short-circuits the spelling when the caller already ran spell_canon
    (the v5 decoder shares it with the DICT enumeration)."""
    from leon_tpu_torch.ops import bloom
    from leon_tpu_torch.ops.kmer import pack_codes_batch_np

    bitset = np.zeros(n_words, np.uint32)
    if canon is not None:
        step = max(1, (256 << 20) // (4 * max(1, canon.shape[1])))
        for s in range(0, canon.shape[0], step):
            bitset |= bloom.build_np(canon[s : s + step], n_words, n_hashes, seed, k)
        return bitset
    lens, codes = parse_payload(raw, k)
    if codes.size == 0:
        return bitset
    starts = np.cumsum(lens) - lens
    nk = lens - k + 1
    pos = np.repeat(starts, nk) + (
        np.arange(int(nk.sum())) - np.repeat(np.cumsum(nk) - nk, nk)
    )
    # chunked so the (chunk, k) window matrix stays ~256 MB even at the
    # 64M-kmer section cap
    step = max(1, (256 << 20) // (4 * k))
    off = np.arange(k)[None, :]
    for s in range(0, pos.size, step):
        win = codes[pos[s : s + step, None] + off]  # (chunk, k)
        fwd = pack_codes_batch_np(win, k)
        rcw = pack_codes_batch_np((3 - win)[:, ::-1], k)
        take = _np_lex_less(rcw, fwd)
        canon_c = np.where(take[:, None], rcw, fwd)
        bitset |= bloom.build_np(canon_c, n_words, n_hashes, seed, k)
    return bitset


def spell_canon(raw: bytes, k: int) -> np.ndarray:
    """(n_solid, W) u32: every canonical k-mer spelled by the unitig
    payload, in payload traversal order. Native rolling-window spell when
    the lib is available (O(n) vs the numpy chunked form's O(n*k) —
    measured ~4.7 s of a 43 s 500k-read decompress); numpy fallback is
    bit-identical (tested)."""
    from leon_tpu_torch.ops.kmer import pack_codes_batch_np, words_for_k

    lens, codes = parse_payload(raw, k)
    if codes.size == 0:
        return np.zeros((0, max(1, (k + 15) // 16)), np.uint32)

    from leon_tpu_torch import native

    lib = native.get_lib()
    if lib is not None and hasattr(lib, "leon_spell_canon"):
        W = words_for_k(k)
        nk_total = int(np.maximum(lens - k + 1, 0).sum())
        out = np.empty((nk_total, W), dtype=np.uint32)
        codes_c = np.ascontiguousarray(codes, dtype=np.uint8)
        lens_c = np.ascontiguousarray(lens, dtype=np.int64)
        m = lib.leon_spell_canon(codes_c.ctypes.data, lens_c.shape[0],
                                 lens_c.ctypes.data, k, W, out.ctypes.data)
        if m == nk_total:
            return np.ascontiguousarray(out.astype("<u4"))
        # count mismatch (unitigs shorter than k shouldn't exist in a
        # valid payload): fall through to the numpy reference
    starts = np.cumsum(lens) - lens
    nk = lens - k + 1
    pos = np.repeat(starts, nk) + (
        np.arange(int(nk.sum())) - np.repeat(np.cumsum(nk) - nk, nk)
    )
    step = max(1, (256 << 20) // (4 * k))
    off = np.arange(k)[None, :]
    chunks = []
    for s in range(0, pos.size, step):
        win = codes[pos[s : s + step, None] + off]
        fwd = pack_codes_batch_np(win, k)
        rcw = pack_codes_batch_np((3 - win)[:, ::-1], k)
        take = _np_lex_less(rcw, fwd)
        chunks.append(np.where(take[:, None], rcw, fwd))
    return np.ascontiguousarray(np.concatenate(chunks).astype("<u4"))


def sort_rows_bigint(allc: np.ndarray) -> np.ndarray:
    """Sort (n, W) u32 LSW-first rows ascending as big-ints. W<=2 packs
    into u64 keys (np's u64 argsort is ~8x faster than the structured
    comparator); wider rows use the MSW-first structured view."""
    W = allc.shape[1]
    if W == 1:
        return allc[np.argsort(allc[:, 0], kind="stable")]
    if W == 2:
        v = allc[:, 0].astype(np.uint64) | (allc[:, 1].astype(np.uint64) << 32)
        return allc[np.argsort(v, kind="stable")]
    key = np.ascontiguousarray(allc[:, ::-1]).view(
        [("", "<u4")] * W
    ).reshape(-1)
    return allc[np.argsort(key, kind="stable")]


def solid_kmers_sorted(raw: bytes, k: int, canon: np.ndarray | None = None) -> np.ndarray:
    """(n_solid, W) u32 DISTINCT canonical solid k-mers, ascending big-int
    order, spelled from the unitig payload. This is the DICT-v2
    enumeration (FORMAT.md §5): encoder and decoder both derive it from
    the SAME payload bytes with this same function, so anchor indices
    into it are deterministic by construction. DEDUPED: a self-twin
    chain (a unitig adjacent to its own reverse complement) legitimately
    spells its k-mers twice in the payload, but the enumeration must
    match the distinct solid run the encoder indexes against
    (solid_run_host / solid_indices_dev). `canon` short-circuits the
    spelling when the caller already has spell_canon's output (the
    decoder shares it with the bitset rebuild)."""
    if canon is None:
        canon = spell_canon(raw, k)
    s = sort_rows_bigint(canon)
    if s.shape[0] > 1:
        keep = np.concatenate(([True], (s[1:] != s[:-1]).any(axis=1)))
        s = np.ascontiguousarray(s[keep])
    return s

