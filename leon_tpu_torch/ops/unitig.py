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
  successor search and the internal edges), ``unitig_double`` (K6: one
  pointer-doubling round, with ``double_init`` and ``break_cycles``),
  ``unitig_emit`` (K7: chain ids, lengths and the packed bases) and
  ``solid_lookup`` (K8: the DICT's anchor keys into the solid run). They
  replace _build_dev_impl, _bucket_starts, _searchsorted_words_dev and
  solid_indices_dev (unitig.py:351-645, 938-963). The kernels read the
  solid run only: ``dispatch_build`` first compacts the counted run with
  K2's solid mode (ops/count.py ``compact_solid``; the reference's
  _compact_dev). ``dispatch_build``, ``drain_build`` and
  ``solid_indices`` keep the reference's contracts (unitig.py:699-782,
  938-963) over the port's sorted int64 keys. Each wrapper has a plain
  PyTorch version (``build_plain`` and ``chain_rank_plain`` for the
  composites), which the wrapper takes for CPU tensors.

tests/test_torch_unitig.py holds both builders to the reference's and
tests/test_torch_pipeline.py compares whole archives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from leon_tpu.utils import varint
from leon_tpu_torch import kernels, state

__all__ = [
    "chains_cap", "build_np_payload", "payload_from", "parse_payload",
    "rebuild_bitset_np", "spell_canon", "sort_rows_bigint", "solid_kmers_sorted",
    "unitig_links", "unitig_double", "unitig_emit", "solid_lookup", "chain_rank",
    "chain_rank_plain", "build", "build_plain", "dispatch_build", "drain_build",
    "solid_indices",
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
    from leon_tpu import native

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

    from leon_tpu import native
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
# Input: the solid run, sorted distinct (M,) int64 keys with every row
# solid. dispatch_build compacts a counted run to it (K2's solid mode);
# ids stay order-isomorphic, so the payload is the uncompacted build's
# (unitig.py:663-669). Directed node d = 2*i + o spells row i's key (o = 0)
# or its reverse complement (o = 1). Node arrays are int32. K6 state S is
# (2M, 4) int32: [P, c0, c1, 0] (the modes are in csrc/unitig.cu).

ACYCLIC, FULL, RANK = 0, 1, 2  # K6 modes


def _check_run(keys, k: int, name: str) -> None:
    kernels.need(1 <= k <= 31, f"{name}: k={k} > 31 needs multiword keys")
    kernels.need(keys.dtype == torch.int64 and keys.dim() == 1,
                 f"{name}: keys must be (M,) int64")
    kernels.need(2 * keys.shape[0] < 1 << 31, f"{name}: 2M node ids overflow int32")


def _check_nodes(M: int, *arrs, name: str) -> None:
    for a in arrs:
        kernels.need(a.dtype == torch.int32 and a.shape == (2 * M,),
                     f"{name}: node arrays must be (2M,) int32")


def _check_state(S, name: str) -> None:
    kernels.need(S.dtype == torch.int32 and S.dim() == 2 and S.shape[1] == 4,
                 f"{name}: state must be (N, 4) int32")


def _revcomp_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    rc = torch.zeros_like(x)
    for i in range(k):
        rc |= (3 - ((x >> (2 * i)) & 3)) << (2 * (k - 1 - i))
    return rc


def _node_keys_plain(keys: torch.Tensor, k: int) -> torch.Tensor:
    """(2M,) spelled form of every directed node."""
    return torch.stack([keys, _revcomp_plain(keys, k)], dim=1).reshape(-1)


def _find_plain(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Index of each q in the sorted distinct keys (M > 0), or -1."""
    M = keys.shape[0]
    j = torch.searchsorted(keys, q)
    jc = torch.clamp(j, max=M - 1)
    return torch.where((j < M) & (keys[jc] == q), jc, -1)


def _buckets(keys: torch.Tensor, k: int) -> torch.Tensor:
    """(2^T + 1,) int32 prefix table over the top min(16, 2k) bits (card)."""
    T = min(16, 2 * k)
    starts = torch.empty((1 << T) + 1, dtype=torch.int32, device=keys.device)
    rc = kernels.lib().lt_unitig_buckets(keys.data_ptr(), keys.shape[0], k,
                                         starts.data_ptr(), kernels.stream(keys))
    kernels.check(rc, "unitig_buckets")
    return starts


def unitig_links(keys: torch.Tensor, k: int):
    """K5: (nxt, prev) (2M,) int32 — each directed node's successor along
    an internal edge and its predecessor, -1 where none (unitig.py:469-508).
    keys: a non-empty solid run."""
    _check_run(keys, k, "unitig_links")
    kernels.need(keys.shape[0] > 0, "unitig_links: empty run")
    if not kernels.on_cuda(keys, "unitig_links"):
        return unitig_links_plain(keys, k)
    keys = keys.contiguous()
    M = keys.shape[0]
    starts = _buckets(keys, k)
    succ, outc, nxt, prev = (torch.empty(2 * M, dtype=torch.int32, device=keys.device)
                             for _ in range(4))
    rc = kernels.lib().lt_unitig_links(
        keys.data_ptr(), M, k, starts.data_ptr(), succ.data_ptr(), outc.data_ptr(),
        nxt.data_ptr(), prev.data_ptr(), kernels.stream(keys))
    kernels.check(rc, "unitig_links")
    kernels.launches["unitig_links"] += 1
    return nxt, prev


def unitig_links_plain(keys: torch.Tensor, k: int):
    """Plain version of unitig_links: the reference's successor loop with
    torch.searchsorted for the bucketed search."""
    _check_run(keys, k, "unitig_links")
    M = keys.shape[0]
    dev = keys.device
    rc = _revcomp_plain(keys, k)
    low = (1 << (2 * k - 2)) - 1  # ((x << 2) | b) & mask, without overflow
    succ = torch.full((M, 2), -1, dtype=torch.int64, device=dev)
    outc = torch.zeros((M, 2), dtype=torch.int64, device=dev)
    for o in (0, 1):
        x, xr = (keys, rc) if o == 0 else (rc, keys)
        for b in range(4):
            y = ((x & low) << 2) | b
            yr = (xr >> 2) | ((3 - b) << (2 * (k - 1)))
            take_rc = yr < y
            j = _find_plain(keys, torch.where(take_rc, yr, y))
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


def double_init(nxt: torch.Tensor, prev: torch.Tensor, mode: int) -> torch.Tensor:
    """K6 start state (N, 4) int32 for `mode` (unitig.py:559-584)."""
    N = nxt.shape[0]
    _check_nodes(N // 2, nxt, prev, name="double_init")
    kernels.need(N > 0 and mode in (ACYCLIC, FULL, RANK), "double_init: bad mode or empty")
    if not kernels.on_cuda(nxt, "double_init"):
        return double_init_plain(nxt, prev, mode)
    S = torch.empty((N, 4), dtype=torch.int32, device=nxt.device)
    rc = kernels.lib().lt_unitig_init(mode, N, nxt.contiguous().data_ptr(),
                                      prev.contiguous().data_ptr(), S.data_ptr(),
                                      kernels.stream(nxt))
    kernels.check(rc, "unitig_double")
    kernels.launches["unitig_double"] += 1
    return S


def double_init_plain(nxt: torch.Tensor, prev: torch.Tensor, mode: int) -> torch.Tensor:
    ids = torch.arange(nxt.shape[0], dtype=torch.int32, device=nxt.device)
    z = torch.zeros_like(ids)
    if mode == FULL:
        cols = (torch.where(nxt >= 0, nxt, ids), (nxt < 0).to(torch.int32), ids, z)
    else:
        c1 = (prev < 0).to(torch.int32) if mode == ACYCLIC else z
        cols = (torch.where(prev >= 0, prev, ids), (prev >= 0).to(torch.int32), c1, z)
    return torch.stack(cols, dim=1)


def unitig_double(S: torch.Tensor, mode: int):
    """K6: one pointer-doubling round. Returns (S2, changed): changed is a
    (1,) int32 tensor, 1 when any pointer moved (unitig.py:537-544)."""
    _check_state(S, "unitig_double")
    kernels.need(S.shape[0] > 0 and mode in (ACYCLIC, FULL, RANK), "unitig_double: bad mode")
    if not kernels.on_cuda(S, "unitig_double"):
        return unitig_double_plain(S, mode)
    S = S.contiguous()
    S2 = torch.empty_like(S)
    changed = torch.empty(1, dtype=torch.int32, device=S.device)
    rc = kernels.lib().lt_unitig_double(mode, S.shape[0], S.data_ptr(), S2.data_ptr(),
                                        changed.data_ptr(), kernels.stream(S))
    kernels.check(rc, "unitig_double")
    kernels.launches["unitig_double"] += 1
    return S2, changed


def unitig_double_plain(S: torch.Tensor, mode: int):
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


def _chain_rank(nxt, prev, assume_acyclic: bool, init, step, cut):
    N = nxt.shape[0]
    D = max(1, (N - 1).bit_length()) + 1

    def run(mode, nxt, prev):
        S = init(nxt, prev, mode)
        for _ in range(D):
            S, changed = step(S, mode)
            if not int(changed.item()):
                break
        return S

    if assume_acyclic:
        return nxt, prev, run(ACYCLIC, nxt, prev)
    nxt, prev = cut(run(FULL, nxt, prev), nxt, prev)
    return nxt, prev, run(RANK, nxt, prev)


def chain_rank(nxt: torch.Tensor, prev: torch.Tensor, assume_acyclic: bool):
    """Head and rank of every node by pointer doubling (K6); the full
    variant first cuts the cycles. Returns (nxt, prev, S): S[:, 0] is the
    head, S[:, 1] the rank, and in the acyclic variant S[:, 2] == 0 marks a
    node that reached no head (a cycle).

    The host reads the changed flag after every round and stops at the
    first round that moved no pointer; the reference's docstring
    (unitig.py:513-527) shows this equals running all D rounds. Chains
    converge in log2(longest chain) + 1 rounds, well under D on real data,
    and each round past that point would cost a full pass of gathers,
    against one 4-byte read per round."""
    return _chain_rank(nxt, prev, assume_acyclic, double_init, unitig_double, break_cycles)


def chain_rank_plain(nxt: torch.Tensor, prev: torch.Tensor, assume_acyclic: bool):
    """Plain version of chain_rank (the plain K6 steps on any device)."""
    return _chain_rank(nxt, prev, assume_acyclic, double_init_plain, unitig_double_plain,
                       break_cycles_plain)


def _check_emit(keys, k, nxt, prev, S, cap: int, cap_bases: int) -> None:
    _check_run(keys, k, "unitig_emit")
    M = keys.shape[0]
    kernels.need(M > 0, "unitig_emit: empty run")
    _check_nodes(M, nxt, prev, name="unitig_emit")
    _check_state(S, "unitig_emit")
    kernels.need(S.shape[0] == 2 * M, "unitig_emit: state must have 2M rows")
    kernels.need(cap > 0 and cap_bases > 0 and cap_bases % 16 == 0,
                 "unitig_emit: caps must be > 0, cap_bases a multiple of 16")
    kernels.need(keys.device == nxt.device == prev.device == S.device,
                 "unitig_emit: tensors on two devices")


def unitig_emit(keys: torch.Tensor, k: int, nxt: torch.Tensor, prev: torch.Tensor,
                S: torch.Tensor, cap: int, cap_bases: int, acyclic: bool) -> torch.Tensor:
    """K7: the reference's output buffer, u32 bits in int32: [n_chains,
    overflow, has_cycles, 0 | len_nodes (cap) | packed bases (cap_bases/16)]
    (unitig.py:586-645)."""
    _check_emit(keys, k, nxt, prev, S, cap, cap_bases)
    if not kernels.on_cuda(keys, "unitig_emit"):
        return unitig_emit_plain(keys, k, nxt, prev, S, cap, cap_bases, acyclic)
    keys, S = keys.contiguous(), S.contiguous()
    nxt, prev = nxt.contiguous(), prev.contiguous()
    dev = keys.device
    N = S.shape[0]
    lib, st = kernels.lib(), kernels.stream(keys)
    buf = torch.zeros(4 + cap + cap_bases // 16, dtype=torch.int32, device=dev)
    cm = torch.full((N,), N, dtype=torch.int32, device=dev)
    tmn = torch.full((N,), N, dtype=torch.int32, device=dev)
    kernels.check(lib.lt_unitig_emit_mins(N, S.data_ptr(), int(acyclic), cm.data_ptr(),
                                          tmn.data_ptr(), buf.data_ptr(), st), "unitig_emit")
    kh = torch.empty(N, dtype=torch.int32, device=dev)
    kernels.check(lib.lt_unitig_emit_heads(N, prev.data_ptr(), cm.data_ptr(), tmn.data_ptr(),
                                           kh.data_ptr(), st), "unitig_emit")
    cid = torch.cumsum(kh, 0, dtype=torch.int32)
    kernels.check(lib.lt_unitig_emit_lens(N, nxt.data_ptr(), S.data_ptr(), kh.data_ptr(),
                                          cid.data_ptr(), cap, buf.data_ptr(), st),
                  "unitig_emit")
    start = _chain_starts(buf[4 : 4 + cap], k)
    kernels.check(lib.lt_unitig_emit_bases(keys.data_ptr(), N, k, S.data_ptr(), kh.data_ptr(),
                                           cid.data_ptr(), start.data_ptr(), cap, cap_bases,
                                           buf.data_ptr(), st), "unitig_emit")
    kernels.launches["unitig_emit"] += 1
    return buf


def _chain_starts(len_nodes: torch.Tensor, k: int) -> torch.Tensor:
    """Exclusive prefix sum of each chain's base count (int64)."""
    ln = len_nodes.to(torch.int64)
    bp = ln + (ln > 0).to(torch.int64) * (k - 1)
    return torch.cumsum(bp, 0) - bp


def unitig_emit_plain(keys: torch.Tensor, k: int, nxt: torch.Tensor, prev: torch.Tensor,
                      S: torch.Tensor, cap: int, cap_bases: int, acyclic: bool) -> torch.Tensor:
    """Plain version of unitig_emit: the reference's scatters over a u8
    base plane, then the 2-bit pack. Bases are ORed in (bit planes by
    scatter-max), as the kernel's atomicOr does; the reference overwrites,
    which differs only where two bases share a position (ROADMAP queue 3,
    even-k palindromes)."""
    _check_emit(keys, k, nxt, prev, S, cap, cap_bases)
    dev = keys.device
    N = S.shape[0]
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

    F = _node_keys_plain(keys, k)
    pos = [start[cid[ok]] + (k - 1) + rank[ok]]
    code = [F[ok] & 3]
    hd = ok & keep_head
    hstart, hF = start[cid[hd]], F[hd]
    for j in range(k - 1):
        pos.append(hstart + j)
        code.append((hF >> (2 * (k - 1) - 2 * j)) & 3)
    pos, code = torch.cat(pos), torch.cat(code)
    inb = (pos >= 0) & (pos < cap_bases)
    pos, code = pos[inb], code[inb]
    bases = torch.zeros(cap_bases, **i64)
    for bit in (1, 2):
        plane = torch.zeros(cap_bases, **i64).scatter_reduce(0, pos, code & bit, reduce="amax")
        bases |= plane
    packed = (bases.reshape(-1, 16) << (2 * torch.arange(16, **i64))).sum(dim=1)
    hdr = torch.tensor([total, int(total > cap), int(cyc), 0], **i64)
    buf = torch.cat([hdr, len_nodes, packed])
    return torch.where(buf >= 1 << 31, buf - (1 << 32), buf).to(torch.int32)


def _check_lookup(keys, k: int, q) -> None:
    _check_run(keys, k, "solid_lookup")
    kernels.need(q.dtype == torch.int64 and q.dim() == 1 and q.device == keys.device,
                 "solid_lookup: queries must be (Q,) int64 on the run's device")


def solid_lookup(keys: torch.Tensor, k: int, q: torch.Tensor):
    """K8: for (Q,) int64 query keys, (hit (Q,) bool, rank (Q,) int64):
    hit when q is in the solid run, rank its row there (0 on a miss) —
    indices into solid_kmers_sorted(payload) (unitig.py:938-963)."""
    _check_lookup(keys, k, q)
    if not kernels.on_cuda(keys, "solid_lookup"):
        return solid_lookup_plain(keys, k, q)
    M, Q = keys.shape[0], q.shape[0]
    hit = torch.zeros(Q, dtype=torch.uint8, device=keys.device)
    rank = torch.zeros(Q, dtype=torch.int64, device=keys.device)
    if M == 0 or Q == 0:
        return hit.view(torch.bool), rank
    keys, q = keys.contiguous(), q.contiguous()
    starts = _buckets(keys, k)
    rc = kernels.lib().lt_solid_lookup(keys.data_ptr(), M, k, starts.data_ptr(), q.data_ptr(),
                                       Q, hit.data_ptr(), rank.data_ptr(), kernels.stream(keys))
    kernels.check(rc, "solid_lookup")
    kernels.launches["solid_lookup"] += 1
    return hit.view(torch.bool), rank


def solid_lookup_plain(keys: torch.Tensor, k: int, q: torch.Tensor):
    _check_lookup(keys, k, q)
    if keys.shape[0] == 0:
        return (torch.zeros(q.shape[0], dtype=torch.bool, device=q.device),
                torch.zeros(q.shape[0], dtype=torch.int64, device=q.device))
    j = _find_plain(keys, q)
    hit = j >= 0
    return hit, torch.where(hit, j, 0)


def build(keys: torch.Tensor, k: int, cap_chains: int, cap_bases: int,
          assume_acyclic: bool = True) -> torch.Tensor:
    """The device build (K5 -> K6 -> K7) over a non-empty solid run;
    returns unitig_emit's buffer. assume_acyclic runs the optimistic
    variant, which only flags cycles (buffer word 2)."""
    nxt, prev = unitig_links(keys, k)
    nxt, prev, S = chain_rank(nxt, prev, assume_acyclic)
    return unitig_emit(keys, k, nxt, prev, S, cap_chains, cap_bases, assume_acyclic)


def build_plain(keys: torch.Tensor, k: int, cap_chains: int, cap_bases: int,
                assume_acyclic: bool = True) -> torch.Tensor:
    """Plain version of build, on the tensors' own device."""
    nxt, prev = unitig_links_plain(keys, k)
    nxt, prev, S = chain_rank_plain(nxt, prev, assume_acyclic)
    return unitig_emit_plain(keys, k, nxt, prev, S, cap_chains, cap_bases, assume_acyclic)


@dataclass
class _Inflight:
    buf: torch.Tensor       # build output (see unitig_emit)
    keys: torch.Tensor      # the solid run the build read
    k: int
    cap_chains: int
    cap_bases: int


def _caps(M: int, k: int, cap_chains: int) -> int:
    """Base capacity (unitig.py:711-715): kept directed nodes are at most
    2M (self-twin components spell both twins)."""
    cap_bases = 2 * M + (k - 1) * cap_chains
    return -(-cap_bases // 16) * 16


def dispatch_build(keys: torch.Tensor, counts: torch.Tensor, cutoff: int, k: int,
                   nu: int) -> _Inflight:
    """Run the optimistic device build over a sorted distinct counted run
    (keys, counts): compact it to its solid rows (K2's solid mode), then
    K5-K7 (unitig.py:718-745). `nu` is the exact distinct count, which
    sets the frozen chain capacity."""
    from leon_tpu_torch.ops import count

    keys, _ = count.compact_solid(keys, counts, cutoff)
    M = keys.shape[0]
    cap = chains_cap(nu)
    cb = _caps(M, k, cap)
    if M:
        buf = build(keys, k, cap, cb)
    else:
        buf = torch.zeros(4, dtype=torch.int32, device=keys.device)
    return _Inflight(buf, keys, k, cap, cb)


def drain_build(infl: _Inflight) -> bytes | None:
    """The payload of a dispatched build, or None (the caller writes
    BLOOM): a flagged cycle re-runs the full variant; a chain overflow
    retries once at cap * RETRY_FACTOR (unitig.py:748-782)."""

    def rebuild(cap, cb, acyclic):
        return build(infl.keys, infl.k, cap, cb, acyclic)

    def host(b):
        return b.cpu().numpy().view(np.uint32)

    buf = host(infl.buf)
    acyclic = True
    if buf[2]:  # cycles: the optimistic build is invalid
        acyclic = False
        buf = host(rebuild(infl.cap_chains, infl.cap_bases, False))
    if buf[1]:  # overflow: one retry with a larger cap
        cap = infl.cap_chains * RETRY_FACTOR
        cb = _caps(infl.keys.shape[0], infl.k, cap)
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
    leon_tpu.ops.unitig.solid_indices_dev."""
    q = torch.from_numpy(state.words_to_keys(words)).to(infl.keys.device)
    hit, rank = solid_lookup(infl.keys, infl.k, q)
    return hit.cpu().numpy(), rank.cpu().numpy(), infl.keys.shape[0]


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

    from leon_tpu import native

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

