"""Unitig coding of the solid k-mer set, host half (a copy of
leon_tpu/ops/unitig.py:49-341 and 790-936).

The archive stores the solid set as unitigs and the decoder rebuilds the
bit-identical Bloom filter from them (FORMAT.md §4a; see the reference
module's docstring for the construction). The port runs the reference's
production builder, the native host one; the device builder
(unitig_device_max_kmers > 0) is not ported. Copied, with the k-mer and
Bloom imports pointed at the port, because the reference module reaches
jax through them; it must stay identical in behaviour
(tests/test_torch_pipeline.py compares whole archives).
"""

from __future__ import annotations

import numpy as np

from leon_tpu.utils import varint

__all__ = [
    "chains_cap", "build_np_payload", "payload_from", "parse_payload",
    "rebuild_bitset_np", "spell_canon", "sort_rows_bigint", "solid_kmers_sorted",
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

