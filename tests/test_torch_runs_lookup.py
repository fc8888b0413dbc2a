"""K2 `runs` and K8 `solid_lookup` on adversarial inputs: their plain
versions against leon_tpu's _merge_sorted_runs, _hist_of_sorted,
compact_solid and solid_indices_dev, exact; the wrappers' host-side logic
(K2's scratch size, K8's splitter choice); and models of the two kernels'
algorithms (K2's step Spans folded over two passes, K8's splitter sample
then one segment) against the plain versions, so that the kernels' design
is checked here, where no card runs them. Everything is integer: the
tolerance is 0."""

import bisect
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import SENTINEL_KEY as SENTINEL
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import unitig as ref_unitig
from leon_tpu_torch import state
from leon_tpu_torch.ops import count, unitig

M32 = 0xFFFFFFFF
I32_MAX = 0x7FFFFFFF

# chip_smoke.py's adversarial inputs, at CPU size: the card runs the
# kernels on the same generators at full size
K2_CASES = chip_smoke.K2_CASES
k2_case = chip_smoke.k2_case


def _reference_runs(keys, counts, cutoff):
    """leon_tpu: _merge_sorted_runs (counts 1 a valid row in length mode;
    SENTINEL rows are the reference's all-ones pads with count 0), then
    compact_solid at the cutoff and _hist_of_sorted over what it keeps."""
    if keys.size == 0:  # nothing to merge
        return np.zeros((0, 2), np.uint32), np.zeros(0, np.int32), np.zeros(256, np.int32)
    valid = keys != SENTINEL
    c = (valid.astype(np.int32) if counts is None else np.where(valid, counts, 0)).astype(np.int32)
    words = state.keys_to_words(np.where(valid, keys, 0), 2)
    words[~valid] = M32
    skeys, bnd, summed = ref_count._merge_sorted_runs(
        (jnp.asarray(words[:, 1]), jnp.asarray(words[:, 0])), jnp.asarray(c))
    bnd = np.asarray(bnd)
    rw = np.stack([np.asarray(skeys[1])[bnd], np.asarray(skeys[0])[bnd]], axis=1)
    rc = np.asarray(summed)[bnd]
    nu = rc.size
    size = max(nu, 1)
    ow, oc = ref_count.compact_solid(jnp.asarray(np.resize(rw, (size, 2))),
                                     jnp.asarray(np.resize(rc, size) * (nu > 0)),
                                     np.int32(max(cutoff, 1)), size)
    ns = int((rc >= max(cutoff, 1)).sum())
    ow, oc = np.asarray(ow)[:ns], np.asarray(oc)[:ns]
    hist = np.asarray(ref_count._hist_of_sorted(jnp.ones(ns, bool), jnp.asarray(oc)))
    return ow, oc, hist


@pytest.mark.parametrize("cutoff", [1, 2, 300])
@pytest.mark.parametrize("name", K2_CASES)
def test_runs_plain_matches_reference(name, cutoff):
    keys, counts = k2_case(name, tile=64, hot=1 << 12)
    tk = torch.from_numpy(keys)
    tc = None if counts is None else torch.from_numpy(counts)
    gk, gc, gh = count.runs_plain(tk, tc, cutoff, want_hist=True)
    want_w, want_c, want_h = _reference_runs(keys, counts, cutoff)
    np.testing.assert_array_equal(state.keys_from_torch(gk, 2), want_w)
    np.testing.assert_array_equal(gc.numpy(), want_c)
    np.testing.assert_array_equal(gh.numpy(), want_h)
    if cutoff > 1 and counts is not None:  # compact_solid is K2 at the cutoff
        sk, sc = count.compact_solid(*count.runs_plain(tk, tc)[:2], cutoff)
        np.testing.assert_array_equal(sk.numpy(), gk.numpy())
        np.testing.assert_array_equal(sc.numpy(), gc.numpy())


# ---------------------------------------------------------------------------
# K2's algorithm: tile Spans, chunk folds, two passes (csrc/count.cu)
# ---------------------------------------------------------------------------

IDENT = (1, 0, 0, 0)  # (flags, pre, suf, e): interior, nothing carried
EMPTY = (0, 0, 0, 0)  # the prefix before the first row


def _clamp(s):
    return min(s & M32, I32_MAX)


def _cat(L, R, cut):
    """csrc/count.cu cat(): span L, then span R."""
    if R[0] & 1:
        return (L[0], L[1], (L[2] + R[2]) & M32, L[3])
    if L[0] & 1:
        return (R[0] & 2, (L[2] + R[1]) & M32, R[2], R[3])
    emit = bool(R[0] & 2) and _clamp(L[2] + R[1]) >= cut
    return (L[0] & 2, L[1], R[2], L[3] + R[3] + emit)


def _block_fold(spans, cut, threads):
    """block_fold(): contiguous stretches a thread, a shuffle tree in each
    warp of 32, then the warps in order."""
    n = len(spans)
    per = -(-n // threads) if n else 0
    x = []
    for t in range(threads):
        acc = IDENT
        for sp in spans[min(n, t * per) : min(n, t * per + per)]:
            acc = _cat(acc, sp, cut)
        x.append(acc)
    warps = []
    for w in range(0, threads, 32):
        lanes = x[w : w + 32]
        off = 1
        while off < len(lanes):  # simultaneous shuffles: read the old values
            lanes = [_cat(lanes[ln], lanes[ln + off], cut) if ln + off < len(lanes) else lanes[ln]
                     for ln in range(len(lanes))]
            off <<= 1
        warps.append(lanes[0])
    out = IDENT
    for wv in warps:
        out = _cat(out, wv, cut)
    return out


def _tile_span(keys, counts, tile, t, cut):
    """step_run(): the rows of step t as (row, F, S, tail, valid), the edge
    run (the run before the step, if the step's first row closes it), and
    the step's Span. A tail is a head on the next row of the same step; a
    run that ends on the step's last row is closed by the next step."""
    n = keys.size

    def key(i):
        return int(keys[i]) if 0 <= i < n else SENTINEL

    def val(i):
        if i >= n:
            return 0
        return 1 if counts is None else int(counts[i]) & M32

    first, last = t * tile, (t + 1) * tile
    F, S, items = False, 0, []
    for i in range(first, last):
        head = key(i) != key(i - 1)  # before row 0: SENTINEL
        S = val(i) if head else (S + val(i)) & M32
        F = F or head
        tail = i + 1 < last and key(i + 1) != key(i)
        items.append((i, F, S, tail, key(i) != SENTINEL))
    edge = first > 0 and key(first) != key(first - 1) and key(first - 1) != SENTINEL
    pending, pre, e = (2 if edge else 0), 0, 0
    for i, f, s, tail, valid in items:
        if tail and valid:
            if f:
                e += _clamp(s) >= cut
            else:
                pending, pre = 2, s
    return items, edge, (int(not F) | pending, pre, S, e)


def _k2_model(keys, counts, cutoff, tile, per, threads):
    """The two passes over the n + 1 rows (row n a SENTINEL), a warp's
    stretch being `per` steps of `tile` rows: the count pass's folds a
    warp and R (a block_fold of them all), then the write pass from each
    warp's prefix (a block_fold of the blocks' warps before it, then its
    block's earlier warps in order). Returns (keys, values, hist) as
    runs() does."""
    cut = max(cutoff, 1)
    steps = (keys.size + tile) // tile
    chunks = [range(c, min(c + per, steps)) for c in range(0, steps, per)]
    spans = [_tile_span(keys, counts, tile, t, cut)[2] for t in range(steps)]
    aggs = []
    for ch in chunks:  # the count pass
        acc = IDENT
        for t in ch:
            acc = _cat(acc, spans[t], cut)
        aggs.append(acc)
    R = _cat(EMPTY, _block_fold(aggs, cut, threads), cut)[3]
    out = []
    for b, ch in enumerate(chunks):  # the write pass: the blocks before, then its own warps
        blk = b - b % 8
        pfx = _cat(EMPTY, _block_fold(aggs[:blk], cut, threads), cut)
        for agg in aggs[blk:b]:
            pfx = _cat(pfx, agg, cut)
        for t in ch:
            items, edge, A = _tile_span(keys, counts, tile, t, cut)
            base = pfx[3]
            if edge and _clamp(pfx[2]) >= cut:
                out.append((base, int(keys[t * tile - 1]), _clamp(pfx[2])))
                base += 1
            for i, f, s, tail, valid in items:
                v = _clamp(s if f else pfx[2] + s)
                if tail and valid and v >= cut:
                    out.append((base, int(keys[i]), v))
                    base += 1
            pfx = _cat(pfx, A, cut)
            assert base == pfx[3]  # the prefix counts what the step wrote
    assert [o[0] for o in out] == list(range(len(out))) and len(out) == R
    ok = np.array([o[1] for o in out], np.int64)
    oc = np.array([o[2] for o in out], np.int32)
    hist = np.bincount(np.minimum(oc, 255), minlength=256)
    hist[0] = 0
    return ok, oc, hist


@pytest.mark.parametrize("per,threads", [(1, 256), (3, 4), (7, 64)])
@pytest.mark.parametrize("cutoff", [1, 2, 300])
@pytest.mark.parametrize("name", K2_CASES)
def test_runs_tile_model_matches_plain(name, cutoff, per, threads):
    """The folds are exact however the steps are cut into warps' stretches
    and however many threads fold the warps' Spans."""
    tile = 16
    keys, counts = k2_case(name, tile=tile, hot=300)
    gk, gc, gh = _k2_model(keys, counts, cutoff, tile, per, threads)
    tc = None if counts is None else torch.from_numpy(counts)
    wk, wc, wh = count.runs_plain(torch.from_numpy(keys), tc, cutoff, want_hist=True)
    np.testing.assert_array_equal(gk, wk.numpy())
    np.testing.assert_array_equal(gc, wc.numpy())
    np.testing.assert_array_equal(gh, wh.numpy())


def test_span_cat_is_associative():
    """cat() is a monoid with IDENT as its unit, on random Spans."""
    rng = np.random.default_rng(3)

    def span():
        flags = int(rng.integers(0, 4))
        if flags & 1:
            return (1, 0, int(rng.integers(0, 1 << 32)), 0)
        return (flags, int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32)),
                int(rng.integers(0, 50)))

    for cut in (1, 2, 300, I32_MAX):
        for _ in range(300):
            a, b, c = span(), span(), span()
            assert _cat(_cat(a, b, cut), c, cut) == _cat(a, _cat(b, c, cut), cut)
            assert _cat(IDENT, a, cut) == a and _cat(a, IDENT, cut) == a


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 1 << 27])
def test_runs_scratch_bytes(n):
    """A 16-byte Span for each warp (at most one a step, and a block's
    worth more) and a counter."""
    assert count._runs_scratch_bytes(n) == 16 * ((n + count.RUNS_STEP) // count.RUNS_STEP + 8) + 4


# ---------------------------------------------------------------------------
# K8: adversarial solid runs and queries, at k = 15, 16, 31 and W = 2..16
# ---------------------------------------------------------------------------

K8_K = chip_smoke.K8_KS  # int64 keys at k <= 31, then W = 2, 4, 8, 16 words
K8_CASES = chip_smoke.K8_CASES


def k8_case(name, k):
    return chip_smoke.k8_case(name, k, 3000)


def _run_form(words, k):
    """The counter's form of (n, W) u32 rows: int64 keys at k <= 31."""
    if k <= 31:
        return torch.from_numpy(state.words_to_keys(words))
    return state.words_to_torch(words, "cpu")


@pytest.mark.parametrize("name", K8_CASES)
@pytest.mark.parametrize("k", K8_K)
def test_solid_lookup_plain_matches_solid_indices_dev(name, k):
    rows, q = k8_case(name, k)
    infl = SimpleNamespace(words=jnp.asarray(rows), counts=jnp.ones(rows.shape[0], jnp.int32),
                           cutoff=1, k=k)
    want_hit, want_rank, ns = ref_unitig.solid_indices_dev(infl, q)
    hit, rank = unitig.solid_lookup_plain(_run_form(rows, k), k, _run_form(q, k))
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    assert ns == rows.shape[0] and want_hit.any() and not want_hit.all()


def _k8_model(rows_int, q_int, row_bytes):
    """lookup_kernel: the splitter sample, then one segment of the run."""
    M = len(rows_int)
    S, step = unitig._lookup_split(M, row_bytes)
    sample = rows_int[::step]
    assert len(sample) == S
    out = []
    for x in q_int:
        lo = bisect.bisect_right(sample, x)
        j = -1
        if lo:
            a = (lo - 1) * step
            if sample[lo - 1] == x:
                j = a
            else:
                b = min(a + step, M)
                a = bisect.bisect_left(rows_int, x, a + 1, b)
                j = a if a < M and rows_int[a] == x else -1
        out.append(j)
    return np.array(out, np.int64)


@pytest.mark.parametrize("sample_rows", [4, 1024])
@pytest.mark.parametrize("name", K8_CASES)
@pytest.mark.parametrize("k", [15, 31, 63, 255])
def test_lookup_split_model_matches_plain(k, name, sample_rows, monkeypatch):
    monkeypatch.setattr(unitig, "LOOKUP_SAMPLE_ROWS", sample_rows)
    rows, q = k8_case(name, k)
    W = rows.shape[1]
    as_int = [int(sum(int(r[j]) << (32 * j) for j in range(W))) for r in rows]
    q_int = [int(sum(int(r[j]) << (32 * j) for j in range(W))) for r in q]
    j = _k8_model(as_int, q_int, 8 if k <= 31 else 4 * W)
    hit, rank = unitig.solid_lookup_plain(_run_form(rows, k), k, _run_form(q, k))
    np.testing.assert_array_equal(j >= 0, hit.numpy())
    np.testing.assert_array_equal(np.where(j >= 0, j, 0), rank.numpy())


@pytest.mark.parametrize("row_bytes", [8, 12, 16, 32, 64])
@pytest.mark.parametrize("M", [1, 5, 1023, 1024, 1025, 2_014_298, 14_254_300])
def test_lookup_split_fits_and_covers(M, row_bytes):
    S, step = unitig._lookup_split(M, row_bytes)
    assert 1 <= S <= unitig.LOOKUP_SAMPLE_ROWS
    assert S * row_bytes <= unitig.LOOKUP_SAMPLE_BYTES
    assert (S - 1) * step < M <= S * step
