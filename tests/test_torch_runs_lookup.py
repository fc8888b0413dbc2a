"""K2 `runs`, K8 `solid_lookup` and K14 `word_runs`/`runs_words` on
adversarial inputs: their plain versions against leon_tpu's
_merge_sorted_runs, _hist_of_sorted, compact_solid, count_batch and
solid_indices_dev, exact; the wrappers' host-side logic (K2's and K14's
scratch sizes, K8's splitter choice); and models of the kernels'
algorithms (K2's and K14's step Spans folded over two passes, K14's
interleaved steps and staged writes, K8's splitter sample then one
segment) against the plain versions, so that the kernels' design is
checked here, where no card runs them. Everything is integer: the
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


# ---------------------------------------------------------------------------
# K14: adversarial multiword rows (chip_smoke.py k14_case) at W = 2..16;
# the plain versions against leon_tpu, and a model of K14's design
# (interleaved steps, plane-by-plane heads, item scans, Spans, staged
# writes) against the plain versions
# ---------------------------------------------------------------------------

K14_CASES = chip_smoke.K14_CASES
K14_CUTOFFS = chip_smoke.K14_CUTOFFS
K14_WIDTHS = (2, 4, 5, 8, 16)


def k14_case(name, W, tile=64):
    return chip_smoke.k14_case(name, W, tile, hot=3 * tile + 5)


def _planes(rows):
    return state.words_to_planes(state.words_to_torch(rows, "cpu"))


def _bucket(n):
    """The padded size the reference calls run at (few jit shapes)."""
    return max(64, 1 << (n - 1).bit_length())


def _reference_word_runs(rows, counts, cutoff):
    """leon_tpu: _merge_sorted_runs over the W u32 columns (MSW first; run
    lengths when counts is None), compact_solid at the cutoff and
    _hist_of_sorted over what it keeps. The rows are padded to a bucket
    with all-ones rows of count 0, the reference's own pads, which sort
    last or fold into a real run without changing it."""
    W = rows.shape[1]
    n = rows.shape[0]
    if n == 0:
        return np.zeros((0, W), np.uint32), np.zeros(0, np.int32), np.zeros(256, np.int32)
    size = _bucket(n)
    pw = np.full((size, W), M32, np.uint32)
    pw[:n] = rows
    pc = np.zeros(size, np.int32)
    pc[:n] = 1 if counts is None else counts
    skeys, bnd, summed = ref_count._merge_sorted_runs(
        tuple(jnp.asarray(pw[:, W - 1 - j]) for j in range(W)), jnp.asarray(pc))
    bnd = np.asarray(bnd)
    rw = np.stack([np.asarray(skeys[W - 1 - j])[bnd] for j in range(W)], axis=1)
    rc = np.asarray(summed)[bnd]
    sw = np.zeros((size, W), np.uint32)
    sw[: rc.size] = rw
    sc = np.zeros(size, np.int32)
    sc[: rc.size] = rc
    ow, oc = ref_count.compact_solid(jnp.asarray(sw), jnp.asarray(sc),
                                     np.int32(max(cutoff, 1)), size)
    ns = int((rc >= max(cutoff, 1)).sum())
    hist = np.asarray(ref_count._hist_of_sorted(jnp.asarray(np.arange(size) < ns), oc))
    return np.asarray(ow)[:ns], np.asarray(oc)[:ns], hist


def _words_np(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", K14_CASES)
@pytest.mark.parametrize("W", K14_WIDTHS)
def test_word_runs_plain_matches_reference(W, name):
    """word_runs_plain in its three modes equals leon_tpu's merge, solid
    compaction and histogram (counts at cutoffs 1, 2, 255, 256; run
    lengths), and runs_words_plain equals leon_tpu's count_batch."""
    rows, counts = k14_case(name, W)
    planes = _planes(rows)
    want_w, want_c, want_h = _reference_word_runs(rows, None, 1)
    gw, gc, gh = count.word_runs_plain(planes, W, None, 1, True)
    np.testing.assert_array_equal(_words_np(gw), want_w)
    np.testing.assert_array_equal(gc.numpy(), want_c)
    np.testing.assert_array_equal(gh.numpy(), want_h)
    if rows.shape[0]:
        pad = np.zeros((1, _bucket(rows.shape[0]), W), np.uint32)
        pad[0, : rows.shape[0]] = rows
        uw, uc = ref_count.count_batch(pad, np.arange(pad.shape[1])[None] < rows.shape[0])
        rw, rc = count.runs_words_plain(planes, W)
        np.testing.assert_array_equal(_words_np(rw), uw)
        np.testing.assert_array_equal(rc.numpy(), uc)
    if counts is None:
        return
    tc = torch.from_numpy(counts)
    for cutoff in K14_CUTOFFS:
        want_w, want_c, want_h = _reference_word_runs(rows, counts, cutoff)
        gw, gc, gh = count.word_runs_plain(planes, W, tc, cutoff, True)
        np.testing.assert_array_equal(_words_np(gw), want_w)
        np.testing.assert_array_equal(gc.numpy(), want_c)
        np.testing.assert_array_equal(gh.numpy(), want_h)
        if cutoff > 1:  # compact_solid_words is K14 at the cutoff over the merged run
            mw, mc, _ = count.word_runs_plain(planes, W, tc)
            sw, sc = count.compact_solid_words(mw, mc, cutoff)
            np.testing.assert_array_equal(sw.numpy(), gw.numpy())
            np.testing.assert_array_equal(sc.numpy(), gc.numpy())


def _shfl_up(x, off):
    """__shfl_up_sync over 32 lanes: lane i gets lane i - off (lanes below
    off their own value)."""
    return np.concatenate([x[:off], x[:-off]])


def _k14_step(keys, vals, n, base, items, prev, cut, write=None):
    """WordRows::run over the step's rows base + 32 j + lane (keys (n, NP)
    int64 planes, vals (n,) u32 or None for lengths): the step's Span and,
    in the write pass (write = (P, W, v64)), the runs it writes: a list of
    (words, value) in output order, through the staging layout."""
    NP = keys.shape[1]
    lanes = np.arange(32)
    idx = base + 32 * np.arange(items)[:, None] + lanes[None, :]  # (items, 32)
    vd = idx < n
    safe = np.minimum(idx, max(n - 1, 0))
    k = np.zeros((items, 32, NP), np.int64)
    v = np.ones((items, 32), np.int64) if vals is None else np.zeros((items, 32), np.int64)
    if n:
        k = np.where(vd[..., None], keys[safe], 0)
        if vals is not None:
            v = np.where(vd, vals[safe], 0)
    # plane by plane, each row against the row before it: lane - 1's (one
    # rotating shuffle), at lane 0 lane 31's of the item before, or prev
    flat = k.reshape(items * 32, NP)
    before = np.concatenate([np.asarray(prev, np.int64)[None, :], flat[:-1]])
    same = np.ones(items * 32, bool)
    for q in range(NP):
        same &= flat[:, q] == before[:, q]
    h = ~vd | (idx == 0) | ~same.reshape(items, 32)
    # a tail: the next row of the step (lane + 1's, at lane 31 lane 0's of
    # the next item) is a head; the step's last row is closed by the next step
    tl = np.concatenate([h.reshape(-1)[1:], [False]]).reshape(items, 32)
    F = np.zeros((items, 32), bool)
    S = np.zeros((items, 32), np.int64)
    cf, cs = False, 0
    for j in range(items):  # a warp scan an item, then the carry
        af, as_ = h[j].copy(), v[j] & M32
        off = 1
        while off < 32:
            pf, ps = _shfl_up(af, off), _shfl_up(as_, off)
            take = lanes >= off
            nf = np.where(take, pf | af, af)
            ns = np.where(take, np.where(af, as_, (ps + as_) & M32), as_)
            af, as_ = nf, ns
            off <<= 1
        F[j] = cf | af
        S[j] = np.where(af, as_, (cs + as_) & M32)
        cf, cs = bool(F[j, 31]), int(S[j, 31])
    edge = bool(h[0, 0]) and base > 0
    ends = tl & vd  # the rows where a run ends in the step
    clamped = np.minimum(S, I32_MAX)
    e = int((ends & F & (clamped >= cut)).sum())
    lone = ends & ~F  # the run entering from the left ends here (one row at most)
    assert lone.sum() <= 1 and not (edge and lone.any())
    pend = edge or bool(lone.any())
    pre = int(S[lone][0]) if lone.any() else 0
    A = (int(not cf) | (2 if pend else 0), pre, cs, e)
    if write is None:
        return A, None
    P, W, v64 = write
    pend_out = pend and _clamp(P[2] + pre) >= cut
    step = 32 * items
    stage_w = np.full(step * 2 * NP + step * 2 * NP // 32, -1, np.int64)
    stage_v = np.full(step, -1, np.int64)
    # the unflipped u32 words of every row of the step, word w of row (j, lane)
    u = k.astype(np.uint64) ^ np.uint64(1 << 63)
    words = np.concatenate([np.stack([u[..., q] & np.uint64(M32), u[..., q] >> np.uint64(32)],
                                     axis=-1) for q in range(NP)], axis=-1)[..., :W].astype(np.int64)

    def put(slots, rows_w, vals_):
        i = slots[:, None] * W + np.arange(W)[None, :]
        stage_w[i + (i >> 5)] = rows_w
        stage_v[slots] = vals_ & M32 if v64 else np.minimum(vals_ & M32, I32_MAX)

    o = 0
    if edge and pend_out:
        pu = np.array([int(x) % (1 << 64) ^ (1 << 63) for x in prev], dtype=object)
        pw = [(int(pu[w // 2]) >> (32 * (w % 2))) & M32 for w in range(W)]
        put(np.array([0]), np.array([pw], np.int64), np.array([P[2]], np.int64))
        o = 1
    for j in range(items):  # slots: o + the emitting lanes before each, item by item
        em = ends[j] & np.where(F[j], clamped[j] >= cut, pend_out)
        lanes_em = np.flatnonzero(em)
        s_ = np.where(F[j], S[j], P[2] + S[j])[lanes_em]
        put(o + np.arange(lanes_em.size), words[j, lanes_em], s_)
        o += lanes_em.size
    idx_out = np.arange(o * W)
    out_w = stage_w[idx_out + (idx_out >> 5)].reshape(o, W)
    assert (out_w >= 0).all() and (stage_v[:o] >= 0).all()  # every slot was staged
    return A, list(zip(out_w.astype(np.uint32), stage_v[:o]))


def _k14_model(rows, counts, cutoff, items, per, threads, v64):
    """K14's two passes over the n + 1 rows (row n past the end) as
    runs_pass_kernel runs them, a warp's stretch being `per` steps of 32 *
    items rows. Returns (words (R, W) u32, values (R,), hist)."""
    W = rows.shape[1]
    planes = _planes(rows)
    keys = np.stack([p.numpy() for p in planes], axis=1).reshape(rows.shape[0], len(planes))
    n = rows.shape[0]
    vals = None if counts is None else counts.astype(np.int64) & M32
    cut = max(cutoff, 1)
    step = 32 * items
    steps = (n + step) // step
    chunks = [range(c, min(c + per, steps)) for c in range(0, steps, per)]

    def prev_of(t):
        return keys[t * step - 1] if t > 0 else np.zeros(keys.shape[1], np.int64)

    aggs = []
    for ch in chunks:  # the count pass
        acc = IDENT
        for t in ch:
            acc = _cat(acc, _k14_step(keys, vals, n, t * step, items, prev_of(t), cut)[0], cut)
        aggs.append(acc)
    R = _cat(EMPTY, _block_fold(aggs, cut, threads), cut)[3]
    out, blocks = [], {}
    for b, ch in enumerate(chunks):  # the write pass: the blocks before, then its own warps
        blk = b - b % 8
        if blk not in blocks:  # every warp of a block folds the same Spans
            blocks[blk] = _cat(EMPTY, _block_fold(aggs[:blk], cut, threads), cut)
        pfx = blocks[blk]
        for agg in aggs[blk:b]:
            pfx = _cat(pfx, agg, cut)
        for t in ch:
            A, runs_ = _k14_step(keys, vals, n, t * step, items, prev_of(t), cut, (pfx, W, v64))
            assert len(out) == pfx[3]  # the step writes at the prefix's count
            out += runs_
            pfx = _cat(pfx, A, cut)
            assert len(out) == pfx[3]
    assert len(out) == R
    words = np.array([w for w, _ in out], np.uint32).reshape(-1, W)
    values = np.array([v for _, v in out], np.int64)
    hist = np.bincount(np.minimum(values, 255), minlength=256)
    hist[0] = 0
    return words, values, hist


@pytest.mark.parametrize("items,per,threads", [(2, 1, 256), (4, 3, 4), (8, 7, 64)])
@pytest.mark.parametrize("name", K14_CASES)
@pytest.mark.parametrize("W", K14_WIDTHS)
def test_word_runs_model_matches_plain(W, name, items, per, threads):
    """The model of K14 equals word_runs_plain (counts at cutoffs 1, 2,
    255, 256 with the histogram; run lengths) and runs_words_plain, however
    the steps are cut into items and stretches and however many threads
    fold the Spans."""
    rows, counts = k14_case(name, W, 32 * items)
    planes = _planes(rows)
    modes = [(None, 1, False)] + ([] if counts is None else
                                  [(counts, c, False) for c in K14_CUTOFFS])
    for cnt, cutoff, _ in modes:
        gw, gv, gh = _k14_model(rows, cnt, cutoff, items, per, threads, False)
        tc = None if cnt is None else torch.from_numpy(cnt)
        ww, wv, wh = count.word_runs_plain(planes, W, tc, cutoff, True)
        np.testing.assert_array_equal(gw, _words_np(ww))
        np.testing.assert_array_equal(gv, wv.numpy())
        np.testing.assert_array_equal(gh, wh.numpy())
    gw, gv, _ = _k14_model(rows, None, 1, items, per, threads, True)
    ww, wv = count.runs_words_plain(planes, W)
    np.testing.assert_array_equal(gw, _words_np(ww))
    np.testing.assert_array_equal(gv, wv.numpy())


@pytest.mark.parametrize("W", range(1, 17))
def test_word_runs_step_and_scratch(W):
    """K14's step (csrc/count.cu WordRows::STEP: 8 rows a lane at one
    plane, 4 at two to four, 2 past that) sizes its scratch: a Span a warp
    of at most one a step, a block's worth more, and a counter."""
    P = (W + 1) // 2
    step = count._word_runs_step(W)
    assert step == 32 * (8 if P == 1 else 4 if P <= 4 else 2)
    for n in (0, 1, step - 1, step, 25_239_809):
        assert count._runs_scratch_bytes(n, step) == 16 * ((n + step) // step + 8) + 4
