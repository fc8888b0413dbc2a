"""Kernel K23 (csrc/sort.cu `merge_path`) as the card runs it, on the CPU at
tolerance 0 (everything is integer), and the counters' merge route built on
it against leon_tpu.

A numpy model of the kernel (pairwise rounds over the runs in order, an odd
last run waiting for the next round; in a round, blocks of merge_tile(W)
outputs of one pair; a block's two cross-diagonals found by the 32-ary warp
search; the stretches it copies; each thread's sub-diagonal by a binary
search and its items merged serially with the tops compared first and the
lower words on a tie, A's element first on equal elements) runs on every
chip_smoke.merge_case (R = 2, 3, 5, 9; runs of 0, 1 and a tile +- 1
elements; equal elements; one run before or after another; interleaved;
rows equal but in word 0; both sides of the int64 sign and of word W-1's
top bit; an all-ones tail) at keys of k = 15, 31 and rows of W = 2, 3, 4,
8, 16, and what it gives is held against np.argsort / np.lexsort (stable)
of the runs' concatenation and against merge_path_plain, elements and
counts. Then the counters' merges (DeviceCounter at k = 21, 31; the
WordCounter at k = 63, 127), forced with one chunk a slab, so that 2-9 runs
merge, against leon_tpu's _merge_sorted_runs and _hist_of_sorted of the
runs' concatenation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu_torch import state
from leon_tpu_torch.ops import count

SIGN = np.uint64(1 << 63)
FORMS = chip_smoke.MERGE_KEYS + chip_smoke.MERGE_ROWS


def _words(data: np.ndarray) -> np.ndarray:
    """A run's elements as (n, W) u32 words, least significant first."""
    return data.view(np.uint32).reshape(data.shape[0], -1)


def _top(x: np.ndarray, signed: bool) -> np.ndarray:
    t = (x[:, -1].astype(np.uint64) << np.uint64(32)) | x[:, -2].astype(np.uint64)
    return t ^ SIGN if signed else t


def _le(a: np.ndarray, b: np.ndarray, signed: bool) -> np.ndarray:
    """a[i] <= b[i], as mp_le: the tops first, then words W-3 .. 0."""
    ta, tb = _top(a, signed), _top(b, signed)
    low = np.ones(a.shape[0], bool)
    open_ = np.ones(a.shape[0], bool)
    for q in range(a.shape[1] - 3, -1, -1):
        d = open_ & (a[:, q] != b[:, q])
        low[d] = a[d, q] < b[d, q]
        open_ &= ~d
    return (ta < tb) | ((ta == tb) & low)


def _warp_search(A, B, d: np.ndarray, signed: bool) -> np.ndarray:
    """mp_search for each diagonal of d at once: 32 probes a step, the lanes
    below t (the count of true predicates) true."""
    na, nb = A.shape[0], B.shape[0]
    lo, hi = np.maximum(d - nb, 0), np.minimum(d, na)
    lane = np.arange(32)
    while (lo < hi).any():
        act = lo < hi
        span = (hi - lo)[:, None]
        m = np.where(span <= 32, lo[:, None] + lane, lo[:, None] + span * lane // 32)
        ok = act[:, None] & (m < hi[:, None])
        pred = np.zeros(m.shape, bool)
        if ok.any():
            mi, bi = m[ok], (d[:, None] - 1 - m)[ok]
            pred[ok] = _le(A[mi], B[bi], signed)
        t = pred.sum(axis=1)
        assert (pred == (lane[None, :] < t[:, None])).all()  # true, then false
        s = span[:, 0]
        nlo = np.where(s <= 32, lo + t, np.where(t > 0, lo + s * (t - 1) // 32 + 1, lo))
        nhi = np.where(s <= 32, lo + t, np.where(t < 32, lo + s * t // 32, hi))
        lo, hi = np.where(act, nlo, lo), np.where(act, nhi, hi)
    return lo


def _block(A, B, signed: bool, items: int) -> np.ndarray:
    """One block's tile (A and B its stretches): each thread's sub-diagonal
    by a binary search, its items merged serially. Returns each output's
    source (i for A[i], na + j for B[j])."""
    na, nb = A.shape[0], B.shape[0]
    tn = na + nb
    diag = np.minimum(np.arange(count.MERGE_THREADS) * items, tn)
    lo, hi = np.maximum(diag - nb, 0), np.minimum(diag, na)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        le = np.zeros(diag.shape, bool)
        le[act] = _le(A[mid[act]], B[(diag - 1 - mid)[act]], signed)
        lo = np.where(act & le, mid + 1, lo)
        hi = np.where(act & ~le, mid, hi)
    i, j = lo.copy(), diag - lo
    src = np.full(tn, -1, np.int64)
    for step in range(items):
        p = diag + step
        live = p < np.minimum(diag + items, tn)
        take_a = live & (j >= nb)
        both = live & (j < nb) & (i < na)
        if both.any():
            take_a[both] = _le(A[i[both]], B[j[both]], signed)
        take_b = live & ~take_a
        src[p[take_a]] = i[take_a]
        src[p[take_b]] = na + j[take_b]
        i, j = i + take_a, j + take_b
    assert (src >= 0).all()  # every output written once
    return src


def _pair(A, ca, B, cb, signed: bool) -> tuple:
    """One pair's merge as K23's blocks make it."""
    W = A.shape[1]
    tile, items = count.merge_tile(W), count.merge_tile(W) // count.MERGE_THREADS
    na, nb = A.shape[0], B.shape[0]
    d = np.arange(0, na + nb, tile)
    a0 = _warp_search(A, B, d, signed)
    a1 = np.append(a0[1:], na)
    out, cout = np.empty((na + nb, W), np.uint32), np.empty(na + nb, np.int32)
    for blk in range(d.shape[0]):
        b0 = d[blk] - a0[blk]
        b1 = min(d[blk] + tile, na + nb) - a1[blk]
        sa, sb = A[a0[blk] : a1[blk]], B[b0:b1]
        src = _block(sa, sb, signed, items)
        rows = np.concatenate([sa, sb])
        cnt = np.concatenate([ca[a0[blk] : a1[blk]], cb[b0:b1]])
        out[d[blk] : d[blk] + src.shape[0]] = rows[src]
        cout[d[blk] : d[blk] + src.shape[0]] = cnt[src]
    return out, cout


def merge_model(runs: list, signed: bool) -> tuple:
    """K23's rounds (ops/count.py _merge_rounds) over the nonempty runs."""
    parts = [(_words(d), c) for d, c in runs if c.shape[0]]
    if not parts:
        return None
    while len(parts) > 1:
        merged = [_pair(a, ca, b, cb, signed) for (a, ca), (b, cb) in zip(parts[0::2], parts[1::2])]
        parts = merged + parts[2 * len(merged) :]
    return parts[0]


@pytest.mark.parametrize("name", chip_smoke.MERGE_CASES)
@pytest.mark.parametrize("form,width", FORMS)
def test_merge_model_matches_stable_sort_and_plain(form, width, name):
    runs = chip_smoke.merge_case(name, form, width)
    keys = form == "keys"
    got = merge_model(runs, keys)
    data = np.concatenate([d for d, _ in runs])
    counts = np.concatenate([c for _, c in runs])
    if keys:
        order = np.argsort(data, kind="stable")
    else:
        w = _words(data)
        order = np.lexsort([w[:, q] for q in range(w.shape[1])])
    want_w, want_c = _words(data[order]), counts[order]
    np.testing.assert_array_equal(got[0], want_w)
    np.testing.assert_array_equal(got[1], want_c)
    plain = count.merge_path_plain([(torch.from_numpy(d), torch.from_numpy(c)) for d, c in runs])
    np.testing.assert_array_equal(_words(plain[0].numpy()), want_w)
    np.testing.assert_array_equal(plain[1].numpy(), want_c)
    # the wrapper's CPU route (a check that each run is sorted, then the
    # plain version) gives the same
    wrap = count.merge_path if keys else count.merge_path_rows
    out = wrap([(torch.from_numpy(d), torch.from_numpy(c)) for d, c in runs])
    np.testing.assert_array_equal(_words(out[0].numpy()), want_w)
    np.testing.assert_array_equal(out[1].numpy(), want_c)


def test_merge_wrappers_refuse_unsorted_runs_and_bad_shapes():
    k = torch.tensor([3, 1], dtype=torch.int64)
    c = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="not sorted"):
        count.merge_path([(k, c), (k.sort().values, c)])
    rows = torch.tensor([[0, 1], [5, 0]], dtype=torch.int32)  # (1, 0) > (0, 5), MSW first
    with pytest.raises(ValueError, match="not sorted"):
        count.merge_path_rows([(rows, c)])
    with pytest.raises(ValueError, match="2 <= W <= 16"):
        count.merge_path_rows([(torch.zeros(2, 17, dtype=torch.int32), c)])
    with pytest.raises(ValueError, match="counts"):
        count.merge_path([(k.sort().values, c.to(torch.int64))])
    with pytest.raises(ValueError, match="no runs"):
        count.merge_path([])


# (k, chunks, merge_factor): one chunk a slab; 1000: every run waits for the
# final merge (R = chunks), 1 and 2: merges of two runs along the way
COUNTER_CASES = ((21, 2, 1000), (31, 9, 1000), (31, 6, 1), (63, 5, 1000), (63, 6, 2),
                 (127, 9, 1000))


@pytest.mark.parametrize("k,chunks,merge_factor", COUNTER_CASES)
def test_counter_merges_match_reference(k, chunks, merge_factor):
    """Every merge of the counter's runs (K23's plain route, then K2 or K14's
    row policy with the histogram at finalize) against leon_tpu's
    _merge_sorted_runs and _hist_of_sorted over the runs' concatenation."""
    rng = np.random.default_rng(k * 100 + chunks)
    W, B = count.words_for_k(k), 8
    L = k + 40
    contig = rng.integers(0, 4, 3 * L, dtype=np.uint8)
    cls = count.DeviceCounter if k <= 31 else count.WordCounter
    port = cls(k, "cpu", slab_kmers=B * (L - k + 1), merge_factor=merge_factor)
    merges = []
    merge = port._merge_sorted

    def recorded(parts, want_hist):
        out = merge(parts, want_hist)
        merges.append((parts, want_hist, out))
        return out

    port._merge_sorted = recorded
    for _ in range(chunks):
        st = rng.integers(0, contig.size - L, B)
        seqs = contig[st[:, None] + np.arange(L)]
        mut = rng.random(seqs.shape) < 0.02
        seqs[mut] = (seqs[mut] + 1) & 3
        seqs[1::2] = (3 - seqs[1::2])[:, ::-1]
        lens = np.full(B, L, np.int32)
        port.add_packed(state.packed_to_torch(ref_kmer.pack_codes_np(seqs), "cpu"),
                        torch.from_numpy(lens), L)
    port.finalize(None, None, None, 7)
    sizes = [len(p) for p, _, _ in merges]
    assert max(sizes) >= 2 and (merge_factor < 1000 or sizes[-1] == chunks)
    for parts, want_hist, (uk, uc, hist) in merges[-3:]:
        data = np.concatenate([d.numpy() for d, _ in parts])
        counts = np.concatenate([c.numpy() for _, c in parts])
        words = _words(data)
        keys_t = tuple(jnp.asarray(words[:, W - 1 - j]) for j in range(W))
        skeys, bd, summed = ref_count._merge_sorted_runs(keys_t, jnp.asarray(counts))
        bd = np.asarray(bd)
        want_w = np.stack([np.asarray(skeys[W - 1 - j])[bd] for j in range(W)], axis=1)
        np.testing.assert_array_equal(_words(uk.numpy()), want_w)
        np.testing.assert_array_equal(uc.numpy(), np.asarray(summed)[bd])
        if want_hist:
            np.testing.assert_array_equal(
                hist.numpy(), np.asarray(ref_count._hist_of_sorted(bd, summed)))
