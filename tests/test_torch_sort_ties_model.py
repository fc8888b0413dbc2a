"""count_batch as the card runs it (W >= 3): top_sort (one torch.sort of the
rows' top 64 bits), then K20 `sort_ties` (csrc/count.cu) in the rounds of
ops/count.py _tie_rounds, then K14. A numpy model of one K20 round (a run of
one row written at once; runs of up to 32 rows settled by a warp and of up
to 1,024 by a block, each all-equal or ranked by its rows, MSW first; longer
runs left to the next round; in the final round every row written where it
stands) goes through the port's own _tie_rounds, and the planes it gives are
held against sort_ties_plain and, reduced by runs_words_plain, against
leon_tpu's count_batch; count_batch and count_batch_plain on the CPU too.
Inputs: chip_smoke.py's tie_case (runs of 1, 2, 31, 32, 33, 1,024, 1,025
and 65,536 equal top words, runs of 2, 32, 1,024 and 2,000 equal rows, or one run of
70,000 rows; lower words around the int64 sign flip; rows equal but for
word 0) at W = 3..16, and the tensor path's k-mers. Everything is integer:
the tolerance is 0."""

import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu_torch import state
from leon_tpu_torch.ops import count, kmer

WARP, BLOCK = count.TIE_WARP_RUN, count.TIE_BLOCK_RUN


class ModelLaunch:
    """One K20 round in numpy, as _sort_ties_launch runs it on the card;
    counts the rows each path took. With pay = (pay, pay_out), each row's
    value goes where the row goes, as the kernel's st_put writes it."""

    def __init__(self):
        self.paths = dict(single=0, warp=0, block=0, long=0, final=0, equal_runs=0)

    def __call__(self, keys, src, rows, W, out, dst, final, pay=None):
        n = keys.shape[0]
        d = np.arange(n) if dst is None else dst.numpy()
        src_np = src.numpy()
        rows_u = rows.numpy().view(np.uint32)[src_np]
        planes = [p.numpy() for p in state.words_to_planes(torch.from_numpy(rows_u.view(np.int32)))]

        def put(at, idx):
            for o, p in zip(out, planes):
                o[torch.from_numpy(d[at])] = torch.from_numpy(p[idx])
            if pay is not None:
                pay[1][torch.from_numpy(d[at])] = pay[0][torch.from_numpy(src_np[idx])]

        if final:
            self.paths["final"] += n
            put(np.arange(n), np.arange(n))
            return None
        k = keys.numpy()
        head = np.ones(n, bool)
        head[1:] = k[1:] != k[:-1]
        starts = np.flatnonzero(head)
        lengths = np.diff(np.append(starts, n))
        run = np.repeat(np.arange(starts.size), lengths)
        length = lengths[run]
        settle = length <= BLOCK
        self.paths["single"] += int((length == 1).sum())
        self.paths["warp"] += int(((length > 1) & (length <= WARP)).sum())
        self.paths["block"] += int(((length > WARP) & settle).sum())
        self.paths["long"] += int((~settle).sum())
        i = np.flatnonzero(settle)
        for r in np.flatnonzero((lengths > 1) & (lengths <= BLOCK)):
            rr = rows_u[starts[r] : starts[r] + lengths[r]]
            self.paths["equal_runs"] += int((rr == rr[0]).all())
        # each settled run ordered by its rows, MSW first (ranks within the run)
        order = np.lexsort(tuple(rows_u[i, w] for w in range(W)) + (run[i],))
        put(i, i[order])
        long_runs = np.flatnonzero(lengths > BLOCK)
        if not long_runs.size:
            return None
        return torch.from_numpy(starts[long_runs]), torch.from_numpy(lengths[long_runs])


def reference_count(canon, valid):
    u, c = ref_count.count_batch(canon.view(np.uint32), valid)
    return np.asarray(u), np.asarray(c)


def check(canon, valid, launch):
    W = canon.shape[2]
    ct, vt = torch.from_numpy(np.array(canon)), torch.from_numpy(np.array(valid))
    keys, src, rows = count.top_sort(ct, vt)
    assert bool((keys[1:] >= keys[:-1]).all())
    planes = count._tie_rounds(keys, src, rows, W, launch)
    plain = count.sort_ties_plain(keys, src, rows, W)
    for a, b in zip(planes, plain):
        assert torch.equal(a, b)
    ru, rn = reference_count(canon, valid)
    for uniq, cnt in (count.runs_words_plain(planes, W), count.count_batch(ct, vt),
                      count.count_batch_plain(ct, vt)):
        np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
        np.testing.assert_array_equal(cnt.numpy(), rn)
    return ru, rn


@pytest.mark.parametrize("W", range(3, 17))
def test_runs_across_the_limits(W):
    """Runs of 1, 2, 31, 32, 33, 1,024, 1,025, 65,536 rows: every path of
    K20, rounds over the next planes down to the final one."""
    launch = ModelLaunch()
    canon, valid = chip_smoke.tie_case(W)
    ru, rn = check(canon, valid, launch)
    p = launch.paths
    assert p["single"] and p["warp"] and p["block"] and p["long"] and p["final"]
    assert p["equal_runs"]  # settled runs of equal rows (the vote's path)
    # rows equal but for word 0, and words around the sign flip, were counted apart
    assert rn.sum() == valid.sum() and (ru[:, 0] == 0x80000000).any()
    assert (ru[:, 0] == 0x7FFFFFFF).any() and (ru[:, W - 1] == 0xFFFFFFFF).any()
    assert (ru[:, W - 1] == 0).any() and (ru[:, W - 1] == 0x80000000).any()


@pytest.mark.parametrize("W", [3, 4, 8, 16])
def test_one_run_of_every_row(W):
    launch = ModelLaunch()
    canon, valid = chip_smoke.tie_case(W, every=True)
    check(canon, valid, launch)
    assert launch.paths["long"] >= valid.sum() and launch.paths["final"]  # every row: long


@pytest.mark.parametrize("k", [33, 63, 127, 255])
def test_kmers_of_reads(k):
    """The tensor path's own rows: the k-mers of overlapping reads (runs of
    the copies of a k-mer and its variants past the top 64 bits)."""
    rng = np.random.default_rng(k)
    contig = rng.integers(0, 4, 400, dtype=np.uint8)
    L = k + 30
    st = rng.integers(0, contig.size - L, 60)
    codes = contig[st[:, None] + np.arange(L)]
    err = rng.random(codes.shape) < 0.01
    codes[err] = (codes[err] + 1) & 3
    lengths = rng.integers(k - 1, L + 1, 60).astype(np.int32)
    canon, _, valid = (np.asarray(a) for a in ref_kmer.kmer_scan(codes, lengths, k))
    launch = ModelLaunch()
    check(canon.view(np.int32), valid, launch)
    assert launch.paths["warp"]
    canon_t, _, _ = kmer.kmer_scan_words(torch.from_numpy(codes), torch.from_numpy(lengths), k)
    assert torch.equal(canon_t, torch.from_numpy(np.array(canon).view(np.int32)))


def test_sort_ties_guards():
    rows = torch.zeros(4, 3, dtype=torch.int32)
    keys = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        count.sort_ties(keys, keys.to(torch.int32), rows, 3)
    with pytest.raises(ValueError):
        count.sort_ties(keys, keys, rows, 4)
    empty = count.sort_ties(keys[:0], keys[:0], rows, 3)
    assert len(empty) == 2 and all(p.shape == (0,) for p in empty)
