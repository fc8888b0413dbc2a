"""Kernel K14's row policy (csrc/count.cu WordRows<NP, true, true>,
`count.word_runs_rows`): the WordCounter's final run reduced as (M, W) int32
rows read as they stand, so that finalize builds no planes on the card.
Held on the CPU at tolerance 0 (everything is integer) against leon_tpu's
_merge_sorted_runs, _hist_of_sorted and compact_solid at W = 2, 3, 4, 8 and
16, on sorted rows with runs of equal rows, rows equal but for word 0,
words around the int64 sign flip, and counts whose sums pass 2**31 - 1
(clamped) and 2**32 (the u32 sum wraps). A numpy model of the policy's
row units (words 2q + 1 and 2q of a row, unflipped; a head where any unit
differs from the row before; the emitted row copied out as it stands)
gives the plain version's rows and heads; the wrapper on the CPU is the
plain version (state.words_to_planes, then word_runs_plain)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import count as ref_count
from leon_tpu_torch import state
from leon_tpu_torch.ops import count

WIDTHS = (2, 3, 4, 8, 16)
CUTOFFS = (1, 2, 255, 256)


def sorted_run(W: int, n: int = 20_000):
    """(words (n, W) u32 sorted MSW first, counts (n,) int32): rows drawn
    from a pool of 3,000 (words from chip_smoke.TIE_EDGES or random; every
    other pool row equal to the one before but for word 0), so that runs of
    equal rows form; tie_counts' counts (sums past 2**31 - 1 and 2**32)."""
    rng = np.random.default_rng(300 + W)
    pool = rng.integers(0, 1 << 32, (3000, W), dtype=np.uint64)
    edges = np.array(chip_smoke.TIE_EDGES, np.uint64)
    pick = rng.random(pool.shape) < 0.4
    pool[pick] = edges[rng.integers(0, edges.size, int(pick.sum()))]
    pool[1::2, 1:] = pool[0::2, 1:]
    words = pool[rng.integers(0, pool.shape[0], n)].astype(np.uint32)
    words = words[np.lexsort(tuple(words[:, j] for j in range(W)))]
    return words, chip_smoke.tie_counts(n, W)


def reference(words: np.ndarray, counts: np.ndarray):
    """leon_tpu's merge of the sorted run: (distinct rows, summed counts,
    histogram)."""
    W = words.shape[1]
    words_t = tuple(jnp.asarray(words[:, W - 1 - j]) for j in range(W))
    skeys, boundary, summed = ref_count._merge_sorted_runs(words_t, jnp.asarray(counts))
    hist = np.asarray(ref_count._hist_of_sorted(boundary, summed))
    b = np.asarray(boundary)
    uniq = np.stack([np.asarray(skeys[W - 1 - j])[b] for j in range(W)], axis=1)
    return uniq, np.asarray(summed)[b], hist


def units_model(words: np.ndarray):
    """The row policy's view of the rows: unit q = words 2q + 1 and 2q of a
    row (word W counts 0), unflipped; heads where any unit differs from the
    row before. Returns (units (n, P) u64, heads (n,) bool)."""
    n, W = words.shape
    w = np.concatenate([words, np.zeros((n, W % 2), np.uint32)], axis=1).astype(np.uint64)
    units = (w[:, 1::2] << np.uint64(32)) | w[:, 0::2]
    heads = np.ones(n, bool)
    heads[1:] = (units[1:] != units[:-1]).any(axis=1)
    return units, heads


@pytest.mark.parametrize("W", WIDTHS)
def test_rows_match_reference(W):
    """word_runs_rows with the histogram against _merge_sorted_runs and
    _hist_of_sorted, and in solid mode against compact_solid at each
    cutoff; the units model's heads and rows are the plain version's."""
    words, counts = sorted_run(W)
    wt, ct = torch.from_numpy(words.view(np.int32)), torch.from_numpy(counts)
    uniq, vals, hist = count.word_runs_rows(wt, ct, 1, True)
    ru, rc, rh = reference(words, counts)
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(vals.numpy(), rc)
    np.testing.assert_array_equal(hist.numpy(), rh)
    assert (rc == 0x7FFFFFFF).any() and ru.shape[0] < words.shape[0]
    units, heads = units_model(words)
    planes = state.words_to_planes(wt)
    plane_heads = np.ones(words.shape[0], bool)
    stacked = torch.stack(planes, dim=1).numpy()
    plane_heads[1:] = (stacked[1:] != stacked[:-1]).any(axis=1)
    np.testing.assert_array_equal(heads, plane_heads)
    np.testing.assert_array_equal(words[heads], ru)  # a run's row copied out as it stands
    # solid mode: compact_solid over the reference's distinct run
    for cutoff in CUTOFFS:
        sw, sc = count.compact_solid_words(torch.from_numpy(ru.view(np.int32)),
                                           torch.from_numpy(rc), cutoff)
        m = int((rc >= cutoff).sum())
        ow, oc = ref_count.compact_solid(jnp.asarray(ru), jnp.asarray(rc), cutoff, ru.shape[0])
        np.testing.assert_array_equal(sw.numpy().view(np.uint32), np.asarray(ow)[:m])
        np.testing.assert_array_equal(sc.numpy(), np.asarray(oc)[:m])
    # the plain route of a counter's sorted final run: the same as its planes' K14
    for a, b in zip(count.word_runs_rows(wt, ct, 2, True),
                    count.word_runs_plain(planes, W, ct, 2, True)):
        assert torch.equal(a, b)


def test_word0_only_and_empty():
    """Rows equal but for word 0 at every width are separate runs; an empty
    run gives empty outputs; bad arguments raise."""
    for W in WIDTHS:
        words = np.zeros((4, W), np.uint32)
        words[:, 1:] = 0xFFFFFFFF
        words[:, 0] = (0, 0, 0x7FFFFFFF, 0x80000000)
        counts = np.array([1, 2, 3, 0x7FFFFFFF], np.int32)
        uniq, vals, _ = count.word_runs_rows(torch.from_numpy(words.view(np.int32)),
                                             torch.from_numpy(counts))
        np.testing.assert_array_equal(uniq.numpy().view(np.uint32)[:, 0],
                                      [0, 0x7FFFFFFF, 0x80000000])
        np.testing.assert_array_equal(vals.numpy(), [3, 3, 0x7FFFFFFF])
        e = count.word_runs_rows(torch.zeros(0, W, dtype=torch.int32),
                                 torch.zeros(0, dtype=torch.int32), 1, True)
        assert e[0].shape == (0, W) and e[1].shape == (0,) and int(e[2].sum()) == 0
    i32, i64 = torch.int32, torch.int64
    with pytest.raises(ValueError):
        count.word_runs_rows(torch.zeros(3, 17, dtype=i32), torch.zeros(3, dtype=i32))
    with pytest.raises(ValueError):
        count.word_runs_rows(torch.zeros(3, 4, dtype=i32), torch.zeros(3, dtype=i64))
