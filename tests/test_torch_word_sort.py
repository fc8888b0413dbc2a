"""The WordCounter's sorts at W >= 3 as the card runs them, and K9's index
split, held against leon_tpu on the CPU at tolerance 0 (everything is
integer).

A slab (K17's P sign-flipped int64 planes) goes through kernel K21
(`plane_rows`: rows and top keys), one torch.sort of the top keys with the
row index, and K20 (`sort_ties`); a merge's (M, W) rows go through one
torch.sort of their top keys and K20 with each row's count as its payload;
K14 reduces both. (The WordCounter merges sorted runs on K23 since then, and
`sort_rows` is left without a counter caller.) Here numpy models of K21 (a
thread a row) and of one K20 round with the payload
(tests/test_torch_sort_ties_model.py's ModelLaunch) run in the port's own
`_tie_rounds`, and what they give is held against the
plain versions (plane_rows_plain, sort_ties_plain with the payload), and,
after K14's count mode, against leon_tpu's `_merge_sorted_runs` and
`_hist_of_sorted`, on chip_smoke.py's tie_case with tie_counts as the
payload (runs past 1,024 equal top words whose rows differ, equal rows,
sums past 2**31 - 1 and past 2**32) at W = 3, 4, 5, 8 and 16. Then the
WordCounter itself on the models of K21, K20 and K23
(tests/test_torch_merge_path.py's merge_model), with spills forced (slabs of 512 k-mers,
merge factor 1 or 2) at k = 33, 63, 127 and 255: its merge and spill log
and its finalize against leon_tpu's DeviceCounter, as
tests/test_torch_stream.py holds the plain route.

K9 (csrc/graph.cu `gather_words_kernel`, a thread an index over M / 256
blocks): a model of its threads covers every index once and gives
gather_words_plain's and the Pallas probe script's xla_gather's values, at
every M mod 4 and every 16-byte phase of the index view, with negative and
out-of-range indices (chip_smoke.py's k9_case, which phase 7 runs on the
card)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import count as ref_count
from leon_tpu_torch import state
from leon_tpu_torch.ops import count, gather
from test_torch_merge_path import merge_model
from test_torch_sort_ties_model import ModelLaunch
from test_torch_stream import SEED, _feed, _fed_counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_M32 = 0xFFFFFFFF


def plane_rows_model(planes, W: int, threads: int = 256):
    """K21 in numpy: a block of `threads` takes that many rows at a time; a
    thread a row unflips its planes into its W words, stored in shared
    memory a row every S words (W + 1 at even W), and writes its top key
    (words W-1 and W-2: the high half of plane P-2 at odd W); then the
    block's rows go out as 16-byte chunks of the block's stretch of rows,
    word j of the stretch read at (j // W) * S + j % W, and the words past
    the last whole chunk one at a time."""
    u = [(p.numpy().view(np.uint64) ^ np.uint64(1 << 63)) for p in planes]
    n, P = u[0].shape[0], len(planes)
    S = W + 1 if W % 2 == 0 else W
    flat = np.zeros(n * W, np.uint32)
    top = u[P - 1] if W % 2 == 0 else (u[P - 1] << np.uint64(32)) | (u[P - 2] >> np.uint64(32))
    for base in range(0, n, threads):
        m = min(threads, n - base)
        smem = np.zeros(threads * S, np.uint32)
        t = np.arange(m)
        for w in range(W):
            smem[t * S + w] = (u[w // 2][base + t] >> np.uint64(32 * (w % 2))).astype(np.uint32)
        j = np.arange(m * W)  # the 16-byte chunks' words, then the tail's
        flat[base * W + j] = smem[(j // W) * S + j % W]
    rows = flat.reshape(n, W)
    top = (top ^ np.uint64(1 << 63)).view(np.int64)
    return torch.from_numpy(rows.view(np.int32)), torch.from_numpy(top)


class Models:
    """count.plane_rows, count.sort_ties and count.merge_path_rows replaced
    by the models (the WordCounter calls them through the module), counting
    their calls."""

    def __init__(self, monkeypatch):
        self.launch = ModelLaunch()
        self.calls = dict(plane_rows=0, sort_ties=0, payload=0, merge=0)
        monkeypatch.setattr(count, "plane_rows", self.plane_rows)
        monkeypatch.setattr(count, "sort_ties", self.sort_ties)
        monkeypatch.setattr(count, "merge_path_rows", self.merge_path_rows)

    def plane_rows(self, planes, W):
        self.calls["plane_rows"] += 1
        got = plane_rows_model(planes, W)
        for a, b in zip(got, count.plane_rows_plain(planes, W)):
            assert torch.equal(a, b)
        return got

    def sort_ties(self, keys, src, rows, W, pay=None):
        self.calls["sort_ties"] += 1
        self.calls["payload"] += pay is not None
        return count._tie_rounds(keys, src, rows, W, self.launch, pay)

    def merge_path_rows(self, runs):
        self.calls["merge"] += len(runs) > 1
        rows, counts = merge_model([(r.numpy(), c.numpy()) for r, c in runs], False)
        return torch.from_numpy(rows.view(np.int32)), torch.from_numpy(counts)


def _reference_merge(words: np.ndarray, counts: np.ndarray):
    """leon_tpu's merge of (M, W) u32 rows with their counts: the distinct
    rows (LSW first), their summed counts and the histogram."""
    W = words.shape[1]
    words_t = tuple(jnp.asarray(words[:, W - 1 - j]) for j in range(W))
    skeys, boundary, summed = ref_count._merge_sorted_runs(words_t, jnp.asarray(counts))
    hist = np.asarray(ref_count._hist_of_sorted(boundary, summed))
    b = np.asarray(boundary)
    uniq = np.stack([np.asarray(skeys[W - 1 - j])[b] for j in range(W)], axis=1)
    return uniq, np.asarray(summed)[b], hist


@pytest.mark.parametrize("W", [3, 4, 5, 8, 16])
def test_merge_with_counts_matches_reference(W):
    """A merge as the card runs it: the rows' top keys sorted, the K20 model
    with tie_counts as its payload through _tie_rounds (every path: single
    rows, warp and block runs, long runs over the next planes, the final
    round), against sort_ties_plain with the payload; then K14's count mode
    against leon_tpu's _merge_sorted_runs and _hist_of_sorted."""
    canon, valid = chip_smoke.tie_case(W)
    words = torch.from_numpy(canon.reshape(-1, W)[valid.reshape(-1)])
    counts = torch.from_numpy(chip_smoke.tie_counts(words.shape[0], W))
    keys, src = torch.sort(count._top_keys(words))
    launch = ModelLaunch()
    planes, pay = count._tie_rounds(keys, src, words, W, launch, counts)
    plain, plain_pay = count.sort_ties_plain(keys, src, words, W, counts)
    for a, b in zip(planes + (pay,), plain + (plain_pay,)):
        assert torch.equal(a, b)
    p = launch.paths
    assert p["single"] and p["warp"] and p["block"] and p["long"] and p["final"]
    # the CPU route of the WordCounter's merge is the plain version
    got_planes, got_pay = count.sort_rows(words, counts)
    for a, b in zip(got_planes + (got_pay,), plain + (plain_pay,)):
        assert torch.equal(a, b)
    uniq, vals, hist = count.word_runs_plain(planes, W, pay, 1, True)
    ru, rc, rh = _reference_merge(words.numpy().view(np.uint32), counts.numpy())
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(vals.numpy(), rc)
    np.testing.assert_array_equal(hist.numpy(), rh)
    # runs of equal rows summed past 2**31 - 1 (clamped) and past 2**32 (wrapped)
    _, inv = np.unique(words.numpy(), axis=0, return_inverse=True)
    sums = np.zeros(int(inv.max()) + 1, np.int64)
    np.add.at(sums, inv.reshape(-1), counts.numpy().astype(np.int64))
    assert (sums > 0x7FFFFFFF).any() and (sums > _M32).any() and sums.size < words.shape[0]
    assert (rc == 0x7FFFFFFF).any()


@pytest.mark.parametrize("W", [3, 4, 5, 8, 16])
def test_slab_sort_matches_reference(W):
    """A slab as the card runs it: the K21 model (held against
    plane_rows_plain), its top keys sorted, the K20 model, then K14's
    length mode, against leon_tpu's count of the same rows; the CPU route
    (sort_slab) gives the same planes."""
    canon, valid = chip_smoke.tie_case(W, every=W == 5)
    words = torch.from_numpy(canon.reshape(-1, W)[valid.reshape(-1)])
    slab = state.words_to_planes(words)
    rows, top = plane_rows_model(slab, W)
    for a, b in zip((rows, top), count.plane_rows_plain(slab, W)):
        assert torch.equal(a, b)
    keys, src = torch.sort(top)
    planes = count._tie_rounds(keys, src, rows, W, ModelLaunch())
    for a, b in zip(planes, count.sort_slab(slab, W)):
        assert torch.equal(a, b)
    uniq, lengths = count.runs_words_plain(planes, W)
    ru, rn = ref_count.count_batch(canon.view(np.uint32), valid)
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), np.asarray(ru))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(rn))


# (merge_factor, spill_rows): every merge spills; merged runs stay on the
# device (merges with counts on the device, no spill; at k = 127 and 255 the
# reference's unspilled finalize compiles its Bloom build for a minute)
SCHEDULES = {"spill_each": (1, 256), "no_spill": (2, 1 << 30)}
CASES = [(k, "spill_each") for k in (33, 63, 127, 255)] + [(k, "no_spill") for k in (33, 63)]


@pytest.mark.parametrize("k,schedule", CASES)
def test_word_counter_on_models_matches_reference(monkeypatch, k, schedule):
    """The WordCounter with K21, K20 and K23 as the card runs them (the
    models), slabs of 512 k-mers: its merges and spills, and the sizes
    compared at each, are the reference DeviceCounter's, and so are its
    finalize's histogram, cutoff, solid count and Bloom filter; no
    sort_planes runs, and the merges take K23, not K20 with the counts."""
    models = Models(monkeypatch)
    planes_sorted = []
    real = count.sort_planes
    monkeypatch.setattr(count, "sort_planes", lambda *a, **kw: planes_sorted.append(1)
                        or real(*a, **kw))
    mf, spill_rows = SCHEDULES[schedule]
    log = ([], [])
    ref, port, _ = _fed_counters(k, 6, mf, spill_rows, log)
    rng = np.random.default_rng(k + 2)
    L = k + 59
    lens = np.full(8, L, np.int32)
    for _ in range(4):
        _feed(ref, port, rng.integers(0, 4, (8, L), dtype=np.uint8), lens, L)
    rb, rnw, rcut, rns, rhist, rH, _ = ref.finalize(None, None, None, SEED, False,
                                                    want_solid=True)
    pb, pnw, pcut, pns, phist, pH, run = port.finalize(None, None, None, SEED, False)
    assert log[1] == log[0]
    assert any(e[0] == "merge" for e in log[0])
    assert any(e[0] == "spill" for e in log[0]) == (schedule != "no_spill")
    np.testing.assert_array_equal(phist, rhist)
    assert (pcut, pns, pnw, pH) == (rcut, rns, rnw, rH)
    np.testing.assert_array_equal(state.bitset_from_torch(pb), np.asarray(rb)[:rnw])
    assert models.calls["plane_rows"] and models.calls["sort_ties"] and models.calls["merge"]
    assert not models.calls["payload"]
    assert not planes_sorted


def _probe_script():
    path = os.path.join(ROOT, "scripts", "probe_pallas_gather.py")
    spec = importlib.util.spec_from_file_location("probe_pallas_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k9_model(table: torch.Tensor, idx: torch.Tensor):
    """K9 in numpy: lt_gather_words' grid of ceil(M / 256) blocks of 256
    threads, thread i (i < M) loading idx[i], normalising it by JAX's rule
    and loading the table. Returns (out, the times each index was
    written)."""
    n, M = table.numel(), idx.numel()
    tab = table.numpy().view(np.uint32)
    ix = idx.numpy().astype(np.int64)
    out = np.zeros(M, np.uint32)
    hits = np.zeros(M, np.int64)
    threads = 256 * (-(-M // 256))
    for i in range(threads):
        if i >= M:
            continue
        j = ix[i] + n if ix[i] < 0 else ix[i]
        out[i] = tab[min(max(j, 0), n - 1)]
        hits[i] += 1
    return out, hits


@pytest.mark.parametrize("n", chip_smoke.K9_SMALL_N + (1 << 12,))
def test_k9_covers_every_index(n):
    """Every M mod 4 and every 16-byte phase of the index view: the model
    writes each index once and gives gather_words_plain's values (the
    wrapper on the CPU) and the probe script's xla_gather's (JAX's index
    rule: negative indices and out-of-range ones)."""
    xla_gather = _probe_script().xla_gather
    for M in chip_smoke.K9_MS[:-1]:  # 65,539 indices: the card's case
        table_np, base_np = chip_smoke.k9_case(n, M, n + M)
        table, base = torch.from_numpy(table_np), torch.from_numpy(base_np)
        phases = set()
        for off in chip_smoke.K9_OFFS:
            idx = base[off : off + M]
            want = gather.gather_words_plain(table, idx).numpy().view(np.uint32)
            out, hits = k9_model(table, idx)
            np.testing.assert_array_equal(hits, np.ones(M, np.int64))
            np.testing.assert_array_equal(out, want)
            np.testing.assert_array_equal(
                gather.gather_words(table, idx).numpy().view(np.uint32), want)
            np.testing.assert_array_equal(
                np.asarray(xla_gather(jnp.asarray(table_np.view(np.uint32)),
                                      jnp.asarray(idx.numpy()))), want)
            phases.add(idx.data_ptr() % 16)
        assert len(phases) == 4 or M == 0
