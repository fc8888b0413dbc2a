"""Port parity: the device unitig build (K5-K7's plain versions) and the
DICT lookup (K8's plain version) against leon_tpu's device build
(dispatch_build + drain_build on jax-CPU), its solid_indices_dev, and the
host builder build_np_payload, native and pure numpy. Payloads are bytes:
the comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leon_tpu import native
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu.ops import unitig as ref_unitig
from leon_tpu_torch import state
from leon_tpu_torch.ops import unitig
from test_unitig import _pad_run, unitig_kmer_set

CUTOFF = 2


def _run(rng, k, contigs, cov=3, singletons=0, single_len=300):
    """Distinct canonical run (sorted words, counts) of `contigs` at
    coverage `cov` plus `singletons` random reads seen once (sub-cutoff
    rows), counted by the reference (as tests/test_unitig.py makes runs)."""
    rows = [c for c in contigs for _ in range(cov)]
    rows += [rng.integers(0, 4, single_len, dtype=np.uint8) for _ in range(singletons)]
    L = max(r.size for r in rows)
    codes = np.stack([np.pad(r, (0, L - r.size)) for r in rows])
    lengths = np.array([r.size for r in rows], np.int32)
    canon, _, valid = ref_kmer.kmer_scan(codes, lengths, k)
    uniq, counts = ref_count.count_batch(np.asarray(canon), np.asarray(valid))
    return np.asarray(uniq), np.asarray(counts).astype(np.int32)


def _isolated_run(rng, k, n):
    """n random solid k-mers (count 2), far apart in the graph: one chain
    each."""
    codes = rng.integers(0, 4, (n, k), dtype=np.uint8)
    canon, _ = ref_kmer.kmer_words_batch_np(codes, np.zeros(n, np.int64), k)
    keys = np.unique(state.words_to_keys(canon))
    return state.keys_to_words(keys, canon.shape[1]), np.full(keys.size, 2, np.int32)


def _port(words, counts, k, nu, cutoff=CUTOFF):
    keys, cnt = state.run_from_reference(words, counts)
    return unitig.drain_build(unitig.dispatch_build(keys, cnt, cutoff, k, nu))


def _reference(words, counts, k, nu, cutoff=CUTOFF):
    wpad, cpad = _pad_run(words, counts)
    infl = ref_unitig.dispatch_build(jnp.asarray(wpad), jnp.asarray(cpad), cutoff, k, nu)
    return ref_unitig.drain_build(infl)


def _host(words, counts, k, nu, monkeypatch, cutoff=CUTOFF):
    """(native, pure numpy) build_np_payload of the port's copy."""
    nat = unitig.build_np_payload(words, counts, cutoff, k, nu)
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        pure = unitig.build_np_payload(words, counts, cutoff, k, nu)
    return nat, pure


def _all_equal(words, counts, k, monkeypatch, nu=None):
    """Every builder's payload for one run; asserts they are one value."""
    nu = words.shape[0] if nu is None else nu
    got = {
        "port": _port(words, counts, k, nu),
        "reference": _reference(words, counts, k, nu),
    }
    got["native"], got["numpy"] = _host(words, counts, k, nu, monkeypatch)
    assert len(set(got.values())) == 1, {n: None if p is None else len(p) for n, p in got.items()}
    return got["port"]


def _sorted_rows(w):
    return w[np.lexsort([w[:, j] for j in range(w.shape[1])])]


@pytest.mark.parametrize("k", [15, 16, 31])
@pytest.mark.parametrize("sub_cutoff", [False, True])
def test_device_build_matches_reference_and_host(rng, monkeypatch, k, sub_cutoff):
    contigs = [rng.integers(0, 4, 250, dtype=np.uint8) for _ in range(2)]
    words, counts = _run(rng, k, contigs, singletons=8 if sub_cutoff else 0)
    if sub_cutoff:
        assert (counts < CUTOFF).sum() > 100  # the run really holds sub-cutoff rows
    else:
        words, counts = words[counts >= CUTOFF], counts[counts >= CUTOFF]
    payload = _all_equal(words, counts, k, monkeypatch)
    solid = words[counts >= CUTOFF]
    spelled = unitig_kmer_set(payload, k)
    assert spelled.shape[0] == solid.shape[0]
    np.testing.assert_array_equal(_sorted_rows(spelled), _sorted_rows(solid))


@pytest.mark.parametrize("extra", [0, 1])
def test_cycles_take_the_full_variant(rng, monkeypatch, extra):
    """Circular contigs of 200 and 201 k-mers: the optimistic build flags
    the cycle and drain_build re-runs the full variant, which cuts each
    cycle at its min-id node."""
    k = 15
    contig = rng.integers(0, 4, 200 + extra, dtype=np.uint8)
    circ = np.concatenate([contig, contig[: k - 1]])
    lin = rng.integers(0, 4, 300, dtype=np.uint8)
    words, counts = _run(rng, k, [circ, lin])
    keys, cnt = state.run_from_reference(words, counts)
    infl = unitig.dispatch_build(keys, cnt, CUTOFF, k, words.shape[0])
    assert int(infl.buf[2]) == 1  # the optimistic pass saw the cycle
    payload = _all_equal(words, counts, k, monkeypatch)
    assert unitig_kmer_set(payload, k).shape[0] == int((counts >= CUTOFF).sum())


def _self_twin_seqs(rng):
    """A reverse-complement palindrome, A10 T10 A10 and poly-A (the
    reference's self-twin regression, tests/test_unitig.py:460)."""
    pal = rng.integers(0, 4, 40, dtype=np.uint8)
    return [np.concatenate([pal, (3 - pal)[::-1]]),
            np.array([0] * 10 + [3] * 10 + [0] * 10, np.uint8), np.zeros(40, np.uint8)]


def test_self_twin_chain(rng, monkeypatch):
    """A unitig adjacent to its own reverse complement (an edge d -> twin
    of d, odd k) is spelled twice; the DICT enumeration (solid_kmers_sorted)
    dedups it back to the solid run."""
    k = 15
    words, counts = _run(rng, k, _self_twin_seqs(rng))
    payload = _all_equal(words, counts, k, monkeypatch)
    solid = words[counts >= CUTOFF]
    assert unitig.spell_canon(payload, k).shape[0] > solid.shape[0]  # spelled twice
    np.testing.assert_array_equal(unitig.solid_kmers_sorted(payload, k), _sorted_rows(solid))


@pytest.mark.parametrize("seq", [0, 1])
def test_even_k_palindrome_matches_reference_device(rng, seq):
    """At even k a self-twin chain runs through a palindromic k-mer, whose
    two directed nodes share one successor. The reference's builders
    disagree there (ROADMAP.md queue 3): its native host builder loops
    forever on A10 T10 A10 at k = 16 and its numpy one raises, so they are
    not called. Here the port's device build equals the reference's
    device build byte for byte, and, like it, spells fewer k-mers than the
    solid run holds (with flanks the two differ where bases collide:
    test_torch_pipeline.py::test_even_k_palindrome_archive_is_rejected)."""
    k = 16
    words, counts = _run(rng, k, [_self_twin_seqs(rng)[seq]])
    nu = words.shape[0]
    got = _port(words, counts, k, nu)
    assert got == _reference(words, counts, k, nu)
    assert unitig.spell_canon(got, k).shape[0] < int((counts >= CUTOFF).sum())


@pytest.mark.parametrize("n, fits", [(20_000, True), (40_000, False)])
def test_chain_overflow_retry_and_bloom(monkeypatch, n, fits):
    """Isolated solid k-mers, one chain each: 20k overflow the frozen
    4096-chain capacity and fit after the x8 retry; 40k overflow twice and
    give None (the BLOOM section) on every builder."""
    k = 31
    words, counts = _isolated_run(np.random.default_rng(n), k, n)
    assert unitig.chains_cap(words.shape[0]) == 4096
    payload = _all_equal(words, counts, k, monkeypatch)
    if fits:
        lens, _ = unitig.parse_payload(payload, k)
        assert 4096 < lens.size <= 4096 * unitig.RETRY_FACTOR
    else:
        assert payload is None


def test_empty_and_single_kmer(monkeypatch):
    k = 15
    empty = np.zeros((0, 1), np.uint32), np.zeros(0, np.int32)
    # the reference's pipeline never builds an empty run (n_solid > 0 gate)
    # and its device build raises on one; the port gives the host's None
    assert _port(*empty, k, 0) is None
    assert _host(*empty, k, 0, monkeypatch) == (None, None)
    codes = np.array([0, 0, 2, 1, 3, 0, 1, 1, 2, 0, 3, 3, 1, 0, 2], np.uint8)
    canon, _ = ref_kmer.kmer_words_batch_np(codes[None], np.zeros(1, np.int64), k)
    payload = _all_equal(canon, np.array([3], np.int32), k, monkeypatch)
    lens, _ = unitig.parse_payload(payload, k)
    assert lens.tolist() == [k]


def test_solid_lookup_matches_solid_indices_dev(rng):
    k = 31
    contigs = [rng.integers(0, 4, 300, dtype=np.uint8) for _ in range(3)]
    words, counts = _run(rng, k, contigs, singletons=6)
    nu = words.shape[0]
    wpad, cpad = _pad_run(words, counts)
    ref_infl = ref_unitig.dispatch_build(jnp.asarray(wpad), jnp.asarray(cpad), CUTOFF, k, nu)
    absent, _ = ref_kmer.kmer_words_batch_np(rng.integers(0, 4, (50, k), dtype=np.uint8),
                                             np.zeros(50, np.int64), k)
    q = np.concatenate([words[rng.integers(0, nu, 400)], absent, words[:3], words[-3:]])
    want = ref_unitig.solid_indices_dev(ref_infl, q)
    keys, cnt = state.run_from_reference(wpad, cpad)
    hit, rank, ns = unitig.solid_indices(unitig.dispatch_build(keys, cnt, CUTOFF, k, nu), q)
    np.testing.assert_array_equal(hit, want[0])
    np.testing.assert_array_equal(rank, want[1])
    assert ns == want[2]
    assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("cyclic", [False, True])
def test_early_exit_equals_all_rounds(rng, cyclic):
    """chain_rank stops at the first round that moves no pointer; running
    all D rounds gives the same heads and carries (unitig.py:513-527)."""
    k = 15
    contig = rng.integers(0, 4, 256, dtype=np.uint8)
    circ = np.concatenate([contig, contig[: k - 1]]) if cyclic else contig
    words, counts = _run(rng, k, [circ, rng.integers(0, 4, 500, dtype=np.uint8)])
    keys, _ = state.run_from_reference(words[counts >= CUTOFF], counts[counts >= CUTOFF])
    nxt, prev = unitig.unitig_links_plain(keys, k)
    D = (2 * keys.shape[0] - 1).bit_length() + 1
    modes = [unitig.FULL] if cyclic else [unitig.ACYCLIC, unitig.FULL]
    for mode in modes:
        S = unitig.double_init_plain(nxt, prev, mode)
        for _ in range(D):
            S, _c = unitig.unitig_double_plain(S, mode)
        if mode == unitig.ACYCLIC:
            _n, _p, early = unitig.chain_rank_plain(nxt, prev, True)
        else:
            S1 = unitig.double_init_plain(nxt, prev, mode)
            for _ in range(D):
                S1, changed = unitig.unitig_double_plain(S1, mode)
                if not int(changed):
                    break
            early = S1
        assert torch.equal(S, early)
    assert bool((unitig.chain_rank_plain(nxt, prev, True)[2][:, 2] == 0).any()) == cyclic


def test_run_from_reference_drops_pads(rng):
    words, counts = _run(rng, 21, [rng.integers(0, 4, 200, dtype=np.uint8)])
    wpad, cpad = _pad_run(words, counts)
    assert wpad.shape[0] > words.shape[0]
    assert state.words_to_keys(wpad[-1:])[0] == -1  # a pad would sort first
    keys, cnt = state.run_from_reference(wpad, cpad)
    np.testing.assert_array_equal(keys.numpy(), state.words_to_keys(words))
    np.testing.assert_array_equal(cnt.numpy(), counts)
    assert bool((keys[1:] > keys[:-1]).all())
    bad = cpad.copy()
    bad[-1] = 1
    with pytest.raises(ValueError, match="pad rows"):
        state.run_from_reference(wpad, bad)
