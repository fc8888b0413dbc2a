"""Port parity at 32 <= k <= 255 (W = 2..16 u32 words): the device unitig
build (K5-K7's plain versions over (M, W) int32 rows) against leon_tpu's
device build (dispatch_build + drain_build on jax-CPU), its _build_dev
buffer and its numpy builder's arrays (_np_chains), and the host builder
build_np_payload, native and pure numpy; the DICT lookup (K8's plain
version) against solid_indices_dev; whole archives with
unitig_device_max_kmers = 2**30 against leon_tpu's, both ways; and the
default compress where an abundance cutoff above 255 makes the histogram
overcount the solid rows. Everything is integer: the tolerance is 0."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leon_tpu import pipeline as ref_pipeline
from leon_tpu.config import LeonConfig
from leon_tpu.ops import unitig as ref_unitig
from leon_tpu_torch import native, pipeline, state
from leon_tpu_torch.ops import count, kmer, unitig
from test_roundtrip import sim_seq, write_fasta
from test_torch_longk import ARCHIVES as LONG_ARCHIVES
from test_torch_widek import ARCHIVES as WIDE_ARCHIVES
from test_torch_widek import PORT_KW, REF_KW
from test_unitig import _pad_run, unitig_kmer_set

CUTOFF = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _canon(seqs, k):
    """Every canonical k-mer of each sequence, (n, W) u32 rows."""
    out = []
    for s in seqs:
        win = s[np.arange(s.size - k + 1)[:, None] + np.arange(k)]
        f = kmer.pack_codes_batch_np(win, k)
        r = kmer.pack_codes_batch_np((3 - win)[:, ::-1], k)
        out.append(np.where(unitig._np_lex_less(r, f)[:, None], r, f))
    return np.concatenate(out)


def _count(rows):
    """Sorted distinct rows (ascending big integers) and their counts."""
    s = unitig.sort_rows_bigint(rows)
    new = np.concatenate(([True], (s[1:] != s[:-1]).any(axis=1)))
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, s.shape[0])).astype(np.int32)
    return np.ascontiguousarray(s[new]), counts


def _run(rng, k, contigs, cov=3, singletons=0, single_len=None):
    """Distinct canonical run (sorted words, counts) of `contigs` at
    coverage `cov` plus `singletons` random reads seen once (sub-cutoff
    rows), as make_solid (tests/test_unitig.py:16) counts its contigs."""
    seqs = [c for c in contigs for _ in range(cov)]
    seqs += [rng.integers(0, 4, single_len or 2 * k, dtype=np.uint8)
             for _ in range(singletons)]
    return _count(_canon(seqs, k))


def _solid(words, counts, k, cutoff=CUTOFF):
    """The port's solid run of a reference run: K14's solid mode."""
    rows, cnt = state.run_from_reference(words, counts, k)
    return count.compact_solid_words(rows, cnt, cutoff)[0]


def _port(words, counts, k, nu, cutoff=CUTOFF):
    return unitig.drain_build(unitig.dispatch_build(_solid(words, counts, k, cutoff), k, nu))


def _reference(words, counts, k, nu, cutoff=CUTOFF):
    wpad, cpad = _pad_run(words, counts)
    infl = ref_unitig.dispatch_build(jnp.asarray(wpad), jnp.asarray(cpad), cutoff, k, nu)
    return ref_unitig.drain_build(infl)


def _all_equal(words, counts, k, monkeypatch, nu=None):
    """Every builder's payload for one run; asserts they are one value."""
    nu = words.shape[0] if nu is None else nu
    got = {
        "port": _port(words, counts, k, nu),
        "reference": _reference(words, counts, k, nu),
        "native": unitig.build_np_payload(words, counts, CUTOFF, k, nu),
    }
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        got["numpy"] = unitig.build_np_payload(words, counts, CUTOFF, k, nu)
    assert len(set(got.values())) == 1, {n: None if p is None else len(p) for n, p in got.items()}
    return got["port"]


def _sorted_rows(w):
    return w[np.lexsort([w[:, j] for j in range(w.shape[1])])]


@pytest.mark.parametrize("k", [33, 63, 65, 127, 255])
@pytest.mark.parametrize("sub_cutoff", [False, True])
def test_device_build_matches_reference_and_host(monkeypatch, k, sub_cutoff):
    rng = np.random.default_rng(k)
    contigs = [rng.integers(0, 4, 250 + k, dtype=np.uint8) for _ in range(2)]
    words, counts = _run(rng, k, contigs, singletons=4 if sub_cutoff else 0)
    if sub_cutoff:
        assert (counts < CUTOFF).sum() > 100  # the run really holds sub-cutoff rows
    else:
        assert (counts >= CUTOFF).all()
    payload = _all_equal(words, counts, k, monkeypatch)
    solid = words[counts >= CUTOFF]
    spelled = unitig_kmer_set(payload, k)
    assert spelled.shape[0] == solid.shape[0]
    np.testing.assert_array_equal(_sorted_rows(spelled), _sorted_rows(solid))


@pytest.mark.parametrize("k", [63, 255])
def test_links_ranks_and_emit_match_reference(k):
    """K5's, K6's and K7's plain versions, step by step: the internal edges
    and the heads and ranks of both chain_rank variants equal the numpy
    builder's (_np_chains), and the K7 buffer of each variant equals the
    reference's _build_dev buffer (the same capacities)."""
    rng = np.random.default_rng(k + 1)
    contigs = [rng.integers(0, 4, 200 + k, dtype=np.uint8) for _ in range(3)]
    words, counts = _run(rng, k, contigs)
    nu = words.shape[0]
    _F, nxt_np, head_np, rank_np, _kept, _kh = ref_unitig._np_chains(words, counts, CUTOFF, k)
    rows, _ = state.run_from_reference(words, counts, k)
    nxt, prev = unitig.unitig_links_plain(rows, k)
    np.testing.assert_array_equal(nxt.numpy(), nxt_np)  # acyclic input: no cut
    want_prev = np.full(2 * nu, -1)
    want_prev[nxt_np[nxt_np >= 0]] = np.flatnonzero(nxt_np >= 0)
    np.testing.assert_array_equal(prev.numpy(), want_prev)
    wpad, cpad = _pad_run(words, counts)
    cap = unitig.chains_cap(nu)
    cb = ref_unitig._caps(wpad.shape[0], nu, k, cap)
    for acyclic in (True, False):
        n2, p2, S = unitig.chain_rank_plain(nxt, prev, acyclic)
        np.testing.assert_array_equal(S[:, 0].numpy(), head_np)
        np.testing.assert_array_equal(S[:, 1].numpy(), rank_np)
        got = unitig.unitig_emit_plain(rows, k, n2, p2, S, cap, cb, acyclic)
        want = ref_unitig._build_dev(jnp.asarray(wpad), jnp.asarray(cpad), np.int32(CUTOFF),
                                     k=k, cap_chains=cap, cap_bases=cb,
                                     assume_acyclic=acyclic)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("k, extra", [(63, 0), (127, 1)])
def test_cycle_links_and_cut_match_numpy(k, extra):
    """On a circular contig the full variant's cut leaves the numpy
    builder's final links, heads and ranks."""
    rng = np.random.default_rng(k)
    contig = rng.integers(0, 4, 200 + extra, dtype=np.uint8)
    circ = np.concatenate([contig, contig[: k - 1]])
    words, counts = _run(rng, k, [circ, rng.integers(0, 4, 300, dtype=np.uint8)])
    _F, nxt_np, head_np, rank_np, _kept, _kh = ref_unitig._np_chains(words, counts, CUTOFF, k)
    rows, _ = state.run_from_reference(words, counts, k)
    nxt, prev = unitig.unitig_links_plain(rows, k)
    assert bool((unitig.chain_rank_plain(nxt, prev, True)[2][:, 2] == 0).any())  # flagged
    n2, _p2, S = unitig.chain_rank_plain(nxt, prev, False)
    np.testing.assert_array_equal(n2.numpy(), nxt_np)
    np.testing.assert_array_equal(S[:, 0].numpy(), head_np)
    np.testing.assert_array_equal(S[:, 1].numpy(), rank_np)


def test_even_k_palindrome_matches_reference_device():
    """At k = 32 (W = 2), A18 T18 holds the palindromic k-mer A16 T16, whose
    two directed nodes share one successor; with 14-base flanks on both
    sides a kept chain has no tail and its bases land on positions of
    other chains. The port's device build writes there the reference's
    last writer, so its payload equals leon_tpu's device build byte for
    byte (the host builders are not called: ROADMAP.md queue 3)."""
    k = 32
    rng = np.random.default_rng(k)
    flanks = rng.integers(0, 4, (2, 14), dtype=np.uint8)
    seq = np.concatenate([flanks[0], np.zeros(18, np.uint8), np.full(18, 3, np.uint8),
                          flanks[1]])
    words, counts = _run(rng, k, [seq])
    nu = words.shape[0]
    got = _port(words, counts, k, nu)
    assert got is not None and got == _reference(words, counts, k, nu)


def _isolated_run(rng, k, n):
    """n random solid k-mers (count 2), far apart in the graph: one chain
    each."""
    codes = rng.integers(0, 4, (n, k), dtype=np.uint8)
    canon, _ = kmer.kmer_words_batch_np(codes, np.zeros(n, np.int64), k)
    words, _ = _count(canon)
    return words, np.full(words.shape[0], 2, np.int32)


@pytest.mark.parametrize("n, fits", [(20_000, True), (40_000, False)])
def test_chain_overflow_retry_and_bloom(monkeypatch, n, fits):
    """At k = 63 (W = 4), isolated solid k-mers, one chain each: 20k
    overflow the frozen 4096-chain capacity and fit after the x8 retry,
    which rebuilds from the same rows; 40k overflow twice and give None
    (the BLOOM section) on every builder."""
    k = 63
    words, counts = _isolated_run(np.random.default_rng(n), k, n)
    assert unitig.chains_cap(words.shape[0]) == 4096
    payload = _all_equal(words, counts, k, monkeypatch)
    if fits:
        lens, _ = unitig.parse_payload(payload, k)
        assert 4096 < lens.size <= 4096 * unitig.RETRY_FACTOR
    else:
        assert payload is None


@pytest.mark.parametrize("k", [63, 255])
def test_solid_lookup_matches_solid_indices_dev(k):
    rng = np.random.default_rng(k + 2)
    contigs = [rng.integers(0, 4, 200 + k, dtype=np.uint8) for _ in range(3)]
    words, counts = _run(rng, k, contigs, singletons=3)
    nu = words.shape[0]
    wpad, cpad = _pad_run(words, counts)
    ref_infl = ref_unitig.dispatch_build(jnp.asarray(wpad), jnp.asarray(cpad), CUTOFF, k, nu)
    absent, _ = kmer.kmer_words_batch_np(rng.integers(0, 4, (50, k), dtype=np.uint8),
                                         np.zeros(50, np.int64), k)
    q = np.concatenate([words[rng.integers(0, nu, 400)], absent, words[:3], words[-3:]])
    want = ref_unitig.solid_indices_dev(ref_infl, q)
    hit, rank, ns = unitig.solid_indices(unitig.dispatch_build(_solid(wpad, cpad, k), k, nu), q)
    np.testing.assert_array_equal(hit, want[0])
    np.testing.assert_array_equal(rank, want[1])
    assert ns == want[2]
    assert want[0].any() and not want[0].all()


def test_run_forms_are_checked():
    """The run's form follows k: int64 keys up to 31, (M, W) int32 words
    past it; the K8 queries take the run's form."""
    words = torch.zeros((4, 4), dtype=torch.int32)
    keys = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64 keys"):
        unitig.unitig_links_plain(words, 31)
    with pytest.raises(ValueError, match=r"\(M, 4\) int32 words"):
        unitig.unitig_links_plain(keys, 63)
    with pytest.raises(ValueError, match=r"\(M, 3\) int32 words"):
        unitig.unitig_links_plain(words, 33)
    with pytest.raises(ValueError, match="the run's form"):
        unitig.solid_lookup_plain(words, 63, keys)


# the device-build twins of the multiword archive cases at odd k: the same
# corpora, seeds and configs (so the reference reuses its compiled walks)
DEVICE_ARCHIVES = {
    33: (WIDE_ARCHIVES, "fastq_lossy_k33", 500),
    63: (WIDE_ARCHIVES, "fasta_wrapped_k63", 500),
    127: (LONG_ARCHIVES, "fastq_lossless_k127", 900),
    255: (LONG_ARCHIVES, "fasta_long_k255", 900),
}


@pytest.mark.parametrize("k", sorted(DEVICE_ARCHIVES))
def test_device_build_archive_matches_reference(tmp_path, k):
    """Compress with the device unitig build (unitig_device_max_kmers =
    2**30) writes leon_tpu's archive (the device build there too), with a
    UNITIGS section; each package decodes the other's archive exactly."""
    table, case, seed = DEVICE_ARCHIVES[k]
    make, k_case, kw = table[case]
    assert k_case == k
    fasta = "fasta" in case
    src = tmp_path / ("in.fasta" if fasta else "in.fastq")
    make(src, np.random.default_rng(sorted(table).index(case) + seed))
    kw = dict(kw, kmer_size=k, unitig_device_max_kmers=1 << 30)
    ref_cfg, port_cfg = LeonConfig(**REF_KW, **kw), LeonConfig(**PORT_KW, **kw)
    ref_arc, port_arc = str(tmp_path / "ref.leon"), str(tmp_path / "port.leon")
    rst = ref_pipeline.compress(str(src), ref_arc, cfg=ref_cfg)
    pst = pipeline.compress(str(src), port_arc, cfg=port_cfg, device="cpu")
    assert open(port_arc, "rb").read() == open(ref_arc, "rb").read()
    assert pst["unitig_bytes"] == rst["unitig_bytes"] > 0
    assert "count.unitig_dispatch" in pst["span_s"] and "unitig.thread_build" not in pst["span_s"]
    original = open(src, "rb").read()
    exact = fasta or kw.get("lossless")
    for who, arc in (("ref", ref_arc), ("port", port_arc)):
        outs = (ref_pipeline.decompress(arc, str(tmp_path / f"r_{who}"), cfg=ref_cfg)["output"],
                pipeline.decompress(arc, str(tmp_path / f"p_{who}"), cfg=port_cfg,
                                    device="cpu")["output"])
        for out in outs:
            got = open(out, "rb").read()
            if exact:
                assert got == original
            else:
                assert got.split(b"\n")[1::4] == original.split(b"\n")[1::4]


# The default compress where cutoff > 255 makes the clamped histogram
# overcount n_solid, so the reference hands its native builder zero pad rows
# (ROADMAP.md queue 3): 3,000 reads from a 400-bp contig, abundance 300.
_PAD_CASES = {31: (60, 100), 63: (120, 150)}


def _pad_corpus(path, k):
    rng = np.random.default_rng(300)
    contig = rng.integers(0, 4, 400, dtype=np.uint8)
    lmin, lmax = _PAD_CASES[k]
    write_fasta(path, [sim_seq(rng, contig, lmin=lmin, lmax=lmax) for _ in range(3000)])


_PORT_COMPRESS = """
import sys
from leon_tpu_torch import pipeline
from leon_tpu_torch.config import LeonConfig
st = pipeline.compress(sys.argv[1], sys.argv[2], device="cpu", cfg=LeonConfig(
    kmer_size=int(sys.argv[3]), abundance=300, batch_reads=1024, reads_per_block=1500))
print(st["n_solid_kmers"], st["unitig_bytes"])
"""


@pytest.mark.parametrize("k", sorted(_PAD_CASES))
def test_cutoff_above_255_default_compress(tmp_path, k):
    """The port's default compress finishes, in a process of its own with a
    time limit. At k = 31 the reference's native builder never returns on
    the pad rows (its hash finds the all-A pads, which link to themselves),
    and the port writes the reference's device-build archive; at k = 63 the
    builder returns (its binary search over the shifted buckets never finds
    them) with a payload past the frozen size rule, and the port writes the
    reference's default archive, with the BLOOM section. The hanging
    reference path is never run."""
    src = tmp_path / "in.fasta"
    _pad_corpus(src, k)
    port_arc = str(tmp_path / "port.leon")
    res = subprocess.run([sys.executable, "-c", _PORT_COMPRESS, str(src), port_arc, str(k)],
                         capture_output=True, text=True, timeout=240,
                         cwd=os.path.dirname(os.path.dirname(pipeline.__file__)))
    assert res.returncode == 0, res.stderr[-2000:]
    n_solid, unitig_bytes = map(int, res.stdout.split()[-2:])
    extra = dict(unitig_device_max_kmers=1 << 30) if k == 31 else {}
    ref_arc = str(tmp_path / "ref.leon")
    rst = ref_pipeline.compress(str(src), ref_arc, cfg=LeonConfig(
        kmer_size=k, abundance=300, batch_reads=1024, reads_per_block=1500, mesh_devices=1,
        **extra))
    assert open(port_arc, "rb").read() == open(ref_arc, "rb").read()
    assert (n_solid, unitig_bytes) == (rst["n_solid_kmers"], rst["unitig_bytes"])
    assert (unitig_bytes > 0) == (k == 31)


_HOST_BUILD = """
import sys
import numpy as np
from leon_tpu_torch.ops import unitig
rows = np.load(sys.argv[1])
try:
    p = unitig.build_np_payload(rows, np.full(rows.shape[0], 2, np.int32), 2, int(sys.argv[2]))
except unitig.LinksNotChains:
    print("endless")
else:
    print("none" if p is None else p.hex())
"""


@pytest.mark.parametrize("k, n_pad, endless", [(31, 19, True), (31, 1, False), (15, 4, True),
                                               (63, 15, False), (16, 4, False)])
def test_native_build_reports_endless_walk(tmp_path, k, n_pad, endless):
    """The port's native builder over solid rows and all-A pad rows, in a
    process of its own with a time limit: where its hash successor search
    (k <= 15, 17 <= k <= 31) finds two or more pads, which link to
    themselves, it raises LinksNotChains instead of looping as the
    reference's does; one pad, or the binary search's widths (k = 16,
    k >= 32), give the reference's payload. A solid A^(k-1)C is a second
    out-edge of the all-A node: no loop at any k."""
    rng = np.random.default_rng(k)
    words, _ = _run(rng, k, [rng.integers(0, 4, 300, dtype=np.uint8)], cov=1)
    W = words.shape[1]
    one = np.zeros((1, W), np.uint32)
    one[0, 0] = 1
    for rows, loops in ((np.concatenate([words, np.zeros((n_pad, W), np.uint32)]), endless),
                        (np.concatenate([one, words, np.zeros((n_pad, W), np.uint32)]), False)):
        np.save(tmp_path / "rows.npy", rows)
        res = subprocess.run([sys.executable, "-c", _HOST_BUILD, str(tmp_path / "rows.npy"),
                              str(k)], capture_output=True, text=True, timeout=120,
                             cwd=os.path.dirname(os.path.dirname(pipeline.__file__)))
        assert res.returncode == 0, res.stderr[-2000:]
        got = res.stdout.split()[-1]
        if loops:
            assert got == "endless"
        else:
            want = ref_unitig.build_np_payload(rows, np.full(rows.shape[0], 2, np.int32), 2, k)
            assert got == ("none" if want is None else want.hex())
