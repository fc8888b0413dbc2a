"""Port parity at 65 <= k <= 255 (W = 5..16 u32 words, ceil(W/2) int64
planes), the main path's multiword route past k = 64: K17's plain version
(kmer_scan_halves) against kmer_scan_packed, K14's plain version in count,
cutoff and histogram modes against _merge_sorted_runs, compact_solid and
_hist_of_sorted, the WordCounter against leon_tpu's DeviceCounter, K16's
plain version against build_device, K18's and K19's plain versions
against encode_batch_compact_packed and decode_batch_flat_packed, at
W = 5, 8 and 16 (k = 65, 127, 255) and, for K17 and K14, at k = 128 with a
palindrome (an all-ones top word); whole archives against leon_tpu's,
both ways; the width guards; ``python -m leon_tpu_torch``. All exact
(tolerance 0), inputs made from numpy seeds."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leon_tpu import pipeline as ref_pipeline
from leon_tpu.config import LeonConfig
from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu.ops import walk as ref_walk
from leon_tpu_torch import pipeline, state
from leon_tpu_torch.ops import bloom, count, kmer, walk
from test_roundtrip import sim_seq, write_fasta, write_fastq
from test_torch_widek import H, PORT_KW, REF_KW, SEED, _palindrome, _reads, _ref_bits, _walk_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K17: the compacted scan, P planes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [65, 127, 128, 255])
def test_scan_planes_matches_reference(k):
    rng = np.random.default_rng(k)
    L = k + 37
    codes, lengths = _reads(rng, 24, L, k, contig_len=L + 120)
    packed = ref_kmer.pack_codes_np(codes)
    canon, _, valid = ref_kmer.kmer_scan_packed(packed, lengths, k, L)
    want = np.asarray(canon)[np.asarray(valid)]  # read-major valid rows
    W = want.shape[1]
    tp, tl = state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths)
    planes = kmer.kmer_scan_halves(tp, tl, k, L)
    assert len(planes) == (W + 1) // 2 and planes[0].shape == (want.shape[0],)
    np.testing.assert_array_equal(state.planes_to_words(planes, W).numpy().view(np.uint32), want)
    n = want.shape[0]
    bufs = tuple(torch.full((n + 5,), -5, dtype=torch.int64) for _ in planes)
    for got, h, b in zip(kmer.kmer_scan_halves(tp, tl, k, L, out=bufs), planes, bufs):
        torch.testing.assert_close(got, h, rtol=0, atol=0)
        assert int(b[n]) == -5
    if k % 16 == 0:  # the palindrome (all-ones top word) is a row like any other
        pal = ref_kmer.pack_codes_batch_np(_palindrome(k)[None, :], k)
        assert pal[0, W - 1] == 0xFFFFFFFF and (want == pal).all(axis=1).sum() == 2


def test_planes_round_trip_and_order():
    rng = np.random.default_rng(5)
    for W in range(5, 17):
        words = rng.integers(0, 1 << 32, (400, W), dtype=np.uint64).astype(np.uint32)
        words[:3] = 0xFFFFFFFF
        words[3:6] = 0
        words[6:40, W - 1] = words[6, W - 1]  # ties in the top word
        planes = state.words_to_planes(state.words_to_torch(words, "cpu"))
        assert len(planes) == state.n_planes(W)
        np.testing.assert_array_equal(state.planes_to_words(planes, W).numpy().view(np.uint32),
                                      words)
        order = np.lexsort(tuple(words[:, j] for j in range(W)))  # last key = MSW
        srt, perm = count.sort_planes(planes, with_perm=True)
        np.testing.assert_array_equal(state.planes_to_words(srt, W).numpy().view(np.uint32),
                                      words[order])
        np.testing.assert_array_equal(words[perm.numpy()], words[order])
        np.testing.assert_array_equal(
            state.planes_to_words(count.sort_planes(planes), W).numpy().view(np.uint32),
            words[order])


# ---------------------------------------------------------------------------
# K14 in K2's modes over P planes
# ---------------------------------------------------------------------------


def _merge_case(W, k, rng):
    """Concatenated runs: words with repeats, counts 0..4 and a few near
    2**31 (the clamp), and at k = 16W the palindrome twice."""
    n = 2500
    base = rng.integers(0, 1 << 32, (300, W), dtype=np.uint64).astype(np.uint32)
    base[:, W - 1] &= np.uint32(ref_kmer.top_mask(k))
    base[1:40, W - 1] = base[0, W - 1]  # rows that differ below the top word
    words = base[rng.integers(0, base.shape[0], n)]
    counts = rng.integers(0, 5, n).astype(np.int32)
    words[:30] = base[0]
    counts[:30] = 0x7FFFFFF0  # one key's sum passes 2**32
    words[30:33] = base[1]
    counts[30:33] = [0x7FFFFFFF, 0x7FFFFFFF, 2]  # wraps to 0 mod 2**32
    if k % 16 == 0:
        pal = ref_kmer.pack_codes_batch_np(_palindrome(k)[None, :], k)[0]
        assert pal[W - 1] == 0xFFFFFFFF
        words[40:42] = pal
        counts[40:42] = 1
    return words, counts


@pytest.mark.parametrize("k", [65, 127, 128, 255])
def test_word_runs_modes_match_reference(k):
    W = ref_kmer.words_for_k(k)
    rng = np.random.default_rng(k + 1)
    words, counts = _merge_case(W, k, rng)
    keys_t = tuple(jnp.asarray(words[:, W - 1 - j]) for j in range(W))
    skeys, boundary, summed = ref_count._merge_sorted_runs(keys_t, jnp.asarray(counts))
    bnd = np.asarray(boundary)
    want_w = np.stack([np.asarray(skeys[W - 1 - j])[bnd] for j in range(W)], axis=1)
    want_c = np.asarray(summed)[bnd]
    want_h = np.asarray(ref_count._hist_of_sorted(boundary, summed))
    # count mode with the histogram: sort with the counts as payload
    planes, perm = count.sort_planes(state.words_to_planes(state.words_to_torch(words, "cpu")),
                                     with_perm=True)
    gw, gc, gh = count.word_runs(planes, W, torch.from_numpy(counts)[perm], 1, True)
    np.testing.assert_array_equal(gw.numpy().view(np.uint32), want_w)
    np.testing.assert_array_equal(gc.numpy(), want_c)
    np.testing.assert_array_equal(gh.numpy(), want_h)
    assert gc.dtype == torch.int32 and int(gc.max()) == 0x7FFFFFFF
    if k % 16 == 0:
        pal = ref_kmer.pack_codes_batch_np(_palindrome(k)[None, :], k)[0]
        assert gc[np.flatnonzero((want_w == pal).all(axis=1))].tolist() == [2]
    # cutoff mode = compact_solid on the distinct run
    cutoff = 3
    sw, sc = count.compact_solid_words(gw, gc, cutoff)
    nsol = int((want_c >= cutoff).sum())
    ow, oc = ref_count.compact_solid(jnp.asarray(want_w), jnp.asarray(want_c), np.int32(cutoff),
                                     ref_count._bucket_size(nsol))
    np.testing.assert_array_equal(sw.numpy().view(np.uint32), np.asarray(ow)[:nsol])
    np.testing.assert_array_equal(sc.numpy(), np.asarray(oc)[:nsol])
    # length mode (a raw slab), with cutoff and histogram
    lw, lc, lh = count.word_runs(count.sort_words(state.words_to_torch(words, "cpu")), W, None,
                                 2, True)
    ru, rn = ref_count.count_batch(words[:, None, :], np.ones((words.shape[0], 1), bool))
    keep = rn >= 2
    np.testing.assert_array_equal(lw.numpy().view(np.uint32), ru[keep])
    np.testing.assert_array_equal(lc.numpy(), rn[keep])
    want_lh = np.bincount(np.minimum(rn[keep], 255), minlength=256)
    want_lh[0] = 0
    np.testing.assert_array_equal(lh.numpy(), want_lh)


# ---------------------------------------------------------------------------
# The multiword counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,lossy", [(65, True), (127, False), (255, False)])
def test_word_counter_matches_reference(k, lossy):
    """At k = 255 the reference counter spills its runs to the host
    (spill_rows=1), whose finalize builds the filter with build_np: the
    same bits as build_device (the reference's contract), which takes over
    a minute to compile for k = 255 on the CPU."""
    rng = np.random.default_rng(k + 7)
    L, B = k + 25, 32
    spill = k > 127
    ref = ref_count.DeviceCounter(k, slab_kmers=1 << (9 if spill else 11), merge_factor=2,
                                  **(dict(spill_rows=1) if spill else {}))
    port = count.WordCounter(k, "cpu", slab_kmers=500, merge_factor=2)
    flushes = 0
    canons, valids = [], []
    for _ in range(3):
        codes, lengths = _reads(rng, B, L, k, contig_len=L + 60, err=0.002)
        packed = ref_kmer.pack_codes_np(codes)
        canon, _, valid = ref_kmer.kmer_scan_packed(packed, lengths, k, L)
        ref.add(canon, valid)
        canons.append(np.asarray(canon))
        valids.append(np.asarray(valid))
        port.add_packed(state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths), L)
        flushes = max(flushes, len(port._runs))
    assert flushes >= 1  # the small slab flushed (and merged: merge_factor 2)
    rb, rnw, rcut, rns, rhist, rH, (rwords, rcnt, rnu, host_pair) = ref.finalize(
        None, None, None, SEED, lossy, want_solid=True, unitig_max=128 << 20)
    pb, pnw, pcut, pns, phist, pH, (pw, pcnt, pnu, psolid) = port.finalize(
        None, None, None, SEED, lossy, unitig_max=128 << 20)
    np.testing.assert_array_equal(phist, np.asarray(rhist))
    assert (pcut, pns, pnw, pH, pnu) == (rcut, rns, rnw, rH, rnu)
    assert rns > 0 and (host_pair is not None) == spill
    np.testing.assert_array_equal(state.bitset_from_torch(pb), np.asarray(rb)[:rnw])
    # the distinct run: the reference's count_batch over every valid row
    ru, rn = ref_count.count_batch(np.concatenate(canons), np.concatenate(valids))
    np.testing.assert_array_equal(pw.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(pcnt.numpy(), rn)
    # the solid rows the Bloom build compacted, handed on for the unitig builder
    want_solid = host_pair[0] if spill else np.asarray(rwords)[np.asarray(rcnt) >= rcut]
    np.testing.assert_array_equal(psolid.numpy().view(np.uint32), want_solid)


# ---------------------------------------------------------------------------
# K16 as the main path's Bloom build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [65, 127, 255])
def test_bloom_build_words_matches_build_device(k):
    """At k = 255 against the reference's host build (build_np, the same
    bits as build_device, which takes over a minute to compile for k = 255
    on the CPU); build_device itself at k = 65 and 127."""
    rng = np.random.default_rng(k)
    W = ref_kmer.words_for_k(k)
    M = 1500
    words = rng.integers(0, 1 << 32, (M, W), dtype=np.uint64).astype(np.uint32)
    words[:, W - 1] &= np.uint32(ref_kmer.top_mask(k))
    counts = rng.integers(0, 6, M).astype(np.int32)
    cutoff, n_words = 3, ref_bloom.choose_n_words(int((counts >= 3).sum()), 12.0)
    if k > 127:
        want = ref_bloom.build_np(words[counts >= cutoff], n_words, H, SEED, k)
    else:
        want = np.asarray(ref_bloom.build_device(jnp.asarray(words), jnp.asarray(counts),
                                                 jnp.int32(cutoff), n_words, H, SEED, k))
        assert not want[n_words:].any()
    got = bloom.bloom_build_words(state.words_to_torch(words, "cpu"),
                                  torch.from_numpy(counts) >= cutoff, n_words, n_words, H, SEED,
                                  k)
    np.testing.assert_array_equal(state.bitset_from_torch(got), want[:n_words])


# ---------------------------------------------------------------------------
# K18 and K19: the walk encode and the decode re-walk
# ---------------------------------------------------------------------------

WALK_B = 32


@pytest.mark.parametrize("k,with_conf", [(65, True), (127, False), (255, True)])
def test_walk_encode_words_matches_reference(k, with_conf):
    L = k + 49
    codes, lengths, bitset, n_words = _walk_case(k, L, k + with_conf, WALK_B)
    packed = ref_kmer.pack_codes_np(codes)
    cap = (L - k) * WALK_B
    ref = np.asarray(ref_walk.encode_batch_compact_packed(
        packed, lengths, _ref_bits(bitset, n_words), k, H, np.uint32(n_words), SEED,
        cap, cap, with_conf, L)).astype(np.uint16)
    tp, tl = state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths)
    tb = state.bitset_to_torch(bitset, "cpu")
    enc = walk.walk_encode_words(tp, tl, tb, n_words, k, H, SEED, L, with_conf)
    buf = walk.walk_pack(enc, torch.cumsum(enc["tot"], dim=1), L, k, cap, cap, with_conf)
    np.testing.assert_array_equal(buf.numpy().view(np.uint16), ref)
    want = ref_walk.unpack_compact(ref, WALK_B, WALK_B, L, cap, cap, with_conf, k)
    assert want["anchored"].sum() >= 4 and len(want["errgap_flat"])
    got, ce, cb = walk.encode_batch_compact_packed(tp, tl, tb, k, H, n_words, SEED, None, None,
                                                   with_conf, L)
    enc2 = walk.unpack_compact(got.numpy().view(np.uint16), WALK_B, WALK_B, L, ce, cb,
                               with_conf, k)
    for key in ("anchored", "apos", "nerr_r", "nbif_r", "nerr_l", "nbif_l", "errgap_flat",
                "errnt_flat", "bif_flat", "conf16"):
        np.testing.assert_array_equal(enc2[key], want[key])


@pytest.mark.parametrize("k", [65, 127, 255])
def test_walk_decode_words_matches_reference(k):
    L = k + 49
    codes, lengths, bitset, n_words = _walk_case(k, L, k + 11, WALK_B)
    packed = ref_kmer.pack_codes_np(codes)
    cap = (L - k) * WALK_B
    buf = np.asarray(ref_walk.encode_batch_compact_packed(
        packed, lengths, _ref_bits(bitset, n_words), k, H, np.uint32(n_words), SEED,
        cap, cap, False, L)).astype(np.uint16)
    enc = walk.unpack_compact(buf, WALK_B, WALK_B, L, cap, cap, False, k)
    anch = enc["anchored"]
    W = ref_kmer.words_for_k(k)
    canon, orient = ref_kmer.kmer_words_batch_np(codes, enc["apos"].astype(np.int64), k)
    afwd = np.where(orient[:, None], ref_kmer.revcomp_words_batch_np(canon, k), canon)
    et = enc["nerr_r"] + enc["nerr_l"]
    bt = enc["nbif_r"] + enc["nbif_l"]
    scal = np.zeros((WALK_B, 9 + W), np.int32)
    scal[:, 0] = enc["apos"]
    scal[:, 1] = anch
    scal[:, 2] = np.where(anch, lengths, 0)
    scal[:, 3], scal[:, 4] = enc["nerr_r"], enc["nerr_l"]
    scal[:, 5], scal[:, 6] = enc["nbif_r"], enc["nbif_l"]
    scal[:, 7] = np.cumsum(et) - et
    scal[:, 8] = np.cumsum(bt) - bt
    scal[:, 9:] = afwd.view(np.int32)
    eg = enc["errgap_flat"].astype(np.int32)
    en = enc["errnt_flat"].astype(np.uint8)
    bf = enc["bif_flat"].astype(np.uint8)

    def padded(a, n=1024):
        out = np.zeros(max(n, a.size + L), a.dtype)
        out[: a.size] = a
        return out

    ref = np.asarray(ref_walk.decode_batch_flat_packed(
        scal, padded(eg.astype(np.uint16)), padded(en), padded(bf),
        _ref_bits(bitset, n_words), k, H, np.uint32(n_words), SEED, L, W))
    args = (torch.from_numpy(scal), torch.from_numpy(eg), torch.from_numpy(en),
            torch.from_numpy(bf), state.bitset_to_torch(bitset, "cpu"), n_words, k, H, SEED, L)
    got = walk.walk_decode_words(*args)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(walk.decode_batch_flat_packed(*args).numpy(), got.numpy())
    dec = walk.unpack_codes_u32_np(got.numpy().view(np.uint32), L)
    assert anch.sum() >= 4
    for i in np.flatnonzero(anch):
        np.testing.assert_array_equal(dec[i, : lengths[i]], codes[i, : lengths[i]])


# ---------------------------------------------------------------------------
# The width guards
# ---------------------------------------------------------------------------


def test_guards_reject_w17_and_k256():
    """W = 17 (k = 256) has no instance: every wrapper of the multiword route
    refuses it before it reaches a kernel, and LeonConfig refuses k = 256."""
    with pytest.raises(ValueError, match=r"\[1, 255\]"):
        LeonConfig(kmer_size=256)
    L, B = 300, 4
    packed = torch.zeros(B, (L + 15) // 16, dtype=torch.int32)
    lengths = torch.full((B,), L, dtype=torch.int32)
    with pytest.raises(ValueError, match="k=256"):
        kmer.kmer_scan_halves(packed, lengths, 256, L)
    planes = tuple(torch.zeros(3, dtype=torch.int64) for _ in range(9))
    with pytest.raises(ValueError, match="W=17"):
        count.word_runs(planes, 17)
    with pytest.raises(ValueError, match="k=256"):
        bloom.bloom_build_words(torch.zeros(3, 17, dtype=torch.int32),
                                torch.ones(3, dtype=torch.bool), 64, 64, H, SEED, 256)
    bits = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="k=256"):
        walk.walk_encode_words(packed, lengths, bits, 64, 256, H, SEED, L, False)
    scal = torch.zeros(B, 9 + 16, dtype=torch.int32)
    e32, e8 = torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.uint8)
    with pytest.raises(ValueError, match="k=256"):
        walk.walk_decode_words(scal, e32, e8, e8, bits, 64, 256, H, SEED, L)


# ---------------------------------------------------------------------------
# Whole archives
# ---------------------------------------------------------------------------


def _fastq_long(path, rng, n=120):
    """2 x 250-style reads at one length (one chunk width, so the reference
    compiles its walk once), and a few short and empty records."""
    contig = rng.integers(0, 4, 900, dtype=np.uint8)
    seqs = [sim_seq(rng, contig, lmin=200, lmax=200) for _ in range(n)]
    seqs += [b"NNNN", b"", b"ACG", b"A" * 70]
    write_fastq(path, seqs, rng)


def _fasta_long(path, rng, n=60):
    """Long reads at one length, wrapped, with short, all-N and empty ones."""
    contig = rng.integers(0, 4, 1200, dtype=np.uint8)
    seqs = [sim_seq(rng, contig, lmin=300, lmax=300) for _ in range(n)]
    seqs += [b"ACGT", b"A" * 255, b"N" * 50, b""]
    write_fasta(path, seqs, wrap=70)


def _fasta_k95(path, rng):
    """The reference's own k = 95 case (tests/test_roundtrip.py:276-283)."""
    contig = rng.integers(0, 4, 1500, dtype=np.uint8)
    write_fasta(path, [sim_seq(rng, contig, lmin=120, lmax=128, err=0.002) for _ in range(120)])


# (corpus, k, LeonConfig fields): no corpus with unitig sections holds a
# palindromic k-mer at even k (ROADMAP.md queue 3)
ARCHIVES = {
    "fastq_lossy_k65": (_fastq_long, 65, {}),
    "fasta_k95": (_fasta_k95, 95, dict(abundance=2)),
    "fastq_lossless_k127": (_fastq_long, 127, dict(lossless=True)),
    "fasta_k128_bloom": (_fasta_long, 128, dict(unitig_sections=False)),
    # the reference's counter spills to the host here (count_spill_rows=1):
    # the same archive, without compiling build_device for k = 255
    "fasta_long_k255": (_fasta_long, 255, dict(count_spill_rows=1)),
}


@pytest.mark.parametrize("case", sorted(ARCHIVES))
def test_archive_and_cross_decode_match_reference(tmp_path, case):
    make, k, kw = ARCHIVES[case]
    rng = np.random.default_rng(sorted(ARCHIVES).index(case) + 900)
    src = tmp_path / ("in.fasta" if "fasta" in case else "in.fastq")
    make(src, rng)
    ref_cfg = LeonConfig(kmer_size=k, **REF_KW, **kw)
    port_cfg = LeonConfig(kmer_size=k, **PORT_KW, **kw)
    ref_arc, port_arc = str(tmp_path / "ref.leon"), str(tmp_path / "port.leon")
    rst = ref_pipeline.compress(str(src), ref_arc, cfg=ref_cfg)
    pst = pipeline.compress(str(src), port_arc, cfg=port_cfg, device="cpu")
    assert open(port_arc, "rb").read() == open(ref_arc, "rb").read()
    for key in ("n_reads", "n_anchored", "n_solid_kmers", "abundance", "unitig_bytes",
                "stream_bytes"):
        assert pst[key] == rst[key], key
    assert rst["n_anchored"] > 0
    assert (pst["unitig_bytes"] == 0) == (not kw.get("unitig_sections", True))
    outs = {}
    for who, arc in (("ref", ref_arc), ("port", port_arc)):
        outs[("ref", who)] = ref_pipeline.decompress(
            arc, str(tmp_path / f"ref_dec_{who}"), cfg=ref_cfg)["output"]
        outs[("port", who)] = pipeline.decompress(
            arc, str(tmp_path / f"port_dec_{who}"), cfg=port_cfg, device="cpu")["output"]
    data = {key: open(p, "rb").read() for key, p in outs.items()}
    assert len(set(data.values())) == 1
    original = open(src, "rb").read()
    if "fasta" in case or kw.get("lossless"):
        assert data[("port", "ref")] == original
    else:
        assert data[("port", "ref")].split(b"\n")[1::4] == original.split(b"\n")[1::4]


def test_python_m_leon_tpu_torch_k127(tmp_path):
    """python -m leon_tpu_torch runs the port's command line (cli.py)."""
    rng = np.random.default_rng(127)
    src = tmp_path / "r.fastq"
    _fastq_long(src, rng, n=40)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "leon_tpu_torch", "-file", str(src), "-c", "-test-file",
         "-device", "cpu", "-kmer-size", "127", "-verbose", "0"],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "round-trip (sequence-exact): OK" in res.stdout
