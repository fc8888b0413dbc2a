"""Port parity at 32 <= k <= 64 (W = 2..4 u32 words), the main path's
multiword route: K17's plain version (kmer_scan_halves) against
kmer_scan_packed, K14's plain version in count, cutoff and histogram modes
against _merge_sorted_runs, compact_solid and _hist_of_sorted, the
WordCounter against leon_tpu's DeviceCounter, K16's plain version against
build_device, K18's and K19's plain versions against
encode_batch_compact_packed and decode_batch_flat_packed, and whole
archives against leon_tpu's, both ways; all exact (tolerance 0)."""

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
from test_roundtrip import BASES, sim_seq, write_fasta, write_fastq

H, SEED = 4, 0x1234ABCD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _palindrome(k):
    """T^(k/2) A^(k/2): its own reverse complement, all-ones top word at
    k = 32, 48, 64."""
    return np.array([3] * (k // 2) + [0] * (k // 2), np.uint8)


def _reads(rng, B, L, k, contig_len=300, err=0.02):
    """(codes (B, L), lengths): ragged reads of a short contig, some
    shorter than k, pad lanes, and a palindrome at even k."""
    contig = rng.integers(0, 4, contig_len, dtype=np.uint8)
    codes = np.zeros((B, L), np.uint8)
    lengths = rng.integers(k - 3, L + 1, B).astype(np.int32)
    lengths[:3] = [L, k - 1, k]
    lengths[-3:] = 0
    for i in range(B):
        st = rng.integers(0, contig_len - L)
        r = contig[st : st + L].copy()
        mut = rng.random(L) < err
        r[mut] = (r[mut] + 1) & 3
        if i % 2:
            r = (3 - r)[::-1]
        codes[i, : lengths[i]] = r[: lengths[i]]
    if k % 2 == 0:
        codes[3, :k] = _palindrome(k)
        codes[4, 5 : 5 + k] = _palindrome(k)
        lengths[3], lengths[4] = k, k + 5
    return codes, lengths


# ---------------------------------------------------------------------------
# K17: the compacted scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [32, 33, 48, 63, 64])
def test_scan_halves_matches_reference(k):
    rng = np.random.default_rng(k)
    L = 88
    codes, lengths = _reads(rng, 40, L, k)
    packed = ref_kmer.pack_codes_np(codes)
    canon, _, valid = ref_kmer.kmer_scan_packed(packed, lengths, k, L)
    want = np.asarray(canon)[np.asarray(valid)]  # read-major valid rows
    tp, tl = state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths)
    planes = kmer.kmer_scan_halves(tp, tl, k, L)
    assert len(planes) == (1 if k <= 32 else 2) and planes[0].shape == (want.shape[0],)
    np.testing.assert_array_equal(
        state.planes_to_words(planes, want.shape[1]).numpy().view(np.uint32), want)
    # into slab views longer than the valid rows
    n = want.shape[0]
    bufs = tuple(torch.full((n + 7,), -5, dtype=torch.int64) for _ in planes)
    got = kmer.kmer_scan_halves(tp, tl, k, L, out=bufs)
    for g, h, b in zip(got, planes, bufs):
        torch.testing.assert_close(g, h, rtol=0, atol=0)
        assert int(b[n]) == -5
    if k % 2 == 0:  # the palindrome (all-ones top word) is a row like any other
        pal = ref_kmer.pack_codes_batch_np(_palindrome(k)[None, :], k)
        assert (want == pal).all(axis=1).sum() == 2


def test_halves_round_trip_and_order():
    rng = np.random.default_rng(3)
    for W in (1, 2, 3, 4):
        words = rng.integers(0, 1 << 32, (500, W), dtype=np.uint64).astype(np.uint32)
        words[:3] = 0xFFFFFFFF
        words[3:6] = 0
        t = state.words_to_torch(words, "cpu")
        planes = state.words_to_planes(t)
        np.testing.assert_array_equal(state.planes_to_words(planes, W).numpy().view(np.uint32),
                                      words)
        planes = count.sort_planes(planes)
        order = np.lexsort(tuple(words[:, j] for j in range(W)))  # last key = MSW
        np.testing.assert_array_equal(
            state.planes_to_words(planes, W).numpy().view(np.uint32), words[order])


# ---------------------------------------------------------------------------
# K14 in K2's modes
# ---------------------------------------------------------------------------


def _merge_case(W, k, rng):
    """Concatenated runs: words with repeats, counts 0..4 and a few near
    2**31 (the clamp), and at k = 64 the palindrome twice."""
    n = 3000
    base = rng.integers(0, 1 << 32, (400, W), dtype=np.uint64).astype(np.uint32)
    base[:, W - 1] &= np.uint32(ref_kmer.top_mask(k))
    words = base[rng.integers(0, base.shape[0], n)]
    counts = rng.integers(0, 5, n).astype(np.int32)
    words[:30] = base[0]
    counts[:30] = 0x7FFFFFF0  # one key's sum passes 2**32
    words[30:33] = base[1]
    counts[30:33] = [0x7FFFFFFF, 0x7FFFFFFF, 2]  # wraps to 0 mod 2**32
    if k == 64:
        pal = ref_kmer.pack_codes_batch_np(_palindrome(k)[None, :], k)[0]
        assert pal[W - 1] == 0xFFFFFFFF
        words[40:42] = pal
        counts[40:42] = 1
    return words, counts


@pytest.mark.parametrize("k", [48, 64])
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
    if k == 64:
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


@pytest.mark.parametrize("k,lossy", [(33, False), (64, True)])
def test_word_counter_matches_reference(k, lossy):
    rng = np.random.default_rng(k + 7)
    L, B = 80, 48
    ref = ref_count.DeviceCounter(k, slab_kmers=1 << 12, merge_factor=2)
    port = count.WordCounter(k, "cpu", slab_kmers=1000, merge_factor=2)
    flushes = 0
    for _ in range(4):
        codes, lengths = _reads(rng, B, L, k)
        packed = ref_kmer.pack_codes_np(codes)
        canon, _, valid = ref_kmer.kmer_scan_packed(packed, lengths, k, L)
        ref.add(canon, valid)
        port.add_packed(state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths), L)
        flushes = max(flushes, len(port._runs))
    assert flushes >= 1  # the small slab flushed (and merged: merge_factor 2)
    rb, rnw, rcut, rns, rhist, rH, (rwords, rcnt, rnu, _) = ref.finalize(
        None, None, None, SEED, lossy, want_solid=True, unitig_max=128 << 20)
    pb, pnw, pcut, pns, phist, pH, (pw, pcnt, pnu, psolid) = port.finalize(
        None, None, None, SEED, lossy, unitig_max=128 << 20)
    np.testing.assert_array_equal(phist, np.asarray(rhist))
    assert (pcut, pns, pnw, pH, pnu) == (rcut, rns, rnw, rH, rnu)
    assert rns > 0
    np.testing.assert_array_equal(state.bitset_from_torch(pb), np.asarray(rb)[:rnw])
    rc = np.asarray(rcnt)
    np.testing.assert_array_equal(pw.numpy().view(np.uint32), np.asarray(rwords)[rc > 0])
    np.testing.assert_array_equal(pcnt.numpy(), rc[rc > 0])
    # the solid rows the Bloom build compacted, handed on for the unitig builder
    np.testing.assert_array_equal(psolid.numpy().view(np.uint32),
                                  np.asarray(rwords)[rc >= rcut])
    # the reference's padded run carries across
    rw, rcn = state.run_from_reference(np.asarray(rwords), rc, k)
    np.testing.assert_array_equal(rw.numpy(), pw.numpy())
    np.testing.assert_array_equal(rcn.numpy(), pcnt.numpy())


def test_empty_word_counter_matches_reference():
    ref = ref_count.DeviceCounter(63)
    port = count.WordCounter(63, "cpu")
    r = ref.finalize(None, None, None, 7, False, want_solid=True)
    p = port.finalize(None, None, None, 7, False)
    assert p[1:4] == r[1:4] and p[5] == r[5] and p[6] is None


# ---------------------------------------------------------------------------
# K16 as the main path's Bloom build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [33, 63])
def test_bloom_build_words_matches_build_device(k):
    rng = np.random.default_rng(k)
    W = ref_kmer.words_for_k(k)
    M = 3000
    words = rng.integers(0, 1 << 32, (M, W), dtype=np.uint64).astype(np.uint32)
    words[:, W - 1] &= np.uint32(ref_kmer.top_mask(k))
    counts = rng.integers(0, 6, M).astype(np.int32)
    cutoff, n_words = 3, ref_bloom.choose_n_words(int((counts >= 3).sum()), 12.0)
    want = np.asarray(ref_bloom.build_device(jnp.asarray(words), jnp.asarray(counts),
                                             jnp.int32(cutoff), n_words, H, SEED, k))
    tw = state.words_to_torch(words, "cpu")
    got = bloom.bloom_build_words(tw, torch.from_numpy(counts) >= cutoff, n_words, n_words, H,
                                  SEED, k)
    np.testing.assert_array_equal(state.bitset_from_torch(got), want[:n_words])
    assert not want[n_words:].any()


# ---------------------------------------------------------------------------
# K18 and K19: the walk encode and the decode re-walk
# ---------------------------------------------------------------------------


def _walk_case(k, L, seed, B=48):
    """(codes, lengths, bitset, n_words): reads from a contig whose k-mers
    fill a lean Bloom filter (false positives make bifurcations)."""
    rng = np.random.default_rng(seed)
    contig = rng.integers(0, 4, 2 * L + 200, dtype=np.uint8)
    codes = np.zeros((B, L), np.uint8)
    lengths = rng.integers(k + 1, L + 1, B).astype(np.int32)
    lengths[:4] = [L, k - 3, k, 0]
    lengths[-4:] = 0
    for i in range(B):
        st = rng.integers(0, contig.size - L)
        r = contig[st : st + L].copy()
        mut = rng.random(L) < 0.03
        r[mut] = (r[mut] + rng.integers(1, 4, int(mut.sum()))) & 3
        if i % 2:
            r = (3 - r)[::-1]
        codes[i, : lengths[i]] = r[: lengths[i]]
    win = np.lib.stride_tricks.sliding_window_view(contig, k)
    solid, _ = ref_kmer.kmer_words_batch_np(win, np.zeros(win.shape[0], np.int64), k)
    n_words = ref_bloom.choose_n_words(solid.shape[0], 5.0)
    return codes, lengths, ref_bloom.build_np(solid, n_words, H, SEED, k), n_words


def _ref_bits(bitset, n_words):
    return np.pad(bitset, (0, ref_bloom.alloc_words(n_words) - n_words))


@pytest.mark.parametrize("k,with_conf", [(33, True), (48, False), (63, True), (64, False)])
def test_walk_encode_words_matches_reference(k, with_conf):
    L = 104
    B = 48
    codes, lengths, bitset, n_words = _walk_case(k, L, k + with_conf)
    packed = ref_kmer.pack_codes_np(codes)
    cap = (L - k) * B
    ref = np.asarray(ref_walk.encode_batch_compact_packed(
        packed, lengths, _ref_bits(bitset, n_words), k, H, np.uint32(n_words), SEED,
        cap, cap, with_conf, L)).astype(np.uint16)
    tp, tl = state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths)
    tb = state.bitset_to_torch(bitset, "cpu")
    enc = walk.walk_encode_words(tp, tl, tb, n_words, k, H, SEED, L, with_conf)
    buf = walk.walk_pack(enc, torch.cumsum(enc["tot"], dim=1), L, k, cap, cap, with_conf)
    np.testing.assert_array_equal(buf.numpy().view(np.uint16), ref)
    want = ref_walk.unpack_compact(ref, B, B, L, cap, cap, with_conf, k)
    assert want["anchored"].sum() > B // 2 and len(want["bif_flat"]) and len(want["errgap_flat"])
    # the pipeline's call: exact caps, the kernel picked by k
    got, ce, cb = walk.encode_batch_compact_packed(tp, tl, tb, k, H, n_words, SEED, None, None,
                                                   with_conf, L)
    enc2 = walk.unpack_compact(got.numpy().view(np.uint16), B, B, L, ce, cb, with_conf, k)
    for key in ("anchored", "apos", "nerr_r", "nbif_r", "nerr_l", "nbif_l", "errgap_flat",
                "errnt_flat", "bif_flat", "conf16"):
        np.testing.assert_array_equal(enc2[key], want[key])


@pytest.mark.parametrize("k", [33, 63])
def test_walk_decode_words_matches_reference(k):
    L, B = 104, 48
    codes, lengths, bitset, n_words = _walk_case(k, L, k + 11)
    packed = ref_kmer.pack_codes_np(codes)
    cap = (L - k) * B
    buf = np.asarray(ref_walk.encode_batch_compact_packed(
        packed, lengths, _ref_bits(bitset, n_words), k, H, np.uint32(n_words), SEED,
        cap, cap, False, L)).astype(np.uint16)
    enc = walk.unpack_compact(buf, B, B, L, cap, cap, False, k)
    anch = enc["anchored"]
    W = ref_kmer.words_for_k(k)
    canon, orient = ref_kmer.kmer_words_batch_np(codes, enc["apos"].astype(np.int64), k)
    afwd = np.where(orient[:, None], ref_kmer.revcomp_words_batch_np(canon, k), canon)
    et = enc["nerr_r"] + enc["nerr_l"]
    bt = enc["nbif_r"] + enc["nbif_l"]
    scal = np.zeros((B, 9 + W), np.int32)
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
    assert anch.sum() > B // 2
    for i in np.flatnonzero(anch):
        np.testing.assert_array_equal(dec[i, : lengths[i]], codes[i, : lengths[i]])


# ---------------------------------------------------------------------------
# Whole archives
# ---------------------------------------------------------------------------

REF_KW = dict(batch_reads=64, reads_per_block=100, mesh_devices=1)
PORT_KW = dict(batch_reads=64, reads_per_block=100)


def _fastq(path, rng, n=200):
    contig = rng.integers(0, 4, 600, dtype=np.uint8)
    seqs = [sim_seq(rng, contig) for _ in range(n)] + [b"NNNN", b"", b"ACG"]
    write_fastq(path, seqs, rng)


def _fasta(path, rng, n=80):
    contig = rng.integers(0, 4, 600, dtype=np.uint8)
    seqs = [sim_seq(rng, contig, lmin=150, lmax=300) for _ in range(n)]
    seqs += [b"ACGT", b"A" * 63, b"N" * 50, b"", BASES[rng.integers(0, 4, 64)].tobytes()]
    write_fasta(path, seqs, wrap=70)


# (corpus, k, LeonConfig fields): no corpus with unitig sections holds a
# palindromic k-mer at even k (ROADMAP.md queue 3)
ARCHIVES = {
    "fastq_lossy_k33": (_fastq, 33, {}),
    "fastq_lossless_k48": (_fastq, 48, dict(lossless=True)),
    "fasta_wrapped_k63": (_fasta, 63, {}),
    "fasta_k32_bloom": (_fasta, 32, dict(unitig_sections=False)),
    "fastq_k64_bloom": (_fastq, 64, dict(unitig_sections=False, noheader=True)),
}


@pytest.mark.parametrize("case", sorted(ARCHIVES))
def test_archive_and_cross_decode_match_reference(tmp_path, case):
    make, k, kw = ARCHIVES[case]
    rng = np.random.default_rng(sorted(ARCHIVES).index(case) + 500)
    src = tmp_path / ("in.fastq" if make is _fastq else "in.fasta")
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
    if make is _fasta or kw.get("lossless"):
        assert data[("port", "ref")] == original
    else:
        assert data[("port", "ref")].split(b"\n")[1::4] == original.split(b"\n")[1::4]


def test_device_unitig_build_at_k33(tmp_path):
    """The device unitig build at k > 31, which raised NotImplementedError
    (item 9b) until K5, K7 and K8 took W-word rows: the same input at
    k = 33 with unitig_device_max_kmers = 2**30 gives leon_tpu's archive
    (its device build too), with a UNITIGS section, and decodes exactly."""
    rng = np.random.default_rng(65)
    src = tmp_path / "in.fasta"
    _fasta(src, rng, n=20)
    kw = dict(kmer_size=33, unitig_device_max_kmers=1 << 30)
    ref_arc, port_arc = str(tmp_path / "a.leon"), str(tmp_path / "b.leon")
    rst = ref_pipeline.compress(str(src), ref_arc, cfg=LeonConfig(**kw, **REF_KW))
    pst = pipeline.compress(str(src), port_arc, cfg=LeonConfig(**kw, **PORT_KW), device="cpu")
    assert open(port_arc, "rb").read() == open(ref_arc, "rb").read()
    assert pst["unitig_bytes"] == rst["unitig_bytes"] > 0
    out = pipeline.decompress(port_arc, str(tmp_path / "b.out"), cfg=LeonConfig(**kw, **PORT_KW),
                              device="cpu")["output"]
    assert open(out, "rb").read() == open(src, "rb").read()


def test_cli_kmer_size_on_the_cpu(tmp_path, capsys):
    """-kmer-size 32..255 through the port's command line (-device cpu runs
    the plain versions); past 255 it exits 1, as LeonConfig refuses it."""
    from leon_tpu_torch import cli

    rng = np.random.default_rng(48)
    src = tmp_path / "r.fasta"
    _fasta(src, rng, n=12)
    for k in (48, 70):
        assert cli.main(["-file", str(src), "-c", "-test-file", "-device", "cpu", "-kmer-size",
                         str(k), "-verbose", "0"]) == 0
        assert "round-trip (byte-exact): OK" in capsys.readouterr().out
    assert cli.main(["-file", str(src), "-c", "-device", "cpu", "-kmer-size", "256",
                     "-verbose", "0"]) == 1
    assert "[1, 255]" in capsys.readouterr().err
