"""Port parity, tensor-level k-mer path: kmer_scan_words (kernel K13's
plain version), count_batch (torch.sort + K14's plain version),
merge_counts, bloom_build_words (K16's plain version) and the dense
encode_batch (K15's plain version) against leon_tpu's kmer_scan,
count_batch, merge_counts, build_np and encode_batch, on full arrays with
tolerance 0 (every output is integer or bool), for k up to 64. Also: the
dense and the compact encode give the same container streams, the port's
entry() equals __graft_entry__.entry(), and the slice as a whole (reads ->
scan -> count -> graph) equals leon_tpu's at k = 33 and 63."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from leon_tpu import graph as ref_graph
from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu.ops import walk as ref_walk
from leon_tpu_torch import LeonConfig, entry, state
from leon_tpu_torch import pipeline as port_pipeline
from leon_tpu_torch.codecs import blocks
from leon_tpu_torch.graph import Graph
from leon_tpu_torch.io import bank, container
from leon_tpu_torch.ops import bloom, count, kmer, walk

H, SEED = 4, 0x1234ABCD
SCAN_K = [15, 16, 31, 32, 33, 48, 63, 64]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op thread is
    faster for them when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(reads, L=None):
    """(codes (B, L) u8, lengths (B,) i32) of a list of code arrays
    (tests/test_walk.py:13-21)."""
    L = L or max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    return codes, lengths


def _scan_case(k):
    """Ragged reads (0, < k, exactly k, full), a read with base bytes past
    its end, at even k a read holding T^(k/2) A^(k/2) (a canonical
    palindrome whose top word is all ones at k = 32, 48, 64) twice, and a
    read with code bytes above 3 (the reference's u32 arithmetic)."""
    rng = np.random.default_rng(k)
    B, L = 24, 140
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    lengths[:4] = [0, k - 1, k, L]
    if k % 2 == 0:
        pal = np.r_[np.full(k // 2, 3), np.zeros(k // 2)].astype(np.uint8)
        codes[4, 3 : 3 + k] = pal
        codes[5, 40 : 40 + k] = pal
        lengths[4:6] = L
    codes[6, 10:14] = [4, 7, 255, 4]
    return codes, lengths


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k", SCAN_K)
def test_kmer_scan_and_count_match_reference(k):
    codes, lengths = _scan_case(k)
    rc_, rrc, rv = (np.asarray(a) for a in ref_kmer.kmer_scan(codes, lengths, k))
    canon, is_rc, valid = kmer.kmer_scan_words(_t(codes), _t(lengths), k)
    assert canon.dtype == torch.int32 and canon.shape == rc_.shape
    np.testing.assert_array_equal(canon.numpy().view(np.uint32), rc_)  # every position
    np.testing.assert_array_equal(is_rc.numpy(), rrc)
    np.testing.assert_array_equal(valid.numpy(), rv)
    assert is_rc.any() and not is_rc.all()

    ru, rn = ref_count.count_batch(rc_, rv)
    uniq, counts = count.count_batch(canon, valid)
    assert uniq.dtype == torch.int32 and counts.dtype == torch.int64
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(counts.numpy(), rn)
    if k in (32, 48, 64):  # the palindrome's all-ones top word counts, twice
        top = ru[:, -1] == 0xFFFFFFFF
        assert top.any() and (rn[top] >= 2).any()


@pytest.mark.parametrize("k", [15, 33, 64])
def test_count_batch_empty_and_duplicates(k):
    W = (k + 15) // 16
    rng = np.random.default_rng(100 + k)
    canon = rng.integers(0, 1 << 32, (6, 9, W), dtype=np.uint64).astype(np.uint32)
    none = np.zeros((6, 9), bool)
    ru, rn = ref_count.count_batch(canon, none)
    uniq, counts = count.count_batch(_t(canon.view(np.int32)), _t(none))
    assert tuple(uniq.shape) == ru.shape == (0, W) and tuple(counts.shape) == rn.shape == (0,)
    # duplicate-heavy: 8 distinct rows (one with all-ones words) over 400 slots
    pool = rng.integers(0, 1 << 32, (8, W), dtype=np.uint64).astype(np.uint32)
    pool[0] = 0xFFFFFFFF
    dup = pool[rng.integers(0, 8, (20, 20))]
    valid = rng.random((20, 20)) < 0.9
    ru, rn = ref_count.count_batch(dup, valid)
    uniq, counts = count.count_batch(_t(dup.view(np.int32)), _t(valid))
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(counts.numpy(), rn)
    assert rn.sum() == valid.sum() and len(rn) == 8


@pytest.mark.parametrize("sorted_runs", [True, False])
def test_merge_counts_matches_reference(sorted_runs):
    rng = np.random.default_rng(7)
    parts = []
    for n in (0, 50, 300, 1):
        w = rng.integers(0, 6, (n, 3), dtype=np.uint64).astype(np.uint32)
        c = rng.integers(1, 9, n).astype(np.int64)
        if sorted_runs:
            order = np.lexsort(tuple(w[:, j] for j in range(3)))
            w, c = w[order], c[order]
            keep = np.ones(n, bool)
            keep[1:] = (w[1:] != w[:-1]).any(axis=1)
            w, c = w[keep], c[keep]
        parts.append((w, c))
    want = ref_count.merge_counts(parts)
    got = count.merge_counts(parts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() == sum(int(c.sum()) for _, c in parts)
    for a, b in zip(count.merge_counts([]), ref_count.merge_counts([])):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("k", [15, 31, 33, 63])
def test_bloom_build_words_matches_build_np(k):
    rng = np.random.default_rng(200 + k)
    W = (k + 15) // 16
    words = rng.integers(0, 1 << 32, (3000, W), dtype=np.uint64).astype(np.uint32)
    words[:, -1] &= np.uint32(ref_kmer.top_mask(k))
    valid = rng.random(3000) < 0.8
    n_words = 576  # ~7.7 bits per k-mer, off the allocation grid
    want = ref_bloom.build_np(words[valid], n_words, H, SEED, k)
    n_alloc = bloom.alloc_words(n_words)
    assert n_alloc == ref_bloom.alloc_words(n_words) > n_words
    got = bloom.bloom_build_words(state.words_to_torch(words, "cpu"), _t(valid), n_alloc,
                                  n_words, H, SEED, k).numpy().view(np.uint32)
    np.testing.assert_array_equal(got[:n_words], want)
    assert not got[n_words:].any()


def _solid_bloom(codes, lengths, k, abundance=2, seed=SEED):
    """The reference's recipe (tests/test_walk.py:24-30)."""
    canon, _, valid = ref_kmer.kmer_scan(codes, lengths, k)
    uniq, counts = ref_count.count_batch(np.asarray(canon), np.asarray(valid))
    solid = uniq[counts >= abundance]
    n_words = ref_bloom.choose_n_words(max(1, solid.shape[0]), 12.0)
    return ref_bloom.build_np(solid, n_words, H, seed, k), n_words


def _encode_both(codes, lengths, bits, n_words, k, seed=SEED):
    want = {n: np.asarray(v) for n, v in ref_walk.encode_batch(
        codes, lengths, jnp.asarray(bits), k, H, n_words, seed).items()}
    got = state.dense_from_torch(walk.encode_batch(
        _t(codes), _t(lengths), state.bitset_to_torch(bits, "cpu"), k, H, n_words, seed))
    assert list(got) == [n for n, _, _ in walk.DENSE] and set(got) == set(want)
    for n in want:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    return got


@pytest.mark.parametrize("k", [15, 31, 33, 63])
def test_encode_batch_matches_reference(sim_reads, k):
    codes, lengths = _batch(sim_reads)
    bits, n_words = _solid_bloom(codes, lengths, k)
    got = _encode_both(codes, lengths, bits, n_words, k)
    assert got["anchored"].mean() > 0.7
    assert got["nerr_r"].sum() + got["nerr_l"].sum() > 0 and got["confirmed"].any()


def test_encode_batch_short_reads_match_reference(rng):
    """tests/test_walk.py:72-91: reads < k, exactly k, and one base."""
    k = 31
    contig = rng.integers(0, 4, 300, dtype=np.uint8)
    reads = [contig[i : i + 80] for i in range(0, 200, 4)]
    reads += [contig[5:20], contig[10 : 10 + k], np.array([0], dtype=np.uint8)]
    codes, lengths = _batch(reads)
    bits, n_words = _solid_bloom(codes, lengths, k, seed=1)
    got = _encode_both(codes, lengths, bits, n_words, k, seed=1)
    assert not got["anchored"][-3] and not got["anchored"][-1] and got["anchored"][-2]


def _quals(reads):
    return [bytes([0x45 + (i % 20)] * len(r)) for i, r in enumerate(reads)]


def _encoder(cfg, meta, reads):
    bases = np.frombuffer(b"ACGT", np.uint8)
    block = bank.SeqBlock(fmt=bank.FASTQ, headers=[b"r%d" % i for i in range(len(reads))],
                          seqs=[bases[r].tobytes() for r in reads], quals=_quals(reads),
                          pluses=[None] * len(reads))
    prep = blocks.prepare_block(block, cfg.max_device_len)
    return blocks.BlockEncoder(cfg, meta, blocks.AnchorDict(2), block, prep), prep


def test_dense_and_compact_streams_agree(sim_reads):
    """The same chunks through the port's BlockEncoder, once as the dense
    dict (encode_batch) and once as the compact path (K4's plain walk_encode
    -> walk_pack -> unpack_compact): the same container streams, lossy
    qualities (the confirmed positions) included."""
    k = 31
    cfg = LeonConfig(batch_reads=48)
    codes, lengths = _batch(sim_reads)
    bits, n_words = _solid_bloom(codes, lengths, k)
    bitset = state.bitset_to_torch(bits, "cpu")
    meta = container.Meta(k=k, fmt=bank.FASTQ, qual_mode=container.QUAL_LOSSY, header_mode=0,
                          n_hashes=H, final_newline=True, n_words=n_words, seed=SEED,
                          n_reads=len(sim_reads), abundance=2)
    (dense_be, prep), (compact_be, _) = (_encoder(cfg, meta, sim_reads) for _ in range(2))
    for ch in port_pipeline.chunk_block(prep, cfg, k):
        ct, lt = _t(ch.codes), _t(ch.dev_len)
        dense = walk.unpack_dense(state.dense_from_torch(
            walk.encode_batch(ct, lt, bitset, k, H, n_words, SEED)), ch.n)
        packed = state.packed_to_torch(kmer.pack_codes_np(ch.codes), "cpu")
        buf, ce, cb = walk.encode_batch_compact_packed(packed, lt, bitset, k, H, n_words, SEED,
                                                       None, None, True, ch.L)
        compact = walk.unpack_compact(buf.numpy().view(np.uint16), ch.n, ch.codes.shape[0],
                                      ch.L, ce, cb, with_conf=True, k=k)
        for be, enc in ((dense_be, dense), (compact_be, compact)):
            be.add_subbatch(blocks.SubbatchData(codes=ch.codes, seg_len=ch.seg_len,
                                                seg_read=ch.seg_read, seg_off=ch.seg_off,
                                                n=ch.n, enc=enc))
    a, b = dense_be.finish_streams(), compact_be.finish_streams()
    assert [s for s, _, _ in a] == [s for s, _, _ in b] and len(a) > 5
    for (sa, da, ka), (sb, db, kb) in zip(a, b):
        da, db = (d() if callable(d) else d for d in (da, db))  # deferred dict payloads
        assert bytes(da) == bytes(db), sa
        assert ka.keys() == kb.keys() and all(np.array_equal(ka[x], kb[x]) for x in ka), sa
    original = np.frombuffer(b"".join(_quals(sim_reads)), np.uint8)
    assert (dense_be.qual_arr != original).any()  # confirmed positions were rewritten
    np.testing.assert_array_equal(dense_be.qual_arr, compact_be.qual_arr)


def test_entry_matches_reference():
    """The port's entry() on the CPU against __graft_entry__.entry(): the
    same example arguments (the toy batch and its bitset), and fn(*args)
    equal key by key."""
    ref_fn, ref_args = ref_entry.entry()
    fn, args = entry.entry(device="cpu")
    codes, lengths, bitset = args
    np.testing.assert_array_equal(codes.numpy(), ref_args[0])
    np.testing.assert_array_equal(lengths.numpy(), ref_args[1])
    np.testing.assert_array_equal(state.bitset_from_torch(bitset), ref_args[2])
    want = {n: np.asarray(v) for n, v in ref_fn(*ref_args).items()}
    got = state.dense_from_torch(fn(*args))
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert got["anchored"].all()


@pytest.mark.parametrize("k", [33, 63])
def test_slice_reads_to_graph(k):
    """Reads -> kmer_scan_words -> count_batch -> Graph.from_solid (CPU) ->
    successors and walk, against leon_tpu's graph of the reference's count."""
    rng = np.random.default_rng(300 + k)
    contig = rng.integers(0, 4, 260, dtype=np.uint8)
    reads = []
    for _ in range(60):
        st = int(rng.integers(0, 160))
        r = contig[st : st + 100].copy()
        r[rng.random(100) < 0.005] ^= 1
        reads.append(r if rng.random() < 0.5 else (3 - r)[::-1])
    codes, lengths = _batch(reads)
    canon, _, valid = kmer.kmer_scan_words(_t(codes), _t(lengths), k)
    uniq, counts = count.count_batch(canon, valid)
    solid = uniq.numpy().view(np.uint32)[counts.numpy() >= 2]
    rc_, _, rv = ref_kmer.kmer_scan(codes, lengths, k)
    ru, rn = ref_count.count_batch(np.asarray(rc_), np.asarray(rv))
    ref_solid = ru[rn >= 2]
    np.testing.assert_array_equal(solid, ref_solid)
    g = Graph.from_solid(solid, k, device="cpu")
    rg = ref_graph.Graph.from_solid(ref_solid, k)
    q = np.concatenate([solid, kmer.pack_codes_batch_np(contig[None, 100 : 100 + k], k)])
    np.testing.assert_array_equal(g.dbg.successors(q).numpy(), np.asarray(rg.dbg.successors(q)))
    pb, pn = g.dbg.walk(q, 40)
    wb, wn = rg.dbg.walk(q, 40)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(wn))
    assert int(pn[-1]) > 20  # a k-mer of the contig walks along it
