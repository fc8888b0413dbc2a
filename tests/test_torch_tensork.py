"""Port parity at 65 <= k <= 255 (W = 5..16 u32 words) on the tensor-level
k-mer path and the graph API's queries: kmer_scan_words (kernel K13's
plain version) against leon_tpu's kmer_scan, count_batch (sort_planes +
K14's plain version) against count_batch, the dense encode_batch (K15's
plain version) against encode_batch, every DBG node and edge query (K10)
against leon_tpu.graph.DBG, the blocked bloom.probe against bloom.probe,
the three mesh functions against leon_tpu.parallel.mesh, and the reads ->
scan -> count -> graph slice (the solid set of ``make_scene``). k = 65,
127, 128 (a palindrome with an all-ones top word) and 255; all exact
(tolerance 0), inputs made from numpy seeds. Also the W = 17 and k = 256
guards. walk, traverse and the Graph facade: test_torch_tensork_walk.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leon_tpu import graph as ref_graph
from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu.ops import walk as ref_walk
from leon_tpu.parallel import mesh as ref_mesh
from leon_tpu_torch import graph, state
from leon_tpu_torch.ops import bloom, count, kmer, walk
from leon_tpu_torch.parallel import mesh
from test_torch_widek import _palindrome

H, SEED = 4, 0x1234ABCD
KS = [65, 127, 128, 255]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_graph.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_case(k):
    """Ragged reads (0, < k, exactly k, full), base bytes past a read's
    end, at even k the palindrome T^(k/2) A^(k/2) twice (its top word is
    all ones at k = 128), and code bytes above 3 (the reference's u32
    arithmetic)."""
    rng = np.random.default_rng(k)
    B, L = 16, k + 40
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    lengths[:4] = [0, k - 1, k, L]
    if k % 2 == 0:
        codes[4, 3 : 3 + k] = _palindrome(k)
        codes[5, 20 : 20 + k] = _palindrome(k)
        lengths[4:6] = L
    codes[6, 10:14] = [4, 7, 255, 4]
    return codes, lengths


def _reads(k, seed, n=40, extra=60, contig_len=None, err=0.005):
    """n reads of k + extra bases from a random contig, half reverse-
    complemented, few substitutions: (codes, lengths, contig)."""
    rng = np.random.default_rng(seed)
    L = k + extra
    contig = rng.integers(0, 4, contig_len or L + 80, dtype=np.uint8)
    codes = np.zeros((n, L), np.uint8)
    for i in range(n):
        st = int(rng.integers(0, contig.size - L + 1))
        r = contig[st : st + L].copy()
        r[rng.random(L) < err] ^= 1
        codes[i] = r if i % 2 == 0 else (3 - r)[::-1]
    return codes, np.full(n, L, np.int32), contig


# ---------------------------------------------------------------------------
# K13 and count_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_kmer_scan_and_count_match_reference(k):
    codes, lengths = _scan_case(k)
    rc_, rrc, rv = (np.asarray(a) for a in ref_kmer.kmer_scan(codes, lengths, k))
    canon, is_rc, valid = kmer.kmer_scan_words(_t(codes), _t(lengths), k)
    assert canon.dtype == torch.int32 and canon.shape == rc_.shape
    assert rc_.shape[2] == (k + 15) // 16
    np.testing.assert_array_equal(canon.numpy().view(np.uint32), rc_)  # every position
    np.testing.assert_array_equal(is_rc.numpy(), rrc)
    np.testing.assert_array_equal(valid.numpy(), rv)
    assert is_rc.any() and not is_rc.all()

    ru, rn = ref_count.count_batch(rc_, rv)
    uniq, counts = count.count_batch(canon, valid)
    assert uniq.dtype == torch.int32 and counts.dtype == torch.int64
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(counts.numpy(), rn)
    if k == 128:  # the palindrome's all-ones top word counts, twice
        top = ru[:, -1] == 0xFFFFFFFF
        assert top.any() and (rn[top] >= 2).any()


@pytest.mark.parametrize("k", [65, 255])
def test_count_batch_empty_and_duplicates(k):
    W = (k + 15) // 16
    rng = np.random.default_rng(100 + k)
    canon = rng.integers(0, 1 << 32, (6, 9, W), dtype=np.uint64).astype(np.uint32)
    none = np.zeros((6, 9), bool)
    ru, rn = ref_count.count_batch(canon, none)
    uniq, counts = count.count_batch(_t(canon.view(np.int32)), _t(none))
    assert tuple(uniq.shape) == ru.shape == (0, W) and tuple(counts.shape) == rn.shape == (0,)
    # duplicate-heavy: 8 distinct rows (one with an all-ones top word, as a
    # palindrome at k = 16W has, two equal but for word 0). A row of all
    # ones in every word is no canonical k-mer (TT..T's is AA..A), and the
    # reference's count ties it with its invalid marker (ROADMAP queue 3).
    pool = rng.integers(0, 1 << 32, (8, W), dtype=np.uint64).astype(np.uint32)
    pool[0, -1] = 0xFFFFFFFF
    pool[2, 1:] = pool[1, 1:]
    dup = pool[rng.integers(0, 8, (20, 20))]
    valid = rng.random((20, 20)) < 0.9
    ru, rn = ref_count.count_batch(dup, valid)
    uniq, counts = count.count_batch(_t(dup.view(np.int32)), _t(valid))
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(counts.numpy(), rn)
    assert rn.sum() == valid.sum() and len(rn) == 8


# ---------------------------------------------------------------------------
# K15: the dense encode
# ---------------------------------------------------------------------------


def _solid_bloom(codes, lengths, k, abundance=2):
    """The reference's recipe (tests/test_walk.py:24-30)."""
    canon, _, valid = ref_kmer.kmer_scan(codes, lengths, k)
    uniq, counts = ref_count.count_batch(np.asarray(canon), np.asarray(valid))
    solid = uniq[counts >= abundance]
    n_words = ref_bloom.choose_n_words(max(1, solid.shape[0]), 12.0)
    return ref_bloom.build_np(solid, n_words, H, SEED, k), n_words


@pytest.mark.parametrize("k", KS)
def test_encode_batch_matches_reference(k):
    codes, lengths, _ = _reads(k, 200 + k, err=0.4 / k)  # ~0.4 errors a k-mer
    lengths[:3] = [k - 1, k, k + 1]  # no k-mer, one, two
    codes[:3][np.arange(codes.shape[1])[None, :] >= lengths[:3, None]] = 0
    bits, n_words = _solid_bloom(codes, lengths, k)
    want = {n: np.asarray(v) for n, v in ref_walk.encode_batch(
        codes, lengths, jnp.asarray(bits), k, H, n_words, SEED).items()}
    got = state.dense_from_torch(walk.encode_batch(
        _t(codes), _t(lengths), state.bitset_to_torch(bits, "cpu"), k, H, n_words, SEED))
    assert list(got) == [n for n, _, _ in walk.DENSE] and set(got) == set(want)
    for n in want:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert got["anchored"].mean() > 0.6 and not got["anchored"][0]
    assert got["nerr_r"].sum() + got["nerr_l"].sum() > 0 and got["confirmed"].any()


# ---------------------------------------------------------------------------
# K10: the node and edge queries (walk, traverse and the Graph facade:
# tests/test_torch_tensork_walk.py)
# ---------------------------------------------------------------------------


def _node(seq, pos, k):
    return ref_kmer.pack_codes_batch_np(seq[None, pos : pos + k], k)


def make_scene(k):
    """A contig (2k + 160 bp), a SNP variant of it (the bubble) and an arm
    that leaves the contig and dead-ends 8 bases later (the tip), each
    three times, counted by the port (K13 + count_batch) and by the
    reference: the slice's solid sets must be equal. Queries: nodes before
    the bubble and the tip (so a short traversal meets both), every solid
    node, and random words with garbage above bit 2k."""
    rng = np.random.default_rng(1000 + k)
    contig = rng.integers(0, 4, 2 * k + 160, dtype=np.uint8)
    snp = k + 60
    variant = contig.copy()
    variant[snp] = (variant[snp] + 1) & 3
    tip = np.concatenate([contig[20 : 20 + k + 5], rng.integers(0, 4, 8, dtype=np.uint8)])
    seqs = [contig] * 3 + [variant] * 3 + [tip] * 3
    codes = np.zeros((len(seqs), contig.size), np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = s
    lengths = np.array([len(s) for s in seqs], np.int32)
    rc_, _, rv = ref_kmer.kmer_scan(codes, lengths, k)
    ru, rn = ref_count.count_batch(np.asarray(rc_), np.asarray(rv))
    solid = np.asarray(ru)[np.asarray(rn) >= 2]
    canon, _, valid = kmer.kmer_scan_words(_t(codes), _t(lengths), k)
    uniq, counts = count.count_batch(canon, valid)
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32)[counts.numpy() >= 2], solid)
    n_words = ref_bloom.choose_n_words(len(solid), 64.0)  # few false branches in a bubble
    bits = ref_bloom.build_np_classic(solid, n_words, H, SEED, k)
    W = solid.shape[1]
    junk = rng.integers(0, 1 << 32, (24, W), dtype=np.uint64).astype(np.uint32)
    starts = np.concatenate([_node(contig, p, k) for p in (0, snp - k, 24, snp - k - 3)])
    return dict(
        k=k, solid=solid, n_words=n_words, bits=bits,
        ref=ref_graph.DBG(bitset=jnp.asarray(bits), k=k, n_hashes=H, n_words=n_words,
                          seed=SEED),
        port=state.dbg_from_reference(bits, k, H, n_words, SEED, "cpu"),
        queries=np.concatenate([starts, solid, junk]), starts=starts)


@pytest.fixture(scope="module", params=KS)
def scene(request):
    return make_scene(request.param)


@pytest.mark.parametrize("query", ["contains", "successors", "predecessors", "out_degree",
                                   "in_degree", "is_branching"])
def test_node_and_edge_queries(scene, query):
    q = scene["queries"]
    want = np.asarray(getattr(scene["ref"], query)(q))
    got = getattr(scene["port"], query)(q)
    np.testing.assert_array_equal(got.numpy(), want)
    if query == "contains":
        n0 = len(scene["starts"])
        assert want[n0 : n0 + len(scene["solid"])].all()
    if query == "is_branching":
        assert want.any() and not want.all()


def test_blocked_probe_matches_reference(scene):
    """bloom.probe (K10's blocked self mode), as the compressor's filter
    is probed, over the solid set and random words."""
    k, solid = scene["k"], scene["solid"]
    n_words = ref_bloom.choose_n_words(len(solid), 6.0)
    bits = ref_bloom.build_np(solid, n_words, H, SEED, k)
    q = scene["queries"]
    want = np.asarray(ref_bloom.probe(jnp.asarray(bits), jnp.asarray(q), H, n_words, SEED, k))
    got = bloom.probe(state.bitset_to_torch(bits, "cpu"), state.words_to_torch(q, "cpu"), H,
                      n_words, SEED, k)
    np.testing.assert_array_equal(got.numpy(), want)
    n0 = len(scene["starts"])
    assert want[n0 : n0 + len(solid)].all()


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

EIGHT = ["cpu"] * 8


@pytest.mark.parametrize("k", [65, 128, 255])
def test_mesh_matches_reference(k):
    """sharded_bloom_build (K16 per shard), the sharded counter (K13) and
    encoder (K15) over eight CPU shards against leon_tpu's mesh over the
    eight virtual JAX devices and against one shard. The bitset is held
    against the reference's build_np; against its sharded build too, but
    at k = 255 that program compiles for about a minute."""
    codes, lengths, _ = _reads(k, 300 + k, n=32, contig_len=k + 400, err=0.4 / k)
    n_words = 2047
    canon, _, valid = ref_kmer.kmer_scan(codes, lengths, k)
    ru, rn = ref_count.count_batch(np.asarray(canon), np.asarray(valid))
    solid = ru[rn >= 2]
    want = np.pad(ref_bloom.build_np(solid, n_words, H, SEED, k),
                  (0, ref_bloom.alloc_words(n_words) - n_words))
    if k != 255:
        np.testing.assert_array_equal(np.asarray(ref_mesh.sharded_bloom_build(
            ref_mesh.make_mesh(8), solid, n_words, H, SEED, k)), want)
    for devs in (EIGHT, ["cpu"]):
        reps = mesh.sharded_bloom_build(mesh.make_mesh(devices=devs), solid, n_words, H, SEED, k)
        assert len(reps) == len(devs)
        for rep in reps:
            np.testing.assert_array_equal(state.bitset_from_torch(rep), want)

    wants = [np.asarray(a) for a in ref_mesh.make_sharded_counter(ref_mesh.make_mesh(8), k)(
        codes, lengths)]
    one = mesh.make_sharded_counter(mesh.make_mesh(devices=["cpu"]), k)(codes, lengths)
    got = mesh.make_sharded_counter(mesh.make_mesh(devices=EIGHT), k)(codes, lengths)
    for g, o, w in zip(got, one, wants):
        gn = g.numpy().view(np.uint32) if g.dtype == torch.int32 else g.numpy()
        np.testing.assert_array_equal(gn, w)
        assert torch.equal(g, o)

    bits = want[:n_words]
    wenc = ref_mesh.make_sharded_encoder(ref_mesh.make_mesh(8), k, H, n_words, SEED)(
        codes, lengths, jnp.asarray(bits))
    bt = state.bitset_to_torch(bits, "cpu")
    genc = state.dense_from_torch(mesh.make_sharded_encoder(
        mesh.make_mesh(devices=EIGHT), k, H, n_words, SEED)(codes, lengths, bt))
    oenc = state.dense_from_torch(mesh.make_sharded_encoder(
        mesh.make_mesh(devices=["cpu"]), k, H, n_words, SEED)(codes, lengths, bt))
    assert set(genc) == set(wenc)
    for n, v in wenc.items():
        np.testing.assert_array_equal(genc[n], np.asarray(v), err_msg=n)
        np.testing.assert_array_equal(oenc[n], genc[n], err_msg=n)
    assert genc["anchored"].mean() > 0.5


# ---------------------------------------------------------------------------
# the guards
# ---------------------------------------------------------------------------


def test_width_guards():
    """k = 256 (W = 17) is refused by every wrapper of the slice, as
    LeonConfig refuses it; k = 255 is taken."""
    codes = torch.zeros(2, 300, dtype=torch.uint8)
    lengths = torch.full((2,), 300, dtype=torch.int32)
    bits = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="k=256"):
        kmer.kmer_scan_words(codes, lengths, 256)
    with pytest.raises(ValueError, match="W <= 16"):
        count.count_batch(torch.zeros(2, 3, 17, dtype=torch.int32),
                          torch.ones(2, 3, dtype=torch.bool))
    with pytest.raises(ValueError, match="W=17"):
        count.runs_words(state.words_to_planes(torch.zeros(4, 17, dtype=torch.int32)), 17)
    with pytest.raises(ValueError, match="k=256"):
        walk.encode_batch(codes, lengths, bits, 256, H, 64, SEED)
    w17 = torch.zeros(3, 17, dtype=torch.int32)
    with pytest.raises(ValueError, match="k=256"):
        bloom.dbg_probe(bits, w17, "out", True, H, 64, SEED, 256)
    with pytest.raises(ValueError, match="k=256"):
        graph.dbg_walk(bits, w17, H, 64, SEED, 256, 4)
    with pytest.raises(ValueError, match="k=256"):
        graph.dbg_traverse(bits, w17, H, 64, SEED, 256, 4, 3)
    with pytest.raises(ValueError, match="k=256"):
        graph.Graph.from_solid(np.zeros((4, 17), np.uint32), 256, device="cpu")
    with pytest.raises(ValueError, match="k=256"):
        mesh.sharded_bloom_build(mesh.make_mesh(devices=["cpu"]), np.zeros((4, 17), np.uint32),
                                 64, H, SEED, 256)
    with pytest.raises(ValueError, match="k=256"):
        mesh.make_sharded_counter(mesh.make_mesh(devices=["cpu"]), 256)(codes, lengths)
    canon, _, valid = kmer.kmer_scan_words(codes, lengths, 255)
    assert canon.shape == (2, 46, 16) and bool(valid.all())
