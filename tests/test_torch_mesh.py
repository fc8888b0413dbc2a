"""Port parity, mesh: the port's sharded Bloom build, lane-sharded counter
and encoder over eight CPU shards (a device list with repeats) against
leon_tpu.parallel.mesh over the eight virtual JAX devices
(tests/conftest.py) and against one shard, exact; and the port's dryrun
(steps 1-3 of __graft_entry__.dryrun_multichip) against the same steps
taken with the reference, and its steps 4-5 (the product path on the
mesh)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu.ops import walk as ref_walk
from leon_tpu.parallel import mesh as ref_mesh
from leon_tpu_torch import entry, state
from leon_tpu_torch.ops import count
from leon_tpu_torch.parallel import mesh

EIGHT = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def read_batch(rng):
    """tests/test_parallel.py:13-22."""
    B, L = 64, 128
    contig = rng.integers(0, 4, 2000, dtype=np.uint8)
    codes = np.zeros((B, L), dtype=np.uint8)
    lengths = np.full(B, 100, dtype=np.int32)
    for i in range(B):
        st = int(rng.integers(0, 1900))
        codes[i, :100] = contig[st : st + 100]
    return codes, lengths


def _solid(codes, lengths, k):
    canon, _, valid = ref_kmer.kmer_scan(codes, lengths, k)
    uniq, counts = ref_count.count_batch(np.asarray(canon), np.asarray(valid))
    return uniq[counts >= 2]


def test_make_mesh_and_uneven_lanes(read_batch):
    m = mesh.make_mesh(devices=EIGHT)
    assert m.size == 8 and all(d.type == "cpu" for d in m.devices)
    assert mesh.make_mesh(3, devices=EIGHT).size == 3
    codes, lengths = read_batch
    with pytest.raises(ValueError, match="split evenly"):
        mesh.make_sharded_counter(mesh.make_mesh(devices=["cpu"] * 3), 31)(codes, lengths)
    with pytest.raises(ValueError, match="split evenly"):
        mesh.make_sharded_encoder(mesh.make_mesh(devices=["cpu"] * 5), 31, 4, 64, 5)(
            codes, lengths, torch.zeros(64, dtype=torch.int32))


@pytest.mark.parametrize("k", [31, 33])
def test_sharded_bloom_matches_reference(read_batch, k):
    codes, lengths = read_batch
    H, seed, n_words = 4, 5, 2047
    solid = _solid(codes, lengths, k)
    want = np.asarray(ref_mesh.sharded_bloom_build(ref_mesh.make_mesh(8), solid, n_words, H,
                                                   seed, k))
    host = ref_bloom.build_np(solid, n_words, H, seed, k)
    np.testing.assert_array_equal(want[:n_words], host)
    for devs in (EIGHT, ["cpu"]):
        reps = mesh.sharded_bloom_build(mesh.make_mesh(devices=devs), solid, n_words, H, seed, k)
        assert len(reps) == len(devs)
        for rep in reps:
            got = state.bitset_from_torch(rep)
            assert got.shape == want.shape == (ref_bloom.alloc_words(n_words),)
            np.testing.assert_array_equal(got, want)
            assert not got[n_words:].any()


def test_sharded_counter_matches_reference(read_batch):
    codes, lengths = read_batch
    k = 31
    want = [np.asarray(a) for a in ref_mesh.make_sharded_counter(ref_mesh.make_mesh(8), k)(
        codes, lengths)]
    one = mesh.make_sharded_counter(mesh.make_mesh(devices=["cpu"]), k)(codes, lengths)
    got = mesh.make_sharded_counter(mesh.make_mesh(devices=EIGHT), k)(codes, lengths)
    for g, o, w in zip(got, one, want):
        gn = g.numpy().view(np.uint32) if g.dtype == torch.int32 else g.numpy()
        np.testing.assert_array_equal(gn, w)
        assert torch.equal(g, o)
    uniq, counts = count.count_batch(got[0], got[2])
    ru, rn = ref_count.count_batch(want[0], want[2])
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(counts.numpy(), rn)


def test_sharded_encoder_matches_reference(read_batch):
    """tests/test_parallel.py:44-66, all 15 keys, and one shard."""
    codes, lengths = read_batch
    k, H, seed = 31, 4, 5
    solid = _solid(codes, lengths, k)
    n_words = ref_bloom.choose_n_words(max(1, len(solid)), 12.0)
    bits = ref_bloom.build_np(solid, n_words, H, seed, k)
    want = ref_mesh.make_sharded_encoder(ref_mesh.make_mesh(8), k, H, n_words, seed)(
        codes, lengths, jnp.asarray(bits))
    want = {n: np.asarray(v) for n, v in want.items()}
    single = {n: np.asarray(v) for n, v in ref_walk.encode_batch(
        codes, lengths, jnp.asarray(bits), k, H, n_words, seed).items()}
    bt = state.bitset_to_torch(bits, "cpu")
    got = state.dense_from_torch(mesh.make_sharded_encoder(
        mesh.make_mesh(devices=EIGHT), k, H, n_words, seed)(codes, lengths, bt))
    one = state.dense_from_torch(mesh.make_sharded_encoder(
        mesh.make_mesh(devices=["cpu"]), k, H, n_words, seed)(codes, lengths, bt))
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        np.testing.assert_array_equal(got[n], single[n], err_msg=n)
        np.testing.assert_array_equal(one[n], want[n], err_msg=n)
    assert got["anchored"].mean() > 0.8


def test_dryrun_matches_reference_steps():
    """entry.dryrun on four CPU shards: the reference's dryrun_multichip
    steps 1-3 taken with leon_tpu on the same toy batch give the same count,
    bitset (every replica) and encode."""
    (uniq, counts), reps, enc = entry.dryrun(["cpu"] * 4)
    k, H, seed, B, L = 15, 4, 0x1234ABCD, 8, 48
    codes, lengths = ref_entry._toy_batch(B, L, k)
    canon, _, valid = ref_kmer.kmer_scan(codes, lengths, k)
    ru, rn = ref_count.count_batch(np.asarray(canon), np.asarray(valid))
    np.testing.assert_array_equal(uniq.numpy().view(np.uint32), ru)
    np.testing.assert_array_equal(counts.numpy(), rn)
    bits = np.asarray(ref_mesh.sharded_bloom_build(ref_mesh.make_mesh(4), ru[rn >= 2], 2048, H,
                                                   seed, k))
    assert len(reps) == 4
    for rep in reps:
        np.testing.assert_array_equal(state.bitset_from_torch(rep), bits)
    want = ref_walk.encode_batch(codes, lengths, jnp.asarray(bits), k, H, 2048, seed)
    got = state.dense_from_torch(enc)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], np.asarray(v), err_msg=n)


def test_dryrun_product_steps_detect_a_wrong_shard_order(monkeypatch):
    """entry.dryrun's steps 4-5 on eight CPU shards pass; with the shards'
    encodings joined out of lane order the mesh archive is no longer the
    one-device archive, and dryrun raises."""
    entry.dryrun(EIGHT)
    from leon_tpu_torch import pipeline

    walk_chunk = pipeline._walk_chunk

    def swapped(ch, shards, *args):
        return walk_chunk(ch, shards[::-1], *args) if len(shards) > 1 else walk_chunk(
            ch, shards, *args)

    monkeypatch.setattr(pipeline, "_walk_chunk", swapped)
    with pytest.raises(AssertionError, match="mesh archive != single-device archive"):
        entry.dryrun(EIGHT)
