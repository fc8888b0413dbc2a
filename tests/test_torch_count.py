"""Port parity: the slab counter (kernel K2's plain path, the Bloom build
K3, the scan K1) against leon_tpu's DeviceCounter, _merge_sorted_runs and
compact_solid, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu_torch import state
from leon_tpu_torch.ops import count
from leon_tpu_torch.ops.kmer import SENTINEL

K = 21
B, L = 64, 56


def _chunks(seed, n_chunks=4):
    """Reads from a short contig (coverage gives a real cutoff valley)."""
    rng = np.random.default_rng(seed)
    contig = rng.integers(0, 4, 300, dtype=np.uint8)
    out = []
    for _ in range(n_chunks):
        codes = np.zeros((B, L), np.uint8)
        lengths = rng.integers(K - 2, L + 1, B).astype(np.int32)
        lengths[-3:] = 0
        for i in range(B):
            st = rng.integers(0, 300 - L)
            r = contig[st : st + L].copy()
            mut = rng.random(L) < 0.02
            r[mut] = (r[mut] + 1) & 3
            if i % 2:
                r = (3 - r)[::-1]
            codes[i, : lengths[i]] = r[: lengths[i]]
        out.append((ref_kmer.pack_codes_np(codes), lengths))
    return out


@pytest.mark.parametrize("lossy", [False, True])
def test_counter_finalize_matches_reference(lossy):
    chunks = _chunks(11 + lossy)
    ref = ref_count.DeviceCounter(K, slab_kmers=1 << 12, merge_factor=2)
    port = count.DeviceCounter(K, "cpu", slab_kmers=3000, merge_factor=2)
    for packed, lengths in chunks:
        canon, _, valid = ref_kmer.kmer_scan_packed(packed, lengths, K, L)
        ref.add(canon, valid)
        port.add_packed(state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths), L)
    seed = 0x1234ABCD
    rb, rnw, rcut, rns, rhist, rH, (rwords, rcnt, rnu, _) = ref.finalize(
        None, None, None, seed, lossy, want_solid=True, unitig_max=128 << 20)
    pb, pnw, pcut, pns, phist, pH, (pkeys, pcnt, pnu) = port.finalize(
        None, None, None, seed, lossy, unitig_max=128 << 20)
    np.testing.assert_array_equal(phist, np.asarray(rhist))
    assert (pcut, pns, pnw, pH, pnu) == (rcut, rns, rnw, rH, rnu)
    assert rcut > 2 and rns > 0  # the corpus has a real valley
    np.testing.assert_array_equal(state.bitset_from_torch(pb), np.asarray(rb)[:rnw])
    # the distinct run and its solid compaction
    rc = np.asarray(rcnt)
    rw = np.asarray(rwords)[rc > 0]
    np.testing.assert_array_equal(state.keys_from_torch(pkeys, 2), rw)
    np.testing.assert_array_equal(pcnt.numpy(), rc[rc > 0])
    sk, sc = count.compact_solid(pkeys, pcnt, pcut)
    ow, oc = ref_count.compact_solid(rwords, rcnt, np.int32(rcut),
                                     ref_count._bucket_size(rns))
    np.testing.assert_array_equal(state.keys_from_torch(sk, 2), np.asarray(ow)[:rns])
    np.testing.assert_array_equal(sc.numpy(), np.asarray(oc)[:rns])


def test_empty_counter_matches_reference():
    ref = ref_count.DeviceCounter(K)
    port = count.DeviceCounter(K, "cpu")
    r = ref.finalize(None, None, None, 7, False, want_solid=True)
    p = port.finalize(None, None, None, 7, False)
    assert p[1:4] == r[1:4] and p[5] == r[5] and p[6] is None
    assert not state.bitset_from_torch(p[0]).any()


def test_merge_sorted_runs_matches_reference():
    """Count payload sums: u32 wraparound, int32 clamp, zero groups drop,
    pads (all-ones / SENTINEL, count 0) never emit."""
    rng = np.random.default_rng(5)
    n = 4096
    keys = rng.integers(0, 1 << 20, n).astype(np.int64) * 977
    counts = rng.integers(0, 5, n).astype(np.int32)
    counts[:40] = 0x7FFFFFF0  # one key's sum passes 2**32
    keys[:40] = keys[0]
    keys[-100:] = -1  # pads
    counts[-100:] = 0
    words = state.keys_to_words(np.where(keys < 0, 0, keys), 2)
    words[keys < 0] = 0xFFFFFFFF
    skeys, boundary, summed = ref_count._merge_sorted_runs(
        (jnp.asarray(words[:, 1]), jnp.asarray(words[:, 0])), jnp.asarray(counts))
    bnd = np.asarray(boundary)
    want_w = np.stack([np.asarray(skeys[1])[bnd], np.asarray(skeys[0])[bnd]], axis=1)
    want_c = np.asarray(summed)[bnd]
    tk = torch.from_numpy(np.where(keys < 0, SENTINEL, keys))
    sk, perm = torch.sort(tk)
    gk, gc, hist = count.runs(sk, torch.from_numpy(counts)[perm], 1, want_hist=True)
    np.testing.assert_array_equal(state.keys_from_torch(gk, 2), want_w)
    np.testing.assert_array_equal(gc.numpy(), want_c)
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(ref_count._hist_of_sorted(boundary, summed)))


def test_runs_raw_slab_matches_reference_sort_count():
    rng = np.random.default_rng(9)
    n = 5000
    keys = rng.integers(0, 300, n).astype(np.int64) << 33
    valid = rng.random(n) < 0.9
    words = state.keys_to_words(keys, 2)
    sk_ref, bnd, cnt = ref_count._sort_count_device(
        (jnp.asarray(words[:, 1]), jnp.asarray(words[:, 0])), jnp.asarray(valid), k=K)
    bnd = np.asarray(bnd)
    want_w = np.stack([np.asarray(sk_ref[1])[bnd], np.asarray(sk_ref[0])[bnd]], axis=1)
    tk = torch.from_numpy(np.where(valid, keys, SENTINEL))
    gk, gc, _ = count.runs(torch.sort(tk).values)
    np.testing.assert_array_equal(state.keys_from_torch(gk, 2), want_w)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(cnt)[bnd])


def test_auto_cutoff_matches_reference():
    rng = np.random.default_rng(1)
    for _ in range(20):
        hist = rng.integers(0, 1000, 256)
        hist[0] = 0
        assert count.auto_cutoff(hist) == ref_count.auto_cutoff(hist)
