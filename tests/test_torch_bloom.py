"""Port parity: the Bloom build (kernel K3's plain path) against leon_tpu's
build_device and native build_np, exact, for H in {2, 3, 4, 8}."""

import numpy as np
import pytest
import torch

from leon_tpu.ops import bloom as ref_bloom
from leon_tpu_torch import state
from leon_tpu_torch.ops import bloom

SEED = 0x1234ABCD


def _run(k, M, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << (2 * k), M, dtype=np.int64))
    counts = rng.integers(0, 6, keys.size).astype(np.int32)
    return keys, counts


@pytest.mark.parametrize("H", [2, 3, 4, 8])
def test_bloom_build_matches_reference(H):
    k = 31 if H != 3 else 15
    keys, counts = _run(k, 3000, H)
    W = (k + 15) // 16
    words = state.keys_to_words(keys, W)
    cutoff = 3
    n_words = bloom.choose_n_words(int((counts >= cutoff).sum()), 9.0)
    got = bloom.bloom_build(torch.from_numpy(keys), torch.from_numpy(counts), cutoff,
                            n_words, H, SEED, k)
    assert got.shape == (n_words,)
    got = state.bitset_from_torch(got)
    dev = np.asarray(ref_bloom.build_device(words, counts, np.int32(cutoff),
                                            n_words, H, SEED, k))
    np.testing.assert_array_equal(got, dev[:n_words])
    assert not dev[n_words:].any()
    np.testing.assert_array_equal(
        got, ref_bloom.build_np(words[counts >= cutoff], n_words, H, SEED, k))
    # host half copies agree with the reference
    np.testing.assert_array_equal(
        bloom.build_np(words[counts >= cutoff], n_words, H, SEED, k), got)
    assert ref_bloom.probe_np(got, words, H, n_words, SEED, k)[counts >= cutoff].all()


def test_plain_hash_matches_reference():
    keys, _ = _run(31, 500, 2)
    words = state.keys_to_words(keys, 2)
    f, r = bloom.hash_keys_plain(torch.from_numpy(keys), 31, bloom.tables(SEED, 31))
    rf, rr = ref_bloom.hash_words(words, 31, SEED, np)
    np.testing.assert_array_equal(f.numpy(), rf.astype(np.int64))
    np.testing.assert_array_equal(r.numpy(), rr.astype(np.int64))
    wi, mask = bloom.wordmask_plain(f, r, 8, 123456)
    rwi, rmask = ref_bloom.wordmask_from_hashes(rf, rr, 8, 123456, np)
    np.testing.assert_array_equal(wi.numpy(), rwi)
    np.testing.assert_array_equal(mask.numpy(), rmask.astype(np.int64))


def test_sizing_rules_match_reference():
    rng = np.random.default_rng(4)
    for _ in range(10):
        hist = rng.integers(0, 5000, 256)
        hist[0] = 0
        c = int(rng.integers(1, 30))
        for lossy in (False, True):
            for stored in (False, True):
                assert bloom.auto_params(hist, c, lossy, stored) == \
                    ref_bloom.auto_params(hist, c, lossy, stored)
        n = int(rng.integers(1, 10**7))
        assert bloom.choose_n_words(n, 7.5) == ref_bloom.choose_n_words(n, 7.5)
    assert (bloom.tables(5, 31) == ref_bloom.tables(5, 31)).all()
