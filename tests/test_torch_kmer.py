"""Port parity: k-mer scan (kernel K1's plain path) against leon_tpu's
kmer_scan_packed, exact, on random reads with short and pad lanes."""

import numpy as np
import pytest
import torch

from leon_tpu.ops import kmer as ref_kmer
from leon_tpu_torch import state
from leon_tpu_torch.ops import kmer

B, L = 48, 40


def _batch(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = [L, 0, 5]
    lengths[-4:] = 0  # pad lanes
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return codes, lengths


@pytest.mark.parametrize("k", [15, 16, 31])
def test_kmer_scan_matches_reference(k):
    codes, lengths = _batch(k)
    packed = ref_kmer.pack_codes_np(codes)
    canon, _is_rc, valid = ref_kmer.kmer_scan_packed(packed, lengths, k, L)
    canon, valid = np.asarray(canon), np.asarray(valid)
    P = L - k + 1
    want = state.words_to_keys(canon.reshape(-1, canon.shape[-1]))
    want = np.where(valid.reshape(-1), want, kmer.SENTINEL)
    got = kmer.kmer_scan(state.packed_to_torch(packed, "cpu"),
                         torch.from_numpy(lengths), k, L)
    assert got.shape == (B * P,)
    np.testing.assert_array_equal(got.numpy(), want)
    # signed int64 key order == the reference's MSW-first word order
    v = valid.reshape(-1)
    words = canon.reshape(-1, canon.shape[-1])[v]
    ref_order = np.lexsort(tuple(words[:, j] for j in range(words.shape[1])))
    np.testing.assert_array_equal(np.sort(want[v]), want[v][ref_order])


def test_kmer_scan_out_slab_view():
    codes, lengths = _batch(7)
    packed = state.packed_to_torch(ref_kmer.pack_codes_np(codes), "cpu")
    k = 21
    n = B * (L - k + 1)
    slab = torch.full((n + 10,), -1, dtype=torch.int64)
    kmer.kmer_scan(packed, torch.from_numpy(lengths), k, L, out=slab[5:5 + n])
    np.testing.assert_array_equal(
        slab[5:5 + n].numpy(), kmer.kmer_scan_plain(packed, torch.from_numpy(lengths), k, L).numpy())
    assert (slab[:5] == -1).all() and (slab[5 + n:] == -1).all()


def test_host_half_matches_reference():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (20, 50), dtype=np.uint8)
    pos = rng.integers(0, 50 - 31, 20)
    for k in (15, 31, 40):
        a = kmer.kmer_words_batch_np(codes, pos, k)
        b = ref_kmer.kmer_words_batch_np(codes, pos, k)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        w = a[0]
        np.testing.assert_array_equal(kmer.revcomp_words_batch_np(w, k),
                                      ref_kmer.revcomp_words_batch_np(w, k))
    np.testing.assert_array_equal(kmer.pack_codes_np(codes), ref_kmer.pack_codes_np(codes))
    assert kmer.pack_2bit_np(codes[0]) == ref_kmer.pack_2bit_np(codes[0])
