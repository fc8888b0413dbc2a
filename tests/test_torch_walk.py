"""Port parity: the walk encode (kernel K4's plain path: walk_encode +
walk_pack) against leon_tpu's encode_batch_compact_packed at the same
caps, and the decode re-walk against decode_batch_flat_packed, exact.
Batches hold short, all-N (code 0) and pad lanes; one width has
ME = L - k > 255 (the 6-u16 scal layout)."""

import numpy as np
import pytest
import torch

from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu.ops import walk as ref_walk
from leon_tpu_torch import state
from leon_tpu_torch.ops import walk

K, H, SEED = 31, 4, 0x1234ABCD
B = 64


def _case(L, seed):
    """(codes, lengths, bitset, n_words): reads from a contig whose
    k-mers fill a lean Bloom filter (false positives make bifurcations)."""
    rng = np.random.default_rng(seed)
    contig = rng.integers(0, 4, 2 * L + 200, dtype=np.uint8)
    codes = np.zeros((B, L), np.uint8)
    lengths = rng.integers(K + 1, L + 1, B).astype(np.int32)
    lengths[:4] = [L, K - 3, K, 0]  # full, short, exactly k, pad
    lengths[-6:] = 0  # pad lanes
    for i in range(B):
        st = rng.integers(0, contig.size - L)
        r = contig[st : st + L].copy()
        mut = rng.random(L) < 0.03
        r[mut] = (r[mut] + rng.integers(1, 4, int(mut.sum()))) & 3
        if i % 2:
            r = (3 - r)[::-1]
        codes[i, : lengths[i]] = r[: lengths[i]]
    codes[5, : lengths[5]] = 0  # all-N read (exceptions substituted by A)
    win = np.lib.stride_tricks.sliding_window_view(contig, K)
    solid, _ = ref_kmer.kmer_words_batch_np(win, np.zeros(win.shape[0], np.int64), K)
    n_words = ref_bloom.choose_n_words(solid.shape[0], 5.0)
    bitset = ref_bloom.build_np(solid, n_words, H, SEED, K)
    return codes, lengths, bitset, n_words


def _ref_bitset(bitset, n_words):
    return np.pad(bitset, (0, ref_bloom.alloc_words(n_words) - n_words))


@pytest.mark.parametrize("L,with_conf", [(104, True), (104, False), (296, True)])
def test_encode_buffer_matches_reference(L, with_conf):
    codes, lengths, bitset, n_words = _case(L, L + with_conf)
    packed = ref_kmer.pack_codes_np(codes)
    cap_err = cap_bif = (L - K) * B  # never overflows
    ref = np.asarray(ref_walk.encode_batch_compact_packed(
        packed, lengths, _ref_bitset(bitset, n_words), K, H, np.uint32(n_words), SEED,
        cap_err, cap_bif, with_conf, L)).astype(np.uint16)
    tp = state.packed_to_torch(packed, "cpu")
    tl = torch.from_numpy(lengths)
    tb = state.bitset_to_torch(bitset, "cpu")
    got, ce, cb = walk.encode_batch_compact_packed(tp, tl, tb, K, H, n_words, SEED,
                                                   cap_err, cap_bif, with_conf, L)
    assert (ce, cb) == (cap_err, cap_bif)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), ref)
    enc = walk.unpack_compact(ref, B, B, L, cap_err, cap_bif, with_conf, K)
    assert enc["anchored"].sum() > B // 2 and len(enc["bif_flat"]) and len(enc["errgap_flat"])
    assert ref.size == walk.pack_len(B, L, K, cap_err, cap_bif, with_conf)  # 6 u16/read if ME > 255
    # exact caps (the pipeline's choice) give the same streams
    got2, ce2, cb2 = walk.encode_batch_compact_packed(tp, tl, tb, K, H, n_words, SEED,
                                                      None, None, with_conf, L)
    enc2 = walk.unpack_compact(got2.numpy().view(np.uint16), B, B, L, ce2, cb2, with_conf, K)
    assert ce2 == -(-len(enc["errgap_flat"]) // 8) * 8
    for key in ("anchored", "apos", "nerr_r", "nbif_l", "errgap_flat", "errnt_flat",
                "bif_flat", "conf16"):
        np.testing.assert_array_equal(enc2[key], enc[key])


@pytest.mark.parametrize("L", [104, 296])
def test_decode_matches_reference(L):
    codes, lengths, bitset, n_words = _case(L, L + 7)
    packed = ref_kmer.pack_codes_np(codes)
    cap_err = cap_bif = (L - K) * B
    buf = np.asarray(ref_walk.encode_batch_compact_packed(
        packed, lengths, _ref_bitset(bitset, n_words), K, H, np.uint32(n_words), SEED,
        cap_err, cap_bif, False, L)).astype(np.uint16)
    enc = walk.unpack_compact(buf, B, B, L, cap_err, cap_bif, False, K)
    anch = enc["anchored"]
    canon, orient = ref_kmer.kmer_words_batch_np(codes, enc["apos"].astype(np.int64), K)
    afwd = np.where(orient[:, None], ref_kmer.revcomp_words_batch_np(canon, K), canon)
    et = enc["nerr_r"] + enc["nerr_l"]
    bt = enc["nbif_r"] + enc["nbif_l"]
    scal = np.zeros((B, 11), np.int32)
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
        _ref_bitset(bitset, n_words), K, H, np.uint32(n_words), SEED, L, 2))
    got = walk.walk_decode(torch.from_numpy(scal), torch.from_numpy(eg), torch.from_numpy(en),
                           torch.from_numpy(bf), state.bitset_to_torch(bitset, "cpu"),
                           n_words, K, H, SEED, L)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    dec = walk.unpack_codes_u32_np(got.numpy().view(np.uint32), L)
    for i in np.flatnonzero(anch):
        np.testing.assert_array_equal(dec[i, : lengths[i]], codes[i, : lengths[i]])
