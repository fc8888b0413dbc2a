"""K17 `kmer_scan_halves` (and K1's keys) as a bit extraction: a numpy model
of the kernel's design (the 2k-bit field of the packed read at bit 2p, its
complement as the reverse complement, its 2-bit groups reversed and shifted
as the forward k-mer, the lesser one MSW first) against leon_tpu's
kmer_scan_packed and the port's plain versions, on chip_smoke.py's
adversarial reads (scan_case: k = 17 .. 255, L mod 16 = 0, 1, 15, reads of
length 0, k - 1, k and L, palindromes and all-ones top words at k = 16W).
K1 `kmer_scan` (k <= 31) likewise, as one 64-bit cut a key over dense
rows: a numpy model of its arithmetic (the field's two funnel-shifted
halves, ~x masked to 2k bits as the reverse complement, rev2 of each half
with the halves swapped and shifted right by 64 - 2k as the forward key,
SENTINEL past len - k) and of its key-to-thread walk, against leon_tpu's
kmer_scan_packed and the port's kmer_scan_plain at k = 1, 2, 15, 16, 17 and
31 (chip_smoke.K1_KS). Everything is integer: the tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu_torch import state
from leon_tpu_torch.ops import kmer

M32 = np.uint64(0xFFFFFFFF)
SENTINEL = (1 << 63) - 1

# the bit-reversal of every byte, for rev2
_BREV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint32)


def _funnel_r(lo, hi, sh):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> sh, sh in 0..31."""
    return (((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64))
            >> np.asarray(sh, np.uint64)) & M32


def _rev2(x):
    """The 16 2-bit groups of u32 x in reverse order (__brev, then each bit
    pair swapped back)."""
    x = x.astype(np.uint32)
    r = ((_BREV8[x & 0xFF] << 24) | (_BREV8[(x >> 8) & 0xFF] << 16)
         | (_BREV8[(x >> 16) & 0xFF] << 8) | _BREV8[x >> 24]).astype(np.uint32)
    return ((r >> 1) & np.uint32(0x55555555)) | ((r & np.uint32(0x55555555)) << 1)


def scan_model(packed, lengths, k, L):
    """The kernel's arithmetic for every valid position, read-major: (n, W)
    u32 canonical words, and (B, P) int64 keys with SENTINEL past each
    read's last k-mer (K1's form, for k <= 31)."""
    W = -(-k // 16)
    B, L16 = packed.shape
    P = L - k + 1
    nv = np.clip(lengths.astype(np.int64) - (k - 1), 0, P)
    r = np.repeat(np.arange(B), nv)
    p = np.concatenate([np.arange(c) for c in nv]) if B else np.zeros(0, np.int64)
    a, sh = p >> 4, 2 * (p & 15)
    pad = np.concatenate([packed.astype(np.uint32), np.zeros((B, 1), np.uint32)], axis=1)
    top = np.uint64(kmer.top_mask(k))
    x = [_funnel_r(pad[r, a + i], pad[r, np.minimum(a + i + 1, L16)], sh) for i in range(W)]
    x[W - 1] &= top
    rc = [~v & M32 for v in x]
    rc[W - 1] &= top
    rv = [_rev2(x[W - 1 - j]).astype(np.uint64) for j in range(W)] + [np.zeros_like(x[0])]
    s = 2 * (16 * W - k)
    fwd = [_funnel_r(rv[j], rv[j + 1], s) for j in range(W)]
    less = np.zeros(p.size, bool)
    eq = np.ones(p.size, bool)
    for j in range(W - 1, -1, -1):
        less |= eq & (rc[j] < fwd[j])
        eq &= rc[j] == fwd[j]
    words = np.stack([np.where(less, rc[j], fwd[j]) for j in range(W)], axis=1).astype(np.uint32)
    keys = np.full((B, P), SENTINEL, np.int64)
    if W <= 2:
        keys[r, p] = words[:, 0].astype(np.int64) | (
            words[:, W - 1].astype(np.int64) << 32 if W == 2 else 0)
    return words, keys


CASES = [(k, mod) for k in chip_smoke.SCAN_KS for mod in chip_smoke.SCAN_L_MOD16]


@pytest.mark.parametrize("k,mod", CASES)
def test_scan_model_matches_reference(k, mod):
    """The model equals leon_tpu's kmer_scan_packed on its valid positions,
    the port's kmer_scan_halves_plain (planes), and at k <= 31 the
    reference's keys with SENTINEL elsewhere (K1's form, kmer_scan_plain)."""
    codes, lengths = chip_smoke.scan_case(k, mod, 24)
    L = codes.shape[1]
    assert L % 16 == mod and (lengths == 0).any() and (lengths == k - 1).any()
    packed = kmer.pack_codes_np(codes)
    words, keys = scan_model(packed, lengths, k, L)
    canon, _, valid = ref_kmer.kmer_scan_packed(jnp.asarray(packed), jnp.asarray(lengths), k, L)
    canon, valid = np.asarray(canon), np.asarray(valid)
    np.testing.assert_array_equal(words, canon[valid])
    tp, tl = state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths)
    got = kmer.kmer_scan_halves_plain(tp, tl, k, L)
    np.testing.assert_array_equal(state.planes_to_words(got, words.shape[1]).numpy().view(np.uint32),
                                  words)
    if k <= 31:
        ref_keys = np.where(valid, state.words_to_keys(canon.reshape(-1, canon.shape[-1]))
                            .reshape(valid.shape), SENTINEL)
        np.testing.assert_array_equal(keys, ref_keys)
        np.testing.assert_array_equal(kmer.kmer_scan_plain(tp, tl, k, L).numpy(), keys.reshape(-1))
    if k % 16 == 0:  # the palindromes and the all-ones top words are there
        W = k // 16
        assert (words[:, W - 1] == 0xFFFFFFFF).any()


def k1_model(packed, lengths, k, L):
    """K1's arithmetic at every position: (B, P) int64 keys, SENTINEL where
    p > len - k."""
    B, L16 = packed.shape
    P = L - k + 1
    r, p = np.divmod(np.arange(B * P), P)
    a, sh = p >> 4, 2 * (p & 15)
    pad = np.concatenate([packed.astype(np.uint32), np.zeros((B, 2), np.uint32)], axis=1)
    w0, w1, w2 = (pad[r, a + i] for i in range(3))  # words past the row read as 0
    lo, hi = _funnel_r(w0, w1, sh), _funnel_r(w1, w2, sh)
    kmask = np.uint64((1 << (2 * k)) - 1)
    rc = ~((hi << np.uint64(32)) | lo) & kmask
    fwd = ((_rev2(lo).astype(np.uint64) << np.uint64(32)) | _rev2(hi).astype(np.uint64)) \
        >> np.uint64(64 - 2 * k)
    keys = np.minimum(fwd, rc).astype(np.int64)
    keys[p > lengths[r].astype(np.int64) - k] = SENTINEL
    return keys.reshape(B, P)


def k1_walk(P, threads=256, block_keys=2048):
    """The (read, position) each thread of a K1 block visits, key by key, as
    csrc/kmer.cu steps them (dr reads and dp positions a step)."""
    R = max(1, block_keys // P)
    dr, dp = threads // P, threads % P
    seen = {}
    for t in range(threads):
        r, p = divmod(t, P)
        for i in range(t, R * P, threads):
            seen[i] = (r, p)
            p, r = p + dp, r + dr
            if p >= P:
                p, r = p - P, r + 1
    return R, seen


K1_CASES = [(k, mod) for k in chip_smoke.K1_KS for mod in chip_smoke.SCAN_L_MOD16]


@pytest.mark.parametrize("k,mod", K1_CASES)
def test_k1_model_matches_reference(k, mod):
    """K1's model equals leon_tpu's kmer_scan_packed (its canonical keys
    where valid, SENTINEL elsewhere) and the port's kmer_scan_plain on
    scan_case, reads of length 0, k - 1, k and L included; the block's
    walk visits every key of its reads once, at divmod(key, P)."""
    codes, lengths = chip_smoke.scan_case(k, mod, 24)
    L = codes.shape[1]
    assert L % 16 == mod and (lengths == 0).any() and (lengths == k).any()
    packed = kmer.pack_codes_np(codes)
    keys = k1_model(packed, lengths, k, L)
    canon, _, valid = ref_kmer.kmer_scan_packed(jnp.asarray(packed), jnp.asarray(lengths), k, L)
    canon, valid = np.asarray(canon), np.asarray(valid)
    ref_keys = np.where(valid, state.words_to_keys(canon.reshape(-1, canon.shape[-1]))
                        .reshape(valid.shape), SENTINEL)
    np.testing.assert_array_equal(keys, ref_keys)
    assert (keys == SENTINEL).any() and (keys != SENTINEL).any()
    tp, tl = state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths)
    np.testing.assert_array_equal(kmer.kmer_scan_plain(tp, tl, k, L).numpy(), keys.reshape(-1))
    P = L - k + 1
    R, seen = k1_walk(P)
    assert sorted(seen) == list(range(R * P))
    assert all(seen[i] == divmod(i, P) for i in seen)


@pytest.mark.parametrize("P", [1, 2, 73, 74, 255, 256, 257, 2047, 2048, 2049, 3000])
def test_k1_walk_covers_every_key(P):
    """The key-to-thread walk at widths around the block's thread count and
    key budget: every key of the block's R reads once, at divmod(key, P)."""
    R, seen = k1_walk(P)
    assert R == max(1, 2048 // P)
    assert sorted(seen) == list(range(R * P))
    assert all(seen[i] == divmod(i, P) for i in seen)
