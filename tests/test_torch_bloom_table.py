"""K16 `bloom_build_words` as a table hash: a numpy model of its arithmetic
(csrc/kmer_words.cuh hash_kmer_tab: hash family v4 a word at a time from
eight 16-entry (f, r) nibble tables, the top word masked to 2k bits, the
code-0 bases above k cancelled by padf / padr, even and odd words summed
apart and rotated once) against leon_tpu's hash_words at every width
W = 1..16, at k = 16W - 15, 16W - 1 and 16W, on random words with garbage
above 2k in the top word; then K16's plain version against the builds it
replaces, leon_tpu's build_device and mesh._bloom_words_local (run op by op:
their jitted programs take a minute to compile at k = 255), at W = 2, 4, 8
and 16 with H = 1..8 and n_words = 64, so that many rows share a word.
Everything is integer: the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.parallel import mesh as ref_mesh
from leon_tpu_torch import state
from leon_tpu_torch.ops import bloom, kmer

SEED = 0x1234ABCD
u32 = np.uint32


def _rol(x, r: int):
    """u32 rotate left by r mod 32 (a negative r rotates right)."""
    r %= 32
    x = np.asarray(x, np.uint32)
    return ((x << u32(r)) | (x >> u32(32 - r))) if r else x


def nibble_tables(tab):
    """(tf, tr), each (8, 16) u32: tf[n][x] = XOR over t < 2 of
    rol(T[(x >> 2t) & 3], 2n + t), tr[n][x] the same of ror(Tc[...], 2n + t)
    (the kernel holds 16 copies of each entry, one a bank pair)."""
    x = np.arange(16)
    tf = np.zeros((8, 16), np.uint32)
    tr = np.zeros((8, 16), np.uint32)
    for n in range(8):
        for t in range(2):
            b = (x >> (2 * t)) & 3
            tf[n] ^= _rol(tab[0][b], 2 * n + t)
            tr[n] ^= _rol(tab[1][b], -(2 * n + t))
    return tf, tr


def pads(tab, k: int):
    """(padf, padr): the terms of the code-0 bases at m = k .. 16W - 1."""
    W = -(-k // 16)
    f = r = u32(0)
    for m in range(k, 16 * W):
        f ^= _rol(tab[0][0], m)
        r ^= _rol(tab[1][0], -m)
    return u32(f), u32(r)


def hash_tab_model(words, k: int, seed: int):
    """(f, r) of (n, W) u32 words as the kernel computes them."""
    tab = ref_bloom.tables(seed, k)
    tf, tr = nibble_tables(tab)
    padf, padr = pads(tab, k)
    W = words.shape[1]
    w = words.astype(np.uint32).copy()
    w[:, W - 1] &= u32(kmer.top_mask(k))
    acc_f = [np.full(len(w), padf, np.uint32), np.zeros(len(w), np.uint32)]  # even, odd words
    acc_r = [np.full(len(w), padr, np.uint32), np.zeros(len(w), np.uint32)]
    for j in range(W):
        for n in range(8):
            x = (w[:, j] >> u32(4 * n)) & u32(15)
            acc_f[j & 1] ^= tf[n][x]
            acc_r[j & 1] ^= tr[n][x]
    f = acc_f[0] ^ _rol(acc_f[1], 16)
    r = _rol(acc_r[0] ^ _rol(acc_r[1], 16), k - 1)
    return f, r


def _words(rng, n: int, W: int):
    """Random (n, W) u32 rows, every bit random: garbage above 2k included."""
    return rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(np.uint32)


TAB_CASES = [(W, k) for W in range(1, 17) for k in (16 * W - 15, 16 * W - 1, 16 * W)]


@pytest.mark.parametrize("W,k", TAB_CASES)
def test_table_hash_matches_hash_words(W, k):
    """The model equals the reference's from-scratch hash at the pad edges:
    k = 16W (no pad base), 16W - 1 (one), 16W - 15 (fifteen), on rows whose
    top words carry garbage above 2k, the all-zero and the all-ones row."""
    rng = np.random.default_rng(1000 * W + k)
    w = _words(rng, 400, W)
    w[0] = 0
    w[1] = 0xFFFFFFFF
    if k < 16 * W:
        assert (w[:, W - 1] & ~u32(kmer.top_mask(k))).any()
    f, r = hash_tab_model(w, k, SEED)
    rf, rr = ref_bloom.hash_words(w, k, SEED, np)
    np.testing.assert_array_equal(f, rf)
    np.testing.assert_array_equal(r, rr)
    # and the port's own copy of the hash, which its plain versions use
    pf, pr = bloom.hash_words(w, k, SEED)
    np.testing.assert_array_equal(f, pf)
    np.testing.assert_array_equal(r, pr)


def test_table_hash_other_seeds():
    """The tables follow the seed: three more seeds at W = 4, 8, 16."""
    rng = np.random.default_rng(5)
    for seed in (0, 1, 0xFFFFFFFF):
        for k in (63, 127, 255):
            w = _words(rng, 200, -(-k // 16))
            f, r = hash_tab_model(w, k, seed)
            rf, rr = ref_bloom.hash_words(w, k, seed, np)
            np.testing.assert_array_equal(f, rf)
            np.testing.assert_array_equal(r, rr)


N_WORDS, N_ALLOC = 64, 128
BUILD_CASES = [(k, h) for k in (31, 63, 127, 255) for h in range(1, 9)]


@pytest.mark.parametrize("k,h", BUILD_CASES)
def test_plain_build_matches_reference_builds(k, h):
    """K16's plain version over 300 rows into 64 words (hot words: about 5
    rows a word) equals build_device's bitset (its [:n_words], the rest
    zero) over the rows at or above the cutoff, and _bloom_words_local's
    partial over a sparse valid mask into 128 allocated words (64 used)."""
    W = -(-k // 16)
    rng = np.random.default_rng(17 * k + h)
    w = _words(rng, 300, W)  # garbage above 2k: the reference reads k bases
    counts = rng.integers(0, 4, 300).astype(np.int32)
    valid = counts >= 2
    tw = state.words_to_torch(w, "cpu")
    with jax.disable_jit():
        dev = np.asarray(ref_bloom.build_device(jnp.asarray(w), jnp.asarray(counts),
                                                jnp.int32(2), N_WORDS, h, SEED, k))
        part = np.asarray(ref_mesh._bloom_words_local(jnp.asarray(w), jnp.asarray(valid),
                                                      jnp.uint32(N_WORDS), N_ALLOC, h, SEED, k))
    got = bloom.bloom_build_words_plain(tw, torch.from_numpy(valid), N_WORDS, N_WORDS, h, SEED, k)
    np.testing.assert_array_equal(state.bitset_from_torch(got), dev[:N_WORDS])
    assert not dev[N_WORDS:].any()
    got = bloom.bloom_build_words_plain(tw, torch.from_numpy(valid), N_ALLOC, N_WORDS, h, SEED, k)
    np.testing.assert_array_equal(state.bitset_from_torch(got), part)
    assert part[:N_WORDS].any() and not part[N_WORDS:].any()
