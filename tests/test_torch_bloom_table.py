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
K3 `bloom_build` (k <= 31) hashes its int64 keys as K16's W = 2 rows: the
model at W = 2 against the reference's hash at k = 1, 2, 15, 16, 17 and 31,
and a model of K3's warp compaction (128 rows a warp a step, the solid
keys queued in ballot order and hashed 32 at a time) on chip_smoke.py's
k3_case runs at cutoffs that keep no row, every row and one in five.
Everything is integer: the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.parallel import mesh as ref_mesh
import chip_smoke
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


def pads(tab, k: int, W: int = 0):
    """(padf, padr): the terms of the code-0 bases at m = k .. 16W - 1 (W
    defaults to ceil(k/16); K3 hashes a key as W = 2 words at every k)."""
    W = W or -(-k // 16)
    f = r = u32(0)
    for m in range(k, 16 * W):
        f ^= _rol(tab[0][0], m)
        r ^= _rol(tab[1][0], -m)
    return u32(f), u32(r)


def hash_tab_model(words, k: int, seed: int, top=None):
    """(f, r) of (n, W) u32 words as the kernel computes them; top masks the
    top word (K16: the k-mer's 2k bits; K3, whose keys are exact, passes
    0xFFFFFFFF)."""
    tab = ref_bloom.tables(seed, k)
    tf, tr = nibble_tables(tab)
    W = words.shape[1]
    padf, padr = pads(tab, k, W)
    w = words.astype(np.uint32).copy()
    w[:, W - 1] &= u32(kmer.top_mask(k) if top is None else top)
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


K3_KS = chip_smoke.K3_KS


def _key_words(keys):
    """int64 keys as K3 reads them: (n, 2) u32, low word first."""
    k64 = np.asarray(keys, np.int64).view(np.uint64)
    return np.stack([(k64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (k64 >> np.uint64(32)).astype(np.uint32)], axis=1)


@pytest.mark.parametrize("k", K3_KS)
def test_k3_table_hash_at_two_words(k):
    """K3's hash, the table hash over a key's two words at every k <= 31
    (no top mask; pads over m = k .. 31), equals the reference's hash of
    the key's ceil(k/16) words and the port's plain hash_keys_plain."""
    rng = np.random.default_rng(k)
    top = (1 << (2 * k)) - 1
    keys = np.concatenate([[0, top], rng.integers(0, top, 500, dtype=np.int64, endpoint=True)])
    w2 = _key_words(keys)
    f, r = hash_tab_model(w2, k, SEED, top=0xFFFFFFFF)
    rf, rr = ref_bloom.hash_words(w2[:, : -(-k // 16)], k, SEED, np)
    np.testing.assert_array_equal(f, rf)
    np.testing.assert_array_equal(r, rr)
    pf, pr = bloom.hash_keys_plain(torch.from_numpy(keys), k, bloom.tables(SEED, k))
    np.testing.assert_array_equal(f, pf.numpy().astype(np.uint32))
    np.testing.assert_array_equal(r, pr.numpy().astype(np.uint32))


def k3_compaction_model(counts, cutoff: int, n_warps: int, tile: int = 128):
    """Row indices in the order K3's warps hash them: warp w takes tiles w,
    w + n_warps, ... of `tile` rows (four a lane), queues its solid rows in
    ballot order (row j of every lane, then row j + 1), hashes 32 off the
    queue's top while it holds 32, and the rest at the end."""
    M = counts.size
    order = []
    for w in range(n_warps):
        queue = []
        for t0 in range(w * tile, M, n_warps * tile):
            for j in range(4):
                for lane in range(32):
                    r = t0 + 4 * lane + j
                    if r < M and counts[r] >= cutoff:
                        queue.append(r)
            while len(queue) >= 32:
                order.extend(queue[-32:])
                del queue[-32:]
        order.extend(queue)
    return np.array(order, np.int64)


@pytest.mark.parametrize("keep", chip_smoke.K3_KEEP)
@pytest.mark.parametrize("k", (15, 31))
def test_k3_compaction_model(k, keep):
    """Every row at or above the cutoff is hashed exactly once, no other
    row is, whatever the grid; the bitset the model's rows set (4,099 and
    64 words, H = 1..8) equals the plain build's."""
    keys, counts, cutoff = chip_smoke.k3_case(k, keep, 3001)
    solid = np.flatnonzero(counts >= cutoff)
    assert solid.size == {"none": 0, "all": keys.size}.get(keep, solid.size)
    if keep == "fifth":
        assert 0.1 < solid.size / keys.size < 0.3
    for n_warps in (1, 3, 64):
        order = k3_compaction_model(counts, cutoff, n_warps)
        np.testing.assert_array_equal(np.sort(order), solid)
    tk, tc = torch.from_numpy(keys), torch.from_numpy(counts)
    for h in range(1, 9):
        for nw in (64, 4099):
            f, r = hash_tab_model(_key_words(keys[order]), k, SEED, top=0xFFFFFFFF)
            wi, mask = bloom.wordmask_from_hashes(f, r, h, nw)
            bits = np.zeros(nw, np.uint32)
            np.bitwise_or.at(bits, wi, mask)
            want = bloom.bloom_build_plain(tk, tc, cutoff, nw, h, SEED, k)
            np.testing.assert_array_equal(bits, state.bitset_from_torch(want))
