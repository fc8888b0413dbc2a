"""K10 `dbg_probe` as the card runs it: a numpy model of its algorithm
(csrc/graph.cu) against the reference, on rows whose every bit is random
(dirty above 2k), at k = 1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 127, 128,
254 and 255 (chip_smoke.K10_KS). The model hashes a node once, a word at a
time from K16's nibble tables (test_torch_bloom_table.hash_tab_model), then
rolls the pairs of its four neighbours from the node's (f, r): the shl2
successors from the leaving first base, the shr2_ins predecessors from the
leaving last base and the new first base c' read from the shifted words
(shr2_ins does not mask, so where 2k < 32W the caller's bits 2k..2k+1 are
ORed into it). Each pair must equal leon_tpu's hash_words of leon_tpu's
shl2 / shr2_ins of the same words, and the model's membership (classic: the
H loads of the four candidates in rounds, round i loading hash i of every
candidate still alive; blocked: one word each) must equal leon_tpu's
probe_classic and probe on bitsets built by build_np_classic and build_np
from a mix of the rows and their neighbours. Then chip_smoke.py's k12_case,
which the card runs against K12, is held to what its docstring says: SNP
bubbles whose branches meet at the last depth (D = k), bubbles that never
meet (D = k - 1), lanes that stop at step 0. Everything is integer: the tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu_torch.graph import dbg_traverse_plain
from leon_tpu_torch.ops import kmer
from test_torch_bloom_table import _rol, hash_tab_model

SEED, H, N = 0x5EED, 4, 300
u32 = np.uint32


def base0(words: np.ndarray, k: int) -> np.ndarray:
    """Base 0 (bits 2(k-1)..2k-1) of (n, W) u32 words."""
    t = 2 * (k - 1)
    return ((words[:, t // 32] >> u32(t % 32)) & u32(3)).astype(np.int64)


def shr2_ins_model(words: np.ndarray, c, k: int) -> np.ndarray:
    """(kmer >> 2) | (c << 2(k-1)) over (n, W) u32 words, unmasked
    (csrc/kmer_words.cuh shr2_ins)."""
    W = words.shape[1]
    out = words >> u32(2)
    out[:, : W - 1] |= words[:, 1:] << u32(30)
    t = 2 * (k - 1)
    out[:, t // 32] |= u32(c) << u32(t % 32)
    return out


def roll_model(words: np.ndarray, k: int, seed: int):
    """((f_out, r_out), (f_in, r_in)), each (n, 4) u32: the node hashed once
    from the nibble tables, its 4 successors' and 4 predecessors' pairs
    rolled from it (roll_out, roll_in)."""
    T, Tc, Trot, Tcrot = ref_bloom.tables(seed, k)
    f, r = hash_tab_model(words, k, seed)
    o = base0(words, k)
    fb, rb = _rol(f ^ Trot[o], 1), _rol(r ^ Tc[o], -1)
    out = (fb[:, None] ^ T[None, :], rb[:, None] ^ Tcrot[None, :])
    l = (words[:, 0] & u32(3)).astype(np.int64)
    dirty = base0(shr2_ins_model(words, 0, k), k)
    cp = np.arange(4)[None, :] | dirty[:, None]  # c' of candidate c
    fb, rb = _rol(f ^ T[l], -1), _rol(r ^ Tcrot[l], 1)
    inn = (fb[:, None] ^ Trot[cp], rb[:, None] ^ Tc[cp])
    return out, inn


def probe_classic_rounds(bits: np.ndarray, f, r, n_hashes: int, n_words: int):
    """(member, loads) of candidates (n, C): round i loads hash i of every
    candidate still alive (probe_classic_n)."""
    h1 = np.minimum(f, r)
    h2 = np.maximum(f, r) | u32(1)
    alive = np.ones(f.shape, bool)
    loads = np.zeros(f.shape, np.int64)
    g = h1.copy()
    for i in range(n_hashes):
        if i:
            g = g + h2
        loads += alive
        wi = (g.astype(np.uint64) * np.uint64(n_words)) >> np.uint64(32)
        alive &= ((bits[wi] >> (g & u32(31))) & u32(1)) == 1
    return alive, loads


def probe_blocked_model(bits: np.ndarray, f, r, n_hashes: int, n_words: int):
    """Blocked membership of candidates (n, C): one word, an H-bit mask."""
    lo, hi = np.minimum(f, r), np.maximum(f, r)
    wi = (lo.astype(np.uint64) * np.uint64(n_words)) >> np.uint64(32)
    m = np.zeros(f.shape, np.uint32)
    for i in range(n_hashes):
        b = ((hi >> u32(5 * i)) if i < 6 else (lo >> u32(5 * (i - 6)))) & u32(31)
        m |= u32(1) << b
    return (bits[wi] & m) == m


def ref_neighbours(words: np.ndarray, k: int):
    """leon_tpu's shl2 and shr2_ins of the words by c = 0..3: two (n, 4, W)."""
    w = jnp.asarray(words)
    c = [jnp.full(words.shape[0], b, jnp.uint32) for b in range(4)]
    return tuple(np.stack([np.asarray(step(w, c[b], k)) for b in range(4)], axis=1)
                 for step in (ref_kmer.shl2, ref_kmer.shr2_ins))


def _case(k: int):
    rng = np.random.default_rng(k)
    W = kmer.words_for_k(k)
    words = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64).astype(np.uint32)
    words[0], words[1] = 0, 0xFFFFFFFF
    return words


@pytest.mark.parametrize("k", chip_smoke.K10_KS)
def test_roll_matches_reference_hash(k):
    """The rolled pairs equal hash_words of the reference's shifted words;
    at k < 16W some rows shift dirty bits into the predecessors' base 0."""
    words = _case(k)
    (fo, ro), (fi, ri) = roll_model(words, k, SEED)
    succ, pred = ref_neighbours(words, k)
    for (f, r), nb in (((fo, ro), succ), ((fi, ri), pred)):
        rf, rr = ref_bloom.hash_words(nb, k, SEED, np)
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(r, rr)
    if 2 * k < 32 * words.shape[1]:
        assert (base0(shr2_ins_model(words, 0, k), k) != 0).any()


@pytest.mark.parametrize("k", chip_smoke.K10_KS)
def test_membership_matches_reference_probes(k):
    """The model's membership of the node and of its 8 neighbours equals
    leon_tpu's probe_classic and probe; the rounds make the early exit's
    loads, 4 to 4H a node."""
    words = _case(k)
    W = words.shape[1]
    succ, pred = ref_neighbours(words, k)
    rng = np.random.default_rng(k + 1)
    every = np.concatenate([words, succ.reshape(-1, W), pred.reshape(-1, W)])
    solid = every[rng.random(every.shape[0]) < 0.5]
    n_words = 8 * every.shape[0] // 32 + 7
    classic = ref_bloom.build_np_classic(solid, n_words, H, SEED, k)
    blocked = np.asarray(ref_bloom.build_np(solid, n_words, H, SEED, k))
    (fo, ro), (fi, ri) = roll_model(words, k, SEED)
    f0, r0 = hash_tab_model(words, k, SEED)
    for f, r, q in ((f0[:, None], r0[:, None], words[:, None]), (fo, ro, succ), (fi, ri, pred)):
        got, loads = probe_classic_rounds(classic, f, r, H, n_words)
        want = ref_bloom.probe_classic(classic, q.reshape(-1, W), H, n_words, SEED, k)
        np.testing.assert_array_equal(got.reshape(-1), want)
        wi, bit = ref_bloom.wordbit_classic_from_hashes(f, r, H, n_words, np)
        hit = ((classic[wi] >> bit) & 1) == 1
        early = np.where(hit.all(-1), H, np.argmin(hit, axis=-1) + 1)
        np.testing.assert_array_equal(loads, early)
        got = probe_blocked_model(blocked, f, r, H, n_words)
        want = ref_bloom.probe(jnp.asarray(blocked), jnp.asarray(q.reshape(-1, W)), H, n_words,
                               SEED, k)
        np.testing.assert_array_equal(got.reshape(-1), np.asarray(want))
    if 4 ** k > every.shape[0]:  # members and non-members both (k = 1, 2: every k-mer)
        assert 0 < got.mean() < 1


@pytest.mark.parametrize("case", [c for c in chip_smoke.K12_CASES if c[0] <= 63])
def test_k12_case_is_adversarial(case):
    """k12_case's first five lanes (a SNP's branching node, a tip's, a
    contig k-mer, the contig's last k-mer, a random word) through the plain
    traversal: the SNP's branches meet after k + 1 steps, at depth k - 1,
    so at D = k at the last depth (its first outer step emits D + 1 bases),
    at D = k + 1 one depth before it, and at D < k never (the lane stops
    with nothing emitted); the contig k-mer walks; the last k-mer stops at
    step 0."""
    k, S, D, n_lanes, h = case
    lanes, bits, n_words = chip_smoke.k12_case(k, S, D, n_lanes, h)
    assert lanes.shape == (n_lanes, kmer.words_for_k(k))
    out, n = dbg_traverse_plain(torch.from_numpy(bits.view(np.int32)),
                                torch.from_numpy(lanes[:5].view(np.int32)), h, n_words,
                                chip_smoke.SEED, k, S, D)
    n = n.numpy()
    assert out.shape == (min(5, n_lanes), S * (D + 2))
    assert n[0] >= k + 1 if D >= k else n[0] == 0
    assert n[2] > 0 and n[3] == 0
