"""K11 `dbg_walk` as the card runs it: a numpy model of its per-lane
algorithm (csrc/graph.cu) against the port's plain version and leon_tpu's
DBG.walk, on chip_smoke.py's k11_case (start words with random bits above
2k, SNP bubbles, false-positive branches, lanes that stop at step 0 and at
step S - 1, walks longer than k steps) at k = 1, 15, 16, 17, 31, 32, 33, 63,
64, 127, 128, 255 (chip_smoke.K11_KS).

The model keeps what the kernel keeps: a lane's (f, r), a ring of RW = W + 1
u32 words and two ring positions, whatever W. The start node is hashed once
from K16's nibble tables (test_torch_bloom_table.hash_tab_model); its words
go into ring words 0..W-1 as they are (dirty bits and all) and the other
ring words start undefined; column c of the node's sequence lies at
bit-pair (k - 1 - c) mod 16RW, so a step reads its leaving base (column s)
from the ring, or from the word of walked bases being built when it lies
there (k < 16), and rolls its four candidates' pairs out of (f, r); the
candidates are probed in rounds (test_torch_graph_roll_model's
probe_classic_rounds: round i loads hash i of every candidate still
alive). The row's bytes go out as common.cuh's RowChunks stores them (K15
stores its error slots with it too): 16-byte chunks of the address space,
whole chunks in one store, the row's first and last chunks (shared with the
rows beside it) a word or an element at a time, the stopped lane's argmax
repeated. Everything is integer: the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu import graph as ref_graph
from leon_tpu.ops import bloom as ref_bloom
from leon_tpu_torch.graph import dbg_walk_plain
from leon_tpu_torch.ops import kmer
from test_torch_bloom_table import _rol, hash_tab_model
from test_torch_graph_roll_model import probe_classic_rounds

SEED = chip_smoke.SEED
u32 = np.uint32
REF_COMPILED_MAX_K = 64  # above it the reference runs op by op, over REF_STEPS steps
REF_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain version's many small tensor ops
    (see tests/test_torch_graph.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def walk_model(words: np.ndarray, bits: np.ndarray, H: int, n_words: int, k: int, S: int,
               seed: int):
    """(bases (N, S) uint8, n (N,) int32), all lanes in lockstep: a lane's
    state changes only while it walks (the ring positions depend on the
    step alone)."""
    N, W = words.shape
    T, Tc, Trot, Tcrot = (t.astype(u32) for t in ref_bloom.tables(seed, k))
    f, r = hash_tab_model(words, k, seed)
    RW = W + 1
    M = 16 * RW  # bit-pairs in the ring
    ring = np.full((N, RW), 0xDEADBEEF, u32)  # shared memory starts undefined
    ring[:, :W] = words
    acc = np.zeros(N, u32)
    alive = np.ones(N, bool)
    n = np.zeros(N, np.int32)
    u = np.zeros(N, np.int64)
    bases = np.zeros((N, S), np.uint8)
    ar = np.arange(N)
    rp, wp = k - 1, M - 1  # the pairs of the leaving base and of the next walked one
    for s in range(S):
        wv = acc if rp >> 4 == wp >> 4 else ring[:, rp >> 4]
        o = ((wv >> u32(2 * (rp & 15))) & u32(3)).astype(np.int64)
        fb, rb = _rol(f ^ Trot[o], 1), _rol(r ^ Tc[o], -1)
        cf, cr = fb[:, None] ^ T[None, :], rb[:, None] ^ Tcrot[None, :]
        m, _loads = probe_classic_rounds(bits, cf, cr, H, n_words)
        u = np.where(alive, np.argmax(m, axis=1), u)  # a stopped lane repeats its argmax
        bases[:, s] = u
        go = alive & (m.sum(axis=1) == 1)
        n += go
        f = np.where(go, cf[ar, u], f)
        r = np.where(go, cr[ar, u], r)
        acc = np.where(go, acc | (u.astype(u32) << u32(2 * (wp & 15))), acc)
        if wp & 15 == 0:  # the word of walked bases is whole
            ring[:, wp >> 4] = np.where(go, acc, ring[:, wp >> 4])
            acc = np.where(go, u32(0), acc)
        alive = go
        wp = wp - 1 if wp else M - 1
        rp = rp - 1 if rp else M - 1
    return bases, n


def row_chunk_stores(addr: int, n: int, count: int, esize: int, fill: bool) -> list:
    """common.cuh RowChunks over a row of n elements of esize bytes at
    address addr: elements 0 .. count - 1 put in order, then the rest filled
    (K11's stopped lane) or the last chunk ended (K15's errors): the
    (address, bytes) of every store."""
    E, EW = 16 // esize, 4 // esize
    out, off = [], (addr & 15) // esize

    def flush(i):
        c = (off + i) & (E - 1)
        first = i - c
        if first >= 0 and c == E - 1:
            out.append((addr + first * esize, 16))
            return
        lo = -first if first < 0 else 0
        for t in range(4):
            if EW * t >= lo and EW * t + EW - 1 <= c:
                out.append((addr + (first + EW * t) * esize, 4))
            elif EW > 1:
                out.extend((addr + (first + e) * esize, esize)
                           for e in range(max(EW * t, lo), min(EW * t + EW - 1, c) + 1))

    def put(i):
        if (off + i) & (E - 1) == E - 1 or i == n - 1:
            flush(i)

    for i in range(count):
        put(i)
    if not fill:
        if 0 < count < n and (off + count - 1) & (E - 1) != E - 1:
            flush(count - 1)
        return out
    i = count
    while i < n and (off + i) & (E - 1):
        put(i)
        i += 1
    while i + E <= n:
        out.append((addr + i * esize, 16))
        i += E
    while i < n:
        put(i)
        i += 1
    return out


@pytest.mark.parametrize("N", chip_smoke.K11_NS)
@pytest.mark.parametrize("k", chip_smoke.K11_KS)
def test_walk_model_matches_plain(k, N):
    """The model's whole (N, S) plane and n equal the port's plain version
    (which the wrapper runs on the CPU); the case stops lanes at step 0,
    wraps rings and (at N = 257) walks whole."""
    lanes, bits, nw, h, S = chip_smoke.k11_case(k, N)
    assert (lanes[:, -1] & ~u32(kmer.top_mask(k))).any() or 2 * k == 32 * lanes.shape[1]
    got_b, got_n = walk_model(lanes, bits, h, nw, k, S, SEED)
    pb, pn = dbg_walk_plain(torch.from_numpy(bits.view(np.int32)),
                            torch.from_numpy(lanes.view(np.int32)), h, nw, SEED, k, S)
    np.testing.assert_array_equal(got_b, pb.numpy())
    np.testing.assert_array_equal(got_n, pn.numpy())
    assert (got_n == 0).any()
    if N > 256 and k > 1:
        assert (got_n > k).any() and (got_n == S).any(), "walks past k steps and whole"


@pytest.mark.parametrize("k", chip_smoke.K11_KS)
def test_walk_model_matches_reference(k):
    """The model equals leon_tpu's DBG.walk on the N = 61 case: compiled
    over every step at k <= 64, op by op (jax.disable_jit) over the first
    REF_STEPS steps above (its from-scratch hash takes minutes to compile
    there)."""
    lanes, bits, nw, h, S = chip_smoke.k11_case(k, chip_smoke.K11_NS[0])
    dbg = ref_graph.DBG(jnp.asarray(bits), k, h, nw, SEED)
    if k <= REF_COMPILED_MAX_K:
        wb, wn = dbg.walk(lanes, S)
    else:
        S = REF_STEPS
        with jax.disable_jit():
            wb, wn = dbg.walk(lanes, S)
    got_b, got_n = walk_model(lanes, bits, h, nw, k, S, SEED)
    np.testing.assert_array_equal(got_b, np.asarray(wb))
    np.testing.assert_array_equal(got_n, np.asarray(wn))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 35, 100])
@pytest.mark.parametrize("esize,base", [(1, 0), (1, 256 + 5), (4, 0), (4, 256 + 12)])
@pytest.mark.parametrize("fill", [True, False])
def test_row_chunks_store_each_element_once(n, esize, base, fill):
    """RowChunks on rows of n elements laid end to end from `base`, after
    every count of puts: each element put (or filled) is stored exactly
    once, by its own row, none past them, and each 16-byte store lies whole
    inside its row on a 16-byte boundary; a row of n * esize >= 48 bytes
    goes out mostly in 16-byte stores."""
    for row in range(20):
        addr = base + row * n * esize
        for count in range(n + 1):
            seen = np.zeros(n * esize, np.int64)
            stores = row_chunk_stores(addr, n, count, esize, fill)
            for a, w in stores:
                assert addr <= a and a + w <= addr + n * esize
                assert a % w == 0
                seen[a - addr : a - addr + w] += 1
            done = n if fill else count
            np.testing.assert_array_equal(seen[: done * esize], 1)
            np.testing.assert_array_equal(seen[done * esize :], 0)
            if fill and n * esize >= 48:
                assert sum(w == 16 for _, w in stores) >= n * esize // 16 - 1
