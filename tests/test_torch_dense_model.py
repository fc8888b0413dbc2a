"""K15 `walk_dense` as the card runs it: a numpy model of its per-thread
algorithm (csrc/walk.cu) against the port's plain version (encode_batch_plain)
and leon_tpu's encode_batch, on chip_smoke.py's k15_case (walk_case's reads:
lengths 0, k - 1, k, k + 1, L and longer than L, anchors at 0 and len - k,
unanchored and all-error reads, true and false-positive bifurcations on
both sides, sides that walk past the anchor's k bases so that the rings
wrap) at k = 1, 5, 15, 16, 17, 31, 32, 33, 63, 64, 127, 128, 255
(chip_smoke.K15_KS) and L mod 16 = 0, 1, 15.

The model keeps what the kernel keeps: the codes packed 16 columns to a word
(taken & 3, zero past column L-1), K18's anchor scan over the packed row
(WALKW_SCAN_UNROLL positions rolled and probed, then folded in order), one
ring of walked bases a side starting from the anchor's words (the other
words undefined), the leaving base read from the ring, or at k < 16 from the
word the side is building when it lies there; the right side walks min(len
- k - apos, ME) steps (column L-1's base past the row), the left side apos
steps; each event goes to its side's next slot (bif rank, absolute errpos,
errnt rank, side-local gap), and the confirmed columns of a word, where any
is set, are stored as its 16 bytes over the rows the block zeroed first (a
word stored twice keeps only the last store: at k < 15 the left side's
first word carries the right side's bits). Everything is integer: the
tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import walk as ref_walk
from leon_tpu_torch import state
from leon_tpu_torch.ops import kmer, walk
from test_torch_walk_model import M32, U, Filter, Ring, anchor_part, popc, rol1, rolr, ror1
from test_torch_walk_model import row_base

SEED = chip_smoke.SEED
N_RANDOM = 64  # random reads beside the edge reads (at k = 5 a few carry a shared word)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain version's many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def anchor_model(pr, n, k, flt):
    """K18's anchor scan of a packed row over its first n columns:
    (anchored, apos, f, r)."""
    st = flt.st
    af = ar = apos = 0
    best, anchored = M32, False
    P = n - k + 1
    if P > 0:
        f = r = 0
        for j in range(k):
            x = row_base(pr, j)
            f, r = rol1(f) ^ st[x], r ^ rolr(st[4 + x], j)
        for p0 in range(0, P, U):
            group = []
            for p in range(p0, p0 + U):
                if 0 < p < P:
                    x, o = row_base(pr, p + k - 1), row_base(pr, p - 1)
                    f = rol1(f ^ st[8 + o]) ^ st[x]
                    r = ror1(r ^ st[4 + o]) ^ st[12 + x]
                group.append((p, f, r, p < P and flt.member(f, r)))
            for p, hf, hr, mem in group:
                if p < P:
                    val = min(hf, hr) if mem else M32
                    anchored |= mem
                    if p == 0 or val < best:
                        best, apos, af, ar = val, p, hf, hr
    return anchored, apos, af, ar


def dense_model(codes, lengths, bitset, n_words, k, H):
    """K15 thread by thread: encode_batch's 15 arrays as int64 numpy, and
    the number of reads whose left side carried the right side's confirmed
    bits in a shared word."""
    B, L = codes.shape
    ME = max(1, L - k)
    flt = Filter(bitset, n_words, H, k)
    packed = kmer.pack_codes_np(codes & 3).view(np.uint32)
    out = {n: np.zeros((B,) if d == "s" else (B, ME) if d == "e" else (B, L), np.int64)
           for n, d, _ in walk.DENSE}  # the block's zero pass
    carried = 0
    for i in range(B):
        pr = [int(w) for w in packed[i]]
        lenf = int(lengths[i])
        anchored, apos, af, ar = anchor_model(pr, min(lenf, L), k, flt)
        out["anchored"][i], out["apos"][i] = anchored, apos
        if not anchored:
            continue
        rings = (Ring(k), Ring(k))
        for w in range(apos >> 4, ((apos + k - 1) >> 4) + 1):
            for ring in rings:
                ring.store(16 * w, pr[w])
        b_last = row_base(pr, L - 1) if lenf > L else 0
        first = {}
        for right, steps, ring, side in ((True, min(max(lenf - k - apos, 0), ME), rings[0], "r"),
                                         (False, apos, rings[1], "l")):
            j0 = apos + k if right else apos - 1
            f, r, last, ne, nb = af, ar, -1, 0, 0
            cw = first.get("r", 0) if not right and (j0 >> 4) == ((apos + k) >> 4) else 0
            carried += bool(cw)
            hw = ring.word(j0) & anchor_part(right, j0) if steps > 0 else 0
            for s in range(steps):
                j = j0 + s if right else j0 - s
                b = b_last if right and j >= L else row_base(pr, j)
                c = j - k if right else j + k  # the column leaving the window
                o = (hw >> (2 * (c & 15))) & 3 if c >> 4 == j >> 4 else ring.base(c)
                sm, fb, rb = flt.probe4(right, o, f, r)
                below = (1 << b) - 1
                if (sm >> b) & 1:
                    if popc(sm) == 1:
                        if not right or j < L:
                            cw |= 1 << (j & 15)
                    else:
                        out[f"bif_{side}"][i, nb] = popc(sm & below)
                        nb += 1
                else:
                    out[f"errpos_{side}"][i, ne] = j
                    out[f"errnt_{side}"][i, ne] = popc(~sm & 0xF & below)
                    out[f"gap_{side}"][i, ne] = s - last - 1
                    ne, last = ne + 1, s
                b_adv = (sm & -sm).bit_length() - 1 if not (sm >> b) & 1 and sm else b
                f, r = flt.next_chains(right, fb, rb, b_adv)
                hw |= b_adv << (2 * (j & 15))
                if (j & 15) == (15 if right else 0) or s == steps - 1:
                    ring.store(j, hw)
                    first.setdefault(side, cw)
                    c0 = j & ~15
                    if cw and c0 < L:  # the word's 16 bytes, clipped to the row
                        n = min(16, L - c0)
                        out["confirmed"][i, c0 : c0 + n] = [(cw >> t) & 1 for t in range(n)]
                    hw = cw = 0
            out[f"nbif_{side}"][i], out[f"nerr_{side}"][i] = nb, ne
    return out, carried


def _same(got: dict, want: dict) -> None:
    assert list(want) == [n for n, _, _ in walk.DENSE]
    for n in want:
        np.testing.assert_array_equal(got[n], np.asarray(want[n]).astype(np.int64), err_msg=n)


CASES = [(k, mod) for k in chip_smoke.K15_KS for mod in chip_smoke.WALK_L_MOD16]


@pytest.mark.parametrize("k,mod", CASES)
def test_dense_model_matches_plain(k, mod):
    """The model's 15 arrays equal the port's plain version (which the
    wrapper runs on the CPU); the case anchors, has errors (past k = 1) and
    bifurcations on both sides, walks a left side past k columns, and at
    1 < k < 15 stores a word from both sides."""
    codes, lengths, bitset, nw, H = chip_smoke.k15_case(k, mod, N_RANDOM)
    got, carried = dense_model(codes, lengths, bitset, nw, k, H)
    plain = walk.encode_batch(torch.from_numpy(codes), torch.from_numpy(lengths),
                              state.bitset_to_torch(bitset, "cpu"), k, H, nw, SEED)
    _same(got, {n: v.numpy() for n, v in plain.items()})
    B, L = codes.shape
    anch = got["anchored"] == 1
    assert anch.sum() > B // 2 and not anch.all()
    assert (anch & (lengths > L)).any(), "a read longer than L walks"
    assert (got["nbif_r"] > 0).any() and (got["nbif_l"] > 0).any()
    if k > 1:  # at k = 1 every base is solid
        assert (got["nerr_r"] > 0).any() and (got["nerr_l"] > 0).any()
    assert ((got["apos"] > k) & anch).any(), "a left side walks past k columns"
    if 1 < k < 15:
        assert carried > 0, "a word both sides store"


@pytest.mark.parametrize("k", chip_smoke.K15_KS)
def test_dense_model_matches_reference(k):
    """The model equals leon_tpu's encode_batch on the case at one L mod 16
    a k."""
    mod = chip_smoke.WALK_L_MOD16[chip_smoke.K15_KS.index(k) % 3]
    codes, lengths, bitset, nw, H = chip_smoke.k15_case(k, mod, N_RANDOM)
    got, _ = dense_model(codes, lengths, bitset, nw, k, H)
    want = ref_walk.encode_batch(codes, lengths, jnp.asarray(bitset), k, H, nw, SEED)
    _same(got, {n: np.asarray(want[n]) for n, _, _ in walk.DENSE})
