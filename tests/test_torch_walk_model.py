"""K18 `walk_encode_words` and K19 `walk_decode_words` as the card runs them:
a numpy model of the kernels' per-thread algorithm (no window: the base
leaving it is the walked base k positions back, read from a ring of the
thread's walked bases that does not grow with L, one ring a side, both
starting from the anchor and starting otherwise undefined; K18's read bases
from its packed row; the walked word and the output word built in registers
and stored in order, one word per 16 positions, over rows zeroed first;
the anchor scan folded in groups of WALKW_SCAN_UNROLL positions; K19's
anchor hashed base by base from its words) against leon_tpu's
encode_batch_compact_packed and decode_batch_flat_packed and against the
port's plain versions, on chip_smoke.py's adversarial reads (walk_case:
k = 17 .. 255, L mod 16 = 0, 1, 15, H = 1..8; reads of length 0, k - 1, k,
k + 1, L and longer than L, the anchor at 0 and at len - k, unanchored and
all-error reads, true and false-positive bifurcations on both sides, sides
that walk past the anchor's k bases; and rows of L = 2048 and 2049).
Then the wrappers at W = 8 and 16 on the CPU against leon_tpu. Everything
is integer: the tolerance is 0."""

import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu.ops import walk as ref_walk
from leon_tpu_torch import state
from leon_tpu_torch.ops import bloom, kmer, walk

SEED = chip_smoke.SEED
M32 = 0xFFFFFFFF
U = 4  # csrc/walk.cu WALKW_SCAN_UNROLL
N_RANDOM = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rol1(x):
    return ((x << 1) | (x >> 31)) & M32


def ror1(x):
    return ((x >> 1) | (x << 31)) & M32


def rolr(x, r):
    r &= 31
    return ((x << r) | (x >> (32 - r))) & M32 if r else x


class Filter:
    """The blocked Bloom probe and the shared-memory tables of one batch:
    st[kind * 4 + base], kinds T, Tc, Trot, Tcrot (common.cuh)."""

    def __init__(self, bitset, n_words, H, k):
        self.bits = [int(w) for w in bitset]
        self.n_words, self.H = n_words, H
        tab = bloom.tables(SEED, k)
        self.tab = [[int(v) for v in tab[kd]] for kd in range(4)]
        self.st = [v for row in self.tab for v in row]

    def member(self, f, r):
        lo, hi = min(f, r), max(f, r)
        m = 0
        for i in range(self.H):
            m |= 1 << (((hi >> (5 * i)) if i < 6 else (lo >> (5 * (i - 6)))) & 31)
        return (self.bits[(lo * self.n_words) >> 32] & m) == m

    def probe4(self, right, o, f, r):
        """probe4: (solid mask, fb, rb)."""
        st, t = self.st, self.tab
        if right:
            fb, rb, tf, tr = rol1(f ^ st[8 + o]), ror1(r ^ st[4 + o]), t[0], t[3]
        else:
            fb, rb, tf, tr = ror1(f ^ st[o]), rol1(r ^ st[12 + o]), t[2], t[1]
        sm = sum(1 << c for c in range(4) if self.member(fb ^ tf[c], rb ^ tr[c]))
        return sm, fb, rb

    def next_chains(self, right, fb, rb, b):
        st = self.st
        return (fb ^ st[b], rb ^ st[12 + b]) if right else (fb ^ st[8 + b], rb ^ st[4 + b])


class Ring:
    """A thread's ring of walked bases (csrc/walk.cu walkw_ring): RW u32
    words, RW the power of two >= ceil(k/16) + 1, column c in word
    (c >> 4) & (RW - 1)."""

    def __init__(self, k):
        self.rw = 4
        while self.rw < -(-k // 16) + 1:
            self.rw *= 2
        self.w = [0xDEADBEEF] * self.rw  # shared memory starts undefined

    def word(self, c):
        return self.w[(c >> 4) & (self.rw - 1)]

    def base(self, c):
        return (self.word(c) >> (2 * (c & 15))) & 3

    def store(self, c, v):
        self.w[(c >> 4) & (self.rw - 1)] = v


def row_base(words, j):
    """Base j of a packed row (K18's Cols: the read in device memory)."""
    return (int(words[j >> 4]) >> (2 * (j & 15))) & 3


def anchor_part(right, j0):
    """The bits of a side's first word that hold anchor bases."""
    sh = 2 * (j0 & 15)
    return (1 << sh) - 1 if right else (0 if sh == 30 else (M32 << (sh + 2)) & M32)


def popc(x):
    return bin(x).count("1")


def nth_set(m, n):
    for c in range(4):
        if (m >> c) & 1:
            if n == 0:
                return c
            n -= 1
    return 0


def encode_model(packed, lengths, bitset, n_words, k, H, L, with_conf):
    """K18 thread by thread: walk_encode's dict as numpy (event rows zero
    past each read's events)."""
    flt = Filter(bitset, n_words, H, k)
    st = flt.st
    B, L16 = packed.shape
    ME, L16c = L - k, (L16 if with_conf else 0)
    meta = np.zeros((B, 6), np.int64)
    tot = np.zeros((2, B), np.int64)
    ev = {n: np.zeros((B, ME), np.int64) for n in ("ev_gap", "ev_nt", "ev_bif")}
    conf = np.zeros((B, L16c), np.int64)  # the block's coalesced zero pass
    for i in range(B):
        pr = [int(w) for w in packed[i]]
        lenf = int(lengths[i])
        n = min(lenf, L)
        af = ar = apos = 0
        best, anchored = M32, False
        P = n - k + 1
        if P > 0:
            f = r = 0
            for j in range(k):
                x = row_base(pr, j)
                f, r = rol1(f) ^ st[x], r ^ rolr(st[4 + x], j)
            for p0 in range(0, P, U):  # U rolls and probes, then the fold in order
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
        total = min(max(lenf - k, 0), ME) if anchored else 0
        nr = min(max(lenf - k - apos, 0), total)
        rings = (Ring(k), Ring(k))
        b_last = 0
        if total > 0:  # both rings start from the anchor's words
            for w in range(apos >> 4, ((apos + k - 1) >> 4) + 1):
                for ring in rings:
                    ring.store(16 * w, pr[w])
            if lenf > L:
                b_last = row_base(pr, L - 1)
        ne = nb = 0
        counts = []
        for right, steps, ring in ((True, nr, rings[0]), (False, total - nr, rings[1])):
            j0 = apos + k if right else apos - 1
            f, r, last, cw, serr, sbif = af, ar, -1, 0, 0, 0
            hw = ring.word(j0) & anchor_part(right, j0) if steps > 0 else 0
            for s in range(steps):
                j = j0 + s if right else j0 - s
                b = b_last if right and j >= L else row_base(pr, j)
                sm, fb, rb = flt.probe4(right, ring.base(j - k if right else j + k), f, r)
                below = (1 << b) - 1
                if (sm >> b) & 1:
                    if popc(sm) == 1:
                        if not right or j < L:
                            cw |= 1 << (j & 15)
                    else:
                        ev["ev_bif"][i, nb] = popc(sm & below)
                        nb, sbif = nb + 1, sbif + 1
                else:
                    ev["ev_gap"][i, ne] = s - last - 1
                    ev["ev_nt"][i, ne] = popc(~sm & 0xF & below)
                    ne, last, serr = ne + 1, s, serr + 1
                b_adv = nth_set(sm, 0) if not (sm >> b) & 1 and sm else b
                f, r = flt.next_chains(right, fb, rb, b_adv)
                hw |= b_adv << (2 * (j & 15))
                if (j & 15) == (15 if right else 0) or s == steps - 1:
                    ring.store(j, hw)
                    if L16c and (not right or (j >> 4) < L16c):
                        conf[i, j >> 4] = cw  # a plain store: each side owns its words
                    hw = cw = 0
            counts += [serr, sbif]
        meta[i] = [anchored, apos, counts[1], counts[0], counts[3], counts[2]]
        tot[:, i] = [ne, nb]
    return dict(meta=meta, tot=tot, conf=conf, **ev)


def decode_model(scal, errgaps, errnts, bifs, bitset, n_words, k, H, L):
    """K19 thread by thread: (B, ceil(L/16)) u32 decoded bases."""
    flt = Filter(bitset, n_words, H, k)
    st = flt.st
    B = scal.shape[0]
    L16, ME = (L + 15) // 16, max(1, L - k)
    out = np.zeros((B, L16), np.uint32)  # the block's coalesced zero pass
    n_err, n_bif = len(errgaps), len(bifs)
    for i in range(B):
        sc = [int(v) for v in scal[i]]
        apos = sc[0]
        if not (sc[1] and 0 <= apos <= L - k):
            continue
        n = min(sc[2], L)
        orow = out[i]
        rings = (Ring(k), Ring(k))
        af = ar = acc = aw = 0
        t = 2 * (k - 1)
        for a in range(k):  # the anchor, top word first, hashed as it goes
            if a == 0 or (t & 31) == 30:
                aw = sc[9 + (t >> 5)] & M32
            b = (aw >> (t & 31)) & 3
            af, ar = rol1(af) ^ st[b], ar ^ rolr(st[4 + b], a)
            p = apos + a
            acc |= b << (2 * (p & 15))
            if (p & 15) == 15 or a == k - 1:
                orow[p >> 4] = acc
                for ring in rings:
                    ring.store(p, acc)
                acc = 0
            t -= 2
        nerr_r, nerr_l, nbif_r, nbif_l, err_base, bif_base = sc[3:9]
        total = max(n - k, 0)
        nr = min(max(n - k - apos, 0), total)
        pbif = 0
        for right, steps, side_n, ebase, ring in (
                (True, nr, nerr_r, err_base, rings[0]),
                (False, total - nr, nerr_l, err_base + nerr_r, rings[1])):
            if steps <= 0:
                continue
            j0 = apos + k if right else apos - 1
            hw = ow = ring.word(j0) & anchor_part(right, j0)
            f, r, ei = af, ar, 0
            next_err = int(errgaps[ebase]) if side_n > 0 and ebase < n_err else -1
            for s in range(steps):
                j = j0 + s if right else j0 - s
                is_err = ei < side_n and s == next_err
                if is_err:
                    rank_ns = int(errnts[ebase + ei]) & 3
                    ei += 1
                    next_err = (next_err + 1 + int(errgaps[ebase + ei])
                                if ei < side_n and ebase + ei < n_err else -1)
                sm, fb, rb = flt.probe4(right, ring.base(j - k if right else j + k), f, r)
                b_uniq = nth_set(sm, 0)
                if is_err:
                    b = nth_set(~sm & 0xF, rank_ns)
                elif popc(sm) >= 2:
                    q, rank = min(pbif, 2 * ME - 1), 0
                    if q < nbif_r:
                        if bif_base + q < n_bif:
                            rank = int(bifs[bif_base + q])
                    else:
                        tq = min(q - nbif_r, ME - 1)
                        if tq < nbif_l and bif_base + nbif_r + tq < n_bif:
                            rank = int(bifs[bif_base + nbif_r + tq])
                    b = nth_set(sm, rank & 3)
                    pbif += 1
                else:
                    b = b_uniq
                b_adv = b_uniq if is_err and sm else b
                ow |= b << (2 * (j & 15))
                hw |= b_adv << (2 * (j & 15))
                if (j & 15) == (15 if right else 0) or s == steps - 1:
                    orow[j >> 4] = ow
                    ring.store(j, hw)
                    ow = hw = 0
                f, r = flt.next_chains(right, fb, rb, b_adv)
    return out


def _ref_bits(bitset, n_words):
    return np.pad(bitset, (0, bloom.alloc_words(n_words) - n_words))


def _padded(a, L, n=1024):
    out = np.zeros(max(n, a.size + L), a.dtype)
    out[: a.size] = a
    return out


def _as_torch(enc):
    return {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in enc.items()}


def _same_encode(got, want, ME):
    """meta, tot, conf and each read's valid event slots equal (u16 values
    compared as such)."""
    def u16(x):
        return np.asarray(x, np.int64) & 0xFFFF

    for n in ("meta", "tot", "conf"):
        np.testing.assert_array_equal(u16(got[n]), u16(want[n]), err_msg=n)
    tot = u16(want["tot"])
    for n, row in (("ev_gap", 0), ("ev_nt", 0), ("ev_bif", 1)):
        valid = np.arange(ME)[None, :] < tot[row][:, None]
        np.testing.assert_array_equal(u16(got[n])[valid], u16(want[n])[valid], err_msg=n)


# (k, L mod 16, L): walk_case's rows, then its long rows (WALK_LONG)
CASES = ([(k, mod, 0) for k in chip_smoke.WALK_KS for mod in chip_smoke.WALK_L_MOD16]
         + [(k, 0, L) for k, L in chip_smoke.WALK_LONG])


def _encode_case(k, mod, with_conf, long_l):
    codes, lengths, bitset, nw, H = chip_smoke.walk_case(k, mod, N_RANDOM, long_l)
    L = codes.shape[1]
    packed = kmer.pack_codes_np(codes)
    model = encode_model(packed.view(np.uint32), lengths, bitset, nw, k, H, L, with_conf)
    return codes, lengths, bitset, nw, H, L, packed, model


@pytest.mark.parametrize("with_conf", [True, False])
@pytest.mark.parametrize("k,mod,long_l", CASES)
def test_encode_model_matches_reference(k, mod, long_l, with_conf):
    """The model's per-read outputs equal the port's plain version (which
    the wrapper runs on the CPU), and its flat buffer (walk_pack) equals
    leon_tpu's encode_batch_compact_packed, byte for byte."""
    codes, lengths, bitset, nw, H, L, packed, model = _encode_case(k, mod, with_conf, long_l)
    tp, tl = state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths)
    tb = state.bitset_to_torch(bitset, "cpu")
    plain = walk.walk_encode_words(tp, tl, tb, nw, k, H, SEED, L, with_conf)
    _same_encode(model, {n: v.numpy() for n, v in plain.items()}, L - k)
    B = codes.shape[0]
    cap = -(-(L - k) * B // 8) * 8
    ref = np.asarray(ref_walk.encode_batch_compact_packed(
        packed, lengths, _ref_bits(bitset, nw), k, H, np.uint32(nw), SEED, cap, cap,
        with_conf, L)).astype(np.uint16)
    m = _as_torch(model)
    buf = walk.walk_pack_plain(m, torch.cumsum(m["tot"], dim=1), L, k, cap, cap, with_conf)
    np.testing.assert_array_equal(buf.numpy().view(np.uint16), ref)
    # the edges the case is built for
    meta = model["meta"]
    anch = meta[:, 0] == 1
    assert anch.sum() > B // 3 and model["tot"].sum() > 0
    assert (anch & (lengths > L)).any(), "a read longer than L walks"
    assert ((meta[:, 2] > 0) & (meta[:, 4] > 0)).any(), "bifurcations on both sides"
    assert ((meta[:, 3] > 0) & (meta[:, 5] > 0)).any(), "errors on both sides"
    ends = np.flatnonzero(anch & (lengths == L) & ((meta[:, 1] == 0) | (meta[:, 1] == L - k)))
    assert {0, L - k} <= set(meta[ends, 1]), "anchors at 0 and at len - k"


@pytest.mark.parametrize("k,mod,long_l", CASES)
def test_decode_model_matches_reference(k, mod, long_l):
    """The model decodes what the model encoded exactly as leon_tpu's
    decode_batch_flat_packed and the port's plain version, and restores
    every anchored read of length <= L (longer ones go in unanchored)."""
    codes, lengths, bitset, nw, H, L, packed, model = _encode_case(k, mod, False, long_l)
    B = codes.shape[0]
    m = _as_torch(model)
    incl = torch.cumsum(m["tot"], dim=1)
    ce, cb = (-(-int(incl[i, -1]) // 8) * 8 for i in (0, 1))
    buf = walk.walk_pack_plain(m, incl, L, k, ce, cb, False).numpy().view(np.uint16)
    enc = walk.unpack_compact(buf, B, B, L, ce, cb, False, k)
    scal, eg, en, bf = chip_smoke.decode_inputs(enc, codes, lengths, k, lengths <= L)
    got = decode_model(scal, eg, en, bf, bitset, nw, k, H, L)
    W = ref_kmer.words_for_k(k)
    ref = np.asarray(ref_walk.decode_batch_flat_packed(
        scal, _padded(eg.astype(np.uint16), L), _padded(en, L), _padded(bf, L),
        _ref_bits(bitset, nw), k, H, np.uint32(nw), SEED, L, W))
    np.testing.assert_array_equal(got, ref)
    args = (torch.from_numpy(scal), torch.from_numpy(eg), torch.from_numpy(en),
            torch.from_numpy(bf), state.bitset_to_torch(bitset, "cpu"), nw, k, H, SEED, L)
    np.testing.assert_array_equal(walk.walk_decode_words(*args).numpy().view(np.uint32), got)
    dec = walk.unpack_codes_u32_np(got, L)
    rows = np.flatnonzero(scal[:, 1])
    assert rows.size > B // 3
    for i in rows:
        np.testing.assert_array_equal(dec[i, : lengths[i]], codes[i, : lengths[i]])


# ---------------------------------------------------------------------------
# the wrappers past four words on the CPU (tests/test_torch_widek.py takes
# them to k = 64)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,with_conf", [(127, True), (128, False), (255, True)])
def test_walk_words_match_reference_wide(k, with_conf):
    """walk_encode_words + walk_pack and walk_decode_words (their plain
    versions on the CPU) against leon_tpu on 250-bp-style reads of the
    bench contig (chip_smoke.long_reads' generator, 1% substitutions)."""
    L = 16 * -(-(k + 60) // 16)
    codes, lengths = chip_smoke.long_reads(40, k - 2, L)
    codes = codes[:, :L]
    H = 4
    rng = np.random.default_rng(k)
    contig_rows = codes[lengths >= k]
    win = np.concatenate([np.lib.stride_tricks.sliding_window_view(c[:n], k)
                          for c, n in zip(contig_rows, lengths[lengths >= k])])
    win = win[rng.random(win.shape[0]) < 0.9]  # some k-mers missing: errors
    solid, _ = kmer.kmer_words_batch_np(win, np.zeros(win.shape[0], np.int64), k)
    solid = np.unique(solid, axis=0)
    nw = bloom.choose_n_words(solid.shape[0], 8.0)
    bitset = bloom.build_np(solid, nw, H, SEED, k)
    packed = kmer.pack_codes_np(codes)
    B = codes.shape[0]
    cap = -(-(L - k) * B // 8) * 8
    ref = np.asarray(ref_walk.encode_batch_compact_packed(
        packed, lengths, _ref_bits(bitset, nw), k, H, np.uint32(nw), SEED, cap, cap,
        with_conf, L)).astype(np.uint16)
    tp, tl = state.packed_to_torch(packed, "cpu"), torch.from_numpy(lengths)
    tb = state.bitset_to_torch(bitset, "cpu")
    enc = walk.walk_encode_words(tp, tl, tb, nw, k, H, SEED, L, with_conf)
    buf = walk.walk_pack(enc, torch.cumsum(enc["tot"], dim=1), L, k, cap, cap, with_conf)
    np.testing.assert_array_equal(buf.numpy().view(np.uint16), ref)
    got, ce, cb = walk.encode_batch_compact_packed(tp, tl, tb, k, H, nw, SEED, None, None,
                                                   with_conf, L)
    unpacked = walk.unpack_compact(got.numpy().view(np.uint16), B, B, L, ce, cb, with_conf, k)
    assert unpacked["anchored"].sum() > B // 2 and len(unpacked["errgap_flat"])
    scal, eg, en, bf = chip_smoke.decode_inputs(unpacked, codes, lengths, k)
    W = ref_kmer.words_for_k(k)
    want = np.asarray(ref_walk.decode_batch_flat_packed(
        scal, _padded(eg.astype(np.uint16), L), _padded(en, L), _padded(bf, L),
        _ref_bits(bitset, nw), k, H, np.uint32(nw), SEED, L, W))
    args = (torch.from_numpy(scal), torch.from_numpy(eg), torch.from_numpy(en),
            torch.from_numpy(bf), tb, nw, k, H, SEED, L)
    dec = walk.decode_batch_flat_packed(*args).numpy().view(np.uint32)
    np.testing.assert_array_equal(dec, want)
    back = walk.unpack_codes_u32_np(dec, L)
    for i in np.flatnonzero(scal[:, 1]):
        np.testing.assert_array_equal(back[i, : lengths[i]], codes[i, : lengths[i]])
