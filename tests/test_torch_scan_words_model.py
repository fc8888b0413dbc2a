"""K13 `kmer_scan_words` as the card runs it: a numpy model of its design
(csrc/kmer.cu) against leon_tpu's kmer_scan and the port's plain version,
on chip_smoke.py's k13_case at k = 1, 5, 15, 16, 17, 31, 32, 33, 63, 64,
65, 127, 128, 255 (chip_smoke.K13_KS), L mod 16 = 0, 1, 15, and on rows
longer than one job (chip_smoke.K13_LONG).

The model keeps what the kernel keeps: the jobs of the C entry (R whole
reads, or K13_POS positions of one read), a job's code bytes packed 16
columns to a word (byte & 3, zero past column L-1) with a zero pad word
after the last word its positions read, each position's k-mer cut from
those words (funnel shifts, ~x as the reverse complement, rev2 for the
forward strand), and the reference's roll over columns [j - 16W + 1, j]
where a byte above 3 lies there (j: the window's last column). The byte
loads (aligned u32 words, funnel-shifted by the row's offset, the bytes
past the row masked) and their packing and dirty masks are modelled bit
for bit on every offset and length. Everything is integer: the tolerance
is 0."""

import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu_torch.ops import kmer

M32 = 0xFFFFFFFF
POS, CODE_WORDS = 2048, 2048  # csrc/kmer.cu K13_POS, K13_CODE_WORDS
U = np.uint64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain version's many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the byte loads: load16, pack4, dirty4
# ---------------------------------------------------------------------------


def pack4(x):
    t = x & 0x03030303
    t |= t >> 6
    return (t & 0xF) | ((t >> 12) & 0xF0)


def dirty4(x):
    m = ((((x >> 2) & 0x3F3F3F3F) + 0x7F7F7F7F) & 0x80808080) & M32
    return ((m >> 7) & 1) | ((m >> 14) & 2) | ((m >> 21) & 4) | ((m >> 28) & 8)


def load16(buf: bytes, start: int, L: int, g: int):
    """K13's load of columns 16g .. 16g + 15 of the row at byte `start` of
    buf (an allocation aligned to 4 bytes): the aligned words holding them,
    funnel-shifted by the row's offset, bytes past the row masked."""
    nb = min(16, L - 16 * g)
    a = start + 16 * g
    off, base = a & 3, a & ~3
    nw = (off + nb + 3) >> 2
    v = [int.from_bytes(buf[base + 4 * i : base + 4 * i + 4], "little") if i < nw else 0
         for i in range(5)]
    p = d = 0
    for i in range(4):
        x = (((v[i + 1] << 32) | v[i]) >> (8 * off)) & M32
        keep = nb - 4 * i
        x = x if keep >= 4 else 0 if keep <= 0 else x & ((1 << (8 * keep)) - 1)
        p |= pack4(x) << (8 * i)
        d |= dirty4(x) << (4 * i)
    return p, d


def test_load16_packs_and_marks_every_offset():
    """Every row offset 0..3 and column count 1..16: the packed word is
    pack_codes_np of the bytes & 3 and the mask marks the bytes above 3,
    whatever lies around the row."""
    rng = np.random.default_rng(16)
    for off in range(4):
        for nb in range(1, 17):
            for _ in range(8):
                row = rng.choice(np.array([0, 1, 2, 3, 4, 7, 0x80, 0xFC, 0xFF], np.uint8), nb)
                buf = rng.integers(0, 256, off + nb + 8, dtype=np.uint8)
                buf[off : off + nb] = row
                p, d = load16(buf.tobytes(), off, nb, 0)
                want = kmer.pack_codes_np((row & 3)[None, :])[0, 0]
                assert p == int(want)
                assert d == sum(1 << j for j in range(nb) if row[j] > 3)


# ---------------------------------------------------------------------------
# the kernel's design, vectorised over positions
# ---------------------------------------------------------------------------


def rev2(x):
    r = np.zeros_like(x)
    for g in range(16):
        r |= ((x >> U(2 * g)) & U(3)) << U(30 - 2 * g)
    return r


def funnel(lo, hi, sh):
    return (((hi << U(32)) | lo) >> sh) & U(M32)


def lex_less(a, b):
    less = np.zeros(a.shape[0], bool)
    eq = np.ones(a.shape[0], bool)
    for j in range(a.shape[1] - 1, -1, -1):
        less |= eq & (a[:, j] < b[:, j])
        eq &= a[:, j] == b[:, j]
    return less


def jobs_p1(P: int, L: int, p):
    """The end of the job holding position p (the C entry's split)."""
    if P <= POS:
        return np.full_like(p, P)
    return np.minimum(P, (p // POS) * POS + POS)


def model_cut(codes, k):
    """(canon (B*P, W) u64, is_rc) cut from each job's packed words."""
    B, L = codes.shape
    W, P = kmer.words_for_k(k), L - k + 1
    top, s = U(kmer.top_mask(k)), U(2 * (16 * W - k))
    packed = kmer.pack_codes_np(codes & 3).astype(U)
    packed = np.concatenate([packed, np.zeros((B, W + 2), U)], axis=1)
    p = np.tile(np.arange(P), B)
    b = np.repeat(np.arange(B), P)
    ge = (jobs_p1(P, L, p) + k - 1 + 15) >> 4  # the job's pad word
    a = p >> 4

    def word(i):
        return np.where(a + i < ge, packed[b, a + i], U(0))

    sh = U(2) * (p & 15).astype(U)
    x = [funnel(word(i), word(i + 1), sh) for i in range(W)]
    x[W - 1] &= top
    rc = np.stack([~xi & U(M32) for xi in x], axis=1)
    rc[:, W - 1] &= top
    fwd = np.stack([funnel(rev2(x[W - 1 - j]), rev2(x[W - 2 - j]) if j + 1 < W else 0 * x[0], s)
                    for j in range(W)], axis=1)
    take = lex_less(rc, fwd)
    return np.where(take[:, None], rc, fwd), take


def shl2(w, c, top):
    o = np.empty_like(w)
    o[:, 0] = ((w[:, 0] << U(2)) | c) & U(M32)
    for j in range(1, w.shape[1]):
        o[:, j] = ((w[:, j] << U(2)) | (w[:, j - 1] >> U(30))) & U(M32)
    o[:, -1] &= top
    return o


def shr2_ins(w, c, k):
    o = np.empty_like(w)
    for j in range(w.shape[1] - 1):
        o[:, j] = ((w[:, j] >> U(2)) | (w[:, j + 1] << U(30))) & U(M32)
    o[:, -1] = w[:, -1] >> U(2)
    t = 2 * (k - 1)
    o[:, t // 32] |= (c << U(t % 32)) & U(M32)
    return o


def model_roll(codes, k, b, p):
    """The reference's u32 roll over columns [j - 16W + 1, j] (from 0) of
    positions (b, p), from a zero state."""
    W = kmer.words_for_k(k)
    top = U(kmer.top_mask(k))
    j = p + k - 1
    fwd = np.zeros((b.size, W), U)
    rc = np.zeros_like(fwd)
    for e in range(16 * W):
        col = j - 16 * W + 1 + e
        on = col >= 0
        c = codes[b, np.maximum(col, 0)].astype(U)
        f2, r2 = shl2(fwd, c, top), shr2_ins(rc, (U(3) - c) & U(M32), k)
        fwd = np.where(on[:, None], f2, fwd)
        rc = np.where(on[:, None], r2, rc)
    take = lex_less(rc, fwd)
    return np.where(take[:, None], rc, fwd), take


def reach(codes, k):
    """(B*P,) bool: a byte above 3 lies in columns [j - 16W + 1, j]."""
    B, L = codes.shape
    W, P = kmer.words_for_k(k), L - k + 1
    cnt = np.concatenate([np.zeros((B, 1), np.int64), np.cumsum(codes > 3, axis=1)], axis=1)
    j = np.arange(P) + k - 1
    lo = np.maximum(0, j - 16 * W + 1)
    return ((cnt[:, j + 1] - cnt[:, lo]) > 0).reshape(-1)


def model_scan(codes, lengths, k):
    B, L = codes.shape
    W, P = kmer.words_for_k(k), L - k + 1
    canon, take = model_cut(codes, k)
    d = reach(codes, k)
    if d.any():
        i = np.flatnonzero(d)
        canon[i], take[i] = model_roll(codes, k, i // P, i % P)
    valid = np.arange(P)[None, :] <= lengths[:, None].astype(np.int64) - k
    return canon.astype(np.uint32).reshape(B, P, W), take.reshape(B, P), valid


def check(codes, lengths, k):
    got = model_scan(codes, lengths, k)
    want = [np.asarray(a) for a in ref_kmer.kmer_scan(codes, lengths, k)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    plain = kmer.kmer_scan_words(torch.from_numpy(codes), torch.from_numpy(lengths), k)
    np.testing.assert_array_equal(plain[0].numpy().view(np.uint32), want[0])
    np.testing.assert_array_equal(plain[1].numpy(), want[1])
    np.testing.assert_array_equal(plain[2].numpy(), want[2])
    return got


@pytest.mark.parametrize("mod", chip_smoke.K13_L_MOD16)
@pytest.mark.parametrize("k", chip_smoke.K13_KS)
def test_model_matches_reference(k, mod):
    codes, lengths = chip_smoke.k13_case(k, mod, 24)
    canon, take, _ = check(codes, lengths, k)
    assert take.any() and not take.all()
    # the reach is real: where a byte above 3 lies only before a window (in
    # its rc reach of 16W - k positions, when that is 8 or more), the plain
    # cut differs from the reference somewhere
    W = kmer.words_for_k(k)
    if 16 * W - k >= 8:
        cut = model_cut(codes, k)[0].astype(np.uint32).reshape(canon.shape)
        B, L = codes.shape
        P = L - k + 1
        inside = np.zeros((B, P), bool)
        for r, c in zip(*np.nonzero(codes > 3)):
            inside[r, max(0, c - k + 1) : min(P, c + 1)] = True
        before = reach(codes, k).reshape(B, P) & ~inside
        assert before.any()
        assert (cut[before] != canon[before]).any()


@pytest.mark.parametrize("k,L", chip_smoke.K13_LONG)
def test_model_long_rows(k, L):
    """Rows of more positions than one job: the jobs' pad words."""
    codes, lengths = chip_smoke.k13_case(k, 1, 4, L)
    assert L - k + 1 > POS
    check(codes, lengths, k)


def test_jobs_fit_the_block():
    """Whole-read jobs hold their reads' packed words and pad in
    K13_CODE_WORDS at every P <= K13_POS (the C entry's R >= 1); a job of
    K13_POS positions holds its words too."""
    for k in (1, 16, 17, 255):
        for P in (1, 2, 100, POS - 1, POS):
            L = P + k - 1
            L16 = (L + 15) // 16
            R = max(1, min(POS // P, CODE_WORDS // (L16 + 1)))
            assert R * (L16 + 1) <= CODE_WORDS
        W = kmer.words_for_k(k)
        for p0 in (0, POS, 5 * POS):
            g0 = max(0, p0 + k - 16 * W) >> 4
            assert ((p0 + POS + k - 1 + 15) >> 4) - g0 + 1 <= CODE_WORDS
