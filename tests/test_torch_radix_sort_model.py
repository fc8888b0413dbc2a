"""Kernel K22 (csrc/sort.cu `radix_sort`) as the card runs it, on the CPU at
tolerance 0 (everything is integer).

A numpy model of the kernel's histogram (every digit's bucket offsets) and
of one pass (tiles of RADIX_TILE keys; a key's place: its digit's bucket
offset, plus the keys of its digit in the tiles before (the look-back), in
the warps before in its tile, and before it in its warp; the index payload
as int32 between a sort's first and last passes, as ops/count.py
`_radix_codes` asks) runs through the port's own pass driver
(`radix_drive`: the digits of the bits it is told the keys differ in, the
higher ones skipped, the two buffers in turn), and what it gives is held
against np.argsort(kind="stable") and the plain version
(torch.sort(stable=True)), keys and payloads, on chip_smoke.py's sort_case
(n = 0, 1, 2, one tile and one tile +- 1, equal keys, one varying digit at
the top or the bottom, a SENTINEL tail, both sides of the int64 sign, odd
and even pass counts over constant digits, many ties) over 64 bits and over
its SORT_BITS, and on the row source (sort_rows_case: keys read from rows'
top words, with and without idx). Then the counters built on the plain version
(DeviceCounter's slab, its merge of sorted runs (K23's plain route), sort_rows
at W = 2) against leon_tpu's _fused_sort_count, _merge_sorted_runs and
_hist_of_sorted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu.ops import count as ref_count
from leon_tpu_torch.ops import count
from leon_tpu_torch.ops.kmer import SENTINEL

TILE, WARP_KEYS = count.RADIX_TILE, count.RADIX_TILE // 8  # a tile; a warp's 32 x 16 keys
_SIGN = np.uint64(1 << 63)


def hist_model(u: np.ndarray) -> np.ndarray:
    """lt_radix_hist: the bucket offsets (8, 256) int64 of the unsigned keys u."""
    offsets = np.zeros((8, 256), np.int64)
    for d in range(8):
        c = np.bincount(((u >> np.uint64(8 * d)) & np.uint64(255)).astype(np.int64),
                        minlength=256)
        offsets[d] = np.cumsum(c) - c
    return offsets


def pass_model(u: np.ndarray, pays: list, d: int, offsets: np.ndarray):
    """One pass over digit d: each key's place from its tile (the look-back
    sum of the tiles before), its warp's offset in the tile and its rank in
    its warp, as rs_pass_kernel computes them. Returns (u, pays) placed."""
    n = u.size
    dig = ((u >> np.uint64(8 * d)) & np.uint64(255)).astype(np.int64)
    pos = np.empty(n, np.int64)
    excl = np.zeros(256, np.int64)  # the digit's keys in the tiles before
    for t0 in range(0, n, TILE):
        dt = dig[t0 : t0 + TILE]
        t = np.arange(dt.size)
        w = t // WARP_KEYS
        tot = np.bincount(dt, minlength=256)  # the counts the tile publishes
        tstart = np.cumsum(tot) - tot
        wcnt = np.zeros((8, 256), np.int64)
        np.add.at(wcnt, (w, dt), 1)
        wexcl = np.cumsum(wcnt, axis=0) - wcnt  # the warps before, a digit
        grp = w * 256 + dt  # a key's rank in its warp: its digit's keys before it there
        order = np.argsort(grp, kind="stable")
        first = np.searchsorted(grp[order], grp[order], side="left")
        rank = np.empty(dt.size, np.int64)
        rank[order] = np.arange(dt.size) - first
        place = tstart[dt] + wexcl[w, dt] + rank  # the key's place in the tile (staged)
        gbase = offsets[d] + excl - tstart
        pos[t0 : t0 + dt.size] = gbase[dt] + place
        excl += tot
    assert np.array_equal(np.sort(pos), np.arange(n))
    out = np.empty_like(u)
    out[pos] = u
    placed = []
    for p in pays:
        q = np.empty_like(p)
        q[pos] = p
        placed.append(q)
    return out, placed


def model_sort(u: np.ndarray, payload, bits: int = 64, index_src=None):
    """The driver over the models for a sort over the low `bits` bits, with
    the payload kinds the card would run (payload: None, an int32 array, or
    "index": index_src[i], or i): (keys sorted as int64, payload or None,
    passes, the payload's dtype pass by pass)."""
    n = u.size
    offsets = hist_model(u)
    if isinstance(payload, str):
        kind, first = count.RADIX_INDEX, index_src if index_src is not None else np.arange(n)
    else:
        kind = None if payload is None else torch.from_numpy(payload).dtype
        first = payload
    codes = count._radix_codes(kind, len(count.radix_passes(bits)))
    made, dtypes = [], []

    def alloc():
        made.append([None, None])
        return made[-1]

    def run_pass(src, dst, d, i):
        keys, pay = (u, first) if src is None else src
        code = codes[i]
        if code in (count._PAY_IDX32, count._PAY_I32):
            pay = pay.astype(np.int32)
        elif code in (count._PAY_IDX, count._PAY_I32W):
            pay = pay.astype(np.int64)
        out, placed = pass_model(keys, [] if pay is None else [pay], d, offsets)
        dst[0], dst[1] = out, placed[0] if pay is not None else None
        dtypes.append(None if pay is None else dst[1].dtype)

    res = count.radix_drive(bits, run_pass, alloc)
    n_pass = len(count.radix_passes(bits))
    assert res is made[(n_pass - 1) % 2] and len(made) == min(n_pass, 2)
    return (res[0] ^ _SIGN).view(np.int64), res[1], n_pass, dtypes


@pytest.mark.parametrize("name", chip_smoke.SORT_CASES)
def test_model_through_the_driver(name):
    """Keys alone, with an int32 payload and with the index, over 64 bits
    and over the case's SORT_BITS: the models through radix_drive equal
    np.argsort(kind="stable") and the plain version; the pass count is the
    number of digits of those bits (one at least), the output in buffer 0
    after an odd count; the index travels as int32 and comes out int64."""
    keys = chip_smoke.sort_case(name)
    n = keys.size
    u = keys.view(np.uint64) ^ _SIGN
    ref = np.argsort(keys, kind="stable")
    p32 = chip_smoke.sort_payload(n, len(name))
    kt = torch.from_numpy(keys)
    for bits in sorted({64, chip_smoke.SORT_BITS.get(name, 64)}):
        for pay in (None, p32, "index"):
            got_k, got_p, passes, dtypes = model_sort(u, pay, bits)
            assert passes == max(1, -(-bits // 8))
            np.testing.assert_array_equal(got_k, keys[ref])
            want = count.radix_sort_plain(kt, None if pay is None else
                                          torch.arange(n) if isinstance(pay, str) else
                                          torch.from_numpy(pay))
            if pay is None:
                np.testing.assert_array_equal(got_k, want.numpy())
                assert dtypes == [None] * passes
                continue
            np.testing.assert_array_equal(got_k, want[0].numpy())
            np.testing.assert_array_equal(got_p, want[1].numpy())
            if isinstance(pay, str):
                np.testing.assert_array_equal(got_p, ref)
                assert dtypes == ([np.int64] if passes == 1 else
                                  [np.int32] * (passes - 1) + [np.int64])
            else:
                np.testing.assert_array_equal(got_p, pay[ref])
                assert dtypes == [np.int32] * passes
        # the wrapper on the CPU is the plain version, contiguous or not
        np.testing.assert_array_equal(count.radix_sort(kt, bits=bits).numpy(), keys[ref])
        k, i = count.radix_sort_index(kt, bits)
        np.testing.assert_array_equal(i.numpy(), ref)
    if name in chip_smoke.SORT_BITS:  # the case's keys differ in no higher digit
        top = -(-chip_smoke.SORT_BITS[name] // 8)
        assert all(d < max(top, 1) for d in chip_smoke.SORT_DIGITS[name])
    wide = torch.stack([kt, -kt], dim=1)[:, 0]
    np.testing.assert_array_equal(count.radix_sort(wide).numpy(), keys[ref])


def _top_u(rows: np.ndarray) -> np.ndarray:
    """The rows' top 64 bits as the kernel's row source reads them."""
    r = rows.view(np.uint32).astype(np.uint64)
    W = r.shape[1]
    return r[:, 0] if W == 1 else (r[:, W - 1] << np.uint64(32)) | r[:, W - 2]


@pytest.mark.parametrize("W", chip_smoke.SORT_ROWS_WS)
def test_row_source(W):
    """The first pass reading each key from its row's top words (rows[idx]
    or rows), with the index (idx[i] or i) as payload, equals the plain
    route (_top_keys, then torch.sort(stable=True)) and np.argsort."""
    rows, idx = chip_smoke.sort_rows_case(W, 3 * TILE + 7, W)
    u_all = _top_u(rows)
    rt, it = torch.from_numpy(rows), torch.from_numpy(idx)
    for sel in (idx, None):
        u = u_all if sel is None else u_all[sel]
        got_k, got_p, _, _ = model_sort(u, "index", 64, sel)
        want_k, want_p = count.radix_sort_rows(rt, None if sel is None else it)
        np.testing.assert_array_equal(got_k, want_k.numpy())
        np.testing.assert_array_equal(got_p, want_p.numpy())
        keys = (u ^ _SIGN).view(np.int64)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(got_p, order if sel is None else sel[order])
        np.testing.assert_array_equal(
            count.radix_sort_rows(rt, None if sel is None else it, index=False).numpy(), got_k)
    # the one-plane widths: the top key is state.words_to_planes' plane
    if W <= 2:
        from leon_tpu_torch import state

        np.testing.assert_array_equal(count._top_keys(rt).numpy(),
                                      state.words_to_planes(rt)[0].numpy())


def test_codes_and_guards():
    """Pass kinds: an index as int32 only between a first and a last pass;
    the passes of the bits; the top keys' bits at k; bad arguments (a wrong
    bits claim among them) raise."""
    assert count._radix_codes(count.RADIX_INDEX, 1) == [count._PAY_IDX]
    assert count._radix_codes(count.RADIX_INDEX, 3) == [
        count._PAY_IDX32, count._PAY_I32, count._PAY_I32W]
    assert count._radix_codes(torch.int32, 2) == [count._PAY_I32] * 2
    assert count._radix_codes(None, 2) == [count._PAY_NONE] * 2
    assert count.radix_passes(0) == [0] and count.radix_passes(1) == [0]
    assert count.radix_passes(62) == list(range(8)) and count.radix_passes(48) == list(range(6))
    assert [count.top_key_bits(k) for k in (20, 32, 33, 48, 63, 64, 127, 255)] == [
        40, 64, 34, 64, 62, 64, 62, 62]
    with pytest.raises(ValueError):
        count.radix_sort(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        count.radix_sort(torch.zeros(4, dtype=torch.int64), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        count.radix_sort(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        count.radix_sort_rows(torch.zeros(4, 17, dtype=torch.int32))
    with pytest.raises(ValueError):
        count.radix_sort(torch.tensor([0, 1 << 40]), bits=40)
    with pytest.raises(ValueError):
        count.radix_sort_index(torch.tensor([-1, 0]), 63)
    count.radix_sort(torch.tensor([5, 1 << 40, 3]), bits=41)


def _key_words(keys: np.ndarray) -> tuple:
    """int64 keys < 2**62 as the reference's (hi, lo) u32 columns."""
    u = keys.view(np.uint64)
    return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def test_counters_match_reference():
    """DeviceCounter's slab (K22's keys alone, then K2) against leon_tpu's
    _fused_sort_count over the same k-mers (SENTINEL = invalid), its merge
    (K23 over sorted runs with their counts, then K2 with the histogram)
    against _merge_sorted_runs and _hist_of_sorted of the runs'
    concatenation, and sort_rows at W = 2 (the one-plane route: K22 reading
    the rows) the same."""
    keys = chip_smoke.sort_case("sentinel_tail")
    keys = np.where(keys == SENTINEL, keys, keys % 5000)  # duplicates
    n = keys.size
    counter = count.DeviceCounter(31, "cpu")
    uk, uc = counter._slab_run([torch.from_numpy(keys)])
    valid = keys != SENTINEL
    hi, lo = _key_words(np.where(valid, keys, 0))
    chunks = (jnp.stack([lo, hi], axis=1).reshape(1, n, 2),)
    skeys, boundary, cnt = ref_count._fused_sort_count(chunks, (jnp.asarray(valid)[None],), n, 31)
    b = np.asarray(boundary)
    ref_keys = ((np.asarray(skeys[0]).astype(np.uint64) << np.uint64(32))
                | np.asarray(skeys[1]).astype(np.uint64))[b].view(np.int64)
    np.testing.assert_array_equal(uk.numpy(), ref_keys)
    np.testing.assert_array_equal(uc.numpy(), np.asarray(cnt)[b])
    # a merge of the run, a third of it again, and the run reversed
    mk = np.concatenate([ref_keys, ref_keys[::3], ref_keys[::-1]])
    rng = np.random.default_rng(7)
    mc = chip_smoke.tie_counts(mk.size, 5)
    mk, mc = mk[rng.permutation(mk.size)], mc
    # the merge takes sorted runs: three stretches of (mk, mc), each sorted
    # stably with its counts
    parts = []
    for a, b in ((0, mk.size // 3), (mk.size // 3, mk.size // 2), (mk.size // 2, mk.size)):
        o = np.argsort(mk[a:b], kind="stable")
        parts.append((torch.from_numpy(mk[a:b][o]), torch.from_numpy(mc[a:b][o])))
    gk, gc, gh = counter._merge_sorted(parts, True)
    sk, bd, summed = ref_count._merge_sorted_runs(_key_words(mk), jnp.asarray(mc))
    bd = np.asarray(bd)
    rk = ((np.asarray(sk[0]).astype(np.uint64) << np.uint64(32))
          | np.asarray(sk[1]).astype(np.uint64))[bd].view(np.int64)
    np.testing.assert_array_equal(gk.numpy(), rk)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(summed)[bd])
    np.testing.assert_array_equal(gh.numpy(), np.asarray(ref_count._hist_of_sorted(bd, summed)))
    # the WordCounter's merge at W = 2: sort_rows reads the one plane from the rows
    words = np.stack([(mk.view(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      (mk.view(np.uint64) >> np.uint64(32)).astype(np.uint32)], axis=1)
    planes, pc = count.sort_rows(torch.from_numpy(words.view(np.int32)), torch.from_numpy(mc))
    uw, uv, uh = count.word_runs_plain(planes, 2, pc, 1, True)
    uw = uw.numpy().view(np.uint32).astype(np.uint64)
    np.testing.assert_array_equal(((uw[:, 1] << np.uint64(32)) | uw[:, 0]).view(np.int64), rk)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(summed)[bd])
    np.testing.assert_array_equal(uh.numpy(), gh.numpy())
