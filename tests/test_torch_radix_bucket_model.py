"""K22's bucket route (csrc/sort.cu: a pass of K22 over each of the
bucket's bytes, then K24 radix_bucket and K25 radix_oversize) as the card
runs it, on the CPU at tolerance 0 (everything is integer).

A numpy model of each kernel, with the block capacity C (K24's BUCKET_CAP),
its share (C / 2), the largest bucket a round ranks (C / 16; the card's
BUCKET_RANK) and the pass tile as parameters, so that small inputs reach
every path: the histogram of the bucket's bytes (16 bits, or 24: the
tests run both, named as the wrappers' `route`) and its passes (tiles, warps,
look-back sums; bucket_drive, the port's own driver, runs them), the shares'
first bucket starts (bs_edge_kernel), each block's rounds and the oversize
bucket it lists (bs_bucket_kernel), a round's sort (where its buckets are
small, each key placed at its bucket's start plus its rank there; else each
thread's 8 keys sorted by odd-even transposition, then merge levels: a pair
already in order left as it is, else each thread's merge-path search and
serial merge), and the oversize buckets (their digit histograms, the live
digits, a pass for each through the two key buffers in turn, the last
writing the payload out, the copy of a bucket left in the second buffer).
What it gives is held against np.argsort(kind="stable") and the plain version
(torch.sort(stable=True)), keys and payloads, on chip_smoke.py's sort_case
and bucket_case inputs (a SENTINEL-heavy slab, one bucket, equal keys,
buckets of C - 1, C and C + 1 keys and shares that end inside a bucket, half
the keys one key) at bits = 17, 31, 42, 62 and 64: keys alone, with an int32
payload, with the index, and read from rows (bucket_rows) at W = 1, 2, 3, 4,
8, 16 with and without idx, merged rounds of 1 to 256 keys, and ranked
rounds. The models take the bucket route at every width the bucket leaves
a bit below; the route the card takes for (n, bits) is checked apart
(test_route)."""

import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu_torch.ops import count

_SIGN = np.uint64(1 << 63)
IPT = 8  # keys a K24 thread sorts and merges (csrc/sort.cu BS_IPT)
CAPS = (64, 256)  # the model's capacities C (the card's: count.BUCKET_CAP)
TILE = 128  # the model's pass tile (the card's: count.RADIX_TILE)
WIDTHS = (count.BUCKET_BITS, count.BUCKET_WIDE_BITS)  # the bucket's bits


def rank_of(C: int) -> int:
    """The largest bucket a round of capacity C ranks (the card's
    count.BUCKET_RANK at BUCKET_CAP)."""
    return C // 16


def dense_of(C: int) -> int:
    """The most keys a bucket, on average, of a round that a round of
    capacity C ranks (the card's count.BUCKET_DENSE)."""
    return rank_of(C) // 2


def digit_of(u: np.ndarray, shift: int) -> np.ndarray:
    return ((u >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)


def pass_model(u: np.ndarray, pays: list, shift: int, offsets: np.ndarray, tile: int,
               origin: int = 0) -> tuple:
    """K22's tile pass over the digit at `shift` of keys u: each key's place
    from its digit's offset (offsets (256,)), the digit's keys in the tiles
    before (the look-back), in the warps before it in its tile and before it
    in its warp. Returns (places, u placed, pays placed: place - origin)."""
    n = u.size
    dig = digit_of(u, shift)
    pos = np.empty(n, np.int64)
    excl = np.zeros(256, np.int64)
    warp_keys = tile // 8
    for t0 in range(0, n, tile):
        dt = dig[t0 : t0 + tile]
        w = np.arange(dt.size) // warp_keys
        tot = np.bincount(dt, minlength=256)
        tstart = np.cumsum(tot) - tot
        wcnt = np.zeros((8, 256), np.int64)
        np.add.at(wcnt, (w, dt), 1)
        wexcl = np.cumsum(wcnt, axis=0) - wcnt
        grp = w * 256 + dt
        order = np.argsort(grp, kind="stable")
        first = np.searchsorted(grp[order], grp[order], side="left")
        rank = np.empty(dt.size, np.int64)
        rank[order] = np.arange(dt.size) - first
        pos[t0 : t0 + dt.size] = offsets[dt] + excl[dt] + wexcl[w, dt] + rank
        excl += tot
    out = np.empty_like(u)
    out[pos - origin] = u
    placed = []
    for p in pays:
        q = np.empty_like(p)
        q[pos - origin] = p
        placed.append(q)
    return pos, out, placed


def round_model(u: np.ndarray, p: np.ndarray) -> tuple:
    """One merged K24 round of m keys: each thread's IPT keys sorted in
    registers by odd-even transposition (a key moves up only past a greater
    one), then merge levels of runs R = IPT, 2 IPT, ...: a pair already in
    order (its first run's last key <= its second's first) left as it is,
    else each thread's IPT outputs from a merge-path search and a serial
    merge (the first run's key on a tie). Returns (u, p) sorted."""
    m = u.size
    k, v = [int(x) for x in u], [int(x) for x in p]
    for o in range(0, m, IPT):
        kk, vv = k[o : o + IPT], v[o : o + IPT]
        for r in range(IPT):
            for q in range(r & 1, len(kk) - 1, 2):
                if kk[q] > kk[q + 1]:
                    kk[q], kk[q + 1] = kk[q + 1], kk[q]
                    vv[q], vv[q + 1] = vv[q + 1], vv[q]
        k[o : o + IPT], v[o : o + IPT] = kk, vv
    R = IPT
    while R < m:
        nk, nv = list(k), list(v)
        for o in range(0, m, IPT):
            ps = o & ~(2 * R - 1)
            na, nb = min(R, m - ps), min(R, m - ps - R)
            if nb <= 0 or k[ps + R - 1] <= k[ps + R]:
                continue  # the pair is in order
            diag = o - ps
            cnt = min(IPT, na + nb - diag)
            lo, hi = max(0, diag - nb), min(diag, na)
            while lo < hi:
                mid = (lo + hi) >> 1
                if k[ps + mid] <= k[ps + R + diag - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, diag - lo
            for q in range(cnt):
                ta = j >= nb or (i < na and k[ps + i] <= k[ps + R + j])
                src = ps + i if ta else ps + R + j
                nk[o + q], nv[o + q] = k[src], v[src]
                i, j = (i + 1, j) if ta else (i, j + 1)
        k, v = nk, nv
        R <<= 1
    return np.array(k, np.uint64), np.array(v, np.int64)


def rank_model(u: np.ndarray, p: np.ndarray, L: int, S: int, D: int):
    """K24's rank route over a round of whole buckets (keys u >> L equal):
    None if a bucket holds more than S keys (key i's bucket is key i + S's)
    or they hold more than D keys on average (m > D x the bucket starts),
    else each key at its bucket's first place (found walking back) plus its
    rank there (the bucket's keys that are smaller, or equal and before it),
    as (u, p) sorted."""
    m = u.size
    b = u >> np.uint64(L)
    if m > S and np.any(b[: m - S] == b[S:]):
        return None
    if m > D * (1 + int(np.count_nonzero(b[1:] != b[:-1]))):
        return None
    ku, kp = np.empty_like(u), np.empty_like(p)
    for i in range(m):
        lo = i
        while lo > 0 and b[lo - 1] == b[i]:
            lo -= 1
        r, j = 0, lo
        while j < m and b[j] == b[i]:
            r += int(u[j] < u[i] or (u[j] == u[i] and j < i))
            j += 1
        ku[lo + r], kp[lo + r] = u[i], p[i]
    return ku, kp


def bucket_model(buf1: list, buf0: list, n: int, bits: int, B: int, C: int, tile: int) -> list:
    """K24 and K25 over the keys buf1 = [u, pay] (pay int32 or None),
    grouped by bucket (their top B of `bits` bits), into buf0 = [u,
    scratch] (its contents scratch): the keys sorted
    into buf0[0], the payload into the returned final array. Records what
    the card would list: the lists of rounds and oversize buckets."""
    u1, p1 = buf1
    u0, p0 = buf0
    L = bits - B
    bkt = u1 >> np.uint64(L)
    assert np.all(bkt[1:] >= bkt[:-1])  # the passes left the buckets ascending
    S = C // 2
    shares = -(-n // S)
    E = np.empty(shares + 1, np.int64)
    E[0], E[shares] = 0, n
    for e in range(1, shares):  # bs_edge_kernel
        p = e * S
        E[e] = p if bkt[p - 1] != bkt[p] else np.searchsorted(bkt, bkt[p], side="right")
    final = None if p1 is None else np.zeros(n, np.int64)
    rounds, segs = [], []
    for b in range(shares):  # bs_bucket_kernel
        s, e = int(E[b]), int(E[b + 1])
        if s >= e:
            continue
        cut = e
        if e - s > C:
            cut = int(np.searchsorted(bkt[s : e - 1], bkt[e - 1], side="left")) + s
            if e - cut > C:
                segs.append((cut, e - cut))
                e = cut
        for a, z in ((s, cut), (cut, e)):
            if z > a:
                assert z - a <= C and (a == 0 or bkt[a - 1] != bkt[a])
                assert z == n or bkt[z - 1] != bkt[z]  # whole buckets
                pz = np.zeros(z - a, np.int64) if p1 is None else p1[a:z]
                ranked = rank_model(u1[a:z], pz, L, rank_of(C), dense_of(C))
                rounds.append((a, z, "merge" if ranked is None else "rank"))
                su, sp = round_model(u1[a:z], pz) if ranked is None else ranked
                u0[a:z] = su
                if final is not None:
                    final[a:z] = sp
    digits = count.bucket_digits(bits, B)
    for s, m in segs:  # K25: its live digits, a pass each, the finish copy
        assert m > C and np.all(bkt[s : s + m] == bkt[s])
        hist = [np.bincount(digit_of(u1[s : s + m], 8 * d), minlength=256) for d in range(digits)]
        live = [d for d in range(digits) if hist[d].max() < m]
        keys, pays = [u0, u1], [p0, p1]  # by buffer: j even reads buffer 1
        for j, d in enumerate(live):
            src, dst = (1, 0) if j % 2 == 0 else (0, 1)
            offs = s + np.cumsum(hist[d]) - hist[d]
            sp = [] if p1 is None else [pays[src][s : s + m]]
            pos, placed_u, placed_p = pass_model(keys[src][s : s + m], sp, 8 * d, offs, tile, s)
            assert np.array_equal(np.sort(pos), np.arange(s, s + m))
            keys[dst][s : s + m] = placed_u
            if p1 is not None:
                (final if j == len(live) - 1 else pays[dst])[s : s + m] = placed_p[0]
        if len(live) % 2 == 0:
            u0[s : s + m] = u1[s : s + m]
            if p1 is not None and not live:
                final[s : s + m] = p1[s : s + m]
    bucket_model.last = (rounds, segs)
    return final


def model_sort(u: np.ndarray, payload, bits: int, C: int, route: tuple, index_src=None,
               tile: int = TILE):
    """The block or bucket route (as radix_route names it) over the models:
    (keys sorted as int64, payload or None). payload: None, an int32 array,
    or "index" (index_src[i], or i)."""
    n = u.size
    route, B = count.check_route(n, bits, route, C)
    if isinstance(payload, str):
        first = (index_src if index_src is not None else np.arange(n)).astype(np.int64)
    else:
        first = None if payload is None else payload.astype(np.int64)
    if route == "block":
        su, sp = round_model(u, np.zeros(n, np.int64) if first is None else first)
        return (su ^ _SIGN).view(np.int64), None if first is None else sp
    assert route == "bucket"
    L = bits - B
    passes = B // 8
    v = u >> np.uint64(L)
    offsets = [np.cumsum(c) - c for c in
               (np.bincount(digit_of(v, 8 * d), minlength=256) for d in range(passes))]
    made = []

    def alloc():
        made.append([None, None])
        return made[-1]

    def run_pass(src, dst, d, i):
        keys, pay = (u, first) if src is None else src
        _, dst[0], placed = pass_model(keys, [] if pay is None else [pay], L + 8 * d,
                                       offsets[d], tile)
        dst[1] = None if pay is None else placed[0]

    def run_buckets(src, dst):
        dst[0] = dst[0].copy()
        dst[1] = bucket_model(src, dst, n, bits, B, C, tile)

    res = count.bucket_drive(run_pass, run_buckets, alloc, passes)
    assert res is made[passes % 2] and len(made) == 2
    return (res[0] ^ _SIGN).view(np.int64), res[1]


def route_of(n: int, C: int, B: int) -> tuple:
    """The route the models take for n keys: one block up to C keys, else
    the bucket route with buckets of B bits."""
    return ("bucket", B) if n > C else ("block", 0)


def check(keys: np.ndarray, bits: int, C: int, B: int, pay_seed: int) -> None:
    """The models on keys alone, with an int32 payload, with the index, by
    route_of(n, C, B), against np.argsort(kind="stable") and the plain
    version."""
    n = keys.size
    route = route_of(n, C, B)
    u = keys.view(np.uint64) ^ _SIGN
    ref = np.argsort(keys, kind="stable")
    p32 = chip_smoke.sort_payload(n, pay_seed)
    kt = torch.from_numpy(keys)
    for pay in (None, p32, "index"):
        got_k, got_p = model_sort(u, pay, bits, C, route)
        np.testing.assert_array_equal(got_k, keys[ref])
        if pay is None:
            np.testing.assert_array_equal(got_k, count.radix_sort_plain(kt).numpy())
            continue
        want = count.radix_sort_plain(
            kt, torch.arange(n) if isinstance(pay, str) else torch.from_numpy(pay))
        np.testing.assert_array_equal(got_k, want[0].numpy())
        np.testing.assert_array_equal(got_p, want[1].numpy())
        np.testing.assert_array_equal(got_p, ref if isinstance(pay, str) else pay[ref])
    # the wrapper on the CPU (the plain version), with the bits claim checked
    np.testing.assert_array_equal(count.radix_sort(kt, bits=bits).numpy(), keys[ref])
    np.testing.assert_array_equal(count.radix_sort_index(kt, bits)[1].numpy(), ref)
    if n > C:  # the route named to the wrapper, checked against n and bits
        got = count.radix_sort_index(kt, bits, route=("bucket", B))
        np.testing.assert_array_equal(got[1].numpy(), ref)


@pytest.mark.parametrize("bb", WIDTHS)
@pytest.mark.parametrize("C", CAPS)
@pytest.mark.parametrize("name", chip_smoke.SORT_CASES)
def test_sort_cases(name, C, bb):
    """chip_smoke.py's sort_case inputs (one tile and 123 keys of the card's
    passes) over 64 bits and over the case's SORT_BITS, with buckets of bb
    bits where they leave a bit below them."""
    keys = chip_smoke.sort_case(name, tiles=1)
    for bits in sorted({64, chip_smoke.SORT_BITS.get(name, 64)}):
        if bb < bits:
            check(keys, bits, C, bb, len(name))


# (bits, the bucket's bits): each width where the keys use more bits
BUCKET_WIDTHS = [(bits, bb) for bits in chip_smoke.BUCKET_SORT_BITS for bb in WIDTHS
                 if bb < bits]


@pytest.mark.parametrize("C", CAPS)
@pytest.mark.parametrize("bits,bb", BUCKET_WIDTHS)
@pytest.mark.parametrize("name", chip_smoke.BUCKET_SORT_CASES)
def test_bucket_cases(name, bits, bb, C):
    """bucket_case at each bits and bucket width: the oversize buckets and
    the rounds the card would run, ranked or merged, then the sorts exact."""
    keys = chip_smoke.bucket_case(name, bits, C, bb)
    check(keys, bits, C, bb, bits)
    u = keys.view(np.uint64) ^ _SIGN
    route = ("bucket", bb)
    model_sort(np.sort(u), None, bits, C, route)  # sorted input: only whole buckets move
    model_sort(u, None, bits, C, route)
    rounds, segs = bucket_model.last
    sizes = np.unique(u >> np.uint64(bits - bb), return_counts=True)[1]
    assert sorted(m for _, m in segs) == sorted(sizes[sizes > C].tolist())
    assert sum(z - a for a, z, _ in rounds) + sum(m for _, m in segs) == keys.size
    su = np.sort(u)  # the keys of positions a:z of the grouped keys
    for a, z, how in rounds:  # ranked where its buckets are small (rank_of, dense_of)
        sizes = np.unique(su[a:z] >> np.uint64(bits - bb), return_counts=True)[1]
        small = sizes.max() <= rank_of(C) and z - a <= dense_of(C) * sizes.size
        assert how == ("rank" if small else "merge")
    if name == "cap_edges":  # C - 1 and C keys sort in a round, C + 1 is oversize
        assert sorted(m for _, m in segs) == [C + 1, C + 1, 3 * C + 5]
        assert "merge" in {how for _, _, how in rounds}
    if name == "sentinel_heavy" and bits >= 31:  # small buckets beside the SENTINEL's
        assert "rank" in {how for _, _, how in rounds}
    if name == "equal":  # one bucket, no live digit: K25 copies it
        assert segs == [(0, keys.size)]


@pytest.mark.parametrize("bb", WIDTHS)
@pytest.mark.parametrize("W", chip_smoke.SORT_ROWS_WS)
def test_row_source(W, bb):
    """The first pass (or the block route's load) reading each key from its
    row's top words (rows[idx] or rows), with the index (idx[i] or i): the
    models equal the plain route (_top_keys, then torch.sort) and
    np.argsort, on cap_edges at 42 bits (a key of W = 1 is its row's word
    0) and on a block-route input, with buckets of bb bits."""
    C = CAPS[0]
    for keys, bits in ((chip_smoke.bucket_case("cap_edges", 42, C, bb), 42),
                       (chip_smoke.bucket_case("one_bucket", 31, C, bb)[: C - 3], 31)):
        rows, idx = chip_smoke.bucket_rows(keys, W, W)
        r = rows.view(np.uint32).astype(np.uint64)
        u_all = r[:, 0] if W == 1 else (r[:, W - 1] << np.uint64(32)) | r[:, W - 2]
        rt, it = torch.from_numpy(rows), torch.from_numpy(idx)
        for sel in (idx, None):
            u = u_all if sel is None else u_all[sel]
            got_k, got_p = model_sort(u, "index", 64 if sel is None else bits, C,
                                      route_of(u.size, C, bb), sel)
            want_k, want_p = count.radix_sort_rows(rt, None if sel is None else it)
            np.testing.assert_array_equal(got_k, want_k.numpy())
            np.testing.assert_array_equal(got_p, want_p.numpy())
            order = np.argsort((u ^ _SIGN).view(np.int64), kind="stable")
            np.testing.assert_array_equal(got_p, order if sel is None else sel[order])


@pytest.mark.parametrize("name", chip_smoke.BUCKET_SORT_CASES)
def test_round_merges(name):
    """A merged K24 round on rounds of 1 to 256 keys of each bucket_case, in
    any order (the block route's): keys and payload equal a stable sort."""
    keys = chip_smoke.bucket_case(name, 64, CAPS[1])
    u = keys.view(np.uint64) ^ _SIGN
    for m in (1, 7, 8, 9, 31, 63, 64, 65, 200, 256):
        su, sp = round_model(u[:m], np.arange(m))
        ref = np.argsort(keys[:m], kind="stable")
        np.testing.assert_array_equal(sp, ref)
        np.testing.assert_array_equal(su, u[:m][ref])


@pytest.mark.parametrize("name", chip_smoke.BUCKET_SORT_CASES)
def test_rank_rounds(name):
    """K24's rank route on rounds of whole buckets cut from each bucket_case
    (sorted by bucket, each bucket's keys in their order): exact against a
    stable sort where every bucket holds at most S keys, refused (merged)
    where one holds S + 1, at S = 4 and 16 (the card's: count.BUCKET_RANK);
    a round of buckets of 3 keys refused where the buckets may hold 2 keys
    on average (D), ranked at 3."""
    keys = chip_smoke.bucket_case(name, 64, CAPS[1], 24)
    u = keys.view(np.uint64) ^ _SIGN
    for S in (rank_of(c) for c in CAPS):
        D = S  # the density the cut rounds below pass
        for L in (40, 56, 62):
            b = u >> np.uint64(L)
            g = u[np.argsort(b, kind="stable")]
            ends = np.flatnonzero(np.diff(g >> np.uint64(L))) + 1
            for a, z in zip(np.r_[0, ends], np.r_[ends, g.size]):
                for m in (z - a, min(z - a, S), min(z - a, S + 1)):
                    part = g[a : a + m]
                    got = rank_model(part, np.arange(m), L, S, D)
                    if m > S:
                        assert got is None
                        continue
                    ref = np.argsort(part, kind="stable")
                    np.testing.assert_array_equal(got[0], part[ref])
                    np.testing.assert_array_equal(got[1], ref)
        # a round of several small buckets
        b = u >> np.uint64(62)
        g = np.concatenate([u[b == v][:S] for v in np.unique(b)])
        got = rank_model(g, np.arange(g.size), 62, S, D)
        ref = np.argsort(g, kind="stable")
        np.testing.assert_array_equal(got[1], ref)
        # the density: ten buckets of 3 keys, ranked at D = 3, merged at D = 2
        g = (np.repeat(np.arange(10, dtype=np.uint64), 3) << np.uint64(40)) | (
            np.arange(30, dtype=np.uint64)[::-1] % np.uint64(7))
        got = rank_model(g, np.arange(30), 40, S, 3)
        np.testing.assert_array_equal(got[1], np.argsort(g, kind="stable"))
        assert rank_model(g, np.arange(30), 40, S, 2) is None


def test_route():
    """The host's route from n and bits alone: the passes at bits <= 16 (as
    _tie_rounds' short sorts), from 2**31 keys, and past the capacity below
    BUCKET_MIN_BITS or at 64 bits (DeviceCounter's slab); one block up to
    the capacity; else the bucket route, its buckets of 24 bits past
    BUCKET_WIDE_N keys; a route named to the wrappers checked against n and
    bits; the digits K25 may pass over."""
    cap = count.BUCKET_CAP
    assert count.BUCKET_MIN_BITS == 41
    assert count.radix_route(cap + 1, 40) == count.radix_route(10**7, 34) == ("passes", 0)
    assert count.radix_route(cap + 1, 41) == ("bucket", 16)
    assert count.radix_route(cap, 40) == count.radix_route(1, 17) == ("block", 0)
    assert count.radix_route(10**7, 16) == count.radix_route(5, 1) == ("passes", 0)
    assert count.radix_route(1 << 31, 62) == count.radix_route(37_000_000, 64) == ("passes", 0)
    assert count.radix_route(cap, 64) == ("block", 0)
    assert count.radix_route(24_800_000, 62) == count.radix_route(2_488_405, 62) == ("bucket", 24)
    assert count.radix_route(14_466_187, 42) == ("bucket", 24)
    wide_n = count.BUCKET_WIDE_N
    assert count.radix_route(wide_n, 63) == ("bucket", 16)
    assert count.radix_route(wide_n + 1, 63) == ("bucket", 24)
    assert count.radix_route(100, 62, 64) == ("bucket", 16)
    for route in (("bucket", 24), ("bucket", 16), ("block", 0), ("passes", 0)):
        assert count.check_route(cap + 1 if route[0] != "block" else cap, 42, route) == route
    for n, bits, route in ((cap + 1, 42, ("block", 0)), (cap + 1, 24, ("bucket", 24)),
                           (cap + 1, 16, ("bucket", 16)), (cap + 1, 42, ("bucket", 20)),
                           (cap + 1, 42, ("merge", 0)), (cap + 1, 42, ("passes", 16))):
        with pytest.raises(ValueError):
            count.check_route(n, bits, route)
    assert [count.bucket_digits(b, 16) for b in (17, 24, 25, 31, 42, 62, 64)] == [
        1, 1, 2, 2, 4, 6, 6]
    assert [count.bucket_digits(b, 24) for b in (25, 31, 42, 62, 64)] == [1, 1, 3, 5, 5]
    assert count.BUCKET_RANK == cap // 64 and count.BUCKET_DENSE == 8
    assert count.BUCKET_SHARE * 2 == cap
