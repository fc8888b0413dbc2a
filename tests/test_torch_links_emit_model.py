"""K5 `unitig_links` and K7 `unitig_emit` as the card runs them: numpy
models of their algorithms (csrc/unitig.cu) step by step, against the
plain versions on chip_smoke.py's k5_case and k7_case inputs at every k of
chip_smoke.K5_KS (the key route's k = 1, 2, 15, 16, 17, 31 and each width's
16W - 15 and 16W, W = 2..16; 255 for 256). K5: the prefix table sized
to the run (links_table_bits) and filled a row at a time, the dispatch of
a node's eight candidates to one forward search and the reverse-
complement searches it takes, the searches' lockstep rounds, the rows
from the forward lower bound up to the first miss, the link pass that
pulls prev from the twin, and any table size giving the same links. K7:
the chain minimum kept at the head and its parity rule, the two prefix
sums as block scans, the lengths and the shifted base counts, the
position-ordered plane whose positions below the chains' end are each
written once (the model asserts it), the pack, the heads' prefixes over
a warp's lanes, and, where a chain without a tail makes writes share a
position, the key plane whose largest key is the reference's last
writer. Then whole device builds with the models in K5's and K7's places
against leon_tpu's (dispatch_build + drain_build on jax-CPU), and K5 run
once a build. Everything is integer: the tolerance is 0."""

import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu_torch import state
from leon_tpu_torch.ops import kmer, unitig
from test_torch_unitig import _port, _reference, _run, _self_twin_seqs, _solid
from test_torch_unitig_words import _run as _run_words

K5_KS = chip_smoke.K5_KS
M32 = 0xFFFFFFFF


def _words(run: np.ndarray, k: int) -> np.ndarray:
    """The run as (M, W) u32 words, W = ceil(k/16): an int64 key is the
    same 2k bits in one or two words."""
    run = np.asarray(run)
    return state.keys_to_words(run, kmer.words_for_k(k)) if run.ndim == 1 else run.astype(np.uint32)


def top_bits(w: np.ndarray, k: int, T: int) -> np.ndarray:
    """The top T bits of each 2k-bit row (csrc/unitig.cu top_bits,
    top_bits_w)."""
    if T == 0:
        return np.zeros(w.shape[0], np.int64)
    shift = 2 * k - T
    wi, off = divmod(shift, 32)
    tb = w[:, wi].astype(np.int64) >> off
    if off and wi + 1 < w.shape[1]:
        tb |= (w[:, wi + 1].astype(np.int64) << (32 - off)) & M32
    return tb & ((1 << T) - 1)


def buckets_model(w: np.ndarray, k: int, T: int) -> np.ndarray:
    """starts (2^T + 1): thread i writes the buckets after row i-1's up to
    row i's (row M: 2^T)."""
    cur = np.append(top_bits(w, k, T), 1 << T)
    prv = np.concatenate([[-1], cur[:-1]])
    return np.repeat(np.arange(w.shape[0] + 1), cur - prv)


def cmp_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sign of a - b over (n, W) u32 rows as big integers, most significant
    word first (cmp_row)."""
    c = np.zeros(a.shape[0], np.int64)
    open_ = np.ones(a.shape[0], bool)
    for j in range(a.shape[1] - 1, -1, -1):
        c[open_ & (a[:, j] < b[:, j])] = -1
        c[open_ & (a[:, j] > b[:, j])] = 1
        open_ &= a[:, j] == b[:, j]
    return c


def links_model(run, k: int, T: int | None = None, stats: dict | None = None):
    """(nxt, prev) as lt_unitig_links computes them: a thread a directed
    node d = 2i + o, its forward search and the rc searches it takes run
    in lockstep rounds over the table's buckets; then a row's two nodes
    link, prev pulled from the twin."""
    w = _words(run, k)
    M = w.shape[0]
    T = unitig.links_table_bits(M, k) if T is None else T
    starts = buckets_model(w, k, T)
    rc = kmer.revcomp_words_batch_np(w, k)
    d = np.arange(2 * M)
    i, o = d >> 1, (d & 1).astype(bool)[:, None]
    x, xr = np.where(o, rc[i], w[i]), np.where(o, w[i], rc[i])
    fwd = unitig._np_shl2(x, 0, k)  # y_b = fwd | b
    q = [fwd] + [unitig._np_shr2_ins(xr, 3 - b, k) for b in range(4)]
    act = np.zeros((2 * M, 5), bool)
    for b in range(4):
        y = fwd.copy()
        y[:, 0] |= np.uint32(b)
        act[:, 1 + b] = unitig._np_lex_less(q[1 + b], y)
    act[:, 0] = ~act[:, 1:].all(axis=1)
    lo = np.zeros((2 * M, 5), np.int64)
    hi = np.zeros((2 * M, 5), np.int64)
    for s in range(5):
        p = top_bits(q[s], k, T)
        lo[:, s] = np.where(act[:, s], starts[p], 0)
        hi[:, s] = np.where(act[:, s], starts[p + 1], 0)
    hit = np.full((2 * M, 5), -1, np.int64)
    rounds = 0
    while (lo < hi).any():  # a round: every unfinished search's middle row
        rounds += 1
        for s in range(5):
            live = np.flatnonzero(lo[:, s] < hi[:, s])
            mid = (lo[live, s] + hi[live, s]) >> 1
            c = cmp_rows(w[mid], q[s][live])
            lo[live, s] = np.where(c < 0, mid + 1, lo[live, s])
            hi[live, s] = np.where(c < 0, hi[live, s], mid)
            hit[live, s] = np.where(c == 0, mid, hit[live, s])
    fm, fb = [], []
    go = act[:, 0].copy()
    for t in range(4):  # the rows from fwd's lower bound, up to the first miss
        j = lo[:, 0] + t
        r = w[np.minimum(j, M - 1)]
        same = go & (j < M) & ((r[:, 0] & ~np.uint32(3)) == fwd[:, 0])
        same &= (r[:, 1:] == fwd[:, 1:]).all(axis=1)
        fm.append(same)
        fb.append(r[:, 0] & 3)
        go = same
    oc = np.zeros(2 * M, np.int64)
    sc = np.full(2 * M, -1, np.int64)
    for b in range(4):
        j = hit[:, 1 + b].copy()
        for t in range(4):
            j = np.where(~act[:, 1 + b] & fm[t] & (fb[t] == b), lo[:, 0] + t, j)
        oc += j >= 0
        sc = np.where((j >= 0) & (oc == 1), 2 * j + act[:, 1 + b], sc)
    # link, a row's two nodes: nxt where internal; prev pulled from the
    # twin's internal edge, none for a palindromic row's odd node
    internal = (oc == 1) & (sc >= 0) & (oc[np.maximum(sc, 0) ^ 1] == 1)
    nxt = np.where(internal, sc, -1)
    pal = (w == rc).all(axis=1)[i]
    prev = np.where(internal[d ^ 1] & ~(o[:, 0] & pal), sc[d ^ 1] ^ 1, -1)
    if stats is not None:
        stats.update(T=T, rounds=rounds, searches=int(act.sum()), fwd=int(act[:, 0].sum()))
    return nxt.astype(np.int32), prev.astype(np.int32)


def base_at(w: np.ndarray, i, k: int) -> np.ndarray:
    """Base i (0 = first) of each spelled row: bits 2(k-1-i) (base_of)."""
    t = 2 * (k - 1 - np.asarray(i, np.int64))
    t = np.broadcast_to(t, (w.shape[0],))
    return (w[np.arange(w.shape[0]), t // 32].astype(np.int64) >> (t % 32)) & 3


EM_SCAN = 1024  # entries a block of K7's scans takes (csrc/unitig.cu)


def block_scan(v: np.ndarray):
    """(each entry's inclusive sum within its block of EM_SCAN, each
    block's exclusive offset): emit_heads_kernel / emit_bscan_kernel, then
    emit_top_kernel."""
    cs = np.cumsum(v)
    blk = np.arange(v.size) // EM_SCAN
    local = cs - np.concatenate([[0], cs])[blk * EM_SCAN]
    totals = np.add.reduceat(v, np.arange(0, v.size, EM_SCAN)) if v.size else v
    return local, np.cumsum(totals) - totals


def emit_model(run, k, nxt, prev, S, cap: int, cap_bases: int, acyclic: bool,
               info: dict | None = None) -> np.ndarray:
    """The u32 buffer as lt_unitig_emit_heads, _lens and _bases make it."""
    w = _words(np.asarray(run), k)
    nxt, prev, S = (np.asarray(a, np.int64) for a in (nxt, prev, S))
    N = S.shape[0]
    M = N // 2
    ids = np.arange(N)
    head, rank = S[:, 0], S[:, 1]
    buf = np.zeros(4 + cap + cap_bases // 16, np.int64)
    # heads: ~(the chain's min id) at its head, a max over a zeroed array
    # (read, then atomicMax: the max whatever the order); kept where there is
    # no prev and the min is even (or no node has that head: 0)
    cm = np.zeros(N, np.int64)
    np.maximum.at(cm, head, ~ids & M32)
    kh = (prev < 0) & ((cm == 0) | ((~cm & M32) & 1 == 0))
    # the flags' prefix sum in two levels: block-inclusive counts beside the
    # flags (cl), then the blocks' totals scanned (boff) in one block
    cl, boff = block_scan(kh.astype(np.int64))

    def chain(h):
        return np.where(kh[h], cl[h] + boff[h // EM_SCAN] - 1, -1)

    # the header from the scan's total; lens at the kept tails below cap,
    # each chain's base count shifted a chain up, scanned the same way
    total = int(boff[-1] + cl[-1])
    buf[0], buf[1] = total, int(total > cap)
    buf[2] = int(bool(acyclic) and (S[:, 2] == 0).any())
    tails = np.flatnonzero(nxt < 0)
    tc = chain(head[tails])
    keep = (tc >= 0) & (tc < cap)
    buf[4 + tc[keep]] = rank[tails[keep]] + 1
    bp = np.zeros(cap + 1, np.int64)
    bp[tc[keep] + 1] = rank[tails[keep]] + k
    bl, soff = block_scan(bp)
    start = bl + soff[np.arange(cap + 1) // EM_SCAN]  # chain c's first position
    collide = int(keep.sum()) < min(total, cap)
    # bases: each kept node's last base, each kept head's k - 1 prefix bases
    c = chain(head)
    ok = (c >= 0) & (c < cap)
    nodes = ids[ok]
    xw = w[nodes >> 1]
    odd = (nodes & 1).astype(bool)
    pos = [start[c[ok]] + (k - 1) + rank[ok]]
    code = [np.where(odd, 3 - base_at(xw, 0, k), xw[:, 0].astype(np.int64) & 3)]
    key = [unitig._node_key(nodes, M)]
    hd = nodes[head[ok] == nodes]  # the kept heads, a warp's one after another
    hw, hodd, hc = w[hd >> 1], (hd & 1).astype(bool), c[hd]
    for j in range(k - 1):  # lane j mod 32 writes prefix base j
        pos.append(start[hc] + j)
        code.append(np.where(hodd, 3 - base_at(hw, k - 1 - j, k), base_at(hw, j, k)))
        key.append(unitig._prefix_key(j, hc, M, cap))
    pos, code, key = (np.concatenate(a).astype(np.int64) for a in (pos, code, key))
    inb = (pos >= 0) & (pos < cap_bases)
    dropped = int((~inb).sum())
    pos, code, key = pos[inb], code[inb], key[inb]
    tb = start[cap]
    if collide:  # atomicMax of (key << 2 | base) into the zeroed 64-bit plane
        win = np.zeros(cap_bases, np.int64)
        np.maximum.at(win, pos, (key << 2) | code)
        bases = win & 3
    else:  # plain byte stores: every position below start[cap] once
        assert np.array_equal(np.sort(pos), np.arange(min(tb, cap_bases)))
        plane = np.full(cap_bases, 255, np.int64)  # never read past start[cap]
        plane[pos] = code
        bases = np.where(np.arange(cap_bases) < tb, plane, 0) & 3
    buf[4 + cap :] = (bases.reshape(-1, 16) << (2 * np.arange(16))).sum(axis=1)
    if info is not None:
        info.update(collide=collide, dropped=dropped, shared=pos.size - np.unique(pos).size)
    return buf.astype(np.uint32)


def _run_tensor(rows: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(rows.view(np.int32) if rows.ndim == 2 else rows)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k", K5_KS)
@pytest.mark.parametrize("name", chip_smoke.K5_CASES)
def test_links_model_matches_plain(name, k):
    """The model of K5 gives the plain version's links on every k5_case:
    the forward search and the taken rc searches, at the wrapper's table
    size; the one_bucket runs put every row in one bucket."""
    rows = chip_smoke.k5_case(name, k)
    st = {}
    got = links_model(rows, k, stats=st)
    want = unitig.unitig_links_plain(_run_tensor(rows), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    if name == "one_bucket" and k >= 15:
        assert np.unique(top_bits(_words(rows, k), k, st["T"])).size == 1
        assert st["rounds"] >= max(1, rows.shape[0].bit_length() - 1)


@pytest.mark.parametrize("k", (1, 2, 16, 31, 32, 127, 255))
def test_links_any_table_size(k):
    """Any table size gives the same links: T = 0 (one bucket), 1, the
    wrapper's, and the most K5 takes (LINKS_TABLE_MAX, at most 2k - 2)."""
    rows = chip_smoke.k5_case("chains", k)
    want = links_model(rows, k)
    for T in sorted({0, min(1, 2 * k - 2), min(unitig.LINKS_TABLE_MAX, 2 * k - 2)}):
        for a, b in zip(links_model(rows, k, T), want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("M, k, T", [(1, 1, 0), (1, 2, 1), (5, 15, 3), (2_014_298, 31, 21),
                                     (14_254_300, 31, 24), (530_019, 255, 20),
                                     (1 << 30, 255, 26), (300, 16, 9)])
def test_table_bits(M, k, T):
    """The table's bits: bitlen(M), at most 26 and 2k - 2."""
    assert unitig.links_table_bits(M, k) == T


@pytest.mark.parametrize("k", (2, 15, 17, 31, 33, 127, 255))
def test_buckets_and_forward_bucket(k):
    """The table a row at a time equals each bucket's first row, and a
    node's four forward candidates (fwd | b) share one bucket at T <= 2k - 2."""
    w = _words(chip_smoke.k5_case("chains", k), k)
    T = unitig.links_table_bits(w.shape[0], k)
    tops = top_bits(w, k, T)
    np.testing.assert_array_equal(buckets_model(w, k, T),
                                  np.searchsorted(tops, np.arange((1 << T) + 1)))
    fwd = unitig._np_shl2(w, 0, k)
    for b in range(1, 4):
        y = fwd.copy()
        y[:, 0] |= np.uint32(b)
        np.testing.assert_array_equal(top_bits(y, k, T), top_bits(fwd, k, T))


def _emit_args(c: dict):
    return [c["run"], c["k"], c["nxt"], c["prev"], c["S"], c["cap"], c["cap_bases"],
            c["acyclic"]]


@pytest.mark.parametrize("k", K5_KS)
@pytest.mark.parametrize("name", chip_smoke.K7_CASES)
def test_emit_model_matches_plain(name, k):
    """The model of K7 gives the plain version's buffer on every k7_case;
    positions are shared (the collision plane) only where a kept chain has
    no tail: in the palindromes at even k and nowhere else."""
    c = chip_smoke.k7_case(name, k)
    args = _emit_args(c)
    info = {}
    got = emit_model(*args, info=info)
    want = unitig.unitig_emit_plain(*args).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    if name == "palindromes" and k % 2 == 0 and k >= 16:
        assert info["collide"] and info["shared"] > 0
    elif name in ("chains", "cap_at", "cap_bases_cut"):
        assert not info["collide"]
    if name == "cap_over":
        assert got[1] == 1
    if name == "cap_bases_cut" and k >= 15:  # the cut drops the last chain's tail
        assert info["dropped"] > 0


@pytest.mark.parametrize("k", (16, 32, 64))
def test_emit_parity_rule(k):
    """keep_head by the parity of the chain's min id equals the reference's
    min id <= min twin id, at every head of the palindrome and cycle
    cases."""
    for name in ("palindromes", "cycles", "self_twin"):
        c = chip_smoke.k7_case(name, k)
        S = c["S"].numpy().astype(np.int64)
        N = S.shape[0]
        ids = np.arange(N)
        cm = np.full(N, N)
        tmn = np.full(N, N)
        np.minimum.at(cm, S[:, 0], ids)
        np.minimum.at(tmn, S[:, 0], ids ^ 1)
        heads = np.flatnonzero(c["prev"].numpy() < 0)
        np.testing.assert_array_equal(cm[heads] <= tmn[heads], cm[heads] % 2 == 0)


def test_wrappers_on_cpu_are_plain():
    """On CPU tensors the wrappers run the plain versions."""
    rows = _run_tensor(chip_smoke.k5_case("palindromes", 32))
    for a, b in zip(unitig.unitig_links(rows, 32), unitig.unitig_links_plain(rows, 32)):
        assert torch.equal(a, b)
    args = _emit_args(chip_smoke.k7_case("palindromes", 32))
    assert torch.equal(unitig.unitig_emit(*args), unitig.unitig_emit_plain(*args))


def _build_sets():
    rng = np.random.default_rng(0x57)
    out = {}
    out["chains_k15"] = (15, [rng.integers(0, 4, n, dtype=np.uint8) for n in (15, 16, 78, 79, 80)])
    flank = rng.integers(0, 4, (2, 14), dtype=np.uint8)
    pal16 = _self_twin_seqs(rng)[1]
    out["palindrome_k16"] = (16, [np.concatenate([flank[0], pal16, flank[1]])])
    circ = rng.integers(0, 4, 200, dtype=np.uint8)
    out["cycles_k31"] = (31, [np.concatenate([circ, circ[:30]]),
                              rng.integers(0, 4, 300, dtype=np.uint8)])
    out["palindrome_k32"] = (32, [np.concatenate([flank[0], np.zeros(18, np.uint8),
                                                  np.full(18, 3, np.uint8), flank[1]])])
    circ = rng.integers(0, 4, 201, dtype=np.uint8)
    out["cycles_k63"] = (63, [np.concatenate([circ, circ[:62]]),
                              rng.integers(0, 4, 250, dtype=np.uint8)])
    return out


BUILD_SETS = _build_sets()


@pytest.mark.parametrize("name", sorted(BUILD_SETS))
def test_model_build_matches_reference(monkeypatch, name):
    """dispatch_build + drain_build with the models in K5's and K7's places
    write leon_tpu's payload (its device build on jax-CPU): chains, the
    flanked palindromes at k = 16 and 32 (shared positions), and cycles
    (the full variant)."""
    k, seqs = BUILD_SETS[name]
    rng = np.random.default_rng(1)
    words, counts = (_run if k <= 31 else _run_words)(rng, k, seqs)
    nu = words.shape[0]
    want = _reference(words, counts, k, nu)
    solid = _solid(words, counts, k)

    def links(rows, kk):
        r = rows.numpy().view(np.uint32) if rows.dim() == 2 else rows.numpy()
        return tuple(torch.from_numpy(a) for a in links_model(r, kk))

    def emit(rows, kk, nxt, prev, S, cap, cb, acyclic):
        r = rows.numpy().view(np.uint32) if rows.dim() == 2 else rows.numpy()
        return torch.from_numpy(emit_model(r, kk, nxt.numpy(), prev.numpy(), S.numpy(), cap,
                                           cb, acyclic).view(np.int32))

    monkeypatch.setattr(unitig, "unitig_links", links)
    monkeypatch.setattr(unitig, "unitig_emit", emit)
    got = unitig.drain_build(unitig.dispatch_build(solid, k, nu))
    assert got is not None and got == want


@pytest.mark.parametrize("case", ["cycles", "overflow"])
def test_links_once_a_build(monkeypatch, case):
    """drain_build's rebuilds (the full variant after a flagged cycle; the
    overflow retry) reuse the dispatched build's K5 links: one K5 call a
    build, and the payload the host builder's."""
    rng = np.random.default_rng(5)
    k = 31
    if case == "cycles":
        circ = rng.integers(0, 4, 200, dtype=np.uint8)
        words, counts = _run(rng, k, [np.concatenate([circ, circ[:30]])])
    else:  # isolated k-mers: 5,000 chains overflow the 4,096 capacity once
        codes = rng.integers(0, 4, (5000, k), dtype=np.uint8)
        canon, _ = kmer.kmer_words_batch_np(codes, np.zeros(5000, np.int64), k)
        keys = np.unique(state.words_to_keys(canon))
        words, counts = state.keys_to_words(keys, 2), np.full(keys.size, 2, np.int32)
    nu = words.shape[0]
    calls = []
    real = unitig.unitig_links

    def spy(rows, kk):
        calls.append(rows.shape[0])
        return real(rows, kk)

    monkeypatch.setattr(unitig, "unitig_links", spy)
    infl = unitig.dispatch_build(_solid(words, counts, k), k, nu)
    flags = infl.buf[1:3].tolist()
    got = unitig.drain_build(infl)
    assert flags == ([0, 1] if case == "cycles" else [1, 0])
    assert len(calls) == 1
    assert got == unitig.build_np_payload(words, counts, 2, k, nu)
