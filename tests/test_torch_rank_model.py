"""K6 `unitig_rank` as one list-ranking pass: a numpy model of its algorithm
(csrc/unitig.cu: the ruler sampling hash, the segment walks, pointer
jumping over the rulers, the fold, and the reference's own rounds over the
nodes that reach no fixed point) against the plain version (the
reference's rounds until no pointer moves) in all three modes, and through
chain_rank's two variants, on chip_smoke.py's rank_case graphs at ruler
samplings of every node, one in 4, the default and none (only where orbits
end); then, with the model in K6's place, whole device builds against
leon_tpu's (dispatch_build + drain_build on jax-CPU) on k-mer sets with
chains of 2^t - 1, 2^t and 2^t + 1 k-mers, isolated k-mers, self-twin
chains, the even-k palindrome and cycles of 1, 2, 3, 4, 5 and 8 k-mers.
Everything is integer: the tolerance is 0."""

import numpy as np
import pytest
import torch

import chip_smoke
from leon_tpu_torch.ops import unitig
from test_torch_unitig import _port, _reference, _run, _self_twin_seqs, _solid

ACYCLIC, FULL, RANK = unitig.ACYCLIC, unitig.FULL, unitig.RANK
MODES = (ACYCLIC, FULL, RANK)
RLOGS = chip_smoke.RANK_RLOGS + (unitig.RULER_LOG2,)


def _wrap32(x):
    """int64 values as int32 wraps them."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def rank_model(nxt, prev, mode: int, rlog: int) -> np.ndarray:
    """(N, 4) int32 state as lt_unitig_rank computes it, step by step."""
    nxt = np.asarray(nxt, np.int64)
    prev = np.asarray(prev, np.int64)
    N = nxt.size
    ids = np.arange(N)
    samp = chip_smoke.rank_sampled(ids, rlog)
    # rulers: where orbits end, the sampled ids, and (mode 1) the nodes whose
    # successor's prev is another node
    if mode == FULL:
        ruler = (nxt < 0) | samp | ((nxt >= 0) & (prev[np.maximum(nxt, 0)] != ids))
    else:
        ruler = (prev < 0) | samp
    RN = np.flatnonzero(ruler)
    cnt = RN.size
    owner = np.full(N, -1, np.int64)
    loc = np.zeros(N, np.int64)
    aux = ids.copy()
    owner[RN] = np.arange(cnt)
    RS = np.ones(cnt, np.int64)
    # walks, against the orbit up to the next ruler
    for i, u in enumerate(RN):
        n = 1
        if mode == FULL:
            mn, y = u, prev[u]
            while y >= 0 and n < N and not samp[y]:
                mn = min(mn, y)
                owner[y], loc[y], aux[y] = i, n, mn
                n += 1
                y = prev[y]
        else:
            x, y = u, nxt[u]
            while y >= 0 and n < N:
                if prev[y] != x or samp[y]:
                    break
                owner[y], loc[y] = i, n
                n += 1
                x, y = y, nxt[y]
        RS[i] = n
    # link: pointer jumping over the rulers, bitlen(cnt) + 1 rounds at most
    link = np.full(cnt, -1, np.int64)
    dist = np.zeros(cnt, np.int64)
    hz = np.zeros(cnt, np.int64)
    hw = np.zeros(cnt, np.int64)
    for i, u in enumerate(RN):
        f = nxt[u] if mode == FULL else prev[u]
        if f < 0:
            hz[i] = u
            hw[i] = u if mode == FULL else 0
            continue
        link[i] = owner[f] if owner[f] >= 0 else i
        dist[i] = loc[f] + 1
        if mode == FULL:
            hz[i] = min(u, aux[f])
    for _ in range(max(cnt, 1).bit_length() + 1):
        lk = link >= 0
        g = np.where(lk, link, 0)
        dist = np.where(lk, _wrap32(dist + dist[g]), dist)
        if mode == FULL:
            hz, hw = np.where(lk, np.minimum(hz, hz[g]), hz), np.where(lk, hw[g], hw)
        else:
            hz = np.where(lk, hz[g], hz)
        link = np.where(lk, link[g], link)
        if not (link >= 0).any():
            break
    resolved = link < 0
    md = max([0] + [int(d + s - 1) for d, s, r in zip(dist, RS, resolved) if r])
    # fold
    S = np.zeros((N, 4), np.int64)
    cyc = np.ones(N, bool)
    for d in range(N):
        i = owner[d]
        if i < 0 or not resolved[i]:
            continue
        cyc[d] = False
        if mode == FULL:
            S[d] = (hw[i], 1, min(aux[d], hz[i]), 0)
        else:
            S[d] = (hz[i], _wrap32(dist[i] + loc[d]), int(mode == ACYCLIC), 0)
    # the rest: the reference's rounds over their list alone
    U = np.flatnonzero(cyc)
    if U.size:
        idx = np.full(N, -1, np.int64)
        idx[U] = np.arange(U.size)
        f = nxt[U] if mode == FULL else prev[U]
        P = idx[np.where(f >= 0, f, U)]
        assert (P >= 0).all()
        if mode == FULL:
            c0, c1 = (f < 0).astype(np.int64), U.copy()
        else:
            c0 = (f >= 0).astype(np.int64)
            c1 = (f < 0).astype(np.int64) if mode == ACYCLIC else np.zeros(U.size, np.int64)
        J = 0 if md <= 1 else (md - 1).bit_length()
        D = max(1, (N - 1).bit_length()) + 1
        for j in range(1, D + 1):
            g = P[P]
            moved = bool((g != P).any())
            if mode == FULL:
                c0, c1 = c0 | c0[P], np.minimum(c1, c1[P])
            else:
                c0 = _wrap32(c0 + c0[P])
                c1 = c1 | c1[P] if mode == ACYCLIC else c1
            P = g
            if j > J and not moved:
                break
        S[U] = np.stack([U[P], c0, c1, np.zeros(U.size, np.int64)], axis=1)
    return S.astype(np.int32)


def _tensors(name: str, rlog: int):
    nxt, prev = chip_smoke.rank_case(name, rlog)
    return torch.from_numpy(nxt), torch.from_numpy(prev)


@pytest.mark.parametrize("rlog", RLOGS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", chip_smoke.RANK_CASES)
def test_model_matches_plain(name, mode, rlog):
    """The model of one K6 pass equals the reference's rounds: head or
    tail, rank or reached flag, and the carries of every node, cycle nodes
    included (their state after the reference's number of rounds)."""
    nxt, prev = _tensors(name, rlog)
    got = rank_model(nxt.numpy(), prev.numpy(), mode, rlog)
    want = unitig.unitig_rank_plain(nxt, prev, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rlog", RLOGS)
@pytest.mark.parametrize("name", chip_smoke.RANK_CASES)
def test_model_chain_rank_both_variants(name, rlog):
    """chain_rank with the model as K6: the optimistic variant, and the full
    one (FULL, the cycle cut, then RANK over the cut links), equal
    chain_rank_plain; a cycle shows as c1 == 0 exactly where one exists."""
    nxt, prev = _tensors(name, rlog)

    def rank(n, p, mode):
        return torch.from_numpy(rank_model(n.numpy(), p.numpy(), mode, rlog))

    for acyclic in (True, False):
        got = unitig._chain_rank(nxt, prev, acyclic, rank, unitig.break_cycles_plain)
        want = unitig.chain_rank_plain(nxt, prev, acyclic)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    flagged = bool((unitig.chain_rank_plain(nxt, prev, True)[2][:, 2] == 0).any())
    assert flagged == (name.startswith("cycles") or name == "mixed")


def test_wrapper_on_cpu_is_plain():
    """On CPU tensors the wrapper runs the plain version."""
    nxt, prev = _tensors("mixed", unitig.RULER_LOG2)
    for mode in MODES:
        want = unitig.unitig_rank_plain(nxt, prev, mode)
        assert torch.equal(unitig.unitig_rank(nxt, prev, mode), want)


def test_rank_case_cycles_sampling():
    """cycles_free holds no sampled node on its cycles, cycles_ruled one a
    cycle, at one in 4 and at K6's own sampling."""
    for rlog in (2, unitig.RULER_LOG2):
        for name, want in (("cycles_free", 0), ("cycles_ruled", 1)):
            nxt, prev = chip_smoke.rank_case(name, rlog)
            on = np.flatnonzero(nxt >= 0)
            smp = chip_smoke.rank_sampled(on, rlog)
            n_cycles = 2 * len(chip_smoke.RANK_CYCLES)
            assert int(smp.sum()) == want * n_cycles


@pytest.mark.parametrize("rlog", (2, unitig.RULER_LOG2))
def test_rank_case_chain_sampling(rlog):
    """chain_unsampled's long chain holds no sampled node (its head is its
    one ruler), chain_sampled's chain no unsampled one (every node a
    ruler), at one in 4 and at K6's own sampling."""
    t = 6
    for name, n, want in (("chain_unsampled", 1 << t, 0), ("chain_sampled", 1 << (t - 2), 1)):
        nxt, prev = chip_smoke.rank_case(name, rlog, t=t)
        on = np.flatnonzero((nxt >= 0) | (prev >= 0))
        assert on.size == n
        assert int(chip_smoke.rank_sampled(on, rlog).sum()) == want * n


# k-mer sets for whole builds (k = 15 but for the palindrome at k = 16)
def _periodic(rng, n: int, k: int):
    """A read around a circular sequence of period n: n k-mers in a cycle."""
    while True:
        unit = rng.integers(0, 4, n, dtype=np.uint8)
        if n == 1 or all((np.roll(unit, s) != unit).any() for s in range(1, n)):
            return np.tile(unit, -(-(n + k + 5) // n))[: n + k + 5]


def _build_sets():
    rng = np.random.default_rng(0xC6)
    k = 15
    out = {}
    for t in (4, 7):
        for dn, tag in ((-1, "m1"), (0, ""), (1, "p1")):
            n = (1 << t) + dn
            out[f"chain_2^{t}{tag}"] = (k, [rng.integers(0, 4, n + k - 1, dtype=np.uint8)])
    out["isolated"] = (k, [rng.integers(0, 4, k, dtype=np.uint8) for _ in range(40)])
    out["self_twin"] = (k, _self_twin_seqs(rng))
    out["palindrome_k16"] = (16, [_self_twin_seqs(rng)[1]])
    out["cycles"] = (k, [_periodic(rng, n, k) for n in chip_smoke.RANK_CYCLES])
    out["mixed"] = (k, [_periodic(rng, n, k) for n in (3, 8)]
                    + [rng.integers(0, 4, n, dtype=np.uint8) for n in (40, 200, 31)]
                    + _self_twin_seqs(rng)[:1])
    return out


BUILD_SETS = _build_sets()


@pytest.mark.parametrize("name", sorted(BUILD_SETS))
def test_model_build_matches_reference(monkeypatch, name):
    """dispatch_build + drain_build with the model in K6's place, at every
    ruler sampling, write leon_tpu's payload (its device build on
    jax-CPU): the optimistic variant, and the full one where the set has
    cycles."""
    k, seqs = BUILD_SETS[name]
    rng = np.random.default_rng(1)
    words, counts = _run(rng, k, seqs)
    nu = words.shape[0]
    want = _reference(words, counts, k, nu)
    if name in ("cycles", "mixed"):  # the optimistic build flags the cycles
        assert int(unitig.dispatch_build(_solid(words, counts, k), k, nu).buf[2]) == 1
    for rlog in RLOGS:
        monkeypatch.setattr(unitig, "unitig_rank", lambda n, p, mode, _r=rlog: torch.from_numpy(
            rank_model(n.numpy(), p.numpy(), mode, _r)))
        assert _port(words, counts, k, nu) == want, rlog
