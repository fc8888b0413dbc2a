#!/usr/bin/env python3
"""Time kernels K2 (`count.runs`, three modes) and K8 (`unitig.solid_lookup`)
of one tree's leon_tpu_torch on the card, beside the PyTorch call that
computes the same function, on inputs made from a fixed seed.

    python3 scripts/ab_k2_k8.py --tree PATH [--label NAME]

PATH is the root of a checkout (the package is imported from there), so
two trees (a parent and a change) are compared by running the script once
for each, in turns, in one call on one card (parent, change, change,
parent). Each run prints one JSON line: the card's name and power limit,
and per record its time in ms (CUDA events, mean of `reps` calls after one
warm-up; under 50 us the profiler's device time, as chip_smoke.py times).

Inputs (chip_smoke.py's shapes):
  runs         chip_smoke.py phase 3's slab: 7 x 65,536 reads of 100 bp from
               a 2 Mbp random contig with 1% substitutions, K1 at k = 31,
               torch.sort; length mode (library: torch.unique_consecutive
               with counts)
  runs:merge   the distinct run and every third row again, sorted with the
               counts as payload; counts + histogram
  runs:solid   the distinct run's compaction at the abundance cutoff
  lookup:bench the solid rows of that run, 100,000 of them and 100,000 with
               low bits flipped as queries (library: torch.searchsorted)
  lookup:yeast 14,254,300 sorted distinct random 31-mer keys, the same
               200,000-query mix
  lookup:w4/w8/w16  2,024,000 / 1,777,017 / 530,019 sorted distinct random
               rows of k = 63 / 127 / 255, the same query mix
Every record is checked exact against the tree's plain version first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--label", default="", help="name printed with the results")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_k2_k8: no CUDA device", file=sys.stderr)
        return 2
    from leon_tpu_torch import kernels, state
    from leon_tpu_torch.ops import count, kmer, unitig

    dev = torch.device("cuda")
    kernels.lib()

    def ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        t = t0.elapsed_time(t1) / reps
        if t >= 1.0:
            return t
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        d = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA") / 1e3 / reps
        return d if 0 < d < 0.05 else t

    def same(a, b) -> None:
        for x, y in zip(a, b):
            if x is None and y is None:
                continue
            if not torch.equal(x.to(torch.int64), y.to(torch.int64)):
                raise AssertionError("kernel differs from its plain version")

    out = {}
    # K2 on chip_smoke.py phase 3's slab
    rng = np.random.default_rng(20261016)
    K, L, READ_LEN, nr = 31, 104, 100, 7 * 65536
    contig = rng.integers(0, 4, 2_000_000, dtype=np.uint8)
    starts = rng.integers(0, contig.size - READ_LEN, nr)
    codes = np.zeros((nr, L), np.uint8)
    codes[:, :READ_LEN] = contig[starts[:, None] + np.arange(READ_LEN)]
    mut = rng.random((nr, READ_LEN)) < 0.01
    codes[:, :READ_LEN][mut] = (codes[:, :READ_LEN][mut] + 1) & 3
    lengths = np.full(nr, READ_LEN, np.int32)
    packed = state.packed_to_torch(kmer.pack_codes_np(codes), "cpu").to(dev)
    skeys = torch.sort(kmer.kmer_scan(packed, torch.from_numpy(lengths).to(dev), K, L)).values
    del packed
    rk, rc, _ = count.runs(skeys)
    same(count.runs(skeys), count.runs_plain(skeys))
    out["runs"] = ms(lambda: count.runs(skeys), 10)
    out["runs:unique_consecutive"] = ms(
        lambda: torch.unique_consecutive(skeys, return_counts=True), 10)
    ms_, perm = torch.sort(torch.cat([rk, rk[::3]]))
    mc = torch.cat([rc, rc[::3]])[perm]
    same(count.runs(ms_, mc, 1, True), count.runs_plain(ms_, mc, 1, True))
    out["runs:merge"] = ms(lambda: count.runs(ms_, mc, 1, True), 10)
    hist = count.runs_plain(ms_, mc, 1, True)[2].cpu().numpy().astype(np.int64)
    cutoff = count.auto_cutoff(hist)
    same(count.compact_solid(rk, rc, cutoff), count.runs_plain(rk, rc, cutoff)[:2])
    out["runs:solid"] = ms(lambda: count.compact_solid(rk, rc, cutoff), 10)
    sk = count.compact_solid(rk, rc, cutoff)[0]
    out["rows"] = {"runs": skeys.numel(), "distinct": rk.numel(), "merge": ms_.numel(),
                   "solid": sk.numel(), "cutoff": cutoff}
    del skeys, ms_, mc

    # K8
    def queries(rows, words: bool):
        r = np.random.default_rng(8)
        q = rows[torch.from_numpy(r.integers(0, rows.shape[0], 100_000)).to(dev)]
        if words:
            miss = q.clone()
            miss[:, 0] ^= 0x155
        else:
            miss = (q ^ 0x155) & ((1 << 62) - 1)
        return torch.cat([q, miss])

    def random_rows(M: int, k: int, seed: int):
        r = np.random.default_rng(seed)
        W = -(-k // 16)
        w = r.integers(0, 1 << 32, (M, W), dtype=np.uint64).astype(np.uint32)
        top = 2 * k - 32 * (W - 1)
        if top < 32:
            w[:, W - 1] &= np.uint32((1 << top) - 1)
        w = w[np.lexsort(w.T)]
        w = w[np.concatenate([[True], (w[1:] != w[:-1]).any(axis=1)])]
        return state.words_to_torch(w, dev)

    sets = [("bench", sk, K), ("yeast", torch.unique(torch.from_numpy(
        np.random.default_rng(31).integers(0, 1 << 62, 14_254_300)).to(dev)), K),
            ("w4", random_rows(2_024_000, 63, 4), 63), ("w8", random_rows(1_777_017, 127, 8), 127),
            ("w16", random_rows(530_019, 255, 16), 255)]
    for name, rows, k in sets:
        words = rows.dim() == 2
        q = queries(rows, words)
        same(unitig.solid_lookup(rows, k, q), unitig.solid_lookup_plain(rows, k, q))
        out[f"lookup:{name}"] = ms(lambda: unitig.solid_lookup(rows, k, q), 20)
        if not words:
            out[f"lookup:{name}:searchsorted"] = ms(lambda: torch.searchsorted(rows, q), 20)
        out["rows"][f"lookup:{name}"] = rows.shape[0]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": card, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
