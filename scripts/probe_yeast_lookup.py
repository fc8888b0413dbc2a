#!/usr/bin/env python3
"""Time K8 (`unitig.solid_lookup`) on chip_smoke.py's yeast-sized solid run
in a fresh process, to compare with the yeast record of a whole
chip_smoke.py run (phase 4, which follows phases 3 and 7-10 in the same
process).

    python3 scripts/probe_yeast_lookup.py --tree PATH [--fill-pool]

PATH is the root of a checkout; its chip_smoke.py builds the genome and
runs phase 4 (K5-K8 against their plain versions) as the script does.
Right after phase 4's own K8 record, the same queries are timed again on
the same rows, on a copy of them, on a copy made after emptying
PyTorch's cache, beside torch.searchsorted, and (where the tree's K8 has
a splitter sample) with 1,024- and 6,144-row samples. --fill-pool first
reserves about 40 GB of the card in 150 blocks of 1-512 MB and frees
every other one, as a long run leaves its memory pool. Prints one JSON
line a phase-4 run.
"""

from __future__ import annotations

import argparse
import json
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--fill-pool", action="store_true", help="reserve and fragment ~40 GB first")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_yeast_lookup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from leon_tpu_torch import kernels
    from leon_tpu_torch.ops import unitig

    kernels.lib()
    checks = cs.unitig_checks

    def timed_checks(records, rows, counts, cutoff, nu, label, k=cs.K, names=cs.DEVICE_BUILD):
        fig = checks(records, rows, counts, cutoff, nu, label, k, names)
        rng = np.random.default_rng(8)  # unitig_checks' queries
        q = rows[torch.from_numpy(rng.integers(0, rows.shape[0], 100_000)).to(rows.device)]
        q = torch.cat([q, (q ^ 0x155) & ((1 << (2 * k)) - 1)])
        out = {"tree": args.tree, "fill_pool": args.fill_pool, "record_ms": records[names[3]]["ms"],
               "again": cs.cuda_ms(lambda: unitig.solid_lookup(rows, k, q), 10)}
        r2, q2 = rows.clone(), q.clone()
        out["copy"] = cs.cuda_ms(lambda: unitig.solid_lookup(r2, k, q2), 10)
        del r2, q2
        torch.cuda.empty_cache()
        r3, q3 = rows.clone(), q.clone()
        out["copy_after_empty_cache"] = cs.cuda_ms(lambda: unitig.solid_lookup(r3, k, q3), 10)
        out["searchsorted"] = cs.cuda_ms(lambda: torch.searchsorted(rows, q), 10)
        default = getattr(unitig, "LOOKUP_SAMPLE_ROWS", None)  # None: a tree without the sample
        for s in (1024, 6144) if default else ():
            unitig.LOOKUP_SAMPLE_ROWS = s
            out[f"sample_{s}"] = cs.cuda_ms(lambda: unitig.solid_lookup(rows, k, q), 10)
        if default:
            unitig.LOOKUP_SAMPLE_ROWS = default
        out["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
        out["card"] = cs.card_line()
        print(json.dumps(out), flush=True)
        return fig

    cs.unitig_checks = timed_checks
    hold = None
    if args.fill_pool:
        sizes = np.random.default_rng(1).integers(1 << 20, 1 << 29, 150)
        hold = [torch.empty(int(x), dtype=torch.uint8, device="cuda") for x in sizes]
        del hold[::2]
    cs.yeast_phase()
    return 0


if __name__ == "__main__":
    sys.exit(main())
