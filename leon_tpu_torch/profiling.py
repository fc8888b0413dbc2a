"""Where the time goes in leon_tpu_torch on one CUDA card.

    python -m leon_tpu_torch.profiling [--reps N] [--out DIR]

Generates the bench corpus (chip_smoke.gen_fastq: 500k reads of 100 bp) and
runs it on the card with -noheader -noqual in four configurations, the
default (native host unitig builder on a thread), the device unitig
build (unitig_device_max_kmers = 2**30), k = 63 (the multiword route,
K17-K19, W = 4) and k = 63 with the device unitig build (K5-K8 over W-word
rows), and 200k reads of 250 bp from the same contig at k = 127 (W = 8),
with either unitig builder, and the default once more with slabs of 2**27
k-mers (count_slab_kmers; the default is 2**25): N rounds, each compressing and decompressing
once per configuration in turn (host clock, each run ends in a
synchronize), then one profiled compress per configuration and one
profiled decompress at k = 31, 63 and 127 under torch.profiler. Prints the card's name and power
limit, every run's wall time, the host span totals of the profiled runs,
the device time per kernel/copy name and the device busy share of each
profiled run (device time / wall time; the idle share is the rest).
Writes the profiler tables and Chrome traces to DIR (default
build/torch_profile/). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # holds chip_smoke.py


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "torch_profile"),
                    help="directory for the profiler tables and traces")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import PIN, PIN127, gen_fastq
    from leon_tpu_torch import LeonConfig, kernels, pipeline

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    work = os.path.join(ROOT, "build", "torch_profile")
    out_dir = args.out
    os.makedirs(work, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(work, "ecoli_500k.fastq")
    src250 = os.path.join(work, "ecoli_200k_250bp.fastq")
    dec = os.path.join(work, "out.fastq")
    gen_fastq(src, PIN["n_reads"], PIN["contig_len"])
    gen_fastq(src250, PIN127["n_reads"], PIN["contig_len"], PIN127["read_len"])
    kernels.lib()
    configs = {"default": LeonConfig(noheader=True, noqual=True),
               "device_unitig": LeonConfig(noheader=True, noqual=True,
                                           unitig_device_max_kmers=1 << 30),
               "k63": LeonConfig(noheader=True, noqual=True, kmer_size=63),
               "k63_device_unitig": LeonConfig(noheader=True, noqual=True, kmer_size=63,
                                               unitig_device_max_kmers=1 << 30),
               "k127": LeonConfig(noheader=True, noqual=True, kmer_size=127),
               "k127_device_unitig": LeonConfig(noheader=True, noqual=True, kmer_size=127,
                                                unitig_device_max_kmers=1 << 30),
               "slab27": LeonConfig(noheader=True, noqual=True, count_slab_kmers=1 << 27)}
    srcs = {name: src250 if name.startswith("k127") else src for name in configs}
    arcs = {name: os.path.join(work, f"{name}.leon") for name in configs}
    n = {name: PIN127["n_reads"] if name.startswith("k127") else PIN["n_reads"]
         for name in configs}

    def run(fn, cfg, *a):
        torch.cuda.synchronize()
        t = time.time()
        st = fn(*a, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        return time.time() - t, st

    res = {"card": card}
    for name in configs:
        res[name] = {"compress_s": [], "decompress_s": []}
    for _ in range(args.reps):
        for name, cfg in configs.items():
            res[name]["compress_s"].append(run(pipeline.compress, cfg, srcs[name], arcs[name])[0])
            res[name]["decompress_s"].append(run(pipeline.decompress, cfg, arcs[name], dec)[0])
    for name in configs:
        for key in ("compress", "decompress"):
            res[name][f"{key}_reads_per_s"] = [n[name] / t for t in res[name][f"{key}_s"]]
    print(json.dumps(res), flush=True)

    for name, fn, cfg, a in (
            ("compress", pipeline.compress, configs["default"], (src, arcs["default"])),
            ("compress_slab27", pipeline.compress, configs["slab27"], (src, arcs["slab27"])),
            ("compress_device_unitig", pipeline.compress, configs["device_unitig"],
             (src, arcs["device_unitig"])),
            ("compress_k63", pipeline.compress, configs["k63"], (src, arcs["k63"])),
            ("compress_k63_device_unitig", pipeline.compress, configs["k63_device_unitig"],
             (src, arcs["k63_device_unitig"])),
            ("compress_k127", pipeline.compress, configs["k127"], (src250, arcs["k127"])),
            ("compress_k127_device_unitig", pipeline.compress, configs["k127_device_unitig"],
             (src250, arcs["k127_device_unitig"])),
            ("decompress", pipeline.decompress, configs["default"], (arcs["default"], dec)),
            ("decompress_k63", pipeline.decompress, configs["k63"], (arcs["k63"], dec)),
            ("decompress_k127", pipeline.decompress, configs["k127"], (arcs["k127"], dec))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, st = run(fn, cfg, *a)
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        rows = sorted(((e.key, e.count, e.device_time_total / 1e3) for e in events
                       if e.device_type.name == "CUDA"), key=lambda r: -r[2])
        busy_ms = sum(r[2] for r in rows)
        summary = {
            "run": name, "wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / wall,
            "by_name_ms": {k: round(ms, 3) for k, _c, ms in rows[:25]},
            "launch_counts": {k: c for k, c, _ms in rows[:25]},
            "span_s": st.get("span_s", {}),
        }
        print(json.dumps(summary), flush=True)
        with open(os.path.join(out_dir, f"{name}_table.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=40))
        prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
