#!/usr/bin/env python3
"""Time K15 (`walk.encode_batch`) of one tree without holding it to its
plain version, beside K18 (`walk.walk_encode_words`, with the confirmed
bits) on the same chunk: for copies of the package whose csrc/walk.cu is
edited to drop or change a part of the kernel (its event stores, its zero
pass, its register cap), which then no longer gives the right output.

    python3 scripts/time_dense.py TREE

TREE is the root of a checkout (its leon_tpu_torch is imported). Inputs:
the first 65,536 reads of scripts/ab_kernels.py's dense section at W = 4
(phase 3's reads, k = 63), W = 8 (200,000 x 250 bp, k = 127) and W = 16
(300-600 bp, k = 255) against the main path's filter of all the reads;
then ("p8") the same reads as W = 4's against chip_smoke.py phase 8's
filter (count_batch of every read, its cutoff and bits per k-mer). Prints
one JSON line an input: the device time of each kernel by the profiler (a
fresh process: late in a long one the profiler keeps only some launches),
two rounds of 10 calls each, K18's, the wrapper's time by CUDA events over
10 calls ("events_ms": what a caller waits), and the chunk's events and
walk steps (K15's output).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def events_ms(fn, reps: int = 10) -> float:
    """Mean time of fn() over reps calls by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    sys.path[:0] = [tree, ROOT, os.path.join(ROOT, "scripts")]
    import torch

    import ab_kernels as ab
    import chip_smoke
    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom, count, kmer, walk

    if not torch.cuda.is_available():
        print("time_dense: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.abspath(walk.__file__).startswith(tree):
        raise RuntimeError(f"leon_tpu_torch imported from {walk.__file__}, not {tree}")
    dev = torch.device("cuda")
    H, SEED, B = chip_smoke.H, chip_smoke.SEED, chip_smoke.B
    for W in (4, 8, 16, "p8"):
        if W in (4, "p8"):
            codes, lengths = ab.slab_reads(7 * B, True)
            k = 63
        elif W == 8:
            path = os.path.join(chip_smoke.WORK, "ab_200k_250bp.fastq")
            os.makedirs(chip_smoke.WORK, exist_ok=True)
            if not os.path.exists(path):
                chip_smoke.gen_fastq(path, 200_000, 2_000_000, 250)
            codes, lengths = chip_smoke.fastq_codes(path)
            k = 127
        else:
            codes, lengths = chip_smoke.long_reads(2 * B, 300, 600)
            k = 255
        L = codes.shape[1]
        packed = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
        ln = torch.from_numpy(lengths).to(dev)
        chunks = [(packed[s : s + B], ln[s : s + B]) for s in range(0, codes.shape[0], B)]
        if W == "p8":  # phase 8's filter
            canon, _rc, valid = kmer.kmer_scan_words(torch.from_numpy(codes).to(dev), ln, k)
            uniq, cnt = count.count_batch(canon, valid)
            del canon, _rc, valid
            hist = torch.bincount(torch.clamp(cnt, max=255), minlength=256).cpu().numpy()
            hist[0] = 0
            cut = count.auto_cutoff(hist)
            solid = uniq[cnt >= cut]
            nw = bloom.choose_n_words(solid.shape[0], bloom.auto_params(hist, cut)[0])
        else:
            sol = ab.main_solid(k, chunks, L, dev)
            solid, nw = sol["solid"], sol["n_words"]
        ones = torch.ones(solid.shape[0], dtype=torch.bool, device=dev)
        bits = bloom.bloom_build_words(solid, ones, nw, nw, H, SEED, k)
        c1, l1 = torch.from_numpy(codes[:B]).to(dev), ln[:B]
        p0, pl0 = chunks[0]
        e = walk.encode_batch(c1, l1, bits, k, H, nw, SEED)
        apos = e["apos"].long()
        steps = torch.clamp(l1.long() - k - apos, 0, max(1, L - k)) + apos
        rec = {"events": {n: int(e[n].sum()) for n in ("nbif_r", "nerr_r", "nbif_l", "nerr_l")},
               "steps": int(torch.where(e["anchored"], steps, 0).sum())}
        rec["events_ms"] = events_ms(lambda: walk.encode_batch(c1, l1, bits, k, H, nw, SEED))
        for rep in range(2):
            d = ab.profile_kernels(lambda: walk.encode_batch(c1, l1, bits, k, H, nw, SEED), 10)
            rec[f"dense_ms{rep}"] = sum(d.values())
            rec[f"dense_kernels{rep}"] = {name[:24]: v for name, v in d.items()}
            rec[f"k18_ms{rep}"] = sum(ab.profile_kernels(
                lambda: walk.walk_encode_words(p0, pl0, bits, nw, k, H, SEED, L, True),
                10).values())
        print(json.dumps({f"w{W}": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
