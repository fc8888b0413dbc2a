#!/usr/bin/env python3
"""Time K22's routes (ops/count.py radix_route) on the count path's keys, on
one CUDA card: each shape sorted by the passes route, by the bucket route
with buckets of 16 bits and of 24 (each forced through the wrappers'
`route`), and by the bucket route again on a build of csrc/sort.cu whose K24
never ranks (BS_RANK set to 0 in a copy under build/dev, so every round
merges), two rounds in turns. Every sort is held exact against
torch.sort(stable=True) first.

The shapes: the k = 31 slab of ab_kernels.slab_reads(500_000) (37.0M keys
over 64 bits, as DeviceCounter sorts it), the same with half its keys one
key, and the slab of a repeat-heavy corpus (scripts/gen_realistic.py:
500,000 reads of 100 bp from a 1.5 Mbp genome with its repeats, 33x); the
k = 127 slab's top keys with their index over top_key_bits(127) = 62 bits
(phase 9's 200,000 reads of 250 bp, every chunk), the first chunk's top
keys at W = 4, 8, 16 (k = 63, 127, 255; as ab_kernels' chunk:w*); the
k = 65 top keys over 34 bits (W = 5; phase 9's W = 4 reads); a k = 21
merge's keys (the k = 31 slab's distinct run and every third row, cut to 42
bits, with their int32 counts); random keys with their index over 25 and 32
bits (14.5M) and over 62 bits at 2**15, 2**17, 2**19 and 2**21 keys. Prints
the card's name and power limit, then a line of JSON, "shape" -> {"n",
"bits", "route": [ms (CUDA events, 10 sorts), ...]}.

    python3 scripts/tune_sort.py
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_norank():
    """Start nvcc on csrc/sort.cu alone with BS_RANK 0 (K24 merges every
    round): (the process, the library's path)."""
    src = open(os.path.join(ROOT, "leon_tpu_torch/csrc/sort.cu")).read()
    line = "#define BS_RANK 128"
    if line not in src:
        raise RuntimeError(f"csrc/sort.cu has no '{line}'")
    os.makedirs(os.path.join(ROOT, "build/dev"), exist_ok=True)
    cu = os.path.join(ROOT, "build/dev/sort_norank.cu")
    with open(cu, "w") as f:
        f.write(src.replace(line, "#define BS_RANK 0"))
    so = os.path.join(ROOT, "build/dev/sort_norank.so")
    return subprocess.Popen(["/usr/local/cuda/bin/nvcc", "-gencode=arch=compute_90a,code=sm_90a",
                             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
                             os.path.join(ROOT, "leon_tpu_torch/csrc"), "-o", so, cu]), so


def main() -> int:
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch

    import ab_kernels
    import chip_smoke
    import gen_realistic
    from leon_tpu_torch import kernels, state
    from leon_tpu_torch.ops import count, kmer

    if not torch.cuda.is_available():
        print("tune_sort: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda")
    nvcc, so = build_norank()
    full = kernels.lib()
    if nvcc.wait() != 0:
        raise RuntimeError("nvcc failed on the BS_RANK 0 copy of csrc/sort.cu")
    norank = ctypes.CDLL(so)
    for name, argtypes in kernels._SIGS.items():
        if name.startswith("lt_radix"):
            fn = getattr(norank, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def slab_of(codes, lengths, k):
        packed = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
        return kmer.kmer_scan(packed, torch.from_numpy(lengths).to(dev), k, codes.shape[1])

    def tops(codes, lengths, k, chunk):
        """The top keys of k-mers of the reads, every chunk of `chunk` reads
        scanned as sort_slab's slab (K17, K21), concatenated."""
        W = count.words_for_k(k)
        out = []
        for s in range(0, codes.shape[0], chunk):
            c, ln = codes[s : s + chunk], lengths[s : s + chunk]
            packed = state.packed_to_torch(kmer.pack_codes_np(c), dev)
            planes = kmer.kmer_scan_halves(packed, torch.from_numpy(ln).to(dev), k, c.shape[1])
            out.append(count.plane_rows(planes, W)[1])
        return torch.cat(out)

    # (name, keys, payload: None, an int32 tensor or "index", bits)
    shapes = []
    codes, lengths = ab_kernels.slab_reads(500_000, True)
    slab = slab_of(codes, lengths, 31)
    shapes.append(("k31:slab", slab, None, 64))
    g = torch.Generator().manual_seed(23)
    half = slab.clone()
    half[: half.numel() // 2] = half[7]
    half = half[torch.randperm(half.numel(), generator=g).to(dev)]
    shapes.append(("k31:half_one_key", half, None, 64))
    rk, rc, _ = count.runs(torch.sort(slab).values)
    mk21 = torch.cat([rk, rk[::3]]) >> 20
    mc = torch.cat([rc, rc[::3]])
    shapes.append(("k21:merge", mk21, mc, 42))
    del rk, rc
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    path = os.path.join(chip_smoke.WORK, "tune_realistic.fastq")
    gen_realistic.gen(path, 500_000, 100, 1_500_000, 7, False)
    rcodes, rlengths = chip_smoke.fastq_codes(path)
    shapes.append(("k31:realistic", slab_of(rcodes, rlengths, 31), None, 64))
    B = chip_smoke.B
    path = os.path.join(chip_smoke.WORK, "ab_200k_250bp.fastq")
    chip_smoke.gen_fastq(path, 200_000, 2_000_000, 250)
    c8, l8 = chip_smoke.fastq_codes(path)
    shapes.append(("k127:top", tops(c8, l8, 127, B), "index", count.top_key_bits(127)))
    c4, l4 = ab_kernels.slab_reads(7 * B, True)
    c16, l16 = chip_smoke.long_reads(2 * B, 300, 600)
    for W, k, c, ln in ((4, 63, c4, l4), (8, 127, c8, l8), (16, 255, c16, l16)):
        shapes.append((f"chunk:w{W}", tops(c[:B], ln[:B], k, B), "index", count.top_key_bits(k)))
    shapes.append(("k65:top", tops(c4, l4, 65, B), "index", count.top_key_bits(65)))
    gen = torch.Generator().manual_seed(5)
    rnd = torch.randint(0, 1 << 62, (mk21.numel(),), generator=gen).to(dev)
    for bits in (25, 32):
        shapes.append((f"rand:{bits}", (rnd >> (62 - bits)).contiguous(), "index", bits))
    for e in (15, 17, 19, 21):
        shapes.append((f"rand:62:2^{e}", rnd[: 1 << e].contiguous(), "index", 62))
    del codes, rcodes, c4, c8, c16

    def sorter(keys, pay, bits, route):
        if isinstance(pay, str):
            return lambda: count.radix_sort_index(keys, bits, route=route)
        return lambda: count.radix_sort(keys, pay, bits, route=route)

    routes = {"passes": (full, ("passes", 0)), "b16": (full, ("bucket", 16)),
              "b24": (full, ("bucket", 24)), "b16:norank": (norank, ("bucket", 16)),
              "b24:norank": (norank, ("bucket", 24))}
    res = {}
    for name, keys, pay, bits in shapes:
        if pay is None:
            want = (torch.sort(keys, stable=True).values,)
        elif isinstance(pay, str):
            want = tuple(torch.sort(keys, stable=True))
        else:
            want = count.radix_sort_plain(keys, pay)
        res[name] = {"n": keys.numel(), "bits": bits}
        for r, (lib, route) in routes.items():
            if route[1] >= bits:
                continue
            kernels._LIB = lib
            got = sorter(keys, pay, bits, route)()
            got = tuple(got) if isinstance(got, (list, tuple)) else (got,)
            for x, y in zip(got, want):
                if not torch.equal(x.to(torch.int64), y.to(torch.int64)):
                    raise AssertionError(f"{name} {r}: differs from torch.sort")
        kernels._LIB = full
    for turn in range(2):
        for name, keys, pay, bits in shapes:
            order = list(routes.items())
            for r, (lib, route) in order if turn == 0 else order[::-1]:
                if route[1] >= bits:
                    continue
                kernels._LIB = lib
                res[name].setdefault(r, []).append(round(ms(sorter(keys, pay, bits, route)), 4))
            kernels._LIB = full
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
