#!/usr/bin/env python3
"""Smoke run of leon_tpu_torch on one CUDA card: the quickest proof that
the port still starts, builds its kernels and round-trips on the GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero without the
final line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from leon_tpu_torch/csrc with nvcc, and check
     the native host library;
  3. run every kernel at the main path's shapes on inputs made with numpy
     from a fixed seed, require it to equal its plain PyTorch version run
     on CPU copies (integer-exact: tolerance 0), and time both on the card;
  4. compress and decompress four small corpora (lossy and lossless FASTQ,
     long-read FASTA, k = 15, 16 and 31, both Bloom-set sections) on the
     card and on the CPU: the archives and outputs must be identical;
  5. generate the bench corpus (bench.gen_fastq: 500k reads of 100 bp from
     a 2 Mbp contig), compress and decompress it on the card with
     -noheader -noqual, require the exact sequence round trip, the pinned
     archive (the reference's bytes) and every kernel's launch count > 0.
It prints one JSON line of kernel records, then, last, the device line.
Work files go to build/chip_smoke/ beside this script.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# The reference's archive for the bench corpus: leon_tpu.pipeline.compress
# (CPU backend) with LeonConfig(noheader=True, noqual=True). Its stream
# sizes and anchored count equal BENCH_r05.json's.
PIN = {
    "n_reads": 500_000, "contig_len": 2_000_000,
    "bytes": 3_372_596,
    "sha256": "aa1dfc2904bd6a5a1aa69e7dfc6681b1f6d3243c9bb5df623f0377c5ff4e4ae6",
    "n_anchored": 499_145,
}

# kernel -> (CUDA source, the TPU program it replaces)
KERNELS = {
    "kmer_scan": ("leon_tpu_torch/csrc/kmer.cu", "leon_tpu/ops/kmer.py:141"),
    "runs": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:45"),
    "bloom_build": ("leon_tpu_torch/csrc/bloom.cu", "leon_tpu/ops/bloom.py:394"),
    "walk_encode": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:432"),
    "walk_pack": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:460"),
    "walk_decode": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:819"),
}

K, H, SEED, B, READ_LEN = 31, 4, 0x1234ABCD, 65536, 100


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
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


def max_abs_err(a, b) -> int:
    """Max |a - b| over the int64 values of two same-shape integer tensors
    (a on the card, b on the CPU); raises unless they are equal."""
    import torch

    a = a.cpu().to(torch.int64)
    b = b.to(torch.int64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    err = int((a - b).abs().max()) if a.numel() else 0
    if err:
        raise AssertionError(f"kernel differs from its plain version (max |diff| {err})")
    return err


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_checks(records: dict, dev: str = "cuda", timer=cuda_ms, n_chunks: int = 7) -> None:
    """K1-K3 on a slab of n_chunks * B reads (>= 2**25 keys at 7), K4 on one
    chunk of B reads (L = 104, k = 31, H = 4) against a bitset of ~1.5M words
    built from the reads' contig. `dev` and `timer` exist for a rehearsal
    on the CPU, where the wrappers take their plain versions."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom, count, kmer, walk

    dev = torch.device(dev)
    rng = np.random.default_rng(20261016)
    L = 104
    contig = rng.integers(0, 4, PIN["contig_len"], dtype=np.uint8)
    nr = n_chunks * B
    starts = rng.integers(0, contig.size - READ_LEN, nr)
    codes = np.zeros((nr, L), np.uint8)
    codes[:, :READ_LEN] = contig[starts[:, None] + np.arange(READ_LEN)]
    mut = rng.random((nr, READ_LEN)) < 0.01
    codes[:, :READ_LEN][mut] = (codes[:, :READ_LEN][mut] + 1) & 3
    rev = np.arange(nr) % 2 == 1
    codes[rev, :READ_LEN] = (3 - codes[rev, :READ_LEN])[:, ::-1]
    lengths = np.full(nr, READ_LEN, np.int32)
    lengths[:: 997] = rng.integers(0, READ_LEN, lengths[:: 997].size)  # short, pad
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    packed_np = kmer.pack_codes_np(codes)
    packed_c = state.packed_to_torch(packed_np, "cpu")
    lengths_c = torch.from_numpy(lengths)
    packed_d, lengths_d = packed_c.to(dev), lengths_c.to(dev)

    # K1
    got = kmer.kmer_scan(packed_d, lengths_d, K, L)
    want = kmer.kmer_scan_plain(packed_c, lengths_c, K, L)
    records["kmer_scan"] = dict(
        max_abs_err=max_abs_err(got, want),
        ms=timer(lambda: kmer.kmer_scan(packed_d, lengths_d, K, L), 10),
        plain_ms=timer(lambda: kmer.kmer_scan_plain(packed_d, lengths_d, K, L), 2))
    log(f"kmer_scan ok: {got.numel()} keys")

    # K2: raw slab, then a merge with a count payload, then the solid compaction
    skeys = torch.sort(got).values
    sk_c = skeys.cpu()
    rk, rc, _ = count.runs(skeys)
    pk, pc, _ = count.runs_plain(sk_c)
    err = max(max_abs_err(rk, pk), max_abs_err(rc, pc))
    mk = torch.cat([rk, rk[::3]])
    mc = torch.cat([rc, rc[::3]])
    ms, perm = torch.sort(mk)
    mc = mc[perm]
    gk, gc, gh = count.runs(ms, mc, 1, True)
    wk, wc, wh = count.runs_plain(ms.cpu(), mc.cpu(), 1, True)
    err = max(err, max_abs_err(gk, wk), max_abs_err(gc, wc), max_abs_err(gh, wh))
    hist = wh.numpy().astype(np.int64)
    cutoff = count.auto_cutoff(hist)
    sk, sc = count.compact_solid(rk, rc, cutoff)
    tk, tc, _ = count.runs_plain(rk.cpu(), rc.cpu(), cutoff)
    err = max(err, max_abs_err(sk, tk), max_abs_err(sc, tc))
    records["runs"] = dict(
        max_abs_err=err, ms=timer(lambda: count.runs(skeys), 5),
        plain_ms=timer(lambda: count.runs_plain(skeys), 2))
    log(f"runs ok: {skeys.numel()} keys -> {rk.numel()} distinct, cutoff {cutoff}, "
        f"{sk.numel()} solid")

    # K3 on the distinct run, sized as the pipeline sizes it
    n_solid = int(hist[min(cutoff, 255):].sum())
    bpk, _h = bloom.auto_params(hist, cutoff, False, stored_filter=False)
    n_words = bloom.choose_n_words(n_solid, bpk)
    bits_d = bloom.bloom_build(rk, rc, cutoff, n_words, H, SEED, K)
    bits_c = bloom.bloom_build_plain(rk.cpu(), rc.cpu(), cutoff, n_words, H, SEED, K)
    records["bloom_build"] = dict(
        max_abs_err=max_abs_err(bits_d, bits_c),
        ms=timer(lambda: bloom.bloom_build(rk, rc, cutoff, n_words, H, SEED, K), 10),
        plain_ms=timer(lambda: bloom.bloom_build_plain(rk, rc, cutoff, n_words, H, SEED, K), 2))
    log(f"bloom_build ok: {n_words} words")

    # K4 on one chunk
    p1d, l1d = packed_d[:B].contiguous(), lengths_d[:B].contiguous()
    p1c, l1c = packed_c[:B], lengths_c[:B]

    def enc_d():
        return walk.walk_encode(p1d, l1d, bits_d, n_words, K, H, SEED, L, True)

    e_d = enc_d()
    e_c = walk.walk_encode_plain(p1c, l1c, bits_c, n_words, K, H, SEED, L, True)
    err = max(max_abs_err(e_d[n], e_c[n]) for n in ("meta", "tot", "conf"))
    ME = L - K
    tot_c = e_c["tot"].to(torch.int64)
    for n, row in (("ev_gap", 0), ("ev_nt", 0), ("ev_bif", 1)):
        valid = torch.arange(ME)[None, :] < tot_c[row][:, None]
        a = e_d[n].cpu().to(torch.int64)[valid]
        err = max(err, max_abs_err(a, e_c[n].to(torch.int64)[valid]))
    records["walk_encode"] = dict(
        max_abs_err=err, ms=timer(enc_d, 10),
        plain_ms=timer(lambda: walk.walk_encode_plain(p1d, l1d, bits_d, n_words, K, H,
                                                        SEED, L, True), 1))
    anchored = int(e_c["meta"][:, 0].sum())
    log(f"walk_encode ok: {anchored}/{B} anchored, {int(tot_c[0].sum())} err, "
        f"{int(tot_c[1].sum())} bif events")

    incl_d = torch.cumsum(e_d["tot"], dim=1)
    incl_c = torch.cumsum(e_c["tot"], dim=1)
    cap_err = -(-int(incl_c[0, -1]) // 8) * 8
    cap_bif = -(-int(incl_c[1, -1]) // 8) * 8
    buf_d = walk.walk_pack(e_d, incl_d, L, K, cap_err, cap_bif, True)
    buf_c = walk.walk_pack_plain(e_c, incl_c, L, K, cap_err, cap_bif, True)
    records["walk_pack"] = dict(
        max_abs_err=max_abs_err(buf_d, buf_c),
        ms=timer(lambda: walk.walk_pack(e_d, incl_d, L, K, cap_err, cap_bif, True), 10),
        plain_ms=timer(lambda: walk.walk_pack_plain(e_d, incl_d, L, K, cap_err, cap_bif,
                                                      True), 2))
    log("walk_pack ok")

    # decode what was encoded
    enc = walk.unpack_compact(buf_c.numpy().view(np.uint16), B, B, L, cap_err, cap_bif,
                              True, K)
    canon, orient = kmer.kmer_words_batch_np(codes[:B], enc["apos"].astype(np.int64), K)
    afwd = np.where(orient[:, None], kmer.revcomp_words_batch_np(canon, K), canon)
    anch = enc["anchored"]
    et = enc["nerr_r"] + enc["nerr_l"]
    bt = enc["nbif_r"] + enc["nbif_l"]
    scal = np.zeros((B, 11), np.int32)
    scal[:, 0] = enc["apos"]
    scal[:, 1] = anch
    scal[:, 2] = np.where(anch, lengths[:B], 0)
    scal[:, 3], scal[:, 4] = enc["nerr_r"], enc["nerr_l"]
    scal[:, 5], scal[:, 6] = enc["nbif_r"], enc["nbif_l"]
    scal[:, 7] = np.cumsum(et) - et
    scal[:, 8] = np.cumsum(bt) - bt
    scal[:, 9:] = afwd.view(np.int32)
    dec_in_c = (torch.from_numpy(scal), torch.from_numpy(enc["errgap_flat"].astype(np.int32)),
                torch.from_numpy(enc["errnt_flat"].astype(np.uint8)),
                torch.from_numpy(enc["bif_flat"].astype(np.uint8)))
    dec_in_d = tuple(t.to(dev) for t in dec_in_c)
    d_d = walk.walk_decode(*dec_in_d, bits_d, n_words, K, H, SEED, L)
    d_c = walk.walk_decode_plain(*dec_in_c, bits_c, n_words, K, H, SEED, L)
    err = max_abs_err(d_d, d_c)
    back = walk.unpack_codes_u32_np(d_c.numpy().view(np.uint32), L)
    rows = np.flatnonzero(anch)
    same = (back[rows] == codes[:B][rows]) | (np.arange(L)[None, :] >= lengths[:B][rows, None])
    if not same.all():
        raise AssertionError("decode did not restore the encoded reads")
    records["walk_decode"] = dict(
        max_abs_err=err,
        ms=timer(lambda: walk.walk_decode(*dec_in_d, bits_d, n_words, K, H, SEED, L), 10),
        plain_ms=timer(lambda: walk.walk_decode_plain(*dec_in_d, bits_d, n_words, K, H,
                                                        SEED, L), 1))
    log(f"walk_decode ok: {rows.size} reads restored")


# ---------------------------------------------------------------------------
# phase 4: other widths and modes, the card against the CPU
# ---------------------------------------------------------------------------

# (label, corpus kind, LeonConfig fields): lossy qualities (the confirmed-
# position bits), one-word keys (k <= 16), reads past 255 walk steps (the
# 6-u16 per-read layout), the BLOOM section
VARIANTS = [
    ("fastq lossy k=31", "fastq", {}),
    ("fastq lossless k=15", "fastq", dict(lossless=True, kmer_size=15)),
    ("fasta wrapped, reads to 300 bp, k=31", "fasta", {}),
    ("fasta k=16, BLOOM section", "fasta", dict(kmer_size=16, unitig_sections=False)),
]


def write_corpus(path: str, kind: str, seed: int) -> None:
    """1,500 reads with 1% substitutions, half reverse-complemented, a few
    with N runs, from a 3 kbp contig: FASTQ of 60-100 bp, or FASTA of
    150-300 bp wrapped at 70 columns."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contig = rng.integers(0, 4, 3000, dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(1500):
            ln = int(rng.integers(60, 101) if kind == "fastq" else rng.integers(150, 301))
            st = int(rng.integers(0, contig.size - ln))
            r = contig[st : st + ln].copy()
            mut = rng.random(ln) < 0.01
            r[mut] = (r[mut] + 1) & 3
            if i % 2:
                r = (3 - r)[::-1]
            s = bases[r].tobytes()
            if i % 97 == 0:
                s = s[:10] + b"NNNNN" + s[15:]
            if kind == "fastq":
                q = rng.integers(33, 74, ln).astype(np.uint8).tobytes()
                f.write(b"@v%d %d\n%s\n+\n%s\n" % (i, ln, s, q))
            else:
                f.write(b">v%d\n" % i + b"".join(s[j : j + 70] + b"\n"
                                                 for j in range(0, ln, 70)))


def variants(dev: str = "cuda") -> None:
    """Each variant's archive compressed on the card equals the one the
    plain (CPU) path writes — which the CPU tests hold equal to leon_tpu's —
    and the card decodes it: byte-exact for lossless modes, sequence-exact
    and equal to the CPU decode for lossy qualities. (`dev` exists for a
    rehearsal on the CPU.)"""
    from leon_tpu_torch import LeonConfig, pipeline

    os.makedirs(WORK, exist_ok=True)
    for i, (label, kind, kw) in enumerate(VARIANTS):
        src = os.path.join(WORK, f"variant{i}.{kind}")
        write_corpus(src, kind, 100 + i)
        cfg = LeonConfig(**kw)
        data = {}
        for side, d in (("card", dev), ("cpu", "cpu")):
            arc = f"{src}.{side}.leon"
            pipeline.compress(src, arc, cfg=cfg, device=d)
            pipeline.decompress(arc, f"{arc}.out", cfg=cfg, device=d)
            with open(arc, "rb") as f, open(f"{arc}.out", "rb") as g:
                data[side] = (f.read(), g.read())
        if data["card"] != data["cpu"]:
            raise AssertionError(f"variant {label}: the card's archive or output differs "
                                 "from the plain path's")
        with open(src, "rb") as f:
            original = f.read()
        lossy = kind == "fastq" and not kw.get("lossless")
        out = data["card"][1]
        if (out.split(b"\n")[1::4] != original.split(b"\n")[1::4]) if lossy else out != original:
            raise AssertionError(f"variant {label}: round trip is not exact")
        log(f"variant ok: {label}, archive {len(data['card'][0])} B")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


def seq_lines(path: str) -> list:
    with open(path, "rb") as f:
        return f.read().split(b"\n")[1::4]


def main_path(records: dict, card: str, dev: str = "cuda") -> None:
    import torch

    import bench
    from leon_tpu_torch import LeonConfig, kernels, pipeline

    os.makedirs(WORK, exist_ok=True)
    src = os.path.join(WORK, "ecoli_500k.fastq")
    arc = os.path.join(WORK, "ecoli_500k.leon")
    out = os.path.join(WORK, "ecoli_500k.out.fastq")
    t = time.time()
    bench.gen_fastq(src, PIN["n_reads"], PIN["contig_len"])
    log(f"corpus: {os.path.getsize(src)} bytes in {time.time() - t:.1f} s (host)")
    cfg = LeonConfig(noheader=True, noqual=True)

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    kernels.launches.clear()
    sync()
    t = time.time()
    st = pipeline.compress(src, arc, cfg=cfg, device=dev)
    sync()
    t_c = time.time() - t
    t = time.time()
    pipeline.decompress(arc, out, cfg=cfg, device=dev)
    sync()
    t_d = time.time() - t
    launches = dict(kernels.launches)

    if seq_lines(src) != seq_lines(out):
        raise AssertionError("sequence round trip is not exact")
    with open(arc, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    size = os.path.getsize(arc)
    if (size, digest) != (PIN["bytes"], PIN["sha256"]) or st["n_anchored"] != PIN["n_anchored"]:
        raise AssertionError(f"archive {size} B sha256 {digest} n_anchored {st['n_anchored']} "
                             f"!= the reference's {PIN}")
    missing = [n for n in KERNELS if launches.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for n in KERNELS:
        records[n]["launches"] = launches[n]
    n = PIN["n_reads"]
    log(f"main path ok: archive {size} B = the reference's (sha256 {digest[:16]}), "
        f"ratio {st['ratio']:.3f}, round trip exact")
    log(f"compress {n / t_c:.1f} reads/s ({t_c:.2f} s), decompress {n / t_d:.1f} reads/s "
        f"({t_d:.2f} s) on {card} (host clock, end to end)")
    log(f"compress spans: {json.dumps(st.get('span_s', {}))}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: nothing to check", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card, flush=True)
    from leon_tpu_torch import kernels, pipeline

    t = time.time()
    kernels.lib()
    log(f"kernels built in {time.time() - t:.1f} s")
    pipeline.require_native()
    records = {n: {} for n in KERNELS}
    kernel_checks(records)
    variants()
    main_path(records, card)
    out = []
    for name, (src, repl) in KERNELS.items():
        r = records[name]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                    "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
