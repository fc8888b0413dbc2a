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
     from a fixed seed, require it to equal its plain PyTorch version
     (integer-exact: tolerance 0; K1-K4 against CPU copies, the unitig
     kernels K5-K8 against the plain version on the card), and time both
     on the card; the device unitig payload must equal the native host
     builder's;
  4. build a yeast-sized genome on the card (linear contigs plus two
     circular plasmids), count it with K1 + sort + K2, and build its
     unitigs with K5-K7 and with the plain version: equal buffers, the
     cycle variant taken, the payload equal to the native host builder's;
  5. compress and decompress four small corpora (lossy and lossless FASTQ,
     long-read FASTA, k = 15, 16 and 31, both Bloom-set sections) on the
     card and on the CPU: the archives and outputs must be identical;
  6. generate the bench corpus (bench.gen_fastq: 500k reads of 100 bp from
     a 2 Mbp contig), compress and decompress it on the card with
     -noheader -noqual, then again with the device unitig build
     (unitig_device_max_kmers = 2**30); each run must give the exact
     sequence round trip and the pinned archive (the reference's bytes),
     and launch each kernel of its path (K1-K4; K5-K8) at least once.
It prints one JSON line of kernel records, then, last, the device line.
Kernels under ~50 us are timed from the profiler's device time, the rest
with CUDA events. Work files go to build/chip_smoke/ beside this script.
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
    "unitig_links": ("leon_tpu_torch/csrc/unitig.cu", "leon_tpu/ops/unitig.py:377"),
    "unitig_double": ("leon_tpu_torch/csrc/unitig.cu", "leon_tpu/ops/unitig.py:512"),
    "unitig_emit": ("leon_tpu_torch/csrc/unitig.cu", "leon_tpu/ops/unitig.py:586"),
    "solid_lookup": ("leon_tpu_torch/csrc/unitig.cu", "leon_tpu/ops/unitig.py:938"),
}
DEVICE_BUILD = ("unitig_links", "unitig_double", "unitig_emit", "solid_lookup")

K, H, SEED, B, READ_LEN = 31, 4, 0x1234ABCD, 65536, 100


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


SMALL_MS = 0.05  # below this, events around Python calls read host dispatch


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (after one warm-up): CUDA
    events around the calls, or, for a call whose kernels and copies take
    under SMALL_MS of device time by the profiler, that device time (events
    around calls that short read the host's dispatch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    if ms >= 20 * SMALL_MS:
        return ms
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_ms = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA") / 1e3 / reps
    return dev_ms if 0 < dev_ms < SMALL_MS else ms


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


def kernel_checks(records: dict, n_chunks: int = 7) -> None:
    """K1-K3 on a slab of n_chunks * B reads (>= 2**25 keys at 7), K4 on one
    chunk of B reads (L = 104, k = 31, H = 4) against a bitset of ~1.5M words
    built from the reads' contig, K5-K8 on the slab's solid run."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom, count, kmer, walk

    dev = torch.device("cuda")
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
        ms=cuda_ms(lambda: kmer.kmer_scan(packed_d, lengths_d, K, L), 10),
        plain_ms=cuda_ms(lambda: kmer.kmer_scan_plain(packed_d, lengths_d, K, L), 2))
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
        max_abs_err=err, ms=cuda_ms(lambda: count.runs(skeys), 5),
        plain_ms=cuda_ms(lambda: count.runs_plain(skeys), 2))
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
        ms=cuda_ms(lambda: bloom.bloom_build(rk, rc, cutoff, n_words, H, SEED, K), 10),
        plain_ms=cuda_ms(lambda: bloom.bloom_build_plain(rk, rc, cutoff, n_words, H, SEED, K), 2))
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
        max_abs_err=err, ms=cuda_ms(enc_d, 10),
        plain_ms=cuda_ms(lambda: walk.walk_encode_plain(p1d, l1d, bits_d, n_words, K, H,
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
        ms=cuda_ms(lambda: walk.walk_pack(e_d, incl_d, L, K, cap_err, cap_bif, True), 10),
        plain_ms=cuda_ms(lambda: walk.walk_pack_plain(e_d, incl_d, L, K, cap_err, cap_bif,
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
        ms=cuda_ms(lambda: walk.walk_decode(*dec_in_d, bits_d, n_words, K, H, SEED, L), 10),
        plain_ms=cuda_ms(lambda: walk.walk_decode_plain(*dec_in_d, bits_d, n_words, K, H,
                                                          SEED, L), 1))
    log(f"walk_decode ok: {rows.size} reads restored")

    # K5-K8 on the solid run the pipeline hands the device build
    unitig_checks(records, sk, sc, cutoff, rk.numel(), "bench")


# ---------------------------------------------------------------------------
# phases 3-4: the unitig kernels K5-K8 against their plain versions
# ---------------------------------------------------------------------------


def unitig_checks(records: dict, keys, counts, cutoff: int, nu: int, label: str) -> dict:
    """K5-K8 on a sorted solid run (keys, counts) on the card against their
    plain versions on the same tensors, exact; the device payload against
    the native host builder's. Fills records[name] (ms, plain_ms,
    max_abs_err) and returns the build's figures."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import unitig

    M = keys.numel()

    # K5
    nxt, prev = unitig.unitig_links(keys, K)
    want = unitig.unitig_links_plain(keys, K)
    records["unitig_links"] = dict(
        max_abs_err=max(max_abs_err(nxt, want[0].cpu()), max_abs_err(prev, want[1].cpu())),
        ms=cuda_ms(lambda: unitig.unitig_links(keys, K), 5),
        plain_ms=cuda_ms(lambda: unitig.unitig_links_plain(keys, K), 1))
    log(f"[{label}] unitig_links ok: {M} solid rows, {int((nxt >= 0).sum())} internal edges")

    # K6: the start states and one round of every mode, then whole rankings
    err = 0
    for mode in (unitig.ACYCLIC, unitig.FULL, unitig.RANK):
        S0 = unitig.double_init(nxt, prev, mode)
        err = max(err, max_abs_err(S0, unitig.double_init_plain(nxt, prev, mode).cpu()))
        got, ch = unitig.unitig_double(S0, mode)
        exp, ch_p = unitig.unitig_double_plain(S0, mode)
        err = max(err, max_abs_err(got, exp.cpu()), max_abs_err(ch, ch_p.cpu()))
    ranked = {}
    for acyclic in (True, False):
        got = unitig.chain_rank(nxt, prev, acyclic)
        exp = unitig.chain_rank_plain(nxt, prev, acyclic)
        err = max(err, *(max_abs_err(a, b.cpu()) for a, b in zip(got, exp)))
        ranked[acyclic] = got
    S0 = unitig.double_init(nxt, prev, unitig.ACYCLIC)
    records["unitig_double"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: unitig.unitig_double(S0, unitig.ACYCLIC), 10),
        plain_ms=cuda_ms(lambda: unitig.unitig_double_plain(S0, unitig.ACYCLIC), 3))
    log(f"[{label}] unitig_double ok")

    # K7 on both rankings; then the whole build (dispatch + drain) and the
    # plain build on the card
    cap = unitig.chains_cap(nu)
    cb = unitig._caps(M, K, cap)
    err = 0
    for acyclic, (n2, p2, S) in ranked.items():
        got = unitig.unitig_emit(keys, K, n2, p2, S, cap, cb, acyclic)
        exp = unitig.unitig_emit_plain(keys, K, n2, p2, S, cap, cb, acyclic)
        err = max(err, max_abs_err(got, exp.cpu()))
    n2, p2, S = ranked[True]
    records["unitig_emit"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: unitig.unitig_emit(keys, K, n2, p2, S, cap, cb, True), 5),
        plain_ms=cuda_ms(lambda: unitig.unitig_emit_plain(keys, K, n2, p2, S, cap, cb, True), 1))

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.time()
    infl = unitig.dispatch_build(keys, counts, cutoff, K, nu)
    cyc = int(infl.buf[2])
    payload = unitig.drain_build(infl)
    torch.cuda.synchronize()
    t_kernel = time.time() - t
    peak = torch.cuda.max_memory_allocated()
    t = time.time()
    plain_bufs = [unitig.build_plain(keys, K, cap, cb, a) for a in (True, False)]
    torch.cuda.synchronize()
    t_plain = time.time() - t
    kernel_bufs = [unitig.build(keys, K, cap, cb, a) for a in (True, False)]
    for a, b in zip(kernel_bufs, plain_bufs):
        max_abs_err(a, b.cpu())
    if payload is None:
        raise AssertionError(f"[{label}] the device build gave no payload")
    words = state.keys_from_torch(keys, 2)
    t = time.time()
    host = unitig.build_np_payload(words, counts.cpu().numpy(), cutoff, K, nu)
    t_host = time.time() - t
    if payload != host:
        raise AssertionError(f"[{label}] device payload differs from the native host builder's")
    n_chains = unitig.parse_payload(payload, K)[0].size
    log(f"[{label}] unitig_emit ok; build: {n_chains} chains, cycles flagged {cyc}, "
        f"payload {len(payload)} B = the native host builder's")

    # K8: solid keys, and keys that are not in the run
    rng = np.random.default_rng(8)
    q = keys[torch.from_numpy(rng.integers(0, M, 100_000)).to(keys.device)]
    q = torch.cat([q, (q ^ 0x155) & ((1 << (2 * K)) - 1)])
    hit, rank = unitig.solid_lookup(keys, K, q)
    hit_p, rank_p = unitig.solid_lookup_plain(keys, K, q)
    records["solid_lookup"] = dict(
        max_abs_err=max(max_abs_err(hit, hit_p.cpu()), max_abs_err(rank, rank_p.cpu())),
        ms=cuda_ms(lambda: unitig.solid_lookup(keys, K, q), 10),
        plain_ms=cuda_ms(lambda: unitig.solid_lookup_plain(keys, K, q), 3))
    log(f"[{label}] solid_lookup ok: {int(hit.sum())}/{q.numel()} hits")
    return dict(n_solid=M, n_distinct=nu, n_chains=n_chains, cycles_flagged=cyc,
                payload_bytes=len(payload), build_s=t_kernel, plain_build_s=t_plain,
                host_build_s=t_host, peak_device_bytes=peak)


def yeast_phase() -> dict:
    """A yeast-sized genome made on the card from a seeded generator: linear
    contigs of 14.2 Mbp in all and two circular plasmids (48 and 6.3 kbp).
    Each contig (a circular one extended by its first k-1 bases) is cut
    into windows of 128 bp at a stride of 128 - (k-1), so every k-mer lies
    in exactly one window; two copies of the windows give every genomic
    k-mer a count of at least 2. K1 + sort + K2 count them; K5-K8 are then
    held against their plain versions."""
    import numpy as np
    import torch

    from leon_tpu_torch.ops import count, kmer

    dev = torch.device("cuda")
    linear = [3_100_000, 2_700_000, 2_400_000, 2_200_000, 2_000_000, 1_800_000]
    circular = [48_000, 6_300]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    total = sum(linear) + sum(circular)
    genome = torch.randint(0, 4, (total,), generator=gen, device=dev, dtype=torch.int64)
    Lw = 128
    stride = Lw - (K - 1)
    starts, lens, off = [], [], 0
    parts = []
    for i, n in enumerate(linear + circular):
        c = genome[off : off + n]
        off += n
        if i >= len(linear):
            c = torch.cat([c, c[: K - 1]])
        base = sum(p.numel() for p in parts)
        parts.append(c)
        st = np.arange(0, c.numel() - K + 1, stride)
        starts.append(base + st)
        lens.append(np.minimum(Lw, c.numel() - st))
    seq = torch.cat(parts)
    st = torch.from_numpy(np.concatenate(starts)).to(dev)
    ln = torch.from_numpy(np.concatenate(lens).astype(np.int32)).to(dev)
    B = st.numel()
    idx = torch.clamp(st[:, None] + torch.arange(Lw, device=dev), max=seq.numel() - 1)
    codes = torch.where(torch.arange(Lw, device=dev)[None, :] < ln[:, None], seq[idx], 0)
    sh = 2 * torch.arange(16, device=dev, dtype=torch.int64)
    words = (codes.reshape(B, Lw // 16, 16) << sh).sum(dim=2)
    packed = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    packed, ln = torch.cat([packed, packed]), torch.cat([ln, ln])
    del genome, seq, idx, codes, words

    keys = torch.sort(kmer.kmer_scan(packed, ln, K, Lw)).values
    uk, uc, _ = count.runs(keys)
    del keys, packed
    cutoff = 2
    sk, sc = count.compact_solid(uk, uc, cutoff)
    log(f"[yeast] genome {total} bp in {len(linear)} linear + {len(circular)} circular contigs, "
        f"{2 * B} windows -> {uk.numel()} distinct, {sk.numel()} solid k-mers")
    records: dict = {}
    fig = unitig_checks(records, sk, sc, cutoff, uk.numel(), "yeast")
    if not fig["cycles_flagged"]:
        raise AssertionError("[yeast] the optimistic build did not flag the plasmid cycles")
    fig["genome_bp"] = total
    fig["kernels"] = records
    return fig


# ---------------------------------------------------------------------------
# phase 5: other widths and modes, the card against the CPU
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


def variants() -> None:
    """Each variant's archive compressed on the card equals the one the
    plain (CPU) path writes — which the CPU tests hold equal to leon_tpu's —
    and the card decodes it: byte-exact for lossless modes, sequence-exact
    and equal to the CPU decode for lossy qualities."""
    from leon_tpu_torch import LeonConfig, pipeline

    os.makedirs(WORK, exist_ok=True)
    for i, (label, kind, kw) in enumerate(VARIANTS):
        src = os.path.join(WORK, f"variant{i}.{kind}")
        write_corpus(src, kind, 100 + i)
        cfg = LeonConfig(**kw)
        data = {}
        for side, d in (("card", "cuda"), ("cpu", "cpu")):
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
# phase 6: the main path
# ---------------------------------------------------------------------------


def seq_lines(path: str) -> list:
    with open(path, "rb") as f:
        return f.read().split(b"\n")[1::4]


def main_path(records: dict, card: str) -> None:
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
    n = PIN["n_reads"]
    walls = {}
    # the default (native host unitig builder on a thread) drives K1-K4; the
    # device-build configuration drives K1-K8. The kernels line takes K1-K4's
    # counts from the default run and K5-K8's from the device-build run.
    default_path = [k for k in KERNELS if k not in DEVICE_BUILD]
    for label, extra, path, read in (
            ("default", {}, default_path, default_path),
            ("device unitig build", {"unitig_device_max_kmers": 1 << 30}, list(KERNELS),
             list(DEVICE_BUILD))):
        cfg = LeonConfig(noheader=True, noqual=True, **extra)
        kernels.launches.clear()
        torch.cuda.synchronize()
        t = time.time()
        st = pipeline.compress(src, arc, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        t_c = time.time() - t
        t = time.time()
        pipeline.decompress(arc, out, cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        t_d = time.time() - t
        launches = dict(kernels.launches)

        if seq_lines(src) != seq_lines(out):
            raise AssertionError(f"{label}: sequence round trip is not exact")
        with open(arc, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        size = os.path.getsize(arc)
        if ((size, digest) != (PIN["bytes"], PIN["sha256"])
                or st["n_anchored"] != PIN["n_anchored"]):
            raise AssertionError(f"{label}: archive {size} B sha256 {digest} n_anchored "
                                 f"{st['n_anchored']} != the reference's {PIN}")
        missing = [k for k in path if launches.get(k, 0) < 1]
        if missing:
            raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")
        for k in read:
            records[k]["launches"] = launches[k]
        walls[label] = t_c
        log(f"main path ({label}) ok: archive {size} B = the reference's (sha256 "
            f"{digest[:16]}), ratio {st['ratio']:.3f}, round trip exact, launches {launches}")
        log(f"compress {n / t_c:.1f} reads/s ({t_c:.2f} s), decompress {n / t_d:.1f} reads/s "
            f"({t_d:.2f} s) on {card} (host clock, end to end)")
        log(f"compress spans: {json.dumps(st.get('span_s', {}))}")
    log(f"compress wall, one call: {json.dumps(walls)}")


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
    fig = yeast_phase()
    log(f"[yeast] {json.dumps(fig)}")
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
