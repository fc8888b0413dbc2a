#!/usr/bin/env python3
"""Time kernels K2 (`count.runs`, three modes), K8 (`unitig.solid_lookup`),
K14 (`count.word_runs` in its three modes and `count.runs_words`), the k-mer
scans K1 (`kmer.kmer_scan`) and K17 (`kmer.kmer_scan_halves`), the walks
K18 and K19, the tensor path's K13, K15 and `count_batch` (K20), the Bloom
builds K16 and K3, the device unitig build's K5
links, K6 chain ranking and K7 emission, and the graph API's K10-K12 of one
tree's leon_tpu_torch on the card, beside the PyTorch call that computes the same function where
there is one, on inputs made from fixed seeds.

    python3 scripts/ab_kernels.py --tree PATH [--label NAME]
        [--only k2,k8,scan,k14,walk,dense,tensor,bloom,rank,k3,links,emit,graph,
                gather,wordsort,sort]

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
  scan:k1      K1 on one 65,536-read chunk of phase 3's reads (L = 104,
               k = 31), as DeviceCounter.add_packed launches it; ":slab"
               the 7-chunk slab in one launch (chip_smoke.py phase 3's)
  scan:w4/w8/w16  K17 on one 65,536-read chunk at phase 9's shapes: phase 3's
               reads at k = 63, 250-bp reads (gen_fastq's 250-bp corpus) at
               k = 127, 300-600 bp reads (chip_smoke.long_reads) at k = 255:
               the kernel alone (its C entry with the offsets made first),
               ":wrapper" the whole wrapper call (with its host sync on the
               valid count) and ":sync" the valid count alone (its device
               work by the profiler: the host's wait shows in ":wrapper"
               less the kernel)
  word_runs:w4/w8/w16  K14 over phase 9's rows at the same three shapes
               (every chunk scanned by K17): ":slab" the first chunk's sorted
               rows in length mode (library: torch.unique_consecutive(dim=0)
               over the stacked planes), ":merge" the merge of every chunk's
               slab run (counts + histogram), ":solid" the solid compaction
               at the abundance cutoff, ":runs_words" count_batch's K14
               over every valid row sorted (library as ":slab")
  walk:w2/w4/w8/w16/l2048  K18 (`walk.walk_encode_words`, without the
               confirmed bits) and K19 (`walk.walk_decode_words`, on what K18
               encoded) alone on one 65,536-read chunk: W = 2 phase 3's reads
               at k = 31 (beside K4's `walk_encode` and `walk_decode` on the
               same chunk: k4_enc_ms, k4_dec_ms), W = 4 the same reads at
               k = 63, W = 8 the 250-bp corpus at k = 127, W = 16
               chip_smoke.long_reads at k = 255, l2048 long_reads of 1,025-
               2,048 bp at k = 63 (L = 2048, the default max_device_len), each
               against the Bloom filter the main path builds from the
               chunks' reads (phase 9's: K17, K14, K16, 24 bits a solid
               k-mer, H = 4). Beside each: its probes (K18 one an anchor
               position and four a step, K19 four a step), the probe floor
               (scripts/walk_probe_floor.cu: the same probes, the same
               threads, no dependency between them), the arithmetic bound
               (STEP_OPS a step, ANCHOR_OPS an anchor position, over the
               card's issue rate), the byte bound, the bound (the largest of
               the three) and the kernel's share of it; and the registers
               ptxas gave the tree's walk kernels
  dense:w4/w8/w16  (section dense) K15 (`walk.encode_batch`, the tensor
               path's dense walk: the codes packed, then the walk) on the
               first 65,536 reads of walk's inputs at k = 63, 127 and 255
               (L = 104, 250, 600), against the main path's filter of those
               reads, beside K18 (`walk.walk_encode_words` with the
               confirmed bits, "k18_ms") on the same chunk and filter: its
               probes (one an anchor position and four a step: the right
               side's min(len - k - apos, ME) steps and the left side's
               apos), "floor_ms" their probe floor
               (scripts/walk_probe_floor.cu), "bytes_ms" (codes, lengths and
               the bitset read, the packed copy written and read, the 15
               outputs written) over 3.35 TB/s, the bound (the larger),
               "share" and "k18_plus_bytes_ms"; "device_ms" and
               "k18_device_ms", the device time alone (kernels and
               memsets by the profiler; "device" K15's by kernel: the
               wrapper's host work shows in "ms" less it); the ptxas
               registers of the tree's K15 and K18 kernels
  tensor:w4/w8/w16  (section tensor) K13 (`kmer.kmer_scan_words`) over every
               read of walk's inputs at k = 63, 127 and 255 (458,752 x 104,
               200,000 x 250, 131,072 x 300-600 bp: PERF.md row 12a), held
               against its plain version: "k13_ms", its bytes (codes and
               lengths read, canon, is_rc and valid written), bound and
               share; then `count.count_batch` over the valid rows (row
               12b), held against `torch.unique(dim=0, return_counts=True)`
               of the same rows put in the u32 order: "count_batch_ms"
               beside "unique_ms", "bound_ms" (the valid rows read once,
               uniq and counts written once, one read and write of the top
               sort's int64 keys and indices) and "device" (each kernel's
               and copy's device time by the profiler); on a tree with K20,
               "top_sort_ms" (the valid rows' top 64 bits, torch.sort),
               "sort_ties_ms" (K20, held against its plain version) with
               its bytes (keys and indices read, rows gathered, planes
               written) and bound, and "runs_words_ms" (K14 on its planes);
               the ptxas registers of the tree's K13, K20 and K14 kernels
  bloom:w4/w8/w16  K16 (`bloom.bloom_build_words`) over the main path's
               solid rows at each width (phase 9's: K17, K14, the solid
               compaction; 24 bits a solid k-mer, H = 4), as the
               WordCounter calls it; ":partial" over the whole distinct run
               with its solid rows marked valid (the tensor path's and
               mesh's partial, a sparse valid); ":hot" the same solid rows
               into 64 words (every atomic on 64 addresses). Beside each:
               rows, valid rows, bytes (the valid mask, the valid rows'
               words, the bitset), the byte bound, the table loads
               (8W 64-bit (f, r) entries a valid row) and the table-load
               bound (their 32-bit words over 132 SMs x 32 lanes x the
               maximum SM clock: shared memory's rate), and the ptxas
               registers of the tree's K1 and K16 instances
  bloom:k3     (section k3) K3 (`bloom.bloom_build`) on phase 3's slab run at
               its cutoff (k = 31), with its byte bound and ptxas registers
  rank:bench/yeast/w4/w8/w16  (section rank) K6: `unitig.chain_rank` whole,
               optimistic (the time includes any host read the tree makes;
               ":full" the full variant: FULL, the cycle cut, RANK) on the
               links K5 makes over phase 3's bench solid run (2,014,298
               31-mers), chip_smoke.py's yeast genome (yeast_solid: 14.25M
               solid 31-mers, two plasmid cycles) and phase 9's solid sets at
               k = 63 / 127 / 255; its bound (nxt and prev read, S written:
               24 bytes a node); "build_ms" the whole device build,
               dispatch_build + drain_build (host clock after a sync, mean of
               3 after one), "build_peak_bytes" the device memory it takes
               above what the caller holds (torch.cuda.max_memory_allocated);
               on a tree with `unitig.unitig_rank`, "kernels" the device
               time of each of its kernels by the profiler. K6's ruler
               sampling is a constant (RK_RULER_LOG2 in csrc/unitig.cu): to
               retune it, run this section on a copy of the tree with the
               constant edited, beside the tree itself
  links:bench/yeast/w4/w8/w16  (section links) K5 (`unitig.unitig_links`) on
               the same runs as rank: its time, "bytes" (the run read, nxt
               and prev written) and their bound, "floor_ms" its probe floor
               (scripts/links_probe_floor.cu: a table entry and a row word
               for each search of the change's design that lands at a
               random place, "random_searches": node 2i's reverse-
               complement forms and node 2i + 1's forward search, of
               "searches" in all; the others follow the rows' order; no
               dependency between them), the bound (the larger) and the
               share of it; at k = 31 "library_ms", one torch.searchsorted of
               the 8 candidate keys of every row over the run (the search
               part alone); "kernels" each kernel's device time by the
               profiler, "T" the change's table bits; the ptxas registers
  emit:bench/yeast/w4/w8/w16  (section emit) K7 (`unitig.unitig_emit`) on
               the optimistic ranking of the same runs: its time, bytes (the
               run, nxt, prev, S read, the buffer written), bound, share and
               kernels as links; then the device build, dispatch_build +
               drain_build: "build_ms" (host clock after a sync, mean of 3
               after one), "build_split" (one profiled build: its kernels'
               device time, D2H, the other copies and memsets, and the rest
               of its wall, the host's), "build_launches" (K5, K6's
               kernels, K7 a build) and "build_peak_bytes"
  graph:w2/w8/w16  (section graph) the graph API's kernels as chip_smoke.py
               phases 7 and 10 drive them, on Graph.from_solid of phase 3's
               2,014,298 solid 31-mers (slab_reads with `reverse`, K1, sort,
               K2, the cutoff from its merge's histogram) and phase 9's
               solid sets at k = 127 and 255 (1,777,017 and 530,019 rows):
               K10 (`bloom.dbg_probe`) over
               every node in each mode (self, out, in), classic on the
               graph's bitset (H = 4, 16 bits a k-mer) and blocked on the
               compress filter (K3's at k = 31, K16's past it); K11
               (`DBG.walk`, 100 steps from every node); K12 (`DBG.traverse`,
               16 steps) at D = 32 from 65,536 nodes (the branching nodes
               first) and at D = k + 1 from those 65,536 and from their
               first 16,384 (K11's bases and n from its first 262,144 nodes
               also held against its plain version). Beside each: "loads",
               the fewest bitset loads
               any design makes on these inputs (a classic probe's up to its
               first clear bit, a blocked probe's one word; K12's bubble
               depths probe only the live branches), counted by a replay in
               PyTorch (rolled hashes) that must give the kernel's own
               output; "floor_ms", scripts/graph_probe_floor.cu with those
               loads, independent, 8 in flight a thread; "chain_ms", the
               same kernel with each row's or lane's probe steps as one
               chain of dependent loads (one a step: the fewest dependent
               rounds; "max_steps" the longest lane's); "bytes_ms" (nodes
               read, outputs written); for K10 "table_ms", its hash's 8W
               64-bit table entries a row over shared memory's rate (as
               bloom's); "bound_ms" the largest, "share" bound / ms; the
               ptxas registers of the tree's graph kernels
  gather:1mb/2mb/8mb  (section gather) K9 (`gather.gather_words`) on
               chip_smoke.py phase 7's inputs (2**24 random indices into u32
               tables of 1, 2 and 8 MB) beside `torch.take` ("library_ms")
               and its floors from scripts/gather_floor.cu: "stream_ms" (a),
               the indices read and the outputs written alone, and
               "l2_ms" (b), 2**24 random 4-byte loads from the table with
               4, 8 or 16 in flight a thread (the least of the three is
               "l2_floor_ms"); "bound_ms" the larger of (a) and (b),
               "bytes_ms" the byte bound (table, indices and outputs over
               3.35 TB/s), "share" bound / ms; the ptxas registers of the
               tree's K9
  wordsort:w4/w8/w16  (section wordsort) the WordCounter's slab sort plus
               K14 as the main path runs it (`WordCounter._slab_run`: the
               parent's LSD sort_planes, or K21, the top sort and K20), on
               the bench slabs: every valid k-mer of the 500,000 x 100 bp
               bench corpus at k = 63 (W = 4) and of the 200,000 x 250 bp
               corpus at k = 127 (W = 8), each one slab as compress counts
               it, and one 65,536-read chunk of 300-600 bp reads at k = 255
               (W = 16, phase 9's); held against sort_planes + K14's plain
               version; "slab_ms" beside "library_ms"
               (`torch.unique(dim=0, return_counts=True)` of the slab's
               rows), "lsd_ms" (the LSD sort_planes alone), on a tree with
               K21 its parts ("plane_rows_ms", "top_sort_ms", "sort_ties_ms",
               "word_runs_ms") and "planes_to_words_ms" (the PyTorch
               planes -> rows a kernel replaced); the byte bound (the
               planes read, the distinct rows and counts written) and
               floor (c) of scripts/gather_floor.cu ("rows_floor_ms": the
               slab's rows gathered in its top-sort order); "peak_bytes"
               the card's memory the slab run takes above what the caller
               holds. ":merge" at W = 8 and 16: phase 9's merge of every
               chunk's slab run with the counts (`_merge_sorted`: K23 over
               the runs, or on a tree without it the sort of their
               concatenation with the counts carried; then K14 with the
               histogram; no one PyTorch call sums a payload), its parts and
               floor (c).
               "w16:flush" the card's peak memory while phase 9's two W = 16
               chunks fill a slab and the second flushes it (the scan,
               the slab sort and K14 of 25.6M rows)
  sort:k31:slab/k31:sentinel_heavy/k31:half_one_key/k31:merge/k21:merge/w8:slab(:bits)/chunk:*/
  w16:rows/merge:*  (section sort) K22
               (`count.radix_sort` and its index and row forms) at the count
               path's shapes: the k = 31 slab of 500,000 reads of phase 3's
               generator (K1, 37.0M keys, SENTINEL where invalid; keys
               alone), the slab with SENTINEL at a random one position in
               four (":sentinel_heavy") and with half its keys one key,
               shuffled (":half_one_key"), the merge of its distinct run and every third row
               again (two sorted runs, with their int32 counts), those keys
               cut to 42 bits (":k21:merge", sorted over 42 bits as a k = 21
               merge is, beside "all_passes_ms" over 64; a tree whose
               radix_sort takes bits),
               the k = 127
               bench slab's top keys (K21 over every chunk's K17 planes; with
               their index; over 64 bits, and over top_key_bits(k) as the
               main path sorts them, ":bits"), the first chunk's top keys at W = 4, 8, 16
               (":chunk:w4" ...: phase 9's chunks, with their index, over
               top_key_bits(k)) and the W = 16 merge's top keys read from its rows
               (phase 9's two chunks; with their index): "path_ms" the
               tree's own sort there (on a tree without K22, torch.sort and
               the gather it made), beside "torch_sort_ms" (torch.sort(stable
               =True) of the keys: the library call), "plain_ms" (the plain
               version: torch.sort and the payload's gather; at W = 16 with
               _top_keys), "floor_ms" (scripts/sort_floor.cu: the keys and
               the payload as K22 carries it between passes, int32, copied
               once a pass for "passes", the digits in which the keys differ),
               "bucket_floor_ms" (the bucket route's floor: the keys read once,
               then a copy for each of its passes, two or three, and one for
               K24), on a tree whose wrappers take `route`: "route" (the
               one radix_route picks) and the sort by each route named to the
               wrapper, "passes_ms", "bucket16_ms" and "bucket24_ms" (where
               the bucket leaves a bit below it; not on the merge's keys
               read from rows),
               "bytes_ms" (keys read and written
               once, the payload written, over 3.35 TB/s), "share_of_floor",
               "share_of_bucket_floor", "share_of_bytes" and "kernels_ms"
               (each of K22's, K24's and K25's kernels and the memsets in
               one sort, device time by the profiler); ":final:w8/w16" finalize's
               reduce of the final run at k = 127 and 255 (every chunk's slab
               run merged): the tree's (K14's row policy, or
               state.words_to_planes and K14) beside "planes_k14_ms" and
               "words_to_planes_ms"; "merge:k31/w4/w8/w16" K23 at the
               count's four merge shapes: the k = 31 merge's two runs (the
               distinct run and every third row, with their counts) and
               phase 9's merges of every chunk's slab run at W = 4, 8, 16 (7,
               4, 2 runs): "k23_ms" (`merge_path` / `merge_path_rows`, held
               against merge_path_plain) beside "cat_sort_ms" (the parent's
               route: torch.cat of the runs, then K22 with the counts over
               2k bits, or `sort_rows`: K22 of the top keys read from the
               rows and K20 with the counts), "torch_sort_ms"
               (torch.sort(stable=True) of the concatenated keys, or of the
               rows' top keys), "counter_merge_ms" (the tree's whole counter
               merge with its reduce and histogram), the card's peak memory
               of each ("*_peak_bytes"), "floor_ms" (scripts/sort_floor.cu
               lt_merge_floor: the runs' elements and counts copied once a
               pairwise round, "rounds" = ceil(log2 runs)), "bytes_ms" (read
               once and written once) and the shares of both; the ptxas
               registers of K22's and K23's kernels
Every record is checked exact against the tree's plain version first.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ("k2", "k8", "scan", "k14", "walk", "dense", "tensor", "bloom", "rank", "k3", "links",
            "emit", "graph", "gather", "wordsort", "sort")


def slab_sort(count, planes, W: int):
    """The tree's WordCounter slab sort: sort_slab (K21, the top sort, K20)
    where the tree has it, else the parent's LSD sort_planes."""
    return count.sort_slab(planes, W) if hasattr(count, "sort_slab") else count.sort_planes(planes)


def merge_sort(count, state, words, counts):
    """The tree's WordCounter merge sort: sort_rows (the top sort, K20 with
    the counts as payload) where the tree has it, else sort_planes with the
    counts permuted. Returns (planes, counts)."""
    if hasattr(count, "sort_rows"):
        return count.sort_rows(words, counts)
    planes, perm = count.sort_planes(state.words_to_planes(words), with_perm=True)
    return planes, counts[perm]


def counter_merge(count, c, runs: list, want_hist: bool):
    """The tree's counter merge of sorted runs [(rows, counts), ...] with its
    reduce: K23 over the runs where they lie where the tree has it
    (`_merge_sorted(parts, want_hist)`), else the parent's torch.cat and sort
    of the concatenation (`_merge_sorted(rows, counts, True, want_hist)`)."""
    if "parts" in inspect.signature(c._merge_sorted).parameters:
        return c._merge_sorted(runs, want_hist)
    import torch

    return c._merge_sorted(torch.cat([r[0] for r in runs]), torch.cat([r[1] for r in runs]),
                           True, want_hist)


def peak_bytes(fn) -> int:
    """The card's memory fn() takes above what the caller holds."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def slab_reads(nr: int, reverse: bool):
    """chip_smoke.py phase 3's reads: (nr, 104) codes of 100 bp from a 2
    Mbp random contig, 1% substitutions (kernel_checks also reverses
    every other read and shortens every 997th: `reverse`)."""
    import numpy as np

    rng = np.random.default_rng(20261016)
    L, READ_LEN = 104, 100
    contig = rng.integers(0, 4, 2_000_000, dtype=np.uint8)
    starts = rng.integers(0, contig.size - READ_LEN, nr)
    codes = np.zeros((nr, L), np.uint8)
    codes[:, :READ_LEN] = contig[starts[:, None] + np.arange(READ_LEN)]
    mut = rng.random((nr, READ_LEN)) < 0.01
    codes[:, :READ_LEN][mut] = (codes[:, :READ_LEN][mut] + 1) & 3
    lengths = np.full(nr, READ_LEN, np.int32)
    if reverse:
        rev = np.arange(nr) % 2 == 1
        codes[rev, :READ_LEN] = (3 - codes[rev, :READ_LEN])[:, ::-1]
        lengths[:: 997] = rng.integers(0, READ_LEN, lengths[:: 997].size)
        codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return codes, lengths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--label", default="", help="name printed with the results")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help=f"comma-separated sections of {SECTIONS}")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        ap.error(f"--only takes {SECTIONS}")
    sys.path.insert(0, ROOT)  # chip_smoke.py's read generators, from this script's tree
    import chip_smoke

    sys.path.insert(0, args.tree)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
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
            if not torch.equal(x.to(torch.int64), y.to(torch.int64).to(x.device)):
                raise AssertionError("kernel differs from its plain version")

    out = {"rows": {}}

    def chunks_of(codes, lengths):
        B = chip_smoke.B
        packed = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
        ln = torch.from_numpy(lengths).to(dev)
        return [(packed[s : s + B], ln[s : s + B]) for s in range(0, codes.shape[0], B)]

    wide_inputs = {}

    def wide(W: int):
        """(k, chunks, L, the first chunk's codes and lengths, every read's
        codes and lengths) of phase 9's reads at one width (W = 2: phase 3's
        reads at k = 31; W = 0: one chunk of 1,025-2,048 bp reads at k =
        63)."""
        if W not in wide_inputs:
            if W == 0:
                codes, lengths = chip_smoke.long_reads(chip_smoke.B, 1025, 2048)
                k = 63
            elif W <= 4:
                codes, lengths = slab_reads(7 * chip_smoke.B, True)
                k = 31 if W == 2 else 63
            elif W == 8:
                os.makedirs(chip_smoke.WORK, exist_ok=True)
                path = os.path.join(chip_smoke.WORK, "ab_200k_250bp.fastq")
                chip_smoke.gen_fastq(path, 200_000, 2_000_000, 250)
                codes, lengths = chip_smoke.fastq_codes(path)
                k = 127
            else:
                codes, lengths = chip_smoke.long_reads(2 * chip_smoke.B, 300, 600)
                k = 255
            wide_inputs[W] = (k, chunks_of(codes, lengths), codes.shape[1],
                              codes[: chip_smoke.B], lengths[: chip_smoke.B], codes, lengths)
        return wide_inputs[W]

    if "k2" in only:  # K2 on chip_smoke.py phase 3's slab
        K, L = 31, 104
        codes, lengths = slab_reads(7 * 65536, False)
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
        out["rows"].update({"runs": skeys.numel(), "distinct": rk.numel(), "merge": ms_.numel(),
                            "solid": sk.numel(), "cutoff": cutoff})
        del skeys, ms_, mc

    if "k8" in only:
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

        sets = [("yeast", torch.unique(torch.from_numpy(
            np.random.default_rng(31).integers(0, 1 << 62, 14_254_300)).to(dev)), 31),
                ("w4", random_rows(2_024_000, 63, 4), 63),
                ("w8", random_rows(1_777_017, 127, 8), 127),
                ("w16", random_rows(530_019, 255, 16), 255)]
        if "k2" in only:
            sets.insert(0, ("bench", sk, 31))
        for name, rows, k in sets:
            words = rows.dim() == 2
            q = queries(rows, words)
            same(unitig.solid_lookup(rows, k, q), unitig.solid_lookup_plain(rows, k, q))
            out[f"lookup:{name}"] = ms(lambda: unitig.solid_lookup(rows, k, q), 20)
            if not words:
                out[f"lookup:{name}:searchsorted"] = ms(lambda: torch.searchsorted(rows, q), 20)
            out["rows"][f"lookup:{name}"] = rows.shape[0]

    if "scan" in only:
        # K1 as DeviceCounter.add_packed launches it: one chunk into a slab view
        codes, lengths = slab_reads(chip_smoke.B, True)
        (p1, l1), = chunks_of(codes, lengths)
        L = codes.shape[1]
        want = kmer.kmer_scan_plain(p1, l1, 31, L)
        slab = torch.empty(want.numel(), dtype=torch.int64, device=dev)
        same([kmer.kmer_scan(p1, l1, 31, L, out=slab)], [want])
        out["scan:k1"] = ms(lambda: kmer.kmer_scan(p1, l1, 31, L, out=slab), 20)
        out["rows"]["scan:k1"] = want.numel()
        del want, slab
        codes, lengths = slab_reads(7 * chip_smoke.B, True)
        p7 = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
        l7 = torch.from_numpy(lengths).to(dev)
        slab = kmer.kmer_scan(p7, l7, 31, L)
        same([slab], [kmer.kmer_scan_plain(p7, l7, 31, L)])
        out["scan:k1:slab"] = ms(lambda: kmer.kmer_scan(p7, l7, 31, L, out=slab), 10)
        out["rows"]["scan:k1:slab"] = slab.numel()
        del p7, l7, slab
        lib = kernels.lib()
        for W in (4, 8, 16):
            k, chunks, L = wide(W)[:3]
            p0, l0 = chunks[0]
            P = L - k + 1
            same(kmer.kmer_scan_halves(p0, l0, k, L), kmer.kmer_scan_halves_plain(p0, l0, k, L))
            nv = torch.clamp(l0.to(torch.int64) - (k - 1), 0, P)
            n = int(nv.sum())
            offs = torch.cumsum(nv, 0) - nv
            dst = tuple(torch.empty(n, dtype=torch.int64, device=dev)
                        for _ in range(state.n_planes(W)))
            ptrs = np.array([h.data_ptr() for h in dst], dtype=np.uint64)
            st = kernels.stream(p0)

            def raw():
                kernels.check(lib.lt_kmer_scan_halves(
                    p0.data_ptr(), l0.data_ptr(), offs.data_ptr(), p0.shape[0], p0.shape[1], L,
                    k, P, kmer.top_mask(k), len(dst), ptrs.ctypes.data, st), "kmer_scan_halves")

            raw()
            same(dst, kmer.kmer_scan_halves(p0, l0, k, L))
            out[f"scan:w{W}"] = ms(raw, 20)
            out[f"scan:w{W}:wrapper"] = ms(lambda: kmer.kmer_scan_halves(p0, l0, k, L), 20)
            out[f"scan:w{W}:sync"] = ms(
                lambda: int(torch.clamp(l0.to(torch.int64) - (k - 1), 0, P).sum()), 20)
            out["rows"][f"scan:w{W}"] = n
            del dst

    if "k14" in only:
        for W in (4, 8, 16):
            k, chunks, L = wide(W)[:3]
            tag = f"word_runs:w{W}"
            scans = [kmer.kmer_scan_halves(p, ln, k, L) for p, ln in chunks]
            srt = slab_sort(count, scans[0], W)
            same(count.word_runs(srt, W), count.word_runs_plain(srt, W))
            stacked = torch.stack(srt, dim=1)
            out[f"{tag}:slab"] = ms(lambda: count.word_runs(srt, W), 10)
            out[f"{tag}:slab:unique_consecutive"] = ms(
                lambda: torch.unique_consecutive(stacked, dim=0, return_counts=True), 3)
            out["rows"][f"{tag}:slab"] = srt[0].numel()
            del stacked, srt
            slab_runs = [count.word_runs(slab_sort(count, h, W), W)[:2] for h in scans]
            words = torch.cat([r[0] for r in slab_runs])
            counts = torch.cat([r[1] for r in slab_runs])
            del slab_runs
            mpl, mc = merge_sort(count, state, words, counts)
            del words, counts
            gw, gc, gh = count.word_runs(mpl, W, mc, 1, True)
            same((gw, gc, gh), count.word_runs_plain(mpl, W, mc, 1, True))
            out[f"{tag}:merge"] = ms(lambda: count.word_runs(mpl, W, mc, 1, True), 10)
            out["rows"][f"{tag}:merge"] = [mc.numel(), gw.shape[0]]
            del mpl, mc
            cutoff = count.auto_cutoff(gh.cpu().numpy().astype(np.int64))
            gpl = state.words_to_planes(gw)
            same(count.word_runs(gpl, W, gc, cutoff), count.word_runs_plain(gpl, W, gc, cutoff))
            out[f"{tag}:solid"] = ms(lambda: count.word_runs(gpl, W, gc, cutoff), 10)
            out["rows"][f"{tag}:solid"] = [gc.numel(), int((gc >= cutoff).sum()), cutoff]
            del gw, gc, gh, gpl
            apl = slab_sort(count, tuple(torch.cat([s[q] for s in scans])
                                         for q in range(state.n_planes(W))), W)
            del scans
            same(count.runs_words(apl, W), count.runs_words_plain(apl, W))
            stacked = torch.stack(apl, dim=1)
            out[f"{tag}:runs_words"] = ms(lambda: count.runs_words(apl, W), 10)
            out[f"{tag}:runs_words:unique_consecutive"] = ms(
                lambda: torch.unique_consecutive(stacked, dim=0, return_counts=True), 3)
            out["rows"][f"{tag}:runs_words"] = apl[0].numel()
            del apl, stacked
            torch.cuda.empty_cache()
    if "walk" in only:
        out["walk"] = walk_section(args.tree, wide, ms, same, dev)
    if "dense" in only:
        out["dense"] = dense_section(args.tree, wide, ms, same, dev)
    if "tensor" in only:
        out["tensor"] = tensor_section(args.tree, wide, ms, same, dev)
    if "bloom" in only:
        out["bloom"] = bloom_section(args.tree, wide, ms, same, dev)
    if "k3" in only:
        out["k3"] = k3_section(args.tree, slab_reads, ms, same, dev)
    if "rank" in only:
        out["rank"] = rank_section(wide, slab_reads, ms, same, dev)
    if "links" in only:
        out["links"] = links_section(args.tree, wide, slab_reads, ms, same, dev)
    if "emit" in only:
        out["emit"] = emit_section(args.tree, wide, slab_reads, ms, same, dev)
    if "graph" in only:
        out["graph"] = graph_section(args.tree, wide, slab_reads, ms, same, dev)
    if "gather" in only:
        out["gather"] = gather_section(args.tree, ms, same, dev)
    if "wordsort" in only:
        out["wordsort"] = wordsort_section(wide, ms, same, dev)
    if "sort" in only:
        out["sort"] = sort_section(args.tree, wide, ms, same, dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "card": card, "ms": out}), flush=True)
    return 0


# Thread instructions K18 and K19 must issue (csrc/walk.cu, counted by hand;
# recount them when the kernels change). A walk step: the leaving base from
# the ring (its word index, shared-memory load, shift and mask: 8), rolled
# out of both chains (two table loads, two xors, two rotates: 6); per
# candidate two xors, min, max, the word index (mulhi), the H-bit mask
# (shift, mask, shift, or per hash), the load and the membership test (and,
# compare, or): 9 + 4H; pick the base, roll it into the chains and the
# walked word (popcount, its bit, two table loads, two xors, shift, or: 9).
# An anchor position: one base in and one out (shift and mask each: 4; four
# table loads, two xors, two rotates, two xors: 10), one probe (5 + 4H + 3),
# the fold (min, compare, four selects: 6).


def step_ops(H: int) -> int:
    return 14 + 4 * (9 + 4 * H) + 9


def anchor_ops(H: int) -> int:
    return 14 + 5 + 4 * H + 3 + 6


def lane_rate() -> float:
    """Lane-cycles a second: SMs x 32 lanes x the card's maximum SM clock
    (nvidia-smi)."""
    import torch

    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.split()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count * 32 * float(mhz) * 1e6


def issue_rate() -> float:
    """Thread instructions a second the card can issue: 4 warp schedulers
    an SM, each a warp's instruction a clock."""
    return 4 * lane_rate()


def floor_lib(name: str, fn: str, argtypes: list):
    """scripts/<name>.cu built with nvcc into build/ab_kernels/, with the C
    entry `fn`'s argument types set."""
    import ctypes
    import shutil

    src = os.path.join(ROOT, "scripts", f"{name}.cu")
    out_dir = os.path.join(ROOT, "build", "ab_kernels")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src], check=True, timeout=600)
    lib = ctypes.CDLL(so)
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def probe_floor_lib():
    """scripts/walk_probe_floor.cu (K18 and K19's probe floor)."""
    import ctypes

    P, I, Un = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    return floor_lib("walk_probe_floor", "lt_probe_floor", [P, Un, I, P, I, Un, P, P])


WALK_KERNELS = ("walk_encode_words_kernel", "walk_decode_words_kernel", "walk_encode_kernel",
                "walk_decode_kernel")


def registers(tree: str, names: tuple) -> dict:
    """Registers ptxas gave the instances of the named kernels in the tree's
    last kernel build (build/leon_tpu_torch/ptxas.log): name -> [min, max]
    (a name that prefixes another comes after it in `names`)."""
    import re

    path = os.path.join(tree, "build", "leon_tpu_torch", "ptxas.log")
    regs, cur = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = re.sub(r"^_Z\d+", "", m.group(1))
                cur = next((n for n in names if name.startswith(n)), None)
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                lo, hi = regs.get(cur, (999, 0))
                regs[cur] = [min(lo, int(m.group(1))), max(hi, int(m.group(1)))]
                cur = None
    return regs


def main_solid(k: int, chunks, L: int, dev) -> dict:
    """The main path's count of every chunk's k-mers at 32 <= k <= 255
    (phase 9's: K17, each slab's sort + K14, their merge, the cutoff, the
    solid compaction) and its Bloom sizing: the distinct rows and counts,
    the cutoff, the solid rows, n_solid and n_words."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom, count, kmer

    W = kmer.words_for_k(k)
    runs = [count.word_runs(slab_sort(count, kmer.kmer_scan_halves(p, ln, k, L), W), W)[:2]
            for p, ln in chunks]
    words = torch.cat([r[0] for r in runs])
    counts = torch.cat([r[1] for r in runs])
    del runs
    mpl, mc = merge_sort(count, state, words, counts)
    gw, gc, gh = count.word_runs(mpl, W, mc, 1, True)
    del words, counts, mc, mpl
    hist = gh.cpu().numpy().astype(np.int64)
    cutoff = count.auto_cutoff(hist)
    sw, _ = count.compact_solid_words(gw, gc, cutoff)
    n_solid = int(hist[min(cutoff, 255):].sum())
    bpk, _h = bloom.auto_params(hist, cutoff, False, stored_filter=False)
    return {"distinct": gw, "counts": gc, "cutoff": cutoff, "solid": sw, "n_solid": n_solid,
            "n_words": bloom.choose_n_words(n_solid, bpk)}


def bloom_section(tree: str, wide, ms, same, dev) -> dict:
    """K16 at the main path's solid sets (W = 4, 8, 16), its partial over
    the distinct run and its hot-word case, with their bounds; see the
    docstring."""
    import numpy as np
    import torch

    import chip_smoke
    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom, count, kmer

    H, SEED = chip_smoke.H, chip_smoke.SEED
    lanes = lane_rate()
    res = {"lane_rate": lanes}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def k16(tag, words, valid, n_alloc, nw, k):
        got = bloom.bloom_build_words(words, valid, n_alloc, nw, H, SEED, k)
        same([got], [bloom.bloom_build_words_plain(words, valid, n_alloc, nw, H, SEED, k)])
        W = words.shape[1]
        n_valid = int(valid.sum())
        rec = {"k": k, "rows": words.shape[0], "valid": n_valid, "n_words": nw,
               "ms": ms(lambda: bloom.bloom_build_words(words, valid, n_alloc, nw, H, SEED, k),
                        10),
               "bytes": nbytes(valid, got) + 4 * W * n_valid}  # valid rows' words only
        rec["bytes_ms"] = rec["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
        rec["table_loads"] = 8 * W * n_valid
        rec["table_ms"] = 2 * rec["table_loads"] / lanes * 1e3  # 64-bit entries
        rec["bound_ms"] = max(rec["bytes_ms"], rec["table_ms"])
        rec["share"] = rec["bound_ms"] / rec["ms"]
        res[tag] = rec
        print(json.dumps({f"bloom:{tag}": rec}), flush=True)

    for W in (4, 8, 16):
        k, chunks, L = wide(W)[:3]
        sol = main_solid(k, chunks, L, dev)
        sw, nw = sol["solid"], sol["n_words"]
        ones = torch.ones(sw.shape[0], dtype=torch.bool, device=dev)
        k16(f"w{W}", sw, ones, nw, nw, k)
        k16(f"w{W}:partial", sol["distinct"], sol["counts"] >= sol["cutoff"],
            bloom.alloc_words(nw), nw, k)
        if W == 4:
            k16(f"w{W}:hot", sw, ones, 64, 64, k)
        del sol, sw, ones
        torch.cuda.empty_cache()

    res["registers"] = registers(tree, ("bloom_build_words_kernel", "kmer_scan_kernel"))
    return res


def bench_run(slab_reads, dev):
    """Phase 3's slab run at k = 31 (K1, torch.sort, K2): the distinct keys
    and counts, the cutoff, and the pipeline's Bloom size."""
    import numpy as np
    import torch

    import chip_smoke
    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom, count, kmer

    K, L = 31, 104
    codes, lengths = slab_reads(7 * chip_smoke.B, False)
    packed = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
    skeys = torch.sort(kmer.kmer_scan(packed, torch.from_numpy(lengths).to(dev), K, L)).values
    del packed
    rk, rc, _ = count.runs(skeys)
    del skeys
    hist = count.runs_plain(rk, rc, 1, True)[2].cpu().numpy().astype(np.int64)
    cutoff = count.auto_cutoff(hist)
    n_solid = int(hist[min(cutoff, 255):].sum())
    bpk, _h = bloom.auto_params(hist, cutoff, False, stored_filter=False)
    return rk, rc, cutoff, n_solid, bloom.choose_n_words(n_solid, bpk)


def k3_section(tree: str, slab_reads, ms, same, dev) -> dict:
    """K3 on phase 3's slab run at its cutoff, with its byte bound."""
    import chip_smoke
    from leon_tpu_torch.ops import bloom

    H, SEED, K = chip_smoke.H, chip_smoke.SEED, 31
    rk, rc, cutoff, n_solid, nw = bench_run(slab_reads, dev)
    bits = bloom.bloom_build(rk, rc, cutoff, nw, H, SEED, K)
    same([bits], [bloom.bloom_build_plain(rk, rc, cutoff, nw, H, SEED, K)])
    rec = {"k": K, "rows": rk.numel(), "valid": n_solid, "n_words": nw,
           "ms": ms(lambda: bloom.bloom_build(rk, rc, cutoff, nw, H, SEED, K), 20),
           "bytes": 12 * rk.numel() + 4 * nw}
    rec["bytes_ms"] = rec["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    rec["share"] = rec["bytes_ms"] / rec["ms"]
    rec["registers"] = registers(tree, ("bloom_build_kernel",))
    print(json.dumps({"bloom:k3": rec}), flush=True)
    return rec


def unitig_sets(wide, slab_reads, dev):
    """The device build's solid runs, one at a time: (name, rows, k, the
    distinct count) for phase 3's bench run (k = 31), chip_smoke.py's yeast
    genome and phase 9's solid sets at W = 4, 8, 16."""
    import chip_smoke
    from leon_tpu_torch.ops import count

    rk, rc, cutoff, _n, _nw = bench_run(slab_reads, dev)
    yield "bench", count.compact_solid(rk, rc, cutoff)[0], 31, rk.numel()
    del rk, rc
    sk, _sc, _c, nu, _g = chip_smoke.yeast_solid()
    yield "yeast", sk, 31, nu
    del sk
    for W in (4, 8, 16):
        k, chunks, L = wide(W)[:3]
        sol = main_solid(k, chunks, L, dev)
        yield f"w{W}", sol["solid"], k, sol["distinct"].shape[0]
        del sol


def profile_kernels(fn, reps: int) -> dict:
    """Device time a call of each kernel and copy of fn() by the profiler
    (ms, mean over reps calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:48]: e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def links_section(tree: str, wide, slab_reads, ms, same, dev) -> dict:
    """K5 on the device build's runs with its byte bound, its probe floor
    (scripts/links_probe_floor.cu: a table entry and a row word for each
    search of the change's design that lands at a random place, no
    dependency between them) and, at k <= 31, one
    torch.searchsorted of the 8 candidate keys of every row over the run
    (the search part alone: the links need the counts and the internal
    edges besides)."""
    import ctypes

    import torch

    import chip_smoke
    from leon_tpu_torch import kernels
    from leon_tpu_torch.ops import unitig

    P, I, Un = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    floor = floor_lib("links_probe_floor", "lt_links_floor", [P, Un, P, Un, I, P, I, Un, P, P])
    res = {}
    for name, rows, k, nu in unitig_sets(wide, slab_reads, dev):
        M = rows.shape[0]
        nxt, prev = unitig.unitig_links(rows, k)
        same((nxt, prev), unitig.unitig_links_plain(rows, k))
        N = 2 * M
        T = max(0, min(M.bit_length(), 26, 2 * k - 2))  # the change's table (links_table_bits)
        rec = {"k": k, "rows": M, "nodes": N, "T": T,
               "ms": ms(lambda: unitig.unitig_links(rows, k), 10),
               "bytes": rows.numel() * rows.element_size() + 8 * N}
        rec["bytes_ms"] = rec["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
        x0 = unitig._u32_rows(rows)
        rc = unitig._revcomp_plain(x0, k)
        take, cands = [], []
        for x, xr in ((x0, rc), (rc, x0)):
            t_o = []
            for b in range(4):
                cy, trc = unitig._successor_plain(x, xr, b, k)
                t_o.append(trc)
                cands.append(cy)
            take.append(torch.stack(t_o, dim=1))
        take = torch.stack(take, dim=1).reshape(N, 4)  # node 2i + o
        fwd_search = (~take).any(dim=1).to(torch.int32)
        rc_searches = take.sum(dim=1).to(torch.int32)
        rec["searches"] = int(fwd_search.sum() + rc_searches.sum())
        # the searches at random places: node 2i's rc forms (xr = the row's
        # reverse complement) and node 2i + 1's forward search (x << 2, x the
        # reverse complement); the others follow the rows' order
        odd = torch.arange(N, device=dev) % 2 == 1
        counts = torch.where(odd, fwd_search, rc_searches).contiguous()
        rec["random_searches"] = int(counts.sum())
        tab = torch.zeros((1 << T) + 1, dtype=torch.int32, device=dev)
        out = torch.empty(N, dtype=torch.int32, device=dev)
        rw = rows.element_size() * (rows.shape[1] if rows.dim() == 2 else 1) // 4
        st = kernels.stream(rows)

        def run_floor():
            kernels.check(floor.lt_links_floor(tab.data_ptr(), tab.numel(), rows.data_ptr(), M,
                                               rw, counts.data_ptr(), N, 0x5EED, out.data_ptr(),
                                               st), "links_floor")

        rec["floor_ms"] = ms(run_floor, 10)
        rec["bound_ms"] = max(rec["bytes_ms"], rec["floor_ms"])
        rec["share"] = rec["bound_ms"] / rec["ms"]
        if rows.dim() == 1:
            q = torch.cat([c.reshape(-1) for c in cands]).contiguous()
            rec["library_ms"] = ms(lambda: torch.searchsorted(rows, q), 10)
            rec["library_note"] = ("torch.searchsorted of the 8 candidate keys of every row: "
                                   "the search part alone")
            del q
        rec["kernels"] = profile_kernels(lambda: unitig.unitig_links(rows, k), 10)
        res[name] = rec
        print(json.dumps({f"links:{name}": rec}), flush=True)
        del nxt, prev, x0, rc, take, cands, counts, tab, out, rows
        torch.cuda.empty_cache()
    res["registers"] = registers(tree, ("succ_words_kernel", "succ_kernel", "buckets_words_kernel",
                                        "buckets_kernel", "link_kernel"))
    return res


def emit_section(tree: str, wide, slab_reads, ms, same, dev) -> dict:
    """K7 on the optimistic ranking of each device build's run, with its
    byte bound; then the device build (dispatch_build + drain_build): its
    wall (host clock after a sync, mean of 3 after one), split by the
    profiler into kernel time, memset time, D2H time and the rest (host),
    its launches a build and its peak memory above what the caller holds."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from leon_tpu_torch import kernels
    from leon_tpu_torch.ops import unitig

    res = {}
    for name, rows, k, nu in unitig_sets(wide, slab_reads, dev):
        M = rows.shape[0]
        nxt, prev = unitig.unitig_links(rows, k)
        n2, p2, S = unitig.chain_rank(nxt, prev, True)
        cap = unitig.chains_cap(nu)
        cb = unitig._caps(M, k, cap)
        buf = unitig.unitig_emit(rows, k, n2, p2, S, cap, cb, True)
        same([buf], [unitig.unitig_emit_plain(rows, k, n2, p2, S, cap, cb, True)])
        rec = {"k": k, "rows": M, "nodes": 2 * M, "cap": cap, "cap_bases": cb,
               "ms": ms(lambda: unitig.unitig_emit(rows, k, n2, p2, S, cap, cb, True), 10),
               "bytes": sum(t.numel() * t.element_size() for t in (rows, n2, p2, S, buf))}
        rec["bytes_ms"] = rec["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
        rec["share"] = rec["bytes_ms"] / rec["ms"]
        rec["kernels"] = profile_kernels(
            lambda: unitig.unitig_emit(rows, k, n2, p2, S, cap, cb, True), 10)
        del nxt, prev, n2, p2, S, buf
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        before = dict(kernels.launches)
        unitig.drain_build(unitig.dispatch_build(rows, k, nu))
        torch.cuda.synchronize()
        rec["build_peak_bytes"] = torch.cuda.max_memory_allocated() - held
        rec["build_launches"] = {n: kernels.launches[n] - before.get(n, 0)
                                 for n in ("unitig_links", "unitig_double", "unitig_emit")}
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            unitig.drain_build(unitig.dispatch_build(rows, k, nu))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        rec["build_ms"] = sum(walls[1:]) / 3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            unitig.drain_build(unitig.dispatch_build(rows, k, nu))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        dev_ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

        def total(pred):
            return sum(e.device_time_total for e in dev_ev if pred(e.key)) / 1e3

        d2h = total(lambda n: "DtoH" in n or "Device -> Host" in n)
        copies = total(lambda n: "Memcpy" in n or "Memset" in n)
        kern = total(lambda n: True) - copies
        rec["build_split"] = {"profiled_wall_ms": wall, "kernel_ms": kern, "d2h_ms": d2h,
                              "other_copies_ms": copies - d2h,
                              "host_ms": wall - kern - copies}
        res[name] = rec
        print(json.dumps({f"emit:{name}": rec}), flush=True)
        del rows
        torch.cuda.empty_cache()
    res["registers"] = registers(tree, ("emit_bases_kernel", "emit_bases_words_kernel",
                                        "emit_mins_kernel", "emit_heads_kernel",
                                        "emit_lens_kernel", "emit_pack_kernel"))
    return res


def rank_section(wide, slab_reads, ms, same, dev) -> dict:
    """K6 (chain_rank) on the bench, yeast and phase 9 solid sets; see the
    docstring."""
    import time

    import torch

    import chip_smoke
    from leon_tpu_torch.ops import unitig

    res = {}
    for name, rows, k, nu in unitig_sets(wide, slab_reads, dev):
        nxt, prev = unitig.unitig_links(rows, k)
        N = nxt.shape[0]
        rec = {"nodes": N, "bound_ms": 24 * N / chip_smoke.HBM_BYTES_PER_S * 1e3}
        for acyclic, tag in ((True, ""), (False, ":full")):
            same(unitig.chain_rank(nxt, prev, acyclic), unitig.chain_rank_plain(nxt, prev, acyclic))
            rec[f"ms{tag}"] = ms(lambda: unitig.chain_rank(nxt, prev, acyclic), 10)
        rec["cycles"] = bool((unitig.chain_rank_plain(nxt, prev, True)[2][:, 2] == 0).any())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        unitig.drain_build(unitig.dispatch_build(rows, k, nu))
        torch.cuda.synchronize()
        rec["build_peak_bytes"] = torch.cuda.max_memory_allocated() - held
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            unitig.drain_build(unitig.dispatch_build(rows, k, nu))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        rec["build_ms"] = sum(walls[1:]) / 3
        if hasattr(unitig, "unitig_rank"):
            rec["kernels"] = profile_kernels(lambda: unitig.chain_rank(nxt, prev, True), 10)
        res[name] = rec
        print(json.dumps({f"rank:{name}": rec}), flush=True)
        del nxt, prev, rows
        torch.cuda.empty_cache()
    return res


def walk_section(tree: str, wide, ms, same, dev) -> dict:
    """K18 and K19 alone on one chunk at W = 2, 4, 8, 16 and L = 2048 (and
    K4 at W = 2) with their probe counts, probe floor and bounds; see the
    docstring."""
    import numpy as np
    import torch

    import chip_smoke
    from leon_tpu_torch import kernels
    from leon_tpu_torch.ops import bloom, walk

    H, SEED = chip_smoke.H, chip_smoke.SEED
    floor = probe_floor_lib()
    issue_per_s = issue_rate()
    res = {"issue_rate": issue_per_s, "step_ops": step_ops(H), "anchor_ops": anchor_ops(H)}

    def main_filter(k, chunks, L):
        """The main path's Bloom filter over every chunk's k-mers (phase 9)."""
        sol = main_solid(k, chunks, L, dev)
        ones = torch.ones(sol["solid"].shape[0], dtype=torch.bool, device=dev)
        nw = sol["n_words"]
        return (bloom.bloom_build_words(sol["solid"], ones, nw, nw, H, SEED, k), nw,
                sol["n_solid"])

    def floor_ms(bits, nw, counts):
        c = counts.to(torch.int32).contiguous()
        o = torch.empty(c.numel(), dtype=torch.int32, device=dev)
        st = kernels.stream(c)

        def run():
            kernels.check(floor.lt_probe_floor(bits.data_ptr(), nw, H, c.data_ptr(), c.numel(),
                                               0x5EED, o.data_ptr(), st),
                          "probe_floor")
        return ms(run, 10)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    for W in (2, 4, 8, 16, 0):
        k, chunks, L, codes0, lengths0 = wide(W)[:5]
        tag = f"walk:w{W}" if W else f"walk:l{L}"
        bits, nw, n_solid = main_filter(k, chunks, L)
        p0, l0 = chunks[0]
        ME = L - k
        enc_d = walk.walk_encode_words(p0, l0, bits, nw, k, H, SEED, L, False)
        enc_p = walk.walk_encode_plain(p0, l0, bits, nw, k, H, SEED, L, False)
        same([enc_d["meta"], enc_d["tot"]], [enc_p["meta"], enc_p["tot"]])
        tot = enc_p["tot"].to(torch.int64)
        for n, row in (("ev_gap", 0), ("ev_nt", 0), ("ev_bif", 1)):
            valid = torch.arange(ME, device=dev)[None, :] < tot[row][:, None]
            same([enc_d[n].to(torch.int64)[valid]], [enc_p[n].to(torch.int64)[valid]])
        del enc_p
        incl = torch.cumsum(enc_d["tot"], dim=1)
        ce, cb = (-(-int(incl[i, -1]) // 8) * 8 for i in (0, 1))
        buf = walk.walk_pack(enc_d, incl, L, k, ce, cb, False).cpu().numpy()
        nb = p0.shape[0]
        enc = walk.unpack_compact(buf.view(np.uint16), nb, nb, L, ce, cb, False, k)
        dec_in = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in chip_smoke.decode_inputs(enc, codes0, lengths0, k))
        dec_d = walk.walk_decode_words(*dec_in, bits, nw, k, H, SEED, L)
        same([dec_d], [walk.walk_decode_plain(*dec_in, bits, nw, k, H, SEED, L)])
        rec = {"k": k, "L": L, "n_words": nw, "n_solid": n_solid}
        rec["enc_ms"] = ms(lambda: walk.walk_encode_words(p0, l0, bits, nw, k, H, SEED, L,
                                                          False), 10)
        rec["dec_ms"] = ms(lambda: walk.walk_decode_words(*dec_in, bits, nw, k, H, SEED, L), 10)
        if W == 2:  # K4 on the same chunk and filter
            e4 = walk.walk_encode(p0, l0, bits, nw, k, H, SEED, L, False)
            same([e4["meta"], e4["tot"]], [enc_d["meta"], enc_d["tot"]])
            same([walk.walk_decode(*dec_in, bits, nw, k, H, SEED, L)], [dec_d])
            rec["k4_enc_ms"] = ms(lambda: walk.walk_encode(p0, l0, bits, nw, k, H, SEED, L,
                                                           False), 10)
            rec["k4_dec_ms"] = ms(lambda: walk.walk_decode(*dec_in, bits, nw, k, H, SEED, L), 10)
        # probes, from the lengths: every read scans its min(len, L) - k + 1
        # anchor positions, every anchored read walks min(len - k, ME) steps
        ln = l0.to(torch.int64)
        anchored = enc_d["meta"][:, 0].to(torch.bool)
        scan = torch.clamp(torch.clamp(ln, max=L) - k + 1, min=0)
        steps = torch.where(anchored, torch.clamp(ln - k, 0, ME), 0)
        enc_probes, dec_probes = scan + 4 * steps, 4 * steps
        rec["probes_enc"] = int(enc_probes.sum())
        rec["probes_dec"] = int(dec_probes.sum())
        rec["anchor_positions"], rec["steps"] = int(scan.sum()), int(steps.sum())
        rec["floor_enc_ms"] = floor_ms(bits, nw, enc_probes)
        rec["floor_dec_ms"] = floor_ms(bits, nw, dec_probes)
        rec["arith_enc_ms"] = ((rec["anchor_positions"] * anchor_ops(H)
                                + rec["steps"] * step_ops(H)) / issue_per_s * 1e3)
        rec["arith_dec_ms"] = rec["steps"] * step_ops(H) / issue_per_s * 1e3
        n_ev = enc_d["tot"].to(torch.int64).sum(dim=1).tolist()
        rec["bytes_enc_ms"] = (nbytes(p0, l0, bits, enc_d["meta"], enc_d["tot"])
                               + 3 * n_ev[0] + n_ev[1]) / chip_smoke.HBM_BYTES_PER_S * 1e3
        rec["bytes_dec_ms"] = (nbytes(*dec_in, bits, dec_d)
                               / chip_smoke.HBM_BYTES_PER_S * 1e3)
        for side in ("enc", "dec"):
            bound = max(rec[f"floor_{side}_ms"], rec[f"arith_{side}_ms"], rec[f"bytes_{side}_ms"])
            rec[f"bound_{side}_ms"] = bound
            rec[f"share_{side}"] = bound / rec[f"{side}_ms"]
        res[tag[5:]] = rec
        print(json.dumps({tag: rec}), flush=True)
        del bits, enc_d, dec_d, dec_in
        torch.cuda.empty_cache()
    res["registers"] = registers(tree, WALK_KERNELS)
    return res



DENSE_KERNELS = ("walk_dense_kernel", "dense_pack_kernel", "walk_encode_words_kernel")


def dense_section(tree: str, wide, ms, same, dev) -> dict:
    """K15 beside K18 on one chunk at W = 4, 8, 16 with K15's probes, probe
    floor and byte bound; see the docstring."""
    import torch

    import chip_smoke
    from leon_tpu_torch import kernels
    from leon_tpu_torch.ops import bloom, walk

    H, SEED = chip_smoke.H, chip_smoke.SEED
    floor = probe_floor_lib()
    res = {}

    def floor_ms(bits, nw, counts):
        c = counts.to(torch.int32).contiguous()
        o = torch.empty(c.numel(), dtype=torch.int32, device=dev)
        st = kernels.stream(c)

        def run():
            kernels.check(floor.lt_probe_floor(bits.data_ptr(), nw, H, c.data_ptr(), c.numel(),
                                               0x5EED, o.data_ptr(), st),
                          "probe_floor")
        return ms(run, 10)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    for W in (4, 8, 16):
        k, chunks, L, codes0, lengths0 = wide(W)[:5]
        tag = f"dense:w{W}"
        sol = main_solid(k, chunks, L, dev)
        nw = sol["n_words"]
        ones = torch.ones(sol["solid"].shape[0], dtype=torch.bool, device=dev)
        bits = bloom.bloom_build_words(sol["solid"], ones, nw, nw, H, SEED, k)
        del sol, ones
        c1 = torch.from_numpy(codes0).to(dev)
        l1 = torch.from_numpy(lengths0).to(dev)
        p0, pl0 = chunks[0]
        enc = walk.encode_batch(c1, l1, bits, k, H, nw, SEED)
        same([enc[n] for n, _, _ in walk.DENSE],
             [v for v in walk.encode_batch_plain(c1, l1, bits, k, H, nw, SEED).values()])
        rec = {"k": k, "L": L, "reads": c1.shape[0], "n_words": nw}
        rec["ms"] = ms(lambda: walk.encode_batch(c1, l1, bits, k, H, nw, SEED), 10)
        rec["k18_ms"] = ms(lambda: walk.walk_encode_words(p0, pl0, bits, nw, k, H, SEED, L,
                                                          True), 10)
        # the device time alone: the kernels' and memsets' by the profiler
        rec["device"] = profile_kernels(
            lambda: walk.encode_batch(c1, l1, bits, k, H, nw, SEED), 10)
        rec["device_ms"] = sum(rec["device"].values())
        rec["k18_device_ms"] = sum(profile_kernels(
            lambda: walk.walk_encode_words(p0, pl0, bits, nw, k, H, SEED, L, True), 10).values())
        # K15's probes: every read scans its min(len, L) - k + 1 anchor
        # positions; an anchored read walks min(len - k - apos, ME) steps
        # right and apos left
        ME = max(1, L - k)
        ln = l1.to(torch.int64)
        apos = enc["apos"].to(torch.int64)
        scan = torch.clamp(torch.clamp(ln, max=L) - k + 1, min=0)
        steps = torch.where(enc["anchored"], torch.clamp(ln - k - apos, 0, ME) + apos, 0)
        probes = scan + 4 * steps
        rec["anchor_positions"], rec["steps"] = int(scan.sum()), int(steps.sum())
        rec["probes"] = int(probes.sum())
        rec["floor_ms"] = floor_ms(bits, nw, probes)
        packed_bytes = 2 * c1.shape[0] * ((L + 15) // 16) * 4
        rec["bytes"] = nbytes(c1, l1, bits, *enc.values()) + packed_bytes
        rec["bytes_ms"] = rec["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
        rec["bound_ms"] = max(rec["floor_ms"], rec["bytes_ms"])
        rec["share"] = rec["bound_ms"] / rec["ms"]
        rec["k18_plus_bytes_ms"] = rec["k18_ms"] + rec["bytes_ms"]
        del enc, c1, l1
        res[tag[6:]] = rec
        print(json.dumps({tag: rec}), flush=True)
        del bits
        torch.cuda.empty_cache()
    res["registers"] = registers(tree, DENSE_KERNELS)
    return res


TENSOR_KERNELS = ("kmer_scan_words_kernel", "sort_ties_block_kernel", "sort_ties_kernel",
                  "runs_pass_kernel")


def tensor_section(tree: str, wide, ms, same, dev) -> dict:
    """K13 and count_batch (with K20 where the tree has it) at PERF.md rows
    12a and 12b's shapes; see the docstring."""
    import torch

    import chip_smoke
    from leon_tpu_torch import state
    from leon_tpu_torch.ops import count, kmer

    res = {}
    rate = chip_smoke.HBM_BYTES_PER_S / 1e3  # bytes a ms

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    for W in (4, 8, 16):
        k, *_, codes, lengths = wide(W)
        ca = torch.from_numpy(codes).to(dev)
        la = torch.from_numpy(lengths).to(dev)
        got = kmer.kmer_scan_words(ca, la, k)
        same(got, kmer.kmer_scan_words_plain(ca, la, k))
        canon, is_rc, valid = got
        rec = {"k": k, "reads": ca.shape[0], "L": ca.shape[1], "positions": valid.numel()}
        rec["k13_ms"] = ms(lambda: kmer.kmer_scan_words(ca, la, k), 10)
        rec["k13_bytes"] = nbytes(ca, la, canon, is_rc, valid)
        rec["k13_bound_ms"] = rec["k13_bytes"] / rate
        rec["k13_share"] = rec["k13_bound_ms"] / rec["k13_ms"]
        del ca, la, is_rc, got
        # count_batch, exact against torch.unique(dim=0) of the same rows
        # (put in the u32 order), and timed beside it
        rows = canon.reshape(-1, W)[valid.reshape(-1)]
        uq, cn = count.count_batch(canon, valid)
        lu, lc = torch.unique(rows, dim=0, return_counts=True)
        lp, lcs = merge_sort(count, state, lu.contiguous(), lc.to(torch.int32))
        same((uq, cn), (state.planes_to_words(lp, W), lcs))
        n, M = rows.shape[0], uq.shape[0]
        rec["rows"], rec["distinct"] = n, M
        del lu, lc, lp, lcs
        rec["count_batch_ms"] = ms(lambda: count.count_batch(canon, valid), 5)
        rec["unique_ms"] = ms(lambda: torch.unique(rows, dim=0, return_counts=True), 3)
        # the valid rows read once, uniq and counts written once, one pass of
        # the top sort's keys and indices (read and written)
        rec["bound_bytes"] = 4 * W * n + (4 * W + 8) * M + 32 * n
        rec["bound_ms"] = rec["bound_bytes"] / rate
        rec["device"] = profile_kernels(lambda: count.count_batch(canon, valid), 3)
        if hasattr(count, "sort_ties"):
            keys, src, frows = count.top_sort(canon, valid)
            tp = count.sort_ties(keys, src, frows, W)
            same(tp, count.sort_ties_plain(keys, src, frows, W))
            rec["top_sort_ms"] = ms(lambda: count.top_sort(canon, valid), 5)
            rec["sort_ties_ms"] = ms(lambda: count.sort_ties(keys, src, frows, W), 10)
            rec["sort_ties_bytes"] = nbytes(keys, src, *tp) + 4 * W * n
            rec["sort_ties_bound_ms"] = rec["sort_ties_bytes"] / rate
            rec["rows_floor_ms"] = rows_floor_ms(frows, src, ms, dev)
            rec["runs_words_ms"] = ms(lambda: count.runs_words(tp, W), 10)
            del keys, src, frows, tp
        res[f"w{W}"] = rec
        print(json.dumps({f"tensor:w{W}": rec}), flush=True)
        del canon, valid, rows, uq, cn
        torch.cuda.empty_cache()
    res["registers"] = registers(tree, TENSOR_KERNELS)
    return res

M32 = 0xFFFFFFFF


def graph_replay(bloom, kmer, k: int, seed: int, H: int, n_words: int, bits, dev):
    """PyTorch replays of the graph kernels' probes on int64-held u32 values
    (rolled hashes, as csrc/graph.cu rolls them): (probe_loads, walk_loads,
    traverse_loads), each returning the kernel's own output beside the
    loads (a classic probe's up to its first clear bit, a blocked probe's
    one word: the fewest any design makes) and the dependent steps (one a
    probe step: the fewest dependent rounds) of each row or lane."""
    import torch

    tab = torch.tensor(bloom.tables(seed, k).astype("int64"), device=dev)
    T, Tc, Trot, Tcrot = tab
    b64 = bits.to(torch.int64) & M32
    t0 = 2 * (k - 1)

    def rol(x, s):
        s %= 32
        return ((x << s) | (x >> (32 - s))) & M32 if s else x

    def base0(w):
        return (w[..., t0 // 32] >> (t0 % 32)) & 3

    def roll_out(f, r, w):
        o = base0(w)
        return (rol(f ^ Trot[o], 1)[..., None] ^ T), (rol(r ^ Tc[o], 31)[..., None] ^ Tcrot)

    def roll_in(f, r, w):
        lb = w[:, 0] & 3
        cp = torch.arange(4, device=dev)[None, :] | base0(kmer.shr2_ins(w, 0, k))[:, None]
        return (rol(f ^ T[lb], 31)[:, None] ^ Trot[cp]), (rol(r ^ Tcrot[lb], 1)[:, None] ^ Tc[cp])

    def classic(f, r):
        """(member, loads) of candidates (..., C): loads up to the first clear bit."""
        h1, h2 = torch.minimum(f, r), torch.maximum(f, r) | 1
        alive = torch.ones(f.shape, dtype=torch.bool, device=dev)
        loads = torch.zeros(f.shape, dtype=torch.int32, device=dev)
        g = h1
        for i in range(H):
            if i:
                g = (g + h2) & M32
            loads += alive
            alive &= ((b64[(g * n_words) >> 32] >> (g & 31)) & 1) == 1
        return alive, loads

    def start(words):
        w = words.to(torch.int64) & M32
        f, r = bloom.hash_words_plain(w, k, bloom.tables(seed, k))
        return w, f, r

    def probe_loads(words, mode, is_classic):
        """(member (N,) or (N, 4), loads (N,), steps (N,))."""
        w, f, r = start(words)
        if mode != "self":
            f, r = (roll_out if mode == "out" else roll_in)(f, r, w)
        else:
            f, r = f[:, None], r[:, None]
        ones = torch.ones(w.shape[0], dtype=torch.int32, device=dev)
        if is_classic:
            m, ld = classic(f, r)
            return m.squeeze(1) if mode == "self" else m, ld.sum(1), ones
        return None, f.shape[1] * ones, ones

    def walk_loads(words, S):
        """(n (N,), loads (N,), steps (N,))."""
        cur, f, r = start(words)
        N = cur.shape[0]
        ar = torch.arange(N, device=dev)
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        n = torch.zeros(N, dtype=torch.int32, device=dev)
        loads = torch.zeros(N, dtype=torch.int32, device=dev)
        steps = torch.zeros(N, dtype=torch.int32, device=dev)
        for _ in range(S):
            cf, cr = roll_out(f, r, cur)
            m, ld = classic(cf, cr)
            loads += torch.where(alive, ld.sum(1), 0)
            steps += alive.to(torch.int32)
            u = torch.argmax(m.to(torch.int32), dim=1)
            go = alive & (m.sum(1) == 1)
            n += go.to(torch.int32)
            cur = torch.where(go[:, None], kmer.shl2(cur, u, k), cur)
            f = torch.where(go, cf[ar, u], f)
            r = torch.where(go, cr[ar, u], r)
            alive = go
            if not bool(alive.any()):
                break
        return n, loads, steps

    def traverse_loads(words, S, D):
        """(n (N,), loads (N,), steps (N,)): an outer step probes the node's
        4 candidates, a bubble depth the 4 candidates of each live branch."""
        cur, f, r = start(words)
        N, W = cur.shape
        ar = torch.arange(N, device=dev)
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        n = torch.zeros(N, dtype=torch.int64, device=dev)
        loads = torch.zeros(N, dtype=torch.int64, device=dev)
        steps = torch.zeros(N, dtype=torch.int64, device=dev)
        for _ in range(S):
            if not bool(alive.any()):
                break
            cf, cr = roll_out(f, r, cur)
            m, ld = classic(cf, cr)
            loads += torch.where(alive, ld.sum(1), 0)
            steps += alive.to(torch.int64)
            deg = m.sum(1)
            simple, branch = alive & (deg == 1), alive & (deg >= 2)
            u = torch.argmax(m.to(torch.int32), dim=1)
            bn = torch.stack([kmer.shl2(cur, c, k) for c in range(4)], dim=1)  # (N, 4, W)
            bf, br = cf.clone(), cr.clone()
            live = m & branch[:, None]
            active = branch.clone()
            dstar = torch.full((N,), -1, dtype=torch.int64, device=dev)
            cnode, cfh, crh = cur.clone(), f.clone(), r.clone()
            for d in range(D):
                if not bool(active.any()):
                    break
                gf, gr = roll_out(bf, br, bn)  # (N, 4, 4)
                mm, ll = classic(gf, gr)
                stepping = live & active[:, None]
                ll = ll * stepping[..., None]
                loads += ll.sum((1, 2))
                steps += active.to(torch.int64)
                uc = torch.argmax(mm.to(torch.int32), dim=2)
                go = stepping & (mm.sum(2) == 1)
                live = torch.where(active[:, None], go, live)
                nb = kmer.shl2(bn.reshape(-1, W), uc.reshape(-1), k).reshape(N, 4, W)
                bn = torch.where(go[..., None], nb, bn)
                bf = torch.where(go, gf.gather(2, uc[..., None]).squeeze(2), bf)
                br = torch.where(go, gr.gather(2, uc[..., None]).squeeze(2), br)
                any_live = live.any(1)
                first = torch.argmax(live.to(torch.int32), dim=1)
                ref = bn[ar, first]
                same = ((bn == ref[:, None, :]).all(2) | ~live).all(1)
                now = active & any_live & same
                dstar = torch.where(now, d, dstar)
                cnode = torch.where(now[:, None], ref, cnode)
                cfh = torch.where(now, bf[ar, first], cfh)
                crh = torch.where(now, br[ar, first], crh)
                active &= any_live & ~same
            conv = branch & (dstar >= 0)
            n += torch.where(simple, 1, torch.where(conv, dstar + 2, 0))
            cur = torch.where(simple[:, None], kmer.shl2(cur, u, k),
                              torch.where(conv[:, None], cnode, cur))
            f = torch.where(simple, cf[ar, u], torch.where(conv, cfh, f))
            r = torch.where(simple, cr[ar, u], torch.where(conv, crh, r))
            alive = simple | conv
        return n.to(torch.int32), loads.to(torch.int32), steps.to(torch.int32)

    return probe_loads, walk_loads, traverse_loads


GRAPH_KERNELS = ("dbg_probe_kernel", "dbg_walk_kernel", "dbg_traverse_kernel")
WALK_CHECK_LANES = 1 << 18  # K11's lanes held against its plain version


def graph_section(tree: str, wide, slab_reads, ms, same, dev) -> dict:
    """K10, K11 and K12 at phase 7's and phase 10's shapes with the loads of
    their designs, their probe floors and bounds; see the docstring."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke
    from leon_tpu_torch import kernels, state
    from leon_tpu_torch.graph import Graph, dbg_walk_plain
    from leon_tpu_torch.ops import bloom, count, kmer

    P, I, I64, Un = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    floor = floor_lib("graph_probe_floor", "lt_graph_floor", [P, Un, P, I64, Un, I, P, P])
    H, SEED = chip_smoke.H, chip_smoke.SEED
    S_WALK, S_TRAV, LANES = (chip_smoke.GRAPH_WALK_STEPS, chip_smoke.GRAPH_TRAVERSE_STEPS,
                             chip_smoke.GRAPH_TRAVERSE_LANES)

    def floor_ms(bits, nw, counts, dep):
        c = counts.to(torch.int32).contiguous()
        o = torch.empty(c.numel(), dtype=torch.int32, device=dev)
        st = kernels.stream(c)

        def run():
            kernels.check(floor.lt_graph_floor(bits.data_ptr(), nw, c.data_ptr(), c.numel(),
                                               0x5EED, int(dep), o.data_ptr(), st), "graph_floor")
        return ms(run, 10)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    lanes_per_s = lane_rate()

    def bounds(rec, bits, nw, loads, steps, moved, hashed=0, W=0):
        rec["loads"] = int(loads.to(torch.int64).sum())
        rec["floor_ms"] = floor_ms(bits, nw, loads, False)
        rec["chain_ms"] = floor_ms(bits, nw, steps, True)
        rec["max_steps"] = int(steps.max())
        rec["bytes_ms"] = moved / chip_smoke.HBM_BYTES_PER_S * 1e3
        # K10 hashes each row from K16's tables: 8W 64-bit entries a row
        rec["table_ms"] = 2 * 8 * W * hashed / lanes_per_s * 1e3
        rec["bound_ms"] = max(rec["floor_ms"], rec["chain_ms"], rec["bytes_ms"], rec["table_ms"])
        rec["share"] = rec["bound_ms"] / rec["ms"]

    def solid_sets():
        # phase 3's: its reads (slab_reads with `reverse`), the cutoff and the
        # filter's size from the histogram of its merge (the run and every
        # third row again), K3's filter
        rk, rc = bench_run(lambda nr, _rev: slab_reads(nr, True), dev)[:2]
        mk, perm = torch.sort(torch.cat([rk, rk[::3]]))
        hist = count.runs(mk, torch.cat([rc, rc[::3]])[perm], 1, True)[2]
        hist = hist.cpu().numpy().astype(np.int64)
        del mk, perm
        cutoff = count.auto_cutoff(hist)
        bpk, _h = bloom.auto_params(hist, cutoff, False, stored_filter=False)
        nw3 = bloom.choose_n_words(int(hist[min(cutoff, 255):].sum()), bpk)
        solid = count.compact_solid(rk, rc, cutoff)[0]
        bits3 = bloom.bloom_build(rk, rc, cutoff, nw3, H, SEED, 31)
        del rk, rc
        yield "w2", 31, state.keys_to_words(solid.cpu().numpy(), 2), bits3, nw3
        for W in (8, 16):
            k, chunks, L = wide(W)[:3]
            sol = main_solid(k, chunks, L, dev)
            sw = sol["solid"]
            ones = torch.ones(sw.shape[0], dtype=torch.bool, device=dev)
            nw = sol["n_words"]
            yield (f"w{W}", k, sw.cpu().numpy().view(np.uint32), 
                   bloom.bloom_build_words(sw, ones, nw, nw, H, SEED, k), nw)
            del sol, sw

    res = {}
    for name, k, words, cbits, cnw in solid_sets():
        G = Graph.from_solid(words, k)
        dbg = G.dbg
        nodes = state.words_to_torch(G.index.sorted_words, dev)
        gb, gnw = dbg.bitset, dbg.n_words
        rec = {"k": k, "nodes": nodes.shape[0], "n_words": gnw, "compress_n_words": cnw}
        # the graph's own filter (classic, its seed and H) and the compressor's
        for is_classic, bits, nw, h, seed in ((True, gb, gnw, dbg.n_hashes, dbg.seed),
                                               (False, cbits, cnw, H, SEED)):
            probe_loads, _w, _t = graph_replay(bloom, kmer, k, seed, h, nw, bits, dev)
            for mode in ("self", "out", "in"):
                tag = f"probe:{mode}:{'classic' if is_classic else 'blocked'}"
                a = (bits, nodes, mode, is_classic, h, nw, seed, k)
                got = bloom.dbg_probe(*a)
                same([got], [bloom.dbg_probe_plain(*a)])
                member, loads, steps = probe_loads(nodes, mode, is_classic)
                if member is not None:
                    same([got], [member])  # the replay follows the kernel
                r = {"ms": ms(lambda: bloom.dbg_probe(*a), 20),
                     "member_share": float(got.float().mean())}
                bounds(r, bits, nw, loads, steps, nbytes(nodes, got), nodes.shape[0],
                       nodes.shape[1])
                rec[tag] = r
        _p, walk_loads, traverse_loads = graph_replay(bloom, kmer, k, dbg.seed, dbg.n_hashes,
                                                      gnw, gb, dev)
        wb, wn = dbg.walk(nodes, S_WALK)
        n, loads, steps = walk_loads(nodes, S_WALK)
        same([wn], [n])
        m = min(nodes.shape[0], WALK_CHECK_LANES)
        same([wb[:m], wn[:m]], dbg_walk_plain(gb, nodes[:m], dbg.n_hashes, gnw, dbg.seed, k,
                                              S_WALK))
        r = {"ms": ms(lambda: dbg.walk(nodes, S_WALK), 3), "lanes": nodes.shape[0],
             "steps": S_WALK, "mean_steps": float(wn.float().mean())}
        bounds(r, gb, gnw, loads, steps, nbytes(nodes, wb, wn))
        rec["walk"] = r
        del wb, wn
        branch = dbg.is_branching(nodes)
        starts = torch.cat([nodes[branch], nodes[~branch]])[:LANES].contiguous()
        for tag, D, lanes in (("traverse:d32", 32, starts), ("traverse:deep", k + 1, starts),
                              ("traverse:deep16k", k + 1, starts[: LANES // 4])):
            if tag == "traverse:deep" and D == 32:
                continue
            tb, tn = dbg.traverse(lanes, S_TRAV, D)
            n, loads, steps = traverse_loads(lanes, S_TRAV, D)
            same([tn], [n])
            r = {"ms": ms(lambda: dbg.traverse(lanes, S_TRAV, D), 5), "lanes": lanes.shape[0],
                 "D": D, "out_bytes": tb.numel(), "mean_bases": float(tn.float().mean())}
            bounds(r, gb, gnw, loads, steps, nbytes(lanes, tb, tn))
            rec[tag] = r
            del tb, tn
        res[name] = rec
        print(json.dumps({f"graph:{name}": rec}), flush=True)
        del G, dbg, nodes, starts, cbits
        torch.cuda.empty_cache()
    res["registers"] = registers(tree, GRAPH_KERNELS)
    return res


FLUSH_SLAB = 1 << 25  # the config's count_slab_kmers


def gather_floor_lib():
    """scripts/gather_floor.cu: the stream, L2-load and row-gather floors."""
    import ctypes

    P, I, I64, Un = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib = floor_lib("gather_floor", "lt_stream_floor", [P, I64, P, P])
    lib.lt_l2_floor.argtypes = [P, Un, I64, I, Un, P, P]
    lib.lt_l2_floor.restype = ctypes.c_int
    lib.lt_rows_floor.argtypes = [P, I, P, I64, P, P]
    lib.lt_rows_floor.restype = ctypes.c_int
    return lib


def rows_floor_ms(rows, perm, ms, dev) -> float:
    """Floor (c): the (N, W) int32 rows gathered in perm's order (int64) and
    written contiguously (scripts/gather_floor.cu), W = 4, 8 or 16."""
    import torch

    from leon_tpu_torch import kernels

    lib = gather_floor_lib()
    rows = rows.contiguous()
    perm = perm.contiguous()
    out = torch.empty(perm.numel(), rows.shape[1], dtype=torch.int32, device=dev)
    st = kernels.stream(rows)

    def run():
        kernels.check(lib.lt_rows_floor(rows.data_ptr(), rows.shape[1], perm.data_ptr(),
                                        perm.numel(), out.data_ptr(), st), "rows_floor")

    run()
    if not torch.equal(out, rows[perm]):
        raise AssertionError("rows_floor: the gather differs from rows[perm]")
    return ms(run, 10)


def gather_section(tree: str, ms, same, dev) -> dict:
    """K9 at phase 7's shapes beside torch.take and its floors (a) and (b);
    see the docstring."""
    import torch

    import chip_smoke
    from leon_tpu_torch import kernels
    from leon_tpu_torch.ops import gather

    lib = gather_floor_lib()
    res = {}
    for mb, (table, idx) in chip_smoke.gather_inputs(dev).items():
        got = gather.gather_words(table, idx)
        same([got], [gather.gather_words_plain(table, idx)])
        idx64 = idx.to(torch.int64)
        M, n = idx.numel(), table.numel()
        out = torch.empty_like(idx)
        st = kernels.stream(idx)
        rec = {"indices": M, "table_words": n,
               "ms": ms(lambda: gather.gather_words(table, idx), 20),
               "library_ms": ms(lambda: torch.take(table, idx64), 20)}
        rec["stream_ms"] = ms(lambda: kernels.check(
            lib.lt_stream_floor(idx.data_ptr(), M, out.data_ptr(), st), "stream_floor"), 20)
        for U in (4, 8, 16):
            rec[f"l2_ms:u{U}"] = ms(lambda: kernels.check(
                lib.lt_l2_floor(table.data_ptr(), n, M, U, 0x5EED, out.data_ptr(), st),
                "l2_floor"), 20)
        rec["l2_floor_ms"] = min(rec[f"l2_ms:u{U}"] for U in (4, 8, 16))
        rec["bytes_ms"] = (4 * n + 8 * M) / chip_smoke.HBM_BYTES_PER_S * 1e3
        rec["bound_ms"] = max(rec["stream_ms"], rec["l2_floor_ms"])
        rec["share"] = rec["bound_ms"] / rec["ms"]
        res[f"{mb}mb"] = rec
        print(json.dumps({f"gather:{mb}mb": rec}), flush=True)
    res["registers"] = registers(tree, ("gather_words_kernel",))
    return res


def wordsort_section(wide, ms, same, dev) -> dict:
    """The WordCounter's slab sort plus K14 at the bench slabs and phase 9's
    W = 16 chunk, its merges with the counts at W = 8 and 16, floor (c) and
    the card's peak memory; see the docstring."""
    import torch

    import chip_smoke
    from leon_tpu_torch import state
    from leon_tpu_torch.ops import count, kmer

    rate = chip_smoke.HBM_BYTES_PER_S / 1e3  # bytes a ms
    res = {}

    def bench_slab(k, chunks, L):
        """A WordCounter fed every chunk (one slab, not flushed), and its slab."""
        c = count.WordCounter(k, dev, slab_kmers=1 << 25)  # the config's count_slab_kmers
        for p, ln in chunks:
            c.add_packed(p, ln, L)
        if c._pend_n >= c.slab or c._runs or c._pending is not None:
            raise AssertionError("wordsort: the slab flushed")
        return c, [b[: c._fill] for b in c._buf]

    def parts(rec, planes, W, n):
        """On a tree with K21: the slab sort's parts and floor (c)."""
        rows, top = count.plane_rows(planes, W)
        same((rows, top), count.plane_rows_plain(planes, W))
        keys, src = torch.sort(top)
        srt = count.sort_ties(keys, src, rows, W)
        rec["plane_rows_ms"] = ms(lambda: count.plane_rows(planes, W), 10)
        rec["planes_to_words_ms"] = ms(lambda: state.planes_to_words(planes, W), 5)
        rec["top_sort_ms"] = ms(lambda: torch.sort(top), 5)
        rec["sort_ties_ms"] = ms(lambda: count.sort_ties(keys, src, rows, W), 5)
        rec["word_runs_ms"] = ms(lambda: count.word_runs(srt, W), 5)
        rec["rows_floor_ms"] = rows_floor_ms(rows, src, ms, dev)
        rec["plane_rows_bound_ms"] = (8 * len(planes) + 4 * W + 8) * n / rate
        del rows, top, keys, src, srt

    inputs = {}
    for W in (4, 8, 16):
        if W == 4:
            path = os.path.join(chip_smoke.WORK, "ab_500k.fastq")
            os.makedirs(chip_smoke.WORK, exist_ok=True)
            chip_smoke.gen_fastq(path, 500_000, 2_000_000)
            codes, lengths = chip_smoke.fastq_codes(path)
            k, L = 63, codes.shape[1]
            inputs[W] = (k, chunks_of_reads(codes, lengths, dev), L, "bench")
        elif W == 8:
            k, chunks, L = wide(8)[:3]
            inputs[W] = (k, chunks, L, "bench")
        else:
            k, chunks, L = wide(16)[:3]
            inputs[W] = (k, chunks[:1], L, "chunk")
    for W in (4, 8, 16):
        k, chunks, L, what = inputs[W]
        c, planes = bench_slab(k, chunks, L)
        n = planes[0].numel()
        got = c._slab_run(planes)
        same(got, count.word_runs_plain(count.sort_planes(planes), W)[:2])
        M = got[0].shape[0]
        rec = {"k": k, "what": what, "rows": n, "distinct": M}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        c._slab_run(planes)
        torch.cuda.synchronize()
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        rec["slab_ms"] = ms(lambda: c._slab_run(planes), 5)
        rec["lsd_ms"] = ms(lambda: count.sort_planes(planes), 3)
        rows = state.planes_to_words(planes, W)
        rec["library_ms"] = ms(lambda: torch.unique(rows, dim=0, return_counts=True), 3)
        del rows
        rec["bytes"] = 8 * len(planes) * n + (4 * W + 4) * M
        rec["bound_ms"] = rec["bytes"] / rate
        if hasattr(count, "plane_rows"):
            parts(rec, planes, W, n)
        res[f"w{W}"] = rec
        print(json.dumps({f"wordsort:w{W}": rec}), flush=True)
        del c, planes, got
        torch.cuda.empty_cache()
    # phase 9's merges of every chunk's slab run, with the counts
    for W in (8, 16):
        k, chunks, L = wide(W)[:3]
        c = count.WordCounter(k, dev)
        runs = [c._slab_run(kmer.kmer_scan_halves(p, ln, k, L)) for p, ln in chunks]
        words = torch.cat([r[0] for r in runs])
        counts = torch.cat([r[1] for r in runs])
        got = counter_merge(count, c, runs, True)
        pl, perm = count.sort_planes(state.words_to_planes(words), with_perm=True)
        same(got, count.word_runs_plain(pl, W, counts[perm], 1, True))
        del pl, perm
        n, M = words.shape[0], got[0].shape[0]
        rec = {"k": k, "chunks": len(chunks), "rows": n, "distinct": M,
               "merge_ms": ms(lambda: counter_merge(count, c, runs, True), 5),
               "bytes": (4 * W + 4) * (n + M) + 1024}
        del runs
        rec["bound_ms"] = rec["bytes"] / rate
        rec["sort_ms"] = ms(lambda: merge_sort(count, state, words, counts), 5)
        if hasattr(count, "sort_rows"):
            keys, src = torch.sort(count._top_keys(words))
            rec["top_sort_ms"] = ms(lambda: torch.sort(count._top_keys(words)), 5)
            rec["sort_ties_ms"] = ms(lambda: count.sort_ties(keys, src, words, W, counts), 5)
            rec["rows_floor_ms"] = rows_floor_ms(words, src, ms, dev)
            del keys, src
        res[f"w{W}:merge"] = rec
        print(json.dumps({f"wordsort:w{W}:merge": rec}), flush=True)
        del c, words, counts, got
        torch.cuda.empty_cache()
    # the card's peak memory of phase 9's W = 16 slab flushed by the chunk
    # that fills it (the second: its positions pass 2**25)
    k, chunks, L = wide(16)[:3]
    c = count.WordCounter(k, dev, slab_kmers=FLUSH_SLAB)
    for p, ln in chunks:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        c.add_packed(p, ln, L)
        torch.cuda.synchronize()
        if c._pending is not None:
            break
    else:
        raise AssertionError("wordsort: no chunk flushed the slab")
    res["w16:flush"] = {"slab_rows": int(c._pending[1].sum()), "before_bytes": base,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"wordsort:w16:flush": res["w16:flush"]}), flush=True)
    del c
    torch.cuda.empty_cache()
    return res


def sort_passes(keys) -> int:
    """The passes an LSD sort of int64 keys needs: the 8-bit digits in which
    they do not all fall in one bucket (at least one; K22 runs the digits of
    the bits its caller names, 8 at every shape of this section)."""
    import torch

    u = keys ^ torch.iinfo(torch.int64).min  # signed order as unsigned order
    n = keys.numel()
    split = 0
    for d in range(8):
        c = torch.bincount(((u >> (8 * d)) & 255).to(torch.int64), minlength=256)
        split += int(int(c.max()) < n)
    return max(split, 1)


def sort_floor_ms(keys, pay_bytes: int, passes: int, ms, dev) -> float:
    """K22's floor: `passes` copies of the keys and of a payload of
    pay_bytes a key, buffer to buffer in turns (scripts/sort_floor.cu)."""
    import ctypes

    import torch

    from leon_tpu_torch import kernels

    P, I64 = ctypes.c_void_p, ctypes.c_longlong
    lib = floor_lib("sort_floor", "lt_sort_floor", [P, P, I64, P, P, I64, P])
    n = keys.numel()
    kb, pb = -(-8 * n // 16) * 16, -(-pay_bytes * n // 16) * 16
    bufs = [torch.empty(kb + pb, dtype=torch.uint8, device=dev) for _ in range(2)]
    bufs[0][: 8 * n].copy_(keys.view(torch.uint8))
    st = kernels.stream(keys)

    def run():
        for i in range(passes):
            a, b = bufs[i % 2], bufs[1 - i % 2]
            kernels.check(lib.lt_sort_floor(a.data_ptr(), b.data_ptr(), kb,
                                            a.data_ptr() + kb if pb else None,
                                            b.data_ptr() + kb if pb else None, pb, st),
                          "sort_floor")

    run()
    if not torch.equal(bufs[passes % 2][: 8 * n].view(torch.int64), keys):
        raise AssertionError("sort_floor: the copies lost the keys")
    return ms(run, 10)


def bucket_floor_ms(keys, pay_bytes: int, passes: int, ms, dev) -> float:
    """The floor of K22's bucket route: one read of the keys (its histogram)
    and passes + 1 copies of the keys and of a payload of pay_bytes a key
    (its passes and the bucket sort's read and write; scripts/sort_floor.cu)."""
    import ctypes

    import torch

    from leon_tpu_torch import kernels

    P, I64 = ctypes.c_void_p, ctypes.c_longlong
    lib = floor_lib("sort_floor", "lt_read_floor", [P, I64, P, P])
    n = keys.numel()
    sink = torch.zeros(4, dtype=torch.int64, device=dev)
    st = kernels.stream(keys)
    kb = 8 * n // 16 * 16

    def run():
        kernels.check(lib.lt_read_floor(keys.data_ptr(), kb, sink.data_ptr(), st), "read_floor")

    return ms(run, 10) + sort_floor_ms(keys, pay_bytes, passes + 1, ms, dev)


BUCKET_KERNELS = ("rs_hist", "rs_scan", "rs_pass", "bs_edge", "bs_bucket", "bs_seg_hist",
                  "bs_seg_pass", "bs_seg_finish", "Memset")


def sort_section(tree: str, wide, ms, same, dev) -> dict:
    """K22 at the count path's shapes beside torch.sort, the plain version,
    its floors and its byte bound, and K14's row policy on the final runs;
    on a tree without K22 its own path's sort (see the docstring)."""
    import torch

    from leon_tpu_torch import kernels, state
    from leon_tpu_torch.ops import count, kmer

    has = hasattr(count, "radix_sort")
    res = {}

    routed = has and "route" in inspect.signature(count.radix_sort).parameters

    def case(name, keys, path, plain, pay_bytes: int, moved: int, bits: int = 64, by=None):
        passes = sort_passes(keys)
        # the bucket route's passes: one a byte of its bucket (the tree's
        # route's; 16 bits where it takes no bucket route)
        route = count.radix_route(keys.numel(), bits) if routed else ("passes", 0)
        bpasses = (route[1] if route[0] == "bucket" else 16) // 8
        r = {"n": keys.numel(), "passes": passes,
             "path_ms": ms(path, 10),
             "torch_sort_ms": ms(lambda: torch.sort(keys, stable=True), 10),
             "plain_ms": ms(plain, 10),
             "floor_ms": sort_floor_ms(keys, pay_bytes, passes, ms, dev),
             "bucket_floor_ms": bucket_floor_ms(keys, pay_bytes, bpasses, ms, dev),
             "bytes_ms": moved / 3.35e12 * 1e3}
        if routed and by is not None:  # the sort by each route, named to the wrapper
            r["route"] = list(route)
            r["passes_ms"] = ms(by(("passes", 0)), 10)
            for B in (count.BUCKET_BITS, count.BUCKET_WIDE_BITS):
                if B < bits:
                    r[f"bucket{B}_ms"] = ms(by(("bucket", B)), 10)
        r["share_of_floor"] = r["floor_ms"] / r["path_ms"]
        r["share_of_bucket_floor"] = r["bucket_floor_ms"] / r["path_ms"]
        r["share_of_bytes"] = r["bytes_ms"] / r["path_ms"]
        if has:  # each kernel's device time in one sort, by the profiler
            prof = profile_kernels(path, 3)
            r["kernels_ms"] = {k: sum(v for name, v in prof.items() if k in name)
                               for k in BUCKET_KERNELS}
        res[name] = r
        print(json.dumps({f"sort:{name}": r}), flush=True)

    # k = 31: the slab of 500,000 reads of phase 3's generator (K1: 37.0M
    # keys, SENTINEL where invalid), keys alone; its distinct run and every
    # third row again, with the counts (two sorted runs, as a merge sorts)
    codes, lengths = slab_reads(500_000, True)
    packed = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
    slab = kmer.kmer_scan(packed, torch.from_numpy(lengths).to(dev), 31, codes.shape[1])
    del packed, codes
    if has:
        same([count.radix_sort(slab)], [count.radix_sort_plain(slab)])
    path = (lambda: count.radix_sort(slab)) if has else (lambda: torch.sort(slab).values)
    case("k31:slab", slab, path, lambda: torch.sort(slab, stable=True).values, 0,
         16 * slab.numel(), by=lambda r: lambda: count.radix_sort(slab, route=r))
    # the slab's shape with SENTINEL at one position in four (a bucket of
    # 9.2M equal keys), and with half its keys one key
    g = torch.Generator(device="cpu").manual_seed(23)
    heavy = slab.clone()
    heavy[(torch.rand(slab.numel(), generator=g) < 0.25).to(dev)] = kmer.SENTINEL
    half = slab.clone()
    half[: half.numel() // 2] = half[7]
    half = half[torch.randperm(half.numel(), generator=g).to(dev)]
    for name, keys in (("k31:sentinel_heavy", heavy), ("k31:half_one_key", half)):
        if has:
            same([count.radix_sort(keys)], [torch.sort(keys, stable=True).values])
        case(name, keys, (lambda: count.radix_sort(keys)) if has else
             (lambda: torch.sort(keys).values), lambda: torch.sort(keys, stable=True).values, 0,
             16 * keys.numel(), by=lambda r: lambda: count.radix_sort(keys, route=r))
    del heavy, half
    rk, rc, _ = count.runs(torch.sort(slab).values)
    del slab
    mk, mc = torch.cat([rk, rk[::3]]), torch.cat([rc, rc[::3]])
    if has:
        same(count.radix_sort(mk, mc), count.radix_sort_plain(mk, mc))

    def merge_path_parent():
        s = torch.sort(mk)
        return s.values, mc[s.indices]

    def merge_plain():
        s = torch.sort(mk, stable=True)
        return s.values, mc[s.indices]

    case("k31:merge", mk, (lambda: count.radix_sort(mk, mc)) if has else merge_path_parent,
         merge_plain, 4, 24 * mk.numel())
    if has and "bits" in inspect.signature(count.radix_sort).parameters:
        # the passes the caller's bits save: the merge's keys cut to their
        # first 21 bases (42 bits, the keys of a k = 21 merge), sorted over
        # 42 bits (6 passes, as DeviceCounter sorts them) and over 64 (8)
        mk21 = mk >> 20
        same(count.radix_sort(mk21, mc, 42), count.radix_sort_plain(mk21, mc))
        case("k21:merge", mk21, lambda: count.radix_sort(mk21, mc, 42),
             lambda: count.radix_sort_plain(mk21, mc), 4, 24 * mk21.numel(), 42,
             lambda r: lambda: count.radix_sort(mk21, mc, 42, route=r))
        res["k21:merge"]["all_passes_ms"] = ms(lambda: count.radix_sort(mk21, mc), 10)
        del mk21
    del mk, mc
    rk, rc = rk.contiguous(), rc.contiguous()
    merge_section(res, rk, rc, wide, ms, same, dev)
    # k = 127: the bench slab's top keys (K21 over every chunk's K17 planes),
    # with their index, over 64 bits and, as sort_slab sorts them, over
    # top_key_bits(k)
    k, chunks, L = wide(8)[:3]
    scans = [kmer.kmer_scan_halves(p, ln, k, L) for p, ln in chunks]
    slab8 = tuple(torch.cat([s[q] for s in scans]) for q in range(state.n_planes(8)))
    del scans
    rows8, top = count.plane_rows(slab8, 8)
    if has:
        same(count.radix_sort_index(top), torch.sort(top, stable=True))
    case("w8:slab", top, (lambda: count.radix_sort_index(top)) if has else
         (lambda: torch.sort(top)), lambda: torch.sort(top, stable=True), 4,
         24 * top.numel())
    if has and hasattr(count, "top_key_bits"):
        bits = count.top_key_bits(k)
        same(count.radix_sort_index(top, bits), torch.sort(top, stable=True))
        case("w8:slab:bits", top, lambda: count.radix_sort_index(top, bits),
             lambda: torch.sort(top, stable=True), 4, 24 * top.numel(), bits,
             lambda r: lambda: count.radix_sort_index(top, bits, route=r))
    del rows8, top, slab8
    # the first chunk's top keys at W = 4, 8, 16 with their index, as
    # sort_slab sorts a chunk's slab (over top_key_bits(k))
    for W in (4, 8, 16):
        k, chunks, L = wide(W)[:3]
        top = count.plane_rows(kmer.kmer_scan_halves(*chunks[0], k, L), W)[1]
        bits = count.top_key_bits(k)
        if has:
            same(count.radix_sort_index(top, bits), torch.sort(top, stable=True))
        case(f"chunk:w{W}", top, (lambda: count.radix_sort_index(top, bits)) if has else
             (lambda: torch.sort(top)), lambda: torch.sort(top, stable=True), 4,
             24 * top.numel(), bits, lambda r: lambda: count.radix_sort_index(top, bits, route=r))
        del top
    # k = 127 and 255: the final run (every chunk's slab run merged), reduced
    # as finalize reduces it: K14's row policy, or the planes and K14
    for W in (8, 16):
        k, chunks, L = wide(W)[:3]
        runs = [count.word_runs(slab_sort(count, kmer.kmer_scan_halves(p, ln, k, L), W), W)[:2]
                for p, ln in chunks]
        words = torch.cat([r[0] for r in runs])
        counts = torch.cat([r[1] for r in runs])
        del runs
        if W == 16:
            # the W = 16 merge's top keys read from its rows, with their index
            tk = count._top_keys(words)
            if has:
                same(count.radix_sort_rows(words), torch.sort(tk, stable=True))
            case("w16:rows", tk, (lambda: count.radix_sort_rows(words)) if has else
                 (lambda: torch.sort(count._top_keys(words))),
                 lambda: torch.sort(count._top_keys(words), stable=True), 4, 24 * tk.numel())
            del tk
        pl, pc = merge_sort(count, state, words, counts)
        gw, gc, gh = count.word_runs(pl, W, pc, 1, True)
        del pl, pc, words, counts
        gpl = state.words_to_planes(gw)
        if has:
            same(count.word_runs_rows(gw, gc, 1, True), count.word_runs(gpl, W, gc, 1, True))
        rows_path = ((lambda: count.word_runs_rows(gw, gc, 1, True)) if has else
                     (lambda: count.word_runs(state.words_to_planes(gw), W, gc, 1, True)))
        res[f"final:w{W}"] = {
            "rows": gw.shape[0], "path_ms": ms(rows_path, 10),
            "planes_k14_ms": ms(lambda: count.word_runs(gpl, W, gc, 1, True), 10),
            "words_to_planes_ms": ms(lambda: state.words_to_planes(gw), 10),
            "bytes_ms": (gw.numel() * 4 * 2 + gc.numel() * 8) / 3.35e12 * 1e3}
        del gw, gc, gh, gpl
        torch.cuda.empty_cache()
    res["registers"] = registers(tree, ("rs_pass_kernel", "rs_hist_kernel", "mp_merge_kernel",
                                        "bs_bucket_kernel", "bs_seg_pass_kernel"))
    return res


def merge_floor_ms(runs: list, ms, dev) -> float:
    """K23's floor: the runs' elements and counts copied once for each
    pairwise round, ceil(log2 R), buffer to buffer in turns
    (scripts/sort_floor.cu lt_merge_floor)."""
    import ctypes

    import torch

    from leon_tpu_torch import kernels

    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = floor_lib("sort_floor", "lt_merge_floor", [P, P, I64, P, P, I64, I, P])
    n = sum(c.shape[0] for _, c in runs)
    eb = runs[0][0].element_size() * (runs[0][0].numel() // max(1, runs[0][0].shape[0]))
    rb, cb = -(-eb * n // 16) * 16, -(-4 * n // 16) * 16
    bufs = [torch.empty(rb + cb, dtype=torch.uint8, device=dev) for _ in range(2)]
    rounds = (len(runs) - 1).bit_length()
    st = kernels.stream(bufs[0])

    def run():
        a, b = bufs
        kernels.check(lib.lt_merge_floor(a.data_ptr(), b.data_ptr(), rb, a.data_ptr() + rb,
                                         b.data_ptr() + rb, cb, rounds, st), "merge_floor")

    return ms(run, 10)


def merge_section(res: dict, rk, rc, wide, ms, same, dev) -> None:
    """K23 at the count's four merge shapes (PERF.md row 19b): the k = 31
    merge (the slab's distinct run and every third row, two runs of keys)
    and phase 9's merges of every chunk's slab run at W = 4, 8 and 16 (7, 4
    and 2 runs of rows), each with its counts; see the docstring."""
    import torch

    from leon_tpu_torch.ops import count, kmer

    k23 = hasattr(count, "merge_path")
    cases = [("merge:k31", 31, [(rk, rc), (rk[::3].contiguous(), rc[::3].contiguous())])]
    for W in (4, 8, 16):
        k, chunks, L = wide(W)[:3]
        c = count.WordCounter(k, dev)
        cases.append((f"merge:w{W}", k, [c._slab_run(kmer.kmer_scan_halves(p, ln, k, L))
                                         for p, ln in chunks]))
        del c
    for name, k, runs in cases:
        rows = runs[0][0].dim() == 2
        bits = count.top_key_bits(k) if rows else 2 * k
        c = (count.WordCounter if rows else count.DeviceCounter)(k, dev)

        def parent_route():  # the parent's merge sort: torch.cat, then K22 (and K20)
            data = torch.cat([d for d, _ in runs])
            cnt = torch.cat([x for _, x in runs])
            return count.sort_rows(data, cnt, bits) if rows else count.radix_sort(data, cnt, bits)

        data = torch.cat([d for d, _ in runs])
        keys = count._top_keys(data) if rows else data
        n = keys.numel()
        r = {"runs": len(runs), "n": n, "rounds": (len(runs) - 1).bit_length(),
             "cat_sort_ms": ms(parent_route, 5),
             "torch_sort_ms": ms(lambda: torch.sort(keys, stable=True), 5),
             "counter_merge_ms": ms(lambda: counter_merge(count, c, runs, True), 5),
             "counter_merge_peak_bytes": peak_bytes(lambda: counter_merge(count, c, runs, True)),
             "floor_ms": merge_floor_ms(runs, ms, dev),
             "bytes_ms": 2 * (data.element_size() * data.numel() + 4 * n) / 3.35e12 * 1e3}
        del data, keys
        if k23:
            merge = count.merge_path_rows if rows else count.merge_path
            same(merge(runs), count.merge_path_plain(runs))
            r["k23_ms"] = ms(lambda: merge(runs), 10)
            r["k23_peak_bytes"] = peak_bytes(lambda: merge(runs))
            r["share_of_floor"] = r["floor_ms"] / r["k23_ms"]
            r["share_of_bytes"] = r["bytes_ms"] / r["k23_ms"]
        r["cat_sort_peak_bytes"] = peak_bytes(parent_route)
        res[name] = r
        print(json.dumps({f"sort:{name}": r}), flush=True)
        del runs, c
        torch.cuda.empty_cache()


def chunks_of_reads(codes, lengths, dev) -> list:
    """(n, L) read codes as 65,536-lane packed chunks on the card."""
    import torch

    import chip_smoke
    from leon_tpu_torch import state
    from leon_tpu_torch.ops import kmer

    B = chip_smoke.B
    packed = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
    ln = torch.from_numpy(lengths).to(dev)
    return [(packed[s : s + B], ln[s : s + B]) for s in range(0, codes.shape[0], B)]


if __name__ == "__main__":
    sys.exit(main())
