#!/usr/bin/env python3
"""Smoke run of leon_tpu_torch on one CUDA card: the quickest proof that
the port still starts, builds its kernels and round-trips on the GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero without the
final line; phase 6's corpora are made first, and phases 7, 8, 9 and 10
run right after phase 3, whose reads and solid set they reuse):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from leon_tpu_torch/csrc with nvcc, and check
     the native host library;
  3. run every kernel at the main path's shapes on inputs made with numpy
     from a fixed seed, require it to equal its plain PyTorch version
     (integer-exact: tolerance 0; K1-K4 against CPU copies, the unitig
     kernels K5-K8 against the plain version on the card), and time both
     on the card (K1 on the 7-chunk slab in one launch and, record
     `kmer_scan:chunk`, on one 65,536-read chunk into a slab view as the
     counter launches it; K22 on the slab's keys and on the merge's keys
     with their counts, as the parent sorted a merge: records `radix_sort`,
     `radix_sort:merge`, beside torch.sort; the slab's sort again under
     torch.cuda.set_sync_debug_mode("error"), which raises on a host read;
     K23 on the merge's two sorted runs, where they lie, with
     their counts: record `merge_path`, beside torch.sort of the
     concatenated keys and the parent's cat and K22; K2 in its three modes:
     records `runs`, `runs:merge`, `runs:solid`); K23 on adversarial runs
     (merge_case at k = 15 and 31: R = 2, 3, 5, 9, runs of 0, 1 and one
     tile +- 1 keys, every key equal, one run before or after another,
     interleaved runs, keys equal but in their low word, both sides of the
     int64 sign, an int64-max tail; each run a view at an unaligned offset);
     K22 on adversarial keys (sort_case: n =
     0, 1, 2, one tile - 1, one tile, one tile + 1, all keys equal, keys
     that differ only in the top or only in the bottom digit, a SENTINEL
     tail, both sides of the int64 sign, three and two varying digits
     sorted over 56 and 48 bits so that an odd and an even number of
     passes run, many ties; over 64 bits and the case's bits, alone, with
     an int32 payload and the index, as a strided view; the row source at
     W = 1, 2, 3, 4, 8, 16 with and without idx); K22's bucket and block
     routes (K24, K25) on sort_case at 10 tiles and on bucket_case (a
     SENTINEL-heavy slab, one bucket, equal keys, buckets of 8,191, 8,192
     and 8,193 keys, half the keys one key) at bits = 17, 31, 42, 62, 64, in
     the same forms and on their first 8,192 and 17 keys; K1 on adversarial reads (scan_case at
     k = 1, 2, 15, 16, 17, 31, L mod 16 = 0, 1, 15, through `out=` into a
     view one key into its buffer); the device unitig payload must equal the native host
     builder's; K2 on adversarial inputs (k2_case: a key repeated 2^22
     times, run sums that wrap u32 or pass 2^31 - 1, runs of 1-3 rows at
     every offset of a step edge, a SENTINEL tail, n = 0, 1, 2) at
     cutoffs 1, 2 and 300 with the histogram, and K8 on adversarial runs
     (k8_case: queries below the first row and above the last, equal to
     them, one row, five rows, top 16 bits of two values) at k = 15, 16,
     31 and W = 2, 4, 8, 16, K6 on adversarial graphs (rank_case: chains
     of 2^16 - 1, 2^16, 2^16 + 1 nodes, chains with no sampled node and
     with every node sampled, singletons, self-twin chains, two nodes
     sharing a successor, cycles of 1-8 nodes with and without a sampled
     ruler, all mixed, node ids placed by K6's ruler sampling) in every
     mode and through chain_rank, K5 on adversarial runs (k5_case at
     K5_KS: k = 1, 2, 15, 16, 17, 31 and each width's 16W - 15 and 16W
     (255 at W = 16): chains of 1, 2, 2^t - 1, 2^t, 2^t + 1 k-mers, a run
     in one bucket of K5's table, one row, self-twin chains, flanked
     palindromes), K7 on adversarial inputs (k7_case at K5_KS: those
     chains, cycles in both variants, self-twin chains, palindromes whose
     chains share positions, the chain capacity at the chain count and
     one below it, the base capacity cut inside a prefix; the chains and
     palindromes again with 64-bit collision keys), and K3 on
     adversarial runs (k3_case: k = 1, 2, 15, 16, 17, 31, cutoffs that keep
     no row, every row or one in five, H = 1..8, 64 and 4,099 words, an
     unaligned view, M = 0, 1), each equal to its plain version; the K6
     record times the whole optimistic chain_rank (five launches);
  4. build a yeast-sized genome on the card (linear contigs plus two
     circular plasmids), count it with K1 + K22 + K2, and build its
     unitigs with K5-K7 and with the plain version: equal buffers, the
     cycle variant taken with K5 launched once (its rebuild reuses the
     links) and K7 twice, the payload equal to the native host builder's;
  5. compress and decompress twelve small corpora (lossy and lossless
     FASTQ, long-read FASTA, k = 15, 16, 31, 32, 48, 64, 65, 96 and 255,
     both Bloom-set sections, then two more at k = 65 and 255 with the
     device unitig build) on the card and on the CPU: the archives and
     outputs must be identical; the k = 255 runs launch the multiword
     kernels and the device unitig build at W = 16 and give their launch
     counts (the first k = 255 run in chunks of 64 reads and slabs of 2**14
     k-mers, so that its runs merge on K23);
  6. generate the bench corpus (gen_fastq, a copy of bench.py's: 500k
     reads of 100 bp from a 2 Mbp contig), compress and decompress it on
     the card with -noheader -noqual, then again with the device unitig
     build (unitig_device_max_kmers = 2**30), then at k = 63; then 200k
     reads of 250 bp from the same contig and seed at k = 127 (W = 8);
     then k = 63 and k = 127 again with the device unitig build; each run
     must give the exact sequence round trip and its pinned archive (the
     reference's bytes, PIN, PIN63 and PIN127), and launch each kernel of
     its path (K1, K22, K2-K4 and, at k = 31, whose two slabs merge, K23;
     K5-K8; K17, K21, K22, K20, K14 and its row policy, K16, K18,
     walk_pack, K19; those and K5-K8 over W-word rows) at least once, with
     torch.sort, ops.count.words_to_planes and ops.count._top_keys replaced
     by guards that raise on a CUDA tensor, and every merge of runs watched
     (CudaGuards: inside a merge torch.cat raises on CUDA tensors, and a
     merge must launch K23 and neither K22 nor K20), restored after;
  7. K10 on adversarial words (k10_case: every bit random, so dirty bits
     reach the shr2_ins neighbours' first base, at k = 1, 2, 15, 16, 17,
     31, 32, 33, 63, 64, 127, 128, 254, 255, N = 1, 255, 257, every mode,
     classic and blocked, an unaligned view) and K12 on adversarial graphs
     (k12_case: SNP bubbles meeting at the last depth or never, tips, lanes
     that stop at step 0, rows of S(D + 2) = 35 bytes, D = 1, N below one
     block and no multiple of any block size) and K11 on adversarial walks
     (k11_case at k = 1..64 of K11_KS: start words with random bits above
     2k, SNP bubbles, false-positive branches, lanes that stop at step 0
     and at step S - 1, walks past k steps; N = 61, 257; an unaligned
     view), each equal to its plain version; then the graph API at full
     width on phase 3's solid set
     (2,014,298 k-mers, k = 31): Graph.from_solid, contains / successors / predecessors /
     is_branching / iter_branching over every node, contains of 2**21
     random k-mers (false-positive rate), the blocked bloom.probe of the
     compressor's filter, walk from every node (100 steps), traverse from
     65,536 nodes (16 steps, D = 32), and the Pallas probe script's
     gather (2**24 indices into 1, 2 and 8 MB tables); each of K9-K12
     launched at least once, then held against its plain version on the
     card, exactly, and timed (K9 also against torch.take); before them K9
     on adversarial indices (k9_case: M mod 4 = 0..3, each 16-byte phase of
     the index view, negative and out-of-range indices, tables of 1 and 257
     words and the three above, and their 2**24 indices as an unaligned
     view);
  8. K15 on adversarial reads (k15_case, walk_case's edge reads, at k =
     1..64 of K15_KS and L mod 16 = 0, 1, 15; the codes also as an
     unaligned view), K13 on adversarial reads (k13_case: code bytes above
     3 at column 0, at the last column, past a read's end, before windows
     within the reach of their rc bits, at every other column, a read of
     only 0xFF, at k = 1..64 of K13_KS and L mod 16 = 0, 1, 15, and rows of
     more than 2,048 positions, K13_LONG; the codes also as an unaligned
     view) and K20 on adversarial rows (tie_case: runs of 1, 2, 31, 32, 33,
     1,024, 1,025 and 65,536 equal top words, runs of equal rows, one run
     of every row, words around the int64 sign flip, rows equal but for
     word 0, at W = 3, 4, 8, 16; count_batch too; and with tie_counts as
     its payload, as the WordCounter's merges run it, then K14's count
     mode), each equal to its plain version; then the tensor-level
     k-mer path on phase 3's 458,752 reads: at k = 31,
     K13 scan + K22 + K14 count equal phase 3's distinct run and
     solid keys, K16 over the solid rows equals K3's bitset, K15 on one
     chunk agrees with K4; at k = 63 (W = 4) scan, count (the top sort,
     K20, K14), K16, K15 and
     the graph API (K10/K11 at W = 4); the 4-shard mesh on the one card
     equals one shard; entry() on the card equals its CPU run; each of
     K13-K16 and K20 launched at least once, then held against its plain
     version on the card, exactly, and timed (K14 also against
     torch.unique_consecutive, count_batch against torch.unique);
  9. the multiword route of compress and decompress at three widths, as
     65,536-lane packed chunks: k = 63 on phase 3's reads (the distinct
     run and cutoff must equal phase 8's), k = 127 on phase 6's 250-bp
     corpus (the solid count must equal PIN127's) and k = 255 on 131,072
     reads of 300-600 bp: K17 scan, the WordCounter's sorts (each chunk's
     slab by sort_slab: K21 plane_rows, K22 of the top keys with their
     index, K20; the slab runs' merge by K23 where they lie, records
     `merge_path:rows`, `:rows8`, `:rows16`, and, as the parent merged them,
     by sort_rows over their concatenation: K22 reading the top keys from
     the rows, K20 with the counts as its payload; each equal to the LSD
     sort of the same rows; K22 records `radix_sort:main`, `:rows` and
     `:main8`, `:rows8`, `:main16`, `:rows16`; K24 and K25 in the slab's
     top sort, by the profiler: `radix_bucket:main`, `radix_oversize:main`,
     `:main8`, `:main16`; the first width's top sort again under the sync
     debug mode's "error"), K14 slab
     runs, merge (counts,
     histogram), its row policy on the final run (`word_runs_rows`, with
     the histogram and in solid mode, equal to K14 over the run's planes
     and to K14 over the sorted planes of the merge)
     and solid mode, K16 over the run's solid rows, K18 encode
     and K19 decode of one chunk, then the device unitig build over the
     solid rows (K5, K6, K7, K8 at W = 4, 8 and 16; the payload must equal
     the native host builder's), each held against its plain version on
     the card, exactly, and timed (records `name:w4`, `name:w8`,
     `name:w16` for K5-K8); before them K14 on adversarial rows (k14_case:
     n = 0, 1, 2, one run over every row, every row distinct, a run of
     2^20 rows across steps, stretches and blocks, run sums that wrap u32
     or pass 2^31 - 1, runs of 1-3 rows at every offset of a step edge,
     all-ones top words and the all-ones row; neighbouring runs differ in
     one word) at W = 4, 8 and 16 in its three modes, cutoffs 1, 2, 255
     and 256 with the histogram, K23 on adversarial runs of rows
     (merge_case at W = 2, 3, 4, 8, 16: phase 3's cases, rows equal in their
     top 64 bits that differ only in word 0, both sides of word W-1's top
     bit, all-ones tails), K17 on adversarial reads (scan_case:
     k = 17 to 255, L mod 16 = 0, 1, 15, reads of length 0, k - 1, k, L,
     palindromes and all-ones top words at k = 16W), and K18 and K19 on
     adversarial reads (walk_case: the same k and L mod 16, H = 1..8, so
     W = 2..16; reads of length 0, k - 1, k, k + 1, L and longer than L,
     anchors at 0 and len - k, unanchored and all-error reads,
     bifurcations on both sides, sides past the anchor's k bases), and K16
     on adversarial rows (bloom_adversarial: W = 1..16 at k = 16W - 15,
     16W - 1 and 16W, H = 1..8, garbage above 2k, 64 words for 4,096 rows,
     a sparse valid, S = 0), each equal to its plain version;
 10. K11, K15 and K13 on their adversarial cases past k = 64; then phases
     8 and 7 past four words, on phase 9's reads and solid sets: at
     k = 127 (W = 8) K13 over the 200,000 reads of 250 bp, count_batch
     (the top sort, K20, K14's run lengths; 19,755,554 distinct, 1,777,017
     solid),
     the 4-shard Bloom build (= one shard = phase 9's K16), K15 on one
     chunk, and the graph API on the solid set (every query over every
     node, 2**21 random k-mers, the blocked probe of phase 9's filter,
     walk from every node, traverse from 65,536 nodes at D = 32 and
     D = k + 1); then the same at k = 255 (W = 16) on phase 9's 131,072
     reads of 300-600 bp; each of K10-K15 launched at least once at each
     width (and K20), its output on the path held against its plain
     version on the card, exactly, at the path's shapes (every read, node, lane and
     step; K12 at D = k + 1 on the first sixteenth of its lanes), and timed
     there (records `name:w8`, `name:w16`; K14 also
     against torch.unique_consecutive, count_batch against torch.unique).
 11. inputs past one card's limits (leon_tpu_torch/pipeline.py, ops/count.py):
     (a) phase 6's corpora in stream mode (stream_threshold_bytes = 1: each
     pass parses again, pass 2 uploads its chunks) with a forced
     multi-run spill (slabs of 2**22 k-mers, a merge at every second slab,
     runs of 2**21 rows or more to host RAM; at least two spills) at k = 31,
     63 and 127, once with each unitig builder: each archive must be PIN,
     PIN63 or PIN127, and the path's kernels must launch, the spilled Bloom
     build (K3, or K16 past k = 31) and K23 among them, every merge of runs
     on K23 with neither K22 nor K20 launched inside it and no torch.cat of
     CUDA runs (MergeGuard); (b) in a child process
     (`python3 chip_smoke.py --large-corpus`), a corpus over 1 GiB
     (LARGE: 5,000,000 reads of 100 bp from a 20 Mbp random contig, 1%
     substitutions, every other read reverse-complemented, by the
     vectorised gen_large_fastq) compressed with the bench's flags and
     the default configuration but count_spill_rows = 2**24 and
     count_merge_factor = 2 (at the defaults its largest merged run,
     about 58M rows, stays under the 64M spill threshold): it must take
     stream mode and spill at least twice, round-trip exactly, launch
     K1-K4 and K3 on the spilled Bloom, and write the archive of the
     same file compressed in memory and unspilled on the card, which must
     be the reference's (LARGE_PIN, from leon_tpu on the CPU); the child prints
     its walls, spans, spills, the card's peak memory and its peak RSS;
     (c) a checkpoint resume on the bench corpus: the second run launches
     neither K1 nor K2 and writes PIN; (d) compress with profile_dir: a
     Chrome trace appears and the archive is PIN.
 12. several devices (leon_tpu_torch/pipeline.py's placer,
     parallel/distributed.py): (a) the bench corpus compressed and
     decompressed with its lanes sharded over a four-shard mesh on the one
     card (device=["cuda:0"] * 4, mesh_devices = 4) at k = 31 with the host
     unitig builder and at k = 63 with the device builder: each archive
     must be PIN or PIN63, the decode on the mesh must give the input's
     sequences, and K1 / K17 (count), K4 / K18 (encode) and K4 / K19
     (decode) must launch, at least once a shard a chunk; (b)
     compress_distributed over gloo in two child processes on the one card
     (`python3 chip_smoke.py --distributed-rank R N PG SRC ARC`, each rank
     on its default device cuda:(R mod the card count), here cuda:0) on the
     bench corpus at k = 31: rank 0's archive must be PIN. It prints the walls and launch counts beside
     the card's name and power limit.
The adversarial checks of K5 and K7 (phase 3), K11 (phases 7 and 10), K15
(phases 8 and 10) and K18 and K19 (phase 9), whose plain versions hold the
host longest, run in a child process (`python3 chip_smoke.py
--adversarial`) from before phase 4 to after phase 12, while the parent
runs phases that time no kernel; the run fails if the child fails.
It prints one JSON line of kernel records (each with its bound: the bytes
it must move, every input read once and every output written once, over
the card's 3.35 TB/s; for K8, which searches the run, the queries, its
outputs and one row of the run a query, as `bound_note` says; K18 and
K19, bound by their Bloom probes, note their probe floor's script),
then, last, the device line. Kernels under ~50 us
are timed from the profiler's device time, the rest with CUDA events.
Work files go to build/chip_smoke/ beside this script.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import resource
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
# The same corpus at k = 63 (W = 4, the multiword route): leon_tpu.pipeline.
# compress (CPU backend) with LeonConfig(noheader=True, noqual=True,
# kmer_size=63).
PIN63 = {
    "bytes": 6_343_954,
    "sha256": "a183c79f487a77c25aa4d8a995daa4f917315595d4d20218984f2fa03884d18f",
    "n_anchored": 402_662, "n_solid": 1_978_436,
}
# 2x250-style reads at k = 127 (W = 8): gen_fastq(src, 200_000, 2_000_000,
# 250) (sha256 b27b4950...), then leon_tpu.pipeline.compress(src, out,
# cfg=LeonConfig(noheader=True, noqual=True, kmer_size=127)) with jax on
# the CPU (JAX_PLATFORMS=cpu, PYTHONPATH=/path/to/repo).
PIN127 = {
    "n_reads": 200_000, "read_len": 250,
    "bytes": 7_895_648,
    "sha256": "494a7f7a29bda246da0b8aed43aeee7700410315422a0567d57e0ea8629c8fe3",
    "n_anchored": 172_124, "n_solid": 1_777_017,
}

# kernel -> (CUDA source, the TPU program it replaces)
KERNELS = {
    "kmer_scan": ("leon_tpu_torch/csrc/kmer.cu", "leon_tpu/ops/kmer.py:141"),
    "kmer_scan:chunk": ("leon_tpu_torch/csrc/kmer.cu", "leon_tpu/ops/kmer.py:141"),
    "runs": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:45"),
    "runs:merge": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:226"),
    "runs:solid": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:707"),
    "bloom_build": ("leon_tpu_torch/csrc/bloom.cu", "leon_tpu/ops/bloom.py:394"),
    "walk_encode": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:432"),
    "walk_pack": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:460"),
    "walk_decode": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:819"),
    "unitig_links": ("leon_tpu_torch/csrc/unitig.cu", "leon_tpu/ops/unitig.py:377"),
    "unitig_double": ("leon_tpu_torch/csrc/unitig.cu", "leon_tpu/ops/unitig.py:512"),
    "unitig_emit": ("leon_tpu_torch/csrc/unitig.cu", "leon_tpu/ops/unitig.py:586"),
    "solid_lookup": ("leon_tpu_torch/csrc/unitig.cu", "leon_tpu/ops/unitig.py:938"),
    "gather_words": ("leon_tpu_torch/csrc/graph.cu", "scripts/probe_pallas_gather.py:41"),
    "dbg_probe": ("leon_tpu_torch/csrc/graph.cu", "leon_tpu/ops/bloom.py:257"),
    "dbg_walk": ("leon_tpu_torch/csrc/graph.cu", "leon_tpu/graph.py:87"),
    "dbg_traverse": ("leon_tpu_torch/csrc/graph.cu", "leon_tpu/graph.py:125"),
    "kmer_scan_words": ("leon_tpu_torch/csrc/kmer.cu", "leon_tpu/ops/kmer.py:129"),
    "runs_words": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:88"),
    "sort_ties": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:45"),
    "bloom_build_words": ("leon_tpu_torch/csrc/bloom.cu", "leon_tpu/parallel/mesh.py:33"),
    "walk_dense": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:621"),
    "kmer_scan_halves": ("leon_tpu_torch/csrc/kmer.cu", "leon_tpu/ops/kmer.py:141"),
    "word_runs": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:227"),
    "bloom_build_words:main": ("leon_tpu_torch/csrc/bloom.cu", "leon_tpu/ops/bloom.py:422"),
    "walk_encode_words": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:556"),
    "walk_decode_words": ("leon_tpu_torch/csrc/walk.cu", "leon_tpu/ops/walk.py:820"),
    "plane_rows": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:194"),
    "sort_ties:main": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:227"),
    "radix_sort": ("leon_tpu_torch/csrc/sort.cu", "leon_tpu/ops/count.py:60"),
    "radix_sort:merge": ("leon_tpu_torch/csrc/sort.cu", "leon_tpu/ops/count.py:233"),
    "radix_sort:main": ("leon_tpu_torch/csrc/sort.cu", "leon_tpu/ops/count.py:60"),
    "radix_sort:rows": ("leon_tpu_torch/csrc/sort.cu", "leon_tpu/ops/count.py:233"),
    "radix_bucket:main": ("leon_tpu_torch/csrc/sort.cu", "leon_tpu/ops/count.py:60"),
    "radix_oversize:main": ("leon_tpu_torch/csrc/sort.cu", "leon_tpu/ops/count.py:60"),
    "word_runs_rows": ("leon_tpu_torch/csrc/count.cu", "leon_tpu/ops/count.py:227"),
    "merge_path": ("leon_tpu_torch/csrc/sort.cu", "leon_tpu/ops/count.py:233"),
    "merge_path:rows": ("leon_tpu_torch/csrc/sort.cu", "leon_tpu/ops/count.py:233"),
}
DEVICE_BUILD = ("unitig_links", "unitig_double", "unitig_emit", "solid_lookup")
GRAPH = ("gather_words", "dbg_probe", "dbg_walk", "dbg_traverse")
TENSOR = ("kmer_scan_words", "runs_words", "sort_ties", "bloom_build_words", "walk_dense")
# the main path's multiword route (32 <= k <= 255): K17, K14 (word_runs),
# K16, K18 (+ walk_pack), K19, and the WordCounter's sorts K21 (plane_rows)
# and K20 (sort_ties, with the counts as payload on a merge). A record's
# name up to ":" is its launch counter: K16 has one record on the tensor
# path (phase 8, as mesh.py calls it) and one on the main path (phase 9,
# over the solid rows), K20 one each on the tensor path (phases 8 and 10)
# and the main path (phase 9: ":main", ":main8", ":main16"); K22 two on the
# main path at k <= 31 (phase 3: "radix_sort", the slab, keys alone;
# ":merge", with the counts) and two a width past it (phase 9: ":main" the
# slab's top sort with the row index, ":rows" the top sort of the slab runs'
# rows, read from the rows; ":main8", ":rows8", ...), K22's bucket route's
# K24 and K25 ("radix_bucket:main", "radix_oversize:main", ":main8",
# ":main16": the slab's top sort; the k <= 31 slab's 64-bit keys take the
# passes) beside them; K14's row policy
# (`word_runs_rows`, the reduce of a merged run) one a width; K23 one on the
# main path at k <= 31 (phase 3: "merge_path", two runs of keys) and one a
# width past it (phase 9: ":rows", ":rows8", ":rows16", the chunks' slab
# runs); the multiword kernels have one record at k = 63 (W = 4) and one each
# at W = 8 and W = 16 (":w8", ":w16").
WIDE = ("kmer_scan_halves", "word_runs", "bloom_build_words:main", "walk_encode_words",
        "walk_decode_words", "plane_rows", "sort_ties:main", "radix_sort:main",
        "radix_sort:rows", "word_runs_rows", "merge_path:rows", "radix_bucket:main",
        "radix_oversize:main")
WIDE8, WIDE16 = (tuple(f"{n}{w}" if n.startswith(("sort_ties:", "radix_sort:", "merge_path:",
                                                  "radix_bucket:", "radix_oversize:"))
                       else f"{n.split(':')[0]}:w{w}" for n in WIDE) for w in (8, 16))
# K23's records past k = 31: a bench compress at k = 63 or 127 fills one
# slab and merges nothing, so their launches come from runs that merge (phase
# 11's spilled runs at W = 4 and 8, phase 5's V255 at W = 16)
MERGES = ("merge_path:rows", "merge_path:rows8", "merge_path:rows16")
KERNELS.update({n: KERNELS[w] for n, w in zip(WIDE8 + WIDE16, WIDE + WIDE)})
# the tensor path and the graph API past four words (phase 10): K13, K14's
# run lengths, K15, K10-K12 and K20 at W = 8 (k = 127) and W = 16 (k = 255)
LONGK = ("kmer_scan_words", "runs_words", "walk_dense", "dbg_probe", "dbg_walk", "dbg_traverse",
         "sort_ties")
LONGK8, LONGK16 = (tuple(f"{n}:w{w}" for n in LONGK) for w in (8, 16))
KERNELS.update({n: KERNELS[c] for n, c in zip(LONGK8 + LONGK16, LONGK + LONGK)})
# the device unitig build over W-word rows (k > 31): K5, K6, K7 and K8 at
# W = 4 (k = 63), 8 (k = 127) and 16 (k = 255), records "name:w4" etc.
UNITIG4, UNITIG8, UNITIG16 = (tuple(f"{n}:w{w}" for n in DEVICE_BUILD) for w in (4, 8, 16))
KERNELS.update({n: KERNELS[counter] for n, counter in
                zip(UNITIG4 + UNITIG8 + UNITIG16, DEVICE_BUILD * 3)})
COMPRESS = tuple(k for k in KERNELS
                 if k not in GRAPH + TENSOR + WIDE + WIDE8 + WIDE16 + LONGK8 + LONGK16
                 + UNITIG4 + UNITIG8 + UNITIG16)
K63, K127, K255 = 63, 127, 255

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)

K, H, SEED, B, READ_LEN = 31, 4, 0x1234ABCD, 65536, 100


def counter(name: str) -> str:
    """The launch counter of a kernel record's name."""
    return name.split(":")[0]


def no_merges(names: tuple) -> tuple:
    """names but K23's records past k = 31 (MERGES: a run that fills one slab
    merges nothing)."""
    return tuple(n for n in names if n not in MERGES)


T_START = time.time()


def log(msg: str) -> None:
    """A line of the run's log, with the seconds since the script started."""
    print(f"[chip_smoke {time.time() - T_START:.0f} s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


SMALL_MS = 0.05  # below this, events around Python calls read host dispatch
SLOW_MS = 200.0  # a first call this long is one of the reps: no warm-up to pay off


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (after one warm-up, or,
    for a call of SLOW_MS or more, the first call counted as a rep): CUDA
    events around the calls, or, for a call whose kernels and copies take
    under SMALL_MS of device time by the profiler, that device time (events
    around calls that short read the host's dispatch). The profiler's time
    counts only when it recorded each of its kernels and copies at least
    once per call: late in a run it has kept one launch of ten."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    first = t0.elapsed_time(t1)
    if first >= SLOW_MS:
        _, rest = timed(lambda: [fn() for _ in range(reps - 1)])
        return (first + rest) / reps
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
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.device_time_total for e in dev) / 1e3 / reps
    whole = bool(dev) and min(e.count for e in dev) >= reps
    return dev_ms if whole and 0 < dev_ms < SMALL_MS else ms


def timed(fn) -> tuple:
    """fn()'s result and its time in ms over that one call (CUDA events):
    for plain versions that take seconds, whose checking call is their
    timing."""
    import torch

    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def nbytes(*objs) -> int:
    """Bytes of the tensors in objs (tensors, or dicts / lists / tuples of
    them; other values count 0)."""
    import torch

    n = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
        elif isinstance(o, dict):
            n += nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            n += nbytes(*o)
    return n


def record(err: int, ms: float, plain_ms: float, moved: int, library_ms=None,
           bound_note=None) -> dict:
    """A kernel's record: its max |diff| against the plain version, its
    time, the plain version's, its bound (moved bytes over the card's
    memory rate: each input read once, each output written once, or, per
    bound_note, what the function must read of an input it searches) and
    the time of the one PyTorch call that computes the same function (None
    where there is none)."""
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes", moved_bytes=moved,
                library_ms=library_ms, bound_note=bound_note)


def sort_record(err: int, fn, keys, payload, reps: int = 10) -> dict:
    """K22's record for one sort of keys (n,) int64 (the keys themselves, or
    the top keys a row source gives) with payload (None, an (n,) tensor, or
    "index": each key's index): its time beside the plain version's
    (torch.sort(stable=True) and the payload's gather, on the same keys)
    and torch.sort's (library_ms: the call the port made before K22, which
    computes the same order); the bound: the keys (and payload) read once
    and written once (an index is only written)."""
    import torch

    from leon_tpu_torch.ops import count

    index = isinstance(payload, str)
    pay = torch.arange(keys.shape[0], device=keys.device) if index else payload
    moved = 2 * nbytes(keys, None if index else payload) + (nbytes(pay) if index else 0)
    return record(err, cuda_ms(fn, reps), cuda_ms(lambda: count.radix_sort_plain(keys, pay), reps),
                  moved, cuda_ms(lambda: torch.sort(keys, stable=True), reps))


def route_kernels_ms(fn, reps: int = 3) -> dict:
    """Device time a call of fn() (a K22 sort) spends in K22's kernels
    ("radix_sort": its histogram, scan, passes and memsets), K24's
    ("radix_bucket": bs_edge, bs_bucket) and K25's ("radix_oversize":
    bs_seg_*), by the profiler, mean over reps calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"radix_sort": 0.0, "radix_bucket": 0.0, "radix_oversize": 0.0}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        name = ("radix_oversize" if "bs_seg_" in e.key else
                "radix_bucket" if "bs_edge" in e.key or "bs_bucket" in e.key else "radix_sort")
        out[name] += e.device_time_total / 1e3 / reps
    return out


def bucket_records(sort_rec: dict, fn, keys, payload, bits: int) -> tuple:
    """The records of K24 and K25 in one K22 sort fn() of keys (n,) int64
    over `bits` bits on the bucket route, with payload (None, or "index":
    4 bytes a key between the kernels, 8 out): each kernel's device time in
    the sort (route_kernels_ms) beside the whole sort's error; the plain
    and library times of what the two compute together, on the keys as the
    passes leave them, grouped by bucket (radix_sort_plain of those keys
    and their index; torch.sort(stable=True) of them); the bound: the keys
    (and payload) of the buckets each kernel sorts read once and written
    once (K24: buckets of up to count.BUCKET_CAP keys; K25: the larger
    ones)."""
    import torch

    from leon_tpu_torch.ops import count

    route, B = count.radix_route(keys.numel(), bits)
    if route != "bucket":
        raise AssertionError(f"bucket_records: {keys.numel()} keys over {bits} bits go by {route}")
    bucket = keys >> (bits - B)  # the arithmetic shift keeps the buckets' order
    order = torch.sort(bucket, stable=True).indices
    grouped = keys[order]
    sizes = torch.unique_consecutive(bucket[order], return_counts=True)[1]
    n_over = int(sizes[sizes > count.BUCKET_CAP].sum())
    del bucket
    per_key = 16 + (0 if payload is None else 12)
    dev_ms = route_kernels_ms(fn)
    pay = None if payload is None else order
    plain_ms = cuda_ms(lambda: count.radix_sort_plain(grouped, pay), 10)
    library_ms = cuda_ms(lambda: torch.sort(grouped, stable=True), 10)
    return tuple(record(sort_rec["max_abs_err"], dev_ms[name], plain_ms, per_key * moved,
                        library_ms)
                 for name, moved in (("radix_bucket", keys.numel() - n_over),
                                     ("radix_oversize", n_over)))


def merge_record(err: int, fn, runs: list, reps: int = 10) -> dict:
    """K23's record for one merge of runs [(keys or rows, counts), ...]: its
    time beside the plain version's (merge_path_plain: torch.cat and a stable
    torch.sort) and torch.sort(stable=True) of the concatenated keys (of the
    rows' top keys, _top_keys; library_ms: the library call that orders
    them, not counting the cat); the bound: the runs' elements and counts
    read once and the merged run written once (a merge of R runs in pairwise
    rounds moves them once a round: PERF.md's floor)."""
    import torch

    from leon_tpu_torch.ops import count

    data = torch.cat([d for d, _ in runs])
    keys = data if data.dim() == 1 else count._top_keys(data)
    del data
    return record(err, cuda_ms(fn, reps), cuda_ms(lambda: count.merge_path_plain(runs), 2),
                  2 * nbytes(runs), cuda_ms(lambda: torch.sort(keys, stable=True), reps))


# K18 and K19 wait on their Bloom probes, not on their bytes
WALK_BOUND_NOTE = ("bytes only; the walk's binding bound is its probe floor "
                   "(scripts/ab_kernels.py --only walk, PERF.md rows 10-11c)")
# K10-K12 wait on their Bloom probes' random loads
GRAPH_BOUND_NOTE = ("bytes only; the graph kernels' binding bound is their probe floor "
                    "(scripts/ab_kernels.py --only graph, PERF.md rows 14-15c)")
# K9 waits on its random table loads, K20 on its random row gathers
GATHER_BOUND_NOTE = ("bytes only; K9's binding bound is floor (b), its random L2 loads "
                     "(scripts/gather_floor.cu via scripts/ab_kernels.py --only gather, "
                     "PERF.md rows 1-2)")
TIES_BOUND_NOTE = ("bytes only; K20's gather floor (c), its rows gathered in sort order "
                   "(scripts/gather_floor.cu via scripts/ab_kernels.py --only wordsort, "
                   "PERF.md rows 4b-8c, 12b)")
# K5 waits on its searches' random loads
LINKS_BOUND_NOTE = ("bytes only; K5's binding bound is its probe floor "
                    "(scripts/ab_kernels.py --only links, PERF.md rows 17a, 17a (W))")


def max_abs_err(a, b) -> int:
    """Max |a - b| over the int64 values of two same-shape integer or bool
    tensors, compared on a's device (b, on the card or the CPU, is moved
    there); raises unless they are equal."""
    import torch

    if tuple(a.shape) != tuple(b.shape):
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    a = a.to(torch.int64)
    b = b.to(device=a.device, dtype=torch.int64)
    err = int((a - b).abs().max()) if a.numel() else 0
    if err:
        raise AssertionError(f"kernel differs from its plain version (max |diff| {err})")
    return err


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_checks(records: dict, n_chunks: int = 7) -> dict:
    """K1-K3 on a slab of n_chunks * B reads (>= 2**25 keys at 7), K4 on one
    chunk of B reads (L = 104, k = 31, H = 4) against a bitset of ~1.5M words
    built from the reads' contig, K5-K8 on the slab's solid run. Returns
    what the graph phase reuses: the solid keys, K3's bitset and its size,
    and the contig."""
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
    records["kmer_scan"] = record(
        max_abs_err(got, want),
        cuda_ms(lambda: kmer.kmer_scan(packed_d, lengths_d, K, L), 10),
        cuda_ms(lambda: kmer.kmer_scan_plain(packed_d, lengths_d, K, L), 2),
        nbytes(packed_d, lengths_d, got))
    log(f"kmer_scan ok: {got.numel()} keys")
    # K1 as DeviceCounter.add_packed launches it: one chunk into a slab view
    P = L - K + 1
    p1, l1 = packed_d[:B], lengths_d[:B]
    view = torch.empty(2 * B * P, dtype=torch.int64, device=dev)[B * P :]
    kmer.kmer_scan(p1, l1, K, L, out=view)
    records["kmer_scan:chunk"] = record(
        max_abs_err(view, want[: B * P]),
        cuda_ms(lambda: kmer.kmer_scan(p1, l1, K, L, out=view), 20),
        cuda_ms(lambda: kmer.kmer_scan_plain(p1, l1, K, L), 2), nbytes(p1, l1, view))
    log(f"kmer_scan:chunk ok: {B * P} keys, {records['kmer_scan:chunk']['ms']:.4f} ms "
        f"(the slab's {nr} reads in one launch {records['kmer_scan']['ms']:.4f} ms)")
    del view
    k1_adversarial()

    # K22 on the slab (keys only: DeviceCounter._slab_run); K22 carrying
    # counts over the merge's keys (the parent's merge sort; the merge itself
    # is K23's, below); K2: the raw slab, the merge with its count payload,
    # then the solid compaction
    skeys = count.radix_sort(got)
    records["radix_sort"] = sort_record(max_abs_err(skeys, count.radix_sort_plain(got)),
                                        lambda: count.radix_sort(got), got, None)
    # the sort makes no host read: a synchronizing call inside it raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = count.radix_sort(got)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if max_abs_err(again, skeys):
        raise AssertionError("radix_sort: a second sort of the slab differs")
    log("radix_sort: the slab's sort under torch.cuda.set_sync_debug_mode('error') ok")
    del again
    sk_c = skeys.cpu()
    rk, rc, _ = count.runs(skeys)
    pk, pc, _ = count.runs_plain(sk_c)
    err = max(max_abs_err(rk, pk), max_abs_err(rc, pc))
    mk = torch.cat([rk, rk[::3]]).flip(0)
    mc0 = torch.cat([rc, rc[::3]]).flip(0)
    ms, mc = count.radix_sort(mk, mc0, 2 * K)  # k-mer keys: 2k bits
    serr = max(max_abs_err(a, b) for a, b in zip((ms, mc), count.radix_sort_plain(mk, mc0)))
    records["radix_sort:merge"] = sort_record(serr, lambda: count.radix_sort(mk, mc0, 2 * K),
                                              mk, mc0)
    log(f"radix_sort ok: the slab's {got.numel()} keys {records['radix_sort']['ms']:.4f} ms "
        f"(torch.sort {records['radix_sort']['library_ms']:.4f}), the merge's {mk.numel()} keys "
        f"with their counts {records['radix_sort:merge']['ms']:.4f} ms (torch.sort "
        f"{records['radix_sort:merge']['library_ms']:.4f})")
    del mk, mc0
    sort_adversarial()
    bucket_adversarial()
    # K23 on two runs as DeviceCounter merges them: the slab's distinct run
    # and every third row of it again, each sorted, with their counts, read
    # where they lie; beside the parent's route (torch.cat, then K22 with the
    # counts over the keys' 2k bits)
    mruns = [(rk, rc), (rk[::3].contiguous(), rc[::3].contiguous())]
    merr = max(max_abs_err(a, b) for a, b in
               zip(count.merge_path(mruns), count.merge_path_plain(mruns)))
    records["merge_path"] = merge_record(merr, lambda: count.merge_path(mruns), mruns)
    parent_ms = cuda_ms(lambda: count.radix_sort(torch.cat([r[0] for r in mruns]),
                                                 torch.cat([r[1] for r in mruns]), 2 * K), 5)
    log(f"merge_path ok: {ms.numel()} keys in two runs with their counts "
        f"{records['merge_path']['ms']:.4f} ms (the parent's cat + K22 {parent_ms:.4f}, "
        f"torch.sort {records['merge_path']['library_ms']:.4f}, bound "
        f"{records['merge_path']['bound_ms']:.4f})")
    del mruns
    merge_adversarial(MERGE_KEYS)
    gk, gc, gh = count.runs(ms, mc, 1, True)
    wk, wc, wh = count.runs_plain(ms.cpu(), mc.cpu(), 1, True)
    err_m = max(max_abs_err(gk, wk), max_abs_err(gc, wc), max_abs_err(gh, wh))
    hist = wh.numpy().astype(np.int64)
    cutoff = count.auto_cutoff(hist)
    sk, sc = count.compact_solid(rk, rc, cutoff)
    tk, tc, _ = count.runs_plain(rk.cpu(), rc.cpu(), cutoff)
    err_s = max(max_abs_err(sk, tk), max_abs_err(sc, tc))
    records["runs"] = record(
        err, cuda_ms(lambda: count.runs(skeys), 5), cuda_ms(lambda: count.runs_plain(skeys), 2),
        nbytes(skeys, rk, rc),
        cuda_ms(lambda: torch.unique_consecutive(skeys, return_counts=True), 5))
    records["runs:merge"] = record(
        err_m, cuda_ms(lambda: count.runs(ms, mc, 1, True), 5),
        cuda_ms(lambda: count.runs_plain(ms, mc, 1, True), 2), nbytes(ms, mc, gk, gc, gh))
    records["runs:solid"] = record(
        err_s, cuda_ms(lambda: count.compact_solid(rk, rc, cutoff), 5),
        cuda_ms(lambda: count.runs_plain(rk, rc, cutoff), 2), nbytes(rk, rc, sk, sc))
    log(f"runs ok: {skeys.numel()} keys -> {rk.numel()} distinct; merge of {ms.numel()} "
        f"rows; cutoff {cutoff}, {sk.numel()} solid")
    runs_adversarial()

    # K3 on the distinct run, sized as the pipeline sizes it
    n_solid = int(hist[min(cutoff, 255):].sum())
    bpk, _h = bloom.auto_params(hist, cutoff, False, stored_filter=False)
    n_words = bloom.choose_n_words(n_solid, bpk)
    bits_d = bloom.bloom_build(rk, rc, cutoff, n_words, H, SEED, K)
    bits_c = bloom.bloom_build_plain(rk.cpu(), rc.cpu(), cutoff, n_words, H, SEED, K)
    records["bloom_build"] = record(
        max_abs_err(bits_d, bits_c),
        cuda_ms(lambda: bloom.bloom_build(rk, rc, cutoff, n_words, H, SEED, K), 10),
        cuda_ms(lambda: bloom.bloom_build_plain(rk, rc, cutoff, n_words, H, SEED, K), 2),
        nbytes(rk, rc, bits_d))
    log(f"bloom_build ok: {n_words} words")
    k3_adversarial()

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
    records["walk_encode"] = record(
        err, cuda_ms(enc_d, 10),
        cuda_ms(lambda: walk.walk_encode_plain(p1d, l1d, bits_d, n_words, K, H, SEED, L, True),
                1),
        nbytes(p1d, l1d, bits_d, e_d))
    anchored = int(e_c["meta"][:, 0].sum())
    log(f"walk_encode ok: {anchored}/{B} anchored, {int(tot_c[0].sum())} err, "
        f"{int(tot_c[1].sum())} bif events")

    incl_d = torch.cumsum(e_d["tot"], dim=1)
    incl_c = torch.cumsum(e_c["tot"], dim=1)
    cap_err = -(-int(incl_c[0, -1]) // 8) * 8
    cap_bif = -(-int(incl_c[1, -1]) // 8) * 8
    buf_d = walk.walk_pack(e_d, incl_d, L, K, cap_err, cap_bif, True)
    buf_c = walk.walk_pack_plain(e_c, incl_c, L, K, cap_err, cap_bif, True)
    records["walk_pack"] = record(
        max_abs_err(buf_d, buf_c),
        cuda_ms(lambda: walk.walk_pack(e_d, incl_d, L, K, cap_err, cap_bif, True), 10),
        cuda_ms(lambda: walk.walk_pack_plain(e_d, incl_d, L, K, cap_err, cap_bif, True), 2),
        nbytes(e_d, incl_d, buf_d))
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
    records["walk_decode"] = record(
        err, cuda_ms(lambda: walk.walk_decode(*dec_in_d, bits_d, n_words, K, H, SEED, L), 10),
        cuda_ms(lambda: walk.walk_decode_plain(*dec_in_d, bits_d, n_words, K, H, SEED, L), 1),
        nbytes(dec_in_d, bits_d, d_d))
    log(f"walk_decode ok: {rows.size} reads restored")

    # K5-K8 on the solid run the pipeline hands the device build; K8 on
    # adversarial runs at every width
    unitig_checks(records, sk, sc, cutoff, rk.numel(), "bench")
    rank_adversarial()
    lookup_adversarial()  # K5 and K7 on adversarial runs: the adversarial child
    return dict(solid_keys=sk, bits=bits_d, n_words=n_words, contig=contig, codes=codes,
                lengths=lengths, n_distinct=rk.numel(), cutoff=cutoff, k4_enc=e_d)


# ---------------------------------------------------------------------------
# phase 3: K2 and K8 on adversarial inputs (tests/test_torch_runs_lookup.py
# holds the plain versions to leon_tpu's on the same generators)
# ---------------------------------------------------------------------------

RUNS_STEP = 256  # rows a warp of K2 takes at a step (leon_tpu_torch/ops/count.py)
K2_CASES = ("n0", "n1", "n2", "n2_distinct", "hot", "hot_counts", "wrap", "sentinel",
            "sentinel_counts", "distinct", "boundary0", "boundary1", "boundary2", "boundary3")
K2_CUTOFFS = (1, 2, 300)
SENTINEL_KEY = (1 << 63) - 1


def _runs_from_lengths(lengths, rng):
    """Sorted int64 keys: run i has lengths[i] rows of a key that grows by 1-3."""
    import numpy as np

    ks = np.cumsum(rng.integers(1, 4, len(lengths))) + 1000
    return np.repeat(ks, lengths).astype(np.int64)


def _edge_lengths(tile: int, n_edges: int, rng) -> list:
    """Run lengths of 1-3 such that at edge m (row m * tile) a run of
    length L starts d rows before the edge, (L, d) cycling over every
    0 <= d < L."""
    combos = [(L, d) for L in (1, 2, 3) for d in range(L)]
    out, pos = [], 0
    for m in range(1, n_edges + 1):
        L, d = combos[m % len(combos)]
        while pos < m * tile - d:
            ln = min(int(rng.integers(1, 4)), m * tile - d - pos)
            out.append(ln)
            pos += ln
        out.append(L)
        pos += L
    return out


def k2_case(name: str, tile: int = RUNS_STEP, hot: int = 1 << 22):
    """(keys (n,) int64 sorted, counts (n,) int32 or None) of one
    adversarial K2 input, whose runs sit on edges `tile` rows apart (K2's
    steps; on the card also edges between warps and blocks): n = 0, 1, 2;
    one key `hot` times between other runs; run sums that wrap u32, pass
    2^31 - 1 or wrap to exactly 0; runs of 1-3 rows at every offset of an
    edge (boundary0-3, 96 edges); a SENTINEL tail across an edge; a
    distinct run with counts."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)) * 7919 + tile)
    if name == "n0":
        return np.zeros(0, np.int64), None
    if name == "n1":
        return np.array([77], np.int64), None
    if name == "n2":
        return np.array([5, 5], np.int64), None
    if name == "n2_distinct":
        return np.array([5, 9], np.int64), np.array([3, 0], np.int32)
    if name in ("hot", "hot_counts"):
        lengths = np.concatenate([rng.integers(1, 4, 3 * tile // 2), [hot],
                                  rng.integers(1, 4, tile)])
        keys = _runs_from_lengths(lengths, rng)
        return keys, (rng.integers(0, 4, keys.size).astype(np.int32)
                      if name == "hot_counts" else None)
    if name == "wrap":
        lengths = rng.integers(1, 6, 3 * tile)
        keys = _runs_from_lengths(lengths, rng)
        counts = rng.integers(0, 3, keys.size).astype(np.int32)
        heads = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        for h, ln in zip(heads[::7], lengths[::7]):
            counts[h : h + ln] = 0x7FFFFFF0  # past 2^31 - 1 from 2 rows, past 2^32 from 3
        for h, ln in zip(heads[3::11], lengths[3::11]):
            if ln >= 2:  # two rows of 2^31 (as u32): the sum wraps to 0 and drops
                counts[h : h + ln] = 0
                counts[h : h + 2] = -(1 << 31)
        return keys, counts
    if name.startswith("boundary"):
        lengths = ([1] * int(name[len("boundary"):])) + _edge_lengths(tile, 96, rng)
        keys = _runs_from_lengths(np.array(lengths), rng)
        return keys, rng.integers(1, 5, keys.size).astype(np.int32)
    if name in ("sentinel", "sentinel_counts"):
        keys = _runs_from_lengths(rng.integers(1, 4, tile // 2 + 8), rng)
        keys = np.concatenate([keys[: tile + 7], np.full(tile + 9, SENTINEL_KEY, np.int64)])
        if name == "sentinel":
            return keys, None
        counts = rng.integers(0, 5, keys.size).astype(np.int32)
        counts[keys == SENTINEL_KEY] = 0  # the reference's pads carry count 0
        return keys, counts
    if name == "distinct":
        keys = _runs_from_lengths(np.ones(3 * tile + 11, np.int64), rng)
        return keys, rng.integers(1, 400, keys.size).astype(np.int32)
    raise KeyError(name)


K8_KS = (15, 16, 31, 32, 63, 127, 255)  # int64 keys, then W = 2, 4, 8, 16 words
K8_CASES = ("random", "one", "few", "clustered")


def k8_case(name: str, k: int, M: int):
    """(rows (M', W) u32 sorted distinct, LSW first; queries (Q, W) u32) of
    one adversarial K8 input: random rows, M' = 1, M' = 5 (fewer than the
    splitter sample), or rows whose top 16 bits take two values (most of
    a prefix table's buckets empty). Queries: rows of the run, rows with
    a low or a high bit flipped, the first and last rows, the zero row and
    the all-ones row (below the first and above the last), random rows."""
    import numpy as np

    W = -(-k // 16)
    rng = np.random.default_rng(k * 1000 + sum(map(ord, name)))
    top_bits = 2 * k - 32 * (W - 1)
    top_mask = np.uint32((1 << top_bits) - 1) if top_bits < 32 else np.uint32(0xFFFFFFFF)

    def rand_rows(n):
        w = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(np.uint32)
        w[:, W - 1] &= top_mask
        return w

    def set_bit(w, b, on):
        j, o = divmod(b, 32)
        w[:, j] = (w[:, j] | np.uint32(1 << o)) if on else (w[:, j] & ~np.uint32(1 << o))

    n = {"one": 1, "few": 5}.get(name, M)
    rows = rand_rows(n)
    if name == "clustered":
        pref = np.where(rng.random(n) < 0.5, 3, 40000)
        for b in range(16):
            j, o = divmod(2 * k - 16 + b, 32)
            bit = ((pref >> b) & 1).astype(np.uint32) << np.uint32(o)
            rows[:, j] = (rows[:, j] & ~np.uint32(1 << o)) | bit
        rows[:, 0] |= np.uint32(1)  # not the zero row
    else:  # the top two bits 01: between the zero row and the all-ones row
        set_bit(rows, 2 * k - 1, False)
        set_bit(rows, 2 * k - 2, True)
    rows = rows[np.lexsort(rows.T)]
    if rows.shape[0] > 1:
        rows = rows[np.concatenate([[True], (rows[1:] != rows[:-1]).any(axis=1)])]
    q = rows[rng.integers(0, rows.shape[0], 2000)]
    lo, hi = q[:600].copy(), q[600:900].copy()
    lo[:, 0] ^= np.uint32(1)
    set_bit(hi, 2 * k - 3, True)
    ones = np.full((1, W), 0xFFFFFFFF, np.uint32)
    ones[:, W - 1] &= top_mask
    q = np.concatenate([q, lo, hi, rows[:1], rows[-1:], np.zeros((1, W), np.uint32), ones,
                        rand_rows(200)])
    return rows, q


def runs_adversarial() -> None:
    """K2 against its plain version on the card, exactly, on every
    k2_case at cutoffs 1, 2 and 300, with the histogram."""
    import torch

    from leon_tpu_torch.ops import count

    dev = torch.device("cuda")
    n_checked = 0
    for name in K2_CASES:
        keys, counts = k2_case(name)
        kd = torch.from_numpy(keys).to(dev)
        cd = None if counts is None else torch.from_numpy(counts).to(dev)
        for cutoff in K2_CUTOFFS:
            got = count.runs(kd, cd, cutoff, True)
            want = count.runs_plain(kd, cd, cutoff, True)
            for a, b in zip(got, want):
                max_abs_err(a, b)
            n_checked += got[0].numel()
    log(f"runs ok on {len(K2_CASES)} adversarial inputs x cutoffs {K2_CUTOFFS} "
        f"({n_checked} runs emitted in all)")


def lookup_adversarial() -> None:
    """K8 against its plain version on the card, exactly, on every k8_case
    at k = 15, 16 and 31 (int64 keys) and W = 2, 4, 8 and 16 (k = 32, 63,
    127, 255), 100,000 rows where the case is not smaller."""
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import unitig

    dev = torch.device("cuda")
    n_hits = 0
    for k in K8_KS:
        for name in K8_CASES:
            rows, q = k8_case(name, k, 100_000)
            if k <= 31:
                rd = torch.from_numpy(state.words_to_keys(rows)).to(dev)
                qd = torch.from_numpy(state.words_to_keys(q)).to(dev)
            else:
                rd, qd = state.words_to_torch(rows, dev), state.words_to_torch(q, dev)
            hit, rank = unitig.solid_lookup(rd, k, qd)
            hit_p, rank_p = unitig.solid_lookup_plain(rd, k, qd)
            max_abs_err(hit, hit_p)
            max_abs_err(rank, rank_p)
            n_hits += int(hit.sum())
    log(f"solid_lookup ok on {len(K8_CASES)} adversarial runs at k = {K8_KS} "
        f"({n_hits} hits)")


# ---------------------------------------------------------------------------
# phase 3: K22 on adversarial inputs (tests/test_torch_radix_sort_model.py
# runs the same cases through a numpy model of its passes)
# ---------------------------------------------------------------------------

SORT_CASES = ("n0", "n1", "n2", "tile_m1", "tile", "tile_p1", "equal", "top_digit",
              "bottom_digit", "sentinel_tail", "sign", "odd_passes", "even_passes", "dups")
SORT_ROWS_WS = (1, 2, 3, 4, 8, 16)
# the digits each case's keys differ in (None: any number)
SORT_DIGITS = {"equal": (), "top_digit": (7,), "bottom_digit": (0,), "odd_passes": (0, 3, 6),
               "even_passes": (1, 5)}
# the low bits a case's sort is told its keys differ in (radix_sort's bits;
# 64 for the rest): one pass, or 7 and 6 passes over digits that are
# constant among them
SORT_BITS = {"equal": 0, "bottom_digit": 8, "odd_passes": 56, "even_passes": 48}


def sort_case(name: str, tiles: int = 3):
    """(n,) int64 keys of one adversarial K22 input: n = 0, 1, 2 (the two
    descending), one tile - 1, one tile, one tile + 1; else `tiles` tiles
    and 123 keys (the look-back across tiles, a last tile not full): all
    keys equal, keys that differ only in the top digit (the int64 sign
    among it) or only in the bottom one, 62-bit keys with SENTINEL at one
    position in four and a SENTINEL tail (the k <= 31 slab), keys over the
    whole int64 range with INT64_MIN, -1, 0 and INT64_MAX (both sides of the
    sign), keys that differ in digits 0, 3 and 6 (sorted over 56 bits: seven
    passes, the output in the first buffer) or in 1 and 5 (48 bits: six
    passes, in the second), and keys drawn from 300 values (ties, so
    stability shows in a payload)."""
    import zlib

    import numpy as np

    from leon_tpu_torch.ops import count

    tile = count.RADIX_TILE
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    sizes = {"n0": 0, "n1": 1, "n2": 2, "tile_m1": tile - 1, "tile": tile, "tile_p1": tile + 1}
    n = sizes.get(name, tiles * tile + 123)
    u = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    if name == "n2":
        u = np.array([5, 1 << 63 | 3], np.uint64)  # 5, then a negative key
    elif name in SORT_DIGITS:
        base = rng.integers(0, 1 << 64, dtype=np.uint64)
        u = np.full(n, base, np.uint64)
        for d in SORT_DIGITS[name]:
            byte = rng.integers(0, 256, n, dtype=np.uint64)
            u = (u & ~np.uint64(0xFF << (8 * d))) | (byte << np.uint64(8 * d))
    elif name == "sentinel_tail":
        u = rng.integers(0, 1 << 62, n, dtype=np.uint64)
        u[rng.random(n) < 0.25] = (1 << 63) - 1
        u[-1000:] = (1 << 63) - 1
    elif name == "sign":
        u[:4] = np.array([1 << 63, (1 << 64) - 1, 0, (1 << 63) - 1], np.uint64)
        u = u[rng.permutation(n)]
    elif name == "dups":
        u = rng.integers(0, 1 << 64, 300, dtype=np.uint64)[rng.integers(0, 300, n)]
    return u.view(np.int64)


def sort_payload(n: int, seed: int):
    """An (n,) int32 payload for a K22 case, random bits."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)


def sort_rows_case(W: int, n: int, seed: int) -> tuple:
    """(rows (N, W) int32, idx (n,) int64) for K22's row source: top words
    from a few values (ties), the lower ones random; idx picks n of the N =
    n + n // 3 rows in a random order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    N = n + n // 3
    rows = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64)
    tops = rng.integers(0, 1 << 32, (50, min(W, 2)), dtype=np.uint64)
    tops[:4, -1] = (0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)
    rows[:, W - min(W, 2):] = tops[rng.integers(0, 50, N)]
    idx = rng.permutation(N)[:n].astype(np.int64)
    return rows.astype(np.uint32).view(np.int32), idx


# K22's bucket route (K24 radix_bucket, K25 radix_oversize) on adversarial
# inputs (tests/test_torch_radix_bucket_model.py runs the same cases through a
# numpy model of the route at a small capacity): each case at each of
# BUCKET_SORT_BITS, sized from the capacity `cap` (count.BUCKET_CAP on the
# card) so that oversize buckets show
BUCKET_SORT_CASES = ("sentinel_heavy", "one_bucket", "equal", "cap_edges", "half_one_key")
BUCKET_SORT_BITS = (17, 31, 42, 62, 64)


def bucket_case(name: str, bits: int, cap: int, bbits: int = 16):
    """(n,) int64 keys that differ only in their low `bits` bits (a random
    constant above them), for K22's bucket route with buckets (the top
    `bbits` of those bits) of up to `cap` keys sorted in shared memory:
    "sentinel_heavy" the k = 31 slab's shape
    (keys in the lower quarter of the upper half of the used range, the
    largest key, a SENTINEL, at one position in four: one bucket of 1.5 cap
    keys, all equal); "one_bucket" 3 cap + 5 keys in one bucket, not all
    equal (from a pool of values: ties); "equal" 2 cap + 1 equal keys;
    "cap_edges" buckets of cap - 1, cap, cap + 1, 1, 2, cap + 1, cap,
    cap - 1, 3 cap + 5 and 7 keys, shuffled (shares end inside buckets);
    "half_one_key" 4 cap keys, half of them one key."""
    import zlib

    import numpy as np

    rng = np.random.default_rng(zlib.crc32(f"{name}:{bits}".encode()))
    L = bits - bbits
    u64 = np.uint64
    hi = u64(0) if bits == 64 else u64(int(rng.integers(0, 1 << (64 - bits))) << bits)
    top = u64((1 << bits) - 1)

    def low(n, pool):
        vals = rng.integers(0, 1 << 62, pool, dtype=np.uint64) & u64((1 << L) - 1)
        return vals[rng.integers(0, pool, n)]

    if name == "sentinel_heavy":
        n = 6 * cap + 11
        v = u64(1 << (bits - 1)) + rng.integers(0, 1 << (bits - 2), n, dtype=np.uint64)
        v[rng.random(n) < 0.25] = top
    elif name == "one_bucket":
        n = 3 * cap + 5
        v = (u64(int(rng.integers(0, 1 << bbits))) << u64(L)) | low(n, n // 3)
    elif name == "equal":
        v = np.full(2 * cap + 1, rng.integers(0, 1 << 62, dtype=np.uint64) & top, np.uint64)
    elif name == "cap_edges":
        sizes = [cap - 1, cap, cap + 1, 1, 2, cap + 1, cap, cap - 1, 3 * cap + 5, 7]
        b = np.sort(rng.choice(1 << bbits, len(sizes), replace=False)).astype(np.uint64)
        v = np.repeat(b, sizes) << u64(L) | low(sum(sizes), sum(sizes) // 4)
        v = v[rng.permutation(v.size)]
    else:  # half_one_key
        n = 4 * cap
        v = rng.integers(0, 1 << 62, n, dtype=np.uint64) << u64(2) & top
        v[: n // 2] = v[n // 2]
        v = v[rng.permutation(n)]
    return ((hi | v) ^ u64(1 << 63)).view(np.int64)


def bucket_rows(keys, W: int, seed: int) -> tuple:
    """(rows (N, W) int32, idx (n,) int64) whose top 64 bits (row i's words
    W-1 and W-2; word 0 alone at W = 1: the key's low 32 bits) are keys'
    sign-flipped values, the lower words random; idx picks the n keys' rows
    (N = n + n // 3) in a random order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = keys.shape[0]
    N = n + n // 3
    u = keys.view(np.uint64) ^ np.uint64(1 << 63)
    rows = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64)
    idx = rng.permutation(N)[:n].astype(np.int64)
    if W == 1:
        rows[idx, 0] = u & np.uint64(0xFFFFFFFF)
    else:
        rows[idx, W - 1] = u >> np.uint64(32)
        rows[idx, W - 2] = u & np.uint64(0xFFFFFFFF)
    return rows.astype(np.uint32).view(np.int32), idx


def sort_adversarial() -> None:
    """K22 against its plain version, exactly, keys and payload, on every
    sort_case, over 64 bits and over the case's SORT_BITS, by the route
    radix_route picks and again by the passes route named to the wrappers
    (the odd and even numbers of passes at 56 and 48 bits, which the card
    sorts by buckets): keys alone, with sort_payload's int32 payload, with
    their index; the keys also as a non-contiguous view; then the row
    source on sort_rows_case at each W of SORT_ROWS_WS, with and without
    idx."""
    import torch

    from leon_tpu_torch.ops import count

    dev = torch.device("cuda")
    n_keys = 0
    for name in SORT_CASES:
        keys = sort_case(name)
        kc = torch.from_numpy(keys)
        kd = kc.to(dev)
        pc = torch.from_numpy(sort_payload(keys.shape[0], len(name)))
        ic = torch.arange(keys.shape[0])
        for bits in sorted({64, SORT_BITS.get(name, 64)}):
            for route in (None, ("passes", 0)):
                max_abs_err(count.radix_sort(kd, bits=bits, route=route),
                            count.radix_sort_plain(kc))
                for a, b in zip(count.radix_sort(kd, pc.to(dev), bits, route=route),
                                count.radix_sort_plain(kc, pc)):
                    max_abs_err(a, b)
                for a, b in zip(count.radix_sort_index(kd, bits, route=route),
                                count.radix_sort_plain(kc, ic)):
                    max_abs_err(a, b)
        wide = torch.stack([kd, -kd], dim=1)[:, 0]  # every other int64 of its storage
        max_abs_err(count.radix_sort(wide), count.radix_sort_plain(kc))
        n_keys += keys.shape[0]
    for W in SORT_ROWS_WS:
        rows, idx = sort_rows_case(W, 3 * count.RADIX_TILE + 7, W)
        rc, ic = torch.from_numpy(rows), torch.from_numpy(idx)
        rd, id_ = rc.to(dev), ic.to(dev)
        for a, b in zip(count.radix_sort_rows(rd, id_), count.radix_sort_rows(rc, ic)):
            max_abs_err(a, b)
        for a, b in zip(count.radix_sort_rows(rd), count.radix_sort_rows(rc)):
            max_abs_err(a, b)
        max_abs_err(count.radix_sort_rows(rd, id_, index=False),
                    count.radix_sort_rows(rc, ic, index=False))
    log(f"radix_sort ok on {len(SORT_CASES)} adversarial inputs ({n_keys} keys over 64 bits and "
        f"their SORT_BITS, by the card's route and by the passes; alone, with an int32 payload "
        f"and the index, as a strided view) and on rows at W = {SORT_ROWS_WS}")


def bucket_adversarial() -> None:
    """K22's bucket and block routes (K24, K25) against the plain version,
    exactly, keys and payload: every sort_case at 10 tiles and 123 keys (the
    SENTINEL tail's bucket, equal keys and one varying digit past the
    capacity: oversize) over 64 bits and its SORT_BITS, and every
    bucket_case at each of BUCKET_SORT_BITS at the card's capacity: alone,
    with an int32 payload and with the index; read from rows (bucket_rows)
    at each W of SORT_ROWS_WS with and without idx; the case's first
    BUCKET_CAP and 17 keys (the block route). Each by the bucket route
    named to the wrappers (`route`), with buckets of 16 bits and again of 24
    (bucket_case sized for that width), wherever the bucket leaves a bit
    below it: the card takes that route at fewer widths (radix_route), and
    K24 and K25 are held exact at all of them."""
    import torch

    from leon_tpu_torch.ops import count

    dev = torch.device("cuda")
    cap = count.BUCKET_CAP

    def forms(keys, bits: int, seed: int, B: int) -> None:
        route = ("bucket", B) if keys.shape[0] > cap else ("block", 0)
        kc = torch.from_numpy(keys)
        kd = kc.to(dev)
        pc = torch.from_numpy(sort_payload(keys.shape[0], seed))
        max_abs_err(count.radix_sort(kd, bits=bits, route=route), count.radix_sort_plain(kc))
        for a, b in zip(count.radix_sort(kd, pc.to(dev), bits, route=route),
                        count.radix_sort_plain(kc, pc)):
            max_abs_err(a, b)
        for a, b in zip(count.radix_sort_index(kd, bits, route=route),
                        count.radix_sort_plain(kc, torch.arange(keys.shape[0]))):
            max_abs_err(a, b)

    n_keys = 0
    for bb in (count.BUCKET_BITS, count.BUCKET_WIDE_BITS):
        for name in SORT_CASES:
            keys = sort_case(name, 10)
            for bits in sorted({64, SORT_BITS.get(name, 64)}):
                if bb < bits:
                    forms(keys, bits, len(name), bb)
            n_keys += keys.shape[0]
        for name in BUCKET_SORT_CASES:
            for bits in BUCKET_SORT_BITS:
                if bb >= bits:
                    continue
                keys = bucket_case(name, bits, cap, bb)
                forms(keys, bits, bits, bb)
                forms(keys[:cap], bits, bits, bb)
                forms(keys[:17], bits, bits, bb)
                n_keys += keys.shape[0]
                route = ("bucket", bb)
                for W in SORT_ROWS_WS:
                    rows, idx = bucket_rows(keys, W, W)
                    rc, ic = torch.from_numpy(rows), torch.from_numpy(idx)
                    rd, id_ = rc.to(dev), ic.to(dev)
                    for a, b in zip(count.radix_sort_rows(rd, id_, bits=bits, route=route),
                                    count.radix_sort_rows(rc, ic)):
                        max_abs_err(a, b)
                    for a, b in zip(count.radix_sort_rows(rd, route=route),
                                    count.radix_sort_rows(rc)):
                        max_abs_err(a, b)
                    max_abs_err(
                        count.radix_sort_rows(rd, id_[: cap - 1], index=False, bits=bits,
                                              route=("block", 0)),
                        count.radix_sort_rows(rc, ic[: cap - 1], index=False))
    log(f"radix_sort's bucket and block routes ok on {len(SORT_CASES)} sort cases and "
        f"{len(BUCKET_SORT_CASES)} bucket cases at bits = {BUCKET_SORT_BITS}, buckets of 16 and "
        f"24 bits ({n_keys} keys; alone, with an int32 payload and the index; rows at W = "
        f"{SORT_ROWS_WS})")


# ---------------------------------------------------------------------------
# phases 3 and 9: K23 on adversarial runs (tests/test_torch_merge_path.py runs
# the same cases through a numpy model of its blocks and threads)
# ---------------------------------------------------------------------------

MERGE_CASES = ("r2", "r3", "r5", "r9", "sizes", "equal", "same_set", "before", "after",
               "interleaved", "word0", "sign", "max_tail")
# (form, width): int64 keys of k = 15 and 31 (phase 3), (n, W) rows (phase 9)
MERGE_KEYS = (("keys", 15), ("keys", 31))
MERGE_ROWS = tuple(("rows", W) for W in (2, 3, 4, 8, 16))


def merge_case(name: str, form: str, width: int) -> list:
    """One adversarial K23 input: sorted runs [(data, counts (n,) int32),
    ...] as numpy arrays, data int64 keys in signed order (form "keys",
    width = k: keys of 2k bits but in the sign and max_tail cases) or (n, W)
    int32 rows sorted MSW first as u32 words (form "rows", W = width).
    Cases: R = 2, 3, 5 and 9 runs of random sizes drawing from one pool of
    values, so that runs share them ("r2" ... "r9"); runs of 0, 1, one K23
    tile - 1, one tile and one tile + 1 elements ("sizes"); every element of
    every run equal ("equal"); each run the same distinct values
    ("same_set"); each run wholly before the next ("before") or after it
    ("after"); two runs taking alternate values ("interleaved"); values equal
    but in word 0, so rows with equal top 64 bits at W >= 3 ("word0"); both
    sides of the int64 sign and of word W-1's top bit ("sign"); an int64-max
    (all-ones) tail in every run ("max_tail"). The counts are random int32,
    so that an order that is not stable shows."""
    import zlib

    import numpy as np

    from leon_tpu_torch.ops import count

    W = 2 if form == "keys" else width
    tile = count.merge_tile(W)
    rng = np.random.default_rng(zlib.crc32(f"{name}:{form}:{width}".encode()))
    top = 1 << (2 * width) if form == "keys" else 1 << 64

    def rand(n):  # n random elements as (n, W) u32 words, LSW first
        if form == "keys":
            u = rng.integers(0, top, n, dtype=np.uint64)
            return np.stack([u & np.uint64(0xFFFFFFFF), u >> np.uint64(32)], axis=1).astype(
                np.uint32)
        return rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(np.uint32)

    def order(x):  # x's rows sorted as the form orders them
        hi = x[:, W - 1].astype(np.int64)
        if form == "keys":
            hi = hi.astype(np.uint32).view(np.int32).astype(np.int64)  # signed top word
        return x[np.lexsort([x[:, q] for q in range(W - 1)] + [hi])]

    def pick(pool, sizes):  # each run: sizes[i] elements of pool, sorted
        return [order(pool[rng.integers(0, pool.shape[0], n)]) for n in sizes]

    R = {"r2": 2, "r3": 3, "r5": 5, "r9": 9}
    if name in R:
        sizes = rng.integers(0, 3 * tile, R[name])
        sizes[0] = 2 * tile + 77
        runs = pick(rand(3000), sizes)
    elif name == "sizes":
        runs = pick(rand(5000), (0, 1, tile - 1, tile, tile + 1, 1, 0))
    elif name == "equal":
        one = rand(1)
        runs = [np.repeat(one, n, axis=0) for n in (tile + 5, 2 * tile + 3, 7, tile)]
    elif name == "same_set":
        pool = np.unique(rand(2 * tile + 11), axis=0)
        runs = [order(pool)] * 3
    elif name in ("before", "after"):
        pool = order(rand(4 * tile + 40))
        cuts = (0, 2 * tile + 1, 3 * tile + 8, pool.shape[0])
        runs = [pool[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        runs = runs if name == "before" else runs[::-1]
    elif name == "interleaved":
        pool = order(rand(4 * tile + 3))
        runs = [pool[0::2], pool[1::2]]
    elif name == "word0":
        pool = np.repeat(rand(1), 60, axis=0)
        pool[:, 0] = rng.integers(0, 1 << 32, 60, dtype=np.uint64).astype(np.uint32)
        runs = pick(pool, (tile + 9, 2 * tile, 3, tile - 1))
    elif name == "sign":
        pool = rng.integers(0, 1 << 32, (800, W), dtype=np.uint64).astype(np.uint32)
        pool[:400, W - 1] = np.resize(np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                                               np.uint32), 400)
        pool[:4] = 0  # INT64_MIN, -1, 0, INT64_MAX (as keys) among them
        pool[0, W - 1], pool[1], pool[3] = 0x80000000, 0xFFFFFFFF, 0xFFFFFFFF
        pool[3, W - 1] = 0x7FFFFFFF
        runs = pick(pool, (2 * tile + 1, tile, 17))
    else:  # max_tail
        runs = []
        for n, m in ((2 * tile, 3), (tile + 1, tile + 2), (5, 1)):
            x = np.full((n + m, W), 0xFFFFFFFF, np.uint32)
            x[:n] = rand(n)
            if form == "keys":
                x[:, 1] &= 0x7FFFFFFF  # INT64_MAX is the largest key
            runs.append(order(x))
    out = []
    for x in runs:
        c = rng.integers(-(1 << 31), 1 << 31, x.shape[0], dtype=np.int64).astype(np.int32)
        data = x.view(np.int64)[:, 0] if form == "keys" else x.view(np.int32)
        out.append((np.ascontiguousarray(data), c))
    return out


def merge_adversarial(forms: tuple) -> None:
    """K23 against its plain version, exactly, on every merge_case at each
    (form, width) of forms; each run a view at an offset of 0-2 elements into
    its buffer and its counts at 0-3 (so that every phase of a 16-byte chunk
    starts a run)."""
    import torch

    from leon_tpu_torch.ops import count

    dev = torch.device("cuda")
    n_el = 0
    for form, width in forms:
        merge = count.merge_path if form == "keys" else count.merge_path_rows
        for name in MERGE_CASES:
            runs = merge_case(name, form, width)
            on_card = []
            for i, (x, c) in enumerate(runs):
                xd = torch.from_numpy(x).to(dev)
                cd = torch.from_numpy(c).to(dev)
                xb = torch.empty((x.shape[0] + 2,) + x.shape[1:], dtype=xd.dtype, device=dev)
                cb = torch.empty(c.shape[0] + 3, dtype=cd.dtype, device=dev)
                xv, cv = xb[i % 3 : i % 3 + x.shape[0]], cb[i % 4 : i % 4 + c.shape[0]]
                xv.copy_(xd)
                cv.copy_(cd)
                on_card.append((xv, cv))
            want = count.merge_path_plain([(torch.from_numpy(x), torch.from_numpy(c))
                                           for x, c in runs])
            for a, b in zip(merge(on_card), want):
                max_abs_err(a, b)
            n_el += want[1].shape[0]
    log(f"merge_path ok on {len(MERGE_CASES)} adversarial cases at {forms} ({n_el} elements)")


# ---------------------------------------------------------------------------
# phase 3: K6 and K3 on adversarial inputs (tests/test_torch_rank_model.py
# and tests/test_torch_bloom_table.py hold models of both kernels and the
# plain versions to leon_tpu's on the same generators)
# ---------------------------------------------------------------------------

RANK_CASES = ("chain_pow2m1", "chain_pow2", "chain_pow2p1", "chain_unsampled", "chain_sampled",
              "singletons", "self_twin", "shared_succ", "cycles_free", "cycles_ruled", "mixed")
RANK_CYCLES = (1, 2, 3, 4, 5, 8)  # cycle lengths of the cycles_* cases
RANK_RLOGS = (0, 2, -1)  # ruler samplings: every node, one in 4, only where orbits end


def rank_sampled(ids, rlog: int):
    """K6's ruler sampling of node ids (csrc/unitig.cu rk_sampled): a u32
    multiplicative hash whose top rlog bits are zero (rlog 0: every node,
    -1: none)."""
    import numpy as np

    ids = np.asarray(ids, np.int64)
    if rlog < 0:
        return np.zeros(ids.shape, bool)
    if rlog == 0:
        return np.ones(ids.shape, bool)
    m = 0xFFFFFFFF
    h = (ids * 0x9E3779B1) & m
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    return (h >> (32 - rlog)) == 0


def rank_case(name: str, rlog: int, t: int = 6, scale: int = 1):
    """(nxt, prev) (N,) int32 of one adversarial K6 input, as K5 links them
    (prev[s] = the largest d with nxt[d] = s), node ids shuffled: one chain
    of 2^t - 1, 2^t or 2^t + 1 nodes (beside a short one); a chain of 2^t
    nodes none of which is sampled at rlog (its head the one ruler), and
    one of 2^(t-2) nodes all sampled (every node a ruler); 1,000 * scale
    singletons; a self-twin chain (nodes c_0..c_m then their twins c_m ^ 1
    .. c_0 ^ 1, as a unitig adjacent to its own reverse complement); two
    chains that share one successor (the even-k palindrome); cycles of
    RANK_CYCLES nodes with no node sampled as a ruler at rlog, or with one;
    and all of these mixed with tails that run into cycles. The
    chain_*sampled and cycles_* cases take their ids by rank_sampled at
    rlog."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)) * 131 + 7 * t + scale)
    edges = []
    n_single = 1000 * scale  # at least: every id no structure takes is a singleton
    N = 4 * (1 << t) + 2 * n_single + 16384 * scale + 4096
    used = np.zeros(N, bool)
    perm = rng.permutation(N)
    smp = rank_sampled(perm, rlog)
    order = {None: iter(perm), True: iter(perm[smp]), False: iter(perm[~smp]),
             "pair": iter(rng.permutation(N // 2))}

    def draw(key):
        for x in order[key]:
            if key == "pair":
                if not used[2 * x] and not used[2 * x + 1]:
                    used[2 * x] = used[2 * x + 1] = True
                    return int(x)
            elif not used[x]:
                used[x] = True
                return int(x)
        return None

    def take(n: int, n_sampled: int = -1):
        """n unused ids; n_sampled of them sampled at rlog where rlog allows
        (at rlog 0 every id is sampled, at -1 none)."""
        if n_sampled < 0 or rlog <= 0:
            return [draw(None) for _ in range(n)]
        out = [draw(True) for _ in range(n_sampled)] + [draw(False) for _ in range(n - n_sampled)]
        rng.shuffle(out)
        return out

    def chain(ids, close=False):
        edges.extend(zip(ids[:-1], ids[1:]))
        if close:
            edges.append((ids[-1], ids[0]))

    def self_twin(m: int):
        fwd = [2 * draw("pair") for _ in range(m)]
        chain(fwd + [d ^ 1 for d in reversed(fwd)])

    def shared(la: int, lb: int, ls: int, into_cycle: bool = False):
        a, b, c = take(la), take(lb), take(ls)
        chain(a)
        chain(b)
        chain(c, close=into_cycle)
        edges.append((a[-1], c[0]))
        edges.append((b[-1], c[0]))

    if name.startswith("chain_pow2"):
        n = (1 << t) + {"chain_pow2m1": -1, "chain_pow2": 0, "chain_pow2p1": 1}[name]
        chain(take(n))
        chain(take(3))
    elif name == "chain_unsampled":
        chain(take(1 << t, 0))
    elif name == "chain_sampled":
        n = 1 << (t - 2)
        chain(take(n, n))
    elif name == "singletons":
        pass
    elif name == "self_twin":
        for m in (1, 2, 5, 33):
            self_twin(m)
    elif name == "shared_succ":
        shared(1, 1, 1)
        shared(3, 2, 9)
        shared(7, 1, 1 << t)
    elif name.startswith("cycles"):
        for L in RANK_CYCLES:
            for _ in range(2):
                chain(take(L, 1 if name == "cycles_ruled" else 0), close=True)
    elif name == "mixed":
        for L in rng.integers(1, 300, 40 * scale):
            chain(take(int(L)))
        for L in RANK_CYCLES + (37, 300):
            chain(take(L, 0), close=True)
            chain(take(L, 1), close=True)
        for _ in range(3):
            shared(int(rng.integers(1, 40)), int(rng.integers(1, 40)),
                   int(rng.integers(2, 60)), into_cycle=True)
            shared(int(rng.integers(1, 40)), int(rng.integers(1, 40)), int(rng.integers(1, 60)))
        for m in (1, 4, 30):
            self_twin(m)
        chain(take(1 << t))
    else:
        raise KeyError(name)
    nxt = np.full(N, -1, np.int64)
    prev = np.full(N, -1, np.int64)
    if edges:
        e = np.array(edges, np.int64)
        nxt[e[:, 0]] = e[:, 1]
        np.maximum.at(prev, e[:, 1], e[:, 0])
    return nxt.astype(np.int32), prev.astype(np.int32)


def rank_adversarial() -> None:
    """K6 against its plain version on the card, exactly, in every mode
    (and chain_rank's two variants) on every rank_case at chains of 2^16
    +-1 nodes among 0.5-0.9M, ids placed by K6's own ruler sampling."""
    import torch

    from leon_tpu_torch.ops import unitig

    dev = torch.device("cuda")
    n_runs = 0
    for name in RANK_CASES:
        nxt_np, prev_np = rank_case(name, unitig.RULER_LOG2, t=16, scale=32)
        nxt, prev = torch.from_numpy(nxt_np).to(dev), torch.from_numpy(prev_np).to(dev)
        for mode in (unitig.ACYCLIC, unitig.FULL, unitig.RANK):
            max_abs_err(unitig.unitig_rank(nxt, prev, mode),
                        unitig.unitig_rank_plain(nxt, prev, mode))
            n_runs += 1
        for acyclic in (True, False):
            for a, b in zip(unitig.chain_rank(nxt, prev, acyclic),
                            unitig.chain_rank_plain(nxt, prev, acyclic)):
                max_abs_err(a, b)
    log(f"unitig_rank ok on {len(RANK_CASES)} adversarial graphs ({n_runs} rankings, and "
        f"chain_rank both ways)")


K3_KS = (1, 2, 15, 16, 17, 31)
K3_KEEP = ("none", "all", "fifth")


def k3_case(k: int, keep: str, M: int):
    """(keys (M,) int64 sorted distinct k-mers, counts (M,) int32, cutoff)
    for K3: random keys of 2k bits (all 4^k at k <= 8 where M is larger),
    the all-zero and the top key among them; the cutoff keeps no row, every
    row, or one in five."""
    import numpy as np

    rng = np.random.default_rng(31 * k + len(keep) + M)
    top = (1 << (2 * k)) - 1
    if top < 4 * M:
        keys = np.arange(min(M, top + 1), dtype=np.int64)
    else:
        keys = np.unique(np.concatenate([[0, top], rng.integers(0, top, M, dtype=np.int64)]))
        keys = keys[:M]
    counts = rng.integers(1, 5, keys.size).astype(np.int32)
    if keep == "fifth":
        counts[:] = 1
        counts[rng.random(keys.size) < 0.2] = 7
        cutoff = 5
    else:
        cutoff = 100 if keep == "none" else 1
    return keys, counts, cutoff


def k3_adversarial() -> None:
    """K3 against its plain version on the card, exactly, at K3_KS with
    cutoffs that keep no row, every row and one in five, H = 1..8: 3,001
    rows (no multiple of a warp's 128) into 64 words (hot words) and into
    4,099; a view one row in (unaligned: the scalar loads); M = 0, 1."""
    import torch

    from leon_tpu_torch.ops import bloom

    dev = torch.device("cuda")
    n_builds = 0
    for k in K3_KS:
        for keep in K3_KEEP:
            keys_np, counts_np, cutoff = k3_case(k, keep, 3001)
            keys = torch.from_numpy(keys_np).to(dev)
            counts = torch.from_numpy(counts_np).to(dev)
            for h in range(1, 9):
                for nw, lo in ((64, 0), (4099, 0), (4099, 1)):
                    kk, cc = keys[lo:], counts[lo:]
                    max_abs_err(bloom.bloom_build(kk, cc, cutoff, nw, h, SEED, k),
                                bloom.bloom_build_plain(kk, cc, cutoff, nw, h, SEED, k))
                    n_builds += 1
            for m in (0, 1):
                max_abs_err(bloom.bloom_build(keys[:m], counts[:m], 1, 64, 4, SEED, k),
                            bloom.bloom_build_plain(keys[:m], counts[:m], 1, 64, 4, SEED, k))
    log(f"bloom_build ok on adversarial runs at k = {K3_KS}, cutoffs keeping {K3_KEEP} "
        f"({n_builds} builds, and M = 0, 1)")


# ---------------------------------------------------------------------------
# phase 3: K5 and K7 on adversarial runs (tests/test_torch_links_emit_model.py
# holds numpy models of both kernels, and the plain versions to leon_tpu's,
# on the same generators)
# ---------------------------------------------------------------------------

# every width's shortest and longest k (W = 2..16; k <= 255) beside the key route's
K5_KS = tuple(dict.fromkeys((1, 2, 15, 16, 17, 31) + tuple(
    k for W in range(2, 17) for k in (16 * W - 15, min(16 * W, 255)))))
K5_CASES = ("chains", "one_bucket", "single", "self_twin", "palindromes")
K7_CASES = ("chains", "cycles", "cycles_full", "self_twin", "palindromes", "cap_at", "cap_over",
            "cap_bases_cut")


def canon_rows(seqs, k: int):
    """The sorted distinct canonical k-mers of sequences of base codes, in
    the device build's form: (M,) int64 keys at k <= 31, else (M, W) u32
    words."""
    import numpy as np

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import kmer, unitig

    out = []
    for s in seqs:
        s = np.asarray(s, np.uint8)
        if s.size >= k:
            win = s[np.arange(s.size - k + 1)[:, None] + np.arange(k)]
            f = kmer.pack_codes_batch_np(win, k)
            r = kmer.pack_codes_batch_np((3 - win)[:, ::-1], k)
            out.append(np.where(unitig._np_lex_less(r, f)[:, None], r, f))
    w = unitig.sort_rows_bigint(np.concatenate(out))
    w = w[np.concatenate(([True], (w[1:] != w[:-1]).any(axis=1)))]
    return state.words_to_keys(w) if k <= 31 else np.ascontiguousarray(w)


def k5_case(name: str, k: int, scale: int = 1):
    """One adversarial K5 run at k (canon_rows' form): chains of 1, 2,
    2^t - 1, 2^t and 2^t + 1 k-mers (t = 3 and 6, or 16 at scale > 1) and
    isolated k-mers; rows that all start with k - min(6, k/2) A bases (one
    bucket of the prefix table: the searches take log2 M rounds), chains
    among them; one row; self-twin chains (a sequence, then its reverse
    complement; A^m T^m A^m); palindromic k-mers with 14-base flanks (at
    even k their two nodes share successors)."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)) * 1009 + 7 * k + scale)

    def rnd(n):
        return rng.integers(0, 4, n, dtype=np.uint8)

    def rc(a):
        return (3 - a)[::-1]

    if name == "chains":
        seqs = [rnd(n + k - 1) for t in (3, 16 if scale > 1 else 6)
                for n in (1, 2, (1 << t) - 1, 1 << t, (1 << t) + 1)]
        seqs += [rnd(k) for _ in range(50 * scale)]
    elif name == "one_bucket":
        h = k - min(6, k // 2)
        seqs = [np.concatenate([np.zeros(h + int(n), np.uint8), rnd(k - h)])
                for n in rng.integers(0, max(1, h), 40 * scale)]
        seqs += [np.concatenate([np.zeros(h, np.uint8), rnd(k - h)]) for _ in range(100 * scale)]
    elif name == "single":
        seqs = [rnd(k)]
    elif name == "self_twin":
        m = k // 2 + 5
        seqs = [np.concatenate([a, rc(a)]) for a in (rnd(max(2 * k, 40)) for _ in range(scale))]
        seqs.append(np.concatenate([np.zeros(m, np.uint8), np.full(m, 3, np.uint8),
                                    np.zeros(m, np.uint8)]))
    elif name == "palindromes":
        seqs = [np.concatenate([rnd(14), a, rc(a), rnd(14)])
                for a in (rnd(k // 2) for _ in range(8 * scale))]
        seqs.append(np.concatenate([rnd(14), np.zeros(k // 2 + 2, np.uint8),
                                    np.full(k // 2 + 2, 3, np.uint8), rnd(14)]))
    else:
        raise KeyError(name)
    return canon_rows(seqs, k)


def k7_case(name: str, k: int, scale: int = 1, device: str = "cpu") -> dict:
    """One adversarial K7 input at k, on `device`: the run, K5's and K6's
    plain outputs (nxt, prev, S of chain_rank_plain, optimistic or full as
    `acyclic` says) and the capacities: k5_case's chains, self-twin chains
    and palindromes; circular contigs of 1, 2, 5, 40 and 201 k-mers beside
    a linear one (the optimistic ranking flags them; "cycles_full" the full
    variant); the chain capacity at the chain count and one below it
    (overflow); the base capacity cut inside the last chain's prefix."""
    import numpy as np
    import torch

    from leon_tpu_torch.ops import unitig

    rng = np.random.default_rng(sum(map(ord, name)) * 31 + k + scale)
    if name.startswith("cycles"):
        seqs = []
        for n in (1, 2, 5, 40, 201):
            c = rng.integers(0, 4, n, dtype=np.uint8)
            seqs.append(np.tile(c, -(-(n + k + 4) // n))[: n + k + 4])
        seqs.append(rng.integers(0, 4, 300 * scale + k, dtype=np.uint8))
        rows = canon_rows(seqs, k)
    else:
        rows = k5_case({"cap_at": "chains", "cap_over": "chains",
                        "cap_bases_cut": "chains"}.get(name, name), k, scale)
    run = torch.from_numpy(rows.view(np.int32) if rows.ndim == 2 else rows).to(device)
    acyclic = name != "cycles_full"
    nxt, prev = unitig.unitig_links_plain(run, k)
    nxt, prev, S = unitig.chain_rank_plain(nxt, prev, acyclic)
    M = run.shape[0]
    cap = unitig.chains_cap(M)
    cap_bases = unitig._caps(M, k, cap)
    if name.startswith("cap"):
        buf = unitig.unitig_emit_plain(run, k, nxt, prev, S, cap, cap_bases, acyclic)
        n = int(buf[0])
        lens = buf[4 : 4 + n].to(torch.int64)
        if name == "cap_at":
            cap = n
        elif name == "cap_over":
            cap = max(1, n - 1)
        else:
            last = int((lens + k - 1).sum() - (lens[-1] + k - 1))
            cap_bases = max(16, (last + (k - 1) // 2) // 16 * 16)
        cap_bases = cap_bases if name == "cap_bases_cut" else unitig._caps(M, k, cap)
    return dict(run=run, k=k, nxt=nxt, prev=prev, S=S, cap=cap, cap_bases=cap_bases,
                acyclic=acyclic)


def k5_adversarial(scale: int = 2) -> None:
    """K5 against its plain version on the card, exactly, on every k5_case
    at K5_KS."""
    import torch

    from leon_tpu_torch.ops import unitig

    dev = torch.device("cuda")
    n = 0
    for k in K5_KS:
        for name in K5_CASES:
            rows = k5_case(name, k, scale)
            run = torch.from_numpy(rows.view("int32") if rows.ndim == 2 else rows).to(dev)
            for a, b in zip(unitig.unitig_links(run, k), unitig.unitig_links_plain(run, k)):
                max_abs_err(a, b)
            n += 1
    log(f"unitig_links ok on {n} adversarial runs ({len(K5_CASES)} cases at k = {K5_KS})")


def k7_adversarial() -> None:
    """K7 against its plain version on the card, exactly, on every k7_case
    at K5_KS (its K5 and K6 inputs from their plain versions on the card);
    the chains and palindromes again with 64-bit collision keys (which the
    wrapper takes where 2M + (k-1) cap reaches EMIT_KEY32_LIMIT)."""
    from leon_tpu_torch.ops import unitig

    n = 0
    limit = unitig.EMIT_KEY32_LIMIT
    for k in K5_KS:
        for name in K7_CASES:
            c = k7_case(name, k, device="cuda")
            args = [c["run"], k, c["nxt"], c["prev"], c["S"], c["cap"], c["cap_bases"],
                    c["acyclic"]]
            want = unitig.unitig_emit_plain(*args)
            max_abs_err(unitig.unitig_emit(*args), want)
            n += 1
            if name in ("chains", "palindromes"):
                try:
                    unitig.EMIT_KEY32_LIMIT = 0
                    max_abs_err(unitig.unitig_emit(*args), want)
                finally:
                    unitig.EMIT_KEY32_LIMIT = limit
                n += 1
    log(f"unitig_emit ok on {n} adversarial inputs ({len(K7_CASES)} cases at k = {K5_KS}, "
        f"chains and palindromes with 32- and 64-bit keys)")


# ---------------------------------------------------------------------------
# phase 9: K14 and K17 on adversarial inputs (tests/test_torch_runs_lookup.py
# and tests/test_torch_scan_bits.py hold models of both kernels and the plain
# versions to leon_tpu's on the same generators)
# ---------------------------------------------------------------------------

K14_CASES = ("n0", "n1", "n2", "n2_distinct", "one_run", "distinct", "hot", "wrap",
             "boundary0", "boundary1", "boundary2", "boundary3", "short", "ones")
K14_CUTOFFS = (1, 2, 255, 256)
K14_WIDTHS = (4, 8, 16)


def _word_rows(lengths, W: int, rng):
    """(n, W) u32 rows sorted MSW first: run i has lengths[i] copies of a
    row that differs from the row before it in one word only (a random
    word, raised by 1-3), so neighbouring runs differ in one int64 plane."""
    import numpy as np

    lengths = np.asarray(lengths, np.int64)
    m = lengths.size
    word = rng.integers(0, W, m)
    inc = rng.integers(1, 4, m).astype(np.int64)
    base = rng.integers(0, 1 << 31, W).astype(np.int64)
    rows = np.stack([base[c] + np.cumsum(np.where(word == c, inc, 0)) for c in range(W)], axis=1)
    return np.repeat(rows.astype(np.uint32), lengths, axis=0)


def k14_case(name: str, W: int, tile: int, hot: int = 1 << 20):
    """(rows (n, W) u32 sorted MSW first, counts (n,) int32 or None) of one
    adversarial K14 input, whose runs sit on edges `tile` rows apart (K14's
    steps; on the card also edges between warps and blocks): n = 0, 1, 2;
    one run over every row (`hot` rows, crossing steps, stretches and
    blocks); every row distinct; one run of `hot` rows between short runs;
    run sums that wrap u32, pass 2^31 - 1 or wrap to exactly 0; runs of 1-3
    rows at every offset of an edge (boundary0-3, 96 edges); short runs
    with zero counts; all-ones top words (k = 16W) and the all-ones row
    last. Neighbouring runs differ in one word."""
    import numpy as np

    rng = np.random.default_rng(sum(map(ord, name)) * 7919 + tile * 31 + W)

    def counts_of(rows, lo, hi):
        return rng.integers(lo, hi, rows.shape[0]).astype(np.int32)

    if name == "n0":
        return np.zeros((0, W), np.uint32), None
    if name == "n1":
        return _word_rows([1], W, rng), None
    if name == "n2":
        return _word_rows([2], W, rng), None
    if name == "n2_distinct":
        return _word_rows([1, 1], W, rng), np.array([3, 0], np.int32)
    if name == "one_run":
        rows = _word_rows([hot], W, rng)
        return rows, counts_of(rows, 1, 3)
    if name == "distinct":
        rows = _word_rows(np.ones(3 * tile + 11, np.int64), W, rng)
        return rows, counts_of(rows, 1, 400)
    if name == "hot":
        lengths = np.concatenate([rng.integers(1, 4, 3 * tile // 2), [hot],
                                  rng.integers(1, 4, tile)])
        rows = _word_rows(lengths, W, rng)
        return rows, counts_of(rows, 0, 4)
    if name == "wrap":
        lengths = rng.integers(1, 6, 3 * tile)
        rows = _word_rows(lengths, W, rng)
        counts = counts_of(rows, 0, 3)
        heads = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        for h, ln in zip(heads[::7], lengths[::7]):
            counts[h : h + ln] = 0x7FFFFFF0  # past 2^31 - 1 from 2 rows, past 2^32 from 3
        for h, ln in zip(heads[3::11], lengths[3::11]):
            if ln >= 2:  # two rows of 2^31 (as u32): the sum wraps to 0 and drops
                counts[h : h + ln] = 0
                counts[h : h + 2] = -(1 << 31)
        return rows, counts
    if name.startswith("boundary"):
        lengths = ([1] * int(name[len("boundary"):])) + _edge_lengths(tile, 96, rng)
        rows = _word_rows(lengths, W, rng)
        return rows, counts_of(rows, 1, 5)
    if name == "short":
        rows = _word_rows(rng.integers(1, 4, 4 * tile), W, rng)
        return rows, counts_of(rows, 0, 5)
    if name == "ones":
        lengths = rng.integers(1, 4, 2 * tile)
        rows = _word_rows(lengths, W, rng)
        heads = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        rows[heads[2 * lengths.size // 3] :, W - 1] = 0xFFFFFFFF
        rows[heads[-1] :] = 0xFFFFFFFF  # the all-ones row, last
        return rows, counts_of(rows, 1, 5)
    raise KeyError(name)


def words_adversarial() -> None:
    """K14 against its plain version on the card, exactly, on every
    k14_case at W = 4, 8 and 16: word_runs with the counts at cutoffs 1, 2,
    255 and 256 with the histogram, word_runs' and runs_words' run
    lengths."""
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import count

    dev = torch.device("cuda")
    n_checked = 0
    for W in K14_WIDTHS:
        for name in K14_CASES:
            rows, counts = k14_case(name, W, count._word_runs_step(W))
            planes = state.words_to_planes(state.words_to_torch(rows, dev))
            cd = None if counts is None else torch.from_numpy(counts).to(dev)
            pairs = [(count.word_runs(planes, W), count.word_runs_plain(planes, W)),
                     (count.runs_words(planes, W), count.runs_words_plain(planes, W))]
            if cd is not None:
                pairs += [(count.word_runs(planes, W, cd, c, True),
                           count.word_runs_plain(planes, W, cd, c, True)) for c in K14_CUTOFFS]
            for got, want in pairs:
                for a, b in zip(got, want):
                    if a is not None or b is not None:
                        max_abs_err(a, b)
                n_checked += got[0].shape[0]
    log(f"word_runs, runs_words ok on {len(K14_CASES)} adversarial inputs at W = {K14_WIDTHS} x "
        f"cutoffs {K14_CUTOFFS} ({n_checked} runs emitted in all)")


SCAN_KS = (17, 31, 32, 33, 63, 64, 65, 127, 128, 255)
SCAN_L_MOD16 = (0, 1, 15)
# K1's k (k <= 31): W = 1 at both ends, the word edge, and the largest k
K1_KS = (1, 2, 15, 16, 17, 31)


def scan_case(k: int, mod: int, n_random: int):
    """(codes (B, L) uint8, lengths (B,) int32) of one adversarial scan
    input: L = 16 m + mod with room for a few k-mers; reads of length 0,
    k - 1, k, L and L - 1 (zeros past each read), at k = 16W a read that is
    its own reverse complement and one whose canonical k-mers have an
    all-ones top word (T^16 ... A^16), then n_random random reads of
    random lengths."""
    import numpy as np

    rng = np.random.default_rng(k * 100 + mod)
    L = 16 * -(-(k + 21) // 16) + mod
    B = 8 + n_random
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = np.concatenate([[0, k - 1, k, L, L - 1, L, L, L],
                              rng.integers(0, L + 1, n_random)]).astype(np.int32)
    if k % 16 == 0:
        half = codes[5, : k // 2]
        codes[5, :k] = np.concatenate([half, (3 - half)[::-1]])  # a palindrome
        codes[6, :16] = 3
        codes[6, k - 16 : k] = 0  # T^16 ... A^16: the top word all-ones both ways
        codes[7, :k] = 3
        codes[7, k // 2 : k] = 0  # T^(k/2) A^(k/2): a palindrome, top word all-ones
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return codes, lengths


def scan_adversarial() -> None:
    """K17 against its plain version on the card, exactly, on every
    scan_case (k = 17 .. 255, L mod 16 = 0, 1, 15), 4,096 random reads
    beside the edge reads."""
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import kmer

    dev = torch.device("cuda")
    n_rows = 0
    for k in SCAN_KS:
        for mod in SCAN_L_MOD16:
            codes, lengths = scan_case(k, mod, 4096)
            L = codes.shape[1]
            pd = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
            ld = torch.from_numpy(lengths).to(dev)
            got = kmer.kmer_scan_halves(pd, ld, k, L)
            for a, b in zip(got, kmer.kmer_scan_halves_plain(pd, ld, k, L)):
                max_abs_err(a, b)
            n_rows += got[0].numel()
    log(f"kmer_scan_halves ok on adversarial reads at k = {SCAN_KS}, L mod 16 = "
        f"{SCAN_L_MOD16} ({n_rows} valid k-mers)")


def k1_adversarial() -> None:
    """K1 against its plain version on the card, exactly, on every scan_case
    at K1_KS (k = 1 .. 31, L mod 16 = 0, 1, 15), 4,096 random reads beside
    the edge reads, written through `out=` into a slab view one key past
    an allocation's start (the key before it must stay as it was)."""
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import kmer

    dev = torch.device("cuda")
    n_keys = 0
    for k in K1_KS:
        for mod in SCAN_L_MOD16:
            codes, lengths = scan_case(k, mod, 4096)
            L = codes.shape[1]
            pd = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
            ld = torch.from_numpy(lengths).to(dev)
            n = codes.shape[0] * (L - k + 1)
            buf = torch.full((n + 1,), -7, dtype=torch.int64, device=dev)
            kmer.kmer_scan(pd, ld, k, L, out=buf[1:])
            max_abs_err(buf[1:], kmer.kmer_scan_plain(pd, ld, k, L))
            max_abs_err(buf[:1], torch.full((1,), -7, dtype=torch.int64))
            n_keys += n
    log(f"kmer_scan ok on adversarial reads at k = {K1_KS}, L mod 16 = {SCAN_L_MOD16} "
        f"({n_keys} keys)")


WALK_KS = SCAN_KS
WALK_L_MOD16 = SCAN_L_MOD16
# (k, L) of long rows: the default max_device_len (a chunk holding a read
# over 1,024 bp), at W = 4 and, one column past it, at W = 16
WALK_LONG = ((63, 2048), (255, 2049))


def walk_case(k: int, mod: int, n_random: int, L: int = 0):
    """(codes (B, L) uint8, lengths (B,) int32, bitset (n_words,) u32,
    n_words, H) of one adversarial walk input: L = 16 m + mod > 2k + 24 (or
    the L given: a long row, WALK_LONG), so a side can walk past the
    anchor's k bases; a contig with a (k-1)-base
    repeat whose two copies differ in the bases before and after it (true
    bifurcations on both sides), its k-mers in a lean filter (6 bits a
    k-mer: false-positive bifurcations), H = 1..8 by (k, mod); reads of
    length 0, k - 1, k, k + 1 and L; longer than L (L + 7, 2L: the row holds
    L columns); a contig k-mer then random bases (the anchor at 0, an all-
    error right side) and the mirror (the anchor at len - k); a random read
    (unanchored, or all errors); reads across each repeat copy; a read with
    20% errors (errors within the first k steps of both sides); a
    homopolymer; error-free contig reads anchored at 0 and at len - k (their
    first, last k-mer has the smallest min(f, r), where the contig has such
    reads); then n_random contig
    reads of random length (0..L+20) and strand with 3% substitutions."""
    import numpy as np

    from leon_tpu_torch.ops import bloom, kmer

    rng = np.random.default_rng(k * 1000 + mod + 11)
    L = L or 16 * -(-(2 * k + 24) // 16) + mod
    H = 1 + (k + mod) % 8
    contig = rng.integers(0, 4, 3 * L + 400, dtype=np.uint8)
    rep = rng.integers(0, 4, k - 1, dtype=np.uint8)
    a1 = L // 2 + 100
    a2 = a1 + L + 150
    for a, before, after in ((a1, 0, 1), (a2, 2, 3)):
        contig[a - 1], contig[a : a + k - 1], contig[a + k - 1] = before, rep, after

    def mutate(r, rate):
        mut = rng.random(r.size) < rate
        r[mut] = (r[mut] + rng.integers(1, 4, int(mut.sum()))) & 3
        return r

    def take(start, n, rc=False):
        r = contig[start : start + n].copy()
        return (3 - r)[::-1].copy() if rc else r

    rows = [(np.zeros(0, np.uint8), 0), (take(5, k - 1), k - 1), (take(9, k), k),
            (take(13, k + 1), k + 1), (mutate(take(17, L), 0.03), L),
            (take(21, L), L + 7), (mutate(take(25, L, True), 0.03), 2 * L),
            (np.concatenate([take(29, k), rng.integers(0, 4, L - k, dtype=np.uint8)]), L),
            (np.concatenate([rng.integers(0, 4, L - k, dtype=np.uint8), take(33, k)]), L),
            (rng.integers(0, 4, L, dtype=np.uint8), L),
            (take(a1 - L // 2, L), L), (take(a2 - L // 2, L, True), L),
            (take(a1 - 3, L), L - 5), (take(a2 + k - L + 3, L, True), L),
            (mutate(take(37, L), 0.2), L), (np.full(L, 1, np.uint8), L)]
    # error-free contig reads whose smallest min(f, r) is their first k-mer
    # (the anchor at 0) and their last (the anchor at len - k)
    # (at k < 17, where few k-mers exist, a contig may have neither)
    win = np.lib.stride_tricks.sliding_window_view(contig, k)
    f, r = bloom.hash_words(kmer.pack_codes_batch_np(win, k), k, SEED)
    v = np.minimum(f, r)
    after = np.lib.stride_tricks.sliding_window_view(v[1:], L - k).min(axis=1)
    first = np.flatnonzero(v[: after.size] < after)[:1]
    before = np.lib.stride_tricks.sliding_window_view(v, L - k).min(axis=1)
    last = np.flatnonzero(v[L - k :] < before[: v.size - L + k])[:1]
    rows += [(take(int(i), L), L) for i in np.concatenate([first, last])]
    for _ in range(n_random):
        n = int(rng.integers(0, L + 21))
        r = mutate(take(int(rng.integers(0, contig.size - L)), L, bool(rng.integers(0, 2))), 0.03)
        rows.append((r, n))
    codes = np.zeros((len(rows), L), np.uint8)
    lengths = np.array([n for _, n in rows], np.int32)
    for i, (r, n) in enumerate(rows):
        codes[i, : min(n, L)] = r[: min(n, L)]
    solid, _ = kmer.kmer_words_batch_np(win, np.zeros(win.shape[0], np.int64), k)
    solid = np.unique(solid, axis=0)
    n_words = bloom.choose_n_words(solid.shape[0], 6.0)
    return codes, lengths, bloom.build_np(solid, n_words, H, SEED, k), n_words, H


def decode_inputs(enc: dict, codes, lengths, k: int, decodable=None) -> tuple:
    """K19's inputs from an encoded batch (unpack_compact's dict) as numpy
    arrays: scal (B, 9+W) int32 with each anchored read's forward anchor
    words (from its codes: the host's dictionary lookup), errgaps int32,
    errnts and bifs uint8. Reads outside `decodable` (default: all) go in
    as unanchored; the streams keep their events."""
    import numpy as np

    from leon_tpu_torch.ops import kmer

    nb = codes.shape[0]
    W = kmer.words_for_k(k)
    canon, orient = kmer.kmer_words_batch_np(codes, enc["apos"].astype(np.int64), k)
    afwd = np.where(orient[:, None], kmer.revcomp_words_batch_np(canon, k), canon)
    anch = enc["anchored"] & (True if decodable is None else decodable)
    et = enc["nerr_r"] + enc["nerr_l"]
    bt = enc["nbif_r"] + enc["nbif_l"]
    scal = np.zeros((nb, 9 + W), np.int32)
    scal[:, 0] = enc["apos"]
    scal[:, 1] = anch
    scal[:, 2] = np.where(anch, lengths, 0)
    scal[:, 3], scal[:, 4] = enc["nerr_r"], enc["nerr_l"]
    scal[:, 5], scal[:, 6] = enc["nbif_r"], enc["nbif_l"]
    scal[:, 7] = np.cumsum(et) - et
    scal[:, 8] = np.cumsum(bt) - bt
    scal[:, 9:] = afwd.view(np.int32)
    return (scal, enc["errgap_flat"].astype(np.int32), enc["errnt_flat"].astype(np.uint8),
            enc["bif_flat"].astype(np.uint8))


def walk_adversarial() -> None:
    """K18 (with and without the confirmed bits) and K19 (on what K18
    encoded; reads longer than L go in unanchored) against their plain
    versions on the card, exactly, on every walk_case (k = 17 .. 255, W = 2
    .. 16, L mod 16 = 0, 1, 15; and the long rows of WALK_LONG, with the
    confirmed bits only: their plain versions take a minute), 4,096 random
    reads beside the edge reads; every anchored read of length <= L decodes
    to itself."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import kmer, walk

    dev = torch.device("cuda")
    n_steps = 0
    cases = [(k, mod, 0) for k in WALK_KS for mod in WALK_L_MOD16]
    for k, mod, long_l in cases + [(k, 0, L) for k, L in WALK_LONG]:
        codes, lengths, bitset, nw, h = walk_case(k, mod, 4096, long_l)
        B_, L = codes.shape
        pd = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
        ld = torch.from_numpy(lengths).to(dev)
        bd = state.bitset_to_torch(bitset, dev)
        for conf in (True, False)[: 1 if long_l else 2]:
            e_d = walk.walk_encode_words(pd, ld, bd, nw, k, h, SEED, L, conf)
            e_p = walk.walk_encode_plain(pd, ld, bd, nw, k, h, SEED, L, conf)
            for n in ("meta", "tot", "conf"):
                max_abs_err(e_d[n], e_p[n])
            tot = e_p["tot"].to(torch.int64)
            for n, row in (("ev_gap", 0), ("ev_nt", 0), ("ev_bif", 1)):
                valid = torch.arange(L - k, device=dev)[None, :] < tot[row][:, None]
                max_abs_err(e_d[n].to(torch.int64)[valid], e_p[n].to(torch.int64)[valid])
        incl = torch.cumsum(e_d["tot"], dim=1)
        ce, cb = (-(-int(incl[i, -1]) // 8) * 8 for i in (0, 1))
        buf = walk.walk_pack(e_d, incl, L, k, ce, cb, False).cpu().numpy()
        enc = walk.unpack_compact(buf.view(np.uint16), B_, B_, L, ce, cb, False, k)
        dec_np = decode_inputs(enc, codes, lengths, k, lengths <= L)
        dec_in = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in dec_np)
        d_d = walk.walk_decode_words(*dec_in, bd, nw, k, h, SEED, L)
        max_abs_err(d_d, walk.walk_decode_plain(*dec_in, bd, nw, k, h, SEED, L))
        back = walk.unpack_codes_u32_np(d_d.cpu().numpy().view(np.uint32), L)
        rows = np.flatnonzero(dec_np[0][:, 1])
        inside = np.arange(L)[None, :] < lengths[rows, None]
        if not ((back[rows] == codes[rows]) | ~inside).all():
            raise AssertionError(f"walk_case k={k} mod={mod}: decode did not restore reads")
        n_steps += int(torch.clamp(ld.to(torch.int64) - k, 0, L - k)[e_d["meta"][:, 0] > 0]
                       .sum())
    log(f"walk_encode_words, walk_decode_words ok on adversarial reads at k = {WALK_KS}, "
        f"L mod 16 = {WALK_L_MOD16} and (k, L) = {WALK_LONG} ({n_steps} walk steps)")


# K16's k: for every W = 1..16 the pad edges of its table hash (16W - 15,
# 16W - 1 and 16W code-0 bases cancelled: 15, 1, none; k <= 255)
BLOOM_KS = tuple(k for W in range(1, 17) for k in (16 * W - 15, 16 * W - 1, 16 * W)
                 if k <= 255)


def bloom_adversarial() -> None:
    """K16 against its plain version on the card, exactly, at every k of
    BLOOM_KS and H = 1..8: 4,096 random rows with garbage above 2k in the
    top word (the all-zero and the all-ones row among them), every row
    valid into 64 words (64 rows a word: hot words) and a sparse valid (a
    row in five) into 4,099 of 4,160 allocated words (the rest must stay
    zero); and S = 0."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom

    dev = torch.device("cuda")
    n_builds = 0
    for k in BLOOM_KS:
        W = -(-k // 16)
        rng = np.random.default_rng(k)
        rows = rng.integers(0, 1 << 32, (4096, W), dtype=np.uint64).astype(np.uint32)
        rows[0], rows[1] = 0, 0xFFFFFFFF
        words = state.words_to_torch(rows, dev)
        ones = torch.ones(4096, dtype=torch.bool, device=dev)
        sparse = torch.from_numpy(rng.random(4096) < 0.2).to(dev)
        for h in range(1, 9):
            for valid, n_alloc, nw in ((ones, 64, 64), (sparse, 4160, 4099)):
                got = bloom.bloom_build_words(words, valid, n_alloc, nw, h, SEED, k)
                max_abs_err(got, bloom.bloom_build_words_plain(words, valid, n_alloc, nw, h,
                                                               SEED, k))
                if got[nw:].any():
                    raise AssertionError(f"bloom_build_words k={k}: words past n_words set")
                n_builds += 1
        empty = words[:0]
        max_abs_err(bloom.bloom_build_words(empty, ones[:0], 64, 64, 4, SEED, k),
                    torch.zeros(64, dtype=torch.int32))
    log(f"bloom_build_words ok on adversarial rows at {len(BLOOM_KS)} k (W = 1..16, "
        f"k = 16W - 15, 16W - 1, 16W <= 255) x H = 1..8 ({n_builds} builds, and S = 0)")


# ---------------------------------------------------------------------------
# phases 3-4: the unitig kernels K5-K8 against their plain versions
# ---------------------------------------------------------------------------


def unitig_checks(records: dict, rows, counts, cutoff: int, nu: int, label: str,
                  k: int = K, names: tuple = DEVICE_BUILD) -> dict:
    """K5-K8 on a sorted solid run (rows, counts) on the card against their
    plain versions on the same tensors, exact; the device payload against
    the native host builder's. rows are (M,) int64 keys at k <= 31, else
    (M, W) int32 words (the multiword route's solid rows). Fills
    records[name] for `names` (K5, K6, K7, K8: ms, plain_ms, max_abs_err)
    and returns the build's figures."""
    import numpy as np
    import torch

    from leon_tpu_torch import kernels, state
    from leon_tpu_torch.ops import unitig

    n_links, n_double, n_emit, n_lookup = names
    M = rows.shape[0]
    words_form = rows.dim() == 2
    tag = f"{label}, k={k}" + (f", W={rows.shape[1]}" if words_form else "")

    # K5
    nxt, prev = unitig.unitig_links(rows, k)
    want = unitig.unitig_links_plain(rows, k)
    records[n_links] = record(
        max(max_abs_err(nxt, want[0].cpu()), max_abs_err(prev, want[1].cpu())),
        cuda_ms(lambda: unitig.unitig_links(rows, k), 5),
        cuda_ms(lambda: unitig.unitig_links_plain(rows, k), 1), nbytes(rows, nxt, prev),
        bound_note=LINKS_BOUND_NOTE)
    log(f"[{tag}] unitig_links ok: {M} solid rows, {int((nxt >= 0).sum())} internal edges")

    # K6: one pass in every mode, then both chain_rank variants; the record
    # times the whole optimistic ranking (one pass: its bound reads nxt and
    # prev and writes S once)
    err = 0
    for mode in (unitig.ACYCLIC, unitig.FULL, unitig.RANK):
        err = max(err, max_abs_err(unitig.unitig_rank(nxt, prev, mode),
                                   unitig.unitig_rank_plain(nxt, prev, mode)))
    ranked = {}
    for acyclic in (True, False):
        got = unitig.chain_rank(nxt, prev, acyclic)
        exp = unitig.chain_rank_plain(nxt, prev, acyclic)
        err = max(err, *(max_abs_err(a, b.cpu()) for a, b in zip(got, exp)))
        ranked[acyclic] = got
    records[n_double] = record(
        err, cuda_ms(lambda: unitig.chain_rank(nxt, prev, True), 10),
        cuda_ms(lambda: unitig.chain_rank_plain(nxt, prev, True), 2),
        nbytes(nxt, prev, ranked[True][2]))
    full_ms = cuda_ms(lambda: unitig.chain_rank(nxt, prev, False), 5)
    log(f"[{tag}] unitig_rank ok: chain_rank {records[n_double]['ms']:.4f} ms, "
        f"the full variant {full_ms:.4f} ms ({2 * M} nodes)")

    # K7 on both rankings; then the whole build (dispatch + drain) and the
    # plain build on the card
    cap = unitig.chains_cap(nu)
    cb = unitig._caps(M, k, cap)
    err = 0
    for acyclic, (n2, p2, S) in ranked.items():
        got = unitig.unitig_emit(rows, k, n2, p2, S, cap, cb, acyclic)
        exp = unitig.unitig_emit_plain(rows, k, n2, p2, S, cap, cb, acyclic)
        err = max(err, max_abs_err(got, exp.cpu()))
    n2, p2, S = ranked[True]
    records[n_emit] = record(
        err, cuda_ms(lambda: unitig.unitig_emit(rows, k, n2, p2, S, cap, cb, True), 5),
        cuda_ms(lambda: unitig.unitig_emit_plain(rows, k, n2, p2, S, cap, cb, True), 1),
        nbytes(rows, n2, p2, S, unitig.unitig_emit(rows, k, n2, p2, S, cap, cb, True)))

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    t = time.time()
    infl = unitig.dispatch_build(rows, k, nu)
    cyc = int(infl.buf[2])
    payload = unitig.drain_build(infl)
    torch.cuda.synchronize()
    t_kernel = time.time() - t
    peak = torch.cuda.max_memory_allocated()
    build_launches = {n: kernels.launches[n] - before.get(n, 0)
                      for n in ("unitig_links", "unitig_emit")}
    if build_launches["unitig_links"] != 1:
        raise AssertionError(f"[{tag}] a device build launched K5 {build_launches['unitig_links']} "
                             f"times (cycles flagged {cyc}): its rebuilds must reuse the links")
    t = time.time()
    plain_bufs = [unitig.build_plain(rows, k, cap, cb, a) for a in (True, False)]
    torch.cuda.synchronize()
    t_plain = time.time() - t
    kernel_bufs = [unitig.build(rows, k, cap, cb, a) for a in (True, False)]
    for a, b in zip(kernel_bufs, plain_bufs):
        max_abs_err(a, b.cpu())
    if payload is None:
        raise AssertionError(f"[{tag}] the device build gave no payload")
    words = (rows.cpu().numpy().view(np.uint32) if words_form
             else state.keys_from_torch(rows, 2))
    t = time.time()
    host = unitig.build_np_payload(words, counts.cpu().numpy(), cutoff, k, nu)
    t_host = time.time() - t
    if payload != host:
        raise AssertionError(f"[{tag}] device payload differs from the native host builder's")
    n_chains = unitig.parse_payload(payload, k)[0].size
    log(f"[{tag}] unitig_emit ok; build: {n_chains} chains, cycles flagged {cyc}, "
        f"payload {len(payload)} B = the native host builder's; dispatch_build + "
        f"drain_build {t_kernel * 1e3:.2f} ms (host clock, first call), launches "
        f"{build_launches}")

    # K8: solid rows, and rows that are not in the run (low bits flipped)
    rng = np.random.default_rng(8)
    q = rows[torch.from_numpy(rng.integers(0, M, 100_000)).to(rows.device)]
    if words_form:
        miss = q.clone()
        miss[:, 0] ^= 0x155
    else:
        miss = (q ^ 0x155) & ((1 << (2 * k)) - 1)
    q = torch.cat([q, miss])
    hit, rank = unitig.solid_lookup(rows, k, q)
    hit_p, rank_p = unitig.solid_lookup_plain(rows, k, q)
    records[n_lookup] = record(
        max(max_abs_err(hit, hit_p.cpu()), max_abs_err(rank, rank_p.cpu())),
        cuda_ms(lambda: unitig.solid_lookup(rows, k, q), 10),
        cuda_ms(lambda: unitig.solid_lookup_plain(rows, k, q), 3),
        nbytes(q, hit, rank) + q.shape[0] * rows[0].numel() * rows.element_size(),
        None if words_form else cuda_ms(lambda: torch.searchsorted(rows, q), 10),
        "the queries, hit, rank and one row of the run per query (a search reads no more)")
    log(f"[{tag}] solid_lookup ok: {int(hit.sum())}/{q.shape[0]} hits")
    return dict(n_solid=M, n_distinct=nu, n_chains=n_chains, cycles_flagged=cyc,
                payload_bytes=len(payload), build_s=t_kernel, plain_build_s=t_plain,
                host_build_s=t_host, peak_device_bytes=peak, build_launches=build_launches)


def yeast_solid() -> tuple:
    """A yeast-sized genome made on the card from a seeded generator: linear
    contigs of 14.2 Mbp in all and two circular plasmids (48 and 6.3 kbp).
    Each contig (a circular one extended by its first k-1 bases) is cut
    into windows of 128 bp at a stride of 128 - (k-1), so every k-mer lies
    in exactly one window; two copies of the windows give every genomic
    k-mer a count of at least 2. K1 + sort + K2 count them. Returns the
    solid keys and counts, the cutoff, the distinct count and the genome's
    size, contig counts and windows."""
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

    keys = count.radix_sort(kmer.kmer_scan(packed, ln, K, Lw))
    uk, uc, _ = count.runs(keys)
    del keys, packed
    cutoff = 2
    sk, sc = count.compact_solid(uk, uc, cutoff)
    return sk, sc, cutoff, uk.numel(), (total, len(linear), len(circular), 2 * B)


def yeast_phase() -> dict:
    """yeast_solid's run; K5-K8 are then held against their plain
    versions."""
    sk, sc, cutoff, nu, (total, n_lin, n_circ, n_win) = yeast_solid()
    log(f"[yeast] genome {total} bp in {n_lin} linear + {n_circ} circular contigs, "
        f"{n_win} windows -> {nu} distinct, {sk.numel()} solid k-mers")
    records: dict = {}
    fig = unitig_checks(records, sk, sc, cutoff, nu, "yeast")
    if not fig["cycles_flagged"]:
        raise AssertionError("[yeast] the optimistic build did not flag the plasmid cycles")
    if fig["build_launches"] != {"unitig_links": 1, "unitig_emit": 2}:
        raise AssertionError(f"[yeast] the build's K5, K7 launches {fig['build_launches']} != "
                             "1, 2 (the full variant's rebuild reuses K5's links)")
    fig["genome_bp"] = total
    fig["kernels"] = records
    return fig


# ---------------------------------------------------------------------------
# phase 7: the graph API (K9-K12) at full width
# ---------------------------------------------------------------------------

GRAPH_WALK_STEPS = 100
GRAPH_TRAVERSE_LANES, GRAPH_TRAVERSE_STEPS = 65536, 16
GATHER_M, GATHER_TABLE_MB = 1 << 24, (1, 2, 8)  # scripts/probe_pallas_gather.py:95-103


def gather_inputs(dev) -> dict:
    """The Pallas probe script's inputs: 2**24 random indices into u32
    tables of 1, 2 and 8 MB (scripts/probe_pallas_gather.py:94-103)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    idx_host = rng.integers(0, 1 << 30, GATHER_M, dtype=np.uint32)
    out = {}
    for mb in GATHER_TABLE_MB:
        n = (mb << 20) // 4
        table = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
        idx = (idx_host % np.uint32(n)).astype(np.int32)
        out[mb] = (torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev))
    return out


# K9's adversarial indices (k9_case): every M mod 4 and every 16-byte phase
# of the index view (an unaligned view), indices from -3n to 3n with the
# edges -n - 1, -n, -1, 0, n - 1 and n (a negative index counts from the
# end, then indices clamp into [0, n)), on tables of 1 and 257 words and
# the three of GATHER_TABLE_MB
K9_MS = (0, 1, 2, 3, 4, 5, 6, 7, 1021, 4096, 65539)
K9_OFFS = (0, 1, 2, 3)
K9_SMALL_N = (1, 257)


def k9_case(n: int, M: int, seed: int):
    """(table (n,) int32 holding u32 bits, base (M + 3,) int32): one K9
    input is idx = base[off : off + M] for an offset off of K9_OFFS."""
    import numpy as np

    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    base = rng.integers(-3 * n, 3 * n + 1, M + 3).astype(np.int32)
    edges = np.array([-n - 1, -n, -1, 0, n - 1, n], np.int64)
    pick = rng.random(M + 3) < 0.25
    base[pick] = edges[rng.integers(0, edges.size, int(pick.sum()))]
    return table, base


def k9_adversarial(gin: dict) -> None:
    """K9 against its plain version on the card, exactly, on k9_case at every
    (M, offset) of K9_MS x K9_OFFS over the small tables and the three of
    gather_inputs, and on those tables' 2**24 indices as an unaligned view of
    2**24 - 1."""
    import torch

    from leon_tpu_torch.ops import gather

    dev = torch.device("cuda")
    tables = [torch.from_numpy(k9_case(n, 0, n)[0]).to(dev) for n in K9_SMALL_N]
    tables += [gin[mb][0] for mb in GATHER_TABLE_MB]
    for t, table in enumerate(tables):
        n = table.numel()
        for M in K9_MS:
            base = torch.from_numpy(k9_case(n, M, 100 * t + M)[1]).to(dev)
            for off in K9_OFFS:
                idx = base[off : off + M]
                max_abs_err(gather.gather_words(table, idx), gather.gather_words_plain(table, idx))
    for mb in GATHER_TABLE_MB:
        table, idx = gin[mb]
        max_abs_err(gather.gather_words(table, idx[1:]), gather.gather_words_plain(table, idx[1:]))
    log(f"gather_words ok on M = {K9_MS} at offsets {K9_OFFS}, tables of {K9_SMALL_N} words "
        f"and {GATHER_TABLE_MB} MB, and 2**24 - 1 unaligned indices")


# K10 on dirty words (every bit random, so bits 2k..2k+1 shift into base 0
# of a shr2_ins neighbour where 2k < 32W) at each width's edges, N below,
# at and above a 256-thread block; K12 on graphs of SNP bubbles and tips
K10_KS = (1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 127, 128, 254, 255)
K10_NS = (1, 255, 257)
# (k, S, D, N, H): cap = S(D + 2) = 35 (no multiple of 16), N below one
# block, D = k (a SNP's branches meet after k + 1 steps: at the last depth,
# D - 1), D = k - 1 (they never meet: the lane stops), D = k + 1 (the
# default), D = 1, N no multiple of any block size; H = 1..8 (K12 loads a
# probe's hashes after the first in groups)
K12_CASES = ((15, 7, 3, 300, 8), (15, 4, 15, 5, 4), (31, 5, 31, 1000, 4), (31, 5, 30, 257, 5),
             (31, 5, 32, 300, 4), (33, 6, 1, 257, 1), (63, 3, 63, 300, 3), (127, 3, 5, 257, 2),
             (255, 2, 3, 33, 7))


def k10_case(k: int, N: int, H: int) -> tuple:
    """(words (N, W) u32 with every bit random, classic bitset, blocked
    bitset, n_words) for K10: each bitset (H hashes, 16 bits a k-mer and 7
    words more, so that n_words is no multiple of 64) holds one in two of
    the rows and of their 4 shl2 and 4 shr2_ins neighbours as the
    reference's steps make them from the dirty words, so members,
    non-members and false positives mix."""
    import numpy as np
    import torch

    from leon_tpu_torch.ops import bloom, kmer

    rng = np.random.default_rng(1000 * k + N)
    W = kmer.words_for_k(k)
    words = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64).astype(np.uint32)
    w64 = torch.from_numpy(words.astype(np.int64))
    cand = torch.cat([w64] + [step(w64, c, k) for step in (kmer.shl2, kmer.shr2_ins)
                              for c in range(4)]).numpy().astype(np.uint32)
    solid = cand[rng.random(cand.shape[0]) < 0.5]
    solid[:, -1] &= np.uint32(kmer.top_mask(k))
    nw = bloom.choose_n_words(solid.shape[0], 16.0) + 7
    return (words, bloom.build_np_classic(solid, nw, H, SEED, k),
            bloom.build_np(solid, nw, H, SEED, k), nw)


def k10_adversarial() -> None:
    """K10 against its plain version on the card, exactly: k10_case at every
    k of K10_KS and N of K10_NS (H = 1, 4, 8 by N), each mode (self, out,
    in), classic and blocked addressing; the words also as an unaligned
    view (one word into a buffer: the scalar row loads)."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom

    dev = torch.device("cuda")
    n = 0
    for k in K10_KS:
        for N, H in zip(K10_NS, (1, 4, 8)):
            words_np, classic_np, blocked_np, nw = k10_case(k, N, H)
            words = state.words_to_torch(words_np, dev)
            flat = torch.zeros(words.numel() + 1, dtype=torch.int32, device=dev)
            flat[1:] = words.reshape(-1)
            views = (words, flat[1:].view(words.shape))
            for q in views if N == K10_NS[-1] else views[:1]:
                for classic, bits_np in ((True, classic_np), (False, blocked_np)):
                    bits = torch.from_numpy(bits_np.view(np.int32)).to(dev)
                    for mode in ("self", "out", "in"):
                        a = (bits, q, mode, classic, H, nw, SEED, k)
                        max_abs_err(bloom.dbg_probe(*a), bloom.dbg_probe_plain(*a))
                        n += 1
    log(f"dbg_probe ok on dirty words at k = {K10_KS}, N = {K10_NS}, every mode, classic "
        f"and blocked ({n} calls)")


def k12_case(k: int, S: int, D: int, N: int, H: int) -> tuple:
    """(starts (N, W) u32, bitset u32, n_words) for K12: the forward
    k-mers of a random contig, of SNP variants of it (a bubble whose branches
    meet after k + 1 steps, at depth k - 1) and of tips (a branch of 1..k/2
    bases off it that ends), spaced 3k + 3 apart, in a classic bitset (H
    hashes, 64 bits a k-mer, so that a false positive seldom ends a branch
    early); lanes start before each SNP and tip, on random contig k-mers,
    on the contig's last k-mer (no successor) and on random words (most
    stop at step 0)."""
    import numpy as np

    from leon_tpu_torch.ops import bloom, kmer

    rng = np.random.default_rng(7 * k + 131 * S + D + N)
    gap, n_feat = 3 * k + 3, 8
    G = gap * (n_feat + 2)
    contig = rng.integers(0, 4, G).astype(np.uint8)
    seqs, starts = [contig], []
    for j in range(n_feat):
        p = gap * (j + 1)
        alt = contig[p - k : p + k + 1].copy()
        alt[k] = (alt[k] + rng.integers(1, 4)) & 3
        if j % 2 == 0:  # a SNP: the two paths meet again after k + 1 steps
            seqs.append(alt)
        else:  # a tip: 1..k/2 bases off the contig, then nothing
            seqs.append(alt[: k + 1 + int(rng.integers(0, max(1, k // 2)))])
        starts.append(contig[p - k : p])
    for q in rng.integers(0, G - k, 8):
        starts.append(contig[q : q + k])
    starts.append(contig[G - k :])
    kmers = np.concatenate([np.lib.stride_tricks.sliding_window_view(s, k) for s in seqs])
    solid = np.unique(kmer.pack_codes_batch_np(kmers, k), axis=0)
    nw = bloom.choose_n_words(solid.shape[0], 64.0)  # few false positives
    W = kmer.words_for_k(k)
    lanes = kmer.pack_codes_batch_np(np.stack(starts), k)
    rnd = rng.integers(0, 1 << 32, (4, W), dtype=np.uint64).astype(np.uint32)
    lanes = np.concatenate([lanes, rnd])
    # a SNP's, a tip's, a contig k-mer's, the last k-mer's and a random
    # word's lane first (every case has them), then the rest in seeded order
    first = [0, 1, n_feat, n_feat + 8, n_feat + 9]
    rest = rng.permutation(np.resize(np.arange(lanes.shape[0]), max(0, N - len(first))))
    return (lanes[np.concatenate([first, rest]).astype(np.int64)[:N]],
            bloom.build_np_classic(solid, nw, H, SEED, k), nw)


def k12_adversarial() -> None:
    """K12 against its plain version on the card, exactly (bases and n), on
    k12_case at every (k, S, D, N, H) of K12_CASES."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.graph import dbg_traverse, dbg_traverse_plain

    dev = torch.device("cuda")
    for k, S, D, N, H in K12_CASES:
        lanes, bits_np, nw = k12_case(k, S, D, N, H)
        a = (torch.from_numpy(bits_np.view(np.int32)).to(dev), state.words_to_torch(lanes, dev),
             H, nw, SEED, k, S, D)
        (gb, gn), (pb, pn) = dbg_traverse(*a), dbg_traverse_plain(*a)
        max_abs_err(gb, pb)
        max_abs_err(gn, pn)
    log(f"dbg_traverse ok on bubbles and tips at (k, S, D, N, H) = {K12_CASES}")


# K11 on walks through SNP bubbles, tips and false positives from dirty
# start words; K15 on walk_case's reads (K18's edge reads) down to k = 1,
# where the leaving base may lie in the word a side is building, and at
# k = 5, where both sides' first words may be one. Phase 7 runs the cases at
# k <= 64, phase 8 K15's at k <= 64, phase 10 the rest.
K11_KS = (1, 15, 16, 17, 31, 32, 33, 63, 64, 127, 128, 255)
K11_NS = (61, 257)
K15_KS = (1, 5) + K11_KS[1:]


def k11_case(k: int, N: int) -> tuple:
    """(starts (N, W) u32, classic bitset u32, n_words, H, S) for K11: S =
    2k + 40 steps (a walk past k steps wraps its ring); a random contig of
    3S + 6k + 6 bases whose forward k-mers, with SNP variants of it every
    2k + 2 bases in its middle third (true bifurcations), fill a classic
    bitset: at N < 256 of 16 bits a k-mer with H = 1..3 hashes (many false
    positives: walks stop at spurious branches), else of 24 bits with H =
    4..8 (most walks run long); lanes start on contig k-mers, S - 1 steps
    before the contig's end (a lane that stops at step S - 1 unless a false
    positive stops it first), on its last k-mer and on random words (stops
    at step 0) and before each SNP; every start carries random bits above
    2k in its top word (shl2 masks them, the hash reads k bases)."""
    import numpy as np

    from leon_tpu_torch.ops import bloom, kmer

    rng = np.random.default_rng(11 * k + N)
    S = 2 * k + 40
    H, bits_per_kmer = (1 + k % 3, 16.0) if N < 256 else (4 + k % 5, 24.0)
    G = 3 * S + 6 * k + 6
    contig = rng.integers(0, 4, G).astype(np.uint8)
    seqs, snps = [contig], list(range(G // 3, 2 * G // 3 - k, 2 * k + 2))
    for p in snps:
        alt = contig[p - k + 1 : p + k].copy()
        alt[k - 1] = (alt[k - 1] + rng.integers(1, 4)) & 3
        seqs.append(alt)
    kmers = np.concatenate([np.lib.stride_tricks.sliding_window_view(q, k) for q in seqs])
    solid = np.unique(kmer.pack_codes_batch_np(kmers, k), axis=0)
    nw = bloom.choose_n_words(solid.shape[0], bits_per_kmer)
    pos = np.concatenate([[G - k - (S - 1), G - k], np.array(snps) - k - 3,
                          rng.integers(0, G - k, max(0, N - len(snps) - 6))])
    pos = np.clip(pos, 0, G - k)
    starts = kmer.pack_codes_batch_np(contig[pos[:, None] + np.arange(k)], k)
    W = kmer.words_for_k(k)
    rnd = rng.integers(0, 1 << 32, (4, W), dtype=np.uint64).astype(np.uint32)
    lanes = np.concatenate([starts, rnd])[:N]
    dirty = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    lanes[:, -1] |= dirty & ~np.uint32(kmer.top_mask(k))
    return lanes, bloom.build_np_classic(solid, nw, H, SEED, k), nw, H, S


def k11_adversarial(ks: tuple) -> None:
    """K11 against its plain version on the card, exactly (bases and n), on
    k11_case at each k of ks and N of K11_NS, the starts also as an
    unaligned view (one word into a buffer)."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.graph import dbg_walk, dbg_walk_plain

    dev = torch.device("cuda")
    for k in ks:
        for N in K11_NS:
            lanes, bits_np, nw, h, S = k11_case(k, N)
            words = state.words_to_torch(lanes, dev)
            flat = torch.zeros(words.numel() + 1, dtype=torch.int32, device=dev)
            flat[1:] = words.reshape(-1)
            bits = torch.from_numpy(bits_np.view(np.int32)).to(dev)
            for q in (words, flat[1:].view(words.shape)):
                a = (bits, q, h, nw, SEED, k, S)
                (gb, gn), (pb, pn) = dbg_walk(*a), dbg_walk_plain(*a)
                max_abs_err(gb, pb)
                max_abs_err(gn, pn)
    log(f"dbg_walk ok on bubbles, false positives and dirty starts at k = {ks}, N = {K11_NS}")


def k15_case(k: int, mod: int, n_random: int):
    """K15's adversarial reads: walk_case (k = 1..255)."""
    return walk_case(k, mod, n_random)


def k15_adversarial(ks: tuple) -> None:
    """K15 against its plain version on the card, exactly (all 15 outputs),
    on k15_case at each k of ks and L mod 16 = 0, 1, 15, 1,024 random reads
    beside the edge reads, the codes also as an unaligned view."""
    import numpy as np
    import torch

    from leon_tpu_torch.ops import walk

    dev = torch.device("cuda")
    for k in ks:
        for mod in WALK_L_MOD16:
            codes_np, lengths_np, bits_np, nw, h = k15_case(k, mod, 1024)
            codes = torch.from_numpy(codes_np).to(dev)
            flat = torch.zeros(codes.numel() + 1, dtype=torch.uint8, device=dev)
            flat[1:] = codes.reshape(-1)
            a = (torch.from_numpy(lengths_np).to(dev),
                 torch.from_numpy(bits_np.view(np.int32)).to(dev), k, h, nw, SEED)
            want = walk.encode_batch_plain(codes, *a)
            for c in (codes, flat[1:].view(codes.shape)) if mod == 1 else (codes,):
                got = walk.encode_batch(c, *a)
                for n in want:
                    max_abs_err(got[n], want[n])
    log(f"walk_dense ok on edge reads at k = {ks}, L mod 16 = {WALK_L_MOD16}")


# K13's adversarial reads (k13_case): bytes above 3 where each reach of them
# shows; phase 8 runs the k <= 64, phase 10 the rest; K13_LONG's rows hold
# more positions than one job of K13_POS (csrc/kmer.cu) at both ends of the
# widths.
K13_KS = (1, 5, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 255)
K13_L_MOD16 = (0, 1, 15)
K13_LONG = ((31, 2100), (255, 2351))
K13_DIRTY = (4, 7, 0x80, 0xFC, 0xFF)  # code bytes above 3


def k13_case(k: int, mod: int, n_random: int, L: int = 0):
    """(codes (B, L) uint8, lengths (B,) int32) of one adversarial K13
    input: L = 16 m + mod >= k + 40 (or the L given); reads of length 0, k -
    1, k and L; a byte above 3 (from K13_DIRTY) at column 0, at the last
    column, past a read's end (length k + 2, the byte at column k + 6), alone
    at column 20 (so windows start 1 .. 20 columns after it: its rc bits
    reach 16W - k positions past the last window that holds it), at every
    other column, and a read of only 0xFF; at even k a palindrome; then
    n_random random reads of random lengths (the bytes past a read's end
    left random), one in four with 1-3 bytes above 3 at random columns."""
    import numpy as np

    rng = np.random.default_rng(13 * k + mod + L)
    L = L or 16 * -(-(k + 40) // 16) + mod
    B = 10 + n_random
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = np.concatenate([[0, k - 1, k, L, L, L, k + 2, L, L, L],
                              rng.integers(0, L + 1, n_random)]).astype(np.int32)
    d = [K13_DIRTY[(k + i) % len(K13_DIRTY)] for i in range(5)]
    codes[4, 0], codes[5, L - 1], codes[6, k + 6], codes[7, 20] = d[:4]
    codes[8, ::2] = d[4]
    codes[9] = 0xFF
    if k % 2 == 0:
        half = codes[3, : k // 2]
        codes[3, k // 2 : k] = (3 - half)[::-1]
    for r in np.flatnonzero(rng.random(n_random) < 0.25) + 10:
        cols = rng.integers(0, L, rng.integers(1, 4))
        codes[r, cols] = rng.integers(4, 256, cols.size)
    return codes, lengths


def k13_adversarial(ks: tuple) -> None:
    """K13 against its plain version on the card, exactly (canon, is_rc,
    valid), on k13_case at each k of ks and L mod 16 = 0, 1, 15 (1,024
    random reads beside the edge reads; at L mod 16 = 1 the codes also as an
    unaligned view), and on K13_LONG's rows at the k of ks."""
    import torch

    from leon_tpu_torch.ops import kmer

    dev = torch.device("cuda")
    cases = [(k, mod, 1024, 0) for k in ks for mod in K13_L_MOD16]
    cases += [(k, 1, 16, L) for k, L in K13_LONG if k in ks]
    for k, mod, nr, L in cases:
        codes_np, lengths_np = k13_case(k, mod, nr, L)
        codes = torch.from_numpy(codes_np).to(dev)
        lengths = torch.from_numpy(lengths_np).to(dev)
        flat = torch.zeros(codes.numel() + 1, dtype=torch.uint8, device=dev)
        flat[1:] = codes.reshape(-1)
        want = kmer.kmer_scan_words_plain(codes, lengths, k)
        for c in (codes, flat[1:].view(codes.shape)) if mod == 1 else (codes,):
            for a, b in zip(kmer.kmer_scan_words(c, lengths, k), want):
                max_abs_err(a, b)
    log(f"kmer_scan_words ok on dirty and edge reads at k = {ks}, L mod 16 = {K13_L_MOD16}, "
        f"long rows {[c for c in K13_LONG if c[0] in ks]}")


# K20's adversarial rows (tie_case): runs of equal top 64 bits across the
# kernel's warp (32 rows) and block (1,024) limits and past them
TIE_WS = (3, 4, 8, 16)
TIE_RUNS = (1, 2, 31, 32, 33, 1024, 1025, 65536)
TIE_EQUAL = (2, 32, 1024, 2000)  # runs of equal rows
TIE_EDGES = (0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)  # u32 words around the int64 sign flip


def tie_case(W: int, every: bool = False):
    """(canon (B, P, W) int32 holding u32 words, valid (B, P) bool) of one
    adversarial K20 input: runs of TIE_RUNS rows with equal top words W-1
    and W-2, and runs of TIE_EQUAL equal rows (or, with `every`, one run of
    70,000 rows); a run's rows are drawn from a pool of distinct rows whose
    lower words are TIE_EDGES or random, half of them equal to the first but
    for word 0, the first ones' word 0 each of TIE_EDGES; top words from
    TIE_EDGES too (each of them in turn for the first eight runs); no row is all ones (the
    reference ties that row with its invalid marker, ROADMAP queue 3); the
    rows shuffled into 64 positions a read, one position in 8 invalid
    (random words)."""
    import numpy as np

    rng = np.random.default_rng(2000 + W + 100 * every)
    edges = np.array(TIE_EDGES, np.uint64)

    def words(n):
        w = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64)
        pick = rng.random((n, W)) < 0.5
        w[pick] = edges[rng.integers(0, len(edges), int(pick.sum()))]
        return w

    runs = []
    sizes = [(70_000, False)] if every else [(n, False) for n in TIE_RUNS] + [
        (n, True) for n in TIE_EQUAL]
    second = rng.choice(1 << 32, len(sizes), replace=False)  # word W-2: a top key a run
    for size, equal in sizes:
        pool = words(1 if equal else max(1, min(size, 8 + size // 256)))
        pool[1::2, 1:] = pool[0, 1:]  # equal to the first but for word 0
        pool[: len(edges), 0] = edges[: pool.shape[0]]
        run = pool[rng.integers(0, pool.shape[0], size)]
        run[:, W - 1] = edges[len(runs) % len(edges)] if len(runs) < 8 else words(1)[0, W - 1]
        run[:, W - 2] = second[len(runs)]
        runs.append(run)
    rows = np.concatenate(runs)
    ones = (rows == 0xFFFFFFFF).all(axis=1)
    rows[ones, 0] = 0xFFFFFFFE
    rows = rows[rng.permutation(rows.shape[0])]
    n_all = rows.shape[0] + rows.shape[0] // 7
    valid = np.ones(n_all, bool)
    valid[rng.choice(n_all, n_all - rows.shape[0], replace=False)] = False
    canon = rng.integers(0, 1 << 32, (-(-n_all // 64) * 64, W), dtype=np.uint64)
    canon[: n_all][valid] = rows
    valid = np.concatenate([valid, np.zeros(canon.shape[0] - n_all, bool)])
    return (canon.astype(np.uint32).view(np.int32).reshape(-1, 64, W),
            valid.reshape(-1, 64))


def tie_counts(n: int, seed: int):
    """(n,) int32 counts for tie_case's rows as a merge's payload: 1-99,
    and one row in 16 between 2**30 and 2**31 - 1, so that runs of equal rows
    sum past 2**31 - 1 (clamped) and past 2**32 (the u32 sum wraps)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c = rng.integers(1, 100, n)
    big = rng.random(n) < 1 / 16
    c[big] = rng.integers(1 << 30, 1 << 31, int(big.sum()))
    return c.astype(np.int32)


def tie_adversarial() -> None:
    """K20 against its plain version on the card, exactly, on tie_case at
    each W of TIE_WS (runs of every size, and one run of every row), also
    with tie_counts as its payload (as the WordCounter's merges run it:
    the rows' top keys sorted, K20 carrying the counts), and count_batch
    against count_batch_plain on the same rows."""
    import torch

    from leon_tpu_torch.ops import count

    dev = torch.device("cuda")
    for W in TIE_WS:
        for every in (False, True):
            canon_np, valid_np = tie_case(W, every)
            canon = torch.from_numpy(canon_np).to(dev)
            valid = torch.from_numpy(valid_np).to(dev)
            keys, src, rows = count.top_sort(canon, valid)
            for a, b in zip(count.sort_ties(keys, src, rows, W),
                            count.sort_ties_plain(keys, src, rows, W)):
                max_abs_err(a, b)
            for a, b in zip(count.count_batch(canon, valid), count.count_batch_plain(canon, valid)):
                max_abs_err(a, b)
            words = rows[valid.reshape(-1)]
            counts = torch.from_numpy(tie_counts(words.shape[0], W)).to(dev)
            keys, src = torch.sort(count._top_keys(words))
            (gp, gc), (pp, pc) = (count.sort_ties(keys, src, words, W, counts),
                                  count.sort_ties_plain(keys, src, words, W, counts))
            for a, b in zip(gp + (gc,), pp + (pc,)):
                max_abs_err(a, b)
            for a, b in zip(count.word_runs(gp, W, gc, 1, True),
                            count.word_runs_plain(pp, W, pc, 1, True)):
                max_abs_err(a, b)
    log(f"sort_ties, count_batch ok on runs of {TIE_RUNS} equal top words and one run of every "
        f"row at W = {TIE_WS}, with and without a counts payload")


def graph_phase(records: dict, bench_state: dict) -> dict:
    """The graph API on the bench run's solid set (phase 3: 2,014,298
    canonical k-mers at k = 31, W = 2), as its users drive it: every query
    over every node, walks from every node, traversals from 65,536 nodes,
    the blocked probe of the compressor's own filter (phase 3's K3 bitset)
    and the probe script's gathers. Launch counts are read from this run
    alone; then each kernel is held against its plain version on the same
    inputs on the card (exact) and timed."""
    import numpy as np
    import torch

    from leon_tpu_torch import kernels, state
    from leon_tpu_torch.graph import Graph, dbg_traverse_plain, dbg_walk_plain
    from leon_tpu_torch.ops import bloom, gather
    from leon_tpu_torch.ops.kmer import pack_codes_batch_np

    k10_adversarial()
    k12_adversarial()  # K11 on adversarial walks: the adversarial child
    dev = torch.device("cuda")
    words = state.keys_from_torch(bench_state["solid_keys"], 2)
    rnd = state.keys_to_words(np.random.default_rng(31).integers(0, 1 << 62, 1 << 21), 2)
    contig = bench_state["contig"]
    gin = gather_inputs(dev)
    k9_adversarial(gin)
    torch.cuda.synchronize()

    kernels.launches.clear()
    t = time.time()
    G = Graph.from_solid(words, K)  # 16 bits per k-mer, H = 4, seed 0, on the card
    t_build = time.time() - t
    dbg = G.dbg
    nodes = state.words_to_torch(G.index.sorted_words, dev)
    member = dbg.contains(nodes)
    fp = dbg.contains(rnd)
    succ = dbg.successors(nodes)
    pred = dbg.predecessors(nodes)
    branch = dbg.is_branching(nodes)
    branching = np.concatenate(list(G.iter_branching()))
    blocked = bloom.probe(bench_state["bits"], nodes, H, bench_state["n_words"], SEED, K)
    wb, wn = dbg.walk(nodes, GRAPH_WALK_STEPS)
    starts = state.words_to_torch(np.concatenate([branching, G.index.sorted_words])
                                  [:GRAPH_TRAVERSE_LANES], dev)
    tb, tn = dbg.traverse(starts, GRAPH_TRAVERSE_STEPS)
    gathered = {mb: gather.gather_words(*gin[mb]) for mb in GATHER_TABLE_MB}
    pos = np.arange(64) * ((contig.size - K - GRAPH_WALK_STEPS) // 64)
    heads = pack_codes_batch_np(contig[pos[:, None] + np.arange(K)], K)
    cb, cn = dbg.walk(heads, GRAPH_WALK_STEPS)
    torch.cuda.synchronize()
    t_path = time.time() - t
    launches = dict(kernels.launches)
    missing = [k for k in GRAPH if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"graph: kernels never launched on the graph path: {missing}")

    # what comes out is right
    M = words.shape[0]
    if G.dbg.n_words != bloom.choose_n_words(M, 16.0):
        raise AssertionError(f"graph: n_words {G.dbg.n_words}")
    host_bits = bloom.build_np_classic(words, G.dbg.n_words, 4, 0, K)
    if not np.array_equal(state.bitset_from_torch(dbg.bitset), host_bits):
        raise AssertionError("graph: the card's bitset differs from build_np_classic's")
    if not bool(member.all()) or not bool(blocked.all()):
        raise AssertionError("graph: a solid k-mer is missing from a Bloom filter")
    br_np = branch.cpu().numpy()
    if not np.array_equal(branching, G.index.sorted_words[br_np]):
        raise AssertionError("graph: iter_branching disagrees with is_branching")
    # walks from 64 forward k-mers of the contig the reads came from spell it
    cb, cn = cb.cpu().numpy(), cn.cpu().numpy()
    spelled = contig[pos[:, None] + K + np.arange(GRAPH_WALK_STEPS)]
    steps = np.arange(GRAPH_WALK_STEPS)[None, :] < cn[:, None]
    if not (cn.sum() > 0 and ((cb == spelled) | ~steps).all()):
        raise AssertionError("graph: walks from the contig's k-mers did not spell the contig")
    fig = dict(n_nodes=M, n_words=G.dbg.n_words, from_solid_s=t_build, path_s=t_path,
               fp_rate=float(fp.float().mean()), n_branching=int(branching.shape[0]),
               mean_out_degree=float(succ.sum(dim=1).float().mean()),
               mean_in_degree=float(pred.sum(dim=1).float().mean()),
               walk_mean_steps=float(wn.float().mean()),
               walk_full=float((wn == GRAPH_WALK_STEPS).float().mean()),
               traverse_mean_bases=float(tn.float().mean()),
               contig_walk_mean_steps=float(cn.mean()))
    log(f"graph path ok: {json.dumps(fig)}; launches {launches}")

    # each kernel against its plain version on the card, exact, and timed
    args = (dbg.bitset, nodes, "out", True, dbg.n_hashes, dbg.n_words, dbg.seed, K)
    err = max_abs_err(succ, bloom.dbg_probe_plain(*args).cpu())
    for mode, got, q in (("self", member, nodes), ("in", pred, nodes),
                         ("self", fp, state.words_to_torch(rnd, dev))):
        err = max(err, max_abs_err(got, bloom.dbg_probe_plain(
            dbg.bitset, q, mode, True, dbg.n_hashes, dbg.n_words, dbg.seed, K).cpu()))
    err = max(err, max_abs_err(blocked, bloom.dbg_probe_plain(
        bench_state["bits"], nodes, "self", False, H, bench_state["n_words"], SEED, K).cpu()))
    records["dbg_probe"] = record(
        err, cuda_ms(lambda: bloom.dbg_probe(*args), 20),
        cuda_ms(lambda: bloom.dbg_probe_plain(*args), 2),
        nbytes(nodes, dbg.bitset, succ), bound_note=GRAPH_BOUND_NOTE)
    log("dbg_probe ok: contains, successors, predecessors, random contains, blocked probe")

    wargs = (dbg.bitset, nodes, dbg.n_hashes, dbg.n_words, dbg.seed, K, GRAPH_WALK_STEPS)
    pb, pn = dbg_walk_plain(*wargs)
    records["dbg_walk"] = record(
        max(max_abs_err(wb, pb.cpu()), max_abs_err(wn, pn.cpu())),
        cuda_ms(lambda: dbg.walk(nodes, GRAPH_WALK_STEPS), 5),
        cuda_ms(lambda: dbg_walk_plain(*wargs), 1), nbytes(nodes, dbg.bitset, wb, wn),
        bound_note=GRAPH_BOUND_NOTE)
    del pb, pn
    log("dbg_walk ok")

    D = K + 1
    targs = (dbg.bitset, starts, dbg.n_hashes, dbg.n_words, dbg.seed, K,
             GRAPH_TRAVERSE_STEPS, D)
    pb, pn = dbg_traverse_plain(*targs)
    records["dbg_traverse"] = record(
        max(max_abs_err(tb, pb.cpu()), max_abs_err(tn, pn.cpu())),
        cuda_ms(lambda: dbg.traverse(starts, GRAPH_TRAVERSE_STEPS), 5),
        cuda_ms(lambda: dbg_traverse_plain(*targs), 1), nbytes(starts, dbg.bitset, tb, tn),
        bound_note=GRAPH_BOUND_NOTE)
    del pb, pn
    log("dbg_traverse ok")

    err, per_table = 0, {}
    for mb in GATHER_TABLE_MB:
        table, idx = gin[mb]
        err = max(err, max_abs_err(gathered[mb], gather.gather_words_plain(table, idx).cpu()))
        ms = cuda_ms(lambda: gather.gather_words(table, idx), 20)
        idx64 = idx.to(torch.int64)  # torch.take takes int64 indices only
        per_table[mb] = dict(
            ms=ms, plain_ms=cuda_ms(lambda: gather.gather_words_plain(table, idx), 10),
            library_ms=cuda_ms(lambda: torch.take(table, idx64), 20),
            elem_per_s=GATHER_M / ms * 1e3, moved=nbytes(table, idx, gathered[mb]))
    big = per_table[GATHER_TABLE_MB[-1]]
    records["gather_words"] = record(err, big["ms"], big["plain_ms"], big["moved"],
                                     big["library_ms"], bound_note=GATHER_BOUND_NOTE)
    log(f"gather_words ok: {json.dumps(per_table)}")
    for k in GRAPH:
        records[k]["launches"] = launches[k]
    return fig


# ---------------------------------------------------------------------------
# phase 8: the tensor-level k-mer path (K13-K16) at k = 31 and 63
# ---------------------------------------------------------------------------

MESH_SHARDS = 4


def dense_events(enc: dict, side_keys, counts) -> "torch.Tensor":
    """A dense dict's per-side event slots (right, then left) flattened in
    read-major walk order, the order of K4's event rows."""
    import torch

    ME = enc[side_keys[0]].shape[1]
    slot = torch.arange(ME, device=enc[side_keys[0]].device)[None, :]
    keep = torch.cat([slot < enc[c][:, None] for c in counts], dim=1)
    return torch.cat([enc[n].to(torch.int64) for n in side_keys], dim=1)[keep]


def k4_agrees(enc: dict, k4: dict, L: int) -> None:
    """K15's dense dict against K4's walk_encode rows of the same chunk:
    anchored, apos, the per-side counts, the error gaps and ranks, the bif
    ranks and the confirmed positions."""
    import torch

    meta = k4["meta"].to(torch.int64)
    for col, n in enumerate(("anchored", "apos", "nbif_r", "nerr_r", "nbif_l", "nerr_l")):
        max_abs_err(enc[n].to(torch.int64), meta[:, col])
    ME = k4["ev_gap"].shape[1]
    slot = torch.arange(ME, device=meta.device)[None, :]
    tot = k4["tot"].to(torch.int64)
    for keys, counts, k4_name, row, mask in (
            (("gap_r", "gap_l"), ("nerr_r", "nerr_l"), "ev_gap", 0, 0xFFFF),
            (("errnt_r", "errnt_l"), ("nerr_r", "nerr_l"), "ev_nt", 0, 0xFF),
            (("bif_r", "bif_l"), ("nbif_r", "nbif_l"), "ev_bif", 1, 0xFF)):
        want = (k4[k4_name].to(torch.int64) & mask)[slot < tot[row][:, None]]
        max_abs_err(dense_events(enc, keys, counts), want)
    sh = torch.arange(16, device=meta.device)
    bits = (k4["conf"].to(torch.int64)[:, :, None] >> sh) & 1
    max_abs_err(enc["confirmed"], bits.reshape(bits.shape[0], -1)[:, :L] == 1)


def tensor_phase(records: dict, bench_state: dict) -> dict:
    """The tensor-level k-mer path on phase 3's 458,752 bench reads (L =
    104): at k = 31 the scan (K13) and count (K22 + K14) must give
    phase 3's distinct run and solid keys (at k = 63 the count takes the
    top sort, K20 and K14, and must equal count_batch_plain), K16 over the solid rows K3's
    bitset, and K15 on one chunk K4's walk; at k = 63 (W = 4) scan, count,
    K16 (H = 4, the reference's default bits per k-mer), K15 on one chunk,
    and the graph API on the solid set (successors of every node, walk of
    100 steps from 65,536 nodes; K10 and K11 at W = 4, held against their
    plain versions). The 4-shard mesh on one card must equal
    one shard, entry() on the card its CPU run. Launch counts come from
    this run; then each kernel is held against its plain version on the
    card, exactly, and timed."""
    import numpy as np
    import torch

    from leon_tpu_torch import entry, kernels, state
    from leon_tpu_torch.graph import Graph, dbg_walk_plain
    from leon_tpu_torch.ops import bloom, count, kmer, walk
    from leon_tpu_torch.parallel import mesh

    k13_adversarial(tuple(k for k in K13_KS if k <= 64))  # K15's: the adversarial child
    tie_adversarial()
    dev = torch.device("cuda")
    codes = torch.from_numpy(bench_state["codes"]).to(dev)
    lengths = torch.from_numpy(bench_state["lengths"]).to(dev)
    L = codes.shape[1]
    c1, l1 = codes[:B], lengths[:B]
    n_words, cutoff = bench_state["n_words"], bench_state["cutoff"]
    torch.cuda.synchronize()

    kernels.launches.clear()
    t = time.time()
    # k = 31: a second, independent counting path
    canon, _, valid = kmer.kmer_scan_words(codes, lengths, K)
    uniq31, cnt31 = count.count_batch(canon, valid)
    solid31 = uniq31[cnt31 >= cutoff]
    ones31 = torch.ones(solid31.shape[0], dtype=torch.bool, device=dev)
    bits31 = bloom.bloom_build_words(solid31, ones31, n_words, n_words, H, SEED, K)
    enc31 = walk.encode_batch(c1, l1, bits31, K, H, n_words, SEED)
    # k = 63: W = 4
    k63 = 63
    canon, _, valid = kmer.kmer_scan_words(codes, lengths, k63)
    uniq63, cnt63 = count.count_batch(canon, valid)
    hist = torch.bincount(torch.clamp(cnt63, max=255), minlength=256).cpu().numpy()
    hist[0] = 0
    cut63 = count.auto_cutoff(hist)
    bpk63, _ = bloom.auto_params(hist, cut63)
    solid63 = uniq63[cnt63 >= cut63]
    nw63 = bloom.choose_n_words(solid63.shape[0], bpk63)
    ones63 = torch.ones(solid63.shape[0], dtype=torch.bool, device=dev)
    bits63 = bloom.bloom_build_words(solid63, ones63, nw63, nw63, H, SEED, k63)
    enc63 = walk.encode_batch(c1, l1, bits63, k63, H, nw63, SEED)
    G = Graph.from_solid(solid63.cpu().numpy().view(np.uint32), k63)
    nodes = state.words_to_torch(G.index.sorted_words, dev)
    succ63 = G.dbg.successors(nodes)
    wb63, wn63 = G.dbg.walk(nodes[:GRAPH_TRAVERSE_LANES], GRAPH_WALK_STEPS)
    # the mesh: 4 shards on the one card
    m4 = mesh.make_mesh(devices=[dev] * MESH_SHARDS)
    reps = mesh.sharded_bloom_build(m4, solid31, n_words, H, SEED, K)
    enc_m = mesh.make_sharded_encoder(m4, K, H, n_words, SEED)(c1, l1, reps)
    fn, args = entry.entry()
    ent = fn(*args)
    torch.cuda.synchronize()
    t_path = time.time() - t
    launches = dict(kernels.launches)
    missing = [n for n in TENSOR if launches.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"tensor path: kernels never launched: {missing}")

    # what comes out is right
    if uniq31.shape[0] != bench_state["n_distinct"]:
        raise AssertionError(f"k=31: {uniq31.shape[0]} distinct != phase 3's "
                             f"{bench_state['n_distinct']}")
    u = solid31.to(torch.int64) & 0xFFFFFFFF
    max_abs_err(u[:, 0] | (u[:, 1] << 32), bench_state["solid_keys"])
    max_abs_err(bits31, bench_state["bits"])
    k4_agrees(enc31, bench_state["k4_enc"], L)
    aw = bloom.alloc_words(n_words)
    for rep in reps:
        max_abs_err(rep[:n_words], bits31)
        if rep.shape[0] != aw or bool(rep[n_words:].any()):
            raise AssertionError("mesh: a replica's pad words are not zero")
    for n in enc31:
        max_abs_err(enc_m[n], enc31[n])
    fn_c, args_c = entry.entry("cpu")
    ent_c = fn_c(*args_c)
    for n in ent:
        max_abs_err(ent[n], ent_c[n].to(dev))
    if not bool(G.dbg.contains(nodes).all()):
        raise AssertionError("k=63: a solid k-mer is missing from the graph's filter")
    # K10 and K11 at W = 4 against their plain versions
    d = G.dbg
    max_abs_err(succ63, bloom.dbg_probe_plain(d.bitset, nodes, "out", True, d.n_hashes,
                                              d.n_words, d.seed, k63))
    for a, b in zip((wb63, wn63), dbg_walk_plain(d.bitset, nodes[:GRAPH_TRAVERSE_LANES],
                                                 d.n_hashes, d.n_words, d.seed, k63,
                                                 GRAPH_WALK_STEPS)):
        max_abs_err(a, b)
    anch63 = enc63["anchored"].float().mean().item()
    fig = dict(n_reads=codes.shape[0], distinct31=uniq31.shape[0], solid31=solid31.shape[0],
               distinct63=uniq63.shape[0], cutoff63=cut63, bits_per_kmer63=bpk63,
               solid63=solid63.shape[0], n_words63=nw63,
               anchored31=enc31["anchored"].float().mean().item(), anchored63=anch63,
               graph63_mean_out_degree=float(succ63.sum(dim=1).float().mean()),
               walk63_mean_steps=float(wn63.float().mean()), path_s=t_path)
    log(f"tensor path ok: {json.dumps(fig)}; launches {launches}")
    del G, succ63, wb63, wn63, reps, enc_m, ent, ent_c

    # each kernel against its plain version on the card, exact, and timed
    # (the k = 63 shapes; K13 and K15 also at k = 31)
    err = 0
    for k, enc in ((K, enc31), (k63, enc63)):
        got = kmer.kmer_scan_words(codes, lengths, k)
        want = kmer.kmer_scan_words_plain(codes, lengths, k)
        err = max(err, *(max_abs_err(a, b) for a, b in zip(got, want)))
        del want
        bits, nw = (bits31, n_words) if k == K else (bits63, nw63)
        want = walk.encode_batch_plain(c1, l1, bits, k, H, nw, SEED)
        err = max(err, *(max_abs_err(enc[n], want[n]) for n in enc))
        del want
    records["kmer_scan_words"] = record(
        err, cuda_ms(lambda: kmer.kmer_scan_words(codes, lengths, k63), 5),
        cuda_ms(lambda: kmer.kmer_scan_words_plain(codes, lengths, k63), 1),
        nbytes(codes, lengths, got))
    log("kmer_scan_words ok")
    records["walk_dense"] = record(
        err, cuda_ms(lambda: walk.encode_batch(c1, l1, bits63, k63, H, nw63, SEED), 10),
        cuda_ms(lambda: walk.encode_batch_plain(c1, l1, bits63, k63, H, nw63, SEED), 1),
        nbytes(c1, l1, bits63, enc63))
    log(f"walk_dense ok: k=31 {enc31['anchored'].float().mean().item():.4f}, "
        f"k=63 {anch63:.4f} anchored")

    # K20 on the path's k = 63 rows after the top sort; count_batch against
    # its plain version, and timed beside torch.unique(dim=0) (below)
    err = max(max_abs_err(a, b) for a, b in zip((uniq63, cnt63),
                                                 count.count_batch_plain(got[0], got[2])))
    tkeys, tsrc, trows = count.top_sort(got[0], got[2])
    tp = count.sort_ties(tkeys, tsrc, trows, 4)
    err = max(err, *(max_abs_err(a, b)
                     for a, b in zip(tp, count.sort_ties_plain(tkeys, tsrc, trows, 4))))
    records["sort_ties"] = record(
        err, cuda_ms(lambda: count.sort_ties(tkeys, tsrc, trows, 4), 5),
        cuda_ms(lambda: count.sort_ties_plain(tkeys, tsrc, trows, 4), 2),
        nbytes(tkeys, tsrc, tp) + tkeys.numel() * 4 * 4)
    log(f"sort_ties ok: {tkeys.numel()} rows (k=63)")
    fig["count_batch63_ms"] = cuda_ms(lambda: count.count_batch(got[0], got[2]), 3)
    del tkeys, tsrc, trows, tp
    rows = got[0].reshape(-1, 4)[got[2].reshape(-1)]
    del got
    planes = count.sort_words(rows)
    uq, cn = count.runs_words(planes, 4)
    pu, pc = count.runs_words_plain(planes, 4)
    err = max(max_abs_err(uq, pu), max_abs_err(cn, pc), max_abs_err(uq, uniq63),
              max_abs_err(cn, cnt63))
    del pu, pc
    planes2 = count.sort_words(solid31)
    err = max(err, *(max_abs_err(a, b) for a, b in zip(count.runs_words(planes2, 2),
                                                 count.runs_words_plain(planes2, 2))))
    u0, c0 = count.count_batch(torch.zeros(2, 3, 4, dtype=torch.int32, device=dev),
                               torch.zeros(2, 3, dtype=torch.bool, device=dev))  # all invalid
    if tuple(u0.shape) != (0, 4) or tuple(c0.shape) != (0,):
        raise AssertionError(f"count_batch on no rows: {tuple(u0.shape)}, {tuple(c0.shape)}")
    # K14 beside torch.unique_consecutive over the same sorted rows (its own
    # function); torch.unique(dim=0), which also sorts, beside count_batch
    srows = state.planes_to_words(planes, 4)
    fig["unique63_ms"] = cuda_ms(lambda: torch.unique(rows, dim=0, return_counts=True), 2)
    records["runs_words"] = record(
        err, cuda_ms(lambda: count.runs_words(planes, 4), 5),
        cuda_ms(lambda: count.runs_words_plain(planes, 4), 2), nbytes(planes, uq, cn),
        cuda_ms(lambda: torch.unique_consecutive(srows, dim=0, return_counts=True), 3))
    log(f"runs_words ok: {rows.shape[0]} rows -> {uq.shape[0]} distinct (k=63)")
    del rows, srows, planes, planes2, uq, cn

    err = 0
    for words, ones, nw, k in ((solid31, ones31, n_words, K), (solid63, ones63, nw63, k63)):
        aw = bloom.alloc_words(nw)
        err = max(err, max_abs_err(bloom.bloom_build_words(words, ones, aw, nw, H, SEED, k),
                                   bloom.bloom_build_words_plain(words, ones, aw, nw, H, SEED, k)))
    args63 = (solid63, ones63, nw63, nw63, H, SEED, k63)
    records["bloom_build_words"] = record(
        err, cuda_ms(lambda: bloom.bloom_build_words(*args63), 10),
        cuda_ms(lambda: bloom.bloom_build_words_plain(*args63), 1),
        nbytes(solid63, ones63, bits63))
    log("bloom_build_words ok")
    for n in TENSOR:
        records[n]["launches"] = launches[n]
    return fig


# ---------------------------------------------------------------------------
# phase 9: the main path's multiword route (K17, K14's modes, K16, K18, K19)
# ---------------------------------------------------------------------------


def multiword_checks(records: dict, names: tuple, codes, lengths, k: int, unitig_names: tuple,
                     keep: dict | None = None) -> dict:
    """The kernels compress and decompress run at 32 <= k <= 255, at one
    k's main-path shapes: the (n, L) read codes as 65,536-lane packed
    chunks. K17 scans each chunk's valid k-mers as sign-flipped int64
    planes; each chunk's slab run (sort + K14 in length mode) and their
    merge (K14 with the counts payload and the histogram); K14's solid
    mode, K16 over the run's solid rows at the pipeline's sizing, K18 on
    one chunk (with and without the confirmed bits) and K19 on what K18
    encoded (restoring the reads). Each kernel is held against its plain
    version on the card, exactly, and timed, into records under `names`
    (K17, K14, K16, K18, K19); their launch counts come from a main-path
    run at the same width. Then K5-K8 over the solid rows (unitig_checks,
    records `unitig_names`). Returns the counts the caller checks; `keep`,
    when given, receives the run's solid rows, cutoff and Bloom bitset
    (phase 10's inputs)."""
    import numpy as np
    import torch

    from leon_tpu_torch import state
    from leon_tpu_torch.ops import bloom, count, kmer, walk

    (n_scan, n_runs, n_bloom, n_enc, n_dec, n_prows, n_ties, n_top, n_rtop, n_wrows, n_merge,
     n_btop, n_otop) = names
    dev = torch.device("cuda")
    L = codes.shape[1]
    W = kmer.words_for_k(k)
    tag = f"k={k}, W={W}"
    packed_d = state.packed_to_torch(kmer.pack_codes_np(codes), dev)
    lengths_d = torch.from_numpy(lengths).to(dev)
    chunks = [(packed_d[s : s + B], lengths_d[s : s + B]) for s in range(0, codes.shape[0], B)]

    # K17
    planes = [kmer.kmer_scan_halves(p, ln, k, L) for p, ln in chunks]
    err = 0
    for (p, ln), got in zip(chunks[:2], planes):
        want = kmer.kmer_scan_halves_plain(p, ln, k, L)
        err = max(err, *(max_abs_err(a, b) for a, b in zip(got, want)))
        del want
    # timed apart from the wrapper's host sync on the valid count
    p0, l0 = chunks[0]
    nv = torch.clamp(l0.to(torch.int64) - (k - 1), 0, L - k + 1)
    offs0 = torch.cumsum(nv, 0) - nv
    dst = tuple(torch.empty_like(h) for h in planes[0])
    records[n_scan] = record(
        err, cuda_ms(lambda: kmer.scan_halves_launch(p0, l0, offs0, k, L, dst), 10),
        cuda_ms(lambda: kmer.kmer_scan_halves_plain(p0, l0, k, L), 2), nbytes(p0, l0, planes[0]))
    for a, b in zip(dst, planes[0]):
        max_abs_err(a, b)
    wrapper_ms = cuda_ms(lambda: kmer.kmer_scan_halves(p0, l0, k, L), 10)
    n_rows = sum(h[0].numel() for h in planes)
    log(f"{n_scan} ok: {n_rows} valid k-mers ({tag}) in {len(chunks)} chunks; one chunk "
        f"{records[n_scan]['ms']:.4f} ms, the wrapper with its host sync {wrapper_ms:.4f} ms")
    del dst

    # K21 on the first chunk's slab, as the WordCounter's slab sort runs it
    h0 = planes[0]
    rows0, top0 = count.plane_rows(h0, W)
    err = max(max_abs_err(a, b) for a, b in zip((rows0, top0), count.plane_rows_plain(h0, W)))
    records[n_prows] = record(
        err, cuda_ms(lambda: count.plane_rows(h0, W), 10),
        cuda_ms(lambda: count.plane_rows_plain(h0, W), 2), nbytes(h0, rows0, top0))
    log(f"{n_prows} ok: {h0[0].numel()} slab rows ({tag})")
    # K22 on the slab's top keys with their index, as sort_slab runs it
    bits = count.top_key_bits(k)
    got = count.radix_sort_index(top0, bits)
    err = max(max_abs_err(a, b) for a, b in
              zip(got, count.radix_sort_plain(top0, torch.arange(top0.shape[0], device=dev))))
    records[n_top] = sort_record(err, lambda: count.radix_sort_index(top0, bits), top0, "index")
    records[n_btop], records[n_otop] = bucket_records(
        records[n_top], lambda: count.radix_sort_index(top0, bits), top0, "index", bits)
    # the bucket route makes no host read: a synchronizing call inside it raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = count.radix_sort_index(top0, bits)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if max(max_abs_err(a, b) for a, b in zip(again, got)):
        raise AssertionError(f"{n_top}: a second sort of the top keys differs")
    log(f"{n_top} ok: the slab's {top0.numel()} top keys with their index ({tag}) "
        f"{records[n_top]['ms']:.4f} ms (torch.sort {records[n_top]['library_ms']:.4f}; "
        f"K24 {records[n_btop]['ms']:.4f}, K25 {records[n_otop]['ms']:.4f}; again under "
        f"torch.cuda.set_sync_debug_mode('error'))")
    del rows0, top0, h0, got, again

    # the WordCounter's sorts (sort_slab: K21, the top sort, K20; sort_rows:
    # the top sort, K20 with the counts), each equal to the LSD sort of the
    # same planes (sorted rows are unique); K14: slab runs (length mode),
    # their merge (counts + histogram), solid mode
    slab_runs = []
    for i, h in enumerate(planes):
        srt = count.sort_slab(h, W, bits)
        got = count.word_runs(srt, W)
        if i == 0:
            lsd = count.sort_planes(h)
            err = max(max_abs_err(a, b) for a, b in zip(srt, lsd))
            want = count.word_runs_plain(lsd, W)
            err = max(err, max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
            del lsd
        slab_runs.append(got[:2])
    del planes, srt
    # K23 merging the slab runs where they lie, as the WordCounter merges them
    mw, mcnt = count.merge_path_rows(slab_runs)
    err_m = max(max_abs_err(a, b) for a, b in
                zip((mw, mcnt), count.merge_path_plain(slab_runs)))
    records[n_merge] = merge_record(err_m, lambda: count.merge_path_rows(slab_runs), slab_runs, 5)
    log(f"{n_merge} ok: {len(slab_runs)} slab runs, {mw.shape[0]} rows with their counts ({tag}) "
        f"{records[n_merge]['ms']:.4f} ms (torch.sort of the top keys "
        f"{records[n_merge]['library_ms']:.4f}, bound {records[n_merge]['bound_ms']:.4f})")
    words = torch.cat([r[0] for r in slab_runs])
    counts = torch.cat([r[1] for r in slab_runs])
    del slab_runs
    mpl, mc = count.sort_rows(words, counts, bits)
    lpl, perm = count.sort_planes(state.words_to_planes(words), with_perm=True)
    lc = counts[perm]
    err = max(err, *(max_abs_err(a, b) for a, b in zip(mpl, lpl)))
    # K22 reading the merge's top keys from its rows with their index, and
    # K20 with the counts as its payload, as sort_rows launches them
    keys, src = count.radix_sort_rows(words, bits=bits)
    tk = count._top_keys(words)
    err_t = max(max_abs_err(a, b) for a, b in
                zip((keys, src), count.radix_sort_plain(tk, torch.arange(tk.shape[0], device=dev))))
    records[n_rtop] = sort_record(err_t, lambda: count.radix_sort_rows(words, bits=bits), tk,
                                  "index")
    log(f"{n_rtop} ok: the merge's {tk.numel()} top keys read from its rows ({tag}) "
        f"{records[n_rtop]['ms']:.4f} ms (torch.sort {records[n_rtop]['library_ms']:.4f})")
    del tk
    tp, tc = count.sort_ties(keys, src, words, W, counts)
    pp, pc = count.sort_ties_plain(keys, src, words, W, counts)
    terr = max(max_abs_err(a, b) for a, b in zip(tp + (tc,), pp + (pc,)))
    records[n_ties] = record(
        terr, cuda_ms(lambda: count.sort_ties(keys, src, words, W, counts), 5),
        cuda_ms(lambda: count.sort_ties_plain(keys, src, words, W, counts), 2),
        nbytes(keys, src, words, counts, tp, tc), bound_note=TIES_BOUND_NOTE)
    log(f"{n_ties} ok: {words.shape[0]} slab runs' rows with their counts ({tag}); their "
        f"sort (the parent's merge, after its cat) "
        f"{cuda_ms(lambda: count.sort_rows(words, counts, bits), 5):.4f} ms")
    del words, counts, perm, keys, src, tp, tc, pp, pc
    gw, gc, gh = count.word_runs(mpl, W, mc, 1, True)
    err = max(err, *(max_abs_err(a, b) for a, b in
                     zip((gw, gc, gh), count.word_runs_plain(lpl, W, lc, 1, True))))
    # the WordCounter's merge route (K23, K14's row policy) gives the same run
    err = max(err, *(max_abs_err(a, b) for a, b in
                     zip(count.word_runs_rows(mw, mcnt, 1, True), (gw, gc, gh))))
    del lpl, lc, mw, mcnt
    hist = gh.cpu().numpy().astype(np.int64)
    cutoff = count.auto_cutoff(hist)
    # K14's row policy on the final run, as finalize reduces it and compacts
    # its solid rows, against K14 over the run's planes
    gpl = state.words_to_planes(gw)
    rw = count.word_runs_rows(gw, gc, 1, True)
    err_w = max(max_abs_err(a, b) for a, b in zip(rw, count.word_runs(gpl, W, gc, 1, True)))
    sw, sc = count.compact_solid_words(gw, gc, cutoff)
    pw, pc, _ = count.word_runs(gpl, W, gc, cutoff)
    err_w = max(err_w, max_abs_err(sw, pw), max_abs_err(sc, pc))
    records[n_wrows] = record(
        err_w, cuda_ms(lambda: count.word_runs_rows(gw, gc, 1, True), 5),
        cuda_ms(lambda: count.word_runs_plain(state.words_to_planes(gw), W, gc, 1, True), 2),
        nbytes(gw, gc, rw))
    log(f"{n_wrows} ok: the final run's {gw.shape[0]} rows ({tag}) "
        f"{records[n_wrows]['ms']:.4f} ms, K14 over its planes "
        f"{cuda_ms(lambda: count.word_runs(gpl, W, gc, 1, True), 5):.4f} ms")
    del gpl, rw
    pw, pc, _ = count.word_runs_plain(state.words_to_planes(gw), W, gc, cutoff)
    err = max(err, max_abs_err(sw, pw), max_abs_err(sc, pc))
    records[n_runs] = record(
        err, cuda_ms(lambda: count.word_runs(mpl, W, mc, 1, True), 5),
        cuda_ms(lambda: count.word_runs_plain(mpl, W, mc, 1, True), 2),
        nbytes(mpl, mc, gw, gc, gh))
    n_distinct = gw.shape[0]
    log(f"{n_runs} ok: {mc.numel()} run rows -> {n_distinct} distinct, cutoff {cutoff}, "
        f"{sw.shape[0]} solid ({tag})")
    del mpl, mc, pw, pc

    # K16 as the WordCounter calls it: over the solid rows K14 compacted (the
    # same bits as the whole run with its solid rows marked)
    n_solid = int(hist[min(cutoff, 255):].sum())
    bpk, _h = bloom.auto_params(hist, cutoff, False, stored_filter=False)
    nw = bloom.choose_n_words(n_solid, bpk)
    ones = torch.ones(sw.shape[0], dtype=torch.bool, device=dev)
    bits = bloom.bloom_build_words(sw, ones, nw, nw, H, SEED, k)
    err = max(max_abs_err(bits, bloom.bloom_build_words_plain(sw, ones, nw, nw, H, SEED, k)),
              max_abs_err(bits, bloom.bloom_build_words(gw, gc >= cutoff, nw, nw, H, SEED, k)))
    records[n_bloom] = record(
        err, cuda_ms(lambda: bloom.bloom_build_words(sw, ones, nw, nw, H, SEED, k), 10),
        cuda_ms(lambda: bloom.bloom_build_words_plain(sw, ones, nw, nw, H, SEED, k), 1),
        nbytes(sw, ones, bits))
    log(f"{n_bloom} ok: {n_solid} solid rows of {n_distinct}, {nw} words ({tag})")
    if keep is not None:
        keep.update(codes=codes, lengths=lengths, solid=sw, bits=bits, n_words=nw,
                    cutoff=cutoff, distinct=n_distinct, n_solid=n_solid)
    del gw, gc, gh, ones

    # K5-K8 over the solid rows, as the device unitig build reads them
    unitig_fig = unitig_checks(records, sw, sc, cutoff, n_distinct, "multiword", k, unitig_names)
    del sw, sc

    # K18 on one chunk, with and without the confirmed bits
    def enc_d(conf: bool):
        return walk.walk_encode_words(p0, l0, bits, nw, k, H, SEED, L, conf)

    ME = L - k
    err = 0
    for conf in (True, False):
        e_d = enc_d(conf)
        e_p = walk.walk_encode_plain(p0, l0, bits, nw, k, H, SEED, L, conf)
        err = max(err, *(max_abs_err(e_d[n], e_p[n]) for n in ("meta", "tot", "conf")))
        tot = e_p["tot"].to(torch.int64)
        for n, row in (("ev_gap", 0), ("ev_nt", 0), ("ev_bif", 1)):
            valid = torch.arange(ME, device=dev)[None, :] < tot[row][:, None]
            err = max(err, max_abs_err(e_d[n].to(torch.int64)[valid],
                                       e_p[n].to(torch.int64)[valid]))
        del e_p
    # bytes: the inputs, meta and tot, and the tot-many event slots the
    # kernel writes of each read's (ME,) rows (e_d is the run without conf)
    n_ev = e_d["tot"].to(torch.int64).sum(dim=1).tolist()
    ev_bytes = (n_ev[0] * (e_d["ev_gap"].element_size() + e_d["ev_nt"].element_size())
                + n_ev[1] * e_d["ev_bif"].element_size())
    records[n_enc] = record(
        err, cuda_ms(lambda: enc_d(False), 10),
        cuda_ms(lambda: walk.walk_encode_plain(p0, l0, bits, nw, k, H, SEED, L, False), 1),
        nbytes(p0, l0, bits, e_d["meta"], e_d["tot"]) + ev_bytes, bound_note=WALK_BOUND_NOTE)
    nb = p0.shape[0]
    anchored = int(e_d["meta"][:, 0].sum())
    log(f"{n_enc} ok: {anchored}/{nb} anchored, {n_ev[0]} err, {n_ev[1]} bif events ({tag})")

    # K19 on what K18 encoded
    incl = torch.cumsum(e_d["tot"], dim=1)
    cap_err = -(-int(incl[0, -1]) // 8) * 8
    cap_bif = -(-int(incl[1, -1]) // 8) * 8
    buf = walk.walk_pack(e_d, incl, L, k, cap_err, cap_bif, False).cpu().numpy()
    enc = walk.unpack_compact(buf.view(np.uint16), nb, nb, L, cap_err, cap_bif, False, k)
    anch = enc["anchored"]
    dec_in = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in decode_inputs(enc, codes[:nb], lengths[:nb], k))
    d_d = walk.walk_decode_words(*dec_in, bits, nw, k, H, SEED, L)
    err = max_abs_err(d_d, walk.walk_decode_plain(*dec_in, bits, nw, k, H, SEED, L))
    back = walk.unpack_codes_u32_np(d_d.cpu().numpy().view(np.uint32), L)
    rows = np.flatnonzero(anch)
    same = (back[rows] == codes[:nb][rows]) | (np.arange(L)[None, :] >= lengths[:nb][rows, None])
    if not same.all() or rows.size == 0:
        raise AssertionError(f"{tag}: decode did not restore the encoded reads")
    records[n_dec] = record(
        err, cuda_ms(lambda: walk.walk_decode_words(*dec_in, bits, nw, k, H, SEED, L), 10),
        cuda_ms(lambda: walk.walk_decode_plain(*dec_in, bits, nw, k, H, SEED, L), 1),
        nbytes(dec_in, bits, d_d), bound_note=WALK_BOUND_NOTE)
    log(f"{n_dec} ok: {rows.size} reads restored ({tag})")
    return dict(k=k, n_reads=codes.shape[0], L=L, valid_rows=n_rows, distinct=n_distinct,
                cutoff=cutoff, n_solid=n_solid, n_words=nw, anchored=anchored,
                unitig=unitig_fig)


def widek_phase(records: dict, bench_state: dict, tensor_fig: dict, r250: str) -> tuple:
    """Phase 9: the multiword kernels at k = 63 on phase 3's 458,752 reads (L
    = 104; the distinct run, cutoff and solid count must equal phase 8's),
    at k = 127 (W = 8) on the whole 250-bp corpus of phase 6 (the solid
    count must equal PIN127's), and at k = 255 (W = 16) on 131,072 reads of
    300-600 bp (long_reads); first K14 and K17 on adversarial inputs
    (words_adversarial, scan_adversarial) and K18 and K19
    (walk_adversarial), and K16 at the pad edges of its table hash
    (bloom_adversarial). Returns the figures and, per k of
    W >= 8, the reads, solid rows and Bloom bitset phase 10 takes over."""
    words_adversarial()
    scan_adversarial()
    bloom_adversarial()  # K18 and K19 on adversarial reads: the adversarial child
    merge_adversarial(MERGE_ROWS)
    fig63 = multiword_checks(records, WIDE, bench_state["codes"], bench_state["lengths"], K63,
                             UNITIG4)
    want = (tensor_fig["distinct63"], tensor_fig["cutoff63"], tensor_fig["solid63"])
    if (fig63["distinct"], fig63["cutoff"], fig63["n_solid"]) != want:
        raise AssertionError(f"k={K63}: distinct, cutoff, solid {fig63} != phase 8's {want}")
    hand = {K127: {}, K255: {}}
    codes, lengths = fastq_codes(r250)
    fig127 = multiword_checks(records, WIDE8, codes, lengths, K127, UNITIG8, hand[K127])
    if fig127["n_solid"] != PIN127["n_solid"]:
        raise AssertionError(f"k={K127}: {fig127['n_solid']} solid != the reference's "
                             f"{PIN127['n_solid']}")
    codes, lengths = long_reads(2 * B, 300, 600)
    fig255 = multiword_checks(records, WIDE16, codes, lengths, K255, UNITIG16, hand[K255])
    return {"k63": fig63, "k127": fig127, "k255": fig255}, hand


# ---------------------------------------------------------------------------
# phase 10: the tensor path and the graph API past four words (W = 8, 16)
# ---------------------------------------------------------------------------

# the plain traversal pays 4 x D probe steps an outer step, each a few
# hundred PyTorch ops (61-66 s for 16,384 lanes x 16 steps at D = 256 on
# an H100): at the default D = k + 1 it is held on the first sixteenth of
# the lanes
LONGK_DEEP_LANES = GRAPH_TRAVERSE_LANES // 16


def longk_checks(records: dict, names: tuple, hand: dict, k: int) -> dict:
    """Phases 8 and 7 at one k past four words, on phase 9's reads and solid
    set at that k (`hand`), as their users drive them. The tensor path: K13
    over every read, count_batch (the top sort, K20, K14's run lengths) over
    its valid rows (equal to count_batch_plain), which must give phase 9's
    distinct and solid counts and
    solid rows; the solid rows' blocked Bloom filter built through
    sharded_bloom_build on 4 shards of the one card, which must equal one
    shard and phase 9's K16 bitset; K15 on the first 65,536 reads. The
    graph API on the solid set: Graph.from_solid, contains / successors /
    predecessors / is_branching over every node, contains of 2**21 random
    k-mers, the blocked bloom.probe of phase 9's compress filter over its
    solid rows (all members), walk from every node (100 steps), traverse
    from 65,536 nodes (16 steps at D = 32 and at the default D = k + 1).
    Launch counts come from this run; then each kernel's output on the
    path is held against its plain version on the same inputs on the card
    (exact) and timed at those shapes, every lane and step (K12 at the
    default depth on the first LONGK_DEEP_LANES lanes): the plain versions
    of K11, K12, K13, K15 and K20, which take seconds, on their one checking
    call."""
    import numpy as np
    import torch

    from leon_tpu_torch import kernels, state
    from leon_tpu_torch.graph import Graph, dbg_traverse_plain, dbg_walk_plain
    from leon_tpu_torch.ops import bloom, count, kmer, walk
    from leon_tpu_torch.parallel import mesh

    n_scan, n_runs, n_dense, n_probe, n_walk, n_trav, n_ties = names
    dev = torch.device("cuda")
    W = kmer.words_for_k(k)
    tag = f"k={k}, W={W}"
    codes = torch.from_numpy(hand["codes"]).to(dev)
    lengths = torch.from_numpy(hand["lengths"]).to(dev)
    c1, l1 = codes[:B], lengths[:B]
    nw, cutoff = hand["n_words"], hand["cutoff"]
    rnd = np.random.default_rng(k).integers(0, 1 << 32, (1 << 21, W), dtype=np.uint64)
    rnd[:, -1] &= kmer.top_mask(k)
    rnd = state.words_to_torch(rnd.astype(np.uint32), dev)
    S = GRAPH_TRAVERSE_STEPS
    torch.cuda.synchronize()

    kernels.launches.clear()
    t = time.time()
    canon, is_rc, valid = kmer.kmer_scan_words(codes, lengths, k)
    uniq, cnt = count.count_batch(canon, valid)
    solid = uniq[cnt >= cutoff]
    reps = mesh.sharded_bloom_build(mesh.make_mesh(devices=[dev] * MESH_SHARDS), solid, nw, H,
                                    SEED, k)
    one = mesh.sharded_bloom_build(mesh.make_mesh(devices=[dev]), solid, nw, H, SEED, k)[0]
    enc = walk.encode_batch(c1, l1, reps[0], k, H, nw, SEED)
    torch.cuda.synchronize()
    t_g = time.time()
    G = Graph.from_solid(solid.cpu().numpy().view(np.uint32), k)
    t_build = time.time() - t_g
    dbg = G.dbg
    nodes = state.words_to_torch(G.index.sorted_words, dev)
    member = dbg.contains(nodes)
    succ = dbg.successors(nodes)
    pred = dbg.predecessors(nodes)
    branch = dbg.is_branching(nodes)
    fp = dbg.contains(rnd)
    blocked = bloom.probe(hand["bits"], hand["solid"], H, nw, SEED, k)
    wb, wn = dbg.walk(nodes, GRAPH_WALK_STEPS)
    starts = torch.cat([nodes[branch], nodes[~branch]])[:GRAPH_TRAVERSE_LANES]
    trav = {32: dbg.traverse(starts, S, 32), k + 1: dbg.traverse(starts, S)}  # default D
    torch.cuda.synchronize()
    t_path = time.time() - t
    launches = dict(kernels.launches)
    missing = [n for n in names + ("bloom_build_words",) if launches.get(counter(n), 0) < 1]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched on the path: {missing}")

    # what comes out is right
    if (uniq.shape[0], solid.shape[0]) != (hand["distinct"], hand["n_solid"]):
        raise AssertionError(f"{tag}: {uniq.shape[0]} distinct, {solid.shape[0]} solid != "
                             f"phase 9's {hand['distinct']}, {hand['n_solid']}")
    max_abs_err(solid, hand["solid"])
    for rep in reps:
        max_abs_err(rep, one)
    max_abs_err(one[:nw], hand["bits"])
    if G.dbg.n_words != bloom.choose_n_words(solid.shape[0], 16.0):
        raise AssertionError(f"{tag}: graph n_words {G.dbg.n_words}")
    if not bool(member.all()) or not bool(blocked.all()):
        raise AssertionError(f"{tag}: a solid k-mer is missing from a Bloom filter")
    tn, tnd = trav[32][1], trav[k + 1][1]
    if not bool(enc["anchored"].any()) or int(tnd.sum()) < int(tn.sum()):
        raise AssertionError(f"{tag}: no read anchored, or the default depth crossed less")
    fig = dict(k=k, n_reads=codes.shape[0], valid_rows=int(valid.sum()), distinct=uniq.shape[0],
               solid=solid.shape[0], graph_n_words=G.dbg.n_words, from_solid_s=t_build,
               path_s=t_path, fp_rate=float(fp.float().mean()),
               n_branching=int(branch.sum()),
               mean_out_degree=float(succ.sum(dim=1).float().mean()),
               walk_mean_steps=float(wn.float().mean()),
               walk_full=float((wn == GRAPH_WALK_STEPS).float().mean()),
               traverse_mean_bases=float(tn.float().mean()),
               traverse_default_mean_bases=float(tnd.float().mean()),
               anchored=float(enc["anchored"].float().mean()))
    log(f"long-k tensor path and graph ok ({tag}): {json.dumps(fig)}; launches {launches}")
    del reps, one, member, pred, branch, fp, blocked

    # each kernel's output on the path against its plain version on the
    # card, exact, and timed at the path's shapes
    got = (canon, is_rc, valid)
    want, plain_ms = timed(lambda: kmer.kmer_scan_words_plain(codes, lengths, k))
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    del want
    records[n_scan] = record(err, cuda_ms(lambda: kmer.kmer_scan_words(codes, lengths, k), 5),
                             plain_ms, nbytes(codes, lengths, got))
    log(f"{n_scan} ok: {codes.shape[0]} reads ({tag}; plain {plain_ms / 1e3:.1f} s)")

    # count_batch beside torch.unique(dim=0), which also sorts; K14 beside
    # torch.unique_consecutive over the same sorted rows (its own function)
    # K20 on the path's rows after the top sort; count_batch against its
    # plain version
    err = max(max_abs_err(a, b) for a, b in zip((uniq, cnt),
                                                 count.count_batch_plain(canon, valid)))
    tkeys, tsrc, trows = count.top_sort(canon, valid)
    tp = count.sort_ties(tkeys, tsrc, trows, W)
    want, plain_ms = timed(lambda: count.sort_ties_plain(tkeys, tsrc, trows, W))
    err = max(err, *(max_abs_err(a, b) for a, b in zip(tp, want)))
    del want
    records[n_ties] = record(err, cuda_ms(lambda: count.sort_ties(tkeys, tsrc, trows, W), 5),
                             plain_ms, nbytes(tkeys, tsrc, tp) + tkeys.numel() * 4 * W)
    log(f"{n_ties} ok: {tkeys.numel()} rows ({tag})")
    del tkeys, tsrc, trows, tp
    rows = canon.reshape(-1, W)[valid.reshape(-1)]
    fig["count_batch_ms"] = cuda_ms(lambda: count.count_batch(canon, valid), 3)
    fig["unique_ms"] = cuda_ms(lambda: torch.unique(rows, dim=0, return_counts=True), 1)
    del canon, is_rc, valid, got
    planes = count.sort_words(rows)
    srows = state.planes_to_words(planes, W)
    uq, cn = count.runs_words(planes, W)
    pu, pc = count.runs_words_plain(planes, W)
    err = max(max_abs_err(uq, pu), max_abs_err(cn, pc), max_abs_err(uq, uniq),
              max_abs_err(cn, cnt))
    del pu, pc, rows
    records[n_runs] = record(
        err, cuda_ms(lambda: count.runs_words(planes, W), 5),
        cuda_ms(lambda: count.runs_words_plain(planes, W), 1), nbytes(planes, uq, cn),
        cuda_ms(lambda: torch.unique_consecutive(srows, dim=0, return_counts=True), 3))
    log(f"{n_runs} ok: {srows.shape[0]} rows -> {uq.shape[0]} distinct ({tag})")
    del srows, planes, uq, cn, uniq, cnt

    bits = hand["bits"]
    want, plain_ms = timed(lambda: walk.encode_batch_plain(c1, l1, bits, k, H, nw, SEED))
    err = max(max_abs_err(enc[n], want[n]) for n in enc)
    del want
    records[n_dense] = record(
        err, cuda_ms(lambda: walk.encode_batch(c1, l1, bits, k, H, nw, SEED), 5), plain_ms,
        nbytes(c1, l1, bits, enc))
    log(f"{n_dense} ok: {c1.shape[0]} reads, {fig['anchored']:.4f} anchored ({tag})")

    args = (dbg.bitset, nodes, "out", True, dbg.n_hashes, dbg.n_words, dbg.seed, k)
    err = max_abs_err(succ, bloom.dbg_probe_plain(*args))
    for mode, q in (("self", nodes), ("in", nodes), ("self", rnd)):
        a = (dbg.bitset, q, mode, True, dbg.n_hashes, dbg.n_words, dbg.seed, k)
        err = max(err, max_abs_err(bloom.dbg_probe(*a), bloom.dbg_probe_plain(*a)))
    a = (hand["bits"], hand["solid"], "self", False, H, nw, SEED, k)
    err = max(err, max_abs_err(bloom.dbg_probe(*a), bloom.dbg_probe_plain(*a)))
    records[n_probe] = record(
        err, cuda_ms(lambda: bloom.dbg_probe(*args), 10),
        cuda_ms(lambda: bloom.dbg_probe_plain(*args), 1), nbytes(nodes, dbg.bitset, succ),
        bound_note=GRAPH_BOUND_NOTE)
    log(f"{n_probe} ok: contains, successors, predecessors, random contains, blocked probe "
        f"({tag})")

    wargs = (dbg.bitset, nodes, dbg.n_hashes, dbg.n_words, dbg.seed, k, GRAPH_WALK_STEPS)
    (pb, pn), plain_ms = timed(lambda: dbg_walk_plain(*wargs))
    records[n_walk] = record(
        max(max_abs_err(wb, pb), max_abs_err(wn, pn)),
        cuda_ms(lambda: dbg.walk(nodes, GRAPH_WALK_STEPS), 3), plain_ms,
        nbytes(nodes, dbg.bitset, wb, wn), bound_note=GRAPH_BOUND_NOTE)
    del pb, pn
    log(f"{n_walk} ok: {nodes.shape[0]} lanes ({tag}; plain {plain_ms / 1e3:.1f} s)")

    # K12: the path's traversals against the plain version, every outer
    # step: at D = 32 every lane (the record, as phase 7's), at the default
    # D = k + 1 the first LONGK_DEEP_LANES (lanes are independent)
    err, plain_ms = 0, {}
    for D, nl in ((32, starts.shape[0]), (k + 1, LONGK_DEEP_LANES)):
        tb, tn = trav[D]
        (pb, pn), plain_ms[D] = timed(lambda: dbg_traverse_plain(
            dbg.bitset, starts[:nl], dbg.n_hashes, dbg.n_words, dbg.seed, k, S, D))
        err = max(err, max_abs_err(tb[:nl], pb), max_abs_err(tn[:nl], pn))
        del pb, pn
        log(f"{n_trav} ok at D = {D}: {nl} lanes, {S} steps ({tag}; plain "
            f"{plain_ms[D] / 1e3:.1f} s)")
    records[n_trav] = record(err, cuda_ms(lambda: dbg.traverse(starts, S, 32), 5), plain_ms[32],
                             nbytes(starts, dbg.bitset, *trav[32]), bound_note=GRAPH_BOUND_NOTE)
    fig["traverse_deep_ms"] = cuda_ms(lambda: dbg.traverse(starts, S), 3)
    fig["traverse_deep_plain_ms"] = plain_ms[k + 1]
    for n in names:
        records[n]["launches"] = launches[counter(n)]
    return fig


def longk_phase(records: dict, hand: dict) -> dict:
    """Phase 10: K11, K15 and K13 on their adversarial cases past k = 64, then
    longk_checks at k = 127 (W = 8) on the 200,000 reads of 250 bp and their
    1,777,017 solid k-mers (PIN127's), then at k = 255 (W = 16) on phase 9's
    131,072 reads of 300-600 bp and their solid set."""
    k13_adversarial(tuple(k for k in K13_KS if k > 64))  # K11's and K15's: the adversarial child
    return {f"k{k}": longk_checks(records, names, hand.pop(k), k)
            for k, names in ((K127, LONGK8), (K255, LONGK16))}


def fastq_codes(path: str) -> tuple:
    """The sequence lines of a FASTQ of one read length (gen_fastq's) as
    (n, L) uint8 codes (A, C, G, T = 0..3) and (n,) int32 lengths."""
    import numpy as np

    seqs = [s for s in seq_lines(path) if s]
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"CGT", np.uint8)] = (1, 2, 3)
    codes = lut[np.frombuffer(b"".join(seqs), np.uint8)].reshape(len(seqs), -1)
    return codes, np.full(len(seqs), codes.shape[1], np.int32)


def long_reads(n: int, lmin: int, lmax: int) -> tuple:
    """n reads of lmin..lmax bp made as gen_fastq makes its reads (the bench
    contig's seed and size, 1% substitutions, every other read reverse-
    complemented), as (n, lmax) uint8 codes, zero past each read, and (n,)
    int32 lengths."""
    import numpy as np

    rng = np.random.default_rng(0xBE7C4)
    contig = rng.integers(0, 4, PIN["contig_len"], dtype=np.uint8)
    lengths = rng.integers(lmin, lmax + 1, n).astype(np.int32)
    starts = rng.integers(0, contig.size - lmax, n)
    j = np.arange(lmax)
    codes = contig[starts[:, None] + j]
    mut = rng.random((n, lmax)) < 0.01
    codes[mut] = (codes[mut] + rng.integers(1, 4, int(mut.sum()))) & 3
    inside = j[None, :] < lengths[:, None]
    rc = np.where(inside, lengths[:, None] - 1 - j, j)  # reverse within the read
    odd = np.arange(n) % 2 == 1
    codes[odd] = 3 - np.take_along_axis(codes[odd], rc[odd], axis=1)
    codes[~inside] = 0
    return codes, lengths


# ---------------------------------------------------------------------------
# phase 5: other widths and modes, the card against the CPU
# ---------------------------------------------------------------------------

# (label, corpus kind, LeonConfig fields): lossy qualities (the confirmed-
# position bits), one-word keys (k <= 16), reads past 255 walk steps (the
# 6-u16 per-read layout), the BLOOM section; then the multiword route at
# k = 32, 48 and 64, and past four words at k = 65 (W = 5), 96 (an even k,
# W = 6) and 255 (W = 16, on reads of 300-600 bp, in chunks of 64 reads and
# slabs of 2**14 k-mers merged at every slab: K23 at W = 16); then the k = 65
# and k = 255 corpus kinds with the device unitig build over W-word rows
V255 = "fasta k=255, reads of 300-600 bp"
V255_MERGES = dict(batch_reads=64, count_slab_kmers=1 << 14, count_merge_factor=1)
V65_DEVICE = "fastq lossy k=65, reads of 100-250 bp, device unitig build"
V255_DEVICE = f"{V255}, device unitig build"
VARIANTS = [
    ("fastq lossy k=31", "fastq", {}),
    ("fastq lossless k=15", "fastq", dict(lossless=True, kmer_size=15)),
    ("fasta wrapped, reads to 300 bp, k=31", "fasta", {}),
    ("fasta k=16, BLOOM section", "fasta", dict(kmer_size=16, unitig_sections=False)),
    ("fastq lossy k=32", "fastq", dict(kmer_size=32)),
    ("fastq lossless k=48", "fastq", dict(lossless=True, kmer_size=48)),
    ("fasta k=64, BLOOM section", "fasta", dict(kmer_size=64, unitig_sections=False)),
    ("fastq lossy k=65, reads of 100-250 bp", "fastq250", dict(kmer_size=65)),
    ("fasta k=96, BLOOM section", "fasta", dict(kmer_size=96, unitig_sections=False)),
    (V255, "fasta600", dict(kmer_size=255, **V255_MERGES)),
    (V65_DEVICE, "fastq250", dict(kmer_size=65, unitig_device_max_kmers=1 << 30)),
    (V255_DEVICE, "fasta600", dict(kmer_size=255, unitig_device_max_kmers=1 << 30)),
]
# the card runs that give the W = 16 records' launches: the multiword
# kernels' from V255, K5-K8's from V255_DEVICE

# corpus kind -> (format, read lengths, reads)
CORPORA = {"fastq": ("fastq", 60, 100, 1500), "fasta": ("fasta", 150, 300, 1500),
           "fastq250": ("fastq", 100, 250, 1500), "fasta600": ("fasta", 300, 600, 400)}


def write_corpus(path: str, kind: str, seed: int) -> None:
    """Reads with 1% substitutions, half reverse-complemented, a few with N
    runs, from a 3 kbp contig (CORPORA): FASTQ, or FASTA wrapped at 70
    columns."""
    import numpy as np

    fmt, lmin, lmax, n = CORPORA[kind]
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contig = rng.integers(0, 4, 3000, dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            ln = int(rng.integers(lmin, lmax + 1))
            st = int(rng.integers(0, contig.size - ln))
            r = contig[st : st + ln].copy()
            mut = rng.random(ln) < 0.01
            r[mut] = (r[mut] + 1) & 3
            if i % 2:
                r = (3 - r)[::-1]
            s = bases[r].tobytes()
            if i % 97 == 0:
                s = s[:10] + b"NNNNN" + s[15:]
            if fmt == "fastq":
                q = rng.integers(33, 74, ln).astype(np.uint8).tobytes()
                f.write(b"@v%d %d\n%s\n+\n%s\n" % (i, ln, s, q))
            else:
                f.write(b">v%d\n" % i + b"".join(s[j : j + 70] + b"\n"
                                                 for j in range(0, ln, 70)))


def variants() -> list:
    """Each variant's archive compressed on the card equals the one the
    plain (CPU) path writes — which the CPU tests hold equal to leon_tpu's —
    and the card decodes it: byte-exact for lossless modes, sequence-exact
    and equal to the CPU decode for lossy qualities. Returns each variant's
    launch counts on the card (compress and decompress), by label."""
    import torch

    from leon_tpu_torch import LeonConfig, kernels, pipeline

    os.makedirs(WORK, exist_ok=True)
    card_launches = {}
    for i, (label, kind, kw) in enumerate(VARIANTS):
        src = os.path.join(WORK, f"variant{i}.{CORPORA[kind][0]}")
        write_corpus(src, kind, 100 + i)
        cfg = LeonConfig(**kw)
        data = {}
        for side, d in (("card", "cuda"), ("cpu", "cpu")):
            arc = f"{src}.{side}.leon"
            kernels.launches.clear()
            torch.cuda.synchronize()
            pipeline.compress(src, arc, cfg=cfg, device=d)
            pipeline.decompress(arc, f"{arc}.out", cfg=cfg, device=d)
            if side == "card":
                torch.cuda.synchronize()
                card_launches[label] = dict(kernels.launches)
            with open(arc, "rb") as f, open(f"{arc}.out", "rb") as g:
                data[side] = (f.read(), g.read())
        if data["card"] != data["cpu"]:
            raise AssertionError(f"variant {label}: the card's archive or output differs "
                                 "from the plain path's")
        with open(src, "rb") as f:
            original = f.read()
        lossy = CORPORA[kind][0] == "fastq" and not kw.get("lossless")
        out = data["card"][1]
        if (out.split(b"\n")[1::4] != original.split(b"\n")[1::4]) if lossy else out != original:
            raise AssertionError(f"variant {label}: round trip is not exact")
        log(f"variant ok: {label}, archive {len(data['card'][0])} B, card launches "
            f"{card_launches[label]}")
    # k = 65's top keys differ in 34 bits, below count.BUCKET_MIN_BITS: K22
    # sorts them on the passes route, so K24 and K25 have no launch to show
    v65 = tuple(n for n in no_merges(WIDE) if counter(n) not in ("radix_bucket",
                                                                 "radix_oversize"))
    for label, names in ((V255, WIDE16), (V65_DEVICE, v65 + DEVICE_BUILD),
                         (V255_DEVICE, no_merges(WIDE16) + DEVICE_BUILD)):
        missing = [n for n in names if card_launches[label].get(counter(n), 0) < 1]
        if missing:
            raise AssertionError(f"variant {label}: kernels never launched: {missing}")
    return card_launches


# ---------------------------------------------------------------------------
# phase 6: the main path
# ---------------------------------------------------------------------------


def gen_fastq(path: str, n_reads: int, contig_len: int, read_len: int = READ_LEN) -> None:
    """The bench corpus (a copy of bench.py:36-59, the same RNG calls, so
    the pinned archives stay the same bytes): reads of read_len bp (100 in
    the bench) from a random contig, 1% substitutions, every other read
    reverse-complemented."""
    import numpy as np

    rng = np.random.default_rng(0xBE7C4)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    contig = rng.integers(0, 4, contig_len, dtype=np.uint8)
    starts = rng.integers(0, contig_len - read_len, n_reads)
    with open(path, "wb") as f:
        chunks = []
        for i in range(n_reads):
            r = contig[starts[i] : starts[i] + read_len].copy()
            mut = rng.random(read_len) < 0.01
            r[mut] = (r[mut] + rng.integers(1, 4, int(mut.sum()))) & 3
            if i % 2:
                r = (3 - r)[::-1]
            q = rng.integers(35, 70, read_len).astype(np.uint8)
            chunks.append(
                b"@SRRX.%d %d/1\n%s\n+\n%s\n"
                % (i, i, bases[r].tobytes(), q.tobytes())
            )
            if len(chunks) >= 4096:
                f.write(b"".join(chunks))
                chunks = []
        f.write(b"".join(chunks))


def seq_lines(path: str) -> list:
    with open(path, "rb") as f:
        return f.read().split(b"\n")[1::4]


def corpora() -> dict:
    """Phase 6's two corpora, generated once into WORK: the bench corpus
    (500k x 100 bp) and 200k reads x 250 bp from the same contig and seed
    (PIN127's)."""
    os.makedirs(WORK, exist_ok=True)
    paths = {}
    for name, n_reads, read_len in (("ecoli_500k", PIN["n_reads"], READ_LEN),
                                    ("ecoli_200k_250bp", PIN127["n_reads"], PIN127["read_len"])):
        src = paths[name] = os.path.join(WORK, f"{name}.fastq")
        t = time.time()
        gen_fastq(src, n_reads, PIN["contig_len"], read_len)
        log(f"corpus {name}: {os.path.getsize(src)} bytes in {time.time() - t:.1f} s (host)")
    return paths


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def check_pin(label: str, arc: str, st: dict, pin: dict) -> tuple:
    """Raise unless the archive and its stats are the reference's (pin);
    returns the archive's size and SHA-256."""
    size, digest = os.path.getsize(arc), sha256_of(arc)
    if ((size, digest) != (pin["bytes"], pin["sha256"])
            or st["n_anchored"] != pin["n_anchored"]
            or st["n_solid_kmers"] != pin.get("n_solid", st["n_solid_kmers"])):
        raise AssertionError(f"{label}: archive {size} B sha256 {digest} n_anchored "
                             f"{st['n_anchored']} n_solid {st['n_solid_kmers']} != the "
                             f"reference's {pin}")
    return size, digest


class MergeGuard:
    """A context in which every counter merge (ops.count._SlabCounter._merged)
    is watched, restored on exit: inside a merge torch.cat raises on a CUDA
    tensor, and a merge that launches K22 (radix_sort) or K20 (sort_ties), or
    that merges two runs or more without launching K23 (merge_path), raises.
    `merges` counts the merges of two runs or more."""

    def __enter__(self):
        import torch

        from leon_tpu_torch import kernels
        from leon_tpu_torch.ops import count

        self.merges = 0
        self.saved = count._SlabCounter._merged
        merged, guard = self.saved, self

        def no_cat(tensors, *args, **kwargs):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
                raise AssertionError("torch.cat of CUDA tensors inside a merge")
            return cat(tensors, *args, **kwargs)

        def watched(counter, want_hist):
            global_cat = torch.cat
            n_runs = sum(1 for r in counter._runs if r[1].numel())
            before = {n: kernels.launches[n] for n in ("radix_sort", "sort_ties", "merge_path")}
            torch.cat = no_cat
            try:
                out = merged(counter, want_hist)
            finally:
                torch.cat = global_cat
            did = {n: kernels.launches[n] - c for n, c in before.items()}
            if counter.device.type == "cuda":
                if did["radix_sort"] or did["sort_ties"] or (n_runs >= 2 and not did["merge_path"]):
                    raise AssertionError(f"a merge of {n_runs} runs launched {did}")
                guard.merges += n_runs >= 2
            return out

        cat = torch.cat
        count._SlabCounter._merged = watched
        return self

    def __exit__(self, *exc):
        from leon_tpu_torch.ops import count

        count._SlabCounter._merged = self.saved
        return False


class CudaGuards(MergeGuard):
    """A context in which torch.sort, ops.count.words_to_planes and
    ops.count._top_keys raise on a CUDA tensor (they still run on CPU
    tensors), and every merge is watched as MergeGuard watches it, restored
    on exit: phase 6 shows that the count path sorts on K22, merges runs on
    K23 where they lie and reduces a merged run with K14's row policy, no
    library sort and no elementwise plane or key building on the card."""

    def __enter__(self):
        import torch

        from leon_tpu_torch.ops import count

        super().__enter__()
        self.saved_fns = (torch.sort, count.words_to_planes, count._top_keys)

        def guard(name, fn):
            def call(x, *args, **kwargs):
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    raise AssertionError(f"{name} called on a CUDA tensor on the main path")
                return fn(x, *args, **kwargs)
            return call

        torch.sort = guard("torch.sort", self.saved_fns[0])
        count.words_to_planes = guard("ops.count.words_to_planes", self.saved_fns[1])
        count._top_keys = guard("ops.count._top_keys", self.saved_fns[2])
        return self

    def __exit__(self, *exc):
        import torch

        from leon_tpu_torch.ops import count

        torch.sort, count.words_to_planes, count._top_keys = self.saved_fns
        return super().__exit__(*exc)


def main_path(records: dict, card: str, paths: dict) -> None:
    import torch

    from leon_tpu_torch import LeonConfig, kernels, pipeline

    walls = {}
    # the default (native host unitig builder on a thread) drives K1-K4; the
    # device-build configuration drives K1-K8; k = 63 and k = 127 drive the
    # multiword route (K17, K14, K16, K18 + walk_pack, K19) at W = 4 and 8,
    # and again with the device build (K5-K8 over W-word rows). The kernels
    # line takes K1-K4's counts from the default run, K5-K8's from the
    # device-build runs and the multiword kernels' from the k = 63 and
    # k = 127 runs.
    default_path = [k for k in COMPRESS if k not in DEVICE_BUILD]
    for label, corpus, extra, path, read, pin in (
            ("default", "ecoli_500k", {}, default_path, default_path, PIN),
            ("device unitig build", "ecoli_500k", {"unitig_device_max_kmers": 1 << 30},
             list(COMPRESS), list(DEVICE_BUILD), PIN),
            (f"k={K63}", "ecoli_500k", {"kmer_size": K63}, list(no_merges(WIDE)) + ["walk_pack"],
             list(no_merges(WIDE)), PIN63),
            (f"k={K127}, 250 bp", "ecoli_200k_250bp", {"kmer_size": K127},
             list(no_merges(WIDE8)) + ["walk_pack"], list(no_merges(WIDE8)), PIN127),
            (f"k={K63}, device unitig build", "ecoli_500k",
             {"kmer_size": K63, "unitig_device_max_kmers": 1 << 30},
             list(no_merges(WIDE) + UNITIG4) + ["walk_pack"], list(UNITIG4), PIN63),
            (f"k={K127}, 250 bp, device unitig build", "ecoli_200k_250bp",
             {"kmer_size": K127, "unitig_device_max_kmers": 1 << 30},
             list(no_merges(WIDE8) + UNITIG8) + ["walk_pack"], list(UNITIG8), PIN127)):
        src = paths[corpus]
        arc = os.path.join(WORK, f"{corpus}.leon")
        out = os.path.join(WORK, f"{corpus}.out.fastq")
        n = len(seq_lines(src))
        cfg = LeonConfig(noheader=True, noqual=True, **extra)
        kernels.launches.clear()
        torch.cuda.synchronize()
        with CudaGuards() as guards:
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
        size, digest = check_pin(label, arc, st, pin)
        missing = [k for k in path if launches.get(counter(k), 0) < 1]
        if missing:
            raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")
        for k in read:
            records[k]["launches"] = launches[counter(k)]
        walls[label] = (t_c, t_d)
        log(f"main path ({label}) ok: archive {size} B = the reference's (sha256 "
            f"{digest[:16]}), ratio {st['ratio']:.3f}, round trip exact, launches {launches}; "
            f"{guards.merges} merges of runs, each on K23 with no K22 or K20 launch and no "
            f"torch.cat of CUDA runs")
        log(f"compress {n / t_c:.1f} reads/s ({t_c:.2f} s), decompress {n / t_d:.1f} reads/s "
            f"({t_d:.2f} s) on {card} (host clock, end to end)")
        log(f"compress spans: {json.dumps(st.get('span_s', {}))}")
    log(f"compress, decompress walls (s), one call: {json.dumps(walls)}")



# ---------------------------------------------------------------------------
# phase 11: inputs past one card's limits
# ---------------------------------------------------------------------------

# (a): slabs of 2**22 k-mers (a 65,536-read chunk is a slab of its own), a
# merge at every second slab, every merged run of 2**21 rows or more spilled
FORCED_SPILL = {"stream_threshold_bytes": 1, "count_slab_kmers": 1 << 22,
                "count_merge_factor": 1, "count_spill_rows": 1 << 21}
# (b): over 1 GiB of FASTQ in fixed 220-byte records
LARGE = {"n_reads": 5_000_000, "contig_len": 20_000_000, "read_len": 100, "seed": 0x5EED}
LARGE_EXTRA = {"count_spill_rows": 1 << 24, "count_merge_factor": 2}
# The reference's archive of LARGE's corpus (gen_large_fastq, sha256
# 08def1b7...2cf5d6): leon_tpu.pipeline.compress(src, out,
# cfg=LeonConfig(noheader=True, noqual=True, **LARGE_EXTRA)) with jax on the
# CPU (JAX_PLATFORMS=cpu; about 10 min on 8 cores, 11.5 GB peak RSS).
LARGE_PIN = {
    "bytes": 35_819_506,
    "sha256": "52d510e243f5a9dff784fe53e3e704baed051ad230d1427c6232cf1b1bf541ca",
    "n_solid": 20_017_798,
}
LARGE_HEADER = b"@SRRX."  # then 9 digits and a newline: 16 bytes


def gen_large_fastq(path: str) -> None:
    """LARGE's corpus, vectorised: reads from a random contig, 1%
    substitutions, every other read reverse-complemented, headers
    "@SRRX.<9 digits>", qualities 35-69, written 250,000 records at a time."""
    import numpy as np

    n, G, L = LARGE["n_reads"], LARGE["contig_len"], LARGE["read_len"]
    rng = np.random.default_rng(LARGE["seed"])
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    contig = rng.integers(0, 4, G, dtype=np.uint8)
    hl = len(LARGE_HEADER) + 10
    rec_len = hl + 2 * (L + 1) + 2
    with open(path, "wb") as f:
        for s in range(0, n, 250_000):
            m = min(250_000, n - s)
            idx = np.arange(s, s + m)
            r = contig[rng.integers(0, G - L, m)[:, None] + np.arange(L)]
            mut = rng.random((m, L)) < 0.01
            r = np.where(mut, (r + rng.integers(1, 4, (m, L), dtype=np.uint8)) & 3, r)
            odd = idx % 2 == 1
            r[odd] = (3 - r[odd])[:, ::-1]
            rec = np.empty((m, rec_len), np.uint8)
            rec[:, : len(LARGE_HEADER)] = np.frombuffer(LARGE_HEADER, np.uint8)
            for j in range(9):
                rec[:, len(LARGE_HEADER) + j] = 48 + (idx // 10 ** (8 - j)) % 10
            rec[:, hl - 1] = 10
            rec[:, hl : hl + L] = bases[r]
            rec[:, hl + L] = 10
            rec[:, hl + L + 1 : hl + L + 3] = np.frombuffer(b"+\n", np.uint8)
            rec[:, hl + L + 3 : hl + 2 * L + 3] = rng.integers(35, 70, (m, L), dtype=np.uint8)
            rec[:, -1] = 10
            f.write(rec.tobytes())


def large_seqs_equal(src: str, out: str) -> bool:
    """The decompressed FASTQ's sequence lines equal LARGE's reads (the
    output's headers are synthesised, so its lines are found by newline)."""
    import numpy as np

    n, L = LARGE["n_reads"], LARGE["read_len"]
    hl = len(LARGE_HEADER) + 10
    want = np.fromfile(src, dtype=np.uint8).reshape(n, -1)[:, hl : hl + L]
    got = np.fromfile(out, dtype=np.uint8)
    nl = np.flatnonzero(got == 10)
    if nl.size != 4 * n:
        return False
    starts = nl[0::4] + 1
    if not (nl[1::4] - starts == L).all():
        return False
    return bool((got[starts[:, None] + np.arange(L)] == want).all())


def large_corpus_child() -> int:
    """Phase 11 (b), run by the parent as its own process so that its peak
    host RSS is its own: compress LARGE's corpus in stream mode with its
    spills, decompress it, then compress it in memory and unspilled; print
    one JSON line of what was measured. Raises on a failed check."""
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from leon_tpu_torch import LeonConfig, kernels, pipeline

    os.makedirs(WORK, exist_ok=True)
    src = os.path.join(WORK, "large_5M.fastq")
    arc, mem_arc = os.path.join(WORK, "large.leon"), os.path.join(WORK, "large_mem.leon")
    out = os.path.join(WORK, "large.out.fastq")
    t = time.time()
    gen_large_fastq(src)
    fig = {"input_bytes": os.path.getsize(src), "gen_s": time.time() - t}
    if fig["input_bytes"] <= 1 << 30:
        raise AssertionError(f"the large corpus is {fig['input_bytes']} B, not over 1 GiB")
    kernels.lib()
    cfg = LeonConfig(noheader=True, noqual=True, **LARGE_EXTRA)
    kernels.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.time()
    st = pipeline.compress(src, arc, cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    fig["compress_s"] = time.time() - t
    fig["compress_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    fig["compress_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    fig["launches"] = dict(kernels.launches)
    missing = [n for n in ("kmer_scan", "runs", "bloom_build", "walk_encode", "walk_pack")
               if fig["launches"].get(n, 0) < 1]
    if missing:
        raise AssertionError(f"large corpus: kernels never launched: {missing}")
    for key in ("stream_mode", "count_spills", "n_reads", "n_solid_kmers", "abundance",
                "output_bytes", "ratio", "span_s"):
        fig[key] = st[key]
    if not st["stream_mode"] or st["count_spills"] < 2:
        raise AssertionError(f"large corpus: stream mode {st['stream_mode']}, spills "
                             f"{st['count_spills']}: wanted stream mode and two spills or more")
    log(f"large corpus: {fig['input_bytes']} B took stream mode: {st['stream_mode']}; "
        f"spills: {st['count_spills']}")
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    dst = pipeline.decompress(arc, out, cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    fig["decompress_s"] = time.time() - t
    fig["decompress_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    fig["decompress_span_s"] = dst["span_s"]
    fig["peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if not large_seqs_equal(src, out):
        raise AssertionError("large corpus: sequence round trip is not exact")
    os.unlink(out)
    mem_cfg = LeonConfig(noheader=True, noqual=True, stream_threshold_bytes=fig["input_bytes"],
                         count_spill_rows=1 << 30)
    t = time.time()
    mst = pipeline.compress(src, mem_arc, cfg=mem_cfg, device="cuda")
    torch.cuda.synchronize()
    fig["in_memory_compress_s"] = time.time() - t
    if mst["stream_mode"] or mst["count_spills"]:
        raise AssertionError("large corpus: the comparison run streamed or spilled")
    fig["sha256"], want = sha256_of(arc), sha256_of(mem_arc)
    if fig["sha256"] != want:
        raise AssertionError(f"large corpus: the streamed, spilled archive {fig['sha256']} != "
                             f"the in-memory, unspilled archive {want}")
    got = (os.path.getsize(arc), fig["sha256"], st["n_solid_kmers"])
    if got != (LARGE_PIN["bytes"], LARGE_PIN["sha256"], LARGE_PIN["n_solid"]):
        raise AssertionError(f"large corpus: archive (bytes, sha256, n_solid) {got} is not the "
                             f"reference's {LARGE_PIN}")
    for p in (src, arc, mem_arc):
        os.unlink(p)
    print(json.dumps({"large_corpus": fig}), flush=True)
    return 0




def stream_phase(records: dict, paths: dict) -> dict:
    """Phase 11 (see the module docstring): (a) stream mode with a forced
    multi-run spill on phase 6's corpora, (b) the corpus over 1 GiB in a
    child process, (c) a checkpoint resume, (d) profile_dir. The spilled runs
    at k = 63 and 127 (host builder) give the launches of K23's records
    merge_path:rows and :rows8."""
    import torch

    from leon_tpu_torch import LeonConfig, kernels, pipeline

    fig = {}
    host_path = ["kmer_scan", "runs", "merge_path", "bloom_build", "walk_encode", "walk_pack"]
    wide_path = ["kmer_scan_halves", "plane_rows", "sort_ties", "word_runs", "merge_path",
                 "word_runs_rows", "bloom_build_words", "walk_encode_words", "walk_pack"]
    device_build = ["unitig_links", "unitig_double", "unitig_emit", "solid_lookup"]
    for label, corpus, k, pin in (("k=31", "ecoli_500k", K, PIN),
                                  (f"k={K63}", "ecoli_500k", K63, PIN63),
                                  (f"k={K127}, 250 bp", "ecoli_200k_250bp", K127, PIN127)):
        for builder, dev_max in (("host builder", 0), ("device builder", 1 << 30)):
            name = f"{label}, {builder}"
            arc = os.path.join(WORK, "stream.leon")
            cfg = LeonConfig(noheader=True, noqual=True, kmer_size=k,
                             unitig_device_max_kmers=dev_max, **FORCED_SPILL)
            kernels.launches.clear()
            with MergeGuard() as guard:
                t = time.time()
                st = pipeline.compress(paths[corpus], arc, cfg=cfg, device="cuda")
                torch.cuda.synchronize()
                wall = time.time() - t
            launches = dict(kernels.launches)
            check_pin(f"stream, spilled ({name})", arc, st, pin)
            if not st["stream_mode"] or st["count_spills"] < 2:
                raise AssertionError(f"{name}: stream mode {st['stream_mode']}, spills "
                                     f"{st['count_spills']}")
            path = (host_path if k == K else wide_path) + (device_build if dev_max else [])
            missing = [n for n in path if launches.get(n, 0) < 1]
            if missing:
                raise AssertionError(f"{name}: kernels never launched: {missing}")
            if guard.merges < 1:
                raise AssertionError(f"{name}: no merge of runs")
            if k != K and not dev_max:
                records["merge_path:rows" + ("" if k == K63 else "8")]["launches"] = \
                    launches["merge_path"]
            fig[name] = {"compress_s": wall, "spills": st["count_spills"],
                         "host_merge_s": st["span_s"].get("count.fin.host_merge"),
                         "merges": guard.merges, "launches": launches}
            log(f"stream, spilled ({name}) ok: archive = the reference's, stream mode, "
                f"{st['count_spills']} spills, {guard.merges} merges of runs (each on K23, no "
                f"K22 or K20 inside, no torch.cat of CUDA runs), {wall:.2f} s, "
                f"launches {launches}")

    # the child needs the card's memory: the cache this process kept from the
    # earlier phases goes back first
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before the large corpus: this process holds {torch.cuda.memory_allocated()} B "
        f"of the card's memory ({torch.cuda.memory_reserved()} B reserved)")
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--large-corpus"],
                         capture_output=True, text=True, timeout=900)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr[-8000:])
    if res.returncode != 0:
        raise AssertionError(f"large corpus: the child exited {res.returncode}")
    fig["large_corpus"] = json.loads(res.stdout.strip().splitlines()[-1])["large_corpus"]

    src = paths["ecoli_500k"]
    ck = os.path.join(WORK, "count.ckpt")
    if os.path.exists(ck):
        os.unlink(ck)
    cfg = LeonConfig(noheader=True, noqual=True, checkpoint=ck)
    arc = os.path.join(WORK, "ckpt.leon")
    st = pipeline.compress(src, arc, cfg=cfg, device="cuda")
    check_pin("checkpoint written", arc, st, PIN)
    kernels.launches.clear()
    t = time.time()
    st = pipeline.compress(src, arc, cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    fig["resumed_compress_s"] = time.time() - t
    check_pin("checkpoint resumed", arc, st, PIN)
    if not st["resumed"] or kernels.launches["kmer_scan"] or kernels.launches["runs"]:
        raise AssertionError(f"checkpoint: resumed {st['resumed']}, launches "
                             f"{dict(kernels.launches)}: K1 or K2 ran on a resumed count")
    log(f"checkpoint resume ok: archive = the reference's, K1 and K2 not launched, "
        f"{fig['resumed_compress_s']:.2f} s, launches {dict(kernels.launches)}")

    prof = os.path.join(WORK, "profile")
    if os.path.isdir(prof):
        for p in os.listdir(prof):
            os.unlink(os.path.join(prof, p))
    st = pipeline.compress(src, arc, cfg=LeonConfig(noheader=True, noqual=True, profile_dir=prof),
                           device="cuda")
    check_pin("profile_dir", arc, st, PIN)
    traces = [p for p in os.listdir(prof) if p.endswith(".pt.trace.json")]
    if len(traces) != 1 or os.path.getsize(os.path.join(prof, traces[0])) == 0:
        raise AssertionError(f"profile_dir: traces {traces}")
    log(f"profile_dir ok: trace {traces[0]} ({os.path.getsize(os.path.join(prof, traces[0]))} B), "
        "archive = the reference's")
    return fig


# ---------------------------------------------------------------------------
# phase 12: several devices
# ---------------------------------------------------------------------------

MESH = 4
# label -> (k, unitig_device_max_kmers, pin, the count, encode and decode kernels)
MESH_RUNS = {
    "k=31, host builder": (K, 0, PIN, ("kmer_scan", "walk_encode", "walk_decode")),
    f"k={K63}, device builder": (K63, 1 << 30, PIN63,
                                 ("kmer_scan_halves", "walk_encode_words", "walk_decode_words")),
}
DIST_RANKS = 2


def distributed_rank_child(rank: int, n_ranks: int, pg: str, src: str, arc: str) -> int:
    """One rank of phase 12 (b): compress_distributed of src into arc over a
    gloo group of n_ranks processes (a file rendezvous at pg), on the
    rank's default device; prints one JSON line (stats, launches, wall)."""
    import torch

    sys.path.insert(0, ROOT)
    from leon_tpu_torch import LeonConfig, kernels
    from leon_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{pg}", n_ranks, rank)
    try:
        kernels.lib()
        torch.distributed.barrier()
        t = time.time()
        st = distributed.compress_distributed(src, arc, cfg=LeonConfig(noheader=True, noqual=True))
        torch.cuda.synchronize()
        torch.distributed.barrier()
        st["wall_s"] = time.time() - t
        st["launches"] = dict(kernels.launches)
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "stats": st}), flush=True)
    return 0


def mesh_phase(paths: dict, card: str, devices=("cuda:0",) * MESH,
               n_ranks: int = DIST_RANKS) -> dict:
    """Phase 12 (see the module docstring): the mesh over `devices`, then
    n_ranks processes."""
    import torch

    from leon_tpu_torch import LeonConfig, kernels, pipeline

    fig = {}
    src = paths["ecoli_500k"]
    n = len(seq_lines(src))
    devices = list(devices)
    for label, (k, dev_max, pin, (scan, enc, dec)) in MESH_RUNS.items():
        arc = os.path.join(WORK, "mesh.leon")
        out = os.path.join(WORK, "mesh.out.fastq")
        cfg = LeonConfig(noheader=True, noqual=True, kmer_size=k, unitig_device_max_kmers=dev_max,
                         mesh_devices=len(devices))
        kernels.launches.clear()
        torch.cuda.synchronize()
        t = time.time()
        st = pipeline.compress(src, arc, cfg=cfg, device=devices)
        torch.cuda.synchronize()
        t_c = time.time() - t
        c_launches = dict(kernels.launches)
        kernels.launches.clear()
        t = time.time()
        dst = pipeline.decompress(arc, out, cfg=cfg, device=devices)
        torch.cuda.synchronize()
        t_d = time.time() - t
        d_launches = dict(kernels.launches)
        if st["mesh_devices"] != len(devices) or dst["mesh_devices"] != len(devices):
            raise AssertionError(f"mesh ({label}): ran on {st['mesh_devices']} / "
                                 f"{dst['mesh_devices']} shards, not {len(devices)}")
        check_pin(f"mesh ({label})", arc, st, pin)
        if seq_lines(src) != seq_lines(out):
            raise AssertionError(f"mesh ({label}): the decode on the mesh is not the input")
        chunks = -(-n // B)
        got = {scan: c_launches.get(scan, 0), enc: c_launches.get(enc, 0),
               dec: d_launches.get(dec, 0)}
        if min(got.values()) < len(devices) * chunks:
            raise AssertionError(f"mesh ({label}): launches {got}, fewer than {len(devices)} "
                                 f"shards x {chunks} chunks")
        fig[label] = {"compress_s": t_c, "decompress_s": t_d, "compress_launches": c_launches,
                      "decompress_launches": d_launches}
        log(f"mesh of {len(devices)} shards on {devices} ({label}) ok: archive = the reference's, "
            f"decode = the input; compress {t_c:.2f} s, decompress {t_d:.2f} s on {card}; "
            f"launches {got}")

    pg = os.path.join(WORK, "dist.pg")
    arc = os.path.join(WORK, "dist.leon")
    for p in (pg, arc):
        if os.path.exists(p):
            os.unlink(p)
    t = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--distributed-rank",
                               str(r), str(n_ranks), pg, src, arc],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n_ranks)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.time() - t
    ranks = {}
    for r, (proc, (so, se)) in enumerate(zip(procs, outs)):
        sys.stderr.write(se[-4000:])
        if proc.returncode != 0:
            raise AssertionError(f"distributed: rank {r} exited {proc.returncode}")
        ranks[r] = json.loads(so.strip().splitlines()[-1])["stats"]
    st0 = ranks[0]
    if any(s["n_processes"] != n_ranks or not s["device"].startswith("cuda")
           for s in ranks.values()):
        raise AssertionError(f"distributed: ranks ran as {[(s['n_processes'], s['device']) for s in ranks.values()]}")
    st0 = dict(st0, n_anchored=sum(s["n_anchored_local"] for s in ranks.values()))
    check_pin("distributed", arc, st0, PIN)
    missing = [(r, name) for r, s in ranks.items() for name in ("kmer_scan", "walk_encode")
               if s["launches"].get(name, 0) < 1]
    if missing:
        raise AssertionError(f"distributed: kernels never launched: {missing}")
    fig["distributed"] = {"wall_s": wall, "ranks": {r: {"compress_s": s["wall_s"],
                                                        "launches": s["launches"],
                                                        "traffic_bytes": s["traffic_bytes"],
                                                        "parse_sharded": s["parse_sharded"]}
                                                    for r, s in ranks.items()}}
    log(f"compress_distributed over {n_ranks} gloo ranks ok (devices "
        f"{[s['device'] for s in ranks.values()]}): archive = the reference's; {wall:.2f} s "
        f"from spawn to exit, compress {[round(s['wall_s'], 3) for s in ranks.values()]} s on "
        f"{card}")
    return fig


# The adversarial checks whose plain versions hold the host longest (K5 and
# K7's runs, K11's walks, K15's and K18/K19's reads: each plain version a
# Python loop of small launches) run in a child process, `python3
# chip_smoke.py --adversarial`, started before phase 4 and joined after phase
# 12, while the parent runs phases that time no kernel (their launches and
# walls only; phase 4 logs the yeast build's times, and these share the card
# with the child).
ADVERSARIAL = "--adversarial"


def adversarial_child() -> int:
    """The checks the parent hands to a child (see ADVERSARIAL), each of
    which raises on a kernel that differs from its plain version."""
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from leon_tpu_torch import kernels

    kernels.lib()
    k5_adversarial()
    k7_adversarial()
    k11_adversarial(K11_KS)
    k15_adversarial(K15_KS)
    walk_adversarial()
    log("adversarial checks ok: K5, K7, K11, K15, K18, K19")
    return 0


def start_adversarial_child():
    """The adversarial child, its output to a file under WORK."""
    os.makedirs(WORK, exist_ok=True)
    out = open(os.path.join(WORK, "adversarial.log"), "w")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), ADVERSARIAL],
                            stdout=out, stderr=subprocess.STDOUT), out


def join_adversarial_child(child) -> None:
    """Wait for the adversarial child, print its log, raise if it failed."""
    proc, out = child
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    with open(out.name) as f:
        sys.stdout.write(f.read()[-20000:])
    if rc != 0:
        raise AssertionError(f"the adversarial checks' child exited {rc}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: nothing to check", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card, flush=True)
    from leon_tpu_torch import kernels, pipeline

    t0 = time.time()

    def done(phase: str) -> None:
        log(f"{phase} done at {time.time() - t0:.1f} s")

    kernels.lib()
    done("kernel build")
    pipeline.require_native()
    records = {n: {} for n in KERNELS}
    paths = corpora()
    done("corpora")
    bench_state = kernel_checks(records)
    done("phase 3")
    graph_fig = graph_phase(records, bench_state)
    done("phase 7")
    tensor_fig = tensor_phase(records, bench_state)
    done("phase 8")
    wide_fig, hand = widek_phase(records, bench_state, tensor_fig, paths["ecoli_200k_250bp"])
    del bench_state
    done("phase 9")
    longk_fig = longk_phase(records, hand)
    del hand
    done("phase 10")
    child = start_adversarial_child()
    try:
        fig = yeast_phase()
        log(f"[yeast] {json.dumps(fig)}")
        done("phase 4")
        card_launches = variants()
        for names, label in ((WIDE16, V255), (UNITIG16, V255_DEVICE)):
            for n in names:
                records[n]["launches"] = card_launches[label][counter(n)]
        done("phase 5")
        main_path(records, card, paths)
        done("phase 6")
        stream_fig = stream_phase(records, paths)
        done("phase 11")
        mesh_fig = mesh_phase(paths, card)
        done("phase 12")
    finally:
        join_adversarial_child(child)
    done("adversarial child joined")
    log(f"[graph] {json.dumps(graph_fig)}")
    log(f"[tensor] {json.dumps(tensor_fig)}")
    log(f"[multiword kernels] {json.dumps(wide_fig)}")
    log(f"[long-k tensor path and graph] {json.dumps(longk_fig)}")
    log(f"[inputs past one card's limits] {json.dumps(stream_fig)}")
    log(f"[several devices] {card}: {json.dumps(mesh_fig)}")
    out = []
    for name, (src, repl) in KERNELS.items():
        r = records[name]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                    "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "moved_bytes": r["moved_bytes"], "bound_note": r["bound_note"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--large-corpus"]:
        sys.exit(large_corpus_child())
    if sys.argv[1:] == [ADVERSARIAL]:
        sys.exit(adversarial_child())
    if sys.argv[1:2] == ["--distributed-rank"]:
        sys.exit(distributed_rank_child(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7]))
    sys.exit(main())
