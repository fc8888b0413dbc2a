"""Canonical k-mer counting and the solidity threshold (counterpart of
leon_tpu/ops/count.py).

Device half (new): ``runs``, the wrapper of kernel K2 (csrc/count.cu): a
reduce-by-key over a sorted int64 key array that emits each distinct key
with its summed count, in order, and optionally the 256-bin count histogram:
a count pass and a write pass, each warp reducing a stretch of rows, runs
that cross stretches carried as associative Spans. It replaces the
reference's boundary/run-length, compaction, merge-sum, histogram and
solid-compaction programs (count.py:34-85, 208-264, 707-719). The sort
before it is ``radix_sort``, the wrapper of kernel K22 (csrc/sort.cu): a
stable radix sort of int64 keys over the low bits in which the caller says
they may differ, alone or with an int32 payload or the keys' index, the keys
read from an array or, in its first pass, from (N, W) rows' top 64 bits; at
41-63 bits past 8,192 keys two or three passes group the keys by their top 16
or 24 bits and kernels K24 (each bucket sorted in shared memory) and K25
(buckets too large for it, through device memory) finish the sort
(``radix_route``); it
replaces the sorts inside the reference's count programs (``lax.sort``,
count.py:60, 64, 233). Runs that are
already sorted merge by ``merge_path`` / ``merge_path_rows``, the wrappers of
kernel K23 (csrc/sort.cu): a stable merge-path merge of int64 keys or (M, W)
rows with their int32 counts, in pairwise rounds, the runs read in place
(the sort at count.py:233 where its input is runs).

``DeviceCounter`` streams k-mer keys through one slab on the device: the
scan kernel writes into the slab, a full slab is sorted (K22) and reduced to
its distinct run, and runs merge (K23 with the counts, then K2)
once they outgrow ``merge_factor`` slabs. Slab, merge and spill sizes are
the config's (``count_slab_kmers``, ``count_merge_factor``,
``count_spill_rows``). A merged run of ``spill_rows`` rows or more moves to
host RAM (a non-blocking copy into pinned memory, resolved at the next spill
or at finalize) and the device merge restarts empty, so the card holds at
most a spill's rows plus ``merge_factor`` slabs of runs whatever the input's
size. ``finalize`` after a spill merges every run on the host (the native
k-way merge), takes the histogram, cutoff and the exact solid count there,
and sends the solid rows to the card once for the Bloom build
(count.py:285-306, 391-440, 504-524, 592-600, 643-706).

``count_batch`` is the one-shot count of (B, P, W) canonical words (k <=
255, counterpart of count.py:88-104): at W >= 3 ``top_sort`` (one K22 sort
of the valid rows' top 64 bits, read from the rows, with their row index),
then ``sort_ties``, the wrapper of kernel K20 (csrc/count.cu), which gathers
the rows in that order as sign-flipped int64 planes (with a payload a row,
if given, to the row's place) and orders each run of equal top bits by the
lower words (at W <= 2 one K22 sort of the one plane); then ``runs_words``,
the wrapper of kernel K14 (csrc/count.cu), a reduce-by-key of run lengths
over rows of up to 8 planes (W <= 16). ``word_runs`` is K14 in K2's modes (a
counts payload, cutoff, histogram) over the same rows. K14 is K2's two
passes over multi-plane rows.

``WordCounter`` is DeviceCounter for 32 <= k <= 255 (the main path's
multiword route): K17 (ops/kmer.py) writes each chunk's valid k-mers as
planes into the slab; at W >= 3 ``sort_slab`` orders a slab as count_batch
orders its rows: ``plane_rows``, the wrapper of kernel K21 (csrc/count.cu),
turns the planes into (n, W) rows and top keys, one K22 sort of the keys
with their index, then K20 (at W <= 2 one K22 sort of the one plane); K14
reduces slabs; runs merge by K23 over their (M, W) rows and reduce by
``word_runs_rows`` (K14's row policy over rows). ``sort_rows`` (K22 reading
the top keys from the rows, then K20 carrying each row's count to its place)
sorts rows that are not runs: no counter path calls it since K23.
``compact_solid_words`` is the row policy's solid mode, and the Bloom build is K16 over those solid rows. Both counters share
``_SlabCounter``'s slab, flush, merge, spill and finalize, on the
reference's schedule (its bucketed run sizes decide every merge and spill),
and take a chunk as lane shards (``add_shards``, the mesh) and a distinct
run from elsewhere (``ingest_run``, the distributed count). ``merge_counts``
(host) is a copy of count.py:107-170, ``histogram`` of count.py:173-174,
``_bucket_size`` of count.py:267-275, ``range_boundaries`` and
``range_split`` of count.py:722-759, ``auto_cutoff`` of count.py:761-784.
"""

from __future__ import annotations

import ctypes
import sys
from typing import NamedTuple

import numpy as np
import torch

from leon_tpu_torch import kernels
from leon_tpu_torch.ops import bloom
from leon_tpu_torch.ops.kmer import SENTINEL, kmer_scan, kmer_scan_halves, words_for_k
from leon_tpu_torch.state import (keys_from_torch, n_planes, planes_to_words, words_to_keys,
                                  words_to_planes, words_to_torch)
from leon_tpu_torch.utils.trace import span

_I32_MAX = 0x7FFFFFFF
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)  # int64 sign bit (state.words_to_planes' flip)


# ---------------------------------------------------------------------------
# Kernel K22 (radix_sort) and its plain version
# ---------------------------------------------------------------------------

RADIX_TILE = 4096  # keys a tile of a K22 pass (csrc/sort.cu RS_TILE)
RADIX_INDEX = "index"  # the payload of a sort that returns each key's index
# csrc/sort.cu RS_PAY_*: none, int32, the index written as int64 or as
# int32, int32 read and int64 written
_PAY_NONE, _PAY_I32, _PAY_IDX, _PAY_IDX32, _PAY_I32W = range(5)
BUCKET_BITS = 16  # a key's bucket up to BUCKET_WIDE_N keys: the top 16 of the bits it uses
BUCKET_WIDE_BITS = 24  # ... and past it the top 24, a pass more, a few keys a bucket
BUCKET_WIDE_N = 1 << 19  # (16 bits the faster up to 2**19 keys, 24 at 2**21: PERF.md §6)
BUCKET_CAP = 8192  # keys a K24 block sorts at once (csrc/sort.cu BS_CAP)
BUCKET_SHARE = 4096  # a K24 block's share of the partitioned keys (BS_SHARE)
BUCKET_RANK = 128  # K24 ranks a round whose buckets hold at most this many keys (BS_RANK)
BUCKET_DENSE = 8  # ... and this many on average (BS_DENSE)
# the bucket route from 41 used bits, where the passes route runs 6 passes
# or more: on the H100 the passes won at 25, 32 and 34 bits (4 and 5
# passes), the bucket route at 42 and 62 (PERF.md row 19, §6)
BUCKET_MIN_BITS = 41
ROUTES = ("passes", "block", "bucket")


def radix_route(n: int, bits: int, cap: int = BUCKET_CAP) -> tuple:
    """K22's route for n keys that differ in their low `bits` bits, chosen on
    the host from n and bits alone (csrc/sort.cu's header), as (route, B):
    ("passes", 0), an LSD pass for each 8-bit digit (bits <= 16, too many
    keys for an int32 place, or past cap keys below BUCKET_MIN_BITS or at
    64 bits: the bits no caller narrowed, such as DeviceCounter's slab, whose
    buckets gained nothing on a repeat-heavy corpus and lost where half its
    keys are one key); ("block", 0), K24 alone, one block sorting all n <=
    cap keys; ("bucket", B), a pass over each byte of the top B used bits
    (16, or past BUCKET_WIDE_N keys 24), then K24 sorting each bucket in
    shared memory and K25 the buckets of more than cap keys through device
    memory. cap: K24's capacity (the card's BUCKET_CAP; a model's own)."""
    if bits <= BUCKET_BITS or n >= 1 << 31:
        return ("passes", 0)
    if n <= cap:
        return ("block", 0)
    if BUCKET_MIN_BITS <= bits < 64:
        return ("bucket", BUCKET_WIDE_BITS if n > BUCKET_WIDE_N else BUCKET_BITS)
    return ("passes", 0)


def check_route(n: int, bits: int, route: tuple, cap: int = BUCKET_CAP) -> tuple:
    """route, as radix_route gives it, checked against n keys over `bits`:
    the block route holds at most cap keys, a bucket of B = 16 or 24 bits
    leaves at least one of the used bits below it."""
    name, B = route
    kernels.need(name in ROUTES, f"radix_sort: route {name!r} not in {ROUTES}")
    kernels.need(name != "block" or (n <= cap and B == 0),
                 f"radix_sort: the block route sorts at most {cap} keys")
    kernels.need(name != "bucket" or (B in (BUCKET_BITS, BUCKET_WIDE_BITS) and B < bits
                                      and n < 1 << 31),
                 f"radix_sort: no bucket of {B} bits below {bits} bits")
    kernels.need(name != "passes" or B == 0, "radix_sort: the passes route has no bucket")
    return route


def bucket_digits(bits: int, B: int) -> int:
    """The 8-bit digits of a bucket's remaining bits (bits - B): the passes
    K25 may run over an oversize bucket."""
    return -(-(bits - B) // 8)


def radix_passes(bits: int = 64) -> list:
    """The digits a K22 sort on the passes route runs a pass over, low digit
    first: the 8-bit digits of the low `bits` bits, in which the caller says
    the keys may differ (every key's higher bits are equal), and at least
    one, so that a sort of equal keys still writes its output."""
    return list(range(max(1, -(-bits // 8))))


def radix_drive(bits: int, run_pass, alloc):
    """K22's pass driver: a pass for each digit of radix_passes(bits); pass
    i reads what pass i - 1 wrote (the first pass: the sort's source, given
    as None) and writes buffer i mod 2 (two at most, each made by alloc()),
    by run_pass(src, dst, digit, i). Returns the buffer of the last pass."""
    bufs, src = [], None
    for i, d in enumerate(radix_passes(bits)):
        if len(bufs) <= i % 2:
            bufs.append(alloc())
        run_pass(src, bufs[i % 2], d, i)
        src = bufs[i % 2]
    return src


def bucket_drive(run_pass, run_buckets, alloc, passes: int = 2):
    """K22's bucket route driver: a pass over each digit 0 .. passes - 1 of
    the keys >> (bits - B), the bucket's bytes, low byte first
    (run_pass(src, dst, digit, i) as radix_drive's, pass i into buffer i mod
    2), leaves the keys grouped by bucket; run_buckets(grouped, out) sorts
    each bucket (K24, K25) into the other buffer, the sort's one output.
    Returns it."""
    bufs, src = [alloc(), alloc()], None
    for i in range(passes):
        run_pass(src, bufs[i % 2], i, i)
        src = bufs[i % 2]
    run_buckets(src, bufs[passes % 2])
    return bufs[passes % 2]


def _radix_codes(kind, passes: int) -> list:
    """The payload kind of each of a sort's passes (csrc/sort.cu RS_PAY_*)
    for a payload `kind` (None, torch.int32, or RADIX_INDEX): an index
    travels as int32 between a sort's first and last passes (4 bytes less a
    key a pass), as int64 in a one-pass sort. The bucket route's passes
    take the kinds of a sort one pass longer but its last: K24 and K25 write
    the int64 index."""
    if kind is None:
        return [_PAY_NONE] * passes
    if kind == torch.int32:
        return [_PAY_I32] * passes
    if passes == 1:
        return [_PAY_IDX]
    return [_PAY_IDX32] + [_PAY_I32] * (passes - 2) + [_PAY_I32W]


def _radix_launch(n: int, dev, keys, rows, idx, payload, kind, bits: int, route: tuple):
    """K22 on the card over n keys (keys (n,) int64, or the top 64 bits of
    rows[idx] / rows, (N, W) int32) by `route` (radix_route's): on the passes
    and bucket routes lt_radix_hist (the digits' bucket offsets), then
    radix_drive's passes, or bucket_drive's (two or three) and
    lt_radix_buckets (K24, K25); on the block route lt_radix_block (K24).
    kind: the payload's (None, torch.int32, or RADIX_INDEX: an index below
    2**31). Returns (keys, payload or None)."""
    kernels.need(kind != RADIX_INDEX or (n if rows is None else rows.shape[0]) <= 1 << 31,
                 "radix_sort: an index must fit an int32 between passes")
    lib = kernels.lib()
    st = kernels.stream(rows if keys is None else keys)
    W = 0 if rows is None else rows.shape[1]
    kp = None if keys is None else keys.data_ptr()
    rp = None if rows is None else rows.data_ptr()
    ip = None if idx is None else idx.data_ptr()
    pp = None if payload is None else payload.data_ptr()
    route, bb = route
    out_dt = None if kind is None else torch.int32 if kind == torch.int32 else torch.int64
    if route == "block":
        out = [torch.empty(n, dtype=torch.int64, device=dev),
               None if kind is None else torch.empty(n, dtype=out_dt, device=dev)]
        mode = 0 if kind is None else 1 if kind == torch.int32 else 2
        rc = lib.lt_radix_block(kp, rp, W, ip, pp, mode, n, out[0].data_ptr(),
                                None if out[1] is None else out[1].data_ptr(),
                                int(out_dt == torch.int64), st)
        kernels.check(rc, "radix_bucket")
        kernels.launches["radix_bucket"] += 1
        return out
    base = bits - bb if route == "bucket" else 0
    passes = bb // 8 if route == "bucket" else len(radix_passes(bits))
    scratch = torch.empty(2 * 8 * 256, dtype=torch.int64, device=dev)
    offsets = scratch[8 * 256 :]
    rc = lib.lt_radix_hist(kp, rp, W, ip, n, base, passes, scratch.data_ptr(),
                           offsets.data_ptr(), st)
    kernels.check(rc, "radix_sort")
    status = torch.empty(256 * (-(-n // RADIX_TILE)) + 1, dtype=torch.int64, device=dev)
    codes = _radix_codes(kind, passes + 1 if route == "bucket" else passes)
    pay_dt = (None if kind is None else
              torch.int32 if codes[0] in (_PAY_I32, _PAY_IDX32) else torch.int64)

    def alloc():
        return [torch.empty(n, dtype=torch.int64, device=dev),
                None if pay_dt is None else torch.empty(n, dtype=pay_dt, device=dev)]

    def run_pass(src, dst, d, i):
        if codes[i] == _PAY_I32W:  # the last pass widens the index into int64
            dst[1] = torch.empty(n, dtype=torch.int64, device=dev)
        if src is None:  # the source: the keys or rows, the payload as given
            args = (kp, rp, W, ip, pp)
        else:  # the pass before's buffer: keys and their payload
            args = (src[0].data_ptr(), None, 0, None,
                    None if src[1] is None else src[1].data_ptr())
        rc = lib.lt_radix_pass(*args, codes[i], n, d, base, offsets.data_ptr(),
                               dst[0].data_ptr(), None if dst[1] is None else dst[1].data_ptr(),
                               status.data_ptr(), status.numel() * 8, st)
        kernels.check(rc, "radix_sort")

    def run_buckets(src, dst):
        need = ctypes.c_longlong(0)
        kernels.check(lib.lt_radix_bucket_scratch(n, ctypes.addressof(need)), "radix_bucket")
        work = torch.empty(need.value, dtype=torch.uint8, device=dev)
        final = None if kind is None else torch.empty(n, dtype=out_dt, device=dev)
        rc = lib.lt_radix_buckets(src[0].data_ptr(), None if src[1] is None else src[1].data_ptr(),
                                  n, bits, bb, dst[0].data_ptr(),
                                  None if dst[1] is None else dst[1].data_ptr(),
                                  None if final is None else final.data_ptr(),
                                  int(out_dt == torch.int64), work.data_ptr(), need.value, st)
        kernels.check(rc, "radix_bucket")
        dst[1] = final

    if route == "bucket":
        out = bucket_drive(run_pass, run_buckets, alloc, passes)
        kernels.launches["radix_bucket"] += 1
        kernels.launches["radix_oversize"] += 1
    else:
        out = radix_drive(bits, run_pass, alloc)
    kernels.launches["radix_sort"] += 1
    return out


def _check_radix_args(keys, payload=None, bits: int = 64) -> None:
    kernels.need(keys.dtype == torch.int64 and keys.dim() == 1,
                 "radix_sort: keys must be (n,) int64")
    kernels.need(0 <= bits <= 64, f"radix_sort: bits={bits} not in [0, 64]")
    if payload is not None:
        kernels.need(payload.dtype in (torch.int32, torch.int64) and payload.shape == keys.shape,
                     "radix_sort: payload must be (n,) int32 or int64")
        kernels.need(payload.device == keys.device, "radix_sort: tensors on two devices")


def _check_bits(keys: torch.Tensor, bits: int) -> None:
    """On the CPU, the callers' claim that the keys differ only in their low
    `bits` bits (the card's passes cover no other digit)."""
    if bits < 64 and keys.shape[0]:
        kernels.need(bool((((keys ^ keys[0]) >> bits) == 0).all()),
                     f"radix_sort: the keys differ above their low {bits} bits")


def _route(n: int, bits: int, route: tuple | None) -> tuple:
    """The route of a K22 sort of n keys over `bits`: the caller's, checked,
    else radix_route's."""
    return radix_route(n, bits) if route is None else check_route(n, bits, tuple(route))


def radix_sort(keys: torch.Tensor, payload: torch.Tensor | None = None, bits: int = 64, *,
               route: tuple | None = None):
    """Keys (n,) int64 sorted ascending in signed order, stably, with the
    int32 payload carried along (kernel K22; the order of
    torch.sort(stable=True)), over the low `bits` bits, in which the keys may
    differ (their higher bits are equal in every key), by `route`, or the
    one radix_route(n, bits) picks (the card's; checks name another).
    Returns the sorted keys, or (keys, payload)."""
    _check_radix_args(keys, payload, bits)
    route = _route(keys.shape[0], bits, route)
    kernels.need(payload is None or payload.dtype == torch.int32,
                 "radix_sort: the payload must be int32 (radix_sort_index: the index)")
    if not kernels.on_cuda(keys, "radix_sort"):
        _check_bits(keys, bits)
        return radix_sort_plain(keys, payload)
    n = keys.shape[0]
    if n == 0:
        return keys.clone() if payload is None else (keys.clone(), payload.clone())
    k, p = _radix_launch(n, keys.device, keys.contiguous(), None, None,
                         None if payload is None else payload.contiguous(),
                         None if payload is None else torch.int32, bits, route)
    return k if payload is None else (k, p)


def radix_sort_index(keys: torch.Tensor, bits: int = 64, *, route: tuple | None = None) -> tuple:
    """(keys sorted, each sorted key's index in keys), stably, as
    torch.sort(keys, stable=True) gives them: K22 with the index as its
    payload (made by its first pass or load), over the low `bits` bits and
    by the route as radix_sort."""
    _check_radix_args(keys, None, bits)
    route = _route(keys.shape[0], bits, route)
    if not kernels.on_cuda(keys, "radix_sort"):
        _check_bits(keys, bits)
        return radix_sort_plain(keys, torch.arange(keys.shape[0], device=keys.device))
    n = keys.shape[0]
    if n == 0:
        return keys.clone(), torch.zeros(0, dtype=torch.int64, device=keys.device)
    return _radix_launch(n, keys.device, keys.contiguous(), None, None, None, RADIX_INDEX, bits,
                         route)


def radix_sort_rows(rows: torch.Tensor, idx: torch.Tensor | None = None, index: bool = True,
                    bits: int = 64, *, route: tuple | None = None):
    """The top 64 bits of (N, W) int32 rows (W <= 16), or of rows[idx], as
    sign-flipped int64 keys (_top_keys) sorted stably, with the row each key
    came from (idx[i], or i) when index: (keys, src), else keys. bits and
    route: as radix_sort's. On the card K22 reads each key from its row in its first
    pass (K24 in its one block on the block route)."""
    kernels.need(rows.dtype == torch.int32 and rows.dim() == 2 and 1 <= rows.shape[1] <= 16,
                 "radix_sort_rows: rows must be (N, W <= 16) int32")
    kernels.need(0 <= bits <= 64, f"radix_sort_rows: bits={bits} not in [0, 64]")
    if idx is not None:
        kernels.need(idx.dtype == torch.int64 and idx.dim() == 1 and idx.device == rows.device,
                     "radix_sort_rows: idx must be (n,) int64 on the rows' device")
    n = rows.shape[0] if idx is None else idx.shape[0]
    route = _route(n, bits, route)
    if not kernels.on_cuda(rows, "radix_sort"):
        src = idx if idx is not None else torch.arange(n, device=rows.device)
        keys = _top_keys(rows, idx)
        _check_bits(keys, bits)
        return radix_sort_plain(keys, src if index else None)
    if n == 0:
        keys = torch.zeros(0, dtype=torch.int64, device=rows.device)
        return (keys, keys.clone()) if index else keys
    k, p = _radix_launch(n, rows.device, None, rows.contiguous(),
                         None if idx is None else idx.contiguous(), None,
                         RADIX_INDEX if index else None, bits, route)
    return (k, p) if index else k


def radix_sort_plain(keys: torch.Tensor, payload: torch.Tensor | None = None):
    """Plain version of radix_sort (and of its index and row forms):
    torch.sort(stable=True), then the payload (int32, or an int64 index)
    gathered in that order."""
    _check_radix_args(keys, payload)
    vals, perm = torch.sort(keys, stable=True)
    return vals if payload is None else (vals, payload[perm])


def top_key_bits(k: int) -> int:
    """The low bits in which the top keys (_top_keys) of canonical k-mers'
    rows may differ: the 2k - 32 (W - 1) bits of word W - 1 and word W - 2's
    32 (the bits above 2k are 0); at W <= 2 the k-mer's 2k bits."""
    return 2 * k - 32 * max(words_for_k(k) - 2, 0)


# ---------------------------------------------------------------------------
# Kernel K23 (merge_path) and its plain version
# ---------------------------------------------------------------------------

MERGE_THREADS = 256  # threads a block of K23 (csrc/sort.cu MP_THREADS)


def merge_tile(W: int) -> int:
    """The outputs a block of K23 merges at an element width of W u32 words
    (csrc/sort.cu mp_tile: MERGE_THREADS threads of min(16, 60 // (W + 2))
    items, about 56 KB of shared memory)."""
    return MERGE_THREADS * min(16, 60 // (W + 2))


def _check_merge_runs(runs: list, rows: bool) -> int:
    """The element width of K23's runs: (keys (n,) int64, counts (n,) int32)
    pairs (2: a key's two words), or (rows (n, W) int32, counts) pairs with
    one W, 2 <= W <= 16; all on one device."""
    name = "merge_path_rows" if rows else "merge_path"
    kernels.need(len(runs) >= 1, f"{name}: no runs")
    dev, W = runs[0][0].device, runs[0][0].shape[1] if rows else 2
    for data, counts in runs:
        if rows:
            kernels.need(data.dtype == torch.int32 and data.dim() == 2 and data.shape[1] == W
                         and 2 <= W <= 16, f"{name}: rows must be (n, W) int32, 2 <= W <= 16")
        else:
            kernels.need(data.dtype == torch.int64 and data.dim() == 1,
                         f"{name}: keys must be (n,) int64")
        kernels.need(counts.dtype == torch.int32 and counts.shape == data.shape[:1],
                     f"{name}: counts must be (n,) int32")
        kernels.need(data.device == dev and counts.device == dev, f"{name}: tensors on two devices")
    return W


def _check_sorted_runs(runs: list) -> None:
    """On the CPU, the callers' claim that each run is sorted (keys in signed
    order, rows MSW first as u32 words): K23 merges, it does not sort."""
    for data, _ in runs:
        if data.shape[0] < 2:
            continue
        planes = (data,) if data.dim() == 1 else words_to_planes(data)
        below = torch.zeros(data.shape[0] - 1, dtype=torch.bool)
        equal = torch.ones_like(below)
        for h in reversed(planes):  # the most significant plane first
            below |= equal & (h[1:] > h[:-1])
            equal &= h[1:] == h[:-1]
        kernels.need(bool((below | equal).all()), "merge_path: a run is not sorted")


def _merge_rounds(parts: list, W: int, sign: bool, alloc) -> tuple:
    """K23's pairwise rounds on the card over nonempty runs `parts` ((data,
    counts), data's storage W u32 words an element): each round merges runs
    2i and 2i + 1 into a buffer of alloc(n) (an odd last run waits for the
    next round), a round's pairs in one launch (up to 8 a launch, csrc/sort.cu
    MP_MAX_PAIRS), the first round reading the runs where they are. Returns
    the merged (data, counts)."""
    lib = kernels.lib()
    st = kernels.stream(parts[0][1])
    while len(parts) > 1:
        table, merged = [], []
        for (a, ca), (b, cb) in zip(parts[0::2], parts[1::2]):
            out, cout = alloc(ca.shape[0] + cb.shape[0])
            table.append((a.data_ptr(), ca.data_ptr(), b.data_ptr(), cb.data_ptr(),
                          out.data_ptr(), cout.data_ptr(), ca.shape[0], cb.shape[0]))
            merged.append((out, cout))
        tab = np.array(table, dtype=np.int64)
        kernels.check(lib.lt_merge_path(tab.ctypes.data, len(table), W, int(sign), st),
                      "merge_path")
        parts = merged + parts[len(table) * 2 :]
    return parts[0]


def merge_path(runs: list) -> tuple:
    """Sorted runs of int64 keys, each with its int32 counts ([(keys (n,),
    counts (n,)), ...], keys ascending in signed order), merged stably: on
    equal keys the earlier run's first, the order of torch.sort(stable=True)
    of their concatenation (kernel K23 in pairwise rounds, the runs read in
    place; one run is returned as it is). Returns (keys (N,) int64, counts
    (N,) int32)."""
    _check_merge_runs(runs, False)
    if not kernels.on_cuda(runs[0][0], "merge_path"):
        _check_sorted_runs(runs)
        return runs[0] if len(runs) == 1 else merge_path_plain(runs)
    return _merge_launch(runs, 2, True, lambda n: torch.empty(n, dtype=torch.int64,
                                                              device=runs[0][0].device))


def merge_path_rows(runs: list) -> tuple:
    """merge_path over (rows (n, W) int32, counts (n,) int32) runs, 2 <= W
    <= 16, each sorted MSW first as u32 words (the WordCounter's runs): equal
    rows keep their runs' order. At W = 2 a row is one unsigned 64-bit key,
    K23's key form. Returns (rows (N, W) int32, counts (N,) int32)."""
    W = _check_merge_runs(runs, True)
    if not kernels.on_cuda(runs[0][0], "merge_path"):
        _check_sorted_runs(runs)
        return runs[0] if len(runs) == 1 else merge_path_plain(runs)
    return _merge_launch(runs, W, False, lambda n: torch.empty(n, W, dtype=torch.int32,
                                                               device=runs[0][0].device))


def _merge_launch(runs: list, W: int, sign: bool, alloc) -> tuple:
    """K23 on the card: the nonempty runs through _merge_rounds (no launch
    for fewer than two)."""
    if len(runs) == 1:
        return runs[0]
    parts = [(d.contiguous(), c.contiguous()) for d, c in runs if c.shape[0]]
    if len(parts) < 2:
        return parts[0] if parts else (alloc(0), torch.empty(0, dtype=torch.int32,
                                                               device=runs[0][1].device))
    kernels.need(sum(c.shape[0] for _, c in parts) < 1 << 40, "merge_path: too many elements")

    def alloc2(n):
        return alloc(n), torch.empty(n, dtype=torch.int32, device=parts[0][1].device)

    out = _merge_rounds(parts, W, sign, alloc2)
    kernels.launches["merge_path"] += 1
    return out


def merge_path_plain(runs: list) -> tuple:
    """Plain version of merge_path and merge_path_rows: torch.cat of the
    runs, then a stable torch.sort of the keys (sort_planes of the rows'
    planes), the counts permuted along."""
    data = torch.cat([d for d, _ in runs])
    counts = torch.cat([c for _, c in runs])
    if data.dim() == 1:
        keys, perm = torch.sort(data, stable=True)
        return keys, counts[perm]
    _, perm = sort_planes(words_to_planes(data), with_perm=True)
    return data[perm], counts[perm]


# ---------------------------------------------------------------------------
# Kernel K2 and its plain version
# ---------------------------------------------------------------------------


def _check_runs_args(keys, counts) -> None:
    kernels.need(keys.dtype == torch.int64 and keys.dim() == 1, "runs: keys must be (n,) int64")
    if counts is not None:
        kernels.need(counts.dtype == torch.int32 and counts.shape == keys.shape,
                     "runs: counts must be (n,) int32")
        kernels.need(counts.device == keys.device, "runs: tensors on two devices")


RUNS_STEP = 256  # rows a warp of K2 takes at a time (csrc/count.cu K2_STEP)


def _runs_scratch_bytes(n: int, step: int = RUNS_STEP) -> int:
    """The scratch of K2 (steps of RUNS_STEP rows) or K14 (_word_runs_step)
    for n rows: a 16-byte Span for each warp of the grid (at most one a
    step of the n + 1 rows it reads, the last past the end, rounded up to a
    block of 8 warps) and the count pass's done counter."""
    return 16 * ((n + step) // step + 8) + 4


def runs(keys: torch.Tensor, counts: torch.Tensor | None = None, cutoff: int = 1,
         want_hist: bool = False):
    """Reduce-by-key over SORTED int64 keys; SENTINEL rows are ignored.

    A run's value is its length (counts None) or the u32-wrapping sum of its
    int32 counts, clamped to 2**31-1 (count.py:239-253). Runs whose value is
    >= max(cutoff, 1) are emitted in key order: zero-sum runs always drop,
    and cutoff > 1 is compact_solid. Returns (keys (R,) int64, counts (R,)
    int32, hist): hist is the (256,) integer histogram of min(value, 255)
    over the emitted runs (bin 0 is 0) when want_hist, else None.

    On the card K2 is a count pass (R, reading the keys and counts once),
    the one host sync, and a write pass into outputs of exactly R rows."""
    _check_runs_args(keys, counts)
    if not kernels.on_cuda(keys, "runs"):
        return runs_plain(keys, counts, cutoff, want_hist)
    keys = keys.contiguous()
    counts = counts.contiguous() if counts is not None else None
    dev = keys.device
    n = keys.shape[0]
    lib, st = kernels.lib(), kernels.stream(keys)
    cnt_p = counts.data_ptr() if counts is not None else None
    nbytes = _runs_scratch_bytes(n)
    scratch = torch.empty(-(-nbytes // 8) + 1, dtype=torch.int64, device=dev)  # + the total
    rc = lib.lt_runs_count(keys.data_ptr(), cnt_p, n, int(cutoff), scratch.data_ptr(), nbytes,
                           scratch[-1:].data_ptr(), st)
    kernels.check(rc, "runs")
    R = int(scratch[-1])
    out_k = torch.empty(R, dtype=torch.int64, device=dev)
    out_c = torch.empty(R, dtype=torch.int32, device=dev)
    hist = torch.empty(256, dtype=torch.int32, device=dev) if want_hist else None
    rc = lib.lt_runs_write(keys.data_ptr(), cnt_p, n, int(cutoff),
                           hist.data_ptr() if hist is not None else None, out_k.data_ptr(),
                           out_c.data_ptr(), scratch.data_ptr(), nbytes, st)
    kernels.check(rc, "runs")
    kernels.launches["runs"] += 1
    return out_k, out_c, hist


def runs_plain(keys: torch.Tensor, counts: torch.Tensor | None = None,
               cutoff: int = 1, want_hist: bool = False):
    """Plain version of runs: boundaries, prefix sums read at the next
    boundary (the reference's _merge_sorted_runs arithmetic), filter."""
    _check_runs_args(keys, counts)
    dev = keys.device
    n = keys.shape[0]
    valid = keys != SENTINEL
    head = valid.clone()
    if n > 1:
        head[1:] &= keys[1:] != keys[:-1]
    if counts is None:
        vals = valid.to(torch.int64)
    else:
        vals = torch.where(valid, counts.to(torch.int64) & _M32, 0)
    incl = torch.cumsum(vals, 0)
    starts = torch.nonzero(head).reshape(-1)
    nv = int(valid.sum())
    ends = torch.cat([starts[1:], torch.tensor([nv], dtype=torch.int64, device=dev)])
    if starts.numel():
        sums = (incl[ends - 1] - incl[starts] + vals[starts]) & _M32
    else:
        sums = torch.zeros(0, dtype=torch.int64, device=dev)
    c = torch.clamp(sums, max=_I32_MAX)
    emit = c >= max(int(cutoff), 1)
    out_k = keys[starts[emit]]
    out_c = c[emit].to(torch.int32)
    hist = None
    if want_hist:
        hist = torch.bincount(torch.clamp(out_c.to(torch.int64), max=255), minlength=256)
        hist[0] = 0
    return out_k, out_c, hist


def compact_solid(keys: torch.Tensor, counts: torch.Tensor, cutoff: int):
    """Order-preserving compaction of a distinct run to its rows with
    count >= cutoff (leon_tpu count.compact_solid) — K2 in solid mode."""
    out_k, out_c, _ = runs(keys, counts, cutoff)
    return out_k, out_c


# ---------------------------------------------------------------------------
# Kernel K14 (multiword runs) and its plain version; count_batch
# ---------------------------------------------------------------------------


def _check_runs_words_args(planes, W: int, counts=None) -> None:
    kernels.need(1 <= W <= 16, f"runs_words: W={W} not in [1, 16]")
    kernels.need(isinstance(planes, (tuple, list)) and len(planes) == n_planes(W),
                 f"runs_words: {n_planes(W)} planes for W={W}")
    lo = planes[0]
    for h in planes:
        kernels.need(h.dtype == torch.int64 and h.dim() == 1 and h.shape == lo.shape,
                     "runs_words: planes must be (n,) int64")
        kernels.need(h.device == lo.device, "runs_words: tensors on two devices")
    if counts is not None:
        kernels.need(counts.dtype == torch.int32 and counts.shape == lo.shape,
                     "runs_words: counts must be (n,) int32")
        kernels.need(counts.device == lo.device, "runs_words: tensors on two devices")


def _word_runs_step(W: int) -> int:
    """Rows a warp of K14 takes at a step (csrc/count.cu WordRows::STEP): 32
    lanes of 8 rows at one plane, 4 at two to four, 2 past that."""
    P = n_planes(W)
    return 32 * (8 if P == 1 else 4 if P <= 4 else 2)


def _runs_words_launch(planes, W: int, counts, cutoff: int, want_hist: bool, modes: bool):
    """K14 on the card: (words (R, W) int32, values (R,) int32 with modes
    (word_runs) or int64 run lengths without (runs_words), hist (256,)
    int32 or None): a count pass (R), the one host sync, and a write pass
    into outputs of exactly R rows; counted under the wrapper's name."""
    name = "word_runs" if modes else "runs_words"
    planes = [h.contiguous() for h in planes]
    counts = counts.contiguous() if counts is not None else None
    lo = planes[0]
    dev = lo.device
    n = lo.shape[0]
    kernels.need(n < 1 << 32, f"{name}: {n} rows: a run's length must fit a u32")
    lib = kernels.lib()
    ptrs = np.array([h.data_ptr() for h in planes], dtype=np.uint64)
    cnt_p = counts.data_ptr() if counts is not None else None
    nbytes = _runs_scratch_bytes(n, _word_runs_step(W))
    scratch = torch.empty(-(-nbytes // 8) + 1, dtype=torch.int64, device=dev)  # + the total
    hist = torch.empty(256, dtype=torch.int32, device=dev) if want_hist else None
    st = kernels.stream(lo)
    rc = lib.lt_word_runs_count(ptrs.ctypes.data, len(planes), cnt_p, n, int(cutoff),
                                scratch.data_ptr(), nbytes, scratch[-1:].data_ptr(), st)
    kernels.check(rc, name)
    R = int(scratch[-1])
    uniq = torch.empty(R, W, dtype=torch.int32, device=dev)
    vals = torch.empty(R, dtype=torch.int32 if modes else torch.int64, device=dev)
    rc = lib.lt_word_runs_write(ptrs.ctypes.data, len(planes), cnt_p, n, W, int(cutoff),
                                hist.data_ptr() if hist is not None else None, uniq.data_ptr(),
                                vals.data_ptr(), int(not modes), scratch.data_ptr(), nbytes, st)
    kernels.check(rc, name)
    kernels.launches[name] += 1
    return uniq, vals, hist


def runs_words(planes: tuple, W: int):
    """Reduce-by-key over rows sorted by their P = ceil(W/2) sign-flipped
    int64 planes (state.words_to_planes; W <= 16). Every row counts (the
    caller drops invalid rows first). Returns (uniq (M, W) int32 holding the
    u32 words, counts (M,) int64) in key order."""
    _check_runs_words_args(planes, W)
    if not kernels.on_cuda(planes[0], "runs_words"):
        return runs_words_plain(planes, W)
    uniq, counts, _ = _runs_words_launch(planes, W, None, 1, False, False)
    return uniq, counts


def word_runs(planes: tuple, W: int, counts: torch.Tensor | None = None, cutoff: int = 1,
              want_hist: bool = False):
    """K14 in K2's modes (the multiword counterpart of ``runs``; the
    WordCounter's wrapper, with its own launch count, W <= 16): over rows
    sorted by their P = ceil(W/2) planes, a run's value is its length
    (counts None) or the u32-wrapping sum of its int32 counts clamped to
    2**31-1 (count.py:239-253); runs whose value is >= max(cutoff, 1) are
    emitted in key order. Returns (words (R, W) int32, values (R,) int32,
    hist): hist is the (256,) histogram of min(value, 255) over the emitted
    runs (bin 0 is 0) when want_hist, else None."""
    _check_runs_words_args(planes, W, counts)
    if not kernels.on_cuda(planes[0], "word_runs"):
        return word_runs_plain(planes, W, counts, cutoff, want_hist)
    return _runs_words_launch(planes, W, counts, cutoff, want_hist, True)


def _word_runs_plain(planes, W: int, counts, cutoff: int, want_hist: bool):
    """Heads where any plane changes; values from prefix sums read at the
    next head (lengths, or the u32-wrapping count sums clamped); filter."""
    lo = planes[0]
    dev = lo.device
    n = lo.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        ne = lo[1:] != lo[:-1]
        for h in planes[1:]:
            ne = ne | (h[1:] != h[:-1])
        head[1:] = ne
    starts = torch.nonzero(head).reshape(-1)
    ends = torch.cat([starts[1:], torch.full((min(n, 1),), n, dtype=torch.int64, device=dev)])
    if counts is None:
        vals = ends - starts
    else:
        incl = torch.cumsum(counts.to(torch.int64) & _M32, 0)
        sums = (incl[ends - 1] - incl[starts] + (counts[starts].to(torch.int64) & _M32)) & _M32
        vals = torch.clamp(sums, max=_I32_MAX)
    emit = vals >= max(int(cutoff), 1)
    words = planes_to_words([h[starts[emit]] for h in planes], W)
    vals = vals[emit]
    hist = None
    if want_hist:
        hist = torch.bincount(torch.clamp(vals, max=255), minlength=256)
        hist[0] = 0
    return words, vals, hist


def runs_words_plain(planes: tuple, W: int):
    """Plain version of runs_words: heads where any plane changes, run
    lengths from the head positions, words unflipped from the planes."""
    _check_runs_words_args(planes, W)
    words, lengths, _ = _word_runs_plain(planes, W, None, 1, False)
    return words, lengths


def word_runs_plain(planes: tuple, W: int, counts: torch.Tensor | None = None,
                    cutoff: int = 1, want_hist: bool = False):
    """Plain version of word_runs (the reference's _merge_sorted_runs,
    _hist_of_sorted and compact_solid arithmetic on multi-plane keys)."""
    _check_runs_words_args(planes, W, counts)
    words, vals, hist = _word_runs_plain(planes, W, counts, cutoff, want_hist)
    return words, vals.to(torch.int32), hist


def sort_planes(planes, with_perm: bool = False):
    """Sort rows by their planes, most significant (the last) first, signed,
    with torch.sort(stable=True) (radix_sort_plain's sort): one sort for one
    plane, else an LSD sort (one stable sort per plane from plane 0 up, each
    carrying the sorted planes below it along). The plain versions' sort: no
    card path runs it (the counters sort on K22). Returns the sorted planes
    as a tuple, plus the permutation when with_perm (to carry a payload
    along)."""
    low, perm = torch.sort(planes[0], stable=True)
    done = [low]
    for q in range(1, len(planes)):
        vals, p2 = torch.sort(planes[q][perm], stable=True)
        done = [x[p2] for x in done] + [vals]
        if with_perm or q < len(planes) - 1:
            perm = perm[p2]
    return (tuple(done), perm) if with_perm else tuple(done)


def sort_words(words: torch.Tensor) -> tuple:
    """(N, W) int32 u32 words -> their sign-flipped int64 planes sorted
    lexicographically, most significant word first (sort_planes)."""
    return sort_planes(words_to_planes(words))


def compact_solid_words(words: torch.Tensor, counts: torch.Tensor, cutoff: int):
    """Order-preserving compaction of a multiword distinct run to its rows
    with count >= cutoff (leon_tpu count.compact_solid) — K14's row policy
    in solid mode. Returns (words (S, W) int32, counts (S,) int32)."""
    out_w, out_c, _ = word_runs_rows(words, counts, cutoff)
    return out_w, out_c


def _check_word_runs_rows_args(words, counts) -> int:
    kernels.need(words.dtype == torch.int32 and words.dim() == 2 and 1 <= words.shape[1] <= 16,
                 "word_runs_rows: words must be (M, W <= 16) int32")
    kernels.need(counts.dtype == torch.int32 and counts.shape == words.shape[:1],
                 "word_runs_rows: counts must be (M,) int32")
    kernels.need(counts.device == words.device, "word_runs_rows: tensors on two devices")
    return words.shape[1]


def word_runs_rows(words: torch.Tensor, counts: torch.Tensor, cutoff: int = 1,
                   want_hist: bool = False):
    """word_runs with its counts payload over (M, W) int32 rows sorted MSW
    first, read as they stand: kernel K14's row policy (a run boundary is any
    word that differs from the row before; the WordCounter's final run, so
    that no words_to_planes runs on the card). Returns (words (R, W) int32,
    values (R,) int32, hist or None) as word_runs."""
    W = _check_word_runs_rows_args(words, counts)
    if not kernels.on_cuda(words, "word_runs_rows"):
        return word_runs_plain(words_to_planes(words), W, counts, cutoff, want_hist)
    words, counts = words.contiguous(), counts.contiguous()
    dev = words.device
    n = words.shape[0]
    kernels.need(n < 1 << 32, f"word_runs_rows: {n} rows: a run's length must fit a u32")
    lib = kernels.lib()
    nbytes = _runs_scratch_bytes(n, _word_runs_step(W))
    scratch = torch.empty(-(-nbytes // 8) + 1, dtype=torch.int64, device=dev)  # + the total
    hist = torch.empty(256, dtype=torch.int32, device=dev) if want_hist else None
    st = kernels.stream(words)
    rc = lib.lt_word_runs_rows_count(words.data_ptr(), W, counts.data_ptr(), n, int(cutoff),
                                     scratch.data_ptr(), nbytes, scratch[-1:].data_ptr(), st)
    kernels.check(rc, "word_runs_rows")
    R = int(scratch[-1])
    uniq = torch.empty(R, W, dtype=torch.int32, device=dev)
    vals = torch.empty(R, dtype=torch.int32, device=dev)
    rc = lib.lt_word_runs_rows_write(words.data_ptr(), W, counts.data_ptr(), n, int(cutoff),
                                     hist.data_ptr() if hist is not None else None,
                                     uniq.data_ptr(), vals.data_ptr(), scratch.data_ptr(), nbytes,
                                     st)
    kernels.check(rc, "word_runs_rows")
    kernels.launches["word_runs_rows"] += 1
    return uniq, vals, hist


# ---------------------------------------------------------------------------
# count_batch: one sort of the top 64 bits, then kernel K20 (sort_ties) and K14
# ---------------------------------------------------------------------------

TIE_WARP_RUN, TIE_BLOCK_RUN = 32, 1024  # csrc/count.cu ST_WARP_RUN, ST_BLOCK_RUN


def _check_count_batch_args(canon, valid) -> int:
    kernels.need(canon.dtype == torch.int32 and canon.dim() == 3 and 1 <= canon.shape[2] <= 16,
                 "count_batch: canon must be (B, P, W <= 16) int32")
    kernels.need(valid.dtype == torch.bool and valid.shape == canon.shape[:2],
                 "count_batch: valid must be (B, P) bool")
    kernels.need(valid.device == canon.device, "count_batch: tensors on two devices")
    return canon.shape[2]


def _top_keys(rows: torch.Tensor, idx: torch.Tensor | None = None) -> torch.Tensor:
    """The top 64 bits of (N, W) int32 rows (or of rows[idx]): words W-1 and
    W-2 (word 0 alone at W = 1) as one sign-flipped int64, whose signed order
    is their u32 order, MSW first (at W <= 2 the row's one plane)."""
    W = rows.shape[1]
    if W == 1:
        top = rows[:, 0].to(torch.int64) & _M32
        top = top if idx is None else top[idx]
    elif W % 2 == 0:  # words W-2 and W-1 are the last int64 of a row
        top = rows.view(torch.int64)[:, -1]
        top = top if idx is None else top[idx]
    else:
        hi, lo = rows[:, W - 1], rows[:, W - 2]
        if idx is not None:
            hi, lo = hi[idx], lo[idx]
        top = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & _M32)
    return top ^ _SIGN


def top_sort(canon: torch.Tensor, valid: torch.Tensor):
    """count_batch's top sort (W >= 3): the valid rows of (B, P, W) int32
    canon by their top 64 bits (_top_keys), K22 reading them from the rows.
    Returns (keys (n,) int64 sorted, src (n,) int64: sorted row i is row
    src[i] of rows, rows (B*P, W) int32, canon's rows)."""
    W = canon.shape[2]
    rows = canon.contiguous().reshape(-1, W)
    idx = torch.nonzero(valid.reshape(-1)).reshape(-1)
    keys, src = radix_sort_rows(rows, idx)
    return keys, src, rows


def _check_sort_ties_args(keys, src, rows, W: int, pay=None) -> None:
    kernels.need(3 <= W <= 16 and rows.dtype == torch.int32 and rows.dim() == 2
                 and rows.shape[1] == W, "sort_ties: rows must be (N, W) int32, 3 <= W <= 16")
    kernels.need(keys.dtype == torch.int64 and keys.dim() == 1 and src.dtype == torch.int64
                 and src.shape == keys.shape, "sort_ties: keys and src must be (n,) int64")
    kernels.need(keys.device == src.device == rows.device, "sort_ties: tensors on two devices")
    if pay is not None:
        kernels.need(pay.dtype == torch.int32 and pay.shape == rows.shape[:1],
                     "sort_ties: pay must be (N,) int32, a value a row")
        kernels.need(pay.device == rows.device, "sort_ties: tensors on two devices")


def sort_ties(keys: torch.Tensor, src: torch.Tensor, rows: torch.Tensor, W: int,
              pay: torch.Tensor | None = None):
    """Rows in the reference's order after the sort of their top 64 bits
    (kernel K20): keys (n,) int64 sorted (top_sort's), src (n,) int64 (sorted
    row i is rows[src[i]]), rows (N, W) int32, 3 <= W <= 16. Returns the
    P = ceil(W/2) sign-flipped int64 planes (state.words_to_planes) of the
    n rows, each run of equal keys ordered by its rows, MSW first (equal rows
    in src order): the input of runs_words. With pay ((N,) int32, a value a
    row: the WordCounter's merge counts) returns (planes, pay (n,) int32 in
    the rows' new order). On the card: K20 over the runs of up to
    TIE_BLOCK_RUN rows, then rounds over the next plane for longer ones
    (_tie_rounds)."""
    _check_sort_ties_args(keys, src, rows, W, pay)
    if not kernels.on_cuda(rows, "sort_ties"):
        return sort_ties_plain(keys, src, rows, W, pay)
    out = _tie_rounds(keys.contiguous(), src.contiguous(), rows.contiguous(), W,
                      _sort_ties_launch, None if pay is None else pay.contiguous())
    if keys.shape[0]:
        kernels.launches["sort_ties"] += 1
    return out


def _ties_lists(n: int) -> tuple:
    """(capacity of block runs, of long runs) of K20's lists for n rows."""
    return n // (TIE_WARP_RUN + 1) + 1, n // (TIE_BLOCK_RUN + 1) + 1


def _sort_ties_launch(keys, src, rows, W: int, out: tuple, dst, final: bool, pay=None):
    """One round of K20 on the card into the planes `out` (dst: where sorted
    row i goes, None for i; pay: None, or (pay, pay_out) int32, pay_out[place]
    = pay[row]). Returns the runs of more than TIE_BLOCK_RUN rows it left
    (starts, lengths), or None (after the host read of their count)."""
    n = keys.shape[0]
    cap_mid, cap_long = _ties_lists(n)
    lists = torch.empty(2 + cap_mid + 2 * cap_long, dtype=torch.int64, device=keys.device)
    ptrs = np.array([h.data_ptr() for h in out], dtype=np.uint64)
    pin, pout = (None, None) if pay is None else (pay[0].data_ptr(), pay[1].data_ptr())
    rc = kernels.lib().lt_sort_ties(
        keys.data_ptr(), src.data_ptr(), rows.data_ptr(), n, W,
        dst.data_ptr() if dst is not None else None, int(final), len(out), ptrs.ctypes.data,
        pin, pout, lists.data_ptr(), cap_mid, kernels.stream(keys))
    kernels.check(rc, "sort_ties")
    n_long = 0 if final or n == 0 else int(lists[1])
    if not n_long:
        return None
    ent = lists[2 + cap_mid : 2 + cap_mid + 2 * n_long].view(n_long, 2)
    return ent[:, 0], ent[:, 1]


def _tie_rounds(keys, src, rows, W: int, launch, pay=None):
    """K20's rounds: `launch` (the card's _sort_ties_launch, or a model of it)
    settles every run of up to TIE_BLOCK_RUN rows and returns the longer
    ones; those are ordered by their next plane (a stable K22 sort by the
    plane, then by run) and launched again with the runs of equal (run,
    plane) as keys, until the planes run out: in that last round every run
    holds equal rows (final). Returns the planes, and with pay ((N,) int32)
    the payload in their order (each launch writes a row's value where it
    writes the row)."""
    n = keys.shape[0]
    out = tuple(torch.empty(n, dtype=torch.int64, device=rows.device)
                for _ in range(n_planes(W)))
    pays = None if pay is None else (pay, torch.empty(n, dtype=torch.int32, device=rows.device))
    longs = launch(keys, src, rows, W, out, None, False, pays)
    pos, q = None, n_planes(W) - 2  # the plane below the key
    while longs is not None:
        starts, lengths = longs
        run = torch.repeat_interleave(torch.arange(lengths.shape[0], device=rows.device),
                                      lengths)
        first = torch.cumsum(lengths, 0) - lengths
        x = starts[run] + torch.arange(run.shape[0], device=rows.device) - first[run]
        src, pos = src[x], (x if pos is None else pos[x])
        u = rows[src].to(torch.int64) & _M32
        nxt = (u[:, 2 * q] | (u[:, 2 * q + 1] << 32 if 2 * q + 1 < W else 0)) ^ _SIGN
        o1 = radix_sort_index(nxt)[1]
        # then by run: indices below the runs' count, a pass for each 8 of its bits
        order = o1[radix_sort_index(run[o1], max(1, (lengths.shape[0] - 1).bit_length()))[1]]
        run, nxt, src = run[order], nxt[order], src[order]
        new = torch.ones_like(run, dtype=torch.bool)
        new[1:] = (run[1:] != run[:-1]) | (nxt[1:] != nxt[:-1])
        longs = launch(torch.cumsum(new, 0), src, rows, W, out, pos, q == 0, pays)
        q -= 1
    return out if pays is None else (out, pays[1])


def sort_ties_plain(keys: torch.Tensor, src: torch.Tensor, rows: torch.Tensor, W: int,
                    pay: torch.Tensor | None = None):
    """Plain version of sort_ties: the rows' planes sorted by (run of equal
    keys, the planes below the top one) with sort_planes' stable passes, the
    payload permuted along."""
    _check_sort_ties_args(keys, src, rows, W, pay)
    planes = words_to_planes(rows[src])
    run = torch.zeros_like(keys)
    if keys.shape[0] > 1:
        run[1:] = torch.cumsum(keys[1:] != keys[:-1], 0)
    _, perm = sort_planes(planes[:-1] + (run,), with_perm=True)
    out = tuple(h[perm] for h in planes)
    return out if pay is None else (out, pay[src[perm]])


def count_batch(canon: torch.Tensor, valid: torch.Tensor):
    """Count one batch of canonical k-mers (counterpart of leon_tpu
    count.count_batch, count.py:88-104): canon (B, P, W) int32 u32 words,
    valid (B, P) bool, W <= 16 (k <= 255). Returns (uniq (M, W) int32 words
    sorted MSW first, counts (M,) int64) on canon's device: at W <= 2 the
    valid rows' one plane sorted by K22 (read from the rows), else top_sort
    and K20 sort_ties; then K14 runs_words."""
    W = _check_count_batch_args(canon, valid)
    if W <= 2:
        rows = canon.contiguous().reshape(-1, W)
        idx = torch.nonzero(valid.reshape(-1)).reshape(-1)
        return runs_words((radix_sort_rows(rows, idx, index=False),), W)
    return runs_words(sort_ties(*top_sort(canon, valid), W), W)


def count_batch_plain(canon: torch.Tensor, valid: torch.Tensor):
    """Plain version of count_batch: torch.sort (sort_words; at W >= 3 of
    the valid rows' _top_keys with their row index), sort_ties_plain and
    runs_words_plain."""
    W = _check_count_batch_args(canon, valid)
    if W <= 2:
        planes = sort_words(canon.reshape(-1, W)[valid.reshape(-1)])
    else:
        rows = canon.contiguous().reshape(-1, W)
        idx = torch.nonzero(valid.reshape(-1)).reshape(-1)
        planes = sort_ties_plain(*radix_sort_plain(_top_keys(rows, idx), idx), rows, W)
    return runs_words_plain(planes, W)


# ---------------------------------------------------------------------------
# The WordCounter's sorts: kernel K21 (plane_rows), the top sort and K20
# ---------------------------------------------------------------------------


def _check_plane_rows_args(planes, W: int) -> None:
    kernels.need(3 <= W <= 16, f"plane_rows: W={W} not in [3, 16]")
    _check_runs_words_args(planes, W)


def plane_rows(planes: tuple, W: int) -> tuple:
    """The WordCounter's slab (K17's P = ceil(W/2) sign-flipped int64 planes,
    3 <= W <= 16) as rows (n, W) int32 holding the u32 words, and each row's
    top 64 bits as one sign-flipped int64 (_top_keys): the input of the slab's
    top sort and K20 (kernel K21)."""
    _check_plane_rows_args(planes, W)
    if not kernels.on_cuda(planes[0], "plane_rows"):
        return plane_rows_plain(planes, W)
    planes = [h.contiguous() for h in planes]
    n = planes[0].shape[0]
    rows = torch.empty(n, W, dtype=torch.int32, device=planes[0].device)
    top = torch.empty(n, dtype=torch.int64, device=planes[0].device)
    ptrs = np.array([h.data_ptr() for h in planes], dtype=np.uint64)
    rc = kernels.lib().lt_plane_rows(ptrs.ctypes.data, len(planes), n, W, rows.data_ptr(),
                                     top.data_ptr(), kernels.stream(planes[0]))
    kernels.check(rc, "plane_rows")
    if n:
        kernels.launches["plane_rows"] += 1
    return rows, top


def plane_rows_plain(planes: tuple, W: int) -> tuple:
    """Plain version of plane_rows: state.planes_to_words, then _top_keys."""
    _check_plane_rows_args(planes, W)
    rows = planes_to_words(planes, W)
    return rows, _top_keys(rows)


def sort_slab(planes: tuple, W: int, bits: int = 64) -> tuple:
    """The WordCounter's slab, its rows as P sign-flipped int64 planes,
    sorted MSW first (the sort of leon_tpu/ops/count.py _fused_sort_count,
    194-207). At W <= 2 one K22 sort of the one plane; else K21 (rows and
    top keys), one K22 sort of the top keys with their index, then K20.
    bits: the low bits in which the top keys may differ (top_key_bits(k)).
    Returns the sorted planes (runs_words' and word_runs' input)."""
    if W <= 2:
        return (radix_sort(planes[0], bits=bits),)
    rows, top = plane_rows(planes, W)
    keys, src = radix_sort_index(top, bits)
    return sort_ties(keys, src, rows, W)


def sort_rows(words: torch.Tensor, counts: torch.Tensor, bits: int = 64) -> tuple:
    """The WordCounter's merge sort: (M, W) int32 rows with their int32
    counts, sorted MSW first with the counts carried along (lax.sort with the
    counts as payload in leon_tpu/ops/count.py _merge_sorted_runs, 226-254).
    One K22 sort of the rows' top keys, read from the rows, with their row
    index; at W <= 2 that key is the row's one plane and the counts are
    permuted along, else K20 orders the rows with the counts as its payload.
    bits: as sort_slab's. Returns (planes, counts)."""
    W = words.shape[1]
    words = words.contiguous()
    keys, src = radix_sort_rows(words, bits=bits)
    if W <= 2:
        return (keys,), counts[src]
    return sort_ties(keys, src, words, W, counts)


def merge_counts(partials: list) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-batch (unique (m, W) u32, counts (m,)) numpy partials on
    the host — a copy of leon_tpu/ops/count.py:107-170: the native k-way
    merge when every partial is sorted, else a lexsort."""
    if not partials:
        return np.zeros((0, 1), dtype=np.uint32), np.zeros(0, dtype=np.int64)
    nat = _merge_counts_native(partials)
    if nat is not None:
        return nat
    allk = np.concatenate([p[0] for p in partials], axis=0)
    allc = np.concatenate([p[1] for p in partials], axis=0)
    if allk.shape[0] == 0:
        return allk, allc
    W = allk.shape[1]
    order = np.lexsort(tuple(allk[:, j] for j in range(W)))
    sk, sc = allk[order], allc[order]
    newgrp = np.ones(sk.shape[0], dtype=bool)
    newgrp[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    gid = np.cumsum(newgrp) - 1
    out_counts = np.zeros(int(gid[-1]) + 1, dtype=np.int64)
    np.add.at(out_counts, gid, sc)
    return sk[newgrp], out_counts


def _merge_counts_native(partials):
    """Native k-way merge of sorted (uniq, counts) runs; None when any run
    is not sorted or the widths differ."""
    import ctypes

    from leon_tpu_torch import native

    lib = native.get_lib()
    runs_ = [(k, c) for k, c in partials if k.shape[0] > 0]
    if not runs_:
        k0 = partials[0][0]
        return (np.zeros((0, k0.shape[1]), np.uint32), np.zeros(0, np.int64))
    W = runs_[0][0].shape[1]
    keys_c, cnts_c, ns = [], [], []
    for k, c in runs_:
        if k.shape[1] != W:
            return None
        kk = np.ascontiguousarray(k, dtype=np.uint32)
        if not lib.leon_rows_sorted(kk.shape[0], W, kk.ctypes.data):
            return None
        keys_c.append(kk)
        cnts_c.append(np.ascontiguousarray(c, dtype=np.int64))
        ns.append(kk.shape[0])
    R = len(runs_)
    total = int(sum(ns))
    out_k = np.empty((total, W), dtype=np.uint32)
    out_c = np.empty(total, dtype=np.int64)
    kp = (ctypes.c_void_p * R)(*[k.ctypes.data for k in keys_c])
    cp = (ctypes.c_void_p * R)(*[c.ctypes.data for c in cnts_c])
    ns_a = np.asarray(ns, dtype=np.int64)
    m = lib.leon_merge_runs(R, W, kp, cp, ns_a.ctypes.data,
                            out_k.ctypes.data, out_c.ctypes.data)
    return np.ascontiguousarray(out_k[:m]), out_c[:m]


# ---------------------------------------------------------------------------
# Host helpers (copies)
# ---------------------------------------------------------------------------


def auto_cutoff(hist: np.ndarray) -> int:
    """Automatic abundance threshold — the frozen rule of
    leon_tpu/ops/count.py:761-784: the first count attaining the minimum of
    the valley before the coverage mode (highest peak at count >= 4), when
    that valley is below half the peak; else 2."""
    n = hist.size
    if n < 6:
        return 2
    h = hist.astype(np.float64)
    p = 4 + int(np.argmax(h[4:]))
    if h[p] <= 0:
        return 2
    v_slice = h[2 : p + 1]
    vmin = v_slice.min()
    if vmin >= 0.5 * h[p]:
        return 2
    c = 2 + int(np.argmin(v_slice))
    return min(c, 50)


def range_boundaries(nproc: int, k: int, W: int) -> np.ndarray:
    """(nproc-1, W) u32 LSW-first boundaries splitting the canonical k-mer
    space into nproc ranges of equal expected mass (a copy of
    leon_tpu/ops/count.py:722-737): canonical = min(fwd, rc) of two ~uniform
    2k-bit values, so P(C <= x) = 1 - (1 - x/T)^2 with T = 2^(2k), and the
    inverse CDF needs no data (the same on every process)."""
    import math

    T = 1 << (2 * k)
    out = np.zeros((max(0, nproc - 1), W), np.uint32)
    for i in range(1, nproc):
        x = int(T * (1.0 - math.sqrt(1.0 - i / nproc)))
        for j in range(W):
            out[i - 1, j] = (x >> (32 * j)) & 0xFFFFFFFF
    return out


def range_split(uniq: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Split positions of a sorted (M, W) distinct run at the boundary keys
    (a copy of leon_tpu/ops/count.py:740-759): (nproc+1,) int64 offsets,
    range q = rows[off[q]:off[q+1]]."""
    M, W = uniq.shape
    dt = np.dtype([(f"w{j}", ">u4") for j in range(W - 1, -1, -1)])

    def rec(x):
        r = np.empty(x.shape[0], dtype=dt)
        for j in range(W):
            r[f"w{j}"] = x[:, j]
        return r

    offs = np.zeros(bounds.shape[0] + 2, np.int64)
    offs[-1] = M
    if M and bounds.shape[0]:
        offs[1:-1] = np.searchsorted(rec(np.ascontiguousarray(uniq)),
                                     rec(np.ascontiguousarray(bounds)))
    return offs


# ---------------------------------------------------------------------------
# Streaming counter
# ---------------------------------------------------------------------------


def histogram(counts: np.ndarray, max_count: int = 255) -> np.ndarray:
    """Counts clamped at max_count, binned (a copy of count.py:173-174)."""
    return np.bincount(np.minimum(counts, max_count), minlength=max_count + 1)


class Run(NamedTuple):
    """finalize's distinct run, what the unitig builders take. Unspilled:
    rows (M,) int64 keys or (M, W) int32 words and counts (M,) int32, the
    whole distinct run on the device; solid its solid rows on the device
    where the Bloom build compacted them (WordCounter), else None. After a
    spill: rows are the solid rows in host memory ((n_solid, W) u32, LSW
    first), counts None, and solid the same rows on the device in the
    counter's form. nu is the exact distinct count."""

    rows: object
    counts: torch.Tensor | None
    nu: int
    solid: torch.Tensor | None


def _host_run(rows: torch.Tensor, counts: torch.Tensor, W: int) -> tuple:
    """A run in host memory -> the reference's spilled form: (uniq (M, W)
    u32 LSW first, counts (M,) int64)."""
    if rows.dim() == 1:
        uniq = keys_from_torch(rows, W)
    else:
        uniq = np.array(rows.numpy().view(np.uint32))
    return uniq, counts.numpy().astype(np.int64)


class _Spilling:
    """A spilled run's copy to the host: a non-blocking D2H into pinned
    memory on the card (the caller's stream orders it before any later
    reuse of the device rows), the tensors themselves on the CPU."""

    def __init__(self, rows: torch.Tensor, counts: torch.Tensor):
        self.done = None
        if rows.device.type != "cuda":
            self.rows, self.counts = rows, counts
            return
        self.rows = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        self.counts = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
        self.rows.copy_(rows, non_blocking=True)
        self.counts.copy_(counts, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(rows.device))

    def resolve(self, W: int) -> tuple:
        if self.done is not None:
            self.done.synchronize()
        return _host_run(self.rows, self.counts, W)


def _bucket_size(n: int, floor: int = 1 << 12) -> int:
    """The reference's size bucket of a run of n rows (a copy of
    leon_tpu/ops/count.py:267-275): 1/8-octave steps of at least 4096 rows,
    1/4-octave past 64M rows. The port pads nothing to it; the counters
    keep it as each run's size for the merge and spill decisions, so that
    they merge and spill exactly where the reference does."""
    shift = 3 if n <= (64 << 20) else 2
    gran = max(floor, 1 << max(0, (n - 1).bit_length() - shift))
    return -(-n // gran) * gran


class _SlabCounter:
    """What both counters share (see the module docstring): the slab (one to
    eight (n,) int64 buffers the scan kernel writes into), its flush to a
    sorted distinct run, the merge of runs past merge_factor slabs, the
    spill of a merged run to host RAM and finalize's selection rules. A
    subclass says how rows are scanned, sorted, reduced, uploaded and
    hashed.

    The schedule is the reference DeviceCounter's (count.py:285-426,
    442-555), kept as bookkeeping: a slab counts the B * P positions of
    each chunk (valid or not, at every k) and flushes after the chunk that
    reaches slab_kmers, so its buffers hold up to a slab plus one chunk; a
    flushed slab's run joins the runs, and its merge check runs, only when
    the next slab flushes or the count ends (the reference's deferred
    compaction); every run counts as _bucket_size of its distinct rows in
    the merge trigger, the next trigger and both spill tests."""

    def __init__(self, k: int, device, slab_kmers: int, merge_factor: int, spill_rows: int,
                 n_bufs: int):
        self.k = k
        self.W = words_for_k(k)
        self.device = torch.device(device)
        self.slab = int(slab_kmers)
        self.merge_factor = int(merge_factor)
        self.spill_rows = int(spill_rows)
        self._n_bufs = n_bufs
        self._buf: list | None = None  # slab storage (grows to a slab plus a chunk)
        self._fill = 0  # rows in the buffers
        self._pend_n = 0  # positions of the chunks in the slab
        self._pending = None  # the last flushed slab's (rows, counts), not a run yet
        self._runs: list = []  # (rows, counts int32, bucket) distinct runs on the device
        self._runs_n = 0  # sum of the runs' buckets
        self._next_merge = self.merge_factor * self.slab
        # spilled runs: (uniq, counts) host pairs, the newest maybe still a
        # _Spilling (depth-1 deferral: at most one copy in flight)
        self._host_runs: list = []
        self.n_spills = 0

    def _reserve(self, n: int) -> list:
        """(n,) views of the slab buffers for the scan kernel to write into."""
        need = self._fill + n
        if self._buf is None or need > self._buf[0].numel():
            have = self._buf[0].numel() if self._buf is not None else 0
            cap = max(need, min(self.slab, 2 * have), 1 << 16)
            bufs = [torch.empty(cap, dtype=torch.int64, device=self.device)
                    for _ in range(self._n_bufs)]
            if self._fill:
                for new, old in zip(bufs, self._buf):
                    new[: self._fill] = old[: self._fill]
            self._buf = bufs
        views = [b[self._fill : need] for b in self._buf]
        self._fill = need
        return views

    def add_packed(self, packed: torch.Tensor, lengths: torch.Tensor, L: int) -> None:
        """Scan one packed chunk (B, ceil(L/16)) int32 straight into the slab."""
        self.add_shards([(packed, lengths)], L)

    def add_shards(self, shards: list, L: int) -> None:
        """Scan one chunk given as lane blocks [(packed, lengths), ...] in lane
        order (the mesh's shards, each on its own device) into the one slab
        on the counter's device, then count the chunk's positions towards
        the slab (count.py:298-308)."""
        positions = 0
        for packed, lengths in shards:
            n = packed.shape[0] * (L - self.k + 1)
            positions += n
            if packed.device == self.device:
                m = self._scan(packed, lengths, L, self._reserve(n))[0].shape[0]
                self._fill -= n - m  # K17 writes the valid rows only
            else:  # another card scans its lanes; its rows come over
                with kernels.device_scope(packed.device):
                    rows = self._scan(packed, lengths, L, None)
                for view, r in zip(self._reserve(rows[0].shape[0]), rows):
                    view.copy_(r)
        self._pend_n += positions
        if self._pend_n >= self.slab:
            self._flush_slab()

    def _flush_slab(self) -> None:
        """Reduce the slab to its sorted distinct run; the previous slab's run
        joins the runs first (count.py:320-333)."""
        if not self._pend_n:
            return
        self._resolve_compact()
        filled = [b[: self._fill] for b in self._buf]
        self._fill = self._pend_n = 0
        self._pending = self._slab_run(filled)

    def _resolve_compact(self, merge: bool = True) -> None:
        """The last flushed slab's run joins the runs at its bucketed size;
        then the merge trigger is checked (count.py:335-370)."""
        if self._pending is None:
            return
        rows, counts = self._pending
        self._pending = None
        bucket = _bucket_size(max(1, counts.numel()))
        self._runs.append((rows, counts, bucket))
        self._runs_n += bucket
        if merge and self._runs_n >= self._next_merge and len(self._runs) > 1:
            self._merge_runs()

    def _merged(self, want_hist: bool):
        """Merge every run into one, read where it lies: the subclass's merge
        of sorted runs, then its reduce (with the histogram if want_hist)."""
        parts = [(r[0], r[1]) for r in self._runs]
        self._runs, self._runs_n = [], 0
        return self._merge_sorted(parts, want_hist)

    def _merge_runs(self) -> None:
        """count.py:389-405: a lone run spills when its bucket reaches
        spill_rows; several merge into one, which spills at a bucket of
        spill_rows or more and else stays as the only run, the next merge
        due merge_factor slabs past its bucket."""
        if len(self._runs) <= 1:
            if self._runs and self._runs[0][2] >= self.spill_rows:
                self._spill_run(*self._runs[0])
            return
        rows, counts, _ = self._merged(False)
        bucket = _bucket_size(max(1, counts.numel()))
        if bucket >= self.spill_rows:
            self._spill_run(rows, counts, bucket)
            return
        self._runs = [(rows, counts, bucket)]
        self._runs_n = bucket
        self._next_merge = bucket + self.merge_factor * self.slab

    def _spill_run(self, rows: torch.Tensor, counts: torch.Tensor, bucket: int) -> None:
        """Move a merged run (bucket: its bucketed size) to host RAM and
        restart the device merge hierarchy empty (count.py:407-426): this
        run's copy starts, the previous one's is resolved."""
        copy = _Spilling(rows, counts)
        if self._host_runs and isinstance(self._host_runs[-1], _Spilling):
            self._host_runs[-1] = self._host_runs[-1].resolve(self.W)
        self._host_runs.append(copy)
        self._runs, self._runs_n = [], 0
        self._next_merge = self.merge_factor * self.slab
        self.n_spills += 1

    def _device_empty(self) -> bool:
        return not self._pend_n and not self._runs and self._pending is None

    def _merged_run(self):
        """Collapse the slab and the runs on the device into one run, which
        the merge spills where its bucket reaches spill_rows
        (count.py:489-502); returns (rows, counts, bucket) or None."""
        self._flush_slab()
        self._resolve_compact()
        self._buf = None
        if not self._runs:
            return None
        if len(self._runs) > 1:
            self._merge_runs()
        return self._runs[0] if self._runs else None

    def _host_merged(self) -> tuple | None:
        """Every run, on the device and spilled, merged into one host run
        (uniq (M, W) u32 LSW first, counts (M,) int64), or None when there
        is none (count.py:504-524)."""
        r = None if self._device_empty() else self._merged_run()
        parts = [h.resolve(self.W) if isinstance(h, _Spilling) else h for h in self._host_runs]
        self._host_runs = []
        if r is not None:
            rows, counts, _ = r
            self._runs, self._runs_n = [], 0
            parts.append(_host_run(rows.cpu(), counts.cpu(), self.W))
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else merge_counts(parts)

    def distinct_run(self) -> tuple:
        """The whole count as the compacted distinct multiset on the host:
        (uniq (M, W) u32 LSW first, counts (M,) int32 clamped), sorted
        (count.py:526-536; the exchange unit of a count across processes)."""
        hm = self._host_merged()
        if hm is None:
            return np.zeros((0, self.W), np.uint32), np.zeros(0, np.int32)
        uniq, counts = hm
        return uniq, np.minimum(counts, _I32_MAX).astype(np.int32)

    def ingest_run(self, uniq: np.ndarray, counts: np.ndarray) -> None:
        """Feed a sorted distinct run (distinct_run's, maybe another
        process's) back in as a run of its own, at its bucketed size and
        with no merge check (count.py:538-555); finalize then takes the
        cutoff and the Bloom filter from the merged counts."""
        M = int(uniq.shape[0])
        if M == 0:
            return
        rows = self._upload(np.ascontiguousarray(uniq, dtype=np.uint32))
        cnt = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int32)).to(self.device)
        bucket = _bucket_size(M)
        self._runs.append((rows, cnt, bucket))
        self._runs_n += bucket

    def finalize(self, abundance, bits_per_kmer, H, seed: int,
                 lossy_quals: bool = False, unitig_max: int = 0):
        """Returns (bitset (n_words,) int32, n_words, cutoff, n_solid,
        hist (256,) int64 numpy, H, run): run is a Run, or None when the
        count is empty. The selection rules are leon_tpu's
        DeviceCounter.finalize (count.py:557-641): without a spill the
        final merge stays on the device and n_solid is read from the
        clamped histogram; after one, _finalize_host."""
        if self._device_empty():
            hist = np.zeros(256, np.int64)
            cutoff = abundance if abundance is not None else 2
            if bits_per_kmer is None:
                bits_per_kmer = 16.0 if lossy_quals else 5.0
            if H is None:
                H = 4 if lossy_quals else 2
            n_words = bloom.choose_n_words(1, bits_per_kmer)
            bitset = torch.zeros(n_words, dtype=torch.int32, device=self.device)
            return bitset, n_words, cutoff, 0, hist, H, None
        if self._host_runs:
            return self._finalize_host(abundance, bits_per_kmer, H, seed, lossy_quals,
                                       unitig_max)
        # the final collapse of the slab, the last flushed slab and the runs
        # never spills (count.py:442-487)
        self._resolve_compact(merge=False)
        if self._pend_n:
            self._runs.append((*self._slab_run([b[: self._fill] for b in self._buf]), 0))
            self._fill = self._pend_n = 0
        self._buf = None
        rows, counts, hist_t = self._merged(True)  # one run: its reduce alone
        hist = hist_t.cpu().numpy().astype(np.int64)
        cutoff = abundance if abundance is not None else auto_cutoff(hist)
        n_solid = int(hist[min(cutoff, 255):].sum())
        bits_per_kmer, H, n_words = self._bloom_size(hist, cutoff, n_solid, bits_per_kmer, H,
                                                     lossy_quals, unitig_max)
        bitset, solid = self._bloom(rows, counts, cutoff, n_words, H, seed)
        return bitset, n_words, cutoff, n_solid, hist, H, Run(rows, counts, int(hist.sum()), solid)

    def _finalize_host(self, abundance, bits_per_kmer, H, seed: int, lossy_quals: bool,
                       unitig_max: int):
        """finalize after a spill (count.py:643-704): one host k-way merge
        of every run; the histogram, cutoff and the exact solid count
        (counts >= cutoff, where the unspilled path reads the clamped
        histogram) on the host; the solid rows go to the card once, where
        K3 or K16 builds the Bloom filter (the bitset of the reference's
        host build_np)."""
        with span("count.fin.host_merge"):
            uniq, counts = self._host_merged()
        hist = histogram(counts)
        cutoff = abundance if abundance is not None else auto_cutoff(hist)
        solid_m = counts >= cutoff
        n_solid = int(solid_m.sum())
        bits_per_kmer, H, n_words = self._bloom_size(hist, cutoff, n_solid, bits_per_kmer, H,
                                                     lossy_quals, unitig_max)
        solid = np.ascontiguousarray(uniq[solid_m])
        with span("count.fin.upload"):
            rows = self._upload(solid)
        bitset = self._bloom_solid(rows, n_words, H, seed)
        return bitset, n_words, cutoff, n_solid, hist, H, Run(solid, None, int(hist.sum()), rows)

    def _bloom_size(self, hist, cutoff: int, n_solid: int, bits_per_kmer, H, lossy_quals: bool,
                    unitig_max: int) -> tuple:
        """(bits_per_kmer, H, n_words): the auto rule where not given; the
        UNITIGS section replaces a stored filter where the solid count
        admits it (bloom.auto_params). Warns where the filter saturates."""
        auto_bpk, auto_h = bloom.auto_params(
            hist, cutoff, lossy_quals,
            stored_filter=not (0 < n_solid <= unitig_max))
        if bits_per_kmer is None:
            bits_per_kmer = auto_bpk
        if H is None:
            H = auto_h
        n_words = bloom.choose_n_words(max(1, n_solid), bits_per_kmer)
        warn = bloom.saturation_warning(n_solid, n_words, bits_per_kmer)
        if warn:
            print(f"[leon-tpu-torch] {warn}", file=sys.stderr)
        return bits_per_kmer, H, n_words


class DeviceCounter(_SlabCounter):
    """Counts canonical k-mers of k <= 31 as one int64 key each (K1 into the
    slab, K22 radix_sort, K2; merges K23 merge_path, K2; the Bloom build
    K3)."""

    def __init__(self, k: int, device, slab_kmers: int = 1 << 25, merge_factor: int = 4,
                 spill_rows: int = 64 << 20):
        super().__init__(k, device, slab_kmers, merge_factor, spill_rows, 1)

    def _scan(self, packed, lengths, L: int, out) -> tuple:
        """K1: every position's key (SENTINEL where invalid), into out."""
        return (kmer_scan(packed, lengths, self.k, L, out=out[0] if out else None),)

    def _slab_run(self, filled: list):
        uk, uc, _ = runs(radix_sort(filled[0]))
        return uk, uc

    def _merge_sorted(self, parts: list, want_hist: bool):
        """Sorted runs [(keys, counts), ...] merged (K23) and reduced (K2)."""
        keys, counts = merge_path(parts)
        return runs(keys, counts, 1, want_hist)

    def _bloom(self, keys, counts, cutoff: int, n_words: int, H: int, seed: int):
        return bloom.bloom_build(keys, counts, cutoff, n_words, H, seed, self.k), None

    def _upload(self, solid: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(words_to_keys(solid)).to(self.device)

    def _bloom_solid(self, keys, n_words: int, H: int, seed: int):
        ones = torch.ones(keys.shape[0], dtype=torch.int32, device=keys.device)
        return bloom.bloom_build(keys, ones, 1, n_words, H, seed, self.k)


class WordCounter(_SlabCounter):
    """Counts canonical k-mers of 32 <= k <= 255 (W = 2..16 u32 words) with
    DeviceCounter's slab, flush, merge, spill and finalize rules: K17 writes
    the valid positions' P = ceil(W/2) sign-flipped int64 planes into the
    slab's P buffers (invalid rows are dropped, so no key marks them),
    sort_slab orders them (W >= 3: K21, the top sort, K20), K14 reduces;
    runs are (M, W) int32 words with int32 counts, merged by K23
    (merge_path_rows, the runs read in place) and reduced by K14's row
    policy (word_runs_rows; the final run's too); the Bloom build is that policy's solid mode,
    then K16 over those rows (which finalize hands on for the unitig
    builder)."""

    def __init__(self, k: int, device, slab_kmers: int = 1 << 25, merge_factor: int = 4,
                 spill_rows: int = 64 << 20):
        super().__init__(k, device, slab_kmers, merge_factor, spill_rows,
                         n_planes(words_for_k(k)))

    def _scan(self, packed, lengths, L: int, out) -> tuple:
        """K17: the valid positions' planes only, at the head of out."""
        return kmer_scan_halves(packed, lengths, self.k, L, out=tuple(out) if out else None)

    def _slab_run(self, filled: list):
        words, counts, _ = word_runs(sort_slab(filled, self.W, top_key_bits(self.k)), self.W)
        return words, counts

    def _merge_sorted(self, parts: list, want_hist: bool):
        """Sorted runs [(words, counts), ...] merged (K23) and reduced (K14's
        row policy)."""
        words, counts = merge_path_rows(parts)
        return word_runs_rows(words, counts, 1, want_hist)

    def _bloom(self, words, counts, cutoff: int, n_words: int, H: int, seed: int):
        solid = compact_solid_words(words, counts, cutoff)[0]
        return self._bloom_solid(solid, n_words, H, seed), solid

    def _upload(self, solid: np.ndarray) -> torch.Tensor:
        return words_to_torch(solid, self.device)

    def _bloom_solid(self, words, n_words: int, H: int, seed: int):
        ones = torch.ones(words.shape[0], dtype=torch.bool, device=words.device)
        return bloom.bloom_build_words(words, ones, n_words, n_words, H, seed, self.k)
