"""Canonical k-mer counting and the solidity threshold (counterpart of
leon_tpu/ops/count.py).

Device half (new): ``runs``, the wrapper of kernel K2 (csrc/count.cu): a
reduce-by-key over a sorted int64 key array that emits each distinct key
with its summed count, in order, and optionally the 256-bin count
histogram. It replaces the reference's boundary/run-length, compaction,
merge-sum, histogram and solid-compaction programs
(count.py:34-85, 208-264, 707-719). The sort before it is ``torch.sort``,
as the reference leaves its sort to ``lax.sort``.

``DeviceCounter`` streams k-mer keys through one slab on the device: the
scan kernel writes into the slab, a full slab is sorted and reduced to its
distinct run, and runs merge (sort with the counts as payload, then K2)
once they outgrow ``merge_factor`` slabs. Slab and run sizes are set for
an 80 GB card; a run past ``SPILL_ROWS`` would need the reference's host
spill (count.py:592-600, 643-704), which the port does not have yet.

``auto_cutoff`` is a copy of count.py:761-784.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from leon_tpu_torch import kernels
from leon_tpu_torch.ops import bloom
from leon_tpu_torch.ops.kmer import SENTINEL, kmer_scan

_I32_MAX = 0x7FFFFFFF
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Kernel K2 and its plain version
# ---------------------------------------------------------------------------


def _check_runs_args(keys, counts) -> None:
    kernels.need(keys.dtype == torch.int64 and keys.dim() == 1, "runs: keys must be (n,) int64")
    if counts is not None:
        kernels.need(counts.dtype == torch.int32 and counts.shape == keys.shape,
                     "runs: counts must be (n,) int32")
        kernels.need(counts.device == keys.device, "runs: tensors on two devices")


def runs(keys: torch.Tensor, counts: torch.Tensor | None = None, cutoff: int = 1,
         want_hist: bool = False):
    """Reduce-by-key over SORTED int64 keys; SENTINEL rows are ignored.

    A run's value is its length (counts None) or the u32-wrapping sum of its
    int32 counts, clamped to 2**31-1 (count.py:239-253). Runs whose value is
    >= max(cutoff, 1) are emitted in key order: zero-sum runs always drop,
    and cutoff > 1 is compact_solid. Returns (keys (R,) int64, counts (R,)
    int32, hist): hist is the (256,) integer histogram of min(value, 255)
    over the emitted runs (bin 0 is 0) when want_hist, else None."""
    _check_runs_args(keys, counts)
    if not kernels.on_cuda(keys, "runs"):
        return runs_plain(keys, counts, cutoff, want_hist)
    keys = keys.contiguous()
    counts = counts.contiguous() if counts is not None else None
    dev = keys.device
    n = keys.shape[0]
    lib = kernels.lib()
    cnt_p = counts.data_ptr() if counts is not None else None
    nb = max(1, -(-n // 256))
    block_off = torch.empty(nb, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    hist = torch.empty(256, dtype=torch.int32, device=dev) if want_hist else None
    st = kernels.stream(keys)
    rc = lib.lt_runs_count(keys.data_ptr(), cnt_p, n, int(cutoff),
                           hist.data_ptr() if hist is not None else None,
                           block_off.data_ptr(), total.data_ptr(), st)
    kernels.check(rc, "runs")
    R = int(total.item())
    out_k = torch.empty(R, dtype=torch.int64, device=dev)
    out_c = torch.empty(R, dtype=torch.int32, device=dev)
    rc = lib.lt_runs_write(keys.data_ptr(), cnt_p, n, int(cutoff),
                           block_off.data_ptr(), out_k.data_ptr(),
                           out_c.data_ptr(), st)
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


# ---------------------------------------------------------------------------
# Streaming counter
# ---------------------------------------------------------------------------


SLAB_KMERS = 1 << 27   # 1 GiB of int64 keys; the sort transient is ~3x that
SPILL_ROWS = 1 << 30   # largest distinct run kept on the card (12 GiB)


class DeviceCounter:
    """Counts canonical k-mer keys on one device (see module docstring)."""

    def __init__(self, k: int, device, slab_kmers: int = SLAB_KMERS, merge_factor: int = 4):
        self.k = k
        self.device = torch.device(device)
        self.slab = int(slab_kmers)
        self.merge_factor = int(merge_factor)
        self._buf: torch.Tensor | None = None  # slab storage (grows to slab)
        self._fill = 0
        self._runs: list = []  # (keys int64, counts int32) distinct runs
        self._runs_n = 0
        self._next_merge = self.merge_factor * self.slab

    def _reserve(self, n: int) -> torch.Tensor:
        """A (n,) view of the slab for the scan kernel to write into."""
        if self._fill and self._fill + n > self.slab:
            self._flush_slab()
        need = self._fill + n
        if self._buf is None or need > self._buf.numel():
            have = self._buf.numel() if self._buf is not None else 0
            cap = max(need, min(self.slab, 2 * have), 1 << 16)
            buf = torch.empty(cap, dtype=torch.int64, device=self.device)
            if self._fill:
                buf[: self._fill] = self._buf[: self._fill]
            self._buf = buf
        view = self._buf[self._fill : need]
        self._fill = need
        return view

    def add_packed(self, packed: torch.Tensor, lengths: torch.Tensor, L: int) -> None:
        """Scan one packed chunk (B, ceil(L/16)) int32 straight into the slab."""
        B = packed.shape[0]
        n = B * (L - self.k + 1)
        kmer_scan(packed, lengths, self.k, L, out=self._reserve(n))
        if self._fill >= self.slab:
            self._flush_slab()

    def _flush_slab(self) -> None:
        if not self._fill:
            return
        skeys = torch.sort(self._buf[: self._fill]).values
        self._fill = 0
        uk, uc, _ = runs(skeys)
        self._runs.append((uk, uc))
        self._runs_n += uk.numel()
        if self._runs_n >= self._next_merge and len(self._runs) > 1:
            self._merge_runs()

    def _merged(self, want_hist: bool):
        """Merge every run into one: sort with the counts as payload, K2."""
        keys = torch.cat([r[0] for r in self._runs])
        counts = torch.cat([r[1] for r in self._runs])
        self._runs, self._runs_n = [], 0
        skeys, perm = torch.sort(keys)
        return runs(skeys, counts[perm], 1, want_hist)

    def _merge_runs(self) -> None:
        uk, uc, _ = self._merged(False)
        self._check_spill(uk.numel())
        self._runs = [(uk, uc)]
        self._runs_n = uk.numel()
        self._next_merge = self._runs_n + self.merge_factor * self.slab

    @staticmethod
    def _check_spill(n: int) -> None:
        if n >= SPILL_ROWS:
            raise NotImplementedError(
                f"distinct k-mer run of {n} rows exceeds the on-card limit "
                f"{SPILL_ROWS}: the host-spilled count is ROADMAP.md queue 1, item 9")

    def finalize(self, abundance, bits_per_kmer, H, seed: int,
                 lossy_quals: bool = False, unitig_max: int = 0):
        """Returns (bitset (n_words,) int32, n_words, cutoff, n_solid,
        hist (256,) int64 numpy, H, run) where run = (keys, counts, nu) is
        the final distinct run on the device (None when empty). The
        selection rules are leon_tpu's DeviceCounter.finalize
        (count.py:557-641)."""
        self._flush_slab()
        self._buf = None
        if not self._runs:
            hist = np.zeros(256, np.int64)
            cutoff = abundance if abundance is not None else 2
            if bits_per_kmer is None:
                bits_per_kmer = 16.0 if lossy_quals else 5.0
            if H is None:
                H = 4 if lossy_quals else 2
            n_words = bloom.choose_n_words(1, bits_per_kmer)
            bitset = torch.zeros(n_words, dtype=torch.int32, device=self.device)
            return bitset, n_words, cutoff, 0, hist, H, None
        if len(self._runs) == 1:
            uk, uc = self._runs[0]
            self._runs, self._runs_n = [], 0
            keys, counts, hist_t = runs(uk, uc, 1, True)
        else:
            keys, counts, hist_t = self._merged(True)
        self._check_spill(keys.numel())
        hist = hist_t.cpu().numpy().astype(np.int64)
        cutoff = abundance if abundance is not None else auto_cutoff(hist)
        n_solid = int(hist[min(cutoff, 255):].sum())
        auto_bpk, auto_h = bloom.auto_params(
            hist, cutoff, lossy_quals,
            stored_filter=not (0 < n_solid <= unitig_max))
        if bits_per_kmer is None:
            bits_per_kmer = auto_bpk
        if H is None:
            H = auto_h
        n_words = bloom.choose_n_words(max(1, n_solid), bits_per_kmer)
        bitset = bloom.bloom_build(keys, counts, cutoff, n_words, H, seed, self.k)
        warn = bloom.saturation_warning(n_solid, n_words, bits_per_kmer)
        if warn:
            print(f"[leon-tpu-torch] {warn}", file=sys.stderr)
        return (bitset, n_words, cutoff, n_solid, hist, H,
                (keys, counts, int(hist.sum())))
