"""Bloom filter over canonical solid k-mers (counterpart of
leon_tpu/ops/bloom.py; hash family v4 and blocked addressing are frozen by
FORMAT.md §4).

Host half: a numpy-only copy of leon_tpu/ops/bloom.py:26-60, 97-195 and
265-366 (tables, hashing, addressing, sizing rules, the native host
build), kept here because that module imports jax when it loads.

Device half (new): ``bloom_build``, the wrapper of kernel K3
(csrc/bloom.cu), and ``bloom_build_plain``; plus the plain PyTorch hash
and probe helpers the walk's plain versions share. PyTorch's uint32 lacks
shifts and comparisons on the CPU, so plain u32 values ride in int64
masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from leon_tpu_torch import kernels

# FORMAT.md §4 frozen constants
_C1 = 0x5BF03635
_PHI = 0x9E3779B9
_M32 = 0xFFFFFFFF

MAX_WORDS = (1 << 31) - 64  # word index must fit int32


def _fmix32_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


def _rol_int(x: int, r: int) -> int:
    r %= 32
    return ((x << r) | (x >> (32 - r))) & _M32


def tables(seed: int, k: int) -> np.ndarray:
    """Table constants for hash family v4, shape (4, 4) uint32:
    [kind][base] with kind 0=T, 1=Tc, 2=Trot, 3=Tcrot."""
    out = np.zeros((4, 4), dtype=np.uint32)
    base = _fmix32_int(seed ^ _C1)
    T = [_fmix32_int((base + b * _PHI) & _M32) for b in range(4)]
    Tc = [T[3 - b] for b in range(4)]
    out[0] = T
    out[1] = Tc
    out[2] = [_rol_int(v, k - 1) for v in T]
    out[3] = [_rol_int(v, k - 1) for v in Tc]
    return out


def hash_words(words, k: int, seed: int):
    """From-scratch (f, r) strand-chain values of packed k-mer words
    (..., W) u32 (numpy)."""
    tab = tables(seed, k)
    shape = words.shape[:-1]
    u = np.uint32
    f = np.zeros(shape, np.uint32)
    r = np.zeros(shape, np.uint32)
    T = np.asarray(tab[0])
    Tc = np.asarray(tab[1])
    for i in range(k):
        t = 2 * (k - 1 - i)
        bi = ((words[..., t // 32] >> u(t % 32)) & u(3)).astype(np.int64)
        rf = (k - 1 - i) % 32
        rr = i % 32
        tv = np.take(T, bi)
        cv = np.take(Tc, bi)
        f = f ^ (((tv << u(rf)) | (tv >> u((32 - rf) % 32))) if rf else tv)
        r = r ^ (((cv << u(rr)) | (cv >> u((32 - rr) % 32))) if rr else cv)
    return f, r


def mulhi32(a, b):
    """High 32 bits of the u32 x u32 product in pure u32 arithmetic."""
    u = np.uint32
    M16 = u(0xFFFF)
    al, ah = a & M16, a >> u(16)
    bl, bh = b & M16, b >> u(16)
    ll = al * bl
    hl = ah * bl
    lh = al * bh
    hh = ah * bh
    cross = (ll >> u(16)) + (hl & M16) + lh
    return hh + (hl >> u(16)) + (cross >> u(16))


def wordmask_from_hashes(f, r, n_hashes: int, n_words: int):
    """Blocked addressing (FORMAT.md §4 v4): word = mulhi32(min(f, r),
    n_words); mask = OR of 1 << bit_i, bit_i = (max >> 5i) & 31 for i < 6,
    then (min >> 5(i-6)) & 31. Returns (word int64, mask uint32)."""
    u = np.uint32
    if n_words > MAX_WORDS:
        raise ValueError(f"n_words {n_words} > {MAX_WORDS}")
    lo = np.minimum(f, r)
    hi = np.maximum(f, r)
    wi = mulhi32(lo, u(n_words)).astype(np.int64)
    mask = np.zeros(lo.shape, np.uint32)
    for i in range(n_hashes):
        b = ((hi >> u(5 * i)) if i < 6 else (lo >> u(5 * (i - 6)))) & u(31)
        mask = mask | (u(1) << b)
    return wi, mask


def wordmask(words, n_hashes: int, n_words: int, seed: int, k: int):
    """(word_index, 32-bit mask) of packed k-mer words (..., W)."""
    f, r = hash_words(words, k, seed)
    return wordmask_from_hashes(f, r, n_hashes, n_words)


def auto_params(hist: np.ndarray, cutoff: int,
                lossy_quals: bool = False,
                stored_filter: bool = True) -> tuple[float, int]:
    """(bits_per_kmer, n_hashes) from the count histogram — the frozen rule
    of leon_tpu/ops/bloom.py:265-310 (see its docstring for the sweeps)."""
    c = min(max(int(cutoff), 0), hist.size - 1)
    n_solid = float(hist[c:].sum())
    if n_solid <= 0:
        return (16.0, 4) if lossy_quals else (8.0, 3)
    mean_cov = float((np.arange(hist.size) * hist)[c:].sum()) / n_solid
    if lossy_quals:
        bpk = float(np.clip(3.4 * mean_cov, 12.0, 24.0))
        return (max(bpk, 24.0), 4) if not stored_filter else (bpk, 4)
    bpk = float(np.clip(1.2 * mean_cov, 4.0, 24.0))
    if not stored_filter:
        return max(bpk, 24.0), 4
    H = 2 if bpk < 6.0 else (3 if bpk < 10.0 else 4)
    return bpk, H


def choose_n_words(n_solid: int, bits_per_kmer: float) -> int:
    """Bitset words for an exactly-sized filter (multiple of 64 words)."""
    want_words = int(np.ceil(max(64.0, n_solid * bits_per_kmer) / 32.0))
    return min(-(-want_words // 64) * 64, MAX_WORDS)


def saturation_warning(n_solid: int, n_words: int, bits_per_kmer: float) -> str | None:
    """Warn when MAX_WORDS clipped the filter below its design point."""
    want_bits = n_solid * bits_per_kmer
    have_bits = 32.0 * n_words
    if have_bits < 0.8 * want_bits:
        return (
            f"Bloom filter clipped: {n_solid} solid k-mers want "
            f"{want_bits / 8e6:.0f} MB at {bits_per_kmer} bits/kmer but the "
            f"filter is capped at {have_bits / 8e6:.0f} MB; false positives "
            "will inflate the event streams (raise abundance to shrink the "
            "solid set)"
        )
    return None


def build_np(solid_words: np.ndarray, n_words: int, n_hashes: int, seed: int, k: int) -> np.ndarray:
    """Host build: uint32 bitset of shape (n_words,). Native per-row kernel
    when available; bit-identical numpy fallback."""
    bitset = np.zeros(n_words, dtype=np.uint32)
    if not solid_words.shape[0]:
        return bitset
    from leon_tpu import native

    lib = native.get_lib()
    if lib is not None and hasattr(lib, "leon_bloom_build"):
        tab = tables(seed, k)
        T = np.ascontiguousarray(tab[0])
        Tc = np.ascontiguousarray(tab[1])
        w = np.ascontiguousarray(solid_words, dtype=np.uint32)
        rc = lib.leon_bloom_build(w.shape[0], w.shape[1], w.ctypes.data,
                                  int(n_words), int(n_hashes), int(k),
                                  T.ctypes.data, Tc.ctypes.data,
                                  bitset.ctypes.data)
        if rc == 0:
            return bitset
        bitset[:] = 0
    wi, mask = wordmask(solid_words, n_hashes, n_words, seed, k)
    np.bitwise_or.at(bitset, wi.reshape(-1), mask.reshape(-1))
    return bitset


# ---------------------------------------------------------------------------
# Plain PyTorch hashing and probing (u32 values in int64)
# ---------------------------------------------------------------------------


def rol(x: torch.Tensor, r: int) -> torch.Tensor:
    r %= 32
    if not r:
        return x
    return ((x << r) | (x >> (32 - r))) & _M32


def ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return rol(x, 32 - (r % 32))


def take4(tab_row: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """tab_row[idx] for a (4,) u32 table and int64 indices, as int64."""
    t = torch.tensor([int(v) for v in tab_row], dtype=torch.int64, device=idx.device)
    return t[idx]


def hash_keys_plain(keys: torch.Tensor, k: int, tab: np.ndarray):
    """From-scratch (f, r) of int64 k-mer keys (hash_words on one word)."""
    f = torch.zeros_like(keys)
    r = torch.zeros_like(keys)
    for i in range(k):
        b = (keys >> (2 * (k - 1 - i))) & 3
        f = f ^ rol(take4(tab[0], b), (k - 1 - i) % 32)
        r = r ^ rol(take4(tab[1], b), i % 32)
    return f, r


def wordmask_plain(f: torch.Tensor, r: torch.Tensor, H: int, n_words: int):
    """wordmask_from_hashes on int64-held u32 values: (word, mask) int64."""
    lo = torch.minimum(f, r)
    hi = torch.maximum(f, r)
    wi = (lo * int(n_words)) >> 32
    mask = torch.zeros_like(lo)
    for i in range(H):
        b = ((hi >> (5 * i)) if i < 6 else (lo >> (5 * (i - 6)))) & 31
        mask = mask | (torch.ones_like(b) << b)
    return wi, mask


def probe_plain(bitset: torch.Tensor, f: torch.Tensor, r: torch.Tensor,
                H: int, n_words: int) -> torch.Tensor:
    """Blocked membership of (f, r) pairs in an int32-stored bitset."""
    wi, mask = wordmask_plain(f, r, H, n_words)
    w = bitset.to(torch.int64)[wi] & _M32
    return (w & mask) == mask


# ---------------------------------------------------------------------------
# Device build: kernel K3 and its plain version
# ---------------------------------------------------------------------------


def _check_build_args(keys, counts, n_words: int, H: int, k: int) -> None:
    kernels.need(keys.dtype == torch.int64 and keys.dim() == 1,
                 "bloom_build: keys must be (M,) int64")
    kernels.need(counts.dtype == torch.int32 and counts.shape == keys.shape,
                 "bloom_build: counts must be (M,) int32")
    kernels.need(counts.device == keys.device, "bloom_build: tensors on two devices")
    kernels.need(1 <= H <= 8, f"bloom_build: H={H} not in [1, 8]")
    kernels.need(1 <= k <= 31, f"bloom_build: k={k} needs multiword keys")
    kernels.need(0 < n_words <= MAX_WORDS, f"bloom_build: n_words={n_words}")


def bloom_build(keys: torch.Tensor, counts: torch.Tensor, cutoff: int,
                n_words: int, H: int, seed: int, k: int) -> torch.Tensor:
    """Bitset (n_words,) int32 over the keys whose count >= cutoff. The
    reference (bloom.build_device) returns alloc_words(n_words) words whose
    [:n_words] prefix is this bitset."""
    _check_build_args(keys, counts, n_words, H, k)
    if not kernels.on_cuda(keys, "bloom_build"):
        return bloom_build_plain(keys, counts, cutoff, n_words, H, seed, k)
    keys = keys.contiguous()
    counts = counts.contiguous()
    bits = torch.empty(n_words, dtype=torch.int32, device=keys.device)
    tab = kernels.host_tables(tables(seed, k))
    rc = kernels.lib().lt_bloom_build(
        keys.data_ptr(), counts.data_ptr(), keys.shape[0], int(cutoff),
        int(n_words), H, k, tab.ctypes.data, bits.data_ptr(), kernels.stream(keys))
    kernels.check(rc, "bloom_build")
    kernels.launches["bloom_build"] += 1
    return bits


def bloom_build_plain(keys: torch.Tensor, counts: torch.Tensor, cutoff: int,
                      n_words: int, H: int, seed: int, k: int) -> torch.Tensor:
    """Plain version of bloom_build: hash every solid row from scratch, set
    its mask bits (leon_tpu/ops/bloom.py:394-414 sets the same (word, bit)
    pairs by sort-dedup-scatter)."""
    _check_build_args(keys, counts, n_words, H, k)
    solid = keys[counts >= cutoff]
    f, r = hash_keys_plain(solid, k, tables(seed, k))
    wi, mask = wordmask_plain(f, r, H, n_words)
    bit = torch.zeros(n_words * 32, dtype=torch.bool, device=keys.device)
    for b in range(32):
        sel = ((mask >> b) & 1) == 1
        bit[wi[sel] * 32 + b] = True
    weights = torch.ones(32, dtype=torch.int64, device=keys.device) << torch.arange(
        32, device=keys.device)
    words = (bit.reshape(n_words, 32).to(torch.int64) * weights).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
