"""Bloom filter over canonical solid k-mers (counterpart of
leon_tpu/ops/bloom.py; hash family v4 and blocked addressing are frozen by
FORMAT.md §4).

Host half: a numpy-only copy of leon_tpu/ops/bloom.py:26-60, 97-195,
225-254 and 265-366 (tables, hashing, blocked and classic addressing,
sizing rules, the native and classic host builds), kept here because that
module imports jax when it loads.

Device half (new): ``bloom_build``, the wrapper of kernel K3
(csrc/bloom.cu), and ``bloom_build_plain``; ``dbg_probe``, the wrapper of
kernel K10 (csrc/graph.cu: blocked or classic membership of (N, W) k-mer
words or of their four neighbours), with ``probe`` and ``probe_classic``
on top of it, and ``dbg_probe_plain``; ``bloom_build_words``, the wrapper
of kernel K16 (csrc/bloom.cu: one shard's blocked partial over (S, W)
k-mer words: parallel/mesh.py's at k <= 255, the main path's Bloom build
over the solid rows at 32 <= k <= 255), and its plain version, with
``alloc_words`` (a copy of bloom.py:123-134); plus the plain PyTorch hash and
probe helpers the walk's plain versions share. PyTorch's uint32 lacks
shifts and comparisons on the CPU, so plain u32 values ride in int64
masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from leon_tpu_torch import kernels
from leon_tpu_torch.ops.kmer import i32_bits, need_words_k, shl2, shr2_ins, top_mask

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


def wordbit_classic_from_hashes(f, r, n_hashes: int, n_words: int):
    """Classic (unblocked) addressing, numpy (leon_tpu/ops/bloom.py:225-244):
    H (word, bit) pairs by double hashing g_i = h1 + i*h2 with
    (h1, h2) = (min(f, r), max(f, r) | 1), word = mulhi32(g_i, n_words),
    bit = g_i & 31. Used by the graph API, not by the container format."""
    u = np.uint32
    if n_words > MAX_WORDS:
        raise ValueError(f"n_words {n_words} > {MAX_WORDS}")
    h1 = np.minimum(f, r)
    h2 = np.maximum(f, r) | u(1)
    wis, bits = [], []
    for i in range(n_hashes):
        g = h1 + u(i) * h2
        wis.append(mulhi32(g, u(n_words)).astype(np.int64))
        bits.append(g & u(31))
    return np.stack(wis, axis=-1), np.stack(bits, axis=-1)


def build_np_classic(solid_words: np.ndarray, n_words: int, n_hashes: int,
                     seed: int, k: int) -> np.ndarray:
    """Host build of a classic-addressed bitset (leon_tpu/ops/bloom.py:247-254)."""
    bitset = np.zeros(n_words, dtype=np.uint32)
    if solid_words.shape[0]:
        f, r = hash_words(solid_words, k, seed)
        wi, bit = wordbit_classic_from_hashes(f, r, n_hashes, n_words)
        np.bitwise_or.at(bitset, wi.reshape(-1), np.uint32(1) << bit.reshape(-1))
    return bitset


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
    from leon_tpu_torch import native

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
    """tab_row[idx] for a (4,) u32 table and int64 indices 0..3, as int64;
    the values are picked as Python ints (a table copied to the card would
    make each call wait for it)."""
    v = [int(x) for x in tab_row]
    return torch.where(idx < 2, torch.where(idx == 0, v[0], v[1]),
                       torch.where(idx == 2, v[2], v[3]))


def hash_keys_plain(keys: torch.Tensor, k: int, tab: np.ndarray):
    """From-scratch (f, r) of int64 k-mer keys (k <= 31): hash_words_plain
    on the key's two u32 words."""
    return hash_words_plain(torch.stack([keys & _M32, keys >> 32], dim=-1), k, tab)


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


def hash_words_plain(words: torch.Tensor, k: int, tab: np.ndarray):
    """From-scratch (f, r) of packed k-mer words (..., W), u32 values in
    int64, with the tables(seed, k) rows (leon_tpu/ops/bloom.py:97-117).
    Bases go 32 at a time: their codes, table values and rotations as
    (..., 32) tensors, XOR-folded; k one-base steps would cost k launches
    of every op at k = 255."""
    dev = words.device
    f = torch.zeros(words.shape[:-1], dtype=torch.int64, device=dev)
    r = torch.zeros_like(f)
    for i0 in range(0, k, 32):
        i = torch.arange(i0, min(i0 + 32, k), device=dev)
        t = 2 * (k - 1 - i)
        b = (words[..., t // 32] >> (t % 32)) & 3
        f = f ^ _xor_fold(_rol_each(take4(tab[0], b), (k - 1 - i) % 32))
        r = r ^ _xor_fold(_rol_each(take4(tab[1], b), i % 32))
    return f, r


def _rol_each(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 (..., n) rotated left by s (n,) in [0, 32)."""
    return ((x << s) | (x >> (32 - s))) & _M32


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last dimension."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = torch.cat([x[..., :h] ^ x[..., h : 2 * h], x[..., 2 * h :]], dim=-1)
    return x[..., 0]


def wordbit_classic_plain(f: torch.Tensor, r: torch.Tensor, H: int, n_words: int):
    """wordbit_classic_from_hashes on int64-held u32 values: (word, bit)
    int64 (..., H)."""
    h1 = torch.minimum(f, r)
    h2 = torch.maximum(f, r) | 1
    g = torch.stack([(h1 + i * h2) & _M32 for i in range(H)], dim=-1)
    return (g * int(n_words)) >> 32, g & 31


# ---------------------------------------------------------------------------
# Graph probes: kernel K10 and its plain version
# ---------------------------------------------------------------------------

SELF, OUT, IN = 0, 1, 2  # K10 modes: the row, its 4 shl2 / 4 shr2_ins neighbours
_MODES = {"self": SELF, "out": OUT, "in": IN}


def check_probe_args(bitset, words, mode: int, classic: bool, H: int, n_words: int,
                     k: int) -> None:
    kernels.need(mode in (SELF, OUT, IN), f"dbg_probe: mode {mode}")
    kernels.need(words.dtype == torch.int32 and words.dim() == 2,
                 "dbg_probe: words must be (N, W) int32 (u32 bits)")
    need_words_k(k, "dbg_probe")
    kernels.need(words.shape[1] == (k + 15) // 16,
                 f"dbg_probe: {words.shape[1]} words for k={k} (need ceil(k/16))")
    kernels.need(bitset.dtype == torch.int32 and bitset.dim() == 1,
                 "dbg_probe: bitset must be (n,) int32")
    kernels.need(bitset.device == words.device, "dbg_probe: tensors on two devices")
    kernels.need(0 < n_words <= min(bitset.numel(), MAX_WORDS),
                 f"dbg_probe: n_words={n_words} for a {bitset.numel()}-word bitset")
    kernels.need(H >= 1 and (classic or H <= 8), f"dbg_probe: H={H}")


def dbg_probe(bitset: torch.Tensor, words: torch.Tensor, mode: str, classic: bool,
              H: int, n_words: int, seed: int, k: int) -> torch.Tensor:
    """Membership of (N, W) int32 k-mer words (mode "self" -> (N,) bool) or
    of their four shl2 ("out") or shr2_ins ("in") neighbours (-> (N, 4)
    bool), classic or blocked addressing, in an int32-stored bitset."""
    m = _MODES[mode]
    check_probe_args(bitset, words, m, classic, H, n_words, k)
    if not kernels.on_cuda(words, "dbg_probe"):
        return dbg_probe_plain(bitset, words, mode, classic, H, n_words, seed, k)
    words, bitset = words.contiguous(), bitset.contiguous()
    N, W = words.shape
    out = torch.empty((N,) if m == SELF else (N, 4), dtype=torch.bool, device=words.device)
    tab = kernels.host_tables(tables(seed, k))
    rc = kernels.lib().lt_dbg_probe(
        words.data_ptr(), N, W, m, int(classic), k, top_mask(k), tab.ctypes.data,
        bitset.data_ptr(), H, int(n_words), out.data_ptr(), kernels.stream(words))
    kernels.check(rc, "dbg_probe")
    kernels.launches["dbg_probe"] += 1
    return out


def dbg_probe_plain(bitset: torch.Tensor, words: torch.Tensor, mode: str, classic: bool,
                    H: int, n_words: int, seed: int, k: int) -> torch.Tensor:
    """Plain version of dbg_probe: the reference's from-scratch hash_words,
    then wordbit_classic_from_hashes + probe_wordbit or wordmask +
    probe_wordmask (leon_tpu/ops/bloom.py:257-262, 369-386), on the
    neighbours graph.DBG._neighbor_words builds (graph.py:56-72)."""
    m = _MODES[mode]
    check_probe_args(bitset, words, m, classic, H, n_words, k)
    return probe_words_plain(bitset.to(torch.int64) & _M32, words.to(torch.int64) & _M32,
                             m, classic, H, n_words, seed, k)


def probe_words_plain(bits: torch.Tensor, w: torch.Tensor, m: int, classic: bool, H: int,
                      n_words: int, seed: int, k: int) -> torch.Tensor:
    """dbg_probe_plain's arithmetic on int64-held u32 values: bits (n,),
    words (N, W); m one of SELF, OUT, IN."""
    if m != SELF:
        step = shl2 if m == OUT else shr2_ins
        w = torch.stack([step(w, c, k) for c in range(4)], dim=1)
    f, r = hash_words_plain(w, k, tables(seed, k))
    if classic:
        wi, bit = wordbit_classic_plain(f, r, H, n_words)
        return (((bits[wi] >> bit) & 1) == 1).all(dim=-1)
    wi, mask = wordmask_plain(f, r, H, n_words)
    return (bits[wi] & mask) == mask


def probe_classic(bitset: torch.Tensor, words: torch.Tensor, n_hashes: int, n_words: int,
                  seed: int, k: int) -> torch.Tensor:
    """Classic-addressed membership of (N, W) words -> (N,) bool (K10)."""
    return dbg_probe(bitset, words, "self", True, n_hashes, n_words, seed, k)


def probe(bitset: torch.Tensor, words: torch.Tensor, n_hashes: int, n_words: int,
          seed: int, k: int) -> torch.Tensor:
    """Blocked membership (the container's addressing) of (N, W) words ->
    (N,) bool (K10)."""
    return dbg_probe(bitset, words, "self", False, n_hashes, n_words, seed, k)


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
    return _or_masks(wi, mask, n_words)


def _or_masks(wi: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int32 words holding the OR of every mask at its word index."""
    bit = torch.zeros(n * 32, dtype=torch.bool, device=wi.device)
    for b in range(32):
        sel = ((mask >> b) & 1) == 1
        bit[wi[sel] * 32 + b] = True
    weights = torch.ones(32, dtype=torch.int64, device=wi.device) << torch.arange(
        32, device=wi.device)
    words = (bit.reshape(n, 32).to(torch.int64) * weights).sum(dim=1)
    return i32_bits(words)


# ---------------------------------------------------------------------------
# Sharded build partial: kernel K16 and its plain version
# ---------------------------------------------------------------------------


def alloc_words(n_words: int) -> int:
    """Device-allocation size of an exact-size filter (a copy of
    leon_tpu/ops/bloom.py:123-134): the next point on a 1/8-octave grid,
    a multiple of 64 words."""
    n = max(64, int(n_words))
    step = max(64, 1 << ((n - 1).bit_length() - 3))
    a = -(-n // step) * step
    return min(-(-a // 64) * 64, MAX_WORDS)


def _check_build_words_args(words, valid, n_alloc: int, n_words: int, H: int, k: int) -> None:
    kernels.need(1 <= k <= 255, f"bloom_build_words: k={k} not in [1, 255]")
    kernels.need(words.dtype == torch.int32 and words.dim() == 2
                 and words.shape[1] == (k + 15) // 16,
                 f"bloom_build_words: words must be (S, {(k + 15) // 16}) int32 for k={k}")
    kernels.need(valid.dtype == torch.bool and valid.shape == (words.shape[0],),
                 "bloom_build_words: valid must be (S,) bool")
    kernels.need(valid.device == words.device, "bloom_build_words: tensors on two devices")
    kernels.need(1 <= H <= 8, f"bloom_build_words: H={H} not in [1, 8]")
    kernels.need(0 < n_words <= n_alloc <= MAX_WORDS,
                 f"bloom_build_words: n_words={n_words}, n_alloc={n_alloc}")


def bloom_build_words(words: torch.Tensor, valid: torch.Tensor, n_alloc: int, n_words: int,
                      H: int, seed: int, k: int) -> torch.Tensor:
    """Blocked Bloom partial (n_alloc,) int32 over the valid rows of (S, W)
    int32 k-mer words, addressed into the first n_words words (the rest
    stay zero): one shard's part of sharded_bloom_build (kernel K16)."""
    _check_build_words_args(words, valid, n_alloc, n_words, H, k)
    if not kernels.on_cuda(words, "bloom_build_words"):
        return bloom_build_words_plain(words, valid, n_alloc, n_words, H, seed, k)
    words, valid = words.contiguous(), valid.contiguous()
    bits = torch.empty(n_alloc, dtype=torch.int32, device=words.device)
    tab = kernels.host_tables(tables(seed, k))
    rc = kernels.lib().lt_bloom_build_words(
        words.data_ptr(), valid.data_ptr(), words.shape[0], words.shape[1], int(n_alloc),
        int(n_words), H, k, tab.ctypes.data, bits.data_ptr(), kernels.stream(words))
    kernels.check(rc, "bloom_build_words")
    kernels.launches["bloom_build_words"] += 1
    return bits


def bloom_build_words_plain(words: torch.Tensor, valid: torch.Tensor, n_alloc: int,
                            n_words: int, H: int, seed: int, k: int) -> torch.Tensor:
    """Plain version of bloom_build_words: hash_words from scratch, blocked
    word and mask per valid row, OR (leon_tpu/parallel/mesh.py:33-49 sets
    the same (word, bit) pairs by sort-dedup-scatter)."""
    _check_build_words_args(words, valid, n_alloc, n_words, H, k)
    w = words[valid].to(torch.int64) & _M32
    f, r = hash_words_plain(w, k, tables(seed, k))
    wi, mask = wordmask_plain(f, r, H, n_words)
    return _or_masks(wi, mask, n_alloc)
