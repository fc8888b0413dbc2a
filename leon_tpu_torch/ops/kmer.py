"""2-bit k-mer machinery of the port (counterpart of leon_tpu/ops/kmer.py).

Device half (new): ``kmer_scan``, the wrapper of kernel K1
(csrc/kmer.cu), and ``kmer_scan_plain``, its plain PyTorch version. For
k <= 31 a canonical k-mer is ONE int64 key ``w1 << 32 | w0`` of the
reference's little-endian u32 words (FORMAT.md §3); keys stay below 2**62,
so their signed order equals the reference's MSW-first u32 lexicographic
order (leon_tpu/ops/count.py:204) and ``SENTINEL`` (INT64_MAX) sorts last.

Host half: a copy of the numpy helpers the port calls,
leon_tpu/ops/kmer.py:26-33, 79-93, 153-157 and 199-277, kept here because
that module imports jax when it loads.
It must stay identical in behaviour (tests/test_torch_kmer.py).
"""

from __future__ import annotations

import numpy as np
import torch

from leon_tpu_torch import kernels

SENTINEL = torch.iinfo(torch.int64).max
MAX_K = 31  # one int64 key per k-mer


def words_for_k(k: int) -> int:
    return (k + 15) // 16


def top_mask(k: int) -> int:
    """Mask for the most-significant word of a 2k-bit value in W words."""
    bits = 2 * k - 32 * ((2 * k - 1) // 32)
    return (1 << bits) - 1 if bits < 32 else 0xFFFFFFFF


def pack_codes_np(codes: np.ndarray) -> np.ndarray:
    """(B, L) u8 base codes -> (B, ceil(L/16)) u32, base j in bits 2j..2j+1
    of word j//16."""
    B, L = codes.shape
    pad = (-L) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros((B, pad), np.uint8)], axis=1)
    c = np.ascontiguousarray(codes)
    b = c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    return np.ascontiguousarray(b).view("<u4")


# ---------------------------------------------------------------------------
# Device half: kernel K1 and its plain version
# ---------------------------------------------------------------------------


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32-stored u32 values -> int64 in [0, 2**32)."""
    return t.to(torch.int64) & 0xFFFFFFFF


def unpack_codes(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, ceil(L/16)) int32 packed codes -> (B, L) int64 base codes."""
    B = packed.shape[0]
    sh = 2 * torch.arange(16, dtype=torch.int64, device=packed.device)
    c = (_u32(packed)[:, :, None] >> sh) & 3
    return c.reshape(B, -1)[:, :L]


def _check_scan_args(packed, lengths, k: int, L: int) -> int:
    kernels.need(1 <= k <= MAX_K, f"kmer_scan: k={k} > {MAX_K} needs multiword keys")
    kernels.need(packed.dtype == torch.int32 and packed.dim() == 2,
                 "kmer_scan: packed must be (B, ceil(L/16)) int32")
    kernels.need(packed.shape[1] == (L + 15) // 16, "kmer_scan: packed width != ceil(L/16)")
    kernels.need(lengths.dtype == torch.int32 and lengths.shape == (packed.shape[0],),
                 "kmer_scan: lengths must be (B,) int32")
    kernels.need(lengths.device == packed.device, "kmer_scan: tensors on two devices")
    P = L - k + 1
    kernels.need(P >= 1, f"kmer_scan: batch width {L} < k {k}")
    return P


def kmer_scan(packed: torch.Tensor, lengths: torch.Tensor, k: int, L: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Canonical keys of every k-mer of a packed read batch.

    packed: (B, ceil(L/16)) int32 (kmer.pack_codes_np bits), lengths: (B,)
    int32. Returns (B*P,) int64, P = L-k+1, row-major (read*P + p): the
    canonical key of bases [p, p+k) where p <= len-k, SENTINEL elsewhere.
    `out`, when given, is the (B*P,) int64 destination (a view into the
    count slab). Counterpart of leon_tpu kmer.kmer_scan_packed."""
    P = _check_scan_args(packed, lengths, k, L)
    B = packed.shape[0]
    if out is not None:
        kernels.need(out.dtype == torch.int64 and out.shape == (B * P,)
                     and out.is_contiguous() and out.device == packed.device,
                     "kmer_scan: out must be a contiguous (B*P,) int64 on the input device")
    if not kernels.on_cuda(packed, "kmer_scan"):
        res = kmer_scan_plain(packed, lengths, k, L)
        if out is None:
            return res
        out.copy_(res)
        return out
    packed = packed.contiguous()
    lengths = lengths.contiguous()
    if out is None:
        out = torch.empty(B * P, dtype=torch.int64, device=packed.device)
    if B:
        rc = kernels.lib().lt_kmer_scan(
            packed.data_ptr(), lengths.data_ptr(), B, packed.shape[1], L, k, P,
            out.data_ptr(), kernels.stream(packed))
        kernels.check(rc, "kmer_scan")
        kernels.launches["kmer_scan"] += 1
    return out


def kmer_scan_plain(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                    L: int) -> torch.Tensor:
    """Plain PyTorch version of kmer_scan: the reference's column scan
    (leon_tpu/ops/kmer.py:104-126) with the k-mer as one int64."""
    P = _check_scan_args(packed, lengths, k, L)
    codes = unpack_codes(packed, L)
    B = codes.shape[0]
    mask = (1 << (2 * k)) - 1
    fwd = torch.zeros(B, dtype=torch.int64, device=packed.device)
    rc = torch.zeros_like(fwd)
    canon = torch.empty(B, P, dtype=torch.int64, device=packed.device)
    for j in range(L):
        b = codes[:, j]
        fwd = ((fwd << 2) | b) & mask
        rc = (rc >> 2) | ((3 - b) << (2 * (k - 1)))
        if j >= k - 1:
            canon[:, j - k + 1] = torch.minimum(fwd, rc)
    pos = torch.arange(P, device=packed.device)[None, :]
    valid = pos <= (lengths.to(torch.int64)[:, None] - k)
    return torch.where(valid, canon, torch.full_like(canon, SENTINEL)).reshape(-1)


# ---------------------------------------------------------------------------
# Host half: copy of leon_tpu/ops/kmer.py:153-157, 199-277
# ---------------------------------------------------------------------------

_CODE = np.full(256, 255, dtype=np.uint8)
_CODE[ord("A")] = 0
_CODE[ord("C")] = 1
_CODE[ord("G")] = 2
_CODE[ord("T")] = 3


def pack_codes_batch_np(win: np.ndarray, k: int) -> np.ndarray:
    """(B, k) base codes -> (B, W) u32 words (LSW first)."""
    W = words_for_k(k)
    rev = np.ascontiguousarray(win[:, ::-1], dtype=np.uint8)
    pad = (-k) % 4
    if pad:
        rev = np.pad(rev, ((0, 0), (0, pad)))
    b = rev[:, 0::4] | (rev[:, 1::4] << 2) | (rev[:, 2::4] << 4) | (rev[:, 3::4] << 6)
    bpad = 4 * W - b.shape[1]
    if bpad:
        b = np.pad(b, ((0, 0), (0, bpad)))
    return np.ascontiguousarray(b).view("<u4")


def words_to_codes_batch_np(words: np.ndarray, k: int) -> np.ndarray:
    """(B, W) u32 -> (B, k) uint8 base codes (vectorized inverse)."""
    B = words.shape[0]
    out = np.empty((B, k), dtype=np.uint8)
    for i in range(k):
        t = 2 * (k - 1 - i)
        out[:, i] = (words[:, t // 32] >> np.uint32(t % 32)) & 3
    return out


def revcomp_words_batch_np(words: np.ndarray, k: int) -> np.ndarray:
    codes = words_to_codes_batch_np(words, k)
    return pack_codes_batch_np((3 - codes)[:, ::-1], k)


def kmer_words_batch_np(codes: np.ndarray, pos: np.ndarray, k: int):
    """Canonical k-mer at `pos` per read: (canon (B, W) u32, is_rc (B,))."""
    B, L = codes.shape
    W = words_for_k(k)
    idx = np.clip(pos[:, None] + np.arange(k)[None, :], 0, L - 1)
    win = np.take_along_axis(codes, idx, axis=1)  # (B, k)
    fwd = pack_codes_batch_np(win, k)
    rc = pack_codes_batch_np((3 - win)[:, ::-1], k)
    less = np.zeros(B, dtype=bool)
    eq = np.ones(B, dtype=bool)
    for j in range(W - 1, -1, -1):
        less |= eq & (rc[:, j] < fwd[:, j])
        eq &= rc[:, j] == fwd[:, j]
    canon = np.where(less[:, None], rc, fwd)
    return canon, less


def pack_2bit_np(codes: np.ndarray) -> bytes:
    """2-bit pack a code vector, byte aligned (FORMAT.md stream 9)."""
    n = codes.shape[0]
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).astype(np.uint8).tobytes()


def unpack_2bit_np(buf: bytes, n: int) -> np.ndarray:
    b = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((b.size, 4), dtype=np.uint8)
    out[:, 0] = b & 3
    out[:, 1] = (b >> 2) & 3
    out[:, 2] = (b >> 4) & 3
    out[:, 3] = (b >> 6) & 3
    return out.reshape(-1)[:n]
