"""2-bit k-mer machinery of the port (counterpart of leon_tpu/ops/kmer.py).

Device half (new): ``kmer_scan``, the wrapper of kernel K1
(csrc/kmer.cu), and ``kmer_scan_plain``, its plain PyTorch version;
``kmer_scan_words``, the wrapper of kernel K13 (the unpacked scan to
(B, P, W) u32 words, k <= 255, counterpart of kmer.kmer_scan: each k-mer
cut from the codes, the reference's roll where a code byte above 3
reaches), and ``kmer_scan_words_plain``; ``kmer_scan_halves``, the wrapper of kernel
K17 (the main path's scan for 32 <= k <= 255: the valid positions only,
compacted, as the ceil(W/2) sign-flipped int64 planes the counter sorts), and
``kmer_scan_halves_plain``; ``shl2``, ``shr2_ins``, ``lex_less`` and
``canonical`` on (..., W) words. For
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
_M32 = 0xFFFFFFFF


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


def shl2(words: torch.Tensor, base, k: int) -> torch.Tensor:
    """(kmer << 2 | base) with the top word masked to 2k bits
    (leon_tpu/ops/kmer.py:36-45). words: (..., W) u32 values in int64;
    base: an int or a (...) int64 tensor. Plain PyTorch: the kernels of
    graph.cu carry their own copy."""
    W = words.shape[-1]
    parts = [((words[..., 0] << 2) | base) & 0xFFFFFFFF]
    for j in range(1, W):
        parts.append(((words[..., j] << 2) | (words[..., j - 1] >> 30)) & 0xFFFFFFFF)
    parts[W - 1] = parts[W - 1] & top_mask(k)
    return torch.stack(parts, dim=-1)


def shr2_ins(words: torch.Tensor, base, k: int) -> torch.Tensor:
    """(kmer >> 2) | (base << 2(k-1)), unmasked (leon_tpu/ops/kmer.py:48-58)."""
    W = words.shape[-1]
    parts = [((words[..., j] >> 2) | (words[..., j + 1] << 30)) & 0xFFFFFFFF
             for j in range(W - 1)]
    parts.append(words[..., W - 1] >> 2)
    t = 2 * (k - 1)
    parts[t // 32] = parts[t // 32] | (base << (t % 32))
    return torch.stack(parts, dim=-1)


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
# Device half: kernel K13 (multiword scan, k <= 255) and its plain version
# ---------------------------------------------------------------------------

MAX_K_WORDS = 255  # every W-word kernel (K10-K19): W = ceil(k/16) <= 16
MIN_K_WIDE = 17  # W >= 2: the multiword route's kernels K17-K19 have no W = 1 instance


def need_words_k(k: int, what: str) -> None:
    """A W-word kernel takes 1 <= k <= 255 (W <= 16)."""
    kernels.need(1 <= k <= MAX_K_WORDS, f"{what}: k={k} not in [1, {MAX_K_WORDS}]")


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b comparing (..., W) words as big integers, word 0 least
    significant (leon_tpu/ops/kmer.py:61-69)."""
    W = a.shape[-1]
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(less)
    for j in range(W - 1, -1, -1):
        less = less | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return less


def canonical(fwd: torch.Tensor, rc: torch.Tensor):
    """(canon, is_rc); palindromes keep the forward strand
    (leon_tpu/ops/kmer.py:72-76)."""
    take_rc = lex_less(rc, fwd)
    return torch.where(take_rc[..., None], rc, fwd), take_rc


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _check_scan_words_args(codes, lengths, k: int) -> int:
    need_words_k(k, "kmer_scan_words")
    kernels.need(codes.dtype == torch.uint8 and codes.dim() == 2,
                 "kmer_scan_words: codes must be (B, L) uint8")
    kernels.need(lengths.dtype == torch.int32 and lengths.shape == (codes.shape[0],),
                 "kmer_scan_words: lengths must be (B,) int32")
    kernels.need(lengths.device == codes.device, "kmer_scan_words: tensors on two devices")
    P = codes.shape[1] - k + 1
    kernels.need(P >= 1, f"kmer_scan_words: batch width {codes.shape[1]} < k {k}")
    return P


def kmer_scan_words(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Every k-mer of a read batch as canonical u32 words (k <= 255).

    codes: (B, L) uint8 base codes, lengths: (B,) int32. Returns (canon
    (B, P, W) int32 holding the u32 words LSW first, is_rc (B, P) bool,
    valid (B, P) bool), P = L - k + 1, position p covering bases [p, p+k):
    every position, valid or not, as the reference's scan of all L
    columns. Counterpart of leon_tpu kmer.kmer_scan (kernel K13)."""
    P = _check_scan_words_args(codes, lengths, k)
    if not kernels.on_cuda(codes, "kmer_scan_words"):
        return _scan_words_plain(codes, lengths, k)
    codes, lengths = codes.contiguous(), lengths.contiguous()
    B, L = codes.shape
    dev = codes.device
    canon = torch.empty(B, P, words_for_k(k), dtype=torch.int32, device=dev)
    is_rc = torch.empty(B, P, dtype=torch.bool, device=dev)
    valid = torch.empty(B, P, dtype=torch.bool, device=dev)
    if B:
        rc = kernels.lib().lt_kmer_scan_words(
            codes.data_ptr(), lengths.data_ptr(), B, L, k, P, top_mask(k), canon.data_ptr(),
            is_rc.data_ptr(), valid.data_ptr(), kernels.stream(codes))
        kernels.check(rc, "kmer_scan_words")
        kernels.launches["kmer_scan_words"] += 1
    return canon, is_rc, valid


def kmer_scan_words_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Plain version of kmer_scan_words: the reference's column scan
    (leon_tpu/ops/kmer.py:104-126) over (B, W) words held in int64, with
    its u32 arithmetic (the same words for any code byte)."""
    _check_scan_words_args(codes, lengths, k)
    return _scan_words_plain(codes, lengths, k)


def _scan_words_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """kmer_scan_words_plain without the argument checks (K17's plain
    version runs it too)."""
    B, L = codes.shape
    P = L - k + 1
    W = words_for_k(k)
    c = codes.to(torch.int64)
    fwd = torch.zeros(B, W, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    fwds, rcs = [], []
    for j in range(L):
        b = c[:, j]
        fwd = shl2(fwd, b, k)
        rc = shr2_ins(rc, (3 - b) & _M32, k) & _M32
        if j >= k - 1:
            fwds.append(fwd)
            rcs.append(rc)
    canon, is_rc = canonical(torch.stack(fwds, dim=1), torch.stack(rcs, dim=1))
    pos = torch.arange(P, device=codes.device)[None, :]
    valid = pos <= (lengths.to(torch.int64)[:, None] - k)
    return i32_bits(canon), is_rc, valid


# ---------------------------------------------------------------------------
# Device half: kernel K17 (the compacted multiword scan) and its plain version
# ---------------------------------------------------------------------------


def _check_scan_halves_args(packed, lengths, k: int, L: int, out) -> int:
    kernels.need(MIN_K_WIDE <= k <= MAX_K_WORDS,
                 f"kmer_scan_halves: k={k} not in [{MIN_K_WIDE}, {MAX_K_WORDS}]")
    kernels.need(packed.dtype == torch.int32 and packed.dim() == 2
                 and packed.shape[1] == (L + 15) // 16,
                 "kmer_scan_halves: packed must be (B, ceil(L/16)) int32")
    kernels.need(lengths.dtype == torch.int32 and lengths.shape == (packed.shape[0],),
                 "kmer_scan_halves: lengths must be (B,) int32")
    kernels.need(lengths.device == packed.device, "kmer_scan_halves: tensors on two devices")
    P = L - k + 1
    kernels.need(P >= 1, f"kmer_scan_halves: batch width {L} < k {k}")
    if out is not None:
        kernels.need(len(out) == (words_for_k(k) + 1) // 2,
                     "kmer_scan_halves: out must hold ceil(W/2) planes")
        for h in out:
            kernels.need(h.dtype == torch.int64 and h.dim() == 1 and h.is_contiguous()
                         and h.device == packed.device and h.shape[0] == out[0].shape[0],
                         "kmer_scan_halves: out planes must be contiguous (n,) int64 on the "
                         "input device")
    return P


def kmer_scan_halves(packed: torch.Tensor, lengths: torch.Tensor, k: int, L: int,
                     out: tuple | None = None) -> tuple:
    """Canonical k-mers of the valid positions of a packed read batch
    (17 <= k <= 255), read-major (read r's position p at offs[r] + p), as the
    P = ceil(W/2) sign-flipped int64 planes the WordCounter sorts (state.
    words_to_planes; plane 0 least significant), n rows each. Invalid
    positions are dropped, not marked.

    packed: (B, ceil(L/16)) int32 (kmer.pack_codes_np bits), lengths: (B,)
    int32. `out`, when given, is a tuple of P buffers with at least n rows
    (views into the counter's slab); the result is their first n rows.
    Counterpart of leon_tpu kmer.kmer_scan_packed with its valid mask
    applied (kernel K17)."""
    P = _check_scan_halves_args(packed, lengths, k, L, out)
    nv = torch.clamp(lengths.to(torch.int64) - (k - 1), 0, P)
    n = int(nv.sum())
    if out is not None:
        kernels.need(out[0].shape[0] >= n, f"kmer_scan_halves: out holds < {n} rows")
        out = tuple(h[:n] for h in out)
    if not kernels.on_cuda(packed, "kmer_scan_halves"):
        res = kmer_scan_halves_plain(packed, lengths, k, L)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    packed, lengths = packed.contiguous(), lengths.contiguous()
    dev = packed.device
    if out is None:
        out = tuple(torch.empty(n, dtype=torch.int64, device=dev)
                    for _ in range((words_for_k(k) + 1) // 2))
    if n:
        scan_halves_launch(packed, lengths, torch.cumsum(nv, 0) - nv, k, L, out)
    return out


def scan_halves_launch(packed, lengths, offs, k: int, L: int, out: tuple) -> None:
    """K17's launch alone, after kmer_scan_halves' checks and its host sync
    on the valid count: read r's valid k-mers into rows offs[r] + p of the
    contiguous CUDA planes `out` (offs: (B,) int64, the exclusive prefix of
    the reads' valid counts)."""
    ptrs = np.array([h.data_ptr() for h in out], dtype=np.uint64)
    rc = kernels.lib().lt_kmer_scan_halves(
        packed.data_ptr(), lengths.data_ptr(), offs.data_ptr(), packed.shape[0],
        packed.shape[1], L, k, L - k + 1, top_mask(k), len(out), ptrs.ctypes.data,
        kernels.stream(packed))
    kernels.check(rc, "kmer_scan_halves")
    kernels.launches["kmer_scan_halves"] += 1


def kmer_scan_halves_plain(packed: torch.Tensor, lengths: torch.Tensor, k: int, L: int) -> tuple:
    """Plain version of kmer_scan_halves: the reference's scan
    (kmer_scan_words_plain's column scan on the unpacked codes), its valid
    rows in read-major order, split into sign-flipped planes."""
    from leon_tpu_torch.state import words_to_planes

    _check_scan_halves_args(packed, lengths, k, L, None)
    codes = unpack_codes(packed, L).to(torch.uint8)
    canon, _, valid = _scan_words_plain(codes, lengths, k)
    return words_to_planes(canon.reshape(-1, canon.shape[-1])[valid.reshape(-1)])


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
