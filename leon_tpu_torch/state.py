"""Conversions between the reference's state (numpy arrays, as leon_tpu
keeps them) and the port's tensors.

- Bloom bitset: (n,) u32 numpy <-> (n,) int32 tensor holding the same bits;
  a reference graph.DBG's state -> the port's DBG (dbg_from_reference).
- k-mer words: (N, W) u32 numpy or a tensor of u32 values -> (N, W) int32
  tensor holding the same bits (words_to_torch).
- Distinct-run words: (M, W) u32 LSW-first (W <= 2) <-> (M,) int64 keys
  ``w1 << 32 | w0`` (k <= 31); (M, W) words <-> the ceil(W/2) sign-flipped
  int64 planes the multiword route sorts (words_to_planes, planes_to_words).
- Packed read codes (kmer.pack_codes_np): (B, L16) u32 <-> int32 tensor;
  unpacked codes (B, L) u8 -> uint8 tensor (codes_to_torch).
- A dense encode_batch dict of tensors -> numpy arrays (dense_from_torch).
- The reference's padded device run -> the port's key run
  (run_from_reference).
"""

from __future__ import annotations

import numpy as np
import torch


def bitset_to_torch(bitset: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(bitset, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def bitset_from_torch(bitset: torch.Tensor) -> np.ndarray:
    return bitset.cpu().numpy().view(np.uint32)


def dbg_from_reference(bitset_np: np.ndarray, k: int, n_hashes: int, n_words: int,
                       seed: int, device):
    """The port's graph.DBG over the reference's classic bitset (the state
    of a leon_tpu.graph.DBG), so that both packages probe the same bits."""
    from leon_tpu_torch.graph import DBG

    return DBG(bitset=bitset_to_torch(np.asarray(bitset_np), device), k=k,
               n_hashes=n_hashes, n_words=n_words, seed=seed)


def words_to_torch(words, device) -> torch.Tensor:
    """(N, W) u32 k-mer words -> (N, W) int32 tensor (the same bits) on
    device. words: numpy (any integer dtype holding u32 values), or a
    torch int32 (taken as u32 bits), uint32 or int64 tensor."""
    if isinstance(words, torch.Tensor):
        if words.dtype == torch.uint32:
            words = words.view(torch.int32)
        elif words.dtype != torch.int32:
            from leon_tpu_torch.ops.kmer import i32_bits

            words = i32_bits(words.to(torch.int64) & 0xFFFFFFFF)
        return words.to(device)
    a = np.ascontiguousarray(np.asarray(words).astype(np.uint32, copy=False)).view(np.int32)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def codes_to_torch(codes, device) -> torch.Tensor:
    """(B, L) base codes (numpy or a tensor) -> (B, L) uint8 tensor on
    device, the input of kmer_scan_words and encode_batch."""
    if isinstance(codes, torch.Tensor):
        return codes.to(device=device, dtype=torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8)).to(device)


def dense_from_torch(enc: dict) -> dict:
    """A dense encode_batch dict of tensors -> numpy arrays with the
    reference's dtypes (bool, int32, uint8), key by key."""
    return {n: v.cpu().numpy() for n, v in enc.items()}


def packed_to_torch(packed: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def words_to_keys(words: np.ndarray) -> np.ndarray:
    """(M, W) u32 LSW-first -> (M,) int64 keys (W <= 2)."""
    W = words.shape[1]
    if W > 2:
        raise ValueError(f"{W}-word k-mers do not fit one int64 key")
    keys = words[:, 0].astype(np.int64)
    if W == 2:
        keys |= words[:, 1].astype(np.int64) << 32
    return keys


def keys_to_words(keys: np.ndarray, W: int) -> np.ndarray:
    """(M,) int64 keys -> (M, W) u32 LSW-first (W <= 2)."""
    if W > 2:
        raise ValueError(f"{W}-word k-mers do not fit one int64 key")
    k = np.asarray(keys, dtype=np.int64)
    out = np.empty((k.shape[0], W), dtype=np.uint32)
    out[:, 0] = (k & 0xFFFFFFFF).astype(np.uint32)
    if W == 2:
        out[:, 1] = (k >> 32).astype(np.uint32)
    return out


def keys_from_torch(keys: torch.Tensor, W: int) -> np.ndarray:
    return keys_to_words(keys.cpu().numpy(), W)


_SIGN = -(1 << 63)  # int64 sign bit: x ^ _SIGN maps u64 order onto signed order
_M32 = 0xFFFFFFFF


def n_planes(W: int) -> int:
    """int64 planes of a W-word k-mer: P = ceil(W/2)."""
    return (W + 1) // 2


def words_to_planes(words: torch.Tensor) -> tuple:
    """(M, W) u32 k-mer words (int32 bits, or u32 values in int64) -> the
    P = ceil(W/2) sign-flipped int64 planes, least significant first:
    plane q = (w[2q+1] << 32 | w[2q]) ^ sign (w[W] = 0). Signed order of
    (plane P-1, ..., plane 0) is the reference's MSW-first u32 order
    (count.sort_words' keys); at W <= 4 the planes are (lo,) or (lo, hi)."""
    W = words.shape[1]
    u = words.to(torch.int64) & _M32
    return tuple((u[:, 2 * q] | (u[:, 2 * q + 1] << 32 if 2 * q + 1 < W else 0)) ^ _SIGN
                 for q in range(n_planes(W)))


def planes_to_words(planes, W: int) -> torch.Tensor:
    """Inverse of words_to_planes: (M, W) int32 holding the u32 words."""
    from leon_tpu_torch.ops.kmer import i32_bits

    words = []
    for h in planes:
        h = h ^ _SIGN
        words += [h & _M32, (h >> 32) & _M32]
    return i32_bits(torch.stack(words[:W], dim=1))


def run_from_reference(words_pad: np.ndarray, counts_pad: np.ndarray, k: int | None = None):
    """The reference's padded sorted distinct run ((Mcap, W) u32 words,
    (Mcap,) i32 counts; pad rows all 0xFFFFFFFF with count 0, sorted last)
    -> the port's CPU tensors with the pads dropped: (keys (M,) int64,
    counts (M,) int32), or for k > 31 (the multiword route, W = 2..16)
    (words (M, W) int32 holding the u32 words, counts). A pad would convert
    to key -1, which sorts FIRST in the port's signed order; no canonical
    k-mer has all-ones words (the top word is masked below 32 bits, and at
    k = 16W all-T is not canonical)."""
    words = np.asarray(words_pad, dtype=np.uint32)
    counts = np.asarray(counts_pad, dtype=np.int32)
    real = ~(words == 0xFFFFFFFF).all(axis=1)
    if (counts[~real] != 0).any():
        raise ValueError("pad rows (all-ones words) must have count 0")
    cnt = torch.from_numpy(np.ascontiguousarray(counts[real]))
    if k is not None and k > 31:
        return words_to_torch(words[real], "cpu"), cnt
    return torch.from_numpy(words_to_keys(words[real])), cnt
