"""Conversions between the reference's state (numpy arrays, as leon_tpu
keeps them) and the port's tensors.

- Bloom bitset: (n,) u32 numpy <-> (n,) int32 tensor holding the same bits.
- Distinct-run words: (M, W) u32 LSW-first (W <= 2) <-> (M,) int64 keys
  ``w1 << 32 | w0``.
- Packed read codes (kmer.pack_codes_np): (B, L16) u32 <-> int32 tensor.
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


def run_from_reference(words_pad: np.ndarray, counts_pad: np.ndarray):
    """The reference's padded sorted distinct run ((Mcap, W) u32 words,
    (Mcap,) i32 counts; pad rows all 0xFFFFFFFF with count 0, sorted last)
    -> the port's CPU tensors (keys (M,) int64, counts (M,) int32) with
    the pads dropped. A pad would convert to key -1, which sorts FIRST in the
    port's signed order; no canonical k-mer has all-ones words (the top
    word is masked below 32 bits, and for k = 16 all-T is not canonical)."""
    words = np.asarray(words_pad, dtype=np.uint32)
    counts = np.asarray(counts_pad, dtype=np.int32)
    real = ~(words == 0xFFFFFFFF).all(axis=1)
    if (counts[~real] != 0).any():
        raise ValueError("pad rows (all-ones words) must have count 0")
    keys = words_to_keys(words[real])
    return torch.from_numpy(keys), torch.from_numpy(np.ascontiguousarray(counts[real]))
