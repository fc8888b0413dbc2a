"""Conversions between the reference's state (numpy arrays, as leon_tpu
keeps them) and the port's tensors.

- Bloom bitset: (n,) u32 numpy <-> (n,) int32 tensor holding the same bits.
- Distinct-run words: (M, W) u32 LSW-first (W <= 2) <-> (M,) int64 keys
  ``w1 << 32 | w0``.
- Packed read codes (kmer.pack_codes_np): (B, L16) u32 <-> int32 tensor.
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
