"""Lane-sharded k-mer scan and walk encode, and the sharded Bloom build,
over a list of devices in one process (counterpart of
leon_tpu/parallel/mesh.py).

A ``Mesh`` is an ordered list of torch devices, one per shard; a device may
repeat (eight CPU shards for the tests, as the reference's tests get eight
virtual JAX devices; four shards on one card). Shard i takes the i-th
contiguous block of lanes or rows, as JAX's ``P("d")`` sharding does, and
results come back concatenated in lane order on the first device.

- ``sharded_bloom_build``: each shard builds its blocked Bloom partial
  with kernel K16 (``bloom.bloom_build_words``) into ``aw_pad = ceil(aw/n)
  * n`` words (aw = ``bloom.alloc_words(n_words)``); the word ranges are
  exchanged by device-to-device copies (shard d receives every shard's
  d-th range and ORs them, the reference's all_to_all + local OR), then
  the merged ranges are gathered onto every shard. Returns one replica per
  shard, each (aw,) int32, the words past n_words zero.
- ``make_sharded_counter`` / ``make_sharded_encoder``: kernel K13
  (``kmer.kmer_scan_words``) and kernel K15 (``walk.encode_batch``) per
  shard; the lane count must split evenly (it raises otherwise, as JAX's
  sharding does).

The same layout shards the main path: pipeline.py's placer splits each
chunk's lanes over the mesh's devices inside compress and decompress.
Work across processes is parallel/distributed.py's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from leon_tpu_torch import state
from leon_tpu_torch.ops import bloom, kmer, walk


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices, one per shard (repeats allowed)."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """The mesh over `devices` (a list of torch devices or names), or over
    the first n_devices visible CUDA devices (all of them by default)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass devices=[...]")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices)


def _split(mesh: Mesh, n: int, what: str) -> int:
    if n % mesh.size:
        raise ValueError(f"{what}: {n} lanes do not split evenly over {mesh.size} shards")
    return n // mesh.size


def sharded_bloom_build(mesh: Mesh, solid_words, n_words: int, H: int, seed: int,
                        k: int) -> list:
    """The replicated blocked Bloom bitset of (S, W) solid k-mer words
    (numpy u32 or an int32 tensor), built shard by shard (module
    docstring). Returns one (alloc_words(n_words),) int32 replica per
    shard, on that shard's device."""
    kmer.need_words_k(k, "sharded_bloom_build")
    if n_words > bloom.MAX_WORDS:
        raise ValueError(f"n_words {n_words} > {bloom.MAX_WORDS}")
    n = mesh.size
    aw = bloom.alloc_words(n_words)
    aw_pad = -(-aw // n) * n
    src = solid_words.device if isinstance(solid_words, torch.Tensor) else torch.device("cpu")
    words = state.words_to_torch(solid_words, src)
    S, W = words.shape
    pad = (-S) % n
    words = torch.cat([words, torch.zeros(pad, W, dtype=torch.int32, device=src)])
    valid = torch.arange(S + pad, device=src) < S
    per = (S + pad) // n
    parts = [bloom.bloom_build_words(words[i * per:(i + 1) * per].to(d),
                                     valid[i * per:(i + 1) * per].to(d), aw_pad, n_words, H,
                                     seed, k).reshape(n, aw_pad // n)
             for i, d in enumerate(mesh.devices)]
    merged = []
    for d, dev in enumerate(mesh.devices):  # shard d owns word range d
        acc = parts[d][d].clone()
        for j in range(n):
            if j != d:
                acc |= parts[j][d].to(dev)
        merged.append(acc)
    return [torch.cat([m.to(dev) for m in merged])[:aw] for dev in mesh.devices]


def _shards(mesh: Mesh, codes, lengths, what: str):
    """Shard i's contiguous block of lanes, on its device; numpy inputs
    start on the host."""
    if not isinstance(codes, torch.Tensor):
        codes = state.codes_to_torch(codes, "cpu")
    if not isinstance(lengths, torch.Tensor):
        lengths = torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32))
    per = _split(mesh, codes.shape[0], what)
    return [(codes[i * per:(i + 1) * per].to(d), lengths[i * per:(i + 1) * per].to(d))
            for i, d in enumerate(mesh.devices)]


def make_sharded_counter(mesh: Mesh, k: int):
    """fn(codes (B, L), lengths (B,)) -> (canon (B, P, W) int32, is_rc, valid)
    with the lanes sharded over the mesh (K13 per shard)."""

    def step(codes, lengths):
        outs = [kmer.kmer_scan_words(c, ln, k)
                for c, ln in _shards(mesh, codes, lengths, "sharded counter")]
        first = mesh.devices[0]
        return tuple(torch.cat([o[i].to(first) for o in outs]) for i in range(3))

    return step


def make_sharded_encoder(mesh: Mesh, k: int, H: int, n_words: int, seed: int):
    """fn(codes (B, L), lengths (B,), bitset) -> encode_batch's dense dict
    with the lanes sharded over the mesh (K15 per shard). bitset: one
    int32 tensor, or one replica per shard (sharded_bloom_build's)."""

    def step(codes, lengths, bitset):
        shards = _shards(mesh, codes, lengths, "sharded encoder")
        reps = bitset if isinstance(bitset, (list, tuple)) else [bitset] * mesh.size
        outs = [walk.encode_batch(c, ln, reps[i].to(c.device), k, H, n_words, seed)
                for i, (c, ln) in enumerate(shards)]
        first = mesh.devices[0]
        return {n: torch.cat([o[n].to(first) for o in outs]) for n in outs[0]}

    return step
