"""Entry points of the port's tensor-level path (counterpart of the
repo's __graft_entry__.py).

entry(device)  -> (fn, example_args): the walk-encode step (kernel K15,
                  walk.encode_batch) on a toy batch against a Bloom bitset
                  built from its first k-mers (kernel K13 scan, host
                  build_np), the same batch, bitset and step as
                  __graft_entry__.entry().
dryrun(devices) -> the tensor path of __graft_entry__.dryrun_multichip,
                  steps 1-3, on the port's mesh over `devices`: sharded
                  k-mer scan (K13) and count (torch.sort + K14), the
                  sharded Bloom build (K16), the sharded encode (K15).

Both run on the card unless the caller passes a CPU device.
"""

from __future__ import annotations

import numpy as np
import torch

from leon_tpu_torch import state
from leon_tpu_torch.ops import bloom, count, kmer, walk
from leon_tpu_torch.parallel import mesh as pmesh


def _toy_batch(B: int, L: int, k: int, seed: int = 7):
    """Reads of length L cut from a random 4L-base contig (a copy of
    __graft_entry__._toy_batch, the same RNG calls)."""
    rng = np.random.default_rng(seed)
    contig = rng.integers(0, 4, 4 * L, dtype=np.uint8)
    codes = np.zeros((B, L), dtype=np.uint8)
    lengths = np.full(B, L, dtype=np.int32)
    for i in range(B):
        st = int(rng.integers(0, 3 * L))
        codes[i] = contig[st : st + L]
    return codes, lengths


def _device(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
    return dev


def entry(device=None):
    """(fn, (codes, lengths, bitset)): fn(*args) is the dense walk encode
    of 1,024 reads of 128 bases at k = 31, H = 4 against a 32,768-word
    bitset of the batch's first 4,096 k-mers (every position, valid or
    not, as the reference takes them)."""
    dev = _device(device)
    k, H, seed = 31, 4, 0x1234ABCD
    B, L = 1024, 128
    n_words = 32768
    codes_np, lengths_np = _toy_batch(B, L, k)
    codes = state.codes_to_torch(codes_np, dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    canon, _, _ = kmer.kmer_scan_words(codes, lengths, k)
    words = canon.reshape(-1, kmer.words_for_k(k))[: 4 * B].cpu().numpy().view(np.uint32)
    bitset = state.bitset_to_torch(bloom.build_np(words, n_words, H, seed, k), dev)

    def fn(codes, lengths, bitset):
        return walk.encode_batch(codes, lengths, bitset, k, H, n_words, seed)

    return fn, (codes, lengths, bitset)


def dryrun(devices):
    """__graft_entry__.dryrun_multichip's steps 1-3 on the mesh over
    `devices` (k = 15, H = 4, L = 48, B = max(2n, 8) rounded up to a
    multiple of n): returns ((uniq, counts), bitset replicas, enc)."""
    m = pmesh.make_mesh(devices=devices)
    n = m.size
    k, H, seed = 15, 4, 0x1234ABCD
    B = max(2 * n, 8)
    B += (-B) % n
    L = 48
    codes, lengths = _toy_batch(B, L, k)

    # 1. lane-sharded k-mer scan, then the exact count
    canon, _, valid = pmesh.make_sharded_counter(m, k)(codes, lengths)
    uniq, counts = count.count_batch(canon, valid)
    solid = uniq[counts >= 2]

    # 2. the sharded Bloom build, replicated
    n_words = 2048
    bitset = pmesh.sharded_bloom_build(m, solid, n_words, H, seed, k)

    # 3. the lane-sharded encode against the replicas
    enc = pmesh.make_sharded_encoder(m, k, H, n_words, seed)(codes, lengths, bitset)
    if tuple(enc["anchored"].shape) != (B,):
        raise AssertionError(f"dryrun: anchored has shape {tuple(enc['anchored'].shape)}")
    return (uniq, counts), bitset, enc
