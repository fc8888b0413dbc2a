"""Entry points of the port's tensor-level path (counterpart of the
repo's __graft_entry__.py).

entry(device)  -> (fn, example_args): the walk-encode step (kernel K15,
                  walk.encode_batch) on a toy batch against a Bloom bitset
                  built from its first k-mers (kernel K13 scan, host
                  build_np), the same batch, bitset and step as
                  __graft_entry__.entry().
dryrun(devices) -> __graft_entry__.dryrun_multichip on the port's mesh over
                  `devices`: steps 1-3, the tensor path (sharded k-mer scan
                  (K13) and count (K22 + K14), the sharded Bloom
                  build (K16), the sharded encode (K15)); steps 4-5, the
                  product path (pipeline.compress and decompress with the
                  lanes sharded over the mesh: the archive equals the
                  one-device archive, the round trip is exact, and the
                  mesh decode equals the one-device decode).

Both run on the card unless the caller passes a CPU device.
"""

from __future__ import annotations

import os
import tempfile

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
    """__graft_entry__.dryrun_multichip on the mesh over `devices`: steps 1-3
    at k = 15, H = 4, L = 48, B = max(2n, 8) rounded up to a multiple of n,
    then steps 4-5 (_dryrun_product). Raises on any mismatch; returns
    ((uniq, counts), bitset replicas, enc) of steps 1-3."""
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
    _dryrun_product(list(m.devices))
    return (uniq, counts), bitset, enc


def _dryrun_product(devices: list) -> None:
    """Steps 4-5 of __graft_entry__.dryrun_multichip (__graft_entry__.py:
    94-134, the same corpus): 96 FASTA reads of 80 bp from a random
    800-base contig, k = 15, batch_reads = 8n, compressed and decompressed
    with the lanes sharded over `devices` and on its first device alone."""
    from leon_tpu_torch import pipeline
    from leon_tpu_torch.config import LeonConfig

    n = len(devices)
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    contig = rng.integers(0, 4, 800, dtype=np.uint8)
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in.fasta")
        with open(src, "wb") as f:
            for i in range(96):
                st = int(rng.integers(0, 700))
                f.write(b">r%d\n%s\n" % (i, bases[contig[st : st + 80]].tobytes()))
        common = dict(kmer_size=15, batch_reads=8 * n, reads_per_block=64)
        cfg_mesh = LeonConfig(mesh_devices=n, **common)
        cfg_one = LeonConfig(mesh_devices=1, **common)
        a, b = os.path.join(td, "mesh.leon"), os.path.join(td, "one.leon")
        pipeline.compress(src, a, cfg=cfg_mesh, device=devices)
        pipeline.compress(src, b, cfg=cfg_one, device=devices[0])
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError("dryrun: mesh archive != single-device archive")
        d = pipeline.decompress(a, os.path.join(td, "mesh.out"), cfg=cfg_mesh,
                                device=devices)["output"]
        with open(src, "rb") as fs, open(d, "rb") as fd:
            if fs.read() != fd.read():
                raise AssertionError("dryrun: mesh round trip mismatch")
        d1 = pipeline.decompress(a, os.path.join(td, "one.out"), cfg=cfg_one,
                                 device=devices[0])["output"]
        with open(d, "rb") as fm, open(d1, "rb") as f1:
            if fm.read() != f1.read():
                raise AssertionError("dryrun: mesh decode != single-device decode")
