"""Compression across processes on torch.distributed (counterpart of
leon_tpu/parallel/distributed.py, with its names and structure).

Process-level data parallelism over container blocks:

1. every process parses only its shard: a cooperative byte-range block
   index (newline / '>' scans over each process's byte range,
   _build_block_index) lets owned blocks (bi % nproc == pid) seek and
   parse directly, with a streaming skip-scan fallback for gz, albums and
   irregular inputs;
2. each process counts its shard's k-mers on its device (K1 into
   ops/count.DeviceCounter at k <= 31, K17 into WordCounter past it) and
   compacts them to the sorted distinct (k-mer, count) run; the k-mer space
   is then sharded: fixed inverse-CDF range boundaries
   (count.range_boundaries), an all-to-all of range slices (shared
   filesystem part files, allgather fallback), a merge and histogram per
   range (the histograms summed over an allgather) and a Bloom build per
   range on the device (K3 or K16 over the range's solid rows), the
   disjoint range bitsets OR-combined: the cutoff and the filter are the
   one-process ones on every process. One process takes the reference's
   one-process path instead: ingest_run and finalize on a counter, then
   the device or host unitig build, as pipeline.compress does;
3. each process walk-encodes its blocks (pipeline._walk_chunk: K4 or K18)
   with anchor-dictionary indices deferred; the per-block first-use key
   lists are exchanged and every process replays them in global block
   order, so the dictionary, and every block payload, is the one-process
   run's (shard invariance);
4. block payloads (and, with the UNITIGS section, the solid set) gather to
   process 0, which builds the section and the DICT and writes the
   container: the one-process pipeline.compress archive, byte for byte.

Every exchange moves host bytes, as the reference's process_allgather and
sync_global_devices do: here gloo collectives on CPU tensors (the byte
allgather is chunked, lengths first) and barriers. So no card-to-card
transport is needed, and several processes may share one card (NCCL would
refuse two ranks on one device). Each process's device defaults to
cuda:(rank % device_count()); tests pass device="cpu".

Works unchanged with one process (every exchange is the identity).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
from typing import Optional

import numpy as np
import torch

from leon_tpu_torch import kernels, pipeline, state
from leon_tpu_torch.codecs import blocks as blockcodec
from leon_tpu_torch.codecs import frames
from leon_tpu_torch.config import LeonConfig
from leon_tpu_torch.io import bank, container
from leon_tpu_torch.ops import count, unitig
from leon_tpu_torch.ops import kmer as K


def initialize(init_method: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group over gloo (nothing for one
    process). init_method: "tcp://host:port" or "file:///path"; the
    environment's MASTER_ADDR / MASTER_PORT ("env://") when None."""
    if num_processes is None or num_processes <= 1:
        return
    torch.distributed.init_process_group(backend="gloo", init_method=init_method or "env://",
                                         world_size=num_processes, rank=process_id)


def _process() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# exchange traffic (surfaced in the run stats): bytes this process sent to /
# received from collectives ("dcn", the reference's name for the network
# between hosts), and bytes moved through the shared filesystem
_TRAFFIC = {"dcn_tx": 0, "dcn_rx": 0, "fs_spill": 0, "fs_exchange": 0}


def _sync(name: str) -> None:
    """Every process reaches this point (mhu.sync_global_devices(name))."""
    if _process()[1] > 1:
        torch.distributed.barrier()


def _allgather_i64(vals) -> np.ndarray:
    """(nproc, n) int64: one equal-length int64 vector from every process
    (mhu.process_allgather)."""
    arr = torch.from_numpy(np.array(vals, dtype=np.int64).reshape(-1))
    nproc = _process()[1]
    if nproc == 1:
        return arr.numpy()[None]
    out = [torch.empty_like(arr) for _ in range(nproc)]
    torch.distributed.all_gather(out, arr)
    return torch.stack(out).numpy()


def _allgather_bytes(data: bytes, chunk: int = 8 << 20) -> list[bytes]:
    """One bytes blob from every process (leon_tpu/parallel/distributed.py:
    73-105): the lengths first, then rounds of `chunk` bytes, so peak
    memory is nproc * chunk and the zero padding at most a chunk a process
    a round."""
    nproc = _process()[1]
    if nproc == 1:
        return [data]
    lens = _allgather_i64([len(data)])[:, 0]
    _TRAFFIC["dcn_tx"] += len(data)
    _TRAFFIC["dcn_rx"] += int(lens.sum())
    mx = max(1, int(lens.max()))
    parts: list[list[bytes]] = [[] for _ in range(nproc)]
    src = np.frombuffer(data, np.uint8)
    for off in range(0, mx, chunk):
        step = min(chunk, mx - off)
        buf = np.zeros(step, np.uint8)
        take = max(0, min(len(data) - off, step))
        if take:
            buf[:take] = src[off : off + take]
        out = [torch.empty(step, dtype=torch.uint8) for _ in range(nproc)]
        torch.distributed.all_gather(out, torch.from_numpy(buf))
        for p in range(nproc):
            want = max(0, min(int(lens[p]) - off, step))
            if want:
                parts[p].append(out[p][:want].numpy().tobytes())
    return [b"".join(parts[p]) for p in range(nproc)]


def _write_part(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _gather_payloads_to_zero(my_blob: bytes, output_path: str, pid: int,
                             nproc: int) -> Optional[list[bytes]]:
    """Each process's packed payload blob, on process 0 (distributed.py:
    108-154): through `<output>.part<pid>` files where process 0 sees them
    all (a shared filesystem: no collective carries the archive body), else
    the chunked allgather. Returns the blobs on process 0, None elsewhere."""
    if nproc == 1:
        return [my_blob]
    part = f"{output_path}.part{pid}"
    _write_part(part, my_blob)
    _TRAFFIC["fs_spill"] += len(my_blob)
    _sync("leon.parts.written")
    visible = all(os.path.exists(f"{output_path}.part{p}")
                  for p in range(nproc)) if pid == 0 else True
    flags = _allgather_i64([1 if visible else 0])[:, 0]
    out: Optional[list[bytes]] = None
    if flags[0]:  # process 0's view decides for everyone
        if pid == 0:
            out = []
            for p in range(nproc):
                with open(f"{output_path}.part{p}", "rb") as f:
                    out.append(f.read())
        _sync("leon.parts.read")
    else:
        gathered = _allgather_bytes(my_blob)  # every process takes part
        out = gathered if pid == 0 else None
    _remove(part)
    return out


# --- raw (pickle-free) framings of the exchanges (distributed.py:159-217) ---


def _pack_run(uniq: np.ndarray, counts: np.ndarray) -> bytes:
    """Distinct count run: u64 M, u32 W, uniq (M, W) '<u4', counts '<i4'."""
    M, W = uniq.shape
    return (struct.pack("<QI", M, W)
            + np.ascontiguousarray(uniq.astype("<u4")).tobytes()
            + counts.astype("<i4").tobytes())


def _unpack_run(blob: bytes) -> tuple[np.ndarray, np.ndarray]:
    M, W = struct.unpack_from("<QI", blob, 0)
    o = 12
    uniq = np.frombuffer(blob, "<u4", M * W, o).reshape(M, W)
    counts = np.frombuffer(blob, "<i4", M, o + 4 * M * W)
    return uniq, counts


def _pack_keylists(lists: dict[int, list[bytes]], key_sz: int) -> bytes:
    """Per-block first-use key lists: u32 nblocks, then per block u32 bi,
    u32 nkeys, nkeys * key_sz raw bytes."""
    out = [struct.pack("<I", len(lists))]
    for bi, keys in lists.items():
        out.append(struct.pack("<II", bi, len(keys)))
        out.extend(keys)
    return b"".join(out)


def _unpack_keylists(blob: bytes, key_sz: int) -> dict[int, list[bytes]]:
    (nb,) = struct.unpack_from("<I", blob, 0)
    o = 4
    out: dict[int, list[bytes]] = {}
    for _ in range(nb):
        bi, nk = struct.unpack_from("<II", blob, o)
        o += 8
        out[bi] = [blob[o + i * key_sz : o + (i + 1) * key_sz] for i in range(nk)]
        o += nk * key_sz
    return out


def _pack_payloads(payloads: dict[int, tuple[bytes, int]]) -> bytes:
    """Block payloads: u32 nblocks, then per block u32 bi, u32 n_reads, u64
    len, the payload bytes."""
    out = [struct.pack("<I", len(payloads))]
    for bi, (pl, nr) in payloads.items():
        out.append(struct.pack("<IIQ", bi, nr, len(pl)))
        out.append(pl)
    return b"".join(out)


def _unpack_payloads(blob: bytes) -> dict[int, tuple[bytes, int]]:
    (nb,) = struct.unpack_from("<I", blob, 0)
    o = 4
    out: dict[int, tuple[bytes, int]] = {}
    for _ in range(nb):
        bi, nr, ln = struct.unpack_from("<IIQ", blob, o)
        o += 16
        out[bi] = (blob[o : o + ln], nr)
        o += ln
    return out


def _exchange_range_runs(uniq: np.ndarray, cnts: np.ndarray, bounds: np.ndarray,
                         offs: np.ndarray, output_path: str, pid: int, nproc: int) -> list:
    """All-to-all of the key-range slices (bounds, split at offs) of each
    process's sorted distinct run (distributed.py:219-275): through
    `<out>.runx.<src>.<dst>` part files where every process sees its
    inbound ones, else an allgather of the whole runs, sliced here. Returns
    the sorted runs of this process's range."""
    wrote = []
    for dst in range(nproc):
        if dst == pid:
            continue
        part = f"{output_path}.runx.{pid}.{dst}"
        _write_part(part, _pack_run(np.ascontiguousarray(uniq[offs[dst]:offs[dst + 1]]),
                                    np.ascontiguousarray(cnts[offs[dst]:offs[dst + 1]])))
        _TRAFFIC["fs_exchange"] += os.path.getsize(part)
        wrote.append(part)
    _sync("leon.runx.written")
    visible = all(os.path.exists(f"{output_path}.runx.{src}.{pid}")
                  for src in range(nproc) if src != pid)
    flags = _allgather_i64([1 if visible else 0])[:, 0]
    mine = [(np.ascontiguousarray(uniq[offs[pid]:offs[pid + 1]]),
             np.ascontiguousarray(cnts[offs[pid]:offs[pid + 1]]).astype(np.int64))]
    if flags.all():  # every process sees its inbound part files
        for src in range(nproc):
            if src == pid:
                continue
            with open(f"{output_path}.runx.{src}.{pid}", "rb") as f:
                u, c = _unpack_run(f.read())
            mine.append((u.copy(), c.astype(np.int64)))
        _sync("leon.runx.read")
    else:  # no shared filesystem: ship whole runs, slice locally
        for i, blob in enumerate(_allgather_bytes(_pack_run(uniq, cnts))):
            if i == pid:
                continue
            u, c = _unpack_run(blob)
            o = count.range_split(u, bounds)
            mine.append((np.ascontiguousarray(u[o[pid]:o[pid + 1]]),
                         c[o[pid]:o[pid + 1]].astype(np.int64)))
    for part in wrote:
        _remove(part)
    return mine


def _gather_solid_to_zero(solid_mine: np.ndarray, counts_mine: np.ndarray,
                          output_path: str, pid: int, nproc: int):
    """Each process's solid range rows on process 0 (distributed.py:
    278-321): range order is key order, so the concatenation is the sorted
    global solid run. Returns (solid, counts) on process 0, None
    elsewhere."""
    part = f"{output_path}.solid.{pid}"
    _write_part(part, _pack_run(solid_mine, counts_mine.astype(np.int32)))
    _TRAFFIC["fs_exchange"] += os.path.getsize(part)
    _sync("leon.solid.written")
    visible = all(os.path.exists(f"{output_path}.solid.{p}")
                  for p in range(nproc)) if pid == 0 else True
    flags = _allgather_i64([1 if visible else 0])[:, 0]
    out = None
    if flags[0]:
        if pid == 0:
            us, cs = [], []
            for p in range(nproc):
                with open(f"{output_path}.solid.{p}", "rb") as f:
                    u, c = _unpack_run(f.read())
                us.append(u.copy())
                cs.append(c.copy())
            out = (np.concatenate(us), np.concatenate(cs).astype(np.int32))
        _sync("leon.solid.read")
    else:
        blobs = _allgather_bytes(_pack_run(solid_mine, counts_mine.astype(np.int32)))
        if pid == 0:
            pairs = [_unpack_run(b) for b in blobs]
            out = (np.concatenate([p[0] for p in pairs]),
                   np.concatenate([p[1] for p in pairs]).astype(np.int32))
    _remove(part)
    return out


def _sharded_count_merge(uniq: np.ndarray, cnts: np.ndarray, cfg: LeonConfig, k: int, W: int,
                         H, seed: int, lossy: bool, output_path: str, pid: int, nproc: int,
                         counter: count._SlabCounter):
    """The count merge sharded over the k-mer space (distributed.py:
    324-381): each process owns a fixed key range, receives that range's
    rows, merges them and takes their histogram; the histograms sum over
    an allgather, so every process picks the same cutoff and Bloom size;
    each builds its range's solid rows into the filter on its device
    (counter's K3 or K16), and the disjoint range bitsets OR together into
    the one-process filter.

    Returns (bitset np, n_words, cutoff, n_solid, H, hist,
    (solid_mine, counts_mine))."""
    from leon_tpu_torch.ops import bloom

    bounds = count.range_boundaries(nproc, k, W)
    offs = count.range_split(uniq, bounds)
    parts = _exchange_range_runs(uniq, cnts, bounds, offs, output_path, pid, nproc)
    my_uniq, my_cnts = count.merge_counts(parts)

    hist_local = count.histogram(my_cnts) if my_cnts.size else np.zeros(256, np.int64)
    _TRAFFIC["dcn_tx"] += hist_local.nbytes
    gh = _allgather_i64(hist_local)
    _TRAFFIC["dcn_rx"] += gh.nbytes
    hist = gh.sum(axis=0)

    cutoff = cfg.abundance if cfg.abundance is not None else count.auto_cutoff(hist)
    n_solid = int(hist[min(cutoff, 255):].sum())
    # the global histogram: every process picks the same parameters
    auto_bpk, auto_h = bloom.auto_params(
        hist, cutoff, lossy_quals=lossy,
        stored_filter=not (cfg.unitig_sections and 0 < n_solid <= cfg.unitig_max_kmers))
    bpk = cfg.bloom_bits_per_kmer if cfg.bloom_bits_per_kmer is not None else auto_bpk
    H = H if H is not None else auto_h
    n_words = bloom.choose_n_words(max(1, n_solid), bpk)
    warn = bloom.saturation_warning(n_solid, n_words, bpk)
    if warn:
        import sys

        print(f"[leon-tpu-torch] {warn}", file=sys.stderr)

    solid_m = my_cnts >= cutoff
    solid_mine = np.ascontiguousarray(my_uniq[solid_m])
    counts_mine = np.minimum(my_cnts[solid_m], np.iinfo(np.int32).max).astype(np.int32)
    bits = counter._bloom_solid(counter._upload(solid_mine), n_words, H, seed)
    bitset = state.bitset_from_torch(bits)[:n_words].copy()
    for i, blob in enumerate(_allgather_bytes(bitset.tobytes())):
        if i != pid:
            bitset |= np.frombuffer(blob, dtype=np.uint32)
    return bitset, n_words, cutoff, n_solid, H, hist, (solid_mine, counts_mine)


def _build_block_index(input_path: str, cfg: LeonConfig, pid: int, nproc: int):
    """The cooperative block-boundary byte index for sharded parsing
    (distributed.py:384-463): each process scans only its byte range of the
    input (io/bank.py's range scanners), the per-range counts and the
    block-start offsets found in each range are allgathered.

    Returns (offsets (n_blocks+1,) int64, n_reads), the same on every
    process, or None where the input is not eligible (one process, gz, an
    album, irregular FASTQ structure; the caller streams instead, which
    keeps the one-process parser choice)."""
    if nproc <= 1:
        return None
    paths = bank.album_paths(input_path)
    if len(paths) != 1 or paths[0].endswith(".gz"):
        return None
    path = paths[0]
    S = os.path.getsize(path)
    if S == 0:
        return None
    fmt = bank.sniff_format(input_path)
    if fmt == bank.FASTA and bank._byte_at(path, 0) != b">":
        return None  # leading blanks: the one-process run takes the tolerant parser
    rpb = cfg.reads_per_block
    bounds = [p * S // nproc for p in range(nproc + 1)]
    a, b = bounds[pid], bounds[pid + 1]

    def ag_i64(vals) -> np.ndarray:
        arr = np.asarray(vals, np.int64).reshape(-1)
        _TRAFFIC["dcn_tx"] += arr.nbytes
        out = _allgather_i64(arr)
        _TRAFFIC["dcn_rx"] += out.nbytes
        return out

    if fmt == bank.FASTQ:
        n_local = bank.count_newlines_range(path, a, b)
        counts = ag_i64([n_local])[:, 0]
        cum = np.concatenate([[0], np.cumsum(counts)])
        ends_nl = bank._byte_at(path, S - 1) == b"\n"
        total_lines = int(cum[-1]) + (0 if ends_nl else 1)
        if total_lines % 4 or total_lines == 0:
            return None  # the same decision on every process (shared counts)
        n_reads = total_lines // 4
        n_blocks = max(1, -(-n_reads // rpb))
        want = 4 * rpb * np.arange(1, n_blocks, dtype=np.int64)
        ok, found, offs = bank.fastq_scan_range(path, a, b, int(cum[pid]), want)
        oks = ag_i64([1 if ok else 0])[:, 0]
        if not oks.all():
            return None
    else:
        n_local = bank.count_fasta_headers_range(path, a, b)
        counts = ag_i64([n_local])[:, 0]
        cum = np.concatenate([[0], np.cumsum(counts)])
        n_reads = int(cum[-1])
        if n_reads == 0:
            return None
        n_blocks = max(1, -(-n_reads // rpb))
        want_h = rpb * np.arange(1, n_blocks, dtype=np.int64)
        in_rng = (want_h >= cum[pid]) & (want_h < cum[pid + 1])
        found = want_h[in_rng]
        offs = bank.fasta_header_positions_range(path, a, b, found - int(cum[pid]))

    offsets = np.zeros(n_blocks + 1, np.int64)
    offsets[n_blocks] = S
    pairs = np.stack([found, offs], axis=1) if found.size else np.zeros((0, 2), np.int64)
    for blob in _allgather_bytes(pairs.astype("<i8").tobytes()):
        arr = np.frombuffer(blob, "<i8").reshape(-1, 2)
        if fmt == bank.FASTQ:
            offsets[arr[:, 0] // (4 * rpb)] = arr[:, 1]
        else:
            offsets[arr[:, 0] // rpb] = arr[:, 1]
    if n_blocks > 1 and not (np.diff(offsets) > 0).all():
        return None  # a boundary went unfound: stream instead
    return offsets, n_reads


def compress_distributed(input_path: str, output_path: Optional[str] = None,
                         cfg: Optional[LeonConfig] = None, *, device=None) -> dict:
    """This process's part of a compress over every process of the group
    (initialize first); process 0 writes the archive, the one-process
    pipeline.compress archive of the same input and config. device: this
    process's device, cuda:(rank % device_count()) by default. Returns this
    process's stats (output_bytes and ratio on process 0)."""
    t0 = time.time()
    for _k in _TRAFFIC:
        _TRAFFIC[_k] = 0
    pid, nproc = _process()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("compress_distributed: torch sees no CUDA device; pass device=")
        device = torch.device("cuda", pid % torch.cuda.device_count())
    cfg, device, placer = pipeline._setup(
        dataclasses.replace(cfg or LeonConfig(), mesh_devices=1), device)
    with kernels.device_scope(device):
        return _compress_distributed(input_path, output_path, cfg, device, placer, pid, nproc,
                                     t0)


def _compress_distributed(input_path: str, output_path: Optional[str], cfg: LeonConfig,
                          device: torch.device, placer, pid: int, nproc: int,
                          t0: float) -> dict:
    if output_path is None:
        base = input_path[:-3] if input_path.endswith(".gz") else input_path
        output_path = base + ".leon"

    k = cfg.kmer_size
    W = K.words_for_k(k)
    fmt = bank.sniff_format(input_path)

    header_mode = 0 if cfg.noheader else 1
    if fmt == bank.FASTA or cfg.noqual:
        qual_mode = container.QUAL_NONE
    else:
        qual_mode = container.QUAL_LOSSLESS if cfg.lossless else container.QUAL_LOSSY
    out_fmt = bank.FASTA if (fmt == bank.FASTQ and cfg.seq_only) else fmt
    seq_only_conv = fmt == bank.FASTQ and cfg.seq_only

    def conv(b):
        if not seq_only_conv:
            return b
        if isinstance(b, bank.ArrayBlock):
            return b.to_seq_only_fasta()
        return bank.SeqBlock(
            bank.FASTA, b.headers, b.seqs,
            line_lens=[[len(s)] if len(s) else [] for s in b.seqs],
        )

    # the sharded parse index; None falls back to the streaming skip-scan.
    # One parser choice for all passes, the one-process run's (the FASTQ
    # index scan is validate_arrays, sharded)
    shard_index = _build_block_index(input_path, cfg, pid, nproc)
    use_array_parser = (shard_index is not None) or bank.validate_arrays(input_path)

    def stream_blocks():
        """(bi, block) for every block: callers skip those they do not own."""
        it = (bank.read_blocks_arrays(input_path, cfg.reads_per_block)
              if use_array_parser else bank.read_blocks(input_path, cfg.reads_per_block))
        yield from enumerate(it)

    def my_blocks():
        """(bi, block) for the blocks this process owns (bi % nproc == pid);
        with a shard index each parses from its own byte span."""
        if shard_index is not None:
            offsets, _nr = shard_index
            path0 = bank.album_paths(input_path)[0]
            for bi in range(pid, len(offsets) - 1, nproc):
                yield from ((bi, blk) for blk in bank.read_blocks_span(
                    path0, int(offsets[bi]), int(offsets[bi + 1] - offsets[bi]),
                    cfg.reads_per_block))
        else:
            for bi, blk in stream_blocks():
                if bi % nproc == pid:
                    yield bi, blk

    # --- pass 1: count my shard on the device, exchange distinct runs, merge ---
    H, seed = cfg.bloom_hashes, cfg.seed

    def new_counter():
        return (count.DeviceCounter if k <= K.MAX_K else count.WordCounter)(
            k, device, cfg.count_slab_kmers, cfg.count_merge_factor, cfg.count_spill_rows)

    counter = new_counter()
    n_reads = n_blocks = 0
    if shard_index is not None:
        n_reads = shard_index[1]
        n_blocks = len(shard_index[0]) - 1
        pass1_iter = my_blocks()
    else:
        def _count_and_filter():
            nonlocal n_reads, n_blocks
            for bi, blk in stream_blocks():
                n_reads += blk.n_reads
                n_blocks += 1
                if bi % nproc == pid:
                    yield bi, blk
        pass1_iter = _count_and_filter()
    for _bi, block in pass1_iter:
        prep = blockcodec.prepare_block(conv(block), cfg.max_device_len)
        for ch in pipeline.chunk_block(prep, cfg, k):
            if pipeline._walkable(ch, k):
                counter.add_shards(placer.upload(ch), ch.L)

    uniq, cnts = counter.distinct_run()
    lossy = qual_mode == container.QUAL_LOSSY
    unitig_payload = None
    dict_src = None  # the DICT's enumeration, as pipeline._unitig_sections returns it
    if nproc > 1:
        (bitset_np, n_words, cutoff, n_solid, H, hist,
         (solid_mine, counts_mine)) = _sharded_count_merge(
            uniq, cnts, cfg, k, W, H, seed, lossy, output_path, pid, nproc, counter)
        bitset = state.bitset_to_torch(bitset_np, device)
        if cfg.unitig_sections and 0 < n_solid <= cfg.unitig_max_kmers:
            # the solid set gathers to process 0 (range order is the sorted
            # order) and only process 0 builds the section and decides:
            # the one-process rule and bytes (the host builder writes the
            # device builder's payload)
            sp = _gather_solid_to_zero(solid_mine, counts_mine, output_path, pid, nproc)
            if pid == 0 and sp is not None:
                try:
                    p = unitig.build_np_payload(sp[0], sp[1], cutoff, k, int(hist.sum()))
                except Exception:
                    p = None
                if p is not None and len(p) < 4 * n_words:
                    unitig_payload, dict_src = p, ("host", sp[0])
    else:
        # one process: the merged run through a counter's finalize, and the
        # unitig build as pipeline.compress starts and resolves it
        merged = new_counter()
        merged.ingest_run(uniq, cnts)
        bitset, n_words, cutoff, n_solid, _hist, H, run = merged.finalize(
            cfg.abundance, cfg.bloom_bits_per_kmer, H, seed, lossy,
            unitig_max=cfg.unitig_max_kmers if cfg.unitig_sections else 0)
        out: list = []
        thread, inflight = pipeline._start_unitigs(run, cfg, cutoff, n_solid, k, W, out)
        run = None
        unitig_payload, dict_src = pipeline._unitig_sections(thread, out, inflight, n_words)
        bitset_np = state.bitset_from_torch(bitset)
    bitsets = placer.replicas(bitset)

    meta = container.Meta(
        k=k, fmt=out_fmt, qual_mode=qual_mode, header_mode=header_mode,
        n_hashes=H, final_newline=bank.final_newline(input_path),
        n_words=n_words, seed=seed, n_reads=n_reads, abundance=cutoff,
        seglen=cfg.max_device_len,
        orig_ext=b"fasta" if out_fmt == bank.FASTA else b"fastq",
    )

    # --- pass 2: encode my blocks with the dictionary indices deferred; a
    # block's sequence data goes as soon as its walks are done ---
    with_conf = meta.qual_mode == container.QUAL_LOSSY
    encoders: dict[int, blockcodec.BlockEncoder] = {}
    for bi, block in my_blocks():
        block = conv(block)
        prep = blockcodec.prepare_block(block, cfg.max_device_len)
        be = blockcodec.BlockEncoder(cfg, meta, None, block, prep)
        encoders[bi] = be
        for ch in pipeline.chunk_block(prep, cfg, k):
            enc = None
            if pipeline._walkable(ch, k):
                enc = pipeline._walk_chunk(ch, placer.upload(ch), bitsets, n_words, k, H, seed,
                                           with_conf)
            be.add_subbatch(blockcodec.SubbatchData(
                codes=ch.codes, seg_len=ch.seg_len, seg_read=ch.seg_read,
                seg_off=ch.seg_off, n=ch.n, enc=enc))
        be.prep.flat_codes = np.zeros(0, np.uint8)
        if isinstance(be.block, bank.ArrayBlock):
            be.block.seq_cat = np.zeros(0, np.uint8)
        else:
            be.block.seqs = [b""] * len(be.block.seqs)  # SeqBlock.n_reads is len(seqs)

    # --- dictionary replay: per-block distinct first-use key lists ---
    def distinct_in_order(chunks: list[np.ndarray]) -> list[bytes]:
        if not chunks:
            return []
        raw = np.ascontiguousarray(np.concatenate(chunks).astype("<u4"))
        flat = raw.view([("", "<u4")] * raw.shape[1]).reshape(-1)
        _, first = np.unique(flat, return_index=True)
        sz = raw.shape[1] * 4
        rb = raw.tobytes()
        return [rb[i * sz : (i + 1) * sz] for i in np.sort(first)]

    key_sz = W * 4
    my_lists = {bi: distinct_in_order(be.anchor_key_chunks) for bi, be in encoders.items()}
    all_lists: dict[int, list[bytes]] = {}
    for blob in _allgather_bytes(_pack_keylists(my_lists, key_sz)):
        all_lists.update(_unpack_keylists(blob, key_sz))
    adict = blockcodec.AnchorDict(W)
    # the dict's size before each block's first-use entries: finishing a
    # block needs it for stream 4's implicit new indices, since the dict
    # here is filled up front rather than block by block
    prefix_len: dict[int, int] = {}
    for bi in range(n_blocks):
        prefix_len[bi] = len(adict)
        for key in all_lists.get(bi, ()):
            adict.index_key(key)

    # --- finish my blocks against the global dictionary, gather to 0 ---
    my_payloads: dict[int, tuple[bytes, int]] = {}
    stream_sizes: dict[int, int] = {}
    n_anchored = 0
    for bi, be in encoders.items():
        be.adict = adict
        be.dict_prev_len = prefix_len[bi]
        payload, sizes = blockcodec.assemble_block(be.finish_streams(), be.block.n_reads)
        my_payloads[bi] = (payload, be.block.n_reads)
        n_anchored += sum(c.shape[0] for c in be.anchor_key_chunks)
        for sid, sz in sizes.items():
            stream_sizes[sid] = stream_sizes.get(sid, 0) + sz

    gathered: dict[int, tuple[bytes, int]] = {}
    blobs = _gather_payloads_to_zero(_pack_payloads(my_payloads), output_path, pid, nproc)
    if blobs is not None:
        for blob in blobs:
            gathered.update(_unpack_payloads(blob))

    stats = {
        "input": input_path, "output": output_path, "device": str(device),
        "n_reads": n_reads, "n_anchored_local": n_anchored,
        "n_solid_kmers": n_solid, "abundance": cutoff,
        "process": pid, "n_processes": nproc,
        "parse_sharded": shard_index is not None,
        "time_total_s": round(time.time() - t0, 3),
        # this process's exchange traffic: dcn_* the collectives' bytes
        # (count runs, key lists), fs_* the bytes through part files
        "traffic_bytes": dict(_TRAFFIC),
    }
    if pid == 0:
        if unitig_payload is not None:
            section, is_uni = frames.frame(unitig_payload), True
        else:
            section, is_uni = pipeline.frame_bloom(bitset_np[:n_words]), False
        c = container.Container(
            meta=meta,
            dict_payload=pipeline._dict_payload(adict, unitig_payload, dict_src, k),
            bloom_payload=section,
            block_payloads=[gathered[i][0] for i in range(n_blocks)],
            block_n_reads=[gathered[i][1] for i in range(n_blocks)],
            unitigs=is_uni,
        )
        total = container.write(output_path, c)
        stats["output_bytes"] = total
        stats["input_bytes"] = bank.total_size(input_path)
        stats["ratio"] = stats["input_bytes"] / total if total else 0.0
    return stats
