"""Compression / decompression drivers of the port (counterpart of
leon_tpu/pipeline.py), on one device.

  compress:   parse -> k-mer scan into count slabs (K1) -> sort + reduce
              (torch.sort + K2) -> abundance cutoff -> Bloom build (K3) ->
              solid compaction (K2) -> unitig build -> anchor + walk
              encode (K4) -> host stream assembly -> container
  decompress: container -> Bloom + dict -> decode re-walk (K4) -> host
              reassembly

The unitig build takes one of the reference's two paths
(leon_tpu/pipeline.py:636-722): when 0 < n_solid <= min(unitig_max_kmers,
unitig_device_max_kmers) it runs on the device (K5-K7, span
count.unitig_dispatch) before the first walk chunk and is drained at the
tail (tail.unitig_drain), and the DICT looks its anchors up on the device
(K8); otherwise the native host builder runs on a thread under the encode
stage (unitig.thread_build). A device failure raises: the BLOOM section is
written only where the frozen size and capacity rules say so.

Kept from the reference: the chunking (_bucket_len, _lane_bucket,
chunk_block), the host unitig thread, the ordered frame pool, the tail
and the decode driver. Archives are byte-identical to leon_tpu's for the
same input and config.

Not here: the compile-service retry, the multi-chip placer, checkpoints,
stream mode (inputs over cfg.stream_threshold_bytes), k > 31 and the
host-count fallback. Reaching one raises NotImplementedError
(ROADMAP.md queue 1, item 9). The walk sizes its event buffers from the
per-read counts the kernel produced, so no chunk overflows and the
reference's cap retry and dense fallback have no counterpart; chunks are
encoded one at a time (the card is idle >99% of the run, PERF.md §5, so
the reference's dispatch-ahead queue would buy nothing).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from leon_tpu import native
from leon_tpu.codecs import frames
from leon_tpu.codecs import headers as hcodec
from leon_tpu.config import LeonConfig
from leon_tpu.io import bank, container
from leon_tpu.utils import ragged
from leon_tpu.utils.trace import span, span_add, span_reset, span_totals, tr
from leon_tpu_torch import state
from leon_tpu_torch.codecs import blocks as blockcodec
from leon_tpu_torch.io import records
from leon_tpu_torch.ops import count, unitig, walk
from leon_tpu_torch.ops import kmer as K

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

BATCH_CUDA = 65536  # lanes per walk chunk on the card
BATCH_CPU = 8192


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to leon_tpu_torch yet (ROADMAP.md queue 1, item 9)")


def _setup(cfg: Optional[LeonConfig], device) -> tuple[LeonConfig, torch.device]:
    """Explicit lane count per device (never cfg.resolved(), which imports
    jax), and the checks every entry point shares."""
    cfg = cfg or LeonConfig()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if cfg.batch_reads is None:
        cfg = dataclasses.replace(
            cfg, batch_reads=BATCH_CUDA if device.type == "cuda" else BATCH_CPU)
    if cfg.checkpoint:
        raise _not_ported("checkpoint resume")
    if cfg.profile_dir:
        raise _not_ported("profile_dir tracing")
    require_native()
    return cfg, device


def require_native() -> None:
    """Without the native host library the frame coders fall back to zlib
    and the archive bytes would silently differ from the reference's."""
    if native.get_lib() is None:
        raise RuntimeError("the native host library (leon_tpu/native, g++) did not build")


def _progress(cfg: LeonConfig, stage: str, done: int, total: int) -> None:
    if cfg.verbose >= 1 and total > 1 and sys.stderr.isatty():
        pct = 100.0 * done / total
        print(f"\r[{stage}] {done}/{total} ({pct:.0f}%)", end="" if done < total else "\n",
              file=sys.stderr)


def _bucket_len(maxlen: int, k: int) -> int:
    """Padded chunk width (leon_tpu/pipeline.py:57-68)."""
    need = max(maxlen, k + 1)
    if need <= 128:
        return -(-need // 8) * 8
    step = max(16, 1 << (need.bit_length() - 4))
    return -(-need // step) * step


@dataclass
class Chunk:
    """One device sub-batch of SEGMENTS (leon_tpu/pipeline.py:71-97)."""

    codes: np.ndarray      # (B_pad, L) uint8, exceptions substituted, zero-padded
    dev_len: np.ndarray    # (B_pad,) int32 — 0 for pad lanes
    L: int                 # bucketed width
    n: int                 # true segments in this chunk
    seg_read: np.ndarray
    seg_off: np.ndarray
    seg_len: np.ndarray
    _packed: Optional[np.ndarray] = None

    @property
    def packed(self) -> np.ndarray:  # (B_pad, ceil(L/16)) uint32
        if self._packed is None:
            self._packed = K.pack_codes_np(self.codes)
        return self._packed


def _lane_bucket(m: int, B: int) -> int:
    """Padded lane count of a chunk of m rows (leon_tpu/pipeline.py:100-111)."""
    if m >= B:
        return B
    n = max(4096, m)
    gran = max(4096, 1 << max(0, (n - 1).bit_length() - 3))
    return min(B, -(-n // gran) * gran)


def chunk_block(prep: blockcodec.BlockPrep, cfg: LeonConfig, k: int) -> Iterator[Chunk]:
    """leon_tpu/pipeline.py:114-137."""
    B = cfg.batch_reads
    total = prep.n_segs
    flat = prep.flat_codes
    starts_all = (prep.read_start[prep.seg_read] + prep.seg_off).astype(np.int64)
    for s in range(0, total, B):
        so = prep.seg_off[s : s + B]
        sl = prep.seg_len[s : s + B]
        m = sl.shape[0]
        Lb = _bucket_len(int(sl.max()) if m else 0, k)
        codes = np.zeros((_lane_bucket(m, B), Lb), dtype=np.uint8)
        if flat.size:
            ragged.move(codes.reshape(-1), np.arange(m, dtype=np.int64) * Lb,
                        flat, starts_all[s : s + B], sl)
        dev_pad = np.zeros(codes.shape[0], dtype=np.int32)
        dev_pad[:m] = sl
        yield Chunk(
            codes=codes, dev_len=dev_pad, L=Lb, n=m,
            seg_read=prep.seg_read[s : s + B], seg_off=so, seg_len=sl,
        )


def _walkable(ch: Chunk, k: int) -> bool:
    """Chunks whose lanes are all shorter than k skip the device."""
    return ch.L >= k + 1 and bool((ch.dev_len >= k).any())


def frame_bloom(bitset: np.ndarray) -> bytes:
    """Entropy-frame the Bloom bitset (leon_tpu/pipeline.py:251-261)."""
    return frames.frame(bitset.astype("<u4").tobytes(),
                        try_o1=bitset.nbytes < (128 << 20))


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def _count_pass(preps, cfg: LeonConfig, k: int, H, seed: int, device,
                dev_cache: dict, lossy_quals: bool):
    """K-mer counting + Bloom build on the device. dev_cache keeps each
    chunk's uploaded (packed, lengths) for the encode pass."""
    counter = count.DeviceCounter(k, device, merge_factor=cfg.count_merge_factor)
    ci = 0
    for prep in preps:
        for ch in chunk_block(prep, cfg, k):
            ci += 1
            if not _walkable(ch, k):
                continue
            with span("count.pack_h2d"):
                packed = state.packed_to_torch(ch.packed, device)
                dlen = torch.from_numpy(ch.dev_len).to(device)
                dev_cache[ci - 1] = (packed, dlen)
            with span("count.dispatch"):
                counter.add_packed(packed, dlen, ch.L)
    with span("count.finalize"):
        return counter.finalize(
            cfg.abundance, cfg.bloom_bits_per_kmer, H, seed, lossy_quals,
            unitig_max=cfg.unitig_max_kmers if cfg.unitig_sections else 0)


def _start_unitig_thread(run, cutoff: int, n_solid: int, k: int, W: int, out: list):
    """Compact the distinct run to its solid rows on the device (K2), ship
    them down, and build the unitig payload on a host thread under the
    encode stage (leon_tpu/pipeline.py:643-700)."""
    keys, counts, nu = run
    with span("unitig.solid_d2h"):
        sk, _ = count.compact_solid(keys, counts, cutoff)
        words = state.keys_from_torch(sk, W)
    if words.shape[0] < n_solid:
        # the histogram overcounts solid rows when cutoff > 255; the
        # reference's zero-padded compaction hands the builder n_solid rows
        words = np.concatenate([words, np.zeros((n_solid - words.shape[0], W), np.uint32)])
    hp = (np.ascontiguousarray(words), np.full(n_solid, cutoff, np.int32))

    def _host_build():
        try:
            with span("unitig.thread_build"):
                out.append((unitig.build_np_payload(hp[0], hp[1], cutoff, k, nu, nthreads=3),
                            hp[0]))
        except Exception:  # the BLOOM section is always a correct fallback
            print("[leon-tpu-torch] host unitig build failed; writing the BLOOM section\n"
                  + traceback.format_exc(), file=sys.stderr)
            out.append((None, None))

    t = threading.Thread(target=_host_build, daemon=True)
    t.start()
    return t


def _walk_chunk(ch: Chunk, packed, dlen, bitset, n_words: int, k: int, H: int,
                seed: int, with_conf: bool) -> dict:
    """One chunk's walk encode: the flat buffer, sized from the chunk's own
    event totals (it never overflows), shipped down and unpacked."""
    with span("enc.walk"):
        buf, cap_err, cap_bif = walk.encode_batch_compact_packed(
            packed, dlen, bitset, k, H, n_words, seed, None, None, with_conf, ch.L)
        buf_h = buf.cpu().numpy().view(np.uint16)
    with span("enc.unpack"):
        enc = walk.unpack_compact(buf_h, ch.n, ch.codes.shape[0], ch.L, cap_err, cap_bif,
                                  with_conf=with_conf, k=k)
    if enc is None:
        raise RuntimeError("walk buffer overflow with exact capacities")
    return enc


def compress(input_path: str, output_path: Optional[str] = None,
             cfg: Optional[LeonConfig] = None, *, device) -> dict:
    """Compress a FASTA/FASTQ file into a .leon archive on `device`
    ('cuda' or 'cpu'); returns the reference's stats dict."""
    cfg, device = _setup(cfg, device)
    if cfg.kmer_size > K.MAX_K:
        raise _not_ported(f"k = {cfg.kmer_size} > {K.MAX_K} (multiword keys)")
    try:
        return _compress_impl(input_path, output_path, cfg, device, None)
    except bank.IrregularInput:
        # the optimistic array parser hit irregular structure: restart with
        # the tolerant parser (leon_tpu/pipeline.py:469-478)
        return _compress_impl(input_path, output_path, cfg, device, False)


def _compress_impl(input_path: str, output_path: Optional[str], cfg: LeonConfig,
                   device: torch.device, parser_hint: Optional[bool]) -> dict:
    span_reset()
    t0 = time.time()
    if output_path is None:
        first = bank.album_paths(input_path)[0]
        base = first[:-3] if first.endswith(".gz") else first
        output_path = base + ".leon"

    k = cfg.kmer_size
    W = K.words_for_k(k)
    fmt = bank.sniff_format(input_path)
    if bank.total_size(input_path) > cfg.stream_threshold_bytes:
        raise _not_ported("stream mode (inputs over stream_threshold_bytes)")

    header_mode = 0 if cfg.noheader else 1
    if fmt == bank.FASTA or cfg.noqual:
        qual_mode = container.QUAL_NONE
    else:
        qual_mode = container.QUAL_LOSSLESS if cfg.lossless else container.QUAL_LOSSY
    out_fmt = bank.FASTA if (fmt == bank.FASTQ and cfg.seq_only) else fmt
    seq_only_conv = fmt == bank.FASTQ and cfg.seq_only
    lossy = qual_mode == container.QUAL_LOSSY

    def conv(b):
        if not seq_only_conv:
            return b
        if isinstance(b, bank.ArrayBlock):
            return b.to_seq_only_fasta()
        return bank.SeqBlock(
            bank.FASTA, b.headers, b.seqs,
            line_lens=[[len(s)] if len(s) else [] for s in b.seqs],
        )

    tr("parse.begin")
    use_array_parser = (bank.validate_arrays(input_path, prefix_bytes=8 << 20)
                        if parser_hint is None else parser_hint)

    def raw_blocks():
        if use_array_parser:
            yield from bank.read_blocks_arrays(input_path, cfg.reads_per_block)
        else:
            yield from bank.read_blocks(input_path, cfg.reads_per_block)

    def timed_bp():
        it = raw_blocks()
        while True:
            t = time.time()
            b = next(it, None)
            if b is None:
                span_add("parse.inline", time.time() - t)
                return
            b = conv(b)
            p = blockcodec.prepare_block(b, cfg.max_device_len)
            span_add("parse.inline", time.time() - t)
            yield b, p

    final_nl = bank.final_newline(input_path)
    # pass 1 parses while the device counts; pass 2 replays from RAM
    bp_cache: list = []

    def iter_bp():
        if bp_cache:
            yield from bp_cache
            return
        for bp in timed_bp():
            bp_cache.append(bp)
            yield bp

    t_parse = time.time() - t0

    # --- pass 1: k-mer counting + solidity threshold + Bloom build ---
    t1 = time.time()
    seed = cfg.seed
    tally = {"reads": 0}

    def iter_preps():
        tally["reads"] = 0
        for b, p in iter_bp():
            tally["reads"] += b.n_reads
            yield p

    dev_cache: dict = {}
    bitset, n_words, cutoff, n_solid, _hist, H, run = _count_pass(
        iter_preps(), cfg, k, cfg.bloom_hashes, seed, device, dev_cache, lossy)
    unitig_thread = None
    unitig_inflight = None
    unitig_out: list = []
    if (cfg.unitig_sections and run is not None
            and 0 < n_solid <= cfg.unitig_max_kmers):
        if n_solid <= cfg.unitig_device_max_kmers:
            with span("count.unitig_dispatch"):
                keys, counts, nu = run
                unitig_inflight = unitig.dispatch_build(keys, counts, cutoff, k, nu)
        else:
            unitig_thread = _start_unitig_thread(run, cutoff, n_solid, k, W, unitig_out)
    run = None
    n_reads = tally["reads"]
    t_count = time.time() - t1

    meta = container.Meta(
        k=k, fmt=out_fmt, qual_mode=qual_mode, header_mode=header_mode,
        n_hashes=H, final_newline=final_nl, n_words=n_words,
        seed=seed, n_reads=n_reads, abundance=cutoff,
        seglen=cfg.max_device_len,
        orig_ext=b"fasta" if out_fmt == bank.FASTA else b"fastq",
    )

    # --- pass 2: anchor + walk encode, stream assembly ---
    t1 = time.time()
    writer = container.Writer(output_path)
    writer.section(container.TAG_META, meta.pack())
    adict = blockcodec.AnchorDict(W)
    stream_sizes: dict[int, int] = {}
    counters = {"blocks_done": 0, "anchored": 0}
    with_conf = meta.qual_mode == container.QUAL_LOSSY

    # block framing runs on background workers, committed in order
    # (leon_tpu/pipeline.py:846-933): archives are byte-identical under any
    # scheduling
    n_frame_workers = max(1, cfg.nb_cores or (os.cpu_count() or 1))
    frame_pool = ThreadPoolExecutor(max_workers=n_frame_workers,
                                    thread_name_prefix="leon-blk")
    commit_q: deque = deque()

    def _frame_job(todo, nr):
        t = time.time()
        res = blockcodec.assemble_block(todo, nr)
        span_add("enc.frame_bg", time.time() - t)
        return res

    def _commit(limit: int) -> None:
        while commit_q and (commit_q[0][0].done() or len(commit_q) > limit):
            fut, nr = commit_q.popleft()
            with span("enc.commit_wait"):
                payload, sizes = fut.result()
            with span("enc.write"):
                writer.block(payload, nr)
            counters["blocks_done"] += 1
            for sid, sz in sizes.items():
                stream_sizes[sid] = stream_sizes.get(sid, 0) + sz

    try:
        ci = 0
        for block, prep in iter_bp():
            be = blockcodec.BlockEncoder(cfg, meta, adict, block, prep)
            for ch in chunk_block(prep, cfg, k):
                ci += 1
                enc = None
                if _walkable(ch, k):
                    packed, dlen = dev_cache.pop(ci - 1)
                    enc = _walk_chunk(ch, packed, dlen, bitset, n_words, k, H, seed, with_conf)
                    counters["anchored"] += int(enc["anchored"].sum())
                with span("enc.subbatch"):
                    be.add_subbatch(blockcodec.SubbatchData(
                        codes=ch.codes, seg_len=ch.seg_len, seg_read=ch.seg_read,
                        seg_off=ch.seg_off, n=ch.n, enc=enc))
            with span("enc.finish"):
                todo = be.finish_streams()
            commit_q.append((frame_pool.submit(_frame_job, todo, block.n_reads), block.n_reads))
            _commit(max(4, 2 * n_frame_workers))
            _progress(cfg, "encode", counters["blocks_done"] + 1, len(bp_cache))
        _commit(0)
    finally:
        frame_pool.shutdown(wait=True)
    t_encode = time.time() - t1

    unitig_payload = None
    solid_rows = None
    if unitig_thread is not None:
        with span("tail.unitig_join"):
            unitig_thread.join()
        p, hs = unitig_out[0] if unitig_out else (None, None)
        if p is not None and len(p) < 4 * n_words:  # frozen size rule
            unitig_payload, solid_rows = p, hs
    if unitig_inflight is not None:
        with span("tail.unitig_drain"):
            p = unitig.drain_build(unitig_inflight)
        if p is not None and len(p) < 4 * n_words:  # frozen size rule
            unitig_payload = p
    if unitig_payload is not None:
        with span("tail.unitig_frame"):
            writer.section(container.TAG_UNITIGS, frames.frame(unitig_payload))
    else:
        with span("tail.bloom_frame"):
            writer.section(container.TAG_BLOOM, frame_bloom(state.bitset_from_torch(bitset)))
    with span("tail.dict"):
        if unitig_payload is None or not len(adict):
            dict_payload = adict.payload(None)
        elif unitig_inflight is not None:
            # the build's solid run IS the enumeration: look the anchors up
            # on the device instead of shipping the run down
            dict_payload = adict.payload_indexed(
                *unitig.solid_indices(unitig_inflight, adict.words_array()))
        else:
            dict_payload = adict.payload(solid_rows)
        writer.section(container.TAG_DICT, dict_payload)
    total = writer.close()
    in_bytes = bank.total_size(input_path)
    return {
        "input": input_path,
        "output": output_path,
        "device": str(device),
        "n_reads": n_reads,
        "n_anchored": counters["anchored"],
        "n_solid_kmers": n_solid,
        "abundance": cutoff,
        "bloom_bytes": 4 * n_words,
        "unitig_bytes": len(unitig_payload) if unitig_payload else 0,
        "dict_entries": len(adict),
        "input_bytes": in_bytes,
        "output_bytes": total,
        "ratio": in_bytes / total if total else 0.0,
        "stream_bytes": {blockcodec_stream_name(s): v for s, v in sorted(stream_sizes.items())},
        "time_parse_s": round(t_parse, 3),
        "time_count_s": round(t_count, 3),
        "time_encode_s": round(t_encode, 3),
        "time_total_s": round(time.time() - t0, 3),
        "span_s": span_totals(),
    }


_STREAM_NAMES = {
    1: "flags", 2: "readlen", 3: "anchorpos", 4: "dictidx", 5: "nevt",
    6: "errpos", 7: "errnt", 8: "bif", 9: "rawseq", 10: "excn",
    11: "headers", 12: "quals", 13: "plusline", 14: "fastalines",
    15: "excgap", 16: "excbyte", 17: "quallines",
}


def blockcodec_stream_name(sid: int) -> str:
    return _STREAM_NAMES.get(sid, str(sid))


# ---------------------------------------------------------------------------
# Decompression
# ---------------------------------------------------------------------------


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _dispatch_block_decode(db: blockcodec.DecodedBlock, meta, dict_words: np.ndarray,
                           bitset: torch.Tensor, cfg: LeonConfig, device) -> list:
    """Launch every sub-batch's decode re-walk (leon_tpu/pipeline.py:1046-1143);
    returns the handles _assemble_block_seqs drains."""
    k, H, seed = meta.k, meta.n_hashes, meta.seed
    n_segs = db.seg_read.shape[0]

    # forward-orientation anchor words per anchored segment
    W = dict_words.shape[1] if dict_words.size else K.words_for_k(k)
    afwd_all = np.zeros((n_segs, W), dtype=np.uint32)
    anch_idx = np.flatnonzero(db.anchored)
    if anch_idx.size:
        words = dict_words[db.dictidx]
        rcw = K.revcomp_words_batch_np(words, k)
        ori = db.orient[anch_idx]
        afwd_all[anch_idx] = np.where(ori[:, None], rcw, words)

    # per-lane matrix [apos, anchored, dlen, nerr_r, nerr_l, nbif_r,
    # nbif_l, err_base(rel), bif_base(rel), afwd...]
    scal_all = np.empty((n_segs, 9 + W), dtype=np.int32)
    scal_all[:, 0] = db.apos
    scal_all[:, 1] = db.anchored
    scal_all[:, 2] = np.where(db.anchored, db.seg_len, 0)
    scal_all[:, 3] = db.nerr_r
    scal_all[:, 4] = db.nerr_l
    scal_all[:, 5] = db.nbif_r
    scal_all[:, 6] = db.nbif_l
    scal_all[:, 7] = db.err_base[:n_segs]
    scal_all[:, 8] = db.bif_base[:n_segs]
    scal_all[:, 9:] = afwd_all.view(np.int32)

    B = cfg.batch_reads
    dispatched = []
    for s in range(0, n_segs, B):
        e = min(n_segs, s + B)
        sl = db.seg_len[s:e]
        anch = db.anchored[s:e]
        if not anch.any():
            continue
        scal = scal_all[s:e].copy()
        e0 = int(db.err_base[s])
        e1 = int(db.err_base[e]) if e < n_segs else db.errgaps.size
        b0 = int(db.bif_base[s])
        b1 = int(db.bif_base[e]) if e < n_segs else db.bifs.size
        scal[:, 7] -= e0
        scal[:, 8] -= b0
        Lb = _bucket_len(int(sl[anch].max()), k)
        dec = walk.walk_decode(
            _to_device(scal, device),
            _to_device(db.errgaps[e0:e1].astype(np.int32), device),
            _to_device(db.errnts[e0:e1].astype(np.uint8), device),
            _to_device(db.bifs[b0:b1].astype(np.uint8), device),
            bitset, meta.n_words, k, H, seed, Lb)
        dispatched.append((s, anch, sl, Lb, dec))
    return dispatched


def _assemble_block_seqs(db: blockcodec.DecodedBlock, dispatched: list) -> tuple:
    """Drain the re-walks and build the block's flat ASCII sequence buffer
    (leon_tpu/pipeline.py:1146-1185)."""
    n_reads = db.n_reads
    lengths = db.lengths
    read_start = np.concatenate(([0], np.cumsum(lengths)[:-1])) if n_reads else np.zeros(0, np.int64)
    total = int(lengths.sum()) if n_reads else 0
    out_flat = np.zeros(total, dtype=np.uint8)
    seg_start = read_start[db.seg_read] + db.seg_off

    for s, anch, sl, Lb, dec in dispatched:
        with span("dec.drain"):
            codes = walk.unpack_codes_u32_np(dec.cpu().numpy().view(np.uint32), Lb)
        rows = np.flatnonzero(anch)
        lens = sl[rows]
        ragged.move(out_flat, seg_start[s:][rows],
                    np.ascontiguousarray(codes).reshape(-1), rows * Lb, lens)

    raw_idx = np.flatnonzero(~db.anchored)
    if raw_idx.size:
        ln = db.seg_len[raw_idx]
        nb = (ln + 3) // 4
        codes_all = K.unpack_2bit_np(db.rawseq, 4 * len(db.rawseq))
        src_start = 4 * (np.cumsum(nb) - nb)
        ragged.move(out_flat, seg_start[raw_idx], codes_all, src_start, ln)

    seq_bytes = _BASES[out_flat]
    if db.exc_read.size:
        seq_bytes[read_start[db.exc_read] + db.exc_rel] = db.exc_bytes
    return seq_bytes, read_start, lengths


def decompress(input_path: str, output_path: Optional[str] = None,
               cfg: Optional[LeonConfig] = None, *, device) -> dict:
    """Decompress a .leon archive on `device` ('cuda' or 'cpu')."""
    cfg, device = _setup(cfg, device)
    span_reset()
    t0 = time.time()
    r = container.Reader(input_path)
    meta = r.meta
    if meta.k > K.MAX_K:
        r.close()
        raise _not_ported(f"k = {meta.k} > {K.MAX_K} (multiword keys)")
    if output_path is None:
        stem = input_path[:-5] if input_path.endswith(".leon") else input_path
        root, _dot, _ext = stem.rpartition(".")
        ext = meta.orig_ext.decode()
        output_path = (root if root else stem) + "." + ext + ".d"

    W = K.words_for_k(meta.k)
    uni_framed = r.unitigs_payload
    uni_raw = None
    canon_cache: list = []

    def _get_canon():
        if not canon_cache:
            canon_cache.append(unitig.spell_canon(uni_raw, meta.k))
        return canon_cache[0]

    if uni_framed is not None:
        uni_raw, _ = frames.unframe(uni_framed, 0)
    with span("dec.dict"):
        if r.version >= 5:
            adict = blockcodec.AnchorDict.from_payload_v5(
                r.dict_payload, W,
                solid_provider=lambda: unitig.solid_kmers_sorted(
                    uni_raw, meta.k, canon=_get_canon()),
            )
        else:
            adict = blockcodec.AnchorDict.from_payload(r.dict_payload, W)
        dict_words = adict.words_array()
    if uni_raw is not None:
        with span("dec.rebuild_bitset"):
            bitset_np = unitig.rebuild_bitset_np(
                uni_raw, meta.k, meta.n_words, meta.n_hashes, meta.seed,
                canon=canon_cache[0] if canon_cache else None)
        canon_cache.clear()
    else:
        bloom_bytes, _ = frames.unframe(r.bloom_payload, 0)
        bitset_np = np.frombuffer(bloom_bytes, dtype="<u4")
    bitset = state.bitset_to_torch(bitset_np, device)

    read_index = 0
    wpool = ThreadPoolExecutor(1, thread_name_prefix="leon-dwr")
    wfuts: list = []

    def _write_job(args, kwargs):
        t = time.time()
        records.write_records_arrays(*args, **kwargs)
        span_add("dec.write", time.time() - t)

    try:
        with open(output_path, "wb") as out:
            def emit(db, dispatched, start_index):
                with span("dec.assemble"):
                    seq_flat, _read_start, lengths = _assemble_block_seqs(db, dispatched)
                with span("dec.headers"):
                    if meta.header_mode:
                        headers = hcodec.decode(db.headers_payload or b"", db.n_reads)
                    else:
                        headers = hcodec.synth(start_index, db.n_reads)
                    hcat = b"".join(headers)
                hlens = np.fromiter((len(h) for h in headers), dtype=np.int64, count=len(headers))
                qcat = None
                if meta.fmt == bank.FASTQ and meta.qual_mode != container.QUAL_NONE:
                    qcat = db.quals_concat or b""
                wfuts.append(wpool.submit(
                    _write_job,
                    (out, meta.fmt, hcat, hlens, seq_flat, lengths),
                    dict(qcat=qcat, plus_lens=db.plus_lens, plus_cat=db.plus_cat,
                         fasta_nlines=db.fasta_nlines,
                         fasta_linelens=db.fasta_linelens,
                         qual_nlines=db.qual_nlines,
                         qual_linelens=db.qual_linelens),
                ))

            # depth-2 pipeline: block i+1's re-walks launch before block
            # i's host assembly drains
            pending: list = []
            for bi in range(r.n_blocks):
                with span("dec.parse_block"):
                    db = blockcodec.parse_block(r.block(bi), meta)
                with span("dec.dispatch"):
                    dispatched = _dispatch_block_decode(db, meta, dict_words, bitset,
                                                        cfg, device)
                pending.append((db, dispatched, read_index))
                read_index += db.n_reads
                if len(pending) > 1:
                    emit(*pending.pop(0))
            while pending:
                emit(*pending.pop(0))
            for f in wfuts:  # surface any write error before close
                f.result()
    finally:
        wpool.shutdown(wait=True)
        r.close()
    bank.finalize_file(output_path, meta.final_newline)
    return {
        "input": input_path,
        "output": output_path,
        "device": str(device),
        "n_reads": read_index,
        "output_bytes": os.path.getsize(output_path),
        "time_total_s": round(time.time() - t0, 3),
        "span_s": span_totals(),
    }
