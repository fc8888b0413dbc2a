"""Compression / decompression drivers of the port (counterpart of
leon_tpu/pipeline.py), on one device or lane-sharded over several.

  compress:   parse -> k-mer scan into count slabs (K1) -> sort + reduce
              (K22 radix_sort + K2) -> abundance cutoff -> Bloom build (K3) ->
              solid compaction (K2) -> unitig build -> anchor + walk
              encode (K4) -> host stream assembly -> container
  decompress: container -> Bloom + dict -> decode re-walk (K4) -> host
              reassembly

That is the route for k <= 31, one int64 key per k-mer. For 32 <= k <= 255
(W = 2..16 u32 words) the same stages run on the multiword route: K17 scans
each chunk's valid k-mers into the slab as ceil(W/2) sign-flipped int64 planes,
K21, K22 and K20 sort them, K14 counts and merges (count.WordCounter), K16
builds the Bloom filter, K14's row policy compacts the solid rows, K18
walk-encodes (walk_pack as before) and K19 re-walks at decode. The host
halves (unitig builder, DICT, stream assembly) are W-generic copies.

The unitig build takes one of the reference's two paths
(leon_tpu/pipeline.py:636-722), at every k: when 0 < n_solid <=
min(unitig_max_kmers, unitig_device_max_kmers) it runs on the device (K5-K7
over the solid run: K2's compaction for k <= 31, the rows K14 compacted for
the Bloom build past it; span count.unitig_dispatch) before the first walk
chunk and is drained at the tail (tail.unitig_drain), and the DICT looks its
anchors up on the device (K8); otherwise the native host builder runs on a
thread under the encode stage (unitig.thread_build). A device failure
raises: the BLOOM section is written only where the frozen size and
capacity rules say so.

Inputs of any size (leon_tpu/pipeline.py:497-572, :914-917): an input over
cfg.stream_threshold_bytes is parsed again for each pass and keeps neither
the parsed blocks nor the uploaded chunks (pass 2 uploads each chunk
itself), and the counter spills merged runs past cfg.count_spill_rows to
host RAM (ops/count.py), so host and card memory stay bounded by the
block, the slab and the spill. A cfg.checkpoint file holds the count
pass's result (the reference's format, so each package resumes the
other's); a matching run skips pass 1. cfg.profile_dir runs compress
again under torch.profiler and writes a Chrome trace there.

Kept from the reference: the chunking (_bucket_len, _lane_bucket,
chunk_block), the host unitig thread, the ordered frame pool, the tail
and the decode driver. Archives are byte-identical to leon_tpu's for the
same input and config.

Several devices (leon_tpu/pipeline.py:264-297, the reference's _Placer):
device= takes one device or a sequence of them (the mesh, in shard order;
a device may repeat), and mesh_devices picks the first n cards (_setup).
Each chunk's lanes split into contiguous blocks, one a shard: the shards
scan into the one counter on the first device (its flushes, merges and
spills are a one-device run's), the Bloom bitset is copied once to every
device, and each shard walk-encodes and re-walks its lanes; the results
join in lane order, so the archive and the decoded output do not depend on
the mesh. The unitig build and K8 run on the first device.

Not here: the compile-service retry and the host-count fallback (never
ported). The walk sizes its
event buffers from the per-read counts the kernel produced, so no chunk
overflows and the reference's cap retry and dense fallback have no
counterpart; chunks are encoded one at a time (the card is idle >99% of
the run, PERF.md §5, so the reference's dispatch-ahead queue would buy
nothing).
"""

from __future__ import annotations

import dataclasses
import json
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

from leon_tpu_torch import kernels, native
from leon_tpu_torch.codecs import frames
from leon_tpu_torch.codecs import headers as hcodec
from leon_tpu_torch.config import LeonConfig
from leon_tpu_torch.io import bank, container
from leon_tpu_torch.utils import ragged
from leon_tpu_torch.utils.trace import span, span_add, span_reset, span_totals, tr
from leon_tpu_torch import state
from leon_tpu_torch.codecs import blocks as blockcodec
from leon_tpu_torch.io import records
from leon_tpu_torch.ops import count, unitig, walk
from leon_tpu_torch.ops import kmer as K

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

BATCH_CUDA = 65536  # lanes per walk chunk on the card
BATCH_CPU = 8192


def _mesh_devices(device, mesh_devices: Optional[int]) -> tuple:
    """The devices of the run, in shard order: a sequence given as device=
    is the mesh (repeats allowed; mesh_devices must be None or its length);
    one CUDA device takes the first mesh_devices visible cards (every
    visible card when None, as the reference takes jax.devices()); the CPU
    takes mesh_devices shards, all on the CPU."""
    if isinstance(device, (list, tuple)):
        devs = tuple(torch.device(d) for d in device)
        if not devs:
            raise ValueError("device: an empty sequence of devices")
        if mesh_devices is not None and mesh_devices != len(devs):
            raise ValueError(f"mesh_devices={mesh_devices} but {len(devs)} devices were given")
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and torch.cuda.is_available():
            visible = torch.cuda.device_count()
            n = visible if mesh_devices is None else mesh_devices
            if n > visible:
                raise ValueError(f"mesh_devices={n}: torch sees {visible} CUDA devices")
            devs = (dev,) if n <= 1 else tuple(torch.device("cuda", i) for i in range(n))
        else:
            devs = (dev,) * max(1, mesh_devices or 1)
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {d}")
    # "cuda" names the current card, as a tensor's device does
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d for d in devs)


def _setup(cfg: Optional[LeonConfig], device) -> tuple:
    """Explicit lane count per device (never cfg.resolved(), which imports
    jax), the checks every entry point shares, and the placer. Returns
    (cfg, the first device, placer)."""
    cfg = cfg or LeonConfig()
    devs = _mesh_devices(device, cfg.mesh_devices)
    if cfg.batch_reads is None:
        cfg = dataclasses.replace(
            cfg, batch_reads=BATCH_CUDA if devs[0].type == "cuda" else BATCH_CPU)
    require_native()
    return cfg, devs[0], _Placer(devs, cfg.batch_reads)


class _Placer:
    """Where a chunk's lanes go (leon_tpu/pipeline.py:264-297): one device,
    or contiguous blocks of lanes over the mesh's devices in shard order
    (parallel/mesh.py's layout, JAX's P("d")), each block uploaded to its
    own device. As in the reference, a mesh whose size does not divide
    batch_reads is not used: the run takes its first device alone."""

    def __init__(self, devices: tuple, batch_reads: int):
        n = len(devices)
        self.devices = devices if n > 1 and batch_reads % n == 0 else devices[:1]
        self.n = len(self.devices)

    def blocks(self, lanes: int) -> list:
        """[(lo, hi), ...]: shard i's lanes, in lane order."""
        per = -(-lanes // self.n)
        return [(min(lanes, i * per), min(lanes, (i + 1) * per)) for i in range(self.n)]

    def upload(self, ch: "Chunk") -> list:
        """[(packed, lengths), ...]: each shard's lanes of the chunk on its
        device."""
        return [(state.packed_to_torch(ch.packed[lo:hi], d),
                 torch.from_numpy(ch.dev_len[lo:hi]).to(d))
                for d, (lo, hi) in zip(self.devices, self.blocks(ch.codes.shape[0]))]

    def replicas(self, t: torch.Tensor) -> dict:
        """{device: t there}: one copy to every distinct device of the mesh
        (the reference's replicated bitset, pipeline.py:826-829)."""
        return {d: t if d == t.device else t.to(d) for d in dict.fromkeys(self.devices)}


def require_native() -> None:
    """Build and load the port's native host library up front: the frame
    coders' bytes depend on it, and get_lib raises if g++ fails."""
    native.get_lib()


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


_CKPT_VERSION = 4  # leon_tpu/pipeline.py:145: counts Bloom layout + key fields
_CKPT_MAGIC = b"LEONCKPT"


def _ckpt_key(cfg: LeonConfig, k: int, input_path: str, lossy_quals: bool) -> tuple:
    """What a checkpoint must match (leon_tpu/pipeline.py:148-159): the
    fields that change the count pass's result, the quality mode (the auto
    Bloom sizing differs by mode) and the input's name and size."""
    try:
        size = bank.total_size(input_path)
    except OSError:
        size = -1
    return (_CKPT_VERSION, k, cfg.seed, cfg.bloom_hashes,
            cfg.bloom_bits_per_kmer, cfg.abundance, cfg.max_device_len,
            lossy_quals, cfg.unitig_sections,
            os.path.basename(input_path), size)


def _load_count_checkpoint(cfg: LeonConfig, k: int, input_path: str, lossy_quals: bool):
    """(bitset (n_words,) u32, n_words, cutoff, n_solid, n_hashes, UNITIGS
    payload or None) from cfg.checkpoint, or None when there is none or it
    does not match (leon_tpu/pipeline.py:165-197). The format: magic | u32
    json_len | JSON header | raw <u4 bitset | optional raw UNITIGS payload.
    No pickle: a hostile file is at worst ignored."""
    if not cfg.checkpoint or not os.path.exists(cfg.checkpoint):
        return None
    try:
        with open(cfg.checkpoint, "rb") as f:
            if f.read(8) != _CKPT_MAGIC:
                return None
            jlen = int.from_bytes(f.read(4), "little")
            if jlen > 1 << 20:
                return None
            d = json.loads(f.read(jlen))
            if d.get("key") != list(_ckpt_key(cfg, k, input_path, lossy_quals)):
                return None
            n_words, nb = int(d["n_words"]), int(d["bitset_bytes"])
            ub = int(d.get("unitig_bytes", 0))
            if nb != 4 * n_words or n_words <= 0 or not 0 <= ub <= os.path.getsize(cfg.checkpoint):
                return None
            raw = f.read(nb)
            uni = f.read(ub) if ub else None
        if len(raw) != nb or (ub and len(uni) != ub):
            return None
        return (np.frombuffer(raw, dtype="<u4"), n_words, int(d["cutoff"]), int(d["n_solid"]),
                int(d["n_hashes"]), uni)
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


def _save_count_checkpoint(cfg: LeonConfig, k: int, input_path: str, lossy_quals: bool,
                           bitset: np.ndarray, n_words: int, cutoff: int, n_solid: int,
                           n_hashes: int, unitig_payload: Optional[bytes]) -> None:
    """Write cfg.checkpoint (leon_tpu/pipeline.py:200-225): the resolved
    section decision rides along (no payload = the BLOOM section), so a
    resumed run writes the same archive."""
    raw = bitset.astype("<u4").tobytes()
    hdr = json.dumps({
        "key": list(_ckpt_key(cfg, k, input_path, lossy_quals)),
        "bitset_bytes": len(raw),
        "n_words": int(n_words), "cutoff": int(cutoff),
        "n_solid": int(n_solid), "n_hashes": int(n_hashes),
        "unitig_bytes": len(unitig_payload) if unitig_payload else 0,
    }).encode()
    tmp = cfg.checkpoint + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_CKPT_MAGIC)
        f.write(len(hdr).to_bytes(4, "little"))
        f.write(hdr)
        f.write(raw)
        if unitig_payload:
            f.write(unitig_payload)
    os.replace(tmp, cfg.checkpoint)


def _count_pass(preps, cfg: LeonConfig, k: int, H, seed: int, device, placer: _Placer,
                dev_cache: Optional[dict], lossy_quals: bool):
    """K-mer counting + Bloom build on the device. Each shard of the mesh
    scans its lanes of a chunk (K1 or K17); the keys go, in lane order,
    into one counter on the first device, so that the slabs, merges and
    spills are a one-device run's. dev_cache (None in stream mode) keeps
    each chunk's uploaded shards [(packed, lengths), ...] for the encode
    pass. Returns the counter's finalize tuple and its spill count."""
    counter = (count.DeviceCounter if k <= K.MAX_K else count.WordCounter)(
        k, device, cfg.count_slab_kmers, cfg.count_merge_factor, cfg.count_spill_rows)
    ci = 0
    for prep in preps:
        for ch in chunk_block(prep, cfg, k):
            ci += 1
            if not _walkable(ch, k):
                continue
            with span("count.pack_h2d"):
                shards = placer.upload(ch)
                if dev_cache is not None:
                    dev_cache[ci - 1] = shards
            with span("count.dispatch"):
                counter.add_shards(shards, ch.L)
    with span("count.finalize"):
        res = counter.finalize(
            cfg.abundance, cfg.bloom_bits_per_kmer, H, seed, lossy_quals,
            unitig_max=cfg.unitig_max_kmers if cfg.unitig_sections else 0)
    return res, counter.n_spills


def _solid_rows(run: count.Run, cutoff: int) -> torch.Tensor:
    """The run's solid rows on the device: the rows the Bloom build
    compacted (K14, or those a spilled count uploaded), else K2's solid
    mode over the keys."""
    return count.compact_solid(run.rows, run.counts, cutoff)[0] if run.solid is None else run.solid


def _start_unitig_thread(run: count.Run, cutoff: int, n_solid: int, k: int, W: int, out: list):
    """Build the unitig payload on a host thread under the encode stage
    (leon_tpu/pipeline.py:643-700), from the solid rows shipped down, or
    from those a spilled count already holds in host memory."""
    if run.counts is None:
        words = run.rows
    else:
        with span("unitig.solid_d2h"):
            solid = _solid_rows(run, cutoff)
            if solid.dim() == 1:
                words = state.keys_from_torch(solid, W)
            else:
                words = solid.cpu().numpy().view(np.uint32)
    words = np.ascontiguousarray(words)
    hp = words
    if words.shape[0] < n_solid:
        # the histogram overcounts solid rows when cutoff > 255, and the
        # reference's zero-padded compaction hands the builder n_solid
        # rows: the port hands it the same rows, for the same bytes
        hp = np.concatenate([words, np.zeros((n_solid - words.shape[0], W), np.uint32)])

    def build(rows):
        return (unitig.build_np_payload(rows, np.full(rows.shape[0], cutoff, np.int32),
                                        cutoff, k, run.nu, nthreads=3), rows)

    def _host_build():
        try:
            with span("unitig.thread_build"):
                try:
                    out.append(build(hp))
                except unitig.LinksNotChains:
                    # the pads' walk never ends (the reference's builder
                    # loops there): build over the exact rows, which gives
                    # the reference's device-build archive
                    out.append(build(words))
        except Exception:  # the BLOOM section is always a correct fallback
            print("[leon-tpu-torch] host unitig build failed; writing the BLOOM section\n"
                  + traceback.format_exc(), file=sys.stderr)
            out.append((None, None))

    t = threading.Thread(target=_host_build, daemon=True)
    t.start()
    return t


def _start_unitigs(run: Optional[count.Run], cfg: LeonConfig, cutoff: int, n_solid: int, k: int,
                   W: int, out: list) -> tuple:
    """Start the unitig build where the section may be written
    (leon_tpu/pipeline.py:636-722): on the device when n_solid <=
    unitig_device_max_kmers, else on a host thread. Returns (thread or None,
    the device build or None)."""
    if not (cfg.unitig_sections and run is not None and 0 < n_solid <= cfg.unitig_max_kmers):
        return None, None
    if n_solid <= cfg.unitig_device_max_kmers:
        with span("count.unitig_dispatch"):
            return None, unitig.dispatch_build(_solid_rows(run, cutoff), k, run.nu)
    return _start_unitig_thread(run, cutoff, n_solid, k, W, out), None


def _dict_payload(adict: blockcodec.AnchorDict, unitig_payload: Optional[bytes], dict_src,
                  k: int) -> bytes:
    """The DICT section: indices into the solid enumeration where the UNITIGS
    section is written (dict_src as _unitig_sections returns it, or None
    where only the payload's bytes are at hand), else the anchors' words."""
    if unitig_payload is None or not len(adict):
        return adict.payload(None)
    if dict_src is None:
        # a resumed count holds only the payload bytes: enumerate it
        return adict.payload(unitig.solid_kmers_sorted(unitig_payload, k))
    if dict_src[0] == "infl":
        # the build's solid run IS the enumeration: look the anchors up on
        # the device instead of shipping the run down
        return adict.payload_indexed(*unitig.solid_indices(dict_src[1], adict.words_array()))
    return adict.payload(dict_src[1])


def _unitig_sections(thread, out: list, inflight, n_words: int) -> tuple:
    """Join the host build or drain the device build and apply the frozen
    size rule (UNITIGS only when smaller than the bitset). Returns (payload
    or None for BLOOM, the DICT's enumeration: ("host", solid rows) or
    ("infl", the device build, whose rows K8 searches), else None)."""
    if thread is not None:
        with span("tail.unitig_join"):
            thread.join()
        p, hs = out[0] if out else (None, None)
        if p is not None and len(p) < 4 * n_words:
            return p, ("host", hs)
    if inflight is not None:
        with span("tail.unitig_drain"):
            p = unitig.drain_build(inflight)
        if p is not None and len(p) < 4 * n_words:
            return p, ("infl", inflight)
    return None, None


_LANE_KEYS = ("anchored", "apos", "nbif_r", "nerr_r", "nbif_l", "nerr_l", "conf16")
_FLAT_KEYS = ("errgap_flat", "errnt_flat", "bif_flat")


def _walk_chunk(ch: Chunk, shards: list, bitsets: dict, n_words: int, k: int, H: int,
                seed: int, with_conf: bool) -> dict:
    """One chunk's walk encode: each shard [(packed, lengths), ...] walks its
    lanes (K4 or K18) against the bitset on its device into a flat buffer
    sized from its own event totals (it never overflows), shipped down and
    unpacked. The shards' enc dicts join in lane order, which is the
    one-device dict: a lane's fields and its events are its own, and the
    event streams run lane after lane."""
    with span("enc.walk"):
        bufs = []
        for packed, dlen in shards:
            with kernels.device_scope(packed.device):
                bufs.append(walk.encode_batch_compact_packed(
                    packed, dlen, bitsets[packed.device], k, H, n_words, seed, None, None,
                    with_conf, ch.L))
        bufs = [(buf.cpu().numpy().view(np.uint16), ce, cb) for buf, ce, cb in bufs]
    with span("enc.unpack"):
        encs = []
        lo = 0
        for (packed, _), (buf_h, cap_err, cap_bif) in zip(shards, bufs):
            B = packed.shape[0]
            enc = walk.unpack_compact(buf_h, max(0, min(ch.n - lo, B)), B, ch.L, cap_err,
                                      cap_bif, with_conf=with_conf, k=k)
            if enc is None:
                raise RuntimeError("walk buffer overflow with exact capacities")
            encs.append(enc)
            lo += B
    if len(encs) == 1:
        return encs[0]
    out = {n: np.concatenate([e[n] for e in encs]) for n in _LANE_KEYS + _FLAT_KEYS}
    out["compact"] = True
    return out


def compress(input_path: str, output_path: Optional[str] = None,
             cfg: Optional[LeonConfig] = None, *, device) -> dict:
    """Compress a FASTA/FASTQ file into a .leon archive on `device` ('cuda'
    or 'cpu', or a sequence of devices: the mesh, _mesh_devices); returns
    the reference's stats dict. The archive does not depend on the mesh."""
    cfg, device, placer = _setup(cfg, device)
    if cfg.profile_dir:
        # the same call under torch.profiler (leon_tpu/pipeline.py:458-468)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            st = compress(input_path, output_path,
                          dataclasses.replace(cfg, profile_dir=None, mesh_devices=None),
                          device=list(placer.devices))
        os.makedirs(cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.profile_dir,
                                              f"compress.{time.time_ns()}.pt.trace.json"))
        return st
    with kernels.device_scope(device):
        try:
            return _compress_impl(input_path, output_path, cfg, device, placer, None)
        except bank.IrregularInput:
            # the optimistic array parser hit irregular structure: restart
            # with the tolerant parser (leon_tpu/pipeline.py:469-478)
            return _compress_impl(input_path, output_path, cfg, device, placer, False)


def _compress_impl(input_path: str, output_path: Optional[str], cfg: LeonConfig,
                   device: torch.device, placer: _Placer, parser_hint: Optional[bool]) -> dict:
    span_reset()
    t0 = time.time()
    if output_path is None:
        first = bank.album_paths(input_path)[0]
        base = first[:-3] if first.endswith(".gz") else first
        output_path = base + ".leon"

    k = cfg.kmer_size
    W = K.words_for_k(k)
    fmt = bank.sniff_format(input_path)
    stream_mode = bank.total_size(input_path) > cfg.stream_threshold_bytes

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
    # in memory, pass 1 parses while the device counts and pass 2 replays
    # its blocks from RAM; in stream mode each pass parses again
    bp_cache: Optional[list] = None if stream_mode else []
    t_parse = time.time() - t0

    # --- pass 1: k-mer counting + solidity threshold + Bloom build ---
    t1 = time.time()
    seed = cfg.seed
    tally = {"reads": 0, "blocks": 0}

    def iter_preps():
        for b, p in timed_bp():
            if bp_cache is not None:
                bp_cache.append((b, p))
            tally["reads"] += b.n_reads
            tally["blocks"] += 1
            yield p

    unitig_thread = unitig_inflight = None
    unitig_out: list = []
    sections = None  # (UNITIGS payload or None, the DICT's enumeration), once resolved
    n_spills = 0
    dev_cache: Optional[dict] = None if stream_mode else {}
    ck = _load_count_checkpoint(cfg, k, input_path, lossy)
    if ck is not None:
        # resume: the bitset goes up, the stored section decision stands,
        # and a pass without the count counts the records
        # (leon_tpu/pipeline.py:777-783), with the parser pass 2 takes: in
        # memory it is pass 1's parse, whose blocks pass 2 replays
        bitset_np, n_words, cutoff, n_solid, H, ck_payload = ck
        bitset = state.bitset_to_torch(bitset_np, device)
        sections = (ck_payload, None)
        if bp_cache is None:
            n_reads = sum(b.n_reads for b in raw_blocks())
        else:
            for _ in iter_preps():
                pass
            n_reads = tally["reads"]
    else:
        (bitset, n_words, cutoff, n_solid, _hist, H, run), n_spills = _count_pass(
            iter_preps(), cfg, k, cfg.bloom_hashes, seed, device, placer, dev_cache, lossy)
        unitig_thread, unitig_inflight = _start_unitigs(run, cfg, cutoff, n_solid, k, W,
                                                        unitig_out)
        run = None
        n_reads = tally["reads"]
        if cfg.checkpoint:
            # the section decision is part of the checkpoint, so it is
            # resolved now (leon_tpu/pipeline.py:756-776)
            sections = _unitig_sections(unitig_thread, unitig_out, unitig_inflight, n_words)
            _save_count_checkpoint(cfg, k, input_path, lossy,
                                   state.bitset_from_torch(bitset)[:n_words], n_words, cutoff,
                                   n_solid, H, sections[0])
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
    bitsets = placer.replicas(bitset)
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
        for block, prep in (bp_cache or timed_bp()):
            be = blockcodec.BlockEncoder(cfg, meta, adict, block, prep)
            for ch in chunk_block(prep, cfg, k):
                ci += 1
                enc = None
                if _walkable(ch, k):
                    up = dev_cache.pop(ci - 1, None) if dev_cache else None
                    if up is None:  # stream mode or a resumed count: upload here
                        with span("enc.pack_h2d"):
                            up = placer.upload(ch)
                    enc = _walk_chunk(ch, up, bitsets, n_words, k, H, seed, with_conf)
                    counters["anchored"] += int(enc["anchored"].sum())
                with span("enc.subbatch"):
                    be.add_subbatch(blockcodec.SubbatchData(
                        codes=ch.codes, seg_len=ch.seg_len, seg_read=ch.seg_read,
                        seg_off=ch.seg_off, n=ch.n, enc=enc))
            with span("enc.finish"):
                todo = be.finish_streams()
            commit_q.append((frame_pool.submit(_frame_job, todo, block.n_reads), block.n_reads))
            _commit(max(4, 2 * n_frame_workers))
            _progress(cfg, "encode", counters["blocks_done"] + 1, tally["blocks"])
        _commit(0)
    finally:
        frame_pool.shutdown(wait=True)
    bp_cache = dev_cache = bitsets = None
    t_encode = time.time() - t1

    if sections is None:
        sections = _unitig_sections(unitig_thread, unitig_out, unitig_inflight, n_words)
    unitig_payload, dict_src = sections
    if unitig_payload is not None:
        with span("tail.unitig_frame"):
            writer.section(container.TAG_UNITIGS, frames.frame(unitig_payload))
    else:
        with span("tail.bloom_frame"):
            writer.section(container.TAG_BLOOM, frame_bloom(state.bitset_from_torch(bitset)))
    with span("tail.dict"):
        writer.section(container.TAG_DICT, _dict_payload(adict, unitig_payload, dict_src, k))
    total = writer.close()
    in_bytes = bank.total_size(input_path)
    return {
        "input": input_path,
        "output": output_path,
        "device": str(device),
        "mesh_devices": placer.n,
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
        "stream_mode": stream_mode,
        "count_spills": n_spills,
        "resumed": ck is not None,
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
                           bitsets: dict, cfg: LeonConfig, placer: _Placer) -> list:
    """Launch every sub-batch's decode re-walk (leon_tpu/pipeline.py:1046-1143);
    returns the handles _assemble_block_seqs drains. On a mesh each shard
    re-walks its block of the sub-batch's lanes (K4 or K19) against the
    bitset on its device, with the whole flat event streams (a lane's
    err_base and bif_base are offsets into them, pipeline.py:1131-1133);
    a sub-batch whose lanes do not split evenly is padded with empty lanes
    to a multiple of the mesh's size (pipeline.py:1113-1117)."""
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
        pad = -(e - s) % placer.n
        if pad:
            sl = np.concatenate([sl, np.zeros(pad, sl.dtype)])
            anch = np.concatenate([anch, np.zeros(pad, bool)])
            scal = np.concatenate([scal, np.zeros((pad, scal.shape[1]), np.int32)])
        Lb = _bucket_len(int(sl[anch].max()), k)
        flats = {d: (_to_device(db.errgaps[e0:e1].astype(np.int32), d),
                     _to_device(db.errnts[e0:e1].astype(np.uint8), d),
                     _to_device(db.bifs[b0:b1].astype(np.uint8), d)) for d in bitsets}
        decs = []
        for d, (lo, hi) in zip(placer.devices, placer.blocks(scal.shape[0])):
            with kernels.device_scope(d):
                decs.append(walk.decode_batch_flat_packed(
                    _to_device(scal[lo:hi], d), *flats[d], bitsets[d], meta.n_words, k, H, seed,
                    Lb))
        dispatched.append((s, anch, sl, Lb, decs))
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

    for s, anch, sl, Lb, decs in dispatched:
        with span("dec.drain"):
            dec = np.concatenate([d.cpu().numpy() for d in decs])
            codes = walk.unpack_codes_u32_np(dec.view(np.uint32), Lb)
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
    """Decompress a .leon archive on `device` ('cuda' or 'cpu', or a
    sequence of devices: the mesh, _mesh_devices)."""
    cfg, device, placer = _setup(cfg, device)
    with kernels.device_scope(device):
        return _decompress_impl(input_path, output_path, cfg, device, placer)


def _decompress_impl(input_path: str, output_path: Optional[str], cfg: LeonConfig,
                     device: torch.device, placer: _Placer) -> dict:
    span_reset()
    t0 = time.time()
    r = container.Reader(input_path)
    meta = r.meta
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
    bitsets = placer.replicas(state.bitset_to_torch(bitset_np, device))

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
                    dispatched = _dispatch_block_decode(db, meta, dict_words, bitsets,
                                                        cfg, placer)
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
        "mesh_devices": placer.n,
        "n_reads": read_index,
        "output_bytes": os.path.getsize(output_path),
        "time_total_s": round(time.time() - t0, 3),
        "span_s": span_totals(),
    }
