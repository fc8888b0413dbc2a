"""Block stream assembly: walk-encode output <-> container byte streams
(a copy of leon_tpu/codecs/blocks.py).

Host-side serialization glue between the walk kernels and the container
(FORMAT.md §6), vectorized numpy over whole sub-batches. Copied, with the
k-mer and walk imports pointed at the port, because the reference module
imports jax through leon_tpu.ops.kmer when it loads; it must stay identical
in behaviour (tests/test_torch_pipeline.py compares whole archives). Left
out of the copy: what the port's pipeline never calls (the in-block
framing pool with BlockEncoder.finish, and AnchorDict.index).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from leon_tpu.codecs import frames
from leon_tpu.io import bank
from leon_tpu_torch.ops import kmer as K
from leon_tpu.utils import varint

# FORMAT.md §6 stream ids
S_FLAGS = 1
S_READLEN = 2
S_ANCHORPOS = 3
S_DICTIDX = 4
S_NEVT = 5
S_ERRPOS = 6
S_ERRNT = 7
S_BIF = 8
S_RAWSEQ = 9
S_EXCN = 10
S_HEADERS = 11
S_QUALS = 12
S_PLUSLINE = 13
S_FASTALINES = 14
S_EXCGAP = 15
S_EXCBYTE = 16
S_QUALLINES = 17  # wrapped FASTQ: quality line structure (when != seq's)

F_ANCHORED = 1
F_ORIENT = 2
F_HASEXC = 4
F_HASPLUS = 8

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _ragged_dst(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Indices for ragged copies: segment i occupies
    [starts[i], starts[i]+lens[i]). Vectorized (repeat + arange)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    rep = np.repeat(starts.astype(np.int64), lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens, dtype=np.int64) - lens, lens
    )
    return rep + within


ragged_dst = _ragged_dst


def _msw_struct(words: np.ndarray) -> np.ndarray:
    """(n, W) u32 LSW-first rows -> (n,) structured keys whose field-wise
    comparison order equals numeric big-int order (for searchsorted)."""
    w = np.ascontiguousarray(words.astype("<u4")[:, ::-1])
    return np.ascontiguousarray(w).view([("", "<u4")] * w.shape[1]).reshape(-1)


def _bitpack(vals: np.ndarray, width: int) -> bytes:
    """Fixed-width little-bit-first packing of u64 values."""
    if vals.size == 0:
        return b""
    bits = ((vals[:, None] >> np.arange(width, dtype=np.uint64)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1)).tobytes()


def _bitunpack(buf: bytes, n: int, width: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int64)
    bits = np.unpackbits(np.frombuffer(buf, np.uint8), count=n * width)
    return (bits.reshape(n, width).astype(np.uint64)
            << np.arange(width, dtype=np.uint64)).sum(axis=1).astype(np.int64)


class AnchorDict:
    """Global anchor dictionary, first-use order (FORMAT.md §5)."""

    def __init__(self, W: int):
        self.W = W
        self._map: dict[bytes, int] = {}
        self._words: list[bytes] = []

    def index_key(self, key: bytes) -> int:
        idx = self._map.get(key)
        if idx is None:
            idx = len(self._words)
            self._map[key] = idx
            self._words.append(key)
        return idx

    def index_array(self, keys: np.ndarray) -> np.ndarray:
        """Bulk first-use-order indexing of (N, W) u32 canonical k-mers.

        Vectorized: the Python dict is touched once per DISTINCT new key
        (np.unique pre-pass), not once per anchor — the per-anchor loop
        was a measured hot spot of stream assembly."""
        n = keys.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        raw = np.ascontiguousarray(keys.astype("<u4"))
        flat = raw.view([("", "<u4")] * raw.shape[1]).reshape(-1)
        uniq, first, inv = np.unique(flat, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")  # first-use order
        rank = np.empty(order.size, dtype=np.int64)
        rank[order] = np.arange(order.size)
        gidx = np.empty(order.size, dtype=np.int64)
        ub = uniq.tobytes()
        sz = raw.shape[1] * 4
        # resolve each distinct key (in first-use order) against the map
        for j in range(order.size):
            u = int(order[j])
            gidx[j] = self.index_key(ub[u * sz : (u + 1) * sz])
        return gidx[rank[inv]]

    def __len__(self) -> int:
        return len(self._words)

    def _raw_body(self) -> bytes:
        out = bytearray()
        varint.encode_one(len(self._words), out)
        out += frames.frame(b"".join(self._words))
        return bytes(out)

    def payload(self, solid_sorted: "np.ndarray | None" = None) -> bytes:
        """DICT section payload (container v5: leading u8 format tag).

        tag 0: raw — varint n + framed key bytes (the only form v3/v4
        could express, minus the tag byte).
        tag 1: solid-indexed — anchors are almost always members of the
        solid set the UNITIGS section already ships, so each entry stores
        its index into `solid_sorted` (ceil(log2 n_solid) bits) instead
        of W*4 raw bytes; Bloom-false-positive anchors miss and stay raw.
        Both sides derive `solid_sorted` from the unitig payload with
        unitig.solid_kmers_sorted, so the enumeration cannot drift.
        Measured 3-4x smaller than tag 0 on the bench corpus, where the
        dict was the second-largest stream (VERDICT r2 weak #5)."""
        n = len(self._words)
        if solid_sorted is None or n == 0 or solid_sorted.shape[0] == 0:
            return b"\x00" + self._raw_body()
        words = self.words_array()
        keys = _msw_struct(words)
        skeys = _msw_struct(solid_sorted)
        ns = int(solid_sorted.shape[0])
        pos = np.searchsorted(skeys, keys)
        posc = np.minimum(pos, ns - 1)
        hit = skeys[posc] == keys
        return self.payload_indexed(hit, posc, ns)

    def payload_indexed(self, hit: np.ndarray, idx: np.ndarray, ns: int) -> bytes:
        """tag-1 payload from a precomputed enumeration lookup (hit mask +
        solid ranks, e.g. unitig.solid_indices_dev) — the device-side
        lookup avoids pulling the whole solid run to host."""
        n = len(self._words)
        if n == 0 or ns == 0:
            return b"\x00" + self._raw_body()
        width = max(1, (ns - 1).bit_length())
        out = bytearray(b"\x01")
        varint.encode_one(n, out)
        varint.encode_one(ns, out)
        out += frames.frame(np.packbits(hit).tobytes())
        out += frames.frame(_bitpack(idx[hit].astype(np.uint64), width))
        out += frames.frame(b"".join(self._words[i] for i in np.nonzero(~hit)[0]))
        return bytes(out)

    @classmethod
    def _from_raw_body(cls, buf: bytes, W: int) -> "AnchorDict":
        n, pos = varint.decode_one(buf, 0)
        raw, _ = frames.unframe(buf, pos)
        d = cls(W)
        sz = W * 4
        if len(raw) != n * sz:
            raise ValueError(f"anchor dict size mismatch: {len(raw)} != {n}*{sz}")
        d._words = [raw[i * sz : (i + 1) * sz] for i in range(n)]
        return d

    @classmethod
    def from_payload(cls, buf: bytes, W: int) -> "AnchorDict":
        """Legacy (container v3/v4) untagged raw payload."""
        return cls._from_raw_body(buf, W)

    @classmethod
    def from_payload_v5(cls, buf: bytes, W: int, solid_provider) -> "AnchorDict":
        """Container v5 tagged payload. `solid_provider` is a zero-arg
        callable returning the sorted solid set (only invoked for tag 1,
        so BLOOM-section archives never pay for it)."""
        if not buf:
            raise ValueError("empty anchor dict payload")
        tag = buf[0]
        if tag == 0:
            return cls._from_raw_body(buf[1:], W)
        if tag != 1:
            raise ValueError(f"unknown anchor dict format tag {tag}")
        n, pos = varint.decode_one(buf, 1)
        ns, pos = varint.decode_one(buf, pos)
        solid_sorted = solid_provider()
        if int(solid_sorted.shape[0]) != ns:
            raise ValueError(
                f"anchor dict solid-set size mismatch: {solid_sorted.shape[0]} != {ns}"
            )
        hraw, pos = frames.unframe(buf, pos)
        hit = np.unpackbits(np.frombuffer(hraw, np.uint8), count=n).astype(bool)
        width = max(1, (ns - 1).bit_length())
        iraw, pos = frames.unframe(buf, pos)
        idx = _bitunpack(iraw, int(hit.sum()), width)
        mraw, _ = frames.unframe(buf, pos)
        sz = W * 4
        if len(mraw) != (n - int(hit.sum())) * sz:
            raise ValueError("anchor dict miss-blob size mismatch")
        d = cls(W)
        solid_le = np.ascontiguousarray(solid_sorted.astype("<u4"))
        hit_words = solid_le[idx]
        words = np.empty((n, W), dtype="<u4")
        words[hit] = hit_words
        if n - int(hit.sum()):
            words[~hit] = np.frombuffer(mraw, "<u4").reshape(-1, W)
        wb = words.tobytes()
        d._words = [wb[i * sz : (i + 1) * sz] for i in range(n)]
        return d

    def words_array(self) -> np.ndarray:
        """(n, W) uint32 array of all canonical anchor k-mers."""
        if not self._words:
            return np.zeros((0, self.W), dtype=np.uint32)
        return np.frombuffer(b"".join(self._words), dtype="<u4").reshape(-1, self.W)


def segment_table(lengths: np.ndarray, seglen: int):
    """(seg_read, seg_off, seg_len) int64 arrays for FORMAT.md §2 rules."""
    n = lengths.shape[0]
    if seglen <= 0:
        ar = np.arange(n, dtype=np.int64)
        return ar, np.zeros(n, np.int64), lengths.astype(np.int64)
    nseg = np.maximum(1, -(-lengths.astype(np.int64) // seglen))
    seg_read = np.repeat(np.arange(n, dtype=np.int64), nseg)
    first = np.concatenate(([0], np.cumsum(nseg)[:-1]))
    seg_in_read = np.arange(seg_read.shape[0], dtype=np.int64) - first[seg_read]
    seg_off = seg_in_read * seglen
    seg_len = np.minimum(lengths.astype(np.int64)[seg_read] - seg_off, seglen)
    return seg_read, seg_off, seg_len


@dataclass
class BlockPrep:
    """Per-block host preprocessing shared by count and encode passes."""

    lens: np.ndarray          # (n_reads,) int64
    flat_codes: np.ndarray    # concatenated substituted base codes
    read_start: np.ndarray    # (n_reads,) int64 offsets into flat_codes
    exc_pos: list             # per read: positions or None
    exc_byte: list
    seg_read: np.ndarray
    seg_off: np.ndarray
    seg_len: np.ndarray

    @property
    def n_segs(self) -> int:
        return self.seg_read.shape[0]


def prepare_block(block, seglen: int) -> BlockPrep:
    """Accepts a bank.SeqBlock (per-read lists) or bank.ArrayBlock (the
    vectorized parser's concatenated-array form — no per-read objects)."""
    n = block.n_reads
    if isinstance(block, bank.ArrayBlock):
        lens = block.seq_lens.astype(np.int64)
        flat = block.seq_cat
    else:
        lens = np.array([len(s) for s in block.seqs], dtype=np.int64)
        flat = np.frombuffer(b"".join(block.seqs), dtype=np.uint8)
    codes_f = K._CODE[flat]
    exc_f = codes_f == 255
    codes_f = np.where(exc_f, 0, codes_f)
    ends = np.cumsum(lens)
    starts = ends - lens
    exc_pos: list = [None] * n
    exc_byte: list = [None] * n
    if exc_f.any():
        eidx = np.flatnonzero(exc_f)
        rows = np.searchsorted(ends, eidx, side="right")
        for r in np.unique(rows):
            sel = eidx[rows == r]
            exc_pos[r] = (sel - starts[r]).astype(np.int64)
            exc_byte[r] = flat[sel]
    seg_read, seg_off, seg_len = segment_table(lens, seglen)
    return BlockPrep(
        lens=lens, flat_codes=codes_f, read_start=starts,
        exc_pos=exc_pos, exc_byte=exc_byte,
        seg_read=seg_read, seg_off=seg_off, seg_len=seg_len,
    )


@dataclass
class SubbatchData:
    """One device sub-batch of SEGMENTS plus its walk-encode output.

    Arrays cover the n true segments (pad lanes excluded); `enc` is the
    unpacked result of encode_batch_compact (or the dense fallback dict),
    or None when the sub-batch skipped the device entirely.
    """

    codes: np.ndarray         # (n_pad, L) uint8 (padded lanes included)
    seg_len: np.ndarray       # (n,) int
    seg_read: np.ndarray      # (n,)
    seg_off: np.ndarray       # (n,)
    n: int
    enc: Optional[dict]


def _pack_2bit(vals: bytes | bytearray) -> bytes:
    """2-bit values (0..3), 4 per byte, value i at bits 2i..2i+1 of byte
    i//4; tail padded with zeros (count comes from stream 5)."""
    a = np.frombuffer(bytes(vals), dtype=np.uint8)
    if not a.size:
        return b""
    pad = (-a.size) % 4
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint8)])
    c = a.reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).tobytes()


def _unpack_2bit(data: bytes, n: int) -> np.ndarray:
    b = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((b.size, 4), np.uint8)
    out[:, 0] = b & 3
    out[:, 1] = (b >> 2) & 3
    out[:, 2] = (b >> 4) & 3
    out[:, 3] = b >> 6
    flat = out.reshape(-1)
    if flat.size < n:
        raise ValueError("2-bit stream shorter than event count")
    return flat[:n]


def _encode_line_struct(line_lens: list) -> bytes:
    """Streams 14/17 payload: per read varint n_lines; if n_lines > 1,
    n_lines-1 varint line lengths (the last line length is implied by the
    read's total length)."""
    vals: list[int] = []
    for lens_ in line_lens:
        vals.append(len(lens_))
        if len(lens_) > 1:
            vals.extend(lens_[:-1])
    return varint.encode_array(np.asarray(vals, dtype=np.uint64))


class BlockEncoder:
    """Accumulates one container block's streams sub-batch by sub-batch."""

    def __init__(self, cfg, meta, adict: AnchorDict, block: bank.SeqBlock,
                 prep: BlockPrep):
        self.cfg = cfg
        self.meta = meta
        self.adict = adict
        self.block = block
        self.prep = prep
        # dict size before this block's first-use entries. The in-order
        # pipeline leaves this None (len(adict) at finish time is correct);
        # the distributed driver prepopulates the global dict and must set
        # the per-block prefix explicitly.
        self.dict_prev_len: Optional[int] = None
        self.flags = bytearray()
        self.anchorpos: list[np.ndarray] = []
        self.anchor_key_chunks: list[np.ndarray] = []  # (m, W) u32 per subbatch
        self.nevt: list[np.ndarray] = []
        self.errpos: list[np.ndarray] = []
        self.errnt = bytearray()
        self.bif = bytearray()
        self.rawseq = bytearray()
        is_arr = isinstance(block, bank.ArrayBlock)
        # per-read bits for flag placement on first segments
        self._read_bits = np.zeros(block.n_reads, dtype=np.uint8)
        for i, p in enumerate(prep.exc_pos):
            if p is not None:
                self._read_bits[i] |= F_HASEXC
        if block.fmt == bank.FASTQ:
            if is_arr:
                if block.plus_lens is not None:
                    self._read_bits[block.plus_lens > 0] |= F_HASPLUS
            elif block.pluses is not None:
                for i, p in enumerate(block.pluses):
                    if p:
                        self._read_bits[i] |= F_HASPLUS
        # mutable concatenated qualities for the lossy transform
        self.qual_arr: Optional[np.ndarray] = None
        self.qual_start: Optional[np.ndarray] = None
        if meta.qual_mode:
            if is_arr:
                self.qual_arr = (block.qual_cat if block.qual_cat is not None
                                 else np.zeros(0, np.uint8)).copy()
                qlens = block.seq_lens.astype(np.int64)  # validated == qual lens
            else:
                qcat = b"".join(block.quals) if block.quals else b""
                self.qual_arr = np.frombuffer(qcat, dtype=np.uint8).copy()
                qlens = np.array([len(q) for q in (block.quals or [])], dtype=np.int64)
            self.qual_start = np.concatenate(([0], np.cumsum(qlens)[:-1])) if qlens.size else np.zeros(0, np.int64)
            self._qual_lens = qlens  # per-read lengths for the method-4 coder

    def add_subbatch(self, sb: SubbatchData) -> None:
        n = sb.n
        enc = sb.enc
        if enc is not None:
            anch = enc["anchored"][:n].astype(bool)
            apos = enc["apos"][:n].astype(np.int64)
            acanon, orient = K.kmer_words_batch_np(sb.codes[:n], apos, self.meta.k)
            orient = orient & anch
        else:
            anch = np.zeros(n, dtype=bool)
            orient = np.zeros(n, dtype=bool)
            apos = np.zeros(n, dtype=np.int64)

        first_seg = sb.seg_off == 0
        fl = (
            anch.astype(np.uint8) * F_ANCHORED
            | orient.astype(np.uint8) * F_ORIENT
            | np.where(first_seg, self._read_bits[sb.seg_read], 0).astype(np.uint8)
        )
        self.flags += fl.tobytes()

        ai = np.flatnonzero(anch)
        if ai.size:
            self.anchorpos.append(apos[ai].astype(np.uint64))
            self.anchor_key_chunks.append(acanon[ai].astype("<u4"))
            nerr_r = enc["nerr_r"][:n].astype(np.int64)
            nbif_r = enc["nbif_r"][:n].astype(np.int64)
            nerr_l = enc["nerr_l"][:n].astype(np.int64)
            nbif_l = enc["nbif_l"][:n].astype(np.int64)
            self.nevt.append(
                np.stack([nerr_r, nbif_r, nerr_l, nbif_l], axis=1)[ai].reshape(-1).astype(np.uint64)
            )
            if enc.get("compact"):
                # device already emitted the exact container stream layout
                self.errpos.append(enc["errgap_flat"].astype(np.uint64))
                self.errnt += enc["errnt_flat"].tobytes()
                self.bif += enc["bif_flat"].tobytes()
            else:
                gaps = np.concatenate([enc["gap_r"][:n], enc["gap_l"][:n]], axis=1)[ai]
                ME = enc["gap_r"].shape[1]
                emask = np.arange(ME)[None, :]
                emask2 = np.concatenate(
                    [emask < nerr_r[ai, None], emask < nerr_l[ai, None]], axis=1
                )
                self.errpos.append(gaps[emask2].astype(np.uint64))
                ents = np.concatenate([enc["errnt_r"][:n], enc["errnt_l"][:n]], axis=1)[ai]
                self.errnt += ents[emask2].astype(np.uint8).tobytes()
                bmask2 = np.concatenate(
                    [emask < nbif_r[ai, None], emask < nbif_l[ai, None]], axis=1
                )
                bifs = np.concatenate([enc["bif_r"][:n], enc["bif_l"][:n]], axis=1)[ai]
                self.bif += bifs[bmask2].astype(np.uint8).tobytes()

        ri = np.flatnonzero(~anch)
        if ri.size:
            from leon_tpu.utils import ragged

            # 2-bit pack all raw segments at once (each segment byte-aligned)
            ln = sb.seg_len[ri].astype(np.int64)
            nb4 = ((ln + 3) // 4) * 4
            flat = np.zeros(int(nb4.sum()), dtype=np.uint8)
            ragged.move(flat, np.cumsum(nb4) - nb4,
                        np.ascontiguousarray(sb.codes).reshape(-1),
                        ri * sb.codes.shape[1], ln)
            c = flat.reshape(-1, 4)
            self.rawseq += (
                c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
            ).astype(np.uint8).tobytes()

        # lossy quality transform at graph-confirmed positions (LOSSY-Q1)
        if self.meta.qual_mode == 2 and enc is not None and self.qual_arr is not None and ai.size:
            from leon_tpu_torch.ops import walk as _walk

            Lc = sb.codes.shape[1]
            if "conf16" in enc:
                conf = _walk.unpack_conf16_bits(enc["conf16"][:n], Lc)
            else:
                conf = enc["confirmed"][:n].astype(bool)
            mask = conf & (np.arange(Lc)[None, :] < sb.seg_len[:, None]) & anch[:, None]
            rows, cols = np.nonzero(mask)
            if rows.size:
                qidx = self.qual_start[sb.seg_read[rows]] + sb.seg_off[rows] + cols
                q = self.qual_arr[qidx]
                self.qual_arr[qidx] = np.where(q >= 0x40, 0x49, q)

    def finish_streams(self) -> list[tuple[int, bytes, dict]]:
        """Resolve this block's raw streams IN ORDER (anchor-dict indices
        depend on the global first-use state, so this must run on the
        pipeline thread, block by block). Returns the (sid, data, frame
        kwargs) list whose entropy framing — the expensive part — is a
        pure function of the list and can run on a background worker
        (assemble_block); archives stay byte-identical under any
        scheduling."""
        block = self.block
        prep = self.prep
        todo: list[tuple[int, object, dict]] = []

        def add(sid: int, data, **kw) -> None:
            # `data` may be bytes or a zero-arg callable producing bytes:
            # callables defer pure per-block work (header tokenization,
            # varint/2-bit packing, inner frames) to the background
            # assembly job; empty results are dropped there, matching the
            # eager `if data` skip
            if callable(data) or data:
                todo.append((sid, data, kw))

        add(S_FLAGS, bytes(self.flags))
        lens = prep.lens
        prev = np.concatenate(([0], lens[:-1]))
        add(S_READLEN, varint.encode_array(varint.zigzag(lens - prev)))
        if self.anchorpos:
            add(S_ANCHORPOS, varint.encode_array(np.concatenate(self.anchorpos)))
            # dictionary indices resolve at finish time, in block order —
            # this is what lets a multi-host run replay a global first-use
            # order and still emit byte-identical blocks
            prev_len = (self.dict_prev_len if self.dict_prev_len is not None
                        else len(self.adict))
            dictidx = self.adict.index_array(np.concatenate(self.anchor_key_chunks))
            # stream 4 (FORMAT.md §6): a NEW anchor's index is implicit
            # (it equals the dict size at that point, first-use order), so
            # only a new/reuse bitmask plus the reused indices are coded —
            # measured ~25% smaller than delta-coding the full sequence
            # new = first occurrence IN THIS BLOCK of an index the block
            # itself created (>= prev_len); later same-block uses are
            # ordinary reuses
            _, first_pos = np.unique(dictidx, return_index=True)
            isfirst = np.zeros(dictidx.size, dtype=bool)
            isfirst[first_pos] = True
            newmask = (dictidx >= prev_len) & isfirst
            # reuses are recency-coded (v3): dist = dict size at the use
            # minus 1 minus idx — overlapping reads reuse RECENT entries,
            # so distances cluster near 0 (measured ~25% under absolute
            # indices on the E.coli corpus)
            size_at = prev_len + np.cumsum(newmask)
            dist = (size_at - 1 - dictidx)[~newmask]
            head = bytearray()
            varint.encode_one(prev_len, head)

            def _dictidx_payload(head=bytes(head), newmask=newmask, dist=dist):
                return (
                    head
                    + frames.frame(np.packbits(newmask).tobytes())
                    + frames.frame(varint.encode_array(dist.astype(np.uint64)),
                                   try_o1=True)
                )

            add(S_DICTIDX, _dictidx_payload)
            # nevt/errpos varints have strong order-1 structure (event
            # counts correlate within a read; gap bytes cluster) — the o1
            # coder measured ~8%/2% under zlib/rANS on the E.coli corpus
            nevt_chunks = self.nevt
            add(S_NEVT,
                lambda c=nevt_chunks: varint.encode_array(np.concatenate(c)),
                try_o1=True)
        if self.errpos:
            ep = np.concatenate(self.errpos)
            if ep.size:
                add(S_ERRPOS, lambda e=ep: varint.encode_array(e), try_o1=True)
        # streams 7/8 carry 2-bit values (base code / candidate rank):
        # packed 4 per byte (FORMAT.md §6), little-endian within the byte
        add(S_ERRNT, lambda b=self.errnt: _pack_2bit(b))
        add(S_BIF, lambda b=self.bif: _pack_2bit(b))
        add(S_RAWSEQ, bytes(self.rawseq))
        excn = [p.size for p in prep.exc_pos if p is not None]
        if excn:
            gaps = []
            byts = []
            for p, b in zip(prep.exc_pos, prep.exc_byte):
                if p is None:
                    continue
                g = np.empty_like(p)
                g[0] = p[0]
                g[1:] = p[1:] - p[:-1] - 1
                gaps.append(g.astype(np.uint64))
                byts.append(b.tobytes())
            add(S_EXCN, varint.encode_array(np.asarray(excn, dtype=np.uint64)))
            add(S_EXCGAP, varint.encode_array(np.concatenate(gaps)))
            add(S_EXCBYTE, b"".join(byts))
        if self.meta.header_mode:
            from leon_tpu.codecs import headers as hcodec

            add(S_HEADERS, lambda h=block.headers: hcodec.encode(h))
        if self.meta.qual_mode and self.qual_arr is not None:
            # biggest stream: position-aware q1 model vs order-1 vs zlib
            # (static rANS skipped — it never wins on quality data and the
            # extra full encode costs real time at scale)
            add(S_QUALS, self.qual_arr.tobytes(), try_rans=False,
                try_o1=True, lens=self._qual_lens)
        self.qual_arr = None
        is_arr = isinstance(block, bank.ArrayBlock)
        if block.fmt == bank.FASTQ:
            plus = bytearray()
            if is_arr:
                pl = block.plus_lens
                if pl is not None and (pl > 0).any():
                    pcat = block.plus_cat or b""
                    ends = np.cumsum(pl)
                    for i in np.flatnonzero(pl > 0):
                        varint.encode_one(int(pl[i]), plus)
                        plus += pcat[int(ends[i] - pl[i]) : int(ends[i])]
            else:
                for p in block.pluses:
                    if p:
                        varint.encode_one(len(p), plus)
                        plus += p
            add(S_PLUSLINE, bytes(plus))
            # wrapped records: per-read line structure (stream 14 for the
            # sequence lines, 17 for the quality lines when they differ)
            if not is_arr and block.line_lens is not None:
                add(S_FASTALINES, _encode_line_struct(block.line_lens))
                if block.qual_line_lens != block.line_lens:
                    add(S_QUALLINES, _encode_line_struct(block.qual_line_lens))
        elif is_arr:
            # vals per read: nlines, then the first nlines-1 line lengths
            # (vectorized scatter from the flat linelens array)
            nl = block.nlines.astype(np.int64)
            ll = block.linelens.astype(np.int64)
            counts = np.maximum(nl - 1, 0)
            per = 1 + counts
            vals = np.zeros(int(per.sum()), dtype=np.uint64)
            starts = np.cumsum(per) - per
            vals[starts] = nl.astype(np.uint64)
            if counts.any():
                grp = np.cumsum(nl) - nl
                vals[_ragged_dst(starts + 1, counts)] = ll[_ragged_dst(grp, counts)].astype(np.uint64)
            add(S_FASTALINES, varint.encode_array(vals))
        else:
            add(S_FASTALINES, _encode_line_struct(block.line_lens))

        return todo


def assemble_block(todo: list, n_reads: int) -> tuple[bytes, dict[int, int]]:
    """Entropy-frame a block's resolved streams and assemble the payload.

    Pure function of `todo` — safe on any thread. Frames the streams one
    after another: the pipeline frames whole BLOCKS in parallel on its
    -nb-cores pool (reference: Dispatcher threads, README.md:47-48). zlib
    and the native coders release the GIL, and frame() still runs its
    method trials concurrently for multi-MB payloads."""
    todo = [(sid, d() if callable(d) else d, kw) for sid, d, kw in todo]
    todo = [t for t in todo if t[1]]
    framed = [frames.frame(d, **kw) for _, d, kw in todo]
    sizes = {sid: len(fr) for (sid, _, _), fr in zip(todo, framed)}
    out = bytearray()
    varint.encode_one(n_reads, out)
    varint.encode_one(len(todo), out)
    for (sid, _, _), fr in zip(todo, framed):
        out.append(sid)
        out += fr
    return bytes(out), sizes


@dataclass
class DecodedBlock:
    """Parsed block streams, segment-resolved, ready for device re-walk."""

    n_reads: int
    lengths: np.ndarray       # (n_reads,) int64
    seg_read: np.ndarray      # (n_segs,)
    seg_off: np.ndarray
    seg_len: np.ndarray
    anchored: np.ndarray      # (n_segs,) bool
    orient: np.ndarray        # (n_segs,) bool
    hasexc: np.ndarray        # (n_reads,)
    hasplus: np.ndarray       # (n_reads,)
    apos: np.ndarray          # (n_segs,) int64
    dictidx: np.ndarray       # per anchored segment
    nerr_r: np.ndarray        # (n_segs,)
    nbif_r: np.ndarray
    nerr_l: np.ndarray
    nbif_l: np.ndarray
    # flat event streams (seg-major, right-then-left per segment) plus
    # per-segment exclusive base offsets — the decoder gathers padded
    # (B, ME) planes from these without any per-segment Python loop
    errgaps: np.ndarray       # (n_err,) int64
    errnts: np.ndarray        # (n_err,) uint8
    bifs: np.ndarray          # (n_bif,) uint8
    err_base: np.ndarray      # (n_segs,) offset of segment's right-err run
    bif_base: np.ndarray
    rawseq: bytes
    # exceptions, flat (vectorized decode): entry j is byte exc_bytes[j] at
    # position exc_rel[j] of read exc_read[j]
    exc_read: np.ndarray
    exc_rel: np.ndarray
    exc_bytes: np.ndarray
    headers_payload: Optional[bytes]
    quals_concat: Optional[bytes]
    plus_lens: np.ndarray          # (n_reads,) text length after '+'
    plus_cat: bytes                # concatenated '+' texts
    fasta_nlines: Optional[np.ndarray]    # seq lines per read (FASTA; wrapped FASTQ)
    fasta_linelens: Optional[np.ndarray]  # all seq line lengths, flat
    qual_nlines: Optional[np.ndarray] = None    # wrapped FASTQ qual lines
    qual_linelens: Optional[np.ndarray] = None


def _decode_line_struct(payload: bytes, n_reads: int, lengths: np.ndarray):
    """Inverse of _encode_line_struct: (nlines (n,), linelens flat).
    Per read: nlines, then nlines-1 explicit lens (last is derived from
    the read's total length). The count positions are a sequential scan
    (cheap int loop); the len extraction + last-line derivation is
    vectorized."""
    vals = varint.decode_array(payload).astype(np.int64)
    nl_arr = np.empty(n_reads, dtype=np.int64)
    cpos = np.empty(n_reads, dtype=np.int64)
    if n_reads and vals.size >= n_reads and (vals[:n_reads] == 1).all() \
            and vals.size == n_reads:
        # single-line reads (the FASTA norm): stride is exactly 1
        nl_arr.fill(1)
        cpos[:] = np.arange(n_reads)
    else:
        from leon_tpu import native

        lib = native.get_lib()
        if lib is not None and hasattr(lib, "leon_linestruct_scan"):
            vals_c = np.ascontiguousarray(vals)
            vp = lib.leon_linestruct_scan(vals_c.ctypes.data, vals_c.size,
                                          n_reads, nl_arr.ctypes.data,
                                          cpos.ctypes.data)
            if vp < 0:
                raise ValueError("fastalines stream truncated")
        else:  # pure-python fallback (no toolchain)
            vp = 0
            for i in range(n_reads):
                cpos[i] = vp
                nl = int(vals[vp])
                nl_arr[i] = nl
                vp += 1 + (nl - 1 if nl > 1 else 0)
    given_counts = np.maximum(nl_arr - 1, 0)
    given = vals[_ragged_dst(cpos + 1, given_counts)] if given_counts.any() else np.zeros(0, np.int64)
    sums = np.zeros(n_reads, dtype=np.int64)
    np.add.at(sums, np.repeat(np.arange(n_reads), given_counts), given)
    last = lengths - sums
    total_lines = int(nl_arr.sum())
    linelens = np.empty(total_lines, dtype=np.int64)
    grp_start = np.cumsum(nl_arr) - nl_arr
    linelens[_ragged_dst(grp_start, given_counts)] = given
    has = nl_arr >= 1
    linelens[grp_start[has] + nl_arr[has] - 1] = last[has]
    return nl_arr, linelens


def parse_block(payload: bytes, meta) -> DecodedBlock:
    n_reads, pos = varint.decode_one(payload, 0)
    n_streams, pos = varint.decode_one(payload, pos)
    sdata: dict[int, bytes] = {}
    qual_frame: Optional[bytes] = None
    for _ in range(n_streams):
        sid = payload[pos]
        if sid == S_QUALS:
            # defer: the method-4 coder needs the read lengths, decoded
            # from the readlen stream below
            qual_frame, pos = frames.skip_frame(payload, pos + 1)
        else:
            data, pos = frames.unframe(payload, pos + 1)
            sdata[sid] = data

    deltas = varint.unzigzag(varint.decode_array(sdata.get(S_READLEN, b""), n_reads))
    lengths = np.cumsum(deltas)
    if qual_frame is not None:
        sdata[S_QUALS], _ = frames.unframe(qual_frame, 0, lens=lengths)
    seg_read, seg_off, seg_len = segment_table(lengths, meta.seglen)
    n_segs = seg_read.shape[0]

    flags = np.frombuffer(sdata.get(S_FLAGS, b"\x00" * n_segs), dtype=np.uint8)
    if flags.shape[0] != n_segs:
        raise ValueError(f"flags stream has {flags.shape[0]} entries, expected {n_segs}")
    anchored = (flags & F_ANCHORED) != 0
    orient = (flags & F_ORIENT) != 0
    first_seg = seg_off == 0
    hasexc = np.zeros(n_reads, dtype=bool)
    hasplus = np.zeros(n_reads, dtype=bool)
    hasexc[seg_read[first_seg]] = ((flags & F_HASEXC) != 0)[first_seg]
    hasplus[seg_read[first_seg]] = ((flags & F_HASPLUS) != 0)[first_seg]

    n_anch = int(anchored.sum())
    apos_a = varint.decode_array(sdata.get(S_ANCHORPOS, b""), n_anch).astype(np.int64)
    # stream 4: varint(prev_len) + frame(new/reuse bitmask) + frame(reuse
    # varints). A NEW anchor's index is implicit — the i-th new anchor in
    # the block is prev_len + i (global first-use order, FORMAT.md §5) —
    # so only reused indices are coded. prev_len is stored so blocks stay
    # independently decodable (FORMAT.md §6).
    dictidx = np.zeros(0, dtype=np.int64)
    if n_anch:
        dbuf = sdata.get(S_DICTIDX, b"")
        prev_len, dp = varint.decode_one(dbuf, 0)
        nm_bytes, dp = frames.unframe(dbuf, dp)
        newmask = np.unpackbits(
            np.frombuffer(nm_bytes, dtype=np.uint8), count=n_anch
        ).astype(bool)
        reuse_raw, dp = frames.unframe(dbuf, dp)
        n_new = int(newmask.sum())
        dist = varint.decode_array(reuse_raw, n_anch - n_new).astype(np.int64)
        dictidx = np.empty(n_anch, dtype=np.int64)
        dictidx[newmask] = prev_len + np.arange(n_new, dtype=np.int64)
        size_at = prev_len + np.cumsum(newmask)
        dictidx[~newmask] = size_at[~newmask] - 1 - dist
    nevt = varint.decode_array(sdata.get(S_NEVT, b""), 4 * n_anch).astype(np.int64).reshape(-1, 4)

    apos = np.zeros(n_segs, dtype=np.int64)
    apos[anchored] = apos_a
    nerr_r = np.zeros(n_segs, dtype=np.int64)
    nbif_r = np.zeros(n_segs, dtype=np.int64)
    nerr_l = np.zeros(n_segs, dtype=np.int64)
    nbif_l = np.zeros(n_segs, dtype=np.int64)
    if n_anch:
        nerr_r[anchored] = nevt[:, 0]
        nbif_r[anchored] = nevt[:, 1]
        nerr_l[anchored] = nevt[:, 2]
        nbif_l[anchored] = nevt[:, 3]

    n_err = int((nerr_r + nerr_l).sum())
    n_bif = int((nbif_r + nbif_l).sum())
    errgaps = varint.decode_array(sdata.get(S_ERRPOS, b""), n_err).astype(np.int64)
    errnts = _unpack_2bit(sdata.get(S_ERRNT, b""), n_err)
    bifs = _unpack_2bit(sdata.get(S_BIF, b""), n_bif)
    if errnts.size != n_err or bifs.size != n_bif:
        raise ValueError("event stream count mismatch")

    err_tot = nerr_r + nerr_l
    bif_tot = nbif_r + nbif_l
    err_base = np.cumsum(err_tot) - err_tot
    bif_base = np.cumsum(bif_tot) - bif_tot

    if hasexc.any():
        nexc = varint.decode_array(sdata[S_EXCN], int(hasexc.sum())).astype(np.int64)
        gaps = varint.decode_array(sdata[S_EXCGAP], int(nexc.sum())).astype(np.int64)
        exc_bytes = np.frombuffer(sdata[S_EXCBYTE], dtype=np.uint8)
        exc_read = np.repeat(np.flatnonzero(hasexc), nexc)
        # segmented cumsum of (gap + 1) - 1 = within-read positions
        steps = gaps + 1
        cg = np.cumsum(steps)
        grp_end = np.cumsum(nexc)
        base = np.repeat(np.concatenate(([0], cg[grp_end[:-1] - 1])), nexc)
        exc_rel = cg - base - 1
    else:
        exc_read = np.zeros(0, np.int64)
        exc_rel = np.zeros(0, np.int64)
        exc_bytes = np.zeros(0, np.uint8)

    # '+'-line texts: rare (hasplus flags); flat (plus_lens, plus_cat) arrays
    plus_lens = np.zeros(n_reads, dtype=np.int64)
    plus_parts: list[bytes] = []
    if hasplus.any():
        buf = sdata[S_PLUSLINE]
        ppos = 0
        for i in np.flatnonzero(hasplus):
            ln, ppos = varint.decode_one(buf, ppos)
            plus_lens[i] = ln
            plus_parts.append(buf[ppos : ppos + ln])
            ppos += ln
    plus_cat = b"".join(plus_parts)

    fasta_nlines = None
    fasta_linelens = None
    qual_nlines = None
    qual_linelens = None
    if meta.fmt == bank.FASTA:
        fasta_nlines, fasta_linelens = _decode_line_struct(
            sdata.get(S_FASTALINES, b""), n_reads, lengths
        )
    elif S_FASTALINES in sdata:  # wrapped FASTQ (rare)
        fasta_nlines, fasta_linelens = _decode_line_struct(
            sdata[S_FASTALINES], n_reads, lengths
        )
        if S_QUALLINES in sdata:
            qual_nlines, qual_linelens = _decode_line_struct(
                sdata[S_QUALLINES], n_reads, lengths
            )
        else:
            qual_nlines, qual_linelens = fasta_nlines, fasta_linelens

    return DecodedBlock(
        n_reads=n_reads, lengths=lengths,
        seg_read=seg_read, seg_off=seg_off, seg_len=seg_len,
        anchored=anchored, orient=orient,
        hasexc=hasexc, hasplus=hasplus, apos=apos, dictidx=dictidx,
        nerr_r=nerr_r, nbif_r=nbif_r, nerr_l=nerr_l, nbif_l=nbif_l,
        errgaps=errgaps, errnts=errnts, bifs=bifs,
        err_base=err_base, bif_base=bif_base,
        rawseq=sdata.get(S_RAWSEQ, b""),
        exc_read=exc_read, exc_rel=exc_rel, exc_bytes=exc_bytes,
        headers_payload=sdata.get(S_HEADERS),
        quals_concat=sdata.get(S_QUALS),
        plus_lens=plus_lens, plus_cat=plus_cat,
        fasta_nlines=fasta_nlines, fasta_linelens=fasta_linelens,
        qual_nlines=qual_nlines, qual_linelens=qual_linelens,
    )
