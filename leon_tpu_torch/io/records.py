"""Decompression record writer (a copy of leon_tpu/io/bank.py:848-970).

Copied because the reference's write_records_arrays imports
leon_tpu.codecs.blocks, which imports jax when it loads; here ragged_dst
comes from the port's blocks. Must stay identical in behaviour.
"""

from __future__ import annotations

from typing import Optional

from leon_tpu.io.bank import FASTQ


def _scatter_lines(buf, area_start, nl, ll, src, ragged_dst) -> None:
    """Scatter per-read wrapped lines + newlines into buf. area_start (n,)
    is each read's line-area start; nl (n,) lines per read; ll flat line
    lengths in read order; src the flat payload bytes."""
    import numpy as np

    from leon_tpu.utils import ragged

    n = area_start.shape[0]
    if not int(nl.sum()):
        return
    line_read = np.repeat(np.arange(n), nl)
    steps = ll + 1
    cs = np.cumsum(steps)
    grp_start = np.cumsum(nl) - nl
    base = np.where(grp_start > 0, cs[np.maximum(grp_start - 1, 0)], 0)
    within_start = cs - np.repeat(base, nl) - steps
    line_start = area_start[line_read] + within_start
    ragged.scatter(buf, line_start, ll, src)
    buf[line_start + ll] = 10


def write_records_arrays(
    out,
    fmt: int,
    hcat: bytes,
    hlens,
    seq_flat,
    lengths,
    qcat: Optional[bytes] = None,
    plus_lens=None,
    plus_cat: bytes = b"",
    fasta_nlines=None,
    fasta_linelens=None,
    qual_nlines=None,
    qual_linelens=None,
) -> None:
    """Fully vectorized record assembly (the decompress hot path): builds
    the block's output bytes with numpy ragged scatters — no per-read
    Python. seq_flat is the reads' ASCII bases concatenated in read order;
    qcat likewise (None = synthesize 'I' quality, the -noqual rule).

    FASTA line structure comes from (fasta_nlines, fasta_linelens); FASTQ
    '+' texts from (plus_lens, plus_cat). Every record ends with a newline
    (the caller trims the final one via finalize_file when META says so).
    """
    import numpy as np

    from leon_tpu_torch.codecs.blocks import ragged_dst

    n = int(lengths.shape[0])
    if n == 0:
        return
    lengths = lengths.astype(np.int64)
    hlens = np.asarray(hlens, dtype=np.int64)
    hcat_a = np.frombuffer(hcat, dtype=np.uint8)
    seq_a = np.asarray(seq_flat, dtype=np.uint8)

    if fmt == FASTQ and fasta_nlines is not None:
        from leon_tpu.utils import ragged

        # wrapped FASTQ (rare): explicit seq/qual line structure
        snl = fasta_nlines.astype(np.int64)
        sll = fasta_linelens.astype(np.int64)
        qnl = qual_nlines.astype(np.int64)
        qll = qual_linelens.astype(np.int64)
        pl = np.zeros(n, np.int64) if plus_lens is None else plus_lens.astype(np.int64)
        rec = 1 + hlens + 1 + lengths + snl + 1 + pl + 1 + lengths + qnl
        off = np.cumsum(rec) - rec
        buf = np.empty(int(rec.sum()), dtype=np.uint8)
        buf[off] = ord("@")
        ragged.scatter(buf, off + 1, hlens, hcat_a)
        p1 = off + 1 + hlens
        buf[p1] = 10
        _scatter_lines(buf, p1 + 1, snl, sll, seq_a, ragged_dst)
        p2 = p1 + 1 + lengths + snl
        buf[p2] = ord("+")
        if pl.any():
            ragged.scatter(buf, p2 + 1, pl, np.frombuffer(plus_cat, dtype=np.uint8))
        p3 = p2 + 1 + pl
        buf[p3] = 10
        qsrc = (np.full(int(lengths.sum()), ord("I"), np.uint8) if qcat is None
                else np.frombuffer(qcat, dtype=np.uint8))
        _scatter_lines(buf, p3 + 1, qnl, qll, qsrc, ragged_dst)
    elif fmt == FASTQ:
        from leon_tpu.utils import ragged

        pl = np.zeros(n, np.int64) if plus_lens is None else plus_lens.astype(np.int64)
        rec = hlens + 2 * lengths + pl + 6
        off = np.cumsum(rec) - rec
        buf = np.empty(int(rec.sum()), dtype=np.uint8)
        buf[off] = ord("@")
        ragged.scatter(buf, off + 1, hlens, hcat_a)
        p1 = off + 1 + hlens
        buf[p1] = 10
        ragged.scatter(buf, p1 + 1, lengths, seq_a)
        p2 = p1 + 1 + lengths
        buf[p2] = 10
        buf[p2 + 1] = ord("+")
        if pl.any():
            ragged.scatter(buf, p2 + 2, pl, np.frombuffer(plus_cat, dtype=np.uint8))
        p3 = p2 + 2 + pl
        buf[p3] = 10
        if qcat is None:
            ragged.fill(buf, p3 + 1, lengths, ord("I"))
        else:
            ragged.scatter(buf, p3 + 1, lengths, np.frombuffer(qcat, dtype=np.uint8))
        p4 = p3 + 1 + lengths
        buf[p4] = 10
    else:
        nl = fasta_nlines.astype(np.int64)
        ll = fasta_linelens.astype(np.int64)
        rec = 1 + hlens + 1 + lengths + nl
        off = np.cumsum(rec) - rec
        buf = np.empty(int(rec.sum()), dtype=np.uint8)
        from leon_tpu.utils import ragged

        buf[off] = ord(">")
        ragged.scatter(buf, off + 1, hlens, hcat_a)
        p1 = off + 1 + hlens
        buf[p1] = 10
        _scatter_lines(buf, p1 + 1, nl, ll, seq_a, ragged_dst)
    out.write(buf.tobytes())
