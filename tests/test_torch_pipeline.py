"""Port parity, whole slice: leon_tpu_torch compress writes the archive
leon_tpu writes, byte for byte, and each package decodes the other's
archive to the same bytes. The port runs its plain (CPU) kernel paths with
a different lane count than the reference (archives are batch-invariant)."""

import numpy as np
import pytest

from leon_tpu import pipeline as ref_pipeline
from leon_tpu.config import LeonConfig
from leon_tpu_torch import pipeline
from test_roundtrip import BASES, sim_seq, write_fasta, write_fastq

REF_KW = dict(batch_reads=64, reads_per_block=100, mesh_devices=1)
PORT_KW = dict(batch_reads=40, reads_per_block=100)


def _fastq(path, rng, contig):
    seqs = [sim_seq(rng, contig) for _ in range(150)] + [b"NNNN", b"", b"ACG"]
    write_fastq(path, seqs, rng)


def _fasta(path, rng, contig):
    seqs = [sim_seq(rng, contig, lmin=150, lmax=300) for _ in range(60)]
    seqs += [b"ACGT", b"A" * 31, b"N" * 50, b"", b"ACGTNNNNACGTACGTACGTNacgtRYKM" * 3,
             BASES[rng.integers(0, 4, 31)].tobytes()]
    write_fasta(path, seqs, wrap=70)


CASES = {
    "fastq_lossy": (_fastq, {}),
    "fastq_lossless": (_fastq, dict(lossless=True)),
    "fastq_noheader_noqual": (_fastq, dict(noheader=True, noqual=True)),
    "fasta_multiline": (_fasta, {}),
    "fasta_bloom_section": (_fasta, dict(unitig_sections=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_archive_and_cross_decode_match_reference(tmp_path, case):
    make, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 100)
    contig = rng.integers(0, 4, 500, dtype=np.uint8)
    src = tmp_path / ("in.fastq" if make is _fastq else "in.fasta")
    make(src, rng, contig)
    ref_cfg = LeonConfig(**REF_KW, **kw)
    port_cfg = LeonConfig(**PORT_KW, **kw)
    ref_arc, port_arc = str(tmp_path / "ref.leon"), str(tmp_path / "port.leon")

    rst = ref_pipeline.compress(str(src), ref_arc, cfg=ref_cfg)
    pst = pipeline.compress(str(src), port_arc, cfg=port_cfg, device="cpu")
    assert open(port_arc, "rb").read() == open(ref_arc, "rb").read()
    for key in ("n_reads", "n_anchored", "n_solid_kmers", "abundance", "unitig_bytes",
                "stream_bytes"):
        assert pst[key] == rst[key], key
    assert rst["n_anchored"] > 0
    # both Bloom-set sections: BLOOM (the bitset) and UNITIGS (rebuilt at decode)
    assert (pst["unitig_bytes"] == 0) == (case == "fasta_bloom_section")

    outs = {}
    for who, arc in (("ref", ref_arc), ("port", port_arc)):
        outs[("ref", who)] = ref_pipeline.decompress(
            arc, str(tmp_path / f"ref_dec_{who}"), cfg=ref_cfg)["output"]
        outs[("port", who)] = pipeline.decompress(
            arc, str(tmp_path / f"port_dec_{who}"), cfg=port_cfg, device="cpu")["output"]
    data = {key: open(p, "rb").read() for key, p in outs.items()}
    assert len(set(data.values())) == 1
    lossless = case in ("fastq_lossless", "fasta_multiline", "fasta_bloom_section")
    if lossless:
        assert data[("port", "ref")] == open(src, "rb").read()


def test_unitig_build_failure_falls_back_to_bloom(tmp_path, monkeypatch, capsys):
    from leon_tpu_torch.ops import unitig

    def boom(*a, **kw):
        raise MemoryError("no room for the unitig graph")

    monkeypatch.setattr(unitig, "build_np_payload", boom)
    rng = np.random.default_rng(7)
    src = tmp_path / "in.fasta"
    _fasta(src, rng, rng.integers(0, 4, 500, dtype=np.uint8))
    cfg = LeonConfig(**PORT_KW)
    st = pipeline.compress(str(src), str(tmp_path / "a.leon"), cfg=cfg, device="cpu")
    assert st["unitig_bytes"] == 0 and st["n_anchored"] > 0
    assert "MemoryError: no room" in capsys.readouterr().err
    out = pipeline.decompress(str(tmp_path / "a.leon"), str(tmp_path / "a.out"), cfg=cfg,
                              device="cpu")["output"]
    assert open(out, "rb").read() == open(src, "rb").read()
