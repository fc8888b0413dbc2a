"""Port parity, whole slice: leon_tpu_torch compress writes the archive
leon_tpu writes, byte for byte, and each package decodes the other's
archive to the same bytes. The port runs its plain (CPU) kernel paths with
a different lane count than the reference (archives are batch-invariant)."""

import numpy as np
import pytest
import torch

from leon_tpu import pipeline as ref_pipeline
from leon_tpu.config import LeonConfig
from leon_tpu_torch import pipeline
from test_roundtrip import BASES, sim_seq, write_fasta, write_fastq

REF_KW = dict(batch_reads=64, reads_per_block=100, mesh_devices=1)
PORT_KW = dict(batch_reads=40, reads_per_block=100)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops:
    the test workers share the cores, and eight threads each oversubscribe
    them (see tests/test_torch_graph.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


DEVICE_UNITIGS = dict(unitig_device_max_kmers=1 << 30)


def _compress_three(tmp_path, src, port_kw=PORT_KW, **kw):
    """(reference device-build, port device-build, port default) archives
    and the two device-build stats dicts."""
    arcs = [str(tmp_path / n) for n in ("ref_dev.leon", "port_dev.leon", "port_host.leon")]
    rst = ref_pipeline.compress(str(src), arcs[0],
                                cfg=LeonConfig(**REF_KW, **DEVICE_UNITIGS, **kw))
    pst = pipeline.compress(str(src), arcs[1], cfg=LeonConfig(**port_kw, **DEVICE_UNITIGS, **kw),
                            device="cpu")
    pipeline.compress(str(src), arcs[2], cfg=LeonConfig(**port_kw, **kw), device="cpu")
    data = [open(a, "rb").read() for a in arcs]
    assert data[1] == data[0] and data[1] == data[2]
    for st in (rst, pst):  # the device path ran, not the host thread
        assert "count.unitig_dispatch" in st["span_s"] and "tail.unitig_drain" in st["span_s"]
        assert "unitig.thread_build" not in st["span_s"]
    return arcs, rst, pst


@pytest.mark.parametrize("case", ["fastq_noheader_noqual", "fasta_multiline"])
def test_device_unitig_build_matches_reference(tmp_path, case):
    """unitig_device_max_kmers > 0 takes the device build (K5-K8's plain
    versions here): the archive is leon_tpu's with the same config, and the
    port's default (host builder) archive; each package decodes it."""
    make, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 200)
    src = tmp_path / ("in.fastq" if make is _fastq else "in.fasta")
    make(src, rng, rng.integers(0, 4, 500, dtype=np.uint8))
    arcs, rst, pst = _compress_three(tmp_path, src, **kw)
    assert pst["unitig_bytes"] > 0 and pst["unitig_bytes"] == rst["unitig_bytes"]
    outs = [ref_pipeline.decompress(arcs[1], str(tmp_path / "ref.out"),
                                    cfg=LeonConfig(**REF_KW, **kw))["output"],
            pipeline.decompress(arcs[0], str(tmp_path / "port.out"),
                                cfg=LeonConfig(**PORT_KW, **kw), device="cpu")["output"]]
    assert open(outs[0], "rb").read() == open(outs[1], "rb").read()
    if case == "fasta_multiline":
        assert open(outs[1], "rb").read() == open(src, "rb").read()


def test_device_unitig_overflow_writes_bloom(tmp_path, monkeypatch):
    """At k = 9 and abundance 2, 1,500 random 100 bp reads (each twice)
    give ~85k solid k-mers in ~83k chains (the graph branches almost
    everywhere): the
    chain capacity overflows twice, the device build gives None and the
    archive carries BLOOM, as leon_tpu's and the host builder's do."""
    from leon_tpu_torch.ops import unitig

    drained = []
    real = unitig.drain_build

    def spy(infl):
        drained.append(real(infl))
        return drained[-1]

    monkeypatch.setattr(unitig, "drain_build", spy)
    rng = np.random.default_rng(36)
    reads = [BASES[rng.integers(0, 4, 100)].tobytes() for _ in range(1500)]
    src = tmp_path / "dense.fasta"
    write_fasta(src, reads + reads)
    _arcs, rst, pst = _compress_three(tmp_path, src, dict(PORT_KW, batch_reads=4096),
                                     kmer_size=9, abundance=2)
    assert drained == [None]
    assert pst["unitig_bytes"] == 0 == rst["unitig_bytes"]


@pytest.mark.parametrize("flanked", [False, True])
def test_even_k_palindrome_archive_is_rejected(tmp_path, flanked):
    """A known fault of the reference, pinned in both packages (ROADMAP.md
    queue 3): at k = 16, AAAAAAAATTTTTTTT is its own reverse complement;
    it leaves a chain with no tail, so the device build's payload spells
    fewer k-mers than the solid run holds and each package's decoder
    rejects the archive. The two archives are equal, bare and flanked:
    with flanks, bases of two chains land on one position, and the port
    writes there the reference's last writer."""
    pal = b"A" * 10 + b"T" * 10 + b"A" * 10
    src = tmp_path / "pal.fasta"
    write_fasta(src, [b"CGTAGCATCG" + pal + b"GCTAGGCTAC" if flanked else pal] * 4)
    kw = dict(kmer_size=16, **DEVICE_UNITIGS)
    arcs = [str(tmp_path / n) for n in ("ref.leon", "port.leon")]
    rst = ref_pipeline.compress(str(src), arcs[0], cfg=LeonConfig(**REF_KW, **kw))
    pst = pipeline.compress(str(src), arcs[1], cfg=LeonConfig(**PORT_KW, **kw), device="cpu")
    assert pst["unitig_bytes"] == rst["unitig_bytes"] > 0
    assert open(arcs[0], "rb").read() == open(arcs[1], "rb").read()
    for arc in arcs:
        with pytest.raises(ValueError, match="solid-set size mismatch"):
            ref_pipeline.decompress(arc, arc + ".ref.out", cfg=LeonConfig(**REF_KW, **kw))
        with pytest.raises(ValueError, match="solid-set size mismatch"):
            pipeline.decompress(arc, arc + ".port.out", cfg=LeonConfig(**PORT_KW, **kw),
                                device="cpu")


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


@pytest.mark.parametrize("mesh", [2, 4])
def test_mesh_devices_above_one_raises(tmp_path, mesh):
    """A request for several cards raises NotImplementedError naming
    ROADMAP queue 1, item 11 at compress and at decompress, before any
    work, instead of running on one card; mesh_devices = 1 (REF_KW, the
    tests above) runs."""
    from leon_tpu_torch import LeonConfig as PortConfig

    rng = np.random.default_rng(mesh)
    src, arc = str(tmp_path / "r.fastq"), str(tmp_path / "r.leon")
    _fastq(src, rng, rng.integers(0, 4, 500, dtype=np.uint8))
    cfg = PortConfig(mesh_devices=mesh, **PORT_KW)
    with pytest.raises(NotImplementedError, match=r"mesh_devices=.*queue 1, item 11"):
        pipeline.compress(src, arc, cfg=cfg, device="cpu")
    pipeline.compress(src, arc, cfg=PortConfig(mesh_devices=1, **PORT_KW), device="cpu")
    with pytest.raises(NotImplementedError, match=r"mesh_devices=.*queue 1, item 11"):
        pipeline.decompress(arc, str(tmp_path / "out.fastq"), cfg=cfg, device="cpu")
