"""The port's compress across processes (leon_tpu_torch.parallel.distributed,
torch.distributed over gloo) writes the archive leon_tpu's one-process
pipeline.compress writes, byte for byte: with one process, and with two
processes on the CPU (subprocesses that import only the port: jax,
leon_tpu and bench are blocked in them), each rendezvousing through a file
under the test's tmp_path, so parallel test workers never share a port."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from leon_tpu import pipeline as ref_pipeline
from leon_tpu.config import LeonConfig as RefConfig
from leon_tpu_torch.config import LeonConfig
from leon_tpu_torch.parallel import distributed
from test_roundtrip import sim_seq, write_fasta, write_fastq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(batch_reads=64, reads_per_block=60)

WORKER = textwrap.dedent("""
    import json, sys
    for name in ("jax", "leon_tpu", "bench"):
        sys.modules[name] = None  # any import of them now raises ImportError
    root, rank, nproc, pg, src, out, kw = sys.argv[1:8]
    sys.path.insert(0, root)
    import torch
    torch.set_num_threads(1)
    from leon_tpu_torch.config import LeonConfig
    from leon_tpu_torch.parallel import distributed
    distributed.initialize("file://" + pg, int(nproc), int(rank))
    st = distributed.compress_distributed(src, out, cfg=LeonConfig(**json.loads(kw)),
                                          device="cpu")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    loaded = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in ("jax", "leon_tpu", "bench")]
    assert not loaded, loaded
    print("WORKER_OK", json.dumps(st))
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fasta(path, rng):
    """250 reads of 60-120 bp from a 900-base contig (tests/test_distributed.py)."""
    contig = rng.integers(0, 4, 900, dtype=np.uint8)
    write_fasta(path, [sim_seq(rng, contig, lmin=60, lmax=120, err=0.0) for _ in range(250)])


def _fastq(path, rng):
    """200 FASTQ reads of 100 bp from a 1,500-base contig, 1% substitutions,
    with short and empty records."""
    contig = rng.integers(0, 4, 1500, dtype=np.uint8)
    seqs = [sim_seq(rng, contig, lmin=100, lmax=100) for _ in range(200)]
    write_fastq(path, seqs + [b"NNNN", b"", b"ACG"], rng)


# name -> (corpus, config fields)
CASES = {
    "fasta_k31": (_fasta, {}),
    "fastq_lossy_k31": (_fastq, {}),
    "fastq_k63": (_fastq, dict(kmer_size=63, lossless=True)),
}


def _reference(tmp_path, case: str):
    make, kw = CASES[case]
    src = str(tmp_path / ("in.fasta" if make is _fasta else "in.fastq"))
    make(src, np.random.default_rng(sorted(CASES).index(case) + 40))
    ref = str(tmp_path / "ref.leon")
    ref_pipeline.compress(src, ref, cfg=RefConfig(**KW, **kw, mesh_devices=1))
    return src, open(ref, "rb").read(), kw


def test_one_process_equals_reference_pipeline(tmp_path):
    src, want, kw = _reference(tmp_path, "fasta_k31")
    out = str(tmp_path / "one.leon")
    st = distributed.compress_distributed(src, out, cfg=LeonConfig(**KW, **kw), device="cpu")
    assert open(out, "rb").read() == want
    assert st["n_processes"] == 1 and st["output_bytes"] == len(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_processes_write_reference_archive(tmp_path, case):
    src, want, kw = _reference(tmp_path, case)
    out = str(tmp_path / "two.leon")
    pg = str(tmp_path / "pg")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, ROOT, str(r), "2", pg, src, out,
                               json.dumps(dict(KW, **kw))],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    stats = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so[-2000:]}\n{se[-3000:]}"
        line = [ln for ln in so.splitlines() if ln.startswith("WORKER_OK")][0]
        stats.append(json.loads(line.split(None, 1)[1]))
    assert open(out, "rb").read() == want
    assert [s["process"] for s in stats] == [0, 1]
    assert all(s["n_processes"] == 2 and s["parse_sharded"] for s in stats)
    # the block payloads went through part files, each rank's own shard
    assert all(0 < s["traffic_bytes"]["fs_spill"] < len(want) for s in stats)
    assert not [f for f in os.listdir(tmp_path) if ".part" in f or ".runx." in f
                or ".solid." in f]


def test_exchange_helpers_one_process():
    """With one process every exchange is the identity; the run framings
    round-trip."""
    blob = bytes(range(256)) * 3
    assert distributed._allgather_bytes(blob) == [blob]
    np.testing.assert_array_equal(distributed._allgather_i64([3, 4]), [[3, 4]])
    rng = np.random.default_rng(3)
    uniq = rng.integers(0, 1 << 32, (17, 3), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(1, 1000, 17).astype(np.int32)
    u, c = distributed._unpack_run(distributed._pack_run(uniq, counts))
    np.testing.assert_array_equal(u, uniq)
    np.testing.assert_array_equal(c, counts)
    lists = {0: [b"abcd", b"efgh"], 5: []}
    assert distributed._unpack_keylists(distributed._pack_keylists(lists, 4), 4) == lists
    pl = {2: (b"xyz", 7), 0: (b"", 0)}
    assert distributed._unpack_payloads(distributed._pack_payloads(pl)) == pl
