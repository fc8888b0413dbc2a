"""Inputs past one card's limits, held against leon_tpu on the CPU at
tolerance 0: stream mode (an input over stream_threshold_bytes is parsed
again for each pass and its chunks uploaded again), the host-spilled count
(merged runs past count_spill_rows move to host RAM; finalize merges them
on the host), checkpoint resume and profile_dir.

The reference's archives depend on neither stream mode nor a spill (below
an abundance cutoff of 256), so one reference archive per (k, unitig
builder) is made once and every port variant is compared with it
(tests/test_count_slab.py:78, tests/test_roundtrip.py:379). At k = 255 the
reference counts with count_spill_rows=1: the same archive, without
compiling its build_device for k = 255 (tests/test_torch_longk.py:383);
there both port builders are held against the reference's host builder,
whose archive its device build writes too (tests/test_torch_unitig_words.py
holds the two equal at k = 255), and whose programs for a solid set of a
new size take a minute to compile on the CPU.
Above 255 the spilled count's exact n_solid differs from the unspilled
count's clamped histogram, so that case has a reference archive of its own.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from leon_tpu import pipeline as ref_pipeline
from leon_tpu.config import LeonConfig as RefConfig
from leon_tpu.ops import bloom as ref_bloom
from leon_tpu.ops import count as ref_count
from leon_tpu.ops import kmer as ref_kmer
from leon_tpu_torch import kernels, pipeline, state
from leon_tpu_torch.config import LeonConfig
from leon_tpu_torch.ops import bloom, count
from test_roundtrip import BASES, sim_seq, write_fasta, write_fastq

KS = (31, 63, 255)
BUILDERS = {"host": 0, "device": 1 << 30}  # unitig_device_max_kmers
REF_KW = dict(batch_reads=64, reads_per_block=100, mesh_devices=1)
# lanes a chunk on the port's side: four or more chunks each, so the
# forced spill below merges and spills at least twice
PORT_BATCH = {31: 40, 63: 40, 255: 16}
# slabs of 512 k-mers (a chunk past that is a slab of its own), a merge at
# every second slab, and every merged run spilled
SPILL = dict(count_slab_kmers=512, count_spill_rows=128, count_merge_factor=1)
MODES = {"stream": dict(stream_threshold_bytes=1), "spill": SPILL,
         "both": dict(stream_threshold_bytes=1, **SPILL)}
SEED = 0x1234ABCD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small tensor ops
    (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(path, k: int, rng) -> None:
    """k <= 63: 150 FASTQ reads of 100 bp from a 1,500 bp contig with short
    and empty records; k = 255: 60 wrapped FASTA reads of 300 bp from a
    1,200 bp contig (0.2% substitutions, so that most 255-mers are solid)
    with short, all-N and empty ones."""
    if k <= 63:
        contig = rng.integers(0, 4, 1500, dtype=np.uint8)
        seqs = [sim_seq(rng, contig, lmin=100, lmax=100) for _ in range(150)]
        write_fastq(path, seqs + [b"NNNN", b"", b"ACG"], rng)
    else:
        contig = rng.integers(0, 4, 1200, dtype=np.uint8)
        seqs = [sim_seq(rng, contig, lmin=300, lmax=300, err=0.002) for _ in range(60)]
        write_fasta(path, seqs + [b"ACGT", b"A" * 255, b"N" * 50, b""], wrap=70)


def _kw(k: int, builder: str = "host") -> dict:
    kw = dict(kmer_size=k, unitig_device_max_kmers=BUILDERS[builder])
    if k <= 63:
        kw["lossless"] = True
    return kw


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The corpora (one file per k) and the reference's archives, each made
    once, on first use."""
    d = tmp_path_factory.mktemp("stream")
    srcs, archives = {}, {}
    for k in KS:
        srcs[k] = str(d / (f"in{k}.fastq" if k <= 63 else f"in{k}.fasta"))
        _corpus(srcs[k], k, np.random.default_rng(1500 + k))

    def ref_archive(k: int, builder: str) -> bytes:
        if k == 255:
            builder = "host"
        if (k, builder) not in archives:
            arc = str(d / f"ref_{k}_{builder}.leon")
            extra = dict(count_spill_rows=1) if k == 255 else {}
            ref_pipeline.compress(srcs[k], arc, cfg=RefConfig(**_kw(k, builder), **REF_KW, **extra))
            archives[k, builder] = open(arc, "rb").read()
        return archives[k, builder]

    return d, srcs, ref_archive


def _port(k: int, builder: str = "host", **kw) -> LeonConfig:
    return LeonConfig(**_kw(k, builder), batch_reads=PORT_BATCH[k], reads_per_block=100, **kw)


# ---------------------------------------------------------------------------
# The archives: stream mode, a forced spill, both
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("k", KS)
def test_archive_matches_reference(work, tmp_path, k, builder, mode):
    d, srcs, ref_archive = work
    arc = str(tmp_path / "port.leon")
    st = pipeline.compress(srcs[k], arc, cfg=_port(k, builder, **MODES[mode]), device="cpu")
    assert open(arc, "rb").read() == ref_archive(k, builder)
    assert st["stream_mode"] == (mode != "spill")
    if mode == "stream":
        assert st["count_spills"] == 0
    else:
        assert st["count_spills"] >= 2
    assert st["unitig_bytes"] > 0 and st["n_anchored"] > 0
    if mode == "both":  # the archive is the reference's: one round trip per (k, builder)
        out = pipeline.decompress(arc, str(tmp_path / "out"), cfg=_port(k), device="cpu")
        assert open(out["output"], "rb").read() == open(srcs[k], "rb").read()


HOT = {31: (100, 1), 63: (150, 1), 255: (300, 2)}  # read length, reads repeated 280 times


def _hot_corpus(path, k: int, rng) -> None:
    """Random reads, one read repeated 320 times (its k-mers solid at an
    abundance of 300) and reads repeated 280 times (counts in [255, 300):
    the unspilled count's clamped histogram counts them solid too, enough
    of them to change the Bloom filter's size)."""
    L, n_warm = HOT[k]
    contig = rng.integers(0, 4, 1200, dtype=np.uint8)
    seqs = [sim_seq(rng, contig, lmin=L, lmax=L) for _ in range(40)]
    for reps in [320] + [280] * n_warm:
        seqs += [BASES[rng.integers(0, 4, L)].tobytes()] * reps
    write_fasta(path, [seqs[i] for i in rng.permutation(len(seqs))])


@pytest.mark.parametrize("k", KS)
def test_spilled_count_pins_exact_solid_count_above_255(tmp_path, k):
    """abundance=300 with a forced spill and no UNITIGS section: the spilled
    count takes n_solid as counts >= cutoff (leon_tpu/ops/count.py:656-657),
    where the unspilled one reads the clamped histogram, and the archive is
    the spilled reference's. The hot read's L - k + 1 k-mers are the solid
    set; the warm reads' would join it in the clamped histogram, and the
    filter's size (24 bits a k-mer, the auto rule at a clamped coverage of
    255) tells the two apart."""
    src = str(tmp_path / "hot.fasta")
    _hot_corpus(src, k, np.random.default_rng(300 + k))
    kw = dict(kmer_size=k, abundance=300, unitig_sections=False, **SPILL)
    ref_arc, arc = str(tmp_path / "ref.leon"), str(tmp_path / "port.leon")
    rst = ref_pipeline.compress(src, ref_arc, cfg=RefConfig(**kw, **REF_KW))
    st = pipeline.compress(src, arc, cfg=LeonConfig(**kw, batch_reads=256, reads_per_block=100),
                           device="cpu")
    assert open(arc, "rb").read() == open(ref_arc, "rb").read()
    assert st["count_spills"] >= 2
    L, n_warm = HOT[k]
    exact = L - k + 1
    assert st["n_solid_kmers"] == rst["n_solid_kmers"] == exact
    assert st["bloom_bytes"] == 4 * bloom.choose_n_words(exact, 24.0)
    assert st["bloom_bytes"] < 4 * bloom.choose_n_words((1 + n_warm) * exact, 24.0)


@pytest.mark.parametrize("k", [31, 63])
def test_spill_decision_matches_reference_above_255(tmp_path, k):
    """The same corpus with a spill at 4,000 rows: the reference counts each
    run at its bucketed size (at least 4,096 rows, leon_tpu/ops/count.py:
    267), so it spills where exact sizes would not, and the port must spill
    with it (exact n_solid against the clamped histogram's: 70 against 140
    at k = 31, 88 against 176 at k = 63 when the two disagree)."""
    src = str(tmp_path / "hot.fasta")
    _hot_corpus(src, k, np.random.default_rng(300 + k))
    kw = dict(kmer_size=k, abundance=300, unitig_sections=False, count_slab_kmers=512,
              count_merge_factor=1, count_spill_rows=4000)
    ref_arc, arc = str(tmp_path / "ref.leon"), str(tmp_path / "port.leon")
    rst = ref_pipeline.compress(src, ref_arc, cfg=RefConfig(**kw, **REF_KW))
    st = pipeline.compress(src, arc, cfg=LeonConfig(**kw, batch_reads=256, reads_per_block=100),
                           device="cpu")
    assert open(arc, "rb").read() == open(ref_arc, "rb").read()
    assert st["count_spills"] >= 1
    assert st["n_solid_kmers"] == rst["n_solid_kmers"] == HOT[k][0] - k + 1


# ---------------------------------------------------------------------------
# The counter: a final merge that itself spills; the spilled Bloom build
# ---------------------------------------------------------------------------


def _counters(k: int, merge_factor: int = 1, spill_rows: int = 256):
    """The reference's DeviceCounter and the port's counter at k, with slabs
    of 512 k-mers."""
    ref = ref_count.DeviceCounter(k, slab_kmers=512, merge_factor=merge_factor,
                                  spill_rows=spill_rows)
    cls = count.DeviceCounter if k <= 31 else count.WordCounter
    return ref, cls(k, "cpu", slab_kmers=512, merge_factor=merge_factor, spill_rows=spill_rows)


def _feed(ref, port, seqs: np.ndarray, lens: np.ndarray, L: int) -> None:
    """One chunk of reads (B, L) into both counters."""
    canon, _, valid = ref_kmer.kmer_scan(seqs, lens, ref.k)
    ref.add(canon, valid)
    port.add_packed(state.packed_to_torch(ref_kmer.pack_codes_np(seqs), "cpu"),
                    torch.from_numpy(lens), L)


def _fed_counters(k: int, feeds: int, merge_factor: int = 1, spill_rows: int = 256,
                  log: list | None = None):
    """Both counters at k, with slabs of 512 k-mers, a merge at every second
    slab and a spill at 256 rows, fed the same 8 reads `feeds` times
    (tests/test_count_slab.py:103; the reference spills at its first merge,
    after 6 feeds). With log, their merges and spills are recorded first
    (_record)."""
    rng = np.random.default_rng(k)
    L = k + 59
    seqs = rng.integers(0, 4, (8, L), dtype=np.uint8)
    lens = np.full(8, L, np.int32)
    ref, port = _counters(k, merge_factor, spill_rows)
    if log is not None:
        _record(ref, log[0])
        _record(port, log[1])
    for _ in range(feeds):
        _feed(ref, port, seqs, lens, L)
    return ref, port, feeds * 8 * (L - k + 1)


def _record(counter, events: list) -> None:
    """Log a counter's merge checks and spills with the sizes they compare:
    at a merge the run count, the runs' bucketed total and the trigger it
    passed, then the runs left and the next trigger; at a spill the run's
    bucketed size. Both packages name the two methods alike."""
    merge, spill = counter._merge_runs, counter._spill_run

    def merge_runs():
        before = (len(counter._runs), counter._runs_n, counter._next_merge)
        merge()
        events.append(("merge", *before, len(counter._runs), counter._runs_n,
                       counter._next_merge))

    def spill_run(rows, counts, bucket):
        events.append(("spill", bucket))
        spill(rows, counts, bucket)

    counter._merge_runs, counter._spill_run = merge_runs, spill_run


# (merge_factor, spill_rows): every merge spills; merged runs stay on the
# device until their bucket reaches 8,192 rows (over 4,096 distinct); none
# spills
SCHEDULES = {"spill_each": (1, 256), "spill_late": (1, 8192), "no_spill": (2, 1 << 30)}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("k", [15, 63])
def test_merge_and_spill_schedule_matches_reference(k, schedule):
    """The port's merges and spills, and the sizes compared at each, are the
    reference counter's (count.py:285-426): on _fed_counters' feeds, then
    on 14 chunks of fresh reads (the distinct set grows past one bucket),
    then with a run from another counter ingested (ingest_run, count.py:
    538-555), through finalize; the results are equal too."""
    mf, spill_rows = SCHEDULES[schedule]
    log = ([], [])
    ref, port, _ = _fed_counters(k, 8, mf, spill_rows, log)
    rng = np.random.default_rng(k + 1)
    L = k + 59
    lens = np.full(8, L, np.int32)
    for _ in range(14):
        _feed(ref, port, rng.integers(0, 4, (8, L), dtype=np.uint8), lens, L)
    assert log[1] == log[0]
    other_ref, other_port, _ = _fed_counters(k, 3)
    ru, rc = other_ref.distinct_run()
    pu, pc = other_port.distinct_run()
    np.testing.assert_array_equal(pu, ru)
    np.testing.assert_array_equal(pc, rc)
    ref.ingest_run(ru, rc)
    port.ingest_run(pu, pc)
    assert port._runs_n == ref._runs_n and len(port._runs) == len(ref._runs)
    rb, rnw, rcut, rns, rhist, rH, _ = ref.finalize(None, None, None, SEED, False,
                                                    want_solid=True)
    pb, pnw, pcut, pns, phist, pH, run = port.finalize(None, None, None, SEED, False)
    assert log[1] == log[0]
    assert any(e[0] == "merge" for e in log[0])
    assert any(e[0] == "spill" for e in log[0]) == (schedule != "no_spill")
    np.testing.assert_array_equal(phist, rhist)
    assert (pcut, pns, pnw, pH) == (rcut, rns, rnw, rH)
    np.testing.assert_array_equal(state.bitset_from_torch(pb), np.asarray(rb)[:rnw])


@pytest.mark.parametrize("k", [5, 63])
def test_distinct_run_after_final_merge_spill(k):
    ref, port, n_kmers = _fed_counters(k, 4)
    uniq, counts = port.distinct_run()
    assert port.n_spills >= 1 and not port._runs  # the final merge spilled too
    ru, rc = ref.distinct_run()
    np.testing.assert_array_equal(uniq, ru)
    np.testing.assert_array_equal(counts, rc)
    assert counts.dtype == np.int32 and int(counts.sum()) == n_kmers


@pytest.mark.parametrize("k", [5, 63])
def test_finalize_after_spill_matches_reference(k):
    ref, port, _ = _fed_counters(k, 8)
    assert port.n_spills >= 1 and ref._host_runs
    rb, rnw, rcut, rns, rhist, rH, (_, _, rnu, host_pair) = ref.finalize(
        None, None, None, SEED, False, want_solid=True, unitig_max=128 << 20)
    pb, pnw, pcut, pns, phist, pH, run = port.finalize(None, None, None, SEED, False,
                                                       unitig_max=128 << 20)
    np.testing.assert_array_equal(phist, rhist)
    assert (pcut, pns, pnw, pH, run.nu) == (rcut, rns, rnw, rH, rnu)
    np.testing.assert_array_equal(state.bitset_from_torch(pb), np.asarray(rb)[:rnw])
    # the solid rows, exact (counts >= cutoff), in host memory and on the device
    assert run.counts is None
    np.testing.assert_array_equal(run.rows, host_pair[0])
    assert run.rows.shape[0] == pns > 0
    on_dev = (state.keys_from_torch(run.solid, port.W) if run.solid.dim() == 1
              else run.solid.numpy().view(np.uint32))
    np.testing.assert_array_equal(on_dev, host_pair[0])


@pytest.mark.parametrize("k", [5, 63])
def test_spilled_bloom_plain_versions_equal_build_np(k):
    """The spilled path's Bloom build is K3 (k <= 31) or K16 over the
    uploaded solid rows; their plain versions give build_np's bitset (the
    reference builds this filter with build_np on the host)."""
    _, port, _ = _fed_counters(k, 8)
    bits, n_words, _, n_solid, _, H, run = port.finalize(2, 8.0, 3, SEED)
    want = ref_bloom.build_np(run.rows, n_words, H, SEED, k)
    np.testing.assert_array_equal(bloom.build_np(run.rows, n_words, H, SEED, k), want)
    np.testing.assert_array_equal(state.bitset_from_torch(bits), want)
    if k <= 31:
        plain = bloom.bloom_build_plain(run.solid, torch.ones(n_solid, dtype=torch.int32), 1,
                                        n_words, H, SEED, k)
    else:
        plain = bloom.bloom_build_words_plain(run.solid, torch.ones(n_solid, dtype=torch.bool),
                                              n_words, n_words, H, SEED, k)
    np.testing.assert_array_equal(state.bitset_from_torch(plain), want)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _no_count(*_a, **_k):
    raise AssertionError("pass 1 ran on a resumed count")


@pytest.mark.parametrize("stream", [False, True])
def test_checkpoint_resume_skips_the_count(work, tmp_path, monkeypatch, stream):
    d, srcs, ref_archive = work
    ck = str(tmp_path / "count.ckpt")
    cfg = _port(31, checkpoint=ck, **(MODES["stream"] if stream else {}))
    first = pipeline.compress(srcs[31], str(tmp_path / "a.leon"), cfg=cfg, device="cpu")
    assert os.path.exists(ck) and not first["resumed"]
    monkeypatch.setattr(pipeline, "_count_pass", _no_count)
    kernels.launches.clear()
    st = pipeline.compress(srcs[31], str(tmp_path / "b.leon"), cfg=cfg, device="cpu")
    assert st["resumed"] and st["n_reads"] == first["n_reads"]
    assert kernels.launches["kmer_scan"] == kernels.launches["runs"] == 0
    for arc in ("a.leon", "b.leon"):
        assert open(tmp_path / arc, "rb").read() == ref_archive(31, "host")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(work, tmp_path, monkeypatch, writer):
    """Each package resumes the other's checkpoint (the same magic, JSON
    header and raw bitset and UNITIGS payload) and writes the reference's
    archive."""
    d, srcs, ref_archive = work
    ck = str(tmp_path / "count.ckpt")
    ref_cfg = RefConfig(**_kw(31), **REF_KW, checkpoint=ck)
    port_cfg = _port(31, checkpoint=ck)
    arc = str(tmp_path / "resumed.leon")
    if writer == "reference":
        ref_pipeline.compress(srcs[31], str(tmp_path / "w.leon"), cfg=ref_cfg)
        monkeypatch.setattr(pipeline, "_count_pass", _no_count)
        assert pipeline.compress(srcs[31], arc, cfg=port_cfg, device="cpu")["resumed"]
    else:
        pipeline.compress(srcs[31], str(tmp_path / "w.leon"), cfg=port_cfg, device="cpu")
        monkeypatch.setattr(ref_pipeline, "_count_pass_device", _no_count)
        ref_pipeline.compress(srcs[31], arc, cfg=ref_cfg)
    assert open(arc, "rb").read() == ref_archive(31, "host")


def _fastq_qual(path, rng):
    contig = rng.integers(0, 4, 1500, dtype=np.uint8)
    write_fastq(path, [sim_seq(rng, contig, lmin=100, lmax=100) for _ in range(120)], rng)


def test_checkpoint_from_other_quality_mode_is_ignored(tmp_path):
    """A lossless run's checkpoint is not resumed by a lossy run on the same
    input (the key holds the mode: the auto Bloom sizing differs,
    tests/test_roundtrip.py:300-320); the lossy run writes the reference's
    lossy archive. The BLOOM section (no UNITIGS) rides along."""
    src = str(tmp_path / "q.fastq")
    _fastq_qual(src, np.random.default_rng(7))
    ck = str(tmp_path / "q.ckpt")
    lossless = _port(31, checkpoint=ck, unitig_sections=False)
    lossy = dataclasses.replace(lossless, lossless=False)
    pipeline.compress(src, str(tmp_path / "ll.leon"), cfg=lossless, device="cpu")
    st = pipeline.compress(src, str(tmp_path / "lo.leon"), cfg=lossy, device="cpu")
    assert not st["resumed"]
    ref_pipeline.compress(src, str(tmp_path / "ref.leon"),
                          cfg=RefConfig(kmer_size=31, unitig_sections=False, **REF_KW))
    assert open(tmp_path / "lo.leon", "rb").read() == open(tmp_path / "ref.leon", "rb").read()
    # and a lossy checkpoint now stands: the next lossy run resumes it
    again = pipeline.compress(src, str(tmp_path / "lo2.leon"), cfg=lossy, device="cpu")
    assert again["resumed"]
    assert open(tmp_path / "lo2.leon", "rb").read() == open(tmp_path / "ref.leon", "rb").read()


def _corrupt(kind: str, good: bytes) -> bytes:
    """A checkpoint that must be ignored, made from a good one."""
    jlen = int.from_bytes(good[8:12], "little")
    hdr = json.loads(good[12 : 12 + jlen])
    body = good[12 + jlen :]

    def with_header(h):
        raw = json.dumps(h).encode()
        return good[:8] + len(raw).to_bytes(4, "little") + raw + body

    return {
        "garbage": bytes(range(256)) * 4,
        "magic": b"NOTCKPT!" + good[8:],
        "truncated": good[: len(good) - 9],
        "huge_header": good[:8] + (1 << 30).to_bytes(4, "little") + good[12:],
        "not_json": good[:12] + b"{" * jlen + body,
        "other_key": with_header(dict(hdr, key=hdr["key"][:-1] + [hdr["key"][-1] + 1])),
        "bitset_size": with_header(dict(hdr, n_words=hdr["n_words"] + 64)),
        "header_list": with_header([1, 2, 3]),
    }[kind]


CORRUPT = ("garbage", "magic", "truncated", "huge_header", "not_json", "other_key", "bitset_size",
           "header_list")


@pytest.fixture(scope="module")
def good_checkpoint(work, tmp_path_factory):
    """A checkpoint of the k = 31 corpus, written once."""
    d, srcs, _ = work
    ck = str(tmp_path_factory.mktemp("ck") / "count.ckpt")
    pipeline.compress(srcs[31], ck + ".leon", cfg=_port(31, checkpoint=ck), device="cpu")
    with open(ck, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", CORRUPT)
def test_corrupt_checkpoint_is_ignored(work, good_checkpoint, tmp_path, kind):
    d, srcs, ref_archive = work
    ck = str(tmp_path / "count.ckpt")
    with open(ck, "wb") as f:
        f.write(_corrupt(kind, good_checkpoint))
    st = pipeline.compress(srcs[31], str(tmp_path / "b.leon"), cfg=_port(31, checkpoint=ck),
                           device="cpu")
    assert not st["resumed"]
    assert open(tmp_path / "b.leon", "rb").read() == ref_archive(31, "host")
    with open(ck, "rb") as f:
        assert f.read() == good_checkpoint  # the run wrote a good checkpoint over it


# ---------------------------------------------------------------------------
# profile_dir
# ---------------------------------------------------------------------------


def test_profile_dir_writes_a_trace(tmp_path):
    """A Chrome trace appears in profile_dir and the archive is the one the
    same call writes unprofiled."""
    src = str(tmp_path / "small.fastq")
    rng = np.random.default_rng(9)
    contig = rng.integers(0, 4, 600, dtype=np.uint8)
    write_fastq(src, [sim_seq(rng, contig) for _ in range(40)], rng)
    prof = tmp_path / "prof"
    st = pipeline.compress(src, str(tmp_path / "p.leon"), cfg=_port(31, profile_dir=str(prof)),
                           device="cpu")
    traces = [p for p in os.listdir(prof) if p.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    pipeline.compress(src, str(tmp_path / "q.leon"), cfg=_port(31), device="cpu")
    assert st["n_reads"] == 40
    assert open(tmp_path / "p.leon", "rb").read() == open(tmp_path / "q.leon", "rb").read()
