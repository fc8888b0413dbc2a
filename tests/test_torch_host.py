"""The port's own copies of leon_tpu's host modules against their originals,
byte for byte on the same seeded inputs: frame coders (rans, o1, q1,
zlib), the header codec, the container, varints and ragged moves, the
FASTA/FASTQ/gz parsers, LeonConfig, and chip_smoke's copy of the bench
corpus generator."""

import dataclasses
import gzip

import numpy as np
import pytest

import bench
import chip_smoke
from leon_tpu import config as ref_config
from leon_tpu.codecs import frames as ref_frames
from leon_tpu.codecs import headers as ref_headers
from leon_tpu.codecs import o1 as ref_o1
from leon_tpu.codecs import q1 as ref_q1
from leon_tpu.codecs import rans as ref_rans
from leon_tpu.io import bank as ref_bank
from leon_tpu.io import container as ref_container
from leon_tpu.utils import ragged as ref_ragged
from leon_tpu.utils import varint as ref_varint
from leon_tpu_torch import config
from leon_tpu_torch.codecs import frames, headers, o1, q1, rans
from leon_tpu_torch.io import bank, container
from leon_tpu_torch.utils import ragged, varint


def _quals(rng, n_reads=300, ln=100):
    """Illumina-like qualities: a slow random walk per read."""
    q = np.clip(35 + np.cumsum(rng.integers(-2, 3, (n_reads, ln)), axis=1), 2, 41)
    return (q + 33).astype(np.uint8).tobytes(), np.full(n_reads, ln, np.int64)


def _payloads(seed):
    rng = np.random.default_rng(seed)
    quals, lens = _quals(rng)
    return {
        "random": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "skewed": rng.choice(4, 20000, p=[0.7, 0.2, 0.07, 0.03]).astype(np.uint8).tobytes(),
        "quals": quals,
        "tiny": b"ACGT" * 3,
        "empty": b"",
    }, lens


@pytest.mark.parametrize("seed", [1, 2])
def test_frame_coders_match_reference(seed):
    data, lens = _payloads(seed)
    for name, d in data.items():
        assert rans.encode(d) == ref_rans.encode(d), name
        assert o1.encode(d) == ref_o1.encode(d), name
        for kw in (dict(), dict(try_o1=True), dict(try_rans=False)):
            fr = frames.frame(d, **kw)
            assert fr == ref_frames.frame(d, **kw), (name, kw)
            assert frames.unframe(fr) == ref_frames.unframe(fr)
    q, ql = data["quals"], lens
    assert q1.encode(q, ql) == ref_q1.encode(q, ql)
    fr = frames.frame(q, try_o1=True, lens=ql)
    assert fr == ref_frames.frame(q, try_o1=True, lens=ql)
    assert fr[0] == frames.METHOD_Q1  # the position-aware model wins on qualities
    assert frames.unframe(fr, lens=ql) == ref_frames.unframe(fr, lens=ql)
    assert frames.unframe(fr, lens=ql)[0] == q
    # zlib (method 1) and raw (0) frames from either side decode alike
    for m, payload in ((frames.METHOD_ZLIB, data["skewed"]), (frames.METHOD_RAW, b"xyz")):
        fr = ref_frames.frame(payload, try_rans=False) if m else ref_frames.frame(payload)
        assert fr[0] == m and frames.unframe(fr)[0] == payload


def test_header_codec_matches_reference():
    rng = np.random.default_rng(7)
    hs = [b"SRR%d.%d %d/1 length=%d" % (7, i, i * 3, int(rng.integers(50, 150)))
          for i in range(400)]
    hs += [b"weird header \x01", b"", b"x" * 300, b"12345678901234567890123 tail"]
    enc = headers.encode(hs)
    assert enc == ref_headers.encode(hs)
    assert headers.decode(enc, len(hs)) == ref_headers.decode(enc, len(hs)) == hs
    assert headers.synth(5, 3) == ref_headers.synth(5, 3)


def _meta(mod, **kw):
    return mod.Meta(k=31, fmt=1, qual_mode=2, header_mode=1, n_hashes=4, final_newline=False,
                    n_words=12345, seed=0x1234ABCD, n_reads=1000, abundance=3, seglen=0,
                    orig_ext=b"fastq", **kw)


@pytest.mark.parametrize("unitigs", [False, True])
def test_container_both_directions(tmp_path, unitigs):
    rng = np.random.default_rng(11)
    blocks = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in (100, 0, 3000)]
    kw = dict(dict_payload=b"dict" * 10, bloom_payload=rng.bytes(777), block_payloads=blocks,
              block_n_reads=[400, 0, 600], unitigs=unitigs)
    ref_c = ref_container.Container(meta=_meta(ref_container), **kw)
    port_c = container.Container(meta=_meta(container), **kw)
    a, b = str(tmp_path / "ref.leon"), str(tmp_path / "port.leon")
    assert ref_container.write(a, ref_c) == container.write(b, port_c)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert dataclasses.asdict(container.read(a)) == dataclasses.asdict(ref_container.read(b))
    back = container.read(a)
    assert (back.meta, back.block_payloads, back.bloom_payload, back.unitigs) == (
        port_c.meta, blocks, port_c.bloom_payload, unitigs)
    assert container.VERSION == ref_container.VERSION and container.MAGIC == ref_container.MAGIC


def test_varints_and_ragged_moves_match_reference():
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.integers(0, 1 << 62, 500, dtype=np.uint64),
                        np.array([0, 127, 128, (1 << 63) - 1], np.uint64)])
    enc = varint.encode_array(v)
    assert enc == ref_varint.encode_array(v)
    assert np.array_equal(varint.decode_array(enc, v.size), ref_varint.decode_array(enc, v.size))
    s = rng.integers(-(1 << 40), 1 << 40, 300)
    assert np.array_equal(varint.zigzag(s), ref_varint.zigzag(s))
    assert np.array_equal(varint.unzigzag(varint.zigzag(s)), s)
    one, ref_one = bytearray(), bytearray()
    varint.encode_one(300, one)
    ref_varint.encode_one(300, ref_one)
    assert one == ref_one and varint.decode_one(bytes(one), 0) == (300, 2)

    src = rng.integers(0, 256, 4000, dtype=np.uint8)
    lens = rng.integers(0, 30, 100)
    starts = np.sort(rng.choice(3900, 100, replace=False)).astype(np.int64)
    assert np.array_equal(ragged.gather(src, starts, lens), ref_ragged.gather(src, starts, lens))
    d1, d2 = np.zeros(5000, np.uint8), np.zeros(5000, np.uint8)
    flat = ragged.gather(src, starts, lens)
    dst = np.cumsum(lens + 7) - lens
    ragged.scatter(d1, dst, lens, flat)
    ref_ragged.scatter(d2, dst, lens, flat)
    ragged.fill(d1, starts, lens // 2, 78)
    ref_ragged.fill(d2, starts, lens // 2, 78)
    assert np.array_equal(d1, d2)
    with pytest.raises(ValueError):
        ragged.move(d1, np.array([4990]), src, np.array([0]), np.array([20]))


def _write_corpora(tmp_path, rng):
    bases = np.frombuffer(b"ACGT", np.uint8)
    fq, fa = tmp_path / "r.fastq", tmp_path / "r.fasta"
    with open(fq, "wb") as f:
        for i in range(300):
            s = bases[rng.integers(0, 4, int(rng.integers(0, 120)))].tobytes()
            q = rng.integers(35, 74, len(s)).astype(np.uint8).tobytes()
            f.write(b"@r%d x\n%s\n+%s\n%s\n" % (i, s, b"r%d" % i if i % 7 == 0 else b"", q))
    with open(fa, "wb") as f:
        for i in range(200):
            s = bases[rng.integers(0, 4, int(rng.integers(0, 300)))].tobytes()
            s = s[:5] + b"NNRY" + s[9:] if i % 11 == 0 else s
            f.write(b">c%d\n" % i + b"".join(s[j : j + 60] + b"\n" for j in range(0, len(s), 60)))
        f.write(b">last\nACGT")  # no final newline
    gz = tmp_path / "r.fastq.gz"
    with open(fq, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    return [str(fq), str(fa), str(gz)]


def test_parsers_match_reference(tmp_path):
    for path in _write_corpora(tmp_path, np.random.default_rng(5)):
        assert bank.sniff_format(path) == ref_bank.sniff_format(path)
        assert bank.final_newline(path) == ref_bank.final_newline(path)
        assert bank.total_size(path) == ref_bank.total_size(path)
        got = [dataclasses.asdict(b) for b in bank.read_blocks(path, 64)]
        assert got == [dataclasses.asdict(b) for b in ref_bank.read_blocks(path, 64)], path
        assert bank.validate_arrays(path) == ref_bank.validate_arrays(path)
        for a, b in zip(bank.read_blocks_arrays(path, 64), ref_bank.read_blocks_arrays(path, 64),
                        strict=True):
            for name in type(b).__slots__:
                x, y = getattr(a, name), getattr(b, name)
                assert np.array_equal(np.asarray(x), np.asarray(y)), (path, name)


def test_config_fields_and_defaults_match_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(config.LeonConfig) == fields(ref_config.LeonConfig)
    assert config.LeonConfig(seq_only=True).noqual and config.LeonConfig().kmer_size == 31
    with pytest.raises(ValueError):
        config.LeonConfig(kmer_size=0)
    assert not hasattr(config.LeonConfig, "resolved")  # it imports jax


def test_chip_smoke_corpus_is_bench_corpus(tmp_path):
    a, b = tmp_path / "a.fastq", tmp_path / "b.fastq"
    bench.gen_fastq(str(a), 3000, 20000)
    chip_smoke.gen_fastq(str(b), 3000, 20000)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("k", [5, 31, 63, 127, 255])
@pytest.mark.parametrize("nproc", [1, 2, 3, 8])
def test_range_split_copies_match_reference(k, nproc):
    """count.range_boundaries / range_split (the distributed count's key
    ranges) against leon_tpu/ops/count.py:722-759, on a sorted distinct run
    with rows on and around every boundary."""
    from leon_tpu.ops import count as ref_count
    from leon_tpu_torch.ops import count

    W = (2 * k + 31) // 32
    bounds = count.range_boundaries(nproc, k, W)
    np.testing.assert_array_equal(bounds, ref_count.range_boundaries(nproc, k, W))
    rng = np.random.default_rng(k * 10 + nproc)
    rows = rng.integers(0, 1 << 32, (300, W), dtype=np.uint64).astype(np.uint32)
    rows[:, W - 1] &= np.uint32((1 << (2 * k - 32 * (W - 1))) - 1)
    near = np.concatenate([bounds, bounds]) if bounds.size else np.zeros((0, W), np.uint32)
    if near.size:
        near[: len(bounds), 0] -= 1  # one below each boundary
    rows = np.unique(np.concatenate([rows, bounds, near]), axis=0)
    rows = rows[np.lexsort(rows.T)]  # ascending, most significant word last
    np.testing.assert_array_equal(count.range_split(rows, bounds),
                                  ref_count.range_split(rows, bounds))
    np.testing.assert_array_equal(count.range_split(rows[:0], bounds),
                                  ref_count.range_split(rows[:0], bounds))
