"""The port runs with no jax at all (the machine with the card has none)
and without the reference package: in a subprocess whose ``import jax``
fails, leon_tpu_torch imports, compresses and decompresses on the CPU (the
round trip is exact) and runs entry() and the multiword count; with
``leon_tpu`` and ``bench`` blocked too, the CLI runs, and the graph API
at k = 15 and, with the tensor path (scan, count, dense encode), at
k = 100 (W = 7). A static check walks the port's sources and chip_smoke.py for
imports of jax, leon_tpu or bench."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.path.insert(0, sys.argv[1])
    from leon_tpu_torch import LeonConfig, pipeline
    src = sys.argv[2]
    cfg = LeonConfig(lossless=True, batch_reads=32, reads_per_block=50)
    st = pipeline.compress(src, src + ".leon", cfg=cfg, device="cpu")
    pipeline.decompress(src + ".leon", src + ".out", cfg=cfg, device="cpu")
    assert open(src, "rb").read() == open(src + ".out", "rb").read()
    assert st["n_anchored"] > 0
    from leon_tpu_torch import entry
    from leon_tpu_torch.ops import count, kmer
    fn, args = entry.entry("cpu")
    assert bool(fn(*args)["anchored"].all())
    canon, _, valid = kmer.kmer_scan_words(args[0][:64], args[1][:64], 33)
    uniq, counts = count.count_batch(canon, valid)
    assert int(counts.sum()) == int(valid.sum()) and uniq.shape[1] == 3
    assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                if sys.modules[m] is not None]
    print("NOJAX_OK", st["n_reads"])
""")


def test_port_runs_without_jax(tmp_path):
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contig = rng.integers(0, 4, 400, dtype=np.uint8)
    src = tmp_path / "reads.fastq"
    with open(src, "wb") as f:
        for i in range(120):
            st = int(rng.integers(0, 300))
            r = contig[st : st + 90].copy()
            r[rng.random(90) < 0.01] ^= 1
            q = rng.integers(35, 74, 90).astype(np.uint8).tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, bases[r].tobytes(), q))
    res = subprocess.run([sys.executable, "-c", SCRIPT, ROOT, str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX_OK 120" in res.stdout


STANDALONE = textwrap.dedent("""
    import sys
    for name in ("jax", "leon_tpu", "bench"):
        sys.modules[name] = None  # any import of them now raises ImportError
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    from leon_tpu_torch import LeonConfig, cli, pipeline
    from leon_tpu_torch.graph import Graph
    from leon_tpu_torch.ops import kmer
    src = sys.argv[2]
    cfg = LeonConfig(batch_reads=32, reads_per_block=50)
    st = pipeline.compress(src, src + ".leon", cfg=cfg, device="cpu")
    pipeline.decompress(src + ".leon", src + ".out", cfg=cfg, device="cpu")
    assert st["n_anchored"] > 0
    rc = cli.main(["-file", src, "-c", "-lossless", "-test-file", "-device", "cpu",
                   "-verbose", "0"])
    assert rc == 0, rc
    contig = np.random.default_rng(1).integers(0, 4, 120, dtype=np.uint8)
    wins = np.stack([contig[i : i + 15] for i in range(106)])
    g = Graph.from_solid(kmer.pack_codes_batch_np(wins, 15), 15, bits_per_kmer=24.0,
                         device="cpu")
    bases, n = g.dbg.walk(kmer.pack_codes_batch_np(wins[:1], 15), 110)
    assert int(n[0]) > 50 and (bases[0, : int(n[0])].numpy() == contig[15 : 15 + int(n[0])]).all()
    assert bool(g.dbg.contains(g.index.sorted_words).all())
    # past four words (k = 100, W = 7): the tensor path and the graph API
    import torch
    from leon_tpu_torch.ops import count, walk
    big = np.random.default_rng(2).integers(0, 4, 260, dtype=np.uint8)
    reads = np.stack([big[i : i + 130] for i in range(0, 130, 10)] * 2)
    lens = torch.full((reads.shape[0],), 130, dtype=torch.int32)
    canon, _, valid = kmer.kmer_scan_words(torch.from_numpy(reads), lens, 100)
    uniq, counts = count.count_batch(canon, valid)
    assert uniq.shape[1] == 7 and int(counts.sum()) == int(valid.sum())
    solid = uniq.numpy().view(np.uint32)[counts.numpy() >= 2]
    g = Graph.from_solid(solid, 100, bits_per_kmer=24.0, device="cpu")
    bases, n = g.dbg.walk(kmer.pack_codes_batch_np(big[None, :100], 100), 60)
    assert int(n[0]) == 60 and (bases[0].numpy() == big[100:160]).all()
    out, n = g.dbg.traverse(g.index.sorted_words[:4], 3, 4)
    assert out.shape == (4, 18)
    enc = walk.encode_batch(torch.from_numpy(reads), lens, g.dbg.bitset, 100, 4,
                            g.dbg.n_words, 0)
    assert enc["anchored"].shape == (reads.shape[0],)
    loaded = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in ("jax", "leon_tpu", "bench")]
    assert not loaded, loaded
    print("STANDALONE_OK", st["n_reads"])
""")


def test_port_runs_without_reference(tmp_path):
    rng = np.random.default_rng(43)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contig = rng.integers(0, 4, 400, dtype=np.uint8)
    src = tmp_path / "reads.fastq"
    with open(src, "wb") as f:
        for i in range(100):
            st = int(rng.integers(0, 300))
            r = contig[st : st + 90].copy()
            q = rng.integers(35, 74, 90).astype(np.uint8).tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, bases[r].tobytes(), q))
    res = subprocess.run([sys.executable, "-c", STANDALONE, ROOT, str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "round-trip (byte-exact): OK" in res.stdout
    assert "STANDALONE_OK 100" in res.stdout


FORBIDDEN = ("jax", "leon_tpu", "bench")


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(ROOT, "leon_tpu_torch", "**", "*.py"), recursive=True))
    + [os.path.join(ROOT, "chip_smoke.py")], ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reference_imports(path):
    """No module of the port, and not chip_smoke.py, imports jax, leon_tpu
    (or any leon_tpu.*) or bench, at any depth of the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if not node.level else []
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
