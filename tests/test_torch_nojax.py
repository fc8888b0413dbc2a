"""The port runs with no jax at all (the machine with the card has none):
in a subprocess whose ``import jax`` fails, leon_tpu_torch imports,
compresses and decompresses on the CPU, and the round trip is exact."""

import os
import subprocess
import sys
import textwrap

import numpy as np

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
