"""The port's command line: the reference's grammar, the version banner,
and a clear error (no traceback) where it cannot run."""

import torch

from leon_tpu_torch import cli


def test_usage_error_and_version(capsys):
    assert cli.main([]) == 1
    assert "exactly one of -c / -d" in capsys.readouterr().err
    assert cli.main(["-file", "x.fastq", "-c", "-d"]) == 1
    assert cli.main(["-version"]) == 0
    assert "leon-tpu-torch version" in capsys.readouterr().out


def test_compress_needs_cuda(tmp_path, capsys):
    src = tmp_path / "r.fasta"
    src.write_bytes(b">r\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n")
    if torch.cuda.is_available():  # on the card this runs for real
        assert cli.main(["-file", str(src), "-c", "-test-file", "-verbose", "0"]) == 0
        assert "round-trip (byte-exact): OK" in capsys.readouterr().out
    else:
        assert cli.main(["-file", str(src), "-c"]) == 1
        assert "CUDA device" in capsys.readouterr().err
