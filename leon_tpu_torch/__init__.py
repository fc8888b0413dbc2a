"""leon_tpu_torch — the PyTorch + CUDA port of leon_tpu for one NVIDIA H100.

Same algorithm, same container (FORMAT.md, v6), same archives byte for
byte: leon_tpu stays the reference. Host code that is free of jax (config,
container, frame codecs, native helpers, parsers) is imported from
leon_tpu; the device work is hand-written CUDA for sm_90a.

Package layout (counterparts of leon_tpu's modules):
  kernels.py   build, load and launch-count the CUDA kernels (csrc/)
  state.py     reference numpy state <-> port tensors
  ops/         kmer (K1), count (K2), bloom (K3), walk (K4), unitig host half
  codecs/      block stream assembly
  io/          decompression record writer
  pipeline.py  compress / decompress on one device
  cli.py       the reference's command line
"""

__version__ = "0.1.0"

from leon_tpu.config import LeonConfig  # noqa: F401  (shared with the reference)
