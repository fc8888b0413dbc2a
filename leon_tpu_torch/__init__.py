"""leon_tpu_torch — the PyTorch + CUDA port of leon_tpu for one NVIDIA H100.

Same algorithm, same container (FORMAT.md, v6), same archives byte for
byte: leon_tpu stays the reference. The port imports nothing of it: the
host modules it needs (config, container, frame codecs, native helpers,
parsers, utils) are its own copies, each naming the file it mirrors and
held equal to it by the CPU tests; the device work is hand-written CUDA
for sm_90a.

Package layout (counterparts of leon_tpu's modules):
  kernels.py   build, load and launch-count the CUDA kernels (csrc/)
  state.py     reference numpy state <-> port tensors
  config.py    LeonConfig
  native/      the C++ host library (frame coders, parsers, unitig builder)
  utils/       varints, ragged moves, spans
  ops/         kmer (K1), count (K2), bloom (K3, K10), walk (K4),
               unitig (K5-K8), gather (K9)
  codecs/      frame coders, headers, block stream assembly
  io/          container, FASTA/FASTQ parsers, decompression record writer
  graph.py     the de Bruijn graph API (K10-K12)
  pipeline.py  compress / decompress, on one device or lane-sharded over
               several (mesh_devices, device=[...])
  parallel/    mesh.py (a device list, sharded Bloom build, scan, encode),
               distributed.py (compress_distributed on torch.distributed)
  entry.py     entry(device), dryrun(devices)
  cli.py       the reference's command line
"""

__version__ = "0.1.0"

from leon_tpu_torch.config import LeonConfig  # noqa: F401
