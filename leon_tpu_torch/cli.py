"""Command line of the port: the reference's grammar (leon_tpu/cli.py),
run on the CUDA card.

    python -m leon_tpu_torch.cli -file reads.fastq -c [-test-file]
    python -m leon_tpu_torch.cli -file reads.fastq.leon -d

The parser and the round-trip oracles are the reference's (jax-free at
import); archives are byte-identical to leon_tpu's.
"""

from __future__ import annotations

import json
import sys

import leon_tpu_torch
from leon_tpu.cli import _build_parser, _files_equal, _is_fasta, _seqs_equal
from leon_tpu.config import LeonConfig


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.version:
        import torch

        from leon_tpu.io import container

        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"* leon-tpu-torch version {leon_tpu_torch.__version__} "
              f"(container format v{container.VERSION})")
        print(f"* torch {torch.__version__}; CUDA devices: {names}")
        return 0
    if not args.file or args.compress == args.decompress:
        print("error: -file and exactly one of -c / -d are required", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("error: leon_tpu_torch runs on a CUDA device and none is visible",
              file=sys.stderr)
        return 1
    try:
        return _run(args)
    except (OSError, ValueError, NotImplementedError) as e:
        # reference behavior: catch and print, no traceback
        print(f"EXCEPTION: {e}", file=sys.stderr)
        return 1


def _run(args) -> int:
    from leon_tpu_torch import pipeline

    cfg = LeonConfig(
        kmer_size=args.kmer_size,
        abundance=args.abundance,
        lossless=args.lossless,
        seq_only=args.seq_only,
        noheader=args.noheader,
        noqual=args.noqual,
        nb_cores=args.nb_cores or None,
        verbose=args.verbose,
    )
    if args.compress:
        stats = pipeline.compress(args.file, cfg=cfg, device="cuda")
        if args.verbose:
            print(json.dumps(stats, indent=2))
        if args.test_file:
            dstats = pipeline.decompress(stats["output"], cfg=cfg, device="cuda")
            full = not (cfg.seq_only or cfg.noheader or cfg.noqual) and (
                cfg.lossless or _is_fasta(args.file)
            )
            ok = (_files_equal if full else _seqs_equal)(args.file, dstats["output"])
            print(f"* round-trip ({'byte' if full else 'sequence'}-exact): {'OK' if ok else 'FAILED'}")
            return 0 if ok else 2
    else:
        stats = pipeline.decompress(args.file, cfg=cfg, device="cuda")
        if args.verbose:
            print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
