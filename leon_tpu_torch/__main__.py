"""python -m leon_tpu_torch: the port's command line (cli.py)."""

from leon_tpu_torch.cli import main

raise SystemExit(main())
