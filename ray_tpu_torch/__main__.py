"""``python -m ray_tpu_torch`` — the CLI entry point (``ray`` command analog)."""

from ray_tpu_torch.scripts.cli import main

main()
