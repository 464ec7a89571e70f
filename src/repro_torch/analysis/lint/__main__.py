"""``python -m repro_torch.analysis.lint``: the port's reprolint command
line (``cli.main``)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
