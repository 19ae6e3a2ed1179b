"""Run one cell of the benchmark once: see ``bench/harness/cli.py``."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from bench.harness.cli import main
    sys.exit(main(sys.argv[1:], T_START))
