#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card this process finds.

    python3 benchmark/run.py --workload stft.serve --seed 7 --seconds 10 --trace 0

It loads, warms up, measures for ``--seconds`` (with ``--trace 1`` the
per-layer metrics from a shorter profiled window), checks a sample of the
answers against the plain reference under ``benchmark/reference``, and
prints one JSON line last on standard output. Without a CUDA card it exits
with 2 and prints no result. See ``PERF.md`` for the cells and metrics.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
