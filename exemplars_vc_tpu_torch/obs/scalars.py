"""Scalar/metric logging: JSONL event stream per run (a copy of
``exemplars_vc_tpu/obs/scalars.py``).

Replaces the reference's tensorboardX scalar + histogram logging
(``02_freq_warping_neural.py:138,212-220``) with a dependency-free JSONL
writer (one event per line: {step, tag, value, wall}); readable by pandas or
converted to TensorBoard offline. Histograms are summarized (min/max/mean/std)
rather than binned."""

from __future__ import annotations

import json
import os
import time

import numpy as np


class ScalarWriter:
    def __init__(self, run_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._f = open(self.path, "a", buffering=1)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({
            "step": step, "tag": tag, "value": float(value), "wall": time.time(),
        }) + "\n")

    def summary(self, tag: str, values, step: int) -> None:
        """Histogram replacement: moment summary of an array (e.g. weights)."""
        v = np.asarray(values).ravel()
        self._f.write(json.dumps({
            "step": step, "tag": tag, "wall": time.time(),
            "min": float(v.min()), "max": float(v.max()),
            "mean": float(v.mean()), "std": float(v.std()),
            "n": int(v.size),
        }) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_scalars(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
