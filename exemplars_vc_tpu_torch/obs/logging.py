"""Structured logging + run-directory management (a copy of
``exemplars_vc_tpu/obs/logging.py``; the default logger is the port's).

Replaces the reference's per-script ``logging.basicConfig`` into timestamped
files (``01_make_dict_parallel.py:41-52``) and the integer run-dir allocator
``logdir()`` (``utils.py:27-49``)."""

from __future__ import annotations

import logging
import os
import sys
import time

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "exemplars_vc_tpu_torch",
               log_dir: str | None = None) -> logging.Logger:
    """Process-wide logger; a stderr handler is attached once. ``log_dir``
    attaches a timestamped FileHandler for that directory — also on an
    already-configured logger (an early no-dir call must not silently
    swallow a later run-dir request)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
        logger.propagate = False
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        want = os.path.abspath(log_dir)
        have = any(
            isinstance(h, logging.FileHandler)
            and os.path.dirname(getattr(h, "baseFilename", "")) == want
            for h in logger.handlers
        )
        if not have:
            fh = logging.FileHandler(
                os.path.join(log_dir, time.strftime("%Y-%m-%d_%H-%M-%S.log"))
            )
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
    return logger


def new_run_dir(root: str = "runs") -> str:
    """Allocate the next integer-numbered run directory (reference
    ``utils.py:27-49`` semantics), creating it atomically."""
    os.makedirs(root, exist_ok=True)
    existing = [int(d) for d in os.listdir(root) if d.isdigit()]
    n = max(existing, default=-1) + 1
    while True:
        path = os.path.join(root, str(n))
        try:
            os.mkdir(path)
            return path
        except FileExistsError:
            n += 1
