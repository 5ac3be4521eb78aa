"""A stage timer with an optional device fence, and trace capture
(port of ``exemplars_vc_tpu/obs/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from exemplars_vc_tpu_torch.device import synchronize


class Timer:
    """``with Timer(device, fence=True) as t: ...`` — ``t.elapsed`` is the
    host wall time of the block in seconds. With ``fence`` the device is
    synchronised at entry and exit, so the time covers the block's device
    work and nothing queued before it."""

    def __init__(self, device: torch.device, fence: bool = False):
        self.device = torch.device(device)
        self.fence = fence
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        if self.fence:
            synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.fence:
            synchronize(self.device)
        self.elapsed = time.perf_counter() - self._t0


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Record a ``torch.profiler`` trace of the block: host activity and,
    when a card is present, its kernels and copies. On exit the trace is
    written under ``log_dir`` as a Chrome trace (``*.pt.trace.json``, which
    TensorBoard's profiler plugin and Perfetto read). The card is
    synchronised before the trace stops, so the block's queued kernels are
    in it."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
