"""A stage timer with an optional device fence, which is also a named span
while a ``torch.profiler`` records, and trace capture (port of
``exemplars_vc_tpu/obs/profiling.py``).

Spans. ``Timer(device, name="solve", residual=False)`` is a span when a
profiler is recording (``torch.profiler.profile`` or :func:`trace_to`), and
only then: it opens a ``record_function`` range of that name, so the block
sits in the profiler's Chrome trace as a ``user_annotation`` on the clock of
the kernels it launched, and on exit it keeps a record in a bounded log (the
name, host start and end, its id, its parent's and its root's, and its
attrs). On a CUDA device it also records a timing event on the current
stream at entry and at exit; their difference, ``device_ms``, is read when
the records are read, after the device has run past them. The stack of
open spans is a context variable, so threads do not mix. With no profiler
recording, a named ``Timer`` records nothing and costs one check. A span
adds no host sync: its attrs are host values the caller already has.

    >>> with torch.profiler.profile():
    ...     before = cursor(); conv.convert(path); after = cursor()
    >>> [s["name"] for s in spans(before, after)]   # children before their root
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import deque

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

from exemplars_vc_tpu_torch.device import synchronize

SPANS_KEPT = 1 << 16      # records the log holds; the oldest are dropped first


class _Span:
    __slots__ = ("name", "id", "parent", "root", "attrs", "t0", "t1", "ev0", "ev1",
                 "device_ms", "range", "token")

    def __init__(self, name: str, attrs: dict, device: torch.device, stack: tuple):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        self.range = record_function(name)
        self.range.__enter__()
        self.ev0 = self.ev1 = self.device_ms = None
        if device.type == "cuda":
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(device))
        self.t0 = time.perf_counter_ns()

    def close(self, device: torch.device) -> None:
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(torch.cuda.current_stream(device))
        self.range.__exit__(None, None, None)
        self.range = None

    def record(self) -> dict:
        if self.ev1 is not None:           # resolved once, when first read
            self.ev1.synchronize()
            self.device_ms = self.ev0.elapsed_time(self.ev1)
            self.ev0 = self.ev1 = None
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "attrs": dict(self.attrs), "start_ns": self.t0, "end_ns": self.t1,
                "host_ms": (self.t1 - self.t0) * 1e-6, "device_ms": self.device_ms}


class SpanLog:
    """The closed spans, in the order they closed (a child before its
    parent), the last ``kept`` of them; ``count`` is every span ever
    closed, so a cursor taken outside any span bounds whole trees."""

    def __init__(self, kept: int = SPANS_KEPT):
        self.records: deque[_Span] = deque(maxlen=kept)
        self.count = 0
        self.lock = threading.Lock()

    def append(self, span: _Span) -> None:
        with self.lock:
            self.records.append(span)
            self.count += 1

    def between(self, since: int, until: int | None) -> list[dict]:
        with self.lock:
            count, held = self.count, list(self.records)
        until = count if until is None else min(until, count)
        first = count - len(held)          # the index of the oldest record held
        return [s.record() for s in held[max(since - first, 0): max(until - first, 0)]]


_ids = itertools.count(1)
_log = SpanLog()
_open: contextvars.ContextVar[tuple] = contextvars.ContextVar("open_spans", default=())


def cursor() -> int:
    """The number of spans recorded so far (monotone)."""
    return _log.count


def spans(since: int = 0, until: int | None = None) -> list[dict]:
    """The spans recorded between two cursors, each {name, id, parent,
    root, attrs, start_ns, end_ns, host_ms, device_ms}; ``device_ms`` is
    None off a CUDA device. Spans the log no longer holds are left out.
    Reading waits for the device to reach the spans' end events."""
    return _log.between(since, until)


class Timer:
    """``with Timer(device, fence=True) as t: ...`` — ``t.elapsed`` is the
    host wall time of the block in seconds. With ``fence`` the device is
    synchronised at entry and exit, so the time covers the block's device
    work and nothing queued before it. With a ``name`` the block is also a
    span while a profiler records (module docstring); ``attrs`` are kept
    with it, and the block may add to ``t.attrs`` before it ends."""

    def __init__(self, device: torch.device, fence: bool = False, name: str | None = None,
                 **attrs):
        self.device = torch.device(device)
        self.fence = fence
        self.name = name
        self.attrs = attrs
        self.elapsed = 0.0
        self._span = None

    def __enter__(self) -> "Timer":
        if self.fence:
            synchronize(self.device)
        if self.name is not None and torch.autograd._profiler_enabled():
            stack = _open.get()
            self._span = _Span(self.name, self.attrs, self.device, stack)
            self._span.token = _open.set(stack + (self._span,))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.fence:
            synchronize(self.device)
        self.elapsed = time.perf_counter() - self._t0
        span, self._span = self._span, None
        if span is not None:
            span.close(self.device)
            _open.reset(span.token)
            _log.append(span)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Record a ``torch.profiler`` trace of the block: host activity and,
    when a card is present, its kernels and copies, with the program's
    spans over them. On exit the trace is written under ``log_dir`` as a
    Chrome trace (``*.pt.trace.json``, which TensorBoard's profiler plugin
    and Perfetto read). The card is synchronised before the trace stops, so
    the block's queued kernels are in it."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
