"""The measured window: one caller in a closed loop over an entry's pool.

A pool is a list of sessions, each a list of call inputs: a request is a
session of one call (``serve``), a live stream a session of many pushes
(``stream``). Each session starts with the entry driver's ``start()``,
which gives the callable of its calls; each call returns (answer, MU steps
or None). The next call starts when the last returns, the window ends with
the call that returns past its deadline, and a call that raises counts as
failed while the loop goes on.
"""

from __future__ import annotations

import importlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Record:
    index: int              # the session's place in the run (pool index modulo its length)
    seconds: float          # host wall of the call
    audio_s: float          # input audio the call converted
    ok: bool
    output: np.ndarray | None = None
    steps: int | None = None  # MU steps the program reports, where it does


@dataclass
class Window:
    records: list = field(default_factory=list)
    wall_s: float = 0.0
    wraps: int = 0          # times the pool ran out and started again

    @property
    def attempted(self) -> int:
        return len(self.records)

    @property
    def failed(self) -> int:
        return sum(not r.ok for r in self.records)


def warm(driver, sessions) -> None:
    for session in sessions:
        call = driver.start()
        for item in session:
            call(item)


def closed_loop(driver, pool, seconds: float) -> Window:
    win = Window()
    t_start = time.perf_counter()
    s = 0
    while True:
        session = pool[s % len(pool)]
        if s and s % len(pool) == 0:
            win.wraps += 1
        call = driver.start()
        done = False
        for k, item in enumerate(session):
            t0 = time.perf_counter()
            try:
                (out, steps), ok = call(item), True
            except Exception as e:    # a failed call counts, and the loop goes on
                print(f"session {s} call {k} failed: {e!r}", file=sys.stderr)
                out, steps, ok = None, None, False
            t1 = time.perf_counter()
            win.records.append(Record(s, t1 - t0, driver.audio_s(item), ok, out, steps))
            if t1 - t_start >= seconds:
                done = True
                break
        s += 1
        if done:
            break
    win.wall_s = time.perf_counter() - t_start
    return win


def free_program_state() -> None:
    """Drop the program's memoised dictionaries and captured graphs, so the
    reference that runs next has the card's memory."""
    for module, cache in (("exemplars_vc_tpu_torch.pipelines.convert", "_DICTS_MEMO"),
                          ("exemplars_vc_tpu_torch.dsp.griffin_lim", "_loops")):
        held = getattr(importlib.import_module(module), cache, None)
        if hasattr(held, "clear"):
            held.clear()
