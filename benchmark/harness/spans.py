"""What the program's spans say about a traced window.

The program records a span for each named ``Timer`` while a profiler
records (``exemplars_vc_tpu_torch.obs.profiling``): ``convert`` (a served
request) over ``features``, ``solve`` and ``synthesis``; ``push`` (a
streamed chunk) over ``solve`` and ``synthesis``; ``nmf`` (the solver, with
F, K, D and n_iter) in each ``solve``; ``world.f0``, ``world.cheaptrick``
and ``world.d4c`` in a WORLD ``features``; ``griffin_lim.capture`` at each
miss of the graph cache and each capture. A reader's ``snapshot`` is
:func:`cursor`, taken before and after the window, and its ``read`` takes
the window's spans with :func:`window`. A program without spans, and a run
off the card (no device times), give None.
"""

from __future__ import annotations

import importlib


def _profiling():
    return importlib.import_module("exemplars_vc_tpu_torch.obs.profiling")


def cursor():
    """The program's span cursor, or None where the program keeps no spans."""
    f = getattr(_profiling(), "cursor", None)
    return None if f is None else f()


def window(obs: dict) -> list | None:
    """The spans recorded between the snapshots of ``obs``, or None."""
    before, after = obs.get("snapshot") or (None, None)
    if before is None or after is None:
        return None
    return _profiling().spans(before, after)


def roots(spans: list, name: str) -> list:
    """The root spans called ``name`` (a request, a push), when each has its
    device time: the run was on the card."""
    rows = [s for s in spans if s["parent"] is None and s["name"] == name]
    return rows if rows and all(s["device_ms"] is not None for s in rows) else []


def per_root_ms(obs: dict, root: str, name: str) -> float | None:
    """Device ms of the spans called ``name`` under the window's ``root``
    spans, summed, over the number of those roots: the mean a request (a
    push) where each root has one."""
    spans = window(obs)
    top = roots(spans or [], root)
    if not top:
        return None
    ids = {r["id"] for r in top}
    rows = [s for s in spans if s["name"] == name and s["root"] in ids]
    return sum(s["device_ms"] for s in rows) / len(top) if rows else None
