"""What a ``torch.profiler`` trace of the traced window says.

The window is the ``benchmark.window`` annotation the harness puts around
the timed loop. Device time is the union of the kernel, copy and set
intervals inside it (``busy_s``); the idle gaps are the stretches of the
window outside that union, each named by the host event that overlaps it
most (the shortest where several overlap it as much). ``runtime_s`` sums
the host's CUDA runtime and driver calls inside the window by name.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "benchmark.window"


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged (start, end) rows of intervals sorted by start."""
    if len(iv) == 0:
        return iv
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def summarize(path: str, top: int = 10) -> dict | None:
    """{busy_s, window_s, kernels, device_ops, idle_gaps, runtime_s} of a Chrome trace,
    or None when it has no window annotation or no device event."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name, kernels = [], defaultdict(float), 0
    runtime = defaultdict(float)
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        if t <= w0 or s >= w1:
            continue
        s, t = max(s, w0), min(t, w1)
        if cat in DEVICE_CATS:
            dev.append((s, t))
            by_name[e["name"][:200]] += (t - s) * 1e-6
            kernels += cat == "kernel"
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((s, t, e["name"][:200]))
            if cat in ("cuda_runtime", "cuda_driver"):
                runtime[e["name"][:200]] += (t - s) * 1e-6
    if not dev:
        return None
    merged = _union(np.asarray(sorted(dev)))
    busy = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6
    edges = np.concatenate([[w0], merged.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:top]]
    hs = np.asarray([h[0] for h in host]) if host else np.zeros(0)
    ht = np.asarray([h[1] for h in host]) if host else np.zeros(0)
    idle = []
    for g0, g1 in longest:
        label = "host"
        if len(hs):
            over = np.minimum(ht, g1) - np.maximum(hs, g0)
            best = over.max()
            if best > 0:
                cand = np.flatnonzero(over == best)
                label = host[int(cand[np.argmin(ht[cand] - hs[cand])])][2]
        idle.append([label, float(g1 - g0) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": (w1 - w0) * 1e-6, "kernels": kernels,
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": idle,
            "runtime_s": dict(runtime)}


def profile_window(run, workdir: str):
    """Run ``run()`` under the profiler inside the window annotation; returns
    (its result, :func:`summarize` of the trace). The trace file is deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return out, summarize(path)
    finally:
        os.remove(path)
