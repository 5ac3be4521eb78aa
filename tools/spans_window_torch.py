#!/usr/bin/env python3
"""A cell's traced window, read from its exported Chrome trace and from the
program's spans: what tracing costs, what the idle gaps are called, and
where the window's ``cudaFree`` and ``cudaFreeHost`` time falls.

    python3 tools/spans_window_torch.py --workload stft.serve --seeds 7,8,9 \\
        [--root DIR] [--out FILE] [--small]

``--root`` is the root of the checkout whose program and benchmark run
(default: this one), so the parent commit unpacked into a git-ignored
directory runs the same window. One process sets the cell up as
``benchmark/run.py`` does (corpus, configuration, prepared entry); then for
each seed its requests, their warm-up and a ``trace_seconds`` window in a
closed loop under ``torch.profiler`` (CPU and CUDA activity, inside the
``benchmark.window`` annotation), exported and read:

- ``calls`` and ``call_ms``: the window's calls and their mean host wall,
  the cost of tracing when compared with another checkout on the same
  seeds; ``root_ms``: the mean host ms of the ``convert`` or ``push`` spans
  (None where the program keeps no spans);
- ``idle_gaps``: the ten longest gaps as ``benchmark.harness.trace``
  names them, and ``gaps_named_by_spans``, how many carry a span's name;
- ``free_s``: the window's ``cudaFree`` and ``cudaFreeHost`` seconds;
- ``spans``: per span name its count and mean host and device ms.

One JSON line a seed on stdout (and appended to ``--out``). ``--small``
cuts the cell as the benchmark's CPU tests do, for a rehearsal on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FREES = ("cudaFree", "cudaFreeHost")


def read_trace(path: str, names: set) -> dict:
    """The free calls inside the window, and the idle gaps, from an
    exported Chrome trace."""
    from benchmark.harness.trace import WINDOW, summarize

    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    win = next(e for e in events if e.get("name") == WINDOW)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    free = defaultdict(float)
    for e in events:
        if e.get("name") in FREES and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            s, t = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if t > s:
                free[e["name"]] += (t - s) * 1e-6
    summary = summarize(path) or {}
    gaps = summary.get("idle_gaps", [])
    return {"busy_s": summary.get("busy_s"), "window_s": summary.get("window_s"),
            "idle_gaps": gaps, "gaps_named_by_spans": sum(g[0] in names for g in gaps),
            "free_s": dict(free)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--out")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import loop
    from benchmark.harness.bench import build_corpus, card_and_limit, program_config
    from benchmark.harness.spec import load_cell
    from benchmark.harness.trace import WINDOW
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.obs import profiling

    cuda = torch.cuda.is_available()
    device = torch.device("cuda:0" if cuda else "cpu")
    if args.small:
        from benchmark.tests.small import small_cell
        cell = small_cell(args.workload, root)
    else:
        cell = load_cell(args.workload, root)
    params, settings, entry = cell.traffic, cell.settings, cell.entry
    has_spans = hasattr(profiling, "cursor")
    root_name = "push" if params["entry"] == "stream" else "convert"
    names = {"convert", "push", "features", "solve", "synthesis", "nmf", "world.f0",
             "world.cheaptrick", "world.d4c"}
    workdir = tempfile.mkdtemp(prefix="evc-spans-")
    store = ArtifactStore(os.path.join(workdir, "store"))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    card = card_and_limit(torch) if cuda else ("cpu", "none")
    try:
        data_path = build_corpus(cell.config, workdir)
        driver = entry.Driver(program_config(settings), store, data_path, params, device)
        for seed in (int(s) for s in args.seeds.split(",")):
            warm, pool = entry.requests(params, settings, seed, os.path.join(workdir, str(seed)),
                                        device)
            loop.warm(driver, warm)
            if cuda:
                torch.cuda.synchronize()
            before = profiling.cursor() if has_spans else None
            with profile(activities=acts) as prof:
                with record_function(WINDOW):
                    win = loop.closed_loop(driver, pool, params["trace_seconds"])
                    if cuda:
                        torch.cuda.synchronize()
            row = {"workload": args.workload, "seed": seed, "root": str(root),
                   "card": card[0], "power_limit": card[1], "calls": win.attempted,
                   "failed": win.failed,
                   "call_ms": statistics.fmean(r.seconds for r in win.records) * 1e3}
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            row.update(read_trace(path, names))
            os.remove(path)
            row["root_ms"] = row["spans"] = None
            if has_spans:
                recs = profiling.spans(before, profiling.cursor())
                by = defaultdict(list)
                for s in recs:
                    by[s["name"]].append(s)
                row["spans"] = {
                    n: {"count": len(v), "host_ms": statistics.fmean(s["host_ms"] for s in v),
                        "device_ms": (statistics.fmean(s["device_ms"] for s in v)
                                      if v[0]["device_ms"] is not None else None)}
                    for n, v in sorted(by.items())}
                roots = [s["host_ms"] for s in recs
                         if s["parent"] is None and s["name"] == root_name]
                row["root_ms"] = statistics.fmean(roots) if roots else None
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        store.flush()
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
