"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (counted in ``setup_s``, from the start of the process to the first
timed call): the 20-pair stand-in corpus copied under the run's directory,
the request pool drawn from the seed, the program's configuration from the
cell's settings, the entry prepared (the dictionaries built on the card, the
kernels built on a checkout's first run), and a warm-up on requests of the
cell's own lengths outside the pool. Then the window: the entry in a closed
loop for ``--seconds``; with ``--trace 1`` a ``trace_seconds`` window under
``torch.profiler`` instead. Then the program's memory peak, in a traced run
the entry's own observations (``serve``: the window's requests again
through the program's fenced stage timer), and the comparison of a sample
with the plain reference. What a request is, how it is called and how the
reference answers it is the entry's (``benchmark/entries``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from benchmark.harness import check, loop, traffic
from benchmark.harness.spec import Cell, load_cell
from benchmark.harness.stats import pct
from benchmark.harness.trace import profile_window

FORBIDDEN = ("jax", "jaxlib", "flax", "exemplars_vc_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_and_limit(torch) -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        limit = out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        limit = "unknown"
    return name, limit


def build_corpus(config: dict, root: str) -> str:
    """The stand-in parallel corpus: pair k of the recipe as
    ``<root>/data/<src>/pNN.wav`` and ``<root>/data/<tar>/pNN.wav``."""
    s = config["settings"]
    data = os.path.join(root, "data")
    k = 0
    for group in config["corpus"]:
        for utt in group["utterances"]:
            k += 1
            for spk, kind in ((s["data.src"], group["src"]), (s["data.tar"], group["tar"])):
                os.makedirs(os.path.join(data, spk), exist_ok=True)
                shutil.copyfile(traffic.SPEECH_DIR / "loo" / f"{kind}_{utt}.wav",
                                os.path.join(data, spk, f"p{k:02d}.wav"))
    return data


def program_config(settings: dict):
    from exemplars_vc_tpu_torch.config import load_config

    def text(v):
        return str(v).lower() if isinstance(v, bool) else str(v)

    cfg = load_config(overrides=[f"{k}={text(v)}" for k, v in settings.items()])
    for k, v in settings.items():
        sec, _, key = k.partition(".")
        if getattr(getattr(cfg, sec), key) != v:
            raise ValueError(f"the program's {k} is {getattr(getattr(cfg, sec), key)!r}, not {v!r}")
    return cfg


def end_to_end(cell: Cell, win, setup_s: float) -> dict:
    ok = [r for r in win.records if r.ok]
    lat = [r.seconds * 1e3 if r.ok else win.wall_s * 1e3 for r in win.records]
    values = {"audio_s_per_s": sum(r.audio_s for r in ok) / win.wall_s,
              cell.entry.LATENCY: pct(lat, 0.95), "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def per_layer(cell: Cell, obs: dict, before: dict, after: dict) -> dict:
    """Each per-layer metric its reader finds, from the traced run's
    observations and the reader's own snapshots."""
    metrics = {}
    for m in cell.per_layer:
        name = m["name"]
        seen = dict(obs, snapshot=(before[name], after[name])) if name in before else obs
        v = cell.readers[name].read(seen)
        if v is not None:
            metrics[name] = {"value": v, "unit": m["unit"]}
    return metrics


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """The result line of one run (without the module check)."""
    import torch

    from exemplars_vc_tpu_torch.io.store import ArtifactStore

    params, settings, entry = cell.traffic, cell.settings, cell.entry
    workdir = tempfile.mkdtemp(prefix="evc-bench-")
    store = None
    marks = [("start", time.perf_counter())]
    try:
        torch.zeros(1, device=device)               # the CUDA context
        marks.append(("context", time.perf_counter()))
        data_path = build_corpus(cell.config, workdir)
        warm, pool = entry.requests(params, settings, seed, os.path.join(workdir, "requests"),
                                    device)
        marks.append(("requests", time.perf_counter()))
        cfg = program_config(settings)
        store = ArtifactStore(os.path.join(workdir, "store"))
        driver = entry.Driver(cfg, store, data_path, params, device)
        marks.append(("prepare", time.perf_counter()))
        loop.warm(driver, warm)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        window_s = min(seconds, params["trace_seconds"]) if trace else seconds
        steps = ", ".join(f"{b[0]} {b[1] - a[1]:.2f}" for a, b in zip(marks, marks[1:]))
        log(f"set-up {setup_s:.2f} s (imports {marks[0][1] - t_start:.2f}, {steps}); "
            f"window of {window_s} s")
        obs = {"entry": params["entry"], "prepare_s": driver.prepare_s}
        if trace:
            snaps = {n: r.snapshot for n, r in cell.readers.items() if hasattr(r, "snapshot")}
            before = {n: f() for n, f in snaps.items()}
            win, summary = profile_window(lambda: loop.closed_loop(driver, pool, window_s),
                                          workdir)
            after = {n: f() for n, f in snaps.items()}
            obs.update(calls=win.attempted, trace=summary)
        else:
            win = loop.closed_loop(driver, pool, seconds)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if trace and hasattr(entry, "observe"):
            obs.update(entry.observe(driver, win, pool))
        log(f"window {win.wall_s:.2f} s, {win.attempted} calls, {win.failed} failed, "
            f"{win.wraps} pool wraps")
        del driver
        loop.free_program_state()
        numbers, problems, rows = check.compare(entry, win, pool, settings, params, data_path,
                                                seed, device)
        for r in rows:
            log(f"checked {r['key']}: " + ", ".join(
                f"{k} {v:.3g}" for k, v in r.items() if k not in ("key", "steps", "ref_steps"))
                + f", MU steps {r['steps']} (reference {r['ref_steps']})")
    finally:
        if store is not None:
            store.flush()
        shutil.rmtree(workdir, ignore_errors=True)
    # the numbers the cell's limits file holds are compared; a missing one fails
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in cell.limits.items()}
    failing = [k for k, c in checks.items() if c["value"] is None or not c["value"] <= c["limit"]]
    result = {"correct": not problems and bool(checks) and not failing,
              "attempted": win.attempted, "failed": win.failed,
              "metrics": per_layer(cell, obs, before, after) if trace
              else end_to_end(cell, win, setup_s)}
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "memory_peak_bytes": peak}
    summary = obs.get("trace")
    if trace and summary:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = dict(checks, problems=problems)
    return result


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda:0")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    name, limit = card_and_limit(torch)       # after the run: nvidia-smi is no part of set-up
    log(f"{name}, power limit {limit}")
    bad = forbidden_modules()
    if bad:
        log(f"loaded in the measured process: {', '.join(bad)}")
        return 3
    result["device"].update(kind=name, count=cell.chips, power_limit=limit)
    checks = result["checks"]
    for p in checks["problems"]:
        log(f"check problem: {p}")
    for k, c in checks.items():
        if k != "problems":
            log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
