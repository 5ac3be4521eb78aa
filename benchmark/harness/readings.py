"""The readings the limits of the correctness check are set from.

    python3 -m benchmark.harness.readings --workload stft.serve --seeds 12 --seconds 4

In one process, on the card: one set-up, then for each seed a short window
at the cell's own load (long enough to finish the mix's longest requests)
and the check of its sample twice: the program against the reference (the
lower reading is the largest of these over the seeds) and the control, the
reference computed in TF32 in the program's place (the upper reading is the
smallest). One JSON line a seed, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from benchmark.harness import check, loop
from benchmark.harness.bench import build_corpus, program_config
from benchmark.harness.spec import Cell, load_cell


def readings(cell: Cell, seeds: list[int], seconds: float, device, pool: int = 64):
    """Yield {seed, calls, program, control, problems, rows, control_rows} a seed."""
    from exemplars_vc_tpu_torch.io.store import ArtifactStore

    params = dict(cell.traffic, pool=pool)
    settings, entry = cell.settings, cell.entry
    workdir = tempfile.mkdtemp(prefix="evc-readings-")
    store = ArtifactStore(os.path.join(workdir, "store"))
    try:
        data_path = build_corpus(cell.config, workdir)
        driver = entry.Driver(program_config(settings), store, data_path, params, device)
        built: dict = {}
        for seed in seeds:
            warm, reqs = entry.requests(params, settings, seed, os.path.join(workdir, f"s{seed}"),
                                        device)
            loop.warm(driver, warm)
            win = loop.closed_loop(driver, reqs, seconds)
            prog, problems, rows = check.compare(entry, win, reqs, settings, params, data_path,
                                                 seed, device, built=built)
            ctrl, _, ctrl_rows = check.compare(entry, win, reqs, settings, params, data_path,
                                               seed, device, control=True, built=built)
            yield {"seed": seed, "calls": win.attempted, "program": prog, "control": ctrl,
                   "problems": problems, "rows": rows, "control_rows": ctrl_rows}
    finally:
        store.flush()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 7)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    rows = []
    t0 = time.perf_counter()
    for row in readings(cell, seeds, args.seconds, torch.device("cuda:0")):
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows), "seconds": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(0)}
    for k in sorted({n for r in rows for n in r["program"]}):
        prog = [r["program"][k] for r in rows if k in r["program"]]
        ctrl = [r["control"][k] for r in rows if k in r["control"]]
        summary[k] = {"lower": max(prog, default=None), "upper": min(ctrl, default=None),
                      "program": prog, "control": ctrl}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
