#!/usr/bin/env python3
"""Time the port's dictionary stage against another checkout of the
repository, on one GPU, in turns (other, this, this, other).

    python3 tools/dicts_ab_torch.py --base DIR [--runs 9] [--out FILE]

``DIR`` is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into a git-ignored directory). Each turn is a
fresh process with that checkout first on ``sys.path``: it builds the
stand-in corpus, converts once (kernel builds, cuFFT plans), then times
``pipelines.convert._aligned_dicts`` from ``--runs`` fresh stores with the
device fenced before and after (the ``dicts`` stage of
``convert_utterance(sync_stages=True)``: pair MFCC, batched DTW, the store's
copy, both |STFT| batches, the exemplar gather), and the wall of as many
whole warm conversions. Prints one JSON object a turn, then their summary;
``--out`` writes all of it as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def worker(runs: int) -> None:
    import torch

    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.pipelines.convert import _aligned_dicts, convert_utterance

    dev = torch.device("cuda:0")
    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    with tempfile.TemporaryDirectory(prefix="evc_dicts_ab_") as root:
        data, src, _ = build_standin_corpus(os.path.join(root, "corpus"))
        convert_utterance(cfg, ArtifactStore(os.path.join(root, "warm")), data, src, nb_file=8,
                          device=dev)
        dicts_ms, convert_ms = [], []
        for k in range(runs):
            store = ArtifactStore(os.path.join(root, f"d{k}"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _aligned_dicts(cfg, store, data, 8, dev)
            torch.cuda.synchronize()
            dicts_ms.append((time.perf_counter() - t0) * 1e3)
            store.flush()
        for k in range(runs):
            store = ArtifactStore(os.path.join(root, f"c{k}"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            convert_utterance(cfg, store, data, src, nb_file=8, device=dev)
            torch.cuda.synchronize()
            convert_ms.append((time.perf_counter() - t0) * 1e3)
            store.flush()
    print(json.dumps({"dicts_ms": dicts_ms, "convert_ms": convert_ms}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="root of the other checkout")
    ap.add_argument("--runs", type=int, default=9)
    ap.add_argument("--out")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.runs)
        return
    if not args.base:
        ap.error("--base DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    roots = {"base": Path(args.base).resolve(), "this": REPO}
    turns = []
    for which in ("base", "this", "this", "base"):
        env = dict(os.environ, PYTHONPATH=str(roots[which]))
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", "--runs",
                            str(args.runs)], cwd=str(roots[which]), env=env,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            sys.exit(f"{which} failed:\n{r.stderr[-3000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        rec["checkout"] = which
        turns.append(rec)
        print(json.dumps({"checkout": which,
                          "dicts_ms_median": statistics.median(rec["dicts_ms"]),
                          "dicts_ms_min": min(rec["dicts_ms"]),
                          "convert_ms_median": statistics.median(rec["convert_ms"]),
                          "dicts_ms": [round(v, 3) for v in rec["dicts_ms"]]}), flush=True)
    summary = {"card": card}
    for which in ("base", "this"):
        for key in ("dicts_ms", "convert_ms"):
            vals = [v for t in turns if t["checkout"] == which for v in t[key]]
            summary[f"{which}_{key}_median"] = statistics.median(vals)
            summary[f"{which}_{key}_min"] = min(vals)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary, "turns": turns}) + "\n")


if __name__ == "__main__":
    main()
