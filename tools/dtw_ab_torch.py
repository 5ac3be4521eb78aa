#!/usr/bin/env python3
"""Time the port's DTW kernels against an earlier design of the same source,
on one GPU, in turns (earlier, current, current, earlier).

    python3 tools/dtw_ab_torch.py --base DIR [--out FILE]

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a git-ignored directory);
its ``exemplars_vc_tpu_torch/csrc/dtw_wavefront.cu`` is built with the same
nvcc flags into ``build/kernels_base/``. Both designs run through their C
entries (ctypes) on the same inputs and must give equal bytes (codes, costs,
paths). Shapes: the main path's 8 pairs × 1408 frames (lengths 1100–1408,
20 MFCC), the MCD's one pair of 683 × 683 (26 mel-cepstral coefficients), and
one long pair of 19,370 × 2000. Times are CUDA events: the median of 7 single
launches and of 5 runs of 20 back-to-back launches (per launch). The base's
C entries are those of the first design (no plan arguments). Prints one JSON object a line; ``--out`` writes them all as one JSON list.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from exemplars_vc_tpu_torch.align import dtw_cuda  # noqa: E402
from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist  # noqa: E402
from exemplars_vc_tpu_torch.kernels import build  # noqa: E402

P = ctypes.c_void_p
I = ctypes.c_int


def build_base(base: Path) -> ctypes.CDLL:
    src = base / "exemplars_vc_tpu_torch" / "csrc" / "dtw_wavefront.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = REPO / "build" / "kernels_base" / f"dtw_wavefront-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.evc_dtw_wavefront.argtypes = [P, P, I, I, I, P, P, P]
    lib.evc_dtw_backtrace.argtypes = [P, P, I, I, I, P, P, P, P]
    return lib


def inputs(n, ta, tb, dim, lo, seed, dev):
    rng = np.random.default_rng(seed)
    fa = torch.as_tensor(rng.standard_normal((n, ta, dim)).astype(np.float32), device=dev)
    fb = torch.as_tensor(rng.standard_normal((n, tb, dim)).astype(np.float32), device=dev)
    la = rng.integers(int(lo * ta), ta + 1, n) if n > 1 else np.array([ta])
    lb = rng.integers(int(lo * tb), tb + 1, n) if n > 1 else np.array([tb])
    lens = torch.as_tensor(np.stack([la, lb], 1).astype(np.int32), device=dev)
    return pairwise_sqdist(fa, fb).contiguous(), lens


def event_ms(fn, reps: int, inner: int = 1) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


class Designs:
    """The two designs' C entries on one set of inputs and output buffers."""

    def __init__(self, base_lib, C, lens, plan):
        self.cur = build.load_library("dtw_wavefront")
        self.cur.evc_dtw_wavefront.argtypes = [P, P, I, I, I, I, I, I, P, P, P]
        self.cur.evc_dtw_backtrace.argtypes = [P, P, I, I, I, P, P, P, P]
        self.base, self.C, self.lens, self.plan = base_lib, C, lens, plan
        self.n, self.ta, self.tb = C.shape
        mp = self.ta + self.tb - 1
        self.out = {k: (torch.empty(self.n, device=C.device),
                        torch.empty((self.n, mp, self.ta), dtype=torch.int8, device=C.device),
                        torch.empty((self.n, mp), dtype=torch.int32, device=C.device),
                        torch.empty((self.n, mp), dtype=torch.int32, device=C.device),
                        torch.empty(self.n, dtype=torch.int32, device=C.device))
                    for k in ("base", "cur")}
        self.stream = torch.cuda.current_stream().cuda_stream

    def wavefront(self, which):
        cost, dirs = self.out[which][:2]
        if which == "base":
            code = self.base.evc_dtw_wavefront(self.C.data_ptr(), self.lens.data_ptr(), self.n,
                                               self.ta, self.tb, cost.data_ptr(),
                                               dirs.data_ptr(), self.stream)
        else:
            p = self.plan
            code = self.cur.evc_dtw_wavefront(self.C.data_ptr(), self.lens.data_ptr(), self.n,
                                              self.ta, self.tb, p["rows_per_lane"],
                                              p["cluster"], p["warps_per_cta"], cost.data_ptr(),
                                              dirs.data_ptr(), self.stream)
        assert code == 0, (which, code)

    def backtrace(self, which):
        _, dirs, pi, pj, pl = self.out[which]
        lib = self.base if which == "base" else self.cur
        code = lib.evc_dtw_backtrace(dirs.data_ptr(), self.lens.data_ptr(), self.n, self.ta,
                                     self.tb, pi.data_ptr(), pj.data_ptr(), pl.data_ptr(),
                                     self.stream)
        assert code == 0, (which, code)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    base_lib = build_base(args.base)
    rows = []

    def emit(rec):
        rec = {"card": smi, **rec}
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    shapes = [("main 8x1408^2", 8, 1408, 1408, 20, 1100 / 1408),
              ("mcd 1x683^2", 1, 683, 683, 26, 1.0),
              ("long 1x19370x2000", 1, 19370, 2000, 4, 1.0)]
    for name, n, ta, tb, dim, lo in shapes:
        C, lens = inputs(n, ta, tb, dim, lo, 0, dev)
        plan = dtw_cuda.dtw_wavefront_plan(n, ta, n_sms)
        ds = Designs(base_lib, C, lens, plan)
        for w in ("base", "cur"):
            ds.wavefront(w)
            ds.backtrace(w)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(ds.out["base"], ds.out["cur"]))
        path_len = ds.out["cur"][4]
        reps_single = 7 if ta < 10_000 else 3
        inner = 20 if ta < 10_000 else 2
        t = {f"{k}_{w}_{mode}": [] for k in ("wavefront", "backtrace") for w in ("base", "cur")
             for mode in ("single", "batched")}
        for w in ("base", "cur", "cur", "base"):
            for k in ("wavefront", "backtrace"):
                fn = (lambda w=w: ds.wavefront(w)) if k == "wavefront" else \
                    (lambda w=w: ds.backtrace(w))
                t[f"{k}_{w}_single"].append(event_ms(fn, reps_single))
                t[f"{k}_{w}_batched"].append(event_ms(fn, 5, inner))
        n_diag = ta + tb - 1
        emit({"shape": name, "n": n, "ta": ta, "tb": tb, "plan": plan, "equal_bytes": equal,
              "path_len_sum": int(path_len.sum()), "n_diag": n_diag,
              **{k: [round(x, 6) for x in v] for k, v in t.items()}})
        if not equal:
            sys.exit(f"{name}: the designs disagree")
        del ds, C
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
