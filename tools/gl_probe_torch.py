#!/usr/bin/env python3
"""Where the fused Griffin-Lim kernel's time goes: time variants of
``csrc/griffin_lim_fused.cu`` with one part of the iteration taken out, on
one GPU.

    python3 tools/gl_probe_torch.py [--out FILE]

Each variant is the current source with a textual patch (below), built with
the same nvcc flags into ``build/kernels_probe/`` (all builds at once) and
run through ``gl_angles_fused`` at the main path's shape (688 × 201, n_fft
400, hop 80, 300 iterations) with CUDA events, median of 5, in turns
(full, variants..., full). The variants compute wrong angles; only
their times mean something: the full kernel's time less a variant's is what
the part taken out costs on the critical path. Then the full kernel under
other plans (tile, threads), the same way: tiles of fewer frames at 256
threads put two CTAs on an SM. Prints one JSON object.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from exemplars_vc_tpu_torch.dsp import griffin_lim_cuda as glc  # noqa: E402
from exemplars_vc_tpu_torch.kernels import build  # noqa: E402

SRC = REPO / "exemplars_vc_tpu_torch" / "csrc" / "griffin_lim_fused.cu"
FFT_CALLS = [("gl_fft(in, other, sc, s.tw, nt, m)", "in")]
VARIANTS = {
    "full": [],
    "no_fft": FFT_CALLS,
    "no_barrier": [("    cg::this_grid().sync();", "    __syncthreads();")],
    "no_frame_store": [("        o[0] = s.ws[2 * j] * w.x;\n        o[1] = s.ws[2 * j + 1] * -w.y;",
                        "")],
    "no_ola_loads": [("        v[q] = lo + q <= hi ? __ldcg(src + (size_t)q * (n - hop)) : 0.0;",
                      "        v[q] = lo + q <= hi ? (double)q : 0.0;")],
    "no_spectrum": [("      if (even)\n        gl_spectrum<true>(U + f * m, nxt + f * m, s, nullptr, "
                     "out, f, k, n, m, mom);", "      if (false)\n        gl_spectrum<true>(U + f "
                     "* m, nxt + f * m, s, nullptr, out, f, k, n, m, mom);")],
}


def build_variant(name: str) -> ctypes.CDLL:
    text = SRC.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: patch target not in the source: {old[:60]!r}")
        text = text.replace(old, new)
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    out_dir = REPO / "build" / "kernels_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"griffin_lim_fused-{name}-{digest}.cu"
    src.write_text(text)
    lib = out_dir / f"griffin_lim_fused-{name}-{digest}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(str(lib))


def event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    F, n_fft, hop, n_it = 688, 400, 80, 300
    rng = np.random.default_rng(0)
    mag = torch.as_tensor(np.abs(rng.standard_normal((F, n_fft // 2 + 1))).astype(np.float32),
                          device=dev)
    ang = torch.as_tensor(np.exp(2j * np.pi * rng.random(tuple(mag.shape))).astype(
        np.complex64), device=dev)
    plan = glc.gl_fused_plan(F, n_fft, hop, torch.cuda.get_device_properties(dev)
                             .multi_processor_count)
    times = {v: [] for v in VARIANTS}
    for v in list(VARIANTS) + ["full"]:
        glc._lib = lambda lib=libs[v]: lib
        times[v].append(event_ms(lambda: glc.gl_angles_fused(mag, ang, n_fft, hop, n_it, 0.9)))
    rec = {"card": smi, "shape": f"{F}x{n_fft // 2 + 1}, n_fft {n_fft}, hop {hop}",
           "iterations": n_it, "plan": {k: v for k, v in plan.items() if k != "radices"},
           "ms": {v: [round(t, 6) for t in ts] for v, ts in times.items()}}
    glc._lib = lambda lib=libs["full"]: lib
    rec["plans"] = {}
    for tile, threads in ((plan["tile"], plan["threads"]), (plan["tile"], 256), (3, 256),
                          (4, 256), (plan["tile"], plan["threads"])):
        p = dict(plan, tile=tile, threads=threads)
        rec["plans"].setdefault(f"tile {tile}, {threads} threads", []).append(round(event_ms(
            lambda: glc.gl_angles_fused(mag, ang, n_fft, hop, n_it, 0.9, _plan=p)), 6))
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
