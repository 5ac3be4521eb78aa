#!/usr/bin/env python3
"""Time the port's fused Griffin-Lim kernel against an earlier design of the
same source, on one GPU, in turns.

    python3 tools/gl_ab_torch.py --base DIR [--out FILE]

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a git-ignored directory)
whose ``exemplars_vc_tpu_torch/csrc/griffin_lim_fused.cu`` is the
table-product design (its C entry takes the re/im planes, the DFT bases and
a grid override); it is built with the same nvcc flags into
``build/kernels_base/``. At the main path's shape (688 frames × 201 bins,
n_fft 400, hop 80) both designs, the plain twin and the graphed cuFFT
yardstick (``chip_smoke.gl_yardstick``) run on the same seeded inputs:
after 6 iterations each must be within 1e-4 relative L2 of the twin; then
300 iterations are timed with CUDA events (median of 5, the twin of 3) in
turns: earlier design, current, yardstick, and back. Prints one JSON
object; ``--out`` writes it to a file too.
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

from chip_smoke import gl_yardstick  # noqa: E402
from exemplars_vc_tpu_torch.dsp import griffin_lim_cuda as glc  # noqa: E402
from exemplars_vc_tpu_torch.kernels import build  # noqa: E402

P = ctypes.c_void_p
I = ctypes.c_int


def build_base(base: Path) -> ctypes.CDLL:
    src = base / "exemplars_vc_tpu_torch" / "csrc" / "griffin_lim_fused.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = REPO / "build" / "kernels_base" / f"griffin_lim_fused-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.evc_gl_fused.restype = I
    lib.evc_gl_fused.argtypes = [P] * 11 + [I] * 5 + [ctypes.c_float, I, P]
    return lib


def base_angles(lib, mag, ang, n_fft, hop, n_iter, momentum):
    """The earlier design through its C entry: complex (F, bins) angles."""
    F, bins = mag.shape
    are, aim = ang.real.contiguous().clone(), ang.imag.contiguous().clone()
    pre, pim = torch.empty_like(are), torch.empty_like(aim)
    frames = torch.empty((2, F, n_fft), dtype=torch.float32, device=mag.device)
    bsr, bsi, bar, bai, inv_w = glc._consts(F, n_fft, hop, "hann", mag.device)
    code = lib.evc_gl_fused(mag.data_ptr(), are.data_ptr(), aim.data_ptr(), pre.data_ptr(),
                            pim.data_ptr(), frames.data_ptr(), bsr.data_ptr(), bsi.data_ptr(),
                            bar.data_ptr(), bai.data_ptr(), inv_w.data_ptr(), F, bins, n_fft,
                            hop, n_iter, momentum / (1.0 + momentum), 0,
                            torch.cuda.current_stream().cuda_stream)
    assert code == 0, code
    return torch.complex(are, aim)


def event_ms(fn, reps: int) -> float:
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
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = build_base(args.base)
    F, n_fft, hop, n_it, mu = 688, 400, 80, 300, 0.9
    rng = np.random.default_rng(0)
    mag = torch.as_tensor(np.abs(rng.standard_normal((F, n_fft // 2 + 1))).astype(np.float32),
                          device=dev)
    ang = torch.as_tensor(np.exp(2j * np.pi * rng.random(tuple(mag.shape))).astype(
        np.complex64), device=dev)
    plan = glc.gl_fused_plan(F, n_fft, hop, torch.cuda.get_device_properties(dev)
                             .multi_processor_count)

    def current(n):
        return glc.gl_angles_fused(mag, ang, n_fft, hop, n, mu)

    twin6 = glc.gl_angles_fused_plain(mag, ang, n_fft, hop, 6, mu)
    replay6, yard6 = gl_yardstick(torch, mag, ang, n_fft, hop, 6, mu)
    replay6()
    six = {"base": base_angles(lib, mag, ang, n_fft, hop, 6, mu), "current": current(6),
           "yardstick": yard6}
    torch.cuda.synchronize()
    rel = {k: float(torch.linalg.norm(v - twin6) / torch.linalg.norm(twin6))
           for k, v in six.items()}
    replay, _ = gl_yardstick(torch, mag, ang, n_fft, hop, n_it, mu)
    runs = {"base": lambda: base_angles(lib, mag, ang, n_fft, hop, n_it, mu),
            "current": lambda: current(n_it), "yardstick": replay}
    times = {k: [] for k in runs}
    for k in ("base", "current", "yardstick", "yardstick", "current", "base"):
        times[k].append(event_ms(runs[k], 5))
    rec = {"card": smi, "shape": f"{F}x{n_fft // 2 + 1}, n_fft {n_fft}, hop {hop}",
           "plan": {k: v for k, v in plan.items() if k != "radices"},
           "iterations": n_it, "rel_l2_to_twin_after_6": rel,
           "ms": {k: [round(t, 6) for t in v] for k, v in times.items()},
           "twin_ms": round(event_ms(lambda: glc.gl_angles_fused_plain(mag, ang, n_fft, hop, n_it,
                                                                       mu), 3), 6)}
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if max(rel.values()) > 1e-4:
        sys.exit(f"a design disagrees with the twin after 6 iterations: {rel}")


if __name__ == "__main__":
    main()
