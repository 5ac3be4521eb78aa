#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``exemplars_vc_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the nvcc builds of the three kernel sources under
   ``exemplars_vc_tpu_torch/csrc`` (``dtw_wavefront``, ``nmf_mu``,
   ``griffin_lim_fused``), all started together;
2. each kernel against its plain-PyTorch twin on the card, at the main
   path's shapes, on seeded numpy inputs, with CUDA-event times (median of
   7; 3 for the 300-iteration Griffin-Lim runs and the DTW twins), each
   beside its bound (the larger of its bytes over 3.35 TB/s and its fp32
   operations over 67 TFLOP/s) and its roofline share: the DTW wavefront and
   backtrace must be exactly equal (the DP is min/add only) at the main
   path's 8 × 1408² (timed, with the time a diagonal step), the MCD's
   1 × 683² (timed), 1409 × 1300, 300 × 517, 517 × 300 (with la = 1 and
   lb = 1 rows) and the longest Ta the wrappers take, 19,370 × 2000; ``nmf_recon``,
   ``nmf_update`` and the one-kernel MU iteration ``nmf_mu_fused`` within a
   relative error max|kernel − plain| / max|plain| of 1e-5 for one call and
   1e-4 after 10 MU steps (they sum in different orders), all three also at
   K = 115,200 (where ``nmf_update`` is timed beside its twin too), with the
   launch plans of the two split-K cluster kernels (grid, cluster, tile,
   shared bytes, clusters the card holds at once) and of ``nmf_update``
   (CTAs, waves at the CTAs an SM that the occupancy query reports, shared
   bytes); the fused Griffin-Lim ``gl_angles_fused`` after 6
   iterations within 1e-4 relative L2 of its twin's unit phases and, against
   a float64 run of the twin, a mean phase error no more than twice the
   float32 twin's own (+ 1e-7): float32 rounding alone moves the phase of a
   bin whose update nearly cancels by ~1e-3 at this shape, so the
   element-wise max is reported, not gated. Timed at 300 iterations beside
   its twin, the production ``griffin_lim`` and the grid-sync floor;
3. the main path: ``convert_utterance`` on the stand-in corpus (8 pairs,
   held-out utterance 100162) with the default config, launch counters
   reset just before and read just after; every kernel of the default path
   must have launched and neither fused kernel, the audio must be finite
   and of the input's length, n_iter ≤ max_iter and the MCD finite. Then
   three warm runs for audio-seconds per second, and ``torch.profiler`` over
   one more: its summed device time, busy share and the hand-written
   kernels' calls and device time (each warm run uses a fresh store, so the
   dictionary build and its DTW run every time);
4. the fused path (opt-in, as in the JAX package), counters reset just
   before: on the same corpus and input, ``nmf_activations(fused=True)``
   against the default solve (equal n_iter, H bit-equal: both sum P over the
   same K slices and den over d ascending), then
   ``gl_angles_fused`` (300 iterations) seeded with the input's phase and a
   centered ISTFT, against the production ``griffin_lim`` on the same Y:
   finite audio of the input's length and a spectral convergence within
   the JAX rule sc_fused < 1.3·sc_gl + 0.02;
5. a small input (3 pairs, 20 MU iterations, 5 Griffin-Lim iterations)
   converted on the card and on the CPU (plain twins, which the CPU tests
   hold to the JAX reference): converted magnitude and audio within 1e-3
   relative L2, equal n_iter, MCD within 0.05 dB.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The stand-in MCD is not comparable to the
real corpus's.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn()`` in milliseconds (CUDA events)."""
    import torch

    fn()
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


def wall_ms(fn, reps: int = 3) -> float:
    """Median host wall time of ``fn()`` in milliseconds, fenced by syncs."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn) -> tuple[float | None, dict]:
    """Device time of one ``fn()`` in milliseconds: the summed durations of
    the profiled events that ran on the card (kernels, copies, memsets), None
    if the profiler saw none; and, by event name, its calls and milliseconds.
    Only device-side events are summed: an aten op's own device time repeats
    its kernels'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, per = 0.0, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            total += us
            calls, t = per.get(ev.name, (0, 0.0))
            per[ev.name] = (calls + 1, t + us / 1e3)
    return (total / 1e3 if total > 0 else None), per


def device_ms(fn) -> float | None:
    return device_profile(fn)[0]


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s, fp32
# FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) for moving ``n_bytes`` (each input read once, each
    output written once) and doing ``n_ops`` fp32 operations, and which of
    the two bounds it."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, n_ops / FP32_FLOP_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def phase_kernels(torch, np, dev) -> dict:
    from exemplars_vc_tpu_torch.align import dtw_cuda
    from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist
    from exemplars_vc_tpu_torch.align.dtw_cuda import (
        dtw_backtrace, dtw_backtrace_plain, dtw_wavefront, dtw_wavefront_plain,
        dtw_wavefront_plan)
    from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
    from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import (
        gl_angles_fused, gl_angles_fused_plain, gl_fused_plan, grid_sync_probe)
    from exemplars_vc_tpu_torch.factorize.nmf_cuda import (
        co_resident_clusters, nmf_mu_fused, nmf_mu_fused_plain, nmf_mu_fused_plan, nmf_recon,
        nmf_recon_plain, nmf_recon_plan, nmf_update, nmf_update_plain, nmf_update_plan)

    rng = np.random.default_rng(0)
    out = {}
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # DTW: the main path's dictionary shape (8 pairs, 1408 padded frames, 20
    # MFCC) and the MCD's (one pair of 683 mel-cepstral frames, order 25),
    # timed; then the edges: Ta > 1024 and not a multiple of 32, Ta < Tb,
    # Ta > Tb, la = 1 and lb = 1, and the longest Ta the wrappers take
    def dtw_case(name, n, ta, tb, dim, lens_rows, timed):
        fa = torch.as_tensor(rng.standard_normal((n, ta, dim)).astype(np.float32), device=dev)
        fb = torch.as_tensor(rng.standard_normal((n, tb, dim)).astype(np.float32), device=dev)
        lens = torch.as_tensor(np.asarray(lens_rows, np.int32), device=dev)
        C = pairwise_sqdist(fa, fb).contiguous()
        del fa, fb
        cost_k, dirs_k = dtw_wavefront(C, lens)
        cost_p, dirs_p = dtw_wavefront_plain(C, lens)
        torch.cuda.synchronize()
        if not (torch.equal(dirs_k, dirs_p) and torch.equal(cost_k, cost_p)):
            fail(f"dtw_wavefront != twin at {name}: {int((dirs_k != dirs_p).sum())} codes "
                 f"differ, max cost diff {float((cost_k - cost_p).abs().max())}")
        del dirs_p
        paths_k = dtw_backtrace(dirs_k, lens)
        paths_p = dtw_backtrace_plain(dirs_k, lens)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(paths_k, paths_p)):
            fail(f"dtw_backtrace != twin at {name}")
        plan = dtw_wavefront_plan(n, ta, n_sms)
        n_diag = ta + tb - 1
        walked = int(paths_k[2].sum())
        # least time: the cells of C inside each pair's lengths read once
        # (Σ la·lb, this run's lens), the lens read, every code and the costs
        # written once; every code of the n·(Ta+Tb-1)·Ta output takes 6
        # float ops. The backtrace reads the codes of its walk and writes both
        # padded paths
        cells = int((lens[:, 0].long() * lens[:, 1].long()).sum())
        wf = bound(4 * cells + n * n_diag * ta + n * 12, 6 * n * n_diag * ta)
        bt = bound(n * 8 + walked + 2 * n * n_diag * 4 + n * 4, 0)
        rec = dict(cost=cost_k, lens=lens, paths=paths_k)
        msg = (f"dtw {name}: N={n} Ta={ta} Tb={tb}: both kernels equal to their twins; plan "
               f"R={plan['rows_per_lane']} rows a lane, {plan['chunk']}-step chunks, "
               f"{plan['warps_per_cta']} warps a CTA, cluster {plan['cluster']}; C cells inside "
               f"the lens {cells}; path cells {walked}")
        if timed:
            wms = cuda_ms(lambda: dtw_wavefront(C, lens))
            bms = cuda_ms(lambda: dtw_backtrace(dirs_k, lens))
            rec.update(
                wavefront=dict(max_abs_err=float((cost_k - cost_p).abs().max()), ms=wms,
                               plain_ms=cuda_ms(lambda: dtw_wavefront_plain(C, lens), reps=3),
                               bound_ms=wf[0], bound_by=wf[1], library_ms=None),
                backtrace=dict(max_abs_err=float(max((a - b).abs().max()
                                                     for a, b in zip(paths_k, paths_p))),
                               ms=bms, plain_ms=cuda_ms(lambda: dtw_backtrace_plain(dirs_k, lens),
                                                        reps=3),
                               bound_ms=bt[0], bound_by=bt[1], library_ms=None))
            msg += (f"\n  wavefront {wms:.4f} ms ({wms * 1e3 / n_diag:.4f} us a diagonal "
                    f"step), bound {wf[0]:.4f} ms ({wf[1]}), roofline share {wf[0] / wms:.4f}; "
                    f"twin {rec['wavefront']['plain_ms']:.4f} ms"
                    f"\n  backtrace {bms:.4f} ms ({bms * 1e3 / max(walked // n, 1):.4f} us a "
                    f"path step), bound {bt[0]:.6f} ms ({bt[1]}), roofline share "
                    f"{bt[0] / bms:.6f}; twin {rec['backtrace']['plain_ms']:.4f} ms")
        say(msg)
        del C, dirs_k
        torch.cuda.empty_cache()
        return rec

    T = 1408
    main = dtw_case("main path", 8, T, T, 20,
                    np.stack([rng.integers(1100, T + 1, 8), rng.integers(1100, T + 1, 8)], 1),
                    timed=True)
    out["dtw_wavefront"], out["dtw_backtrace"] = main["wavefront"], main["backtrace"]
    say(f"  main path costs {[round(float(c), 3) for c in main['cost'][:3]]}..., path_len "
        f"{main['paths'][2][:3].tolist()}...")
    mcd = dtw_case("MCD", 1, 683, 683, 26, [[683, 683]], timed=True)
    for name, ta, tb in (("Ta>1024, Ta%32!=0", 1409, 1300), ("Ta<Tb", 300, 517),
                         ("Ta>Tb", 517, 300)):
        dtw_case(name, 4, ta, tb, 20, [[ta, tb], [1, tb], [ta, 1], [1, 1]], timed=False)
    dtw_case("longest Ta", 1, dtw_cuda.MAX_TA, 2000, 4, [[dtw_cuda.MAX_TA, 2000]], timed=False)
    out["_dtw_mcd"] = mcd

    # NMF at the main path's shapes
    F, K, D = 688, 7680, 201
    for name, plan_fn in (("nmf_recon", nmf_recon_plan), ("nmf_mu_fused", nmf_mu_fused_plan)):
        for k in (K, 115_200):
            pl = plan_fn(F, k, D, n_sms)
            ctas = pl["grid"][0] * pl["grid"][1] * pl["grid"][2]
            say(f"{name} plan at F={F} K={k} D={D}: grid {pl['grid']} = {ctas} CTAs of "
                f"{pl['threads']} threads, cluster {pl['cluster']}, tile {pl['tile']}, "
                f"thread tile {pl['thread_tile']}, {pl['stages']}-deep cp.async ring, "
                f"{pl['smem_bytes']} B shared, K slices {pl['k_bounds'][:3]}..., "
                f"{co_resident_clusters(name, pl, F, k, D)} clusters at once on {n_sms} SMs")
    for k in (K, 115_200):
        pl = nmf_update_plan(F, k, D, n_sms)
        ctas = pl["grid"][0] * pl["grid"][1] * pl["grid"][2]
        resident = co_resident_clusters("nmf_update", pl, F, k, D)
        say(f"nmf_update plan at F={F} K={k} D={D}: grid {pl['grid']} = {ctas} CTAs of "
            f"{pl['threads']} threads, tile {pl['tile']}, thread tile {pl['thread_tile']}, "
            f"{pl['stages']}-deep cp.async ring, {pl['smem_bytes']} B shared; "
            f"{resident // n_sms} CTAs an SM ({resident} at once on {n_sms} SMs): "
            f"{ctas / resident:.2f} waves")
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    A[K - 300:] = 0.0                                   # inert padding rows
    X = np.abs(rng.standard_normal((F, D))).astype(np.float32)
    A = torch.as_tensor(A, device=dev)
    X = torch.as_tensor(X, device=dev)
    H = torch.as_tensor(rng.uniform(0.0, 0.02, (F, K)).astype(np.float32), device=dev)
    Num = X @ A.T
    P = nmf_recon_plain(H, A)
    e_recon = rel_err(nmf_recon(H, A), P)
    H1p = nmf_update_plain(P, A, H, Num)
    e_update = rel_err(nmf_update(P, A, H, Num), H1p)
    Hk, Hp = H.clone(), H.clone()
    for _ in range(10):
        Hk = nmf_update(nmf_recon(Hk, A), A, Hk, Num, out=Hk)
        Hp = nmf_update_plain(nmf_recon_plain(Hp, A), A, Hp, Num)
    e_10 = rel_err(Hk, Hp)
    torch.cuda.synchronize()
    say(f"nmf: F={F} K={K} D={D}: rel err recon {e_recon:.3g}, update {e_update:.3g} "
        f"(limit 1e-5), 10 MU steps {e_10:.3g} (limit 1e-4)")
    if not (e_recon <= 1e-5 and e_update <= 1e-5 and e_10 <= 1e-4):
        fail("nmf kernels outside tolerance")
    # bounds: P = H·A and P·Aᵀ are 2FKD flops each; recon reads H and A and
    # writes P, the update reads P, A, H, Num and writes H; the fused
    # iteration does both products and reads H, A, Num, writes H
    fkd, fk = 2 * F * K * D, F * K
    out["nmf_recon"] = dict(max_abs_err=float((nmf_recon(H, A) - P).abs().max()),
                            ms=cuda_ms(lambda: nmf_recon(H, A)),
                            plain_ms=cuda_ms(lambda: nmf_recon_plain(H, A)),
                            library_ms=cuda_ms(lambda: torch.matmul(H, A)))
    out["nmf_recon"]["bound_ms"], out["nmf_recon"]["bound_by"] = bound(
        4 * (fk + K * D + F * D), fkd)
    out["nmf_update"] = dict(max_abs_err=float((nmf_update(P, A, H, Num) - H1p).abs().max()),
                             ms=cuda_ms(lambda: nmf_update(P, A, H, Num)),
                             plain_ms=cuda_ms(lambda: nmf_update_plain(P, A, H, Num)),
                             library_ms=None)
    out["nmf_update"]["bound_ms"], out["nmf_update"]["bound_by"] = bound(
        4 * (F * D + K * D + 3 * fk), fkd + 4 * fk)

    # the one-kernel MU iteration at the same shapes
    H1f = nmf_mu_fused_plain(H, A, Num)
    e_fused = rel_err(nmf_mu_fused(H, A, Num), H1f)
    Hk, Hp = H.clone(), H.clone()
    for _ in range(10):
        Hk = nmf_mu_fused(Hk, A, Num, out=Hk)
        Hp = nmf_mu_fused_plain(Hp, A, Num)
    e_f10 = rel_err(Hk, Hp)
    torch.cuda.synchronize()
    say(f"nmf_mu_fused: F={F} K={K} D={D}: rel err one call {e_fused:.3g} (limit 1e-5), "
        f"10 MU steps {e_f10:.3g} (limit 1e-4)")
    if not (e_fused <= 1e-5 and e_f10 <= 1e-4):
        fail("nmf_mu_fused outside tolerance")
    out["nmf_mu_fused"] = dict(max_abs_err=float((nmf_mu_fused(H, A, Num) - H1f).abs().max()),
                               ms=cuda_ms(lambda: nmf_mu_fused(H, A, Num)),
                               plain_ms=cuda_ms(lambda: nmf_mu_fused_plain(H, A, Num)),
                               library_ms=None)
    out["nmf_mu_fused"]["bound_ms"], out["nmf_mu_fused"]["bound_by"] = bound(
        4 * (K * D + 3 * fk), 2 * fkd + 4 * fk)
    two_ms = cuda_ms(lambda: nmf_update(nmf_recon(H, A), A, H, Num))
    say(f"  one MU iteration at K={K}: fused kernel {out['nmf_mu_fused']['ms']:.4f} ms, "
        f"nmf_recon + nmf_update {two_ms:.4f} ms, plain {out['nmf_mu_fused']['plain_ms']:.4f} ms")
    del Hk, Hp
    Kb = 115_200                                       # bench_100k.py's dictionary
    Ab = torch.as_tensor(np.abs(rng.standard_normal((Kb, D))).astype(np.float32), device=dev)
    Hb = torch.full((F, Kb), 0.01, dtype=torch.float32, device=dev)
    Numb = X @ Ab.T
    Pb = nmf_recon_plain(Hb, Ab)
    e_rb = rel_err(nmf_recon(Hb, Ab), Pb)
    e_ub = rel_err(nmf_update(Pb, Ab, Hb, Numb), nmf_update_plain(Pb, Ab, Hb, Numb))
    e_b = rel_err(nmf_mu_fused(Hb, Ab, Numb), nmf_mu_fused_plain(Hb, Ab, Numb))
    Hk, Hp, Hf = Hb.clone(), Hb.clone(), Hb.clone()
    for _ in range(10):
        Hk = nmf_update(nmf_recon(Hk, Ab), Ab, Hk, Numb, out=Hk)
        Hf = nmf_mu_fused(Hf, Ab, Numb, out=Hf)
        Hp = nmf_mu_fused_plain(Hp, Ab, Numb)
    e_rb10, e_b10 = rel_err(Hk, Hp), rel_err(Hf, Hp)
    del Hk, Hp, Hf
    rb_ms = cuda_ms(lambda: nmf_recon(Hb, Ab), reps=5)
    rpb_ms = cuda_ms(lambda: nmf_recon_plain(Hb, Ab), reps=5)
    ub_ms = cuda_ms(lambda: nmf_update(Pb, Ab, Hb, Numb), reps=5)
    upb_ms = cuda_ms(lambda: nmf_update_plain(Pb, Ab, Hb, Numb), reps=5)
    fb_ms = cuda_ms(lambda: nmf_mu_fused(Hb, Ab, Numb), reps=5)
    pb_ms = cuda_ms(lambda: nmf_mu_fused_plain(Hb, Ab, Numb), reps=5)
    tb_ms = cuda_ms(lambda: nmf_update(nmf_recon(Hb, Ab), Ab, Hb, Numb), reps=5)
    say(f"  K={Kb}: nmf_recon {rb_ms:.4f} ms, plain {rpb_ms:.4f} ms (rel err {e_rb:.3g}, "
        f"limit 1e-5; recon + update 10 MU steps {e_rb10:.3g}, limit 1e-4)")
    say(f"  K={Kb}: nmf_update {ub_ms:.4f} ms, plain {upb_ms:.4f} ms (rel err {e_ub:.3g}, "
        f"limit 1e-5)")
    say(f"  one MU iteration at K={Kb}: fused kernel {fb_ms:.4f} ms, nmf_recon + nmf_update "
        f"{tb_ms:.4f} ms, plain {pb_ms:.4f} ms (rel err {e_b:.3g}, limit 1e-5; 10 MU steps "
        f"{e_b10:.3g}, limit 1e-4)")
    if not (e_rb <= 1e-5 and e_ub <= 1e-5 and e_b <= 1e-5 and e_rb10 <= 1e-4
            and e_b10 <= 1e-4):
        fail("nmf kernels outside tolerance at K = 115,200")
    del Ab, Hb, Numb, Pb

    # the fused Griffin-Lim at the main path's shape
    Fg, n_fft, hop = 688, 400, 80
    nb = n_fft // 2 + 1
    mag = torch.as_tensor(np.abs(rng.standard_normal((Fg, nb))).astype(np.float32), device=dev)
    ang = torch.as_tensor(np.exp(2j * np.pi * rng.random((Fg, nb))).astype(np.complex64),
                          device=dev)
    g6 = gl_angles_fused(mag, ang, n_fft, hop, 6, 0.9)
    p6 = gl_angles_fused_plain(mag, ang, n_fft, hop, 6, 0.9)
    r6 = gl_angles_fused_plain(mag.double(), ang.to(torch.complex128), n_fft, hop, 6, 0.9)
    torch.cuda.synchronize()
    e_gl = float((g6 - p6).abs().max())
    e_l2 = float(torch.linalg.norm(g6 - p6) / torch.linalg.norm(p6))
    d_k, d_p = (g6 - r6).abs(), (p6 - r6).abs()
    plan = gl_fused_plan(Fg, n_fft, hop)
    say(f"gl_angles_fused: F={Fg} bins={nb} n_fft={n_fft} hop={hop}, 6 iterations: kernel vs "
        f"twin max |phase diff| {e_gl:.3g}, rel L2 {e_l2:.3g} (limit 1e-4); against float64, "
        f"mean / max: kernel {float(d_k.mean()):.3g} / {float(d_k.max()):.3g}, float32 twin "
        f"{float(d_p.mean()):.3g} / {float(d_p.max()):.3g} (limit: kernel mean <= 2x the "
        f"twin's + 1e-7); grid {plan['grid']} blocks of {plan['resident']} co-resident, "
        f"{plan['smem_bytes']} B shared memory")
    if not (e_l2 <= 1e-4 and float(d_k.mean()) <= 2 * float(d_p.mean()) + 1e-7):
        fail("gl_angles_fused outside tolerance")
    # bound: each iteration and frame needs an inverse and a forward real FFT
    # of n_fft (2.5·n_fft·log2(n_fft) flops each, the usual split-radix
    # count), the window, overlap-add and normaliser (4·n_fft) and the
    # per-bin product, momentum and normalisation (12·bins); it reads the
    # magnitudes and phases once and writes the phases
    out["gl_angles_fused"] = dict(
        max_abs_err=e_gl,
        ms=cuda_ms(lambda: gl_angles_fused(mag, ang, n_fft, hop, 300, 0.9), reps=3),
        plain_ms=cuda_ms(lambda: gl_angles_fused_plain(mag, ang, n_fft, hop, 300, 0.9), reps=3),
        library_ms=None)
    out["gl_angles_fused"]["bound_ms"], out["gl_angles_fused"]["bound_by"] = bound(
        4 * Fg * nb + 2 * 8 * Fg * nb,
        300 * Fg * (2 * 2.5 * n_fft * math.log2(n_fft) + 4 * n_fft + 12 * nb))
    sync_ms = cuda_ms(lambda: grid_sync_probe(plan["grid"], 300, dev), reps=3)
    prod_ms = cuda_ms(lambda: griffin_lim(mag, n_fft=n_fft, hop_length=hop, n_iter=300,
                                          init_phase=ang), reps=3)
    prod_dev = device_ms(lambda: griffin_lim(mag, n_fft=n_fft, hop_length=hop, n_iter=300,
                                             init_phase=ang))
    say(f"  300 iterations: fused kernel {out['gl_angles_fused']['ms']:.4f} ms, twin "
        f"{out['gl_angles_fused']['plain_ms']:.4f} ms, production griffin_lim {prod_ms:.4f} ms "
        f"(device time {fmt_ms(prod_dev)}); floor of 300 grid syncs on {plan['grid']} blocks "
        f"{sync_ms:.4f} ms ({sync_ms / 300 * 1e3:.3f} us each)")
    mcd = out.pop("_dtw_mcd")
    for name, r in out.items():
        say(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{fmt_ms(r['library_ms'])}, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
            f"roofline share {r['bound_ms'] / r['ms']:.4f}, max_abs_err {r['max_abs_err']:.3g}")
    for name in ("wavefront", "backtrace"):
        r = mcd[name]
        say(f"  dtw_{name} at the MCD shape: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), roofline share "
            f"{r['bound_ms'] / r['ms']:.4f}")
    return out


def phase_main_path(torch, np, dev, root: str, corpus: tuple, counted: dict,
                    fused: dict) -> dict:
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance

    data, src, tar = corpus
    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    audio_s = 0.0
    for spk in ("SF1", "TF1"):
        for name in sorted(os.listdir(os.path.join(data, spk))):
            x, sr = read_wav(os.path.join(data, spk, name))
            audio_s += len(x) / sr
    x_in, sr = read_wav(src)
    audio_s += len(x_in) / sr

    for fn in (*counted.values(), *fused.values()):
        fn.launches = 0
    t0 = time.perf_counter()
    res = convert_utterance(cfg, ArtifactStore(os.path.join(root, "store0")), data, src,
                            nb_file=8, reference_wav=tar, sync_stages=True, device=dev)
    cold_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    off_path = {name: fn.launches for name, fn in fused.items()}
    F, K, D = res.nmf_shape
    say(f"main path: F={F} K={K} D={D} n_iter={res.n_iter} nmf_error={res.nmf_error:.6g}")
    say(f"main path: launches {launches}")
    say(f"main path: first run {cold_s:.4f} s, fenced stages (s) "
        f"{json.dumps({k: round(v, 6) for k, v in res.timings.items()})}")
    say(f"main path: stand-in held-out MCD {res.mcd_vs_reference:.4f} dB "
        f"(stand-in corpus; not comparable to the real corpus's figure)")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    if max(off_path.values()) > 0:
        fail(f"the default path launched an opt-in fused kernel: {off_path}")
    if res.audio.shape != x_in.shape or not np.isfinite(res.audio).all():
        fail(f"audio shape {res.audio.shape} vs input {x_in.shape}, or not finite")
    if not (1 <= res.n_iter <= cfg.nmf.max_iter) or not np.isfinite(res.nmf_error):
        fail(f"n_iter {res.n_iter} or error {res.nmf_error}")
    if res.mcd_vs_reference is None or not np.isfinite(res.mcd_vs_reference):
        fail(f"MCD {res.mcd_vs_reference}")

    warm = []
    for k in range(3):
        t0 = time.perf_counter()
        convert_utterance(cfg, ArtifactStore(os.path.join(root, f"store{k + 1}")), data, src,
                          nb_file=8, device=dev)
        warm.append(time.perf_counter() - t0)
    med = statistics.median(warm)
    say(f"main path: warm runs {[round(w, 4) for w in warm]} s, audio {audio_s:.3f} s, "
        f"{audio_s / med:.3f} audio-s/s (median)")

    runs = [len(warm)]

    def fresh():   # a fresh store, so the dictionary build and its DTW run
        runs[0] += 1
        convert_utterance(cfg, ArtifactStore(os.path.join(root, f"store{runs[0]}")), data, src,
                          nb_file=8, device=dev)

    total, per = device_profile(fresh)
    kernels = {name: (calls, round(ms, 6)) for name, (calls, ms) in per.items()
               if any(k in name for k in ("dtw_wavefront_kernel", "dtw_backtrace_kernel",
                                          "nmf_recon_kernel", "nmf_update_kernel"))}
    say(f"main path: device time of one warm conversion {fmt_ms(total)}"
        + (f", busy share {total / (med * 1e3):.4f} of the warm median" if total else "")
        + f"; hand-written kernels (calls, ms) {json.dumps(kernels)}")
    return launches


def phase_fused_path(torch, np, dev, root: str, corpus: tuple, fused: dict) -> dict:
    """The opt-in fused path on the stand-in corpus: the one-kernel MU solve
    and the fused Griffin-Lim, held against the default solve and the
    production ``griffin_lim`` on the same inputs."""
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
    from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import gl_angles_fused
    from exemplars_vc_tpu_torch.dsp.stft import istft, stft
    from exemplars_vc_tpu_torch.factorize.nmf import convert_features, nmf_activations
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import extract_stft_complex
    from exemplars_vc_tpu_torch.pipelines.convert import _aligned_dicts, mcd_between_signals

    data, src, tar = corpus
    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    n_fft, hop, iters = cfg.mcep.frame_length, cfg.mcep.hop_length, cfg.nmf.griffin_lim_iters
    dicts, _ = _aligned_dicts(cfg, ArtifactStore(os.path.join(root, "store_fused")), data, 8,
                              dev)
    A, B = dicts["stft"]
    x, _ = read_wav(src)
    S = extract_stft_complex(x, cfg, dev)
    X = torch.abs(S)
    ang0 = torch.where(X > 0, S / torch.clamp(X, min=1e-16),
                       torch.ones((), dtype=torch.complex64, device=dev))
    kw = dict(tol=cfg.nmf.tol, max_iter=cfg.nmf.max_iter, l1=cfg.nmf.sparsity_l1)

    for fn in fused.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_f = nmf_activations(X, A, fused=True, **kw)
    Y_f = convert_features(st_f.H, B)
    ang = gl_angles_fused(Y_f, ang0, n_fft, hop, iters, 0.9)
    y_f = istft(Y_f * ang, n_fft=n_fft, hop_length=hop, length=len(x))
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fused.items()}

    st_d = nmf_activations(X, A, **kw)
    Y_d = convert_features(st_d.H, B)
    y_gl = griffin_lim(Y_f, n_fft=n_fft, hop_length=hop, n_iter=iters, length=len(x),
                       init_phase=S)
    F, K, D = X.shape[0], A.shape[0], X.shape[1]
    e_h = float(torch.linalg.norm(st_f.H - st_d.H) / torch.linalg.norm(st_d.H))

    def sc(y):
        m = torch.abs(stft(y, n_fft=n_fft, hop_length=hop))[:F]
        return float(torch.linalg.norm(m - Y_f) / torch.linalg.norm(Y_f))

    sc_f, sc_g = sc(y_f), sc(y_gl)
    say(f"fused path: F={F} K={K} D={D}: n_iter fused {st_f.n_iter} / default {st_d.n_iter}, "
        f"H rel L2 {e_h:.3g} (limit 0: bit-equal), Y rel L2 "
        f"{float(torch.linalg.norm(Y_f - Y_d) / torch.linalg.norm(Y_d)):.3g}")
    say(f"fused path: launches {launches}; solve + convert + GL {iters} + ISTFT first run "
        f"{fused_s:.4f} s")
    ms = {
        "solve fused": wall_ms(lambda: nmf_activations(X, A, fused=True, **kw)),
        "solve default": wall_ms(lambda: nmf_activations(X, A, **kw)),
        "GL fused": wall_ms(lambda: gl_angles_fused(Y_f, ang0, n_fft, hop, iters, 0.9)),
        "GL production": wall_ms(lambda: griffin_lim(Y_f, n_fft=n_fft, hop_length=hop,
                                                     n_iter=iters, init_phase=S)),
    }
    dev_ms = {
        "solve fused": device_ms(lambda: nmf_activations(X, A, fused=True, **kw)),
        "solve default": device_ms(lambda: nmf_activations(X, A, **kw)),
        "GL fused": device_ms(lambda: gl_angles_fused(Y_f, ang0, n_fft, hop, iters, 0.9)),
        "GL production": device_ms(lambda: griffin_lim(Y_f, n_fft=n_fft, hop_length=hop,
                                                       n_iter=iters, init_phase=S)),
    }
    say("fused path: wall (median of 3) / device time: " + ", ".join(
        f"{k} {ms[k]:.4f} ms / {fmt_ms(dev_ms[k])}" for k in ms))
    ref_sig, _ = read_wav(tar)
    audio_f = y_f.cpu().numpy()
    mcd_f = mcd_between_signals(audio_f, ref_sig, cfg, dev)
    mcd_g = mcd_between_signals(y_gl.cpu().numpy(), ref_sig, cfg, dev)
    say(f"fused path: spectral convergence fused GL {sc_f:.7f}, production GL {sc_g:.7f} "
        f"(rule sc_fused < 1.3 sc_gl + 0.02); stand-in MCD fused {mcd_f:.4f} dB, production "
        f"{mcd_g:.4f} dB (stand-in corpus; not comparable to the real corpus's figure)")
    if launches["nmf_mu_fused"] < st_f.n_iter or launches["gl_angles_fused"] < 1:
        fail(f"the fused path did not run its kernels: {launches}, n_iter {st_f.n_iter}")
    if st_f.n_iter != st_d.n_iter or e_h != 0.0:
        fail("the fused solve is not bit-equal to the default solve")
    if audio_f.shape != x.shape or not np.isfinite(audio_f).all():
        fail(f"fused-path audio shape {audio_f.shape} vs input {x.shape}, or not finite")
    if not sc_f < 1.3 * sc_g + 0.02 or not np.isfinite(mcd_f):
        fail(f"fused GL quality: sc {sc_f} vs {sc_g}, MCD {mcd_f}")
    return launches


def phase_small_agreement(torch, np, dev, root: str) -> None:
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance

    data, src, tar = build_standin_corpus(os.path.join(root, "small"), n_pairs=3)
    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=3", "nmf.max_iter=20"])
    runs = {}
    for d in (dev, "cpu"):
        runs[str(d)] = convert_utterance(
            cfg, ArtifactStore(os.path.join(root, f"small_{str(d).replace(':', '')}")),
            data, src, nb_file=3, synth_iters=5, reference_wav=tar, device=d)
    g, c = runs[str(dev)], runs["cpu"]
    Yg, Yc = g.converted["stft"].cpu().numpy(), c.converted["stft"].numpy()
    e_y = float(np.linalg.norm(Yg - Yc) / np.linalg.norm(Yc))
    e_a = float(np.linalg.norm(g.audio - c.audio) / np.linalg.norm(c.audio))
    d_mcd = abs(g.mcd_vs_reference - c.mcd_vs_reference)
    say(f"small input: card vs CPU: magnitude rel L2 {e_y:.3g}, audio rel L2 {e_a:.3g} "
        f"(limit 1e-3), n_iter {g.n_iter}/{c.n_iter}, MCD {g.mcd_vs_reference:.4f}/"
        f"{c.mcd_vs_reference:.4f} dB (limit 0.05)")
    if e_y > 1e-3 or e_a > 1e-3 or g.n_iter != c.n_iter or d_mcd > 0.05:
        fail("card and CPU disagree on the small input")


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        from exemplars_vc_tpu_torch.align.dtw_cuda import dtw_backtrace, dtw_wavefront
        from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import gl_angles_fused
        from exemplars_vc_tpu_torch.factorize.nmf_cuda import (
            nmf_mu_fused, nmf_recon, nmf_update)
        from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
        from exemplars_vc_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])   # the card's name and power limit
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device count {torch.cuda.device_count()}")
    dev = torch.device("cuda:0")
    srcs = ("dtw_wavefront", "nmf_mu", "griffin_lim_fused")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(srcs)) as pool:   # one nvcc per source, all at once
        list(pool.map(build.load_library, srcs))
    say(f"built {len(srcs)} sources in {time.perf_counter() - t0:.2f} s (in parallel)")
    for src in srcs:
        say(f"built {src}.cu in {build.build_seconds[src]:.2f} s")
        for line in build.ptxas_report.get(src, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                say(f"  ptxas: {line.strip()}")

    counted = {"dtw_wavefront": dtw_wavefront, "dtw_backtrace": dtw_backtrace,
               "nmf_recon": nmf_recon, "nmf_update": nmf_update}
    sources = {"dtw_wavefront": ("exemplars_vc_tpu_torch/csrc/dtw_wavefront.cu",
                                 "exemplars_vc_tpu/align/dtw_pallas.py:102"),
               "dtw_backtrace": ("exemplars_vc_tpu_torch/csrc/dtw_wavefront.cu",
                                 "exemplars_vc_tpu/align/dtw.py:171"),
               "nmf_recon": ("exemplars_vc_tpu_torch/csrc/nmf_mu.cu",
                             "exemplars_vc_tpu/factorize/nmf_pallas.py:34"),
               "nmf_update": ("exemplars_vc_tpu_torch/csrc/nmf_mu.cu",
                              "exemplars_vc_tpu/factorize/nmf_pallas.py:43"),
               "nmf_mu_fused": ("exemplars_vc_tpu_torch/csrc/nmf_mu.cu",
                                "exemplars_vc_tpu/factorize/nmf_pallas.py:50"),
               "gl_angles_fused": ("exemplars_vc_tpu_torch/csrc/griffin_lim_fused.cu",
                                   "exemplars_vc_tpu/dsp/griffin_lim_pallas.py:143")}
    # the opt-in fused path's kernels, counted on their own path
    fused = {"nmf_mu_fused": nmf_mu_fused, "gl_angles_fused": gl_angles_fused}

    kern = phase_kernels(torch, np, dev)
    with tempfile.TemporaryDirectory(prefix="evc_chip_smoke_") as root:
        corpus = build_standin_corpus(os.path.join(root, "corpus"))
        launches = phase_main_path(torch, np, dev, root, corpus, counted, fused)
        launches.update(phase_fused_path(torch, np, dev, root, corpus, fused))
        phase_small_agreement(torch, np, dev, root)
    if "jax" in sys.modules:
        fail("jax was imported")

    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"]}
        for name in sources]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
