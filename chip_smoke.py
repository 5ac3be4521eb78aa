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
   lb = 1 rows) and the longest Ta one launch takes, 32,768 × 2000 (timed,
   its twins once); the wavefront in row bands (one launch a band, each
   band's last row handed to the next): the main path's 8 × 1408² in bands
   of 1024 rows equal to the twin, and a 40,000 × 500 pair (two bands of the
   default 32,768 rows) equal to bands of 8192 rows in codes, path and
   distance, its path monotone from (0, 0) to (39,999, 499), timed, with
   each band's device time; ``nmf_recon``,
   ``nmf_update`` and the one-kernel MU iteration ``nmf_mu_fused`` within a
   relative error max|kernel − plain| / max|plain| of 1e-5 for one call and
   1e-4 after 10 MU steps (they sum in different orders), all three also at
   K = 115,200 (where ``nmf_update`` is timed beside its twin too) and, for
   ``nmf_recon`` and ``nmf_update``, at the serving path's stacked solve
   F = 2752 (four utterances of 688 frames), K = 30,720 (the dictionary and
   its four VTLP copies), timed, with bound, share and ``torch.matmul``'s
   time, and at the WORLD path's solve F = 688, K = 6144, D = 513 (the same
   gates, timed, with bound, share and ``torch.matmul``'s time); ``nmf_recon``
   at the benchmark cells' shapes, K = 14,336 and F × D = 16 × 201 (its
   16-row tile), 620 × 201 and 620 × 1025 (its 128-row tile), within 1e-5 of
   its twin, two launches equal bit for bit, the device time of 20 launches
   beside ``torch.matmul``'s and the bound, with each shape's plan tile; with the
   launch plans of the persistent split-K ``nmf_recon`` (CTAs, tile, units,
   K pieces and groups, CTAs the card holds at once), of the fused cluster
   kernel (grid, cluster, tile, shared bytes, clusters at once) and of ``nmf_update``
   (CTAs, waves at the CTAs an SM that the occupancy query reports, shared
   bytes); the fused Griffin-Lim ``gl_angles_fused`` at 688 × 201 (n_fft
   400, hop 80) and 300 × 25 (n_fft 48, hop 16: a radix-3 pass) after 6
   iterations within 1e-4 relative L2 of its twin's unit phases and, against
   a float64 run of the twin, a mean phase error no more than twice the
   float32 twin's own (+ 1e-7): float32 rounding alone moves the phase of a
   bin whose update nearly cancels by ~1e-3 at this shape, so the
   element-wise max is reported, not gated; two other tiles bit-equal to
   the plan's. Timed at 300 iterations beside its twin, the graphed cuFFT
   yardstick (``gl_yardstick``, its ``library_ms``), the production
   ``griffin_lim`` graphed and eager, and the grid-sync floor;
3. the main path: ``convert_utterance`` on the stand-in corpus (8 pairs,
   held-out utterance 100162) with the default config, launch counters
   reset just before and read just after; every kernel of the default path
   must have launched and neither fused kernel, the audio must be finite
   and of the input's length, n_iter ≤ max_iter and the MCD finite, its
   Griffin-Lim must have captured a graph, and ``nmf_recon`` must have
   launched 1 + n_iter times (the error check's recon feeds the next
   update) and ``nmf_update`` n_iter times. The fenced ``dicts`` stage of
   five more fresh builds is printed (median and spread). Then three warm runs for
   audio-seconds per second (capturing nothing more) and one with fenced
   stages; the production ``griffin_lim`` on the main path's Y graphed
   against the eager loop (``torch.equal``) for graphs of 10, 50 and 300
   iterations, each with its first call (capture) and warm wall and the
   device memory its graphs hold; and ``torch.profiler`` over one more
   conversion: its summed device time, busy share and the hand-written
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
5. the serving path, counters reset just before, on the same corpus through
   ``evaluate.heldout_pair``: a ``Converter`` with the default (Frobenius)
   solver and four VTLP warps (K must be 30,720), ``convert`` of the
   held-out utterance and ``convert_batch`` of four utterances of different
   lengths; ``nmf_recon`` and ``nmf_update`` must have launched and no fused
   kernel; every audio finite and of its input's length; the dictionaries
   built once (``_aligned_dicts.builds``, ``make_dictionary.builds`` and the
   DTW launch counters do not move after the constructor). With
   ``nmf.tol=0`` (a stacked solve has one n_iter, the stacked error's; with
   the tolerance off both run ``max_iter`` steps) each batch item must equal
   its single ``convert`` within 1e-4 relative L2 on the converted
   magnitude and on the audio after 10 Griffin-Lim iterations; the audio
   after 300 is reported (the iterations grow the float32 rounding
   difference between a stacked and a single solve). A ``Converter`` from
   ``load_config(preset="quality")`` (KL, plain torch products by design,
   ``h_smooth=2``) converts the held-out utterance: finite stand-in MCD. The
   bfloat16 solve (plain torch by design) runs once beside the float32 one.
   A ``StreamingConverter`` on the Frobenius dictionaries takes the held-out
   |STFT| in chunks of 16 frames with its phase (context 32, 60 Griffin-Lim
   iterations): with ``nmf.tol=0`` the stacked chunk conversions must equal
   the batch conversion within 1e-4 relative L2; the audio must be finite
   and of F·hop samples. Printed: ``prepare_seconds``, warm ``convert`` wall
   (median of 3), ``convert_batch`` wall and its share an utterance, the
   steady ``push`` wall against the chunk's 80 ms, launches and graph
   captures. Nothing in the phase catches a failure;
6. a small input (3 pairs, 20 MU iterations, 5 Griffin-Lim iterations)
   converted on the card and on the CPU (plain twins, which the CPU tests
   hold to the JAX reference): converted magnitude and audio within 1e-3
   relative L2, equal n_iter, MCD within 0.05 dB;
7. the WORLD path (``data.use_stft=false``, the default WORLD
   configuration: DIO + StoneMask, fft 1024, 5 ms frames, log-MV f0, power
   sp, residual on) on the stand-in corpus, counters reset just before:
   ``convert_utterance`` of the held-out utterance, one cold run with
   fenced stages, then three warm runs from fresh stores (the 16 WORLD
   analyses and the DTW every time); ``dtw_wavefront`` and
   ``dtw_backtrace`` must have launched twice each, ``nmf_recon`` (1 +
   n_sp) + (1 + n_ap) times and ``nmf_update`` n_sp + n_ap times, and no
   fused kernel. Printed: the stages, the (F, K, D) and n_iter of the sp and
   ap solves, the host syncs of the f0 contour relaxation, the device time
   of a warm conversion and its kernels, the stand-in WORLD MCD (not
   comparable to the corpus's). Then the held-out utterance's WORLD
   features on the card against the port's CPU run (voicing on ≥ 99 % of
   frames, sp within 0.05 dB median on frames voiced in both) and a small
   WORLD conversion (3 pairs, 20 MU iterations) card against CPU (converted
   sp and ap within 1e-3 relative L2); one conversion each with
   ``world.f0_method=harvest`` and with ``world.sp_domain=magnitude`` and
   ``nmf.use_residual=off``; a WORLD ``Converter``: ``convert`` and
   ``convert_batch`` of two, each item within 1e-5 relative L2 of its
   single conversion. Nothing in the phase catches a failure;
8. stage 02, the evaluation protocols and the port's CLI, on the stand-in
   corpus through ``pipelines.cli.main`` in-process with ``--device cuda``,
   counters reset just before the first command and read after the last:
   ``make-dict --feat mcep`` (one DTW launch each), ``freq-warp --variant
   amf`` and ``--variant dfw`` (wall seconds each; the DFW batch of 512
   pairs of 201-bin log-spectra is one more DTW launch each), ``warp-train``
   at the default net (20 → 20, 2 layers, 20 epochs, one utterance a step:
   ``train_seconds``, ``steps_per_s``, ``best_test_loss``) and ``warp-eval``
   (its ``improvement``), ``eval-heldout`` with the four canonical configs at
   their defaults (each stand-in MCD) and ``eval-loo --folds 100001,100005
   --configs stft_quality`` (seconds a fold, the summary). Then the same
   commands with ``--device cpu`` (the plain twins, which the CPU tests hold
   to the JAX package): the MCEP dictionary's paths equal; the AMF anchors
   within 1e-4; the DFW kernels on the CPU run's spectra give its paths
   exactly, and the card run's curves differ from the CPU run's by at most
   one bin on at most 0.1 % of their entries, the mean curve by 0.01 bins
   (the two runs' |STFT| differ by float32 rounding, which flips a few
   near-ties); a 3-epoch ``warp-train`` from the same initial parameters on
   3 pairs: history within 1e-3 relative; ``eval-heldout`` of ``stft_parity`` (300
   Griffin-Lim iterations, the default) and ``world_parity``: MCD within
   0.05 dB. Last, the DTW kernels at the DFW shape, 512 × 201² with D = 1,
   on those spectra and on seeded spectra with zeroed tails (runs of equal
   costs at log(1e-8)): wavefront and backtrace byte-equal to their twins,
   timed (CUDA events, median of 7), with the plan and the bound. Nothing in
   the phase catches a failure.

9. the parallel package (``exemplars_vc_tpu_torch/parallel``): first the
   wavefront kernel's tile mode against its twin, byte for byte (codes,
   bottom row, right column, with every halo set, a window off a 16-byte
   boundary, one row a lane and eight, with and without codes), and at
   the sequence-parallel DTW's tile (16,384 rows x 512 columns of a
   2048-column strip), timed there beside its bound and its twin's time;
   a single-device 5-epoch warp-train (2 utterances a step, after a warm
   epoch) for the step rate. Then a world of two gloo ranks that share the
   card and a world of one nccl rank, one process a rank
   (``torch.multiprocessing.spawn``; TCP rendezvous on localhost), each
   rank against its single-device counterpart in the same process, each
   path's first call counted and gated, then timed (median of 3): the
   dictionary-sharded NMF at F = 688, K = 115,200, D = 201 (equal n_iter,
   H within 2e-3 and the error within 1e-3 relative, 1 + n_iter
   ``nmf_recon`` and n_iter ``nmf_update`` launches a rank), and
   ``nmf_recon`` and ``nmf_update`` at the rank's shard (688 x K/n x 201)
   against their twins (1e-5 relative); with two ranks
   also ``convert_utterance`` with ``nmf.solver=mu_sharded`` on the
   stand-in corpus against ``mu`` (dY = max|ΔY| / max|Y| ≤ 2e-3, Y and
   audio equal on both ranks) and the two kernels at its shard (F x K/n x
   D) against their twins, ``sharded_dtw_batch`` of 8 pairs padded to
   1408 frames against ``dtw_batch`` (all outputs equal),
   ``sharded_dtw_long`` of one 32,768 x 2000 pair in 512-column tiles
   against the single-device wavefront on the same C (codes, distance and
   path equal; the distance-only variant's distance equal), and
   ``train_warping_net(data_parallel=True)`` for 5 epochs after a 1-epoch
   warm run (finite, decreasing loss; parameters equal on both ranks). Each rank's launches
   are counted from 0 around its driven calls only. A failed gate in a rank
   ends its world, and the phase fails.
10. ``separate`` (``exemplars_vc_tpu_torch/separate``; torch ops only, no
   hand-written kernel: the six counters are set to 0 before the phase and
   printed after it). (a) The separation benchmark's fixed 2 s stereo
   mixture (``io.standin.synthetic_mixture``, a copy of
   ``bench_separate.py``'s) at its multichannel settings (2 sources, 8
   components, 20 EM iterations, n_fft 400, hop 80) in four configurations,
   ``nmf`` with ``random`` and ``demix`` spatial inits, ``hmm`` and
   ``shmm``, each cold and warm on the card and once in the port's CPU run
   from the same key: images and NLL finite, NLL[-1] ≤ NLL[0],
   image energies within 0.3 % of the CPU run's (``hmm`` and ``shmm``:
   3 %, ``SEP_ENERGY_RTOL``, between the port's own roundoff spread and a
   start from another key, ``tools/separation_spread.py``) and
   ``nll_last`` within 1e-4 relative of the CPU run; DEMIX θ within 1e-4 rad of the CPU run
   with equal delays; HMM state paths after 5 EM iterations equal on ≥ 99 %
   of frames (after 20
   they are reported, from ``PRNGKey(0..3)``: the EM turns roundoff into
   state flips there, as it does between the JAX package and the port's CPU
   run, whose paths after 20 iterations from four seeds' inits part on up
   to 5.9 % of the frames with the NLL within 3.4e-5; ``tests/
   test_torch_separate_ext.py``); the Viterbi sweep
   on tying integer densities equal card vs CPU. Reported: cold and warm
   walls, images' relative L2 to the CPU run, each image's SDR against the
   better-matching true image, the residual ‖x − Σ images‖ / ‖x‖. (b) A 60 s
   two-talker recording made of the in-repo speech
   (``io.standin.speech_mixture``) at the CLI's defaults (``nmf``, random
   init, 8 components, 50 EM): finite, NLL[-1] ≤ NLL[0]; cold and warm
   wall, audio-s/s, ``torch.profiler`` device ms, device launches and the
   largest device events, ``max_memory_allocated``; then ``hmm`` at 2 EM
   iterations (wall, device ms, launches) and the Viterbi sweep alone at its
   shape (2 × 8 states × 12,001 frames: wall, device ms, ms and launches a
   frame). (c) ``pipelines.cli.main(["separate", ..., "--device", "cuda"])``
   in-process on the 2 s mixture written as a stereo wav: the JAX CLI's
   four JSON keys and two wavs. Nothing in the phase catches a failure.
11. ``separate-lead``, the constant-Q transforms and ``separate_batch``
   (torch ops only, no hand-written kernel: the counters are set to 0
   before the phase and printed after it). (a) The 2 s mixture at
   ``bench_separate.py``'s settings (n_fft 1024, hop 256, f0 100-800 Hz, 20
   accompaniment components): ``separate_lead`` on its channel mean,
   ``separate_lead_stereo`` (15 iterations each) and
   ``separate_lead_multichannel`` (10 SIMM iterations, 10 EM), all three
   from the port's own draws of ``PRNGKey(1)``, which must equal the JAX
   package's (``io.standin.jax_simm_draws``: the stereo rounds' draws within
   4 ulp, βR bit-equal; the split depends on the random start,
   ``tools/simm_seed_sweep.py``), each cold and warm on the card and once
   in the port's CPU run: outputs finite, median voiced f0 within 10 Hz of
   220 Hz; the stereo SIMM's lead energy share within 0.01 of the CPU
   run's and within 0.05 of the JAX package's 0.6757, its lead SDR above
   3 dB; the composed path's share within 0.05 of the CPU run's. Reported:
   walls, each SDR, the melody agreement and the lead's relative L2 card vs
   CPU. (b) ``cqt``, ``minqt`` and ``nsgt`` of the 60 s two-talker
   recording at their defaults, on the card against the port's CPU run
   (relative L2 ≤ 1e-4), cold, warm and CPU walls, device ms, launches and
   the largest device events; ``insgt ∘ nsgt`` of the recording within 5e-4
   of its peak and ``iminqt ∘ minqt`` of an in-band sum of sines of its
   length above 40 dB on the interior (the JAX tests' bounds), timed; the
   recording's own MinQT round trip SNR reported. (c) The three models on
   the 60 s recording at the CLI's defaults (40 accompaniment components, 30
   SIMM iterations a round, 20 EM): finite; cold and warm wall, audio-s/s,
   ``torch.profiler`` device ms, launches and the largest device events,
   ``max_memory_allocated``, the share and the voiced frames. (d) In each
   of phase 9's worlds (``batch_separation`` in every rank), ``separate_batch``
   of two-second mixtures cut from the recording (n_fft 400, hop 80, 2
   sources, 8 components, 5 EM), four over the two gloo ranks and one in
   the nccl world, from ``PRNGKey(0)``: each rank's images within 1e-4
   relative of the single-mixture fit (``fit_multichannel_nmf`` and its
   Wiener images) from the same inits (``batch_inits``). (e)
   ``pipelines.cli.main(["separate-lead", ..., "--model", m, "--device",
   "cuda"])`` in-process for the three models on the 2 s mixture written as
   a stereo wav: the JAX CLI's six JSON keys and two wavs. Nothing in the
   phase catches a failure.

12. the JAX package's last public functions, on the stand-in corpus at the
   main path's width (counters set to 0 before (a) and read after it). (a)
   ``obs.trace_to`` around one ``convert_utterance`` with its MCD, from a
   fresh store with the dictionary memo cleared: the one trace file it
   writes must name ``dtw_wavefront_kernel``, ``dtw_backtrace_kernel``,
   ``nmf_recon_kernel`` and ``nmf_update_kernel`` as device events, every
   kernel of the path must have launched and no fused one. (b)
   ``align.build_exemplar_dicts`` on ``dtw_batch``'s paths of the 8 × 1408
   × 20 MFCC pairs and the |STFT| features: bit-equal to the rows
   ``build_exemplar_dicts_padded`` keeps, and on the card bit-equal to the
   CPU run on the CPU run's paths and features (whether the two runs'
   paths agree is printed). (c) Against the port's CPU run on the same
   inputs: ``extract_stft_features_stacked`` of the 8 source utterances
   (rtol 1e-5 with a floor of 1e-5 of the peak, equal frame counts, padded
   frames 0), ``mcep_to_spectrum`` of the held-out target's MCEPs (1e-5
   relative), ``spectral_convergence`` of the converted magnitude against
   the input's (1e-6 relative), ``warping_forward_batch`` and
   ``warping_forward`` at the default net on the MFCC batch (1e-5
   absolute). (d) ``pipelines.cli.main(["separate", ...])`` on the 2 s
   mixture written as a stereo wav with distinct channels: its wavs' energies
   within 0.3 % and its ``nll_last`` within 1e-4 of ``separate_signal`` on
   the duplicated downmix from the same key (the distance to the
   fit of the file's own channels is printed). Each step's walls (cold,
   then warm) are printed. Nothing in the phase catches a failure.
13. seeded draws: the port's counterpart of ``jax.random``
   (``exemplars_vc_tpu_torch/prng.py``) and the seeded commands against
   the JAX package's numbers in ``io/data/jax_prng_golden.npz``
   (``tools/jax_prng_golden.py``, JAX on the CPU). (a) On the card: the keys
   and splits of seeds 0, 1, 42 and 2³¹−1, their bits, ``uniform`` (with
   and without the warping net's bounds) and ``randint`` at a scalar, an odd
   length, a zero size and (2, 201, 8) bit-equal to ``jax.random``'s, and
   ``normal`` within 4 ulp; the default key's WORLD noise (80,000 samples)
   within 4 ulp. (b) The CLI on the
   2 s mixture written as a wav: ``separate-lead --model stereo --seed 1``
   (15 iterations, 20 components) on the card and on the CPU, its lead
   energy share within 0.01 of the CPU run's and within 1e-3 of the JAX
   CLI's (0.1323: read back from PCM16 the split lands there in both
   packages; phase 11 holds the float mixture's 0.6757); ``separate --seed
   0`` (20 EM) on the card against the JAX CLI: ``nll_first`` within 1e-5,
   ``nll_last`` within 2e-3 and the source energies within 5e-2 relative
   (``tests/test_torch_cli.py``'s tolerances: the duplicated channels let
   the EM turn roundoff into per-cent differences). (c) One WORLD
   conversion of the stand-in corpus from the default key, the synthesizer's
   kept noise cleared first: the one noise it draws within 4 ulp of the
   golden ``normal(PRNGKey(0))`` (a draw of n is the first n of a longer
   one), its stand-in WORLD MCD printed. (d) The time of the path's
   largest draw, ``normal(key, (2, 8, 12001)) ** 2`` (H of the 60 s
   ``separate``), on the CPU and on the card (median of 7); and
   ``world.synthesize`` at (c)'s length on the card from the default key's
   kept noise and from ``key=PRNGKey(0)`` drawn on the host each call:
   equal audio, both walls (median of 7).
   Nothing in the phase catches a failure.

The line before the last is ``{"kernels": [...]}`` (``launches``: the main
path's, and for the two fused kernels the fused path's; ``launches_serving``:
the serving phase's; ``launches_world``: the WORLD phase's;
``launches_stage02``: phase 8's; ``launches_parallel``: phase 9's rank 0 in
the two-rank world; ``launches_surface``: phase 12's traced conversion; the
DTW kernels also carry their time and bound at the DFW shape, ``dfw_ms``
and ``dfw_bound_ms``, and the wavefront its tile
mode's launches in phase 9, ``tile_launches_parallel``, its time with and
without codes, bound and largest error against the twin; ``nmf_recon`` and
``nmf_update`` their largest error against the twin at phase 9's shards,
``shard_max_abs_err``); the last line is
``{"ok": true, "device": {...}}``. The stand-in MCD is not comparable to the
real corpus's.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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


def gl_yardstick(torch, mag, ang0, n_fft: int, hop: int, n_iter: int, momentum: float):
    """The library yardstick of ``gl_angles_fused`` (its ``library_ms``):
    the twin's center=False iteration written with ``torch.fft.irfft`` /
    ``rfft`` and ``F.fold``, ``n_iter`` of them captured as one CUDA graph.
    Returns (replay, angles): each replay of the graph recomputes the
    angles from ``ang0``. The port never calls it."""
    import torch.nn.functional as Fn
    from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import _inv_wsum
    from exemplars_vc_tpu_torch.dsp.windows import get_window

    dev, F = mag.device, mag.shape[0]
    L = n_fft + hop * (F - 1)
    w = get_window("hann", n_fft, device=dev)
    inv_w = torch.as_tensor(_inv_wsum(F, n_fft, hop, "hann").reshape(-1), device=dev)
    alpha = momentum / (1.0 + momentum)
    mag = torch.clamp(mag, min=0.0).float()
    ang = ang0.to(torch.complex64).clone()
    prev = torch.zeros_like(ang)

    def loop(k):
        a, p = ang, prev
        for _ in range(k):
            frames = torch.fft.irfft(mag * a, n=n_fft) * w
            y = Fn.fold(frames.T[None], output_size=(1, L), kernel_size=(1, n_fft),
                        stride=(1, hop)).reshape(L) * inv_w
            rebuilt = torch.fft.rfft(y.unfold(0, n_fft, hop) * w)
            t = rebuilt - alpha * p
            a, p = t / torch.clamp(torch.abs(t), min=1e-16), rebuilt
        return a

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):   # cuFFT's plans before the capture
        loop(1)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = loop(n_iter)
    return graph.replay, out


def kernel_events_ms(fn, name: str) -> list[float]:
    """Device milliseconds of each launch of the kernel ``name`` in one
    profiled ``fn()``, in launch order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA and name in ev.name),
                 key=lambda ev: ev.time_range.start)
    return [ev.time_range.elapsed_us() / 1e3 for ev in evs]


def dtw_long(torch, np, dev, rng) -> dict:
    """A source longer than one launch's reach: 40,000 × 500 (4-dim
    features), the default bands (32,768 + 7,232 rows) against bands of
    8192 rows, byte for byte; the path monotone and from corner to corner."""
    from exemplars_vc_tpu_torch.align import dtw_cuda
    from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist
    from exemplars_vc_tpu_torch.align.dtw_cuda import dtw_backtrace, dtw_wavefront

    ta, tb = 40_000, 500
    fa = torch.as_tensor(rng.standard_normal((1, ta, 4)).astype(np.float32), device=dev)
    fb = torch.as_tensor(rng.standard_normal((1, tb, 4)).astype(np.float32), device=dev)
    C = pairwise_sqdist(fa, fb).contiguous()
    lens = torch.tensor([[ta, tb]], dtype=torch.int32, device=dev)
    runs = {}
    for rows in (dtw_cuda.MAX_TA, 8192):
        launched = dtw_wavefront.launches
        cost, dirs = dtw_wavefront(C, lens, band_rows=rows)
        paths = dtw_backtrace(dirs, lens)
        torch.cuda.synchronize()
        runs[rows] = (dtw_wavefront.launches - launched, cost, paths)
        if rows == dtw_cuda.MAX_TA:
            dirs_default = dirs
        elif not torch.equal(dirs, dirs_default):
            fail(f"dtw {ta} x {tb}: codes in bands of {rows} rows differ from the default bands "
                 f"at {int((dirs != dirs_default).sum())} cells")
        del dirs
    (nb, cost, paths), (nb8, cost8, paths8) = runs[dtw_cuda.MAX_TA], runs[8192]
    if not (torch.equal(cost, cost8) and all(torch.equal(a, b) for a, b in zip(paths, paths8))):
        fail(f"dtw {ta} x {tb}: distance or path differ between the bands")
    n = int(paths[2][0])
    pi, pj = paths[0][0, :n].cpu(), paths[1][0, :n].cpu()
    if not ((pi.diff() >= 0).all() and (pj.diff() >= 0).all()
            and (int(pi[0]), int(pj[0]), int(pi[-1]), int(pj[-1])) == (0, 0, ta - 1, tb - 1)):
        fail(f"dtw {ta} x {tb}: the path is not monotone from (0, 0) to ({ta - 1}, {tb - 1})")
    ms = cuda_ms(lambda: dtw_wavefront(C, lens), reps=3)
    ms8 = cuda_ms(lambda: dtw_wavefront(C, lens, band_rows=8192), reps=3)
    bt_ms = cuda_ms(lambda: dtw_backtrace(dirs_default, lens), reps=3)
    per_band = kernel_events_ms(lambda: dtw_wavefront(C, lens), "dtw_wavefront_kernel")
    say(f"dtw {ta} x {tb} in row bands: {nb} bands of <= {dtw_cuda.MAX_TA} rows equal {nb8} bands "
        f"of 8192 (codes, distance {float(cost[0]) / (ta + tb):.6f}, path of {n} cells, monotone "
        f"from (0, 0) to ({ta - 1}, {tb - 1})); wavefront {ms:.4f} ms (bands of 8192: {ms8:.4f} "
        f"ms), device time a band {[round(v, 4) for v in per_band]} ms; backtrace {bt_ms:.4f} ms; "
        f"codes {(ta + tb - 1) * ta / 2**30:.3f} GiB")
    del dirs_default
    torch.cuda.empty_cache()
    return dict(ms=ms, ms_8192=ms8, band_ms=per_band, backtrace_ms=bt_ms, bands=nb)


def nmf_world_shape(torch, np, dev, rng, n_sms) -> dict:
    """``nmf_recon`` and ``nmf_update`` at the WORLD path's solve, F = 688,
    K = 6144, D = 513 (sp and ap: fft 1024), against their twins (1e-5 one
    call, 1e-4 after 10 MU steps), timed beside the twins, the bound and
    ``torch.matmul``."""
    from exemplars_vc_tpu_torch.factorize.nmf_cuda import (
        co_resident_clusters, nmf_recon, nmf_recon_plain, nmf_recon_plan, nmf_update,
        nmf_update_plain, nmf_update_plan)

    F, K, D = 688, 6144, 513
    for name, plan_fn in (("nmf_recon", nmf_recon_plan), ("nmf_update", nmf_update_plan)):
        pl = plan_fn(F, K, D, n_sms)
        say(f"{name} plan at F={F} K={K} D={D}: grid {pl['grid']} of {pl['threads']} threads, "
            f"cluster {pl.get('cluster', (1, 1, 1))}, tile {pl['tile']}, {pl['smem_bytes']} B "
            f"shared, {co_resident_clusters(name, pl, F, K, D)} at once on {n_sms} SMs")
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    A[K - 300:] = 0.0
    A = torch.as_tensor(A, device=dev)
    X = torch.as_tensor(np.abs(rng.standard_normal((F, D))).astype(np.float32), device=dev)
    H = torch.as_tensor(rng.uniform(0.0, 0.02, (F, K)).astype(np.float32), device=dev)
    Num = X @ A.T
    P = nmf_recon_plain(H, A)
    H1 = nmf_update_plain(P, A, H, Num)
    e_r, e_u = rel_err(nmf_recon(H, A), P), rel_err(nmf_update(P, A, H, Num), H1)
    Hk, Hp = H.clone(), H.clone()
    for _ in range(10):
        Hk = nmf_update(nmf_recon(Hk, A), A, Hk, Num, out=Hk)
        Hp = nmf_update_plain(nmf_recon_plain(Hp, A), A, Hp, Num)
    e_10 = rel_err(Hk, Hp)
    torch.cuda.synchronize()
    say(f"nmf: F={F} K={K} D={D} (the WORLD solve): rel err recon {e_r:.3g}, update {e_u:.3g} "
        f"(limit 1e-5), 10 MU steps {e_10:.3g} (limit 1e-4)")
    if not (e_r <= 1e-5 and e_u <= 1e-5 and e_10 <= 1e-4):
        fail("nmf kernels outside tolerance at D = 513")
    fkd, fk = 2 * F * K * D, F * K
    out = {
        "nmf_recon": dict(max_abs_err=float((nmf_recon(H, A) - P).abs().max()),
                          ms=cuda_ms(lambda: nmf_recon(H, A)),
                          plain_ms=cuda_ms(lambda: nmf_recon_plain(H, A)),
                          library_ms=cuda_ms(lambda: torch.matmul(H, A)),
                          bound=bound(4 * (fk + K * D + F * D), fkd)),
        "nmf_update": dict(max_abs_err=float((nmf_update(P, A, H, Num) - H1).abs().max()),
                           ms=cuda_ms(lambda: nmf_update(P, A, H, Num)),
                           plain_ms=cuda_ms(lambda: nmf_update_plain(P, A, H, Num)),
                           library_ms=None,
                           bound=bound(4 * (F * D + K * D + 3 * fk), fkd + 4 * fk)),
    }
    for name, r in out.items():
        say(f"  {name} at F={F} K={K} D={D}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library {fmt_ms(r['library_ms'])}, bound {r['bound'][0]:.6f} ms "
            f"({r['bound'][1]}), roofline share {r['bound'][0] / r['ms']:.4f}, max_abs_err "
            f"{r['max_abs_err']:.3g}")
    return out


def nmf_recon_served(torch, np, dev, rng, n_sms) -> dict:
    """``nmf_recon`` at the benchmark cells' shapes over the 14,336-exemplar
    dictionary: a stream chunk (F = 16, D = 201: the TM = 1 tile), a
    request on the STFT path (F = 620, D = 201) and on the WORLD path (F =
    620, D = 1025), both TM = 8. Each is held within 1e-5 relative of its
    twin, two launches must give equal bits, and each is timed by the
    profiler's device time of 20 back-to-back launches (median of 3
    readings) beside ``torch.matmul`` and the bound."""
    from exemplars_vc_tpu_torch.factorize.nmf_cuda import (
        co_resident_clusters, nmf_recon, nmf_recon_plain, nmf_recon_plan)

    def per_launch_ms(fn, n=20, reps=3):
        # the profiler's device time of n launches in a row: at F = 16 the
        # host takes longer to issue a launch than the kernel runs, so CUDA
        # events around the loop would time the host
        fn()
        return statistics.median(device_ms(lambda: [fn() for _ in range(n)]) / n
                                 for _ in range(reps))

    out = {}
    K = 14_336
    for F, D in ((16, 201), (620, 201), (620, 1025)):
        pl = nmf_recon_plan(F, K, D, n_sms)
        A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
        A[K - 300:] = 0.0
        A = torch.as_tensor(A, device=dev)
        H = torch.as_tensor(rng.uniform(0.0, 0.02, (F, K)).astype(np.float32), device=dev)
        P = nmf_recon_plain(H, A)
        P1, P2 = nmf_recon(H, A), nmf_recon(H, A)
        e = rel_err(P1, P)
        same = bool(torch.equal(P1, P2))
        ms = per_launch_ms(lambda: nmf_recon(H, A))
        lib = per_launch_ms(lambda: torch.matmul(H, A))
        b_ms, b_by = bound(4 * (F * K + K * D + F * D), 2 * F * K * D)
        say(f"nmf_recon at the served shape F={F} K={K} D={D}: plan tile {pl['tile']}, "
            f"thread tile {pl['thread_tile']}, {pl['grid'][0]} CTAs "
            f"({co_resident_clusters('nmf_recon', pl, F, K, D)} at once), {pl['units']} units = "
            f"{pl['tiles']} tiles x {pl['pieces']} K pieces in {pl['groups']} groups; rel err "
            f"{e:.3g} (limit 1e-5), repeat equal bits {same}; {ms * 1e3:.1f} us a launch (device, "
            f"20 in a row), torch.matmul {lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), "
            f"roofline share {b_ms / ms:.4f}")
        if not (e <= 1e-5 and same):
            fail(f"nmf_recon at F={F} K={K} D={D}: rel err {e:.3g} or repeat launches differ")
        out[f"{F}x{K}x{D}"] = dict(tile=pl["tile"], rel_err=e, ms=ms, library_ms=lib,
                                   bound_ms=b_ms, bound_by=b_by)
        del A, H, P, P1, P2
    torch.cuda.empty_cache()
    return out


def phase_kernels(torch, np, dev) -> dict:
    from exemplars_vc_tpu_torch.align import dtw_cuda
    from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist
    from exemplars_vc_tpu_torch.align.dtw_cuda import (
        dtw_backtrace, dtw_backtrace_plain, dtw_wavefront, dtw_wavefront_plain,
        dtw_wavefront_plan)
    from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
    from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import (
        gl_angles_fused, gl_angles_fused_plain, gl_fused_plan, gl_fused_resident,
        grid_sync_probe)
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
    def dtw_case(name, n, ta, tb, dim, lens_rows, timed, plain_reps=3, band_rows=None):
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
        if band_rows is not None:
            launched = dtw_wavefront.launches
            cost_b, dirs_b = dtw_wavefront(C, lens, band_rows=band_rows)
            torch.cuda.synchronize()
            bands = dtw_wavefront.launches - launched
            if not (torch.equal(dirs_b, dirs_p) and torch.equal(cost_b, cost_p)):
                fail(f"dtw_wavefront in bands of {band_rows} rows != twin at {name}: "
                     f"{int((dirs_b != dirs_p).sum())} codes differ")
            say(f"dtw {name}: the wavefront in {bands} bands of {band_rows} rows equals the "
                f"twin (codes and costs)")
            del dirs_b
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
                               plain_ms=cuda_ms(lambda: dtw_wavefront_plain(C, lens),
                                                reps=plain_reps),
                               bound_ms=wf[0], bound_by=wf[1], library_ms=None),
                backtrace=dict(max_abs_err=float(max((a - b).abs().max()
                                                     for a, b in zip(paths_k, paths_p))),
                               ms=bms, plain_ms=cuda_ms(lambda: dtw_backtrace_plain(dirs_k, lens),
                                                        reps=plain_reps),
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
                    timed=True, band_rows=1024)
    out["dtw_wavefront"], out["dtw_backtrace"] = main["wavefront"], main["backtrace"]
    say(f"  main path costs {[round(float(c), 3) for c in main['cost'][:3]]}..., path_len "
        f"{main['paths'][2][:3].tolist()}...")
    mcd = dtw_case("MCD", 1, 683, 683, 26, [[683, 683]], timed=True)
    for name, ta, tb in (("Ta>1024, Ta%32!=0", 1409, 1300), ("Ta<Tb", 300, 517),
                         ("Ta>Tb", 517, 300)):
        dtw_case(name, 4, ta, tb, 20, [[ta, tb], [1, tb], [ta, 1], [1, 1]], timed=False)
    top = dtw_case("longest Ta", 1, dtw_cuda.MAX_TA, 2000, 4, [[dtw_cuda.MAX_TA, 2000]],
                   timed=True, plain_reps=1)
    for name in ("wavefront", "backtrace"):
        r = top[name]
        say(f"  dtw_{name} at Ta = {dtw_cuda.MAX_TA} x 2000: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    del top
    out["_dtw_long"] = dtw_long(torch, np, dev, rng)
    out["_dtw_mcd"] = mcd

    # NMF at the main path's shapes
    F, K, D = 688, 7680, 201
    for k in (K, 115_200):
        pl = nmf_recon_plan(F, k, D, n_sms)
        say(f"nmf_recon plan at F={F} K={k} D={D}: {pl['grid'][0]} CTAs of {pl['threads']} "
            f"threads, tile {pl['tile']}, thread tile {pl['thread_tile']}, "
            f"{pl['stages']}-deep cp.async ring, {pl['smem_bytes']} B shared, "
            f"{pl['units']} units: {pl['tiles']} tiles x {pl['pieces']} K pieces "
            f"{pl['piece_bounds'][:3]}... in {pl['groups']} groups, "
            f"{co_resident_clusters('nmf_recon', pl, F, k, D)} CTAs at once on {n_sms} SMs")
        pl = nmf_mu_fused_plan(F, k, D, n_sms)
        ctas = pl["grid"][0] * pl["grid"][1] * pl["grid"][2]
        say(f"nmf_mu_fused plan at F={F} K={k} D={D}: grid {pl['grid']} = {ctas} CTAs of "
            f"{pl['threads']} threads, cluster {pl['cluster']}, tile {pl['tile']}, "
            f"thread tile {pl['thread_tile']}, {pl['stages']}-deep cp.async ring, "
            f"{pl['smem_bytes']} B shared, K slices {pl['k_bounds'][:3]}..., "
            f"{co_resident_clusters('nmf_mu_fused', pl, F, k, D)} clusters at once on "
            f"{n_sms} SMs")
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

    # the serving path's stacked solve: four utterances of 688 frames over the
    # dictionary and its four VTLP copies (5 x 6144 rows); H alone is 338 MB
    Fs, Ks = 2752, 30_720
    for name, plan_fn in (("nmf_recon", nmf_recon_plan), ("nmf_update", nmf_update_plan)):
        pl = plan_fn(Fs, Ks, D, n_sms)
        say(f"{name} plan at F={Fs} K={Ks} D={D}: grid {pl['grid']} of {pl['threads']} threads, "
            f"cluster {pl.get('cluster', (1, 1, 1))}, tile {pl['tile']}, {pl['smem_bytes']} B "
            f"shared, {co_resident_clusters(name, pl, Fs, Ks, D)} at once on {n_sms} SMs")
    As = np.abs(rng.standard_normal((Ks, D))).astype(np.float32)
    As[Ks - 300:] = 0.0
    As = torch.as_tensor(As, device=dev)
    Xs = torch.as_tensor(np.abs(rng.standard_normal((Fs, D))).astype(np.float32), device=dev)
    Hs = torch.as_tensor(rng.uniform(0.0, 0.02, (Fs, Ks)).astype(np.float32), device=dev)
    Nums = Xs @ As.T
    Ps = nmf_recon_plain(Hs, As)
    e_rs = rel_err(nmf_recon(Hs, As), Ps)
    a_rs = float((nmf_recon(Hs, As) - Ps).abs().max())
    H1s = nmf_update_plain(Ps, As, Hs, Nums)
    e_us = rel_err(nmf_update(Ps, As, Hs, Nums), H1s)
    a_us = float((nmf_update(Ps, As, Hs, Nums) - H1s).abs().max())
    del H1s
    Hk, Hp = Hs.clone(), Hs.clone()
    for _ in range(10):
        Hk = nmf_update(nmf_recon(Hk, As), As, Hk, Nums, out=Hk)
        Hp = nmf_update_plain(nmf_recon_plain(Hp, As), As, Hp, Nums)
    e_s10 = rel_err(Hk, Hp)
    del Hk, Hp
    torch.cuda.synchronize()
    say(f"nmf: F={Fs} K={Ks} D={D}: rel err recon {e_rs:.3g}, update {e_us:.3g} (limit 1e-5), "
        f"10 MU steps {e_s10:.3g} (limit 1e-4)")
    if not (e_rs <= 1e-5 and e_us <= 1e-5 and e_s10 <= 1e-4):
        fail("nmf kernels outside tolerance at F = 2752, K = 30,720")
    fkd_s, fk_s = 2 * Fs * Ks * D, Fs * Ks
    serving = {
        "nmf_recon": dict(max_abs_err=a_rs, ms=cuda_ms(lambda: nmf_recon(Hs, As), reps=5),
                          plain_ms=cuda_ms(lambda: nmf_recon_plain(Hs, As), reps=5),
                          library_ms=cuda_ms(lambda: torch.matmul(Hs, As), reps=5),
                          bound=bound(4 * (fk_s + Ks * D + Fs * D), fkd_s)),
        "nmf_update": dict(max_abs_err=a_us,
                           ms=cuda_ms(lambda: nmf_update(Ps, As, Hs, Nums), reps=5),
                           plain_ms=cuda_ms(lambda: nmf_update_plain(Ps, As, Hs, Nums), reps=5),
                           library_ms=None,
                           bound=bound(4 * (Fs * D + Ks * D + 3 * fk_s), fkd_s + 4 * fk_s)),
    }
    for name, r in serving.items():
        say(f"  {name} at F={Fs} K={Ks}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {fmt_ms(r['library_ms'])}, bound {r['bound'][0]:.6f} ms ({r['bound'][1]}), "
            f"roofline share {r['bound'][0] / r['ms']:.4f}, max_abs_err {r['max_abs_err']:.3g}")
    del As, Xs, Hs, Nums, Ps
    torch.cuda.empty_cache()
    out["_nmf_world"] = nmf_world_shape(torch, np, dev, rng, n_sms)
    out["_nmf_served"] = nmf_recon_served(torch, np, dev, rng, n_sms)

    # the fused Griffin-Lim against its twins, 6 iterations under the PERF.md
    # §2 gates, at n_fft 48 (M = 24 = 8 x 3, a radix-3 pass) and at the main
    # path's shape; other tiles give equal bits
    def gl_case(Fg, n_fft, hop):
        nb = n_fft // 2 + 1
        mag = torch.as_tensor(np.abs(rng.standard_normal((Fg, nb))).astype(np.float32),
                              device=dev)
        ang = torch.as_tensor(np.exp(2j * np.pi * rng.random((Fg, nb))).astype(np.complex64),
                              device=dev)
        g6 = gl_angles_fused(mag, ang, n_fft, hop, 6, 0.9)
        p6 = gl_angles_fused_plain(mag, ang, n_fft, hop, 6, 0.9)
        r6 = gl_angles_fused_plain(mag.double(), ang.to(torch.complex128), n_fft, hop, 6, 0.9)
        plan = gl_fused_plan(Fg, n_fft, hop, n_sms)
        others = (dict(plan, tile=plan["tile"] + 1), dict(plan, tile=plan["tile"] + 2))
        same = all(torch.equal(gl_angles_fused(mag, ang, n_fft, hop, 6, 0.9, _plan=o), g6)
                   for o in others)
        torch.cuda.synchronize()
        e_gl = float((g6 - p6).abs().max())
        e_l2 = float(torch.linalg.norm(g6 - p6) / torch.linalg.norm(p6))
        d_k, d_p = (g6 - r6).abs(), (p6 - r6).abs()
        card = gl_fused_resident(plan, n_fft, hop)
        say(f"gl_angles_fused: F={Fg} bins={nb} n_fft={n_fft} hop={hop}, 6 iterations: kernel "
            f"vs twin max |phase diff| {e_gl:.3g}, rel L2 {e_l2:.3g} (limit 1e-4); against "
            f"float64, mean / max: kernel {float(d_k.mean()):.3g} / {float(d_k.max()):.3g}, "
            f"float32 twin {float(d_p.mean()):.3g} / {float(d_p.max()):.3g} (limit: kernel mean "
            f"<= 2x the twin's + 1e-7); tiles {plan['tile']} + 1 and + 2 bit-equal: {same}; "
            f"plan: {plan['grid']} CTAs of {plan['threads']} threads, tile "
            f"{plan['tile']}, radices {plan['radices']}, {card['smem_bytes']} B shared memory, "
            f"{card['resident']} CTAs fit at once")
        if not (e_l2 <= 1e-4 and float(d_k.mean()) <= 2 * float(d_p.mean()) + 1e-7 and same):
            fail(f"gl_angles_fused outside tolerance at n_fft {n_fft}, or plans disagree")
        return mag, ang, plan, e_gl, p6

    gl_case(300, 48, 16)
    Fg, n_fft, hop, n_it = 688, 400, 80, 300
    nb = n_fft // 2 + 1
    mag, ang, plan, e_gl, p6 = gl_case(Fg, n_fft, hop)
    replay6, y6 = gl_yardstick(torch, mag, ang, n_fft, hop, 6, 0.9)
    replay6()
    torch.cuda.synchronize()
    e_y = float(torch.linalg.norm(y6 - p6) / torch.linalg.norm(p6))
    say(f"  graphed cuFFT yardstick, 6 iterations: rel L2 to the twin {e_y:.3g} (limit 1e-4)")
    if e_y > 1e-4:
        fail("the graphed cuFFT yardstick does not compute the twin's iteration")
    replay300, _ = gl_yardstick(torch, mag, ang, n_fft, hop, n_it, 0.9)
    out["gl_angles_fused"] = dict(
        max_abs_err=e_gl, ms=cuda_ms(lambda: gl_angles_fused(mag, ang, n_fft, hop, n_it, 0.9),
                                     reps=5),
        plain_ms=cuda_ms(lambda: gl_angles_fused_plain(mag, ang, n_fft, hop, n_it, 0.9), reps=3),
        library_ms=cuda_ms(replay300, reps=5))
    # bound: each iteration and frame needs an inverse and a forward real FFT
    # of n_fft (2.5·n_fft·log2(n_fft) flops each, the usual split-radix
    # count), the window, overlap-add and normaliser (4·n_fft) and the
    # per-bin product, momentum and normalisation (12·bins); it reads the
    # magnitudes and phases once and writes the phases
    out["gl_angles_fused"]["bound_ms"], out["gl_angles_fused"]["bound_by"] = bound(
        4 * Fg * nb + 2 * 8 * Fg * nb,
        n_it * Fg * (2 * 2.5 * n_fft * math.log2(n_fft) + 4 * n_fft + 12 * nb))
    sync_ms = cuda_ms(lambda: grid_sync_probe(plan["grid"], n_it, dev), reps=3)
    prod = {}
    for graph in (True, False):
        def run(graph=graph):
            griffin_lim(mag, n_fft=n_fft, hop_length=hop, n_iter=n_it, init_phase=ang,
                        _graph=graph)
        prod[graph] = (cuda_ms(run, reps=3), device_ms(run))
    say(f"  {n_it} iterations: fused kernel {out['gl_angles_fused']['ms']:.4f} ms; twin "
        f"{out['gl_angles_fused']['plain_ms']:.4f} ms; graphed cuFFT yardstick "
        f"{out['gl_angles_fused']['library_ms']:.4f} ms; floor of {n_it} grid syncs on "
        f"{plan['grid']} blocks {sync_ms:.4f} ms ({sync_ms / n_it * 1e3:.3f} us each); "
        f"production griffin_lim (center=True) graphed {prod[True][0]:.4f} ms (device "
        f"{fmt_ms(prod[True][1])}), eager {prod[False][0]:.4f} ms (device "
        f"{fmt_ms(prod[False][1])})")
    mcd = out.pop("_dtw_mcd")
    extra = {k: out.pop(k) for k in ("_dtw_long", "_nmf_world", "_nmf_served")}
    for name, r in out.items():
        say(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{fmt_ms(r['library_ms'])}, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
            f"roofline share {r['bound_ms'] / r['ms']:.4f}, max_abs_err {r['max_abs_err']:.3g}")
    for name in ("wavefront", "backtrace"):
        r = mcd[name]
        say(f"  dtw_{name} at the MCD shape: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), roofline share "
            f"{r['bound_ms'] / r['ms']:.4f}")
    out.update(extra)
    return out


def phase_main_path(torch, np, dev, root: str, corpus: tuple, counted: dict,
                    fused: dict) -> tuple[dict, float]:
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import extract_stft_complex
    from exemplars_vc_tpu_torch.pipelines.convert import _aligned_dicts, convert_utterance

    gl_mod = importlib.import_module("exemplars_vc_tpu_torch.dsp.griffin_lim")
    data, src, tar = corpus
    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    audio_s = 0.0
    for spk in ("SF1", "TF1"):
        for name in sorted(os.listdir(os.path.join(data, spk))):
            x, sr = read_wav(os.path.join(data, spk, name))
            audio_s += len(x) / sr
    x_in, sr = read_wav(src)
    audio_s += len(x_in) / sr

    gl_mod._loops.clear()    # phase 2 captured graphs of this shape
    captures = gl_mod.griffin_lim.captures
    for fn in (*counted.values(), *fused.values()):
        fn.launches = 0
    t0 = time.perf_counter()
    res = convert_utterance(cfg, ArtifactStore(os.path.join(root, "store0")), data, src,
                            nb_file=8, reference_wav=tar, sync_stages=True, device=dev)
    cold_s = time.perf_counter() - t0
    captures_cold = gl_mod.griffin_lim.captures - captures
    captures = gl_mod.griffin_lim.captures
    launches = {name: fn.launches for name, fn in counted.items()}
    off_path = {name: fn.launches for name, fn in fused.items()}
    F, K, D = res.nmf_shape
    say(f"main path: F={F} K={K} D={D} n_iter={res.n_iter} nmf_error={res.nmf_error:.6g}")
    say(f"main path: launches {launches}; Griffin-Lim graphs captured {captures_cold}")
    say(f"main path: first run {cold_s:.4f} s, fenced stages (s) "
        f"{json.dumps({k: round(v, 6) for k, v in res.timings.items()})}")
    say(f"main path: stand-in held-out MCD {res.mcd_vs_reference:.4f} dB "
        f"(stand-in corpus; not comparable to the real corpus's figure)")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    if launches["nmf_recon"] != 1 + res.n_iter or launches["nmf_update"] != res.n_iter:
        fail(f"the solve must launch nmf_recon 1 + n_iter times (the error check's recon feeds "
             f"the next update) and nmf_update n_iter times: {launches}, n_iter {res.n_iter}")
    if captures_cold < 1:
        fail("the main path's Griffin-Lim captured no graph")
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
    fenced = convert_utterance(cfg, ArtifactStore(os.path.join(root, "store_fenced")), data,
                               src, nb_file=8, sync_stages=True, device=dev)
    say(f"main path: a warm run's fenced stages (s) "
        f"{json.dumps({k: round(v, 6) for k, v in fenced.timings.items()})}")

    # the dictionary stage alone, fenced, from fresh stores (nothing memoised,
    # the DTW runs): the paths and features go to the store's writer through
    # pinned copies on a side stream, and only path_len is read back
    dict_ms = []
    for k in range(5):
        store = ArtifactStore(os.path.join(root, f"store_dicts{k}"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _aligned_dicts(cfg, store, data, 8, dev)
        torch.cuda.synchronize()
        dict_ms.append((time.perf_counter() - t0) * 1e3)
        store.flush()
    say(f"main path: the dicts stage fenced, 5 fresh builds: {[round(v, 3) for v in dict_ms]} ms, "
        f"median {statistics.median(dict_ms):.4f} ms, min {min(dict_ms):.4f} ms")

    # one more build, its parts fenced one by one
    from exemplars_vc_tpu_torch.align.dtw import dtw_batch
    from exemplars_vc_tpu_torch.align.exemplar import build_exemplar_dicts_padded
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import build_conversion_dicts_pair
    from exemplars_vc_tpu_torch.pipelines.make_dict import DictionaryArtifacts, pair_mfcc

    parts, t_prev = {}, [0.0]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = round((now - t_prev[0]) * 1e3, 3)
        t_prev[0] = time.perf_counter()

    store = ArtifactStore(os.path.join(root, "store_dicts_parts"))
    torch.cuda.synchronize()
    t_prev[0] = time.perf_counter()
    (FA, la), (FB, lb) = pair_mfcc(cfg, data, 8, dev)
    lap("pair MFCC (load, stack, copy to the card, MFCC)")
    r = dtw_batch(FA, FB, la, lb)
    path_len = r.path_len.cpu()
    lap("DTW (cost matmul, both kernels, path_len back)")
    art = DictionaryArtifacts(path_i=r.path_i, path_j=r.path_j, path_len=path_len, feat_a=FA,
                              feat_b=FB, len_a=torch.as_tensor(la, device=dev),
                              len_b=torch.as_tensor(lb, device=dev), distance=r.distance.cpu())
    store.save("parts", **art.host_copies())
    lap("pinned copies queued, writer started")
    sf, tf = build_conversion_dicts_pair(cfg, store, data, "SF1", "TF1", nb_file=8, device=dev)
    lap("|STFT| of both speakers (stack, copy to the card, STFT)")
    k_true = int(path_len.sum())
    build_exemplar_dicts_padded(sf.feats["stft"], tf.feats["stft"], r.path_i, r.path_j,
                                k_pad=((k_true + 511) // 512) * 512)
    lap("exemplar gather")
    store.flush()
    say(f"main path: one build's parts, each fenced (ms): {json.dumps(parts)}")

    if gl_mod.griffin_lim.captures != captures:
        fail(f"a warm run captured graphs again: {gl_mod.griffin_lim.captures - captures}")

    # the production Griffin-Lim on the main path's Y and seed phase: the
    # graphs against the eager loop (bit-equal), and each block size's cold
    # call (capture and replays) and warm wall, graphs of the shape captured
    # anew; the pool memory is what the device holds after the cold call
    Y = res.converted["stft"]
    S = extract_stft_complex(x_in, cfg, dev)
    n_fft, hop, iters = cfg.mcep.frame_length, cfg.mcep.hop_length, cfg.nmf.griffin_lim_iters

    def gl(graph=True):
        return gl_mod.griffin_lim(Y, n_fft=n_fft, hop_length=hop, n_iter=iters,
                                  length=len(x_in), init_phase=S, _graph=graph)

    y_eager = gl(graph=False)
    default_block = gl_mod.GRAPH_BLOCK
    for block in sorted({default_block, 10, 50, iters}):
        gl_mod.GRAPH_BLOCK = block
        gl_mod._loops.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0, caps0 = torch.cuda.memory_allocated(dev), gl_mod.griffin_lim.captures
        t0 = time.perf_counter()
        y_graph = gl()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        mem = torch.cuda.memory_allocated(dev) - mem0
        caps = gl_mod.griffin_lim.captures - caps0
        warm_ms = wall_ms(gl)
        if not torch.equal(y_graph, y_eager) or gl_mod.griffin_lim.captures - caps0 != caps:
            fail(f"graphed griffin_lim (block {block}) is not bit-equal to the eager loop, or "
                 f"a second call captured again")
        say(f"main path GL ({iters} iterations, F={Y.shape[0]}), graphs of {block} iterations: "
            f"bit-equal to the eager loop; first call {cold_ms:.4f} ms ({caps} captures), warm "
            f"wall {warm_ms:.4f} ms, held after the first call {mem / 2**20:.3f} MiB")
    gl_mod.GRAPH_BLOCK = default_block
    gl_mod._loops.clear()
    dev_g, dev_e = device_ms(gl), device_ms(lambda: gl(graph=False))
    say(f"main path GL: warm wall graphed {wall_ms(gl):.4f} ms (device {fmt_ms(dev_g)}), eager "
        f"{wall_ms(lambda: gl(graph=False)):.4f} ms (device {fmt_ms(dev_e)})")

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
    return launches, res.mcd_vs_reference


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
        "GL production eager": wall_ms(lambda: griffin_lim(Y_f, n_fft=n_fft, hop_length=hop,
                                                           n_iter=iters, init_phase=S,
                                                           _graph=False)),
    }
    dev_ms = {
        "solve fused": device_ms(lambda: nmf_activations(X, A, fused=True, **kw)),
        "solve default": device_ms(lambda: nmf_activations(X, A, **kw)),
        "GL fused": device_ms(lambda: gl_angles_fused(Y_f, ang0, n_fft, hop, iters, 0.9)),
        "GL production": device_ms(lambda: griffin_lim(Y_f, n_fft=n_fft, hop_length=hop,
                                                       n_iter=iters, init_phase=S)),
        "GL production eager": device_ms(lambda: griffin_lim(Y_f, n_fft=n_fft, hop_length=hop,
                                                             n_iter=iters, init_phase=S,
                                                             _graph=False)),
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


def phase_serving(torch, np, dev, root: str, data: str, counted: dict, fused: dict,
                  default_mcd: float) -> dict:
    """The serving path on the stand-in corpus (module docstring, phase 5).
    Any failed gate exits; nothing here catches one."""
    from dataclasses import replace

    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore, list_speaker_wavs
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.pipelines import convert as convert_mod
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import extract_stft_complex
    from exemplars_vc_tpu_torch.pipelines.convert import mcd_between_signals
    from exemplars_vc_tpu_torch.pipelines.evaluate import heldout_pair
    from exemplars_vc_tpu_torch.pipelines.make_dict import make_dictionary
    from exemplars_vc_tpu_torch.pipelines.serve import Converter
    from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter

    gl_mod = importlib.import_module("exemplars_vc_tpu_torch.dsp.griffin_lim")
    warps = "data.dict_augment_warps=0.9,0.95,1.05,1.1"
    base = ["data.tar=TF1", "misc.nb_file=8"]
    cfg_frob = load_config(overrides=base + [warps])
    cfg_quality = load_config(preset="quality", overrides=base)
    src, tar = heldout_pair(data)
    paths = [src] + list_speaker_wavs(data, "SF1")[:3]     # four lengths
    sigs = [read_wav(p)[0] for p in paths]
    store = ArtifactStore(os.path.join(root, "store_serving"))
    all_fns = {**counted, **fused}

    def counts():
        return {name: fn.launches for name, fn in all_fns.items()}

    def built():
        return (convert_mod._aligned_dicts.builds, make_dictionary.builds,
                all_fns["dtw_wavefront"].launches, all_fns["dtw_backtrace"].launches)

    def rel_l2(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def check_audio(what, audio, x):
        if audio.shape != x.shape or not np.isfinite(audio).all():
            fail(f"serving: {what}: audio shape {audio.shape} vs input {x.shape}, or not finite")

    convert_mod._DICTS_MEMO.clear()
    for fn in all_fns.values():
        fn.launches = 0
    caps0 = gl_mod.griffin_lim.captures
    builds0 = built()

    # Frobenius + four warps: the hand-written kernels carry the solve
    conv, prepare_ms = timed(lambda: Converter(cfg_frob, store, data, nb_file=8, device=dev))
    A, B = conv.dicts["stft"]
    K = A.shape[0]
    prepared = built()
    say(f"serving: Converter (Frobenius, 4 VTLP warps): K = {K} exemplars, D = {A.shape[1]}; "
        f"prepare_seconds {conv.prepare_seconds:.4f} (wall {prepare_ms:.2f} ms); dictionary "
        f"builds {prepared[0] - builds0[0]}, DTW builds {prepared[1] - builds0[1]}, launches "
        f"{counts()}")
    if K != 30_720:
        fail(f"serving: the warped dictionary has K = {K}, not 30,720")
    if (prepared[0] - builds0[0], prepared[1] - builds0[1]) != (1, 1):
        fail("serving: the constructor must build the dictionaries exactly once")
    first, first_ms = timed(lambda: conv.convert(src))
    check_audio("convert", first.audio, sigs[0])
    walls = [timed(lambda: conv.convert(src))[1] for _ in range(3)]
    after_convert = counts()
    say(f"serving: convert(held-out): F = {1 + len(sigs[0]) // 80}, n_iter {first.nmf_iters}, "
        f"error {first.nmf_error:.6g}; first call {first_ms:.2f} ms, warm wall "
        f"{[round(w, 2) for w in walls]} ms, median {statistics.median(walls):.4f} ms; launches "
        f"of the 4 calls {after_convert}")
    batch, batch_cold_ms = timed(lambda: conv.convert_batch(paths))
    batch_walls = [timed(lambda: conv.convert_batch(paths))[1] for _ in range(2)]
    frames = [1 + len(x) // 80 for x in sigs]
    for p, b, x in zip(paths, batch, sigs):
        check_audio(f"convert_batch {os.path.basename(p)}", b.audio, x)
    singles = [conv.convert(p) for p in paths]
    single_walls = [timed(lambda p=p: conv.convert(p))[1] for p in paths]
    bw = statistics.median(batch_walls)
    say(f"serving: convert_batch of {len(paths)} (frames {frames}, stacked F = {sum(frames)}): "
        f"one stacked solve, one n_iter for the batch: {batch[0].nmf_iters} (single conversions "
        f"stop at {[s.nmf_iters for s in singles]}); first call {batch_cold_ms:.2f} ms, warm "
        f"wall {[round(w, 2) for w in batch_walls]} ms, {bw / len(paths):.4f} ms an utterance; "
        f"the same four converted one by one, warm: {[round(w, 2) for w in single_walls]} ms, "
        f"sum {sum(single_walls):.4f} ms")
    if built() != prepared:
        fail(f"serving: a conversion built the dictionaries or aligned again: {built()} after "
             f"{prepared}")
    frob_counts = counts()
    if frob_counts["nmf_recon"] < 1 or frob_counts["nmf_update"] < 1:
        fail(f"serving: the Frobenius solve did not launch its kernels: {frob_counts}")
    if max(frob_counts[name] for name in fused) > 0:
        fail(f"serving: a fused kernel launched: {frob_counts}")

    # batch ≡ single, with the tolerance off so that both run max_iter steps.
    # The stacked solve sums P over other K slices than a single one (the
    # recon's split follows F), so the converted magnitudes differ by float32
    # rounding; 300 Griffin-Lim iterations grow that difference, so the audio
    # is gated after 10 iterations (the budget of the reference's own
    # batch-against-single test) and reported after 300
    cfg_exact = replace(cfg_frob, nmf=replace(cfg_frob.nmf, tol=0.0))
    conv_x = Converter(cfg_exact, store, data, nb_file=8, device=dev)
    if built() != prepared:
        fail("serving: a second Converter of the same data built the dictionaries again")
    mags = [torch.abs(extract_stft_complex(x, cfg_exact, dev)) for x in sigs]
    st_all = convert_mod._solve_activations(torch.cat(mags), A, cfg_exact)
    Y_all = (st_all.H @ B).split([m.shape[0] for m in mags])
    e_y = max(float(torch.linalg.norm(Yb - Y1) / torch.linalg.norm(Y1))
              for Yb, Y1 in zip(Y_all, ((convert_mod._solve_activations(m, A, cfg_exact).H @ B)
                                        for m in mags)))
    del st_all, Y_all
    worst = {}
    for iters in (10, None):
        batch_x = conv_x.convert_batch(paths, synth_iters=iters)
        errs = []
        for p, b in zip(paths, batch_x):
            one = conv_x.convert(p, synth_iters=iters)
            errs.append(rel_l2(b.audio, one.audio))
            if b.nmf_iters != one.nmf_iters:
                fail(f"serving: nmf.tol=0 and yet n_iter {b.nmf_iters} vs {one.nmf_iters}")
        worst[iters] = max(errs)
    say(f"serving: batch against single at nmf.tol=0 ({batch_x[0].nmf_iters} steps both), worst "
        f"of {len(paths)}: converted magnitude rel L2 {e_y:.3g} (limit 1e-4); audio rel L2 "
        f"after 10 Griffin-Lim iterations {worst[10]:.3g} (limit 1e-4), after "
        f"{cfg_exact.nmf.griffin_lim_iters} {worst[None]:.3g} (reported: the iterations grow a "
        f"rounding difference of the magnitudes)")
    if e_y > 1e-4 or worst[10] > 1e-4:
        fail("serving: a batch item differs from its single conversion")

    # the bfloat16 solve: plain torch products by design, no hand-written kernel
    before = counts()
    conv_bf = Converter(replace(cfg_frob, nmf=replace(cfg_frob.nmf, work_dtype="bfloat16")),
                        store, data, nb_file=8, device=dev)
    bf, _ = timed(lambda: conv_bf.convert(src))
    bf_walls = [timed(lambda: conv_bf.convert(src))[1] for _ in range(3)]
    check_audio("bfloat16 convert", bf.audio, sigs[0])
    if counts() != before:
        fail("serving: the bfloat16 solve launched a hand-written kernel")
    say(f"serving: nmf.work_dtype=bfloat16 (plain torch products by design, no hand-written "
        f"kernel): n_iter {bf.nmf_iters}, error {bf.nmf_error:.6g} against float32's "
        f"{first.nmf_error:.6g}; warm wall median {statistics.median(bf_walls):.4f} ms")

    # the quality preset: KL (plain torch by design), the same warps, h_smooth=2
    before = counts()
    conv_q, q_prepare_ms = timed(lambda: Converter(cfg_quality, store, data, nb_file=8,
                                                   device=dev))
    if built() != prepared or conv_q.dicts["stft"][0].shape[0] != 30_720:
        fail("serving: the quality preset shares the warped dictionaries and must not rebuild")
    q, q_first_ms = timed(lambda: conv_q.convert(src))
    q_walls = [timed(lambda: conv_q.convert(src))[1] for _ in range(3)]
    check_audio("quality convert", q.audio, sigs[0])
    qb = conv_q.convert_batch(paths[:2])
    for p, b, x in zip(paths, qb, sigs):
        check_audio(f"quality convert_batch {os.path.basename(p)}", b.audio, x)
    ref_sig, _ = read_wav(tar)
    mcd_q = mcd_between_signals(q.audio, ref_sig, cfg_quality, dev)
    mcd_f = mcd_between_signals(first.audio, ref_sig, cfg_frob, dev)
    if counts()["nmf_recon"] != before["nmf_recon"]:
        fail("serving: the KL solve launched the Frobenius kernels")
    say(f"serving: quality preset (KL, plain torch products by design; 4 warps; h_smooth=2): "
        f"prepare {q_prepare_ms:.2f} ms (memoised dictionaries), n_iter {q.nmf_iters}, first "
        f"call {q_first_ms:.2f} ms, warm wall median {statistics.median(q_walls):.4f} ms")
    say(f"serving: stand-in preset MCD {mcd_q:.4f} dB; Frobenius + 4 warps {mcd_f:.4f} dB; the "
        f"default configuration {default_mcd:.4f} dB (stand-in corpus; not comparable to the "
        f"real corpus's figures)")
    if not (np.isfinite(mcd_q) and np.isfinite(mcd_f)):
        fail(f"serving: MCD {mcd_q}, {mcd_f}")

    # streaming on the Frobenius dictionaries
    S = extract_stft_complex(sigs[0], cfg_frob, dev)
    X = torch.abs(S)
    F, chunk, hop = X.shape[0], 16, cfg_frob.mcep.hop_length
    sc_x = StreamingConverter(cfg_exact, A, B, context_frames=32, synth_iters=60, device=dev)
    streamed = torch.cat([sc_x._convert_block(X[i: i + chunk]) for i in range(0, F, chunk)])
    whole = sc_x._convert_block(X)
    e_stream = float(torch.linalg.norm(streamed - whole) / torch.linalg.norm(whole))
    say(f"serving: stream: F = {F} in chunks of {chunk}: stacked chunk conversions against the "
        f"batch conversion at nmf.tol=0: rel L2 {e_stream:.3g} (limit 1e-4)")
    if e_stream > 1e-4:
        fail("serving: chunked conversion differs from the batch conversion")
    caps_stream = gl_mod.griffin_lim.captures
    sc = StreamingConverter(cfg_frob, A, B, context_frames=32, synth_iters=60, device=dev)
    outs, push_ms = [], []
    for i in range(0, F, chunk):
        y, ms = timed(lambda i=i: sc.push(X[i: i + chunk], S[i: i + chunk]))
        outs.append(y)
        push_ms.append(ms)
    audio = np.concatenate(outs)
    if audio.shape != (F * hop,) or not np.isfinite(audio).all():
        fail(f"serving: stream audio shape {audio.shape} vs {(F * hop,)}, or not finite")
    steady = push_ms[3:]          # the context is full from the fourth push on
    chunk_ms = 1e3 * chunk * hop / cfg_frob.data.sr
    say(f"serving: stream: {len(push_ms)} pushes of {chunk} frames ({chunk_ms:.1f} ms of audio "
        f"each), context 32, 60 Griffin-Lim iterations: first three pushes "
        f"{[round(v, 2) for v in push_ms[:3]]} ms (the context grows: a graph capture each), "
        f"steady push median {statistics.median(steady):.4f} ms, max {max(steady):.4f} ms, "
        f"{statistics.median(steady) / chunk_ms:.4f} of real time; Griffin-Lim graphs captured "
        f"by the stream {gl_mod.griffin_lim.captures - caps_stream}")
    # a second converter from a fresh store: the whole preparation again, warm
    conv2 = Converter(cfg_frob, ArtifactStore(os.path.join(root, "store_serving2")), data,
                      nb_file=8, device=dev)
    say(f"serving: a second Converter from a fresh store: prepare_seconds "
        f"{conv2.prepare_seconds:.4f} (the first, {conv.prepare_seconds:.4f}, was the first use "
        f"in the process of the expansion's kernels)")
    launches = counts()
    say(f"serving: launches of the whole phase {launches}; Griffin-Lim graphs captured "
        f"{gl_mod.griffin_lim.captures - caps0} (kept for the {gl_mod._GRAPHS_KEPT} most recent "
        f"shapes)")
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


def phase_world(torch, np, dev, root: str, corpus: tuple, counted: dict, fused: dict) -> dict:
    """The WORLD path on the stand-in corpus (module docstring, phase 7).
    Any failed gate exits; nothing here catches one."""
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.pipelines import convert as convert_mod
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import extract_world_features
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance
    from exemplars_vc_tpu_torch.pipelines.serve import Converter
    from exemplars_vc_tpu_torch.world import dio

    data, src, tar = corpus
    base = ["data.tar=TF1", "misc.nb_file=8", "data.use_stft=false"]
    cfg = load_config(overrides=base)
    all_fns = {**counted, **fused}
    audio_s = 0.0
    for spk in ("SF1", "TF1"):
        for name in sorted(os.listdir(os.path.join(data, spk))):
            x, sr = read_wav(os.path.join(data, spk, name))
            audio_s += len(x) / sr
    x_in, sr = read_wav(src)
    audio_s += len(x_in) / sr

    def rel_l2(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def convert(store_name, c=cfg, **kw):
        return convert_utterance(c, ArtifactStore(os.path.join(root, store_name)), data, src,
                                 nb_file=8, device=dev, **kw)

    convert_mod._DICTS_MEMO.clear()
    for fn in all_fns.values():
        fn.launches = 0
    syncs0 = dio.extend_from_candidates.syncs
    t0 = time.perf_counter()
    res = convert("world0", reference_wav=tar, sync_stages=True)
    cold_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in all_fns.items()}
    syncs = dio.extend_from_candidates.syncs - syncs0
    (F, K, D, n_sp), (_, K_ap, D_ap, n_ap) = res.solves["sp"], res.solves["ap"]
    say(f"world: solves sp (F, K, D) = {(F, K, D)} n_iter {n_sp}, ap {(F, K_ap, D_ap)} n_iter "
        f"{n_ap}; nmf_error {res.nmf_error:.6g}")
    say(f"world: launches {launches}; f0 contour relaxation: {syncs} host syncs in the run "
        f"(three analyses: each speaker's 8 utterances as one batch, the input; one sync every "
        f"{dio.EXTEND_CHECK_EVERY} sweeps)")
    say(f"world: first run {cold_s:.4f} s, fenced stages (s) "
        f"{json.dumps({k: round(v, 6) for k, v in res.timings.items()})}")
    say(f"world: stand-in held-out WORLD MCD {res.mcd_vs_reference:.4f} dB (stand-in corpus; "
        f"not comparable to the real corpus's figure)")
    want = {"dtw_wavefront": 2, "dtw_backtrace": 2, "nmf_recon": (1 + n_sp) + (1 + n_ap),
            "nmf_update": n_sp + n_ap, "nmf_mu_fused": 0, "gl_angles_fused": 0}
    if launches != want:
        fail(f"world: launches {launches}, expected {want}")
    if (D, D_ap) != (513, 513) or K != K_ap:
        fail(f"world: the solves' shapes {res.solves}")
    if res.audio.shape != ((F - 1) * 80,) or not np.isfinite(res.audio).all():
        fail(f"world: audio shape {res.audio.shape} for F = {F}, or not finite")
    if not np.isfinite(res.mcd_vs_reference):
        fail(f"world: MCD {res.mcd_vs_reference}")

    warm = []
    for k in range(3):
        t0 = time.perf_counter()
        convert(f"world{k + 1}")
        warm.append(time.perf_counter() - t0)
    med = statistics.median(warm)
    say(f"world: warm runs {[round(w, 4) for w in warm]} s (fresh stores: the 16 analyses and "
        f"the DTW every time), audio {audio_s:.3f} s, {audio_s / med:.3f} audio-s/s (median)")
    fenced = convert("world_fenced", sync_stages=True)
    say(f"world: a warm run's fenced stages (s) "
        f"{json.dumps({k: round(v, 6) for k, v in fenced.timings.items()})}")
    total, per = device_profile(lambda: convert(f"world_prof{time.perf_counter_ns()}"))
    kernels = {name: (calls, round(ms, 6)) for name, (calls, ms) in per.items()
               if any(k in name for k in ("dtw_wavefront_kernel", "dtw_backtrace_kernel",
                                          "nmf_recon_kernel", "nmf_update_kernel"))}
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:8]
    say(f"world: device time of one warm conversion {fmt_ms(total)}"
        + (f", busy share {total / (med * 1e3):.4f} of the warm median" if total else "")
        + f"; hand-written kernels (calls, ms) {json.dumps(kernels)}; the most device time: "
        + json.dumps([[name[:60], calls, round(ms, 3)] for name, (calls, ms) in top]))

    # the held-out utterance's WORLD features, card against the port's CPU run
    fc = extract_world_features(x_in, cfg, dev)
    fh = extract_world_features(x_in, cfg, "cpu")
    f0c, f0h = fc["f0"][:, 0].cpu().numpy(), fh["f0"][:, 0].numpy()
    agree = float(((f0c > 0) == (f0h > 0)).mean())
    both = (f0c > 0) & (f0h > 0)
    sp_db = np.abs(10 * np.log10(fc["sp"].cpu().numpy()[both])
                   - 10 * np.log10(fh["sp"].numpy()[both]))
    say(f"world: features card vs CPU ({len(f0c)} frames): voicing agrees on {agree:.4f} (limit "
        f">= 0.99), sp on frames voiced in both: median {np.median(sp_db):.3g} dB (limit 0.05), "
        f"max {sp_db.max():.3g} dB; ap rel L2 {rel_l2(fc['ap'].cpu(), fh['ap']):.3g}")
    if agree < 0.99 or np.median(sp_db) > 0.05:
        fail("world: card and CPU analyses disagree")
    small = build_standin_corpus(os.path.join(root, "world_small"), n_pairs=3)
    scfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=3", "nmf.max_iter=20",
                                  "data.use_stft=false"])
    runs = {str(d): convert_utterance(scfg, ArtifactStore(os.path.join(root, f"ws_{d.type}")),
                                      small[0], small[1], nb_file=3, device=d)
            for d in (dev, torch.device("cpu"))}
    g, c = runs[str(dev)], runs["cpu"]
    errs = {name: rel_l2(g.converted[name].cpu(), c.converted[name]) for name in ("sp", "ap")}
    say(f"world: small input (3 pairs, 20 MU iterations) card vs CPU: converted rel L2 {errs} "
        f"(limit 1e-3), n_iter {g.n_iter}/{c.n_iter}")
    if max(errs.values()) > 1e-3:
        fail("world: card and CPU conversions disagree")

    # the levers: Harvest; the magnitude-domain sp solve without the residual
    for over in (["world.f0_method=harvest"],
                 ["world.sp_domain=magnitude", "nmf.use_residual=off"]):
        c = load_config(overrides=base + over)
        syncs0 = dio.extend_from_candidates.syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = convert(f"world_{over[0]}", c=c, reference_wav=tar)
        ms = (time.perf_counter() - t0) * 1e3
        if not np.isfinite(r.audio).all() or not np.isfinite(r.mcd_vs_reference):
            fail(f"world {over}: audio or MCD not finite")
        say(f"world {over}: first run {ms:.2f} ms, n_iter sp/ap {r.solves['sp'][3]}/"
            f"{r.solves['ap'][3]}, relaxation syncs {dio.extend_from_candidates.syncs - syncs0}, "
            f"stand-in MCD {r.mcd_vs_reference:.4f} dB")

    # the WORLD Converter: convert, and convert_batch of two (one by one)
    paths = [src, os.path.join(data, "SF1", sorted(os.listdir(os.path.join(data, "SF1")))[0])]
    conv = Converter(cfg, ArtifactStore(os.path.join(root, "world0")), data, nb_file=8,
                     device=dev)
    one = conv.convert(src)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conv.convert(src)
        walls.append((time.perf_counter() - t0) * 1e3)
    batch = conv.convert_batch(paths)
    singles = [conv.convert(p) for p in paths]
    e_b = max(rel_l2(b.audio, s1.audio) for b, s1 in zip(batch, singles))
    say(f"world: Converter prepare_seconds {conv.prepare_seconds:.4f} (the cold run's store), "
        f"convert n_iter {one.nmf_iters}, warm wall {[round(w, 2) for w in walls]} ms, median "
        f"{statistics.median(walls):.4f} ms; convert_batch of 2 against single conversions: "
        f"rel L2 {e_b:.3g} (limit 1e-5)")
    if e_b > 1e-5 or not all(np.isfinite(b.audio).all() for b in batch):
        fail("world: a convert_batch item differs from its single conversion")
    return launches


def dtw_dfw_shape(torch, np, dev, spectra: list, cpu_paths) -> dict:
    """The DTW kernels at the DFW shape: each (SA, SB) of ``spectra`` as
    N pairs of 201 × 201 1-dim log-spectra, against their twins byte for
    byte; the first set's paths must equal ``cpu_paths`` (the CPU run's).
    Times and bound at the first set."""
    from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist
    from exemplars_vc_tpu_torch.align.dtw_cuda import (
        dtw_backtrace, dtw_backtrace_plain, dtw_wavefront, dtw_wavefront_plain,
        dtw_wavefront_plan)

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for k, (sa, sb) in enumerate(spectra):
        ls, lt = (torch.log(torch.clamp(torch.as_tensor(s, device=dev), min=1e-8))[..., None]
                  for s in (sa, sb))
        n, b = sa.shape
        C = pairwise_sqdist(ls, lt).contiguous()
        lens = torch.full((n, 2), b, dtype=torch.int32, device=dev)
        cost_k, dirs_k = dtw_wavefront(C, lens)
        cost_p, dirs_p = dtw_wavefront_plain(C, lens)
        paths_k = dtw_backtrace(dirs_k, lens)
        paths_p = dtw_backtrace_plain(dirs_k, lens)
        torch.cuda.synchronize()
        ties = float((C[:, 1:, 1:] == C[:, :-1, :-1]).float().mean())
        if not (torch.equal(dirs_k, dirs_p) and torch.equal(cost_k, cost_p)
                and all(torch.equal(a, c) for a, c in zip(paths_k, paths_p))):
            fail(f"dtw at the DFW shape (set {k}): kernels != twins: "
                 f"{int((dirs_k != dirs_p).sum())} codes differ")
        if k == 0:
            if not (np.array_equal(paths_k[0].cpu().numpy(), cpu_paths[0])
                    and np.array_equal(paths_k[1].cpu().numpy(), cpu_paths[1])):
                fail("dtw at the DFW shape: the kernels' paths on the CPU run's spectra differ "
                     "from the CPU run's")
            plan = dtw_wavefront_plan(n, b, n_sms)
            n_diag = 2 * b - 1
            walked = int(paths_k[2].sum())
            wf = bound(4 * n * b * b + n * n_diag * b + n * 12, 6 * n * n_diag * b)
            bt = bound(n * 8 + walked + 2 * n * n_diag * 4 + n * 4, 0)
            wms = cuda_ms(lambda: dtw_wavefront(C, lens))
            bms = cuda_ms(lambda: dtw_backtrace(dirs_k, lens))
            out = dict(wavefront=dict(ms=wms, bound_ms=wf[0], bound_by=wf[1],
                                      plain_ms=cuda_ms(lambda: dtw_wavefront_plain(C, lens),
                                                       reps=3)),
                       backtrace=dict(ms=bms, bound_ms=bt[0], bound_by=bt[1],
                                      plain_ms=cuda_ms(lambda: dtw_backtrace_plain(dirs_k, lens),
                                                       reps=3)))
            say(f"dtw at the DFW shape: N={n} Ta=Tb={b} D=1 (the CPU run's spectra; equal-cost "
                f"diagonal neighbours {ties:.4f}): both kernels byte-equal to their twins, paths "
                f"equal to the CPU run's; plan R={plan['rows_per_lane']}, {plan['warps']} warps, "
                f"cluster {plan['cluster']}, grid {plan['grid']}, {plan['threads']} threads on "
                f"{n_sms} SMs; path cells {walked}")
            for name, r in out.items():
                say(f"  {name} {r['ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
                    f"roofline share {r['bound_ms'] / r['ms']:.4f}; twin {r['plain_ms']:.4f} ms")
        else:
            say(f"dtw at the DFW shape, seeded spectra with zeroed tails (equal-cost diagonal "
                f"neighbours {ties:.4f}): both kernels byte-equal to their twins")
        del C, dirs_k, dirs_p
    torch.cuda.empty_cache()
    return out


def phase_stage02(torch, np, dev, root: str, corpus: tuple, counted: dict,
                  fused: dict) -> dict:
    """Stage 02, evaluation and the CLI on the stand-in corpus (module
    docstring, phase 8). Any failed gate exits; nothing here catches one."""
    import contextlib
    import io

    from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.pipelines import freq_warp
    from exemplars_vc_tpu_torch.pipelines.cli import main as cli

    data = corpus[0]
    all_fns = {**counted, **fused}
    dfw = freq_warp.dfw_warping
    seen = {}

    def spy(sa, sb):
        seen["spectra"] = sa.cpu().numpy(), sb.cpu().numpy()
        seen["paths"] = dfw(sa, sb)
        return seen["paths"]

    def run(device: str, store: str, *argv, data=data, nb="8") -> tuple[dict, float]:
        """One CLI command in this process: its JSON line and wall seconds."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli([argv[0], "--data", data, "--store", os.path.join(root, store), "--nb-file", nb,
                 "--tar", "TF1", "--device", device, *argv[1:]])
        for t in threading.enumerate():    # the command's store writes land (a process
            if t.name.startswith("evc-save-"):    # exit would wait for them too)
                t.join()
        torch.cuda.synchronize()
        return json.loads(buf.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0

    def dtw_launches():
        return counted["dtw_wavefront"].launches, counted["dtw_backtrace"].launches

    freq_warp.dfw_warping = spy
    try:
        for fn in all_fns.values():
            fn.launches = 0
        walls, dtw = {}, {}
        before = dtw_launches()
        md, walls["make-dict mcep"] = run("cuda", "s02", "make-dict", "--feat", "mcep")
        dtw["make-dict mcep"] = tuple(a - b for a, b in zip(dtw_launches(), before))
        for variant in ("amf", "dfw"):
            before = dtw_launches()
            out, walls[f"freq-warp {variant}"] = run("cuda", "s02", "freq-warp", "--variant",
                                                     variant)
            dtw[f"freq-warp {variant}"] = tuple(a - b for a, b in zip(dtw_launches(), before))
            if out["artifacts"] != ({"anchors": [512, 2, 22], "mean_anchors": [2, 22]}
                                    if variant == "amf"
                                    else {"curves": [512, 201], "mean_curve": [201]}):
                fail(f"freq-warp {variant}: artifacts {out['artifacts']}")
        train, walls["warp-train"] = run("cuda", "s02", "warp-train", "--runs",
                                         os.path.join(root, "s02_runs"))
        ev, walls["warp-eval"] = run("cuda", "s02", "warp-eval")
        held, walls["eval-heldout"] = run("cuda", "s02", "eval-heldout")
        loo, walls["eval-loo"] = run("cuda", "s02", "eval-loo", "--folds", "100001,100005",
                                     "--configs", "stft_quality")
        launches = {name: fn.launches for name, fn in all_fns.items()}

        say(f"stage 02: make-dict --feat mcep {json.dumps(md)}; DTW launches (wavefront, "
            f"backtrace) by command {json.dumps(dtw)}")
        say(f"stage 02: wall s by command {json.dumps({k: round(v, 4) for k, v in walls.items()})}")
        say(f"stage 02: warp-train train_seconds {train['train_seconds']:.4f}, steps_per_s "
            f"{train['steps_per_s']}, steps {train['steps_run']}, epochs {train['epochs_run']}, "
            f"best_test_loss {train['best_test_loss']:.6g} (epoch {train['best_epoch']}), "
            f"seconds_to_best {train['seconds_to_best']}; warp-eval {json.dumps(ev)}")
        say(f"stage 02: eval-heldout (stand-in MCD, dB; not comparable to the real corpus's) "
            f"{json.dumps(held)}")
        say(f"stage 02: eval-loo {json.dumps(loo)}; {walls['eval-loo'] / 2:.4f} s a fold")
        if launches["nmf_mu_fused"] or launches["gl_angles_fused"]:
            fail(f"stage 02: a fused kernel launched: {launches}")
        if (dtw["make-dict mcep"] != (1, 1) or dtw["freq-warp dfw"][0] < 1
                or min(launches[k] for k in counted) < 1):
            fail(f"stage 02: launches {launches}, DTW by command {dtw}")
        if train["epochs_run"] != 20 or not np.isfinite(train["best_test_loss"]):
            fail(f"stage 02: warp-train {train}")
        if sorted(held["scores"]) != sorted(["stft_parity", "stft_quality", "world_parity",
                                            "world_quality"]) or \
                not all(np.isfinite(v["mcd_db"]) for v in held["scores"].values()):
            fail(f"stage 02: eval-heldout {held}")
        if [f["utt"] for f in loo["folds"]] != ["100001", "100005"] or \
                not np.isfinite(loo["summary"]["stft_quality"]["mean"]):
            fail(f"stage 02: eval-loo {loo}")

        # the port's CPU run of the same commands (the plain twins)
        t0 = time.perf_counter()
        run("cpu", "s02_cpu", "make-dict", "--feat", "mcep")
        for variant in ("amf", "dfw"):
            run("cpu", "s02_cpu", "freq-warp", "--variant", variant)
        cpu_s = time.perf_counter() - t0
    finally:
        freq_warp.dfw_warping = dfw
    card, host = ArtifactStore(os.path.join(root, "s02")), ArtifactStore(os.path.join(root, "s02_cpu"))
    a, b = card.load("exemplar_dict_SF12TF1_mcep_8_torch"), host.load("exemplar_dict_SF12TF1_mcep_8_torch")
    same = all(np.array_equal(a[k], b[k]) for k in ("path_i", "path_j", "path_len"))
    e_feat = float(np.abs(a["feat_a"] - b["feat_a"]).max() / np.abs(b["feat_a"]).max())
    say(f"stage 02: MCEP dictionary card vs CPU: paths equal {same}, features rel {e_feat:.3g}")
    if not same:
        fail("stage 02: the MCEP dictionary's paths differ between the card and the CPU")
    amf_c, amf_h = card.load("freq_warp_amf_SF12TF1_8_torch"), host.load("freq_warp_amf_SF12TF1_8_torch")
    e_amf = max(float(np.abs(amf_c[k] - amf_h[k]).max()) for k in amf_c)
    dfw_c, dfw_h = card.load("freq_warp_dfw_SF12TF1_8_torch"), host.load("freq_warp_dfw_SF12TF1_8_torch")
    d = np.abs(dfw_c["curves"] - dfw_h["curves"])
    e_mean = float(np.abs(dfw_c["mean_curve"] - dfw_h["mean_curve"]).max())
    say(f"stage 02: freq-warp card vs CPU: AMF anchors max |diff| {e_amf:.3g} rad (limit 1e-4); "
        f"DFW curves differ on {int((d > 0).sum())} of {d.size} entries (limit 0.1 %), by at "
        f"most {d.max():.3g} bins (limit 1), mean curve {e_mean:.3g} (limit 0.01); CPU runs "
        f"{cpu_s:.2f} s")
    if e_amf > 1e-4 or d.max() > 1.0 or (d > 0).mean() > 1e-3 or e_mean > 1e-2:
        fail("stage 02: freq-warp card and CPU disagree")

    # a 3-epoch warp-train from the same initial parameters on both devices, on
    # 3 pairs (2 steps an epoch, as the CPU test against the JAX package): each
    # RMSprop step moves a parameter whose gradient is a rounding residue by
    # ±lr·10, so the two devices' float32 trajectories part with the steps (on
    # the 8 pairs, 18 steps: 7e-6 after the first epoch, 3.4e-2 after the third)
    small = build_standin_corpus(os.path.join(root, "s02_small"), n_pairs=3)[0]
    hist = {dv: run(dv, f"s02_train_{dv}", "warp-train", "-o", "net.nb_epoch=3", "--runs",
                    os.path.join(root, f"s02_runs_{dv}"), data=small, nb="3")[0]["history"]
            for dv in ("cuda", "cpu")}
    e_hist = max(abs(hc[k] - hh[k]) / abs(hh[k]) for hc, hh in zip(hist["cuda"], hist["cpu"])
                 for k in ("train_loss", "test_loss"))
    say(f"stage 02: warp-train 3 epochs on 3 pairs, card vs CPU: history rel {e_hist:.3g} "
        f"(limit 1e-3); test loss {[round(h['test_loss'], 3) for h in hist['cuda']]} / "
        f"{[round(h['test_loss'], 3) for h in hist['cpu']]}")
    if len(hist["cuda"]) != 3 or e_hist > 1e-3:
        fail("stage 02: warp-train card and CPU disagree")

    # eval-heldout on the CPU: the parity configs at their defaults
    t0 = time.perf_counter()
    held_cpu, _ = run("cpu", "s02_cpu", "eval-heldout", "--configs", "stft_parity,world_parity")
    diffs = {k: abs(held["scores"][k]["mcd_db"] - v["mcd_db"])
             for k, v in held_cpu["scores"].items()}
    say(f"stage 02: eval-heldout card vs CPU (stft_parity at 300 Griffin-Lim iterations, the "
        f"default): |MCD diff| {json.dumps(diffs)} dB (limit 0.05); CPU "
        f"{json.dumps(held_cpu['scores'])}, {time.perf_counter() - t0:.2f} s")
    if max(diffs.values()) > 0.05:
        fail("stage 02: eval-heldout card and CPU disagree")

    zero_tail = []
    rng = np.random.default_rng(8)
    for _ in range(2):
        s_ = np.abs(rng.standard_normal((512, 201))).astype(np.float32)
        for row, cut in zip(s_, rng.integers(100, 201, 512)):
            row[cut:] = 0.0
        zero_tail.append(s_)
    dfw_kernels = dtw_dfw_shape(torch, np, dev, [seen["spectra"], tuple(zero_tail)],
                                seen["paths"])
    return {"launches": launches, "dfw": dfw_kernels}


def _counts(fns: dict) -> dict:
    return {name: fn.launches for name, fn in fns.items()}


def _zero(fns: dict) -> None:
    for fn in fns.values():
        fn.launches = 0


def shard_kernels(torch, H, A, X) -> dict:
    """``nmf_recon`` and ``nmf_update`` at one rank's shard (H (F, K/n),
    A (K/n, D), X (F, D)) against their twins, one call each: the relative
    error and the largest absolute one of each (phase 2's gate: 1e-5)."""
    from exemplars_vc_tpu_torch.factorize.nmf_cuda import (
        nmf_recon, nmf_recon_plain, nmf_update, nmf_update_plain)

    Num = X @ A.T
    P = nmf_recon_plain(H, A)
    out = {}
    for name, got, want in (("nmf_recon", nmf_recon(H, A), P),
                            ("nmf_update", nmf_update(P, A, H, Num),
                             nmf_update_plain(P, A, H, Num))):
        out[name] = dict(shape=[H.shape[0], H.shape[1], A.shape[1]], rel=rel_err(got, want),
                         max_abs_err=float((got - want).abs().max()))
    return out


def batch_separation(torch, dev, rank: int, world: int) -> dict:
    """Phase 11 (d), in a rank of phase 9's worlds: ``separate_batch`` of
    two-second mixtures cut from the two-talker recording, four over the
    ranks (one in a world of one rank), split over the data axis; this
    rank's images against the single-mixture fit (``fit_multichannel_nmf``
    and its Wiener images) from the same inits (limit 1e-4 relative).
    Raises on a failed gate."""
    from exemplars_vc_tpu_torch.device import synchronize
    from exemplars_vc_tpu_torch.io.standin import speech_mixture
    from exemplars_vc_tpu_torch.parallel import make_mesh
    from exemplars_vc_tpu_torch.parallel.sharded_separate import batch_inits, separate_batch
    from exemplars_vc_tpu_torch.prng import PRNGKey
    from exemplars_vc_tpu_torch.separate import fit_multichannel_nmf
    from exemplars_vc_tpu_torch.separate.glue import host_stft_stack, images_istft
    from exemplars_vc_tpu_torch.separate.multichannel import _wiener_images

    def timed(fn):
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    n_mix = 4 if world > 1 else 1
    sx, _, _ = speech_mixture(seconds=2.0 * n_mix)
    mixes = sx.reshape(2, n_mix, -1).transpose(1, 0, 2)             # (M, 2, 32000)
    X = torch.stack([host_stft_stack(m, 400, 80, device="cpu") for m in mixes])
    M, F, N, C = X.shape
    inits = batch_inits(PRNGKey(0), M, 2, F, 8, N, C)
    mesh = make_mesh(data=world, dict_=1)
    kw = dict(n_sources=2, n_components=8, n_em=5)
    def batch():
        return separate_batch(X, mesh=mesh, key=PRNGKey(0), device=dev, **kw)

    def single(m):
        fit = fit_multichannel_nmf(X[m], W_init=inits[0][m], H_init=inits[1][m],
                                   R_init=inits[2][m], device=dev, **kw)
        Y = _wiener_images(X[m].to(dev), fit.W, fit.H, fit.R)
        return images_istft(Y, 400, 80, mixes.shape[-1])

    (images, nll), ms = timed(batch)            # the driven, gated call (cold)
    warm_ms = timed(batch)[1]
    images = images.to_local() if hasattr(images, "to_local") else images
    nll = nll.to_local() if hasattr(nll, "to_local") else nll
    per = M // world
    errs, single_ms = [], 0.0
    for i in range(per):
        m = rank * per + i
        want, t = timed(lambda: single(m))
        single_ms += t
        got = images_istft(images[i], 400, 80, mixes.shape[-1])
        errs.append(float((got - want).abs().max() / want.abs().max()))
    out = dict(mixtures=M, on_this_rank=per, F=F, N=N, cold_ms=ms, warm_ms=warm_ms,
               single_ms=single_ms, rel=errs,
               nll_finite=bool(torch.isfinite(nll).all()))
    if max(errs) > 1e-4 or not out["nll_finite"]:
        raise RuntimeError(f"phase 11 (d), rank {rank}: separate_batch vs the single fit "
                           f"{out} (limit 1e-4)")
    return out


def parallel_rank(rank: int, world: int, port: int, backend: str, out_dir: str, data: str,
                  wav: str) -> None:
    """One rank of phase 9 (module docstring): the sharded NMF, and with
    more than one rank the sharded conversion, the sharded batch and
    sequence-parallel DTW and data-parallel training, each against its
    single-device counterpart in this rank. With ``nccl`` rank r drives card
    r, with ``gloo`` every rank card 0. Each path's first call is the driven
    one (launches counted, outputs gated); the times that follow are the
    median of 3 fenced calls (rank 0 alone for the long DTW's sweep).
    Writes its measurements to ``out_dir/<rank>.json``; a failed gate
    raises, which ends the world."""
    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed as dist

    from exemplars_vc_tpu_torch.align import dtw_cuda
    from exemplars_vc_tpu_torch.align.dtw import dtw_batch
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.factorize import nmf_cuda
    from exemplars_vc_tpu_torch.factorize.nmf import nmf_activations
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.models.train import train_warping_net
    from exemplars_vc_tpu_torch.parallel import (
        initialize_multihost, make_mesh, sharded_dtw_batch, sharded_nmf_activations)
    from exemplars_vc_tpu_torch.parallel.sharded_long_dtw import (
        backtrace_host, cost_strip, sharded_dtw_long)
    from exemplars_vc_tpu_torch.parallel.sharded_nmf import gather_activations
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance

    def check(ok: bool, msg: str) -> None:
        if not ok:
            raise RuntimeError(f"phase 9, rank {rank}: {msg}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def median_ms(fn, together: bool = True) -> float:
        """Median wall of 3 fenced calls; ``together``: every rank calls,
        each call after a barrier."""
        times = []
        for _ in range(3):
            if together:
                dist.barrier()
            times.append(timed(fn)[1])
        return statistics.median(times)

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    info = initialize_multihost(f"127.0.0.1:{port}", world, rank, device=dev, backend=backend)
    torch.cuda.set_device(dev)
    fns = {"dtw_wavefront": dtw_cuda.dtw_wavefront, "dtw_backtrace": dtw_cuda.dtw_backtrace,
           "dtw_tile": dtw_cuda.dtw_tile, "nmf_recon": nmf_cuda.nmf_recon,
           "nmf_update": nmf_cuda.nmf_update}
    res = {"info": info, "backend": dist.get_backend(), "device": str(dev)}
    path = {k: 0 for k in fns}        # launches of the driven path in this rank

    # the sharded NMF at the kernel cell's large dictionary, against the
    # single-device solve at the same shape
    F, K, D = 688, 115_200, 201
    rng = np.random.default_rng(9)
    X = torch.as_tensor(np.abs(rng.standard_normal((F, D))).astype(np.float32), device=dev)
    A = torch.as_tensor(np.abs(rng.standard_normal((K, D))).astype(np.float32), device=dev)
    mesh = make_mesh(data=1, dict_=world)
    dist.barrier()
    _zero(fns)
    st = sharded_nmf_activations(X, A, mesh)
    d_nmf = _counts(fns)
    ms = median_ms(lambda: sharded_nmf_activations(X, A, mesh))
    H = gather_activations(st.H, mesh)
    ref = nmf_activations(X, A)
    ref_ms = median_ms(lambda: nmf_activations(X, A))
    e_h = float((H - ref.H).abs().max() / ref.H.abs().max())
    e_err = abs(float(st.error) - float(ref.error)) / float(ref.error)
    res["nmf"] = dict(F=F, K=K, D=D, n_iter=st.n_iter, ref_n_iter=ref.n_iter, h_rel=e_h,
                      err_rel=e_err, ms=ms, ref_ms=ref_ms, launches=d_nmf)
    check(st.n_iter == ref.n_iter, f"sharded NMF n_iter {st.n_iter} != {ref.n_iter}")
    check(e_h <= 2e-3 and e_err <= 1e-3, f"sharded NMF H rel {e_h:.3g}, error rel {e_err:.3g}")
    check(d_nmf["nmf_recon"] == 1 + st.n_iter and d_nmf["nmf_update"] == st.n_iter,
          f"sharded NMF launches {d_nmf} for n_iter {st.n_iter}")
    for k in path:
        path[k] += d_nmf[k]
    res["shard_kernels"] = []

    def shard_case(H, A, X):
        """The kernels at this rank's shard of a solve, against their twins."""
        case = shard_kernels(torch, H, A, X)
        res["shard_kernels"].append(case)
        for name, r in case.items():
            check(r["rel"] <= 1e-5, f"{name} at the shard {r['shape']}: rel err {r['rel']:.3g} "
                                    f"against its twin (limit 1e-5)")

    kl = K // world
    shard_case(st.H, A[rank * kl:(rank + 1) * kl], X)
    del H, ref, st

    res["separate_batch"] = batch_separation(torch, dev, rank, world)
    if world == 1:
        res["path_launches"] = path
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
        return

    # the mu_sharded conversion against mu, on the stand-in corpus
    cfg = load_config(overrides=["data.tar=TF1"])
    cfg_sh = load_config(overrides=["data.tar=TF1", "nmf.solver=mu_sharded"])
    root = os.path.join(out_dir, f"stores_{rank}")
    convert_utterance(cfg_sh, ArtifactStore(os.path.join(root, "warm")), data, wav, nb_file=8,
                      device=dev)
    _zero(fns)
    sh, sh_ms = timed(lambda: convert_utterance(cfg_sh, ArtifactStore(os.path.join(root, "sh")),
                                                data, wav, nb_file=8, sync_stages=True,
                                                device=dev))
    d_conv = _counts(fns)
    mu, mu_ms = timed(lambda: convert_utterance(cfg, ArtifactStore(os.path.join(root, "mu")),
                                                data, wav, nb_file=8, sync_stages=True,
                                                device=dev))
    Y, Ymu = sh.converted["stft"].double(), mu.converted["stft"].double()
    dY = float((Y - Ymu).abs().max() / Ymu.abs().max())
    parts = [torch.empty_like(sh.converted["stft"]) for _ in range(world)]
    dist.all_gather(parts, sh.converted["stft"])
    audio = torch.as_tensor(sh.audio, device=dev)
    audios = [torch.empty_like(audio) for _ in range(world)]
    dist.all_gather(audios, audio)
    same = all(torch.equal(p, parts[0]) for p in parts) and all(
        torch.equal(a, audios[0]) for a in audios)
    res["convert"] = dict(dY=dY, n_iter=sh.n_iter, mu_n_iter=mu.n_iter, K=sh.nmf_shape[1],
                          ms=sh_ms, mu_ms=mu_ms, solve_ms=1e3 * sh.timings["nmf_solve"],
                          mu_solve_ms=1e3 * mu.timings["nmf_solve"], ranks_equal=same,
                          launches=d_conv,
                          finite=bool(np.isfinite(sh.audio).all()))
    check(dY <= 2e-3 and same and res["convert"]["finite"],
          f"mu_sharded conversion dY {dY:.3g}, ranks equal {same}")
    for k in path:
        path[k] += d_conv[k]
    # the kernels at this rank's shard of the conversion's solve (F, K/n, D)
    Fc, Kc, Dc = sh.nmf_shape
    g = np.random.default_rng(13)
    shard_case(torch.as_tensor(g.uniform(0.0, 0.02, (Fc, Kc // world)).astype(np.float32),
                               device=dev),
               torch.as_tensor(np.abs(g.standard_normal((Kc // world, Dc))).astype(np.float32),
                               device=dev),
               torch.as_tensor(np.abs(g.standard_normal((Fc, Dc))).astype(np.float32),
                               device=dev))

    # the main path's DTW batch, 8 pairs padded to 1408 frames, split over
    # the ranks, against dtw_batch
    rng = np.random.default_rng(10)
    fa = rng.standard_normal((8, 1408, 20)).astype(np.float32)
    fb = rng.standard_normal((8, 1408, 20)).astype(np.float32)
    la = rng.integers(1200, 1409, 8).astype(np.int32)
    lb = rng.integers(1200, 1409, 8).astype(np.int32)
    dmesh = make_mesh(data=world, dict_=1)
    dist.barrier()
    _zero(fns)
    rb = sharded_dtw_batch(fa, fb, la, lb, dmesh, device=dev)
    d_batch = _counts(fns)
    rb_ms = median_ms(lambda: sharded_dtw_batch(fa, fb, la, lb, dmesh, device=dev))
    fa_d, fb_d = torch.as_tensor(fa, device=dev), torch.as_tensor(fb, device=dev)
    one = dtw_batch(fa_d, fb_d, la, lb)
    one_ms = median_ms(lambda: dtw_batch(fa_d, fb_d, la, lb))
    eq = all(torch.equal(a, b) for a, b in zip(rb, one))
    res["dtw_batch"] = dict(equal=eq, ms=rb_ms, single_ms=one_ms, launches=d_batch)
    check(eq, "sharded_dtw_batch differs from dtw_batch")
    for k in path:
        path[k] += d_batch[k]

    # one long pair, rows split over the ranks, in 512-column tiles; the
    # single-device wavefront on the same C (the ranks' strips) on rank 0
    ta, tb, cb = 32_768, 2000, 512
    rng = np.random.default_rng(11)
    a = rng.standard_normal((ta, 20)).astype(np.float32)
    b = rng.standard_normal((tb, 20)).astype(np.float32)
    dist.barrier()
    _zero(fns)
    dist_l, codes = sharded_dtw_long(a, b, dmesh, col_block=cb, device=dev)
    d_long = _counts(fns)
    long_ms = median_ms(lambda: sharded_dtw_long(a, b, dmesh, col_block=cb, device=dev))
    dist_d, none = sharded_dtw_long(a, b, dmesh, col_block=cb, keep_dirs=False, device=dev)
    only_ms = median_ms(lambda: sharded_dtw_long(a, b, dmesh, col_block=cb, keep_dirs=False,
                                                 device=dev))
    res["dtw_long"] = dict(ta=ta, tb=tb, col_block=cb, ms=long_ms, distance_only_ms=only_ms,
                           distance=dist_l, launches=d_long)
    check(dist_d == dist_l and none is None, f"distance-only {dist_d} != path mode {dist_l}")
    for k in path:
        path[k] += d_long[k]
    if rank == 0:
        R = ta // world
        bp = torch.zeros((-(-tb // cb) * cb, 20), device=dev)
        bp[:tb] = torch.as_tensor(b, device=dev)
        C = torch.cat([cost_strip(torch.as_tensor(a[q * R:(q + 1) * R], device=dev), bp, tb)
                       for q in range(world)])[:, :tb].contiguous()[None]
        lens = torch.tensor([[ta, tb]], dtype=torch.int32, device=dev)
        cost, dirs = dtw_cuda.dtw_wavefront(C, lens)
        one_ms = median_ms(lambda: dtw_cuda.dtw_wavefront(C, lens), together=False)
        sweep = dtw_cuda.tile_codes(dirs[0], ta, tb)
        same_codes = torch.equal(sweep, codes)
        pi, pj, plen = dtw_cuda.dtw_backtrace(dirs, lens)
        n = int(plen[0])
        hi, hj = backtrace_host(codes)
        same_path = (np.array_equal(hi, pi[0, :n].cpu().numpy())
                     and np.array_equal(hj, pj[0, :n].cpu().numpy()))
        res["dtw_long"].update(single_ms=one_ms, codes_equal=same_codes,
                               distance_equal=float(cost[0]) == dist_l, path_equal=same_path,
                               path_cells=n)
        check(same_codes and float(cost[0]) == dist_l and same_path,
              f"sequence-parallel DTW vs one sweep: codes {same_codes}, distance {dist_l} vs "
              f"{float(cost[0])}, path {same_path}")
        del C, dirs, sweep
    del codes
    torch.cuda.empty_cache()

    # data-parallel warp-train: 5 epochs on the 8 pairs, one utterance a
    # rank a step
    tcfg = load_config(overrides=["data.tar=TF1", "net.nb_epoch=5",
                                  f"net.batch_size={world}"])
    # a 1-epoch warm run first: the ranks are fresh processes, and the step
    # rate is compared with a warm single-card run (:func:`single_train`)
    train_warping_net(replace(tcfg, net=replace(tcfg.net, nb_epoch=1)),
                      ArtifactStore(os.path.join(root, "train_warm")), data, nb_file=8,
                      data_parallel=True, device=dev, run_root=os.path.join(root, "runs_w"))
    store = ArtifactStore(os.path.join(root, "train"))
    _zero(fns)
    m = train_warping_net(tcfg, store, data, nb_file=8, data_parallel=True, device=dev,
                          run_root=os.path.join(root, "runs"))
    d_train = _counts(fns)
    leaves = store.load(m["checkpoint"])    # the same store: its load waits for its writes
    flat = torch.cat([torch.as_tensor(leaves[k], device=dev).reshape(-1)
                      for k in sorted(leaves)])
    flats = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(flats, flat)
    losses = [h["train_loss"] for h in m["history"]]
    res["train"] = dict(steps_per_s=m["steps_per_s"], steps=m["steps_run"],
                        train_seconds=m["train_seconds"], losses=losses,
                        minibatch=m["minibatch_utterances"],
                        params_equal=all(torch.equal(f, flats[0]) for f in flats),
                        launches=d_train)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] and res["train"]["params_equal"],
          f"data-parallel warp-train: losses {losses}, params equal "
          f"{res['train']['params_equal']}")
    for k in path:
        path[k] += d_train[k]
    res["path_launches"] = path
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_parallel(torch, np, dev, root: str, corpus: tuple) -> dict:
    """Phase 9 (module docstring): the tile mode against its twin and timed
    on the card, then a world of two gloo ranks sharing the card and one of
    a single nccl rank, each rank a process (:func:`parallel_rank`).
    Returns rank 0's measurements and the kernels' entries."""
    from exemplars_vc_tpu_torch.align import dtw_cuda
    from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist

    # the tile mode against its twin: every halo set, a ragged window, one
    # row a lane (1000 rows) and eight (4100 rows); then timed and held
    # against the twin at the long DTW's tile, 16,384 rows x 512 columns of
    # a 2048-column strip
    rng = np.random.default_rng(12)
    err = 0.0
    for rows, cols, ld in ((1000, 300, 517), (4100, 512, 2048)):
        C = torch.as_tensor(rng.random((rows, ld)).astype(np.float32) * 4, device=dev)[:, 17:17 + cols]
        top = torch.full((cols + 4,), dtw_cuda.BIG, device=dev)
        top[:cols] = torch.as_tensor(rng.random(cols).astype(np.float32) * 50, device=dev)
        corner = torch.tensor([3.0], device=dev)
        left = torch.as_tensor(rng.random(rows).astype(np.float32) * 50, device=dev)
        for codes in (True, False):
            got = dtw_cuda.dtw_tile(C, top, corner, left, codes=codes)
            want = dtw_cuda.dtw_tile_plain(C, top, corner, left, codes=codes)
            for g, w in zip(got[:2], want[:2]):
                err = max(err, float((g - w).abs().max()))
                if not torch.equal(g, w):
                    fail(f"tile mode {rows} x {cols} (codes {codes}): halo outputs differ "
                         f"from the twin")
            if codes and not torch.equal(got[2], want[2]):
                fail(f"tile mode {rows} x {cols}: codes differ from the twin at "
                     f"{int((got[2] != want[2]).sum())} cells")
    R, cb, tb = 16_384, 512, 2000
    fa = torch.as_tensor(rng.standard_normal((R, 20)).astype(np.float32), device=dev)
    fb = torch.as_tensor(rng.standard_normal((2048, 20)).astype(np.float32), device=dev)
    strip = pairwise_sqdist(fa, fb).contiguous()
    C = strip[:, 512:1024]
    top = torch.full((cb + 4,), dtw_cuda.BIG, device=dev)
    top[:cb] = 1e3
    left = torch.full((R,), 1e3, device=dev)
    corner = torch.tensor([1e3], device=dev)
    tile_ms = cuda_ms(lambda: dtw_cuda.dtw_tile(C, top, corner, left), reps=5)
    tile_nc_ms = cuda_ms(lambda: dtw_cuda.dtw_tile(C, top, corner, left, codes=False), reps=5)
    # the twin once at this tile (~15 s), timed and held against both variants
    t0 = time.perf_counter()
    want = dtw_cuda.dtw_tile_plain(C, top, corner, left)
    torch.cuda.synchronize()
    tile_plain_ms = (time.perf_counter() - t0) * 1e3
    for codes in (True, False):
        got = dtw_cuda.dtw_tile(C, top, corner, left, codes=codes)
        for part, g, w in zip(("bottom row", "right column"), got[:2], want[:2]):
            err = max(err, float((g - w).abs().max()))
            if not torch.equal(g, w):
                fail(f"tile mode {R} x {cb} (codes {codes}): {part} differs from the twin")
        if codes and not torch.equal(got[2], want[2]):
            fail(f"tile mode {R} x {cb}: codes differ from the twin at "
                 f"{int((got[2] != want[2]).sum())} cells")
    del got, want
    # bytes: the tile's costs and halos read once, its codes, bottom row and
    # right column written once; operations: ~6 a cell (3 compares, 2 mins,
    # an add), far under the bytes' time
    cells = R * cb
    tile_bound, tile_by = bound(4 * (cells + 2 * cb + 2 * R) + cells, 6 * cells)
    say(f"parallel: tile mode equal to its twin at 1000 x 300, 4100 x 512 and the long DTW's "
        f"{R} x {cb} tile of a 2048-column strip (codes, bottom row, right column; max |err| "
        f"{err}); at that tile {tile_ms:.4f} ms with codes, {tile_nc_ms:.4f} ms without, the twin "
        f"{tile_plain_ms:.1f} ms, bound {tile_bound:.4f} ms ({tile_by}), "
        f"{100 * tile_bound / tile_ms:.2f} % of it")
    del strip, C, fa, fb
    torch.cuda.empty_cache()

    single = single_train(dev, root, corpus[0], 2)
    worlds = {(world, backend): run_world(world, backend, root, corpus)
              for world, backend in ((2, "gloo"), (1, "nccl"))}
    ranks = worlds[(2, "gloo")]
    launches = ranks[0]["path_launches"]
    if min(launches.values()) < 1:
        fail(f"phase 9: a kernel of the path was not launched: {launches}")
    if single["steps_per_s"] <= 0:
        fail("phase 9: single-device warp-train took no step")
    shard_err = {name: max(case[name]["max_abs_err"] for ws in worlds.values() for r in ws
                           for case in r["shard_kernels"])
                 for name in ("nmf_recon", "nmf_update")}
    return dict(launches=launches, tile_ms=tile_ms, tile_nocodes_ms=tile_nc_ms,
                tile_plain_ms=tile_plain_ms, tile_bound_ms=tile_bound, tile_max_abs_err=err,
                shard_max_abs_err=shard_err, single_train=single, ranks=ranks,
                nccl=worlds[(1, "nccl")][0])


SEP_KW = dict(n_sources=2, n_components=8, n_em=20, n_fft=400, hop_length=80)
SEP_CONFIGS = (("nmf", "random"), ("nmf", "demix"), ("hmm", "random"), ("shmm", "random"))
# Phase 10's limit on the card's source-image energies against the CPU run
# after 20 EM, relative. The HMM EMs turn roundoff into state flips, which
# move the energies: with the input times (1 + 2e-7·noise) the port's own
# fits move them by up to 1.46e-2 (hmm) and 1.51e-2 (shmm) on the card and
# on the CPU, and the card is 8.2e-3 and 3.3e-3 from the CPU run, where a
# start from the next key lands 0.096 (hmm) and 0.099 (shmm) away or more
# (tools/separation_spread.py, keys 0-3, 8 noise seeds; NVIDIA H100 80GB
# HBM3, 700 W). The limit is twice the spread, a third of the control.
SEP_ENERGY_RTOL = {"nmf": 3e-3, "hmm": 3e-2, "shmm": 3e-2}


def _sdr_db(ref, est) -> float:
    import numpy as np

    ref, est = ref.astype(np.float64), est.astype(np.float64)
    return float(10 * np.log10((ref ** 2).sum() / max(((est - ref) ** 2).sum(), 1e-30)))


def _separate(torch, x, dev, seed: int = 0, **kw):
    """``separate_signal`` on ``dev`` from ``PRNGKey(seed)``; returns
    (images, model, wall seconds ending in a sync)."""
    from exemplars_vc_tpu_torch.device import synchronize
    from exemplars_vc_tpu_torch.prng import PRNGKey
    from exemplars_vc_tpu_torch.separate import separate_signal

    dev = torch.device(dev)
    synchronize(dev)
    t0 = time.perf_counter()
    images, model = separate_signal(x, key=PRNGKey(seed), device=dev, **kw)
    synchronize(dev)
    return images, model, time.perf_counter() - t0


def _hmm_states(model):
    return model.H.argmax(dim=1).cpu().numpy()       # (J, N) state paths


def phase_separate(torch, np, dev, root: str, counted: dict, fused: dict) -> dict:
    """``separate`` on the card (module docstring, phase 10)."""
    from exemplars_vc_tpu_torch.align.viterbi import viterbi_paths
    from exemplars_vc_tpu_torch.io.standin import speech_mixture, synthetic_mixture
    from exemplars_vc_tpu_torch.io.wav import write_wav
    from exemplars_vc_tpu_torch.pipelines.cli import main as cli_main
    from exemplars_vc_tpu_torch.separate import demix

    everything = {**counted, **fused}
    _zero(everything)
    out = {"mixture_2s": {}, "launches": {}}
    x, lead_img, acc_img = synthetic_mixture(return_components=True)
    truth = (lead_img, acc_img)

    # (a) the fixed 2 s mixture, four configurations, card against the CPU run
    est = {str(d): demix(x, n_sources=2, n_fft=400, hop_length=80, device=d)
           for d in (dev, "cpu")}
    g, c = est[str(dev)], est["cpu"]
    d_theta = float(np.abs(g.theta - c.theta).max())
    say(f"separate: DEMIX on the card θ {g.theta.tolist()}, delays {g.delay.tolist()}; "
        f"CPU θ {c.theta.tolist()}, delays {c.delay.tolist()}; max |Δθ| {d_theta:.3g} rad "
        f"(limit 1e-4); histogram max rel diff "
        f"{float(np.abs(g.hist - c.hist).max() / np.abs(c.hist).max()):.3g}")
    if d_theta > 1e-4 or not np.array_equal(g.delay, c.delay):
        fail("phase 10: DEMIX angles or delays differ between the card and the CPU")
    for spectral, spatial in SEP_CONFIGS:
        name = f"{spectral}/{spatial}"
        kw = dict(SEP_KW, spectral_model=spectral, spatial_init=spatial)
        img, model, cold = _separate(torch, x, dev, **kw)
        img, model, warm = _separate(torch, x, dev, **kw)
        img_c, model_c, cpu_s = _separate(torch, x, "cpu", **kw)
        y, yc = img.cpu().numpy(), img_c.numpy()
        nll, nll_c = model.neg_log_like.cpu().numpy(), model_c.neg_log_like.numpy()
        if not (np.isfinite(y).all() and np.isfinite(nll).all()):
            fail(f"phase 10 {name}: non-finite images or NLL")
        if nll[-1] > nll[0]:
            fail(f"phase 10 {name}: the NLL rose, {nll[0]} -> {nll[-1]}")
        e, e_c = (y.astype(np.float64) ** 2).sum(axis=(1, 2)), \
            (yc.astype(np.float64) ** 2).sum(axis=(1, 2))
        d_energy = float((np.abs(e - e_c) / e_c).max())
        d_nll = float(abs(nll[-1] - nll_c[-1]) / abs(nll_c[-1]))
        res = {"cold_s": cold, "warm_s": warm, "cpu_s": cpu_s, "nll_first": float(nll[0]),
               "nll_last": float(nll[-1]), "nll_last_cpu": float(nll_c[-1]),
               "nll_last_rel": d_nll, "energy_rel": d_energy,
               "images_rel_l2": float(np.linalg.norm(y - yc) / np.linalg.norm(yc)),
               "sdr_db": [max(_sdr_db(r, y[j]) for r in truth) for j in range(2)],
               "residual": float(np.linalg.norm(x - y.sum(axis=0)) / np.linalg.norm(x))}
        if spectral != "nmf":
            # the HMM EM amplifies roundoff as the NMF EM does, but into
            # state flips: from the same inits the JAX package and the port's
            # CPU run keep equal paths for 10 iterations on this mixture and
            # after 20 part on up to 5.9 % of the frames (hmm; shmm 0.75 %)
            # with the NLL 3.4e-5 apart (tests/test_torch_separate_ext.py::
            # test_hmm_fit_on_the_benchmark_mixture_parts_from_jax_in_paths_only).
            # So the paths are gated after 5 iterations and reported after
            # 20, from PRNGKey(0..3) as that test's four seeds
            res["paths_equal"] = float((_hmm_states(model) == _hmm_states(model_c)).mean())
            res["paths_equal_seeds"] = [res["paths_equal"]] + [
                float((_hmm_states(_separate(torch, x, dev, seed=k, **kw)[1])
                       == _hmm_states(_separate(torch, x, "cpu", seed=k, **kw)[1])).mean())
                for k in (1, 2, 3)]
            kw5 = dict(kw, n_em=5)
            r5 = [_separate(torch, x, d, **kw5)[1] for d in (dev, "cpu")]
            res["paths_equal_5"] = float((_hmm_states(r5[0]) == _hmm_states(r5[1])).mean())
        say(f"separate 2 s {name}: {json.dumps(res)}")
        if d_energy > SEP_ENERGY_RTOL[spectral]:
            fail(f"phase 10 {name}: image energies {d_energy:.3g} apart from the CPU run "
                 f"(limit {SEP_ENERGY_RTOL[spectral]:g})")
        if d_nll > 1e-4:
            fail(f"phase 10 {name}: nll_last {d_nll:.3g} relative from the CPU run (limit 1e-4)")
        if res.get("paths_equal_5", 1.0) < 0.99:
            fail(f"phase 10 {name}: HMM paths after 5 EM iterations equal on "
                 f"{res['paths_equal_5']:.4f} of frames (limit 0.99)")
        out["mixture_2s"][name] = res

    # ties in the Viterbi sweep go to the first index on the card as on the CPU
    rng = np.random.default_rng(0)
    ld = rng.integers(-6, 6, (2, 8, 401)).astype(np.float32)
    lp = rng.integers(-6, 6, (2, 8)).astype(np.float32)
    lt = rng.integers(-6, 6, (2, 8, 8)).astype(np.float32)
    paths = [viterbi_paths(*(torch.as_tensor(a, device=d) for a in (ld, lp, lt))).cpu()
             for d in (dev, "cpu")]
    if not torch.equal(*paths):
        fail("phase 10: the Viterbi sweep on tying integer densities differs card vs CPU")
    say("separate: Viterbi sweep on tying integer densities (2 × 8 × 401) equal card vs CPU")

    # (b) a 60 s two-talker recording at the CLI's defaults
    xs, _, sr = speech_mixture(seconds=60.0)
    seconds = xs.shape[1] / sr
    kw = dict(n_sources=2, n_components=8, n_em=50, n_fft=400, hop_length=80)
    _, model, cold = _separate(torch, xs, dev, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    img, model, warm = _separate(torch, xs, dev, **kw)
    peak = torch.cuda.max_memory_allocated(dev)
    nll = model.neg_log_like.cpu().numpy()
    if not (torch.isfinite(img).all() and np.isfinite(nll).all()) or nll[-1] > nll[0]:
        fail(f"phase 10: the 60 s separation is non-finite or its NLL rose "
             f"({nll[0]} -> {nll[-1]})")
    dev_ms, per = device_profile(lambda: _separate(torch, xs, dev, **kw))
    N = model.H.shape[-1]
    long = {"seconds": seconds, "frames": N, "cold_s": cold, "warm_s": warm,
            "audio_s_per_s": seconds / warm, "device_ms": dev_ms,
            "device_launches": sum(n for n, _ in per.values()),
            "max_memory_allocated_gb": peak / 1e9, "nll_first": float(nll[0]),
            "nll_last": float(nll[-1]),
            "top_device": sorted(((round(ms, 3), n, k[:60]) for k, (n, ms) in per.items()),
                                 reverse=True)[:6]}
    say(f"separate 60 s nmf, 8 components, 50 EM: {json.dumps(long)}")
    kw_h = dict(kw, n_em=2, spectral_model="hmm")
    _separate(torch, xs, dev, **kw_h)
    _, model, hmm_wall = _separate(torch, xs, dev, **kw_h)
    hmm_ms, hmm_per = device_profile(lambda: _separate(torch, xs, dev, **kw_h))
    S = 8
    ld = torch.randn((2, S, N), generator=torch.Generator().manual_seed(0)).to(dev)
    lp = torch.full((2, S), -math.log(S), device=dev)
    lt = torch.log(torch.full((2, S, S), 1.0 / S, device=dev))
    vit_ms = wall_ms(lambda: viterbi_paths(ld, lp, lt))
    vit_dev, vit_per = device_profile(lambda: viterbi_paths(ld, lp, lt))
    vit_launches = sum(n for n, _ in vit_per.values())
    hmm = {"n_em": 2, "warm_s": hmm_wall, "device_ms": hmm_ms,
           "device_launches": sum(n for n, _ in hmm_per.values()),
           "viterbi_wall_ms": vit_ms, "viterbi_device_ms": vit_dev,
           "viterbi_launches": vit_launches, "viterbi_ms_a_frame": vit_ms / N,
           "viterbi_launches_a_frame": vit_launches / N,
           "nll": model.neg_log_like.cpu().numpy().tolist()}
    say(f"separate 60 s hmm, 8 states, 2 EM (Viterbi sweep of 2 × 8 states × {N} frames "
        f"alone: wall and device): {json.dumps(hmm)}")
    out.update(speech_60s=long, hmm_60s=hmm)

    # (c) the CLI in-process on the card
    wav = os.path.join(root, "p10_mixture.wav")
    write_wav(wav, x, 16000)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(["separate", "--wav", wav, "--out-dir", os.path.join(root, "p10_sep"),
                  "--components", "8", "--em-iters", "20", "--device", "cuda"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    if set(res) != {"out", "sr", "nll_first", "nll_last"} or not all(
            os.path.isfile(p) for p in res["out"]) or len(res["out"]) != 2:
        fail(f"phase 10: the CLI's separate printed {res}")
    say(f"separate CLI on the card: {json.dumps(res)}")
    out["cli"] = res
    out["launches"] = _counts(everything)
    say(f"separate: hand-written kernel launches on the path {json.dumps(out['launches'])}")
    return out


LEAD_KW = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0, f0_max=800.0)
# the JAX package's operating point of the stereo SIMM on the 2 s mixture
# (BENCHMARKS.md, TestOperatingPoint: lead energy share 0.6757 from PRNGKey(1))
STEREO_SHARE_JAX = 0.6757


def _fenced(torch, dev, fn):
    """(fn(), wall seconds ending in a sync of ``dev``)."""
    from exemplars_vc_tpu_torch.device import synchronize

    dev = torch.device(dev)
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def _lead_point(np, res, lead_img) -> dict:
    """Lead energy share, voiced frames, median voiced f0 and lead SDR of a
    lead-separation result (``lead_img``: the true lead image, or None)."""
    lead = res.lead.cpu().numpy().astype(np.float64)
    acc = res.accomp.cpu().numpy().astype(np.float64)
    f0 = res.f0[res.f0 > 0]
    out = {"share": float((lead ** 2).sum() / ((lead ** 2).sum() + (acc ** 2).sum())),
           "voiced_frames": int(len(f0)),
           "f0_median": float(np.median(f0)) if len(f0) else 0.0,
           "finite": bool(np.isfinite(lead).all() and np.isfinite(acc).all())}
    if lead_img is not None:
        ref = lead_img if lead.shape[0] == lead_img.shape[0] else lead_img.mean(axis=0)[None]
        out["sdr_db"] = _sdr_db(ref, lead)
    return out


def _transform_checks(torch, np, dev, xs) -> dict:
    """Phase 11 (b): ``cqt``, ``minqt`` and ``nsgt`` of the 60 s recording
    on the card against the port's CPU run, the round trips, walls and
    device time."""
    from exemplars_vc_tpu_torch.dsp import cqt, iminqt, insgt, minqt, nsgt

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    T = xs.shape[1]
    out = {}
    for name, fn in (("cqt", lambda d: cqt(xs, device=d)),
                     ("minqt", lambda d: minqt(xs, device=d)),
                     ("nsgt", lambda d: nsgt(xs, device=d))):
        cold_c, cold = _fenced(torch, dev, lambda: fn(dev))
        _, warm = _fenced(torch, dev, lambda: fn(dev))
        ref, cpu_s = _fenced(torch, "cpu", lambda: fn("cpu"))
        err = rel_l2(cold_c.cpu().numpy(), ref.numpy())
        dev_ms, per = device_profile(lambda: fn(dev))
        out[name] = {"shape": list(cold_c.shape), "cold_s": cold, "warm_s": warm,
                     "cpu_s": cpu_s, "rel_l2_vs_cpu": err,
                     "max_abs_diff_vs_cpu": float((cold_c.cpu() - ref).abs().max()),
                     "device_ms": dev_ms,
                     "device_launches": sum(n for n, _ in per.values()),
                     "top_device": sorted(((round(ms, 3), n, k[:60])
                                           for k, (n, ms) in per.items()), reverse=True)[:3]}
        if not torch.isfinite(cold_c).all() or err > 1e-4:
            fail(f"phase 11 (b): {name} on the card is {err:.3g} relative L2 from the CPU run "
                 "(limit 1e-4) or not finite")
        del cold_c, ref
    # round trips within the JAX tests' bounds: the NSGT on the recording
    # (tests/test_nsgt.py: 5e-4 of the peak), the MinQT's least-squares
    # inverse on an in-band sum of sines of the recording's length
    # (tests/test_minqt.py: > 40 dB on the interior), each timed; the
    # recording's own MinQT round trip is reported
    c = nsgt(xs, device=dev)
    (back, nsgt_inv_s) = _fenced(torch, dev, lambda: insgt(c, T, device=dev))
    err = float((back.cpu() - torch.as_tensor(xs)).abs().max() / np.abs(xs).max())
    out["nsgt"].update(insgt_s=nsgt_inv_s, roundtrip_max_err_over_peak=err)
    if err > 5e-4:
        fail(f"phase 11 (b): insgt(nsgt(x)) is {err:.3g} of the peak from x (limit 5e-4)")
    rng = np.random.default_rng(2)
    t = np.arange(T) / 16000
    sines = sum(rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
                for f in (90.0, 220.0, 700.0, 1500.0, 3300.0, 6100.0)).astype(np.float32)

    def snr_db(x, y):
        lo, hi = 1024, len(x) - 1024
        e = x[lo:hi] - y[lo:hi]
        return float(10 * np.log10((x[lo:hi] ** 2).sum() / max((e ** 2).sum(), 1e-20)))

    y, inv_s = _fenced(torch, dev, lambda: iminqt(minqt(sines, device=dev), T, device=dev))
    snr = snr_db(sines, y.cpu().numpy())
    speech = iminqt(minqt(xs[0], device=dev), T, device=dev).cpu().numpy()
    out["minqt"].update(iminqt_s=inv_s, roundtrip_snr_db_in_band=snr,
                        roundtrip_snr_db_speech=snr_db(xs[0], speech))
    if snr <= 40.0:
        fail(f"phase 11 (b): iminqt(minqt(x)) of an in-band signal at {snr:.1f} dB (limit 40)")
    return out


def phase_lead(torch, np, dev, root: str, counted: dict, fused: dict) -> dict:
    """Lead separation, the transforms and the CLI's ``separate-lead`` on
    the card (module docstring, phase 11)."""
    from exemplars_vc_tpu_torch.io.standin import (
        jax_simm_draws, speech_mixture, synthetic_mixture)
    from exemplars_vc_tpu_torch.io.wav import write_wav
    from exemplars_vc_tpu_torch.pipelines.cli import main as cli_main
    from exemplars_vc_tpu_torch.prng import PRNGKey, split
    from exemplars_vc_tpu_torch.separate import (
        separate_lead, separate_lead_multichannel, separate_lead_stereo)
    from exemplars_vc_tpu_torch.separate.stereo_simm import simm_draws

    everything = {**counted, **fused}
    _zero(everything)
    x, lead_img, _ = synthetic_mixture(return_components=True)
    out = {"mixture_2s": {}}

    # (a) the 2 s mixture from the port's own PRNGKey(1), whose stereo rounds
    # draw what the JAX package draws (its operating point depends on the
    # start: tools/simm_seed_sweep.py)
    draws_ulp = 0
    for k, want in zip(split(PRNGKey(1)), jax_simm_draws()):
        got = simm_draws(k, 513, 126, 145, 20, 4, 20)
        for name, w in want.items():
            a = got[name].numpy()
            d = np.abs(a.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
            if a.shape != w.shape or (name == "beta_init" and d.max() > 0) or d.max() > 4:
                fail(f"phase 11: the port's PRNGKey(1) draws {name} {a.shape} up to "
                     f"{int(d.max())} ulp from the JAX package's {w.shape} (limit 4; βR 0)")
            draws_ulp = max(draws_ulp, int(d.max()))
    say(f"separate-lead: PRNGKey(1)'s stereo SIMM draws equal the JAX package's within "
        f"{draws_ulp} ulp")
    runs = {"mono": lambda d: separate_lead(
                x.mean(axis=0), n_iter=15, n_accomp=20, device=d, key=PRNGKey(1), **LEAD_KW),
            "stereo": lambda d: separate_lead_stereo(
                x, n_iter=15, n_accomp=20, key=PRNGKey(1), device=d, **LEAD_KW),
            "multichannel": lambda d: separate_lead_multichannel(
                x, n_iter_simm=10, n_em=10, n_accomp=20, key=PRNGKey(1), device=d,
                **LEAD_KW)}
    for name, fn in runs.items():
        _, cold = _fenced(torch, dev, lambda: fn(dev))
        res, warm = _fenced(torch, dev, lambda: fn(dev))
        res_c, cpu_s = _fenced(torch, "cpu", lambda: fn("cpu"))
        p, pc = _lead_point(np, res, lead_img), _lead_point(np, res_c, lead_img)
        lead_rel = float(np.linalg.norm(res.lead.cpu().numpy() - res_c.lead.numpy())
                         / np.linalg.norm(res_c.lead.numpy()))
        r = {"cold_s": cold, "warm_s": warm, "cpu_s": cpu_s, "card": p, "cpu": pc,
             "melody_equal": float(np.mean(res.f0 == res_c.f0)), "lead_rel_l2_vs_cpu": lead_rel}
        say(f"separate-lead 2 s {name}: {json.dumps(r)}")
        if not (p["finite"] and pc["finite"]):
            fail(f"phase 11 {name}: non-finite lead or accompaniment")
        if abs(p["f0_median"] - 220.0) > 10.0:
            fail(f"phase 11 {name}: median voiced f0 {p['f0_median']:.1f} Hz (limit 220 ± 10)")
        if name == "stereo":
            if abs(p["share"] - pc["share"]) > 0.01 or abs(p["share"] - STEREO_SHARE_JAX) > 0.05:
                fail(f"phase 11 stereo: lead share {p['share']:.4f} (CPU {pc['share']:.4f}, "
                     f"limit 0.01; JAX {STEREO_SHARE_JAX}, limit 0.05)")
            if p["sdr_db"] <= 3.0:
                fail(f"phase 11 stereo: lead SDR {p['sdr_db']:.2f} dB (limit > 3)")
        if name == "multichannel" and abs(p["share"] - pc["share"]) > 0.05:
            fail(f"phase 11 multichannel: lead share {p['share']:.4f} vs the CPU run's "
                 f"{pc['share']:.4f} (limit 0.05)")
        out["mixture_2s"][name] = r

    # (b) the transforms on the 60 s recording
    xs, _, sr = speech_mixture(seconds=60.0)
    seconds = xs.shape[1] / sr
    out["transforms_60s"] = _transform_checks(torch, np, dev, xs)
    say(f"transforms 60 s: {json.dumps(out['transforms_60s'])}")

    # (c) separate-lead's three models on the 60 s recording at the CLI's
    # defaults (40 accompaniment components, 30 SIMM iterations, 20 EM)
    kw = dict(LEAD_KW, n_accomp=40)
    long = {"mono": lambda: separate_lead(xs.mean(axis=0), n_iter=30, device=dev, **kw),
            "stereo": lambda: separate_lead_stereo(xs, n_iter=30, device=dev, **kw),
            "multichannel": lambda: separate_lead_multichannel(
                xs, n_iter_simm=30, n_em=20, device=dev, **kw)}
    out["speech_60s"] = {}
    for name, fn in long.items():
        _, cold = _fenced(torch, dev, fn)
        torch.cuda.reset_peak_memory_stats(dev)
        res, warm = _fenced(torch, dev, fn)
        peak = torch.cuda.max_memory_allocated(dev)
        p = _lead_point(np, res, None)
        dev_ms, per = device_profile(fn)
        r = {"seconds": seconds, "cold_s": cold, "warm_s": warm,
             "audio_s_per_s": seconds / warm, "device_ms": dev_ms,
             "device_launches": sum(n for n, _ in per.values()),
             "max_memory_allocated_gb": peak / 1e9, **p,
             "top_device": sorted(((round(ms, 3), n, k[:60]) for k, (n, ms) in per.items()),
                                  reverse=True)[:6]}
        say(f"separate-lead 60 s {name}: {json.dumps(r)}")
        if not p["finite"]:
            fail(f"phase 11 (c) {name}: non-finite output on the 60 s recording")
        out["speech_60s"][name] = r

    # (e) the CLI in-process on the card
    wav = os.path.join(root, "p11_mixture.wav")
    write_wav(wav, x, 16000)
    out["cli"] = {}
    for model in ("mono", "stereo", "multichannel"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["separate-lead", "--wav", wav, "--out-dir",
                      os.path.join(root, f"p11_{model}"), "--model", model, "--components",
                      "20", "--iters", "15", "--em-iters", "10", "--device", "cuda"])
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        if set(res) != {"lead", "accomp", "sr", "channels", "voiced_frames", "f0_median"} or \
                not all(os.path.isfile(res[k]) for k in ("lead", "accomp")):
            fail(f"phase 11: the CLI's separate-lead --model {model} printed {res}")
        say(f"separate-lead CLI --model {model} on the card: {json.dumps(res)}")
        out["cli"][model] = res
    out["launches"] = _counts(everything)
    say(f"separate-lead: hand-written kernel launches on the path {json.dumps(out['launches'])}")
    return out


def _trace_kernels(trace_dir: str, names) -> dict:
    """Device kernel events of the one ``*.pt.trace.json`` under
    ``trace_dir``, counted by which of ``names`` they contain, and the
    trace's size in MB."""
    paths = [os.path.join(d, f) for d, _, fs in os.walk(trace_dir) for f in fs
             if f.endswith(".pt.trace.json")]
    if len(paths) != 1:
        fail(f"phase 12: trace_to wrote {paths} under {trace_dir}, not one trace")
    with open(paths[0]) as f:
        events = json.load(f).get("traceEvents", [])
    found = {name: sum(1 for ev in events if ev.get("cat") == "kernel"
                       and name in ev.get("name", "")) for name in names}
    return {"kernel_events": found, "trace_mb": os.path.getsize(paths[0]) / 1e6}


def phase_surface(torch, np, dev, root: str, corpus: tuple, counted: dict,
                  fused: dict) -> dict:
    """The JAX package's last public functions and the CLI's ``separate``
    read on the card (module docstring, phase 12)."""
    from exemplars_vc_tpu_torch.align import build_exemplar_dicts, dtw_batch
    from exemplars_vc_tpu_torch.align.exemplar import build_exemplar_dicts_padded
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.dsp import mcep, mcep_to_spectrum
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
    from exemplars_vc_tpu_torch.io.store import ArtifactStore, load_speaker
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav
    from exemplars_vc_tpu_torch.models import (
        WarpingNetConfig, init_warping_params, warping_forward, warping_forward_batch)
    from exemplars_vc_tpu_torch.obs import spectral_convergence, trace_to
    from exemplars_vc_tpu_torch.pipelines import convert as convert_mod
    from exemplars_vc_tpu_torch.pipelines import convert_utterance
    from exemplars_vc_tpu_torch.pipelines.cli import main as cli_main
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import (
        build_conversion_dicts_pair, extract_stft_features, extract_stft_features_stacked)
    from exemplars_vc_tpu_torch.pipelines.make_dict import pair_mfcc
    from exemplars_vc_tpu_torch.prng import PRNGKey
    from exemplars_vc_tpu_torch.separate import separate_signal

    data, src, tar = corpus
    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=8"])
    cpu = torch.device("cpu")
    walls, out = {}, {}

    def timed(name, fn, reps=2):
        """fn() ``reps`` times; its walls (the first cold) go to ``walls``."""
        walls[name] = []
        for _ in range(reps):
            res, wall = _fenced(torch, dev, fn)
            walls[name].append(wall)
        return res

    # (a) trace_to around one conversion and its MCD, the dictionaries
    # rebuilt (memo cleared, a fresh store), so both DTW kernels run in it
    kernels = ("dtw_wavefront_kernel", "dtw_backtrace_kernel", "nmf_recon_kernel",
               "nmf_update_kernel")
    everything = {**counted, **fused}
    convert_mod._DICTS_MEMO.clear()
    trace_dir = os.path.join(root, "p12_trace")
    _zero(everything)
    with trace_to(trace_dir):
        res = timed("trace_to(convert_utterance + MCD)", lambda: convert_utterance(
            cfg, ArtifactStore(os.path.join(root, "p12_store")), data, src, nb_file=8,
            reference_wav=tar, device=dev), reps=1)
    launches = _counts(everything)
    tr = _trace_kernels(trace_dir, kernels)
    say(f"surface: trace_to around convert_utterance + MCD: kernel events in the trace "
        f"{json.dumps(tr['kernel_events'])}, wrapper launches {json.dumps(launches)}, trace "
        f"{tr['trace_mb']:.3f} MB, MCD {res.mcd_vs_reference:.4f} dB")
    if min(tr["kernel_events"].values()) < 1:
        fail(f"phase 12: the trace lacks a main-path kernel as a device event: {tr}")
    if min(launches[k] for k in counted) < 1 or max(launches[k] for k in fused) > 0:
        fail(f"phase 12: launches in the traced conversion {launches}")
    if res.mcd_vs_reference is None or not np.isfinite(res.mcd_vs_reference):
        fail(f"phase 12: MCD {res.mcd_vs_reference}")
    out.update(trace=tr, launches=launches)

    # (b) the ragged exemplar dictionaries on the main path's 8 × 1408 × 20
    # MFCC pairs and |STFT| features, on the card and in the CPU run
    runs = []
    for d in (dev, cpu):
        (FA, la), (FB, lb) = pair_mfcc(cfg, data, 8, d)
        r = dtw_batch(FA, FB, la, lb)
        sf, tf = build_conversion_dicts_pair(cfg, ArtifactStore(os.path.join(root, "p12_dicts")),
                                             data, "SF1", "TF1", nb_file=8, device=d)
        runs.append((FA, r, sf.feats["stft"], tf.feats["stft"]))
    (FA, r, SA, SB), (_, rc, SAc, SBc) = runs
    A, B = timed("build_exemplar_dicts", lambda: build_exemplar_dicts(
        SA, SB, r.path_i, r.path_j, r.path_len))
    k = A.shape[0]
    Ap, Bp = build_exemplar_dicts_padded(SA, SB, r.path_i, r.path_j,
                                         k_pad=((k + 511) // 512) * 512)
    if not (k == int(r.path_len.sum()) and torch.equal(A, Ap[:k]) and torch.equal(B, Bp[:k])
            and not Ap[k:].any() and not Bp[k:].any()):
        fail("phase 12: build_exemplar_dicts differs from the rows build_exemplar_dicts_padded "
             "keeps")
    Ac, Bc = build_exemplar_dicts(SAc, SBc, rc.path_i, rc.path_j, rc.path_len)
    Ag, Bg = build_exemplar_dicts(*(t.to(dev) for t in (SAc, SBc, rc.path_i, rc.path_j,
                                                        rc.path_len)))
    if not (torch.equal(Ag.cpu(), Ac) and torch.equal(Bg.cpu(), Bc)):
        fail("phase 12: build_exemplar_dicts on the card differs from the CPU run on the CPU "
             "run's paths and features")
    same_paths = bool(torch.equal(r.path_i.cpu(), rc.path_i) and torch.equal(
        r.path_j.cpu(), rc.path_j))
    out["exemplars"] = {"K": k, "K_cpu": Ac.shape[0], "D": A.shape[1],
                        "paths_equal_card_vs_cpu": same_paths,
                        "path_entries_equal": float((r.path_i.cpu() == rc.path_i).double().mean())}
    say(f"surface: build_exemplar_dicts {json.dumps(out['exemplars'])}: bit-equal to the padded "
        f"build's kept rows, and to the CPU run on the CPU run's paths")

    # (c) the other functions, each against the port's CPU run on the same inputs
    sigs, _ = load_speaker(data, "SF1", nb_file=8, cpu_rate=cfg.misc.cpu_rate)
    mags, lens = timed("extract_stft_features_stacked",
                       lambda: extract_stft_features_stacked(sigs, cfg, dev))
    mags_c, lens_c = extract_stft_features_stacked(sigs, cfg, cpu)
    # the tests' rule, rtol 1e-5 with a floor of 1e-5 of the peak: at most 1 passes
    e_stft = float(((mags.cpu() - mags_c).abs()
                    / (1e-5 * (mags_c.abs() + mags_c.abs().max()))).max())
    pad_zero = all(not mags[i, n:].any() for i, n in enumerate(lens))
    m = cfg.mcep
    c = mcep(torch.as_tensor(read_wav(tar)[0], dtype=torch.float32),
             frame_length=m.frame_length, hop_length=m.hop_length, order=m.order,
             alpha=m.alpha)
    spec = timed("mcep_to_spectrum", lambda: mcep_to_spectrum(c.to(dev), alpha=m.alpha))
    spec_c = mcep_to_spectrum(c, alpha=m.alpha)
    e_mcep = float(((spec.cpu() - spec_c).abs() / spec_c.abs()).max())
    Y, S = res.converted["stft"], extract_stft_features(read_wav(src)[0], cfg, dev)
    sc = timed("spectral_convergence", lambda: spectral_convergence(Y, S))
    sc_c = spectral_convergence(Y.cpu(), S.cpu())
    e_sc = abs(float(sc) - float(sc_c)) / abs(float(sc_c))
    net_c = init_warping_params(PRNGKey(0), WarpingNetConfig())
    net = init_warping_params(PRNGKey(0), WarpingNetConfig()).to(dev)
    with torch.no_grad():
        wb = timed("warping_forward_batch", lambda: warping_forward_batch(net, FA))
        wb_c = warping_forward_batch(net_c, FA.cpu())
        w1 = warping_forward(net, FA[0])
    e_warp = float((wb.cpu() - wb_c).abs().max())
    e_warp1 = float((w1.cpu() - wb_c[0]).abs().max())
    out["functions"] = {
        "stft_features": {"shape": list(mags.shape), "lens_equal": bool(np.array_equal(
            lens, lens_c)), "padded_frames_zero": pad_zero, "err_over_tol": e_stft},
        "mcep_to_spectrum": {"shape": list(spec.shape), "rel_err": e_mcep},
        "spectral_convergence": {"card": float(sc), "cpu": float(sc_c), "rel": e_sc},
        "warping_forward_batch": {"shape": list(wb.shape), "max_abs_err": e_warp,
                                  "single_vs_batch_cpu_max_abs_err": e_warp1}}
    say(f"surface: functions card vs CPU {json.dumps(out['functions'])}")
    if e_stft > 1 or not pad_zero or not np.array_equal(lens, lens_c):
        fail("phase 12: extract_stft_features_stacked differs from the CPU run (rtol 1e-5, "
             "floor 1e-5 of the peak), or a padded frame is not 0")
    if e_mcep > 1e-5:
        fail(f"phase 12: mcep_to_spectrum {e_mcep:.3g} relative from the CPU run (limit 1e-5)")
    if e_sc > 1e-6:
        fail(f"phase 12: spectral_convergence {e_sc:.3g} relative from the CPU run (limit 1e-6)")
    if e_warp > 1e-5 or e_warp1 > 1e-5:
        fail(f"phase 12: warping_forward(_batch) {e_warp:.3g} / {e_warp1:.3g} from the CPU run "
             f"(limit 1e-5)")

    # (d) the CLI's separate on a stereo wav with distinct channels separates
    # the duplicated downmix: separate_signal on (mean, mean) from the same
    # inits (the same key), and not the file's own channels
    x = synthetic_mixture()
    wav = os.path.join(root, "p12_stereo.wav")
    write_wav(wav, x, 16000)
    mono = read_wav(wav)[0]
    kw = dict(n_sources=2, n_components=8, n_em=20, n_fft=400, hop_length=80)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        timed("separate CLI (stereo wav)", lambda: cli_main([
            "separate", "--wav", wav, "--out-dir", os.path.join(root, "p12_sep"),
            "--components", "8", "--em-iters", "20", "--seed", "0", "--device", str(dev)]))
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    img, model = separate_signal(np.stack([mono, mono]), device=dev, key=PRNGKey(0), **kw)
    img_st, _ = separate_signal(read_wav(wav, mono=False)[0], device=dev, key=PRNGKey(0),
                                **kw)
    got = np.stack([read_wav(p)[0] for p in cli["out"]])
    e, e_ref, e_st = ((a.astype(np.float64) ** 2).sum(axis=-1) for a in (
        got, img.mean(dim=1).cpu().numpy(), img_st.mean(dim=1).cpu().numpy()))
    d_energy = float((np.abs(e - e_ref) / e_ref).max())
    d_stereo = float((np.abs(e - e_st) / e_st).max())
    nll = model.neg_log_like.cpu().numpy()
    d_nll = abs(cli["nll_last"] - float(nll[-1])) / abs(float(nll[-1]))
    out["cli"] = {"energy_rel_vs_downmix_fit": d_energy, "nll_last_rel": d_nll,
                  "energy_rel_vs_channels_fit": d_stereo, "cli": cli}
    say(f"surface: separate CLI on a stereo wav {json.dumps(out['cli'])}")
    if d_energy > 3e-3 or d_nll > 1e-4:
        fail(f"phase 12: the CLI's separate is not the fit of the duplicated downmix: image "
             f"energies {d_energy:.3g} apart (limit 3e-3), nll_last {d_nll:.3g} (limit 1e-4)")
    out["walls_s"] = walls
    say(f"surface: walls (s) {json.dumps(walls)}")
    return out


# the golden file's seeds and shapes (tools/jax_prng_golden.py)
GOLDEN_SEEDS = (0, 1, 42, 2 ** 31 - 1)
GOLDEN_SHAPES = {"scalar": (), "odd": (7,), "empty": (0,), "jfk": (2, 201, 8)}
# separate --seed 0 on the 2 s mixture at 20 EM against the JAX CLI's numbers,
# the tolerances of tests/test_torch_cli.py (SEPARATE_20EM_RTOL): the JAX
# package alone, its input times (1 + 2e-7·noise), moves the source energies by
# up to 2.9e-2 and the last NLL by up to 7.3e-4
SEPARATE_20EM_RTOL = {"nll_first": 1e-5, "nll_last": 2e-3, "energy": 5e-2}


def _ulp_apart(np, a, b):
    """|a − b| in float32 ulp, element-wise."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def phase_seeded(torch, np, dev, root: str, corpus: tuple) -> dict:
    """The seeded draws on the card and the seeded commands against the JAX
    package's numbers (module docstring, phase 13). Nothing here catches a
    failure."""
    from exemplars_vc_tpu_torch import prng
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.standin import jax_prng_golden, synthetic_mixture
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav
    from exemplars_vc_tpu_torch.pipelines.cli import main as cli_main
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance
    from exemplars_vc_tpu_torch.world import synthesis

    g = jax_prng_golden()
    out = {"jax_version": str(g["jax_version"])}

    # (a) prng on the card against the golden draws
    bound = float(np.float32(1.0) / np.sqrt(np.float32(20)))
    worst_ulp, min_equal, n_arrays = 0, 1.0, 0
    for s in GOLDEN_SEEDS:
        k = prng.PRNGKey(s).to(dev)
        for name, got in (("key", k), ("split2", prng.split(k)), ("split6", prng.split(k, 6))):
            n_arrays += 1
            if not np.array_equal(got.cpu().numpy(), g[f"{name}_{s}"].astype(np.int64)):
                fail(f"phase 13 (a): {name} of seed {s} on the card differs from jax.random's")
        for shape_name, shape in GOLDEN_SHAPES.items():
            exact = {"bits": prng._random_bits(k, shape).cpu().numpy().astype(np.uint32),
                     "uniform": prng.uniform(k, shape).cpu().numpy(),
                     "uniformb": prng.uniform(k, shape, minval=-bound,
                                              maxval=bound).cpu().numpy(),
                     "randint": prng.randint(k, shape, 0, 8).cpu().numpy()}
            for name, got in exact.items():
                want = g[f"{name}_{s}_{shape_name}"]
                n_arrays += 1
                if got.dtype != want.dtype or not np.array_equal(got, want):
                    fail(f"phase 13 (a): {name} of seed {s} at {shape} on the card is not "
                         f"bit-equal to jax.random's")
            want = g[f"normal_{s}_{shape_name}"]
            got = prng.normal(k, shape).cpu().numpy()
            n_arrays += 1
            if got.shape != want.shape:
                fail(f"phase 13 (a): normal of seed {s}: shape {got.shape}, not {want.shape}")
            if want.size:
                d = _ulp_apart(np, got, want)
                worst_ulp = max(worst_ulp, int(d.max()))
                min_equal = min(min_equal, float((d == 0).mean()))
                if d.max() > 4:
                    fail(f"phase 13 (a): normal of seed {s} at {shape} on the card "
                         f"{int(d.max())} ulp from jax.random's (limit 4)")
    noise = prng.normal(prng.PRNGKey(0).to(dev), g["world_noise"].shape).cpu().numpy()
    d = _ulp_apart(np, noise, g["world_noise"])
    out["card_draws"] = {"arrays": n_arrays, "normal_max_ulp": worst_ulp,
                         "normal_bit_equal_min_share": min_equal,
                         "world_noise_max_ulp": int(d.max()),
                         "world_noise_bit_equal_share": float((d == 0).mean())}
    say(f"seeded: prng on the card against jax {out['jax_version']}: "
        f"{json.dumps(out['card_draws'])}")
    if d.max() > 4:
        fail(f"phase 13 (a): the default key's WORLD noise on the card {int(d.max())} ulp from "
             f"the JAX package's (limit 4)")

    # (b) the seeded CLI commands on the 2 s mixture written as a wav
    wav = os.path.join(root, "p13_mixture.wav")
    write_wav(wav, synthetic_mixture(), 16000)

    def cli(args, device):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_main([*args, "--out-dir", os.path.join(root, f"p13_{args[0]}_{device}"),
                      "--device", device])
        return json.loads(buf.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0

    def energy(path) -> float:
        return float((read_wav(path, mono=False)[0].astype(np.float64) ** 2).sum())

    lead_args = ["separate-lead", "--wav", wav, "--model", "stereo", "--seed", "1",
                 "--iters", "15", "--components", "20"]
    shares = {}
    for device in ("cuda", "cpu"):
        res, wall = cli(lead_args, device)
        e_l, e_a = energy(res["lead"]), energy(res["accomp"])
        shares[device] = {"share": e_l / (e_l + e_a), "voiced_frames": res["voiced_frames"],
                          "f0_median": res["f0_median"], "wall_s": wall}
    share_jax = float(g["cli_lead_share"])
    out["separate_lead_cli"] = {**shares, "jax_cli": {
        "share": share_jax, "voiced_frames": int(g["cli_lead_voiced_frames"]),
        "f0_median": float(g["cli_lead_f0_median"])}}
    say(f"seeded: separate-lead --model stereo --seed 1 {json.dumps(out['separate_lead_cli'])}")
    card_share = shares["cuda"]["share"]
    if abs(card_share - shares["cpu"]["share"]) > 0.01 or abs(card_share - share_jax) > 1e-3:
        fail(f"phase 13 (b): the CLI's stereo lead share {card_share:.4f} on the card (CPU "
             f"{shares['cpu']['share']:.4f}, limit 0.01; the JAX CLI's {share_jax:.4f}, "
             f"limit 1e-3)")
    sep, wall = cli(["separate", "--wav", wav, "--seed", "0", "--em-iters", "20"], "cuda")
    e = np.array([energy(p) for p in sep["out"]])
    e_jax = g["cli_separate_energies"]
    rel = {"nll_first": abs(sep["nll_first"] / float(g["cli_separate_nll_first"]) - 1),
           "nll_last": abs(sep["nll_last"] / float(g["cli_separate_nll_last"]) - 1),
           "energy": float((np.abs(e - e_jax) / e_jax).max())}
    out["separate_cli"] = {"card": sep, "energies": e.tolist(), "jax_energies": e_jax.tolist(),
                           "rel_vs_jax": rel, "limits": SEPARATE_20EM_RTOL, "wall_s": wall}
    say(f"seeded: separate --seed 0 (20 EM) on the card against the JAX CLI "
        f"{json.dumps(out['separate_cli'])}")
    for k, lim in SEPARATE_20EM_RTOL.items():
        if rel[k] > lim:
            fail(f"phase 13 (b): separate --seed 0: {k} {rel[k]:.3g} relative from the JAX "
                 f"CLI's (limit {lim})")

    # (c) one WORLD conversion with the default key: the noise it draws
    data, src, tar = corpus
    drawn = []
    normal = prng.normal

    def spy(key, shape=(), dtype=torch.float32):
        drawn.append(normal(key, shape, dtype))
        return drawn[-1]

    synthesis._DEFAULT_NOISE.clear()
    prng.normal = spy
    try:
        res = convert_utterance(
            load_config(overrides=["data.tar=TF1", "misc.nb_file=8", "data.use_stft=false"]),
            ArtifactStore(os.path.join(root, "p13_world")), data, src, nb_file=8,
            reference_wav=tar, device=dev)
    finally:
        prng.normal = normal
    if len(drawn) != 1 or drawn[0].shape[0] > len(g["world_noise"]):
        fail(f"phase 13 (c): the WORLD conversion drew {[tuple(a.shape) for a in drawn]}, not "
             f"one noise of at most {len(g['world_noise'])} samples")
    noise = drawn[0].cpu().numpy()
    d = _ulp_apart(np, noise, g["world_noise"][:len(noise)])
    out["world"] = {"noise_samples": len(noise), "noise_max_ulp": int(d.max()),
                    "noise_bit_equal_share": float((d == 0).mean()),
                    "mcd_db": float(res.mcd_vs_reference)}
    say(f"seeded: WORLD conversion with the default key {json.dumps(out['world'])}; "
        f"stand-in held-out WORLD MCD {res.mcd_vs_reference:.4f} dB")
    if d.max() > 4 or not (np.isfinite(res.audio).all() and np.isfinite(res.mcd_vs_reference)):
        fail(f"phase 13 (c): the WORLD noise {int(d.max())} ulp from the JAX package's (limit "
             f"4), or the audio or MCD not finite")

    # (d) the largest draw of the path: H of the 60 s separate, on the CPU
    kh = prng.split(prng.PRNGKey(0), 3)[1]
    shape = (2, 8, 12001)

    def draw_ms(key, reps=7):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            (prng.normal(key, shape) ** 2).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out["draw_60s_H"] = {"shape": list(shape), "cpu_ms": draw_ms(kh),
                         "card_ms": draw_ms(kh.to(dev)), "torch_threads": torch.get_num_threads()}
    say(f"seeded: normal(key, {shape}) ** 2, median of 7 (host clock, the card's ending in a "
        f"copy to the host) {json.dumps(out['draw_60s_H'])}")

    # the WORLD synthesis at (c)'s length: the default key's noise kept on
    # the card against the same draw made on the host each call
    n = out["world"]["noise_samples"]
    frames = n // 80 + 1
    f0 = torch.full((frames,), 150.0, device=dev)
    sp = torch.full((frames, 513), 1e-3, device=dev)
    ap = torch.full((frames, 513), 0.5, device=dev)
    kept = synthesis.synthesize(f0, sp, ap)
    if not torch.equal(kept, synthesis.synthesize(f0, sp, ap, key=prng.PRNGKey(0))):
        fail("phase 13 (d): the kept WORLD noise and a fresh draw of PRNGKey(0) give "
             "different audio")
    out["world_synthesize"] = {
        "samples": n, "kept_noise_ms": wall_ms(lambda: synthesis.synthesize(f0, sp, ap), 7),
        "drawn_noise_ms": wall_ms(
            lambda: synthesis.synthesize(f0, sp, ap, key=prng.PRNGKey(0)), 7)}
    say(f"seeded: world.synthesize of {n} samples, median of 7 (host clock, fenced) "
        f"{json.dumps(out['world_synthesize'])}")
    return out


def single_train(dev, root: str, data: str, batch: int) -> dict:
    """Phase 9's data-parallel warp-train on one card: the same 5 epochs on
    the 8 pairs with ``batch`` utterances a step, after a 1-epoch warm run."""
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.models.train import train_warping_net

    def train(epochs: int, tag: str) -> dict:
        cfg = load_config(overrides=["data.tar=TF1", f"net.nb_epoch={epochs}",
                                     f"net.batch_size={batch}"])
        return train_warping_net(cfg, ArtifactStore(os.path.join(root, f"p9_{tag}")), data,
                                 nb_file=8, device=dev, run_root=os.path.join(root, "p9_runs"))

    train(1, "train1_warm")
    single = train(5, "train1")
    say(f"parallel: warp-train on one card, 5 epochs, {batch} utterances a step: "
        f"{single['steps_per_s']} steps/s, {single['steps_run']} steps, "
        f"{single['train_seconds']:.4f} s")
    return single


def run_world(world: int, backend: str, root: str, corpus: tuple) -> list[dict]:
    """A world of ``world`` :func:`parallel_rank` processes on ``backend``;
    prints and returns their measurements, by rank."""
    import torch.multiprocessing as mp

    out = os.path.join(root, f"p9_{backend}{world}")
    os.makedirs(out)
    t0 = time.perf_counter()
    mp.spawn(parallel_rank, args=(world, _free_port(), backend, out, corpus[0], corpus[1]),
             nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"{r}.json")) as f:
            ranks.append(json.load(f))
    say(f"parallel: world of {world} {backend} rank(s) in {time.perf_counter() - t0:.2f} s")
    for r, res in enumerate(ranks):
        for key in ("nmf", "shard_kernels", "separate_batch", "convert", "dtw_batch", "dtw_long",
                    "train"):
            if key in res:
                say(f"parallel [{backend} {world}, rank {r}] {key}: {json.dumps(res[key])}")
        say(f"parallel [{backend} {world}, rank {r}] path launches "
            f"{json.dumps(res['path_launches'])}")
    return ranks


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
    card = smi.stdout.strip().splitlines()[0]   # the card's name and power limit
    say(card)
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
        launches, default_mcd = phase_main_path(torch, np, dev, root, corpus, counted, fused)
        launches.update(phase_fused_path(torch, np, dev, root, corpus, fused))
        serving = phase_serving(torch, np, dev, root, corpus[0], counted, fused, default_mcd)
        phase_small_agreement(torch, np, dev, root)
        world = phase_world(torch, np, dev, root, corpus, counted, fused)
        stage02 = phase_stage02(torch, np, dev, root, corpus, counted, fused)
        par = phase_parallel(torch, np, dev, root, corpus)
        phase_separate(torch, np, dev, root, counted, fused)
        phase_lead(torch, np, dev, root, counted, fused)
        surface = phase_surface(torch, np, dev, root, corpus, counted, fused)
        phase_seeded(torch, np, dev, root, corpus)
    if "jax" in sys.modules:
        fail("jax was imported")
    say(card)    # again beside the numbers, for a reader of the output's end

    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "launches_serving": serving[name], "launches_world": world[name],
         "launches_stage02": stage02["launches"][name],
         "launches_parallel": par["launches"].get(name, 0),
         "launches_surface": surface["launches"][name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"],
         **({"dfw_ms": stage02["dfw"][name[4:]]["ms"],
             "dfw_bound_ms": stage02["dfw"][name[4:]]["bound_ms"]}
            if name.startswith("dtw_") else {}),
         **({"tile_launches_parallel": par["launches"]["dtw_tile"], "tile_ms": par["tile_ms"],
             "tile_nocodes_ms": par["tile_nocodes_ms"], "tile_plain_ms": par["tile_plain_ms"],
             "tile_bound_ms": par["tile_bound_ms"],
             "tile_max_abs_err": par["tile_max_abs_err"]}
            if name == "dtw_wavefront" else {}),
         **({"shard_max_abs_err": par["shard_max_abs_err"][name]}
            if name in par["shard_max_abs_err"] else {})}
        for name in sources]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
