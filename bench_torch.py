#!/usr/bin/env python3
"""End-to-end benchmark of the PyTorch/CUDA port on one GPU, in ``bench.py``'s
JSON shape.

    python3 bench_torch.py [--runs 7] [--warps LIST] [--out FILE]

It runs the whole SF1→TF1 pipeline of ``convert_utterance`` on the stand-in
corpus (``exemplars_vc_tpu_torch.io.standin``: 8 pairs, the held-out
utterance 100162 through ``evaluate.heldout_pair``; the reference corpus is
not in the repository): speaker load, alignment MFCC, batched DTW, |STFT|
dictionaries, the MU solve (150 iterations at most, tol 1e-4), conversion
and Griffin-Lim(300). It reports

- ``value``: audio seconds (both speakers' dictionary utterances and the
  input) per wall second of one steady conversion, the median of ``--runs``
  (at least 7) conversions that each build the dictionary anew, with the
  max/min spread;
- ``cold_s``: the first conversion of this process, with the nvcc builds it
  had to make (``kernels_built_s``; empty when ``build/kernels`` was warm);
- ``stages_synced_s``: one conversion with the device fenced around each
  stage;
- ``heldout_mcd_db``: the DTW-aligned MCD against the held-out target (a
  stand-in figure, not comparable to the real corpus's);
- ``serving``: a ``Converter`` prepared once (``prepare_seconds``), its
  ``convert`` p50/p90, ``convert_batch`` of four utterances, and a
  ``StreamingConverter``'s steady ``push`` p50/p90 against the chunk's
  duration (16 frames, context 32, 60 Griffin-Lim iterations);
- ``separate``: ``separate_signal`` in ``bench_separate.py``'s multichannel
  fields (``cold_s``, ``warm_s``, ``rtf_warm``, ``nll_drop``; images fetched
  to the host inside the timing) on its fixed 2 s stereo mixture (2 sources,
  8 components, 20 EM iterations, n_fft 400, hop 80) and on a 60 s
  two-talker recording of the in-repo speech at the CLI's defaults (50 EM
  iterations), each with the card's name and power limit;
- ``separate_lead``: the three lead-separation models (``separate_lead`` on
  the channel mean, ``separate_lead_stereo``, ``separate_lead_multichannel``)
  at the CLI's defaults (n_fft 1024, hop 256, f0 100-800 Hz, 40
  accompaniment components, 30 SIMM iterations a round, 20 EM iterations)
  on the same 2 s and 60 s mixtures: ``cold_s``, ``warm_s`` and
  ``audio_s_per_s`` (warm; outputs fetched to the host inside the timing),
  each with the card's name and power limit.

``--warps`` sets ``data.dict_augment_warps`` for every part (``--warps 14``
stands for the 14 warps of the JAX package's large-dictionary benchmark:
K = 15 × 6144 = 92,160 on the stand-in corpus). The script needs a card,
imports nothing of jax, prints the card's name and power limit to stderr and
into the result, and prints one JSON line to stdout.
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

WARPS_14 = "0.86,0.88,0.9,0.92,0.94,0.96,0.98,1.02,1.04,1.06,1.08,1.1,1.12,1.14"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pct(vals: list[float], q: float) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, int(q * len(s)))]


def bench_separate(torch, dev, card: str) -> dict:
    """``separate_signal`` cold and warm on the 2 s and the 60 s mixtures."""
    from exemplars_vc_tpu_torch.io.standin import speech_mixture, synthetic_mixture
    from exemplars_vc_tpu_torch.prng import PRNGKey
    from exemplars_vc_tpu_torch.separate import separate_signal

    speech, _, sr = speech_mixture(seconds=60.0)
    cases = {"mixture_2s": (synthetic_mixture(), 2.0, 20),
             "speech_60s": (speech, speech.shape[1] / sr, 50)}
    out = {}
    for name, (x, seconds, n_em) in cases.items():
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images, model = separate_signal(
                x, n_sources=2, n_components=8, n_em=n_em, n_fft=400, hop_length=80,
                key=PRNGKey(0), device=dev)
            images.cpu().numpy()
            nll = model.neg_log_like.cpu().numpy()
            return nll, time.perf_counter() - t0

        _, cold = run()
        nll, warm = run()
        out[name] = {"cold_s": round(cold, 4), "warm_s": round(warm, 4),
                     "rtf_warm": round(seconds / warm, 2),
                     "nll_drop": round(float(nll[0] - nll[-1]), 1), "audio_s": seconds,
                     "n_em": n_em, "card": card}
    return out


def bench_separate_lead(torch, dev, card: str) -> dict:
    """The three lead-separation models cold and warm on the 2 s and the
    60 s mixtures."""
    from exemplars_vc_tpu_torch.io.standin import speech_mixture, synthetic_mixture
    from exemplars_vc_tpu_torch.prng import PRNGKey
    from exemplars_vc_tpu_torch.separate import (
        separate_lead, separate_lead_multichannel, separate_lead_stereo)

    speech, _, sr = speech_mixture(seconds=60.0)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0, f0_max=800.0,
              n_accomp=40, device=dev)
    models = {"mono": lambda x, k: separate_lead(x.mean(axis=0), n_iter=30, key=k, **kw),
              "stereo": lambda x, k: separate_lead_stereo(x, n_iter=30, key=k, **kw),
              "multichannel": lambda x, k: separate_lead_multichannel(
                  x, n_iter_simm=30, n_em=20, key=k, **kw)}
    out = {}
    for mix, (x, seconds) in {"mixture_2s": (synthetic_mixture(), 2.0),
                              "speech_60s": (speech, speech.shape[1] / sr)}.items():
        for name, fn in models.items():
            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(x, PRNGKey(0))
                res.lead.cpu().numpy()
                res.accomp.cpu().numpy()
                return time.perf_counter() - t0

            cold = run()
            warm = run()
            out[f"{name}/{mix}"] = {"cold_s": round(cold, 4), "warm_s": round(warm, 4),
                                    "audio_s_per_s": round(seconds / warm, 2),
                                    "audio_s": seconds, "card": card}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=7, help="steady samples (at least 7)")
    ap.add_argument("--warps", default="", help="comma list of VTLP warps, or 14 for the "
                    "large-dictionary list")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    runs = max(args.runs, 7)
    warps = WARPS_14 if args.warps.strip() == "14" else args.warps.strip()

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch.py needs a GPU: torch.cuda.is_available() is False")
    from dataclasses import replace

    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
    from exemplars_vc_tpu_torch.io.store import ArtifactStore, list_speaker_wavs
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.kernels import build
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import extract_stft_complex
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance, mcd_between_signals
    from exemplars_vc_tpu_torch.pipelines.evaluate import heldout_pair
    from exemplars_vc_tpu_torch.pipelines.serve import Converter
    from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else torch.cuda.get_device_name(0)
    log(card)
    dev = torch.device("cuda:0")
    overrides = ["data.tar=TF1", "misc.nb_file=8"]
    if warps:
        overrides.append(f"data.dict_augment_warps={warps}")
    cfg = load_config(overrides=overrides)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="evc_bench_torch_") as root:
        data, _, _ = build_standin_corpus(os.path.join(root, "corpus"))
        wav_path, tar_path = heldout_pair(data)
        total_audio = 0.0
        for spk in ("SF1", "TF1"):
            for p in list_speaker_wavs(data, spk)[:8]:
                x, sr = read_wav(p)
                total_audio += len(x) / sr
        x_in, sr = read_wav(wav_path)
        total_audio += len(x_in) / sr
        log(f"audio to process: {total_audio:.1f} s")

        def fresh(k):   # a fresh store: the dictionary is built anew
            return ArtifactStore(os.path.join(root, f"store{k}"))

        res, cold = synced(lambda: convert_utterance(cfg, fresh("cold"), data, wav_path,
                                                     nb_file=8, device=dev))
        log(f"cold run: {cold:.3f} s (nvcc builds {dict(build.build_seconds)})")
        hots = []
        for k in range(runs):
            res, s = synced(lambda k=k: convert_utterance(cfg, fresh(k), data, wav_path,
                                                          nb_file=8, device=dev))
            hots.append(s)
            log(f"steady run {k + 1}/{runs}: {s:.4f} s")
        hot = statistics.median(hots)
        res_sync = convert_utterance(cfg, fresh("sync"), data, wav_path, nb_file=8,
                                     sync_stages=True, device=dev)
        tar_sig, _ = read_wav(tar_path)
        mcd = float(mcd_between_signals(res_sync.audio, tar_sig, cfg, dev))
        F, K, D = res_sync.nmf_shape
        log(f"F={F} K={K} D={D} n_iter={res_sync.n_iter} MCD {mcd:.4f} dB; fenced stages "
            f"{res_sync.timings}")

        # serving
        conv = Converter(cfg, fresh("serve"), data, nb_file=8, device=dev)
        paths = [wav_path] + list_speaker_wavs(data, "SF1")[:3]
        conv.convert(wav_path)
        conv.convert_batch(paths)            # warm: cuFFT plans a new length
        convert_s = [synced(lambda: conv.convert(wav_path))[1] for _ in range(runs)]
        batch_s = [synced(lambda: conv.convert_batch(paths))[1] for _ in range(3)]
        serial_s = [sum(synced(lambda p=p: conv.convert(p))[1] for p in paths)
                    for _ in range(3)]
        A, B = conv.dicts["stft"]
        S = extract_stft_complex(x_in, cfg, dev)
        X = torch.abs(S)
        chunk, hop = 16, cfg.mcep.hop_length
        sc = StreamingConverter(cfg, A, B, context_frames=32, synth_iters=60, device=dev)
        push_s = [synced(lambda i=i: sc.push(X[i: i + chunk], S[i: i + chunk]))[1]
                  for i in range(0, X.shape[0] - chunk + 1, chunk)]
        steady = push_s[3:]                  # the context is full from the fourth push on
        chunk_s = chunk * hop / cfg.data.sr
        bf = Converter(replace(cfg, nmf=replace(cfg.nmf, work_dtype="bfloat16")),
                       fresh("serve"), data, nb_file=8, device=dev)
        bf.convert(wav_path)
        bf_s = [synced(lambda: bf.convert(wav_path))[1] for _ in range(3)]
        serving = {
            "k_exemplars": int(A.shape[0]),
            "prepare_seconds": round(conv.prepare_seconds, 4),
            "convert_s_p50": round(pct(convert_s, 0.5), 4),
            "convert_s_p90": round(pct(convert_s, 0.9), 4),
            "batch_n_utts": len(paths),
            "batch_frames": [1 + len(read_wav(p)[0]) // hop for p in paths],
            "batch_s_median": round(statistics.median(batch_s), 4),
            "batch_per_utt_s": round(statistics.median(batch_s) / len(paths), 4),
            "serial_s_median": round(statistics.median(serial_s), 4),
            "batch_speedup": round(statistics.median(serial_s) / statistics.median(batch_s), 3),
            "convert_bf16_s_median (plain torch solve)": round(statistics.median(bf_s), 4),
            "push_chunk_frames": chunk,
            "push_chunk_audio_s": chunk_s,
            "push_s_p50": round(pct(steady, 0.5), 5),
            "push_s_p90": round(pct(steady, 0.9), 5),
            "push_real_time_factor_p50": round(pct(steady, 0.5) / chunk_s, 4),
        }
        log(f"serving: {serving}")

    separate = bench_separate(torch, dev, card)
    log(f"separate: {separate}")
    separate_lead = bench_separate_lead(torch, dev, card)
    log(f"separate_lead: {separate_lead}")

    rate = total_audio / hot
    payload = {
        "metric": "audio-seconds/s per GPU (dict build + NMF convert + GL300), "
                  f"{K}-exemplar dictionary, stand-in corpus",
        "value": round(rate, 3),
        "unit": "audio_s/s",
        "detail": {
            "card": card,
            "steady_state_s_median": round(hot, 4),
            "steady_state_s_all": [round(h, 4) for h in hots],
            "steady_state_max_over_min": round(max(hots) / min(hots), 3),
            "cold_s": round(cold, 3),
            "kernels_built_s": {k: round(v, 2) for k, v in build.build_seconds.items()},
            "audio_s": round(total_audio, 2),
            "nmf_shape_F_K_D": [F, K, D],
            "nmf_iters": int(res_sync.n_iter),
            "heldout_utt": "100162 of the stand-in corpus (not in the dictionary-build set)",
            "heldout_mcd_db": round(mcd, 4),
            "stages_synced_s": {k: round(v, 4) for k, v in res_sync.timings.items()},
            "serving": serving,
            "separate": separate,
            "separate_lead": separate_lead,
            "platform": "gpu",
            "torch": torch.__version__,
            "total_wall_s": round(time.perf_counter() - t_start, 1),
        },
    }
    if "jax" in sys.modules:
        sys.exit("jax was imported")
    line = json.dumps(payload)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
