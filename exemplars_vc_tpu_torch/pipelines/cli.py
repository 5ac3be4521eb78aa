"""Command-line interface of the port: the JAX package's subcommands, flags
and JSON output keys (``exemplars_vc_tpu/pipelines/cli.py``), run on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain twins).

Usage::

    python -m exemplars_vc_tpu_torch.pipelines.cli make-dict --data DATA --store STORE
    python -m exemplars_vc_tpu_torch.pipelines.cli convert --data DATA --store STORE \\
        --wav DATA/SF1/100001.wav --out out.wav
    python -m exemplars_vc_tpu_torch.pipelines.cli warp-train --data DATA --device cpu

``-o section.key=value`` overrides the configuration. ``separate`` runs the
multichannel separation and ``separate-lead`` the lead/accompaniment
separation (``--model mono|stereo|multichannel``); ``--seed`` is the seed of
the PRNG key (``prng.PRNGKey``) their random inits are drawn from, as in the
JAX CLI.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile

import numpy as np


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", default=None, help="INI config path (reference format)")
    p.add_argument("--data", required=True, help="root with <speaker>/*.wav dirs")
    p.add_argument("--store", default="artifacts", help="artifact store directory")
    p.add_argument("--src", default=None, help="source speaker (overrides config)")
    p.add_argument("--tar", default=None, help="target speaker (overrides config)")
    p.add_argument("--nb-file", type=int, default=None, help="max utterances")
    p.add_argument("-o", "--override", action="append", default=[],
                   help="config override section.key=value (repeatable)")
    p.add_argument("--preset", default=None,
                   help="named config preset (config.PRESETS, e.g. 'quality'); "
                        "explicit -o overrides still win")
    _add_device(p)


def _add_device(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (the default; raises without a card) or 'cpu'")


def _setup(args):
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.obs.logging import get_logger

    get_logger()
    overrides = list(args.override)
    if args.src:
        overrides.append(f"data.src={args.src}")
    if args.tar:
        overrides.append(f"data.tar={args.tar}")
    cfg = load_config(args.config, overrides, preset=args.preset)
    return cfg, ArtifactStore(args.store)


def cmd_make_dict(args):
    from exemplars_vc_tpu_torch.pipelines.make_dict import make_dictionary

    cfg, store = _setup(args)
    art = make_dictionary(cfg, store, args.data, feat=args.feat, nb_file=args.nb_file,
                          device=args.device)
    print(json.dumps({
        "pairs": int(art.path_len.shape[0]),
        "total_exemplars": int(art.path_len.sum()),
        "mean_distance": float(art.distance.mean()),
    }))


def cmd_conv_dicts(args):
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import build_conversion_dicts

    cfg, store = _setup(args)
    for speaker in (cfg.data.src, cfg.data.tar):
        f = build_conversion_dicts(cfg, store, args.data, speaker, nb_file=args.nb_file,
                                   device=args.device)
        print(json.dumps({
            "speaker": speaker, "kind": f.kind,
            "shapes": {k: list(v.shape) for k, v in f.feats.items()},
        }))


def cmd_convert(args):
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance

    cfg, store = _setup(args)
    res = convert_utterance(cfg, store, args.data, args.wav, out_path=args.out,
                            nb_file=args.nb_file, synth_iters=args.synth_iters,
                            reference_wav=args.ref_wav, device=args.device)
    print(json.dumps({
        "out": args.out, "sr": res.sr, "samples": int(res.audio.shape[0]),
        "nmf_iters": res.n_iter, "nmf_error": res.nmf_error,
        "mcd_vs_reference": res.mcd_vs_reference,
        "timings": {k: round(v, 3) for k, v in res.timings.items()},
    }))


def cmd_demo(args):
    """Stage-05 equivalent: convert the first source utterance with defaults."""
    from exemplars_vc_tpu_torch.io.store import list_speaker_wavs
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance

    cfg, store = _setup(args)
    wav = list_speaker_wavs(args.data, cfg.data.src)[0]
    out = args.out or os.path.join(tempfile.gettempdir(), "exemplars_vc_demo.wav")
    res = convert_utterance(cfg, store, args.data, wav, out_path=out, nb_file=args.nb_file,
                            synth_iters=100, device=args.device)
    print(json.dumps({"wav": wav, "out": out, "samples": int(res.audio.shape[0])}))


def cmd_freq_warp(args):
    """Stage 02 DFW/AMF: estimate frequency warpings over the aligned set."""
    from exemplars_vc_tpu_torch.pipelines.freq_warp import run_freq_warp

    cfg, store = _setup(args)
    res = run_freq_warp(cfg, store, args.data, variant=args.variant, nb_file=args.nb_file,
                        device=args.device)
    print(json.dumps({"variant": args.variant,
                      "artifacts": {k: list(v.shape) for k, v in res.items()}}))


def cmd_convert_dir(args):
    """Batch conversion: prepare the dictionaries once, convert every wav of
    a directory with them."""
    from exemplars_vc_tpu_torch.pipelines.serve import Converter

    cfg, store = _setup(args)
    conv = Converter(cfg, store, args.data, nb_file=args.nb_file, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    results = []
    for w in sorted(glob.glob(os.path.join(args.in_dir, "*.wav"))):
        out = os.path.join(args.out_dir, os.path.basename(w))
        r = conv.convert(w, out_path=out, synth_iters=args.synth_iters)
        results.append({"wav": w, "out": out, "seconds": round(r.seconds, 3)})
    print(json.dumps({
        "prepared_s": round(conv.prepare_seconds, 3),
        "n_files": len(results),
        "total_convert_s": round(sum(r["seconds"] for r in results), 3),
        "results": results,
    }))


def cmd_warp_eval(args):
    """The trained warping net on the held-out split: L1 a coefficient
    against the identity baseline."""
    from exemplars_vc_tpu_torch.models.train import (
        apply_warping_net,
        make_warping_dataset,
        train_test_split,
    )

    cfg, store = _setup(args)
    src, tar, mask = make_warping_dataset(cfg, store, args.data, nb_file=args.nb_file,
                                          features=args.features, device=args.device)
    _, idx_test = train_test_split(src.shape[0])
    pred = apply_warping_net(store, cfg, src[idx_test], features=args.features,
                             device=args.device).cpu().numpy()
    m = mask[idx_test][..., None]
    l1 = float(np.sum(np.abs(pred - tar[idx_test]) * m) / max(m.sum(), 1.0))
    baseline = float(np.sum(np.abs(src[idx_test] - tar[idx_test]) * m) / max(m.sum(), 1.0))
    print(json.dumps({
        "test_utterances": int(len(idx_test)),
        "l1_per_coeff": l1,
        "identity_baseline_l1": baseline,
        "improvement": (baseline - l1) / baseline if baseline else None,
    }))


def cmd_warp_train(args):
    from exemplars_vc_tpu_torch.models.train import train_warping_net

    cfg, store = _setup(args)
    metrics = train_warping_net(cfg, store, args.data, nb_file=args.nb_file,
                                run_root=args.runs, features=args.features, device=args.device)
    print(json.dumps(metrics))


def _names(spec: str | None) -> list[str] | None:
    return spec.split(",") if spec else None


def cmd_eval_heldout(args):
    from exemplars_vc_tpu_torch.pipelines.evaluate import (
        evaluate_heldout,
        no_conversion_baseline,
    )

    cfg, store = _setup(args)
    scores = evaluate_heldout(cfg, store, args.data, nb_file=args.nb_file,
                              configs=_names(args.configs), synth_iters=args.synth_iters,
                              device=args.device)
    print(json.dumps({
        "utterance": "100162 (held out of the dictionary-build set)",
        "no_conversion_mcd_db": round(no_conversion_baseline(cfg, args.data,
                                                             device=args.device), 3),
        "scores": {
            name: {"mcd_db": round(s.mcd, 3),
                   **{f"mcd_vs_{k}_db": round(v, 3) for k, v in s.vs_reference_outputs.items()}}
            for name, s in scores.items()
        },
    }))


def cmd_eval_loo(args):
    from exemplars_vc_tpu_torch.pipelines.evaluate import evaluate_loo

    cfg, store = _setup(args)
    results, summary = evaluate_loo(cfg, store, args.data, configs=_names(args.configs),
                                    synth_iters=args.synth_iters, include_levers=args.levers,
                                    folds=_names(args.folds), audio_dir=args.audio_dir,
                                    device=args.device)
    print(json.dumps({
        "protocol": "leave-one-out: dictionaries from all pairs except the "
                    "held-out utterance, converted + scored vs its true target",
        "folds": [{"utt": f.utt, "no_conversion_mcd_db": round(f.no_conversion_mcd, 3),
                   **{k: round(v, 3) for k, v in f.mcd.items()}}
                  for f in results],
        "summary": {k: {kk: (round(vv, 3) if isinstance(vv, float) else vv)
                        for kk, vv in s.items()}
                    for k, s in summary.items()},
    }))


def cmd_separate(args):
    """Multichannel NMF source separation (``separate/``): one wav a source
    under ``--out-dir``, channels averaged."""
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav
    from exemplars_vc_tpu_torch.prng import PRNGKey
    from exemplars_vc_tpu_torch.separate import separate_signal

    # as the JAX CLI reads it: the file downmixed to mono, duplicated to a
    # 2-channel mixture (a stereo file's channels are averaged first)
    x, sr = read_wav(args.wav)
    x = np.stack([x, x])
    images, model = separate_signal(
        x, n_sources=args.sources, n_components=args.components,
        n_em=args.em_iters, n_fft=args.n_fft, hop_length=args.hop,
        key=PRNGKey(args.seed), device=args.device)
    images = images.cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.wav))[0]
    outs = []
    for j in range(args.sources):
        p = os.path.join(args.out_dir, f"{base}_source{j}.wav")
        write_wav(p, images[j].mean(axis=0), sr)
        outs.append(p)
    nll = model.neg_log_like.cpu().numpy()
    print(json.dumps({"out": outs, "sr": sr,
                      "nll_first": float(nll[0]), "nll_last": float(nll[-1])}))


def cmd_separate_lead(args):
    """Lead/accompaniment separation (SIMM family, ``separate/``): the
    lead and accompaniment images as ``<wav>_lead.wav`` and
    ``<wav>_accomp.wav`` under ``--out-dir``."""
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav
    from exemplars_vc_tpu_torch.prng import PRNGKey

    # the file's own channels: the stereo and multichannel models need the
    # spatial image (separate_lead masks each channel)
    x, sr = read_wav(args.wav, mono=False)
    kw = dict(sample_rate=float(sr), n_fft=args.n_fft, hop_length=args.hop,
              f0_min=args.f0_min, f0_max=args.f0_max, n_accomp=args.components,
              key=PRNGKey(args.seed), device=args.device)
    if args.model == "mono":
        from exemplars_vc_tpu_torch.separate import separate_lead

        res = separate_lead(x, n_iter=args.iters, **kw)
    elif args.model == "stereo":
        from exemplars_vc_tpu_torch.separate import separate_lead_stereo

        res = separate_lead_stereo(x, n_iter=args.iters, **kw)
    else:  # multichannel: the composed source-F0-filter FASST model
        from exemplars_vc_tpu_torch.separate import separate_lead_multichannel

        res = separate_lead_multichannel(x, n_iter_simm=args.iters, n_em=args.em_iters, **kw)
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.wav))[0]
    lead_p = os.path.join(args.out_dir, f"{base}_lead.wav")
    acc_p = os.path.join(args.out_dir, f"{base}_accomp.wav")
    lead = res.lead.cpu().numpy()
    # the whole separated image, C channels; a mono input comes out (1, T)
    write_wav(lead_p, lead, sr)
    write_wav(acc_p, res.accomp.cpu().numpy(), sr)
    f0 = np.asarray(res.f0)
    print(json.dumps({
        "lead": lead_p, "accomp": acc_p, "sr": sr,
        "channels": int(lead.shape[0]),
        "voiced_frames": int((f0 > 0).sum()),
        "f0_median": float(np.median(f0[f0 > 0])) if (f0 > 0).any() else 0.0,
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="exemplars-vc-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("make-dict", help="stage 01: build the exemplar dictionary")
    _add_common(p)
    p.add_argument("--feat", default="mfcc", choices=["mfcc", "mcep"])
    p.set_defaults(fn=cmd_make_dict)

    p = sub.add_parser("conv-dicts", help="stage 03: conversion-feature dictionaries")
    _add_common(p)
    p.set_defaults(fn=cmd_conv_dicts)

    p = sub.add_parser("convert", help="stage 04: convert one utterance")
    _add_common(p)
    p.add_argument("--wav", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--synth-iters", type=int, default=None)
    p.add_argument("--ref-wav", default=None,
                   help="ground-truth target utterance; reports DTW-aligned MCD")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("demo", help="stage 05: single-utterance demo conversion")
    _add_common(p)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("warp-train", help="stage 02: train the neural warping net")
    _add_common(p)
    p.add_argument("--runs", default=None)
    p.add_argument("--features", default="dict",
                   help="'dict' (reference MFCC pairs) or a conversion "
                        "feature ('stft') for direct neural conversion")
    p.set_defaults(fn=cmd_warp_train)

    p = sub.add_parser("warp-eval", help="stage 02: evaluate the trained warping net")
    _add_common(p)
    p.add_argument("--features", default="dict",
                   help="feature set the net was trained on (see warp-train)")
    p.set_defaults(fn=cmd_warp_eval)

    p = sub.add_parser("freq-warp", help="stage 02: DFW/AMF warping estimation")
    _add_common(p)
    p.add_argument("--variant", default="amf", choices=["amf", "dfw"])
    p.set_defaults(fn=cmd_freq_warp)

    p = sub.add_parser("convert-dir", help="serving: batch-convert a directory")
    _add_common(p)
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--synth-iters", type=int, default=None)
    p.set_defaults(fn=cmd_convert_dir)

    p = sub.add_parser("eval-heldout", help="held-out quality evaluation on the "
                       "reference's own 100162 pair (04_align_n_nmf.py:439-440)")
    _add_common(p)
    p.add_argument("--configs", default=None,
                   help="comma list from {stft,world}_{parity,quality} (default all)")
    p.add_argument("--synth-iters", type=int, default=None,
                   help="Griffin-Lim iterations (STFT path)")
    p.set_defaults(fn=cmd_eval_heldout)

    p = sub.add_parser("eval-loo", help="leave-one-out evaluation: dictionaries "
                       "from the other pairs, convert + score the held-out one")
    _add_common(p)
    p.add_argument("--configs", default=None,
                   help="comma list of config names (default: the 4 canonical"
                        " + levers when --levers)")
    p.add_argument("--synth-iters", type=int, default=None)
    p.add_argument("--levers", action="store_true",
                   help="also evaluate the measured quality levers "
                        "(VTLP augmentation, harvest f0, the quality preset)")
    p.add_argument("--folds", default=None,
                   help="comma list of utterance ids to fold (default all)")
    p.add_argument("--audio-dir", default=None,
                   help="write each converted wav as {config}_{utt}.wav")
    p.set_defaults(fn=cmd_eval_loo)

    p = sub.add_parser("separate", help="multichannel NMF source separation "
                                        "(FASST-class, separate/)")
    p.add_argument("--wav", required=True, help="mixture wav (stereo, or mono duplicated)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--sources", type=int, default=2)
    p.add_argument("--components", type=int, default=8)
    p.add_argument("--em-iters", type=int, default=50)
    p.add_argument("--n-fft", type=int, default=400)
    p.add_argument("--hop", type=int, default=80)
    p.add_argument("--seed", type=int, default=0, help="seed of the PRNG key the "
                                                        "random inits are drawn from")
    _add_device(p)
    p.set_defaults(fn=cmd_separate)

    p = sub.add_parser("separate-lead", help="lead/accompaniment separation "
                                             "(SIMM / stereo SIMM / composed "
                                             "multichannel, separate/)")
    p.add_argument("--wav", required=True, help="mixture wav")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--model", default="stereo", choices=["mono", "stereo", "multichannel"])
    p.add_argument("--components", type=int, default=40,
                   help="accompaniment NMF components")
    p.add_argument("--iters", type=int, default=30, help="SIMM iterations per round")
    p.add_argument("--em-iters", type=int, default=20,
                   help="multichannel EM iterations (model=multichannel)")
    p.add_argument("--f0-min", type=float, default=100.0)
    p.add_argument("--f0-max", type=float, default=800.0)
    p.add_argument("--n-fft", type=int, default=1024)
    p.add_argument("--hop", type=int, default=256)
    p.add_argument("--seed", type=int, default=0, help="seed of the PRNG key the "
                                                        "random inits are drawn from")
    _add_device(p)
    p.set_defaults(fn=cmd_separate_lead)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
