"""Held-out and leave-one-out evaluation: the reference's own protocol (port
of ``exemplars_vc_tpu/pipelines/evaluate.py``).

The reference's conversion evaluation is fixed to utterance 100162, which is
not in the dictionary-build set; its source/target pair lies in a ``wav/``
directory beside the ``data/`` root. Converting a dictionary utterance would
be a train-on-test measurement, so the quality numbers come from here:
convert the held-out source with the bundled dictionaries and score the
DTW-aligned MCD against the true held-out target (:func:`evaluate_heldout`),
or fold every bundled pair out in turn (:func:`evaluate_loo`). The
reference's own end-to-end outputs, where a ``results/`` directory beside
``data/`` holds them, are scored as anchors too.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from exemplars_vc_tpu_torch.config import Config, load_config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.io.wav import read_wav
from exemplars_vc_tpu_torch.pipelines.convert import (
    ConversionResult,
    convert_utterance,
    mcd_between_signals,
)

log = logging.getLogger("exemplars_vc_tpu_torch")

HELD_OUT_UTT = "100162"


def heldout_pair(data_path: str, src: str = "SF1", tar: str = "TF1") -> tuple[str, str]:
    """Paths of the held-out source and target wavs, ``<root>/wav/<speaker>_100162.wav``
    with ``<root>`` the parent of ``data_path``."""
    base = os.path.join(os.path.dirname(os.path.abspath(data_path)), "wav")
    return (os.path.join(base, f"{src}_{HELD_OUT_UTT}.wav"),
            os.path.join(base, f"{tar}_{HELD_OUT_UTT}.wav"))


def reference_artifacts(data_path: str) -> dict[str, str]:
    """The reference's committed end-to-end conversion outputs that exist
    under ``<root>/results/``."""
    base = os.path.join(os.path.dirname(os.path.abspath(data_path)), "results")
    out = {}
    for name, fn in (("ref_demo_world", "demo_1_norefined_world.wav"),
                     ("ref_org_world", "org_world.wav")):
        p = os.path.join(base, fn)
        if os.path.isfile(p):
            out[name] = p
    return out


@dataclass
class HeldOutScore:
    name: str                      # config label, e.g. "stft_quality"
    mcd: float                     # DTW-aligned MCD vs the held-out target (dB)
    vs_reference_outputs: dict[str, float]   # MCD vs committed ref artifacts
    result: ConversionResult


def _configs(cfg: Config) -> dict[str, Config]:
    """The four canonical evaluation configs: each synthesis path with the
    reference-parity solver and with the quality settings chosen by held-out
    measurement: the KL β-loss, no context frames, and on the WORLD path the
    magnitude-domain sp solve without the residual."""
    stft = replace(cfg, data=replace(cfg.data, use_stft=True))
    world = replace(cfg, data=replace(cfg.data, use_stft=False))

    def kl(c):
        return replace(c, nmf=replace(c.nmf, beta_loss="kullback-leibler", context_frames=0))

    wq = kl(world)
    wq = replace(wq, world=replace(wq.world, sp_domain="magnitude"),
                 nmf=replace(wq.nmf, use_residual="off"))
    return {"stft_parity": stft, "stft_quality": kl(stft),
            "world_parity": world, "world_quality": wq}


def evaluate_heldout(cfg: Config, store: ArtifactStore, data_path: str,
                     nb_file: int | None = None, configs: list[str] | None = None,
                     synth_iters: int | None = None, compare_reference_outputs: bool = True,
                     *, device: str | torch.device = "cuda") -> dict[str, HeldOutScore]:
    """Convert the held-out 100162 source with the bundled dictionaries on
    ``device`` and score each requested config: {config_name: HeldOutScore}."""
    device = resolve_device(device)
    src_wav, tar_wav = heldout_pair(data_path, cfg.data.src, cfg.data.tar)
    if not (os.path.isfile(src_wav) and os.path.isfile(tar_wav)):
        raise FileNotFoundError(
            f"held-out pair not found next to {data_path}: {src_wav}, {tar_wav}")
    refs = reference_artifacts(data_path) if compare_reference_outputs else {}
    ref_sigs = {k: read_wav(p)[0] for k, p in refs.items()}
    all_cfgs = _configs(cfg)
    scores: dict[str, HeldOutScore] = {}
    for name in configs if configs is not None else list(all_cfgs):
        c = all_cfgs[name]
        res = convert_utterance(c, store, data_path, src_wav, nb_file=nb_file,
                                synth_iters=synth_iters, reference_wav=tar_wav, device=device)
        vs_ref = {k: float(mcd_between_signals(res.audio, sig, c, device))
                  for k, sig in ref_sigs.items()}
        scores[name] = HeldOutScore(name=name, mcd=float(res.mcd_vs_reference),
                                    vs_reference_outputs=vs_ref, result=res)
        log.info("held-out %s: MCD %.2f dB vs target%s", name, scores[name].mcd,
                 "".join(f", {k}={v:.2f}" for k, v in vs_ref.items()))
    return scores


def lever_configs(cfg: Config) -> dict[str, Config]:
    """The quality levers re-checked fold-averaged in the LOO protocol: VTLP
    dictionary augmentation on the STFT quality config, the reference's
    Harvest f0 on both WORLD configs, and the ``quality`` preset (KL, four
    VTLP warps, h_smooth=2) as an evaluation config."""
    base = _configs(cfg)
    vtlp = replace(base["stft_quality"],
                   data=replace(base["stft_quality"].data, dict_augment_warps="0.9,1.1"))
    harvest = replace(base["world_parity"],
                      world=replace(base["world_parity"].world, f0_method="harvest"))
    wq_harvest = replace(base["world_quality"],
                         world=replace(base["world_quality"].world, f0_method="harvest"))
    preset = load_config(preset="quality")
    preset = replace(base["stft_quality"],
                     data=replace(base["stft_quality"].data,
                                  dict_augment_warps=preset.data.dict_augment_warps),
                     nmf=replace(base["stft_quality"].nmf,
                                 beta_loss=preset.nmf.beta_loss,
                                 context_frames=preset.nmf.context_frames,
                                 h_smooth=preset.nmf.h_smooth))
    return {"stft_quality_vtlp": vtlp, "stft_preset": preset,
            "world_parity_harvest": harvest, "world_quality_harvest": wq_harvest}


@dataclass
class LooFold:
    utt: str                       # held-out utterance id, e.g. "100003"
    mcd: dict[str, float]          # config name → MCD vs true target (dB)
    no_conversion_mcd: float       # do-nothing anchor for this fold


def loo_utterances(data_path: str, src: str, tar: str) -> list[str]:
    """Utterance ids present for both speakers: the foldable pairs."""
    def ids(spk):
        d = os.path.join(data_path, spk)
        return {os.path.splitext(n)[0] for n in os.listdir(d) if n.lower().endswith(".wav")}

    return sorted(ids(src) & ids(tar))


def _fold_data_dir(root: str, data_path: str, cfg: Config, utt: str) -> str:
    """A data directory with every pair except ``utt``: per-speaker
    directories of symlinks into the real corpus, which the pipeline reads
    as it reads the real data root."""
    fold = os.path.join(root, "loo", f"data_wo_{utt}")
    for spk in (cfg.data.src, cfg.data.tar):
        d = os.path.join(fold, spk)
        os.makedirs(d, exist_ok=True)
        src_dir = os.path.join(os.path.abspath(data_path), spk)
        for n in sorted(os.listdir(src_dir)):
            if not n.lower().endswith(".wav") or os.path.splitext(n)[0] == utt:
                continue
            link = os.path.join(d, n)
            if not os.path.islink(link):
                os.symlink(os.path.join(src_dir, n), link)
    return fold


def evaluate_loo(cfg: Config, store: ArtifactStore, data_path: str,
                 configs: list[str] | None = None, synth_iters: int | None = None,
                 include_levers: bool = False, folds: list[str] | None = None,
                 audio_dir: str | None = None, *, device: str | torch.device = "cuda"
                 ) -> tuple[list[LooFold], dict[str, dict[str, float]]]:
    """Leave-one-out evaluation over the bundled pairs on ``device``.

    For each utterance id present for both speakers (or each of ``folds``),
    build the dictionaries from the other pairs (a symlinked fold data
    directory and a store subtree of its own) and convert the held-out
    source, scored by DTW-aligned MCD against its true target. Returns the
    folds and ``summary[name]``: mean, std (ddof 1), n, the no-conversion
    anchor's mean and the folds beating it. ``audio_dir`` keeps each
    converted wav as ``{config}_{utt}.wav``."""
    device = resolve_device(device)
    all_cfgs = _configs(cfg)
    if include_levers:
        all_cfgs.update(lever_configs(cfg))
    names = configs if configs is not None else list(all_cfgs)
    utts = loo_utterances(data_path, cfg.data.src, cfg.data.tar)
    if folds is not None:
        utts = [u for u in utts if u in set(folds)]
    if not utts:
        raise FileNotFoundError(f"no foldable pairs under {data_path}")
    if audio_dir is not None:
        os.makedirs(audio_dir, exist_ok=True)

    results: list[LooFold] = []
    for utt in utts:
        fold_data = _fold_data_dir(store.root, data_path, cfg, utt)
        fold_store = ArtifactStore(os.path.join(store.root, "loo", f"store_wo_{utt}"))
        src_wav = os.path.join(data_path, cfg.data.src, f"{utt}.wav")
        tar_wav = os.path.join(data_path, cfg.data.tar, f"{utt}.wav")
        a, _ = read_wav(src_wav)
        b, _ = read_wav(tar_wav)
        anchor = float(mcd_between_signals(a, b, cfg, device))
        per: dict[str, float] = {}
        for name in names:
            out = (os.path.join(audio_dir, f"{name}_{utt}.wav")
                   if audio_dir is not None else None)
            res = convert_utterance(all_cfgs[name], fold_store, fold_data, src_wav,
                                    out_path=out, synth_iters=synth_iters,
                                    reference_wav=tar_wav, device=device)
            per[name] = float(res.mcd_vs_reference)
        results.append(LooFold(utt=utt, mcd=per, no_conversion_mcd=anchor))
        log.info("LOO fold %s: anchor %.2f dB, %s", utt, anchor,
                 ", ".join(f"{k}={v:.2f}" for k, v in per.items()))

    summary: dict[str, dict[str, float]] = {}
    anchors = np.asarray([f.no_conversion_mcd for f in results])
    for name in names:
        vals = np.asarray([f.mcd[name] for f in results])
        summary[name] = {
            "mean": float(vals.mean()),
            "std": float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
            "n": len(vals),
            "anchor_mean": float(anchors.mean()),
            "folds_beating_anchor": int((vals < anchors).sum()),
        }
    return results, summary


def no_conversion_baseline(cfg: Config, data_path: str,
                           *, device: str | torch.device = "cuda") -> float:
    """MCD of the unconverted held-out source vs the held-out target: the
    do-nothing anchor every conversion config must beat."""
    device = resolve_device(device)
    src_wav, tar_wav = heldout_pair(data_path, cfg.data.src, cfg.data.tar)
    a, _ = read_wav(src_wav)
    b, _ = read_wav(tar_wav)
    return float(mcd_between_signals(a, b, cfg, device))
