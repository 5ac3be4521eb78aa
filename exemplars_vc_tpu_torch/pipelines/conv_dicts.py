"""Per-speaker conversion-feature dictionaries (port of
``exemplars_vc_tpu/pipelines/conv_dicts.py``): the |STFT| of every
utterance of a speaker (``data.use_stft``, the default), or its WORLD
sp / ap / f0 (the WORLD path), in the store's padded (N, T, D) layout."""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace

import numpy as np
import torch

from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.stft import stft
from exemplars_vc_tpu_torch.io.store import ArtifactStore, bucketed_signal, load_speaker
from exemplars_vc_tpu_torch.pipelines.make_dict import (
    host_copies,
    pad_signals,
    speaker_batch,
    trim_and_mask,
)
from exemplars_vc_tpu_torch.world.analysis import analyze

log = logging.getLogger("exemplars_vc_tpu_torch")


@dataclass
class ConversionFeatures:
    kind: str                        # "stft" | "world"
    feats: dict[str, torch.Tensor]   # padded (N, T, D) per feature name
    lens: np.ndarray                 # (N,) true frame counts


def extract_stft_complex(sig: np.ndarray, cfg: Config,
                         device: str | torch.device = "cuda") -> torch.Tensor:
    """Complex STFT (F, bins) of one utterance: the signal is zero-padded to
    the frame bucket, as the dictionaries are, then cut to 1 + len // hop
    frames."""
    device = resolve_device(device)
    m = cfg.mcep
    padded, true_frames = bucketed_signal(sig, m.hop_length, cfg.data.frame_bucket)
    x = torch.as_tensor(padded.astype(np.float32), device=device)
    S = stft(x, n_fft=m.frame_length, hop_length=m.hop_length, window=m.window)
    return S[:true_frames]


def extract_stft_features(sig: np.ndarray, cfg: Config,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """|STFT| (F, bins) of one utterance on :func:`extract_stft_complex`'s grid."""
    return torch.abs(extract_stft_complex(sig, cfg, device))


def extract_stft_features_stacked(sigs: list[np.ndarray], cfg: Config,
                                  device: str | torch.device = "cuda"):
    """Every utterance's |STFT| in one batched call: (N, T_pad, bins)
    magnitudes on ``device`` and the true frame counts (N,) as int32.

    The signals are zero-padded to one length, a multiple of hop ×
    ``data.frame_bucket`` samples, so T_pad = 1 + that length // hop; the
    frames at and beyond each utterance's 1 + samples // hop are zeroed
    (the store's padded layout)."""
    device = resolve_device(device)
    m = cfg.mcep
    batch = pad_signals(sigs, m.hop_length * cfg.data.frame_bucket)
    lens = np.asarray([1 + len(s) // m.hop_length for s in sigs], np.int32)
    mags = torch.abs(stft(torch.as_tensor(batch, device=device), n_fft=m.frame_length,
                          hop_length=m.hop_length, window=m.window))
    return trim_and_mask(mags, mags.shape[1], torch.as_tensor(lens, device=device)), lens


def extract_stft_features_batch(sigs: list[np.ndarray], cfg: Config,
                                device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """:func:`extract_stft_features_stacked` cut into one (F_i, bins)
    magnitude an utterance."""
    stacked, lens = extract_stft_features_stacked(sigs, cfg, device)
    return [stacked[i, : lens[i]] for i in range(len(sigs))]


def build_conversion_dicts_pair(cfg: Config, store: ArtifactStore, data_path: str,
                                src: str, tar: str, nb_file: int | None = None,
                                *, device: str | torch.device = "cuda"):
    """Both speakers' |STFT| batches in one batched call.

    The two padded signal batches are padded to a common length and
    transformed together; each is cut back to 1 + its own padded length // hop
    frames and masked beyond each utterance's 1 + samples // hop frames.
    ``store`` is unused there: the STFT batch is recomputed, never
    persisted (as in the JAX package). The WORLD path builds each speaker's
    features with :func:`build_conversion_dicts`, which persists them."""
    device = resolve_device(device)
    if not cfg.data.use_stft:
        return (build_conversion_dicts(cfg, store, data_path, src, nb_file, device=device),
                build_conversion_dicts(cfg, store, data_path, tar, nb_file, device=device))
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    m = cfg.mcep
    step = m.hop_length * cfg.data.frame_bucket
    A, sa = speaker_batch(data_path, src, nb, step, cfg.misc.cpu_rate)
    B, sb = speaker_batch(data_path, tar, nb, step, cfg.misc.cpu_rate)
    la = (1 + sa // m.hop_length).astype(np.int32)
    lb = (1 + sb // m.hop_length).astype(np.int32)
    ta, tb = A.shape[1], B.shape[1]
    x = np.zeros((A.shape[0] + B.shape[0], max(ta, tb)), np.float32)
    x[: A.shape[0], :ta] = A
    x[A.shape[0]:, :tb] = B
    mags = torch.abs(stft(torch.as_tensor(x, device=device), n_fft=m.frame_length,
                          hop_length=m.hop_length, window=m.window))
    SA = trim_and_mask(mags[: A.shape[0]], 1 + ta // m.hop_length,
                       torch.as_tensor(la, device=device))
    SB = trim_and_mask(mags[A.shape[0]:], 1 + tb // m.hop_length,
                       torch.as_tensor(lb, device=device))
    return (ConversionFeatures(kind="stft", feats={"stft": SA}, lens=la),
            ConversionFeatures(kind="stft", feats={"stft": SB}, lens=lb))


def _world_hop(cfg: Config) -> int:
    return int(round(cfg.data.sr * cfg.world.frame_period_ms / 1000.0))


def extract_world_features_stacked(sigs: list[np.ndarray], cfg: Config,
                                   device: str | torch.device = "cuda"):
    """WORLD sp / ap / f0 of every utterance in one batched analysis.

    The signals are zero-padded to one length, a multiple of hop ×
    ``data.frame_bucket`` samples, and analysed together: the f0
    estimators take the mean and size their event buffers over the padded
    signal, as the reference's ``vmap`` does. Returns ({"sp", "ap": (N,
    T_pad, fft/2+1), "f0": (N, T_pad, 1)} with the frames at and beyond each
    utterance's len // hop + 1 zeroed, lens (N,))."""
    device = resolve_device(device)
    w = cfg.world
    hop = _world_hop(cfg)
    batch = pad_signals(sigs, hop * cfg.data.frame_bucket)
    lens = np.asarray([len(s) // hop + 1 for s in sigs], np.int32)
    t_pad = ((int(lens.max()) + cfg.data.frame_bucket - 1)
             // cfg.data.frame_bucket) * cfg.data.frame_bucket
    res = analyze(torch.as_tensor(batch, device=device), sr=cfg.data.sr,
                  frame_period_ms=w.frame_period_ms, f0_floor=w.f0_floor, f0_ceil=w.f0_ceil,
                  fft_size=w.fft_size, refine_f0=w.f0_is_refined, f0_method=w.f0_method)
    lens_d = torch.as_tensor(lens, device=device)
    return ({"sp": trim_and_mask(res.sp, t_pad, lens_d),
             "ap": trim_and_mask(res.ap, t_pad, lens_d),
             "f0": trim_and_mask(res.f0[..., None], t_pad, lens_d)}, lens)


def extract_world_features(sig: np.ndarray, cfg: Config,
                           device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """WORLD features of one utterance, {"sp", "ap": (n, fft/2+1), "f0":
    (n, 1)} with n = len // hop + 1, through the batched analysis with a
    frame bucket 8× coarser, exactly as the reference pads a single input
    (the padding decides the f0 track)."""
    coarse = replace(cfg, data=replace(cfg.data, frame_bucket=cfg.data.frame_bucket * 8))
    feats, _ = extract_world_features_stacked([sig], coarse, device)
    n = len(sig) // _world_hop(cfg) + 1
    return {name: feats[name][0, :n] for name in ("sp", "ap", "f0")}


def conversion_features_key(cfg: Config, speaker: str, nb: int) -> str:
    """The store key of a speaker's conversion features, the reference's:
    a non-reference hop (or frame period) and a non-default f0 estimator
    get keys of their own, so a harvest configuration never reuses
    DIO-extracted features."""
    kind = "stft" if cfg.data.use_stft else "world"
    if kind == "stft":
        tag = "" if cfg.mcep.hop_length == 80 else f"_h{cfg.mcep.hop_length}"
    else:
        fp = cfg.world.frame_period_ms
        tag = "" if fp == 5.0 else f"_fp{fp:g}"
        if cfg.world.f0_method != "dio":
            tag += f"_{cfg.world.f0_method}"
    return f"conv_feats_{speaker}_{kind}_{nb}{tag}"


def build_conversion_dicts(cfg: Config, store: ArtifactStore, data_path: str, speaker: str,
                           nb_file: int | None = None, *,
                           device: str | torch.device = "cuda") -> ConversionFeatures:
    """Build (or load) one speaker's conversion-feature dictionary, the
    reference's ``{spk}_feat_stft.pkl`` / ``{spk}_feat_sp_ap_f0.pkl``. The
    |STFT| batch is recomputed on every call (never persisted, as in the
    reference); the WORLD features are analysed once and kept in ``store``
    under :func:`conversion_features_key` (copied to pinned host memory on
    a side stream for the store's writer), and a later call loads them onto
    ``device``."""
    device = resolve_device(device)
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    kind = "stft" if cfg.data.use_stft else "world"
    key = conversion_features_key(cfg, speaker, nb)
    if kind == "world" and store.has(key):
        log.info("conversion-feature cache hit: %s", key)
        z = store.load(key)
        lens = z.pop("lens")
        return ConversionFeatures(kind=kind, lens=lens, feats={
            name: torch.as_tensor(a, dtype=torch.float32, device=device)
            for name, a in z.items()})
    sigs, _ = load_speaker(data_path, speaker, nb_file=nb, cpu_rate=cfg.misc.cpu_rate)
    if kind == "stft":
        mags, lens = extract_stft_features_stacked(sigs, cfg, device)
        return ConversionFeatures(kind=kind, feats={"stft": mags}, lens=lens)
    feats, lens = extract_world_features_stacked(sigs, cfg, device)
    store.save(key, **host_copies(dict(feats, lens=lens)))
    return ConversionFeatures(kind=kind, feats=feats, lens=lens)
