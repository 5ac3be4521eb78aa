"""Stage 02: frequency-warping estimation (port of
``exemplars_vc_tpu/pipelines/freq_warp.py``).

- :func:`amf_warping`: per aligned frame pair, the LSP line frequencies of
  source and target anchor a piecewise-linear warping ω_tar = w(ω_src).
- :func:`dfw_warping`: dynamic frequency warping, a DTW *along the frequency
  axis* of aligned log-spectrum pairs, run as a batch of 1-dim "sequences"
  through :func:`~exemplars_vc_tpu_torch.align.dtw.dtw_batch` (the DTW
  kernels on the card).
- :func:`apply_warping`: resample a spectrum along a warping function.
- :func:`run_freq_warp`: the stage's entry, persisting the warpings.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from exemplars_vc_tpu_torch.align.dtw import dtw_batch
from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.lpc import lpc, lpc_to_lsp
from exemplars_vc_tpu_torch.dsp.stft import frame_signal
from exemplars_vc_tpu_torch.dsp.windows import get_window
from exemplars_vc_tpu_torch.io.store import ArtifactStore, load_speaker
from exemplars_vc_tpu_torch.pipelines.conv_dicts import build_conversion_dicts
from exemplars_vc_tpu_torch.pipelines.make_dict import make_dictionary

log = logging.getLogger("exemplars_vc_tpu_torch")


def _interp_monotone(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for a sorted 1-D ``xp``: linear between the
    bracketing points (the right one found by ``searchsorted(side='right')``),
    a zero-width bracket takes its left value, and outside [xp[0], xp[-1]]
    the end values (JAX's default edge rule: clamp, no extrapolation)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (x - xp[i - 1]) / torch.where(dx0, 1.0, dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def amf_warping(frames_src: torch.Tensor, frames_tar: torch.Tensor,
                order: int = 20) -> torch.Tensor:
    """Aligned raw frame pairs (N, frame_length) → anchor pairs (N, 2, order+2):
    ω_src and ω_tar of the hamming-windowed frames' LSPs, with the end points
    0 and π."""
    n = frames_src.shape[-1]
    w = get_window("hamming", n, periodic=False, device=frames_src.device,
                   dtype=frames_src.dtype)
    lsp_s = lpc_to_lsp(lpc(frames_src * w, order=order))
    lsp_t = lpc_to_lsp(lpc(frames_tar * w, order=order))
    zeros = torch.zeros(lsp_s.shape[:-1] + (1,), dtype=lsp_s.dtype, device=lsp_s.device)
    pis = torch.full_like(zeros, math.pi)
    anchors_src = torch.cat([zeros, lsp_s, pis], dim=-1)
    anchors_tar = torch.cat([zeros, lsp_t, pis], dim=-1)
    return torch.stack([anchors_src, anchors_tar], dim=-2)


def apply_warping(spec: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Warp a spectrum (n_bins,) with anchor pairs (2, P): resample the source
    spectrum at the inverse-warped frequency of every output bin."""
    n_bins = spec.shape[-1]
    omega = torch.linspace(0.0, math.pi, n_bins, dtype=spec.dtype, device=spec.device)
    src_of_tar = _interp_monotone(omega, anchors[1], anchors[0])
    pos = src_of_tar / math.pi * (n_bins - 1)
    lo = torch.clamp(torch.floor(pos).long(), 0, n_bins - 1)
    hi = torch.clamp(lo + 1, 0, n_bins - 1)
    frac = pos - lo
    return spec[lo] * (1.0 - frac) + spec[hi] * frac


def dfw_warping(spec_src: torch.Tensor, spec_tar: torch.Tensor,
                eps: float = 1e-8) -> tuple[np.ndarray, np.ndarray]:
    """Time-aligned magnitude spectrum pairs (N, n_bins) → their frequency
    warping paths (path_bins_src (N, P), path_bins_tar (N, P)), −1 padded:
    each pair's log-spectra DTW-aligned along the frequency axis."""
    n, b = spec_src.shape
    ls = torch.log(torch.clamp(spec_src, min=eps))[..., None]   # (N, bins, 1)
    lt = torch.log(torch.clamp(spec_tar, min=eps))[..., None]
    lens = np.full((n,), b, dtype=np.int32)
    r = dtw_batch(ls, lt, lens, lens)
    return r.path_i.cpu().numpy(), r.path_j.cpu().numpy()


def warping_curve_from_path(path_i: np.ndarray, path_j: np.ndarray, n_bins: int) -> np.ndarray:
    """Collapse a DFW path to a function tar_bin(src_bin): the path's mean j
    for each i (host-side, small)."""
    curve = np.zeros(n_bins)
    counts = np.zeros(n_bins)
    valid = path_i >= 0
    np.add.at(curve, path_i[valid], path_j[valid])
    np.add.at(counts, path_i[valid], 1)
    return curve / np.maximum(counts, 1)


def _pick_pairs(path_len: np.ndarray, max_pairs: int, rng: np.random.Generator):
    """For each utterance pair with a path, the path positions to sample:
    ``max_pairs // N + 1`` of them (or all), drawn without replacement in
    pair order, as the JAX package draws them."""
    n_pairs = path_len.shape[0]
    for n in range(n_pairs):
        ln = int(path_len[n])
        if ln:
            yield n, rng.choice(ln, size=min(ln, max_pairs // n_pairs + 1), replace=False)


def run_freq_warp(cfg: Config, store: ArtifactStore, data_path: str, variant: str = "amf",
                  nb_file: int | None = None, max_pairs: int = 512,
                  *, device: str | torch.device = "cuda") -> dict[str, np.ndarray]:
    """Stage-02 entry: estimate frequency warpings over the aligned parallel
    set on ``device`` and persist them under a ``_torch`` key.

    variant='amf': hamming→LPC→LSP anchors for up to ``max_pairs`` aligned
    raw-frame pairs; stores the anchors and their mean. variant='dfw':
    frequency-axis DTW of up to ``max_pairs`` aligned |STFT| pairs; stores
    each pair's warping curve and their mean."""
    device = resolve_device(device)
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    key = f"freq_warp_{variant}_{cfg.data.src}2{cfg.data.tar}_{nb}_torch"
    if store.has(key):
        return store.load(key)
    if variant not in ("amf", "dfw"):
        raise ValueError(f"unknown warping variant {variant!r}")

    art = make_dictionary(cfg, store, data_path, nb_file=nb, device=device)
    path_i, path_j = art.path_i.cpu().numpy(), art.path_j.cpu().numpy()
    picks = list(_pick_pairs(art.path_len.numpy(), max_pairs, np.random.default_rng(0)))

    if variant == "amf":
        m = cfg.mcep
        src_sigs, _ = load_speaker(data_path, cfg.data.src, nb_file=nb, cpu_rate=cfg.misc.cpu_rate)
        tar_sigs, _ = load_speaker(data_path, cfg.data.tar, nb_file=nb, cpu_rate=cfg.misc.cpu_rate)
        fa, fb = [], []
        for n, take in picks:
            frames_a, frames_b = (
                frame_signal(torch.as_tensor(s[n], dtype=torch.float32),
                             m.frame_length, m.hop_length).numpy()
                for s in (src_sigs, tar_sigs))
            fa.append(frames_a[np.clip(path_i[n, take], 0, frames_a.shape[0] - 1)])
            fb.append(frames_b[np.clip(path_j[n, take], 0, frames_b.shape[0] - 1)])
        FA, FB = (torch.as_tensor(np.concatenate(f)[:max_pairs], device=device) for f in (fa, fb))
        anchors = amf_warping(FA, FB, order=20).cpu().numpy()
        result = {"anchors": anchors, "mean_anchors": anchors.mean(axis=0)}
    else:
        sa, sb = [], []
        src_f, tar_f = (build_conversion_dicts(cfg, store, data_path, spk, nb_file=nb,
                                               device=device).feats["stft"].cpu().numpy()
                        for spk in (cfg.data.src, cfg.data.tar))
        for n, take in picks:
            sa.append(src_f[n][np.clip(path_i[n, take], 0, src_f.shape[1] - 1)])
            sb.append(tar_f[n][np.clip(path_j[n, take], 0, tar_f.shape[1] - 1)])
        SA, SB = (torch.as_tensor(np.concatenate(s)[:max_pairs], dtype=torch.float32,
                                  device=device) for s in (sa, sb))
        pi, pj = dfw_warping(SA, SB)
        n_bins = SA.shape[1]
        curves = np.stack([warping_curve_from_path(pi[i], pj[i], n_bins)
                           for i in range(pi.shape[0])])
        result = {"curves": curves, "mean_curve": curves.mean(axis=0)}

    store.save(key, **result)
    log.info("freq-warp[%s]: saved %s", variant, key)
    return result
