"""Exemplar conversion of one utterance, STFT path (port of
``exemplars_vc_tpu/pipelines/convert.py``).

1. build the exemplar dictionaries A (source) / B (target) along the DTW
   paths (:func:`_aligned_dicts`),
2. solve the fixed-dictionary MU NMF of the input's |STFT| over A,
3. convert Y = H·B,
4. resynthesize with Griffin-Lim seeded with the input's own phase,
5. optionally score the DTW-aligned MCD against a reference utterance.

Only the default configuration's levers are ported; any other raises
``NotImplementedError`` naming its ROADMAP item. The entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; without a
card the default raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from exemplars_vc_tpu_torch.align.exemplar import build_exemplar_dicts_padded
from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
from exemplars_vc_tpu_torch.dsp.mcep import mcep
from exemplars_vc_tpu_torch.factorize.nmf import (
    NmfState,
    convert_features,
    nmf_activations,
    residual_compensation,
)
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav
from exemplars_vc_tpu_torch.obs.metrics import mcd_aligned
from exemplars_vc_tpu_torch.obs.profiling import Timer
from exemplars_vc_tpu_torch.pipelines.conv_dicts import (
    build_conversion_dicts_pair,
    extract_stft_complex,
)
from exemplars_vc_tpu_torch.pipelines.make_dict import make_dictionary

log = logging.getLogger("exemplars_vc_tpu_torch")


@dataclass
class ConversionResult:
    audio: np.ndarray
    sr: int
    converted: dict[str, torch.Tensor]   # device tensors; .cpu() on demand
    n_iter: int
    nmf_error: float
    timings: dict[str, float] = field(default_factory=dict)
    mcd_vs_reference: float | None = None
    nmf_shape: tuple[int, int, int] = (0, 0, 0)   # (F, K, D) of the solve


def _check_slice(cfg: Config) -> None:
    """Raise for every lever this slice does not port."""
    d, n = cfg.data, cfg.nmf
    unported = [
        (not d.use_stft, "data.use_stft=False (WORLD path)", 10),
        (d.dict_hop_divisor > 1, "data.dict_hop_divisor>1", 8),
        (bool(d.dict_augment_warps), "data.dict_augment_warps", 8),
        (d.dict_prune_frac > 0, "data.dict_prune_frac", 8),
        (n.solve_domain != "linear", "nmf.solve_domain", 8),
        (n.context_frames > 0, "nmf.context_frames", 8),
        (n.normalize_exemplars, "nmf.normalize_exemplars", 8),
        (n.prune_topk > 0, "nmf.prune_topk", 8),
        (n.activation_power != 1.0, "nmf.activation_power", 8),
        (n.h_smooth > 0, "nmf.h_smooth", 8),
        (n.solver == "mu_sharded", "nmf.solver='mu_sharded'", 12),
        (n.solver not in ("auto", "mu", "mu_pallas", "mu_sharded"),
         f"nmf.solver={n.solver!r}", 8),
        (n.work_dtype != "float32", "nmf.work_dtype", 9),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item {item})")


def mcd_between_signals(a: np.ndarray, b: np.ndarray, cfg: Config,
                        device: str | torch.device = "cuda") -> float:
    """DTW-aligned mel-cepstral distortion (dB) between two waveforms."""
    device = resolve_device(device)
    m = cfg.mcep
    ca, cb = (mcep(torch.as_tensor(np.asarray(s, np.float32), device=device),
                   frame_length=m.frame_length, hop_length=m.hop_length,
                   order=m.order, alpha=m.alpha) for s in (a, b))
    return float(mcd_aligned(ca, cb))


def _aligned_dicts(cfg: Config, store: ArtifactStore, data_path: str,
                   nb_file: int | None, device: torch.device):
    """Exemplar dictionaries {name: (A, B)} gathered along the DTW paths, K
    padded with zero rows to a multiple of 512."""
    art = make_dictionary(cfg, store, data_path, nb_file=nb_file, device=device)
    src_feats, tar_feats = build_conversion_dicts_pair(
        cfg, store, data_path, cfg.data.src, cfg.data.tar, nb_file=nb_file, device=device)
    k_true = int(art.path_len.sum())
    k_pad = ((k_true + 511) // 512) * 512
    dicts = {name: build_exemplar_dicts_padded(src_feats.feats[name], tar_feats.feats[name],
                                               art.path_i, art.path_j, k_pad=k_pad)
             for name in src_feats.feats}
    return dicts, src_feats.kind


def _solve_activations(X: torch.Tensor, A: torch.Tensor, cfg: Config) -> NmfState:
    """The default solver: sklearn-parity MU (``auto`` and ``mu``); on the
    card the Frobenius update runs the recon/update kernels. ``mu_pallas``
    runs the same MU, as the reference's Pallas solver does, which takes
    neither ``beta_loss`` nor ``sparsity_l1``: Frobenius without l1."""
    n = cfg.nmf
    pallas = n.solver == "mu_pallas"
    return nmf_activations(X, A, beta_loss="frobenius" if pallas else n.beta_loss, tol=n.tol,
                           max_iter=n.max_iter, l1=0.0 if pallas else n.sparsity_l1)


def convert_utterance(cfg: Config, store: ArtifactStore, data_path: str, wav_path: str,
                      out_path: str | None = None, nb_file: int | None = None,
                      use_residual: bool | None = None, synth_iters: int | None = None,
                      reference_wav: str | None = None, sync_stages: bool = False,
                      *, device: str | torch.device = "cuda") -> ConversionResult:
    """Convert one utterance on ``device`` (see the module docstring).

    ``sync_stages=True`` fences the device around each stage so the timings
    ("dicts", "features", "nmf_solve", "synthesis") are device times;
    otherwise a stage's queued work may drain inside a later one."""
    device = resolve_device(device)
    _check_slice(cfg)
    timings: dict[str, float] = {}
    m = cfg.mcep

    with Timer(device, sync_stages) as t:
        dicts, _ = _aligned_dicts(cfg, store, data_path, nb_file, device)
    timings["dicts"] = t.elapsed

    x, sr = read_wav(wav_path)
    with Timer(device, sync_stages) as t:
        S_in = extract_stft_complex(x, cfg, device)
        X = torch.abs(S_in)
    timings["features"] = t.elapsed

    with Timer(device, sync_stages) as t:
        A, B = dicts["stft"]
        st = _solve_activations(X, A, cfg)
        R = (residual_compensation(X, st.H, A, mode=cfg.nmf.residual_mode)
             if use_residual else None)
        Y = convert_features(st.H, B, R)
    timings["nmf_solve"] = t.elapsed
    F, D = X.shape
    K = A.shape[0]
    log.info("NMF[stft]: F=%d K=%d D=%d iters=%d err=%.3g", F, K, D, st.n_iter,
             float(st.error))

    with Timer(device, sync_stages) as t:
        iters = synth_iters if synth_iters is not None else cfg.nmf.griffin_lim_iters
        if cfg.nmf.gl_init == "source":
            y = griffin_lim(Y, n_fft=m.frame_length, hop_length=m.hop_length,
                            n_iter=iters, length=len(x), init_phase=S_in)
        else:
            gen = torch.Generator(device=device).manual_seed(0)
            y = griffin_lim(Y, n_fft=m.frame_length, hop_length=m.hop_length,
                            n_iter=iters, length=len(x), generator=gen)
        audio = y.cpu().numpy()
    timings["synthesis"] = t.elapsed

    if out_path is not None:
        write_wav(out_path, audio, sr)
    mcd_val = None
    if reference_wav is not None:
        ref_sig, _ = read_wav(reference_wav)
        mcd_val = mcd_between_signals(audio, ref_sig, cfg, device)
        log.info("MCD vs %s: %.2f dB", reference_wav, mcd_val)

    return ConversionResult(audio=audio, sr=sr, converted={"stft": Y},
                            n_iter=st.n_iter, nmf_error=float(st.error),
                            timings=timings, mcd_vs_reference=mcd_val,
                            nmf_shape=(F, K, D))
