"""Lead / accompaniment separation (SIMM) — pyfasst's SeparateLeadStereo
(port of ``exemplars_vc_tpu/separate/lead.py``; pyfasst
``SeparateLeadStereo/SeparateLeadStereoTF.py``, ``SIMM/SIMM.py``,
``separateLeadFunctions.py``).

Durrieu's Smoothed Instantaneous Mixture Model: the lead voice is a
source/filter product (a fixed dictionary of harmonic-comb source spectra
WF0 weighted per frame, times a smooth filter), the accompaniment a free
NMF, fitted by IS-divergence multiplicative updates (``isnmf.sf_nmf``); the
main melody is decoded from the F0 activations by Viterbi tracking
(``align.viterbi``); a second pass restricts the F0 activations to a band
around the melody; Wiener masks resynthesize lead and accompaniment.

The dictionaries (``harmonic_dictionary``, ``hann_filter_basis``) and the
melody transition matrix are host float32 numpy, moved to the device once a
call. The model input is the host float64 power spectrogram of
``separate.glue``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.device import resolve_device

_EPS = 1e-10


class LeadSeparation(NamedTuple):
    """lead/accomp: (C, T) source estimates; f0: (N,) tracked melody in Hz
    (0 where unvoiced); f0_candidates: (P,) the candidate grid; HF0: (P, N)
    final F0 activations."""

    lead: torch.Tensor
    accomp: torch.Tensor
    f0: np.ndarray
    f0_candidates: np.ndarray
    HF0: torch.Tensor


def klglott88_amplitudes(n_harmonics: int, open_quotient: float = 0.5,
                         oversample: int = 4096) -> np.ndarray:
    """|a_h| of the KLGLOTT88 glottal flow derivative, h = 1..n_harmonics.

    The source model behind pyfasst's F0 dictionary
    (``separateLeadFunctions.py``: ``generateODGDspec``, Ot=0.5 as passed at
    ``audioModel.py:2621``): the flow is the cubic pulse
    U(τ) ∝ 27/4·(τ/Ot)²·(1 − τ/Ot) on τ ∈ [0, Ot], 0 elsewhere; the ODGD's
    h-th Fourier coefficient is i·2π·h times the flow's, evaluated with one
    FFT of a finely sampled period. The ODGD peaks at h=2, the raw flow at
    h=1.
    """
    tau = np.arange(oversample) / oversample
    r = tau / open_quotient
    flow = np.where(tau < open_quotient, 27.0 / 4.0 * r * r * (1.0 - r), 0.0)
    spec = np.fft.rfft(flow) / oversample
    h = np.arange(1, n_harmonics + 1)
    amps = np.abs(spec[1 : n_harmonics + 1]) * h   # d/dτ ⇒ ×(2π h), const. dropped
    return (amps / max(amps.max(), 1e-30)).astype(np.float32)


def harmonic_dictionary(
    f0_grid: np.ndarray,
    n_fft: int,
    sample_rate: float,
    n_harmonics: int = 30,
    decay: float = 1.2,
    lobe_bins: float = 1.3,
    source: str = "decay",
    open_quotient: float = 0.5,
    chirp_per_f0: int = 1,
    chirp_depth_semitones: float = 0.5,
) -> np.ndarray:
    """WF0: harmonic-comb source spectra — float32 (n_fft//2+1,
    P·chirp_per_f0), columns sum to 1.

    ≙ pyfasst's KLGLOTT88-derived F0 dictionary (``generate_WF0_chirped``
    family): each candidate f0 contributes Gaussian spectral lobes of
    ``lobe_bins`` std (in DFT bins) at its harmonics, evaluated as one
    (F × P·C × H) broadcast in float32.

    source: ``"decay"`` — 1/h^decay rolloff; ``"klglott88"`` — the
    reference's glottal source power amplitudes |a_h|².

    chirp_per_f0 > 1 adds chirped atom variants per candidate (pyfasst's
    ``chirpPerF0``/``depthChirpInSemiTone``): variant c models a within-frame
    glide of up to ±``chirp_depth_semitones``, harmonic h's lobe widening by
    h·Δf/2 bins. Column p·chirp_per_f0 + c is candidate p, chirp c.
    """
    F = n_fft // 2 + 1
    f0 = torch.as_tensor(np.asarray(f0_grid), dtype=torch.float32)     # (P,)
    bins = torch.arange(F, dtype=torch.float32)                        # (F,)
    h = torch.arange(1, n_harmonics + 1, dtype=torch.float32)          # (H,)
    if source == "klglott88":
        amp = torch.as_tensor(klglott88_amplitudes(n_harmonics, open_quotient) ** 2)
    elif source == "decay":
        amp = h ** (-decay)
    else:
        raise ValueError(f"unknown source {source!r}")

    # chirp variants: fractional within-frame f0 smear per variant
    c = np.arange(chirp_per_f0, dtype=np.float32)
    smear = (2.0 ** (c * chirp_depth_semitones
                     / max(chirp_per_f0 - 1, 1) / 12.0) - 1.0)  # (C,)
    f0c = f0.repeat_interleave(chirp_per_f0)                            # (P·C,)
    smear_c = torch.as_tensor(smear, dtype=torch.float32).repeat(f0.shape[0])

    centers = f0c[None, :, None] * h[None, None, :] * n_fft / sample_rate
    width = lobe_bins + 0.5 * smear_c[None, :, None] * centers
    lobes = amp[None, None, :] * torch.exp(
        -0.5 * ((bins[:, None, None] - centers) / width) ** 2
    ) * lobe_bins / width
    # harmonics above Nyquist center outside [0, F) and decay to ~0 anyway
    W = lobes.sum(dim=2)
    return (W / torch.clamp(W.sum(dim=0, keepdim=True), min=_EPS)).numpy()


def hann_filter_basis(n_bins: int, n_atoms: int = 20) -> np.ndarray:
    """Smooth overlapping Hann atoms over frequency — float32 (n_bins,
    n_atoms).

    ≙ pyfasst ``sourcefilter/filter.py`` (``generateHannBasis``): atom k is
    a Hann bump centered at k·(n_bins − 1)/(n_atoms − 1) with 4× overlap.
    """
    centers = torch.linspace(0, n_bins - 1, n_atoms, dtype=torch.float32)
    width = 4.0 * n_bins / max(n_atoms - 1, 1)
    x = (torch.arange(n_bins, dtype=torch.float32)[:, None] - centers[None, :]) / width
    atom = torch.where(x.abs() < 0.5, 0.5 + 0.5 * torch.cos(2 * math.pi * x),
                       torch.zeros(()))
    return atom.numpy()


def melody_transition(f0_grid: np.ndarray, scale: float = 10.0) -> np.ndarray:
    """(P, P) float32 log-transition penalty ∝ −scale·|Δ log2 f0|, each row
    a log-softmax.

    The smoothness prior pyfasst feeds its ``viterbiTracking`` kernel
    (``SeparateLeadStereoTF.py`` melody smoothing)."""
    lf = torch.log2(torch.as_tensor(np.asarray(f0_grid), dtype=torch.float32))
    d = (lf[:, None] - lf[None, :]).abs()
    return torch.log_softmax(-scale * d, dim=1).numpy()


def f0_grid(f0_min: float, f0_max: float, steps_per_semitone: int) -> np.ndarray:
    """The F0 candidates: ``steps_per_semitone`` a semitone from ``f0_min``
    to at least ``f0_max``."""
    n_steps = int(np.ceil(12 * steps_per_semitone * np.log2(f0_max / f0_min))) + 1
    return f0_min * 2.0 ** (np.arange(n_steps) / (12.0 * steps_per_semitone))


def _track_melody(HF0: torch.Tensor, log_transition: torch.Tensor) -> torch.Tensor:
    """Viterbi melody path over F0 activations (P, N) → (N,) int64, on
    HF0's device (uniform prior)."""
    from exemplars_vc_tpu_torch.align.viterbi import viterbi_track

    P = HF0.shape[0]
    log_density = torch.log(torch.clamp(HF0, min=_EPS))
    log_prior = torch.full((P,), -math.log(P), dtype=torch.float32, device=HF0.device)
    return viterbi_track(log_density, log_prior, log_transition, device=HF0.device)


def melody_band(path: torch.Tensor, n_steps: int, half: float) -> torch.Tensor:
    """(n_steps, N) float32 mask: 1 within ``half`` candidate steps of the
    melody path, 0 elsewhere."""
    cand = torch.arange(n_steps, dtype=torch.float32, device=path.device)
    return ((cand[:, None] - path[None, :].to(torch.float32)).abs() <= half).to(torch.float32)


def _as_audio(x) -> np.ndarray:
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float32)


def separate_lead(
    x,
    sample_rate: float = 16000.0,
    n_fft: int = 1024,
    hop_length: int = 256,
    f0_min: float = 100.0,
    f0_max: float = 800.0,
    steps_per_semitone: int = 4,
    n_harmonics: int = 30,
    n_filt_atoms: int = 20,
    n_accomp: int = 40,
    n_iter: int = 30,
    n_warmup: int = 10,
    melody_halfwidth_semitones: float = 0.5,
    transition_scale: float = 10.0,
    voicing_threshold: float = 0.05,
    key: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> LeadSeparation:
    """Separate the lead (melody) source from the accompaniment.

    The two-pass SIMM pipeline of pyfasst ``SeparateLeadStereoTF.py``:

    1. source/filter NMF with the full F0 dictionary (WF0 and the smooth
       Hann filter basis fixed, free accompaniment residual), preceded by
       ``n_warmup`` iterations with the accompaniment frozen near zero, so
       the structured lead model claims the harmonic energy first;
    2. Viterbi melody decoding over the F0 activations HF0;
    3. a second pass with HF0 masked to ±``melody_halfwidth_semitones`` of
       the melody and the accompaniment reset to a fresh tiny init;
    4. Wiener ratio mask (lead model power vs total) → lead/accomp ISTFT.

    x: (C, T) or (T,) audio. Frames whose lead share of model power is
    below ``voicing_threshold`` report f0 = 0 (unvoiced).

    Every pass hands ``key`` (``PRNGKey(0)`` when None) to ``sf_nmf``, as
    the JAX package does, so a factor a pass draws is the same draw in each
    pass: H, H_filt, W_res and H_res from ``split(key, 6)``'s subkeys 1, 3,
    4 and 5, drawn once here.
    """
    from exemplars_vc_tpu_torch.separate.glue import (
        host_mean_power, host_stft_stack, masked_istft)
    from exemplars_vc_tpu_torch.separate.isnmf import _init, sf_nmf

    dev = resolve_device(device)
    x_np = _as_audio(x)
    if x_np.ndim == 1:
        x_np = x_np[None, :]
    C, T = x_np.shape
    X = host_stft_stack(x_np, n_fft, hop_length, fnc=True, device=dev)   # (F, N, C)
    SX = torch.as_tensor(host_mean_power(x_np, n_fft, hop_length), device=dev)  # (F, N)
    F, N = SX.shape

    grid = f0_grid(f0_min, f0_max, steps_per_semitone)
    n_steps = len(grid)
    WF0 = torch.as_tensor(harmonic_dictionary(grid, n_fft, sample_rate, n_harmonics),
                          device=dev)
    WGAMMA = torch.as_tensor(hann_filter_basis(F, n_filt_atoms), device=dev)
    ks = prng.split(prng.key_or_default(key), 6)   # sf_nmf's subkeys
    draws = dict(
        H_init=_init(ks[1], (n_steps, N), None, dev),
        H_filt_init=_init(ks[3], (n_filt_atoms, N), None, dev),
        W_res_init=_init(ks[4], (F, n_accomp), None, dev, squared=False),
        H_res_init=_init(ks[5], (n_accomp, N), None, dev, squared=False))
    base = dict(n_components=n_steps, n_filt_components=n_filt_atoms,
                n_res_components=n_accomp, W_init=WF0, update_W=False,
                W_filt_init=WGAMMA, update_W_filt=False, n_iter=n_iter, device=dev)
    tiny = dict(W_res_init=torch.full((F, n_accomp), 1e-3, device=dev),
                H_res_init=torch.full((n_accomp, N), 1e-3, device=dev))

    # ---- pass 1: lead-only warm-up, then unconstrained F0 activations -------
    if n_warmup > 0:
        _, H_w, _, HPHI_w, _, _ = sf_nmf(
            SX, **dict(base, n_iter=n_warmup), update_res=False,
            H_init=draws["H_init"], H_filt_init=draws["H_filt_init"], **tiny)
    else:
        H_w, HPHI_w = draws["H_init"], draws["H_filt_init"]
    _, HF0, _, HPHI, WM, HM = sf_nmf(
        SX, **base, H_init=H_w, H_filt_init=HPHI_w,
        W_res_init=draws["W_res_init"], H_res_init=draws["H_res_init"])

    # ---- melody decoding -----------------------------------------------------
    log_trans = torch.as_tensor(melody_transition(grid, transition_scale), device=dev)
    path = _track_melody(HF0, log_trans)                  # (N,)

    # ---- pass 2: melody-constrained re-estimation ---------------------------
    mask = melody_band(path, n_steps, melody_halfwidth_semitones * steps_per_semitone)
    _, HF0, _, HPHI, WM, HM = sf_nmf(
        SX, **base, H_init=HF0 * mask + _EPS * mask, H_filt_init=HPHI, **tiny)
    HF0 = HF0 * mask                                       # keep it banded

    # ---- Wiener ratio mask + resynthesis -------------------------------------
    lead_pow = (WF0 @ HF0) * (WGAMMA @ HPHI)               # (F, N)
    acc_pow = WM @ HM
    gain = lead_pow / torch.clamp(lead_pow + acc_pow, min=_EPS)
    lead, accomp = masked_istft(X, gain[..., None], n_fft, hop_length, T, fnc=True)

    # voicing: frames where the lead model carries real energy
    lead_frame = lead_pow.sum(dim=0)
    tot_frame = torch.clamp((lead_pow + acc_pow).sum(dim=0), min=_EPS)
    voiced = (lead_frame / tot_frame).cpu().numpy() > voicing_threshold
    f0 = np.where(voiced, grid[path.cpu().numpy()], 0.0)
    return LeadSeparation(lead, accomp, f0, grid, HF0)
