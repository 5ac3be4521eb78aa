"""Stereo SIMM — pyfasst's full stereo lead/accompaniment estimator (port of
``exemplars_vc_tpu/separate/stereo_simm.py``; pyfasst
``SeparateLeadStereo/SIMM/SIMM.py:397`` ``Stereo_SIMM`` and its two-round
schedule ``SeparateLeadStereoTF.py:1408,1620``).

The Durrieu Smoothed Instantaneous Mixture Model on both channel power
spectrograms jointly, with per-channel mixing gains::

    ŜR = αR²·(WF0·HF0)⊙(WGAMMA·HGAMMA·HPHI) + WM·diag(βR²)·HM
    ŜL = αL²·(WF0·HF0)⊙(WGAMMA·HGAMMA·HPHI) + WM·diag(βL²)·HM

One iteration re-estimates, in the reference's order: HF0, HPHI
(column-normalized, scale shipped into HF0), HM, HGAMMA (column-normalized
twice, scales shipped down the factor chain), WM (column-normalized into
HM), then αR/αL and βR/βL with the reference's 0.1·ω damping and
sum-to-one renormalizations. A Python loop of float32 matmuls (TF32 off,
``device.py``); the per-iteration IS errors stay on the device until the
fit returns. Its float64 oracle is ``tests/oracles/stereo_simm.py``.

``separate_lead_stereo`` is the two-round VUIMM pipeline: round 1 fits all
parameters (HGAMMA free), the melody is Viterbi-decoded from HF0, round 2
re-fits with HF0 banded around the melody, an all-ones unvoiced column
appended to WF0 and HGAMMA frozen; per-channel Wiener masks resynthesize
lead and accompaniment.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.device import resolve_device

_EPS = 1e-20  # SIMM.py:498 (eps = 10**-20)


class StereoSIMM(NamedTuple):
    """Fitted stereo SIMM parameters.

    alpha: (2,) lead panning gains (R, L), summing to 1; HGAMMA: (P, K)
    filter-shape weights; HPHI: (K, N) filter activations; HF0: (NF0, N)
    source activations; beta: (2, R) accompaniment panning gains per
    component (columns sum to 1); HM: (R, N); WM: (F, R); is_error:
    (n_iter,) IS divergence D(SXR‖ŜR)+D(SXL‖ŜL) after each iteration.
    """

    alpha: torch.Tensor
    HGAMMA: torch.Tensor
    HPHI: torch.Tensor
    HF0: torch.Tensor
    beta: torch.Tensor
    HM: torch.Tensor
    WM: torch.Tensor
    is_error: torch.Tensor


def _safe(x):
    return torch.clamp(x, min=_EPS)


def _colnorm(M):
    """Column-normalize where the column sum is positive; return (M, sums).
    Zero-sum columns stay, but their raw sums are shipped downstream
    (SIMM.py's HPHI/HGAMMA/WM renorms)."""
    s = M.sum(dim=0)
    pos = s > 0
    return torch.where(pos, M / torch.where(pos, s, torch.ones_like(s)), M), s


def _diag_quad(WM, A, HM):
    """diag(WMᵀ A HMᵀ)_r = Σ_f Σ_n WM[f,r]·A[f,n]·HM[r,n]."""
    return ((WM.T @ A) * HM).sum(dim=1)


def _stereo_simm_loop(SXR, SXL, WF0, WGAMMA, alpha, HGAMMA, HPHI, HF0, beta, HM, WM,
                      n_iter: int, omega: float, update_hgamma: bool,
                      update_accomp: bool, diag: bool = False):
    pw = omega          # full-power exponent for the factor updates
    pg = 0.1 * omega    # damped exponent for the mixing gains (SIMM.py:877)

    def recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM):
        SF0 = WF0 @ HF0
        SPHI = (WGAMMA @ HGAMMA) @ HPHI
        lead = SF0 * SPHI
        hatR = _safe(alpha[0] ** 2 * lead + (WM * beta[0] ** 2) @ HM)
        hatL = _safe(alpha[1] ** 2 * lead + (WM * beta[1] ** 2) @ HM)
        return SF0, SPHI, lead, hatR, hatL

    errs, outs = [], []
    for _ in range(n_iter):
        WPHI = WGAMMA @ HGAMMA

        # ---- HF0 (SIMM.py:623-663) --------------------------------------
        SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
        comR = alpha[0] ** 2 * SPHI / hatR
        comL = alpha[1] ** 2 * SPHI / hatL
        num = comR * SXR / hatR + comL * SXL / hatL
        den = comR + comL
        HF0 = HF0 * ((WF0.T @ num) / _safe(WF0.T @ den)) ** pw

        # ---- HPHI (SIMM.py:685-704): normalize, ship scale into HF0 -----
        SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
        comR = alpha[0] ** 2 * SF0 / hatR
        comL = alpha[1] ** 2 * SF0 / hatL
        num = comR * SXR / hatR + comL * SXL / hatL
        den = comR + comL
        HPHI = HPHI * ((WPHI.T @ num) / _safe(WPHI.T @ den)) ** pw
        HPHI, sumHPHI = _colnorm(HPHI)
        HF0 = HF0 * sumHPHI[None, :]

        # ---- HM (SIMM.py:739-751) ---------------------------------------
        if update_accomp:
            SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
            WMR = WM * beta[0] ** 2
            WML = WM * beta[1] ** 2
            num = WMR.T @ (SXR / (hatR * hatR)) + WML.T @ (SXL / (hatL * hatL))
            den = WMR.T @ (1.0 / hatR) + WML.T @ (1.0 / hatL)
            HM = HM * (num / _safe(den)) ** pw

        # ---- HGAMMA (SIMM.py:775-800): double renorm down the chain -----
        if update_hgamma:
            SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
            comR = alpha[0] ** 2 * SF0 / hatR
            comL = alpha[1] ** 2 * SF0 / hatL
            num = comR * SXR / hatR + comL * SXL / hatL
            den = comR + comL
            HGAMMA = HGAMMA * ((WGAMMA.T @ (num @ HPHI.T))
                               / _safe(WGAMMA.T @ (den @ HPHI.T))) ** pw
            HGAMMA, sumHG = _colnorm(HGAMMA)
            HPHI = HPHI * sumHG[:, None]
            HPHI, sumHPHI = _colnorm(HPHI)
            HF0 = HF0 * sumHPHI[None, :]

        # ---- WM (SIMM.py:826-846): normalize, ship into HM --------------
        if update_accomp:
            SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
            HMR = HM.T * (beta[0] ** 2)[None, :]
            HML = HM.T * (beta[1] ** 2)[None, :]
            num = (SXR / (hatR * hatR)) @ HMR + (SXL / (hatL * hatL)) @ HML
            den = (1.0 / hatR) @ HMR + (1.0 / hatL) @ HML
            WM = WM * (num / _safe(den)) ** pw
            WM, sumWM = _colnorm(WM)
            HM = HM * sumWM[:, None]

        # ---- alphaR/alphaL (SIMM.py:871-884): damped, sum-to-one --------
        SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
        denR = lead / hatR
        aR = torch.clamp(alpha[0] * ((denR * SXR / hatR).sum() / denR.sum()) ** pg, min=_EPS)
        denL = lead / hatL
        aL = torch.clamp(alpha[1] * ((denL * SXL / hatL).sum() / denL.sum()) ** pg, min=_EPS)
        aR = aR / torch.clamp(aR + aL, min=1e-3)
        alpha = torch.stack([aR, 1.0 - aR])

        # ---- betaR/betaL (SIMM.py:908-920): per-component, damped -------
        if update_accomp:
            SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
            bR = beta[0] * (_diag_quad(WM, SXR / (hatR * hatR), HM)
                            / _safe(_diag_quad(WM, 1.0 / hatR, HM))) ** pg
            bL = beta[1] * (_diag_quad(WM, SXL / (hatL * hatL), HM)
                            / _safe(_diag_quad(WM, 1.0 / hatL, HM))) ** pg
            bR = bR / _safe(bR + bL)
            beta = torch.stack([bR, 1.0 - bR])

        # ---- IS reconstruction error after the full iteration -----------
        SF0, SPHI, lead, hatR, hatL = recon(alpha, HGAMMA, HPHI, HF0, beta, HM, WM)
        rR = SXR / hatR
        rL = SXL / hatL
        err = (rR - torch.log(_safe(rR)) - 1.0).sum() + (rL - torch.log(_safe(rL)) - 1.0).sum()
        errs.append(err)
        if diag:
            lead_pow = (alpha[0] ** 2 + alpha[1] ** 2) * lead.sum()
            tot = hatR.sum() + hatL.sum()
            outs.append({
                "err": err,
                "alpha_r": alpha[0],
                "lead_share": lead_pow / _safe(tot),
                "sum_hf0": HF0.sum(),
                "sum_hphi": HPHI.sum(),
                "sum_hgamma": HGAMMA.sum(),
                "sum_hm": HM.sum(),
                "sum_wm": WM.sum(),
                "min_hat": torch.minimum(hatR.min(), hatL.min()),
                "max_hat": torch.maximum(hatR.max(), hatL.max()),
                "min_lead": lead.min(),
                "max_hf0": HF0.max(),
            })
    model = StereoSIMM(alpha, HGAMMA, HPHI, HF0, beta, HM, WM, torch.stack(errs))
    if diag:
        return model, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return model


def simm_draws(key: torch.Tensor, F: int, N: int, NF0: int, P: int,
               n_filters: int, n_accomp: int) -> dict:
    """Every random init of one stereo SIMM fit, drawn on the CPU from
    ``split(key, 6)`` as the JAX package draws them: HGAMMA, HPHI, HF0, WM,
    HM (|standard normal|) from subkeys 0-4 and βR (uniform, βL = 1 − βR)
    from subkey 5 — ``SIMM.py:524-583``. Keys are :func:`stereo_simm`'s
    ``*_init`` arguments."""
    ks = prng.split(key, 6)
    shapes = dict(HGAMMA_init=(P, n_filters), HPHI_init=(n_filters, N), HF0_init=(NF0, N),
                  WM_init=(F, n_accomp), HM_init=(n_accomp, N))
    out = {name: prng.normal(k, shape).abs() for k, (name, shape) in zip(ks, shapes.items())}
    bR = prng.uniform(ks[5], (n_accomp,))
    out["beta_init"] = torch.stack([bR, 1.0 - bR])
    return out


def stereo_simm(
    SXR,
    SXL,
    WF0,
    WGAMMA,
    n_filters: int = 4,
    n_accomp: int = 10,
    n_iter: int = 30,
    omega: float = 1.0,
    update_hgamma: bool = True,
    update_accomp: bool = True,
    HGAMMA_init=None,
    HPHI_init=None,
    HF0_init=None,
    WM_init=None,
    HM_init=None,
    beta_init=None,
    alpha_init=None,
    key: torch.Tensor | None = None,
    return_diagnostics: bool = False,
    device: str | torch.device = "cuda",
) -> StereoSIMM:
    """Fit the stereo SIMM to the two channel power spectrograms.

    SXR/SXL: (F, N) right/left power spectrograms. WF0: (F, NF0) fixed
    source dictionary. WGAMMA: (F, P) fixed smooth filter-atom bank. Inits
    not provided are drawn from ``key`` (``PRNGKey(0)`` when None) as
    :func:`simm_draws` does; α starts at (0.5, 0.5).
    ``return_diagnostics`` also returns a dict of per-iteration traces."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    SXR, SXL, WF0, WGAMMA = f32(SXR), f32(SXL), f32(WF0), f32(WGAMMA)
    F, N = SXR.shape
    given = dict(HGAMMA_init=HGAMMA_init, HPHI_init=HPHI_init, HF0_init=HF0_init,
                 WM_init=WM_init, HM_init=HM_init, beta_init=beta_init)
    if any(v is None for v in given.values()):
        draws = simm_draws(prng.key_or_default(key), F, N, WF0.shape[1],
                           WGAMMA.shape[1], n_filters, n_accomp)
        given = {k: draws[k] if v is None else v for k, v in given.items()}
    alpha = f32([0.5, 0.5] if alpha_init is None else alpha_init)
    return _stereo_simm_loop(
        SXR, SXL, WF0, WGAMMA, alpha, f32(given["HGAMMA_init"]), f32(given["HPHI_init"]),
        f32(given["HF0_init"]), f32(given["beta_init"]), f32(given["HM_init"]),
        f32(given["WM_init"]), int(n_iter), float(omega), bool(update_hgamma),
        bool(update_accomp), bool(return_diagnostics))


class StereoLeadSeparation(NamedTuple):
    """lead/accomp: (2, T) stereo source estimates; f0: (N,) melody (Hz, 0
    where unvoiced); f0_candidates: the candidate grid; model: the round-2
    fitted StereoSIMM."""

    lead: torch.Tensor
    accomp: torch.Tensor
    f0: np.ndarray
    f0_candidates: np.ndarray
    model: StereoSIMM


def separate_lead_stereo(
    x,
    sample_rate: float = 16000.0,
    n_fft: int = 1024,
    hop_length: int = 256,
    f0_min: float = 100.0,
    f0_max: float = 800.0,
    steps_per_semitone: int = 4,
    n_harmonics: int = 30,
    n_filt_atoms: int = 20,
    n_filters: int = 4,
    n_accomp: int = 40,
    n_iter: int = 30,
    n_warmup: int = 10,
    melody_halfwidth_semitones: float = 0.5,
    transition_scale: float = 10.0,
    voicing_threshold: float = 0.05,
    key: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> StereoLeadSeparation:
    """Two-round stereo VUIMM lead separation (``SeparateLeadStereoTF.py``).

    Round 1 (``estimStereoSIMMParams``): a warm-up of ``n_warmup``
    iterations with the accompaniment frozen near zero, then the full
    stereo SIMM fit, HGAMMA free. Melody: Viterbi decoding over round-1
    HF0. Round 2 (``estimStereoSUIMMParams``): WF0 extended with an all-ones
    unvoiced column, HF0 re-initialized banded ±``melody_halfwidth_semitones``
    around the melody with the unvoiced row set to 1, HGAMMA frozen at
    round 1's estimate, HPHI/WM/HM fresh. Per-channel Wiener masks resynthesize
    the stereo lead and accompaniment images.

    Random inits: round 1 draws one set (:func:`simm_draws`) from the first
    half of ``split(key)`` and round 2 from the second (``key``
    ``PRNGKey(0)`` when None); every fit of a round takes that set's draws
    where it does not carry a fitted factor, as the JAX package's fits of a
    round share one key.
    """
    from exemplars_vc_tpu_torch.separate.glue import (
        host_stereo_powers, host_stft_stack, masked_istft)
    from exemplars_vc_tpu_torch.separate.lead import (
        _as_audio, _track_melody, f0_grid, hann_filter_basis, harmonic_dictionary,
        melody_band, melody_transition)

    dev = resolve_device(device)
    x_np = _as_audio(x)
    if x_np.ndim == 1:
        x_np = np.stack([x_np, x_np])
    C, T = x_np.shape
    # unit-mean power, computed on the host in float64 (separate/glue.py)
    X = host_stft_stack(x_np, n_fft, hop_length, fnc=False, device=dev)  # (C, F, N)
    SXR, SXL = (torch.as_tensor(a, device=dev)
                for a in host_stereo_powers(x_np, n_fft, hop_length))
    F, N = SXR.shape

    grid = f0_grid(f0_min, f0_max, steps_per_semitone)
    n_steps = len(grid)
    WF0 = torch.as_tensor(harmonic_dictionary(grid, n_fft, sample_rate, n_harmonics),
                          device=dev)
    WGAMMA = torch.as_tensor(hann_filter_basis(F, n_filt_atoms), device=dev)
    r1, r2 = (simm_draws(k, F, N, n_steps, n_filt_atoms, n_filters, n_accomp)
              for k in prng.split(prng.key_or_default(key)))
    kw = dict(n_filters=n_filters, n_accomp=n_accomp, device=dev)

    # ---- round 1: voiced-only SIMM, all parameters free ------------------
    # warm-up with the accompaniment frozen near zero first, as in the mono
    # path: under IS multiplicative updates an unconstrained residual
    # otherwise absorbs the harmonic energy the lead model should claim
    tiny = dict(WM_init=torch.full((F, n_accomp), 1e-3, device=dev),
                HM_init=torch.full((n_accomp, N), 1e-3, device=dev))
    warm = {}
    if n_warmup > 0:
        w = stereo_simm(SXR, SXL, WF0, WGAMMA, n_iter=n_warmup, update_hgamma=True,
                        update_accomp=False, **{**r1, **tiny}, **kw)
        warm = dict(HGAMMA_init=w.HGAMMA, HPHI_init=w.HPHI, HF0_init=w.HF0,
                    alpha_init=w.alpha)
    m1 = stereo_simm(SXR, SXL, WF0, WGAMMA, n_iter=n_iter, update_hgamma=True,
                     **{**r1, **warm}, **kw)

    # ---- melody decoding --------------------------------------------------
    log_trans = torch.as_tensor(melody_transition(grid, transition_scale), device=dev)
    path = _track_melody(m1.HF0, log_trans)                # (N,)

    # ---- round 2: VUIMM — banded HF0 + unvoiced column, HGAMMA frozen ----
    ones = torch.ones((F, 1), device=dev)
    WUF0 = torch.cat([WF0, ones], dim=1)
    band = melody_band(path, n_steps, melody_halfwidth_semitones * steps_per_semitone)
    HUF0 = torch.cat([m1.HF0 * band, torch.ones((1, N), device=dev)], dim=0)
    # the round-1 accompaniment already absorbed part of the melody's
    # harmonic energy; restart it tiny so the banded lead reclaims it
    m2 = stereo_simm(SXR, SXL, WUF0, WGAMMA, n_iter=n_iter, update_hgamma=False,
                     **{**r2, **tiny, "HGAMMA_init": m1.HGAMMA, "HF0_init": HUF0},
                     alpha_init=m1.alpha, **kw)

    # ---- per-channel Wiener masks + resynthesis ---------------------------
    SPHI = (WGAMMA @ m2.HGAMMA) @ m2.HPHI
    lead_pow = (WUF0 @ m2.HF0) * SPHI
    accR = (m2.WM * m2.beta[0] ** 2) @ m2.HM
    accL = (m2.WM * m2.beta[1] ** 2) @ m2.HM
    leadR = m2.alpha[0] ** 2 * lead_pow
    leadL = m2.alpha[1] ** 2 * lead_pow
    gR = leadR / torch.clamp(leadR + accR, min=_EPS)
    gL = leadL / torch.clamp(leadL + accL, min=_EPS)
    gain = torch.stack([gR, gL]) if C == 2 else gR[None]
    lead, accomp = masked_istft(X, gain, n_fft, hop_length, T, fnc=False)

    # voicing: fraction of model power the voiced lead rows carry
    voiced_pow = (m2.alpha[0] ** 2 + m2.alpha[1] ** 2) * (
        (WUF0[:, :-1] @ m2.HF0[:-1]) * SPHI).sum(dim=0)
    tot = torch.clamp((leadR + leadL + accR + accL).sum(dim=0), min=_EPS)
    voiced = (voiced_pow / tot).cpu().numpy() > voicing_threshold
    f0 = np.where(voiced, grid[path.cpu().numpy()], 0.0)
    return StereoLeadSeparation(lead, accomp, f0, grid, m2)
