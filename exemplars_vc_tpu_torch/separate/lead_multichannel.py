"""Multichannel source-F0-filter separation — pyfasst's composed model (port
of ``exemplars_vc_tpu/separate/lead_multichannel.py``; pyfasst
``audioModel.py``: ``multiChanSourceF0Filter`` :2551, ``multichanLead``
:3016, ``runDecomp`` :3060).

A FASST local Gaussian model whose lead source's spectral power is the
Durrieu source/filter product — fixed harmonic-comb dictionary WF0 with free
per-frame activations HF0, times a smooth filter WGAMMA·FW·TW — and whose
other sources are free NMF; every source carries its own spatial covariance,
fitted by the shared EM (``multichannel._spatial_estep``). The lead's
spectral M-step is an IS multiplicative update of (HF0, FW, TW) toward its
posterior statistics z₀; the accompaniment sources take the plain NMF
M-step (``multichannel._nmf_inner``).

``separate_lead_multichannel`` is the ``multichanLead`` schedule: stereo
SIMM first, spatial parameters from the separated signals (DEMIX or their
empirical covariances), the SIMM factors and those spatial estimates seed
the composed model, full EM, spatial Wiener separation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.separate.multichannel import (
    _as_complex,
    _nmf_inner,
    _outer,
    _spatial_estep,
    _wiener_images_v,
    random_spatial_init,
)

_EPS = 1e-10


class MultichannelSF(NamedTuple):
    """Fitted composed model.

    Lead source (source 0): HF0 (NF0, N), FW (P, K), TW (K, N) with the
    fixed bases WF0 (F, NF0) and WGAMMA (F, P). Accompaniment sources
    1..J-1: W (J-1, F, Ka), H (J-1, Ka, N). R: (J, F, C, C) spatial
    covariances. neg_log_like: per-EM-iteration data NLL.
    """

    HF0: torch.Tensor
    FW: torch.Tensor
    TW: torch.Tensor
    W: torch.Tensor
    H: torch.Tensor
    R: torch.Tensor
    neg_log_like: torch.Tensor


def _lead_power(WF0, WGAMMA, HF0, FW, TW):
    return (WF0 @ HF0) * ((WGAMMA @ FW) @ TW)


def _sf_updates(z, WF0, WGAMMA, HF0, FW, TW):
    """One IS multiplicative update sweep of the lead factors toward z
    (≙ pyfasst ``update_spectral_components``, ``audioModel.py:1469``):
    HF0, then FW (column-normalized, scale shipped into TW), then TW
    (per-frame-normalized, scale shipped into HF0)."""
    # HF0
    SPHI = (WGAMMA @ FW) @ TW
    v = torch.clamp((WF0 @ HF0) * SPHI, min=_EPS)
    num = WF0.T @ (z * SPHI / (v * v))
    den = WF0.T @ (SPHI / v)
    HF0 = HF0 * (num / torch.clamp(den, min=_EPS))

    # FW
    SF0 = WF0 @ HF0
    v = torch.clamp(SF0 * SPHI, min=_EPS)
    num = WGAMMA.T @ ((z * SF0 / (v * v)) @ TW.T)
    den = WGAMMA.T @ ((SF0 / v) @ TW.T)
    FW = FW * (num / torch.clamp(den, min=_EPS))
    sumFW = FW.sum(dim=0)
    FW = FW / torch.where(sumFW == 0.0, torch.ones_like(sumFW), sumFW)
    TW = TW * sumFW[:, None]

    # TW
    WPHI = WGAMMA @ FW
    v = torch.clamp(SF0 * (WPHI @ TW), min=_EPS)
    num = WPHI.T @ (z * SF0 / (v * v))
    den = WPHI.T @ (SF0 / v)
    TW = TW * (num / torch.clamp(den, min=_EPS))
    sumTW = TW.sum(dim=0)
    pos = sumTW > 0
    TW = torch.where(pos, TW / torch.where(pos, sumTW, torch.ones_like(sumTW)), TW)
    HF0 = HF0 * sumTW[None, :]
    return HF0, FW, TW


def _em_sf_loop(X, WF0, WGAMMA, HF0, FW, TW, W, H, R, n_em: int,
                n_inner: int) -> MultichannelSF:
    """EM of the composed model: X (F, N, C) complex64; the per-iteration
    NLLs stay on the device until the fit returns."""
    XX = _outer(X)                                         # (F, N, C, C)
    nlls = []
    for _ in range(n_em):
        v_lead = torch.clamp(_lead_power(WF0, WGAMMA, HF0, FW, TW), min=_EPS)
        v_acc = torch.clamp(W @ H, min=_EPS)
        v = torch.cat([v_lead[None], v_acc], dim=0)        # (J, F, N)
        R, scale, z, nll = _spatial_estep(XX, v, R)
        # the free-NMF sources absorb the spatial trace scale directly; the
        # lead's factors absorb it by fitting z₀, which already contains it
        W = W * scale[1:, :, None]
        for _ in range(n_inner):
            HF0, FW, TW = _sf_updates(z[0], WF0, WGAMMA, HF0, FW, TW)
            W, H = _nmf_inner(z[1:], W, H)
        nlls.append(nll)
    return MultichannelSF(HF0, FW, TW, W, H, R, torch.stack(nlls))


# posterior source images for the stacked power model — the shared
# multichannel Wiener path (one implementation for every spectral model)
_wiener_images_sf = _wiener_images_v


def model_power(model: MultichannelSF, WF0, WGAMMA) -> torch.Tensor:
    """Stacked per-source spectral power v (J, F, N) of a fitted model."""
    v_lead = _lead_power(WF0, WGAMMA, model.HF0, model.FW, model.TW)
    v_acc = model.W @ model.H
    return torch.cat([torch.clamp(v_lead, min=_EPS)[None],
                      torch.clamp(v_acc, min=_EPS)], dim=0)


def fit_multichannel_sf(
    X,
    WF0,
    WGAMMA,
    n_acc_sources: int = 1,
    n_filters: int = 4,
    n_acc_components: int = 8,
    n_em: int = 30,
    n_inner: int = 1,
    key: torch.Tensor | None = None,
    HF0_init=None,
    FW_init=None,
    TW_init=None,
    W_init=None,
    H_init=None,
    R_init=None,
    device: str | torch.device = "cuda",
) -> MultichannelSF:
    """Fit the composed source-F0-filter multichannel model.

    X: (F, N, C) complex mixture STFT. Source 0 is the source/filter lead
    (WF0/WGAMMA fixed); sources 1..n_acc_sources are free NMF. Inits not
    provided are drawn on the CPU from ``split(key, 6)`` (``key``
    ``PRNGKey(0)`` when None), one subkey each in the order HF0, FW, TW, W,
    H — 0.75·|randn| + 0.25, pyfasst's ``_initialize_structures``
    (``audioModel.py:2650``) — then R
    (:func:`multichannel.random_spatial_init`)."""
    dev = resolve_device(device)
    X = _as_complex(X, dev)
    WF0 = torch.as_tensor(WF0, dtype=torch.float32, device=dev)
    WGAMMA = torch.as_tensor(WGAMMA, dtype=torch.float32, device=dev)
    F, N, C = X.shape
    ks = prng.split(prng.key_or_default(key), 6)

    def init(k, shape, provided):
        if provided is not None:
            return torch.as_tensor(provided, dtype=torch.float32, device=dev)
        return (0.75 * prng.normal(k, shape).abs() + 0.25).to(dev)

    HF0 = init(ks[0], (WF0.shape[1], N), HF0_init)
    FW = init(ks[1], (WGAMMA.shape[1], n_filters), FW_init)
    TW = init(ks[2], (n_filters, N), TW_init)
    W = init(ks[3], (n_acc_sources, F, n_acc_components), W_init)
    H = init(ks[4], (n_acc_sources, n_acc_components, N), H_init)
    R = (random_spatial_init(ks[5], 1 + n_acc_sources, F, C, device=dev) if R_init is None
         else _as_complex(R_init, dev))
    return _em_sf_loop(X, WF0, WGAMMA, HF0, FW, TW, W, H, R, int(n_em), int(n_inner))


class MultichannelLead(NamedTuple):
    """lead/accomp: (C, T) separated source images; f0: (N,) melody (Hz);
    model: the fitted composed MultichannelSF; simm: the stereo-SIMM
    warm-start result (``StereoLeadSeparation``)."""

    lead: torch.Tensor
    accomp: torch.Tensor
    f0: np.ndarray
    model: MultichannelSF
    simm: object


def separate_lead_multichannel(
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
    n_iter_simm: int = 30,
    n_em: int = 20,
    n_acc_sources: int = 1,
    spatial_init: str = "demix",
    key: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> MultichannelLead:
    """The ``multichanLead.runDecomp`` estimation schedule
    (``audioModel.py:3060``), end to end:

    1. stereo SIMM lead/accompaniment separation
       (:func:`stereo_simm.separate_lead_stereo`, its random inits from
       the first half of ``split(key)``, ``key`` ``PRNGKey(0)`` when None);
    2. spatial parameters from the separated signals: DEMIX on the lead and
       accompaniment images (≙ ``demixOnSepSIMM`` ``audioModel.py:3325``;
       stereo only, any other channel count takes the empirical path), or
       their empirical spatial covariances (``spatial_init="empirical"``);
    3. the SIMM spectral parameters and the spatial estimates seed the
       composed model (every factor given: the fit draws nothing);
    4. full EM on the unit-power STFT, then spatial Wiener separation of
       the raw STFT (the masks are scale-invariant).
    """
    from exemplars_vc_tpu_torch.separate.glue import (
        empirical_spatial_cov, host_stft_stack, images_istft, stack_spatial, unit_power)
    from exemplars_vc_tpu_torch.separate.lead import (
        _as_audio, f0_grid, hann_filter_basis, harmonic_dictionary)
    from exemplars_vc_tpu_torch.separate.stereo_simm import separate_lead_stereo

    dev = resolve_device(device)
    x = _as_audio(x)
    if x.ndim == 1:
        x = np.stack([x, x])
    C, T = x.shape
    k1, k2 = prng.split(prng.key_or_default(key))

    # ---- 1. stereo SIMM warm start ----------------------------------------
    simm = separate_lead_stereo(
        x, sample_rate=sample_rate, n_fft=n_fft, hop_length=hop_length,
        f0_min=f0_min, f0_max=f0_max, steps_per_semitone=steps_per_semitone,
        n_harmonics=n_harmonics, n_filt_atoms=n_filt_atoms, n_filters=n_filters,
        n_accomp=n_accomp, n_iter=n_iter_simm, key=k1, device=dev)

    X = host_stft_stack(x, n_fft, hop_length, fnc=True, device=dev)     # (F, N, C)
    X_fit = unit_power(X)
    F = X.shape[0]
    WF0 = torch.as_tensor(harmonic_dictionary(f0_grid(f0_min, f0_max, steps_per_semitone),
                                              n_fft, sample_rate, n_harmonics), device=dev)
    # the SUIMM round fitted WUF0 = [WF0, 1] (unvoiced column) — keep it
    WUF0 = torch.cat([WF0, torch.ones((F, 1), device=dev)], dim=1)
    WGAMMA = torch.as_tensor(hann_filter_basis(F, n_filt_atoms), device=dev)

    # ---- 2. spatial estimation on the separated signals -------------------
    if spatial_init == "demix" and C != 2:
        spatial_init = "empirical"      # DEMIX is stereo-only
    if spatial_init == "demix":
        from exemplars_vc_tpu_torch.separate.demix import demix

        freqs = np.arange(F) / n_fft
        R_lead, R_acc = (
            demix(img, n_sources=1, n_fft=n_fft, hop_length=hop_length,
                  device=dev).spatial_init(freqs, device=dev)[0]
            for img in (simm.lead, simm.accomp))
    elif spatial_init == "empirical":
        R_lead = empirical_spatial_cov(simm.lead, n_fft, hop_length)
        R_acc = empirical_spatial_cov(simm.accomp, n_fft, hop_length)
    else:
        raise ValueError(f"unknown spatial_init {spatial_init!r}")

    # ---- 3+4. composed model seeded with the SIMM parameters --------------
    # the SIMM accompaniment factors are split across the n_acc_sources
    # free-NMF sources (each takes a slice of WM/HM columns); every
    # accompaniment source starts at the SIMM accompaniment's spatial estimate
    m = simm.model
    J_acc = max(int(n_acc_sources), 1)
    if J_acc > n_accomp:
        raise ValueError(
            f"n_acc_sources={J_acc} exceeds n_accomp={n_accomp}: each "
            "accompaniment source needs at least one SIMM NMF component "
            "to seed from")
    k_per = max(n_accomp // J_acc, 1)
    W_seed = torch.stack([m.WM[:, j * k_per : (j + 1) * k_per] for j in range(J_acc)])
    H_seed = torch.stack([m.HM[j * k_per : (j + 1) * k_per] for j in range(J_acc)])
    model = fit_multichannel_sf(
        X_fit, WUF0, WGAMMA, n_acc_sources=J_acc, n_filters=n_filters,
        n_acc_components=k_per, n_em=n_em,
        HF0_init=m.HF0, FW_init=m.HGAMMA, TW_init=m.HPHI,
        W_init=W_seed, H_init=H_seed, R_init=stack_spatial(R_lead, R_acc, J_acc),
        key=k2, device=dev)

    v = model_power(model, WUF0, WGAMMA)
    Y = _wiener_images_sf(X, v, model.R)                   # (J, F, N, C)
    audio = images_istft(Y, n_fft, hop_length, T)          # (1 + J_acc, C, T)
    return MultichannelLead(audio[0], audio[1:].sum(dim=0), simm.f0, model, simm)
