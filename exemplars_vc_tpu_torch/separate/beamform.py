"""Spatial beamforming: ULA steering vectors, MVDR filters, directivity
diagrams (port of ``exemplars_vc_tpu/separate/beamform.py``; pyfasst
``spatial/dirdiag.py``: ``make_MVDR_filter_target`` :20,
``generate_steer_vec_thetas`` :207, ``directivity_filter_diagram_ULA`` :71).

Steering-vector banks, covariance builds, MVDR solves and angle × frequency
response surfaces are batched closed-form ops; the directivity "diagram" is
returned as a dB array. The C = 2 Hermitian inverse is the FASST EM's
(``separate/multichannel.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.separate.multichannel import _inv_hermitian

SOUND_SPEED = 340.0  # m/s


def _on(a, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(a, device=dev).to(dtype)


def ula_steering(thetas, freqs, n_sensors: int = 2, dist_inter_sensor: float = 0.15,
                 sound_speed: float = SOUND_SPEED,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """Anechoic far-field steering vectors for a uniform linear array.

    a_m(f, θ) = exp(−2πi·f·m·d·sin(θ)/c) for sensor m — (n_thetas, F, C)
    complex64 (≙ ``dirdiag.generate_steer_vec_thetas``)."""
    dev = resolve_device(device)
    thetas = torch.atleast_1d(_on(thetas, dev, torch.float32))
    freqs = torch.atleast_1d(_on(freqs, dev, torch.float32))
    m = torch.arange(n_sensors, dtype=torch.float32, device=dev)
    delay = dist_inter_sensor / sound_speed * torch.sin(thetas)          # (T,)
    phase = -2.0 * math.pi * delay[:, None, None] * freqs[None, :, None] * m
    return torch.complex(torch.cos(phase), torch.sin(phase))


def mvdr_filter(steer_target, steer_interf=None, diag_load: float = 1e-3,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Distortionless MVDR beamformer from steering vectors.

    ``steer_target`` (F, C); ``steer_interf`` (J, F, C), a single (F, C), or
    None. R(f) = Σ a aᴴ + δI (``dirdiag.make_MVDR_filter_target`` :20-69,
    beyond stereo); returns w(f) = R⁻¹a_t / (a_tᴴR⁻¹a_t) — (F, C)
    complex64, unit response toward the target."""
    dev = resolve_device(device)
    at = _on(steer_target, dev, torch.complex64)
    C = at.shape[-1]
    R = at[..., :, None] * at[..., None, :].conj()                      # (F,C,C)
    if steer_interf is not None:
        ai = _on(steer_interf, dev, torch.complex64)
        if ai.ndim == 2:                       # a single interferer as (F, C)
            ai = ai[None]
        R = R + (ai[..., :, None] * ai[..., None, :].conj()).sum(dim=0)
    R = R + diag_load * torch.eye(C, dtype=R.dtype, device=dev)
    Ra = torch.einsum("fij,fj->fi", _inv_hermitian(R), at)
    denom = torch.einsum("fi,fi->f", at.conj(), Ra)
    return Ra / torch.clamp(denom.real, min=1e-12)[:, None]


def directivity_diagram(w_filter, freqs, thetas=None, n_thetas: int = 181,
                        dist_inter_sensor: float = 0.15, sound_speed: float = SOUND_SPEED,
                        floor_db: float = -80.0, device: str | torch.device = "cuda"):
    """Beamformer response surface |wᴴa(θ,f)|² in dB.

    Returns ``(thetas, diagram)`` with diagram (n_thetas, F) — the data the
    reference's ``directivity_filter_diagram_ULA`` (:71) renders with
    matplotlib. One einsum over the whole angle × frequency grid."""
    dev = resolve_device(device)
    w = _on(w_filter, dev, torch.complex64)                              # (F, C)
    if thetas is None:
        thetas = torch.linspace(-np.pi / 2, np.pi / 2, n_thetas, device=dev)
    a = ula_steering(thetas, freqs, w.shape[-1], dist_inter_sensor, sound_speed,
                     device=dev)
    resp = torch.einsum("fc,tfc->tf", w.conj(), a)
    p = resp.real ** 2 + resp.imag ** 2
    return thetas, torch.clamp(10.0 * torch.log10(torch.clamp(p, min=0.0) + 1e-30),
                               min=floor_db)


def apply_beamformer(w_filter, X, device: str | torch.device = "cuda") -> torch.Tensor:
    """Apply w (F, C) to a multichannel STFT X (F, N, C) → (F, N)."""
    dev = resolve_device(device)
    return torch.einsum("fc,fnc->fn", _on(w_filter, dev, torch.complex64).conj(),
                        _on(X, dev, torch.complex64))
