"""Complex-STFT glue shared by the separation entry points (port of
``exemplars_vc_tpu/separate/glue.py``).

The host float64 input transforms are kept exactly: the IS-family fits
amplify float32 device-STFT roundoff in near-silent bins chaotically, so
the model input is computed on the host in float64 (as pyfasst computes it,
``SeparateLeadStereo/SeparateLeadStereoTF.py``), rounded to float32 parts
and combined to complex64 on the device. The JAX module's jitted helpers
that only existed because its backend could not run complex ops eagerly
(``_combine_stft``, ``first_source``) have no counterpart: in torch a
complex tensor is built from its parts in one call, and ``R[0]`` is a view.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.stft import istft, stft

_EPS = 1e-12


def _fnc(S: torch.Tensor, fnc: bool) -> torch.Tensor:
    """(C, N, F) → (F, N, C) [``fnc``] or (C, F, N)."""
    return S.permute(2, 1, 0) if fnc else S.permute(0, 2, 1)


def stft_stack(x: torch.Tensor, n_fft: int, hop_length: int,
               fnc: bool = True) -> torch.Tensor:
    """Multichannel STFT of x (C, T) on its device, stacked (F, N, C)
    [``fnc``] or (C, F, N)."""
    return _fnc(stft(x, n_fft=n_fft, hop_length=hop_length), fnc)


def _host_stft(x, n_fft: int, hop_length: int) -> np.ndarray:
    """Float64 host STFT with ``dsp.stft``'s semantics (center reflect-pad,
    periodic hann): complex128 (..., N, F)."""
    x = np.asarray(x, np.float64)
    pad = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
    x = np.pad(x, pad, mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    t = 2.0 * np.pi * np.arange(n_fft) / n_fft
    w = 0.5 - 0.5 * np.cos(t)
    return np.fft.rfft(x[..., idx] * w, axis=-1)      # (..., N, F)


def _host_stft_power(x, n_fft: int, hop_length: int) -> np.ndarray:
    """Float64 host power spectrogram (..., F, N)."""
    P = np.abs(_host_stft(x, n_fft, hop_length)) ** 2  # (..., N, F)
    return np.swapaxes(P, -1, -2)


def host_stft_stack(x, n_fft: int, hop_length: int, fnc: bool = True,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """Platform-exact multichannel STFT of x (C, T): float64 on the host,
    rounded to float32 parts, complex64 on ``device``; layout as
    :func:`stft_stack`. Separation entry points use it for the model input
    and the masked synthesis alike."""
    S = _host_stft(x, n_fft, hop_length)              # (C, N, F) complex128
    dev = resolve_device(device)
    re = torch.from_numpy(S.real.astype(np.float32)).to(dev)
    im = torch.from_numpy(S.imag.astype(np.float32)).to(dev)
    return _fnc(torch.complex(re, im), fnc)


def host_stereo_powers(x, n_fft: int, hop_length: int):
    """Unit-mean per-channel power spectra (R, L), host float64, returned
    as float32 numpy. x: (C, T) audio."""
    P = _host_stft_power(x, n_fft, hop_length)        # (C, F, N)
    SXR = np.maximum(P[0], _EPS)
    SXL = np.maximum(P[-1], _EPS)
    scale = max(0.5 * (SXR.mean() + SXL.mean()), _EPS)
    return ((SXR / scale).astype(np.float32),
            (SXL / scale).astype(np.float32))


def host_mean_power(x, n_fft: int, hop_length: int) -> np.ndarray:
    """Channel-mean power spectrum (F, N), host float64, float32 numpy out.
    x: (C, T)."""
    P = _host_stft_power(x, n_fft, hop_length).mean(axis=0)
    return np.maximum(P, _EPS).astype(np.float32)


def stereo_powers(X_cfn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-mean per-channel power spectra (R, L) from a (C, F, N) STFT on
    its device (fine for scale estimation; the SIMM-family fits take
    :func:`host_stereo_powers`)."""
    SXR = torch.clamp(X_cfn[0].abs() ** 2, min=_EPS)
    SXL = torch.clamp(X_cfn[-1].abs() ** 2, min=_EPS)
    scale = torch.clamp(0.5 * (SXR.mean() + SXL.mean()), min=_EPS)
    return SXR / scale, SXL / scale


def mean_power(X_fnc: torch.Tensor) -> torch.Tensor:
    """Channel-mean power spectrum (F, N) of a (F, N, C) STFT."""
    return torch.clamp((X_fnc.abs() ** 2).mean(dim=-1), min=_EPS)


def _istft_frames(specs: torch.Tensor, n_fft: int, hop_length: int,
                  length: int) -> torch.Tensor:
    """ISTFT of (..., frames, bins) spectra, batched over the lead axes."""
    lead = specs.shape[:-2]
    flat = specs.reshape((-1,) + specs.shape[-2:])
    audio = istft(flat, n_fft=n_fft, hop_length=hop_length, length=length)
    return audio.reshape(lead + (length,))


def masked_istft(X: torch.Tensor, gain: torch.Tensor, n_fft: int, hop_length: int,
                 length: int, fnc: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Wiener-style split: (X·gain, X − X·gain) → two (C, T) signals.

    X: (F, N, C) [``fnc``] or (C, F, N) complex STFT; gain broadcastable
    to X (real)."""
    lead_spec = X * gain
    acc_spec = X - lead_spec

    def synth(spec):
        s = spec.permute(2, 1, 0) if fnc else spec.permute(0, 2, 1)
        return _istft_frames(s, n_fft, hop_length, length)

    return synth(lead_spec), synth(acc_spec)


def images_istft(Y: torch.Tensor, n_fft: int, hop_length: int,
                 length: int) -> torch.Tensor:
    """Source-image STFTs Y (J, F, N, C) → time-domain images (J, C, T)."""
    return _istft_frames(Y.permute(0, 3, 2, 1), n_fft, hop_length, length)


def _trace_real(M: torch.Tensor) -> torch.Tensor:
    return M.diagonal(dim1=-2, dim2=-1).sum(-1).real


def _outer(a: torch.Tensor) -> torch.Tensor:
    """a aᴴ over the last axis."""
    return a[..., :, None] * a.conj()[..., None, :]


def empirical_spatial_cov(img: torch.Tensor, n_fft: int, hop_length: int,
                          diffuse: float = 0.05) -> torch.Tensor:
    """Trace-normalized empirical spatial covariance (F, C, C) of a signal
    (C, T), mixed with ``diffuse``·I so EM can move from it."""
    X = stft_stack(img, n_fft, hop_length, fnc=True)     # (F, N, C)
    C = X.shape[-1]
    Rf = _outer(X).mean(dim=1)                            # (F, C, C)
    tr = torch.clamp(_trace_real(Rf), min=_EPS)
    Rf = Rf * (C / tr)[..., None, None]
    eye = torch.eye(C, dtype=torch.complex64, device=X.device)
    return (1.0 - diffuse) * Rf + diffuse * eye


def steering_to_spatial(a: torch.Tensor, diffuse: float = 0.05) -> torch.Tensor:
    """Rank-1-plus-diffuse spatial covariances (J, F, C, C) from steering
    vectors a (J, F, C)."""
    aaH = _outer(a)
    tr = torch.clamp(_trace_real(aaH), min=_EPS)
    C = a.shape[-1]
    aaH = aaH * (C / tr)[..., None, None]
    eye = torch.eye(C, dtype=torch.complex64, device=a.device)
    return ((1.0 - diffuse) * aaH + diffuse * eye).to(torch.complex64)


def anechoic_steering(theta: torch.Tensor, delay: torch.Tensor,
                      freqs: torch.Tensor) -> torch.Tensor:
    """a_j(f) = [cosθ_j, sinθ_j·e^{−i2πfδ_j}] — (J, F, 2) complex64."""
    th = theta[:, None]
    dl = delay[:, None]
    ang = -2.0 * math.pi * freqs[None, :] * dl
    phase = torch.polar(torch.ones_like(ang), ang)
    a0 = torch.cos(th).expand(phase.shape).to(torch.complex64)
    a1 = (torch.sin(th) * phase).to(torch.complex64)
    return torch.stack([a0, a1], dim=-1)


def unit_power(X: torch.Tensor) -> torch.Tensor:
    """X / sqrt(mean |X|²) — unit-mean-power complex STFT (the separation
    models are scale-covariant; float32 factor chains overflow on raw
    power values)."""
    s = torch.clamp((X.abs() ** 2).mean(), min=_EPS)
    return X / torch.sqrt(s)


def stack_spatial(R_lead: torch.Tensor, R_acc: torch.Tensor,
                  n_copies: int) -> torch.Tensor:
    """[R_lead; R_acc × n_copies] — (1 + n_copies, F, C, C) complex."""
    return torch.cat([R_lead[None], R_acc[None].expand((n_copies,) + R_acc.shape)])
