"""Fast Griffin-Lim phase reconstruction (port of
``exemplars_vc_tpu/dsp/griffin_lim.py``), plain torch over ``torch.fft``.

Each iteration projects mag∘angles onto consistent spectrograms (ISTFT then
STFT at the magnitude's natural length, trimmed to its frame count: the
centered, reflect-padded projection, whose fixed point is the production's),
then extrapolates with momentum μ/(1+μ) (Perraudin et al. 2013; μ = 0 is the
classic update).

Which route the iterations take is decided up front from the device and the
shape alone:

- On a CUDA tensor (``_fused=True``) whose shape
  ``griffin_lim_cuda.fused_route`` accepts (``n_iter > 0``, hop divides
  n_fft, a tile that fits shared memory: up to 19 frames an SM at n_fft 400,
  so 2,508 frames on 132 SMs, ~25 s; F ≥ 4 for the reflect pad), all
  iterations are one cooperative launch of the fused kernel with
  ``center=True``, which computes this same centered projection in float64
  (``griffin_lim.fused`` counts these calls). Every served and streamed
  synthesis takes it.
- Any other shape, a CPU tensor, or ``_fused=False`` runs the eager loop on
  the tensor's device.

The fused route differs from the eager float32 loop only in rounding
(float64 transforms in place of float32 cuFFT).
"""

from __future__ import annotations

import math

import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import fused_route, gl_angles_fused
from exemplars_vc_tpu_torch.dsp.stft import istft, stft


def _iterate(mag: torch.Tensor, angles: torch.Tensor, prev: torch.Tensor, n_fft: int,
             hop_length: int, alpha: float, n_iter: int):
    for _ in range(n_iter):
        y = istft(mag * angles, n_fft=n_fft, hop_length=hop_length)
        rebuilt = stft(y, n_fft=n_fft, hop_length=hop_length)[: mag.shape[0]]
        t = rebuilt - alpha * prev
        angles = t / torch.clamp(torch.abs(t), min=1e-16)
        prev = rebuilt
    return angles, prev


def griffin_lim(magnitude: torch.Tensor, n_fft: int = 400, hop_length: int = 80,
                n_iter: int = 300, length: int | None = None, momentum: float = 0.9,
                key: torch.Tensor | None = None,
                init_phase: torch.Tensor | None = None,
                return_phase: bool = False, _fused: bool = True):
    """(n_frames, n_bins) magnitude → time signal.

    ``init_phase``: a complex STFT with at least ``n_frames`` frames whose
    angles seed the iteration (the source utterance's phase on the
    conversion path); exactly-zero bins get unit phase. Without it the
    phases start uniform-random, 2π·``uniform(key)`` (``key`` ``PRNGKey(0)``
    when None, as in the JAX package; drawn on the CPU, then moved).
    On a CUDA tensor the iterations run in the fused kernel where its shape
    allows, else in the eager loop (module docstring); a launch that fails
    raises."""
    mag = torch.clamp(magnitude, min=0.0).float()
    if init_phase is not None:
        ip = init_phase[: mag.shape[0]].to(torch.complex64)
        a = torch.abs(ip)
        angles = torch.where(a > 0.0, ip / torch.clamp(a, min=1e-16),
                             torch.ones((), dtype=torch.complex64, device=mag.device))
    else:
        u = prng.uniform(prng.key_or_default(key), mag.shape).to(mag.device)
        angles = torch.polar(torch.ones_like(u), 2.0 * math.pi * u)

    if _fused and mag.device.type == "cuda" and fused_route(
            mag.shape[0], n_fft, hop_length, n_iter,
            torch.cuda.get_device_properties(mag.device).multi_processor_count):
        angles = gl_angles_fused(mag, angles, n_fft, hop_length, n_iter, momentum, center=True)
        griffin_lim.fused += 1
    else:
        angles, _ = _iterate(mag, angles, torch.zeros_like(angles), n_fft, hop_length,
                             momentum / (1.0 + momentum), n_iter)
    y = istft(mag * angles, n_fft=n_fft, hop_length=hop_length, length=length)
    if return_phase:
        return y, angles
    return y


griffin_lim.fused = 0
