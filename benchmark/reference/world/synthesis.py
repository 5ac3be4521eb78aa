"""WORLD-class synthesis: a harmonic + shaped-noise model (port of
``exemplars_vc_tpu/world/synthesis.py``), from the same inputs as
``pw.synthesize`` (f0, spectral envelope sp, aperiodicity ap).

- per-sample phase φ[t] = 2π·cumsum(f0↑)/sr (the running sum in the
  reference's float32 order, ``world._ops.cumsum``);
- harmonic amplitudes a_k = √(4·sp(k·f0)·f0/sr)·√(1 − ap(k·f0)²), read by
  interpolation and upsampled linearly in time;
- minimum-phase harmonic phases from the envelope's real cepstrum;
- periodic part Σ_k a_k[t]·cos(k·φ[t] + θ_k[t]);
- noise part: white noise, STFT-shaped by √sp·ap, inverted by the ISTFT.

The noise is the reference's own: ``normal(key, (n,))`` of the port's
counterpart of ``jax.random`` (``prng``; ``key`` ``PRNGKey(0)`` when None),
drawn on the CPU and moved to the signals' device. The default key's draw
is kept on each device and sliced: element i of a draw depends only on the
key and i, so a draw of n samples is the first n of any longer draw.
Constants are combined as XLA compiles
the reference: a division by a constant is a product with its float32
reciprocal, and 2π/sr is one float32 product. The phase accumulates over
~50k samples and k·φ reaches 10⁵ rad, so its last bits show in the audio.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import prng
from benchmark.reference.dsp import istft, stft
from benchmark.reference.world._ops import cumsum, gather_last


def _recip(c: float) -> float:
    """1/c rounded to float32."""
    return float(np.float32(1.0 / c))


def _two_pi_over(sr: int) -> float:
    """2π·(1/sr) as one float32 product of float32 factors."""
    return float(np.float32(2.0 * math.pi) * np.float32(_recip(sr)))


_NOISE_CACHE_MAX = 1 << 22                  # samples (16 MB, 4.4 min at 16 kHz)
_DEFAULT_NOISE: dict[torch.device, torch.Tensor] = {}


def _default_noise(n: int, dev: torch.device) -> torch.Tensor:
    """``normal(PRNGKey(0), (n,))`` on ``dev``, from the longest such draw
    made on ``dev`` so far (redrawn when a longer one is asked for)."""
    if n > _NOISE_CACHE_MAX:
        return prng.normal(prng.PRNGKey(0), (n,)).to(dev)
    have = _DEFAULT_NOISE.get(dev)
    if have is None or len(have) < n:
        have = _DEFAULT_NOISE[dev] = prng.normal(prng.PRNGKey(0), (n,)).to(dev)
    return have[:n]


def _upsample_frames(values: torch.Tensor, hop: int, n_samples: int) -> torch.Tensor:
    """(F, ...) frame values → (T, ...) a sample, by linear interpolation."""
    Fr = values.shape[0]
    t = torch.arange(n_samples, device=values.device) * _recip(hop)
    lo = torch.clamp(torch.floor(t).to(torch.int64), 0, Fr - 1)
    hi = torch.clamp(lo + 1, 0, Fr - 1)
    frac = (t - lo).reshape((-1,) + (1,) * (values.dim() - 1))
    return values[lo] * (1.0 - frac) + values[hi] * frac


def synthesize(f0: torch.Tensor, sp: torch.Tensor, ap: torch.Tensor, sr: int = 16000,
               frame_period_ms: float = 5.0, fft_size: int = 1024, max_harmonics: int = 96,
               key: torch.Tensor | None = None) -> torch.Tensor:
    """f0 (F,), sp (F, B), ap (F, B) → waveform ((F − 1)·hop,)."""
    hop = int(round(sr * frame_period_ms / 1000.0))
    Fr, B = sp.shape
    n_samples = (Fr - 1) * hop
    dev = sp.device
    voiced = (f0 > 0).to(sp.dtype)
    f0_safe = torch.where(f0 > 0, f0, torch.full_like(f0, 150.0))

    # periodic component
    f0_t = _upsample_frames(f0_safe, hop, n_samples)
    voiced_t = _upsample_frames(voiced, hop, n_samples)
    phase = cumsum(f0_t) * _two_pi_over(sr)
    k = torch.arange(1, max_harmonics + 1, dtype=sp.dtype, device=dev)
    bin_hz = sr / fft_size
    harm_hz = f0_safe[:, None] * k                                        # (F, K)
    pos = torch.clamp(harm_hz * _recip(bin_hz), 0.0, B - 1.001)
    lo = torch.floor(pos).to(torch.int64)
    frac = pos - lo
    hi = torch.clamp(lo + 1, max=B - 1)
    sp_k = gather_last(sp, lo) * (1 - frac) + gather_last(sp, hi) * frac
    ap_k = gather_last(ap, lo) * (1 - frac) + gather_last(ap, hi) * frac
    nyq_mask = (harm_hz < 0.495 * sr).to(sp.dtype)
    # analyzer-consistent gain: a harmonic series with a_k² = 4·sp(k·f0)·f0/sr
    # re-analyzes to the same sp; the periodic power fraction is 1 − ap²
    amp = torch.sqrt(torch.clamp(4.0 * sp_k * f0_safe[:, None] * _recip(sr), min=0.0))
    amp = amp * torch.sqrt(torch.clamp(1.0 - ap_k * ap_k, min=0.0)) * nyq_mask * voiced[:, None]

    # minimum-phase harmonic phases: arg H(ω) = −Σ_{τ>0} 2·c_τ·sin(ωτ), c the
    # real cepstrum of ½·log sp
    n_ceps = 64
    log_half = 0.5 * torch.log(torch.clamp(sp, min=1e-20))
    ceps = torch.fft.irfft(log_half.to(torch.complex64), n=2 * (B - 1))[:, 1:n_ceps]
    tau = torch.arange(1, n_ceps, dtype=sp.dtype, device=dev)
    omega_k = harm_hz * _two_pi_over(sr)
    sin_basis = torch.sin(omega_k[:, :, None] * tau)
    theta = -2.0 * torch.einsum("ft,fkt->fk", ceps, sin_basis)

    amp_t = _upsample_frames(amp, hop, n_samples)
    theta_t = _upsample_frames(theta, hop, n_samples)
    y_per = torch.sum(amp_t * torch.cos(phase[:, None] * k + theta_t), dim=-1) * voiced_t

    # aperiodic component
    noise = (_default_noise(n_samples, dev) if key is None
             else prng.normal(key, (n_samples,)).to(dev))
    N = stft(noise.to(sp.dtype), n_fft=fft_size, hop_length=hop, window="hann")
    Fn = min(N.shape[0], Fr)
    shape = torch.sqrt(torch.clamp(sp[:Fn], min=0.0)) * ap[:Fn]
    y_ap = istft(N[:Fn] * shape, n_fft=fft_size, hop_length=hop, window="hann",
                 length=n_samples)
    return y_per + y_ap
