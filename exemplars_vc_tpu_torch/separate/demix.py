"""DEMIX spatial clustering — anechoic mixing-direction estimation (port of
``exemplars_vc_tpu/separate/demix.py``; pyfasst ``demixTF.py``: ``DEMIX``
:106, ``comp_pcafeatures`` :448, ``comp_clusters`` :155,
``identify_deltaT`` :274, ``steeringVectorsFromCentroids`` :905).

For each source of a stereo mixture: a pan angle θ (relative channel gain)
and an inter-channel delay δ, from the time-frequency points whose local
spatial covariance is close to rank 1. On the device: the local covariances
of all bins (a separable box filter of the outer-product spectrogram), the
closed-form 2×2 eigen-features and their confidence, the
confidence-weighted θ histogram, a fixed-iteration weighted mean-shift of
the centroids and the delay search as one complex contraction (points ×
candidate delays). On the host: peak picking on the small histogram.

The histogram is a scatter-add; on a card ``index_add_`` adds in atomic
order, so its bins differ from a CPU run's in the last bits. The peaks it
picks are the same on well-separated sources.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.separate.glue import (
    _outer,
    anechoic_steering,
    steering_to_spatial,
    stft_stack,
)

_EPS = 1e-12


class DemixEstimate(NamedTuple):
    """Estimated anechoic mixing parameters for J sources (stereo).

    theta: (J,) pan angles in [0, π/2] — direction [cosθ, sinθ];
    delay: (J,) inter-channel delays in SAMPLES (channel 1 relative to 0);
    weight: (J,) total cluster confidence mass (sorted descending);
    hist: (n_bins,) the confidence-weighted θ histogram (diagnostics).
    """

    theta: np.ndarray
    delay: np.ndarray
    weight: np.ndarray
    hist: np.ndarray

    def steering_vectors(self, freqs: np.ndarray,
                         device: str | torch.device = "cuda") -> torch.Tensor:
        """Anechoic steering vectors a_j(f) — (J, F, 2) complex64.

        freqs: (F,) frequencies in CYCLES PER SAMPLE (bin / n_fft);
        a_j(f) = [cosθ_j, sinθ_j · e^{-i2πf δ_j}]."""
        dev = resolve_device(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return anechoic_steering(f32(self.theta), f32(self.delay), f32(freqs))

    def spatial_init(self, freqs: np.ndarray, diffuse: float = 0.05,
                     device: str | torch.device = "cuda") -> torch.Tensor:
        """Rank-1-plus-diffuse spatial covariances R_j(f) — (J, F, 2, 2):
        ``(1−diffuse)·a_j a_jᴴ·C/‖a_j‖² + diffuse·I`` (a pure rank-1 init is a
        fixed point of zero-variance directions)."""
        return steering_to_spatial(self.steering_vectors(freqs, device=device),
                                   float(np.float32(diffuse)))


def _box_smooth(M: torch.Tensor, kf: int, kn: int) -> torch.Tensor:
    """Separable box filter over the leading two axes (F, N, ...) of M, edge
    padded by (k//2, (k−1)//2) on each axis."""
    def smooth_axis(x, k, axis):
        if k <= 1:
            return x
        n = x.shape[axis]
        idx = torch.clamp(torch.arange(-(k // 2), n + (k - 1) // 2, device=x.device),
                          0, n - 1)
        windows = x.index_select(axis, idx).unfold(axis, k, 1)   # window last
        return (windows * (1.0 / k)).sum(-1)

    return smooth_axis(smooth_axis(M, kf, 0), kn, 1)


def _tf_features(X: torch.Tensor, kf: int, kn: int, n_bins: int):
    """Per-TF-bin direction features from a stereo STFT X (F, N, 2).

    Returns (theta, phase, conf, hist): θ ∈ [0, π/2] principal-direction pan
    angle, inter-channel phase at the bin, DEMIX confidence (principal /
    residual local-variance ratio, log-scaled), and the confidence-weighted
    θ histogram over ``n_bins`` bins."""
    Rloc = _box_smooth(_outer(X), kf, kn)                         # (F, N, 2, 2)

    a = Rloc[..., 0, 0].real
    d = Rloc[..., 1, 1].real
    b = Rloc[..., 0, 1]
    # 2×2 Hermitian eigenvalues: λ = (a+d)/2 ± sqrt(((a−d)/2)² + |b|²)
    half = 0.5 * (a + d)
    disc = torch.sqrt(torch.clamp(0.25 * (a - d) ** 2 + b.abs() ** 2, min=0.0))
    lam1 = half + disc
    lam2 = torch.clamp(half - disc, min=0.0)
    # principal eigenvector (up to phase): v ∝ [b, λ1 − a]; fully degenerate
    # bins land at θ = 0 with ~zero confidence
    theta = torch.atan2(torch.clamp(lam1 - a, min=0.0), torch.clamp(b.abs(), min=_EPS))
    # arg conj(b) = arg E[x̄0 x1] = −2πfδ for a source delayed δ on channel 1
    phase = torch.angle(b.conj() + _EPS)

    # how rank-1 the local covariance is, weighted by power
    # (demixTF.py:448-476 comp_pcafeatures / :92 confidenceFromVar)
    conf = (torch.log1p(lam1 / torch.maximum(lam2, _EPS * torch.clamp(lam1, min=_EPS)))
            * torch.log1p(lam1 / torch.clamp(lam1.mean(), min=_EPS)))

    idx = torch.clamp((theta / (0.5 * math.pi) * n_bins).to(torch.int64), 0, n_bins - 1)
    hist = torch.zeros(n_bins, dtype=torch.float32, device=X.device)
    hist.index_add_(0, idx.reshape(-1), conf.reshape(-1))
    return theta, phase, conf, hist


def _refine_centroids(theta, conf, cents, width: float, n_refine: int):
    """Fixed-iteration weighted mean-shift of θ centroids (J,)."""
    th = theta.reshape(-1)
    w = conf.reshape(-1)
    for _ in range(n_refine):
        # soft membership: within ±width of each centroid
        m = (torch.abs(th[None, :] - cents[:, None]) < width).to(torch.float32) * w
        cents = (m @ th) / torch.clamp(m.sum(dim=1), min=_EPS)
    return cents


def _delay_scores(theta, phase, conf, freqs, cents, width: float, delays):
    """Candidate-delay scores per cluster: (J, D).

    score[j, d] = Σ_{bins near θ_j} conf · cos(phase + 2π f δ_d), maximal
    where the candidate cancels the measured −2πfδ phase ramp: the real part
    of one (J × points) · (points × D) complex contraction, the matmul form
    of DEMIX's cross-correlation delay search (demixTF.py:274-351)."""
    th = theta.reshape(-1)
    ph = phase.reshape(-1)
    f = freqs.reshape(-1)
    member = (torch.abs(th[None, :] - cents[:, None]) < width).to(torch.float32)
    z = conf.reshape(-1) * torch.polar(torch.ones_like(ph), ph)              # (P,)
    ang = 2.0 * math.pi * f[:, None] * delays[None, :]
    basis = torch.polar(torch.ones_like(ang), ang)                            # (P, D)
    return ((member * z[None, :]) @ basis).real


def demix(x, n_sources: int | None = None, n_fft: int = 1024, hop_length: int = 256,
          neighborhood: tuple[int, int] = (3, 3), n_bins: int = 90, max_sources: int = 8,
          peak_rel_threshold: float = 0.2, max_delay: float = 8.0, n_delays: int = 129,
          n_refine: int = 4, device: str | torch.device = "cuda") -> DemixEstimate:
    """Estimate anechoic mixing directions of a stereo mixture x (2, T).

    STFT → batched local-covariance PCA features → confidence-weighted θ
    histogram → peak picking (host; ``n_sources=None`` keeps peaks above
    ``peak_rel_threshold``·max as pyfasst's adaptive thresholding does,
    otherwise the top ``n_sources``) → centroid refinement → one
    contraction delay search per cluster over ±``max_delay`` samples."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                                   np.float32), device=dev)
    if x.ndim != 2 or x.shape[0] != 2:
        raise ValueError(f"demix expects a stereo signal (2, T), got {tuple(x.shape)}")
    X = stft_stack(x, n_fft, hop_length, fnc=True)       # (F, N, 2)
    kf, kn = neighborhood

    theta, phase, conf, hist = _tf_features(X, kf, kn, n_bins)
    hist_np = hist.cpu().numpy()

    # ---- host-side peak picking on the small histogram ---------------------
    ext = np.concatenate([[hist_np[0] - 1], hist_np, [hist_np[-1] - 1]])
    is_peak = (hist_np >= ext[:-2]) & (hist_np >= ext[2:])
    peak_idx = np.nonzero(is_peak)[0]
    peak_val = hist_np[peak_idx]
    order = np.argsort(-peak_val)
    peak_idx, peak_val = peak_idx[order], peak_val[order]
    if n_sources is None:
        keep = peak_val >= peak_rel_threshold * (peak_val[0] if len(peak_val) else 1.0)
        peak_idx, peak_val = peak_idx[keep][:max_sources], peak_val[keep][:max_sources]
    else:
        # merge adjacent-bin duplicates before truncating
        dedup: list[int] = []
        for i in peak_idx:
            if all(abs(i - j) > 1 for j in dedup):
                dedup.append(int(i))
            if len(dedup) == n_sources:
                break
        peak_idx = np.asarray(dedup, np.int64)
        if len(peak_idx) < n_sources:
            # fewer distinct peaks than requested sources: fill with evenly
            # spaced angles so the caller always gets n_sources
            fill = np.linspace(0, n_bins - 1, n_sources - len(peak_idx) + 2,
                               dtype=np.int64)[1:-1]
            peak_idx = np.concatenate([peak_idx, fill])[:n_sources]
        peak_val = hist_np[peak_idx]
    if len(peak_idx) == 0:
        peak_idx, peak_val = np.asarray([n_bins // 2]), np.asarray([1.0])

    cents0 = (peak_idx.astype(np.float32) + 0.5) / n_bins * (0.5 * np.pi)
    width = float(np.float32(0.5 * np.pi / n_bins * 3.0))
    cents = _refine_centroids(theta, conf, torch.as_tensor(cents0, device=dev), width,
                              n_refine)

    # ---- per-cluster delay over a static candidate grid --------------------
    F = X.shape[0]
    freqs = (torch.arange(F, dtype=torch.float32, device=dev) / n_fft)[:, None] \
        .expand(theta.shape)
    delays = torch.linspace(-max_delay, max_delay, n_delays, dtype=torch.float32,
                            device=dev)
    scores = _delay_scores(theta, phase, conf, freqs, cents, width, delays)
    delay = delays[torch.argmax(scores, dim=1)].cpu().numpy()

    # total confidence mass per cluster, for ranking
    th = theta.reshape(-1).cpu().numpy()
    w = conf.reshape(-1).cpu().numpy()
    cents_np = cents.cpu().numpy()
    mass = np.array([w[np.abs(th - c) < width].sum() for c in cents_np])
    order = np.argsort(-mass)
    return DemixEstimate(theta=cents_np[order], delay=delay[order], weight=mass[order],
                         hist=hist_np)
