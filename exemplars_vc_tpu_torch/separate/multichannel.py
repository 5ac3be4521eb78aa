"""Multichannel NMF source separation — the FASST local Gaussian model
(port of ``exemplars_vc_tpu/separate/multichannel.py``; pyfasst
``audioModel.py``: ``FASST`` :66, ``MultiChanNMFInst_FASST`` :2296,
``MultiChanNMFConv`` :2422).

Each source j has a spectral power v_j(f, n) = Σ_k W_j[f, k] H_j[k, n] and
a full-rank spatial covariance R_j(f) (C × C Hermitian); the mixture STFT
x(f, n) ∈ ℂ^C is zero-mean Gaussian with Σ_x(f, n) = Σ_j v_j(f, n) R_j(f).
EM (Ozerov & Févotte 2010):

E-step (all bins batched):
    G_j = v_j R_j Σ_x⁻¹,  ŷ_j = G_j x,  R̂_j = ŷ_j ŷ_jᴴ + (I − G_j) v_j R_j
M-step:
    R_j(f) = (1/N) Σ_n R̂_j(f, n) / v_j(f, n)
    z_j(f, n) = (1/C) Re tr(R_j(f)⁻¹ R̂_j(f, n))
    one IS-NMF multiplicative update of (W_j, H_j) toward z_j.

Every step is a batch of complex64 einsums over all (f, n) bins, which
torch sends to cuBLAS ``cgemm`` on a card; the package's device settings
keep TF32 off there (the composed EM goes NaN with reduced-precision
matmuls). C × C inverses are closed form for C ≤ 2. The loop runs n_em
iterations with no host synchronization; the per-iteration NLLs stay on the
device until the fit returns.

Spans (``obs.profiling``: recorded only while a profiler records, no host
sync): ``separate`` (:func:`separate_signal`; attrs C, T, J, K, n_em,
spectral_model) over ``separate.stft`` (the host STFT and its upload),
``separate.em`` (the fit; attrs F, N, C, J, K, n_em, n_inner) and
``separate.images`` (Wiener filter and ISTFT); inside a fit, one
``separate.estep`` an EM iteration (:func:`_spatial_estep`) and one
``separate.nmf`` around each iteration's IS-NMF updates. The counter
``separate_signal.em_iters`` counts the E-steps run, every fit's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.obs.profiling import Timer
from exemplars_vc_tpu_torch.separate.glue import (
    _outer,
    _trace_real,
    host_stft_stack,
    images_istft,
)

_EPS = 1e-10


class MultichannelNMF(NamedTuple):
    """Fitted model: W (J,F,K), H (J,K,N) real; R (J,F,C,C) complex."""

    W: torch.Tensor
    H: torch.Tensor
    R: torch.Tensor
    neg_log_like: torch.Tensor   # per-EM-iteration data negative log-likelihood


def _inv_hermitian(M: torch.Tensor) -> torch.Tensor:
    """Inverse of batched Hermitian PSD matrices (..., C, C): closed form
    for C = 1 and C = 2 (one reciprocal determinant), ``torch.linalg.inv``
    beyond."""
    C = M.shape[-1]
    if C == 1:
        return 1.0 / M
    if C == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        inv_det = 1.0 / (a * d - b * c)
        row0 = torch.stack([d, -b], dim=-1)
        row1 = torch.stack([-c, a], dim=-1)
        return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]
    return torch.linalg.inv(M)


def _hermitize(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.conj().transpose(-1, -2))


def _mixture_cov_inv(v: torch.Tensor, R: torch.Tensor):
    """Σ_x = Σ_j v_j R_j + δI with δ scaled to the mixture power, and its
    inverse: (Sigma, Sinv), each (F, N, C, C)."""
    C = R.shape[-1]
    eye = torch.eye(C, dtype=R.dtype, device=R.device)
    Sigma = torch.einsum("jfn,jfcd->fncd", v.to(R.dtype), R)
    delta = 1e-6 * _trace_real(Sigma) / C + 1e-12
    Sigma = Sigma + delta[..., None, None] * eye
    return Sigma, _inv_hermitian(Sigma)


def _spatial_estep(XX: torch.Tensor, v: torch.Tensor, R: torch.Tensor):
    """Shared E-step + spatial M-step of the FASST local Gaussian model.

    XX: (F, N, C, C) data outer products; v: (J, F, N) current spectral
    power model; R: (J, F, C, C) spatial covariances. Returns (R_new,
    scale, z, nll): the trace-normalized updated spatial covariances, the
    (J, F) scale to ship into the spectral model, the (J, F, N) posterior
    spectral statistics and the data negative log-likelihood under the
    CURRENT parameters (a 0-d tensor)."""
    separate_signal.em_iters += 1
    with Timer(XX.device, name="separate.estep"):
        C = XX.shape[-1]
        eye = torch.eye(C, dtype=XX.dtype, device=XX.device)
        Sigma, Sinv = _mixture_cov_inv(v, R)

        # Wiener gains and posterior moments, all sources at once
        vR = v[..., None, None] * R[:, :, None, :, :]                  # (J,F,N,C,C)
        G = torch.einsum("jfncd,fnde->jfnce", vR, Sinv)
        # ŷŷᴴ = G (x xᴴ) Gᴴ ; R̂ = ŷŷᴴ + (I − G) v R
        GX = torch.einsum("jfncd,fnde->jfnce", G, XX)
        yyH = torch.einsum("jfncd,jfned->jfnce", GX, G.conj())
        Rhat = yyH + vR - torch.einsum("jfncd,jfnde->jfnce", G, vR)

        # Σ_fn [log det Σ_x + xᴴ Σ_x⁻¹ x], non-increasing under EM
        if C == 2:
            det = (Sigma[..., 0, 0] * Sigma[..., 1, 1]
                   - Sigma[..., 0, 1] * Sigma[..., 1, 0]).real
        else:
            det = torch.linalg.det(Sigma).real
        quad = torch.einsum("fncd,fndc->fn", Sinv, XX).real
        nll = torch.sum(torch.log(torch.clamp(det, min=1e-30)) + quad)

        # M-step: spatial covariances, trace-normalized to C (energy → spectra)
        R_new = _hermitize(torch.mean(Rhat / v[..., None, None], dim=2))
        trR = torch.clamp(_trace_real(R_new), min=_EPS)
        R_new = R_new * (C / trR)[..., None, None]

        # a 1e-5·I ridge before inverting: a converged point source drives R_j(f)
        # to its rank-1 steering covariance, whose 2×2 determinant underflows in
        # float32 and turns the EM NaN
        Rinv = _inv_hermitian(R_new + 1e-5 * eye)
        z = torch.einsum("jfcd,jfndc->jfn", Rinv, Rhat).real / C
        return R_new, trR / C, torch.clamp(z, min=_EPS), nll


def _nmf_inner(z: torch.Tensor, W: torch.Tensor, H: torch.Tensor):
    """One IS multiplicative update of every source's (W_j, H_j) toward
    z_j, W then H, W's columns normalized with the scale into H."""
    hat = torch.clamp(W @ H, min=_EPS)
    num = (z / (hat * hat)) @ H.transpose(1, 2)
    den = (1.0 / hat) @ H.transpose(1, 2)
    W = W * (num / torch.clamp(den, min=_EPS))
    sumW = torch.clamp(W.sum(dim=1, keepdim=True), min=_EPS)       # (J,1,K)
    W = W / sumW
    H = H * sumW.transpose(1, 2)
    hat = torch.clamp(W @ H, min=_EPS)
    num = W.transpose(1, 2) @ (z / (hat * hat))
    den = W.transpose(1, 2) @ (1.0 / hat)
    return W, H * (num / torch.clamp(den, min=_EPS))


def _em_loop(X: torch.Tensor, W: torch.Tensor, H: torch.Tensor, R: torch.Tensor,
             n_em: int, n_nmf_inner: int) -> MultichannelNMF:
    """X: (F, N, C) complex64. Returns the fitted MultichannelNMF."""
    XX = _outer(X)                        # loop-invariant (F, N, C, C)
    nlls = []
    for _ in range(n_em):
        v = torch.clamp(W @ H, min=_EPS)                           # (J,F,N)
        R, scale, z, nll = _spatial_estep(XX, v, R)
        W = W * scale[..., None]
        with Timer(X.device, name="separate.nmf"):
            for _ in range(n_nmf_inner):
                W, H = _nmf_inner(z, W, H)
        nlls.append(nll)
    return MultichannelNMF(W, H, R, torch.stack(nlls))


def _wiener_images_v(X: torch.Tensor, v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Posterior source-image STFTs ŷ_j = v_j R_j Σ_x⁻¹ x — (J, F, N, C),
    for a stacked spectral power model v (J, F, N)."""
    v = torch.clamp(v, min=_EPS)
    _, Sinv = _mixture_cov_inv(v, R)
    vR = v[..., None, None] * R[:, :, None, :, :]
    G = torch.einsum("jfncd,fnde->jfnce", vR, Sinv)
    return torch.einsum("jfncd,fnd->jfnc", G, X)


def _wiener_images(X, W, H, R) -> torch.Tensor:
    """NMF-spectral-model wrapper around :func:`_wiener_images_v`."""
    return _wiener_images_v(X, W @ H, R)


def random_spatial_init(key: torch.Tensor, n_sources: int, F: int, C: int,
                        mix: float = 0.2,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Identity-plus-random-rank-1 spatial covariances (J, F, C, C).

    The complex perturbation draws its real and imaginary parts apart (from
    the two halves of ``split(key)``, on the CPU), so sources start with
    distinct inter-channel phase as well as gain."""
    kr, ki = prng.split(key)
    a = torch.complex(prng.normal(kr, (n_sources, C)), prng.normal(ki, (n_sources, C)))
    return _rank1_spatial(a, F, mix).to(resolve_device(device))


def _rank1_spatial(a: torch.Tensor, F: int, mix: float) -> torch.Tensor:
    """(1 − mix)·I + mix·C·a aᴴ/‖a‖², broadcast over F: (J, F, C, C)."""
    J, C = a.shape
    aaH = _outer(a)
    aaH = aaH / torch.clamp(_trace_real(aaH), min=_EPS)[:, None, None]
    R = (torch.eye(C, dtype=torch.complex64)[None] * (1.0 - mix)
         + mix * C * aaH.to(torch.complex64))
    return R[:, None].expand(J, F, C, C).contiguous()


def _as_complex(X, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(X, device=dev).to(torch.complex64)


def fit_multichannel_nmf(X, n_sources: int = 2, n_components: int = 4, n_em: int = 50,
                         n_nmf_inner: int = 1, key: torch.Tensor | None = None,
                         W_init=None, H_init=None, R_init=None,
                         device: str | torch.device = "cuda") -> MultichannelNMF:
    """Fit the multichannel NMF local Gaussian model to a mixture STFT.

    X: (F, N, C) complex mixture STFT (freq-major). Inits not provided are
    drawn from ``split(key, 3)`` (``key`` ``PRNGKey(0)`` when None), one
    subkey each for W, H and R: squared normals for W/H (pyfasst's
    convention), R identity plus a source-specific rank-1 perturbation
    (:func:`random_spatial_init`)."""
    dev = resolve_device(device)
    X = _as_complex(X, dev)
    F, N, C = X.shape
    J, K = n_sources, n_components
    kw, kh, kr = prng.split(prng.key_or_default(key), 3)
    W = (prng.normal(kw, (J, F, K)) ** 2 if W_init is None
         else torch.as_tensor(W_init, dtype=torch.float32))
    H = (prng.normal(kh, (J, K, N)) ** 2 if H_init is None
         else torch.as_tensor(H_init, dtype=torch.float32))
    R = (random_spatial_init(kr, J, F, C, device=dev) if R_init is None
         else _as_complex(R_init, dev))
    return _em_loop(X, W.to(dev, torch.float32), H.to(dev, torch.float32), R,
                    n_em, n_nmf_inner)


def separate_signal(x, n_sources: int = 2, n_components: int = 4, n_em: int = 50,
                    n_fft: int = 400, hop_length: int = 80,
                    key: torch.Tensor | None = None,
                    spectral_model: str = "nmf", spatial_init: str = "random",
                    device: str | torch.device = "cuda"):
    """Separate a multichannel signal x (C, T) into source images (J, C, T).

    pyfasst's ``FASST.estim_param_a_post_model`` +
    ``separate_spatial_filter_comp``: host float64 STFT → EM fit → Wiener
    source images → ISTFT. Returns (images on ``device``, the model).

    spectral_model: ``"nmf"`` or ``"hmm"`` / ``"shmm"`` (``n_components`` is
    then the number of HMM states). spatial_init: ``"random"`` or ``"demix"``
    (DEMIX direction clustering seeds R; stereo only)."""
    dev = resolve_device(device)
    x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
    x = x.astype(np.float32)
    C, T = x.shape
    with Timer(dev, name="separate", C=C, T=T, J=n_sources, K=n_components, n_em=n_em,
               spectral_model=spectral_model):
        with Timer(dev, name="separate.stft"):
            X = host_stft_stack(x, n_fft, hop_length, fnc=True, device=dev)   # (F, N, C)

        R_init = None
        if spatial_init == "demix":
            from exemplars_vc_tpu_torch.separate.demix import demix

            est = demix(x, n_sources=n_sources, n_fft=n_fft, hop_length=hop_length, device=dev)
            R_init = est.spatial_init(np.arange(X.shape[0]) / n_fft, device=dev)
        elif spatial_init != "random":
            raise ValueError(f"unknown spatial_init {spatial_init!r}")

        F, N, _ = X.shape
        hmm = spectral_model in ("hmm", "shmm")
        if not hmm and spectral_model != "nmf":
            raise ValueError(f"unknown spectral_model {spectral_model!r}")
        with Timer(dev, name="separate.em", F=F, N=N, C=C, J=n_sources, K=n_components,
                   n_em=n_em, n_inner=0 if hmm else 1):
            if hmm:
                from exemplars_vc_tpu_torch.separate.hmm import fit_multichannel_hmm

                model = fit_multichannel_hmm(
                    X, n_sources=n_sources, n_states=n_components, n_em=n_em,
                    sticky=spectral_model == "shmm", key=key, R_init=R_init, device=dev)
            else:
                model = fit_multichannel_nmf(
                    X, n_sources=n_sources, n_components=n_components, n_em=n_em,
                    key=key, R_init=R_init, device=dev)
        with Timer(dev, name="separate.images"):
            Y = _wiener_images(X, model.W, model.H, model.R)    # (J, F, N, C)
            images = images_istft(Y, n_fft, hop_length, T)
    return images, model


separate_signal.em_iters = 0
