"""The plain reference of one multichannel NMF separation, written for the
benchmark from the published model.

The model is the FASST local Gaussian model with an NMF spectral model
(Ozerov & Févotte, "Multichannel nonnegative matrix factorization in
convolutive mixtures for audio source separation", IEEE TASLP 18(3), 2010;
pyfasst ``audioModel.py``: ``FASST`` :66, ``MultiChanNMFInst_FASST`` :2296).
The mixture STFT x(f, n) ∈ ℂ^C is zero-mean Gaussian with covariance
Σ_x(f, n) = Σ_j v_j(f, n) R_j(f), where source j has the spectral power
v_j = W_j H_j (W_j ≥ 0 of F × K, H_j ≥ 0 of K × N) and the C × C Hermitian
spatial covariance R_j(f). One EM iteration:

- E-step, each bin (f, n) and source j: the Wiener gain
  G_j = v_j R_j Σ_x⁻¹, the posterior mean ŷ_j = G_j x and the posterior
  second moment R̂_j = ŷ_j ŷ_jᴴ + (I − G_j) v_j R_j, which this file forms as
  G_j (x xᴴ) G_jᴴ + v_j R_j − G_j v_j R_j;
- the data negative log-likelihood under the current parameters,
  Σ_fn [log det Σ_x + xᴴ Σ_x⁻¹ x];
- spatial M-step: R_j(f) = (1/N) Σ_n R̂_j(f, n) / v_j(f, n);
- spectral statistics: z_j(f, n) = (1/C) Re tr(R_j(f)⁻¹ R̂_j(f, n)), then
  one Itakura-Saito multiplicative update of W_j toward z_j and one of H_j
  (Févotte, Bertin & Durrieu 2009): W ← W ⊙ ((z ⊘ v̂²) Hᵀ) ⊘ (v̂^{∘−1} Hᵀ)
  with v̂ = W H, W's columns scaled to sum 1 and the scale carried into H,
  then H ← H ⊙ (Wᵀ (z ⊘ v̂²)) ⊘ (Wᵀ v̂^{∘−1}) with v̂ formed again.

After the last iteration each source's image is ŷ_j = G_j x from the fitted
model, brought back to the time domain by the window-sum-normalized ISTFT.

The inputs as the deployment computes them: the STFT in float64 on the host
(centered, reflect-padded, periodic hann), rounded to float32 parts; the
random start from ``PRNGKey(key)`` split in three: W and H squared standard
normals, R_j = (1 − 0.2)·I + 0.2·C·a_j a_jᴴ / ‖a_j‖² for a complex a_j whose
real and imaginary parts are normals from the two halves of the third key's
split.

Every product, the 2 × 2 ones included, goes through ``torch.matmul`` in
float32 / complex64, so the TF32 setting of :func:`precision` reaches all of
them; inverses and determinants are in closed form, for the stereo (C = 2)
recordings the benchmark sends.

Departures from the published model, each as the deployment computes it:

- Σ_x gets a ridge δ·I, δ = 1e-6·tr(Σ_x)/C + 1e-12;
- R_j(f) is trace-normalized to C after the M-step, and the scale tr/C is
  carried into W_j's rows;
- z_j inverts R_j(f) + 1e-5·I, not R_j(f);
- R_j(f) is made Hermitian, (R + Rᴴ)/2, after the M-step;
- v̂, z, the IS update's denominators and the trace are floored at 1e-10,
  the determinant in the log-likelihood at 1e-30.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference import dsp, prng

EPS = 1e-10
MIX = 0.2           # the random spatial start's weight on its rank-one part


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products, in TF32 where ``tf32`` (the control)."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def check_fit(fit: dict, channels: int) -> None:
    if fit["spectral_model"] != "nmf" or fit["spatial_init"] != "random":
        raise ValueError(f"the reference fits an NMF spectral model from a random start, "
                         f"not {fit['spectral_model']!r} from {fit['spatial_init']!r}")
    if channels != 2:
        raise ValueError(f"the reference separates stereo recordings, not {channels} channels")


def mixture_stft(x: np.ndarray, n_fft: int, hop: int, device) -> torch.Tensor:
    """x (C, T) → (F, N, C) complex64: the STFT in float64 on the host,
    rounded to float32 parts."""
    x = np.pad(np.asarray(x, np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop
    frames = x[:, hop * np.arange(n_frames)[:, None] + np.arange(n_fft)[None, :]]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    S = np.fft.rfft(frames * window, axis=-1).transpose(2, 1, 0)        # (F, N, C)
    return torch.complex(torch.from_numpy(S.real.astype(np.float32)),
                         torch.from_numpy(S.imag.astype(np.float32))).to(device)


def inits(key: int, J: int, K: int, F: int, N: int, C: int, device):
    """(W (J, F, K), H (J, K, N), R (J, F, C, C)) drawn from ``PRNGKey(key)``."""
    kw, kh, kr = prng.split(prng.PRNGKey(key), 3)
    W = prng.normal(kw, (J, F, K)) ** 2
    H = prng.normal(kh, (J, K, N)) ** 2
    k_re, k_im = prng.split(kr)
    a = torch.complex(prng.normal(k_re, (J, C)), prng.normal(k_im, (J, C)))
    aaH = a[:, :, None] * a.conj()[:, None, :]
    aaH = aaH / torch.clamp(trace(aaH), min=EPS)[:, None, None]
    R = torch.eye(C, dtype=torch.complex64) * (1.0 - MIX) + MIX * C * aaH.to(torch.complex64)
    R = R[:, None].expand(J, F, C, C).contiguous()
    return W.to(device), H.to(device), R.to(device)


def trace(M: torch.Tensor) -> torch.Tensor:
    """The real part of the trace of each C × C matrix."""
    return M.diagonal(dim1=-2, dim2=-1).sum(-1).real


def inverse(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of each 2 × 2 matrix."""
    a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / determinant(M)[..., None, None]


def determinant(M: torch.Tensor) -> torch.Tensor:
    """The determinant of each 2 × 2 matrix."""
    return M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]


def mixture_covariance(v: torch.Tensor, R: torch.Tensor):
    """(Σ_x, Σ_x⁻¹, v R) of v (J, F, N) and R (J, F, C, C): the first two
    (F, N, C, C), v R (J, F, N, C, C)."""
    C = R.shape[-1]
    vR = v[..., None, None].to(R.dtype) * R[:, :, None]                # (J, F, N, C, C)
    S = vR.sum(dim=0)
    delta = 1e-6 * trace(S) / C + 1e-12
    S = S + delta[..., None, None] * torch.eye(C, dtype=R.dtype, device=R.device)
    return S, inverse(S), vR


def em_step(XX: torch.Tensor, W, H, R):
    """One EM iteration on the data's outer products XX (F, N, C, C): (W, H,
    R, the NLL under the parameters it started from)."""
    C = XX.shape[-1]
    eye = torch.eye(C, dtype=R.dtype, device=R.device)
    v = torch.clamp(torch.matmul(W, H), min=EPS)                       # (J, F, N)
    S, S_inv, vR = mixture_covariance(v, R)
    G = torch.matmul(vR, S_inv)                                        # (J, F, N, C, C)
    yyH = torch.matmul(torch.matmul(G, XX), G.conj().transpose(-1, -2))
    R_hat = yyH + vR - torch.matmul(G, vR)

    quad = trace(torch.matmul(S_inv, XX))
    nll = torch.sum(torch.log(torch.clamp(determinant(S).real, min=1e-30)) + quad)

    R = (R_hat / v[..., None, None]).mean(dim=2)
    R = 0.5 * (R + R.conj().transpose(-1, -2))
    tr = torch.clamp(trace(R), min=EPS)
    R = R * (C / tr)[..., None, None]
    W = W * (tr / C)[..., None]
    z = trace(torch.matmul(inverse(R + 1e-5 * eye)[:, :, None], R_hat)) / C
    z = torch.clamp(z, min=EPS)

    Ht = H.transpose(1, 2)
    v_hat = torch.clamp(torch.matmul(W, H), min=EPS)
    W = W * (torch.matmul(z / (v_hat * v_hat), Ht)
             / torch.clamp(torch.matmul(1.0 / v_hat, Ht), min=EPS))
    colsum = torch.clamp(W.sum(dim=1, keepdim=True), min=EPS)           # (J, 1, K)
    W, H = W / colsum, H * colsum.transpose(1, 2)
    Wt = W.transpose(1, 2)
    v_hat = torch.clamp(torch.matmul(W, H), min=EPS)
    H = H * (torch.matmul(Wt, z / (v_hat * v_hat))
             / torch.clamp(torch.matmul(Wt, 1.0 / v_hat), min=EPS))
    return W, H, R, nll


def fit(x: torch.Tensor, W, H, R, n_em: int):
    """x (F, N, C) complex64 and a start → (W, H, R, NLLs (n_em,))."""
    XX = x[..., :, None] * x.conj()[..., None, :]                      # (F, N, C, C)
    nlls = []
    for _ in range(n_em):
        W, H, R, nll = em_step(XX, W, H, R)
        nlls.append(nll)
    return W, H, R, torch.stack(nlls)


def images(x: torch.Tensor, W, H, R, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """The source images (J, C, T): ŷ_j = G_j x from the fitted model, then
    the ISTFT of each source and channel."""
    v = torch.clamp(torch.matmul(W, H), min=EPS)
    _, S_inv, vR = mixture_covariance(v, R)
    Y = torch.matmul(torch.matmul(vR, S_inv), x[..., :, None])[..., 0]     # (J, F, N, C)
    return dsp.istft(Y.permute(0, 3, 2, 1), n_fft=n_fft, hop_length=hop, length=length)


def separate(x: np.ndarray, fit_settings: dict, device):
    """The images (J, C, T) of the mixture x (C, T) and the fit's NLLs."""
    check_fit(fit_settings, x.shape[0])
    n_fft, hop = fit_settings["n_fft"], fit_settings["hop_length"]
    X = mixture_stft(x, n_fft, hop, device)
    F, N, C = X.shape
    W, H, R = inits(fit_settings["key"], fit_settings["n_sources"],
                    fit_settings["n_components"], F, N, C, device)
    W, H, R, nlls = fit(X, W, H, R, fit_settings["n_em"])
    return images(X, W, H, R, n_fft, hop, x.shape[-1]), nlls
