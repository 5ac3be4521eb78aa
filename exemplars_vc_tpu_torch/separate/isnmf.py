"""Itakura-Saito NMF multiplicative updates, plain and source/filter (port
of ``exemplars_vc_tpu/separate/isnmf.py``; pyfasst ``tools/nmf.py``).

Full float32 matmuls throughout: the IS updates divide by v², and the
package's device settings keep TF32 off (``device.py``). Random inits are
drawn on the CPU from the JAX package's keys, splits and samplers
(``prng``) and then moved, so one key gives the JAX package's start on
every device.
"""

from __future__ import annotations

import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.device import resolve_device

_EPS = 1e-10  # pyfasst tools/nmf.py:22


def is_divergence(SX: torch.Tensor, SX_hat: torch.Tensor) -> torch.Tensor:
    """Itakura-Saito divergence D_IS(SX ‖ SX_hat), summed over all bins."""
    r = SX / torch.clamp(SX_hat, min=_EPS)
    return torch.sum(r - torch.log(torch.clamp(r, min=_EPS)) - 1.0)


def _div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.clamp(den, min=_EPS)


def _normalize_columns(W: torch.Tensor, H: torch.Tensor):
    """W columns to sum 1, the scale shipped into H's rows (a zero column
    keeps its scale)."""
    sumW = W.sum(dim=0)
    sumW = torch.where(sumW == 0.0, torch.ones_like(sumW), sumW)
    return W / sumW, H * sumW[:, None]


def _update_W(SX, W, H):
    """One IS multiplicative update of W (H fixed), then column-normalize W
    and ship the energy into H — pyfasst ``tools/nmf.py:136-147``."""
    hat = W @ H
    num = _div(SX, hat * hat) @ H.T
    den = _div(torch.ones_like(hat), hat) @ H.T
    return _normalize_columns(W * _div(num, den), H)


def _update_H(SX, W, H):
    """One IS multiplicative update of H (W fixed) — ``tools/nmf.py:149-157``."""
    hat = W @ H
    num = W.T @ _div(SX, hat * hat)
    den = W.T @ _div(torch.ones_like(hat), hat)
    return H * _div(num, den)


def _init(key: torch.Tensor, shape, provided, dev, squared: bool = True):
    """A provided init as float32 on ``dev``, else g² (or (1 + g)²) of the
    standard normal draw of ``key`` (on the CPU, then moved)."""
    if provided is not None:
        return torch.as_tensor(provided, dtype=torch.float32, device=dev)
    g = prng.normal(key, shape)
    return (g ** 2 if squared else (1.0 + g) ** 2).to(dev)


def is_nmf(SX, n_components: int = 10, n_iter: int = 10,
           key: torch.Tensor | None = None, W_init=None, H_init=None,
           update_W: bool = True, update_H: bool = True,
           device: str | torch.device = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """IS-divergence NMF of a power spectrogram: SX (F, N) ≈ W (F, K) · H (K, N).

    pyfasst ``NMF_decomp_init`` semantics: squared-normal inits where not
    provided (W from the first and H from the second half of ``split(key)``,
    ``key`` ``PRNGKey(0)`` when None), W column-normalized after each W
    update with the scale shipped into H, per-factor update switches. Per
    iteration: W then H, each against a freshly computed reconstruction."""
    dev = resolve_device(device)
    SX = torch.as_tensor(SX, dtype=torch.float32, device=dev)
    F, N = SX.shape
    kw, kh = prng.split(prng.key_or_default(key))
    W = _init(kw, (F, n_components), W_init, dev)
    H = _init(kh, (n_components, N), H_init, dev)
    if update_W:  # tools/nmf.py:130-131
        W = W / W.sum(dim=0)
    for _ in range(n_iter):
        if update_W:
            W, H = _update_W(SX, W, H)
        if update_H:
            H = _update_H(SX, W, H)
    return W, H


def sf_nmf(SX, n_components: int = 10, n_filt_components: int = 10,
           n_res_components: int = 2, n_iter: int = 10,
           key: torch.Tensor | None = None,
           W_init=None, H_init=None, W_filt_init=None, H_filt_init=None,
           W_res_init=None, H_res_init=None,
           update_W: bool = True, update_H: bool = True, update_W_filt: bool = True,
           update_H_filt: bool = True, update_res: bool = True,
           device: str | torch.device = "cuda"):
    """Source/filter NMF: SX ≈ (W·H) ⊙ (WFilt·HFilt) + Wres·Hres.

    pyfasst ``SFNMF_decomp_init`` (``tools/nmf.py:161-360``): updates in
    the order W, H, WFilt, HFilt (per-frame filter renormalization shipping
    energy into H), then the residual pair (``update_res=False`` freezes
    it). Returns (W, H, WFilt, HFilt, Wres, Hres). Inits not provided are
    drawn from ``split(key, 6)`` (``key`` ``PRNGKey(0)`` when None), one
    subkey a factor in that order: g² for the first four, (1 + g)² for the
    residual pair."""
    dev = resolve_device(device)
    SX = torch.as_tensor(SX, dtype=torch.float32, device=dev)
    F, N = SX.shape
    ks = prng.split(prng.key_or_default(key), 6)
    W = _init(ks[0], (F, n_components), W_init, dev)
    H = _init(ks[1], (n_components, N), H_init, dev)
    WF = _init(ks[2], (F, n_filt_components), W_filt_init, dev)
    HF = _init(ks[3], (n_filt_components, N), H_filt_init, dev)
    WR = _init(ks[4], (F, n_res_components), W_res_init, dev, squared=False)
    HR = _init(ks[5], (n_res_components, N), H_res_init, dev, squared=False)
    if update_W:
        W = W / W.sum(dim=0)
    if update_W_filt:
        WF = WF / WF.sum(dim=0)

    def hat(W, H, WF, HF, WR, HR):
        SF0, SPHI = W @ H, WF @ HF
        return SF0, SPHI, SF0 * SPHI + WR @ HR

    for _ in range(n_iter):
        if update_W:  # tools/nmf.py:234-254
            _, SPHI, h = hat(W, H, WF, HF, WR, HR)
            num = _div(SX * SPHI, h * h) @ H.T
            den = _div(SPHI, h) @ H.T
            W, H = _normalize_columns(W * _div(num, den), H)
        if update_H:  # tools/nmf.py:256-268
            _, SPHI, h = hat(W, H, WF, HF, WR, HR)
            H = H * _div(W.T @ _div(SX * SPHI, h * h), W.T @ _div(SPHI, h))
        if update_W_filt:  # tools/nmf.py:276-298
            SF0, _, h = hat(W, H, WF, HF, WR, HR)
            num = _div(SX * SF0, h * h) @ HF.T
            den = _div(SF0, h) @ HF.T
            WF, HF = _normalize_columns(WF * _div(num, den), HF)
        if update_H_filt:  # tools/nmf.py:300-327
            SF0, _, h = hat(W, H, WF, HF, WR, HR)
            HF = HF * _div(WF.T @ _div(SX * SF0, h * h), WF.T @ _div(SF0, h))
            # per-frame renormalization of the filter activations, energy → H
            sumH = HF.sum(dim=0)
            H = H * sumH[None, :]
            sumH = torch.where(sumH == 0.0, torch.ones_like(sumH), sumH)
            HF = HF / sumH[None, :]
        if update_res:  # tools/nmf.py:328-359
            _, _, h = hat(W, H, WF, HF, WR, HR)
            num = _div(SX, h * h) @ HR.T
            den = _div(torch.ones_like(h), h) @ HR.T
            WR, HR = _normalize_columns(WR * _div(num, den), HR)
            _, _, h = hat(W, H, WF, HF, WR, HR)
            HR = HR * _div(WR.T @ _div(SX, h * h), WR.T @ _div(torch.ones_like(h), h))
    return W, H, WF, HF, WR, HR
