"""HMM spectral models for separation — pyfasst's MultiChanHMM (port of
``exemplars_vc_tpu/separate/hmm.py``; pyfasst ``audioModel.py``:
``MultiChanHMM`` :2510-2550, the GEM iteration :1728-1930).

A source's spectral power is ONE active spectral state per frame,
v_j(f, n) = W_j[f, s_j(n)], the state sequence decoded by max-sum Viterbi
over per-frame Itakura-Saito costs plus log transition penalties; for the
'free' prior the transition matrix is re-estimated from transition counts.
'SHMM' keeps pyfasst's fixed sticky prior (0.9 self-transition).

The per-state cost matrix is one matmul plus rank-1 log terms; one-hot
state indicators make the M-step matmuls (state spectra V·Pᵀ/counts,
transition counts P[:, :-1]·P[:, 1:]ᵀ). All sources decode in one Viterbi
sweep, each with its own transition matrix (``align.viterbi.viterbi_paths``):
a Python loop over frames of a few launches each, which makes this path
launch-bound on a card. The multichannel variant reuses the FASST spatial
E-step of ``separate.multichannel`` and swaps only the spectral M-step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.align.viterbi import viterbi_paths
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.separate.glue import _outer
from exemplars_vc_tpu_torch.separate.multichannel import (
    MultichannelNMF,
    _as_complex,
    _rank1_spatial,
    _spatial_estep,
)

_EPS = 1e-10


class HMMSpectra(NamedTuple):
    """Fitted single-channel HMM spectral model.

    W: (F, S) per-state spectra; states: (N,) int64 decoded path;
    A: (S, S) transition matrix (rows sum to 1); cost: (n_iter,) total
    decoded IS divergence per iteration.
    """

    W: torch.Tensor
    states: torch.Tensor
    A: torch.Tensor
    cost: torch.Tensor


def _is_cost_matrix(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """IS-divergence cost of explaining each frame with each single state.

    V: (..., F, N) observed power; W: (..., F, S) state spectra. Returns
    (..., S, N): cost[s, n] = Σ_f V[f,n]/W[f,s] − log V[f,n] + log W[f,s] − 1
    (``audioModel.py:1816-1830``)."""
    F = V.shape[-2]
    Wc = torch.clamp(W, min=_EPS)
    cost = (1.0 / Wc).transpose(-1, -2) @ V
    cost = cost - torch.log(torch.clamp(V, min=_EPS)).sum(dim=-2, keepdim=True)
    cost = cost + torch.log(Wc).sum(dim=-2)[..., :, None]
    return cost - F


def _decode(V: torch.Tensor, W: torch.Tensor, A: torch.Tensor):
    """Viterbi state paths minimizing IS cost − log transitions, all J
    sequences in one sweep. V (J, F, N), W (J, F, S), A (J, S, S). Returns
    ((J, N) int64 paths, (J,) decoded costs)."""
    J, _, S = W.shape
    cost = _is_cost_matrix(V, W)                                    # (J, S, N)
    log_prior = torch.full((J, S), -math.log(S), dtype=torch.float32, device=V.device)
    path = viterbi_paths(-cost, log_prior, torch.log(torch.clamp(A, min=_EPS)))
    frame_cost = cost.gather(1, path[:, None, :]).sum(dim=(1, 2))
    return path, frame_cost


def _one_hot(path: torch.Tensor, S: int) -> torch.Tensor:
    """(J, N) paths → (J, S, N) float32 state indicators."""
    return torch.nn.functional.one_hot(path, S).to(torch.float32).transpose(1, 2)


def _count_transitions(P: torch.Tensor, A_prev: torch.Tensor) -> torch.Tensor:
    """Row-normalized transition counts; rows with no visits keep A_prev.

    P: (J, S, N) one-hot state indicators (``audioModel.py:1903-1925``)."""
    counts = P[:, :, :-1] @ P[:, :, 1:].transpose(1, 2)
    row = counts.sum(dim=2, keepdim=True)
    return torch.where(row > 0, counts / torch.clamp(row, min=_EPS), A_prev)


def _state_spectra(V: torch.Tensor, P: torch.Tensor, W_prev: torch.Tensor):
    """IS-optimal state spectra V·Pᵀ/counts; unvisited states keep W_prev."""
    counts = P.sum(dim=2)                                           # (J, S)
    W = V @ P.transpose(1, 2)
    return torch.where(counts[:, None, :] > 0,
                       W / torch.clamp(counts, min=_EPS)[:, None, :], W_prev)


def sticky_transition(n_states: int, stickiness: float = 9.0,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """pyfasst's SHMM prior: (9·I + 1) row-normalized (audioModel.py:2534-2547)."""
    A = stickiness * torch.eye(n_states, dtype=torch.float32,
                               device=resolve_device(device)) + 1.0
    return A / A.sum(dim=1, keepdim=True)


def fit_hmm_spectra(V, n_states: int = 4, n_iter: int = 20, transition=None,
                    update_transition: bool = True, W_init=None,
                    device: str | torch.device = "cuda") -> HMMSpectra:
    """Fit an HMM spectral model to a power spectrogram V (F, N).

    Each frame is explained by exactly one state spectrum (IS divergence),
    segmented by Viterbi with transition penalties. ``update_transition=
    False`` with ``transition=sticky_transition(S)`` is pyfasst's SHMM; the
    default is HMM with the 'free' count-based update. Deterministic init:
    W_init defaults to S evenly spaced FRAMES of V."""
    dev = resolve_device(device)
    V = torch.as_tensor(V, dtype=torch.float32, device=dev)[None]    # (1, F, N)
    N = V.shape[-1]
    S = n_states
    if W_init is None:
        idx = torch.linspace(0, N - 1, S).round().to(torch.int64).to(dev)
        W = V[:, :, idx]
    else:
        W = torch.as_tensor(W_init, dtype=torch.float32, device=dev)[None]
    A = (sticky_transition(S, device=dev) if transition is None
         else torch.as_tensor(transition, dtype=torch.float32, device=dev))[None]
    costs = []
    for _ in range(n_iter):
        path, frame_cost = _decode(V, W, A)
        P = _one_hot(path, S)
        W = _state_spectra(V, P, W)
        if update_transition:
            A = _count_transitions(P, A)
        costs.append(frame_cost[0])
    path, _ = _decode(V, W, A)
    cost = torch.stack(costs) if costs else torch.zeros(0, device=dev)
    return HMMSpectra(W[0], path[0], A[0], cost)


def _em_loop_hmm(X: torch.Tensor, W: torch.Tensor, P: torch.Tensor, A: torch.Tensor,
                 R: torch.Tensor, n_em: int, update_transition: bool):
    """FASST spatial E-step + HMM spectral M-step, all sources batched.
    Returns (W, P, A, R, nlls)."""
    S = W.shape[-1]
    XX = _outer(X)
    nlls = []
    for _ in range(n_em):
        v = torch.clamp(W @ P, min=_EPS)
        R, scale, z, nll = _spatial_estep(XX, v, R)
        W = W * scale[..., None]
        path, _ = _decode(z, W, A)
        P = _one_hot(path, S)
        W = _state_spectra(z, P, W)
        if update_transition:
            A = _count_transitions(P, A)
        nlls.append(nll)
    return W, P, A, R, torch.stack(nlls)


def fit_multichannel_hmm(X, n_sources: int = 2, n_states: int = 4, n_em: int = 50,
                         sticky: bool = False, key: torch.Tensor | None = None,
                         R_init=None, device: str | torch.device = "cuda") -> MultichannelNMF:
    """Fit the multichannel HMM local Gaussian model to a mixture STFT.

    pyfasst ``MultiChanHMM`` with ``makeItHMM`` (``sticky=False``: free
    count-based transition updates) or ``makeItSHMM`` (``sticky=True``:
    fixed sticky prior). X: (F, N, C) complex. Returns a
    :class:`~exemplars_vc_tpu_torch.separate.multichannel.MultichannelNMF`
    whose H is the (J, S, N) one-hot state-indicator matrix, so v_j = W_j·H_j
    and every downstream consumer works unchanged.

    The inits are drawn from ``split(key, 3)`` (``key`` ``PRNGKey(0)`` when
    None): W (squared normals), R (unless ``R_init`` is given) and P
    (uniform random states, one path a source) from its subkeys 0, 1 and
    2. The spatial perturbation takes ONE normal draw g for both parts,
    a = g + i·g, as the JAX package does (it draws both from the same subkey), so every source
    starts with equal inter-channel phase."""
    dev = resolve_device(device)
    X = _as_complex(X, dev)
    F, N, C = X.shape
    J, S = n_sources, n_states
    kw, kr, kp = prng.split(prng.key_or_default(key), 3)
    W = prng.normal(kw, (J, F, S)) ** 2
    if R_init is None:
        g = prng.normal(kr, (J, C))
        R = _rank1_spatial(torch.complex(g, g), F, 0.2).to(dev)
    else:
        R = _as_complex(R_init, dev)
    P = _one_hot(prng.randint(kp, (J, N), 0, S).long(), S)
    A = (sticky_transition(S, device=dev) if sticky
         else torch.full((S, S), 1.0 / S, device=dev)).expand(J, S, S).contiguous()
    W, P, A, R, nlls = _em_loop_hmm(X, W.to(dev, torch.float32), P.to(dev), A, R,
                                    n_em, not sticky)
    return MultichannelNMF(W, P, R, nlls)
