"""The plain reference of one conversion under the repository's ``quality``
preset, written for the benchmark.

The preset (``PRESETS["quality"]`` in the port's ``config.py``, measured in
BENCHMARKS.md's held-out quality section) keeps the STFT path of
:mod:`benchmark.reference.convert` and changes three settings. This file
adds the three, each written from what it is said to do:

1. ``data.dict_augment_warps`` (VTLP augmentation of the dictionary): for
   each warp factor α the whole parallel dictionary is appended once more
   with every row's content moved from frequency f to α·f. Output bin j
   takes the row at the position j / α, interpolated linearly between the
   two bins around it; past the top bin the position is the top bin. Source
   and target rows take the same α, so each warped pair stays a pair. The
   original rows come first, then one block a warp in the order given; the
   zero rows that pad the dictionary are warped with their block and stay
   zero.
2. ``nmf.beta_loss=kullback-leibler``: the multiplicative update of
   sklearn's ``non_negative_factorization(solver='mu',
   beta_loss='kullback-leibler')`` with the dictionary fixed. H starts at
   sqrt(mean(X) / K) everywhere; a step is H ← H ⊙ ((X ⊘ max(H·A, ε))·Aᵀ) ⊘
   s, where s holds the row sums of A and a zero sum becomes ε, the float64
   machine epsilon; the error sqrt(2·D_KL(X ‖ H·A)) is taken at the start and
   after every 10 steps, and the solve stops when it has fallen by less than
   tol times the first error since the check before.
3. ``nmf.h_smooth`` = s: each frame of H becomes the mean of the 2s + 1
   frames centred on it, a frame past either end read as the end frame.

Then Y = H·B and Griffin-Lim from the source phase, as in
:mod:`benchmark.reference.convert`, whose dictionary, STFT and Griffin-Lim
this file uses unchanged.

Departures from the published description:

- float32 throughout, with TF32 off unless the control asks for it
  (:func:`precision`); sklearn computes in the input's float64;
- D_KL sums X·log(X / max(H·A, ε)) over the entries where X > ε, as sklearn
  does, and adds Σ H·A − Σ X; sklearn forms Σ H·A as a product of sums, this
  file sums H·A itself;
- the tol test reads the drop against tol·(first error) where sklearn reads
  drop / (first error) against tol: the same test for a positive first
  error.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import convert
from benchmark.reference.convert import CHECK_EVERY, EPS, precision  # noqa: F401

# the preset's three settings at the values of the plain STFT reference,
# which builds the dictionary before the warps are applied
PLAIN_VALUES = {"nmf.beta_loss": "frobenius", "data.dict_augment_warps": "", "nmf.h_smooth": 0}


def check_quality(s: dict) -> None:
    if s["nmf.beta_loss"] != "kullback-leibler":
        raise ValueError(f"the quality reference solves KL, not {s['nmf.beta_loss']!r}")
    if not s["data.use_stft"]:
        raise ValueError("the quality reference has the STFT path only")
    if s["nmf.sparsity_l1"] != 0.0:
        raise ValueError("the quality reference has no l1 penalty")


def vtlp(M: torch.Tensor, alpha: float) -> torch.Tensor:
    """Rows (N, D) with their content moved from bin f to bin α·f."""
    D = M.shape[1]
    pos = torch.clamp(torch.arange(D, dtype=torch.float64, device=M.device) / alpha, max=D - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=D - 1)
    w = (pos - lo).to(M.dtype)
    return M[:, lo] * (1.0 - w) + M[:, hi] * w


def build_dictionaries(s: dict, data_path: str, device) -> dict:
    """{"stft": (A, B)}: the plain parallel dictionary and its warped copies,
    (K, D) float32 on ``device``."""
    check_quality(s)
    A, B = convert.build_dictionaries(dict(s, **PLAIN_VALUES), data_path, device)["stft"]
    alphas = [float(w) for w in str(s["data.dict_augment_warps"]).split(",") if w.strip()]
    return {"stft": (torch.cat([A] + [vtlp(A, a) for a in alphas]),
                     torch.cat([B] + [vtlp(B, a) for a in alphas]))}


def kl_error(X: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """sqrt(2·D_KL(X ‖ P)), generalised (the entries of X above ε only in the log term)."""
    on = X > EPS
    x = X[on]
    div = torch.sum(x * torch.log(x / torch.clamp(P[on], min=EPS))) + torch.sum(P) - torch.sum(X)
    return torch.sqrt(2.0 * torch.clamp(div, min=0.0))


def kl_solve(X: torch.Tensor, A: torch.Tensor, tol: float, max_iter: int):
    """(H ≥ 0 with X ≈ H·A by the KL multiplicative update, the steps run)."""
    F, K = X.shape[0], A.shape[0]
    H = torch.sqrt(torch.clamp(X.mean(), min=0.0) / K).expand(F, K).contiguous()
    At = A.T
    sums = A.sum(dim=1)
    sums = torch.where(sums == 0.0, EPS, sums)

    def step(H):
        return H * (((X / torch.clamp(H @ A, min=EPS)) @ At) / sums)

    first = prev = kl_error(X, H @ A)
    steps = 0
    for _ in range(max_iter // CHECK_EVERY):
        for _ in range(CHECK_EVERY):
            H = step(H)
        steps += CHECK_EVERY
        e = kl_error(X, H @ A)
        if tol > 0 and bool(prev - e < tol * first):
            break
        prev = e
    else:
        for _ in range(max_iter - steps):
            H = step(H)
            steps += 1
    return H, steps


def smooth(H: torch.Tensor, s: int) -> torch.Tensor:
    """The mean of the 2s + 1 frames around each frame, the ends repeated."""
    if s <= 0:
        return H
    padded = torch.cat([H[:1].expand(s, -1), H, H[-1:].expand(s, -1)])
    return padded.unfold(0, 2 * s + 1, 1).sum(dim=-1) / (2 * s + 1)


def convert_one(x: np.ndarray, dicts: dict, s: dict, device) -> tuple[np.ndarray, int]:
    """The converted audio of one utterance, and the MU steps its solve ran."""
    check_quality(s)
    S = convert.source_stft(x, s, device)
    A, B = dicts["stft"]
    H, steps = kl_solve(torch.abs(S), A, s["nmf.tol"], s["nmf.max_iter"])
    H = smooth(H, s["nmf.h_smooth"])
    y, _ = convert.griffin_lim(H @ B, S, s, s["nmf.griffin_lim_iters"], len(x))
    return y.cpu().numpy(), steps
