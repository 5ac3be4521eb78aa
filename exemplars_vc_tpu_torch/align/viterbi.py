"""Batched Viterbi tracking in torch (port of
``exemplars_vc_tpu/align/viterbi.py``).

The max-sum DP over HMM states of pyfasst's ``viterbiTracking``: per frame
one broadcast ``cum[:, None] + T`` and a max over the antecedent axis. Ties
go to the lowest antecedent, as ``jnp.argmax`` and the Cython's strict ``>``
do; ``torch.max(dim)`` returns the first maximal index too.

The forward pass is a Python loop over frames, each frame a few launches
for every sequence of the batch at once (sequences carry their own
transition matrix). The backtrace is a suffix composition of the
antecedent maps by pointer doubling: ⌈log2 N⌉ gathers, not N.
"""

from __future__ import annotations

import torch

from exemplars_vc_tpu_torch.device import resolve_device


def viterbi_paths(log_density: torch.Tensor, log_prior: torch.Tensor,
                  log_transition: torch.Tensor) -> torch.Tensor:
    """Best state paths of B sequences at once, on the inputs' device.

    log_density (B, S, N) float32; log_prior (B, S); log_transition
    (B, S, S) with [b, s', s] = log p(s | s'). Returns (B, N) int64."""
    B, S, N = log_density.shape
    cum = log_prior + log_density[:, :, 0]
    antes = []
    for n in range(1, N):
        # scores[b, s', s] = cum[b, s'] + T[b, s', s]
        best, ante = torch.max(cum[:, :, None] + log_transition, dim=1)
        cum = best + log_density[:, :, n]
        antes.append(ante)
    last = torch.argmax(cum, dim=1)                                  # (B,)
    if N == 1:
        return last[:, None]
    # maps[n] sends the state at frame n + 1 to its antecedent at frame n;
    # after the doubling, maps[n] sends the last frame's state to frame n's
    maps = torch.stack(antes)                                        # (N-1, B, S)
    step = 1
    while step < N - 1:
        maps = torch.cat([maps[:-step].gather(2, maps[step:]), maps[-step:]])
        step *= 2
    path = maps.gather(2, last[None, :, None].expand(N - 1, B, 1))[:, :, 0]
    return torch.cat([path, last[None]]).T.contiguous()


def viterbi_track(log_density, log_prior, log_transition,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """Most-likely state path.

    log_density: (S, N) per-frame state log-likelihoods; log_prior: (S,);
    log_transition: (S, S) with [s', s] = log p(s | s'). Returns (N,)
    int64 best state path on ``device``."""
    dev = resolve_device(device)
    ld, lp, lt = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (log_density, log_prior, log_transition))
    return viterbi_paths(ld[None], lp[None], lt[None])[0]


def viterbi_track_batch(log_density, log_prior, log_transition,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """(B, S, N) densities → (B, N) paths (shared prior/transition)."""
    dev = resolve_device(device)
    ld, lp, lt = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (log_density, log_prior, log_transition))
    B = ld.shape[0]
    return viterbi_paths(ld, lp.expand(B, -1), lt.expand(B, -1, -1))
