"""Parallel exemplar-dictionary construction (port of
``exemplars_vc_tpu/pipelines/make_dict.py``).

Load both speakers' utterances, compute the alignment MFCC of all of them in
one batched call, DTW-align every pair in one batched wavefront (the kernels
of :mod:`exemplars_vc_tpu_torch.align.dtw_cuda` on the card), and persist the
index-path dictionary in the artifact store under a ``_torch`` key.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from exemplars_vc_tpu_torch.align.dtw import dtw_batch
from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.mel import mfcc
from exemplars_vc_tpu_torch.io.store import ArtifactStore, load_speaker

log = logging.getLogger("exemplars_vc_tpu_torch")


@dataclass
class DictionaryArtifacts:
    """The exemplar-dictionary state, as tensors on one device."""

    path_i: torch.Tensor     # (N, P) int32 source-frame indices per pair, −1 padded
    path_j: torch.Tensor     # (N, P) int32 target-frame indices
    path_len: torch.Tensor   # (N,) int32
    feat_a: torch.Tensor     # (N, T, D) float32 padded alignment features, source
    feat_b: torch.Tensor
    len_a: torch.Tensor      # (N,) int32
    len_b: torch.Tensor
    distance: torch.Tensor   # (N,) float32 normalized DTW distances

    def to_numpy(self) -> dict[str, np.ndarray]:
        """CPU arrays for ``ArtifactStore.save`` (its writer thread runs
        ``np.asarray``, which a CUDA tensor does not take)."""
        return {k: v.detach().cpu().numpy() for k, v in self.__dict__.items()}


def from_jax_artifacts(arrays: dict[str, np.ndarray],
                       device: str | torch.device) -> DictionaryArtifacts:
    """A dictionary from arrays in the ``DictionaryArtifacts`` layout — what
    the JAX package's ``make_dictionary`` stores (or this package's)."""
    ints = ("path_i", "path_j", "path_len", "len_a", "len_b")
    out = {}
    for name in DictionaryArtifacts.__dataclass_fields__:
        dtype = torch.int32 if name in ints else torch.float32
        out[name] = torch.as_tensor(np.asarray(arrays[name]), device=device).to(dtype)
    return DictionaryArtifacts(**out)


def speaker_batch(data_path: str, speaker: str, nb_file: int | None, step: int,
                  cpu_rate: float = 0.6):
    """Padded (N, T) float32 signal batch (T a multiple of ``step``) and the
    true sample lengths (N,) — the numpy counterpart of the JAX package's
    ``io.store.stacked_speaker_batch``, which the port leaves out."""
    sigs, _ = load_speaker(data_path, speaker, nb_file=nb_file, cpu_rate=cpu_rate)
    max_len = max(len(s) for s in sigs)
    target = ((max_len + step - 1) // step) * step
    batch = np.zeros((len(sigs), target), dtype=np.float32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    return batch, np.asarray([len(s) for s in sigs], np.int64)


def trim_and_mask(feats: torch.Tensor, t_pad: int, lens: torch.Tensor) -> torch.Tensor:
    """(N, T, D) → (N, t_pad, D): cut or zero-pad the frame axis, then zero
    the rows at and beyond each utterance's length."""
    if feats.shape[1] >= t_pad:
        feats = feats[:, :t_pad]
    else:
        feats = F.pad(feats, (0, 0, 0, t_pad - feats.shape[1]))
    mask = torch.arange(t_pad, device=feats.device)[None, :] < lens[:, None]
    return feats * mask[..., None]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pair_mfcc(cfg: Config, data_path: str, nb: int, device: torch.device):
    """Alignment MFCC for both speakers in one batched call.

    Both speakers' padded signal batches are padded to a common length and
    concatenated (as the JAX package does, so every frame sees the same
    zeros); each output is cut back to its own frame bucket and masked.
    Returns (FA, la), (FB, lb) with la/lb = 1 + samples // hop."""
    m = cfg.mcep
    bucket = cfg.data.frame_bucket
    step = m.hop_length * bucket
    A, sa = speaker_batch(data_path, cfg.data.src, nb, step, cfg.misc.cpu_rate)
    B, sb = speaker_batch(data_path, cfg.data.tar, nb, step, cfg.misc.cpu_rate)
    n = min(A.shape[0], B.shape[0])
    la = (1 + sa[:n] // m.hop_length).astype(np.int32)
    lb = (1 + sb[:n] // m.hop_length).astype(np.int32)
    T = max(A.shape[1], B.shape[1])
    x = np.zeros((2 * n, T), np.float32)
    x[:n, : A.shape[1]] = A[:n]
    x[n:, : B.shape[1]] = B[:n]
    out = mfcc(torch.as_tensor(x, device=device), sr=cfg.data.sr, n_fft=m.frame_length,
               hop_length=m.hop_length, n_mfcc=m.n_mfcc, n_mels=m.n_mels)
    la_t = torch.as_tensor(la, device=device)
    lb_t = torch.as_tensor(lb, device=device)
    FA = trim_and_mask(out[:n], _round_up(int(la.max()), bucket), la_t)
    FB = trim_and_mask(out[n:], _round_up(int(lb.max()), bucket), lb_t)
    return (FA, la_t), (FB, lb_t)


def make_dictionary(cfg: Config, store: ArtifactStore, data_path: str,
                    feat: str = "mfcc", nb_file: int | None = None,
                    *, device: str | torch.device = "cuda") -> DictionaryArtifacts:
    """Build (or load) the parallel exemplar dictionary for cfg.data.src→tar."""
    if feat != "mfcc":
        raise NotImplementedError(f"alignment feature {feat!r}: only 'mfcc' is ported")
    device = resolve_device(device)
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    hop_tag = "" if cfg.mcep.hop_length == 80 else f"_h{cfg.mcep.hop_length}"
    key = f"exemplar_dict_{cfg.data.src}2{cfg.data.tar}_{feat}_{nb}{hop_tag}_torch"
    if store.has(key):
        log.info("dictionary cache hit: %s", key)
        return from_jax_artifacts(store.load(key), device)

    (FA, la), (FB, lb) = pair_mfcc(cfg, data_path, nb, device)
    r = dtw_batch(FA, FB, la, lb)
    art = DictionaryArtifacts(path_i=r.path_i, path_j=r.path_j, path_len=r.path_len,
                              feat_a=FA, feat_b=FB, len_a=la, len_b=lb,
                              distance=r.distance)
    store.save(key, **art.to_numpy())
    log.info("DTW %d pairs, %s frames", FA.shape[0], tuple(FA.shape[1:]))
    return art
