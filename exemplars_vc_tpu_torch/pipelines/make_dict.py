"""Parallel exemplar-dictionary construction (port of
``exemplars_vc_tpu/pipelines/make_dict.py``).

Load both speakers' utterances, compute the alignment features (MFCC, or
mel-cepstra) of all of them in batched calls, DTW-align every pair in one
batched wavefront (the kernels of :mod:`exemplars_vc_tpu_torch.align.dtw_cuda`
on the card), and persist the index-path dictionary in the artifact store
under a ``_torch`` key.
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
from exemplars_vc_tpu_torch.dsp.mcep import mcep
from exemplars_vc_tpu_torch.dsp.mel import mfcc
from exemplars_vc_tpu_torch.io.store import ArtifactStore, load_speaker

log = logging.getLogger("exemplars_vc_tpu_torch")


_HOST_FIELDS = ("path_len", "distance")   # the per-pair scalars


@dataclass
class DictionaryArtifacts:
    """The exemplar-dictionary state: the paths and features as tensors on
    one device, the per-pair scalars on the host (the one read-back the
    critical path needs: ``path_len`` sizes the exemplar bucket)."""

    path_i: torch.Tensor     # (N, P) int32 source-frame indices per pair, −1 padded
    path_j: torch.Tensor     # (N, P) int32 target-frame indices
    path_len: torch.Tensor   # (N,) int32, on the CPU
    feat_a: torch.Tensor     # (N, T, D) float32 padded alignment features, source
    feat_b: torch.Tensor
    len_a: torch.Tensor      # (N,) int32
    len_b: torch.Tensor
    distance: torch.Tensor   # (N,) float32 normalized DTW distances, on the CPU

    def to_numpy(self) -> dict[str, np.ndarray]:
        """CPU arrays, copied now (a CUDA tensor waits for the device)."""
        return {k: v.detach().cpu().numpy() for k, v in self.__dict__.items()}

    def host_copies(self) -> dict:
        """The fields as :func:`host_copies` hands them to the store."""
        return host_copies(self.__dict__)


def host_copies(tensors: dict) -> dict:
    """What ``ArtifactStore.save`` takes (its writer thread runs
    ``np.asarray``, which a CUDA tensor does not take), without waiting for
    the device: each CUDA tensor is copied into pinned host memory on a side
    stream, and the returned handle waits for that copy only when the writer
    asks for the array; arrays and CPU tensors pass as arrays."""
    cuda = [v for v in tensors.values() if isinstance(v, torch.Tensor) and v.is_cuda]
    if not cuda:
        return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in tensors.items()}
    device = cuda[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    out = {}
    with torch.cuda.stream(side):
        for k, v in tensors.items():
            if not (isinstance(v, torch.Tensor) and v.is_cuda):
                out[k] = v.detach().numpy() if isinstance(v, torch.Tensor) else v
                continue
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v.detach(), non_blocking=True)
            v.record_stream(side)
            out[k] = host
        done = torch.cuda.Event()
        done.record(side)
    return {k: _HostCopy(v, done) if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


class _HostCopy:
    """A pinned host tensor whose copy from the device may still be in
    flight; ``np.asarray`` of it waits for the copy's event."""

    def __init__(self, host: torch.Tensor, done: "torch.cuda.Event"):
        self.host, self.done = host, done

    def __array__(self, dtype=None, copy=None):
        self.done.synchronize()
        a = self.host.numpy()
        return a if dtype is None else a.astype(dtype)


def from_jax_artifacts(arrays: dict[str, np.ndarray],
                       device: str | torch.device) -> DictionaryArtifacts:
    """A dictionary from arrays in the ``DictionaryArtifacts`` layout — what
    the JAX package's ``make_dictionary`` stores (or this package's)."""
    ints = ("path_i", "path_j", "path_len", "len_a", "len_b")
    out = {}
    for name in DictionaryArtifacts.__dataclass_fields__:
        dtype = torch.int32 if name in ints else torch.float32
        where = "cpu" if name in _HOST_FIELDS else device
        out[name] = torch.as_tensor(np.asarray(arrays[name]), device=where).to(dtype)
    return DictionaryArtifacts(**out)


def speaker_batch(data_path: str, speaker: str, nb_file: int | None, step: int,
                  cpu_rate: float = 0.6):
    """Padded (N, T) float32 signal batch (T a multiple of ``step``) and the
    true sample lengths (N,) — the numpy counterpart of the JAX package's
    ``io.store.stacked_speaker_batch``, which the port leaves out."""
    sigs, _ = load_speaker(data_path, speaker, nb_file=nb_file, cpu_rate=cpu_rate)
    return pad_signals(sigs, step), np.asarray([len(s) for s in sigs], np.int64)


def pad_signals(sigs: list[np.ndarray], step: int) -> np.ndarray:
    """The signals zero-padded into one (N, T) float32 batch, T the longest
    signal's length rounded up to a multiple of ``step``."""
    max_len = max(len(s) for s in sigs)
    target = ((max_len + step - 1) // step) * step
    batch = np.zeros((len(sigs), target), dtype=np.float32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    return batch


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
    Returns (FA, la), (FB, lb) with la/lb = 1 + samples // hop as int32
    host arrays."""
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
    FA = trim_and_mask(out[:n], _round_up(int(la.max()), bucket),
                       torch.as_tensor(la, device=device))
    FB = trim_and_mask(out[n:], _round_up(int(lb.max()), bucket),
                       torch.as_tensor(lb, device=device))
    return (FA, la), (FB, lb)


def pair_mcep(cfg: Config, data_path: str, nb: int, device: torch.device):
    """Alignment mel-cepstra for both speakers, one batched call each: the
    uncentered framing gives (samples − frame_length)//hop + 1 frames, cut
    or padded to the bucket and masked as :func:`pair_mfcc`'s. Returns
    (FA, la), (FB, lb), the lengths as int32 host arrays."""
    m = cfg.mcep
    bucket = cfg.data.frame_bucket
    batches = [speaker_batch(data_path, spk, nb, m.hop_length * bucket, cfg.misc.cpu_rate)
               for spk in (cfg.data.src, cfg.data.tar)]
    n = min(b[0].shape[0] for b in batches)
    out = []
    for batch, samples in batches:
        lens = ((samples[:n] - m.frame_length) // m.hop_length + 1).astype(np.int32)
        feats = mcep(torch.as_tensor(batch[:n], device=device), frame_length=m.frame_length,
                     hop_length=m.hop_length, order=m.order, alpha=m.alpha)
        out.append((trim_and_mask(feats, _round_up(int(lens.max()), bucket),
                                  torch.as_tensor(lens, device=device)), lens))
    return out[0], out[1]


def make_dictionary(cfg: Config, store: ArtifactStore, data_path: str,
                    feat: str = "mfcc", nb_file: int | None = None,
                    *, device: str | torch.device = "cuda") -> DictionaryArtifacts:
    """Build (or load) the parallel exemplar dictionary for cfg.data.src→tar,
    aligned on MFCC (``feat="mfcc"``, what the reference's final flow aligns
    on) or on mel-cepstra (``"mcep"`` or ``"mcc"``)."""
    if feat not in ("mfcc", "mcep", "mcc"):
        raise ValueError(f"unsupported alignment feature {feat!r}")
    device = resolve_device(device)
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    hop_tag = "" if cfg.mcep.hop_length == 80 else f"_h{cfg.mcep.hop_length}"
    key = f"exemplar_dict_{cfg.data.src}2{cfg.data.tar}_{feat}_{nb}{hop_tag}_torch"
    if store.has(key):
        log.info("dictionary cache hit: %s", key)
        return from_jax_artifacts(store.load(key), device)

    (FA, la), (FB, lb) = (pair_mfcc if feat == "mfcc" else pair_mcep)(cfg, data_path, nb, device)
    # the lengths are host arrays, so the DTW wrappers check them there; only
    # the per-pair scalars come back to the host here (path_len sizes the
    # exemplar bucket). The paths and features stay on the device, and their
    # host copy for the store is made off this thread's critical path
    r = dtw_batch(FA, FB, la, lb)
    art = DictionaryArtifacts(path_i=r.path_i, path_j=r.path_j, path_len=r.path_len.cpu(),
                              feat_a=FA, feat_b=FB,
                              len_a=torch.as_tensor(la, device=device),
                              len_b=torch.as_tensor(lb, device=device),
                              distance=r.distance.cpu())
    store.save(key, **art.host_copies())
    make_dictionary.builds += 1
    log.info("DTW %d pairs, %s frames", FA.shape[0], tuple(FA.shape[1:]))
    return art


make_dictionary.builds = 0   # dictionaries built (store hits not counted)
