"""Per-speaker conversion-feature dictionaries, STFT half (port of
``exemplars_vc_tpu/pipelines/conv_dicts.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.stft import stft
from exemplars_vc_tpu_torch.io.store import ArtifactStore, bucketed_signal
from exemplars_vc_tpu_torch.pipelines.make_dict import speaker_batch, trim_and_mask


@dataclass
class ConversionFeatures:
    kind: str                        # "stft"
    feats: dict[str, torch.Tensor]   # padded (N, T, D) per feature name
    lens: np.ndarray                 # (N,) true frame counts


def extract_stft_complex(sig: np.ndarray, cfg: Config,
                         device: str | torch.device = "cuda") -> torch.Tensor:
    """Complex STFT (F, bins) of one utterance: the signal is zero-padded to
    the frame bucket, as the dictionaries are, then cut to 1 + len // hop
    frames."""
    device = resolve_device(device)
    m = cfg.mcep
    padded, true_frames = bucketed_signal(sig, m.hop_length, cfg.data.frame_bucket)
    x = torch.as_tensor(padded.astype(np.float32), device=device)
    S = stft(x, n_fft=m.frame_length, hop_length=m.hop_length, window=m.window)
    return S[:true_frames]


def extract_stft_features(sig: np.ndarray, cfg: Config,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """|STFT| (F, bins) of one utterance on :func:`extract_stft_complex`'s grid."""
    return torch.abs(extract_stft_complex(sig, cfg, device))


def build_conversion_dicts_pair(cfg: Config, store: ArtifactStore, data_path: str,
                                src: str, tar: str, nb_file: int | None = None,
                                *, device: str | torch.device = "cuda"):
    """Both speakers' |STFT| batches in one batched call.

    The two padded signal batches are padded to a common length and
    transformed together; each is cut back to 1 + its own padded length // hop
    frames and masked beyond each utterance's 1 + samples // hop frames.
    ``store`` is unused: the STFT batch is recomputed, never persisted (as in
    the JAX package)."""
    del store
    device = resolve_device(device)
    if not cfg.data.use_stft:
        raise NotImplementedError("the WORLD conversion path is ROADMAP queue 1 item 10")
    nb = nb_file if nb_file is not None else cfg.misc.nb_file
    m = cfg.mcep
    step = m.hop_length * cfg.data.frame_bucket
    A, sa = speaker_batch(data_path, src, nb, step, cfg.misc.cpu_rate)
    B, sb = speaker_batch(data_path, tar, nb, step, cfg.misc.cpu_rate)
    la = (1 + sa // m.hop_length).astype(np.int32)
    lb = (1 + sb // m.hop_length).astype(np.int32)
    ta, tb = A.shape[1], B.shape[1]
    x = np.zeros((A.shape[0] + B.shape[0], max(ta, tb)), np.float32)
    x[: A.shape[0], :ta] = A
    x[A.shape[0]:, :tb] = B
    mags = torch.abs(stft(torch.as_tensor(x, device=device), n_fft=m.frame_length,
                          hop_length=m.hop_length, window=m.window))
    SA = trim_and_mask(mags[: A.shape[0]], 1 + ta // m.hop_length,
                       torch.as_tensor(la, device=device))
    SB = trim_and_mask(mags[A.shape[0]:], 1 + tb // m.hop_length,
                       torch.as_tensor(lb, device=device))
    return (ConversionFeatures(kind="stft", feats={"stft": SA}, lens=la),
            ConversionFeatures(kind="stft", feats={"stft": SB}, lens=lb))
