"""Framing, STFT and ISTFT over ``torch.fft`` (port of
``exemplars_vc_tpu/dsp/stft.py``).

The STFT is centered with reflect padding and a periodic hann window
(librosa's defaults). The ISTFT is written out rather than taken from
``torch.istft`` (which has its own NOLA check and edge handling): windowed
irfft frames, overlap-add, division by max(Σw², 1e-8), a crop of n_fft//2
at both ends, and zero padding of the tail up to ``length``.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from exemplars_vc_tpu_torch.dsp.windows import get_window


@lru_cache(maxsize=16)
def _window(name: str, n_fft: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The periodic window on ``device``, made once (read only), so that a
    transform on the card (each of Griffin-Lim's eager iterations makes two)
    uploads no window from the host."""
    return get_window(name, n_fft, periodic=True, device=device, dtype=dtype)


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., T) → (..., n_frames, frame_length), no padding."""
    return x.unfold(-1, frame_length, hop_length)


def stft(x: torch.Tensor, n_fft: int = 400, hop_length: int = 80,
         window: str = "hann", center: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """(..., T) real → (..., n_frames, n_fft//2+1) complex, frames-major."""
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2), mode=pad_mode)
        x = x.reshape(lead + x.shape[-1:])
    w = _window(window, n_fft, x.device, x.dtype)
    return torch.fft.rfft(frame_signal(x, n_fft, hop_length) * w, n=n_fft)


def stft_magnitude(x: torch.Tensor, **kw) -> torch.Tensor:
    """|:func:`stft`|, with the same keywords."""
    return torch.abs(stft(x, **kw))


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(..., n_frames, n_fft) → (..., n_fft + hop·(n_frames−1)) summed frames."""
    lead = frames.shape[:-2]
    n_frames, n_fft = frames.shape[-2:]
    out_len = n_fft + hop_length * (n_frames - 1)
    cols = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)
    y = F.fold(cols, output_size=(1, out_len), kernel_size=(1, n_fft),
               stride=(1, hop_length))
    return y.reshape(lead + (out_len,))


def istft(spec: torch.Tensor, n_fft: int = 400, hop_length: int = 80,
          window: str = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Window-sum-normalized inverse STFT; spec (..., n_frames, n_fft//2+1)."""
    w = _window(window, n_fft, spec.device, torch.float32)
    frames = torch.fft.irfft(spec, n=n_fft) * w
    n_frames = spec.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    y = overlap_add(frames, hop_length)
    wsum = overlap_add((w * w).expand(n_frames, n_fft), hop_length)
    y = y / torch.clamp(wsum, min=1e-8)
    if center:
        y = y[..., n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        if y.shape[-1] < length:   # librosa semantics: zero-pad the tail
            y = F.pad(y, (0, length - y.shape[-1]))
        y = y[..., :length]
    return y
