"""Plain STFT, ISTFT, windows, mel filterbank and MFCC: a frozen copy of the
port's ``dsp/windows.py``, ``dsp/stft.py`` and ``dsp/mel.py`` at the commit
that added this benchmark, so that the reference computes its features with
the same semantics (centered reflect-padded STFT, periodic hann, the
window-sum-normalized ISTFT, Slaney mels, top_db 80, orthonormal DCT-II)
and imports nothing of the program."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def get_window(name: str, length: int, periodic: bool = True,
               device: str | torch.device = "cpu",
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``periodic=True`` is scipy's ``fftbins=True`` / librosa's STFT window
    (periodic hann on the STFT path); ``periodic=False`` the symmetric one
    (blackman for mel-cepstral framing). Built in float64, then cast."""
    n = np.arange(length, dtype=np.float64)
    denom = length if periodic else max(length - 1, 1)
    t = 2.0 * np.pi * n / denom
    if name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(t)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(t)
    elif name == "blackman":
        w = 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2.0 * t)
    elif name in ("rect", "boxcar", "ones"):
        w = np.ones(length, dtype=np.float64)
    else:
        raise ValueError(f"unknown window {name!r}")
    return torch.as_tensor(w, dtype=dtype, device=device)


@lru_cache(maxsize=16)
def _window(name: str, n_fft: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The periodic window on ``device``, made once (read only): a CUDA
    graph capture of Griffin-Lim's loop may not copy it from the host."""
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


def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mel)


def mel_to_hz(m, htk: bool = False):
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_min + f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney") -> np.ndarray:
    """(n_mels, n_fft//2+1) float32 triangular filterbank."""
    fmax = fmax or sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


def dct_matrix(n_out: int, n_in: int, dtype=np.float32) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in)."""
    k = np.arange(n_out, dtype=np.float64)[:, None]
    n = np.arange(n_in, dtype=np.float64)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    m[0] /= np.sqrt(2.0)
    return m.astype(dtype)


def power_to_db(S: torch.Tensor, amin: float = 1e-10,
                top_db: float | None = 80.0) -> torch.Tensor:
    """10·log10(max(S, amin)), floored at (max − top_db) per (F, bins) matrix."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    if top_db is not None:
        peak = log_spec.amax(dim=(-2, -1), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def melspectrogram(x: torch.Tensor, sr: int = 16000, n_fft: int = 400,
                   hop_length: int = 80, n_mels: int = 128,
                   power: float = 2.0) -> torch.Tensor:
    """(..., T) → (..., n_frames, n_mels) mel power spectrogram."""
    mag = torch.abs(stft(x, n_fft=n_fft, hop_length=hop_length)) ** power
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), device=x.device)
    return mag @ fb.T


def mfcc(x: torch.Tensor, sr: int = 16000, n_fft: int = 400, hop_length: int = 80,
         n_mfcc: int = 20, n_mels: int = 128) -> torch.Tensor:
    """(..., T) → (..., n_frames, n_mfcc), librosa.feature.mfcc semantics."""
    S_db = power_to_db(melspectrogram(x, sr=sr, n_fft=n_fft, hop_length=hop_length,
                                      n_mels=n_mels))
    D = torch.as_tensor(dct_matrix(n_mfcc, n_mels), device=x.device)
    return S_db @ D.T
