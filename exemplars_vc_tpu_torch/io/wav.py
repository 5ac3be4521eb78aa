"""WAV read/write without third-party audio libraries (the port's copy of
``exemplars_vc_tpu/io/wav.py``, bit-equal to it).

Replaces the reference's librosa-based IO (``utils.py:218-220`` — float64,
``sr=None``) and int16 writer (``zz_audio_utilities.py:295-314``). Pure
numpy RIFF parsing; a native C++ threaded batch loader is available in
:mod:`exemplars_vc_tpu_torch.io.native` for directory-scale loads.
"""

from __future__ import annotations

import struct

import numpy as np

_PCM_DTYPES = {8: np.uint8, 16: np.int16, 32: np.int32}


def read_wav(path: str, dtype=np.float64,
             mono: bool = True) -> tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file → (float signal in [-1, 1), sample_rate).

    Matches ``librosa.load(path, sr=None, dtype=np.double)`` semantics used at
    reference ``utils.py:218-220`` / ``04_align_n_nmf.py:398``: native sample
    rate, int PCM scaled by 2**(bits-1), multi-channel averaged to mono.
    ``mono=False`` instead returns the channels as (C, T) — for the stereo
    separation models, whose spatial estimation needs real channels.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    sub_format = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            if fmt[0] == 0xFFFE and len(body) >= 26:
                # WAVE_FORMAT_EXTENSIBLE: the real format is the first two
                # bytes of the SubFormat GUID (1 = PCM, 3 = IEEE float)
                sub_format = struct.unpack("<H", body[24:26])[0]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:
        audio_format = sub_format if sub_format is not None else 1

    # tolerate truncated files: keep only whole frames
    frame_bytes = max(1, (bits // 8) * max(n_channels, 1))
    if len(raw) % frame_bytes:
        raw = raw[: (len(raw) // frame_bytes) * frame_bytes]

    if audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype=np.float32).astype(dtype)
        elif bits == 64:
            # the reference's committed results/*.wav are float64 (scipy
            # wavfile.write of a float64 array)
            x = np.frombuffer(raw, dtype=np.float64).astype(dtype)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    elif audio_format == 1:
        pcm_dtype = _PCM_DTYPES.get(bits)
        if pcm_dtype is None:
            raise ValueError(f"{path}: unsupported bit depth {bits}")
        x = np.frombuffer(raw, dtype=pcm_dtype).astype(dtype)
        if bits == 8:
            x = (x - 128.0) / 128.0
        else:
            x = x / float(2 ** (bits - 1))
    else:
        raise ValueError(f"{path}: unsupported audio format {audio_format}")

    if n_channels > 1:
        x = x[: (len(x) // n_channels) * n_channels]
        frames = x.reshape(-1, n_channels)
        if mono:
            x = frames.mean(axis=1)
        else:
            x = frames.T
    elif not mono:
        x = x[None, :]
    return np.ascontiguousarray(x, dtype=dtype), sample_rate


def write_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write float audio in [-1, 1] as 16-bit PCM.

    ``x`` is (T,) mono or (C, T) multichannel (channels interleaved in the
    file, matching :func:`read_wav`'s ``mono=False`` layout). Mirrors
    ``zz_audio_utilities.py:295-314`` (int16 quantization with max
    normalization only when the signal clips)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"write_wav expects (T,) or (C, T), got {x.shape}")
    n_ch = x.shape[0]
    peak = np.max(np.abs(x)) if x.size else 0.0
    if peak > 1.0:
        x = x / peak
    pcm = np.round(x * 32767.0).astype("<i2")
    body = pcm.T.reshape(-1).tobytes()      # interleave channels
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(body)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, n_ch, sample_rate,
                            sample_rate * 2 * n_ch, 2 * n_ch, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(body)))
        f.write(body)
