"""ctypes binding to the native C++ batch wav loader (``native/evc_io.cpp``),
the port's copy of ``exemplars_vc_tpu/io/native.py``.

An in-process thread pool decodes a batch of wavs straight into numpy
buffers. The shared library is compiled on first use, if a C++ compiler is
present, into the git-ignored ``build/native/`` directory beside the package
(the source directory ``native/`` is left as it is)::

    g++ -O3 -std=c++17 -fPIC -Wall -Wextra -shared -o build/native/libevc_io.so \\
        native/evc_io.cpp -pthread

Callers fall back to the pure-numpy reader when the library is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "evc_io.cpp"
_LIB_PATH = _REPO / "build" / "native" / "libevc_io.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or not _SRC.is_file():
        return False
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp.so")
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC), "-pthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)   # atomic: a concurrent loader never sees a torn .so
        return True
    except Exception:
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB_PATH.is_file() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.evc_load_batch.restype = ctypes.c_void_p
        lib.evc_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ]
        lib.evc_batch_length.restype = ctypes.c_long
        lib.evc_batch_length.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.evc_batch_sr.restype = ctypes.c_int
        lib.evc_batch_sr.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.evc_batch_error_msg.restype = ctypes.c_char_p
        lib.evc_batch_error_msg.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.evc_batch_copy.restype = None
        lib.evc_batch_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.evc_batch_free.restype = None
        lib.evc_batch_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_wavs(paths: list[str], n_threads: int = 0) -> tuple[list[np.ndarray], int]:
    """Decode a batch of wav files in parallel → (signals, sample_rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.evc_load_batch(arr, len(paths), n_threads)
    if not handle:
        raise MemoryError("evc_load_batch failed")
    try:
        sigs: list[np.ndarray] = []
        sr = None
        for i, p in enumerate(paths):
            err = lib.evc_batch_error_msg(handle, i)
            if err:
                raise ValueError(f"{p}: {err.decode()}")
            n = lib.evc_batch_length(handle, i)
            this_sr = lib.evc_batch_sr(handle, i)
            if sr is not None and this_sr != sr:
                raise ValueError(f"inconsistent sample rates: {this_sr} vs {sr}")
            sr = this_sr
            buf = np.empty(n, dtype=np.float64)
            lib.evc_batch_copy(
                handle, i, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            )
            sigs.append(buf)
        return sigs, int(sr)
    finally:
        lib.evc_batch_free(handle)
