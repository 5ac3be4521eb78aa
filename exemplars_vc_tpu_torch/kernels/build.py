"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``) and is
compiled on first use into ``build/kernels/<name>-<hash>.so`` beside the
package (a directory ``.gitignore`` lists)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The hash covers the source and the flags, so an edited source rebuilds.
A plain C interface keeps the build to seconds (no PyTorch headers). The
wrappers pass device pointers and PyTorch's current stream as integers.
Nothing here runs at import time; a build or load failure raises. Each
source has its own lock, so threads build different sources in parallel.
``griffin_lim_fused.cu`` uses a cooperative grid sync and needs no extra
flag (no ``-rdc``): the barrier is implemented in the CUDA 12 headers.
``nmf_mu.cu`` launches thread-block clusters (``cudaLaunchKernelEx``) and
needs none either: ``sm_90a`` has them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# shared memory one block may use on Hopper (dynamic, above 48 KB opted in)
SMEM_LIMIT_BYTES = 232_448

_locks_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# per source: seconds the nvcc call took (0.0 when an earlier build was
# reused) and the compiler's -Xptxas -v report (registers, shared memory)
build_seconds: dict[str, float] = {}
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                       "the port's CUDA kernels cannot be built")


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        if out.is_file():
            build_seconds[name] = 0.0
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True, timeout=600)
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (rc {proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            ptxas_report[name] = proc.stderr
            os.replace(tmp, out)   # atomic: concurrent builders never see a torn .so
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib


def check(code: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point; every
    source exports ``evc_error_string`` (``cudaGetErrorString``)."""
    if code != 0:
        fn = lib.evc_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {code} at launch: "
                           f"{fn(code).decode(errors='replace')}")
