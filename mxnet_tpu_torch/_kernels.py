"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/``
beside this file (listed in ``.gitignore``), and loaded with ``ctypes``.
A library newer than its source is reused.  Sources build in parallel,
one ``nvcc`` per source.  Nothing here runs at import time: this module
imports on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXNetError

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "build"
#: library name -> source, relative to this package
SOURCES = {"flash_attention_fwd": "csrc/flash_attention_fwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (looked in $CUDA_HOME/bin, "
                         "/usr/local/cuda/bin and PATH); the CUDA kernels "
                         "are built from csrc/ at first use")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib, src = _lib_path(name), _PKG / SOURCES[name]
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build(names=None, verbose=False) -> dict:
    """Compile the stale libraries among ``names`` (default: all), all
    ``nvcc`` processes started together.  Returns ``{name: compiler
    output}`` for the ones built; ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills of each kernel)."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [exe, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(_PKG / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise MXNetError("nvcc failed for " + ", ".join(failed) + ":\n" +
                         "\n".join(logs[n] for n in failed))
    return logs


def _declare(lib):
    fn = lib.mxt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mxt_cuda_error_string.restype = ctypes.c_char_p


def load(name: str):
    """The loaded library ``name``, built first if it is missing or
    older than its source."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _declare(lib)
            _LIBS[name] = lib
        return lib


def check(lib, err: int, what: str):
    """Raise ``MXNetError`` for a non-zero ``cudaError_t`` from ``lib``."""
    if err:
        msg = lib.mxt_cuda_error_string(err).decode()
        raise MXNetError(f"{what}: CUDA error {err} ({msg})")
