"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/``
beside this file (listed in ``.gitignore``), and loaded with ``ctypes``.
A library newer than its source and every local header the source
includes (``#include "..."``, followed transitively: every source
includes ``csrc/flash_attention_mma.cuh``) is reused.  Sources build
in parallel, one ``nvcc`` per source.  Nothing here runs at import time:
this module imports on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXNetError

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "build"
#: library name -> source, relative to this package
SOURCES = {"flash_attention_fwd": "csrc/flash_attention_fwd.cu",
           "flash_attention_bwd": "csrc/flash_attention_bwd.cu",
           "fused_matmul_affine_relu": "csrc/fused_matmul_affine_relu.cu"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_TAIL = [_INT] * 6 + [ctypes.c_float, _PTR]  # bh .. causal, scale, stream
#: library name -> {C entry point: argtypes}; each returns a cudaError_t
#  (``_mma``: the tensor-core design for bf16/f16; ``_fma``: f32)
SYMBOLS = {
    "flash_attention_fwd": {"mxt_flash_attention_fwd_mma": [_PTR] * 5 + _TAIL,
                            "mxt_flash_attention_fwd_fma":
                                [_PTR] * 5 + _TAIL},
    "flash_attention_bwd": {"mxt_flash_attention_bwd_dq_mma":
                                [_PTR] * 7 + _TAIL,
                            "mxt_flash_attention_bwd_dq_fma":
                                [_PTR] * 7 + _TAIL,
                            "mxt_flash_attention_bwd_dkv_mma":
                                [_PTR] * 8 + _TAIL,
                            "mxt_flash_attention_bwd_dkv_fma":
                                [_PTR] * 8 + _TAIL},
    # x, w, scale, bias, out, M, N, K, dtype, stream
    "fused_matmul_affine_relu": {"mxt_fused_matmul_affine_relu_mma":
                                     [_PTR] * 5 + [_INT] * 4 + [_PTR],
                                 "mxt_fused_matmul_affine_relu_fma":
                                     [_PTR] * 5 + [_INT] * 4 + [_PTR]},
}
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _dependencies(src: Path) -> list:
    """``src`` and the local headers it includes, transitively (a quoted
    ``#include`` resolves beside the file that names it, as in nvcc)."""
    deps, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in deps:
            continue
        deps.append(path)
        todo.extend(path.parent / inc
                    for inc in _INCLUDE.findall(path.read_text()))
    return deps


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a header the
    source includes."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(built < dep.stat().st_mtime
               for dep in _dependencies(_PKG / SOURCES[name]))


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


def _declare(name, lib):
    for symbol, argtypes in SYMBOLS[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mxt_cuda_error_string.restype = ctypes.c_char_p


def load(name: str):
    """The loaded library ``name``, built first if it is missing or
    older than its source or one of its headers."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _declare(name, lib)
            _LIBS[name] = lib
        return lib


def check(lib, err: int, what: str):
    """Raise ``MXNetError`` for a non-zero ``cudaError_t`` from ``lib``."""
    if err:
        msg = lib.mxt_cuda_error_string(err).decode()
        raise MXNetError(f"{what}: CUDA error {err} ({msg})")
