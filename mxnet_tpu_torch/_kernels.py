"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/``
beside this file (listed in ``.gitignore``), and loaded with ``ctypes``.
A library newer than its source and every local header the source
includes (``#include "..."``, followed transitively: the attention and
conv sources include ``csrc/flash_attention_mma.cuh``, the attention
sources and the conv source ``csrc/flash_attention_sm90.cuh`` too) is
reused.  No library links ``-lcuda``: the TMA tensor maps are encoded
through the entry point that the CUDA runtime hands out for
``cuTensorMapEncodeTiled``.  Sources build
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
           "fused_matmul_affine_relu": "csrc/fused_matmul_affine_relu.cu",
           "multi_tensor_update": "csrc/multi_tensor_update.cu",
           "nms_keep": "csrc/nms_keep.cu",
           "csr_dense_dot": "csrc/csr_dense_dot.cu"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_TAIL = [_INT] * 6 + [ctypes.c_float, _PTR]  # bh .. causal, scale, stream
#: library name -> {C entry point: argtypes}; each returns a cudaError_t
#  (``_mma``: the tensor-core design for bf16/f16; ``_fma``: f32)
SYMBOLS = {
    "flash_attention_fwd": {"mxt_flash_attention_fwd_mma": [_PTR] * 5 + _TAIL,
                            "mxt_flash_attention_fwd_fma":
                                [_PTR] * 5 + _TAIL},
    # dQ: q, k, v, O, dO, lse, delta (out), dq; dK/dV: q, k, v, dO, lse,
    # delta, dk, dv
    "flash_attention_bwd": {"mxt_flash_attention_bwd_dq_mma":
                                [_PTR] * 8 + _TAIL,
                            "mxt_flash_attention_bwd_dq_fma":
                                [_PTR] * 8 + _TAIL,
                            "mxt_flash_attention_bwd_dkv_mma":
                                [_PTR] * 8 + _TAIL,
                            "mxt_flash_attention_bwd_dkv_fma":
                                [_PTR] * 8 + _TAIL},
    # x, w, scale, bias, out, M, N, K, dtype, stream
    "fused_matmul_affine_relu": {"mxt_fused_matmul_affine_relu_mma":
                                     [_PTR] * 5 + [_INT] * 4 + [_PTR],
                                 "mxt_fused_matmul_affine_relu_fma":
                                     [_PTR] * 5 + [_INT] * 4 + [_PTR]},
    # table, blocks, nblocks, rule, flags, rescale, clip, mom, b1, 1 - b1,
    # b2, 1 - b2, eps, b1 (double), b2 (double), stream
    "multi_tensor_update": {"mxt_multi_tensor_update":
                                [_PTR] * 2 + [_INT] * 3 +
                                [ctypes.c_float] * 8 +
                                [ctypes.c_double] * 2 + [_PTR]},
    # boxes, valid, cls (or None), keep, scratch, groups, n, threshold,
    # images a chunk, kernels launched (out), stream
    "nms_keep": {"mxt_nms_keep": [_PTR] * 5 + [_INT] * 2 +
                                 [ctypes.c_float, _INT, _PTR, _PTR]},
    # data, cols, indptr, rhs, out, rows, n, dtype, stream
    "csr_dense_dot": {"mxt_csr_dense_dot": [_PTR] * 5 +
                                           [ctypes.c_int64] * 2 +
                                           [_INT, _PTR]},
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
#: library name -> flags of its own: the update kernel, the NMS scan and
#  the CSR product round where their plain versions' separate torch ops
#  round, so no multiply-add is contracted
EXTRA_FLAGS = {"multi_tensor_update": ["--fmad=false"],
               "nms_keep": ["--fmad=false"],
               "csr_dense_dot": ["--fmad=false"]}

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
        cmd = [exe, *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()),
               *(["-Xptxas", "-v"] if verbose else []),
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


def refuse_trace(name, *tensors):
    """Raise ``MXNetError`` naming "Left out of slice 17" when a tensor
    is a fake one of a trace (``torch.export``): the training kernel
    ``name`` is launched through ``ctypes``, not through an op a program
    can hold; no inference forward reaches it, in either package."""
    from torch._subclasses.fake_tensor import FakeTensor

    if any(isinstance(t, FakeTensor) for t in tensors):
        raise MXNetError(
            f"exporting a block that reaches the {name} training kernel "
            "is not supported: an export holds the inference forward "
            "(ROADMAP.md, \"Left out of slice 17\")")
