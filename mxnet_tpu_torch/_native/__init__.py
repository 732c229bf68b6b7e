"""ctypes bindings for the native host runtime: the dependency engine, the
indexed RecordIO reader and the batch prefetcher.

Counterpart of ``mxnet_tpu/_native/__init__.py``.  The C++ sources are the
port's own copies (``csrc/mxt_engine.cc``, ``csrc/mxt_recordio.cc``): the
engine schedules host work (record IO, decode, prefetch) with MXNet's
read-var/write-var conflict semantics (the reference's
``threaded_engine.cc``), a pooled allocator serves the staging buffers
(``pooled_storage_manager.h``), and the reader and prefetcher are
``iter_image_recordio_2.cc``/``iter_prefetcher.h``.

The library is compiled by ``g++`` at first use into ``build/`` beside
the package (listed in ``.gitignore``) and reused while it is newer than
both sources.  A failed build raises ``MXNetError`` carrying the
compiler's output: nothing falls back to Python behind the caller's back
(``io.ImageRecordIter(no_native=True)`` is the explicit Python route).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..base import MXNetError

__all__ = ["lib", "build", "Engine", "RecordReader", "Prefetcher",
           "pool_stats"]

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "build"
SOURCES = [_PKG / "csrc" / "mxt_engine.cc", _PKG / "csrc" / "mxt_recordio.cc"]
LIB_PATH = BUILD_DIR / "libmxtnative.so"
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-shared"]

_LOCK = threading.Lock()
_LIB = None


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(built < src.stat().st_mtime for src in SOURCES)


def build(force=False) -> str:
    """Compile ``csrc/mxt_engine.cc`` and ``csrc/mxt_recordio.cc`` into
    ``build/libmxtnative.so`` if it is missing or older than a source
    (or ``force``).  Returns the compiler's output ('' when nothing was
    built); raises ``MXNetError`` with that output when ``g++`` fails."""
    if not force and not _stale():
        return ""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise MXNetError("g++ not found on PATH (nor $CXX): the native "
                         "record reader is built from mxnet_tpu_torch/csrc/ "
                         "at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libmxtnative.{os.getpid()}.tmp.so"
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError("building the native library failed:\n" +
                         " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, LIB_PATH)  # atomic: concurrent builders never see half
    return proc.stdout + proc.stderr


def _bind(so):
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    so.MXTEngineCreate.restype = ctypes.c_void_p
    so.MXTEngineCreate.argtypes = [ctypes.c_int]
    so.MXTEngineDestroy.argtypes = [ctypes.c_void_p]
    so.MXTEngineNewVar.restype = ctypes.c_int64
    so.MXTEngineNewVar.argtypes = [ctypes.c_void_p]
    so.MXTEnginePush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, i64p, ctypes.c_int,
                                 i64p, ctypes.c_int]
    so.MXTEngineWaitForVar.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    so.MXTEngineWaitAll.argtypes = [ctypes.c_void_p]
    so.MXTEngineVarVersion.restype = ctypes.c_uint64
    so.MXTEngineVarVersion.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    so.MXTGetLastError.restype = ctypes.c_char_p
    so.MXTRecordReaderCreate.restype = ctypes.c_void_p
    so.MXTRecordReaderCreate.argtypes = [ctypes.c_char_p]
    so.MXTRecordReaderDestroy.argtypes = [ctypes.c_void_p]
    so.MXTRecordReaderCount.restype = ctypes.c_int64
    so.MXTRecordReaderCount.argtypes = [ctypes.c_void_p]
    so.MXTRecordReaderSize.restype = ctypes.c_int64
    so.MXTRecordReaderSize.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    so.MXTRecordReaderOffset.restype = ctypes.c_int64
    so.MXTRecordReaderOffset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    so.MXTRecordReaderRead.restype = ctypes.c_int
    so.MXTRecordReaderRead.argtypes = [ctypes.c_void_p, ctypes.c_int64, u8p]
    so.MXTPrefetcherCreate.restype = ctypes.c_void_p
    so.MXTPrefetcherCreate.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int]
    so.MXTPrefetcherDestroy.argtypes = [ctypes.c_void_p]
    so.MXTPrefetcherSchedule.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int]
    so.MXTPrefetcherNext.restype = ctypes.c_int
    so.MXTPrefetcherNext.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(u8p),
                                     ctypes.POINTER(i64p),
                                     i64p, i64p]
    so.MXTBatchFree.argtypes = [u8p, i64p, ctypes.c_int64, ctypes.c_int64]
    so.MXTPoolStats.argtypes = [i64p, i64p]
    return so


def lib():
    """The loaded native library, built first if needed.  Raises
    ``MXNetError`` (with the compiler's message) if it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            _LIB = _bind(ctypes.CDLL(str(LIB_PATH)))
        return _LIB


def available():
    """Whether the native library builds and loads here (the reference's
    ``_native.available()``)."""
    try:
        lib()
    except Exception:
        return False
    return True


def _i64arr(values):
    return (ctypes.c_int64 * len(values))(*values)


_PUSH_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class Engine:
    """Dependency engine handle (reference ``Engine::PushAsync``
    semantics): writes on one var run in push order and alone, reads of
    one var run together, ops on disjoint vars run in parallel.  Python
    callbacks take the GIL, so this suits I/O-bound host tasks."""

    def __init__(self, nthreads=4):
        self._so = lib()
        self._h = self._so.MXTEngineCreate(nthreads)
        self._cbs = []  # callbacks stay alive until wait_all

    def new_var(self):
        return self._so.MXTEngineNewVar(self._h)

    def push(self, fn, read_vars=(), write_vars=()):
        cb = _PUSH_CB(lambda _arg: fn())
        self._cbs.append(cb)
        self._so.MXTEnginePush(
            self._h, ctypes.cast(cb, ctypes.c_void_p), None,
            _i64arr(list(read_vars)), len(read_vars),
            _i64arr(list(write_vars)), len(write_vars))

    def wait_for_var(self, var):
        self._so.MXTEngineWaitForVar(self._h, var)

    def wait_all(self):
        self._so.MXTEngineWaitAll(self._h)
        self._cbs.clear()

    def var_version(self, var):
        return self._so.MXTEngineVarVersion(self._h, var)

    def __del__(self):
        if getattr(self, "_h", None):
            self._so.MXTEngineDestroy(self._h)
            self._h = None


class RecordReader:
    """Indexed native RecordIO reader (``pread``-based, thread-safe): it
    scans the file once and reads record ``i`` in scan order."""

    def __init__(self, path):
        self._so = lib()
        self._h = self._so.MXTRecordReaderCreate(str(path).encode())
        if not self._h:
            raise IOError(self._so.MXTGetLastError().decode())

    def __len__(self):
        return self._so.MXTRecordReaderCount(self._h)

    def offset(self, i):
        """Byte offset of record ``i``'s first part header (maps ``.idx``
        offsets onto scan-order indices)."""
        return self._so.MXTRecordReaderOffset(self._h, i)

    def read(self, i):
        size = self._so.MXTRecordReaderSize(self._h, i)
        if size < 0:
            raise IndexError(f"record index {i} out of range")
        buf = np.empty(size, dtype=np.uint8)
        rc = self._so.MXTRecordReaderRead(
            self._h, i, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError("record read failed")
        return buf.tobytes()

    def close(self):
        if getattr(self, "_h", None):
            self._so.MXTRecordReaderDestroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class Prefetcher:
    """Batch prefetcher: schedule index lists, consume them in schedule
    order, each as a list of record payloads.  The engine's workers read
    ahead; the caller paces scheduling to bound buffered memory (keep
    scheduled - consumed near ``capacity``)."""

    def __init__(self, path, nthreads=4, capacity=4):
        self._so = lib()
        self._reader = RecordReader(path)
        self._engine = Engine(nthreads)
        self._h = self._so.MXTPrefetcherCreate(
            self._reader._h, self._engine._h, capacity)

    def __len__(self):
        return len(self._reader)

    def offset(self, i):
        return self._reader.offset(i)

    def schedule(self, indices):
        idx = _i64arr([int(i) for i in indices])
        self._so.MXTPrefetcherSchedule(self._h, idx, len(indices))

    def next(self):
        """The next scheduled batch as ``list[bytes]``; None when
        drained."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        data = u8p()
        offsets = i64p()
        n = ctypes.c_int64()
        nbytes = ctypes.c_int64()
        rc = self._so.MXTPrefetcherNext(
            self._h, ctypes.byref(data), ctypes.byref(offsets),
            ctypes.byref(n), ctypes.byref(nbytes))
        if rc == -1:
            return None
        if rc != 0:
            raise IOError(self._so.MXTGetLastError().decode())
        try:
            flat = np.ctypeslib.as_array(data, shape=(nbytes.value,)) \
                if nbytes.value else np.empty(0, np.uint8)
            offs = np.ctypeslib.as_array(offsets, shape=(n.value + 1,))
            return [flat[offs[j]:offs[j + 1]].tobytes()
                    for j in range(n.value)]
        finally:
            self._so.MXTBatchFree(data, offsets, n, nbytes)

    def close(self):
        if getattr(self, "_h", None):
            self._engine.wait_all()
            self._so.MXTPrefetcherDestroy(self._h)
            self._h = None
            self._reader.close()

    def __del__(self):
        self.close()


def pool_stats():
    """(hits, misses) of the native pooled buffer allocator."""
    so = lib()
    h = ctypes.c_int64()
    m = ctypes.c_int64()
    so.MXTPoolStats(ctypes.byref(h), ctypes.byref(m))
    return (h.value, m.value)
