"""The build of the port's CUDA kernels (``mxnet_tpu_torch._kernels``),
on the CPU: when a library in ``build/`` is stale and must be rebuilt."""
import os

from mxnet_tpu_torch import _kernels


def _touch(path, seconds):
    os.utime(path, (seconds, seconds))


def test_library_older_than_an_included_header_is_stale(tmp_path,
                                                        monkeypatch):
    """A library is rebuilt when its source, a header the source includes,
    or a header that header includes is newer than it, or when it is
    missing; system headers (``<...>``) are not followed."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    src, header, inner = (csrc / "demo.cu", csrc / "demo.cuh",
                          csrc / "inner.cuh")
    src.write_text('#include <cuda_runtime.h>\n#include "demo.cuh"\n')
    header.write_text('#pragma once\n  #  include "inner.cuh"\n')
    inner.write_text("#pragma once\n")
    lib = build / "libdemo.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_kernels, "_PKG", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", build)
    monkeypatch.setitem(_kernels.SOURCES, "demo", "csrc/demo.cu")
    for path in (src, header, inner):
        _touch(path, 1000)
    _touch(lib, 2000)
    assert not _kernels._stale("demo")
    for path in (header, inner, src):
        _touch(path, 3000)
        assert _kernels._stale("demo"), path.name
        _touch(path, 1000)
    assert not _kernels._stale("demo")
    lib.unlink()
    assert _kernels._stale("demo")


def test_flash_attention_sources_depend_on_the_shared_header():
    """The flash-attention sources and the fused 1x1 conv+BN+ReLU source
    all include the tensor-core header, so an edit of it rebuilds each."""
    header = _kernels._PKG / "csrc" / "flash_attention_mma.cuh"
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "fused_matmul_affine_relu"):
        deps = _kernels._dependencies(_kernels._PKG / _kernels.SOURCES[name])
        assert deps == [_kernels._PKG / _kernels.SOURCES[name], header]
