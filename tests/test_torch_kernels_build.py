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
    all include the tensor-core header and the Hopper header (TMA,
    mbarriers, wgmma), so an edit of either rebuilds each."""
    csrc = _kernels._PKG / "csrc"
    mma, sm90 = csrc / "flash_attention_mma.cuh", \
        csrc / "flash_attention_sm90.cuh"
    for name, headers in (("flash_attention_fwd", {mma, sm90}),
                          ("flash_attention_bwd", {mma, sm90}),
                          ("fused_matmul_affine_relu", {mma, sm90})):
        src = _kernels._PKG / _kernels.SOURCES[name]
        deps = _kernels._dependencies(src)
        assert deps[0] == src and len(deps) == len(set(deps))
        assert set(deps[1:]) == headers, name


def _code(path):
    """The text of a C++ source without its comments."""
    import re

    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _function(code, name):
    """The body of the first function called ``name`` in ``code``."""
    start = code.index(name + "(")
    body = code.index("{", start)
    depth, i = 0, body
    while True:
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        if depth == 0:
            return code[body:i + 1]
        i += 1


def test_forward_and_dkv_issue_wgmma_on_tma_tiles():
    """The bf16/f16 forward and dK/dV kernels issue ``wgmma.mma_async`` on
    tiles that ``cp.async.bulk.tensor`` loads behind ``mbarrier``s: their
    kernels call the Hopper header's wrappers, which hold those
    instructions, and keep no ``mma.sync`` path (the header's ``mma_16816``
    and ``ldmatrix``).  dQ has no ``mma.sync`` design left."""
    csrc = _kernels._PKG / "csrc"
    sm90 = _code(csrc / "flash_attention_sm90.cuh")
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.3d",
                "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                "wgmma.fence", "wgmma.commit_group", "wgmma.wait_group"):
        assert ptx in sm90, ptx
    fwd = _code(csrc / "flash_attention_fwd.cu")
    bwd = _code(csrc / "flash_attention_bwd.cu")
    for code, kernel in ((fwd, "fa_fwd_wgmma_kernel"),
                         (bwd, "fa_bwd_dkv_wgmma_kernel")):
        body = _function(code, kernel)
        for call in ("tma_load_3d", "mbar_wait", "wgmma_ss_step",
                     "wgmma_rs"):
            assert call in code, (kernel, call)
        for old in ("mma_16816", "ldmatrix", "cp_async"):
            assert old not in body, (kernel, old)
    assert "fa_fwd_mma_kernel" not in fwd
    assert "fa_bwd_dkv_mma_kernel" not in bwd
    assert "fa_bwd_dq_mma_kernel" not in bwd
    # each C entry point of the tensor-core design reaches its new kernel
    assert "launch_wgmma_d" in _function(fwd, "mxt_flash_attention_fwd_mma")
    assert "launch_dkv_wgmma_d" in _function(
        bwd, "mxt_flash_attention_bwd_dkv_mma")


def test_dq_and_fused_issue_wgmma_on_tma_tiles():
    """The bf16/f16 dQ kernel (#2) and the fused 1x1 conv+BN+ReLU kernel
    (#4) issue ``wgmma.mma_async`` on tiles that ``cp.async.bulk.tensor``
    loads behind ``mbarrier``s (3-D maps for dQ, 2-D for #4, whose w is
    the transposed-B operand); dQ writes δ; neither keeps ``mma.sync``,
    ``ldmatrix`` or ``cp.async``.  No ``mma.sync`` design remains in
    either source (the conv wrapper pads what a tensor map cannot
    describe)."""
    csrc = _kernels._PKG / "csrc"
    sm90 = _code(csrc / "flash_attention_sm90.cuh")
    for ptx in ("cp.async.bulk.tensor.2d", "p, 1, 1, 0, 1;"):
        assert ptx in sm90, ptx
    bwd = _code(csrc / "flash_attention_bwd.cu")
    conv = _code(csrc / "fused_matmul_affine_relu.cu")
    for code, kernel, calls in (
            (bwd, "fa_bwd_dq_wgmma_kernel",
             ("tma_load_3d", "mbar_wait", "wgmma_ss_step", "wgmma_rs",
              "delta[")),
            (conv, "fused_mm_affine_relu_wgmma_kernel",
             ("tma_load_2d", "mbar_wait", "mbar_arrive_expect_tx",
              "wgmma_ss_tb", "wgmma_wait<1>"))):
        body = _function(code, kernel)
        for call in calls:
            assert call in body, (kernel, call)
        for old in ("mma_16816", "ldmatrix", "cp_async"):
            assert old not in body, (kernel, old)
    assert "mma_16816" not in bwd and "ldmatrix" not in bwd
    assert "launch_dq_wgmma_d" in _function(
        bwd, "mxt_flash_attention_bwd_dq_mma")
    assert "launch_wgmma" in _function(
        conv, "mxt_fused_matmul_affine_relu_mma")
    assert "mma_16816" not in conv and "ldmatrix" not in conv
    assert "elementwise" not in conv


def test_tensor_maps_need_no_libcuda():
    """The TMA tensor maps are encoded through the entry point that the
    CUDA runtime hands out, so no library links ``-lcuda``."""
    flags = list(_kernels.NVCC_FLAGS) + [
        f for extra in _kernels.EXTRA_FLAGS.values() for f in extra]
    assert not any("cuda" in f and f.startswith("-l") for f in flags)
    sm90 = _code(_kernels._PKG / "csrc" / "flash_attention_sm90.cuh")
    assert "cuTensorMapEncodeTiled" in sm90
    assert "cudaGetDriverEntryPoint" in sm90


def test_every_source_builds_with_its_flags_and_declares_its_symbols(
        tmp_path, monkeypatch):
    """``build`` starts one nvcc a stale source, all together, and only
    the update kernel's, the NMS scan's and the CSR product's carry
    ``--fmad=false`` (each must round where its plain version's separate
    ops round); every library declares its C entry points."""
    import subprocess

    cmds = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            cmds.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return ("", None)

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    logs = _kernels.build()
    assert sorted(logs) == sorted(_kernels.SOURCES) == \
        sorted(_kernels.SYMBOLS)
    for cmd in cmds:
        name = os.path.basename(cmd[-1])[:-3]
        assert ("--fmad=false" in cmd) == \
            (name in ("multi_tensor_update", "nms_keep", "csr_dense_dot"))
        assert (tmp_path / f"lib{name}.so").exists()
    assert _kernels.build() == {}  # nothing stale now
