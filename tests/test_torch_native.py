"""The port's native host runtime (``mxnet_tpu_torch._native``, built by
g++ from ``mxnet_tpu_torch/csrc/``): the dependency engine's ordering
rules, the reader's counts and offsets against the JAX package's record
files, the prefetcher's order and buffer pool, and the build's failure
mode.  The engine tests follow ``tests/test_native.py``."""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec

from mxnet_tpu_torch import _native
from mxnet_tpu_torch.base import MXNetError

ROOT = Path(__file__).resolve().parents[1]


def test_engine_write_serialization():
    """A read-modify-write on a shared cell stays exact: writes on one
    var run one at a time, in push order."""
    eng = _native.Engine(nthreads=4)
    var = eng.new_var()
    cell = {"v": 0}

    def bump():
        cur = cell["v"]
        time.sleep(0.001)
        cell["v"] = cur + 1

    for _ in range(50):
        eng.push(bump, write_vars=[var])
    eng.wait_all()
    assert cell["v"] == 50
    assert eng.var_version(var) == 50


def test_engine_reads_parallel_writes_serial():
    eng = _native.Engine(nthreads=4)
    var = eng.new_var()
    t0 = time.time()
    for _ in range(4):
        eng.push(lambda: time.sleep(0.1), read_vars=[var])
    eng.wait_all()
    assert time.time() - t0 < 0.35, "reads of one var run together"
    t0 = time.time()
    for _ in range(4):
        eng.push(lambda: time.sleep(0.05), write_vars=[var])
    eng.wait_all()
    assert time.time() - t0 >= 0.2, "writes of one var run one at a time"


def test_engine_wait_for_var_and_independent_vars():
    eng = _native.Engine(nthreads=4)
    var = eng.new_var()
    log = []
    eng.push(lambda: (time.sleep(0.05), log.append("w")), write_vars=[var])
    eng.wait_for_var(var)
    assert log == ["w"]
    t0 = time.time()
    for _ in range(4):
        eng.push(lambda: time.sleep(0.1), write_vars=[eng.new_var()])
    eng.wait_all()
    assert time.time() - t0 < 0.35


def test_engine_read_write_ordering():
    """A read after a write sees it; a write after a read waits for it."""
    eng = _native.Engine(nthreads=4)
    var = eng.new_var()
    seen = []
    eng.push(lambda: (time.sleep(0.05), seen.append("write1")),
             write_vars=[var])
    eng.push(lambda: seen.append("read:" + str("write1" in seen)),
             read_vars=[var])
    eng.push(lambda: seen.append("write2"), write_vars=[var])
    eng.wait_all()
    assert seen == ["write1", "read:True", "write2"]


def _indexed_recfile(tmp_path, n=30, seed=0):
    """An indexed record file written by the JAX package; returns its
    paths, payloads and the offset of each record (from its .idx)."""
    rng = np.random.RandomState(seed)
    payloads = [rng.bytes(int(rng.randint(1, 4000))) for _ in range(n)]
    rec, idx = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    r = jrec.MXIndexedRecordIO(idx, rec, "r")
    offsets = [r.idx[i] for i in range(n)]
    r.close()
    return rec, idx, payloads, offsets


def test_reader_counts_offsets_and_payloads(tmp_path):
    rec, _, payloads, offsets = _indexed_recfile(tmp_path)
    rd = _native.RecordReader(rec)
    assert len(rd) == len(payloads)
    assert [rd.offset(i) for i in range(len(rd))] == offsets
    for i in reversed(range(len(payloads))):
        assert rd.read(i) == payloads[i]
    with pytest.raises(IndexError):
        rd.read(len(payloads))
    rd.close()


def test_reader_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        _native.RecordReader(str(tmp_path / "nope.rec"))


def test_prefetcher_returns_batches_in_schedule_order(tmp_path):
    rec, _, payloads, _ = _indexed_recfile(tmp_path, n=40, seed=1)
    pf = _native.Prefetcher(rec, nthreads=4, capacity=3)
    order = np.random.RandomState(2).permutation(40)
    batches = [order[s:s + 8] for s in range(0, 40, 8)]
    for b in batches:
        pf.schedule(b)
    for b in batches:
        assert pf.next() == [payloads[i] for i in b]
    assert pf.next() is None
    pf.close()


def test_pool_reuses_buffers_across_consumers(tmp_path):
    rec, _, _, _ = _indexed_recfile(tmp_path, n=16, seed=3)

    def run_once():
        pf = _native.Prefetcher(rec, nthreads=2, capacity=2)
        for _ in range(6):
            pf.schedule(list(range(8)))
        for _ in range(6):
            assert pf.next() is not None
        pf.close()

    run_once()
    h0, _ = _native.pool_stats()
    run_once()  # the same buffer sizes: served from the pool
    h1, _ = _native.pool_stats()
    assert h1 > h0


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(_native, "SOURCES", [bad])
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "LIB_PATH", tmp_path / "build" / "x.so")
    with pytest.raises(MXNetError, match="native library failed") as err:
        _native.build()
    assert "bad.cc" in str(err.value) and "error" in str(err.value)
    assert not (tmp_path / "build" / "x.so").exists()


def test_library_is_the_ports_own_build():
    """The library comes from mxnet_tpu_torch/csrc into
    mxnet_tpu_torch/build; the JAX package's libmxtpu.so is never
    loaded (checked in a fresh process)."""
    assert _native.LIB_PATH == ROOT / "mxnet_tpu_torch" / "build" / \
        "libmxtnative.so"
    assert all(s.parent == ROOT / "mxnet_tpu_torch" / "csrc"
               for s in _native.SOURCES)
    code = ("from mxnet_tpu_torch import _native\n_native.lib()\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('libmxtnative.so' in maps, 'libmxtpu' in maps)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False"]
