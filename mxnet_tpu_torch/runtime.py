"""Runtime feature introspection.

Counterpart of ``mxnet_tpu/runtime.py`` (reference
``python/mxnet/runtime.py``, ``src/libinfo.cc``): ``mx.runtime.Features()``
maps each capability name to a ``Feature`` with ``is_enabled(name)``.
The flags say what this build provides, read from torch at the first
call: ``CUDA``, ``CUDNN`` and ``NCCL`` where torch has them and a card is
present, ``BF16`` and ``F16C`` with CUDA, ``NATIVE_ENGINE`` where the
port's g++-built host runtime (``_native``) builds; ``TPU``, ``PALLAS``,
``XLA`` and ``JIT`` are false (the kernels are hand-written CUDA, the
graphs CUDA graphs).
"""
from __future__ import annotations

import collections


class Feature(collections.namedtuple("Feature", ["name", "enabled"])):
    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    import torch

    cuda = torch.cuda.is_available()
    feats = {"TPU": False, "CPU": True, "XLA": False, "JIT": False,
             "PALLAS": False}
    from . import _native

    feats["NATIVE_ENGINE"] = _native.available()
    feats["RECORDIO"] = True
    feats["DIST_KVSTORE"] = torch.distributed.is_available()
    feats["SPARSE"] = True
    feats["BF16"] = True
    feats["INT64_TENSOR_SIZE"] = True
    feats["CUDA"] = cuda
    feats["CUDNN"] = cuda and torch.backends.cudnn.is_available()
    feats["NCCL"] = cuda and torch.distributed.is_available() and \
        torch.distributed.is_nccl_available()
    feats["CUDA_GRAPHS"] = cuda
    feats["F16C"] = cuda
    for off in ("TENSORRT", "MKLDNN", "OPENCV", "CAFFE", "PROFILER_NVTX"):
        feats[off] = False
    feats["OPENMP"] = torch.backends.openmp.is_available()
    feats["SIGNAL_HANDLER"] = True
    feats["PROFILER"] = True
    return feats


class Features(collections.OrderedDict):
    """Reference ``mx.runtime.Features``: name → ``Feature``."""

    instance = None

    def __new__(cls):
        if cls.instance is None:
            cls.instance = super().__new__(cls)
            cls.instance.update(
                {k: Feature(k, v) for k, v in _detect().items()})
        return cls.instance

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"feature '{feature_name}' is unknown; "
                               f"known: {sorted(self)}")
        return self[feature_name].enabled


def feature_list():
    """Reference ``mx.runtime.feature_list()``."""
    return list(Features().values())
