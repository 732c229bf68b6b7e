"""Pipeline parallelism (counterpart of ``mxnet_tpu/parallel/pipeline.py``:
GPipe and 1F1B schedules over the ``pp`` axis).  Left out of slice 11
(ROADMAP.md): each entry raises ``MXNetError`` naming that list."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["pipeline_apply", "pipeline_train_1f1b"]

LATER = ("is not ported yet (ROADMAP.md, \"Left out of slice 11\", Queue 1 "
         "item 5)")


def pipeline_apply(*args, **kwargs):
    raise MXNetError(f"parallel.pipeline_apply {LATER}")


def pipeline_train_1f1b(*args, **kwargs):
    raise MXNetError(f"parallel.pipeline_train_1f1b {LATER}")
