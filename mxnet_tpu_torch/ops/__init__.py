"""Operator library of the port (counterpart of ``mxnet_tpu/ops``),
with the registry's ``apply_op`` and ``defop`` at its top, as the
reference re-exports them."""
from .registry import apply_op, defop  # noqa: F401
