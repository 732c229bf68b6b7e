"""Automatic mixed precision.

Counterpart of ``mxnet_tpu/amp/__init__.py`` (reference
``python/mxnet/contrib/amp/amp.py`` and ``lists/symbol_fp16.py``).
Casting happens at the op-dispatch choke point: ``ops.registry.apply_op``
calls :func:`maybe_cast_args` with the op's name while amp is active, so
it applies to eager and hybridized execution alike with no graph pass.
The op lists are the port's own copy of the reference's; an op is looked
up by the name it passes to ``apply_op``.  The parameters stay in their
dtype (f32 masters): a listed op casts its float operands on the way in,
and the cast is recorded, so the gradient comes back in the parameter's
dtype.

amp is process-wide state, as in the reference: ``init`` turns it on for
every thread, ``turn_off`` for every thread.  The f16 path keeps the
reference's dynamic loss scaler; bf16 needs none.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "LossScaler", "TARGET_OPS", "FP32_OPS",
           "is_active", "turn_off", "maybe_cast_args"]

# ops that run in the low-precision dtype (the matmul- and conv-heavy
# set; reference list: lists/symbol_fp16.py FP16_FUNCS)
TARGET_OPS = {
    "fully_connected", "convolution", "deconvolution", "dot", "batch_dot",
    "matmul", "linalg_gemm2", "dot_product_attention", "embedding",
    "interleaved_selfatt_qk", "interleaved_selfatt_valatt",
}

# ops pinned to f32 for numerics (reference FP32_FUNCS).  The norm layers
# and softmax_cross_entropy are deliberately not here: their bodies keep
# their statistics in f32 and write their results (and the cross
# entropy's gradient) in the input's dtype, so casting their inputs to
# f32 would only double the bytes of every activation they read.
FP32_OPS = {
    "softmax", "log_softmax", "norm", "sum",
    "mean", "l2_normalization", "exp", "log", "rnn_lstm", "rnn_gru",
}

_STATE = {"active": False, "dtype": None, "scaler": None}


def target_dtype():
    """The low-precision dtype while amp is active, else None."""
    return _STATE["dtype"] if _STATE["active"] else None


def maybe_cast_args(name, raws):
    """Called from ``apply_op``: cast the float operands of op ``name``
    per the op lists (to the target dtype for ``TARGET_OPS``, low
    precision up to f32 for ``FP32_OPS``); others pass unchanged."""
    dt = target_dtype()
    if dt is None:
        return raws
    base = name.split("_<")[0]
    if base in TARGET_OPS:
        return [r.to(dt) if r.is_floating_point() and r.dtype != dt
                else r for r in raws]
    if base in FP32_OPS:
        return [r.float() if r.dtype in (torch.float16, torch.bfloat16)
                else r for r in raws]
    return raws


def init(target_dtype="bfloat16"):
    """Turn amp on (reference ``amp.init()``; the default dtype is
    bfloat16, as in the JAX package)."""
    if str(target_dtype) in ("bfloat16", "bf16", "torch.bfloat16"):
        dt = torch.bfloat16
    elif str(target_dtype) in ("float16", "fp16", "torch.float16"):
        dt = torch.float16
    else:
        raise MXNetError(f"unsupported AMP dtype {target_dtype!r}")
    _STATE["active"] = True
    _STATE["dtype"] = dt


def is_active():
    return _STATE["active"]


def turn_off():
    _STATE["active"] = False
    _STATE["dtype"] = None


class LossScaler:
    """Dynamic loss scaling (reference amp.py DynamicLossScaler): double
    every ``scale_window`` clean steps, halve on overflow."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """Whether any gradient's sum of magnitudes is not finite."""
        for p in params:
            if p.grad_req == "null" or p._data is None:
                continue
            g = p.grad()
            if g is None:
                continue
            if not math.isfinite(float(g._data.float().abs().sum())):
                return True
        return False

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(1.0, self.loss_scale / self._factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale *= self._factor
                self._unskipped = 0


def init_trainer(trainer):
    """Attach a loss scaler to a Trainer (reference ``amp.init_trainer``).
    bf16 needs no scaling; attaching one is still permitted."""
    _STATE["scaler"] = LossScaler()
    trainer._amp_loss_scaler = _STATE["scaler"]
    trainer._amp_original_scale = trainer._scale


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``
    scales the loss up and the Trainer's rescale down (reference
    ``amp.scale_loss``)."""

    def __init__(self, loss, trainer):
        self._trainer = trainer
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        if scaler is None:
            raise MXNetError("call amp.init_trainer(trainer) first")
        self._scaler = scaler
        if isinstance(loss, (list, tuple)):
            self._scaled = [l * scaler.loss_scale for l in loss]
        else:
            self._scaled = loss * scaler.loss_scale

    def __enter__(self):
        self._trainer._scale = self._trainer._amp_original_scale / \
            self._scaler.loss_scale
        return self._scaled

    def __exit__(self, *exc):
        pass


def unscale(trainer):
    """Check the gradients for overflow and update the dynamic scale;
    True when the step should be skipped (reference overflow
    handling)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return False
    overflow = scaler.has_overflow(trainer._params)
    scaler.update_scale(overflow)
    return overflow


def convert_hybrid_block(block, target_dtype="bfloat16", ctx=None):
    """Cast a block's parameters for inference in low precision
    (reference ``amp.convert_hybrid_block``); BatchNorm keeps its f32
    statistics through its own ``cast``."""
    block.cast(torch.bfloat16 if str(target_dtype) in ("bfloat16", "bf16")
               else torch.float16)
    return block
