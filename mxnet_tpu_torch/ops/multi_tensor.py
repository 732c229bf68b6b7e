"""Fused multi-tensor optimizer update: one hand-written CUDA kernel for
every live tensor of a step.

Counterpart of the reference's fused update (``mxnet_tpu/gluon/
trainer.py::Trainer._try_fused_update`` over ``mxnet_tpu/optimizer/
__init__.py::_fused_param_updates``), which XLA compiles into one program
a step; it has no Pallas kernel.  Here ``csrc/multi_tensor_update.cu``
updates the weights, optimizer states and f32 master weights of every
tensor in one launch, in place, from a device table of pointers with each
tensor's lr, wd and update count t (``UpdatePlan``): a CUDA graph that
captured the launch sees a changed lr schedule and the next t when the
host rewrites the table before a replay.

The plain version is the optimizer's own per-tensor rule
(``Optimizer._step``), one tensor at a time; the wrapper takes it only
when the tensors lie on the CPU.  On CUDA every f32, f16 and bf16 weight
goes to the kernel, and anything the kernel does not take raises.
``multi_tensor_update.launches`` counts the launches.

Rules: SGD, SGD with momentum, NAG with momentum, Adam and AdamW
(``Optimizer._fused_rule``), each with or without an f32 master.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels, cuda_graph
from ..base import MXNetError

#: rule name -> the kernel's rule code
RULES = {"sgd": 0, "sgd_mom": 1, "nag_mom": 2, "adam": 3, "adamw": 4}
#: rule name -> the state tensors a tensor carries
_STATES = {"sgd": 0, "sgd_mom": 1, "nag_mom": 1, "adam": 2, "adamw": 2}
#: elements a block (the kernel's kChunk)
CHUNK = 16384
_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_ROW = 10  # int64 words of one table Entry
_PLANS_KEPT = 8


class UpdateItem(NamedTuple):
    """One tensor's update: ``w`` the weight, ``g`` its gradient (the
    weight's dtype), ``states`` the optimizer's state tensors, ``master``
    the f32 master weight or None, and the tensor's lr, wd and t."""
    w: torch.Tensor
    g: torch.Tensor
    states: tuple
    master: torch.Tensor | None
    lr: float
    wd: float
    t: int


def _update_plain(optimizer, items):
    """Plain version: the optimizer's per-tensor rule, one tensor at a
    time (``Optimizer._update_impl``'s body)."""
    with torch.no_grad():
        for it in items:
            if it.master is not None:
                optimizer._step(it.master, it.g.float(), it.states, it.lr,
                                it.wd, it.t)
                it.w.copy_(it.master)
            else:
                optimizer._step(it.w, it.g, it.states, it.lr, it.wd, it.t)


def hyper(optimizer):
    """(rule code, flags, the eight f32 and two f64 scalars) of the
    kernel for ``optimizer`` (``Optimizer._fused_rule``), in the order of
    the C entry point after ``nblocks``."""
    rule, mom, b1, b2, eps = optimizer._fused_rule()
    rescale = float(optimizer.rescale_grad)
    clip = optimizer.clip_gradient
    flags = int(rescale != 1.0) | (int(clip is not None) << 1)
    return (RULES[rule], flags, rescale, float(clip or 0.0), mom, b1,
            1.0 - b1, b2, 1.0 - b2, eps, b1, b2)


class UpdatePlan:
    """The device side of one set of tensors: the block map (one
    (tensor, chunk) pair a block, fixed by the tensors' lengths) and the
    table the host rewrites for each step (``write``).  ``launch`` reads
    both from device memory only, so it can be captured in a CUDA graph
    and replayed after later ``write``s."""

    def __init__(self, numels, device):
        self.numels = tuple(int(n) for n in numels)
        self.device = torch.device(device)
        chunks = [math.ceil(n / CHUNK) for n in self.numels]
        self.nblocks = int(sum(chunks))
        if self.nblocks >= 2 ** 31:
            raise MXNetError("multi_tensor_update: too many blocks "
                             f"({self.nblocks})")
        tensor = np.repeat(np.arange(len(chunks), dtype=np.int32), chunks)
        first = np.repeat(np.cumsum([0] + chunks[:-1]), chunks)
        chunk = np.arange(self.nblocks) - first
        blocks = np.stack([tensor, chunk.astype(np.int32)], axis=1)
        self.blocks = torch.from_numpy(np.ascontiguousarray(blocks)).to(
            self.device)
        self.table = torch.empty((len(self.numels), _ROW), dtype=torch.int64,
                                 device=self.device)
        self._key = self._static = None

    def rows(self, items, optimizer):
        """The table as a host int64 array (one Entry a row).  A set of
        operands is checked and its pointers, lengths and dtypes laid out
        once, keyed by the rule and the operands' addresses and dtypes
        (``_operand_key``); a step with the same operands writes only
        lr, wd and t."""
        rule = optimizer._fused_rule()[0]
        key = (rule, tuple(_operand_key(it) for it in items))
        if key != self._key:
            self._check(items, rule)
            self._static = self._layout(items)
            self._key = key
        rows = self._static.copy()
        rows[:, 7] = np.array([it.lr for it in items],
                              dtype=np.float64).view(np.int64)
        rows[:, 8] = np.array([it.wd for it in items],
                              dtype=np.float64).view(np.int64)
        rows[:, 9] = [it.t for it in items]
        return rows

    @staticmethod
    def _layout(items):
        """Each Entry's pointers, length and dtype code (lr, wd and t
        left 0)."""
        rows = np.zeros((len(items), _ROW), dtype=np.int64)
        for j, it in enumerate(items):
            s = it.states
            rows[j, :5] = (it.w.data_ptr(), it.g.data_ptr(),
                           s[0].data_ptr() if s else 0,
                           s[1].data_ptr() if len(s) > 1 else 0,
                           0 if it.master is None else it.master.data_ptr())
            rows[j, 5] = it.w.numel()
            rows[j, 6] = _CODES[it.w.dtype]
        return rows

    def write(self, items, optimizer):
        """Copy this step's table to the card (stream-ordered, from pinned
        memory: the host does not wait for the card)."""
        host = torch.empty(self.table.shape, dtype=torch.int64,
                           pin_memory=True)
        host.numpy()[:] = self.rows(items, optimizer)
        self.table.copy_(host, non_blocking=True)

    def launch(self, optimizer):
        """Launch the kernel on the current stream over the table as it
        stands on the card when the launch runs."""
        lib = _kernels.load("multi_tensor_update")
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = lib.mxt_multi_tensor_update(
                self.table.data_ptr(), self.blocks.data_ptr(), self.nblocks,
                *hyper(optimizer), stream)
        _kernels.check(lib, err, "multi_tensor_update launch")
        cuda_graph.count(multi_tensor_update)

    def _check(self, items, rule):
        if tuple(it.w.numel() for it in items) != self.numels:
            raise MXNetError("multi_tensor_update: the tensors do not match "
                             "the plan's lengths")
        nstates = _STATES[rule]
        for it in items:
            w = it.w
            # the optimizers' create_state: NAG's momentum in the weight's
            # dtype (f32 with a master), every other state in f32
            sdt = w.dtype if rule == "nag_mom" and it.master is None \
                else torch.float32
            tensors = (w, it.g) + tuple(it.states) + \
                (() if it.master is None else (it.master,))
            if any(t.device != self.device for t in tensors):
                raise MXNetError(
                    "multi_tensor_update: every tensor must lie on "
                    f"{self.device}")
            if w.dtype not in _CODES or it.g.dtype != w.dtype or \
                    it.g.shape != w.shape:
                raise MXNetError(
                    "multi_tensor_update: weights must be float32, float16 "
                    "or bfloat16 with a gradient of the same dtype and "
                    f"shape (got {w.dtype} {tuple(w.shape)}, gradient "
                    f"{it.g.dtype} {tuple(it.g.shape)})")
            if len(it.states) != nstates or any(
                    s.shape != w.shape or s.dtype != sdt
                    for s in it.states):
                raise MXNetError(f"multi_tensor_update: {rule} takes "
                                 f"{nstates} state tensors of the weight's "
                                 f"shape in {sdt}")
            if it.master is not None and (
                    it.master.dtype != torch.float32 or
                    it.master.shape != w.shape or
                    w.dtype == torch.float32):
                raise MXNetError("multi_tensor_update: a master weight is "
                                 "float32 of the weight's shape, for a "
                                 "float16 or bfloat16 weight")
            if not all(t.is_contiguous() for t in tensors):
                raise MXNetError("multi_tensor_update: tensors must be "
                                 "contiguous")


def _operand_key(it):
    """What a validated layout depends on: the addresses and dtypes of
    an item's tensors, and its gradient's shape and layout (a gradient
    may be a view; the weights, states and masters are their holders' own
    tensors)."""
    g = it.g
    return (it.w.data_ptr(), it.w.dtype, g.data_ptr(), g.dtype, g.shape,
            g.is_contiguous(),
            tuple((s.data_ptr(), s.dtype) for s in it.states),
            0 if it.master is None else it.master.data_ptr())


_PLANS = OrderedDict()


def plan_for(items):
    """The cached ``UpdatePlan`` of these tensors' lengths and device."""
    key = (items[0].w.device, tuple(it.w.numel() for it in items))
    plan = _PLANS.pop(key, None)
    if plan is None:
        plan = UpdatePlan(key[1], key[0])
    _PLANS[key] = plan
    while len(_PLANS) > _PLANS_KEPT:
        _PLANS.popitem(last=False)
    return plan


def multi_tensor_update(optimizer, items):
    """Update every ``UpdateItem`` in place by ``optimizer``'s rule: one
    kernel launch for CUDA tensors, the per-tensor plain rule for CPU
    tensors."""
    items = list(items)
    if not items:
        return
    _kernels.refuse_trace("multi_tensor_update", *(it.w for it in items))
    if all(it.w.device.type == "cpu" for it in items):
        _update_plain(optimizer, items)
        return
    if optimizer._kernel_rule() is None:
        raise MXNetError(f"multi_tensor_update: {type(optimizer).__name__} "
                         "has no rule of the kernel")
    plan = plan_for(items)
    plan.write(items, optimizer)
    plan.launch(optimizer)


multi_tensor_update.launches = 0
