"""Optimizers: the ``Optimizer`` base, ``SGD``, ``NAG``, ``Adam`` and
``AdamW``.

Counterpart of ``mxnet_tpu/optimizer/__init__.py`` (reference
``python/mxnet/optimizer/optimizer.py`` over the update ops of
``src/operator/optimizer_op.cc``).  The update rules are MXNet's, written
out here, never ``torch.optim``'s (which differ: MXNet's SGD keeps
``mom = μ·mom − lr·g; w += mom``, and its Adam folds the bias correction
into ``lr_t`` and adds ε to the uncorrected ``√v``).

Each ``_step`` updates the weight and its state tensors in place, under
``torch.no_grad()``, so a parameter keeps its ``torch.nn.Parameter`` and
no second copy of the weights or states is made.  ``_step`` is also the
plain version of the fused multi-tensor kernel
(``ops/multi_tensor.py``), which ``gluon.Trainer`` and
``gluon.FusedTrainStep`` run through ``_fused_param_updates``: one launch
a step, by the rule code each optimizer names (``_fused_rule``).  State
is f32 for f16/bf16 weights (SGD momentum, Adam moments);
``multi_precision=True`` adds an f32 master weight.  The other optimizers (LAMB, RMSProp, ...)
port later (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

import math
import warnings

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from ..ops import multi_tensor

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "create",
           "register"]

_LOW = (torch.float16, torch.bfloat16)


def _state_zeros(weight, dtype=None):
    """Zeros of the weight's shape on its device (in ``dtype``, default
    the weight's)."""
    return NDArray(torch.zeros(weight.shape, dtype=dtype or weight.dtype,
                               device=weight._data.device))


class Optimizer:
    """Base optimizer (reference ``mx.optimizer.Optimizer``)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict if param_dict else {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- registry ------------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise MXNetError(f"unknown optimizer {name!r}; registered: "
                             f"{sorted(Optimizer.opt_registry)} (the others "
                             "are not ported yet: ROADMAP.md, Queue 1 "
                             "item 2)")
        return Optimizer.opt_registry[name.lower()](**kwargs)

    # -- lr/wd ---------------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError(
                "cannot set learning rate: an LRScheduler is active")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith("_weight")}
        self.wd_mult.update(args_wd_mult)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler else \
            self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    # -- state ---------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if weight.dtype in _LOW:
            if self.multi_precision:
                master = NDArray(weight._data.detach().float())
                return (master, self.create_state(index, master))
            warnings.warn(
                "reduced-precision weights without multi_precision=True may "
                "be poorly conditioned; consider multi_precision=True")
        return self.create_state(index, weight)

    # -- update --------------------------------------------------------------
    def _fused_rule(self):
        """(rule, momentum, beta1, beta2, epsilon) of the fused kernel
        (``ops/multi_tensor.RULES``), or None for an optimizer it has no
        rule for."""
        return None

    def _kernel_rule(self):
        """``_fused_rule()``, or None when this optimizer's class
        overrides the ``_step`` of the class that names the rule: the
        kernel would run that class's rule, not the override."""
        owner = next(c for c in type(self).__mro__
                     if "_fused_rule" in vars(c))
        if type(self)._step is not owner._step:
            return None
        return self._fused_rule()

    def _step(self, w, g, states, lr, wd, t):
        """The update rule on raw tensors: updates ``w`` and the
        ``states`` tensors in place.  Subclasses implement it."""
        raise NotImplementedError

    def _prep_grad(self, g, w, wd, include_wd=True):
        """rescale, clip, + wd·w in g's dtype (new tensors; ``g`` itself
        is left alone).  Steps that change nothing are skipped."""
        if self.rescale_grad != 1.0:
            g = g * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        if include_wd and wd:
            g = g + wd * w.to(g.dtype)
        return g

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, multi_precision=False)

    def update_multi_precision(self, index, weight, grad, state):
        use_mp = self.multi_precision and weight.dtype in _LOW
        self._update_impl(index, weight, grad, state, multi_precision=use_mp)

    def _update_impl(self, index, weight, grad, state, multi_precision):
        if isinstance(index, (list, tuple)):
            for i, w, g, s in zip(index, weight, grad, state):
                self._update_impl(i, w, g, s, multi_precision)
            return
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        with torch.no_grad():
            if multi_precision:
                master, sub_state = state
                self._step(master._data, grad._data.float(),
                           _flatten_state(sub_state), lr, wd, t)
                weight._data.copy_(master._data)
            else:
                self._step(weight._data, grad._data, _flatten_state(state),
                           lr, wd, t)


def _flatten_state(state):
    """The raw tensors of a state (None, an NDArray or nested tuples)."""
    if state is None:
        return ()
    if isinstance(state, NDArray):
        return (state._data,)
    return tuple(t for s in state for t in _flatten_state(s))


def _update_items(mp_flags, w_raws, m_raws, g_raws, s_raws, lr_v, wd_v,
                  t_v):
    """The multi-tensor kernel's operands, one ``UpdateItem`` a tensor;
    ``m_raws`` holds only the multi-precision masters, in order among the
    ``mp_flags`` tensors."""
    items, mi = [], 0
    for j, use_mp in enumerate(mp_flags):
        master = None
        if use_mp:
            master, mi = m_raws[mi], mi + 1
        items.append(multi_tensor.UpdateItem(
            w_raws[j], g_raws[j], tuple(s_raws[j]), master, lr_v[j],
            wd_v[j], t_v[j]))
    return items


def _fused_param_updates(optzr, mp_flags, w_raws, m_raws, g_raws, s_raws,
                         lr_v, wd_v, t_v):
    """One optimizer step over all live tensors, in one launch of the
    multi-tensor kernel (its plain version, ``_step`` tensor by tensor,
    on the CPU) — the Trainer's fused update.  The update is in place, in
    the parameters', masters' and states' own tensors, so the reference's
    ``_commit_param_updates`` (which writes the new arrays back) has
    nothing to do here and is not ported."""
    multi_tensor.multi_tensor_update(optzr, _update_items(
        mp_flags, w_raws, m_raws, g_raws, s_raws, lr_v, wd_v, t_v))


def _state_holders(state):
    """The NDArrays of a state (None, an NDArray or nested tuples)."""
    if state is None:
        return ()
    if isinstance(state, NDArray):
        return (state,)
    return tuple(h for s in state for h in _state_holders(s))


def _states_to_numpy(state):
    """A state as numpy arrays in the same nesting (the reference's
    ``save_states`` payload; bf16 comes back as f32)."""
    if state is None:
        return None
    if isinstance(state, NDArray):
        return state.asnumpy()
    return tuple(_states_to_numpy(s) for s in state)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum (reference ``sgd_update`` / ``sgd_mom_update`` /
    ``mp_sgd_*``): ``mom = μ·mom − lr·g; w += mom``, momentum in f32 for
    f16/bf16 weights."""

    def __init__(self, momentum=0.0, lazy_update=True, learning_rate=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.01, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _state_zeros(weight, torch.float32
                            if weight.dtype in _LOW else None)

    def _fused_rule(self):
        return ("sgd_mom" if self.momentum else "sgd", self.momentum, 0.0,
                0.0, 0.0)

    def _step(self, w, g, states, lr, wd, t):
        g = self._prep_grad(g.to(w.dtype), w, wd)
        if self.momentum == 0.0:
            w.sub_(lr * g)
            return
        (mom,) = states
        mom.mul_(self.momentum).sub_(lr * g.to(mom.dtype))
        w.add_(mom.to(w.dtype))


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference ``nag_mom_update``); momentum
    in the weight's dtype."""

    def __init__(self, momentum=0.0, learning_rate=None, **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.01, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _state_zeros(weight)

    def _fused_rule(self):
        return ("nag_mom" if self.momentum else "sgd", self.momentum, 0.0,
                0.0, 0.0)

    def _step(self, w, g, states, lr, wd, t):
        g = self._prep_grad(g.to(w.dtype), w, wd)
        if self.momentum == 0.0:
            w.sub_(lr * g)
            return
        (mom,) = states
        mom.mul_(self.momentum).add_(g)
        w.sub_(lr * (g + self.momentum * mom))


@register
class Adam(Optimizer):
    """Adam (reference ``adam_update``; default lr 0.001): the bias
    correction folds into ``lr_t = lr·√(1−β2ᵗ)/(1−β1ᵗ)`` and ε is added
    to the uncorrected ``√v``; moments in f32 for f16/bf16 weights."""

    def __init__(self, learning_rate=None, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.001, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        dt = torch.float32 if weight.dtype in _LOW else None
        return (_state_zeros(weight, dt), _state_zeros(weight, dt))

    def _fused_rule(self):
        return ("adam", 0.0, self.beta1, self.beta2, self.epsilon)

    def _moments(self, m, v, g, lr, t):
        """Update the moments in place → the step ``lr_t·m/(√v + ε)``."""
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * torch.square(g))
        lr_t = lr * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)
        return lr_t * m / (torch.sqrt(v) + self.epsilon)

    def _step(self, w, g, states, lr, wd, t):
        m, v = states
        g = self._prep_grad(g.to(m.dtype), w, wd)
        w.sub_(self._moments(m, v, g, lr, t).to(w.dtype))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (reference contrib
    ``adamw_update``): ``w −= lr_t·m/(√v + ε) + lr·wd·w``."""

    def _fused_rule(self):
        return ("adamw", 0.0, self.beta1, self.beta2, self.epsilon)

    def _step(self, w, g, states, lr, wd, t):
        m, v = states
        g = self._prep_grad(g.to(m.dtype), w, 0.0, include_wd=False)
        upd = self._moments(m, v, g, lr, t) + lr * wd * w.to(m.dtype)
        w.sub_(upd.to(w.dtype))
