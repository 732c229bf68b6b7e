"""Optimizers: the ``Optimizer`` base, ``SGD``, ``NAG``, ``Adam``,
``AdamW``, ``LAMB``, ``RMSProp`` (plain and centered), ``AdaGrad``,
``AdaDelta``, ``Ftrl``, ``Signum``, ``SignSGD``, ``LARS`` and ``Test``,
with ``Updater``/``get_updater``.

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
``multi_precision=True`` adds an f32 master weight.  A ``row_sparse``
gradient (``ndarray/sparse.py``) takes the lazy row update of SGD and
Adam (``_sparse_step``: only the stored rows and their state change);
another optimizer takes it dense.  The optimizers
after AdamW have no rule code in the kernel (ROADMAP Queue 2): the
Trainer runs their ``_step`` tensor by tensor, and ``FusedTrainStep``
captures that rule in its graph.  There lr, wd and t are 0-d f32 tensors
on the card that the host rewrites before each replay, so every
``_step`` takes them as python numbers or as such tensors: no branch on
their values, no ``math`` on them.
"""
from __future__ import annotations

import math
import pickle
import warnings

import numpy as np
import torch

from .. import engine
from ..base import MXNetError
from ..ndarray import NDArray
from ..ops import multi_tensor

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "LAMB", "RMSProp",
           "AdaGrad", "AdaDelta", "Ftrl", "Signum", "SignSGD", "LARS",
           "Test", "Updater", "get_updater", "create", "register"]

_LOW = (torch.float16, torch.bfloat16)
_FUSED_DTYPES = (torch.float32,) + _LOW  # the fused kernel's weights


def _state_zeros(weight, dtype=None):
    """Zeros of the weight's shape on its device (in ``dtype``, default
    the weight's); over a mesh laid out as the weight (a sharded weight's
    state holds each rank's piece only)."""
    return NDArray(torch.zeros_like(weight._data,
                                    dtype=dtype or weight.dtype,
                                    memory_format=torch.contiguous_format))


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

    def __getstate__(self):
        """The optimizer as pickled for a parameter server
        (``kvstore.dist_async``): each Parameter of ``param_dict`` stands
        as its ``lr_mult`` and ``wd_mult``, all the update reads of it
        (its arrays stay with the worker)."""
        import types

        state = dict(self.__dict__)
        state["param_dict"] = {
            k: types.SimpleNamespace(lr_mult=p.lr_mult, wd_mult=p.wd_mult)
            for k, p in self.param_dict.items()}
        return state

    # -- registry ------------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise MXNetError(f"unknown optimizer {name!r}; registered: "
                             f"{sorted(Optimizer.opt_registry)}")
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

    def _sparse_rows(self, weight, grad, wd):
        """(row ids, rescaled and clipped gradient rows + wd·w rows) of a
        row_sparse gradient, in the reference's order of operations."""
        idx = grad.indices._data
        g = grad.data._data * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return idx, g + wd * weight._data[idx]

    def _prep_grad(self, g, w, wd, include_wd=True):
        """rescale, clip, + wd·w in g's dtype (new tensors; ``g`` itself
        is left alone).  Steps that change nothing are skipped."""
        if self.rescale_grad != 1.0:
            g = g * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        if include_wd and (torch.is_tensor(wd) or wd):
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
        from ..ndarray import sparse as sp

        if isinstance(grad, sp.BaseSparseNDArray):
            # the lazy row update: only the rows a row_sparse gradient
            # stores are touched (reference ``lazy_update``); an
            # optimizer without one takes the gradient dense
            if isinstance(grad, sp.RowSparseNDArray) and \
                    hasattr(self, "_sparse_step"):
                with torch.no_grad():
                    self._sparse_step(index, weight, grad, state, lr, wd, t)
                return
            grad = grad.todense()
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


def _states_from_numpy(state, like=None):
    """``_states_to_numpy``'s inverse, on the device and in the dtypes of
    ``like`` (a state of the same nesting) when given."""
    if state is None:
        return None
    if isinstance(state, np.ndarray):
        if like is None:
            return NDArray(torch.from_numpy(state.copy()))
        return NDArray(torch.from_numpy(state.copy()).to(
            device=like._data.device, dtype=like.dtype))
    likes = like if like is not None else (None,) * len(state)
    return tuple(_states_from_numpy(s, lk) for s, lk in zip(state, likes))


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

    def _sparse_step(self, index, weight, grad, state, lr, wd, t):
        """The lazy row update (reference ``sgd_update(lazy_update=
        True)``): the rows the gradient stores, and their momentum, are
        updated in place; every other row keeps its bits."""
        idx, g = self._sparse_rows(weight, grad, wd)
        w = weight._data
        if self.momentum == 0.0:
            w.index_add_(0, idx, (-lr * g).to(w.dtype))
            return
        mom = state._data
        rows = self.momentum * mom[idx] - lr * g
        mom[idx] = rows
        w.index_add_(0, idx, rows.to(w.dtype))


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

    def _sparse_step(self, index, weight, grad, state, lr, wd, t):
        """The lazy row update (reference ``adam_update(lazy_update=
        True)``): the moments and weights of the rows the gradient
        stores; every other row, and its moments, keep their bits."""
        m, v = (s._data for s in state)
        idx, g = self._sparse_rows(weight, grad, wd)
        m_rows = self.beta1 * m[idx] + (1 - self.beta1) * g
        v_rows = self.beta2 * v[idx] + (1 - self.beta2) * torch.square(g)
        lr_t = lr * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)
        m[idx] = m_rows
        v[idx] = v_rows
        w = weight._data
        w.index_add_(0, idx, (-lr_t * m_rows /
                              (torch.sqrt(v_rows) + self.epsilon))
                     .to(w.dtype))


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


def _norm(t):
    return torch.linalg.vector_norm(t)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer (reference
    ``lamb_update_phase1/2``): Adam's direction with weight decay, scaled
    by ‖w‖/‖direction‖ (bounded by ``lower_bound``/``upper_bound``);
    moments in f32 for f16/bf16 weights."""

    def __init__(self, learning_rate=None, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.001, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        dt = torch.float32 if weight.dtype in _LOW else None
        return (_state_zeros(weight, dt), _state_zeros(weight, dt))

    def _step(self, w, g, states, lr, wd, t):
        m, v = states
        wf = w.to(m.dtype)
        g = self._prep_grad(g.to(m.dtype), wf, 0.0, include_wd=False)
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * torch.square(g))
        if self.bias_correction:
            mhat = m / (1 - self.beta1 ** t)
            vhat = v / (1 - self.beta2 ** t)
        else:
            mhat, vhat = m, v
        gprime = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * wf
        r1 = _norm(wf)
        if self.lower_bound is not None:
            r1 = r1.clamp_min(self.lower_bound)
        if self.upper_bound is not None:
            r1 = r1.clamp_max(self.upper_bound)
        r2 = _norm(gprime)
        ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                            torch.ones_like(r1))
        w.sub_((lr * ratio * gprime).to(w.dtype))


@register
class RMSProp(Optimizer):
    """RMSProp (reference ``rmsprop_update``: ``n = (1−γ1)·g² + γ1·n;
    w −= lr·g/√(n + ε)``) and, with ``centered``, Graves' variant
    (``rmspropalex_update``); states in the weight's dtype, weights
    clipped to ±``clip_weights`` when given."""

    def __init__(self, learning_rate=None, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.001, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_state_zeros(weight), _state_zeros(weight),
                    _state_zeros(weight))
        return (_state_zeros(weight),)

    def _step(self, w, g, states, lr, wd, t):
        g = self._prep_grad(g.to(w.dtype), w, wd)
        n = states[0]
        n.mul_(self.gamma1).add_((1 - self.gamma1) * torch.square(g))
        if not self.centered:
            w.sub_(lr * g / torch.sqrt(n + self.epsilon))
        else:
            _, gbar, delta = states
            gbar.mul_(self.gamma1).add_((1 - self.gamma1) * g)
            delta.mul_(self.gamma2).sub_(lr * g / torch.sqrt(
                n - torch.square(gbar) + self.epsilon))
            w.add_(delta)
        if self.clip_weights:
            w.clamp_(-self.clip_weights, self.clip_weights)


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference ``adagrad_update``): ``h += g²;
    w −= lr·g/(√h + eps)``."""

    def __init__(self, learning_rate=None, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.01, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _state_zeros(weight)

    def _step(self, w, g, states, lr, wd, t):
        (hist,) = states
        g = self._prep_grad(g.to(w.dtype), w, wd)
        hist.add_(torch.square(g))
        w.sub_(lr * g / (torch.sqrt(hist) + self.float_stable_eps))


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference ``adadelta_update``); the learning rate is not
    used."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_state_zeros(weight), _state_zeros(weight))

    def _step(self, w, g, states, lr, wd, t):
        acc_g, acc_delta = states
        g = self._prep_grad(g.to(w.dtype), w, wd)
        acc_g.mul_(self.rho).add_((1 - self.rho) * torch.square(g))
        delta = torch.sqrt(acc_delta + self.epsilon) / torch.sqrt(
            acc_g + self.epsilon) * g
        acc_delta.mul_(self.rho).add_((1 - self.rho) * torch.square(delta))
        w.sub_(delta)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference ``ftrl_update``), L1 strength
    ``lamda1``."""

    def __init__(self, lamda1=0.01, learning_rate=None, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.1, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_state_zeros(weight), _state_zeros(weight))  # z, n

    def _step(self, w, g, states, lr, wd, t):
        z, n = states
        g = self._prep_grad(g.to(w.dtype), w, 0.0, include_wd=False)
        sq = torch.square(g)
        sigma = (torch.sqrt(n + sq) - torch.sqrt(n)) / lr
        z.copy_(z + g - sigma * w)
        n.add_(sq)
        new_w = -(z - torch.sign(z) * self.lamda1) / \
            ((self.beta + torch.sqrt(n)) / lr + wd)
        w.copy_(torch.where(torch.abs(z) > self.lamda1, new_w,
                            torch.zeros_like(w)))


@register
class Signum(Optimizer):
    """signSGD with momentum (reference ``signum_update``): ``mom =
    μ·mom − (1−μ)·g; w = (1 − lr·wd_lh)·w + lr·sign(mom)``; without
    momentum ``w −= lr·sign(g)``."""

    def __init__(self, learning_rate=None, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.01, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _state_zeros(weight)

    def _step(self, w, g, states, lr, wd, t):
        g = self._prep_grad(g.to(w.dtype), w, wd)
        if self.momentum == 0.0:
            w.sub_(lr * torch.sign(g))
            return
        (mom,) = states
        mom.mul_(self.momentum).sub_((1 - self.momentum) * g)
        w.copy_((1 - lr * self.wd_lh) * w + lr * torch.sign(mom))


@register
class SignSGD(Signum):
    """Signum without momentum (reference ``signsgd_update``)."""

    def __init__(self, learning_rate=None, **kwargs):
        super().__init__(learning_rate=learning_rate, momentum=0.0, **kwargs)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling with momentum: the step scaled by
    ``eta·‖w‖/(‖g‖ + wd·‖w‖ + ε)``."""

    def __init__(self, learning_rate=None, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate
                         if learning_rate is not None else 0.1, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _state_zeros(weight)

    def _step(self, w, g, states, lr, wd, t):
        (mom,) = states
        g = self._prep_grad(g.to(w.dtype), w, 0.0, include_wd=False)
        w_norm, g_norm = _norm(w), _norm(g)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
            torch.ones_like(w_norm))
        mom.mul_(self.momentum).add_(lr * trust * (g + wd * w))
        w.sub_(mom)


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w −= lr·rescale_grad·g``."""

    def _step(self, w, g, states, lr, wd, t):
        w.sub_(lr * (g * self.rescale_grad).to(w.dtype))


class Updater:
    """An optimizer applied per (index, grad, weight) — the reference's
    kvstore-side updater (``mx.optimizer.get_updater``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def update_many(self, indices, grads, weights):
        """Apply the optimizer to (index, grad, weight) triples of distinct
        indices: all in one launch of the fused multi-tensor kernel where
        its rule applies (``gluon.Trainer``'s route, ``_fused_param_
        updates``), else one by one (``__call__``).  A sparse gradient
        takes its own lazy row update."""
        from ..ndarray import sparse as sp

        optzr = self.optimizer
        dense = []
        for i, g, w in zip(indices, grads, weights):
            if isinstance(g, sp.BaseSparseNDArray):
                self(i, g, w)  # the lazy row update
            else:
                dense.append((i, g, w))
        if not dense:
            return
        indices, grads, weights = zip(*dense)
        fusable = not engine.is_naive() and \
            optzr._kernel_rule() is not None and all(
                w.dtype in _FUSED_DTYPES and g.dtype == w.dtype and
                g.shape == w.shape for g, w in zip(grads, weights))
        if not fusable:
            for i, g, w in zip(indices, grads, weights):
                self(i, g, w)
            return
        mp_flags, m_raws, s_raws = [], [], []
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = optzr.create_state_multi_precision(i, w)
                self.states_synced[i] = True
            state = self.states[i]
            use_mp = optzr.multi_precision and w.dtype in _LOW
            if use_mp:
                master, state = state
                m_raws.append(master._data)
            mp_flags.append(use_mp)
            s_raws.append(_flatten_state(state))
            optzr._update_count(i)
        _fused_param_updates(
            optzr, mp_flags, [w._data for w in weights], m_raws,
            [g._data.contiguous() for g in grads], s_raws,
            [optzr._get_lr(i) for i in indices],
            [optzr._get_wd(i) for i in indices],
            [optzr._index_update_count[i] for i in indices])

    def get_states(self, dump_optimizer=False):
        """The states as a pickle of numpy arrays (with the optimizer's
        name when ``dump_optimizer``)."""
        states = {k: _states_to_numpy(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, _OptimizerConfig(self.optimizer)))
        return pickle.dumps(states)

    def set_states(self, states):
        """Restore ``get_states``'s result (on the devices and in the
        dtypes of the states already held, else on the CPU)."""
        loaded = pickle.loads(states)
        if isinstance(loaded, tuple):
            loaded = loaded[0]
        self.states = {k: _states_from_numpy(v, self.states.get(k))
                       for k, v in loaded.items()}
        self.states_synced = {k: True for k in self.states}


class _OptimizerConfig:
    def __init__(self, opt):
        self.name = type(opt).__name__.lower()


def get_updater(optimizer):
    """An ``Updater`` over ``optimizer`` (reference ``get_updater``)."""
    return Updater(optimizer)
