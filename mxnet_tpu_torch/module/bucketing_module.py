"""BucketingModule: variable-length sequence training.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference
``python/mxnet/module/bucketing_module.py``): one Module a bucket key,
all sharing one set of parameter arrays; ``sym_gen(bucket_key)`` makes
each bucket's symbol (classically unrolled RNNs fed by
``rnn.BucketSentenceIter``).
"""
from __future__ import annotations

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=None,
                 context=None, **module_kwargs):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._module_kwargs = module_kwargs
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._init_args = None
        self._opt_args = None

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      **self._module_kwargs)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        if self.binded and not force_rebind:
            return
        self._fold = (data_shapes, label_shapes)
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training=for_training,
                 inputs_need_grad=inputs_need_grad)
        self._buckets[self._default_bucket_key] = mod
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        if bucket_key not in self._buckets:
            mod = self._gen_module(bucket_key)
            mod.bind(data_shapes, label_shapes,
                     for_training=self.for_training,
                     inputs_need_grad=self.inputs_need_grad,
                     shared_module=self._buckets[self._default_bucket_key])
            self._share_params(self._buckets[self._default_bucket_key], mod)
            if self.params_initialized:
                mod.params_initialized = True
            if self.optimizer_initialized and self._opt_args:
                mod.init_optimizer(**self._opt_args)
            self._buckets[bucket_key] = mod
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    @staticmethod
    def _share_params(src, dst):
        """Alias parameter/aux NDArray handles so buckets train one set of
        weights (the reference shares executor arg arrays the same way)."""
        for name in dst._param_names:
            if name in src._exec.arg_dict:
                dst._exec.arg_dict[name] = src._exec.arg_dict[name]
                if name in src._exec.grad_dict:
                    dst._exec.grad_dict[name] = src._exec.grad_dict[name]
        for name in dst._aux_names:
            if name in src._exec.aux_dict:
                dst._exec.aux_dict[name] = src._exec.aux_dict[name]

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        assert self.binded
        self._buckets[self._default_bucket_key].init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._opt_args = dict(kvstore=kvstore, optimizer=optimizer,
                              optimizer_params=optimizer_params)
        for mod in self._buckets.values():
            mod.init_optimizer(**self._opt_args, force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._default_bucket_key)
        data_shapes = getattr(data_batch, "provide_data", None)
        label_shapes = getattr(data_batch, "provide_label", None)
        self.switch_bucket(key, data_shapes or self._fold[0],
                           label_shapes if label_shapes is not None
                           else self._fold[1])
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._buckets[self._default_bucket_key].set_params(
            arg_params, aux_params, **kwargs)
        self.params_initialized = True

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)
