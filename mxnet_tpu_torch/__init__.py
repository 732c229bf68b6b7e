"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The same MXNet 1.x user API over PyTorch on an NVIDIA H100, with the
TPU package's Pallas kernels rewritten by hand in CUDA for Hopper
(``csrc/``).  It imports torch, numpy and the standard library only —
never JAX, and nothing of ``mxnet_tpu``, which stays beside it as the
reference.  ``mx.gpu(i)`` is the CUDA device ``cuda:i`` and the default
context; only an explicit ``mx.cpu()`` runs on the host.

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import llama3_8b

    net = llama3_8b()
    net.cast("bfloat16")
    net.initialize(ctx=mx.gpu(0))
    logits = net(mx.nd.array(ids, dtype="int32"))
    out = net.generate(mx.nd.array(ids, dtype="int32"), max_new_tokens=32)

    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1e-3, "momentum": 0.9})
    with mx.autograd.record():
        loss = mx.nd.softmax_cross_entropy(
            net(ids).reshape((-1, vocab)), labels.reshape((-1,))) / ntok
    loss.backward()
    trainer.step(1)

Slices so far: Llama inference, Llama training, ResNet inference
(through a fused 1×1 conv+BN+ReLU kernel) and training
(``gluon.model_zoo.vision``), Llama serving (``serving``: continuous
batching over a paged KV pool, speculative verify, radix prefix reuse),
step fusion and checkpoints, BERT-base under ``amp`` with stateless
serving (``serving.InferenceServer``), and the op library, the rest of
Gluon, ``metric`` and ``callback`` with the rest of the vision model zoo
(MobileNet, Inception v3, DenseNet, VGG, AlexNet, SqueezeNet), and the
data plane: ``recordio`` with the native reader (``_native``), ``io``,
``image``, ``gluon.data`` and the streaming ``data`` loader with packed
Llama pretraining, and the rest through the NumPy front end (``np``,
``npx``), custom ops (``operator``, ``nd.Custom``), ``rtc``,
``gluon.contrib`` (the Estimator) and the tools (``util``, ``runtime``,
``test_utils``, ``monitor``, ``visualization``); ROADMAP Queue 1 lists
what follows.

Precision: importing the package turns off, once and for the whole
process, the torch flags that would let an f32 product run in TF32
(``torch.backends.cudnn.allow_tf32``,
``torch.backends.cuda.matmul.allow_tf32``) or let cuBLAS sum bf16/f16
split-K partials in the input dtype
(``allow_bf16_reduced_precision_reduction``,
``allow_fp16_reduced_precision_reduction``): the reference's f32 is f32
and its bf16 products accumulate in f32.  They are set globally, not
per op, because the serving lanes run on threads and a process-wide
flag saved and restored around each op would race between them.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

from . import base
from .base import MXNetError
from . import sanitizer
from .context import Context, cpu, gpu, tpu, current_context, num_gpus, \
    num_tpus, num_devices
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import autograd
from . import amp
from . import random
from . import name
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import metric
from . import callback
from . import profiler
from . import kvstore
from . import kvstore as kv
from . import gluon
from . import models
from . import convert
from . import engine
from . import serialization
from . import checkpoint
from . import elastic
from . import serving
from . import recordio
from . import image
from . import io
from . import data
from . import parallel
from . import symbol
from . import symbol as sym
from . import executor
from . import module
from . import module as mod
from . import model
from . import predictor
from . import contrib
from . import rnn
from . import util
from . import numpy
from . import numpy as np
from . import numpy_extension
from . import numpy_extension as npx
from . import operator
from . import rtc
from . import test_utils
from . import runtime
from . import monitor
from . import telemetry
from . import visualization
from . import visualization as viz
