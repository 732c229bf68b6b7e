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

Slices so far: Llama inference, Llama training, and ResNet inference
(through a fused 1×1 conv+BN+ReLU kernel) and training
(``gluon.model_zoo.vision``); ROADMAP Queue 1 lists what follows.
"""

__version__ = "0.1.0"

from . import base
from .base import MXNetError
from .context import Context, cpu, gpu, current_context, num_gpus
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import autograd
from . import random
from . import name
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import kvstore
from . import kvstore as kv
from . import gluon
from . import models
from . import convert
