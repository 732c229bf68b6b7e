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

This slice ports Llama inference (ROADMAP Queue 1 lists what follows).
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
from . import gluon
from . import models
from . import convert
