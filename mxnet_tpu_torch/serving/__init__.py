"""Continuous-batching Llama serving on the card.

Counterpart of ``mxnet_tpu/serving``: clients submit prompts to a
bounded queue, a prefill lane admits them into free decode slots (KV in
a paged block pool, capacity bounded by tokens in flight), and a decode
lane advances every in-flight slot a token a step, so a late request
joins the running batch without restarting anyone.  The speed
multipliers ride on the paged path: greedy speculative decoding
(``ServerConfig(draft_net=, spec_k=)``, token-exact by construction) and
the radix prefix cache (``radix_cache=True``: requests that share a
block-aligned prompt prefix prefill only their novel suffix).
``ServerConfig(kv_mode="slots")`` keeps the slot ledger for A/B.

Quick start::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving import ServerConfig

    srv = serving.GenerativeServer(net, ServerConfig(
        num_slots=4, max_length=2048, block_size=16))
    with srv:
        futs = [srv.submit(p, max_new_tokens=32) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]

The server runs on the device of the net's weights (``mx.gpu(0)`` by
default); a net initialized with ``ctx=mx.cpu()`` serves on the CPU.
``GenerativeServer(mesh=, partition_rules=)`` serves dp replicas and
tensor-parallel replicas (``server.py``).  Observability: with
``telemetry.enable(trace=True, capacity=True)`` every request carries a
trace (``telemetry.tracing``) and the lanes keep capacity ledgers;
``ServerConfig(http_port=0, slo={...}, summary_every=N)`` starts the
``/metrics`` endpoint (``metrics.MetricsServer``), the goodput tracker
(``metrics.SLOTracker``) and the rolling ``serving.latency`` records.
"""
from .protocol import (Request, ServerClosedError,     # noqa: F401
                       ServerOverloadedError)
from .bucketing import BucketPolicy, pad_batch, pow2_bucket  # noqa: F401
from .kv_cache import (BlockAllocator, KVCacheManager,  # noqa: F401
                       PagedKVCacheManager)
from .radix import RadixPrefixCache                    # noqa: F401
from .scheduler import BatchScheduler, RequestQueue    # noqa: F401
from .generative import (GenerativeScheduler,          # noqa: F401
                         LlamaServingEngine)
from .lanes import (DecodeLane, PrefillLane, Replica,  # noqa: F401
                    ReplicaDispatcher)
from .server import (GenerativeServer, InferenceServer,  # noqa: F401
                     ServerConfig)
from .metrics import (MetricsServer, SLOTracker,       # noqa: F401
                      prometheus_text)

__all__ = ["Request", "ServerOverloadedError", "ServerClosedError",
           "BucketPolicy", "pow2_bucket", "pad_batch", "KVCacheManager",
           "PagedKVCacheManager", "BlockAllocator", "RadixPrefixCache",
           "RequestQueue", "BatchScheduler", "LlamaServingEngine",
           "GenerativeScheduler", "ServerConfig", "InferenceServer",
           "GenerativeServer", "PrefillLane", "DecodeLane", "Replica",
           "ReplicaDispatcher", "MetricsServer", "SLOTracker",
           "prometheus_text"]
