"""The user-facing serving surface: configs, the generative server,
lifecycle.

Counterpart of ``mxnet_tpu/serving/server.py``.
:class:`GenerativeServer` serves ``LlamaForCausalLM`` decode with
continuous batching: requests join and leave the in-flight decode batch
between steps.  Its default mode keeps K/V in a paged block pool with
disaggregated prefill and decode lanes (``lanes.py``), optionally with
speculative decoding (``ServerConfig(draft_net=, spec_k=)``) and the
radix prefix cache (``radix_cache=True``); ``kv_mode="slots"`` runs the
slot ledger and single-loop scheduler for A/B.  ``ServerConfig(int8=True)``
serves weight-only per-channel int8.

Synchronous convenience: ``server.generate(...)`` submits and waits.

Not ported (ROADMAP.md, Queue 1, "Left out of slice 6"), each raising
``MXNetError``: ``InferenceServer`` (the stateless-model server),
``mesh=``/``partition_rules=`` and dp replicas, and
``ServerConfig(http_port=, slo=)`` (the metrics endpoint and SLO
accounting).
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .bucketing import BucketPolicy
from .protocol import Request, ServerClosedError
from .scheduler import RequestQueue

__all__ = ["ServerConfig", "InferenceServer", "GenerativeServer"]

_LATER = "is not ported yet (ROADMAP.md, Queue 1, \"Left out of slice 6\")"


class ServerConfig:
    """Knobs of the server (defaults are test-scale).

    ``max_batch``/``max_length`` bound the bucket grid: the signature
    ceiling is ``len(batch_buckets) × len(length_buckets)``, and
    ``max_length`` is the engine's ``max_len``.  ``queue_capacity``
    bounds admission (beyond it, submit raises
    ``ServerOverloadedError``).  ``num_slots`` is the decode batch = max
    concurrent sequences; ``int8`` switches on load-time weight
    quantization.  ``kv_mode``: ``"paged"`` (block pool + lanes, the
    default) or ``"slots"``; ``num_blocks=None`` sizes the pool at
    ledger parity (``num_slots × max_len`` tokens).  ``draft_net``
    switches speculation on (``spec_k`` proposals a slot a verify);
    ``radix_cache`` turns on prompt-prefix reuse within
    ``prefix_cache_tokens`` (None = half the pool).

    The reference's settings of its stateless-model server, telemetry
    and SLO surfaces (``batch_window_ms``, ``summary_every``,
    ``length_axis``, ``output_length_axis``, ``calib_data``,
    ``http_host``, ``slo_window``) are not taken: they come back with
    the features that read them (ROADMAP.md, "Left out of slice 6")."""

    def __init__(self, max_batch=8, max_length=128, min_batch=1,
                 min_length=8, queue_capacity=64, num_slots=4,
                 max_new_tokens=32, int8=False, kv_mode="paged",
                 block_size=16, num_blocks=None, http_port=None, slo=None,
                 draft_net=None, spec_k=3, radix_cache=False,
                 prefix_cache_tokens=None):
        if http_port is not None:
            raise MXNetError(f"ServerConfig(http_port=) (the metrics "
                             f"endpoint) {_LATER}")
        if slo:
            raise MXNetError(f"ServerConfig(slo=) (SLO accounting) "
                             f"{_LATER}")
        self.policy = BucketPolicy(max_batch=max_batch,
                                   max_length=max_length,
                                   min_batch=min_batch,
                                   min_length=min_length)
        self.queue_capacity = int(queue_capacity)
        self.num_slots = int(num_slots)
        self.max_new_tokens = int(max_new_tokens)
        self.int8 = bool(int8)
        if kv_mode not in ("paged", "slots"):
            raise MXNetError(f"unknown kv_mode {kv_mode!r}; "
                             "expected 'paged' or 'slots'")
        self.kv_mode = kv_mode
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.draft_net = draft_net
        self.spec_k = int(spec_k)
        self.radix_cache = bool(radix_cache)
        self.prefix_cache_tokens = prefix_cache_tokens \
            if prefix_cache_tokens is None else int(prefix_cache_tokens)


class _ServerBase:
    """start/stop/context-manager scaffolding: a bounded front queue and
    a scheduler (``_sched``) behind it."""

    def __init__(self, config):
        self.config = config or ServerConfig()
        self.queue = RequestQueue(self.config.queue_capacity)
        self._running = False

    def start(self):
        self._sched.start()
        self._running = True
        return self

    def stop(self, drain=True):
        """Graceful by default: queued work is served before exit."""
        if not self._running:
            return
        self._running = False
        self._sched.stop(drain=drain)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _submit(self, req):
        if not self._running:
            raise ServerClosedError("server is not running; call start()")
        self.queue.put(req)
        return req.future


class InferenceServer:
    """The reference's dynamic-batching server for stateless models: not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(f"serving.InferenceServer {_LATER}")


class GenerativeServer(_ServerBase):
    """Continuous-batching decode server for ``LlamaForCausalLM``, on
    the device of the net's weights (``mx.gpu(0)`` unless the net was
    initialized elsewhere).

    ``config.kv_mode`` selects the paged block-pool storage with
    disaggregated prefill/decode lanes (default) or the slot ledger and
    single-loop scheduler (``"slots"``, the A/B baseline).
    """

    def __init__(self, net, config=None, mesh=None, partition_rules=None):
        super().__init__(config)
        from .generative import GenerativeScheduler, LlamaServingEngine
        from .lanes import Replica, ReplicaDispatcher

        if mesh is not None or partition_rules is not None:
            raise MXNetError(f"GenerativeServer(mesh=, partition_rules=) "
                             f"(tensor-parallel and dp replicas) {_LATER}")
        cfg = self.config
        self._replicas = None
        self._dispatcher = None
        if cfg.kv_mode == "slots":
            if cfg.draft_net is not None or cfg.radix_cache:
                raise MXNetError(
                    "speculative decoding and the radix prefix cache "
                    "require kv_mode='paged'")
            self.engine = LlamaServingEngine(
                net, max_len=cfg.policy.max_length,
                num_slots=cfg.num_slots, int8=cfg.int8, kv_mode="slots")
            self._sched = GenerativeScheduler(self.engine, self.queue,
                                              policy=cfg.policy)
            return
        self._replicas = [
            Replica(net, cfg.policy, index=0, num_slots=cfg.num_slots,
                    int8=cfg.int8, block_size=cfg.block_size,
                    num_blocks=cfg.num_blocks,
                    queue_capacity=cfg.queue_capacity,
                    draft_net=cfg.draft_net, spec_k=cfg.spec_k,
                    radix_cache=cfg.radix_cache,
                    prefix_cache_tokens=cfg.prefix_cache_tokens)]
        self._dispatcher = ReplicaDispatcher(self.queue, self._replicas)
        self.engine = self._replicas[0].engine
        self._sched = None

    @property
    def replicas(self):
        return self._replicas or []

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        if self._replicas is None:
            return super().start()
        for rep in self._replicas:
            rep.start()
        self._dispatcher.start()
        self._running = True
        return self

    def stop(self, drain=True):
        if not self._running:
            return
        self._running = False
        if self._replicas is None:
            self._sched.stop(drain=drain)
            return
        # flush the front queue into the replicas first, then drain each
        # replica (prefill lane before decode lane)
        try:
            self._dispatcher.stop(drain=drain)
        finally:
            for rep in self._replicas:
                rep.stop(drain=drain)

    # -- client surface -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, tenant=None):
        """Async: 1-D prompt token ids → Future resolving to the full
        sequence (prompt + generated, int32 numpy), greedy decode."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = int(max_new_tokens or self.config.max_new_tokens)
        if n < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if len(prompt) + n > self.engine.max_len:
            raise MXNetError(
                f"prompt {len(prompt)} + {n} new tokens exceeds the "
                f"engine's max_len {self.engine.max_len}")
        req = Request(prompt_ids=prompt, max_new_tokens=n, tenant=tenant)
        req.length = len(prompt)
        return self._submit(req)

    def generate(self, prompt_ids, max_new_tokens=None, timeout=120.0):
        """Sync: submit + wait for the full sequence."""
        return self.submit(prompt_ids, max_new_tokens).result(timeout)

    # -- observability surface ------------------------------------------------
    def request_records(self):
        """The per-request records of finished (and failed) requests,
        oldest first."""
        if self._replicas is None:
            return list(self._sched.records)
        recs = []
        for r in self._replicas:
            with r._rec_lock:
                recs.extend(r.records)
        return sorted(recs, key=lambda rec: rec["request_id"])

    def health(self):
        """Lane liveness, queue depths and KV occupancy — every number a
        host-side counter read, never a device touch.  ``status`` is
        ``"ok"`` only when every lane thread is alive."""
        if self._replicas is None:
            alive = self._sched._thread is not None \
                and self._sched._thread.is_alive()
            kv = self._sched.mgr.stats()
            if not self._running:
                status = "stopped"
            else:
                status = "ok" if alive else "degraded"
            return {"status": status, "running": self._running,
                    "scheduler_alive": alive,
                    "queue_depth": len(self.queue),
                    "rejected": self.queue.rejected,
                    "kv_occupancy": kv["occupancy"],
                    "kv_utilization": kv["utilization"],
                    "kv_fragmentation": kv["fragmentation"]}
        reps = []
        all_alive = self._dispatcher.alive()
        for r in self._replicas:
            kv = r.mgr.stats()
            pa, da = r.prefill.alive(), r.decode.alive()
            all_alive = all_alive and pa and da
            reps.append({
                "replica": r.index,
                "prefill_alive": pa,
                "decode_alive": da,
                "queue_depth": len(r.queue),
                "in_flight": kv["occupancy"],
                "failed": r.failed,
                "kv_utilization": kv["utilization"],
                "kv_fragmentation": kv["fragmentation"],
                "kv_blocks_in_use": kv["blocks_in_use"]})
        if not self._running:
            status = "stopped"
        else:
            status = "ok" if all_alive else "degraded"
        return {"status": status, "running": self._running,
                "queue_depth": len(self.queue),
                "rejected": self.queue.rejected,
                "replicas": reps}

    def stats(self):
        if self._replicas is None:
            return {
                "completed": self._sched.completed,
                "failed": self._sched.failed,
                "decode_steps": self.engine.steps,
                "rejected": self.queue.rejected,
                "pending": len(self.queue),
                "kv_cache": self._sched.mgr.stats(),
                "compiled_signatures": self.engine.compiled_signatures(),
            }
        reps = self._replicas
        out = {
            "completed": sum(r.completed for r in reps),
            "failed": sum(r.failed for r in reps),
            "decode_steps": sum(r.engine.steps for r in reps),
            "rejected": self.queue.rejected,
            "pending": len(self.queue) + sum(len(r.queue) for r in reps),
            "kv_cache": reps[0].mgr.stats(),
            "compiled_signatures": reps[0].engine.compiled_signatures(),
            "num_replicas": len(reps),
        }
        if any(r.spec_k for r in reps):
            drafted = sum(r.draft_tokens for r in reps)
            accepted = sum(r.accepted_tokens for r in reps)
            out["speculative"] = {
                "k": max(r.spec_k for r in reps),
                "draft_tokens": drafted,
                "accepted_tokens": accepted,
                "accept_rate": round(accepted / drafted, 4)
                if drafted else None,
            }
        if any(r.radix is not None for r in reps):
            rx = [r.radix.stats() for r in reps if r.radix is not None]
            out["radix_cache"] = {
                k: sum(s[k] for s in rx)
                for k in ("hits", "misses", "hit_tokens", "evictions",
                          "inserted_blocks", "cached_tokens")}
        return out
