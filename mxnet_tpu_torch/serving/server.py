"""The user-facing serving surface: configs, the two servers,
lifecycle.

Counterpart of ``mxnet_tpu/serving/server.py``.
:class:`InferenceServer` serves stateless models (one forward a
request: a hybridized gluon block, such as ResNet-50 or BERT, or any
callable) by dynamic batching into power-of-two batch and length
buckets (``BatchScheduler``).  :class:`GenerativeServer` serves
``LlamaForCausalLM`` decode with continuous batching: requests join and
leave the in-flight decode batch between steps.  Its default mode keeps
K/V in a paged block pool with disaggregated prefill and decode lanes
(``lanes.py``), optionally with speculative decoding
(``ServerConfig(draft_net=, spec_k=)``) and the radix prefix cache
(``radix_cache=True``); ``kv_mode="slots"`` runs the slot ledger and
single-loop scheduler for A/B.  ``ServerConfig(int8=True)`` applies
weight quantization at load time: an ``InferenceServer``'s block goes
through ``contrib.quantization.quantize_net`` (calibrated on
``calib_data``), a ``GenerativeServer`` serves weight-only per-channel
int8.

Synchronous convenience: ``server.infer(...)`` and
``server.generate(...)`` submit and wait.

``GenerativeServer(mesh=, partition_rules=)``: a ``dp`` axis runs one
replica a dp slice behind the front queue (``_split_mesh``), each
placed tensor-parallel over its ``tp`` ranks by the rules (default
``SERVING_RULES``).  With tp = 1 the replicas run in this process, dp
slice i on card i; with tp > 1 each process holds one tp rank of one
replica (``python -m mxnet_tpu_torch.launch``): the replica's leader
rank takes that replica's requests and runs its lanes, and its peers
run what the leader sends (``generative.py``).  Across processes each
leader takes its own requests; a router in front spreads them.

Observability: ``ServerConfig(http_port=)`` starts the ``/metrics``,
``/healthz`` and ``/requests`` endpoint (``metrics.MetricsServer``;
``server.metrics_url``), ``slo=`` the per-tenant goodput tracker
(``stats()["slo"]``), ``summary_every`` the rolling ``serving.latency``
records; with ``telemetry.tracing`` on each request gets its trace at
submit, and an overload rejection trips the flight recorder.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError
from ..telemetry import capacity
from ..telemetry import tracing
from .bucketing import BucketPolicy
from .generative import _split_mesh  # noqa: F401  (the reference's home)
from .protocol import Request, ServerClosedError
from .scheduler import BatchScheduler, RequestQueue
from .protocol import ServerOverloadedError  # noqa: F401

__all__ = ["ServerConfig", "InferenceServer", "GenerativeServer"]


class ServerConfig:
    """Knobs of the server (defaults are test-scale).

    ``max_batch``/``max_length`` bound the bucket grid: the signature
    ceiling is ``len(batch_buckets) × len(length_buckets)``, and
    ``max_length`` is the engine's ``max_len``.  ``queue_capacity``
    bounds admission (beyond it, submit raises
    ``ServerOverloadedError``).  ``InferenceServer`` reads
    ``batch_window_ms`` (the dwell before a batch is taken),
    ``length_axis`` (the bucketed axis of each request's inputs) and
    ``output_length_axis`` (the per-example output axis trimmed back at
    demux, or None).  ``num_slots`` is the decode batch = max
    concurrent sequences; ``int8`` switches on load-time weight
    quantization, which an ``InferenceServer`` calibrates on
    ``calib_data`` (an iterable of input batches).  ``kv_mode``:
    ``"paged"`` (block pool + lanes, the default) or ``"slots"``;
    ``num_blocks=None`` sizes the pool at
    ledger parity (``num_slots × max_len`` tokens).  ``draft_net``
    switches speculation on (``spec_k`` proposals a slot a verify);
    ``radix_cache`` turns on prompt-prefix reuse within
    ``prefix_cache_tokens`` (None = half the pool).  On a card,
    ``capture_buckets=True`` captures the engines' prefill and scatter
    graphs of every bucket (with the radix cache, the prefix gather and
    the suffix prefill too), and verify, when the server is built
    (``LlamaServingEngine.capture_buckets``); otherwise each program is
    captured at its first call.

    Observability: ``summary_every`` completions between rolling
    ``serving.latency`` records; ``http_port`` (0 = ephemeral) starts the
    metrics endpoint on ``http_host``; ``slo`` maps tenant →
    ``{"ttft_ms": x, "tpot_ms": y}`` (a flat dict is the ``"default"``
    tenant) for goodput over the last ``slo_window`` requests."""

    def __init__(self, max_batch=8, max_length=128, min_batch=1,
                 min_length=8, queue_capacity=64, batch_window_ms=2.0,
                 summary_every=32, length_axis=0, output_length_axis=None,
                 num_slots=4, max_new_tokens=32, int8=False, calib_data=None,
                 kv_mode="paged", block_size=16, num_blocks=None,
                 http_port=None, http_host="127.0.0.1", slo=None,
                 slo_window=256, draft_net=None, spec_k=3,
                 radix_cache=False, prefix_cache_tokens=None,
                 capture_buckets=False):
        self.policy = BucketPolicy(max_batch=max_batch,
                                   max_length=max_length,
                                   min_batch=min_batch,
                                   min_length=min_length)
        self.queue_capacity = int(queue_capacity)
        self.batch_window_ms = float(batch_window_ms)
        self.summary_every = int(summary_every)
        self.length_axis = int(length_axis)
        self.output_length_axis = output_length_axis
        self.num_slots = int(num_slots)
        self.max_new_tokens = int(max_new_tokens)
        self.int8 = bool(int8)
        self.calib_data = calib_data
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
        self.capture_buckets = bool(capture_buckets)
        self.http_port = http_port
        self.http_host = http_host
        self.slo = slo
        self.slo_window = int(slo_window)


class _ServerBase:
    """start/stop/context-manager scaffolding: a bounded front queue and
    a scheduler (``_sched``) behind it; the metrics endpoint's lifecycle,
    the shared SLO tracker and trace creation at submit."""

    def __init__(self, config):
        self.config = config or ServerConfig()
        self.queue = RequestQueue(self.config.queue_capacity)
        self._running = False
        self._metrics = None
        self.slo = None
        if self.config.slo:
            from .metrics import SLOTracker

            self.slo = SLOTracker(self.config.slo,
                                  window=self.config.slo_window)

    def start(self):
        self._sched.start()
        self._running = True
        self._start_http()
        return self

    def stop(self, drain=True):
        """Graceful by default: queued work is served before exit."""
        if not self._running:
            return
        self._running = False
        self._stop_http()
        self._sched.stop(drain=drain)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- metrics endpoint -----------------------------------------------------
    def _start_http(self):
        if self.config.http_port is None or self._metrics is not None:
            return
        from .metrics import MetricsServer

        self._metrics = MetricsServer(
            self, host=self.config.http_host,
            port=self.config.http_port).start()

    def _stop_http(self):
        if self._metrics is not None:
            self._metrics.stop()
            self._metrics = None

    @property
    def metrics_url(self):
        """Base URL of the live endpoint (None when not started)."""
        return self._metrics.url if self._metrics is not None else None

    def metrics_gauges(self):
        """Live gauges the /metrics scrape adds on top of the telemetry
        snapshot (subclasses extend)."""
        return {"serving.queue_depth": len(self.queue),
                "serving.rejected_total": self.queue.rejected}

    # -- submission -----------------------------------------------------------
    def _submit(self, req):
        if not self._running:
            raise ServerClosedError("server is not running; call start()")
        if tracing.is_enabled() and req.trace is None:
            req.trace = tracing.start_trace(request_id=req.id,
                                            tenant=req.tenant)
        try:
            self.queue.put(req)
        except ServerOverloadedError as exc:
            # shed-load accounting: the rejected request still lands in
            # the JSONL stream (tagged) and trips the flight recorder
            telemetry.emit(req.record(lane="queue", status="rejected",
                                      error=repr(exc)))
            if req.trace is not None:
                tracing.finish(req.trace, status="rejected", lane="queue",
                               error=repr(exc), request_id=req.id)
                req.trace = None
            tracing.incident("overload_rejection", context={
                "queue_capacity": self.queue.capacity,
                "rejected": self.queue.rejected})
            raise
        return req.future


class InferenceServer(_ServerBase):
    """Dynamic-batching server for stateless models.

    ``model`` is a ``Predictor`` (its ``forward`` takes the batch by
    input name), a gluon block (called with one NDArray an input name,
    in ``input_names`` order, on the device of its parameters) or a
    callable taking a dict of stacked numpy arrays and returning its
    outputs.  ``input_names`` defaults to the Predictor's own, or
    ``["data"]``.  A block that is
    hybridized runs each (batch, length) bucket as its own CUDA graph,
    captured on the scheduler thread at the bucket's first batch; the
    signature count stays within ``len(config.policy.signatures())``.
    With ``config.int8`` the block is first quantized in place by
    ``quantize_net(calib_data=config.calib_data, calib_mode="naive")``,
    as in the reference."""

    def __init__(self, model, config=None, input_names=None):
        super().__init__(config)
        self._predictor = model if hasattr(model, "forward") and \
            hasattr(model, "input_names") else None
        if input_names is None and self._predictor is not None:
            input_names = self._predictor.input_names
        if self.config.int8 and self._predictor is None and \
                hasattr(model, "collect_params"):
            from ..contrib.quantization import quantize_net

            if self.config.calib_data is None:
                raise MXNetError("int8 block serving needs "
                                 "config.calib_data for calibration")
            model = quantize_net(model, calib_data=self.config.calib_data,
                                 calib_mode="naive")
        self.model = model
        self.input_names = list(input_names or ["data"])
        self._block = hasattr(model, "collect_params")
        self._sched = BatchScheduler(
            self._run_batch, self.config.policy, self.queue,
            length_axis=self.config.length_axis,
            output_length_axis=self.config.output_length_axis,
            batch_window_ms=self.config.batch_window_ms,
            summary_every=self.config.summary_every)

    def _run_batch(self, batch):
        """One padded bucket through the model (scheduler thread)."""
        from ..context import context_of
        from ..ndarray import NDArray

        if self._predictor is not None:
            return self._predictor.forward(**batch)
        if not self._block:
            return self.model(batch)
        param = next(iter(self.model.collect_params().values()))
        device = param.data()._data.device
        args = [NDArray(torch.from_numpy(batch[n]).to(device))
                for n in self.input_names]
        with context_of(device):
            out = self.model(*args)
        return out if isinstance(out, (list, tuple)) else [out]

    # -- client surface -------------------------------------------------------
    def submit(self, inputs, length=None, tenant=None):
        """Async: one example's inputs (an array, or a dict name → array)
        → a Future resolving to the demuxed output(s).  ``length`` is the
        true size of the bucketed axis (default: the first input's
        ``length_axis`` extent); a length above the policy's
        ``max_length`` raises ``MXNetError`` here, at admission."""
        if not isinstance(inputs, dict):
            inputs = {self.input_names[0]: inputs}
        inputs = {k: np.asarray(v) for k, v in inputs.items()}
        if length is None:
            length = inputs[self.input_names[0]] \
                .shape[self.config.length_axis]
        self.config.policy.length_bucket(int(length))
        req = Request(inputs=inputs, length=int(length), tenant=tenant)
        return self._submit(req)

    def infer(self, inputs, length=None, timeout=60.0):
        """Sync: submit and wait."""
        return self.submit(inputs, length=length).result(timeout)

    def health(self):
        """Scheduler-thread liveness and queue depth (host-side counters,
        never a device touch)."""
        alive = self._sched._thread is not None \
            and self._sched._thread.is_alive()
        if not self._running:
            status = "stopped"
        else:
            status = "ok" if alive else "degraded"
        return {"status": status, "running": self._running,
                "scheduler_alive": alive,
                "queue_depth": len(self.queue),
                "rejected": self.queue.rejected}

    def in_flight(self):
        """The queued requests: id, state, length, tenant and age."""
        with self.queue._cond:
            items = list(self.queue._items)
        now = time.perf_counter()
        return [{"request_id": r.id, "state": "queued",
                 "length": r.length, "tenant": r.tenant,
                 "trace_id": r.trace.trace_id
                 if r.trace is not None else None,
                 "age_ms": round((now - r.t_submit) * 1e3, 3)}
                for r in items]

    def stats(self):
        """Server counters and, for a hybridized block, its CachedOp's
        (the bucketing policy's check: ``signatures`` at most
        ``signature_ceiling``)."""
        out = {
            "completed": self._sched.completed,
            "failed": self._sched.failed,
            "batches": self._sched.batches,
            "rejected": self.queue.rejected,
            "pending": len(self.queue),
            "signature_ceiling": len(self.config.policy.signatures()),
        }
        if self._predictor is not None:
            out["cache"] = self._predictor.cache_stats()
        elif getattr(self.model, "_cached_op", None) is not None:
            out["cache"] = self.model._cached_op.cache_stats()
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out


class GenerativeServer(_ServerBase):
    """Continuous-batching decode server for ``LlamaForCausalLM``, on
    the device of the net's weights (``mx.gpu(0)`` unless the net was
    initialized elsewhere).

    ``config.kv_mode`` selects the paged block-pool storage with
    disaggregated prefill/decode lanes (default) or the slot ledger and
    single-loop scheduler (``"slots"``, the A/B baseline; one replica).
    ``mesh=`` (a dict such as ``{'dp': 2, 'tp': 1}``, or a
    ``parallel.make_mesh`` over ranks) and ``partition_rules=`` (default
    ``SERVING_RULES``): one replica a dp slice, each tensor-parallel over
    its tp ranks (the module docstring).  On a tensor-parallel peer rank
    the server runs its leader's programs between ``start`` and ``stop``
    and takes no requests (``serves_requests``).
    """

    def __init__(self, net, config=None, mesh=None, partition_rules=None):
        super().__init__(config)
        from .generative import GenerativeScheduler, LlamaServingEngine
        from .lanes import Replica, ReplicaDispatcher

        cfg = self.config
        self.mesh = mesh
        self._replicas = None
        self._dispatcher = None
        subs = _split_mesh(
            mesh, device=net.model.embed_tokens.weight.data()._data.device)
        if cfg.kv_mode == "slots":
            if len(subs) > 1:
                raise MXNetError(
                    "kv_mode='slots' runs the single-loop scheduler; "
                    "dp replicas need kv_mode='paged'")
            if cfg.draft_net is not None or cfg.radix_cache:
                raise MXNetError(
                    "speculative decoding and the radix prefix cache "
                    "require kv_mode='paged'")
            self.engine = LlamaServingEngine(
                net, max_len=cfg.policy.max_length,
                num_slots=cfg.num_slots, int8=cfg.int8, kv_mode="slots",
                mesh=subs[0], partition_rules=partition_rules)
            if cfg.capture_buckets:
                self.engine.capture_buckets(cfg.policy)
            self._sched = GenerativeScheduler(
                self.engine, self.queue, policy=cfg.policy,
                summary_every=cfg.summary_every, slo=self.slo)
            return
        self._replicas = [
            Replica(net, cfg.policy, index=i, mesh=sub,
                    partition_rules=partition_rules,
                    num_slots=cfg.num_slots, int8=cfg.int8,
                    block_size=cfg.block_size, num_blocks=cfg.num_blocks,
                    queue_capacity=cfg.queue_capacity,
                    draft_net=cfg.draft_net, spec_k=cfg.spec_k,
                    radix_cache=cfg.radix_cache,
                    prefix_cache_tokens=cfg.prefix_cache_tokens,
                    summary_every=cfg.summary_every, slo=self.slo)
            for i, sub in enumerate(subs) if sub is None or sub.local]
        if cfg.capture_buckets:
            for r in self._replicas:
                for eng in (r.engine, r.draft):
                    if eng is not None:
                        eng.capture_buckets(cfg.policy,
                                            prefix=r.radix is not None)
        self._dispatcher = ReplicaDispatcher(
            self.queue, [r for r in self._replicas if not r.follower])
        self.engine = self._replicas[0].engine
        self._sched = None

    @property
    def replicas(self):
        return self._replicas or []

    @property
    def serves_requests(self):
        """False on a tensor-parallel peer rank: its replica's leader
        takes the requests."""
        rm = self.engine.mesh
        return rm is None or rm.is_leader

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        if self._replicas is None:
            if not self.serves_requests:
                self.engine.follow_in_background()
                self._running = True
                return self
            return super().start()
        # fresh ledgers per server lifetime: replica indices restart at
        # 0, so a previous server's estimators must not leak in
        capacity.reset()
        for rep in self._replicas:
            rep.start()
        self._dispatcher.start()
        self._running = True
        if self.serves_requests:
            self._start_http()
        return self

    def stop(self, drain=True):
        if not self._running:
            return
        self._running = False
        self._stop_http()
        if self._replicas is None:
            if not self.serves_requests:
                self.engine.join_follower()
                return
            try:
                self._sched.stop(drain=drain)
            finally:
                self.engine.release()
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
        if not self.serves_requests:
            rm = self.engine.mesh
            raise MXNetError(
                f"this rank is tensor-parallel rank {rm.tp_rank} of a "
                f"replica whose leader, rank {rm.leader}, takes its "
                "requests")
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
        any_saturated = False
        for r in self._replicas:
            kv = r.mgr.stats()
            pa, da = r.prefill.alive(), r.decode.alive()
            all_alive = all_alive and pa and da
            row = {
                "replica": r.index,
                "prefill_alive": pa,
                "decode_alive": da,
                "queue_depth": len(r.queue),
                "in_flight": kv["occupancy"],
                "failed": r.failed,
                "kv_utilization": kv["utilization"],
                "kv_fragmentation": kv["fragmentation"],
                "kv_blocks_in_use": kv["blocks_in_use"]}
            cap = capacity.snapshot(r.index)
            if cap is not None:
                row["saturated"] = cap["saturated"]
                row["rho"] = cap["rho"]
                row["headroom_rps"] = cap["headroom_rps"]
                any_saturated = any_saturated or cap["saturated"]
            reps.append(row)
        if not self._running:
            status = "stopped"
        elif not all_alive:
            status = "degraded"
        elif any_saturated:
            # alive but past the ρ threshold: still HTTP 200 (a readiness
            # probe must not kill a replica for being busy)
            status = "saturated"
        else:
            status = "ok"
        return {"status": status, "running": self._running,
                "queue_depth": len(self.queue),
                "rejected": self.queue.rejected,
                "replicas": reps}

    def in_flight(self):
        """The /requests table: every request queued (front queue and
        replica queues) or decoding, with the ids the trace stream joins
        on."""
        now = time.perf_counter()

        def queued(queue, replica=None):
            with queue._cond:
                items = list(queue._items)
            return [{"request_id": r.id, "state": "queued",
                     "replica": replica, "length": r.length,
                     "tenant": r.tenant,
                     "trace_id": r.trace.trace_id
                     if r.trace is not None else None,
                     "age_ms": round((now - r.t_submit) * 1e3, 3)}
                    for r in items]

        rows = queued(self.queue)
        if self._replicas is None:
            for slot, (req, tokens) in list(self._sched._seqs.items()):
                rows.append({"request_id": req.id, "state": "decoding",
                             "replica": req.replica, "slot": slot,
                             "tenant": req.tenant,
                             "trace_id": req.trace.trace_id
                             if req.trace is not None else None,
                             "tokens_done": len(tokens),
                             "max_new_tokens": req.max_new_tokens})
            return rows
        for r in self._replicas:
            rows.extend(queued(r.queue, replica=r.index))
            rows.extend(r.decode.snapshot())
        return rows

    def metrics_gauges(self):
        """The base scrape gauges plus the live KV-pool state, per
        replica, and (with capacity accounting on) utilization, ρ and
        headroom per replica with their fleet roll-ups."""
        out = super().metrics_gauges()
        if self._replicas is None:
            kv = self._sched.mgr.stats()
            out["serving.kv_occupancy"] = kv["occupancy"]
            out["serving.kv_utilization"] = kv["utilization"]
            out["serving.kv_fragmentation"] = kv["fragmentation"]
            return out
        drafted = accepted = 0
        for r in self._replicas:
            kv = r.mgr.stats()
            tag = f"|replica={r.index}"
            out["serving.kv_occupancy" + tag] = kv["occupancy"]
            out["serving.kv_utilization" + tag] = kv["utilization"]
            out["serving.kv_fragmentation" + tag] = kv["fragmentation"]
            out["serving.kv_blocks_in_use" + tag] = kv["blocks_in_use"]
            out["serving.replica_queue_depth" + tag] = len(r.queue)
            if r.spec_k:
                drafted += r.draft_tokens
                accepted += r.accepted_tokens
                if r.draft_tokens:
                    out["serving.accept_rate" + tag] = round(
                        r.accepted_tokens / r.draft_tokens, 4)
            if r.radix is not None:
                rx = r.radix.stats()
                out["serving.radix_hits" + tag] = rx["hits"]
                out["serving.radix_hit_tokens" + tag] = rx["hit_tokens"]
                out["serving.radix_evictions" + tag] = rx["evictions"]
                out["serving.radix_cached_tokens" + tag] = \
                    rx["cached_tokens"]
            cap = capacity.snapshot(r.index)
            if cap is not None:
                out["serving.utilization" + tag] = cap["utilization"]
                out["serving.kv_free_frac" + tag] = cap["kv_free_frac"]
                if cap["rho"] is not None:
                    out["serving.rho" + tag] = cap["rho"]
                if cap["headroom_rps"] is not None:
                    out["serving.headroom_rps" + tag] = \
                        cap["headroom_rps"]
        if drafted:
            out["serving.accept_rate"] = round(accepted / drafted, 4)
        if capacity.is_enabled():
            # fleet roll-up: the worst ρ (the replica nearest the knee
            # governs admission) and the total spare request rate
            rhos = [v for k, v in out.items()
                    if k.startswith("serving.rho|")]
            heads = [v for k, v in out.items()
                     if k.startswith("serving.headroom_rps|")]
            utils = [v for k, v in out.items()
                     if k.startswith("serving.utilization|")]
            if rhos:
                out["serving.rho"] = max(rhos)
            if heads:
                out["serving.headroom_rps"] = round(sum(heads), 4)
            if utils:
                out["serving.utilization"] = max(utils)
        return out

    def stats(self):
        if self._replicas is None:
            out = {
                "completed": self._sched.completed,
                "failed": self._sched.failed,
                "decode_steps": self.engine.steps,
                "rejected": self.queue.rejected,
                "pending": len(self.queue),
                "kv_cache": self._sched.mgr.stats(),
                "compiled_signatures": self.engine.compiled_signatures(),
            }
            telemetry.gauge("serving.kv_occupancy",
                            out["kv_cache"]["occupancy"])
            if self.slo is not None:
                out["slo"] = self.slo.snapshot()
            return out
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
        telemetry.gauge("serving.kv_occupancy",
                        sum(r.mgr.stats()["occupancy"] for r in reps))
        telemetry.gauge("serving.kv_blocks_in_use",
                        sum(r.mgr.allocator.blocks_in_use for r in reps))
        if capacity.is_enabled():
            out["capacity"] = [capacity.snapshot(r.index) for r in reps]
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out
