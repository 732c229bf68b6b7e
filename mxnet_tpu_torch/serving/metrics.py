"""Live metrics endpoint and SLO goodput accounting for the servers.

Counterpart of ``mxnet_tpu/serving/metrics.py``.  All host-side: the
HTTP thread renders telemetry snapshots and ledger stats that the
serving threads already keep and never touches a tensor.

* :func:`prometheus_text` — the telemetry snapshot as Prometheus text
  (``telemetry.promtext``, re-exported).
* :class:`MetricsServer` — a stdlib ``http.server`` daemon thread bound
  to an owner server, exposing ``/metrics`` (the text above plus the
  owner's live gauges), ``/healthz`` (lane liveness, queue depths, KV
  occupancy; HTTP 503 when degraded, 200 for ``ok`` and ``saturated``)
  and ``/requests`` (the in-flight table).  Enabled per server by
  ``ServerConfig(http_port=...)`` (0 = an ephemeral port, see
  ``server.metrics_url``); ``stop()`` joins its thread.
* :class:`SLOTracker` — per-tenant TTFT/TPOT targets with **goodput**
  (the fraction of requests meeting their SLO) over a rolling window and
  the all-time stream; results land in ``server.stats()["slo"]`` and as
  ``mxt_serving_goodput{tenant=...}`` gauges on ``/metrics``.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..telemetry.promtext import prometheus_text

__all__ = ["prometheus_text", "MetricsServer", "SLOTracker"]


# -- SLO goodput -------------------------------------------------------------

class SLOTracker:
    """Per-tenant TTFT/TPOT targets and rolling goodput.

    ``targets`` maps tenant name → ``{"ttft_ms": x, "tpot_ms": y}``
    (either key optional); the ``"default"`` entry covers tenants
    without their own row.  A flat ``{"ttft_ms": ..}`` dict is accepted
    as shorthand for ``{"default": ...}``.  ``observe`` is called once
    per completed request and judges only the metrics the target
    actually names (a 1-token request has no TPOT; it is not penalized
    for it)."""

    def __init__(self, targets, window=256):
        targets = dict(targets or {})
        if targets and not any(isinstance(v, dict)
                               for v in targets.values()):
            targets = {"default": targets}
        self.targets = targets
        self.window = int(window)
        self._lock = threading.Lock()
        self._tenants = {}  # tenant -> {"window": deque, "met": n, "total": n}

    def target_for(self, tenant=None):
        """The SLO row applying to ``tenant`` (None when neither the
        tenant nor ``"default"`` is configured)."""
        return self.targets.get(tenant or "default",
                                self.targets.get("default"))

    def observe(self, tenant=None, ttft_ms=None, tpot_ms=None):
        """Judge one completed request against its tenant's targets.
        Returns True/False (met / missed), or None when no target
        applies (nothing is recorded)."""
        target = self.target_for(tenant)
        if target is None:
            return None
        met, judged = True, False
        t = target.get("ttft_ms")
        if t is not None and ttft_ms is not None:
            judged = True
            met = met and ttft_ms <= t
        t = target.get("tpot_ms")
        if t is not None and tpot_ms is not None:
            judged = True
            met = met and tpot_ms <= t
        if not judged:
            return None
        key = tenant or "default"
        with self._lock:
            row = self._tenants.get(key)
            if row is None:
                row = self._tenants[key] = {
                    "window": deque(maxlen=self.window),
                    "met": 0, "total": 0}
            row["window"].append(1 if met else 0)
            row["total"] += 1
            row["met"] += 1 if met else 0
        return met

    def goodput(self, tenant=None):
        """Rolling-window goodput fraction for ``tenant`` (None before
        any observation)."""
        with self._lock:
            row = self._tenants.get(tenant or "default")
            if row is None or not row["window"]:
                return None
            return sum(row["window"]) / len(row["window"])

    def snapshot(self):
        """``stats()``-shaped summary: targets + per-tenant goodput
        over the rolling window and the all-time stream."""
        with self._lock:
            tenants = {
                t: {
                    "total": row["total"],
                    "met": row["met"],
                    "goodput": row["met"] / row["total"]
                    if row["total"] else None,
                    "window": len(row["window"]),
                    "window_goodput": sum(row["window"]) / len(row["window"])
                    if row["window"] else None,
                }
                for t, row in self._tenants.items()}
        return {"targets": self.targets, "window": self.window,
                "tenants": tenants}


# -- the HTTP endpoint thread ------------------------------------------------

def _make_handler(ms):
    class _Handler(BaseHTTPRequestHandler):
        server_version = "mxt-serving"

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    code = 200
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                    body = ms.render_metrics().encode("utf-8")
                elif path == "/healthz":
                    health = ms.owner.health()
                    # "saturated" is degraded-but-alive: lanes are all
                    # serving, capacity ρ is just past threshold — a
                    # 503 here would make the orchestrator restart a
                    # busy replica and shed the very capacity it needs
                    code = (200 if health.get("status")
                            in ("ok", "saturated") else 503)
                    ctype = "application/json"
                    body = json.dumps(health, indent=2,
                                      default=str).encode("utf-8")
                elif path == "/requests":
                    code = 200
                    ctype = "application/json"
                    body = json.dumps(ms.owner.in_flight(), indent=2,
                                      default=str).encode("utf-8")
                else:
                    code, ctype = 404, "text/plain"
                    body = b"not found; endpoints: /metrics /healthz " \
                           b"/requests"
            except Exception as exc:  # scrape errors never kill serving
                code, ctype, body = 500, "text/plain", repr(exc).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # scrapes stay off stderr
            pass

    return _Handler


class MetricsServer:
    """The per-server scrape endpoint: one ``ThreadingHTTPServer`` on a
    daemon thread.  ``owner`` is the serving server — it must provide
    ``health()`` and ``in_flight()`` (both host-side snapshots) and may
    provide ``metrics_gauges()`` for extra live gauges on ``/metrics``
    and ``slo`` (an :class:`SLOTracker`) for goodput gauges."""

    def __init__(self, owner, host="127.0.0.1", port=0):
        self.owner = owner
        self.host = host
        self._requested_port = int(port)
        self._httpd = None
        self._thread = None

    @property
    def port(self):
        """The bound port (resolves ``port=0`` to the ephemeral one)."""
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self):
        return f"http://{self.host}:{self.port}" if self._httpd else None

    def render_metrics(self):
        extra = {}
        gauges_fn = getattr(self.owner, "metrics_gauges", None)
        if gauges_fn is not None:
            extra.update(gauges_fn())
        slo = getattr(self.owner, "slo", None)
        if slo is not None:
            for tenant, row in slo.snapshot()["tenants"].items():
                if row["window_goodput"] is not None:
                    extra[f"serving.goodput|tenant={tenant}"] = \
                        row["window_goodput"]
        return prometheus_text(extra_gauges=extra)

    def start(self):
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), _make_handler(self))
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="mxt-metrics", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
        self._httpd = self._thread = None
