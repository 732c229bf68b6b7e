"""Prometheus text exposition of the telemetry snapshot.

Counterpart of ``mxnet_tpu/telemetry/promtext.py``: the renderer reads
only the telemetry module's host-side snapshots (counters, gauges,
``_Reservoir`` histograms), so the serving ``MetricsServer`` and the
training ``fleet.MetricsEndpoint`` share it, and the same recorded
state gives the same text in both packages.

* dotted telemetry names sanitize to ``mxt_*`` families
  (``serving.completed`` → ``mxt_serving_completed_total``);
* a name of the form ``base|key=value,...`` carries Prometheus labels
  (``serving.ttft_ms|replica=1`` renders as one labelled family);
* counters get ``_total``; histograms render as summaries
  (``quantile="0.5"/"0.9"/"0.99"`` over the rolling window plus
  ``_sum``/``_count`` over the all-time stream).
"""
from __future__ import annotations

import re
import sys

__all__ = ["prometheus_text"]


def _telemetry():
    # the parent package imports this module at its own import time;
    # resolve it lazily through sys.modules to keep the cycle harmless
    return sys.modules.get("mxnet_tpu_torch.telemetry")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: rolling-histogram percentiles exposed as summary quantiles
_QUANTILES = ((50, "0.5"), (90, "0.9"), (99, "0.99"))


def _prom_name(name, prefix="mxt_"):
    """Dotted telemetry name → Prometheus metric family name."""
    body = _NAME_RE.sub("_", name)
    if body and body[0].isdigit():
        body = "_" + body
    return prefix + body


def _split_labels(name):
    """``"serving.ttft_ms|replica=0,lane=decode"`` →
    ``("serving.ttft_ms", {"replica": "0", "lane": "decode"})``."""
    if "|" not in name:
        return name, {}
    base, _, rest = name.partition("|")
    labels = {}
    for part in rest.split(","):
        k, _, v = part.partition("=")
        if k:
            labels[k.strip()] = v.strip()
    return base, labels


def _fmt_labels(labels, extra=None):
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _fmt_value(v):
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(extra_gauges=None):
    """Render the telemetry module's current counters, gauges and
    histogram summaries (plus ``extra_gauges``, a dotted-name → value
    dict the caller wants on the same scrape) as Prometheus text."""
    tel = _telemetry()
    families = {}   # prom name -> {"type": ..., "samples": [(suffix, labels, value)]}

    def fam(name, mtype):
        f = families.get(name)
        if f is None:
            f = families[name] = {"type": mtype, "samples": []}
        return f

    for name, value in sorted(tel.counters().items()):
        base, labels = _split_labels(name)
        fam(_prom_name(base) + "_total", "counter")["samples"].append(
            ("", labels, value))
    gauges = dict(tel.gauges())
    if extra_gauges:
        gauges.update(extra_gauges)
    for name, value in sorted(gauges.items()):
        base, labels = _split_labels(name)
        fam(_prom_name(base), "gauge")["samples"].append(("", labels, value))
    for name, summ in sorted(tel.hists().items()):
        if summ is None:
            continue
        base, labels = _split_labels(name)
        f = fam(_prom_name(base), "summary")
        for p, q in _QUANTILES:
            val = summ.get(f"p{p}")
            if val is not None:
                f["samples"].append(("", dict(labels, quantile=q), val))
        f["samples"].append(("_sum", labels,
                             summ["mean"] * summ["count"]))
        f["samples"].append(("_count", labels, summ["count"]))
    lines = []
    for name in sorted(families):
        f = families[name]
        lines.append(f"# TYPE {name} {f['type']}")
        for suffix, labels, value in f["samples"]:
            lines.append(f"{name}{suffix}{_fmt_labels(labels)} "
                         f"{_fmt_value(value)}")
    return "\n".join(lines) + "\n"
