"""Memory as a managed budget: planner + auto-remat + host offload.

Counterpart of ``mxnet_tpu/memory/``.  The memwatch ledger and the cost
registry (``telemetry``) make memory observable; this package makes it
actionable:

- :mod:`.planner` — pre-dispatch per-device peak prediction and
  fit/no-fit verdicts against the device budget (the card's memory);
- :mod:`.policy` — the remat tier ladder (none → dots → layer), the auto
  policy that picks the cheapest tier that fits, and
  :func:`checkpoint_wrap`, the package's one ``torch.utils.checkpoint``
  site;
- :mod:`.offload` — host-resident optimizer state behind
  ``Trainer(offload="host")``, in pinned host memory with copies on a
  side stream;
- :mod:`.lowering` — the parts of the reference's offline lowering
  engine that carry over (the fit verdicts of its artifacts).

``telemetry.step_end`` and ``memwatch.write_postmortem`` probe this
module via ``sys.modules`` — importing it is what turns on the JSONL
fields and the OOM prescription; nothing here runs on the step hot
path otherwise.
"""
from . import lowering, offload, planner, policy
from .planner import (Plan, budget_bytes, last_plan, plan_from_artifact,
                      plan_kv_pool, plan_model, prescribe, set_budget)
from .policy import TIERS, auto_tier, checkpoint_wrap, select_tier

__all__ = [
    "Plan", "TIERS", "auto_tier", "budget_bytes", "checkpoint_wrap",
    "last_plan", "lowering", "offload", "plan_from_artifact",
    "plan_kv_pool", "plan_model", "planner", "policy", "prescribe",
    "select_tier",
    "set_budget", "telemetry_fields",
]


def telemetry_fields():
    """The per-step JSONL fields this package contributes (probed by
    ``telemetry.step_end``; keys appear only once the corresponding
    mechanism has actually been used)."""
    out = {}
    pol = policy.last_policy()
    if pol is not None:
        out["remat_policy"] = pol["tier"]
    plan = planner.last_plan()
    if plan is not None:
        out["predicted_peak_bytes"] = plan.predicted_peak_bytes
    off = offload.resident_bytes()
    if off:
        out["offload_bytes"] = off
    return out
