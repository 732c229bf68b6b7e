"""Pre-dispatch device-memory planner: predict the per-device peak
BEFORE a step runs.

Counterpart of ``mxnet_tpu/memory/planner.py``, with the same arithmetic.
The planner answers "will this (model, batch, mesh, remat tier, offload
config) fit the device budget?" from three sources, cheapest first:

1. **analytic** — exact per-device byte math over the declared
   parameter shapes, sharded by the SAME partition-rule engine the real
   placement path uses (``parallel.partition``), plus optimizer-state /
   master-copy multipliers and a coarse tier-scaled activation model.
   Microseconds; nothing runs on the device.
2. **registry** (warm signature) — when ``telemetry.costs`` holds an
   entry for this mesh (and remat tier) that carries a measured
   ``temp_bytes`` figure, it replaces the analytic activation term.
3. **artifact** (cold, offline) — a committed ``*_LOWER_*.json``
   lowering artifact of the JAX package, read back through
   :func:`plan_from_artifact`: its per-device memory analysis is the
   load-bearing number, judged against the budget it was compiled under.

The budget is the card's: ``torch.cuda.get_device_properties(i)
.total_memory`` of a CUDA device, unless ``set_budget`` or the
``MXNET_HBM_BUDGET`` environment variable overrides it; without a card
(CPU runs) it is 16 GiB, so CPU plans equal the reference's.

The verdict is a :class:`Plan`: fit / no-fit against the device budget
with headroom and the top offending buffers named.  ``annotate_oom``
(``telemetry.memwatch``) turns the last plan into a prescription via
:func:`prescribe`.
"""
import math
import os

import numpy as np

from .._left_out import refuse
from .lowering import TPU_BUDGET_GIB

# the reference's table of TPU budgets by device kind: the port reads the
# card's memory instead (``budget_bytes``)
__getattr__ = refuse({"DEVICE_BUDGET_GIB": "Not carried over"}, __name__)

#: budget without a card (CPU runs), so CPU plans stay comparable to the
#: reference's
_DEFAULT_BUDGET_GIB = 16.0

_budget_override = None
_last_plan = None
_last_prescription = None


def set_budget(nbytes):
    """Override the device budget (tests shrink it to force the auto
    policy up the tier ladder).  ``None`` restores device detection."""
    global _budget_override
    _budget_override = None if nbytes is None else int(nbytes)


def budget_bytes(device=None):
    """Per-device budget in bytes: explicit override >
    ``MXNET_HBM_BUDGET`` env > the card's total memory
    (``torch.cuda.get_device_properties``; ``device`` a CUDA device or
    its index, default the current one) > 16 GiB without a card."""
    if _budget_override is not None:
        return _budget_override
    env = os.environ.get("MXNET_HBM_BUDGET")
    if env:
        return int(float(env))
    import torch

    if device is not None and not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return int(_DEFAULT_BUDGET_GIB * 2 ** 30)
        device = device.index
    if torch.cuda.is_available():
        if device is None:
            device = torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(_DEFAULT_BUDGET_GIB * 2 ** 30)


class Plan:
    """A pre-dispatch fit verdict for one configuration."""

    __slots__ = ("predicted_peak_bytes", "budget_bytes", "fits",
                 "headroom_bytes", "breakdown", "top_buffers", "source",
                 "remat", "offload", "ctx")

    def __init__(self, predicted_peak_bytes, budget, breakdown,
                 top_buffers, source, remat, offload, ctx=None):
        self.predicted_peak_bytes = int(predicted_peak_bytes)
        self.budget_bytes = int(budget)
        self.fits = self.predicted_peak_bytes <= self.budget_bytes
        self.headroom_bytes = self.budget_bytes - self.predicted_peak_bytes
        self.breakdown = dict(breakdown)
        self.top_buffers = list(top_buffers)
        self.source = source
        self.remat = remat
        self.offload = offload
        self.ctx = ctx or {}

    def as_dict(self):
        return {
            "predicted_peak_bytes": self.predicted_peak_bytes,
            "predicted_peak_gib": round(
                self.predicted_peak_bytes / 2 ** 30, 3),
            "budget_bytes": self.budget_bytes,
            "fits": self.fits,
            "headroom_bytes": self.headroom_bytes,
            "breakdown": self.breakdown,
            "top_buffers": self.top_buffers,
            "source": self.source,
            "remat": self.remat,
            "offload": self.offload,
        }

    def __repr__(self):
        gib = self.predicted_peak_bytes / 2 ** 30
        verdict = "fits" if self.fits else "NO FIT"
        return (f"Plan({verdict}: predicted {gib:.2f} GiB vs "
                f"{self.budget_bytes / 2 ** 30:.2f} GiB budget, "
                f"remat={self.remat!r}, offload={self.offload!r}, "
                f"source={self.source})")


def last_plan():
    return _last_plan


def last_prescription():
    return _last_prescription


class _Dtype:
    """A dtype's ``name`` and ``itemsize``, for a torch dtype numpy does
    not know (bfloat16)."""

    __slots__ = ("name", "itemsize")

    def __init__(self, name, itemsize):
        self.name, self.itemsize = name, itemsize


def _as_dtype(dtype):
    """numpy's dtype of ``dtype`` (default float32), or the name and
    item size of a torch dtype (or its name) that numpy lacks."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, _Dtype):
        return dtype
    import torch

    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    try:
        return np.dtype(dtype)
    except TypeError:
        tdt = getattr(torch, str(dtype), None)
        if not isinstance(tdt, torch.dtype):
            raise
        return _Dtype(str(dtype), tdt.itemsize)


def _normalize_params(params):
    """{name: (shape, dtype)} from a Block, a Parameter mapping, or a
    mapping of (shape, dtype) pairs."""
    if hasattr(params, "_collect_params_with_prefix"):
        params = params._collect_params_with_prefix()
    out = {}
    for name, p in dict(params).items():
        if isinstance(p, tuple) and len(p) == 2 and not hasattr(p, "shape"):
            shape, dtype = p
        else:
            shape, dtype = p.shape, getattr(p, "dtype", None)
        shape = tuple(int(s) for s in (shape or ()))
        assert shape and all(s > 0 for s in shape), \
            f"{name} shape not fully declared: {shape}"
        out[name] = (shape, _as_dtype(dtype))
    return out


_STATE_SLOTS = {"sgd": 1, "nag": 1, "sgld": 0, "adam": 2, "adamw": 2,
    "lamb": 2, "rmsprop": 1, "adagrad": 1, None: 0, "none": 0}


class _OptimizerDesc(tuple):
    """``_optimizer_desc``'s (name, n_state_slots, multi_precision) of an
    Optimizer instance, which a plan keeps in place of the instance: an
    optimizer holds its parameters (``param_dict``), and the last plan
    must not keep a model's weights alive on the card."""


def _optimizer_desc(optimizer):
    """(name, n_state_slots, multi_precision) for a name, an Optimizer
    instance (or its ``_OptimizerDesc``), or None (inference)."""
    if optimizer is None:
        return None, 0, False
    if isinstance(optimizer, _OptimizerDesc):
        return tuple(optimizer)
    if isinstance(optimizer, str):
        name = optimizer.lower()
        return name, _STATE_SLOTS.get(name, 1), False
    name = type(optimizer).__name__.lower()
    n = _STATE_SLOTS.get(name, 1)
    if name in ("sgd", "nag") and not getattr(optimizer, "momentum", 0.0):
        n = 0
    return name, n, bool(getattr(optimizer, "multi_precision", False))


def _mesh_axis_sizes(mesh):
    if mesh is None:
        return {}
    from ..parallel import mesh_axes

    return {str(k): int(v) for k, v in mesh_axes(mesh).items()}


def _shard_div(spec, axes):
    div = 1
    for entry in spec or ():
        if entry:
            for ax in (entry if isinstance(entry, (tuple, list))
                       else (entry,)):
                div *= axes.get(str(ax), 1)
    return div


#: coarse activation prior: live activation bytes per byte of
#: per-device batch input, by remat tier — a transformer-shaped default
#: used only when neither a measured ``activation_hint`` nor a warm
#: registry temp figure is available.
_ACT_MULT = {"none": 12.0, "dots": 4.0, "layer": 2.0}
#: how the tier ladder scales a measured tier-"none" activation figure
_ACT_SCALE = {"none": 1.0, "dots": 0.35, "layer": 0.15}


def _registry_workspace(axes, remat):
    """Measured temp bytes of a warm signature on this mesh (and, when
    the entry carries a remat stamp, this remat tier).  The port's cost
    registry measures no workspace (its ``temp_bytes`` stay 0), so this
    finds nothing unless a caller registered such a figure."""
    try:
        from ..telemetry import costs

        if not costs._enabled:
            return None
        best = None
        for art in costs.snapshot():
            if art.get("error"):
                continue
            mesh_shape = art.get("mesh_shape")
            if axes and mesh_shape and dict(mesh_shape) != axes:
                continue
            stamp = art.get("remat")
            if stamp is not None and stamp != remat:
                continue
            t = int(art.get("temp_bytes") or 0)
            if t and (best is None or t > best):
                best = t
        return best
    except Exception:
        return None


def plan_kv_pool(num_layers, num_kv_heads, head_dim, num_blocks,
                 block_size, dtype=np.float32, mesh=None, rules=None):
    """Per-device bytes of the serving engine's paged KV block pool:
    2 (K and V) × layers × ``num_blocks × num_kv_heads × block_size ×
    head_dim`` × itemsize, sharded the way the serving rule table
    places the pool (``layers.{i}.kv_pool`` — KV-head axis over ``tp``
    by default).  This is the serving analog of the allreduce-bytes
    planning the trainer gets: size the pool BEFORE building the
    engine, and feed the figure to :func:`plan_model` via
    ``kv_pool_bytes=`` to get a fit verdict that includes serving
    state.  Matches ``LlamaServingEngine.kv_pool_bytes()`` exactly."""
    dtype = _as_dtype(dtype)
    shape = (int(num_blocks), int(num_kv_heads), int(block_size),
             int(head_dim))
    div = 1
    if mesh is not None:
        from ..parallel import partition as pt

        axes = _mesh_axis_sizes(mesh)
        specs = pt.as_rules(rules if rules is not None
                            else "llama_serving").specs(
            {"layers.0.kv_pool": shape}, mesh)
        div = _shard_div(specs.get("layers.0.kv_pool"), axes)
    n_elem = int(np.prod(shape))
    return 2 * int(num_layers) * _ceil_div(n_elem * dtype.itemsize, div)


def plan_model(params, mesh=None, rules=None, optimizer=None,
               batch_bytes=0, remat="none", offload=None,
               activation_hint=None, budget=None, device_kind=None,
               training=True, use_registry=True, record=True,
               kv_pool_bytes=0):
    """Analytic per-device peak for a model configuration.

    ``params``: a Block / Parameter mapping / ``{name: (shape, dtype)}``.
    ``batch_bytes``: GLOBAL per-step input bytes (divided over the dp
    axis).  ``activation_hint``: measured live-activation bytes at tier
    "none" (scaled down the ladder); otherwise a warm costs-registry
    temp figure or a coarse batch-proportional prior is used.
    ``offload="host"`` moves optimizer state + f32 masters off-device.
    ``kv_pool_bytes``: per-device serving KV pool (from
    :func:`plan_kv_pool`) held live for the server's lifetime.
    ``device_kind``: the CUDA device (or its index) whose budget to use
    when ``budget`` is not given (default the current one).
    """
    from .policy import normalize

    remat = normalize(remat)
    if remat == "auto":
        raise ValueError("plan_model plans ONE tier; use policy.auto_tier")
    if offload not in (None, "host"):
        raise ValueError(f"unknown offload {offload!r}")
    shapes = _normalize_params(params)
    axes = _mesh_axis_sizes(mesh)
    opt_name, n_state, multi_precision = _optimizer_desc(optimizer)

    specs = {}
    if rules is not None and mesh is not None:
        from ..parallel import partition as pt

        specs = pt.as_rules(rules).specs(
            {n: s for n, (s, _) in shapes.items()}, mesh)

    per_param = {}
    params_b = grads_b = state_b = masters_b = 0
    for name, (shape, dtype) in shapes.items():
        n_elem = int(np.prod(shape))
        div = _shard_div(specs.get(name), axes)
        p_b = _ceil_div(n_elem * dtype.itemsize, div)
        contrib = {"params": p_b}
        params_b += p_b
        if training:
            grads_b += p_b
            contrib["grads"] = p_b
            low_p = dtype.name in ("float16", "bfloat16")
            state_dt = 4 if low_p else dtype.itemsize
            s_b = n_state * _ceil_div(n_elem * state_dt, div)
            m_b = (_ceil_div(n_elem * 4, div)
                   if (low_p and multi_precision) else 0)
            state_b += s_b
            masters_b += m_b
            if s_b:
                contrib["optimizer_state"] = s_b
            if m_b:
                contrib["masters"] = m_b
        per_param[name] = contrib

    dp = axes.get("dp", 1)
    batch_b = _ceil_div(int(batch_bytes), dp)

    source = "analytic"
    if activation_hint is not None:
        act_b = int(activation_hint * _ACT_SCALE[remat])
        source = "analytic+hint"
    else:
        reg = _registry_workspace(axes, remat) if use_registry else None
        if reg is not None:
            act_b = reg
            source = "registry"
        else:
            act_b = int(batch_b * _ACT_MULT[remat]) if training else \
                int(batch_b * _ACT_MULT["none"] / 2)

    offload_b = 0
    if offload == "host":
        offload_b = state_b + masters_b
        state_b = masters_b = 0

    kv_b = int(kv_pool_bytes)
    breakdown = {
        "params": params_b, "grads": grads_b,
        "optimizer_state": state_b, "masters": masters_b,
        "batch": batch_b, "activations": act_b,
        "host_offloaded": offload_b,
    }
    if kv_b:
        breakdown["kv_pool"] = kv_b
    peak = params_b + grads_b + state_b + masters_b + batch_b + act_b \
        + kv_b

    top = sorted(
        ([{"name": n, "bytes": sum(c.values()), "components": c}
          for n, c in per_param.items()]
         + ([{"name": "<batch>", "bytes": batch_b,
              "components": {"batch": batch_b}}] if batch_b else [])
         + ([{"name": "<activations>", "bytes": act_b,
              "components": {"activations": act_b}}] if act_b else [])
         + ([{"name": "<kv_pool>", "bytes": kv_b,
              "components": {"kv_pool": kv_b}}] if kv_b else [])),
        key=lambda d: -d["bytes"])[:8]

    plan = Plan(
        peak, budget if budget is not None else budget_bytes(device_kind),
        breakdown, top, source, remat, offload,
        ctx={"shapes": shapes, "mesh": mesh, "rules": rules,
             "optimizer": optimizer if optimizer is None or
             isinstance(optimizer, str) else
             _OptimizerDesc((opt_name, n_state, multi_precision)),
             "batch_bytes": int(batch_bytes),
             "activation_hint": activation_hint, "budget": budget,
             "training": training, "device_kind": device_kind,
             "kv_pool_bytes": kv_b,
             "optimizer_desc": (opt_name, n_state, multi_precision)})
    if record:
        global _last_plan
        _last_plan = plan
    return plan


def _ceil_div(a, b):
    return int(math.ceil(a / b)) if b > 1 else int(a)


def plan_from_artifact(artifact, budget=None, record=True):
    """A :class:`Plan` from a committed lowering artifact of the JAX
    package (a ``tools/scale_proof.py`` JSON path or dict) — the offline
    cold path.  The artifact's per-device memory analysis is the
    load-bearing number: predicted peak = args + temp (the upper bound
    every ``fit_verdict`` records), against the budget the artifact was
    compiled under when its backend is the TPU
    (``lowering.TPU_BUDGET_GIB``), else this device's."""
    import json

    name = None
    if isinstance(artifact, (str, os.PathLike)):
        name = os.path.basename(str(artifact))
        with open(artifact) as f:
            artifact = json.load(f)
    mem = artifact.get("xla_memory_analysis_per_device", {})
    if "argument_size_in_bytes" not in mem:
        raise ValueError(f"artifact {name or '<dict>'} carries no XLA "
                         "memory analysis")
    args_b = int(mem["argument_size_in_bytes"])
    temp_b = int(mem.get("temp_size_in_bytes", 0))
    peak = args_b + temp_b
    backend = artifact.get("backend", "cpu")
    if backend == "cpu":
        peak -= int(artifact.get("fit_verdict", {}).get(
            "cpu_bf16_upcast_artifact_bytes", 0))
    if budget is None:
        budget = (int(TPU_BUDGET_GIB * 2 ** 30)
                  if backend == "tpu" else budget_bytes())
    breakdown = {"arguments": args_b, "temp": temp_b,
                 "output": int(mem.get("output_size_in_bytes", 0)),
                 "alias": int(mem.get("alias_size_in_bytes", 0))}
    top = [{"name": "<xla arguments>", "bytes": args_b,
            "components": {"arguments": args_b}},
           {"name": "<xla temp>", "bytes": temp_b,
            "components": {"temp": temp_b}}]
    plan = Plan(peak, budget, breakdown, top,
                source=f"lowering:{name or backend}",
                remat=artifact.get("remat"), offload=None,
                ctx={"artifact": name, "mesh": artifact.get("mesh"),
                     "per_chip_batch": artifact.get("per_chip_batch"),
                     "optimizer": artifact.get("optimizer")})
    if record:
        global _last_plan
        _last_plan = plan
    return plan


def prescribe(plan=None, margin=0.0):
    """Turn a failed (or failing) plan into the cheapest fix that fits:
    re-plan the next remat tiers, host offload, and a halved batch, in
    increasing cost-of-fix order.  Returns ``{"candidates": [...],
    "recommendation": {...}|None}`` or ``None`` when there is nothing
    to re-plan (no analytic plan context)."""
    from .policy import TIERS

    plan = plan if plan is not None else _last_plan
    if plan is None or "shapes" not in plan.ctx:
        return None
    ctx = plan.ctx
    base = dict(params=ctx["shapes"], mesh=ctx["mesh"],
                rules=ctx["rules"], optimizer=ctx["optimizer"],
                batch_bytes=ctx["batch_bytes"],
                activation_hint=ctx["activation_hint"],
                budget=ctx["budget"], training=ctx["training"],
                device_kind=ctx["device_kind"],
                kv_pool_bytes=ctx.get("kv_pool_bytes", 0), record=False)

    tier_i = TIERS.index(plan.remat) if plan.remat in TIERS else 0
    candidates = []
    for tier in TIERS[tier_i + 1:]:
        candidates.append((f'remat="{tier}"',
                           dict(base, remat=tier, offload=plan.offload)))
    if plan.offload != "host":
        candidates.append(('offload="host"',
                           dict(base, remat=plan.remat, offload="host")))
        if tier_i + 1 < len(TIERS):
            candidates.append(
                (f'remat="{TIERS[-1]}" + offload="host"',
                 dict(base, remat=TIERS[-1], offload="host")))
    candidates.append(
        ("halve the batch",
         dict(base, remat=plan.remat, offload=plan.offload,
              batch_bytes=ctx["batch_bytes"] // 2,
              activation_hint=(None if ctx["activation_hint"] is None
                               else ctx["activation_hint"] // 2))))

    out, rec = [], None
    for change, kw in candidates:
        cand = plan_model(**kw)
        fits = cand.predicted_peak_bytes <= cand.budget_bytes * (1 - margin)
        entry = {"change": change,
                 "predicted_peak_bytes": cand.predicted_peak_bytes,
                 "predicted_peak_gib": round(
                     cand.predicted_peak_bytes / 2 ** 30, 3),
                 "fits": fits,
                 "headroom_bytes": cand.headroom_bytes}
        out.append(entry)
        if fits and rec is None:
            rec = entry
    result = {"failing_plan": plan.as_dict(), "candidates": out,
              "recommendation": rec}
    global _last_prescription
    _last_prescription = result
    return result
