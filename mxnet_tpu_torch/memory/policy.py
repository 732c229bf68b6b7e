"""Remat policy: a small tier ladder picked by the planner.

Counterpart of ``mxnet_tpu/memory/policy.py``.  Three tiers trade
recompute for activation memory:

- ``"none"``   — save every activation; zero recompute (cheapest step).
- ``"dots"``   — a selective checkpoint that saves the products' outputs
  (``aten.mm``/``addmm``/``bmm``/``matmul``/``linear``, as
  ``jax.checkpoint_policies.dots_saveable`` saves ``dot_general``'s);
  everything else recomputes in the backward, the flash kernel's forward
  included (the reference's ``pallas_call`` is no dot either).
- ``"layer"``  — a full checkpoint at the natural block boundary (each
  decoder layer of a ``scan_layers`` Llama; the whole recorded forward of
  a hybridized block): only the boundary's inputs survive.

``"auto"`` asks the planner for the cheapest tier that fits the device
budget with a configurable margin.  Every remat decision in the package
flows through :func:`checkpoint_wrap`, the one ``torch.utils.checkpoint``
call site (``tests/test_torch_remat.py`` greps for any other).

Both checkpointing tiers also save the outputs of the random draws
(dropout's masks come from the package's generators, which torch's
checkpoint does not replay), so a recompute sees the first forward's
draws, inside a CUDA graph capture as well.  A recompute runs under
``autograd.record`` in the training mode of its forward (the port's ops
record only then) and with the numerics taps muted (its forward's taps
already fired).
"""

TIERS = ("none", "dots", "layer")

#: historical/bool spellings accepted at every remat surface
_ALIASES = {
    None: "none", False: "none", True: "layer",
    "full": "layer", "per_layer": "layer", "per-layer": "layer",
    "dots_saveable": "dots",
}

#: default headroom the auto policy insists on below the device budget
DEFAULT_MARGIN = 0.10

#: last auto-policy decision, for telemetry's ``remat_policy`` field
#: and the OOM prescription: {"tier", "mode", "predicted_peak_bytes"}
_last_policy = None


def normalize(tier):
    """Canonical tier name for any accepted spelling ("auto" passes
    through); raises on garbage rather than silently not remat-ing."""
    t = _ALIASES.get(tier, tier)
    if t == "auto" or t in TIERS:
        return t
    raise ValueError(
        f"unknown remat tier {tier!r}: expected one of {TIERS + ('auto',)}")


def _saved_ops(tier):
    """The aten op packets whose outputs a tier's checkpoint keeps."""
    import torch

    aten = torch.ops.aten
    ops = {aten.rand, aten.rand_like, aten.randn, aten.randn_like,
           aten.randint, aten.randint_like, aten.randperm, aten.bernoulli,
           aten.uniform, aten.normal, aten.multinomial, aten.native_dropout}
    if tier == "dots":
        ops |= {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.matmul,
                aten.linear, aten._scaled_mm}
    return frozenset(ops)


def _context_fn(tier):
    import torch.utils.checkpoint as ckpt

    saved = _saved_ops(tier)

    def policy(ctx, op, *args, **kwargs):
        packet = getattr(op, "overloadpacket", op)
        return ckpt.CheckpointPolicy.MUST_SAVE if packet in saved \
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: ckpt.create_selective_checkpoint_contexts(policy)


def checkpoint_wrap(fn, tier):
    """Wrap ``fn`` per the (normalized) tier — the ONE sanctioned
    ``torch.utils.checkpoint`` site of the package.  ``fn`` takes and
    returns tensors or NDArrays; the wrapped call checkpoints only while
    the package's autograd records (otherwise it is ``fn``)."""
    t = normalize(tier)
    if t == "auto":
        raise ValueError("resolve 'auto' via select_tier()/auto_tier() "
                         "before wrapping")
    if t == "none":
        return fn
    import torch.utils.checkpoint as ckpt

    from .. import autograd as ag
    from ..telemetry import numerics as _numerics

    context_fn = _context_fn(t)

    def wrapped(*args):
        if not ag.is_recording():
            return fn(*args)
        train = ag.is_training()
        calls = [0]

        def run(*inner):
            calls[0] += 1
            with ag.record(train_mode=train):
                if calls[0] == 1:
                    return fn(*inner)
                with _numerics.muted():  # the recompute
                    return fn(*inner)

        return ckpt.checkpoint(run, *args, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=context_fn)

    return wrapped


def record_policy(tier, mode, plan=None):
    """Note the decision (telemetry reads it back via
    ``memory.telemetry_fields``)."""
    global _last_policy
    _last_policy = {
        "tier": tier, "mode": mode,
        "predicted_peak_bytes": (
            int(plan.predicted_peak_bytes) if plan is not None else None),
    }
    return _last_policy


def last_policy():
    return _last_policy


def reset():
    """Forget the last decision (benchmark/test lane isolation)."""
    global _last_policy
    _last_policy = None


def select_tier(plan_for_tier, margin=None, record=True):
    """Cheapest tier whose plan fits with ``margin`` headroom below the
    budget; escalates up the ladder, settling on "layer" (the most
    memory-frugal tier) even when nothing fits — the plan's ``fits``
    flag carries the bad news.  ``plan_for_tier(tier) -> Plan``.
    Returns ``(tier, plan)``."""
    margin = DEFAULT_MARGIN if margin is None else margin
    tier, plan = None, None
    for tier in TIERS:
        plan = plan_for_tier(tier)
        if plan.predicted_peak_bytes <= plan.budget_bytes * (1 - margin):
            break
    if record:
        record_policy(tier, "auto", plan)
    return tier, plan


def auto_tier(params, mesh=None, rules=None, optimizer=None,
              batch_bytes=0, activation_hint=None, budget=None,
              margin=None, record=True):
    """Resolve "auto" for a concrete model: plan each tier with the
    analytic planner and return ``(tier, plan)`` via
    :func:`select_tier`.  ``params`` as accepted by
    :func:`planner.plan_model`; ``activation_hint`` (bytes at tier
    "none") scales down the ladder when the caller measured it."""
    from . import planner

    def plan_for(tier):
        return planner.plan_model(
            params, mesh=mesh, rules=rules, optimizer=optimizer,
            batch_bytes=batch_bytes, remat=tier,
            activation_hint=activation_hint, budget=budget)

    return select_tier(plan_for, margin=margin, record=record)
