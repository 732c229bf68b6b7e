"""Partition-rule engine: named meshes + ordered regex rules → DTensor
placements.

Counterpart of ``mxnet_tpu/parallel/partition.py``.  The user-facing
surface is the reference's rule table: an ordered list of ``(regex,
partition-spec)`` pairs matched against Gluon parameter paths, first
match wins (the t5x/EasyLM ``match_partition_rules`` shape).  The same
table drives real placement at ``Trainer(..., partition_rules=...)``
(:func:`place_params`: each parameter becomes a ``DTensor`` leaf, its
gradient and the optimizer state created afterwards follow its
placements) and dry runs over ``(name, shape)`` pairs with no memory
(:meth:`PartitionRules.specs`, against a ``DeviceMesh`` or a
``{axis: size}`` dict).

Rules are matched against both naming schemes Gluon produces (the
structural dotted path and the flat prefixed name), so the built-in
family tables use separator-tolerant patterns (``(^|[._])``).

Matching discipline, as the reference's:

  * first match wins over the ordered table;
  * scalars always replicate;
  * a matching rule whose non-empty spec length differs from the
    parameter's rank is skipped (a rank-skip) and matching continues;
  * axis names absent from the mesh (or of size 1) resolve to ``None``;
  * a sharded dim must divide evenly: an indivisible axis resolves to
    ``None`` and is reported, never raised mid-init;
  * unmatched parameters replicate (``on_unmatched="replicate"``) or
    raise (``"error"``); :meth:`PartitionRules.coverage` reports them,
    and every rule no parameter used.
"""
from __future__ import annotations

import re

from ..base import MXNetError

__all__ = ["PartitionRules", "as_rules", "place_params", "stacked_spec",
           "LLAMA_RULES", "MIXTRAL_RULES", "SERVING_RULES",
           "FAMILY_RULES",
           "last_placement"]

#: Megatron TP layout for dense llama-family transformers.  Weights are
#: stored (out, in): q/k/v/gate/up split the output dim (column
#: parallel), o/down split the input dim (row parallel), embed/lm_head
#: split the vocab dim.  Terminal catch-all replicates the rest
#: (norms, biases) explicitly.
LLAMA_RULES = (
    (r"(^|[._])(q|k|v|gate|up)(_proj)?[._]weight$", ("tp", None)),
    (r"(^|[._])(o|down)(_proj)?[._]weight$", (None, "tp")),
    (r"(^|[._])embed(_tokens)?[._]weight$", ("tp", None)),
    (r"(^|[._])lm_head[._]weight$", ("tp", None)),
    (r".*", ()),
)

#: Mixtral = llama + MoE expert banks.  The 3-D bank rules come FIRST:
#: the flat names ``moe_gate_weight``/``moe_down_weight`` also match the
#: dense 2-D rules below, and only the rank guard + ordering routes the
#: (E, I, H) banks to the expert layout (mirrors
#: ``models.moe.moe_param_specs``: banks split over ep, intra-expert
#: over tp; the tiny router replicates).
MIXTRAL_RULES = (
    (r"(^|[._])router[._]?weight$", ()),
    (r"(^|[._])(gate|up)_weight$", ("ep", "tp", None)),
    (r"(^|[._])down_weight$", ("ep", None, "tp")),
) + LLAMA_RULES

#: Serving-side llama table: the training rules plus the KV storage.
#: The serving engine names its per-layer KV buffers
#: ``layers.{i}.kv_pool`` — rank 4 either way the engine stores them
#: (paged ``(num_blocks, Hkv, block, head)`` or slotted ``(slots, Hkv,
#: max_len, head)``) — and shards the KV-head axis over ``tp``,
#: matching the column-parallel k/v projections that produce it.  The
#: rank guard keeps the rule away from every 2-D weight.
SERVING_RULES = (
    (r"(^|[._])kv_pool$", (None, "tp", None, None)),
) + LLAMA_RULES

FAMILY_RULES = {"llama": LLAMA_RULES, "mixtral": MIXTRAL_RULES,
                "llama_serving": SERVING_RULES}

#: most recent place_params summary (mesh_shape / sharded_params /
#: replicated_params; the reference's telemetry folds it into each step's
#: record)
_LAST_PLACEMENT = None


def last_placement():
    """The most recent :func:`place_params` summary dict (or None):
    ``{"mesh_shape": {...}, "sharded_params": n, "replicated_params": n}``."""
    return _LAST_PLACEMENT


class Coverage:
    """Placement coverage report — what matched, what fell through.

    ``matched``   {name: (pattern, resolved_spec)} for sharded params
    ``replicated``[names] resolved to full replication (catch-all,
                  axis-dropped, or unmatched under ``replicate`` mode)
    ``unmatched`` [names] no rule matched at all
    ``rank_skips``[(name, pattern)] rules skipped by the rank guard
    ``dropped``   [(name, axis, reason)] spec axes resolved to None
                  ("absent", "size1", "indivisible")
    ``unused``    [patterns] rules no param ever selected
    """

    def __init__(self):
        self.matched = {}
        self.replicated = []
        self.unmatched = []
        self.rank_skips = []
        self.dropped = []
        self.unused = []
        self.mesh_shape = {}

    @property
    def sharded_params(self):
        return len(self.matched)

    @property
    def replicated_params(self):
        return len(self.replicated)

    def summary(self):
        return {"mesh_shape": dict(self.mesh_shape),
                "sharded_params": self.sharded_params,
                "replicated_params": self.replicated_params}

    def render(self):
        lines = [f"mesh={self.mesh_shape} sharded={self.sharded_params} "
                 f"replicated={self.replicated_params}"]
        for name, (pat, spec) in sorted(self.matched.items()):
            lines.append(f"  shard {name}: {spec}  [{pat}]")
        for name in self.unmatched:
            lines.append(f"  UNMATCHED {name} (replicated)")
        for pat in self.unused:
            lines.append(f"  UNUSED rule {pat!r}")
        for name, axis, why in self.dropped:
            lines.append(f"  dropped axis {axis!r} on {name} ({why})")
        return "\n".join(lines)


class PartitionRules:
    """Ordered ``(regex, spec)`` table mapping parameter paths to
    partition specs.  Specs are tuples of mesh-axis names / ``None`` per
    dim (nested tuples allowed for multi-axis dims); ``()`` replicates.
    """

    def __init__(self, rules, on_unmatched="replicate"):
        if on_unmatched not in ("replicate", "error"):
            raise MXNetError(
                f"on_unmatched must be 'replicate' or 'error', "
                f"got {on_unmatched!r}")
        self.on_unmatched = on_unmatched
        self.rules = []
        for pattern, spec in rules:
            try:
                rx = re.compile(pattern)
            except re.error as e:
                raise MXNetError(
                    f"invalid partition-rule regex {pattern!r}: {e}")
            self.rules.append((pattern, rx, tuple(spec)))
        if not self.rules:
            raise MXNetError("empty partition-rule table")

    @classmethod
    def for_family(cls, family, on_unmatched="replicate"):
        """Built-in table by model-family name ('llama', 'mixtral')."""
        try:
            rules = FAMILY_RULES[family]
        except KeyError:
            raise MXNetError(
                f"unknown model family {family!r}; "
                f"known: {sorted(FAMILY_RULES)}")
        return cls(rules, on_unmatched=on_unmatched)

    # -- matching -------------------------------------------------------------

    def match(self, name, shape=None, coverage=None):
        """First rule matching ``name`` (rank-compatible with ``shape``):
        ``(pattern, spec)``; ``(None, None)`` when nothing matches."""
        if shape is not None and len(shape) == 0:
            return None, ()  # scalars always replicate
        for pattern, rx, spec in self.rules:
            if rx.search(name) is None:
                continue
            if shape is not None and spec and len(spec) != len(shape):
                if coverage is not None:
                    coverage.rank_skips.append((name, pattern))
                continue
            return pattern, spec
        return None, None

    def resolve(self, spec, mesh, shape=None, name="?", coverage=None):
        """Ground ``spec`` against ``mesh``: axes absent from the mesh,
        of size 1, or not dividing the dim evenly become ``None``."""
        if spec is None:
            return None
        axes = _axes(mesh)

        def keep(axis, dim):
            why = None
            if axis not in axes:
                why = "absent"
            elif axes[axis] <= 1:
                why = "size1"
            elif dim is not None and dim % axes[axis] != 0:
                why = "indivisible"
            if why is not None and coverage is not None:
                coverage.dropped.append((name, axis, why))
            return why is None

        out = []
        for i, axis in enumerate(spec):
            dim = shape[i] if shape is not None else None
            if axis is None:
                out.append(None)
            elif isinstance(axis, (tuple, list)):
                kept = tuple(a for a in axis if keep(a, dim))
                out.append(kept if kept else None)
            else:
                out.append(axis if keep(axis, dim) else None)
        return tuple(out)

    def specs(self, named_shapes, mesh, coverage=None):
        """Resolved specs for ``{name: shape}`` (or ``(name, shape)``
        pairs) against ``mesh``: ``{name: spec}`` with only actually-
        sharded entries; fills ``coverage`` when given.  Raises under
        ``on_unmatched='error'`` for any name no rule matched."""
        cov = coverage if coverage is not None else Coverage()
        if mesh is not None:
            cov.mesh_shape = _axes(mesh)
        items = named_shapes.items() if hasattr(named_shapes, "items") \
            else named_shapes
        used = set()
        out = {}
        for name, shape in items:
            pattern, spec = self.match(name, shape, coverage=cov)
            if spec is None:
                cov.unmatched.append(name)
                cov.replicated.append(name)
                continue
            if pattern is not None:
                used.add(pattern)
            resolved = self.resolve(spec, mesh, shape, name=name,
                                    coverage=cov)
            if any(a is not None for a in resolved):
                cov.matched[name] = (pattern, resolved)
                out[name] = resolved
            else:
                cov.replicated.append(name)
        cov.unused = [p for p, _rx, _s in self.rules if p not in used]
        if cov.unmatched and self.on_unmatched == "error":
            raise MXNetError(
                "partition rules matched no rule for: "
                + ", ".join(sorted(cov.unmatched)))
        return out

    def coverage(self, named_shapes, mesh):
        """Dry-run ``specs`` and return the :class:`Coverage` report."""
        cov = Coverage()
        self.specs(named_shapes, mesh, coverage=cov)
        return cov


def as_rules(rules):
    """Coerce to :class:`PartitionRules`: pass through an instance, look
    up a family name, or wrap an ``(regex, spec)`` iterable."""
    if rules is None:
        return None
    if isinstance(rules, PartitionRules):
        return rules
    if isinstance(rules, str):
        return PartitionRules.for_family(rules)
    return PartitionRules(rules)


def stacked_spec(spec, stack_axes=1):
    """Spec for a scan-stacked bank of per-layer params: the leading
    stack dim(s) replicate, the per-layer spec shifts right — the shape
    the reference's lowering proofs use for their (L, ...) operands."""
    return (None,) * stack_axes + tuple(spec or ())


def _axes(mesh):
    from . import mesh_axes

    return mesh_axes(mesh)


def place_params(params, rules, mesh=None, on_unmatched=None):
    """Place initialized Gluon parameters per the rule table: each one
    becomes a ``DTensor`` leaf, sharded as its resolved spec says and
    replicated over every other axis, with rank 0's values (so
    replicated pieces are bitwise equal on every rank).  The gradient
    buffer starts again; optimizer state created afterwards follows the
    placement.  Returns the :class:`Coverage` report and records its
    summary (:func:`last_placement`)."""
    from . import _place_parameter, current_mesh

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise MXNetError("place_params needs a mesh; pass mesh= or call "
                         "parallel.set_mesh / mx.gpu(mesh=...) first")
    rules = as_rules(rules)
    if on_unmatched is not None:
        rules = PartitionRules(
            [(p, s) for p, _rx, s in rules.rules], on_unmatched=on_unmatched)
    if hasattr(params, "items"):
        named = list(params.items())
    else:
        named = [(p.name, p) for p in params]
    live = [(n, p) for n, p in named if getattr(p, "_data", None) is not None]
    cov = Coverage()
    specs = rules.specs([(n, p.shape) for n, p in live], mesh, coverage=cov)
    for name, p in live:
        _place_parameter(p, specs.get(name, ()), mesh)
    global _LAST_PLACEMENT
    _LAST_PLACEMENT = cov.summary()
    return cov
