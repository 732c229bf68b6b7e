"""The legacy symbolic API: lazy graph construction.

Counterpart of ``mxnet_tpu/symbol/symbol.py`` (reference
``python/mxnet/symbol/symbol.py`` over the nnvm graph core): a ``Symbol``
is a handle to a DAG of op nodes; composition
(``sym.FullyConnected(data, ...)``) appends nodes; ``bind`` /
``simple_bind`` make an ``Executor`` that walks the DAG through the op
registry (``ops/registry.py``), one NDArray op a node.  The JSON is the
reference's symbol JSON byte for byte (``nodes`` / ``arg_nodes`` /
``heads``, attributes written as strings, node names from
``NameManager``), so a graph written by either package loads in the
other and ``mx.sym.load`` reads MXNet model files.  Shape and dtype
inference runs each node's op on tensors of torch's ``meta`` device (no
data, no compute).
"""
from __future__ import annotations

import json

import numpy as np

from ..base import MXNetError, dtype_name, resolve_dtype
from ..name import NameManager
from ..ops import registry as _op_registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones"]


class _SymNode:
    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op, name, attrs=None, inputs=None, num_outputs=1):
        self.op = op          # "null" for variables
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs or [])   # [(node, oidx)]
        self.num_outputs = num_outputs

    def is_var(self):
        return self.op == "null"


# ops with >1 raw output: name -> (total_outputs, visible_outputs) given attrs
_MULTI_OUT = {
    "split": lambda a: (int(a.get("num_outputs", 1)),) * 2,
    "SliceChannel": lambda a: (int(a.get("num_outputs", 1)),) * 2,
    "topk": lambda a: (2, 2) if a.get("ret_typ") == "both" else (1, 1),
    "BatchNorm": lambda a: (3, 3 if a.get("output_mean_var") else 1),
    "batch_norm": lambda a: (3, 3 if a.get("output_mean_var") else 1),
    # quantization family: (out, min, max) triples
    **{k: (lambda a: (3, 3)) for k in (
        "quantize", "_contrib_quantize", "quantize_v2",
        "_contrib_quantize_v2", "requantize", "_contrib_requantize",
        "quantized_conv", "_contrib_quantized_conv",
        "quantized_fully_connected",
        "_contrib_quantized_fully_connected", "quantized_pooling",
        "_contrib_quantized_pooling", "quantized_flatten",
        "_contrib_quantized_flatten")},
    # detection multi-output contribs
    **{k: (lambda a: (3, 3)) for k in (
        "multibox_target", "MultiBoxTarget", "_contrib_MultiBoxTarget")},
    **{k: (lambda a: (2, 2)) for k in (
        "bipartite_matching", "_contrib_bipartite_matching")},
}

# parameter-bearing ops: ordered input names after ``data``; (name, is_aux,
# include(attrs)) — auto-created as Variables named ``{opname}_{input}``
# (reference: nnvm FListInputNames + gluon naming convention)
_ALWAYS = lambda a: True
_OP_INPUTS = {
    "FullyConnected": [("weight", False, _ALWAYS),
                       ("bias", False, lambda a: not a.get("no_bias", False))],
    "Convolution": [("weight", False, _ALWAYS),
                    ("bias", False, lambda a: not a.get("no_bias", False))],
    "Deconvolution": [("weight", False, _ALWAYS),
                      ("bias", False, lambda a: not a.get("no_bias", True))],
    "BatchNorm": [("gamma", False, _ALWAYS), ("beta", False, _ALWAYS),
                  ("moving_mean", True, _ALWAYS),
                  ("moving_var", True, _ALWAYS)],
    "LayerNorm": [("gamma", False, _ALWAYS), ("beta", False, _ALWAYS)],
    "InstanceNorm": [("gamma", False, _ALWAYS), ("beta", False, _ALWAYS)],
    "Embedding": [("weight", False, _ALWAYS)],
    "LeakyReLU": [("gamma", False, lambda a: a.get("act_type") == "prelu")],
    # output heads auto-create their label var (reference FListInputNames
    # includes 'label'; the var lands as e.g. 'softmax_label')
    "SoftmaxOutput": [("label", False, _ALWAYS)],
    "LinearRegressionOutput": [("label", False, _ALWAYS)],
    "LogisticRegressionOutput": [("label", False, _ALWAYS)],
    "MAERegressionOutput": [("label", False, _ALWAYS)],
}

_canon = {"fully_connected": "FullyConnected", "convolution": "Convolution",
          "deconvolution": "Deconvolution", "batch_norm": "BatchNorm",
          "layer_norm": "LayerNorm", "instance_norm": "InstanceNorm",
          "embedding": "Embedding", "leaky_relu": "LeakyReLU",
          "slice_channel": "SliceChannel",
          "softmax_output": "SoftmaxOutput",
          "linear_regression_output": "LinearRegressionOutput",
          "logistic_regression_output": "LogisticRegressionOutput",
          "mae_regression_output": "MAERegressionOutput"}


def _canon_op(op):
    return _canon.get(op, op)


class Symbol:
    """A handle to one or more outputs of a symbolic graph."""

    def __init__(self, heads):
        self._heads = list(heads)  # [(node, oidx)]

    # --- introspection ------------------------------------------------------

    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def _topo(self):
        """Topological (inputs-first) order of all reachable nodes."""
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._heads)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for src, _ in reversed(node.inputs):
                if id(src) not in seen:
                    stack.append((src, False))
        return order

    def _vars(self):
        return [n for n in self._topo() if n.is_var()]

    def list_arguments(self):
        return [n.name for n in self._vars() if not n.attrs.get("__is_aux__")]

    def list_auxiliary_states(self):
        return [n.name for n in self._vars() if n.attrs.get("__is_aux__")]

    def list_inputs(self):
        return [n.name for n in self._vars()]

    def list_outputs(self):
        names = []
        for node, oidx in self._heads:
            if node.is_var():
                names.append(node.name)
            elif node.num_outputs == 1:
                names.append(node.name + "_output")
            else:
                names.append(f"{node.name}_output{oidx}")
        return names

    @property
    def num_outputs(self):
        return len(self._heads)

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        return (Symbol([h]) for h in self._heads)

    def __getitem__(self, index):
        if isinstance(index, str):
            for node in self._topo():
                total = node.num_outputs
                for oidx in range(total):
                    nm = node.name if node.is_var() else (
                        node.name + "_output" if total == 1
                        else f"{node.name}_output{oidx}")
                    if nm == index or node.name == index:
                        return Symbol([(node, oidx)])
            raise MXNetError(f"no output named {index!r}")
        if isinstance(index, slice):
            return Symbol(self._heads[index])
        return Symbol([self._heads[index]])

    def get_internals(self):
        heads = []
        for node in self._topo():
            for oidx in range(node.num_outputs if not node.is_var() else 1):
                heads.append((node, oidx))
        return Symbol(heads)

    def get_children(self):
        node = self._heads[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    # --- attrs --------------------------------------------------------------

    def attr(self, key):
        v = self._heads[0][0].attrs.get(key)
        return None if v is None else str(v)

    def list_attr(self):
        return {k: str(v) for k, v in self._heads[0][0].attrs.items()}

    def attr_dict(self):
        return {n.name: {k: str(v) for k, v in n.attrs.items()}
                for n in self._topo() if n.attrs}

    def _set_attr(self, **kwargs):
        self._heads[0][0].attrs.update(kwargs)

    # --- arithmetic ---------------------------------------------------------

    def _binop(self, other, opname, scalar_opname, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _make_node(opname, [a, b], {})
        return _make_node(scalar_opname, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binop(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "elemwise_div", "_rdiv_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _make_node("_mul_scalar", [self], {"scalar": -1.0})

    def __eq__(self, o):  # MXNet symbols compare elementwise
        if isinstance(o, (Symbol, int, float)):
            return self._binop(o, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __repr__(self):
        outs = ", ".join(self.list_outputs())
        return f"<Symbol {outs}>"

    def __getattr__(self, opname):
        # fluent op calls: x.reshape(...), x.sum(...) — resolve through the
        # registry (reference generates these methods too)
        if opname.startswith("_"):
            raise AttributeError(opname)
        if _op_registry.get_op(opname) is None:
            raise AttributeError(opname)

        def method(*args, **kwargs):
            from . import _sym_op
            return _sym_op(opname)(self, *args, **kwargs)

        method.__name__ = opname
        return method

    # --- serialization ------------------------------------------------------

    def tojson(self):
        order = self._topo()
        nid = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            entry = {"op": n.op, "name": n.name,
                     "inputs": [[nid[id(s)], oi, 0] for s, oi in n.inputs]}
            attrs = {k: str(v) for k, v in n.attrs.items()
                     if not k.startswith("__")}
            if n.is_var():
                aux_flags = {k: str(v) for k, v in n.attrs.items()
                             if k.startswith("__") and k != "__is_aux__"}
                attrs.update(aux_flags)
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
        graph = {
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(order) if n.is_var()],
            "node_row_ptr": list(range(len(order) + 1)),
            "heads": [[nid[id(n)], oi, 0] for n, oi in self._heads],
            "attrs": {"mxnet_version": ["int", 10700]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # --- shape/type inference ----------------------------------------------

    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes = self._infer(args, kwargs)
        if arg_shapes and any(s is None for s in arg_shapes):
            missing = [n for n, s in zip(self.list_arguments(), arg_shapes)
                       if s is None]
            raise MXNetError(f"cannot infer shapes for arguments {missing}; "
                             "provide them to infer_shape")
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer(args, kwargs)

    def infer_type(self, *args, **kwargs):
        # dtype flows with shapes; default float32
        dtypes = {k: _np_dtype(resolve_dtype(v)) for k, v in kwargs.items()}
        arg_names = self.list_arguments()
        for pos, t in enumerate(args):
            if t is not None:
                dtypes[arg_names[pos]] = _np_dtype(resolve_dtype(t))
        known, outs, auxs = self._infer((), {}, dtypes=dtypes, want="dtype")
        return known, outs, auxs

    def _infer(self, pos_shapes, kw_shapes, dtypes=None, want="shape"):
        given = dict(kw_shapes)
        arg_names = self.list_arguments()
        for pos, s in enumerate(pos_shapes):
            if s is not None:
                given[arg_names[pos]] = s
        dtypes = dtypes or {}
        order = self._topo()
        # node id -> tuple of (shape, dtype) per output, or None if unknown
        info = {}
        for n in order:
            if n.is_var():
                # NB: `or` would treat a provided 0-d shape () as
                # missing (scalar constants from the ONNX importer)
                shape = given.get(n.name)
                if shape is None:
                    shape = n.attrs.get("__shape__")
                dt = dtypes.get(n.name) or _np_dtype(resolve_dtype(
                    n.attrs.get("__dtype__", "float32")))
                info[id(n)] = None if shape is None else \
                    ((tuple(int(d) for d in shape), np.dtype(dt)),)
                continue
            # derive unknown param-shapes from the data input, then eval
            canon = _canon_op(n.op)
            if canon in _OP_INPUTS and n.inputs and \
                    info.get(id(n.inputs[0][0])) is not None:
                data_shape = info[id(n.inputs[0][0])][n.inputs[0][1]][0]
                rules = _param_shapes(canon, n.attrs, data_shape)
                for (src, _oi), pname in zip(
                        n.inputs[1:], [p for p, _, c in _OP_INPUTS[canon]
                                       if c(n.attrs)]):
                    if info.get(id(src)) is None and pname in rules:
                        dt = dtypes.get(src.name) or np.dtype(np.float32)
                        info[id(src)] = ((tuple(rules[pname]), dt),)
            in_info = [info.get(id(s)) for s, _ in n.inputs]
            if any(i is None for i in in_info) or \
                    _op_registry.get_op(n.op) is None:
                info[id(n)] = None
                continue
            structs = [info[id(s)][oi] for s, oi in n.inputs]
            try:
                outs = _eval_node(n.op, n.attrs, structs)
            except Exception:
                info[id(n)] = None
                continue
            info[id(n)] = tuple((tuple(o.shape), _np_dtype(o.dtype))
                                for o in outs)

        def pick(entry, oidx=0):
            if entry is None:
                return None
            shape, dt = entry[oidx]
            return shape if want == "shape" else dt

        variables = self._vars()
        arg_i = [pick(info.get(id(n))) for n in variables
                 if not n.attrs.get("__is_aux__")]
        aux_i = [pick(info.get(id(n))) for n in variables
                 if n.attrs.get("__is_aux__")]
        out_i = [pick(info.get(id(n)), oi) for n, oi in self._heads]
        return arg_i, out_i, aux_i

    # --- binding ------------------------------------------------------------

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        from ..executor import Executor

        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        from ..executor import Executor

        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states)

    def eval(self, ctx=None, **kwargs):
        exe = self.bind(ctx, args=kwargs)
        return exe.forward()


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------

def _np_dtype(dt):
    """The numpy dtype of a torch dtype (bfloat16, which numpy lacks,
    stays the torch dtype)."""
    import torch

    if dt == torch.bfloat16:
        return dt
    return np.dtype(str(dt).removeprefix("torch."))


def _eval_node(op, attrs, structs):
    """Shape-only evaluation of one registry op: the op on tensors of the
    ``meta`` device, which carry shape and dtype and no data."""
    import torch

    from .. import autograd
    from ..base import resolve_dtype
    from ..ndarray.ndarray import NDArray

    fn = _op_registry.get_op(op)
    clean = {k: v for k, v in attrs.items() if not k.startswith("__")}
    ins = [NDArray(torch.empty(shape, dtype=resolve_dtype(dt),
                               device="meta")) for shape, dt in structs]
    with autograd.pause():
        out = fn(*ins, **clean)
    return out if isinstance(out, (tuple, list)) else (out,)


def _param_shapes(op, attrs, data_shape):
    """Infer parameter shapes from the data shape (the role of the
    reference's per-op FInferShape backward-flow)."""
    try:
        if op == "FullyConnected":
            nh = int(attrs["num_hidden"])
            flat = attrs.get("flatten", True)
            in_dim = int(np.prod(data_shape[1:])) if flat else data_shape[-1]
            return {"weight": (nh, in_dim), "bias": (nh,)}
        if op == "Convolution":
            nf = int(attrs["num_filter"])
            kernel = tuple(attrs["kernel"])
            ng = int(attrs.get("num_group", 1))
            return {"weight": (nf, data_shape[1] // ng) + kernel,
                    "bias": (nf,)}
        if op == "Deconvolution":
            nf = int(attrs["num_filter"])
            kernel = tuple(attrs["kernel"])
            ng = int(attrs.get("num_group", 1))
            return {"weight": (data_shape[1], nf // ng) + kernel,
                    "bias": (nf,)}
        if op == "BatchNorm":
            ax = int(attrs.get("axis", 1)) % len(data_shape)
            c = (data_shape[ax],)
            return {"gamma": c, "beta": c, "moving_mean": c, "moving_var": c}
        if op in ("LayerNorm", "InstanceNorm"):
            ax = int(attrs.get("axis", -1)) % len(data_shape)
            c = (data_shape[ax],)
            return {"gamma": c, "beta": c}
        if op == "Embedding":
            return {"weight": (int(attrs["input_dim"]),
                               int(attrs["output_dim"]))}
        if op == "LeakyReLU":
            return {"gamma": (data_shape[1],)}
        if op == "SoftmaxOutput":
            multi = str(attrs.get("multi_output", False)).lower() in \
                ("true", "1")
            return {"label": (data_shape[0],) + data_shape[2:] if multi
                    else data_shape[:-1]}
        if op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                  "MAERegressionOutput"):
            return {"label": data_shape}
    except (KeyError, IndexError):
        pass
    return {}


def _as_head(x):
    if isinstance(x, Symbol):
        if len(x._heads) != 1:
            raise MXNetError(
                f"symbol with {len(x._heads)} outputs used as a single "
                "input; select one with sym[i]")
        return x._heads[0]
    raise MXNetError(f"expected Symbol input, got {type(x).__name__}")


def _make_node(op, input_syms, attrs, name=None):
    canon = _canon_op(op)
    hint = canon.lower().lstrip("_")
    name = NameManager.current().get(name, hint)
    total, visible = 1, 1
    if canon in _MULTI_OUT:
        total, visible = _MULTI_OUT[canon](attrs)
    elif op in _MULTI_OUT:
        total, visible = _MULTI_OUT[op](attrs)
    node = _SymNode(op, name, attrs, [_as_head(s) for s in input_syms],
                    num_outputs=total)
    return Symbol([(node, i) for i in range(visible)])


def _sym_op(opname):
    """Build the symbol-level op function for a registry op."""

    def sym_op(*args, **kwargs):
        name = kwargs.pop("name", None)
        attrs = dict(kwargs.pop("attr", None) or {})
        sym_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if isinstance(kwargs[k], Symbol)}
        attrs.update(kwargs)
        inputs = []
        for a in args:
            if isinstance(a, Symbol):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a and \
                    isinstance(a[0], Symbol):
                inputs.extend(a)  # Concat-style varargs list
        canon = _canon_op(opname)
        if canon in _OP_INPUTS:
            if not inputs and "data" in sym_kwargs:
                inputs.append(sym_kwargs.pop("data"))
            if not inputs:
                raise MXNetError(f"{opname} needs a data input")
            node_name = NameManager.current().get(name, canon.lower())
            name = node_name
            ordered = inputs[:1]       # data
            extra = list(inputs[1:])   # positionally-passed params
            for pname, is_aux, cond in _OP_INPUTS[canon]:
                if not cond(attrs):
                    continue
                if pname in sym_kwargs:
                    ordered.append(sym_kwargs.pop(pname))
                elif extra:
                    ordered.append(extra.pop(0))
                else:
                    v = Variable(f"{node_name}_{pname}")
                    if is_aux:
                        v._heads[0][0].attrs["__is_aux__"] = True
                    ordered.append(v)
            inputs = ordered + extra
        else:
            if not inputs and "data" in sym_kwargs:
                inputs.append(sym_kwargs.pop("data"))
            # non-param ops may still take named symbol inputs (e.g. lhs/rhs)
            inputs.extend(sym_kwargs.values())
        return _make_node(opname, inputs, attrs, name=name)

    sym_op.__name__ = opname
    return sym_op


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """Create a symbolic variable (reference mx.sym.Variable)."""
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else \
            init.__class__.__name__
    attrs.update(kwargs)
    return Symbol([(_SymNode("null", name, attrs), 0)])


var = Variable


def Group(symbols):
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """Parse reference nnvm symbol-json into a Symbol graph."""
    from ..gluon.symbol_block import _parse_attr

    graph = json.loads(json_str)
    nodes_js = graph["nodes"]
    arg_nodes = set(graph.get("arg_nodes", []))
    built = []
    for i, nj in enumerate(nodes_js):
        raw_attrs = nj.get("attrs") or nj.get("param") or {}
        attrs = {k: _parse_attr(v) for k, v in raw_attrs.items()}
        if nj["op"] == "null":
            node = _SymNode("null", nj["name"], attrs)
            # aux-state heuristic for reference files (they don't mark aux
            # in json; executors infer it from op mutable-input slots)
            if any(t in nj["name"] for t in ("moving_mean", "moving_var",
                                             "running_mean", "running_var")):
                node.attrs["__is_aux__"] = True
        else:
            canon = _canon_op(nj["op"])
            total, _vis = _MULTI_OUT[canon](attrs) if canon in _MULTI_OUT \
                else (1, 1)
            node = _SymNode(nj["op"], nj["name"], attrs, num_outputs=total)
        built.append(node)
    for nj, node in zip(nodes_js, built):
        node.inputs = [(built[e[0]], e[1]) for e in nj.get("inputs", [])]
    heads = [(built[h[0]], h[1]) for h in graph["heads"]]
    return Symbol(heads)


def zeros(shape, dtype=None, **kwargs):
    """A zero-input node of zeros (reference ``mx.sym.zeros``)."""
    return _make_node("_zeros", [], {"shape": tuple(shape),
                                     "dtype": dtype_name(dtype or "float32")},
                      name=kwargs.get("name"))


def ones(shape, dtype=None, **kwargs):
    """A zero-input node of ones (reference ``mx.sym.ones``)."""
    return _make_node("_ones", [], {"shape": tuple(shape),
                                    "dtype": dtype_name(dtype or "float32")},
                      name=kwargs.get("name"))


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, **kwargs):
    """Symbolic arange: zero-input creation node.  Defined explicitly
    (rather than via the generic op wrapper, which keeps only Symbol
    positionals) so positional start/stop work like the reference
    mx.sym.arange."""
    attrs = {"start": start, "step": step, "repeat": repeat}
    if stop is not None:
        attrs["stop"] = stop
    if dtype is not None:
        attrs["dtype"] = dtype_name(dtype)
    return _make_node("arange", [], attrs, name=kwargs.get("name"))
