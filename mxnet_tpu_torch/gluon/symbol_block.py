"""Graph export and import: the serving path.

Counterpart of ``mxnet_tpu/gluon/symbol_block.py`` (reference
``HybridBlock.export`` writing ``prefix-symbol.json`` and
``prefix-0000.params``; ``SymbolBlock.imports`` and the C predict API
loading them back).  Two formats, one importer:

* **Export** writes three files: ``path-symbol.json`` (the reference's
  meta keys, ``"mxnet_tpu_format": "torch_export"`` and a
  ``"program_file"``), ``path-%04d.params`` (``arg:``/``aux:`` keys, the
  reference's bytes) and ``path-%04d.pt2``, a ``torch.export`` program of
  the block's inference forward at the signature of its first cached
  graph.  The parameters are inputs of the program, as the reference
  passes them to its StableHLO program, so the ``.pt2`` holds no weights.
  The hand-written kernels that an inference forward reaches are
  ``torch.library`` custom ops (``mxnet_tpu_torch::flash_attention_fwd``,
  ``mxnet_tpu_torch::fused_matmul_affine_relu``,
  ``mxnet_tpu_torch::nms_keep``, which the detectors reach) and stay
  nodes of the program: run on the card, they launch the kernels.  The
  training kernels (the flash backward, the fused update, the CSR
  product) are launched through ``ctypes`` and refuse a trace: no
  inference forward reaches them, in either package.
* **Import of nnvm symbol JSON** (``"nodes"``/``"arg_nodes"``/
  ``"heads"``, the reference's ``save_checkpoint`` of a ``Symbol`` or a
  graph written by MXNet): the graph runs node by node through the op
  registry (``_NNVMGraphRunner``).

A reference StableHLO export (``"mxnet_tpu_format": "stablehlo"``) is a
JAX program and is refused by name ("Not carried over").  An imported
block hybridizes like any block: a CUDA graph per input signature.
"""
from __future__ import annotations

import ast
import json
import os

import torch

from ..base import MXNetError, dtype_name, resolve_dtype
from ..context import current_context
from ..ndarray.ndarray import NDArray
from .. import autograd as ag
from .. import cuda_graph

_FORMAT_KEY = "mxnet_tpu_format"


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

class _ExportShim(torch.nn.Module):
    """The block's inference forward as a function of tensors: the first
    ``len(params)`` arguments stand in for the parameters' values, the
    rest are the block's inputs; returns the outputs as a tuple."""

    def __init__(self, block, params):
        super().__init__()
        self._mx_block = block
        self._mx_params = params

    def forward(self, *tensors):
        n = len(self._mx_params)
        saved = [p._data._data for p in self._mx_params]
        try:
            for p, t in zip(self._mx_params, tensors[:n]):
                p._data._data = t
            with ag.pause(train_mode=False), cuda_graph.scope():
                out = self._mx_block(*(NDArray(t) for t in tensors[n:]))
        finally:
            for p, t in zip(self._mx_params, saved):
                p._data._data = t
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return tuple(o._data for o in outs)


def export_block(block, path, epoch=0):
    """Export a hybridized block that has run forward at least once (the
    reference's precondition): the program is traced at the signature of
    its first cached graph.  Returns the symbol and params file names."""
    cached = getattr(block, "_cached_op", None)
    if cached is None or not cached._graphs:
        raise MXNetError(
            "export requires hybridize() and at least one forward call "
            "(the reference has the same requirement)")
    in_sig = next(iter(cached._graphs))[0]
    if any(s is None for s in in_sig):
        raise MXNetError("export: the first cached signature has a None "
                         "input; a program takes tensors only")
    params = list(block.collect_params().values())
    p_tensors = tuple(p.data()._data.detach() for p in params)
    in_tensors = tuple(torch.zeros(shape, dtype=dt, device=dev)
                       for shape, dt, dev in in_sig)
    with torch.no_grad():
        program = torch.export.export(_ExportShim(block, params),
                                      p_tensors + in_tensors, strict=False)
    # the example inputs hold the weights: the program is saved without
    # them (they are read from the .params file)
    program.example_inputs = None
    prog_path = f"{path}-{epoch:04d}.pt2"
    torch.export.save(program, prog_path)

    from .. import serialization

    payload = {}
    for p in params:
        prefix = "aux:" if p.grad_req == "null" else "arg:"
        payload[prefix + p.name] = p.data()
    serialization.save_ndarrays(f"{path}-{epoch:04d}.params", payload)

    n_out = len(program.graph_signature.output_specs)
    meta = {
        _FORMAT_KEY: "torch_export",
        "version": 1,
        "param_names": [p.name for p in params],
        "param_kinds": ["aux" if p.grad_req == "null" else "arg"
                        for p in params],
        # .params files hold bf16 as f32: the program's dtypes
        "param_dtypes": [dtype_name(t.dtype) for t in p_tensors],
        "input_shapes": [list(s) for s, _, _ in in_sig],
        "input_dtypes": [dtype_name(dt) for _, dt, _ in in_sig],
        "num_outputs": n_out,
        "device": in_sig[0][2].type,
        "program_file": os.path.basename(prog_path),
    }
    with open(f"{path}-symbol.json", "w") as f:
        json.dump(meta, f, indent=2)
    return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"


# ---------------------------------------------------------------------------
# Import
# ---------------------------------------------------------------------------

def load_symbol_json(symbol_file):
    with open(symbol_file) as f:
        return json.load(f)


def import_block(symbol_file, input_names, param_file=None, ctx=None):
    """A ``SymbolBlock`` over an exported program or an nnvm graph, its
    parameters on ``ctx`` (default: the current context)."""
    meta = load_symbol_json(symbol_file)
    if isinstance(input_names, str):
        input_names = [input_names]
    ctx = ctx or current_context()
    fmt = meta.get(_FORMAT_KEY)
    if fmt == "stablehlo":
        raise MXNetError(
            f"{symbol_file!r} is a StableHLO export of the JAX package, a "
            "JAX program: it has no counterpart in the port (ROADMAP.md, "
            "Not carried over); export the block with the port "
            "(a torch.export program)")
    if fmt == "torch_export":
        return _import_program(symbol_file, meta, param_file, ctx)
    if "nodes" in meta:
        return _import_nnvm(meta, input_names, param_file, ctx)
    raise MXNetError(f"unrecognised symbol file format in {symbol_file!r}")


def _load_params(param_file, device):
    """``{name: NDArray}`` of a ``.params`` file (``arg:``/``aux:``
    prefixes dropped) on ``device``."""
    from .. import serialization

    loaded = serialization.load_ndarrays(param_file)
    if isinstance(loaded, list):
        # a block without parameters writes no names, which reads back as
        # an empty list
        if loaded:
            raise MXNetError(f"{param_file!r} holds unnamed arrays; an "
                             "exported block's parameters are named")
        return {}
    return {k.removeprefix("arg:").removeprefix("aux:"):
            NDArray(v._data.to(device)) for k, v in loaded.items()}


def _import_program(symbol_file, meta, param_file, ctx):
    from .block import SymbolBlock

    prog_path = os.path.join(os.path.dirname(os.path.abspath(symbol_file)),
                             meta["program_file"])
    if param_file is None:
        raise MXNetError("param_file is required for program imports")
    program = torch.export.load(prog_path)
    device = ctx.device
    if meta.get("device") != device.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    loaded = _load_params(param_file, device)
    p_raws = []
    for name, dt in zip(meta["param_names"], meta["param_dtypes"]):
        if name not in loaded:
            raise MXNetError(f"parameter {name!r} missing in {param_file!r}")
        p_raws.append(loaded[name]._data.to(resolve_dtype(dt)))
    in_dtypes = [resolve_dtype(dt) for dt in meta["input_dtypes"]]
    module = program.module()

    def fn(F, args, _params):
        # the program's signature is its export's: inputs are cast to it
        raws = [a._data.to(dt) for a, dt in zip(args, in_dtypes)]
        outs = [NDArray(o) for o in module(*p_raws, *raws)]
        return outs[0] if len(outs) == 1 else tuple(outs)

    block = SymbolBlock(prefix="symbolblock_")
    block._fn = fn
    block._program = program
    return block


# --- nnvm-json execution ----------------------------------------------------

def _parse_attr(value):
    """MXNet serializes op attrs as strings ("(3, 3)", "64", "True")."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


# legacy / symbol-only op names → registry names (reference aliases that the
# op registry does not carry natively)
_OP_RENAMES = {
    "SoftmaxOutput": "softmax",
    "LinearRegressionOutput": "identity",
    "LogisticRegressionOutput": "sigmoid",
    "MAERegressionOutput": "identity",
    "_copy": "identity",
    "_Plus": "elemwise_add",
    "_plus": "elemwise_add",
    "_mul": "elemwise_mul",
    "_sub": "elemwise_sub",
    "_div": "elemwise_div",
    "Cast": "cast",
    "SliceChannel": "split",
    "Crop": "slice_like",
}

# ops whose trailing label input is dropped at inference
_DROP_LABEL_OPS = {"SoftmaxOutput", "LinearRegressionOutput",
                   "LogisticRegressionOutput", "MAERegressionOutput"}


class _NNVMGraphRunner:
    """Topological executor over a symbol-json graph through the op
    registry (reference ``GraphExecutor::RunOps``): one NDArray op a node,
    label inputs of the output heads dropped (inference)."""

    def __init__(self, graph, input_names):
        self.nodes = graph["nodes"]
        self.heads = [tuple(h[:2]) for h in graph["heads"]]
        self.arg_nodes = set(graph["arg_nodes"])
        self.input_names = list(input_names)
        used = self._used_nodes()
        # the arguments the heads read, inputs aside (a dropped label is
        # not one)
        self.param_names = [
            n["name"] for i, n in enumerate(self.nodes)
            if i in self.arg_nodes and i in used and
            n["name"] not in self.input_names]
        self._plan = None

    def _used_nodes(self):
        """Nodes reachable from the heads after inference-time label
        dropping (unused label args need no binding)."""
        used = set()
        stack = [nid for nid, _ in self.heads]
        while stack:
            nid = stack.pop()
            if nid in used:
                continue
            used.add(nid)
            node = self.nodes[nid]
            entries = node["inputs"]
            if node["op"] in _DROP_LABEL_OPS and len(entries) > 1:
                entries = entries[:1]
            stack.extend(e[0] for e in entries)
        return used

    def _build_plan(self):
        """(nid, name, op or None, attrs, input entries) for every used
        node in order, with attributes parsed and ops resolved once."""
        from ..ops import registry as op_registry

        used = self._used_nodes()
        plan = []
        for nid, node in enumerate(self.nodes):
            if nid not in used:
                continue
            op_name, name = node["op"], node["name"]
            if op_name == "null":
                plan.append((nid, name, None, None, None))
                continue
            attrs = {k: _parse_attr(v) for k, v in
                     (node.get("attrs") or node.get("param") or {}).items()}
            entries = node["inputs"]
            if op_name in _DROP_LABEL_OPS and len(entries) > 1:
                entries = entries[:1]
            # output/loss heads run their inference-mode rename (label was
            # dropped above), never the training op from the registry
            if op_name in _DROP_LABEL_OPS:
                fn = op_registry.get_op(_OP_RENAMES[op_name])
                if op_name == "SoftmaxOutput":
                    # multi_output softmaxes the class axis 1, not the last
                    attrs = {"axis": 1 if attrs.get("multi_output") else -1}
            else:
                fn = op_registry.get_op(op_name) or \
                    op_registry.get_op(_OP_RENAMES.get(op_name, ""))
            if fn is None:
                raise MXNetError(
                    f"op {op_name!r} (node {name!r}) is not implemented in "
                    "the op registry")
            attrs = {k: v for k, v in attrs.items() if not k.startswith("__")}
            plan.append((nid, name, fn, attrs, entries))
        return plan

    def run(self, inputs, params):
        if self._plan is None:
            self._plan = self._build_plan()
        values = {}  # nid -> tuple of outputs
        for nid, name, fn, attrs, entries in self._plan:
            if fn is None:
                if name in inputs:
                    values[nid] = (inputs[name],)
                elif name in params:
                    values[nid] = (params[name],)
                else:
                    raise MXNetError(
                        f"unbound input {name!r} (inputs: "
                        f"{sorted(inputs)}; params not loaded?)")
                continue
            out = fn(*[values[e[0]][e[1]] for e in entries], **attrs)
            values[nid] = tuple(out) if isinstance(out, (tuple, list)) \
                else (out,)
        outs = [values[nid][oidx] for nid, oidx in self.heads]
        return outs[0] if len(outs) == 1 else tuple(outs)


def _import_nnvm(graph, input_names, param_file, ctx):
    from .block import SymbolBlock

    runner = _NNVMGraphRunner(graph, input_names)
    params = _load_params(param_file, ctx.device) if param_file else {}
    block = SymbolBlock(prefix="symbolblock_")

    def fn(F, args, _params):
        inputs = dict(zip(runner.input_names, args))
        with ag.predict_mode():
            return runner.run(inputs, params)

    block._fn = fn
    return block


def symbol_block_fn(block, outputs, inputs, params):
    """Bind ``SymbolBlock(outputs, inputs, params)``: ``outputs`` a
    ``Symbol``, ``inputs`` its input variable(s), ``params`` a
    ``ParameterDict`` or ``{name: NDArray}`` of the other arguments and
    auxiliary states, registered as the block's parameters."""
    from ..symbol import Symbol
    from .parameter import Parameter

    if isinstance(inputs, Symbol):
        inputs = list(inputs) if len(inputs) > 1 else [inputs]
    input_names = [s.name for s in inputs]
    runner = _NNVMGraphRunner(json.loads(outputs.tojson()), input_names)
    aux = set(outputs.list_auxiliary_states())
    given = {} if params is None else dict(params.items())
    for name in runner.param_names:
        p = Parameter(name, grad_req="null" if name in aux else "write",
                      allow_deferred_init=True)
        value = given.get(name)
        if value is not None:
            value = value.data() if isinstance(value, Parameter) else value
            p.shape = value.shape
            p.dtype = value.dtype
            p.initialize(ctx=value.context)
            p.set_data(value)
        block._reg_params[name] = p
        block.params._params[name] = p

    def fn(F, args, param_values):
        return runner.run(dict(zip(input_names, args)), param_values)

    return fn
