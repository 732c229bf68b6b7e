"""ONNX ModelProto → Symbol graph importer (onnx2mx).

Counterpart of ``mxnet_tpu/contrib/onnx/onnx2mx.py`` (reference
``python/mxnet/contrib/onnx/onnx2mx/import_model.py`` and
``import_onnx.py``) — walks GraphProto nodes, translating
each ONNX op to symbol calls and initializers to arg/aux params.  The
reference depends on the ``onnx`` python package; here the bundled
wire-format decoder (``_proto.parse``) reads ModelProto directly, so
import works with no external dependency — mirroring the exporter.

Supported op set = the exporter's (CNN/MLP: Conv, Gemm, BatchNorm, pools,
activations, Softmax/LogSoftmax, Concat, Flatten, Reshape, elementwise,
Dropout/Identity) — enough for round-trip plus simple external models.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from . import _proto as P

__all__ = ["import_model"]


# --- proto readers ----------------------------------------------------------

def _s64(v):
    """Protobuf int64 varints are two's-complement; sign-extend."""
    v = int(v)
    return v - (1 << 64) if v >= (1 << 63) else v


def _ints(parsed, number):
    """Repeated int field: both packed (wire 2) and unpacked (wire 0)."""
    out = []
    for f, w, v in parsed:
        if f != number:
            continue
        if w == 0:
            out.append(_s64(v))
        elif w == 2:
            i = 0
            while i < len(v):
                x, i = P._read_varint(v, i)
                out.append(_s64(x))
    return out


_DT2NP = {P.FLOAT: np.float32, P.DOUBLE: np.float64, P.INT64: np.int64,
          P.INT32: np.int32, P.INT8: np.int8, P.UINT8: np.uint8,
          P.FLOAT16: np.float16, P.BOOL: np.bool_}


def _read_tensor(buf):
    """TensorProto → (name, np.ndarray)."""
    parsed = P.parse(buf)
    dims = _ints(parsed, 1)
    (dtype,) = _ints(parsed, 2) or [P.FLOAT]
    name = b"".join(P.fields(parsed, 8)).decode("utf-8")
    np_dt = _DT2NP.get(dtype)
    if np_dt is None:
        raise MXNetError(f"ONNX import: unsupported tensor dtype {dtype}")
    raw = b"".join(P.fields(parsed, 9))
    if raw:
        arr = np.frombuffer(raw, dtype=np_dt).reshape(dims)
    elif dtype == P.FLOAT:
        vals = []
        for f, w, v in parsed:
            if f != 4:
                continue
            data = v if w == 2 else np.uint32(v).tobytes()
            vals.append(np.frombuffer(data, dtype=np.float32))
        arr = (np.concatenate(vals) if vals
               else np.zeros(0, np.float32)).reshape(dims)
    elif dtype == P.INT64:
        arr = np.asarray(_ints(parsed, 7), np.int64).reshape(dims)
    elif dtype in (P.INT32, P.INT8, P.UINT8, P.BOOL):
        arr = np.asarray(_ints(parsed, 5), np.int64).astype(np_dt) \
            .reshape(dims)
    else:
        raise MXNetError(
            f"ONNX import: tensor {name!r} has no raw_data and dtype "
            f"{dtype} typed-data decoding is not supported")
    return name, np.array(arr)  # copy: frombuffer views are read-only


def _read_value_info(buf):
    """ValueInfoProto → (name, shape-or-None)."""
    parsed = P.parse(buf)
    name = b"".join(P.fields(parsed, 1)).decode("utf-8")
    shape = None
    types = P.fields(parsed, 2)
    if types:
        tparsed = P.parse(types[0])
        tens = P.fields(tparsed, 1)  # TypeProto.tensor_type
        if tens:
            tt = P.parse(tens[0])
            shapes = P.fields(tt, 2)
            if shapes:
                dims = []
                for dbuf in P.fields(P.parse(shapes[0]), 1):
                    dv = _ints(P.parse(dbuf), 1)
                    dims.append(int(dv[0]) if dv else 0)
                shape = tuple(dims)
    return name, shape


def _read_attr(buf):
    """AttributeProto → (name, python value)."""
    parsed = P.parse(buf)
    name = b"".join(P.fields(parsed, 1)).decode("utf-8")
    atype = (_ints(parsed, 20) or [0])[0]
    if atype == P.ATTR_FLOAT:
        import struct

        (v,) = P.fields(parsed, 2) or [0]
        return name, struct.unpack("<f", np.uint32(v).tobytes())[0]
    if atype == P.ATTR_INT:
        return name, (_ints(parsed, 3) or [0])[0]
    if atype == P.ATTR_STRING:
        return name, b"".join(P.fields(parsed, 4)).decode("utf-8")
    if atype == P.ATTR_INTS:
        return name, _ints(parsed, 8)
    if atype == P.ATTR_TENSOR:
        ts = P.fields(parsed, 5)
        return name, _read_tensor(ts[0])[1] if ts else None
    if atype == P.ATTR_FLOATS:
        vals = []
        for f, w, v in parsed:
            if f == 7:
                data = v if w == 2 else np.uint32(v).tobytes()
                vals.append(np.frombuffer(data, dtype=np.float32))
        return name, list(np.concatenate(vals)) if vals else []
    return name, None


def _read_node(buf):
    parsed = P.parse(buf)
    return {
        "inputs": [b.decode("utf-8") for b in P.fields(parsed, 1)],
        "outputs": [b.decode("utf-8") for b in P.fields(parsed, 2)],
        "name": b"".join(P.fields(parsed, 3)).decode("utf-8"),
        "op_type": b"".join(P.fields(parsed, 4)).decode("utf-8"),
        "attrs": dict(_read_attr(a) for a in P.fields(parsed, 5)),
    }


# --- op translations (ONNX → symbol calls) ----------------------------------

def _sym_pads(attrs, what):
    pads = attrs.get("pads")
    if not pads:
        return None
    n = len(pads) // 2
    begin, end = tuple(pads[:n]), tuple(pads[n:])
    if begin != end:
        raise MXNetError(
            f"ONNX import: asymmetric pads {pads} on {what} not supported")
    return begin


def _conv(sym, node, ins, params):
    w = params.get(node["inputs"][1])
    if w is None:
        raise MXNetError("ONNX import: Conv weight must be an initializer")
    a = node["attrs"]
    kw = dict(kernel=tuple(a.get("kernel_shape", w.shape[2:])),
              num_filter=int(w.shape[0]),
              num_group=int(a.get("group", 1)),
              no_bias=len(ins) < 3)
    if a.get("strides"):
        kw["stride"] = tuple(a["strides"])
    if a.get("dilations"):
        kw["dilate"] = tuple(a["dilations"])
    pad = _sym_pads(a, "Conv")
    if pad:
        kw["pad"] = pad
    return sym.Convolution(*ins[:3], name=node["outputs"][0], **kw)


def _gemm(sym, node, ins, params):
    a = node["attrs"]
    if float(a.get("alpha", 1.0)) != 1.0:
        raise MXNetError("ONNX import: Gemm alpha != 1 unsupported")
    if int(a.get("transA", 0)):
        raise MXNetError("ONNX import: Gemm transA=1 unsupported")
    w = params.get(node["inputs"][1])
    if w is None:
        raise MXNetError("ONNX import: Gemm weight must be an initializer")
    if not int(a.get("transB", 0)):
        params[node["inputs"][1]] = w = np.ascontiguousarray(w.T)
    beta = float(a.get("beta", 1.0))
    use_bias = len(ins) >= 3 and beta != 0.0
    if use_bias and beta != 1.0:
        raise MXNetError("ONNX import: Gemm beta not in (0, 1) unsupported")
    return sym.FullyConnected(*ins[:3 if use_bias else 2],
                              num_hidden=int(w.shape[0]),
                              flatten=False, no_bias=not use_bias,
                              name=node["outputs"][0])


def _pool(pool_type, global_pool=False):
    def f(sym, node, ins, params):
        a = node["attrs"]
        kw = dict(pool_type=pool_type, name=node["outputs"][0])
        if global_pool:
            kw["global_pool"] = True
            kw["kernel"] = (1, 1)
        else:
            kw["kernel"] = tuple(a["kernel_shape"])
            if a.get("strides"):
                kw["stride"] = tuple(a["strides"])
            pad = _sym_pads(a, "Pool")
            if pad:
                kw["pad"] = pad
        return sym.Pooling(ins[0], **kw)
    return f


def _bn(sym, node, ins, params):
    a = node["attrs"]
    return sym.BatchNorm(*ins[:5], eps=float(a.get("epsilon", 1e-5)),
                         momentum=float(a.get("momentum", 0.9)),
                         fix_gamma=False, name=node["outputs"][0])


def _act(op):
    def f(sym, node, ins, params):
        return getattr(sym, op)(ins[0], name=node["outputs"][0])
    return f


def _softmax(op):
    def f(sym, node, ins, params):
        axis = int(node["attrs"].get("axis", -1))
        return getattr(sym, op)(ins[0], axis=axis, name=node["outputs"][0])
    return f


def _binop(op):
    def f(sym, node, ins, params):
        return getattr(sym, op)(ins[0], ins[1], name=node["outputs"][0])
    return f


def _concat(sym, node, ins, params):
    return sym.concat(*ins, dim=int(node["attrs"].get("axis", 1)),
                      name=node["outputs"][0])


def _flatten(sym, node, ins, params):
    if int(node["attrs"].get("axis", 1)) != 1:
        raise MXNetError("ONNX import: Flatten axis != 1 unsupported")
    return sym.Flatten(ins[0], name=node["outputs"][0])


def _reshape(sym, node, ins, params):
    shape = params.get(node["inputs"][1])
    if shape is None:
        raise MXNetError(
            "ONNX import: Reshape shape must be an initializer")
    return sym.Reshape(ins[0], shape=tuple(int(s) for s in shape),
                       name=node["outputs"][0])


def _identity(sym, node, ins, params):
    return sym.identity(ins[0], name=node["outputs"][0])


# --- NLP subset (round 4) ----------------------------------------------------

_ONNX2DT = {P.FLOAT: "float32", P.INT64: "int64", 6: "int32",
            10: "float16", 11: "float64"}  # BOOL handled in _cast


def _matmul(sym, node, ins, params):
    # transformer use is batched rank>=3; batch_dot broadcasts leading
    # dims (2-D standalone MatMul exports arrive as Gemm instead)
    return sym.batch_dot(ins[0], ins[1], name=node["outputs"][0])


def _transpose_imp(sym, node, ins, params):
    perm = node["attrs"].get("perm")
    kw = {} if perm is None else {"axes": tuple(int(p) for p in perm)}
    return sym.transpose(ins[0], name=node["outputs"][0], **kw)


def _gather(sym, node, ins, params):
    axis = int(node["attrs"].get("axis", 0))
    return sym.take(ins[0], ins[1], axis=axis,
                    name=node["outputs"][0])


def _cast(sym, node, ins, params):
    to = int(node["attrs"].get("to", P.FLOAT))
    if to == P.BOOL:
        # bool semantics = (x != 0) collapsed to 0/1, NOT a
        # value-preserving cast (a later Cast-to-float of a real bool
        # yields 1.0, never the original magnitude)
        return sym.sign(sym.abs(ins[0]), name=node["outputs"][0])
    dt = _ONNX2DT.get(to)
    if dt is None:
        raise MXNetError(f"ONNX import: Cast to={to} unsupported")
    return sym.cast(ins[0], dtype=dt, name=node["outputs"][0])


def _leaky(sym, node, ins, params):
    return sym.LeakyReLU(ins[0],
                         slope=float(node["attrs"].get("alpha", 0.01)),
                         name=node["outputs"][0])


def _elu(sym, node, ins, params):
    return sym.LeakyReLU(ins[0], act_type="elu",
                         slope=float(node["attrs"].get("alpha", 1.0)),
                         name=node["outputs"][0])


def _reduce_mean(sym, node, ins, params):
    axes = node["attrs"].get("axes")
    kw = {"keepdims": bool(int(node["attrs"].get("keepdims", 1)))}
    if axes is not None:
        kw["axis"] = tuple(int(a) for a in axes)
    return sym.mean(ins[0], name=node["outputs"][0], **kw)


def _slice_imp(sym, node, ins, params):
    def arr(i):
        v = params.get(node["inputs"][i])
        if v is None:
            raise MXNetError(
                "ONNX import: Slice indices must be initializers")
        return [int(x) for x in np.asarray(v).ravel()]

    starts, ends = arr(1), arr(2)
    axes = arr(3) if len(node["inputs"]) > 3 else \
        list(range(len(starts)))
    if len(node["inputs"]) > 4:
        steps = arr(4)
        if any(s != 1 for s in steps):
            raise MXNetError(
                f"ONNX import: strided Slice (steps={steps}) "
                "unsupported (subset)")
    if len(starts) != 1:
        raise MXNetError(
            "ONNX import: multi-axis Slice unsupported (subset)")
    end = None if ends[0] >= 2 ** 31 else ends[0]
    return sym.slice_axis(ins[0], axis=axes[0], begin=starts[0],
                          end=end, name=node["outputs"][0])


def _unsqueeze(sym, node, ins, params):
    axes = params.get(node["inputs"][1])
    if axes is None:
        raise MXNetError(
            "ONNX import: Unsqueeze axes must be an initializer")
    axes = [int(a) for a in np.asarray(axes).ravel()]
    if len(axes) != 1:
        raise MXNetError("ONNX import: multi-axis Unsqueeze unsupported")
    return sym.expand_dims(ins[0], axis=axes[0],
                           name=node["outputs"][0])


def _where_imp(sym, node, ins, params):
    return sym.where(ins[0], ins[1], ins[2], name=node["outputs"][0])


def _clip_imp(sym, node, ins, params):
    def scalar(i):
        if len(node["inputs"]) <= i or not node["inputs"][i]:
            return None  # genuinely absent optional bound
        v = params.get(node["inputs"][i])
        if v is None:
            raise MXNetError(
                "ONNX import: Clip bounds must be initializers "
                "(computed min/max unsupported in the subset)")
        return float(np.asarray(v).ravel()[0])

    lo, hi = scalar(1), scalar(2)
    if lo is None and hi is None:
        return sym.identity(ins[0], name=node["outputs"][0])
    # absent single bound: exact float32 extreme, so legitimate values up
    # to f32 max pass through unclipped
    f32max = float(np.finfo(np.float32).max)
    return sym.clip(ins[0],
                    a_min=-f32max if lo is None else lo,
                    a_max=f32max if hi is None else hi,
                    name=node["outputs"][0])


# inputs consumed as attributes (constants) per op: {op: input indices}
_ATTR_ONLY_INPUTS = {"Reshape": (1,), "Slice": (1, 2, 3, 4),
                     "Unsqueeze": (1,), "Clip": (1, 2)}


_IMPORTS = {
    "Conv": _conv,
    "Gemm": _gemm,
    "BatchNormalization": _bn,
    "MaxPool": _pool("max"),
    "AveragePool": _pool("avg"),
    "GlobalMaxPool": _pool("max", global_pool=True),
    "GlobalAveragePool": _pool("avg", global_pool=True),
    "Relu": _act("relu"),
    "Sigmoid": _act("sigmoid"),
    "Tanh": _act("tanh"),
    "Exp": _act("exp"),
    "Log": _act("log"),
    "Sqrt": _act("sqrt"),
    "Softplus": _act("softrelu"),
    "Softmax": _softmax("softmax"),
    "LogSoftmax": _softmax("log_softmax"),
    "Concat": _concat,
    "Flatten": _flatten,
    "Reshape": _reshape,
    "Dropout": _identity,
    "Identity": _identity,
    "Add": _binop("broadcast_add"),
    "Mul": _binop("broadcast_mul"),
    "Sub": _binop("broadcast_sub"),
    "Div": _binop("broadcast_div"),
    # NLP subset (round 4)
    "MatMul": _matmul,
    "Transpose": _transpose_imp,
    "Gather": _gather,
    "Cast": _cast,
    "Erf": _act("erf"),
    "LeakyRelu": _leaky,
    "Elu": _elu,
    "ReduceMean": _reduce_mean,
    "Slice": _slice_imp,
    "Unsqueeze": _unsqueeze,
    "Where": _where_imp,
    "Pow": _binop("broadcast_power"),
    "Max": _binop("broadcast_maximum"),
    "Min": _binop("broadcast_minimum"),
    "Clip": _clip_imp,
}


def import_model(model_file):
    """Reference ``mx.contrib.onnx.import_model``: ONNX file →
    ``(sym, arg_params, aux_params)``."""
    from ... import ndarray as nd
    from ... import symbol as sym_mod

    with open(model_file, "rb") as f:
        model = P.parse(f.read())
    graphs = P.fields(model, 7)
    if not graphs:
        raise MXNetError(f"{model_file!r} has no GraphProto")
    g = P.parse(graphs[0])

    params = {}
    for t in P.fields(g, 5):
        name, arr = _read_tensor(t)
        params[name] = arr
    inputs = [_read_value_info(v) for v in P.fields(g, 11)]
    outputs = [_read_value_info(v) for v in P.fields(g, 12)]
    nodes = [_read_node(n) for n in P.fields(g, 1)]

    tensors = {}
    for name, _shape in inputs:
        if name not in params:
            tensors[name] = sym_mod.Variable(name)
    aux_names = set()
    for node in nodes:
        op = node["op_type"]
        if op == "Constant":
            # value feeds downstream as an initializer-like tensor
            val = node["attrs"].get("value")
            if val is None:
                raise MXNetError("ONNX import: Constant without value")
            params[node["outputs"][0]] = np.asarray(val)
            continue
        trans = _IMPORTS.get(op)
        if trans is None:
            raise MXNetError(
                f"ONNX import: op {op!r} has no translation "
                f"(supported: {sorted(_IMPORTS)})")
        if op == "BatchNormalization":
            aux_names.update(node["inputs"][3:5])
        ins = []
        # consumed-as-attribute inputs (Reshape shape, Slice/Unsqueeze
        # indices) stay out of the symbol graph
        attr_only = {node["inputs"][i]
                     for i in _ATTR_ONLY_INPUTS.get(op, ())
                     if i < len(node["inputs"])}
        for iname in node["inputs"]:
            if iname in attr_only:
                continue
            if iname not in tensors:
                if iname in params:
                    # BatchNorm's statistics are auxiliary states (the
                    # reference makes them arguments, so a bound graph
                    # never reads its aux_params)
                    tensors[iname] = sym_mod.Variable(
                        iname, __is_aux__=True) if iname in aux_names \
                        else sym_mod.Variable(iname)
                else:
                    raise MXNetError(
                        f"ONNX import: undefined tensor {iname!r}")
            ins.append(tensors[iname])
        result = trans(sym_mod, node, ins, params)
        outs = result if isinstance(result, (list, tuple)) else [result]
        for oname, o in zip(node["outputs"], outs):
            tensors[oname] = o

    heads = []
    for name, _shape in outputs:
        if name not in tensors:
            if name in params:
                # graph output refers straight to an initializer
                # (Identity-folded models): surface it as a bound variable
                tensors[name] = sym_mod.Variable(name)
            else:
                raise MXNetError(
                    f"ONNX import: graph output {name!r} refers to an "
                    "undefined tensor")
        heads.append(tensors[name])
    sym = heads[0] if len(heads) == 1 else sym_mod.Group(heads)
    # only tensors that actually became graph Variables are parameters:
    # attribute-consumed inputs (Reshape shapes, Slice/Clip bounds) and
    # folded Constants must NOT surface as bindable params — they'd trip
    # Module.set_params(allow_extra=False) as unexpected keys
    used = set(sym.list_arguments()) | set(
        sym.list_auxiliary_states())
    arg_params = {k: nd.array(np.asarray(v)) for k, v in params.items()
                  if k in used and k not in aux_names}
    aux_params = {k: nd.array(np.asarray(params[k])) for k in aux_names
                  if k in params}
    return sym, arg_params, aux_params
