"""Network visualization: ``print_summary`` and ``plot_network``.

Counterpart of ``mxnet_tpu/visualization.py`` (reference
``python/mxnet/visualization.py``) over the port's ``symbol`` graph: the
layer table (name and op, output shape from ``infer_shape``, parameter
count, previous layers) and the graph as DOT source text (the graphviz
Python package is not a dependency; any ``dot`` renders the text).  Both
print and return what the reference's do for the same graph.
"""
from __future__ import annotations

from .base import MXNetError


def _topo_nodes(symbol):
    return symbol._topo()


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print a layer table for a Symbol (reference
    ``mx.viz.print_summary``).  ``shape``: dict of input name → shape for
    output-shape inference."""
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        onames = internals.list_outputs()
        _, int_shapes, _ = internals.infer_shape(**shape)
        shapes = dict(zip(onames, int_shapes))
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(f, pos):
        line = ""
        for i, field in enumerate(f):
            line += str(field)
            line = line[:pos[i]]
            line += " " * (pos[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(fields, positions)
    print("=" * line_length)
    total_params = 0
    for node in _topo_nodes(symbol):
        if node.op == "null" and not node.inputs:
            continue
        name = node.name
        out_shape = shapes.get(f"{name}_output", shapes.get(name, ""))
        nparams = 0
        for inp, _ in node.inputs:
            # param inputs by naming convention (same heuristic the
            # reference uses to split weights from data inputs)
            if inp.op == "null" and inp.name.endswith(
                    ("_weight", "_bias", "_gamma", "_beta", "_moving_mean",
                     "_moving_var")):
                s = shapes.get(inp.name)
                if s:
                    p = 1
                    for d in s:
                        p *= d
                    nparams += p
        total_params += nparams
        prev = ",".join(i.name for i, _ in node.inputs)[:40]
        print_row([f"{name} ({node.op})", str(out_shape), str(nparams),
                   prev], positions)
        print("_" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)
    return total_params


_NODE_STYLE = {
    "Convolution": "fillcolor=\"#fb8072\"",
    "FullyConnected": "fillcolor=\"#fb8072\"",
    "BatchNorm": "fillcolor=\"#bebada\"",
    "Activation": "fillcolor=\"#ffffb3\"",
    "Pooling": "fillcolor=\"#80b1d3\"",
    "Concat": "fillcolor=\"#fdb462\"",
}


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Build DOT source for the symbol graph (reference
    ``mx.viz.plot_network`` returns a graphviz Digraph; here the DOT text
    itself — write it to a file and render with ``dot -Tpdf``)."""
    lines = [f'digraph "{title}" {{',
             '  node [shape=box, style=filled, fillcolor="#8dd3c7"];']
    hidden = set()
    if hide_weights:
        for node in _topo_nodes(symbol):
            for inp, _ in node.inputs:
                if inp.op == "null" and (
                        inp.name.endswith(("_weight", "_bias", "_gamma",
                                           "_beta", "_moving_mean",
                                           "_moving_var"))):
                    hidden.add(inp.name)
    for node in _topo_nodes(symbol):
        if node.name in hidden:
            continue
        style = _NODE_STYLE.get(node.op, "")
        label = node.name if node.op == "null" else \
            f"{node.name}\\n{node.op}"
        lines.append(f'  "{node.name}" [label="{label}"'
                     f'{", " + style if style else ""}];')
        for inp, _ in node.inputs:
            if inp.name in hidden:
                continue
            lines.append(f'  "{inp.name}" -> "{node.name}";')
    lines.append("}")
    return "\n".join(lines)
