"""Standalone inference predictor — the C predict API, in Python.

Counterpart of ``mxnet_tpu/predictor.py`` (reference
``src/c_api/c_predict_api.cc``: ``MXPredCreate(symbol_json, param_bytes,
dev, input_shapes)`` → ``MXPredSetInput`` → ``MXPredForward`` →
``MXPredGetOutput``).  The predictor binds either serving format:

- a ``HybridBlock.export`` artifact (symbol-json meta, ``torch.export``
  program, params): the program runs with the hand-written kernels as its
  custom-op nodes;
- an nnvm symbol-json and ``.params`` checkpoint (``save_checkpoint`` of
  a ``Symbol``, here or in the reference): replayed node by node through
  the op registry.

The bound block is hybridized: on the card each input signature is
captured once into a CUDA graph and replayed (the bind-once contract),
and inputs are staged on the predictor's context (default: the current
one).  A reference StableHLO artifact is a JAX program: ``stablehlo=``
and such a meta file raise naming "Not carried over".
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from . import ndarray as nd
from .base import MXNetError
from .context import current_context
from .ndarray.ndarray import NDArray

__all__ = ["Predictor", "create"]


class Predictor:
    """Bound inference session (reference ``MXPredCreate``).

    Parameters
    ----------
    symbol : str | dict
        Path to a ``*-symbol.json`` file, a JSON string, or the parsed
        dict.
    params : str | bytes
        Path to a ``.params`` file or its raw bytes.
    input_names : list of str, optional
        Graph input names.  Defaults to ``input_shapes`` keys, the
        export-time metadata (programs), or the symbol args not present
        in ``params`` (nnvm graphs).
    input_shapes : dict, optional
        name → shape; used only to infer ``input_names`` and to validate
        ``set_input``.
    program : str | bytes, optional
        The ``.pt2`` program of an export when ``symbol`` is passed as a
        dict or JSON string (no directory to resolve the meta's
        ``program_file`` against): its path or its raw bytes.
    """

    def __init__(self, symbol, params, ctx=None, input_names=None,
                 input_shapes=None, program=None, stablehlo=None):
        from .gluon.symbol_block import import_block, load_symbol_json

        if stablehlo is not None:
            raise MXNetError(
                "Predictor(stablehlo=...): a StableHLO program is a JAX "
                "program with no counterpart in the port (ROADMAP.md, Not "
                "carried over); pass the port's export as program=")
        self._tmpdir = None
        self._ctx = ctx or current_context()
        symbol_file = self._materialize_symbol(symbol)
        param_file = self._materialize_params(params)
        meta = load_symbol_json(symbol_file)
        if "program_file" in meta:
            symbol_file = self._resolve_program(symbol_file, meta, program)
            meta = load_symbol_json(symbol_file)
        self._input_shapes = dict(input_shapes or {})
        if input_names is None:
            if self._input_shapes:
                input_names = list(self._input_shapes)
            elif "input_names" in meta:
                input_names = list(meta["input_names"])
            elif "nodes" in meta:
                input_names = self._infer_inputs_from_graph(meta, param_file)
            elif "input_shapes" in meta:
                # an export: positional inputs, the reference's default
                # data names
                n = len(meta["input_shapes"])
                input_names = ["data"] if n == 1 else \
                    [f"data{i}" for i in range(n)]
            else:
                raise MXNetError(
                    "cannot infer input names; pass input_names or "
                    "input_shapes")
        elif isinstance(input_names, str):
            input_names = [input_names]
        self._input_names = list(input_names)
        self._block = import_block(symbol_file, self._input_names,
                                   param_file, ctx=self._ctx)
        self._block.hybridize(static_alloc=True)
        self._inputs = {}
        self._outputs = None

    # -- input materialisation ------------------------------------------------
    def _tmp(self):
        if self._tmpdir is None:
            import shutil
            import weakref

            self._tmpdir = tempfile.mkdtemp(prefix="mxt_pred_")
            # params copies can be GB-scale; reclaim on GC
            weakref.finalize(self, shutil.rmtree, self._tmpdir,
                             ignore_errors=True)
        return self._tmpdir

    def _resolve_program(self, symbol_file, meta, program):
        """Make ``program_file`` resolvable from the symbol file's dir —
        materializing bytes or rewriting to an absolute path.  Returns the
        symbol file to bind (a tmpdir copy when a rewrite is needed; the
        caller's file is never modified)."""
        ref = meta["program_file"]
        if isinstance(program, (bytes, bytearray)):
            path = os.path.join(self._tmp(), "model.pt2")
            with open(path, "wb") as f:
                f.write(program)
        elif program is not None:
            path = os.path.abspath(program)
        else:
            candidate = os.path.join(
                os.path.dirname(os.path.abspath(symbol_file)), ref)
            if os.path.exists(candidate):
                return symbol_file  # file-based layout resolves as-is
            raise MXNetError(
                f"program {ref!r} not found next to the symbol meta; pass "
                "program=<path or bytes> when creating the Predictor from "
                "a symbol dict or JSON string")
        patched = os.path.join(self._tmp(), "model-symbol.json")
        with open(patched, "w") as f:
            json.dump(dict(meta, program_file=path), f)
        return patched

    def _materialize_symbol(self, symbol):
        if isinstance(symbol, dict):
            path = os.path.join(self._tmp(), "model-symbol.json")
            with open(path, "w") as f:
                json.dump(symbol, f)
            return path
        if isinstance(symbol, str) and not os.path.exists(symbol):
            # JSON text (reference MXPredCreate takes the json STRING)
            try:
                json.loads(symbol)
            except json.JSONDecodeError:
                raise MXNetError(
                    f"symbol is neither an existing file nor JSON: "
                    f"{symbol[:80]!r}")
            path = os.path.join(self._tmp(), "model-symbol.json")
            with open(path, "w") as f:
                f.write(symbol)
            return path
        return symbol

    def _materialize_params(self, params):
        if isinstance(params, (bytes, bytearray)):
            path = os.path.join(self._tmp(), "model.params")
            with open(path, "wb") as f:
                f.write(params)
            return path
        return params

    @staticmethod
    def _infer_inputs_from_graph(meta, param_file):
        from . import serialization

        saved = set()
        if param_file is not None:
            saved = {k.split(":", 1)[-1]
                     for k in serialization.load_ndarrays(param_file)}
        nodes = meta["nodes"]
        names = [nodes[i]["name"] for i in meta["arg_nodes"]
                 if nodes[i]["name"] not in saved]
        if not names:
            raise MXNetError("no unbound args found to use as inputs")
        return names

    # -- the MXPred* surface --------------------------------------------------
    @property
    def input_names(self):
        return list(self._input_names)

    def set_input(self, name, array):
        """``MXPredSetInput``: stage one named input on the predictor's
        context."""
        if name not in self._input_names:
            raise MXNetError(
                f"unknown input {name!r}; expected one of "
                f"{self._input_names}")
        if isinstance(array, NDArray):
            array = array.as_in_context(self._ctx)
        else:
            array = nd.array(np.asarray(array), ctx=self._ctx)
        want = self._input_shapes.get(name)
        if want is not None and tuple(array.shape) != tuple(want):
            raise MXNetError(
                f"input {name!r} has shape {tuple(array.shape)}, "
                f"bound to {tuple(want)}; use reshape()")
        self._inputs[name] = array

    def reshape(self, new_input_shapes):
        """``MXPredReshape``: rebind to new input shapes (a new signature
        is captured at its first forward; earlier ones stay cached)."""
        self._input_shapes.update(new_input_shapes)
        self._inputs.clear()
        self._outputs = None

    def forward(self, **inputs):
        """``MXPredForward``: run the bound graph on the staged (or
        keyword-passed) inputs."""
        from . import autograd

        for k, v in inputs.items():
            self.set_input(k, v)
        missing = [n for n in self._input_names if n not in self._inputs]
        if missing:
            raise MXNetError(f"inputs not set: {missing}")
        args = [self._inputs[n] for n in self._input_names]
        with autograd.pause():
            out = self._block(*args)
        self._outputs = list(out) if isinstance(out, (list, tuple)) \
            else [out]
        return self._outputs

    # -- compile-cache observability ------------------------------------------
    def cache_stats(self):
        """Per-signature graph-cache counters of the bound block:
        ``{"hits", "misses", "signatures"}`` (one miss = one capture of a
        new input signature; all zero before the first forward)."""
        stats = self._block.cache_stats()
        return {k: stats[k] for k in ("hits", "misses", "signatures")}

    def get_output(self, index=0):
        """``MXPredGetOutput``."""
        if self._outputs is None:
            raise MXNetError("call forward() before get_output()")
        if not 0 <= index < len(self._outputs):
            raise MXNetError(
                f"output index {index} out of range "
                f"({len(self._outputs)} outputs)")
        return self._outputs[index]

    @property
    def num_outputs(self):
        if self._outputs is None:
            raise MXNetError("call forward() before num_outputs")
        return len(self._outputs)

    def predict(self, data):
        """Convenience: single-input forward → first output."""
        self.forward(**{self._input_names[0]: data})
        return self.get_output(0)


def create(symbol, params, ctx=None, input_names=None, input_shapes=None,
           program=None, stablehlo=None):
    """``MXPredCreate`` analog."""
    return Predictor(symbol, params, ctx=ctx, input_names=input_names,
                     input_shapes=input_shapes, program=program,
                     stablehlo=stablehlo)
