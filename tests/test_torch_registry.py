"""The op registry of the port (``mxnet_tpu_torch/ops/registry.py``)
against the JAX package's: the same 342 names, the same canonical names,
aliases and ``no_grad`` flags, each name resolving to the port's NDArray
op (one function, no second copy), and the rest of the reference's
registry API working on NDArrays or raising ``MXNetError`` by name."""
import numpy as np
import pytest

import mxnet_tpu as jmx  # noqa: F401  (registers the reference's ops)
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

CPU = tmx.cpu()


def test_list_ops_equals_the_reference():
    assert treg.list_ops() == jreg.list_ops()
    assert len(treg.list_ops()) == 342
    assert treg.duplicate_registrations() == []


@pytest.mark.parametrize("key", ["no_grad", "canonical", "aliases"])
def test_op_meta_agrees_for_every_name(key):
    diff = {n: (treg.op_meta(n).get(key), jreg.op_meta(n).get(key))
            for n in jreg.list_ops()
            if treg.op_meta(n).get(key) != jreg.op_meta(n).get(key)}
    assert diff == {}
    assert treg.op_meta("no_such_op") == {} == jreg.op_meta("no_such_op")


def test_every_name_is_the_ports_ndarray_op():
    nd = tmx.nd
    for name in treg.list_ops():
        fn = treg.get_op(name)
        assert callable(fn), name
        canon = treg.op_meta(name)["canonical"]
        assert fn is treg.get_op(canon), name
        # the registered function is the one the namespaces export
        public = getattr(nd, name, None) or getattr(nd.contrib, name, None)
        if public is not None:
            assert public is fn, name
    assert treg.get_op("no_such_op") is None


def test_contrib_spellings_of_the_attention_ops():
    x = np.random.RandomState(0).rand(4, 2, 12).astype(np.float32)
    for name in ("_contrib_div_sqrt_dim",
                 "_contrib_interleaved_matmul_selfatt_qk"):
        kw = {} if "div" in name else {"heads": 2}
        got = treg.get_op(name)(tmx.nd.array(x, ctx=CPU), **kw)
        ref = jreg.get_op(name)(jmx.nd.array(x), **kw)
        np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(),
                                   rtol=1e-6, atol=1e-7)


def test_defop_make_exporter_wrap_raw_commit_out_accum_dtype():
    import types

    @treg.defop("_probe_op_a", aliases=("_probe_op_b",), no_grad=True)
    def probe(data):
        return data * 2

    try:
        assert treg.get_op("_probe_op_b") is probe
        assert treg.op_meta("_probe_op_a") == {
            "no_grad": True, "canonical": "_probe_op_a",
            "aliases": ("_probe_op_b",)}
        mod = types.ModuleType("probe_mod")
        export = treg.make_exporter(mod)

        def probe_c(data):
            return data + 1

        export(probe_c, "_probe_op_c")
        assert mod.__all__ == ["_probe_op_c"] and mod._probe_op_c is probe_c
        assert treg.get_op("_probe_op_c") is probe_c
    finally:
        for n in ("_probe_op_a", "_probe_op_b", "_probe_op_c"):
            treg._OPS.pop(n, None)
            treg._OP_META.pop(n, None)
    assert treg.list_ops() == jreg.list_ops()
    import torch

    a = treg.wrap_raw(torch.ones(2))
    assert isinstance(a, tmx.nd.NDArray)
    out = tmx.nd.zeros((2,), ctx=CPU)
    assert treg.commit_out(out, a + 1) is out
    np.testing.assert_array_equal(out.asnumpy(), [2.0, 2.0])
    assert treg.commit_out(None, a) is a
    for dt in ("bfloat16", "float16", "float32", "int32"):
        assert treg.accum_dtype(dt) == jreg.accum_dtype(dt), dt


@pytest.mark.parametrize("name", ["current_dispatch_platform",
                                  "dispatch_platform", "platform_of_raw",
                                  "platform_of_raws"])
def test_jax_platform_helpers_raise_not_carried_over(name):
    with pytest.raises(tmx.MXNetError, match="Not carried over"):
        getattr(treg, name)(None)
