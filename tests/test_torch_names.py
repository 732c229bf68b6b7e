"""Public names of the port against the JAX package: the names ROADMAP
Queue 3 open fault 1 found missing, each held to the reference, and a pin
of the whole name set.

The pin compares the public names of ``mx``, ``nd``, ``NDArray``,
``gluon``, ``Block``, ``HybridBlock``, ``Parameter``, ``ParameterDict``,
``Trainer``, ``KVStore``, ``init``, ``random``, ``parallel``,
``contrib``, ``gluon.rnn``, ``gluon.model_zoo``,
``gluon.model_zoo.detection``, ``nd.contrib``, ``image``, ``models``,
``serving``, ``engine``, ``autograd``, ``profiler``, ``base``,
``nd.sparse``, ``io``, ``sym``, ``mod``, ``executor``, ``model``,
``predictor``, ``contrib.onnx``, ``contrib.quantization``,
``ops.registry``, ``ops``, ``kvstore``, ``checkpoint`` and slice 18's
``np``, ``np.random``, ``np.linalg``, ``npx``, ``operator``, ``rtc``,
``gluon.contrib`` (with ``.nn`` and ``.estimator``), ``util``,
``runtime``, ``test_utils``, ``monitor``, ``visualization`` and slice
19's ``telemetry``, ``telemetry.numerics``, ``telemetry.memwatch``,
``telemetry.retrace``, ``telemetry.costs`` and ``telemetry.sinks`` and
slice 21's ``memory``, ``memory.policy``, ``memory.planner``,
``memory.offload`` and ``memory.lowering`` in both
packages with an explicit list of names left out, each with the ROADMAP
list that owns it; reading a left-out name raises ``MXNetError`` naming
that list, never ``AttributeError``.  Beyond the pinned namespaces, every
module the two packages share resolves every public name of the
reference's (``test_every_shared_module_resolves_the_reference_names``).
In the namespaces pinned since slice 16 (``MODULE_NS``), names bound to
objects from outside the two packages (``np``, ``os``, ``OrderedDict``)
are not API and are not compared.
"""
import io
import contextlib
import typing

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
_7, _NC = "slice 7", "Not carried over"

LEFT_OUT = {
    "engine": dict.fromkeys(
        ("cached_vjp", "clear_segment_cache", "key_intern_stats",
         "maybe_defer", "register_dispatch_callback", "segment_cache_stats",
         "unregister_dispatch_callback"), _7),
    "autograd": {"Node": _NC},
    # XLA's lowering and memory analysis, and the TPU budget table
    "memory.lowering": dict.fromkeys(
        ("harvest_memory", "remat_forward", "shell_params"), _NC),
    "memory.planner": {"DEVICE_BUDGET_GIB": _NC},
}

#: namespaces pinned since slice 16: modules whose imports of foreign
#: objects are not compared
MODULE_NS = ("models", "serving", "engine", "autograd", "profiler", "base",
             "nd.sparse", "io", "sym", "mod", "executor", "model",
             "predictor", "contrib.onnx", "contrib.quantization",
             "ops.registry", "ops", "kvstore", "checkpoint", "np",
             "np.random", "np.linalg", "npx", "operator", "rtc",
             "gluon.contrib", "gluon.contrib.nn", "gluon.contrib.estimator",
             "util", "runtime", "test_utils", "monitor", "visualization",
             "telemetry", "telemetry.numerics", "telemetry.memwatch",
             "telemetry.retrace", "telemetry.costs", "telemetry.sinks",
             "telemetry.tracing", "telemetry.capacity", "telemetry.fleet",
             "telemetry.promtext", "serving.metrics", "serving.lanes",
             "serving.scheduler", "serving.server", "sanitizer",
             "memory", "memory.policy", "memory.planner", "memory.offload",
             "memory.lowering")


def _namespaces():
    from mxnet_tpu import gluon as jg, kvstore as jkv, parallel as jpar
    from mxnet_tpu import image as jimage
    from mxnet_tpu import initializer as jinit, random as jrand
    from mxnet_tpu.gluon import model_zoo as jzoo
    from mxnet_tpu_torch import image as timage
    from mxnet_tpu_torch.gluon import model_zoo as tzoo
    import mxnet_tpu.models as jmodels
    import mxnet_tpu.serving as jserving
    import mxnet_tpu.engine as jengine
    import mxnet_tpu.autograd as jautograd
    import mxnet_tpu.profiler as jprofiler
    import mxnet_tpu.base as jbase
    import mxnet_tpu.ndarray.sparse as jsparse
    import mxnet_tpu.io as jio
    import mxnet_tpu_torch.models as tmodels
    import mxnet_tpu_torch.serving as tserving
    import mxnet_tpu_torch.engine as tengine
    import mxnet_tpu_torch.autograd as tautograd
    import mxnet_tpu_torch.profiler as tprofiler
    import mxnet_tpu_torch.base as tbase
    import mxnet_tpu_torch.ndarray.sparse as tsparse
    import mxnet_tpu_torch.io as tio
    import mxnet_tpu.symbol as jsym
    import mxnet_tpu.module as jmod
    import mxnet_tpu.executor as jexec
    import mxnet_tpu.model as jmodel
    import mxnet_tpu.predictor as jpred
    import mxnet_tpu.contrib.onnx as jonnx
    import mxnet_tpu.contrib.quantization as jquant
    import mxnet_tpu.ops.registry as jreg
    import mxnet_tpu_torch.ops.registry as treg
    import mxnet_tpu.ops as jops
    import mxnet_tpu_torch.ops as tops
    import mxnet_tpu.kvstore as jkvmod
    import mxnet_tpu.checkpoint as jckpt
    import mxnet_tpu.numpy as jnp_
    import mxnet_tpu.numpy_extension as jnpx
    import mxnet_tpu.operator as jop
    import mxnet_tpu.rtc as jrtc
    import mxnet_tpu.gluon.contrib as jgc
    import mxnet_tpu.util as jutil
    import mxnet_tpu.runtime as jrt
    import mxnet_tpu.test_utils as jtu
    import mxnet_tpu.monitor as jmon
    import mxnet_tpu.visualization as jviz
    import mxnet_tpu.telemetry as jtel
    import mxnet_tpu_torch.telemetry as ttel
    import mxnet_tpu.sanitizer as jsan
    import mxnet_tpu.serving.metrics as jsm
    import mxnet_tpu.serving.lanes as jsl
    import mxnet_tpu.serving.scheduler as jss
    import mxnet_tpu.serving.server as jssv
    import mxnet_tpu_torch.serving.metrics as tsm
    import mxnet_tpu_torch.serving.lanes as tsl
    import mxnet_tpu_torch.serving.scheduler as tss
    import mxnet_tpu_torch.serving.server as tssv
    import mxnet_tpu.memory as jmem
    import mxnet_tpu_torch.memory as tmem

    return {
        "mx": (jmx, tmx), "nd": (jmx.nd, tmx.nd),
        "NDArray": (jmx.nd.NDArray, tmx.nd.NDArray),
        "gluon": (jg, tmx.gluon), "Block": (jg.Block, tmx.gluon.Block),
        "HybridBlock": (jg.HybridBlock, tmx.gluon.HybridBlock),
        "Parameter": (jg.Parameter, tmx.gluon.Parameter),
        "ParameterDict": (jg.ParameterDict, tmx.gluon.ParameterDict),
        "Trainer": (jg.Trainer, tmx.gluon.Trainer),
        "KVStore": (jkv.KVStore, tmx.kv.KVStore),
        "init": (jinit, tmx.init), "random": (jrand, tmx.random),
        "parallel": (jpar, tmx.parallel),
        "contrib": (jmx.contrib, tmx.contrib),
        "gluon.rnn": (jg.rnn, tmx.gluon.rnn),
        "gluon.model_zoo": (jzoo, tzoo),
        "gluon.model_zoo.detection": (jzoo.detection, tzoo.detection),
        "nd.contrib": (jmx.nd.contrib, tmx.nd.contrib),
        "image": (jimage, timage),
        "models": (jmodels, tmodels), "serving": (jserving, tserving),
        "engine": (jengine, tengine), "autograd": (jautograd, tautograd),
        "profiler": (jprofiler, tprofiler), "base": (jbase, tbase),
        "nd.sparse": (jsparse, tsparse), "io": (jio, tio),
        "sym": (jsym, tmx.sym), "mod": (jmod, tmx.mod),
        "executor": (jexec, tmx.executor), "model": (jmodel, tmx.model),
        "predictor": (jpred, tmx.predictor),
        "contrib.onnx": (jonnx, tmx.contrib.onnx),
        "contrib.quantization": (jquant, tmx.contrib.quantization),
        "ops.registry": (jreg, treg), "ops": (jops, tops),
        "kvstore": (jkvmod, tmx.kvstore),
        "checkpoint": (jckpt, tmx.checkpoint),
        "np": (jnp_, tmx.np), "np.random": (jnp_.random, tmx.np.random),
        "np.linalg": (jnp_.linalg, tmx.np.linalg), "npx": (jnpx, tmx.npx),
        "operator": (jop, tmx.operator), "rtc": (jrtc, tmx.rtc),
        "gluon.contrib": (jgc, tmx.gluon.contrib),
        "gluon.contrib.nn": (jgc.nn, tmx.gluon.contrib.nn),
        "gluon.contrib.estimator": (jgc.estimator,
                                    tmx.gluon.contrib.estimator),
        "util": (jutil, tmx.util), "runtime": (jrt, tmx.runtime),
        "test_utils": (jtu, tmx.test_utils), "monitor": (jmon, tmx.monitor),
        "visualization": (jviz, tmx.visualization),
        "telemetry": (jtel, ttel),
        **{f"telemetry.{m}": (getattr(jtel, m), getattr(ttel, m))
           for m in ("numerics", "memwatch", "retrace", "costs", "sinks",
                     "tracing", "capacity", "fleet", "promtext")},
        "serving.metrics": (jsm, tsm), "serving.lanes": (jsl, tsl),
        "serving.scheduler": (jss, tss), "serving.server": (jssv, tssv),
        "sanitizer": (jsan, tmx.sanitizer),
        "memory": (jmem, tmem),
        **{f"memory.{m}": (getattr(jmem, m), getattr(tmem, m))
           for m in ("policy", "planner", "offload", "lowering")},
    }


def _foreign(obj):
    """An object from outside the two packages: a module, class or
    function the namespace imported (``np``, ``os``, ``OrderedDict``)."""
    import types

    mod = obj.__name__ if isinstance(obj, types.ModuleType) else \
        getattr(obj, "__module__", None)
    if not isinstance(obj, (types.ModuleType, type, types.FunctionType,
                            types.BuiltinFunctionType)) or mod is None:
        return False
    return mod.split(".")[0] not in ("mxnet_tpu", "mxnet_tpu_torch")


def _public(ns, obj):
    names = {n for n in dir(obj) if not n.startswith("_")}
    if ns == "mx":
        names |= set(jmx._LAZY) if obj is jmx else set()
    # typing helpers a module imported are not its API
    names = {n for n in names
             if getattr(typing, n, None) is not getattr(obj, n, 0)}
    if ns in MODULE_NS:
        names = {n for n in names if not _foreign(getattr(obj, n))}
    return names


@pytest.fixture(scope="module")
def fresh_names():
    """Each namespace's public names in a fresh interpreter that imported
    only the two packages: a submodule another test imported (say
    ``mxnet_tpu.gluon.rnn``) becomes an attribute of its package for the
    rest of the process, so the names are read where none was."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, __file__], capture_output=True,
                         text=True, env=env, timeout=120, check=True,
                         cwd=root)
    return {ns: (set(a), set(b))
            for ns, (a, b) in json.loads(out.stdout.splitlines()[-1])
            .items()}


@pytest.mark.parametrize("ns", sorted(_namespaces()))
def test_public_names_match_the_reference_but_the_listed(ns, fresh_names):
    ref, port = fresh_names[ns]
    missing = ref - port
    assert missing == set(LEFT_OUT.get(ns, {})), sorted(missing)
    for name, owner in LEFT_OUT.get(ns, {}).items():
        with pytest.raises(tmx.MXNetError, match=owner):
            getattr(_namespaces()[ns][1], name)


def _slice12_calls():
    """One working call of each name ported in slice 12 (each was a
    refusal naming "Left out of slice 11")."""
    from mxnet_tpu_torch import checkpoint, gluon, nd, parallel, serving
    from mxnet_tpu_torch.models import llama

    def pipeline_apply():
        return parallel.pipeline_apply(
            lambda p, x: x * p, nd.ones((2, 1), ctx=CPU),
            nd.ones((3, 1), ctx=CPU), mesh={"pp": 2}).shape == (3, 1)

    def pipeline_train_1f1b():
        loss = parallel.pipeline_train_1f1b(
            lambda p, x: x * p, lambda o, lab, t: (o - lab).sum(),
            nd.ones((2, 1), ctx=CPU), nd.ones((3, 1), ctx=CPU),
            nd.zeros((3, 1), ctx=CPU), mesh={"pp": 2})[0]
        return float(loss.asscalar()) == 3.0

    def net():
        n = llama.llama_tiny()
        n.initialize(ctx=CPU)
        return n, nd.array(np.zeros((2, 4)), ctx=CPU, dtype="int32")

    def llama_pipeline_forward():
        n, ids = net()
        return llama.llama_pipeline_forward(n, ids, 2, mesh={"pp": 2}) \
            .shape == (2, 4, 256)

    def llama_pipeline_train_step():
        n, ids = net()
        return llama.llama_pipeline_train_step(
            n, ids, ids, 2, mesh={"pp": 2}).shape in ((), (1,))

    def drain_consensus():
        return gluon.trainer.drain_consensus() is False

    def serving_mesh():
        n, _ = net()
        srv = serving.GenerativeServer(n, mesh={"dp": 2})
        return len(srv.replicas) == 2

    def sharded_checkpoint():
        import tempfile

        n, _ = net()
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save_checkpoint(d, 1, n, sharded=True)
            return checkpoint.resume(d, n)[0] == 1

    return {f.__name__: f for f in (
        pipeline_apply, pipeline_train_1f1b, llama_pipeline_forward,
        llama_pipeline_train_step, drain_consensus, serving_mesh,
        sharded_checkpoint)}


@pytest.mark.parametrize("name", sorted(_slice12_calls()))
def test_names_ported_in_slice_12_resolve_to_working_functions(name):
    assert _slice12_calls()[name]()


def _slice13_calls():
    """One working call of each name ported in slice 13 (each was a
    refusal naming "Left out of slice 1" or "Left out of slice 12")."""
    from mxnet_tpu_torch import launch, nd
    from mxnet_tpu_torch.models import llama, moe

    def mixtral_tiny():
        net = llama.mixtral_tiny()
        net.initialize(ctx=CPU)
        ids = nd.array(np.zeros((1, 4)), ctx=CPU, dtype="int32")
        return net(ids).shape == (1, 4, 256)

    def llama_num_experts():
        return isinstance(llama.llama_tiny(num_experts=2).model.layers[0]
                          .mlp, moe.MoEMLP)

    def mixtral_8x7b():
        return llama.mixtral_8x7b(num_layers=1).config.num_experts == 8

    def dist_async():
        kv = tmx.kv.create("dist_async")
        kv.init(0, nd.ones((2,), ctx=CPU))
        out = nd.zeros((2,), ctx=CPU)
        kv.pull(0, out=out)
        kv.close()
        return out.asnumpy().tolist() == [1.0, 1.0]

    def launcher_ssh():
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = launch.main(["-n", "2", "--launcher", "ssh", "--dry-run",
                              "python", "t.py"])
        return rc == 0 and len(buf.getvalue().splitlines()) == 2

    def relaunch_on_failure():
        return launch._backoff_delay(2, 1.0, 30.0, lambda: 1.0) == 4.0

    return {f.__name__: f for f in (
        mixtral_tiny, llama_num_experts, mixtral_8x7b, dist_async,
        launcher_ssh, relaunch_on_failure)}


@pytest.mark.parametrize("name", sorted(_slice13_calls()))
def test_names_ported_in_slice_13_resolve_to_working_functions(name):
    assert _slice13_calls()[name]()


def _slice14_calls():
    """One working call of each name ported in slice 14 (each was a
    refusal naming item 8b or 8c); the parity tests are
    ``test_torch_{quantization,rnn,ctc}.py``."""
    from mxnet_tpu_torch import contrib, gluon, nd, rnn

    x = nd.array((np.arange(6).reshape(2, 3) - 2.5).astype(np.float32),
                 ctx=CPU)

    def quantize_ops():
        q, mn, mx = nd.quantize_v2(x)
        back = nd.dequantize(q, mn, mx)
        return q.asnumpy().dtype == np.int8 and \
            float(np.abs(back.asnumpy() - x.asnumpy()).max()) < 0.02

    def contrib_aliases():
        return nd._contrib_quantize_v2 is nd.quantize_v2 and \
            contrib.amp is tmx.amp

    def quantize_net():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(2, in_units=3))
        net.initialize(ctx=CPU)
        contrib.quantization.quantize_net(net, calib_data=[x])
        return "hybrid_forward" in net[0].__dict__ and \
            net(x).shape == (2, 2)

    def nd_rnn():
        return nd.RNN is nd.rnn

    def gluon_rnn():
        layer = gluon.rnn.GRU(4, input_size=3)
        layer.initialize(ctx=CPU)
        return layer(nd.zeros((5, 2, 3), ctx=CPU)).shape == (5, 2, 4)

    def mx_rnn():
        with tmx.cpu():
            it = rnn.BucketSentenceIter([[1, 2, 3]] * 4, 2, buckets=[4])
        return next(it).data[0].shape == (2, 4) and \
            rnn.LSTMCell is gluon.rnn.LSTMCell

    def ctc():
        return nd.CTCLoss is nd.ctc_loss and \
            isinstance(gluon.loss.CTCLoss(), gluon.loss.Loss)

    def contrib_onnx_refused():
        # refused until slice 17, which ported it
        return contrib.onnx.export_model is \
            tmx.contrib.onnx.mx2onnx.export_model

    return {f.__name__: f for f in (
        quantize_ops, contrib_aliases, quantize_net, nd_rnn, gluon_rnn,
        mx_rnn, ctc, contrib_onnx_refused)}


@pytest.mark.parametrize("name", sorted(_slice14_calls()))
def test_names_ported_in_slice_14_resolve_to_working_functions(name):
    assert _slice14_calls()[name]()


def _slice15_calls():
    """One working call of each name ported in slice 15 (each was a
    refusal naming item 8d or "Left out of slice 10", or, for
    ``gluon.model_zoo.detection``, an ``AttributeError``); the parity
    tests are ``test_torch_{contrib,control_flow,detection_ssd,
    detection_yolo_frcnn,image_det}.py``."""
    from mxnet_tpu_torch import contrib, gluon, image, nd

    def model_zoo_detection():
        return isinstance(gluon.model_zoo.detection.get_model(
            "ssd_300_resnet18_v1", classes=2), gluon.model_zoo.detection.SSD)

    def nd_contrib_ops():
        d = nd.array([[[0, 0.9, 0, 0, 1, 1], [0, 0.8, 0, 0, 1, 0.9]]],
                     ctx=CPU)
        out = nd.contrib.box_nms(d, overlap_thresh=0.5, id_index=0)
        return out.asnumpy()[0, :, 1].tolist() == [np.float32(0.9), -1.0]

    def legacy_nd_names():
        return nd.MultiBoxPrior is nd.contrib.MultiBoxPrior and \
            nd.ROIAlign is nd.contrib.roi_align

    def contrib_ndarray():
        return contrib.ndarray is nd.contrib

    def control_flow():
        outs, final = nd.contrib.foreach(
            lambda x, s: (x + s, x + s), nd.ones((3, 2), ctx=CPU),
            nd.zeros((2,), ctx=CPU))
        return final.asnumpy().tolist() == [3.0, 3.0]

    def image_det_iter():
        with tmx.cpu():
            it = image.ImageDetIter(1, (3, 8, 8), imglist=[
                (np.zeros((8, 8, 3), np.float32), [[0, 0.1, 0.1, 0.5, 0.5]])])
            return next(iter(it)).label[0].shape == (1, 1, 5)

    def create_det_augmenter():
        return isinstance(image.CreateDetAugmenter((3, 8, 8), rand_crop=1,
                                                   rand_mirror=True)[0],
                          image.DetRandomCropAug)

    return {f.__name__: f for f in (
        model_zoo_detection, nd_contrib_ops, legacy_nd_names,
        contrib_ndarray, control_flow, image_det_iter,
        create_det_augmenter)}


@pytest.mark.parametrize("name", sorted(_slice15_calls()))
def test_names_ported_in_slice_15_resolve_to_working_functions(name):
    assert _slice15_calls()[name]()


def _slice16_calls():
    """One working call of each repair of slice 16 (Queue 3's faults:
    each name raised ``AttributeError``, or the behaviour differed from
    the reference); the sparse slice's parity tests are
    ``test_torch_{sparse,fm,profiler}.py``."""
    from mxnet_tpu_torch import autograd, base, engine, gluon, models, nd
    from mxnet_tpu_torch.ndarray import sparse as sp

    def models_reexports():
        from mxnet_tpu_torch.models import bert, fm, transformer

        return models.bert_base is bert.bert_base and \
            models.BERTModel is bert.BERTModel and \
            models.Transformer is transformer.Transformer and \
            models.FMModel is fm.FMModel

    def engine_switches():
        prev = engine.set_async_enabled(False)
        off = engine.async_enabled()
        engine.set_async_enabled(prev)
        was = engine.set_bulk_enabled(True)
        on = engine.bulk_enabled()
        engine.set_bulk_enabled(was)
        engine.shutdown_async()
        return (off, on, engine.pending_ops()) == (False, True, 0) and \
            set(engine.async_stats()) == set(jmx.engine.async_stats())

    def base_helpers():
        import os

        os.environ["MXT_NAMES_PROBE"] = "on"
        try:
            got = (base.normalize_shape(3), base.normalize_shape([2, 4]),
                   base.getenv_bool("MXT_NAMES_PROBE", False),
                   base.getenv_int("MXT_NAMES_PROBE", 7),
                   base.dtype_name("float16"))
            ref = (jmx.base.normalize_shape(3),
                   jmx.base.normalize_shape([2, 4]),
                   jmx.base.getenv_bool("MXT_NAMES_PROBE", False),
                   jmx.base.getenv_int("MXT_NAMES_PROBE", 7),
                   jmx.base.dtype_name("float16"))
        finally:
            del os.environ["MXT_NAMES_PROBE"]
        with pytest.raises(tmx.MXNetError, match="Check failed"):
            base.check(False)
        a, b = base.gen_name("p"), base.gen_name("p")
        return got == ref and a != b and a.startswith("p")

    def refusals_name_their_list():
        # serving.MetricsServer is ported in slice 20
        assert tmx.serving.MetricsServer is not None
        for ns, name, owner in (("engine", "cached_vjp", _7),
                                ("autograd", "Node", _NC)):
            with pytest.raises(tmx.MXNetError, match=owner):
                getattr(_namespaces()[ns][1], name)
        # since slice 17 get_symbol raises as the reference's stub does
        for mx in (jmx, tmx):
            with pytest.raises(NotImplementedError, match="get_symbol"):
                mx.autograd.get_symbol(None)
        return autograd.is_recording() is False

    def parameter_stype():
        p = gluon.Parameter("w", shape=(2, 2), stype="row_sparse")
        with pytest.raises(tmx.MXNetError, match="invalid stype"):
            gluon.Parameter("w", stype="dense")
        emb = gluon.nn.Embedding(5, 2, sparse_grad=True)
        ref = jmx.gluon.nn.Embedding(5, 2, sparse_grad=True)
        return p.stype == "row_sparse" and \
            emb.weight._grad_stype == ref.weight._grad_stype == "row_sparse"

    def fused_step_refuses_sparse_grad():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Embedding(5, 2, sparse_grad=True))
        net.initialize(ctx=CPU)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        with pytest.raises(tmx.MXNetError, match="not fusable"):
            gluon.FusedTrainStep(net, tr, lambda n, x: n(x).sum())
        return True

    def trainer_takes_lazy_rows():
        # a row_sparse gradient skips the fused kernel: the optimizer's
        # lazy update touches only its rows
        net = gluon.nn.Embedding(4, 2)
        net.initialize(tmx.init.One(), ctx=CPU)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5})
        w = net.weight
        w._data._grad = sp.row_sparse_array(
            (np.ones((1, 2), np.float32), [2]), shape=(4, 2), ctx=CPU)
        tr.step(1)
        want = np.ones((4, 2), np.float32)
        want[2] = 0.5
        return np.array_equal(w.data().asnumpy(), want)

    return {f.__name__: f for f in (
        models_reexports, engine_switches, base_helpers,
        refusals_name_their_list, parameter_stype,
        fused_step_refuses_sparse_grad, trainer_takes_lazy_rows)}


@pytest.mark.parametrize("name", sorted(_slice16_calls()))
def test_repairs_of_slice_16_resolve_to_working_functions(name):
    assert _slice16_calls()[name]()


def _slice17_calls():
    """One working call of each name ported in slice 17 (each was a
    refusal naming item 8f, or, in ``ops.registry``, an
    ``AttributeError``); the parity tests are ``test_torch_{symbol,
    module,export,onnx,quantization_symbol,registry}.py``."""
    import os
    import tempfile

    from mxnet_tpu_torch import contrib, gluon, nd, sym
    from mxnet_tpu_torch.ops import registry

    def mlp(head=True):
        data = sym.var("data")
        fc = sym.FullyConnected(data, num_hidden=2, name="fc")
        return sym.SoftmaxOutput(fc, name="softmax") if head else \
            sym.softmax(fc, name="softmax")

    def arrays():
        return {"fc_weight": nd.ones((2, 3), ctx=CPU),
                "fc_bias": nd.zeros((2,), ctx=CPU)}

    def symbol():
        net = mlp()
        return net.infer_shape(data=(4, 3))[1] == [(4, 2)] and \
            sym.load_json(net.tojson()).tojson() == net.tojson()

    def executor():
        exe = mlp().simple_bind(CPU, data=(4, 3))
        out = exe.forward(data=np.ones((4, 3), np.float32))[0]
        return isinstance(exe, tmx.executor.Executor) and \
            out.shape == (4, 2)

    def module():
        with tmx.cpu():
            it = tmx.io.NDArrayIter(np.ones((4, 3), np.float32),
                                    np.zeros(4, np.float32), batch_size=2)
            m = tmx.mod.Module(mlp(), context=CPU)
            m.fit(it, num_epoch=1)
            return m.predict(it).shape == (4, 2)

    def model_checkpoint():
        with tempfile.TemporaryDirectory() as d:
            prefix = os.path.join(d, "m")
            tmx.model.save_checkpoint(prefix, 1, mlp(), arrays(), {})
            s, arg, _ = tmx.model.load_checkpoint(prefix, 1)
            return s.list_arguments() == mlp().list_arguments() and \
                sorted(arg) == ["fc_bias", "fc_weight"]

    def predictor():
        with tempfile.TemporaryDirectory() as d:
            prefix = os.path.join(d, "m")
            tmx.model.save_checkpoint(prefix, 0, mlp(False), arrays(), {})
            p = tmx.predictor.create(prefix + "-symbol.json",
                                     prefix + "-0000.params", ctx=CPU)
            return p.input_names == ["data"] and \
                p.predict(np.ones((1, 3), np.float32)).shape == (1, 2)

    def symbol_block():
        block = gluon.SymbolBlock(mlp(), sym.var("data"), arrays())
        return block(nd.ones((1, 3), ctx=CPU)).shape == (1, 2) and \
            sorted(block.collect_params().keys()) == ["fc_bias",
                                                      "fc_weight"]

    def onnx():
        with tempfile.TemporaryDirectory() as d:
            path = contrib.onnx.export_model(
                mlp(False), arrays(), [(1, 3)],
                onnx_file_path=os.path.join(d, "m.onnx"))
            with tmx.cpu():
                s, arg, _ = contrib.onnx.import_model(path)
            return sorted(arg) == ["fc_bias", "fc_weight"]

    def quantize_model():
        qsym, qarg, _ = contrib.quantization.quantize_model(
            mlp(), arrays(), {}, ctx=CPU, calib_mode="naive",
            calib_data=[nd.ones((2, 3), ctx=CPU)])
        return "quantized_fc" in [n["name"] for n in
                                  __import__("json").loads(
                                      qsym.tojson())["nodes"]]

    def registry_table():
        return len(registry.list_ops()) == 342 and \
            registry.get_op("FullyConnected") is nd.FullyConnected and \
            registry.op_meta("argmax")["no_grad"] and \
            registry.duplicate_registrations() == []

    def parameter_var():
        # the reference raises NotImplementedError; MXNet returns the
        # parameter's variable
        v = gluon.Parameter("w", shape=(2, 3)).var()
        return v.list_arguments() == ["w"] and \
            v.infer_shape()[0] == [(2, 3)]

    def contrib_symbol():
        return contrib.symbol is sym.contrib and \
            "box_nms" in contrib.symbol.__all__

    def bert_to_symbol():
        from mxnet_tpu_torch.models import bert

        net = bert.bert_tiny(vocab_size=10, num_layers=1)
        net.initialize(ctx=CPU)
        ids = nd.zeros((1, 4), ctx=CPU, dtype="int32")
        net(ids, ids)  # the deferred shapes
        s, params = bert.bert_to_symbol(net, 1, 4)
        return len(s.list_outputs()) == 4 and \
            set(params) <= set(s.list_arguments())

    return {f.__name__: f for f in (
        symbol, executor, module, model_checkpoint, predictor,
        symbol_block, onnx, quantize_model, registry_table, parameter_var,
        contrib_symbol, bert_to_symbol)}


@pytest.mark.parametrize("name", sorted(_slice17_calls()))
def test_names_ported_in_slice_17_resolve_to_working_functions(name):
    assert _slice17_calls()[name]()


#: public names of reference modules that are not API: the loop variable
#: ``row`` of ``ops/elemwise.py``'s op tables
NOT_API = {"ops.elemwise": {"row"}}


def _shared_modules():
    import importlib
    import pkgutil

    import mxnet_tpu_torch

    def walk(pkg):
        return {m.name[len(pkg.__name__) + 1:] for m in
                pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}

    shared = sorted(walk(jmx) & walk(mxnet_tpu_torch))
    return [(rel, importlib.import_module("mxnet_tpu." + rel),
             importlib.import_module("mxnet_tpu_torch." + rel))
            for rel in shared if not rel.startswith("_native.lib")]


def test_every_shared_module_resolves_the_reference_names():
    """The dir() diff of every module both packages have: each public
    name of the reference's (its imports from outside the two packages
    aside) resolves in the port or raises ``MXNetError``."""
    missing = {}
    for rel, ref, port in _shared_modules():
        names = {n for n in dir(ref) if not n.startswith("_")
                 and not _foreign(getattr(ref, n))
                 and getattr(typing, n, None) is not getattr(ref, n)}
        for n in sorted(names - NOT_API.get(rel, set())):
            try:
                getattr(port, n)
            except AttributeError:
                missing.setdefault(rel, []).append(n)
            except tmx.MXNetError:
                pass
    assert missing == {}
    assert len(_shared_modules()) > 100


def _slice18_calls():
    """One working call of each name ported in slice 18 (each was a
    refusal naming item 8g or item 9, or an ``AttributeError``); the
    parity tests are ``test_torch_{numpy,numpy_random_linalg,custom_op,
    gluon_contrib,tools}.py``."""
    from mxnet_tpu_torch import _native, checkpoint, kvstore, ops

    def np_front_end():
        a = tmx.np.arange(6, ctx=CPU).reshape(2, 3)
        return type(tmx.np.sum(a, axis=0)).__name__ == "ndarray"

    def npx():
        return tmx.npx.relu(tmx.np.array([-1.0], ctx=CPU)).item() == 0.0

    def nd_custom():
        return tmx.nd.Custom is not None and \
            callable(tmx.operator.register)

    def ops_reexports():
        from mxnet_tpu_torch.ops import registry

        return ops.apply_op is registry.apply_op and \
            ops.defop is registry.defop

    def telemetry_refusals():
        # refused naming item 9 until slice 19 ported the package
        return all(mod.telemetry is tmx.telemetry
                   for mod in (kvstore, checkpoint))

    def native_available():
        return _native.available() is True

    def gluon_contrib():
        return tmx.gluon.contrib.estimator.Estimator is not None and \
            tmx.gluon.contrib.nn.Identity()(tmx.nd.ones((1,), ctx=CPU)) \
            .shape == (1,)

    def tools():
        return not tmx.runtime.Features().is_enabled("TPU") and \
            tmx.viz is tmx.visualization and \
            tmx.util.is_np_array() is False and \
            tmx.test_utils.max_rel_err([1.0], [1.0]) == 0.0 and \
            tmx.monitor.Monitor(1).step == 0

    def rtc():
        k = tmx.rtc.PallasKernel(lambda a: a + 1)
        return k(tmx.nd.zeros((2,), ctx=CPU)).asnumpy().tolist() == \
            [1.0, 1.0]

    return {f.__name__: f for f in (
        np_front_end, npx, nd_custom, ops_reexports, telemetry_refusals,
        native_available, gluon_contrib, tools, rtc)}


@pytest.mark.parametrize("name", sorted(_slice18_calls()))
def test_names_ported_in_slice_18_resolve_to_working_functions(name):
    assert _slice18_calls()[name]()


# -- NDArray ---

def test_ndarray_ctx_as_in_ctx_and_wait_to_write():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    j, t = jmx.nd.array(a), tmx.nd.array(a, ctx=CPU)
    assert t.ctx == t.context == CPU
    assert str(j.ctx.device_type) == "cpu" and t.ctx.device_type == "cpu"
    assert t.as_in_ctx(CPU) is t
    np.testing.assert_array_equal(t.as_in_ctx(CPU).asnumpy(),
                                  j.as_in_ctx(j.ctx).asnumpy())
    assert t.wait_to_write() is t and j.wait_to_write() is j
    assert t.as_nd_ndarray() is t and t.asnative() is t._data
    assert t.stype == j.stype == "default"
    assert t.tostype("default") is t
    # sparse storage (item 8e) is ported in slice 16
    # (tests/test_torch_sparse.py)
    for stype in ("row_sparse", "csr"):
        got, ref = t.tostype(stype), j.tostype(stype)
        assert got.stype == ref.stype == stype
        np.testing.assert_array_equal(got.indices.asnumpy(),
                                      ref.indices.asnumpy())
        np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


def test_dlpack_round_trips_and_crosses_packages():
    a = np.arange(5, dtype=np.float32)
    t = tmx.nd.array(a, ctx=CPU)
    back = tmx.nd.from_dlpack(tmx.nd.to_dlpack_for_read(t))
    np.testing.assert_array_equal(back.asnumpy(), a)
    w = tmx.nd.from_dlpack(tmx.nd.to_dlpack_for_write(t))
    w._data.add_(1.0)  # the writer's buffer is the array's
    np.testing.assert_array_equal(t.asnumpy(), a + 1)
    # the reference reads the port's export, and the port the reference's
    j = jmx.nd.from_dlpack(tmx.nd.to_dlpack_for_read(t))
    np.testing.assert_array_equal(j.asnumpy(), a + 1)
    back = tmx.nd.from_dlpack(jmx.nd.to_dlpack_for_read(j))
    np.testing.assert_array_equal(back.asnumpy(), a + 1)


# -- Block ---

def _mlps():
    nets = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(5, in_units=3, activation="relu",
                                  prefix="fc1_"),
                mx.gluon.nn.Dense(2, in_units=5, prefix="fc2_"))
        net.initialize(mx.init.One(), **kw)
        nets.append(net)
    return nets


def test_block_apply_hooks_and_summary():
    x = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    seen, outs = [], []
    for mx, net, kw in zip((jmx, tmx), _mlps(), ({}, {"ctx": CPU})):
        order = []
        net.apply(lambda b: order.append(type(b).__name__))
        calls = []
        pre = net.register_forward_pre_hook(
            lambda b, a: calls.append(("pre", len(a))))
        post = net.register_forward_hook(
            lambda b, a, o: calls.append(("post", o.shape)))
        y = net(mx.nd.array(x, **kw))
        pre.detach()
        post.detach()
        net(mx.nd.array(x, **kw))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            net.summary(mx.nd.array(x, **kw))
        total = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("Total params")]
        seen.append((order, calls, total))
        outs.append(y.asnumpy())
    assert seen[0] == seen[1]
    assert seen[1][1] == [("pre", 1), ("post", (4, 2))]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)


def test_optimize_for_export_and_symbol_block(tmp_path):
    x = np.random.RandomState(1).rand(2, 3).astype(np.float32)
    jnet, tnet = _mlps()
    jnet.optimize_for(jmx.nd.array(x))
    tnet.optimize_for(tmx.nd.array(x, ctx=CPU))
    assert tnet._active
    np.testing.assert_allclose(tnet(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=1e-6)
    # export and SymbolBlock are ported in slice 17 (the parity tests are
    # tests/test_torch_export.py)
    sym_file, params_file = tnet.export(str(tmp_path / "net"))
    block = tmx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                          ctx=CPU)
    np.testing.assert_allclose(block(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=1e-6)
    with pytest.raises(tmx.MXNetError, match="not bound"):
        tmx.gluon.SymbolBlock()(tmx.nd.array(x, ctx=CPU))


# -- Parameter, ParameterDict, Constant ---

def test_constant_and_get_constant():
    value = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    got = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        c = mx.gluon.Constant("c", value)
        c.initialize(**kw)
        pd = mx.gluon.ParameterDict("blk_")
        k = pd.get_constant("k", value * 2)
        assert pd.get_constant("k") is k
        k.initialize(**kw)
        assert c.grad_req == "null"
        got.append((c.data().asnumpy(), k.data().asnumpy(), k.name))
        with pytest.raises(Exception, match="provide a value"):
            pd.get_constant("missing")
    for a, b in zip(*got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_parameter_list_data_reset_ctx_and_dict_methods(tmp_path):
    jnet, tnet = _mlps()
    tp, jp = tnet.collect_params(), jnet.collect_params()
    p = next(iter(tp.values()))
    assert len(p.list_data()) == len(next(iter(jp.values())).list_data())
    assert p.list_data()[0] is p.data()
    p.reset_ctx(CPU)
    tp.reset_ctx([CPU])
    assert p.list_ctx() == [CPU] and p.data().ctx == CPU
    assert p.dtype_np == p.dtype and p.stype == "default"
    tp.setattr("lr_mult", 0.5)
    jp.setattr("lr_mult", 0.5)
    assert all(q.lr_mult == 0.5 for q in tp.values())
    tp.initialize(verbose=True)  # accepted (already initialized)
    # port save → reference load, and back (the same names: fc1_weight..)
    tp.save(str(tmp_path / "t.params"), strip_prefix="fc")
    jp.load(str(tmp_path / "t.params"), restore_prefix="fc")
    for (_, a), (_, b) in zip(jp.items(), tp.items()):
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())
    for q in jp.values():
        q.set_data(q.data() * 3)
    jp.save(str(tmp_path / "j.params"))
    tp.load(str(tmp_path / "j.params"))
    for (_, a), (_, b) in zip(jp.items(), tp.items()):
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())


# -- KVStore ---

def test_kvstore_broadcast_set_updater_and_optimizer_states(tmp_path):
    w0 = np.array([1.0, 2.0, 3.0], np.float32)
    g = np.array([0.5, -0.5, 1.0], np.float32)
    res = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        kv = mx.kv.create("local")
        out = mx.nd.zeros((3,), **kw)
        kv.broadcast("b", mx.nd.array(w0, **kw), out=out)
        got = [out.asnumpy()]
        kv.init(0, mx.nd.array(w0, **kw))
        kv.set_updater(lambda k, grad, weight: weight.__isub__(grad * 2))
        kv.push(0, mx.nd.array(g, **kw))
        kv.pull(0, out=out)
        got.append(out.asnumpy())
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        kv.push(0, mx.nd.array(g, **kw))
        kv.save_optimizer_states(str(tmp_path / "s"))
        kv.push(0, mx.nd.array(g, **kw))
        kv.pull(0, out=out)
        got.append(out.asnumpy())
        kv.load_optimizer_states(str(tmp_path / "s"))
        kv.push(0, mx.nd.array(g, **kw))
        kv.pull(0, out=out)
        got.append(out.asnumpy())
        res.append(got)
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, rtol=1e-6)
    # row_sparse_pull (item 8e) is ported in slice 16
    # (tests/test_torch_fm.py): a dense target gets only the given rows
    pulled = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        kv = mx.kv.create("local")
        kv.init("t", mx.nd.array(np.arange(6, dtype=np.float32)
                                 .reshape(3, 2), **kw))
        out = mx.nd.zeros((3, 2), **kw)
        kv.row_sparse_pull("t", out=out, row_ids=mx.nd.array([0, 2], **kw))
        pulled.append(out.asnumpy())
    np.testing.assert_array_equal(pulled[1], pulled[0])
    assert pulled[1][1].tolist() == [0.0, 0.0]


# -- init, random ---

def test_init_aliases_and_init_desc():
    assert tmx.init.Zeros is tmx.init.Zero and tmx.init.Ones is tmx.init.One
    for mx in (jmx, tmx):
        d = mx.init.InitDesc("fc_weight", attrs={"lr_mult": "2"})
        assert d == "fc_weight" and d.attrs == {"lr_mult": "2"}
    a = tmx.nd.zeros((2, 2), ctx=CPU)
    tmx.init.Ones()(tmx.init.InitDesc("w_weight"), a)
    np.testing.assert_array_equal(a.asnumpy(), np.ones((2, 2)))


def test_random_seed_of_one_context():
    tmx.random.seed(5)
    first = tmx.nd.random.uniform(shape=(4,), ctx=CPU).asnumpy()
    tmx.random.seed(5, ctx=CPU)
    again = tmx.nd.random.uniform(shape=(4,), ctx=CPU).asnumpy()
    np.testing.assert_array_equal(first, again)
    jmx.random.seed(5, ctx="all")  # the reference takes the keyword too
    with pytest.raises(tmx.MXNetError, match="Not carried over"):
        tmx.random.next_key()


if __name__ == "__main__":
    import json

    print(json.dumps({ns: [sorted(_public(ns, r)), sorted(_public(ns, t))]
                      for ns, (r, t) in _namespaces().items()}))
