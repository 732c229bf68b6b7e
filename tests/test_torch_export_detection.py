"""The detectors' export: SSD, YOLOv3 and Faster R-CNN through
``HybridBlock.export``, ``SymbolBlock.imports`` and ``Predictor``, held
against the live port block and the JAX package's forward, on the CPU.

Each net is built in both packages with the same weights
(``test_torch_detection_ssd.det_arrays``), at the detection tests'
small sizes with a batch of 1; Faster R-CNN on a ResNet-18 backbone
(the detection tests hold the ResNet-50 one), which keeps the exported
program small enough to trace and load quickly.  ``Predictor`` serves the SSD
program (it loads a program as ``SymbolBlock.imports`` does, which
every case runs).  The exported ``torch.export`` program
holds ``mxnet_tpu_torch::nms_keep`` as a node (the greedy scan; its CPU
implementation is the plain version).  Tolerances: the imported program
against the live port block 0 (the same ops on the same values); against
the reference, ids exactly and scores and boxes within 1e-4 of each
output's largest magnitude (``assert_detections_match``, as the
detection tests hold the live block).
"""
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import detection as jdet

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import detection as tdet

from test_torch_detection_ssd import (assert_detections_match,  # noqa: E402
                                      det_arrays, jax_net, outputs)

CPU = tmx.cpu()

NETS = {
    "ssd": (lambda pkg: pkg.ssd_300_resnet18_v1(classes=3), 96, 11),
    "yolo": (lambda pkg: pkg.yolo3_darknet53(classes=3), 64, 12),
    "frcnn": (lambda pkg: pkg.FasterRCNN(
        classes=3, backbone="resnet18_v1", rpn_post_nms=8), 96, 13),
}


def _program_ops(program):
    return sorted({str(n.target) for n in program.graph.nodes
                   if n.op == "call_function" and
                   "mxnet_tpu_torch" in str(n.target)})


@pytest.mark.parametrize("name", sorted(NETS))
def test_exported_detector_matches_live_block_and_reference(name,
                                                            tmp_path):
    make, side, seed = NETS[name]
    x = np.random.RandomState(seed).rand(1, 3, side, side) \
        .astype(np.float32)
    tnet = make(tdet)
    arrays = det_arrays(tnet, x, seed=seed, gain=1.0)
    if name == "frcnn":
        from mxnet_tpu_torch.convert import load_numpy_params

        for k in ("rpn.loc.weight", "rpn.loc.bias"):
            arrays[k] *= 0.1
        load_numpy_params(tnet, arrays, ctx=CPU)
    tnet.hybridize()
    live = outputs(tmx, tnet, x)
    ref = outputs(jmx, jax_net(lambda: make(jdet), arrays), x)
    assert_detections_match(ref, live)
    prefix = str(tmp_path / name)
    t0 = time.perf_counter()
    sym_file, params_file = tnet.export(prefix)
    assert time.perf_counter() - t0 < 60
    block = tmx.gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                          ctx=CPU)
    assert "mxnet_tpu_torch.nms_keep.default" in _program_ops(block._program)
    got = [o.asnumpy() for o in block(tmx.nd.array(x, ctx=CPU))]
    for g, a in zip(got, live):
        np.testing.assert_array_equal(g, a)
    assert_detections_match(ref, got)
    if name == "ssd":  # the Predictor loads the program as imports does
        pred = tmx.predictor.Predictor(sym_file, params_file, ctx=CPU)
        for s, a in zip(pred.forward(data=x), live):
            np.testing.assert_array_equal(s.asnumpy(), a)
