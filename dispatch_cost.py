#!/usr/bin/env python3
"""Host cost of the port's kernel dispatch on one CUDA card.

    python3 dispatch_cost.py [--root TREE] [--tag NAME]

Imports ``mxnet_tpu_torch`` from ``TREE`` (default: this file's
directory), builds its kernels and prints one JSON line: the card's name
and power limit, the host time of one eager call of the flash-attention
forward (#1, ``flash_attention_fwd``) and of the fused 1x1 conv kernel
(#4, ``fused_matmul_affine_relu``) in us (calls enqueued back to back,
on the host's clock, at a small shape so the card keeps up; the median
of WINDOWS windows of HOST_ITERS calls), the same of one eager NDArray
op through ``apply_op`` (``nd.relu`` and ``a + 1.0`` on a (64, 64)
array: the op layer's own cost, bulking off) and of ``nms_keep`` (G=1,
n=400), and the wall time of eager
``resnet50_v1`` bf16 B=128 and ``ssd_512_resnet50_v1`` bf16 B=1
forwards in ms (synchronized; the median of ``REPS`` after a warm-up).
The host is shared with other work, so single windows vary.  To
compare two trees, run it from each in one call on the same card,
alternating (A, B, B, A).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 15
HOST_ITERS = 1000
WINDOWS = 7


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("dispatch_cost: no CUDA card", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.gluon.model_zoo import detection, vision
    from mxnet_tpu_torch.ops import conv_bn_relu as cbr
    from mxnet_tpu_torch.ops import flash_attention as fa

    _kernels.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def host_us(fn):
        for _ in range(10):
            fn()
        windows = []
        for _ in range(WINDOWS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(HOST_ITERS):
                fn()
            windows.append((time.perf_counter() - t) / HOST_ITERS * 1e6)
        torch.cuda.synchronize()
        return statistics.median(windows)

    q = torch.randn((1, 2, 64, 64), device=dev, generator=gen,
                    dtype=torch.bfloat16)
    x = torch.randn((256, 64), device=dev, generator=gen,
                    dtype=torch.bfloat16)
    w = torch.randn((64, 64), device=dev, generator=gen,
                    dtype=torch.bfloat16)
    sc = torch.ones(64, device=dev)
    bi = torch.zeros(64, device=dev)
    with torch.no_grad():
        fa_us = host_us(lambda: fa.flash_attention_fwd(q, q, q))
        fused_us = host_us(lambda: cbr.fused_matmul_affine_relu(x, w, sc,
                                                               bi))
    from mxnet_tpu_torch.ops import contrib

    a = mx.nd.array(torch.randn((64, 64), device=dev, generator=gen),
                    ctx=mx.gpu(0))
    op_us = {"relu": host_us(lambda: mx.nd.relu(a)),
             "add_scalar": host_us(lambda: a + 1.0)}
    xy = torch.rand((1, 400, 2), device=dev, generator=gen) * 400
    boxes = torch.cat([xy, xy + 40], dim=-1)
    valid = torch.ones((1, 400), dtype=torch.bool, device=dev)
    nms_us = host_us(lambda: contrib.nms_keep(boxes, valid, None, 0.5))

    def forward_ms(net, inp):
        net(inp)
        ms = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            net(inp)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms)

    nets = {}
    for name, make, shape in (
            ("resnet50_v1_bf16_B128", lambda: vision.resnet50_v1(),
             (128, 3, 224, 224)),
            ("ssd_512_resnet50_v1_bf16_B1",
             lambda: detection.ssd_512_resnet50_v1(classes=20),
             (1, 3, 512, 512))):
        with mx.gpu(0):
            mx.random.seed(0)
            net = make()
            net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
            net(mx.nd.zeros((1, 3, 128, 128), ctx=mx.gpu(0)))  # shapes
            net.cast("bfloat16")
            inp = mx.nd.array(torch.rand(shape, device=dev, generator=gen)
                              .bfloat16(), ctx=mx.gpu(0))
            nets[name] = forward_ms(net, inp)
        del net
    print(json.dumps(dict(tag=args.tag, root=args.root, nvidia_smi=smi,
                          torch=torch.__version__,
                          flash_attention_fwd_host_us=fa_us,
                          fused_matmul_affine_relu_host_us=fused_us,
                          nd_op_host_us=op_us, nms_keep_host_us=nms_us,
                          eager_forward_ms=nets)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
