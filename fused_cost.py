#!/usr/bin/env python3
"""Times of the port's fused 1x1 conv + BN + ReLU kernel on one CUDA card.

    python3 fused_cost.py [--root TREE] [--tag NAME]

Imports ``mxnet_tpu_torch`` from ``TREE`` (default: this file's
directory), builds its ``fused_matmul_affine_relu`` kernel and prints one
JSON line: the card's name and power limit, then for each net's forward
in bf16 (ResNet-50 v1 at B=128 and at the served B=32 bucket, MobileNet
v1, Inception v3 and DenseNet-121 at B=128) each distinct (M, K, N) of
its fused runs, with the launches a forward makes of it, and:

- ``ms``: ``fused_matmul_affine_relu`` called back to back, host included;
- ``device_ms``: the same calls enqueued behind a device-side sleep, so
  that the events see the device only;
- ``host_us``: the host's time of one call (the median over HOST_RUNS
  runs of REPS calls enqueued back to back, on the host's clock), and
  ``entry_host_us`` its C entry point's alone (the same calls through
  ``ctypes`` on a preallocated output: no custom op, no Python wrapper);
- ``library_ms`` and ``library_device_ms``: cuBLAS ``addmm`` (the scale
  folded into w) then ``relu`` on the same inputs, the library's
  yardstick, which the port never calls;
- ``bound_ms``: the least time the card could take (x, w, scale and bias
  read once, the output written once, 2·M·N·K operations);

each the mean over REPS calls after a warm-up (CUDA events), and each
net's sums over a forward.  The zoo nets' shapes are read off a forward
on the CPU at B=1 (the kernel's plain version), as ``chip_smoke.py``
reads them.  ``deterministic``: two calls at ResNet-50's stage-3 shape
give the same bits.  ``instances``: the C entry points the tree has.

To compare two trees, run it from each in one call on the same card,
alternating (A, B, B, A).
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPS = 20
HOST_RUNS = 5
SEED = 25
B = 128
# ResNet-50 v1 (224 x 224): (H' = W', K, N, launches a forward)
RESNET50 = [(56, 64, 64, 1), (56, 256, 64, 2), (28, 256, 128, 1),
            (28, 512, 128, 3), (14, 512, 256, 1), (14, 1024, 256, 5),
            (7, 1024, 512, 1), (7, 2048, 512, 2)]
# the vision zoo's nets whose 1x1 Conv2D -> BatchNorm -> ReLU runs fuse:
# (name, image side)
ZOO = [("mobilenet1.0", 224), ("inceptionv3", 299), ("densenet121", 224)]
PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12


def time_ms(torch, fn, iters, hide_host=False):
    """Mean time of ``fn`` over ``iters`` back-to-back calls after one
    warm-up (CUDA events); ``hide_host`` opens the window behind a
    device-side sleep of 2e8 cycles, so that the host has enqueued every
    call before the first one runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn):
    """The host's time of one call in us: the median over HOST_RUNS runs
    of REPS calls enqueued back to back, on the host's clock."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(HOST_RUNS):
        t = time.perf_counter()
        for _ in range(REPS):
            fn()
        runs.append((time.perf_counter() - t) / REPS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def entry(torch, x, w, scale, bias):
    """A call of the bf16 tensor-core design's C entry point on the
    operands and a preallocated output, on the current stream."""
    from mxnet_tpu_torch import _kernels

    lib = _kernels.load("fused_matmul_affine_relu")
    fn = lib.mxt_fused_matmul_affine_relu_mma
    out = torch.empty(x.shape[0], w.shape[1], dtype=x.dtype, device="cuda")
    (m, k), n = x.shape, w.shape[1]
    args = [t.data_ptr() for t in (x, w, scale, bias, out)] + \
        [m, n, k, 2, torch.cuda.current_stream().cuda_stream]

    def call():
        _kernels.check(lib, fn(*args), "mxt_fused_matmul_affine_relu_mma")

    return call


def zoo_shapes(mx, vision, cbr):
    """{net: [((M at B=1, K, N), launches a forward), ...]} read off a
    CPU forward through a recording wrapper of the fused op."""
    orig = cbr.fused_matmul_affine_relu
    seen = []

    def record(x, w, scale, bias):
        seen.append((x.shape[0], x.shape[1], w.shape[1]))
        return orig(x, w, scale, bias)

    out = {}
    cbr.fused_matmul_affine_relu = record
    try:
        for name, image in ZOO:
            seen.clear()
            net = vision.get_model(name)
            net.initialize(ctx=mx.cpu())
            net(mx.nd.zeros((1, 3, image, image), ctx=mx.cpu()))
            counts = {}
            for s in seen:
                counts[s] = counts.get(s, 0) + 1
            out[name] = sorted(counts.items())
    finally:
        cbr.fused_matmul_affine_relu = orig
    return out


def shape_row(torch, cbr, gen, m, k, n, per_fwd):
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(k, n, generator=gen, device="cuda") /
         math.sqrt(k)).bfloat16()
    scale = torch.rand(n, generator=gen, device="cuda") + 0.5
    bias = torch.rand(n, generator=gen, device="cuda") - 0.5
    w_lib = (w.float() * scale).bfloat16()
    b_lib = bias.bfloat16()

    def kernel():
        return cbr.fused_matmul_affine_relu(x, w, scale, bias)

    def library():
        return torch.relu(torch.addmm(b_lib, x, w_lib))

    t_ops = 2.0 * m * k * n / PEAK_FLOPS
    t_bytes = (2 * (m * k + k * n + m * n) + 8 * n) / PEAK_BYTES
    return dict(M=m, K=k, N=n, launches_per_forward=per_fwd,
                ms=time_ms(torch, kernel, REPS),
                device_ms=time_ms(torch, kernel, REPS, hide_host=True),
                host_us=host_us(torch, kernel),
                entry_host_us=host_us(torch, entry(torch, x, w, scale, bias)),
                library_ms=time_ms(torch, library, REPS),
                library_device_ms=time_ms(torch, library, REPS,
                                          hide_host=True),
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def net_sum(rows):
    keys = ("ms", "device_ms", "host_us", "entry_host_us", "library_ms",
            "library_device_ms", "bound_ms")
    out = {key: sum(r[key] * r["launches_per_forward"] for r in rows)
           for key in keys}
    out["launches"] = sum(r["launches_per_forward"] for r in rows)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("fused_cost: no CUDA card", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import conv_bn_relu as cbr

    _kernels.build(["fused_matmul_affine_relu"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    fn = cbr.fused_matmul_affine_relu
    out = dict(tag=args.tag, root=args.root, nvidia_smi=smi,
               torch=torch.__version__,
               instances=sorted(_kernels.SYMBOLS["fused_matmul_affine_relu"]))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    nets = {"resnet50": [((B * h * h, k, n), per)
                         for h, k, n, per in RESNET50],
            "resnet50_b32": [((32 * h * h, k, n), per)
                             for h, k, n, per in RESNET50]}
    for name, shapes in zoo_shapes(mx, vision, cbr).items():
        nets[name] = [((m1 * B, k, n), per) for (m1, k, n), per in shapes]
    for name, shapes in nets.items():
        rows = [shape_row(torch, cbr, gen, m, k, n, per)
                for (m, k, n), per in shapes]
        out[name] = dict(forward=net_sum(rows), shapes=rows)
        torch.cuda.empty_cache()
    ops = [torch.randn(B * 196, 1024, generator=gen,
                       device="cuda").bfloat16(),
           (torch.randn(1024, 256, generator=gen, device="cuda") /
            32).bfloat16(),
           torch.rand(256, generator=gen, device="cuda") + 0.5,
           torch.rand(256, generator=gen, device="cuda") - 0.5]
    out["deterministic"] = bool(torch.equal(fn(*ops), fn(*ops)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
