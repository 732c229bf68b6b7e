#!/usr/bin/env python3
"""Times of the port's CSR x dense product and NMS scan on one CUDA card.

    python3 csr_nms_cost.py [--root TREE] [--tag NAME]

Imports ``mxnet_tpu_torch`` from ``TREE`` (default: this file's
directory), builds its ``csr_dense_dot`` and ``nms_keep`` kernels and
prints one JSON line: the card's name and power limit, then for each
call its time (``ms``: back-to-back calls, host included) and its device
time (``device_ms``: the same calls enqueued behind a device-side sleep,
so the events see the device only), the mean over REPS calls after a
warm-up (CUDA events):

- at the factorization machine's shape (a 1,000 x 1,000,000 CSR batch, 39
  nonzeros a row, f32): the kernel's wrapper ``csr_dense_dot`` against the
  (1,000,000, 16) table, ``nd.dot(csr, table)`` and ``nd.dot(csr, g,
  transpose_a=True)`` with g (1,000, 16); for the two ``nd.dot`` calls
  also the host's time of a call (``host_us``) and the first host
  synchronization it makes (``host_sync``, None for none), and, where the
  tree has it, the host's time of the transposed route's column-ordered
  view and of its stable sort;
- ``FMModel(1_000_000, 16).step`` with a ``local`` store running Adam on
  one batch: the step and its forward and gradients (up to the first
  push), on the host's clock, synchronized, the median of FM_STEPS after
  FM_WARMUP;
- ``nms_keep`` at NMS_SIZES.

To compare two trees, run it from each in one call on the same card,
alternating (A, B, B, A).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 50
FM_B, FM_FEATURES, FM_FACTOR, FM_NNZ = 1000, 1_000_000, 16, 39
FM_WARMUP, FM_STEPS = 3, 20
NMS_SIZES = [(32, 400, True), (1, 2000, False), (1, 10647, True)]
SEED = 22


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


def both(torch, fn):
    return dict(ms=time_ms(torch, fn, REPS),
                device_ms=time_ms(torch, fn, REPS, hide_host=True))


def host_side(torch, fn):
    """The host's time of one call in us (REPS calls enqueued back to
    back, on the host's clock), and the first host synchronization the
    call makes (``torch.cuda.set_sync_debug_mode``), or None."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(REPS):
        fn()
    us = (time.perf_counter() - t) / REPS * 1e6
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        sync = None
    except RuntimeError as e:
        sync = str(e).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(host_us=us, host_sync=sync)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("csr_nms_cost: no CUDA card", file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.models import fm
    from mxnet_tpu_torch.ndarray import sparse as tsp
    from mxnet_tpu_torch.ops import contrib as tc

    _kernels.build(["csr_dense_dot", "nms_keep"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gpu = mx.gpu(0)
    r = np.random.RandomState(SEED)
    cols = np.sort(r.randint(0, FM_FEATURES - FM_NNZ, (FM_B, FM_NNZ)), 1) + \
        np.arange(FM_NNZ)  # distinct and increasing in each row
    batch = (r.uniform(0.01, 1.0, FM_B * FM_NNZ).astype(np.float32),
             cols.reshape(-1), np.arange(0, FM_B * FM_NNZ + 1, FM_NNZ))
    csr = mx.nd.sparse.csr_matrix(batch, shape=(FM_B, FM_FEATURES), ctx=gpu)
    table = mx.nd.array(r.randn(FM_FEATURES, FM_FACTOR).astype(np.float32),
                        ctx=gpu)
    g = mx.nd.array(r.randn(FM_B, FM_FACTOR).astype(np.float32), ctx=gpu)
    label = mx.nd.array((r.rand(FM_B) > 0.5).astype(np.float32), ctx=gpu)
    a = (csr.data._data, csr.indices._data, csr.indptr._data,
         tsp._csr_rows(csr))
    out = dict(tag=args.tag, root=args.root, nvidia_smi=smi,
               torch=torch.__version__)
    out["csr_dense_dot"] = both(torch, lambda: tsp.csr_dense_dot(
        *a, table._data))
    out["dot"] = both(torch, lambda: mx.nd.dot(csr, table))
    out["dot_transpose_a"] = both(torch, lambda: mx.nd.dot(
        csr, g, transpose_a=True))
    for key, fn in (("dot", lambda: mx.nd.dot(csr, table)),
                    ("dot_transpose_a", lambda: mx.nd.dot(
                        csr, g, transpose_a=True))):
        out[key].update(host_side(torch, fn))
    if hasattr(tsp, "_csr_column_view"):  # the transposed route's view
        key = a[1].to(torch.int32)
        out["column_view"] = dict(
            host_us=host_side(torch, lambda: tsp._csr_column_view(
                a[0], a[1], a[3], FM_FEATURES))["host_us"],
            sort_host_us=host_side(torch, lambda: torch.sort(
                key, stable=True))["host_us"])

    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.Adam(learning_rate=1e-3))
    model = fm.FMModel(FM_FEATURES, FM_FACTOR, seed=SEED, kvstore=kv,
                       ctx=gpu)
    first_push = []
    push = kv.push

    def timed_push(*p, **k):
        if not first_push:
            torch.cuda.synchronize()
            first_push.append(time.perf_counter())
        return push(*p, **k)

    kv.push = timed_push
    steps, grads = [], []
    for i in range(FM_WARMUP + FM_STEPS):
        del first_push[:]
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.step(csr, label)
        torch.cuda.synchronize()
        if i >= FM_WARMUP:
            steps.append((time.perf_counter() - t) * 1e3)
            grads.append((first_push[0] - t) * 1e3)
    out["fm_step_ms"] = statistics.median(steps)
    out["fm_forward_and_gradients_ms"] = statistics.median(grads)
    del model, kv, table

    gen = torch.Generator().manual_seed(SEED)
    out["nms_keep"] = {}
    for n_img, n, with_cls in NMS_SIZES:
        c = torch.rand((n_img, n, 2), generator=gen) * (n ** 0.5 * 4)
        s = 2.0 + torch.rand((n_img, n, 2), generator=gen) * 10.0
        boxes = torch.cat([c - s / 2, c + s / 2], -1).cuda()
        valid = (torch.rand((n_img, n), generator=gen) > 0.1).cuda()
        ids = torch.randint(0, 3, (n_img, n), generator=gen).float().cuda() \
            if with_cls else None
        out["nms_keep"][f"{n_img}x{n}"] = both(
            torch, lambda: tc.nms_keep(boxes, valid, ids, 0.45))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
