#!/usr/bin/env python3
"""Times of the port's flash-attention kernels on one CUDA card.

    python3 flash_cost.py [--root TREE] [--tag NAME]

Imports ``mxnet_tpu_torch`` from ``TREE`` (default: this file's
directory), builds its ``flash_attention_fwd`` and ``flash_attention_bwd``
kernels and prints one JSON line: the card's name and power limit, then,
at each of SHAPES (bf16), for each call its time (``ms``: back-to-back
calls, host included) and its device time (``device_ms``: the same calls
enqueued behind a device-side sleep, so the events see the device only),
the mean over REPS calls after a warm-up (CUDA events):

- ``fwd`` (#1): ``flash_attention_fwd``, and its wrapper's host time a
  call (``host_us``: the median over HOST_RUNS of REPS calls enqueued
  back to back, on the host's clock) and its C entry point's alone
  (``entry_host_us``: the same calls through ``ctypes`` on preallocated
  outputs, no Python wrapper);
- ``dq`` (#2): δ = rowsum(dO·O) and dQ, the route's cost before dK/dV
  runs: ``flash_attention_bwd_dq`` on the forward's O and lse where the
  tree's dQ kernel computes δ itself (``flash_attention_bwd_dq(q, k, v,
  o, do, lse, ...) -> (dq, delta)``), else the tree's ``_delta`` pass
  then its dQ kernel (``delta_in_dq`` says which), with whether two runs
  give the same bits of dq and δ (``deterministic``);
- ``dkv`` (#3): ``flash_attention_bwd_dkv`` on that δ, with its two host
  times too and whether two of its runs give the same bits
  (``deterministic``);
- ``sdpa_fwd`` and ``sdpa_bwd``: torch's ``scaled_dot_product_attention``
  on the same inputs, and its whole backward (the three gradients, on one
  retained graph): the library's yardsticks, which the port never calls.

To compare two trees, run it from each in one call on the same card,
alternating (A, B, B, A).
"""
import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 50
HOST_RUNS = 5
SEED = 24
# (name, B, H, T, D, causal): the Llama-3-8B training slice's attention and
# BERT-base's (B=64, T=128)
SHAPES = [("slice", 1, 32, 2048, 128, True), ("bert", 64, 12, 128, 64, False)]


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


def entry(torch, lib_name, symbol, tensors, tail):
    """A call of the C entry point ``symbol`` on ``tensors`` (pointers)
    and ``tail`` (its int and float arguments before the stream)."""
    from mxnet_tpu_torch import _kernels

    lib = _kernels.load(lib_name)
    fn = getattr(lib, symbol)
    args = [t.data_ptr() for t in tensors] + list(tail) + \
        [torch.cuda.current_stream().cuda_stream]

    def call():
        _kernels.check(lib, fn(*args), symbol)

    return call


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("flash_cost: no CUDA card", file=sys.stderr)
        return 2
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import flash_attention as fa

    _kernels.build(["flash_attention_fwd", "flash_attention_bwd"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = dict(tag=args.tag, root=args.root, nvidia_smi=smi,
               torch=torch.__version__)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, b, h, t, d, causal in SHAPES:
        q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        delta_in_dq = "o" in inspect.signature(
            fa.flash_attention_bwd_dq).parameters

        def fwd():
            return fa.flash_attention_fwd(q, k, v, causal, scale)

        def dq():
            if delta_in_dq:
                return fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal,
                                                 scale)
            d = fa._delta(o, do)
            return fa.flash_attention_bwd_dq(q, k, v, do, lse, d, causal,
                                             scale), d

        delta = dq()[1]

        def dkv():
            return fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                              causal, scale)

        row = dict(fwd=both(torch, fwd), dq=both(torch, dq),
                   dkv=both(torch, dkv))
        row["dq"]["delta_in_dq"] = delta_in_dq
        first, second = dq(), dq()
        row["dq"]["deterministic"] = all(
            bool(torch.equal(a, c)) for a, c in zip(first, second))
        row["fwd"]["host_us"] = host_us(torch, fwd)
        row["dkv"]["host_us"] = host_us(torch, dkv)
        tail = (b * h, t, t, d, fa._DTYPE_CODES[q.dtype], int(causal),
                scale)
        row["fwd"]["entry_host_us"] = host_us(torch, entry(
            torch, "flash_attention_fwd", "mxt_flash_attention_fwd_mma",
            (q, k, v, torch.empty_like(q), torch.empty_like(lse)), tail))
        row["dkv"]["entry_host_us"] = host_us(torch, entry(
            torch, "flash_attention_bwd",
            "mxt_flash_attention_bwd_dkv_mma",
            (q, k, v, do, lse, delta, torch.empty_like(k),
             torch.empty_like(v)), tail))
        first, second = dkv(), dkv()
        row["dkv"]["deterministic"] = all(
            bool(torch.equal(a, c)) for a, c in zip(first, second))
        row["sdpa_fwd"] = both(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                                   scale=scale))
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        graph_out = sdpa(qr, kr, vr, is_causal=causal, scale=scale)
        row["sdpa_bwd"] = both(torch, lambda: torch.autograd.grad(
            graph_out, (qr, kr, vr), do, retain_graph=True))
        del graph_out
        out[name] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
