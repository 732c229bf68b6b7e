#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA
card: Llama-3-8B inference and training through the hand-written
flash-attention kernels (forward, dQ, dK/dV; bf16 and f16 on the tensor
cores, f32 on the FMA pipes), Llama serving through
``mxnet_tpu_torch.serving.GenerativeServer`` (paged KV, continuous
batching, speculative verify, radix prefix reuse), and ResNet-50 v1
inference through the hand-written fused 1x1 conv + BatchNorm + ReLU
kernel (bf16 and f16 on the tensor cores, f32 on the FMA pipes), and its
training step; every optimizer update through the hand-written fused
multi-tensor kernel, and the CUDA graphs of ``hybridize()``,
``FusedTrainStep``, ``generate`` and the serving tick; ``.params`` files
and a checkpoint's round trip.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit.  Phases, each printed as a JSON line:

1. card: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc, and
   the torch precision flags the package turns off at import (TF32 and
   the bf16/f16 reduced-precision split-K reductions);
2. build: every source in ``csrc/`` with nvcc for sm_90a, all at once;
3. kernel: the forward kernel against its plain PyTorch version at every
   shape of ``KERNEL_SHAPES`` (bf16 and f16 at each D, Tq < Tk, rows
   that see no key, f32), O held row by row and by its relative norm,
   with its time and TFLOP/s, the plain version's, torch SDPA's (a
   yardstick only, where Tq = Tk) and the card's bound; at the slice shape also the wrapper's host time and the
   kernel launched alone through its C entry point;
4. backward kernels: ``flash_attention_bwd`` (dQ and dK/dV) against the
   plain backward at every shape of ``BWD_SHAPES``, each gradient held
   row by row and by its relative norm, with each kernel's time and
   TFLOP/s, delta's, the plain version's, torch SDPA's backward (where
   Tq = Tk) and the bound; at the slice shape also each kernel's wrapper
   host time and its launch alone through its C entry point;
5. fused kernel: ``fused_matmul_affine_relu`` against its plain version
   at ResNet-50 v1's eight shapes (B=128) in bf16 and in f16, one f32
   and one ragged shape, with its design, time, TFLOP/s, the plain
   version's time, the library's (``addmm`` with the scale folded, then
   ``relu``), the eager cuDNN chain's and the bound, and the NCHW ->
   (M, K) copy's time; then one bf16 and one f16 forward's sums;
5b. multi-tensor update: ``csrc/multi_tensor_update.cu`` against its
   plain version (the optimizers' per-tensor rules) for SGD, SGD with
   momentum, NAG, Adam and AdamW in f32, bf16, bf16 with f32 masters and
   f16 at ragged lengths (weights within 1 ulp, f32 states within 2), and
   over the 147 tensors of the 16-layer Llama training slice: its time
   beside the 18.97 ms bound, the plain rule's and the
   ``torch._foreach_*`` chain's (the library yardstick);
6. f32 check: ``llama3_8b`` width at 2 layers, f32, ``net(ids)`` through
   the kernel against the KV-cache decoder's dense prefill;
7. f32 training check: the same net, one loss and backward through the
   kernels (``attn_mode="flash"``) against dense torch autograd
   (``"sdpa"``): the loss and every parameter's gradient;
7b. bf16 checks: the same widths at 2 layers in bf16, at three seeds,
   through the tensor-core kernels: ``net(ids)`` against the dense route,
   then one loss and backward against dense torch autograd, logits and
   every gradient held by relative norm; and the witness, both routes
   against the dense route in f32 on the same weights, the kernels' route
   no further from it than the dense route is (within a factor);
7d. ``FusedTrainStep`` at the same widths, 2 layers, f32, K=2: one
   captured CUDA graph of forward, loss, backward (the flash kernels) and
   the fused update, against two eager steps; then a checkpoint of its
   training state, resumed into a fresh net and trainer: the next step's
   loss and weights equal the uninterrupted run's;
7c. serving exactness: the same widths at 2 layers in f32, 8 prompts of
   64-1024 tokens (32 new tokens each; 4 slots, max_len 2048, blocks of
   16) through ``GenerativeServer`` in the paged mode, the slots mode,
   with speculative decoding (the net as its own draft, spec_k=3), and
   8 prompts sharing a 512-token prefix with the radix cache: every
   reply equal to ``LlamaDecoder.generate`` on its prompt alone, token
   for token;
8. the Llama inference slice: ``llama3_8b`` at full width and depth in
   bf16, weights drawn on the card from a seed: one prompt forward
   (T=2048), eagerly and then hybridized (a replayed CUDA graph, logits
   against the eager ones), and three greedy ``generate`` requests, whose
   decode steps replay a CUDA graph, against the eager decoder's tokens
   and tokens/s;
8b. the serving slice on phase 8's net: 8 requests of 64-1024 tokens in
   the paged mode, in two waves (2, then 6 that join in-flight decode),
   each reply fed back through ``net(ids)`` (the flash forward) and
   every generated token held to the argmax within 24 bf16 ulps, and
   at least 240 of the 256 tokens equal to the offline decoder's (its
   tokens fed back the same way and the dense route's argmax are read
   as witnesses); the serving path itself launches no kernel of the
   port; TTFT, decode step times, tokens/s, prefill batch times, KV
   blocks and memory;
9. the Llama training slice: ``llama3_8b`` at full width and 16 layers in
   bf16, B=1, T=2048, SGD with momentum through ``gluon.Trainer``: one
   warm-up step and three timed steps on one batch, the update one launch
   of the multi-tensor kernel, its time beside its bound;
10. ResNet f32 checks: ``resnet50_v1`` f32, B=2, 224x224, on the card
    (16 fused launches of the FMA design, no TF32) against the CPU (the
    plain version);
    ``resnet18_v1`` thumbnail, one f32 SGD-momentum step on the card
    against the CPU;
11. the ResNet inference slice: ``resnet50_v1`` bf16, 224x224, B=128 and
    B=4, 16 fused launches of the tensor-core design a forward, eagerly
    and hybridized (graph replays against the eager logits); the weights
    through a ``.params`` file and ``pretrained=True`` from it, the same
    forward;
12. the ResNet training slice: ``resnet50_v1`` bf16, B=128, 224x224,
    SGD (lr 0.1, momentum 0.9) and ``SoftmaxCrossEntropyLoss`` (bench.py's
    protocol, eager): one warm-up step and three timed steps on one batch,
    no fused conv launch (BatchNorm normalizes by the batch), one
    multi-tensor update launch a step;
12b. ``FusedTrainStep(net, trainer, forward_loss, steps_per_execution=8,
    batch_size=128)`` on phase 12's net and batch at lr 0.01: 8 falling
    losses against 8 eager steps, then ms a step and images/s of 8
    replays.

The launch counters are set to 0 just before each slice (8, 8b, 9, 11;
the update's in 9, 12 and 12b) and read just after, and at the start of each check that counts them (6, 7,
7b); the bf16 slices must launch the tensor-core designs
(``launches_mma``), the f32 checks the FMA designs.  It exits non-zero on any failed check, and with no
result line when there is no CUDA card or the package is not beside it.
Its last line is ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES = 3.35e12
# (name, B, H, Tq, Tk, D, causal, dtype); shapes that reach the edges of
# the tensor-core design: every D in bf16 and f16, ragged T, Tq < Tk
# (bottom-right alignment) and Tq > Tk (rows that see no key)
MMA_SHAPES = [
    ("d16_bf16", 2, 4, 200, 200, 16, True, "bfloat16"),
    ("d32_bf16", 2, 4, 333, 333, 32, True, "bfloat16"),
    ("d64_bf16", 2, 8, 512, 512, 64, False, "bfloat16"),
    ("d16_f16", 2, 4, 200, 200, 16, True, "float16"),
    ("d32_f16", 2, 4, 333, 333, 32, True, "float16"),
    ("d64_f16", 2, 8, 512, 512, 64, False, "float16"),
    ("bottom_right_bf16", 1, 8, 300, 700, 128, True, "bfloat16"),
    ("masked_rows_bf16", 1, 8, 700, 300, 128, True, "bfloat16"),
]
# the first is the slice's shape
KERNEL_SHAPES = [
    ("slice", 1, 32, 2048, 2048, 128, True, "bfloat16"),
    ("ragged", 2, 32, 1000, 1000, 128, True, "bfloat16"),
    ("noncausal_f32", 2, 4, 256, 256, 64, False, "float32"),
    ("bottom_right", 1, 2, 4, 6, 32, True, "float32"),
    ("d16", 2, 4, 128, 128, 16, True, "float32"),
] + MMA_SHAPES
# f32: another summation order than the plain version; bf16: the kernel's
# output is rounded to 8 mantissa bits; lse is f32 in both
O_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
LSE_TOL = 1e-3
# O is also held row by row, as the gradients are (``grad_errors``): each
# row's largest error within O_ROW_TOL of the row's largest reference
# value, so that the small outputs of late causal rows (|O| about 0.03 at
# T = 2048) are held as tightly as the large early ones; and the whole
# tensor by ||O - O_ref|| / ||O_ref|| <= O_NORM_TOL.  bf16/f16 (unit
# roundoff u = 2^-8 / 2^-11): the tensor-core kernel rounds P before P·V,
# which moves each term of a row's sum by at most u of itself, and rounds
# O, which moves each value by at most u: 2u.  f32: another summation
# order, as for the gradients
O_ROW_TOL = {"float32": 1e-4, "bfloat16": 2 * 2.0 ** -8,
             "float16": 2 * 2.0 ** -11}
O_NORM_TOL = {"float32": 1e-5, "bfloat16": 2 * 2.0 ** -8,
              "float16": 2 * 2.0 ** -11}
# (name, B, H, Tq, Tk, D, causal, dtype); the first is the training
# slice's shape
BWD_SHAPES = [
    ("slice", 1, 32, 2048, 2048, 128, True, "bfloat16"),
    ("ragged", 2, 32, 1000, 1000, 128, True, "bfloat16"),
    ("noncausal_f32", 2, 4, 256, 256, 64, False, "float32"),
    ("bottom_right", 1, 2, 4, 6, 32, True, "float32"),
    ("masked_rows", 1, 2, 6, 4, 32, True, "float32"),
    ("d16", 2, 4, 128, 128, 16, True, "float32"),
] + MMA_SHAPES
# Each gradient is held row by row (a row: one query's dq, one key's dk
# or dv): the row's largest error within ROW_TOL of the row's largest
# reference value, so that the small late rows of a causal gradient are
# held as tightly as the large early ones; and the whole tensor by
# ||g - r|| / ||r|| <= NORM_TOL.  f32: another summation order; bf16:
# the kernels' f32 results are rounded to 8 mantissa bits, at most 2^-8
# (3.9e-3) of each value
ROW_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2e-3}
NORM_TOL = {"float32": 1e-5, "bfloat16": 5e-3, "float16": 1e-3}
# f32 training check: every gradient within this share of the largest
# gradient of the same tensor; both routes are f32 (no TF32), the
# attention sums run in other orders and the difference propagates
# through two layers and the LM head
TRAIN_GRAD_TOL = 1e-3
# bf16 checks (2 layers): both routes run the same bf16 weights through the
# same bf16 matmuls and differ inside attention only, where each rounds to
# bf16 at other places (the kernels round P before it is normalised and
# keep dP in f32; the dense route rounds the normalised P and, under
# autograd, dP).  A rounding moves a value by at most u = 2^-8 of itself,
# so a layer's attention output differs by about u in relative norm; two
# layers carry that to the logits with little gain: logits by relative
# norm within 2u a layer (4u = 1.6e-2); each gradient, which the backward
# rounds at two more places (dS, dP), within 8u (3.1e-2)
BF16_LOGIT_TOL = 4 * 2.0 ** -8
BF16_GRAD_TOL = 8 * 2.0 ** -8
# the bf16 checks' witness: the same weights cast to f32 (exactly) through
# the dense route in f32 give a reference free of bf16 rounding; each bf16
# route's distance to it (relative norm) is that route's own rounding.
# The kernels' route must be as close to it as the dense route is, within
# this factor, for the logits and for every gradient.  On an H100 the
# ratio read 0.970-0.9994 over three seeds (logits and 21 gradients each;
# both routes 3.3-8.1u from the f32 route, the gap between them at most
# 6.3u: their roundings are largely shared, not independent), so a
# fault that adds 1% of the logits' norm to the kernels' route (ratio
# about 1.2) fails it
BF16_WITNESS_RATIO = 1.1
BF16_SEEDS = (SEED, SEED + 1, SEED + 2)
# the bf16 checks' readings at each seed of BF16_SEEDS when the bf16 dQ ran
# on the f32 FMA design (dS kept in f32; the forward and dK/dV on the
# tensor cores), printed beside this run's: (worst gradient's relative
# norm, worst witness ratio)
FMA_DQ_BF16_READINGS = {SEED: (0.024321584030985832, 0.9992440410578218),
                        SEED + 1: (0.02446492575109005, 0.9993867572421938),
                        SEED + 2: (0.024472074583172798, 0.9961660372186644)}
# the training slice's four losses (the same bits in every run) when its
# bf16 forward, dQ and dK/dV all ran on the f32 FMA designs, and when only
# dQ did, printed beside this run's: the tensor-core designs round P and dS
# to bf16, so they move
FMA_DESIGN_LOSSES = [12.569117546, 10.207187653, 8.730205536, 6.096673965]
FMA_DQ_LOSSES = [12.569450378, 10.208418846, 8.703302383, 6.157677650]
TRAIN_LAYERS = 16
TRAIN_LR = 0.1
REQUESTS = [(1, 100), (4, 512), (1, 1500)]  # (batch, prompt length)
# a bf16 graph replay against the eager forward: the same kernels on the
# same inputs, so the same bits are expected; held within one bf16 step
# (2^-8) of the largest eager value
GRAPH_BF16_TOL = 2.0 ** -8
NEW_TOKENS = 32


def design_name(design, dtype):
    """A kernel design as the ``kernels`` line names it, such as
    ``"mma.sync bf16"``."""
    names = {"mma": "mma.sync", "fma": "FMA"}
    short = {"float32": "f32", "float16": "f16", "bfloat16": "bf16"}
    return f"{names[design]} {short[dtype]}"


def emit(obj):
    print(json.dumps(obj), flush=True)


def run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (out.stdout or out.stderr).strip()


def free_card(torch):
    """Release the card memory of the nets an earlier phase dropped: a
    Gluon net holds reference cycles (blocks, decoders), which only the
    cycle collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(torch, fn, iters, hide_host=False):
    """Mean device time of ``fn`` over ``iters`` back-to-back launches,
    after one warm-up call (CUDA events).  ``hide_host``: the window opens
    behind a device-side sleep of 2e8 cycles (about 0.1 s at the H100's
    1.98 GHz), so that the host has enqueued every call before the first
    one runs and the events see device time only (for calls whose host
    time exceeds their device time, such as torch autograd's backward)."""
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


def host_us(torch, fn, iters):
    """Host time of one ``fn`` call in us: ``iters`` calls enqueued back
    to back (no synchronisation between them), on the host's clock."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def launch_only_ms(torch, lib_name, symbol, tensors, tail, iters):
    """Device time of a kernel launched through its C entry point alone,
    on the given (preallocated) tensors: no wrapper checks, no
    allocation.  ``tail``: the entry point's int and float arguments
    before the stream."""
    from mxnet_tpu_torch import _kernels

    lib = _kernels.load(lib_name)
    fn = getattr(lib, symbol)
    args = [t.data_ptr() for t in tensors] + list(tail) + \
        [torch.cuda.current_stream().cuda_stream]

    def launch():
        _kernels.check(lib, fn(*args), symbol)

    return time_ms(torch, launch, iters)


def visible_pairs(tq, tk, causal):
    """(query, key) pairs the mask keeps (bottom-right causal)."""
    if causal:
        return sum(min(tk, max(0, i + tk - tq + 1)) for i in range(tq))
    return tq * tk


def roofline_ms(flops, nbytes, dtype):
    """The larger of the operations over the dtype's peak and the bytes
    over the memory rate, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def bound_ms(b, h, tq, tk, d, causal, dtype, itemsize):
    """Least time for the forward on the card: q, k, v read once, O and
    lse written once; 2 products of 2·D flops per visible pair."""
    flops = 4.0 * d * visible_pairs(tq, tk, causal) * b * h
    nbytes = itemsize * b * h * d * (2 * tq + 2 * tk) + 4 * b * h * tq
    return roofline_ms(flops, nbytes, dtype)


def bwd_bound_ms(b, h, tq, tk, d, causal, dtype, itemsize, products,
                 reads_o, writes):
    """Least time for (part of) the backward: q, k, v, dO (and O, for δ)
    read once, lse and δ read once, ``writes`` rows of D values written
    once; ``products`` products of 2·D flops per visible pair."""
    flops = 2.0 * d * products * visible_pairs(tq, tk, causal) * b * h
    rows_read = 2 * tq + 2 * tk + (tq if reads_o else 0)
    nbytes = itemsize * b * h * d * (rows_read + writes) + \
        8 * b * h * tq
    return roofline_ms(flops, nbytes, dtype)


def kernel_phase(torch, fa, failures):
    """Phase 3: the kernel against the plain version at each shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = []
    for name, b, h, tq, tk, d, causal, dt in KERNEL_SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, h, tq, d, generator=gen, device="cuda",
                        dtype=dtype)
        k = torch.randn(b, h, tk, d, generator=gen, device="cuda",
                        dtype=dtype)
        v = torch.randn(b, h, tk, d, generator=gen, device="cuda",
                        dtype=dtype)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        # the plain version's arithmetic is f32 whatever the input dtype;
        # it runs on f32 copies so its own output rounding is not counted
        o_ref, lse_ref = fa._fa_forward_plain(q.float(), k.float(),
                                              v.float(), causal, scale)
        err_o, share_o, norm_o = grad_errors(torch, o, o_ref)
        fin = torch.isfinite(lse_ref)
        fin_same = bool(torch.equal(fin, torch.isfinite(lse)))
        err_lse = (lse - lse_ref)[fin].abs().max().item() if fin.any() \
            else 0.0
        ok = (fin_same and math.isfinite(err_o) and err_o <= O_TOL[dt]
              and share_o <= O_ROW_TOL[dt] and norm_o <= O_NORM_TOL[dt]
              and err_lse <= LSE_TOL and bool(torch.isfinite(o).all()))
        iters = 20 if tq * tk * b * h > 1e7 else 100
        k_ms = time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal, scale), iters)
        p_ms = time_ms(torch, lambda: fa._fa_forward_plain(
            q, k, v, causal, scale), max(iters // 4, 5))
        lib_ms = None
        if tq == tk:  # torch SDPA's is_causal is top-left: equal here only
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                                 scale=scale), iters,
                             hide_host=True)
        bnd, by = bound_ms(b, h, tq, tk, d, causal, dt, q.element_size())
        flops = 4.0 * d * visible_pairs(tq, tk, causal) * b * h
        row = dict(phase="kernel", shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d,
                   causal=causal, dtype=dt, design=fa._design(dtype),
                   max_abs_err_o=err_o, row_share_o=share_o,
                   rel_norm_o=norm_o,
                   max_abs_err_lse=err_lse, masked_rows_agree=fin_same,
                   tol_o=O_TOL[dt], row_tol_o=O_ROW_TOL[dt],
                   norm_tol_o=O_NORM_TOL[dt], tol_lse=LSE_TOL,
                   kernel_ms=k_ms,
                   tflops=flops / k_ms * 1e-9,
                   plain_ms=p_ms, library_ms=lib_ms, bound_ms=bnd,
                   bound_by=by, ok=ok)
        if not rows:  # the slice shape: the wrapper's own cost
            row["wrapper_host_us"] = host_us(torch, lambda: (
                fa.flash_attention_fwd(q, k, v, causal, scale)), iters)
            row["launch_only_ms"] = launch_only_ms(
                torch, "flash_attention_fwd",
                f"mxt_flash_attention_fwd_{fa._design(dtype)}",
                (q, k, v, o, lse), (b * h, tq, tk, d, fa._DTYPE_CODES[dtype],
                                    int(causal), scale), iters)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"kernel {name}: O err {err_o} (row share "
                            f"{share_o}, norm {norm_o}), lse err "
                            f"{err_lse}, masked rows agree {fin_same}")
    return rows


def dq_zero_row(causal, tq, tk):
    """The query that sees key 0 alone (causal, Tq >= Tk): there P = 1 and
    O = V_0, so dP - δ cancels and its dq is 0 in exact arithmetic; the
    kernel's and the plain version's are rounding noise of f32 sums taken
    in other orders."""
    return tq - tk if causal and tq >= tk else None


def grad_errors(torch, g, r, zero_row=None):
    """(max abs error, worst row share, relative norm) of a kernel's
    result ``g`` (an attention output or a gradient) against its f32
    reference ``r``; a row's share is its largest error
    over its largest reference value, or over ``g``'s dtype's smallest
    normal number where that is larger (f16 rounds smaller values to a
    fixed step; for bf16 and f32 a zero row must match exactly), as
    ``tests/test_torch_kernels_cuda.py`` holds it.  ``zero_row``
    (``dq_zero_row``) is shared over the tensor's largest reference
    value instead of its own."""
    diff = (g.float() - r).abs()
    floor = torch.finfo(g.dtype).tiny
    row_err, row_ref = diff.amax(-1), r.abs().amax(-1).clamp_min(floor)
    if zero_row is not None:
        row_ref[..., zero_row] = r.abs().max()
    share = row_err / row_ref
    norm = (torch.linalg.vector_norm(g.float() - r) /
            torch.linalg.vector_norm(r).clamp_min(1e-30))
    return diff.max().item(), share.max().item(), norm.item()


def backward_phase(torch, fa, failures):
    """Phase 4: ``flash_attention_bwd`` (δ, then the dQ and dK/dV kernels)
    against the plain backward at each shape (the plain version on f32
    copies of the same inputs and the kernel forward's O and lse); then
    each kernel and δ timed alone."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    rows = []
    for name, b, h, tq, tk, d, causal, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)

        def rnd(t):
            return torch.randn(b, h, t, d, generator=gen, device="cuda",
                               dtype=dtype)

        q, k, v, do = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal, scale)
        torch.cuda.synchronize()
        ref = fa._fa_backward_plain(q.float(), k.float(), v.float(),
                                    o.float(), do.float(), lse, causal,
                                    scale)
        row = dict(phase="backward_kernels", shape=name, B=b, H=h, Tq=tq,
                   Tk=tk, D=d, causal=causal, dtype=dt,
                   row_tol=ROW_TOL[dt], norm_tol=NORM_TOL[dt])
        ok = True
        zero_rows = (dq_zero_row(causal, tq, tk), None, None)
        for key, g, r, zero_row in zip(("dq", "dk", "dv"), got, ref,
                                       zero_rows):
            err, share, norm = grad_errors(torch, g, r, zero_row)
            row[f"max_abs_err_{key}"] = err
            row[f"row_share_{key}"], row[f"rel_norm_{key}"] = share, norm
            ok = ok and share <= ROW_TOL[dt] and norm <= NORM_TOL[dt] and \
                bool(torch.isfinite(g).all())
        masked = tq - tk if causal and tq > tk else 0
        if masked:  # rows that see no key: dq exactly 0
            row["masked_rows_dq_zero"] = bool(
                (got[0][:, :, :masked] == 0).all())
            ok = ok and row["masked_rows_dq_zero"]
        delta = fa._delta(o, do)
        iters = 10 if tq * tk * b * h > 1e7 else 50
        row["delta_ms"] = time_ms(torch, lambda: fa._delta(o, do), iters)
        row["dq_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal, scale), iters)
        row["dkv_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal, scale), iters)
        row["plain_ms"] = time_ms(torch, lambda: fa._fa_backward_plain(
            q, k, v, o, do, lse, causal, scale), max(iters // 4, 3))
        row["library_ms"] = None
        if tq == tk:  # torch SDPA's is_causal is top-left: equal here only
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

            # its backward alone (all three gradients), on one retained
            # graph
            out = sdpa(qr, kr, vr, is_causal=causal, scale=scale)
            row["library_ms"] = time_ms(
                torch, lambda: torch.autograd.grad(out, (qr, kr, vr), do,
                                                   retain_graph=True),
                iters, hide_host=True)
            del out
        shape = (b, h, tq, tk, d, causal, dt, q.element_size())
        row["bound_ms"], row["bound_by"] = bwd_bound_ms(
            *shape, products=5, reads_o=True, writes=tq + 2 * tk)
        row["dq_bound_ms"], row["dq_bound_by"] = bwd_bound_ms(
            *shape, products=3, reads_o=False, writes=tq)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bwd_bound_ms(
            *shape, products=4, reads_o=False, writes=2 * tk)
        pairs = visible_pairs(tq, tk, causal) * b * h
        design = fa._design(dtype)
        row["dq_design"] = row["dkv_design"] = design
        row["dkv_tflops"] = 8.0 * d * pairs / row["dkv_ms"] * 1e-9
        row["dq_tflops"] = 6.0 * d * pairs / row["dq_ms"] * 1e-9
        if not rows:  # the slice shape: the wrappers' own cost
            tail = (b * h, tq, tk, d, fa._DTYPE_CODES[dtype], int(causal),
                    scale)
            row["dq_wrapper_host_us"] = host_us(
                torch, lambda: fa.flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, causal, scale), iters)
            row["dq_launch_only_ms"] = launch_only_ms(
                torch, "flash_attention_bwd",
                f"mxt_flash_attention_bwd_dq_{design}",
                (q, k, v, do, lse, delta, torch.empty_like(q)), tail, iters)
            row["dkv_wrapper_host_us"] = host_us(
                torch, lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, causal, scale), iters)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            row["dkv_launch_only_ms"] = launch_only_ms(
                torch, "flash_attention_bwd",
                f"mxt_flash_attention_bwd_dkv_{design}",
                (q, k, v, do, lse, delta, dk, dv), tail, iters)
        row["ok"] = ok
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"backward kernels {name}: {row}")
    return rows


def _lm_forward(mx, net, ids, labels):
    """Recorded forward and token cross entropy (summed, / tokens)."""
    vocab = net.config.vocab_size
    with mx.autograd.record():
        return mx.nd.softmax_cross_entropy(
            net(ids).reshape((-1, vocab)), labels.reshape((-1,))) / \
            labels.size


def _lm_loss(mx, net, ids, labels):
    """Forward, loss and backward; returns the loss as a float."""
    loss = _lm_forward(mx, net, ids, labels)
    loss.backward()
    return float(loss.asscalar())


def _counters(fa):
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


def _mma_counts(fa):
    """Launches of the tensor-core designs: (forward, dQ, dK/dV); the f32
    FMA designs' are the rest of each kernel's ``.launches``."""
    return [c.launches_mma for c in _counters(fa)]


def _zero_counts(fa):
    """Every launch count of the flash kernels (total and per design)."""
    for c in _counters(fa):
        for key in [a for a in vars(c) if a.startswith("launches")]:
            setattr(c, key, 0)


def _rel_norm(torch, a, b):
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b) /
            torch.linalg.vector_norm(b).clamp_min(1e-30)).item()


def _ids_labels(torch, mx, vocab, t, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(0, vocab, (1, t + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    return mx.nd.array(tokens[:, :-1]), mx.nd.array(tokens[:, 1:])


def f32_train_phase(torch, mx, llama, fa, failures):
    """Phase 7: full width, 2 layers, f32, T=1024: one loss and backward
    through the kernels (flash) and through dense torch autograd (sdpa),
    same weights and batch; the loss and every gradient compared."""
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=2)
    net.initialize(ctx=mx.gpu(0))
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 1024,
                              SEED + 4)
    params = net._collect_params_with_prefix()
    _zero_counts(fa)
    loss_flash = _lm_loss(mx, net, ids, labels)
    grads = {k: p.grad()._data.clone() for k, p in params.items()}
    net.config.attn_mode = "sdpa"
    loss_sdpa = _lm_loss(mx, net, ids, labels)
    launched = [c.launches for c in _counters(fa)]  # the FMA designs'
    mma = _mma_counts(fa)
    worst, worst_name = 0.0, None
    for k, p in params.items():
        ref = p.grad()._data
        share = ((grads[k] - ref).abs().max() /
                 ref.abs().max().clamp_min(1e-30)).item()
        if not share <= worst:
            worst, worst_name = share, k
    ok = launched == [2, 2, 2] and mma == [0, 0, 0] and \
        math.isfinite(loss_flash) and \
        abs(loss_flash - loss_sdpa) <= 1e-5 * abs(loss_sdpa) and \
        worst <= TRAIN_GRAD_TOL
    emit(dict(phase="f32_train_check", layers=2, T=1024,
              launches=dict(zip(("fwd", "dq", "dkv"), launched)),
              launches_mma=dict(zip(("fwd", "dq", "dkv"), mma)),
              loss_flash=loss_flash, loss_sdpa=loss_sdpa,
              params=len(params), worst_grad_err_share=worst,
              worst_param=worst_name, tol=TRAIN_GRAD_TOL, ok=ok))
    if not ok:
        failures.append(f"f32 training check: launches {launched} "
                        f"(tensor-core {mma}), loss "
                        f"{loss_flash} vs {loss_sdpa}, worst gradient "
                        f"{worst} ({worst_name})")
    del net, grads, params
    free_card(torch)


def _route(torch, mx, net, ids, labels, params, mode):
    """``net(ids)`` and one loss and backward through ``attn_mode=mode``:
    (logits, loss, {name: gradient})."""
    net.config.attn_mode = mode
    logits = net(ids)._data
    loss = _lm_loss(mx, net, ids, labels)
    return logits, loss, {k: p.grad()._data.clone()
                          for k, p in params.items()}


def bf16_phase(torch, mx, llama, fa, failures):
    """Phase 7b: full width, 2 layers, bf16, T=1024, at each seed of
    ``BF16_SEEDS``: ``net(ids)`` and one loss and backward through the
    tensor-core kernels, against the dense route (``attn_mode="sdpa"``)
    on the same weights, logits and every gradient held by relative norm;
    then the witness, both routes against the dense route in f32 on the
    same weights."""
    for seed in BF16_SEEDS:
        mx.random.seed(seed)
        net = llama.llama3_8b(num_layers=2)
        net.cast("bfloat16")
        net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
        ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 1024,
                                  seed + 12)
        params = net._collect_params_with_prefix()
        _zero_counts(fa)
        flash = _route(torch, mx, net, ids, labels, params, "flash")
        launched = [c.launches for c in _counters(fa)] + _mma_counts(fa)
        dense = _route(torch, mx, net, ids, labels, params, "sdpa")
        net.cast("float32")
        ref = _route(torch, mx, net, ids, labels, params, "sdpa")
        launched_dense = [c.launches for c in _counters(fa)] + \
            _mma_counts(fa)
        # relative norms: kernels vs dense, kernels vs f32, dense vs f32
        gap = {"logits": _rel_norm(torch, flash[0], dense[0])}
        to_ref = {"logits": (_rel_norm(torch, flash[0], ref[0]),
                             _rel_norm(torch, dense[0], ref[0]))}
        for k in params:
            gap[k] = _rel_norm(torch, flash[2][k], dense[2][k])
            to_ref[k] = (_rel_norm(torch, flash[2][k], ref[2][k]),
                         _rel_norm(torch, dense[2][k], ref[2][k]))
        ratio = {k: f / max(d, 1e-30) for k, (f, d) in to_ref.items()}
        worst = max(params, key=gap.get)
        worst_ratio = max(ratio, key=ratio.get)
        loss_flash, loss_sdpa = flash[1], dense[1]
        # 4 forward launches (net(ids), then the loss), 2 dQ, 2 dK/dV, all
        # tensor-core; the dense and f32 routes launch none
        ok = launched == [4, 2, 2, 4, 2, 2] and launched_dense == launched \
            and math.isfinite(loss_flash) and \
            gap["logits"] <= BF16_LOGIT_TOL and \
            abs(loss_flash - loss_sdpa) <= BF16_LOGIT_TOL * abs(loss_sdpa) \
            and gap[worst] <= BF16_GRAD_TOL and \
            ratio[worst_ratio] <= BF16_WITNESS_RATIO
        fma_dq = FMA_DQ_BF16_READINGS.get(seed, (None, None))
        emit(dict(phase="bf16_check", seed=seed, layers=2, T=1024,
                  launches=dict(zip(("fwd", "dq", "dkv"), launched)),
                  launches_mma=dict(zip(("fwd", "dq", "dkv"), launched[3:])),
                  logit_rel_norm=gap["logits"], loss_flash=loss_flash,
                  loss_sdpa=loss_sdpa, loss_f32=ref[1], params=len(params),
                  worst_grad_rel_norm=gap[worst], worst_param=worst,
                  worst_grad_rel_norm_fma_dq=fma_dq[0],
                  tol_logits=BF16_LOGIT_TOL, tol_grads=BF16_GRAD_TOL,
                  witness_flash_dense_to_f32=to_ref,
                  worst_witness_ratio=ratio[worst_ratio],
                  worst_witness_param=worst_ratio,
                  worst_witness_ratio_fma_dq=fma_dq[1],
                  tol_witness_ratio=BF16_WITNESS_RATIO, ok=ok))
        if not ok:
            failures.append(
                f"bf16 check seed {seed}: launches {launched}, "
                f"{launched_dense}, logits {gap['logits']}, loss "
                f"{loss_flash} vs {loss_sdpa}, worst gradient {gap[worst]} "
                f"({worst}), witness ratio {ratio[worst_ratio]} "
                f"({worst_ratio})")
        del net, params, flash, dense, ref
        free_card(torch)


def train_phase(torch, mx, llama, fa, mt, failures):
    """Phase 9: llama3_8b at full width, 16 layers, bf16, B=1, T=2048,
    SGD with momentum — the training main path; the update is one launch
    of the fused multi-tensor kernel a step, printed beside its bound."""
    free_card(torch)
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=TRAIN_LAYERS)
    net.cast("bfloat16")
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": TRAIN_LR, "momentum": 0.9})
    torch.cuda.synchronize()
    emit(dict(phase="train_init", seconds=time.perf_counter() - t,
              layers=TRAIN_LAYERS, params=sum(
                  p.data().size for p in net.collect_params().values()),
              memory_allocated=torch.cuda.memory_allocated()))
    ids, labels = _ids_labels(torch, mx, net.config.vocab_size, 2048,
                              SEED + 5)
    _zero_counts(fa)  # the main path starts here
    losses, step_ms, peaks = [], [], []

    def phase_end(stamps, phase_peaks):
        """Wait for the card; note the clock and the phase's peak of
        allocated memory, and start the next phase's peak."""
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        phase_peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    mt.multi_tensor_update.launches = 0  # the update's main path starts
    for step in range(4):  # one warm-up, then three timed steps
        before = [c.launches for c in _counters(fa)]
        before_mma = _mma_counts(fa)
        stamps, step_peaks = [], []
        phase_end(stamps, [])
        loss_nd = _lm_forward(mx, net, ids, labels)
        phase_end(stamps, step_peaks)
        loss_nd.backward()
        phase_end(stamps, step_peaks)
        mt_before = mt.multi_tensor_update.launches
        trainer.step(1)
        phase_end(stamps, step_peaks)
        update_launches = mt.multi_tensor_update.launches - mt_before
        peaks.extend(step_peaks)
        loss = float(loss_nd.asscalar())
        fwd_ms, bwd_ms, update_ms = ((b - a) * 1e3 for a, b in
                                     zip(stamps, stamps[1:]))
        ms = (stamps[-1] - stamps[0]) * 1e3
        launched = [c.launches - n for c, n in zip(_counters(fa), before)]
        mma = [c - n for c, n in zip(_mma_counts(fa), before_mma)]
        losses.append(loss)
        if step:
            step_ms.append(ms)
        ok = math.isfinite(loss) and launched == [TRAIN_LAYERS] * 3 and \
            mma == [TRAIN_LAYERS] * 3 and update_launches == 1
        emit(dict(phase="train_step", step=step, warmup=step == 0,
                  loss=loss, ms=ms, tokens_per_s=2048 / ms * 1e3,
                  forward_ms=fwd_ms, backward_ms=bwd_ms,
                  update_ms=update_ms,
                  update_bound_ms=update_bound_ms(trainer),
                  update_launches=update_launches,
                  launches=dict(zip(("fwd", "dq", "dkv"), launched)),
                  launches_mma=dict(zip(("fwd", "dq", "dkv"), mma)),
                  max_memory_allocated=dict(zip(
                      ("forward", "backward", "update"), step_peaks)),
                  ok=ok))
        if not ok:
            failures.append(f"train step {step}: loss {loss}, launches "
                            f"{launched}, tensor-core launches {mma}, "
                            f"update launches {update_launches}")
    launches = [c.launches for c in _counters(fa)]  # the main path ends
    update_launches = mt.multi_tensor_update.launches  # ... ends
    kernel_ms, tensors = update_kernel_ms(torch, mt, trainer, 3)
    launches_mma = _mma_counts(fa)
    emit(dict(phase="train_memory", max_memory_allocated=max(peaks)))
    if not losses[-1] < losses[0]:
        failures.append(f"training loss did not fall: {losses}")
    if min(launches + launches_mma) == 0:
        failures.append(f"the training path left a kernel unlaunched: "
                        f"{launches}, tensor-core {launches_mma}")
    emit(dict(phase="train_summary", losses=losses,
              losses_fma_design=FMA_DESIGN_LOSSES,
              losses_fma_dq=FMA_DQ_LOSSES,
              step_ms=step_ms,
              launches=dict(zip(("fwd", "dq", "dkv"), launches)),
              launches_mma=dict(zip(("fwd", "dq", "dkv"), launches_mma)),
              update_launches=update_launches,
              update_kernel_ms=kernel_ms, update_tensors=tensors,
              update_bound_ms=update_bound_ms(trainer),
              ok=losses[-1] < losses[0]))
    return launches, launches_mma, update_launches


def f32_phase(torch, mx, llama, fa, failures):
    """Phase 6: full width, 2 layers, f32: the flash forward against the
    decoder's dense prefill on the same ids."""
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=2)
    net.initialize(ctx=mx.gpu(0))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    ids = torch.randint(0, net.config.vocab_size, (1, 1024), generator=gen,
                        device="cuda", dtype=torch.int32)
    _zero_counts(fa)
    logits = net(mx.nd.array(ids))._data[:, -1].float()
    launched = fa.flash_attention_fwd.launches  # the FMA design's
    mma = fa.flash_attention_fwd.launches_mma
    dec = llama.LlamaDecoder(net, max_len=1024)
    with torch.no_grad():
        _, ref = dec._prefill_impl(dec._weights(), ids, 1024)
    err = (logits - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = launched == 2 and mma == 0 and err <= 1e-3 * scale and \
        math.isfinite(err)
    emit(dict(phase="f32_check", layers=2, T=1024, launches=launched,
              launches_mma=mma,
              max_abs_err=err, max_abs_logit=scale,
              tol=1e-3 * scale, ok=ok))
    if not ok:
        failures.append(f"f32 check: launches {launched} (tensor-core "
                        f"{mma}), err {err} vs "
                        f"{1e-3 * scale}")
    del net, dec, logits, ref
    free_card(torch)


SERVE_PROMPTS = 8
SERVE_NEW = 32
SERVE_MAX_LEN = 2048
SERVE_SLOTS = 4
SERVE_BLOCK = 16
SERVE_PREFIX = 512       # the radix mode's shared prefix
# phase 8b: near-argmax within this many bf16 ulps; the offline decoder
# and the dense route both read 19 at worst on this traffic (PERF.md)
SERVE_ULPS = 24
SERVE_SAME_MIN = 240     # phase 8b: of 256 tokens, at least this many
                         # equal to the offline decoder's (252 read)


def _serve_prompts(vocab):
    """The serving phases' traffic from the seed: 8 prompts of 64-1024
    tokens, and 8 more that share one 512-token prefix (suffixes of
    16-512 tokens)."""
    rs = np.random.RandomState(SEED + 20)
    lens = rs.randint(64, 1025, size=SERVE_PROMPTS)
    plain = [rs.randint(0, vocab, size=n).astype(np.int32) for n in lens]
    prefix = rs.randint(0, vocab, size=SERVE_PREFIX).astype(np.int32)
    shared = [np.concatenate([prefix, rs.randint(0, vocab, size=n)])
              .astype(np.int32)
              for n in rs.randint(16, 513, size=SERVE_PROMPTS)]
    return plain, shared


def _serve(serving, net, prompts, first_wave=None, **kw):
    """Serve ``prompts`` (SERVE_NEW tokens each) through a fresh
    ``GenerativeServer``: all at once, or in two waves, the first
    ``first_wave`` prompts, then the rest once those are decoding.
    Returns (replies, server, stats, wall seconds from the first submit
    to the last reply)."""
    cfg = serving.ServerConfig(max_batch=SERVE_SLOTS,
                               max_length=SERVE_MAX_LEN,
                               num_slots=SERVE_SLOTS,
                               block_size=SERVE_BLOCK,
                               queue_capacity=4 * SERVE_PROMPTS, **kw)
    srv = serving.GenerativeServer(net, cfg)
    cut = first_wave or len(prompts)
    with srv:
        t = time.perf_counter()
        futs = [srv.submit(p, max_new_tokens=SERVE_NEW)
                for p in prompts[:cut]]
        if cut < len(prompts):
            deadline = time.time() + 300
            while srv.engine.steps < 2 and time.time() < deadline:
                time.sleep(0.001)
            futs += [srv.submit(p, max_new_tokens=SERVE_NEW)
                     for p in prompts[cut:]]
        replies = [f.result(600) for f in futs]
        wall_s = time.perf_counter() - t
        stats = srv.stats()
    return replies, srv, stats, wall_s


def serving_f32_phase(torch, mx, llama, serving, failures):
    """Phase 7c: serving exactness.  llama3_8b widths at 2 layers, f32:
    the same 8 prompts served in the paged mode, the slots mode, with
    speculative decoding (the net as its own draft, spec_k=3), and 8
    prompts sharing a 512-token prefix with the radix cache; every reply
    must equal ``LlamaDecoder.generate`` on that prompt alone, token for
    token."""
    free_card(torch)
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=2)
    net.initialize(ctx=mx.gpu(0))
    plain, shared = _serve_prompts(net.config.vocab_size)
    dec = llama.LlamaDecoder(net, max_len=SERVE_MAX_LEN)
    t = time.perf_counter()
    ref = {id(p): dec.generate(p[None], SERVE_NEW)[0].cpu().numpy()
           for p in plain + shared}
    ref_s = time.perf_counter() - t
    modes = [("paged", plain, {}), ("slots", plain, {"kv_mode": "slots"}),
             ("speculative", plain, {"draft_net": net, "spec_k": 3}),
             ("radix", shared, {"radix_cache": True})]
    for mode, prompts, kw in modes:
        replies, srv, stats, wall_s = _serve(serving, net, prompts, **kw)
        wrong = [i for i, (p, r) in enumerate(zip(prompts, replies))
                 if not np.array_equal(r, ref[id(p)])]
        first_bad = None
        if wrong:
            p, r = prompts[wrong[0]], replies[wrong[0]]
            first_bad = int(np.argmax(r != ref[id(p)]) - len(p))
        row = dict(phase="serving_f32", mode=mode, layers=2,
                   prompts=[len(p) for p in prompts], new_tokens=SERVE_NEW,
                   replies_equal=len(prompts) - len(wrong),
                   wrong=wrong, first_wrong_token=first_bad,
                   wall_s=wall_s, reference_s=ref_s,
                   decode_ticks=len(srv.replicas[0].tick_ms)
                   if srv.replicas else stats["decode_steps"],
                   compiled_signatures=[list(s) for s in
                                        stats["compiled_signatures"]],
                   kv_blocks_peak=stats["kv_cache"].get(
                       "peak_blocks_in_use"))
        if mode == "speculative":
            row["speculative"] = stats["speculative"]
        if mode == "radix":
            row["radix"] = stats["radix_cache"]
            row["peak_shared_blocks"] = \
                stats["kv_cache"]["peak_shared_blocks"]
        ok = not wrong and stats["completed"] == len(prompts) and \
            stats["failed"] == 0
        if mode == "speculative":
            ok = ok and stats["speculative"]["accept_rate"] >= 0.6
        if mode == "radix":
            ok = ok and stats["radix_cache"]["hits"] >= 1 and \
                row["peak_shared_blocks"] >= SERVE_PREFIX // SERVE_BLOCK
        row["ok"] = ok
        emit(row)
        if not ok:
            failures.append(f"serving f32 {mode}: replies {wrong} differ "
                            f"from generate (first at token {first_bad})")
        del srv
    del net, dec
    free_card(torch)


def _bf16_ulp(torch, x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def serving_bf16_phase(torch, mx, llama, serving, fa, net, failures):
    """Phase 8b: serving at full size: phase 8's llama3_8b (32 layers,
    bf16), 8 requests (64-1024 tokens, 32 new each) in the paged mode,
    in two waves: 2 requests, then 6 once those are decoding, which fill
    the free slots of the in-flight batch.

    The check feeds each reply through ``net(ids)`` once (the flash
    forward, kernel #1) and reads, at every generated position, how far
    the server's token lies below the row's largest logit, in bf16 ulps
    of that logit.  Two witnesses read the same: the offline decoder
    (``LlamaDecoder.generate`` on each prompt alone, its own tokens fed
    through the flash forward) and the dense route (``attn_mode="sdpa"``
    on the server's ids: the argmax of the engine's own attention
    arithmetic, placed in the flash route's logits).  The server's worst
    gap must be within SERVE_ULPS, and at least SERVE_SAME_MIN of its
    tokens must equal the offline decoder's.  The serving path itself
    launches no kernel of the port (its attention is dense torch ops):
    its count must be 0, and the check's own launches are reported
    apart from it."""
    plain, _ = _serve_prompts(net.config.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)  # the serving path starts here
    replies, srv, stats, wall_s = _serve(serving, net, plain, first_wave=2)
    path_launches = sum(c.launches for c in _counters(fa))  # ... ends here
    rep = srv.replicas[0]
    recs = srv.request_records()
    peak = torch.cuda.max_memory_allocated()
    dec = llama.LlamaDecoder(net, max_len=SERVE_MAX_LEN)
    offline = [dec.generate(p[None], SERVE_NEW)[0].cpu().numpy()
               for p in plain]
    _zero_counts(fa)  # the check's own launches

    def logits_of(seq, t0, mode="flash"):
        ids = mx.nd.array(torch.from_numpy(seq[None, :-1].astype(np.int32))
                          .cuda())
        net.config.attn_mode = mode
        try:
            with torch.no_grad():
                return net(ids)._data[0, t0 - 1:].float()
        finally:
            net.config.attn_mode = "flash"

    def gaps(logits, toks):
        top = logits.max(dim=-1).values
        return ((top - logits.gather(1, toks[:, None])[:, 0]) /
                _bf16_ulp(torch, top)), top

    per = []
    top_abs = 0.0
    for p, r, o in zip(plain, replies, offline):
        t0 = len(p)
        lf = logits_of(r, t0)
        gap_srv, top = gaps(lf, torch.from_numpy(
            r[t0:].astype(np.int64)).cuda())
        ld = logits_of(r, t0, "sdpa")
        gap_dense, _ = gaps(lf, ld.argmax(dim=-1))
        lo = logits_of(o, t0)
        gap_off, _ = gaps(lo, torch.from_numpy(
            o[t0:].astype(np.int64)).cuda())
        top_abs = max(top_abs, top.abs().max().item())
        per.append(dict(server=gap_srv.tolist(), dense=gap_dense.tolist(),
                        offline=gap_off.tolist(),
                        same_as_offline=int((r[t0:] == o[t0:]).sum())))
        del lf, ld, lo
    launches = fa.flash_attention_fwd.launches
    launches_mma = fa.flash_attention_fwd.launches_mma
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")  # listed in .gitignore
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "serving_bf16_gaps.json"), "w") as f:
        json.dump(per, f)
    worst = {k: max(max(g[k]) for g in per)
             for k in ("server", "dense", "offline")}
    over = {k: sum(x > SERVE_ULPS for g in per for x in g[k])
            for k in ("server", "dense", "offline")}
    same = sum(g["same_as_offline"] for g in per)
    ticks = list(rep.tick_ms)
    decode_tokens = sum(rep.tick_slots)
    row = dict(
        phase="serving_bf16", layers=net.config.num_layers, mode="paged",
        waves=[2, len(plain) - 2], prompts=[len(p) for p in plain],
        new_tokens=SERVE_NEW, num_slots=SERVE_SLOTS,
        block_size=SERVE_BLOCK,
        ttft_ms=[r["ttft_ms"] for r in recs],
        queue_wait_ms=[r["queue_wait_ms"] for r in recs],
        joined_step=[r["joined_step"] for r in recs],
        done_step=[r["done_step"] for r in recs],
        decode_step_ms=ticks, decode_step_slots=list(rep.tick_slots),
        decode_step_ms_median=float(np.median(ticks)) if ticks else None,
        decode_tokens_per_s=decode_tokens / sum(ticks) * 1e3
        if ticks else None,
        overall_tokens_per_s=len(plain) * SERVE_NEW / wall_s,
        wall_s=wall_s, prefill_ms=list(rep.prefill_ms),
        kv_blocks_peak=stats["kv_cache"]["peak_blocks_in_use"],
        kv_num_blocks=stats["kv_cache"]["num_blocks"],
        kv_pool_bytes=srv.engine.kv_pool_bytes(),
        max_memory_allocated=peak, largest_top_logit=top_abs,
        worst_gap_ulps=worst, positions_over_tol=over,
        positions=len(plain) * SERVE_NEW, tol_ulps=SERVE_ULPS,
        tokens_same_as_offline=same, tokens_same_min=SERVE_SAME_MIN,
        path_launches=path_launches, check_launches=launches,
        check_launches_mma=launches_mma,
        step_graph_key=list(srv.engine._step_key),
        step_graph_pool_bytes=srv.engine._step_graph.pool_bytes,
        step_graph_replays=srv.engine._step_graph.replays,
        compiled_signatures=[list(k) for k in
                             srv.engine.compiled_signatures()])
    ok = worst["server"] <= SERVE_ULPS and same >= SERVE_SAME_MIN and \
        stats["completed"] == len(plain) and stats["failed"] == 0 and \
        path_launches == 0 and \
        launches == launches_mma == 2 * len(plain) * net.config.num_layers
    row["ok"] = ok
    emit(row)
    if not ok:
        failures.append(f"serving bf16: a token {worst['server']} ulps off "
                        f"the flash forward's argmax (limit {SERVE_ULPS}; "
                        f"offline decoder {worst['offline']}, dense route "
                        f"{worst['dense']}); {same} tokens equal to the "
                        f"offline decoder's (at least {SERVE_SAME_MIN}); "
                        f"serving path launches {path_launches} (0 "
                        f"expected); check launches {launches} "
                        f"(tensor-core {launches_mma})")
    del srv, replies, dec


def slice_phase(torch, mx, llama, fa, failures):
    """Phase 8: llama3_8b, 32 layers, bf16 — the main path."""
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = llama.llama3_8b()
    net.cast("bfloat16")
    net.initialize(ctx=mx.gpu(0))
    torch.cuda.synchronize()
    emit(dict(phase="init", seconds=time.perf_counter() - t,
              params=sum(p.data().size for p in
                         net.collect_params().values())))
    cfg = net.config
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)  # the main path starts here

    ids = mx.nd.array(torch.randint(0, cfg.vocab_size, (1, 2048),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32))
    for run_i in range(2):  # the first call also warms up cuBLAS
        before = fa.flash_attention_fwd.launches
        before_mma = fa.flash_attention_fwd.launches_mma
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = net(ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = fa.flash_attention_fwd.launches - before
        mma = fa.flash_attention_fwd.launches_mma - before_mma
        finite = bool(torch.isfinite(logits._data).all())
        ok = launched == cfg.num_layers and mma == cfg.num_layers and \
            finite and logits.shape == (1, 2048, cfg.vocab_size)
        emit(dict(phase="prompt_forward", run=run_i, B=1, T=2048,
                  launches=launched, launches_mma=mma, finite=finite, ms=ms,
                  tokens_per_s=2048 / ms * 1e3, ok=ok))
        if not ok:
            failures.append(f"prompt forward: launches {launched}, "
                            f"tensor-core {mma}, finite {finite}")
    eager_logits = logits._data
    del logits
    # the same forward hybridized: the first call runs eagerly and
    # captures, the next ones replay the 32-layer graph
    net.hybridize(static_alloc=True, static_shape=True)
    for run_i in range(3):
        before = fa.flash_attention_fwd.launches
        before_mma = fa.flash_attention_fwd.launches_mma
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = net(ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = fa.flash_attention_fwd.launches - before
        mma = fa.flash_attention_fwd.launches_mma - before_mma
        diff = (logits._data.float() - eager_logits.float()).abs().max()
        tol = GRAPH_BF16_TOL * eager_logits.float().abs().max()
        identical = bool(torch.equal(logits._data, eager_logits))
        ok = launched == mma == cfg.num_layers and bool(diff <= tol)
        emit(dict(phase="prompt_forward_graph", run=run_i,
                  captured=run_i == 0, B=1, T=2048, ms=ms,
                  tokens_per_s=2048 / ms * 1e3, launches=launched,
                  launches_mma=mma, identical_to_eager=identical,
                  max_abs_diff=diff.item(), tol=tol.item(), ok=ok))
        if not ok:
            failures.append(f"prompt forward graph run {run_i}: launches "
                            f"{launched} (tensor-core {mma}), max diff "
                            f"{diff.item()} (tol {tol.item()})")
        del logits
    entry = next(iter(net._cached_op._graphs.values()))
    emit(dict(phase="prompt_forward_graph_cache",
              cache_stats=net.cache_stats(),
              graph_pool_bytes=entry[2].pool_bytes))
    net.hybridize(False)
    del eager_logits, entry
    free_card(torch)

    for b, t0 in REQUESTS:
        prompt = mx.nd.array(torch.randint(
            0, cfg.vocab_size, (b, t0), generator=gen, device="cuda",
            dtype=torch.int32))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = net.generate(prompt, max_new_tokens=NEW_TOKENS)  # captures
        torch.cuda.synchronize()
        first_call_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out = net.generate(prompt, max_new_tokens=NEW_TOKENS)  # replays
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t) * 1e3
        # the prefill alone, on the decoder and padded shape generate used
        dec = next(d for m, d in sorted(net._kv_decoders.items())
                   if m >= t0 + NEW_TOKENS)
        lp = dec._prompt_len(t0, NEW_TOKENS)
        pad = torch.zeros((b, lp), dtype=torch.int32, device="cuda")
        pad[:, :t0] = prompt._data
        with torch.no_grad():
            w = dec._weights()
            prefill_ms = time_ms(torch, lambda: dec._prefill_impl(
                w, pad, t0), 1)
        first = out._data[:, t0]
        with torch.no_grad():
            ref_first = net(prompt)._data[:, -1].argmax(-1).to(torch.int32)
        # the eager decoder on the same prompt, in the same run
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine_type = mx.engine.engine_type()
        mx.engine.set_engine_type("NaiveEngine")  # eager decode steps
        try:
            eager = dec.generate(prompt._data, NEW_TOKENS)
        finally:
            mx.engine.set_engine_type(engine_type)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t) * 1e3
        same = bool(torch.equal(eager, out._data))
        ok = out.shape == (b, t0 + NEW_TOKENS) and same and \
            bool(torch.equal(out._data[:, :t0], prompt._data)) and \
            bool(((out._data >= 0) & (out._data < cfg.vocab_size)).all())
        decode_ms = total_ms - prefill_ms
        eager_decode_ms = eager_ms - prefill_ms
        graph, = dec._decode_states[b]["graphs"].values()
        emit(dict(phase="request", B=b, prompt=t0, new_tokens=NEW_TOKENS,
                  max_len=dec.max_len, prefill_len=lp,
                  first_call_ms=first_call_ms, total_ms=total_ms,
                  prefill_ms=prefill_ms,
                  decode_tokens_per_s=b * (NEW_TOKENS - 1) / decode_ms * 1e3
                  if decode_ms > 0 else None,
                  eager_total_ms=eager_ms,
                  eager_decode_tokens_per_s=b * (NEW_TOKENS - 1) /
                  eager_decode_ms * 1e3 if eager_decode_ms > 0 else None,
                  tokens_equal_to_eager=same,
                  decode_graph_pool_bytes=graph.pool_bytes,
                  # the static caches, tokens and positions of every batch
                  # size's graphs, and their pool, so far
                  decode_graph_bytes=dict(zip(("static", "pool"),
                                              dec.decode_graph_bytes())),
                  first_token_matches_forward_argmax=bool(
                      torch.equal(first, ref_first)), ok=ok))
        if not ok:
            failures.append(f"request B={b} t0={t0}: bad output or tokens "
                            f"unlike the eager decoder's ({same})")
        del out, w, eager
    launches = fa.flash_attention_fwd.launches  # the main path ends here
    launches_mma = fa.flash_attention_fwd.launches_mma
    emit(dict(phase="memory",
              max_memory_allocated=torch.cuda.max_memory_allocated()))
    if launches == 0 or launches_mma == 0:
        failures.append("the main path launched no flash_attention_fwd "
                        f"(tensor-core launches {launches_mma})")
    return launches, launches_mma, net


# The fused 1x1 conv + BN + ReLU kernel at ResNet-50 v1's shapes (B=128,
# 224x224): (name, B, H'=W', K, N, dtype, launches a forward); M = B·H'·W'.
# The first eight are the 16 launches of a bf16 forward; then one f32 shape
# and one ragged (B=1, M=49; K, N off the tile sizes).
FUSED_SHAPES = [
    ("s1_k64", 128, 56, 64, 64, "bfloat16", 1),
    ("s1_k256", 128, 56, 256, 64, "bfloat16", 2),
    ("s2_k256", 128, 28, 256, 128, "bfloat16", 1),
    ("s2_k512", 128, 28, 512, 128, "bfloat16", 3),
    ("s3_k512", 128, 14, 512, 256, "bfloat16", 1),
    ("s3_k1024", 128, 14, 1024, 256, "bfloat16", 5),
    ("s4_k1024", 128, 7, 1024, 512, "bfloat16", 1),
    ("s4_k2048", 128, 7, 2048, 512, "bfloat16", 2),
    ("f32", 8, 28, 512, 128, "float32", 0),
    ("ragged", 1, 7, 1000, 300, "bfloat16", 0),
]
# the same eight shapes in f16 (the f16 instance of the tensor-core
# design, the 16 launches of an f16 forward)
FUSED_SHAPES += [("f16_" + name, b, h, k, n, "float16", per)
                 for name, b, h, k, n, dt, per in FUSED_SHAPES[:8]]
# kernel against its plain version on f32 copies: bf16, the kernel rounds
# its f32 result to 8 mantissa bits (2^-8 of each value) and sums in
# another order than cuBLAS (1e-4 of the largest value at K <= 2048); f32,
# only the summation order
FUSED_REL_TOL = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11,
                 "float32": 0.0}
FUSED_ABS_TOL = {"bfloat16": 1e-4, "float16": 1e-4,
                 "float32": 1e-5}  # x the largest value
RESNET_BATCHES = (128, 4)  # bench.py's batch, then __graft_entry__'s
RESNET_LR = 0.1


def fused_kernel_phase(torch, cbr, failures):
    """The fused kernel against its plain version at each shape, with its
    design, time, the plain version's, the library's (``addmm`` with the
    scale folded into w, then ``relu``), the eager NCHW chain's
    (``conv2d`` → ``batch_norm`` in eval → ``relu``), the card's bound and
    the NCHW → (M, K) copy the fused path makes before each launch."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    tnf = torch.nn.functional
    rows = []
    for name, b, h, k, n, dt, per_fwd in FUSED_SHAPES:
        dtype = getattr(torch, dt)
        m = b * h * h

        def rnd(*shape, lo=None, hi=None):
            if lo is None:
                return torch.randn(*shape, generator=gen, device="cuda")
            return torch.rand(*shape, generator=gen, device="cuda") * \
                (hi - lo) + lo

        x_nchw = rnd(b, k, h, h).to(dtype)
        wconv = (rnd(n, k, 1, 1) / math.sqrt(k)).to(dtype)
        gamma, beta = rnd(n, lo=0.5, hi=1.5), rnd(n, lo=-0.5, hi=0.5)
        mean, var = rnd(n, lo=-0.3, hi=0.3), rnd(n, lo=0.5, hi=1.5)
        t = time.perf_counter()
        x = x_nchw.permute(0, 2, 3, 1).reshape(m, k).contiguous()
        w, scale, bias = cbr.fold_bn(wconv, None, gamma, beta, mean, var,
                                     1e-5, False)
        got = cbr.fused_matmul_affine_relu(x, w, scale, bias)
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t
        ref = cbr._fused_matmul_affine_relu_plain(x.float(), w.float(),
                                                  scale, bias)
        diff = (got.float() - ref).abs()
        largest = ref.abs().max().item()
        allowed = FUSED_REL_TOL[dt] * ref.abs() + \
            FUSED_ABS_TOL[dt] * largest
        err = diff.max().item()
        ok = bool((diff <= allowed).all()) and got.dtype == dtype and \
            got.shape == (m, n) and bool(torch.isfinite(got).all())
        iters = 20 if m * k * n > 1e9 else 100
        w_lib = (w.float() * scale).to(dtype)
        b_lib = bias.to(dtype)
        row = dict(
            phase="fused_kernel", shape=name, B=b, H=h, M=m, K=k, N=n,
            dtype=dt, design="fma" if dtype == torch.float32 else "mma",
            launches_per_forward=per_fwd, max_abs_err=err,
            max_abs_ref=largest,
            tol=f"{FUSED_REL_TOL[dt]}*|ref| + {FUSED_ABS_TOL[dt]}*max|ref|",
            first_call_s=first_call_s,
            kernel_ms=time_ms(torch, lambda: cbr.fused_matmul_affine_relu(
                x, w, scale, bias), iters),
            plain_ms=time_ms(torch, lambda: cbr._fused_matmul_affine_relu_plain(
                x, w, scale, bias), max(iters // 4, 5)),
            library_ms=time_ms(torch, lambda: torch.relu(torch.addmm(
                b_lib, x, w_lib)), iters),
            chain_ms=time_ms(torch, lambda: torch.relu(tnf.batch_norm(
                tnf.conv2d(x_nchw, wconv), mean, var, gamma, beta,
                training=False, eps=1e-5)), iters),
            # the fused path's layout copy (conv1x1_bn_relu), outside the
            # kernel
            nchw_to_mk_copy_ms=time_ms(
                torch, lambda: x_nchw.permute(0, 2, 3, 1).reshape(
                    m, k).contiguous(), iters))
        row["tflops"] = 2.0 * m * k * n / row["kernel_ms"] * 1e-9
        isz = x.element_size()
        row["bound_ms"], row["bound_by"] = roofline_ms(
            2.0 * m * k * n, isz * (m * k + k * n + m * n) + 8 * n, dt)
        row["ok"] = ok
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"fused kernel {name}: max err {err} "
                            f"(largest {largest})")
        del x_nchw, x, got, ref, diff, allowed
    # one bf16 ResNet-50 forward's 16 launches: each time summed over
    # them; bound by what bounds most of the summed bound (and the same
    # for an f16 forward, on its own line)
    f16 = [r for r in rows
           if r["launches_per_forward"] and r["dtype"] == "float16"]
    emit(dict(phase="fused_kernel_forward_f16",
              launches=sum(r["launches_per_forward"] for r in f16),
              **{key: sum(r[key] * r["launches_per_forward"] for r in f16)
                 for key in ("kernel_ms", "bound_ms", "plain_ms",
                             "library_ms", "chain_ms")}))
    forward = [r for r in rows
               if r["launches_per_forward"] and r["dtype"] == "bfloat16"]
    total = dict(phase="fused_kernel_forward",
                 launches=sum(r["launches_per_forward"] for r in forward),
                 design=forward[0]["design"],
                 max_abs_err=max(r["max_abs_err"] for r in rows),
                 **{key: sum(r[key] * r["launches_per_forward"]
                             for r in forward)
                    for key in ("kernel_ms", "bound_ms", "plain_ms",
                                "library_ms", "chain_ms",
                                "nchw_to_mk_copy_ms")})
    total["tflops"] = sum(2.0 * r["M"] * r["K"] * r["N"] *
                          r["launches_per_forward"] for r in forward) / \
        total["kernel_ms"] * 1e-9
    by_bytes = sum(r["bound_ms"] * r["launches_per_forward"]
                   for r in forward if r["bound_by"] == "bytes")
    total["bound_by"] = "bytes" if 2 * by_bytes >= total["bound_ms"] \
        else "operations"
    emit(total)
    return total


def _resnet_arrays(torch, mx, net_fn, x_shape):
    """Weights for ``net_fn()`` on the CPU from the seed (Xavier), with
    moving means and variances drawn away from 0 and 1, as numpy arrays
    by structural name."""
    mx.random.seed(SEED)
    net = net_fn()
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    net(mx.nd.zeros(x_shape, ctx=mx.cpu()))  # resolve deferred shapes
    gen = torch.Generator().manual_seed(SEED + 7)
    arrays = {}
    for key, p in net._collect_params_with_prefix().items():
        a = p.data()._data.detach()
        if key.endswith("running_mean"):
            a = torch.randn(a.shape, generator=gen) * 0.1
        elif key.endswith("running_var"):
            a = torch.rand(a.shape, generator=gen) + 0.5
        arrays[key] = a.numpy().copy()
    return arrays


def resnet_f32_phase(torch, mx, vision, cbr, failures):
    """``resnet50_v1`` in f32, B=2, 224x224: the same weights on the card
    (the fused kernel, no TF32) and on the CPU (its plain version)."""
    from mxnet_tpu_torch.convert import load_numpy_params

    free_card(torch)
    shape = (2, 3, 224, 224)
    arrays = _resnet_arrays(torch, mx, vision.resnet50_v1, shape)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(SEED + 8))
    cpu_net, gpu_net = vision.resnet50_v1(), vision.resnet50_v1()
    load_numpy_params(cpu_net, arrays, ctx=mx.cpu())
    load_numpy_params(gpu_net, arrays, ctx=mx.gpu(0))
    fn = cbr.fused_matmul_affine_relu
    before = (fn.launches, fn.launches_mma)
    got = gpu_net(mx.nd.array(x, ctx=mx.gpu(0)))._data.float().cpu()
    launched = fn.launches - before[0]
    mma = fn.launches_mma - before[1]  # f32: the FMA design only
    ref = cpu_net(mx.nd.array(x, ctx=mx.cpu()))._data
    largest = ref.abs().max().item()
    share = (got - ref).abs().max().item() / largest
    ok = launched == 16 and mma == 0 and share <= 1e-3 and \
        got.shape == (2, 1000) and bool(torch.isfinite(got).all())
    emit(dict(phase="resnet_f32_check", B=2, image=224, launches=launched,
              launches_mma=mma, max_abs_logit=largest, max_err_share=share,
              tol=1e-3, ok=ok))
    if not ok:
        failures.append(f"resnet f32 check: launches {launched} "
                        f"(tensor-core {mma}), error share {share}")
    del cpu_net, gpu_net
    free_card(torch)


def resnet_infer_phase(torch, mx, vision, cbr, failures):
    """``resnet50_v1`` in bf16, 224x224, at B=128 and B=4: the inference
    main path through the fused kernel, 16 launches a forward, eagerly and
    then hybridized (CUDA graph replays against the eager logits); then
    the weights' round trip through a ``.params`` file."""
    free_card(torch)
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    inputs = {b: mx.nd.array(torch.rand(
        (b, 3, 224, 224), generator=gen, device="cuda").bfloat16())
        for b in RESNET_BATCHES}
    net(inputs[RESNET_BATCHES[-1]])  # resolve deferred shapes
    torch.cuda.synchronize()
    fn = cbr.fused_matmul_affine_relu
    fn.launches = fn.launches_mma = 0  # the main path starts here
    eager_out, eager_warm = {}, {}
    for b in RESNET_BATCHES:
        x = inputs[b]
        torch.cuda.reset_peak_memory_stats()
        ms, launched = [], []
        for _ in range(4):  # one warm-up, then three timed forwards
            before = (fn.launches, fn.launches_mma)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = net(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launched.append((fn.launches - before[0],
                             fn.launches_mma - before[1]))
        finite = bool(torch.isfinite(out._data).all())
        warm = sum(ms[1:]) / 3
        eager_out[b], eager_warm[b] = out._data, warm
        # 16 launches a forward, all of the tensor-core design
        ok = launched == [(16, 16)] * 4 and finite and \
            out.shape == (b, 1000) and out.dtype == torch.bfloat16
        emit(dict(phase="resnet_infer", B=b, image=224, dtype="bfloat16",
                  launches_per_forward=[n for n, _ in launched],
                  launches_mma_per_forward=[n for _, n in launched],
                  ms=ms, warm_ms=warm,
                  images_per_s=b / warm * 1e3, finite=finite,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  ok=ok))
        if not ok:
            failures.append(f"resnet inference B={b}: launches (all, "
                            f"tensor-core) {launched}, finite {finite}")
        del out
    # hybridized: each batch's first call runs eagerly and captures its
    # graph, the next ones replay it (16 fused launches each)
    net.hybridize(static_alloc=True, static_shape=True)
    for b in RESNET_BATCHES:
        x = inputs[b]
        ms, launched = [], []
        for _ in range(4):
            before = (fn.launches, fn.launches_mma)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = net(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launched.append((fn.launches - before[0],
                             fn.launches_mma - before[1]))
        ref = eager_out[b]
        diff = (out._data.float() - ref.float()).abs().max().item()
        tol = GRAPH_BF16_TOL * ref.float().abs().max().item()
        warm = sum(ms[1:]) / 3
        sig = next(k for k in net._cached_op._graphs if k[0][0][0][0] == b)
        ok = launched == [(16, 16)] * 4 and diff <= tol and \
            out.shape == (b, 1000)
        emit(dict(phase="resnet_infer_graph", B=b, image=224,
                  dtype="bfloat16", ms=ms, warm_ms=warm,
                  eager_warm_ms=eager_warm[b],
                  images_per_s=b / warm * 1e3,
                  launches_per_forward=[n for n, _ in launched],
                  launches_mma_per_forward=[n for _, n in launched],
                  identical_to_eager=bool(torch.equal(out._data, ref)),
                  max_abs_diff=diff, tol=tol,
                  graph_pool_bytes=net._cached_op._graphs[sig][2].pool_bytes,
                  ok=ok))
        if not ok:
            failures.append(f"resnet inference graph B={b}: launches "
                            f"{launched}, max diff {diff} (tol {tol})")
        del out
    launches, launches_mma = fn.launches, fn.launches_mma  # the path ends
    emit(dict(phase="resnet_infer_graph_cache",
              cache_stats=net.cache_stats()))
    net.hybridize(False)
    if launches_mma == 0:
        failures.append("the ResNet inference path launched no "
                        "tensor-core fused_matmul_affine_relu")
    # the weights through a .params file: save_parameters, then
    # resnet50_v1(pretrained=True) from that local file, cast to bf16 (the
    # file holds the bf16 values as f32, exactly), the same forward bits
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="mxt_params_")
    try:
        t = time.perf_counter()
        net.save_parameters(os.path.join(root, "resnet50_v1.params"))
        save_s = time.perf_counter() - t
        size = os.path.getsize(os.path.join(root, "resnet50_v1.params"))
        loaded = vision.resnet50_v1(classes=1000, pretrained=True,
                                    root=root, ctx=mx.gpu(0))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    loaded.cast("bfloat16")
    x = inputs[RESNET_BATCHES[-1]]
    same = bool(torch.equal(loaded(x)._data, net(x)._data))
    emit(dict(phase="params_round_trip", net="resnet50_v1",
              dtype="bfloat16", file_bytes=size, save_s=save_s,
              identical_forward=same, ok=same))
    if not same:
        failures.append("resnet50_v1 .params round trip: the loaded net's "
                        "forward differs")
    del net, inputs, loaded
    free_card(torch)
    return launches, launches_mma


def _resnet_step(mx, net, trainer, loss_fn, x, y, stamps=None):
    """One recorded forward, backward and optimizer step; ``stamps``
    (a callable) marks the end of each phase.  Returns the mean loss."""
    mark = stamps or (lambda: None)
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    mark()
    loss.backward()
    mark()
    trainer.step(x.shape[0])
    mark()
    return float(loss.mean().asscalar())


def resnet18_f32_train_phase(torch, mx, vision, failures):
    """``resnet18_v1(classes=8, thumbnail=True)`` in f32, B=2, 16x16: one
    SGD-momentum step on the card and on the CPU from the same weights;
    the loss and every updated parameter within 1e-4 (of the largest
    value of the same tensor)."""
    from mxnet_tpu_torch.convert import load_numpy_params

    def make():
        return vision.resnet18_v1(classes=8, thumbnail=True)

    arrays = _resnet_arrays(torch, mx, make, (1, 3, 16, 16))
    x = torch.rand((2, 3, 16, 16),
                   generator=torch.Generator().manual_seed(SEED + 10))
    y = torch.tensor([1.0, 5.0])
    results = []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = make()
        load_numpy_params(net, arrays, ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05, "momentum": 0.9})
        loss = _resnet_step(mx, net, trainer,
                            mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx))
        results.append((loss, {k: p.data()._data.detach().float().cpu()
                               for k, p in
                               net._collect_params_with_prefix().items()}))
    (loss_gpu, p_gpu), (loss_cpu, p_cpu) = results
    worst, worst_name = 0.0, None
    for key, ref in p_cpu.items():
        share = ((p_gpu[key] - ref).abs().max() /
                 ref.abs().max().clamp_min(1e-30)).item()
        if not share <= worst:
            worst, worst_name = share, key
    ok = math.isfinite(loss_gpu) and \
        abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu) and worst <= 1e-4
    emit(dict(phase="resnet18_f32_train_check", B=2, image=16,
              loss_gpu=loss_gpu, loss_cpu=loss_cpu, params=len(p_cpu),
              worst_param_err_share=worst, worst_param=worst_name, tol=1e-4,
              ok=ok))
    if not ok:
        failures.append(f"resnet18 f32 training check: loss {loss_gpu} vs "
                        f"{loss_cpu}, worst parameter {worst} "
                        f"({worst_name})")


def resnet_train_phase(torch, mx, vision, cbr, mt, failures):
    """``resnet50_v1``, bf16 (``net.cast``), B=128, 224x224, SGD with
    momentum 0.9 and lr 0.1, ``SoftmaxCrossEntropyLoss`` — bench.py's
    protocol, eager: one warm-up step and three timed steps on one batch.
    BatchNorm normalizes by the batch, so the fused conv kernel never
    runs; the update is one launch of the multi-tensor kernel a step."""
    free_card(torch)
    t = time.perf_counter()
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))  # resolve shapes
    net.cast("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": RESNET_LR, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    b = RESNET_BATCHES[0]
    x = mx.nd.array(torch.rand((b, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())
    y = mx.nd.array(torch.randint(0, 1000, (b,), generator=gen,
                                  device="cuda").float())
    torch.cuda.synchronize()
    emit(dict(phase="resnet_train_init", seconds=time.perf_counter() - t,
              params=sum(p.data().size for p in
                         net.collect_params().values()),
              memory_allocated=torch.cuda.memory_allocated()))
    fused_before = cbr.fused_matmul_affine_relu.launches
    mt.multi_tensor_update.launches = 0  # the update's main path starts
    losses, step_ms = [], []
    for step in range(4):
        stamps, peaks = [], []

        def mark():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

        mark()
        peaks.clear()
        mt_before = mt.multi_tensor_update.launches
        loss = _resnet_step(mx, net, trainer, loss_fn, x, y, mark)
        upd_launches = mt.multi_tensor_update.launches - mt_before
        fwd_ms, bwd_ms, upd_ms = ((b2 - a) * 1e3 for a, b2 in
                                  zip(stamps, stamps[1:]))
        ms = (stamps[-1] - stamps[0]) * 1e3
        losses.append(loss)
        if step:
            step_ms.append(ms)
        ok = math.isfinite(loss) and upd_launches == 1
        emit(dict(phase="resnet_train_step", step=step, warmup=step == 0,
                  B=b, loss=loss, ms=ms, images_per_s=b / ms * 1e3,
                  forward_ms=fwd_ms, backward_ms=bwd_ms, update_ms=upd_ms,
                  update_bound_ms=update_bound_ms(trainer),
                  update_launches=upd_launches,
                  max_memory_allocated=dict(zip(
                      ("forward", "backward", "update"), peaks)), ok=ok))
        if not ok:
            failures.append(f"resnet train step {step}: loss {loss}, "
                            f"update launches {upd_launches}")
    fused = cbr.fused_matmul_affine_relu.launches - fused_before
    update_launches = mt.multi_tensor_update.launches  # ... ends
    kernel_ms, tensors = update_kernel_ms(torch, mt, trainer, 20)
    ok = losses[-1] < losses[0] and fused == 0
    emit(dict(phase="resnet_train_summary", losses=losses, step_ms=step_ms,
              fused_launches=fused, update_launches=update_launches,
              update_kernel_ms=kernel_ms, update_tensors=tensors,
              update_bound_ms=update_bound_ms(trainer), ok=ok))
    if not ok:
        failures.append(f"resnet training: losses {losses}, fused launches "
                        f"{fused} (expected a falling loss and 0)")
    del net, trainer, x, y
    free_card(torch)
    return update_launches


# The fused multi-tensor update kernel (phase 5b): every rule code of the
# kernel at ragged tensor lengths (1 element up to three blocks and a bit)
# in f32, bf16, bf16 with an f32 master and f16, over three steps with an
# lr schedule, rescale, clipping and weight decay; weights within 1 ulp of
# their dtype, f32 states and masters within 2 f32 ulps (the kernel
# rounds where the plain rule's torch ops round).
MT_SIZES = [1, 7, 4097, 16389, 3 * 16384]
MT_RULES = [("sgd", {}), ("sgd", {"momentum": 0.9}),
            ("nag", {"momentum": 0.9}), ("adam", {}), ("adamw", {})]
MT_DTYPES = [("float32", False), ("bfloat16", False), ("bfloat16", True),
             ("float16", False)]
MT_WEIGHT_ULPS = 1
MT_STATE_ULPS = 2
# FusedTrainStep phases: ResNet-50 bf16 B=128, K=8 (bench.py's protocol);
# the 8 losses against 8 eager Trainer steps from the same weights, at an
# lr at which both fall (at phase 12's lr 0.1 the losses on one constant
# batch rise, and a trajectory that diverges hides a wrong update).  Step
# 0 runs the same kernels eagerly in both (it is the graph's warm-up);
# steps 1-7 replay the graph, whose cuDNN and cuBLAS calls may sum in
# another order than the eager calls do, and 8 steps of SGD in bf16 carry
# that: each loss within 2e-2 of the eager loss (relative)
FUSED_STEP_K = 8
FUSED_RESNET_LR = 0.01
FUSED_LOSS_RTOL = 2e-2
# the 2-layer f32 Llama: K=2 graph losses within 1e-5 (relative) of eager
# steps, the final weights within 1e-3 of the largest change the two
# eager steps made to the same tensor (f32; phase 7's 1e-3 share)
FUSED_LLAMA_K = 2


def _max_ulps(torch, got, ref, dtype, chunk=1 << 26):
    """Largest |got - ref| in units of ``dtype``'s spacing at ``ref`` (the
    smallest subnormal step below the normal range), chunk by chunk."""
    eps = torch.finfo(dtype).eps
    floor = torch.finfo(dtype).smallest_normal * eps
    g, r = got.reshape(-1), ref.reshape(-1)
    worst = 0.0
    for i in range(0, r.numel(), chunk):
        a, b = g[i:i + chunk].double(), r[i:i + chunk].double()
        _, e = torch.frexp(b)
        ulp = torch.ldexp(torch.full_like(b, eps), e - 1).clamp_min(floor)
        worst = max(worst, ((a - b).abs() / ulp).max().item())
    return worst


def update_bound_ms(trainer):
    """Least time of one optimizer update on the card: each live weight,
    state and master read and written once, each gradient read once, over
    3.35 TB/s."""
    from mxnet_tpu_torch import optimizer as topt

    nbytes = 0
    for p in trainer._params:
        if p.grad_req == "null" or p._data is None:
            continue
        w = p.data()._data
        nbytes += 3 * w.numel() * w.element_size()
        state = trainer._states[trainer._param2idx[p.name]]
        holders = [] if state is None else topt._state_holders(state)
        nbytes += sum(2 * h._data.numel() * h._data.element_size()
                      for h in holders)
    return nbytes / PEAK_BYTES * 1e3


def update_kernel_ms(torch, mt, trainer, iters):
    """Device time of the update kernel alone over the trainer's tensors:
    the launch of the plan its last step wrote (the pointers it holds are
    still live), ``iters`` times after one warm-up; and the tensor count.
    Run after the timed steps (it updates the weights again)."""
    live = trainer._live()
    device = trainer._params[live[0]].data()._data.device
    plan = mt._PLANS[(device, tuple(trainer._params[i].data().size
                                    for i in live))]
    return time_ms(torch, lambda: plan.launch(trainer._optimizer),
                   iters), len(live)


def multi_tensor_phase(torch, mx, llama, mt, failures):
    """Phase 5b: the fused multi-tensor update kernel against its plain
    version (the optimizer's per-tensor rule) for every rule and dtype at
    ragged lengths, then over the 147 tensors of the 16-layer Llama
    training slice (bf16 weights, SGD with f32 momentum): the check, the
    kernel's time (the launch alone, and the call with its table write),
    the plain version's, the ``torch._foreach_*`` chain's (the library
    yardstick) and the bound."""
    from mxnet_tpu_torch import optimizer as topt

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 20)
    for name, kw in MT_RULES:
        for dt, mp in MT_DTYPES:
            dtype = getattr(torch, dt)
            opt = topt.create(name, multi_precision=mp, rescale_grad=0.5,
                              clip_gradient=1.5, **kw)
            rule = opt._fused_rule()[0]
            n_states = mt._STATES[rule]
            sdt = dtype if rule == "nag_mom" and not mp else torch.float32
            ker = []
            for n in MT_SIZES:
                w = torch.randn(n, generator=gen, device="cuda").to(dtype)
                g = (2 * torch.randn(n, generator=gen, device="cuda")).to(
                    dtype)
                states = tuple((torch.rand(n, generator=gen, device="cuda")
                                * 0.1).to(sdt) for _ in range(n_states))
                ker.append(mt.UpdateItem(w, g, states,
                                         w.float() if mp else None,
                                         0.0, 0.0, 0))
            ref = [mt.UpdateItem(
                it.w.clone(), it.g, tuple(x.clone() for x in it.states),
                None if it.master is None else it.master.clone(), 0.0, 0.0,
                0) for it in ker]
            before = mt.multi_tensor_update.launches
            for step, lr in enumerate((0.1, 0.05, 0.025)):
                sched = [it._replace(lr=lr * (1 + j % 2), wd=0.01 * (j % 3),
                                     t=step + 1) for j, it in enumerate(ker)]
                mt.multi_tensor_update(opt, sched)
                mt._update_plain(opt, [r._replace(lr=x.lr, wd=x.wd, t=x.t)
                                       for r, x in zip(ref, sched)])
            torch.cuda.synchronize()
            launched = mt.multi_tensor_update.launches - before
            w_ulps = max(_max_ulps(torch, k.w, r.w, dtype)
                         for k, r in zip(ker, ref))
            s_ulps = max([_max_ulps(torch, a, b, sdt) for k, r in
                          zip(ker, ref) for a, b in zip(k.states, r.states)]
                         or [0.0])
            m_ulps = max(_max_ulps(torch, k.master, r.master,
                                   torch.float32)
                         for k, r in zip(ker, ref)) if mp else None
            s_tol = MT_STATE_ULPS if sdt == torch.float32 else MT_WEIGHT_ULPS
            ok = launched == 3 and w_ulps <= MT_WEIGHT_ULPS and \
                s_ulps <= s_tol and (m_ulps is None or
                                     m_ulps <= MT_STATE_ULPS)
            emit(dict(phase="multi_tensor", rule=rule, dtype=dt, master=mp,
                      sizes=MT_SIZES, steps=3, launches=launched,
                      weight_ulps=w_ulps, state_ulps=s_ulps,
                      master_ulps=m_ulps, tol_weight_ulps=MT_WEIGHT_ULPS,
                      tol_state_ulps=s_tol, ok=ok))
            if not ok:
                failures.append(f"multi-tensor {rule} {dt} master={mp}: "
                                f"launches {launched}, ulps weight {w_ulps} "
                                f"state {s_ulps} master {m_ulps}")
            del ker, ref
    # the 147 tensors of the training slice, at their shapes
    shapes = [p.shape for p in llama.llama3_8b(
        num_layers=TRAIN_LAYERS).collect_params().values()]
    opt = topt.create("sgd", learning_rate=TRAIN_LR, momentum=0.9)
    items = []
    for shape in shapes:
        w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        g = (torch.randn(shape, generator=gen, device="cuda") * 0.01).to(
            torch.bfloat16)
        m = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        items.append(mt.UpdateItem(w, g, (m,), None, TRAIN_LR, 0.0, 1))
    params = sum(it.w.numel() for it in items)
    ref = [it._replace(w=it.w.clone(), states=(it.states[0].clone(),))
           for it in items]
    before = mt.multi_tensor_update.launches
    mt.multi_tensor_update(opt, items)
    launched = mt.multi_tensor_update.launches - before
    mt._update_plain(opt, ref)
    torch.cuda.synchronize()
    w_ulps = max(_max_ulps(torch, k.w, r.w, torch.bfloat16)
                 for k, r in zip(items, ref))
    s_ulps = max(_max_ulps(torch, k.states[0], r.states[0], torch.float32)
                 for k, r in zip(items, ref))
    err = max((k.w.float() - r.w.float()).abs().max().item()
              for k, r in zip(items, ref))
    del ref
    free_card(torch)
    plan = mt.plan_for(items)
    ws = [it.w for it in items]
    gs = [it.g for it in items]
    ms = [it.states[0] for it in items]

    def foreach_chain():
        torch._foreach_mul_(ms, 0.9)
        torch._foreach_add_(ms, gs, alpha=-TRAIN_LR)
        torch._foreach_add_(ws, ms)

    bound, bound_by = roofline_ms(0.0, 14.0 * params, "bfloat16")
    row = dict(phase="multi_tensor_llama", tensors=len(items),
               params=params, rule="sgd_mom", dtype="bfloat16",
               launches=launched, weight_ulps=w_ulps, state_ulps=s_ulps,
               max_abs_err=err, blocks=plan.nblocks,
               kernel_ms=time_ms(torch, lambda: plan.launch(opt), 5),
               call_ms=time_ms(torch, lambda: mt.multi_tensor_update(
                   opt, items), 5),
               plain_ms=time_ms(torch, lambda: mt._update_plain(opt, items),
                                2),
               library_ms=time_ms(torch, foreach_chain, 3),
               bound_ms=bound, bound_by=bound_by)
    row["gbytes_per_s"] = 14.0 * params / row["kernel_ms"] * 1e-6
    row["ok"] = ok = launched == 1 and w_ulps <= MT_WEIGHT_ULPS and \
        s_ulps <= MT_STATE_ULPS
    emit(row)
    if not ok:
        failures.append(f"multi-tensor over the Llama slice's tensors: "
                        f"launches {launched}, ulps weight {w_ulps} state "
                        f"{s_ulps}")
    del items, plan, ws, gs, ms
    free_card(torch)
    return row


def fused_llama_phase(torch, mx, llama, fa, mt, checkpoint, failures):
    """Phase 7d: ``FusedTrainStep`` on ``llama3_8b`` widths at 2 layers in
    f32, T=1024, K=2 (SGD, momentum 0.9): the graph's losses and final
    weights against two eager ``Trainer.step``s from the same weights,
    with the flash forward, dQ and dK/dV launches counted through the
    replays; then the checkpoint round trip: ``save_checkpoint`` of the
    fused net's training state, one more step, and the same step after
    ``resume`` into a fresh net and trainer: the loss and the weights
    equal."""
    import shutil
    import tempfile

    kw = {"learning_rate": 0.01, "momentum": 0.9}

    def make():
        mx.random.seed(SEED)
        net = llama.llama3_8b(num_layers=2)
        net.initialize(ctx=mx.gpu(0))
        return net

    def lm_loss(n, a, b):
        vocab = n.config.vocab_size
        return mx.nd.softmax_cross_entropy(
            n(a).reshape((-1, vocab)), b.reshape((-1,))) / b.size

    net_e = make()
    ids, labels = _ids_labels(torch, mx, net_e.config.vocab_size, 1024,
                              SEED + 12)
    start = {k: p.data()._data.clone() for k, p in
             net_e._collect_params_with_prefix().items()}
    tr_e = mx.gluon.Trainer(net_e.collect_params(), "sgd", dict(kw))
    eager = []
    for _ in range(FUSED_LLAMA_K):
        with mx.autograd.record():
            loss = lm_loss(net_e, ids, labels)
        loss.backward()
        tr_e.step(1)
        eager.append(float(loss.asscalar()))
    net_f = make()
    tr_f = mx.gluon.Trainer(net_f.collect_params(), "sgd", dict(kw))
    fstep = mx.gluon.FusedTrainStep(net_f, tr_f, lm_loss,
                                    steps_per_execution=FUSED_LLAMA_K,
                                    batch_size=1)
    _zero_counts(fa)
    mt_before = mt.multi_tensor_update.launches
    torch.cuda.synchronize()
    t = time.perf_counter()
    fused = fstep(ids, labels).asnumpy().tolist()
    first_call_s = time.perf_counter() - t
    launched = [c.launches for c in _counters(fa)]
    mt_launched = mt.multi_tensor_update.launches - mt_before
    graph = next(iter(fstep._graphs.values()))["graph"]
    worst, worst_name = 0.0, None
    pe = net_e._collect_params_with_prefix()
    for k, p in net_f._collect_params_with_prefix().items():
        moved = (pe[k].data()._data - start[k]).abs().max().item()
        share = (p.data()._data - pe[k].data()._data).abs().max().item() / \
            max(moved, 1e-30)
        if share > worst:
            worst, worst_name = share, k
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fused, eager))
    per_step = 2 * FUSED_LLAMA_K  # 2 layers, K steps
    ok = launched == [per_step] * 3 and mt_launched == FUSED_LLAMA_K and \
        loss_rel <= 1e-5 and worst <= 1e-3
    emit(dict(phase="fused_step_llama", layers=2, T=1024, dtype="float32",
              K=FUSED_LLAMA_K, losses=fused, eager_losses=eager,
              max_loss_rel_err=loss_rel, worst_weight_err_share=worst,
              worst_param=worst_name,
              launches=dict(zip(("fwd", "dq", "dkv"), launched)),
              multi_tensor_launches=mt_launched,
              graph_replays=graph.replays, graph_pool_bytes=graph.pool_bytes,
              first_call_s=first_call_s, ok=ok))
    if not ok:
        failures.append(f"fused step (llama): losses {fused} vs {eager}, "
                        f"worst weight share {worst} ({worst_name}), "
                        f"launches {launched}, update launches "
                        f"{mt_launched}")
    del net_e, tr_e, start, pe, fstep, graph
    free_card(torch)

    # the checkpoint round trip from the fused net's state
    ckpt_dir = tempfile.mkdtemp(prefix="mxt_ckpt_")
    try:
        t = time.perf_counter()
        checkpoint.save_checkpoint(ckpt_dir, FUSED_LLAMA_K, net_f, tr_f)
        save_s = time.perf_counter() - t
        ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(ckpt_dir) for f in fs)

        def one_step(net, tr):
            with mx.autograd.record():
                loss = lm_loss(net, ids, labels)
            loss.backward()
            tr.step(1)
            return float(loss.asscalar())

        loss_a = one_step(net_f, tr_f)
        mx.random.seed(SEED + 1)
        net_r = llama.llama3_8b(num_layers=2)
        net_r.initialize(ctx=mx.gpu(0))  # other weights: all come from disk
        tr_r = mx.gluon.Trainer(net_r.collect_params(), "sgd", dict(kw))
        t = time.perf_counter()
        step, _ = checkpoint.resume(ckpt_dir, net_r, tr_r)
        resume_s = time.perf_counter() - t
        loss_b = one_step(net_r, tr_r)
        pr = net_r._collect_params_with_prefix()
        diff = max((p.data()._data - pr[k].data()._data).abs().max().item()
                   for k, p in net_f._collect_params_with_prefix().items())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ok = step == FUSED_LLAMA_K and loss_a == loss_b and diff == 0.0
    emit(dict(phase="checkpoint_round_trip", layers=2, dtype="float32",
              step=step, loss_uninterrupted=loss_a, loss_resumed=loss_b,
              max_abs_weight_diff=diff, checkpoint_bytes=ckpt_bytes,
              save_s=save_s, resume_s=resume_s, ok=ok))
    if not ok:
        failures.append(f"checkpoint round trip: step {step}, loss "
                        f"{loss_b} vs {loss_a}, weights differ by {diff}")
    del net_f, tr_f, net_r, tr_r, pr
    free_card(torch)


def fused_resnet_phase(torch, mx, vision, mt, failures):
    """Phase 12b: ``FusedTrainStep(net, trainer, forward_loss,
    steps_per_execution=8, batch_size=128)`` on ``resnet50_v1`` in bf16
    (bench.py's protocol; SGD lr ``FUSED_RESNET_LR``, momentum 0.9, one
    constant batch): the first call (step 0 eager, the capture, 7
    replays) against 8 eager ``Trainer.step``s from the same weights,
    both falling; then one timed call of 8 replays: ms a step and
    images/s, and the graph's pool bytes."""
    free_card(torch)
    b = RESNET_BATCHES[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    x = mx.nd.array(torch.rand((b, 3, 224, 224), generator=gen,
                               device="cuda").bfloat16())
    y = mx.nd.array(torch.randint(0, 1000, (b,), generator=gen,
                                  device="cuda").float())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def make():
        mx.random.seed(SEED)
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(mx.nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
        net.cast("bfloat16")
        return net, mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": FUSED_RESNET_LR, "momentum": 0.9})

    net, tr = make()
    eager, eager_ms = [], []
    for _ in range(FUSED_STEP_K):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(b)
        eager.append(float(loss.sum().asscalar()))
        eager_ms.append((time.perf_counter() - t) * 1e3)
    del net, tr, loss
    free_card(torch)
    net, tr = make()
    fstep = mx.gluon.FusedTrainStep(
        net, tr, lambda n, a, c: loss_fn(n(a), c),
        steps_per_execution=FUSED_STEP_K, batch_size=b)
    mt.multi_tensor_update.launches = before = 0  # the main path starts
    torch.cuda.synchronize()
    t = time.perf_counter()
    fused = fstep(x, y).asnumpy().tolist()
    first_call_s = time.perf_counter() - t
    launched = mt.multi_tensor_update.launches - before
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    more = fstep(x, y).asnumpy()
    call_ms = (time.perf_counter() - t) * 1e3
    launched_all = mt.multi_tensor_update.launches  # ... and ends here
    graph = next(iter(fstep._graphs.values()))["graph"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(fused, eager))
    falling = eager[-1] < eager[0] and fused[-1] < fused[0]
    ok = rel <= FUSED_LOSS_RTOL and falling and \
        launched == FUSED_STEP_K and \
        launched_all == 2 * FUSED_STEP_K and \
        bool(np.isfinite(more).all()) and len(fstep._graphs) == 1
    step_ms = call_ms / FUSED_STEP_K
    emit(dict(phase="fused_step_resnet", B=b, dtype="bfloat16",
              K=FUSED_STEP_K, lr=FUSED_RESNET_LR, losses=fused,
              eager_losses=eager, falling=falling,
              max_loss_rel_err=rel, tol=FUSED_LOSS_RTOL,
              eager_step_ms=eager_ms, first_call_s=first_call_s,
              call_ms=call_ms, step_ms=step_ms,
              images_per_s=b / step_ms * 1e3, next_losses=more.tolist(),
              multi_tensor_launches=launched_all,
              graph_replays=graph.replays, graph_pool_bytes=graph.pool_bytes,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              ok=ok))
    if not ok:
        failures.append(f"fused step (resnet): losses {fused} vs eager "
                        f"{eager} (worst {rel}), update launches "
                        f"{launched}/{launched_all}")
    del net, tr, fstep, graph
    free_card(torch)
    return launched_all



def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.models import llama
    from mxnet_tpu_torch.ops import conv_bn_relu as cbr
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import multi_tensor as mt
    from mxnet_tpu_torch import checkpoint, serving

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    flags = torch.backends.cuda.matmul
    emit(dict(phase="card", nvidia_smi=smi,
              precision_flags={  # set by the package at import
                  "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                  "matmul.allow_tf32": flags.allow_tf32,
                  "matmul.allow_bf16_reduced_precision_reduction":
                      flags.allow_bf16_reduced_precision_reduction,
                  "matmul.allow_fp16_reduced_precision_reduction":
                      flags.allow_fp16_reduced_precision_reduction},
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              nvcc=run([_kernels.nvcc(), "--version"]).splitlines()[-1]))

    t = time.perf_counter()
    logs = _kernels.build(verbose=True)
    build_s = time.perf_counter() - t
    for name in _kernels.SOURCES:
        _kernels.load(name)
    emit(dict(phase="build", seconds=build_s, built=sorted(logs),
              ptxas=[ln.strip() for log in logs.values()
                     for ln in log.splitlines() if "registers" in ln]))

    failures = []
    if torch.backends.cudnn.allow_tf32 or flags.allow_tf32 or \
            flags.allow_bf16_reduced_precision_reduction or \
            flags.allow_fp16_reduced_precision_reduction:
        failures.append("a precision flag is on after importing the "
                        "package")
    rows = kernel_phase(torch, fa, failures)
    brows = backward_phase(torch, fa, failures)
    fused = fused_kernel_phase(torch, cbr, failures)
    mtrow = multi_tensor_phase(torch, mx, llama, mt, failures)
    f32_phase(torch, mx, llama, fa, failures)
    f32_train_phase(torch, mx, llama, fa, failures)
    bf16_phase(torch, mx, llama, fa, failures)
    fused_llama_phase(torch, mx, llama, fa, mt, checkpoint, failures)
    serving_f32_phase(torch, mx, llama, serving, failures)
    infer_launches, infer_mma, net = slice_phase(torch, mx, llama, fa,
                                                 failures)
    serving_bf16_phase(torch, mx, llama, serving, fa, net, failures)
    del net
    train_launches, train_mma, update_launches = train_phase(
        torch, mx, llama, fa, mt, failures)
    resnet_f32_phase(torch, mx, vision, cbr, failures)
    resnet18_f32_train_phase(torch, mx, vision, failures)
    fused_launches, fused_mma = resnet_infer_phase(torch, mx, vision, cbr,
                                                   failures)
    update_launches += resnet_train_phase(torch, mx, vision, cbr, mt,
                                          failures)
    update_launches += fused_resnet_phase(torch, mx, vision, mt, failures)
    if update_launches == 0:
        failures.append("the training paths launched no multi-tensor "
                        "update")

    s, bs = rows[0], brows[0]
    src = "mxnet_tpu_torch/csrc/flash_attention_{}.cu"
    replaces = "mxnet_tpu/ops/flash_attention.py:{}"
    # each kernel: the design that ran at the slice shape (the forward's
    # shapes for the fused kernel), and the main paths' launches of each
    # design (the f32 FMA design's are the rest)
    fwd_launches = infer_launches + train_launches[0]
    fwd_mma = infer_mma + train_mma[0]
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src.format("fwd"), "replaces": replaces.format(132),
         "design": design_name(s["design"], s["dtype"]),
         "launches": fwd_launches, "launches_mma": fwd_mma,
         "launches_fma": fwd_launches - fwd_mma,
         "max_abs_err": s["max_abs_err_o"], "ms": s["kernel_ms"],
         "tflops": s["tflops"],
         "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
         "bound_by": s["bound_by"], "library_ms": s["library_ms"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": src.format("bwd"), "replaces": replaces.format(259),
         "design": design_name(bs["dq_design"], bs["dtype"]),
         "launches": train_launches[1], "launches_mma": train_mma[1],
         "launches_fma": train_launches[1] - train_mma[1],
         "max_abs_err": bs["max_abs_err_dq"], "ms": bs["dq_ms"],
         "tflops": bs["dq_tflops"],
         "plain_ms": bs["plain_ms"], "bound_ms": bs["dq_bound_ms"],
         "bound_by": bs["dq_bound_by"], "library_ms": bs["library_ms"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": src.format("bwd"), "replaces": replaces.format(302),
         "design": design_name(bs["dkv_design"], bs["dtype"]),
         "launches": train_launches[2], "launches_mma": train_mma[2],
         "launches_fma": train_launches[2] - train_mma[2],
         "max_abs_err": max(bs["max_abs_err_dk"], bs["max_abs_err_dv"]),
         "ms": bs["dkv_ms"], "tflops": bs["dkv_tflops"],
         "plain_ms": bs["plain_ms"],
         "bound_ms": bs["dkv_bound_ms"], "bound_by": bs["dkv_bound_by"],
         "library_ms": bs["library_ms"]},
        {"name": "fused_matmul_affine_relu", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/fused_matmul_affine_relu.cu",
         "replaces": "tools/pallas_conv_probe.py:35",
         "design": design_name(fused["design"], "bfloat16"),
         "launches": fused_launches, "launches_mma": fused_mma,
         "launches_fma": fused_launches - fused_mma,
         "max_abs_err": fused["max_abs_err"],
         "ms": fused["kernel_ms"], "tflops": fused["tflops"],
         "plain_ms": fused["plain_ms"],
         "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
         "library_ms": fused["library_ms"]},
        {"name": "multi_tensor_update", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/multi_tensor_update.cu",
         "replaces": "mxnet_tpu/gluon/trainer.py:516",
         "design": "one launch over a device table, bf16 SGD momentum",
         "launches": update_launches, "max_abs_err": mtrow["max_abs_err"],
         "ms": mtrow["kernel_ms"], "plain_ms": mtrow["plain_ms"],
         "bound_ms": mtrow["bound_ms"], "bound_by": mtrow["bound_by"],
         "library_ms": mtrow["library_ms"]}]})
    if failures:
        for f in failures:
            print("FAILED: " + f, file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
