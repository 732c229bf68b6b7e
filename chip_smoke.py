#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA
card: Llama-3-8B inference and training through the hand-written
flash-attention kernels (forward, dQ, dK/dV; bf16 and f16 on the tensor
cores, f32 on the FMA pipes), and ResNet-50 v1 inference through the
hand-written fused 1x1 conv + BatchNorm + ReLU kernel (bf16 on the tensor
cores, f32 on the FMA pipes), and its training step.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit.  Phases, each printed as a JSON line:

1. card: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc;
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
   at ResNet-50 v1's eight shapes (B=128, bf16), one f32 and one ragged
   shape, with its design, time, TFLOP/s, the plain version's time, the
   library's (``addmm`` with the scale folded, then ``relu``), the eager
   cuDNN chain's and the bound, and the NCHW -> (M, K) copy's time; then
   one forward's sums;
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
8. the Llama inference slice: ``llama3_8b`` at full width and depth in
   bf16, weights drawn on the card from a seed: one prompt forward
   (T=2048) and three greedy ``generate`` requests;
9. the Llama training slice: ``llama3_8b`` at full width and 16 layers in
   bf16, B=1, T=2048, SGD with momentum through ``gluon.Trainer``: one
   warm-up step and three timed steps on one batch;
10. ResNet f32 checks: ``resnet50_v1`` f32, B=2, 224x224, on the card
    (16 fused launches of the FMA design, no TF32) against the CPU (the
    plain version);
    ``resnet18_v1`` thumbnail, one f32 SGD-momentum step on the card
    against the CPU;
11. the ResNet inference slice: ``resnet50_v1`` bf16, 224x224, B=128 and
    B=4, 16 fused launches of the tensor-core design a forward;
12. the ResNet training slice: ``resnet50_v1`` bf16, B=128, 224x224,
    SGD (lr 0.1, momentum 0.9) and ``SoftmaxCrossEntropyLoss`` (bench.py's
    protocol, eager): one warm-up step and three timed steps on one batch,
    no fused launch (BatchNorm normalizes by the batch).

The launch counters are set to 0 just before each slice (8, 9, 11) and
read just after, and at the start of each check that counts them (6, 7,
7b); the bf16 slices must launch the tensor-core designs
(``launches_mma``), the f32 checks the FMA designs.  It exits non-zero on any failed check, and with no
result line when there is no CUDA card or the package is not beside it.
Its last line is ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import math
import subprocess
import sys
import time

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


def train_phase(torch, mx, llama, fa, failures):
    """Phase 9: llama3_8b at full width, 16 layers, bf16, B=1, T=2048,
    SGD with momentum — the training main path."""
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

    for step in range(4):  # one warm-up, then three timed steps
        before = [c.launches for c in _counters(fa)]
        before_mma = _mma_counts(fa)
        stamps, step_peaks = [], []
        phase_end(stamps, [])
        loss_nd = _lm_forward(mx, net, ids, labels)
        phase_end(stamps, step_peaks)
        loss_nd.backward()
        phase_end(stamps, step_peaks)
        trainer.step(1)
        phase_end(stamps, step_peaks)
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
            mma == [TRAIN_LAYERS] * 3
        emit(dict(phase="train_step", step=step, warmup=step == 0,
                  loss=loss, ms=ms, tokens_per_s=2048 / ms * 1e3,
                  forward_ms=fwd_ms, backward_ms=bwd_ms,
                  update_ms=update_ms,
                  launches=dict(zip(("fwd", "dq", "dkv"), launched)),
                  launches_mma=dict(zip(("fwd", "dq", "dkv"), mma)),
                  max_memory_allocated=dict(zip(
                      ("forward", "backward", "update"), step_peaks)),
                  ok=ok))
        if not ok:
            failures.append(f"train step {step}: loss {loss}, launches "
                            f"{launched}, tensor-core launches {mma}")
    launches = [c.launches for c in _counters(fa)]  # the main path ends
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
              ok=losses[-1] < losses[0]))
    return launches, launches_mma


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
        del logits

    for b, t0 in REQUESTS:
        prompt = mx.nd.array(torch.randint(
            0, cfg.vocab_size, (b, t0), generator=gen, device="cuda",
            dtype=torch.int32))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = net.generate(prompt, max_new_tokens=NEW_TOKENS)
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
        ok = out.shape == (b, t0 + NEW_TOKENS) and \
            bool(torch.equal(out._data[:, :t0], prompt._data)) and \
            bool(((out._data >= 0) & (out._data < cfg.vocab_size)).all())
        decode_ms = total_ms - prefill_ms
        emit(dict(phase="request", B=b, prompt=t0, new_tokens=NEW_TOKENS,
                  max_len=dec.max_len, prefill_len=lp, total_ms=total_ms,
                  prefill_ms=prefill_ms,
                  decode_tokens_per_s=b * (NEW_TOKENS - 1) / decode_ms * 1e3
                  if decode_ms > 0 else None,
                  first_token_matches_forward_argmax=bool(
                      torch.equal(first, ref_first)), ok=ok))
        if not ok:
            failures.append(f"request B={b} t0={t0}: bad output")
        del out, w
    launches = fa.flash_attention_fwd.launches  # the main path ends here
    launches_mma = fa.flash_attention_fwd.launches_mma
    emit(dict(phase="memory",
              max_memory_allocated=torch.cuda.max_memory_allocated()))
    if launches == 0 or launches_mma == 0:
        failures.append("the main path launched no flash_attention_fwd "
                        f"(tensor-core launches {launches_mma})")
    return launches, launches_mma


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
# kernel against its plain version on f32 copies: bf16, the kernel rounds
# its f32 result to 8 mantissa bits (2^-8 of each value) and sums in
# another order than cuBLAS (1e-4 of the largest value at K <= 2048); f32,
# only the summation order
FUSED_REL_TOL = {"bfloat16": 2.0 ** -8, "float32": 0.0}
FUSED_ABS_TOL = {"bfloat16": 1e-4, "float32": 1e-5}  # x the largest value
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
            dtype=dt, design="mma" if dtype == torch.bfloat16 else "fma",
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
    # them; bound by what bounds most of the summed bound
    forward = [r for r in rows if r["launches_per_forward"]]
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
    main path through the fused kernel, 16 launches a forward."""
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
    launches, launches_mma = fn.launches, fn.launches_mma  # the path ends
    if launches_mma == 0:
        failures.append("the ResNet inference path launched no "
                        "tensor-core fused_matmul_affine_relu")
    del net, inputs
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


def resnet_train_phase(torch, mx, vision, cbr, failures):
    """``resnet50_v1``, bf16 (``net.cast``), B=128, 224x224, SGD with
    momentum 0.9 and lr 0.1, ``SoftmaxCrossEntropyLoss`` — bench.py's
    protocol, eager: one warm-up step and three timed steps on one batch.
    BatchNorm normalizes by the batch, so the fused kernel never runs."""
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
        loss = _resnet_step(mx, net, trainer, loss_fn, x, y, mark)
        fwd_ms, bwd_ms, upd_ms = ((b2 - a) * 1e3 for a, b2 in
                                  zip(stamps, stamps[1:]))
        ms = (stamps[-1] - stamps[0]) * 1e3
        losses.append(loss)
        if step:
            step_ms.append(ms)
        ok = math.isfinite(loss)
        emit(dict(phase="resnet_train_step", step=step, warmup=step == 0,
                  B=b, loss=loss, ms=ms, images_per_s=b / ms * 1e3,
                  forward_ms=fwd_ms, backward_ms=bwd_ms, update_ms=upd_ms,
                  max_memory_allocated=dict(zip(
                      ("forward", "backward", "update"), peaks)), ok=ok))
        if not ok:
            failures.append(f"resnet train step {step}: loss {loss}")
    fused = cbr.fused_matmul_affine_relu.launches - fused_before
    ok = losses[-1] < losses[0] and fused == 0
    emit(dict(phase="resnet_train_summary", losses=losses, step_ms=step_ms,
              fused_launches=fused, ok=ok))
    if not ok:
        failures.append(f"resnet training: losses {losses}, fused launches "
                        f"{fused} (expected a falling loss and 0)")
    del net, trainer, x, y
    free_card(torch)


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

    # float32 matmuls in full f32 (no TF32), for the f32 checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit(dict(phase="card", nvidia_smi=smi,
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
    rows = kernel_phase(torch, fa, failures)
    brows = backward_phase(torch, fa, failures)
    fused = fused_kernel_phase(torch, cbr, failures)
    f32_phase(torch, mx, llama, fa, failures)
    f32_train_phase(torch, mx, llama, fa, failures)
    bf16_phase(torch, mx, llama, fa, failures)
    infer_launches, infer_mma = slice_phase(torch, mx, llama, fa, failures)
    train_launches, train_mma = train_phase(torch, mx, llama, fa, failures)
    resnet_f32_phase(torch, mx, vision, cbr, failures)
    resnet18_f32_train_phase(torch, mx, vision, failures)
    fused_launches, fused_mma = resnet_infer_phase(torch, mx, vision, cbr,
                                                   failures)
    resnet_train_phase(torch, mx, vision, cbr, failures)

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
         "library_ms": fused["library_ms"]}]})
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
