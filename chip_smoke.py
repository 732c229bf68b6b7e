#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA
card: Llama-3-8B inference through the hand-written flash-attention
kernel.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit.  Phases, each printed as a JSON line:

1. card: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc;
2. build: ``csrc/flash_attention_fwd.cu`` with nvcc for sm_90a;
3. kernel: the kernel against its plain PyTorch version at five shapes,
   with its time, the plain version's, torch SDPA's (a yardstick only,
   where Tq = Tk) and the card's bound;
4. f32 check: ``llama3_8b`` width at 2 layers, f32, ``net(ids)`` through
   the kernel against the KV-cache decoder's dense prefill;
5. the slice: ``llama3_8b`` at full width and depth in bf16, weights drawn
   on the card from a seed: one prompt forward (T=2048) and three greedy
   ``generate`` requests, with the kernel's launch count over this phase.

It exits non-zero on any failed check, and with no result line when there
is no CUDA card or the package is not beside it.  Its last line is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import sys
import time

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES = 3.35e12
# (name, B, H, Tq, Tk, D, causal, dtype); the first is the slice's shape
KERNEL_SHAPES = [
    ("slice", 1, 32, 2048, 2048, 128, True, "bfloat16"),
    ("ragged", 2, 32, 1000, 1000, 128, True, "bfloat16"),
    ("noncausal_f32", 2, 4, 256, 256, 64, False, "float32"),
    ("bottom_right", 1, 2, 4, 6, 32, True, "float32"),
    ("d16", 2, 4, 128, 128, 16, True, "float32"),
]
# f32: another summation order than the plain version; bf16: the kernel's
# output is rounded to 8 mantissa bits; lse is f32 in both
O_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
LSE_TOL = 1e-3
REQUESTS = [(1, 100), (4, 512), (1, 1500)]  # (batch, prompt length)
NEW_TOKENS = 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (out.stdout or out.stderr).strip()


def time_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back launches,
    after one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(b, h, tq, tk, d, causal, dtype, itemsize):
    """Least time for this work on the card: the larger of the bytes
    (q, k, v read once, O and lse written once) over the memory rate and
    the operations these inputs need (2 products of 2·D flops per visible
    (query, key) pair) over the peak rate of their type."""
    if causal:
        pairs = sum(min(tk, max(0, i + tk - tq + 1)) for i in range(tq))
    else:
        pairs = tq * tk
    flops = 4.0 * d * pairs * b * h
    nbytes = itemsize * b * h * d * (2 * tq + 2 * tk) + 4 * b * h * tq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


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
        err_o = (o.float() - o_ref).abs().max().item()
        fin = torch.isfinite(lse_ref)
        fin_same = bool(torch.equal(fin, torch.isfinite(lse)))
        err_lse = (lse - lse_ref)[fin].abs().max().item() if fin.any() \
            else 0.0
        ok = (fin_same and math.isfinite(err_o) and err_o <= O_TOL[dt]
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
                                                 scale=scale), iters)
        bnd, by = bound_ms(b, h, tq, tk, d, causal, dt, q.element_size())
        row = dict(phase="kernel", shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d,
                   causal=causal, dtype=dt, max_abs_err_o=err_o,
                   max_abs_err_lse=err_lse, masked_rows_agree=fin_same,
                   tol_o=O_TOL[dt], tol_lse=LSE_TOL, kernel_ms=k_ms,
                   plain_ms=p_ms, library_ms=lib_ms, bound_ms=bnd,
                   bound_by=by, ok=ok)
        emit(row)
        rows.append(row)
        if not ok:
            failures.append(f"kernel {name}: O err {err_o}, lse err "
                            f"{err_lse}, masked rows agree {fin_same}")
    return rows


def f32_phase(torch, mx, llama, fa, failures):
    """Phase 4: full width, 2 layers, f32: the flash forward against the
    decoder's dense prefill on the same ids."""
    mx.random.seed(SEED)
    net = llama.llama3_8b(num_layers=2)
    net.initialize(ctx=mx.gpu(0))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    ids = torch.randint(0, net.config.vocab_size, (1, 1024), generator=gen,
                        device="cuda", dtype=torch.int32)
    before = fa.flash_attention_fwd.launches
    logits = net(mx.nd.array(ids))._data[:, -1].float()
    launched = fa.flash_attention_fwd.launches - before
    dec = llama.LlamaDecoder(net, max_len=1024)
    with torch.no_grad():
        _, ref = dec._prefill_impl(dec._weights(), ids, 1024)
    err = (logits - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = launched == 2 and err <= 1e-3 * scale and math.isfinite(err)
    emit(dict(phase="f32_check", layers=2, T=1024, launches=launched,
              max_abs_err=err, max_abs_logit=scale,
              tol=1e-3 * scale, ok=ok))
    if not ok:
        failures.append(f"f32 check: launches {launched}, err {err} vs "
                        f"{1e-3 * scale}")
    del net, dec, logits, ref
    torch.cuda.empty_cache()


def slice_phase(torch, mx, llama, fa, failures):
    """Phase 5: llama3_8b, 32 layers, bf16 — the main path."""
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
    fa.flash_attention_fwd.launches = 0  # the main path starts here

    ids = mx.nd.array(torch.randint(0, cfg.vocab_size, (1, 2048),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32))
    for run_i in range(2):  # the first call also warms up cuBLAS
        before = fa.flash_attention_fwd.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = net(ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = fa.flash_attention_fwd.launches - before
        finite = bool(torch.isfinite(logits._data).all())
        ok = launched == cfg.num_layers and finite and \
            logits.shape == (1, 2048, cfg.vocab_size)
        emit(dict(phase="prompt_forward", run=run_i, B=1, T=2048,
                  launches=launched, finite=finite, ms=ms,
                  tokens_per_s=2048 / ms * 1e3, ok=ok))
        if not ok:
            failures.append(f"prompt forward: launches {launched}, "
                            f"finite {finite}")
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
    emit(dict(phase="memory",
              max_memory_allocated=torch.cuda.max_memory_allocated()))
    if launches == 0:
        failures.append("the main path launched no flash_attention_fwd")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.models import llama
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
    _kernels.load("flash_attention_fwd")
    emit(dict(phase="build", seconds=build_s, built=sorted(logs),
              ptxas=[ln.strip() for log in logs.values()
                     for ln in log.splitlines() if "registers" in ln]))

    failures = []
    rows = kernel_phase(torch, fa, failures)
    f32_phase(torch, mx, llama, fa, failures)
    launches = slice_phase(torch, mx, llama, fa, failures)

    s = rows[0]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/flash_attention.py:132",
        "launches": launches, "max_abs_err": s["max_abs_err_o"],
        "ms": s["kernel_ms"], "plain_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
        "library_ms": s["library_ms"]}]})
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
