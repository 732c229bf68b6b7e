"""The op library of the PyTorch/CUDA port against the JAX package: one
case per op of ``ops/elemwise.py``, ``ops/tensor.py``,
``ops/output_ops.py`` and ``ops/nn_ops.py``.

Each case draws its inputs with numpy from a seed, runs the op through
``mx.nd`` of both packages (the port on the CPU), and compares every
output and, for a differentiable op, the gradient of
Σ out·head (the heads drawn from the seed too) with respect to its float
inputs.  Tolerances: f32 ``rtol=1e-5, atol=1e-6`` unless a case states
its own (special functions and the decompositions 1e-4); bf16 cases
``2e-2`` (8 mantissa bits, f32 accumulation on both sides).  The
decompositions' factors are compared through sign-invariant functions of
them (squares, absolute values): two LAPACK calls may choose opposite
signs.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
F32 = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(kinds, seed):
    rng = np.random.RandomState(seed)
    out = []
    for shape, kind in kinds:
        if kind == "n":
            a = rng.normal(size=shape)
        elif kind == "nz":  # away from 0 (no kink or tie at 0)
            a = rng.uniform(0.2, 1.5, shape) * rng.choice([-1, 1], shape)
        elif kind == "p":
            a = rng.uniform(0.5, 2.0, shape)
        elif kind == "u":
            a = rng.uniform(-0.9, 0.9, shape)
        elif kind == "g":
            a = rng.uniform(1.1, 3.0, shape)
        elif kind.startswith("i"):
            a = rng.randint(0, int(kind[1:]), shape)
        elif kind == "b":
            a = rng.randint(0, 2, shape)
        elif kind == "spd":
            m = rng.normal(size=shape)
            a = m @ np.swapaxes(m, -1, -2) + shape[-1] * np.eye(shape[-1])
        elif kind == "low":
            a = np.tril(rng.normal(size=shape)) + 3 * np.eye(shape[-1])
        elif kind == "nan":
            a = rng.normal(size=shape)
            a.reshape(-1)[1] = np.nan
        else:
            raise ValueError(kind)
        out.append(np.asarray(a, dtype=np.float32))
    return out


class Case:
    """``grad``: the inputs whose gradients are compared; ``seeded``: the
    outputs the backward is seeded at (all when None; an output without a
    gradient, such as BatchNorm's moved statistics, is left out)."""

    def __init__(self, name, fn, kinds, grad=(0,), tol=F32, dtype=None,
                 train=True, seeded=None):
        self.name, self.fn, self.kinds = name, fn, kinds
        self.grad, self.tol, self.dtype, self.train = grad, tol, dtype, train
        self.seeded = seeded


def _run(pkg, case, arrays, heads):
    """Outputs, and with ``heads`` the gradients of Σ out·head (one
    backward seeded with the heads) for the inputs in ``case.grad``."""
    kw = dict(ctx=CPU) if pkg is tmx else {}
    xs = [pkg.nd.array(a, dtype=case.dtype if i in case.grad else None,
                       **kw) for i, a in enumerate(arrays)]
    for i in case.grad:
        xs[i].attach_grad()
    with pkg.autograd.record(train_mode=case.train):
        out = case.fn(pkg.nd, *xs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [np.asarray(o.asnumpy()).astype(np.float64) for o in outs]
    if heads is None or not case.grad:
        return values, []
    seeded = case.seeded if case.seeded is not None else range(len(outs))
    pkg.autograd.backward([outs[i] for i in seeded],
                          [pkg.nd.array(heads[i], dtype=outs[i].dtype, **kw)
                           for i in seeded])
    return values, [np.asarray(xs[i].grad.asnumpy()).astype(np.float64)
                    for i in case.grad]


X34 = [((3, 4), "n")]
NZ = [((3, 4), "nz")]
P34 = [((3, 4), "p")]
U34 = [((3, 4), "u")]
TWO = [((3, 4), "n"), ((3, 4), "nz")]
BCAST = [((3, 4), "n"), ((1, 4), "p")]
IMG = [((2, 3, 6, 6), "n")]

CASES = [
    # --- elemwise unary ----------------------------------------------------
    Case("abs", lambda nd, x: nd.abs(x), NZ),
    Case("sign", lambda nd, x: nd.sign(x), NZ, grad=()),
    Case("ceil", lambda nd, x: nd.ceil(x), X34, grad=()),
    Case("floor", lambda nd, x: nd.floor(x), X34, grad=()),
    Case("rint", lambda nd, x: nd.rint(x * 3), X34, grad=()),
    Case("round", lambda nd, x: nd.round(x * 3), X34, grad=()),
    Case("trunc", lambda nd, x: nd.trunc(x * 3), X34, grad=()),
    Case("fix", lambda nd, x: nd.fix(x * 3), X34, grad=()),
    Case("exp", lambda nd, x: nd.exp(x), X34),
    Case("expm1", lambda nd, x: nd.expm1(x), X34),
    Case("log", lambda nd, x: nd.log(x), P34),
    Case("log10", lambda nd, x: nd.log10(x), P34),
    Case("log2", lambda nd, x: nd.log2(x), P34),
    Case("log1p", lambda nd, x: nd.log1p(x), P34),
    Case("sqrt", lambda nd, x: nd.sqrt(x), P34),
    Case("rsqrt", lambda nd, x: nd.rsqrt(x), P34),
    Case("cbrt", lambda nd, x: nd.cbrt(x), NZ, tol=LOOSE),
    Case("rcbrt", lambda nd, x: nd.rcbrt(x), NZ, tol=LOOSE),
    Case("square", lambda nd, x: nd.square(x), X34),
    Case("reciprocal", lambda nd, x: nd.reciprocal(x), NZ),
    Case("negative", lambda nd, x: nd.negative(x), X34),
    Case("relu", lambda nd, x: nd.relu(x), NZ),
    Case("sigmoid", lambda nd, x: nd.sigmoid(x), X34),
    Case("softsign", lambda nd, x: nd.softsign(x), X34),
    Case("softrelu", lambda nd, x: nd.softrelu(x), X34),
    Case("tanh", lambda nd, x: nd.tanh(x), X34),
    Case("sin", lambda nd, x: nd.sin(x), X34),
    Case("cos", lambda nd, x: nd.cos(x), X34),
    Case("tan", lambda nd, x: nd.tan(x), U34),
    Case("arcsin", lambda nd, x: nd.arcsin(x), U34),
    Case("arccos", lambda nd, x: nd.arccos(x), U34),
    Case("arctan", lambda nd, x: nd.arctan(x), X34),
    Case("sinh", lambda nd, x: nd.sinh(x), X34),
    Case("cosh", lambda nd, x: nd.cosh(x), X34),
    Case("arcsinh", lambda nd, x: nd.arcsinh(x), X34),
    Case("arccosh", lambda nd, x: nd.arccosh(x), [((3, 4), "g")]),
    Case("arctanh", lambda nd, x: nd.arctanh(x), U34),
    Case("erf", lambda nd, x: nd.erf(x), X34),
    Case("erfinv", lambda nd, x: nd.erfinv(x), U34, tol=LOOSE),
    Case("gamma", lambda nd, x: nd.gamma(x), NZ, tol=LOOSE),
    Case("gammaln", lambda nd, x: nd.gammaln(x), P34, tol=LOOSE),
    Case("logical_not", lambda nd, x: nd.logical_not(x),
         [((3, 4), "b")], grad=()),
    Case("degrees", lambda nd, x: nd.degrees(x), X34),
    Case("radians", lambda nd, x: nd.radians(x), X34),
    Case("identity", lambda nd, x: nd.identity(x), X34),
    Case("isnan", lambda nd, x: nd.isnan(x), [((3, 4), "nan")], grad=()),
    Case("isinf", lambda nd, x: nd.isinf(x / nd.abs(nd.round(x))), X34,
         grad=()),
    Case("isfinite", lambda nd, x: nd.isfinite(x), [((3, 4), "nan")],
         grad=()),
    # --- elemwise binary ---------------------------------------------------
    Case("add", lambda nd, a, b: nd.add(a, b), BCAST, grad=(0, 1)),
    Case("subtract", lambda nd, a, b: nd.subtract(a, b), BCAST, grad=(0, 1)),
    Case("multiply", lambda nd, a, b: nd.multiply(a, b), BCAST,
         grad=(0, 1)),
    Case("divide", lambda nd, a, b: nd.divide(a, b), BCAST, grad=(0, 1)),
    Case("mod", lambda nd, a, b: nd.mod(a * 3, b), BCAST, grad=(0, 1)),
    Case("power", lambda nd, a, b: nd.power(a, b),
         [((3, 4), "p"), ((3, 4), "n")], grad=(0, 1)),
    Case("maximum", lambda nd, a, b: nd.maximum(a, b), TWO, grad=(0, 1)),
    Case("minimum", lambda nd, a, b: nd.minimum(a, b), TWO, grad=(0, 1)),
    Case("hypot", lambda nd, a, b: nd.hypot(a, b), TWO, grad=(0, 1)),
    Case("arctan2", lambda nd, a, b: nd.arctan2(a, b), TWO, grad=(0, 1)),
    Case("equal", lambda nd, a, b: nd.equal(nd.round(a), nd.round(b)), TWO,
         grad=()),
    Case("not_equal", lambda nd, a, b: nd.not_equal(nd.round(a),
                                                    nd.round(b)), TWO,
         grad=()),
    Case("greater", lambda nd, a, b: nd.greater(a, b), TWO, grad=()),
    Case("greater_equal", lambda nd, a, b: nd.greater_equal(a, 0.1), TWO,
         grad=()),
    Case("lesser", lambda nd, a, b: nd.lesser(a, b), TWO, grad=()),
    Case("lesser_equal", lambda nd, a, b: nd.lesser_equal(a, b), TWO,
         grad=()),
    Case("logical_and", lambda nd, a, b: nd.logical_and(a, b),
         [((3, 4), "b"), ((3, 4), "b")], grad=()),
    Case("logical_or", lambda nd, a, b: nd.logical_or(a, b),
         [((3, 4), "b"), ((3, 4), "b")], grad=()),
    Case("logical_xor", lambda nd, a, b: nd.logical_xor(a, b),
         [((3, 4), "b"), ((3, 4), "b")], grad=()),
    Case("add_n", lambda nd, a, b, c: nd.add_n(a, b, c),
         [((3, 4), "n")] * 3, grad=(0, 1, 2)),
    # --- shape -------------------------------------------------------------
    Case("reshape", lambda nd, x: nd.reshape(x, shape=(-4, 1, 2, -3, 0, -2)),
         [((2, 3, 4, 5), "n")]),
    Case("reshape_like", lambda nd, x, y: nd.reshape_like(x, y),
         [((3, 4), "n"), ((2, 6), "n")]),
    Case("transpose", lambda nd, x: nd.transpose(x, axes=(1, 2, 0)),
         [((2, 3, 4), "n")]),
    Case("zeros_like", lambda nd, x: nd.zeros_like(x) + x, X34),
    Case("ones_like", lambda nd, x: nd.ones_like(x) * x, X34),
    Case("swapaxes", lambda nd, x: nd.swapaxes(x, 0, 2), [((2, 3, 4), "n")]),
    Case("expand_dims", lambda nd, x: nd.expand_dims(x, 1), X34),
    Case("squeeze", lambda nd, x: nd.squeeze(x, axis=1), [((3, 1, 4), "n")]),
    Case("broadcast_to", lambda nd, x: nd.broadcast_to(x, shape=(3, 0)),
         [((1, 4), "n")]),
    Case("broadcast_like", lambda nd, x, y: nd.broadcast_like(x, y),
         [((1, 4), "n"), ((3, 4), "n")]),
    Case("broadcast_axis", lambda nd, x: nd.broadcast_axis(x, axis=0,
                                                           size=3),
         [((1, 4), "n")]),
    Case("tile", lambda nd, x: nd.tile(x, reps=(2, 3)), X34),
    Case("repeat", lambda nd, x: nd.repeat(x, repeats=2, axis=1), X34),
    Case("flip", lambda nd, x: nd.flip(x, axis=1), X34),
    Case("pad_constant", lambda nd, x: nd.pad(
        x, mode="constant", pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
        constant_value=0.5), IMG),
    Case("pad_edge", lambda nd, x: nd.pad(
        x, mode="edge", pad_width=(0, 0, 0, 0, 1, 2, 2, 1)), IMG),
    Case("pad_reflect", lambda nd, x: nd.pad(
        x, mode="reflect", pad_width=(0, 0, 0, 0, 1, 2, 2, 1)), IMG),
    Case("concat", lambda nd, a, b: nd.concat(a, b, dim=0),
         [((3, 4), "n"), ((2, 4), "n")], grad=(0, 1)),
    Case("stack", lambda nd, a, b: nd.stack(a, b, axis=1),
         [((3, 4), "n"), ((3, 4), "n")], grad=(0, 1)),
    Case("split", lambda nd, x: nd.split(x, num_outputs=2, axis=1,
                                         squeeze_axis=False), X34),
    Case("slice", lambda nd, x: nd.slice(x, begin=(1, None),
                                         end=(None, 0), step=(1, -2)), X34),
    Case("slice_axis", lambda nd, x: nd.slice_axis(x, axis=1, begin=1,
                                                   end=3), X34),
    Case("slice_like", lambda nd, x, y: nd.slice_like(x, y, axes=(1,)),
         [((3, 4), "n"), ((2, 2), "n")]),
    Case("where", lambda nd, c, a, b: nd.where(c, a, b),
         [((3, 4), "b"), ((3, 4), "n"), ((3, 4), "n")], grad=(1, 2)),
    Case("clip", lambda nd, x: nd.clip(x, -0.5, 0.5), X34),
    Case("cast", lambda nd, x: nd.cast(x, dtype="float16"), X34,
         tol=dict(rtol=1e-3, atol=1e-3)),
    Case("diag", lambda nd, x: nd.diag(x, k=1), [((4, 4), "n")]),
    # --- reductions ----------------------------------------------------------
    Case("sum", lambda nd, x: nd.sum(x, axis=1, keepdims=True),
         [((2, 3, 4), "n")]),
    Case("sum_exclude", lambda nd, x: nd.sum(x, axis=1, exclude=True),
         [((2, 3, 4), "n")]),
    Case("nansum", lambda nd, x: nd.nansum(x, axis=0), [((3, 4), "nan")]),
    Case("mean", lambda nd, x: nd.mean(x, axis=(0, 2)), [((2, 3, 4), "n")]),
    Case("prod", lambda nd, x: nd.prod(x, axis=(0, 2)), [((2, 3, 4), "p")]),
    Case("nanprod", lambda nd, x: nd.nanprod(x, axis=1), [((3, 4), "nan")],
         grad=()),
    Case("max", lambda nd, x: nd.max(x, axis=1), X34),
    Case("min", lambda nd, x: nd.min(x), X34),
    Case("norm_l2", lambda nd, x: nd.norm(x, axis=1), X34),
    Case("norm_l1", lambda nd, x: nd.norm(x, ord=1, axis=0, keepdims=True),
         NZ),
    Case("norm_bf16", lambda nd, x: nd.norm(x), X34, tol=BF16,
         dtype="bfloat16"),
    Case("argmax", lambda nd, x: nd.argmax(x, axis=1), X34, grad=()),
    Case("argmin", lambda nd, x: nd.argmin(x, axis=0, keepdims=True), X34,
         grad=()),
    Case("argsort", lambda nd, x: nd.argsort(nd.round(x), axis=1,
                                             is_ascend=False), X34, grad=()),
    Case("sort", lambda nd, x: nd.sort(x, axis=1, is_ascend=False), X34),
    Case("topk_value", lambda nd, x: nd.topk(x, axis=1, k=2,
                                             ret_typ="value"), X34),
    Case("topk_both", lambda nd, x: nd.topk(nd.round(x), axis=0, k=2,
                                            ret_typ="both", is_ascend=True),
         X34, grad=()),
    Case("topk_mask", lambda nd, x: nd.topk(x, k=2, ret_typ="mask"), X34,
         grad=()),
    Case("cumsum", lambda nd, x: nd.cumsum(x, axis=1), X34),
    # --- indexing ------------------------------------------------------------
    Case("take", lambda nd, x, i: nd.take(x, i, axis=1, mode="wrap"),
         [((3, 4), "n"), ((2, 3), "i6")]),
    Case("pick", lambda nd, x, i: nd.pick(x, i, axis=1, keepdims=True),
         [((3, 4), "n"), ((3,), "i4")]),
    Case("one_hot", lambda nd, i: nd.one_hot(i, depth=5, on_value=2.0,
                                             off_value=-1.0),
         [((2, 3), "i5")], grad=()),
    Case("gather_nd", lambda nd, x, i: nd.gather_nd(x, i),
         [((3, 4), "n"), ((2, 5), "i3")]),
    Case("scatter_nd", lambda nd, v, i: nd.scatter_nd(v, i, shape=(3, 3)),
         [((5,), "n"), ((2, 5), "i3")]),
    Case("boolean_mask", lambda nd, x, m: nd.boolean_mask(x, m),
         [((4, 3), "n"), ((4,), "b")]),
    Case("shape_array", lambda nd, x: nd.shape_array(x), X34, grad=()),
    Case("size_array", lambda nd, x: nd.size_array(x), X34, grad=()),
    # --- sequence ------------------------------------------------------------
    Case("sequence_mask", lambda nd, x, sl: nd.sequence_mask(
        x, sl, use_sequence_length=True, value=-1.0),
        [((5, 3, 2), "n"), ((3,), "i6")]),
    Case("sequence_last", lambda nd, x, sl: nd.sequence_last(
        x, sl + 1, use_sequence_length=True), [((5, 3, 2), "n"),
                                               ((3,), "i5")]),
    Case("sequence_reverse", lambda nd, x, sl: nd.sequence_reverse(
        x, sl + 1, use_sequence_length=True), [((5, 3, 2), "n"),
                                               ((3,), "i5")]),
    # --- matmul --------------------------------------------------------------
    Case("dot", lambda nd, a, b: nd.dot(a, b, transpose_b=True),
         [((3, 4), "n"), ((5, 4), "n")], grad=(0, 1)),
    Case("dot_bf16", lambda nd, a, b: nd.dot(a, b),
         [((3, 8), "n"), ((8, 5), "n")], grad=(0, 1), tol=BF16,
         dtype="bfloat16"),
    Case("batch_dot", lambda nd, a, b: nd.batch_dot(a, b, transpose_a=True),
         [((2, 4, 3), "n"), ((2, 4, 5), "n")], grad=(0, 1)),
    Case("batch_dot_bf16", lambda nd, a, b: nd.batch_dot(a, b),
         [((2, 3, 8), "n"), ((2, 8, 5), "n")], grad=(0, 1), tol=BF16,
         dtype="bfloat16"),
    Case("fully_connected_bf16", lambda nd, x, w: nd.FullyConnected(
        x, w, num_hidden=5, no_bias=True), [((3, 8), "n"), ((5, 8), "n")],
        grad=(0, 1), tol=BF16, dtype="bfloat16"),
    # --- linalg --------------------------------------------------------------
    Case("linalg_gemm2", lambda nd, a, b: nd.linalg_gemm2(
        a, b, transpose_a=True, alpha=0.5), [((2, 4, 3), "n"),
                                             ((2, 4, 5), "n")], grad=(0, 1)),
    Case("linalg_gemm", lambda nd, a, b, c: nd.linalg_gemm(
        a, b, c, transpose_b=True, alpha=2.0, beta=0.5),
        [((3, 4), "n"), ((5, 4), "n"), ((3, 5), "n")], grad=(0, 1, 2)),
    Case("linalg_potrf", lambda nd, a: nd.linalg_potrf(a),
         [((3, 3), "spd")], tol=LOOSE),
    Case("linalg_trsm", lambda nd, a, b: nd.linalg_trsm(
        a, b, transpose=True, alpha=2.0), [((3, 3), "low"), ((3, 4), "n")],
        grad=(1,), tol=LOOSE),
    Case("linalg_trsm_right", lambda nd, a, b: nd.linalg_trsm(
        a, b, rightside=True), [((3, 3), "low"), ((4, 3), "n")], grad=(1,),
        tol=LOOSE),
    Case("linalg_trmm", lambda nd, a, b: nd.linalg_trmm(
        a, b, rightside=True, lower=False), [((3, 3), "n"), ((4, 3), "n")],
        grad=(0, 1)),
    Case("linalg_potri", lambda nd, a: nd.linalg_potri(a),
         [((3, 3), "low")], grad=(), tol=LOOSE),
    Case("linalg_sumlogdiag", lambda nd, a: nd.linalg_sumlogdiag(a),
         [((2, 3, 3), "spd")]),
    Case("linalg_extractdiag", lambda nd, a: nd.linalg_extractdiag(
        a, offset=-1), [((3, 3), "n")]),
    Case("linalg_makediag", lambda nd, a: nd.linalg_makediag(a, offset=1),
         [((2, 3), "n")]),
    Case("linalg_extracttrian", lambda nd, a: nd.linalg_extracttrian(
        a, offset=1), [((4, 4), "n")]),
    Case("linalg_maketrian", lambda nd, a: nd.linalg_maketrian(
        a, lower=False), [((6,), "n")]),
    Case("linalg_gelqf", lambda nd, a: [abs(t) for t in
                                        nd.linalg_gelqf(a)],
         [((3, 5), "n")], tol=LOOSE),
    Case("linalg_syevd", lambda nd, a: (lambda u, w: [nd.square(u), w])(
        *nd.linalg_syevd(a)), [((3, 3), "spd")], tol=LOOSE),
    Case("linalg_gesvd", lambda nd, a: (lambda u, s, v: [
        nd.square(u), s, nd.square(v)])(*nd.linalg_gesvd(a)),
        [((3, 5), "n")], tol=LOOSE),
    Case("linalg_inverse", lambda nd, a: nd.linalg_inverse(a),
         [((3, 3), "spd")], tol=LOOSE),
    Case("linalg_det", lambda nd, a: nd.linalg_det(a), [((3, 3), "spd")],
         tol=LOOSE),
    Case("linalg_slogdet", lambda nd, a: nd.linalg_slogdet(a),
         [((2, 3, 3), "spd")], tol=LOOSE),
    Case("linalg_syrk", lambda nd, a: nd.linalg_syrk(a, transpose=True,
                                                     alpha=0.5), X34),
    Case("smooth_l1", lambda nd, x: nd.smooth_l1(x * 2, scalar=1.5), NZ),
    # --- output ops ----------------------------------------------------------
    Case("softmax_output", lambda nd, x, y: nd.SoftmaxOutput(
        x, y, grad_scale=2.0, use_ignore=True, ignore_label=1,
        normalization="valid", smooth_alpha=0.1),
        [((4, 5), "n"), ((4,), "i5")]),
    Case("softmax_output_multi", lambda nd, x, y: nd.SoftmaxOutput(
        x, y, multi_output=True, normalization="batch"),
        [((2, 4, 3), "n"), ((2, 3), "i4")]),
    Case("linear_regression_output", lambda nd, x, y:
         nd.LinearRegressionOutput(x, y, grad_scale=2.0), TWO),
    Case("logistic_regression_output", lambda nd, x, y:
         nd.LogisticRegressionOutput(x, y), TWO),
    Case("mae_regression_output", lambda nd, x, y:
         nd.MAERegressionOutput(x, y), TWO),
    Case("make_loss", lambda nd, x: nd.MakeLoss(x * x, grad_scale=3.0,
                                               normalization="batch"), X34),
    Case("BlockGrad", lambda nd, x: nd.BlockGrad(x * x) + x, X34),
] + [
    Case(name, (lambda n: lambda nd, x: getattr(nd, n)(x, scalar=1.5))(
        name), NZ if "mod" not in name and "pow" not in name else P34,
        grad=() if name in ("_equal_scalar", "_not_equal_scalar",
                            "_greater_scalar", "_greater_equal_scalar",
                            "_lesser_scalar", "_lesser_equal_scalar",
                            "_logical_and_scalar", "_logical_or_scalar",
                            "_logical_xor_scalar") else (0,))
    for name in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
                 "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_mod_scalar",
                 "_rmod_scalar", "_power_scalar", "_rpower_scalar",
                 "_maximum_scalar", "_minimum_scalar", "_hypot_scalar",
                 "_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                 "_greater_equal_scalar", "_lesser_scalar",
                 "_lesser_equal_scalar", "_logical_and_scalar",
                 "_logical_or_scalar", "_logical_xor_scalar")
] + [
    # --- nn ops ----------------------------------------------------------------
    Case("activation_softrelu", lambda nd, x: nd.Activation(
        x, act_type="softrelu"), X34),
    Case("leaky_relu_elu", lambda nd, x: nd.LeakyReLU(x, act_type="elu",
                                                      slope=0.3), NZ),
    Case("leaky_relu_prelu", lambda nd, x, g: nd.LeakyReLU(
        x, g, act_type="prelu"), [((3, 4), "nz"), ((4,), "p")],
        grad=(0, 1)),
    Case("hard_sigmoid", lambda nd, x: nd.hard_sigmoid(x * 3), NZ),
    Case("convolution_grouped", lambda nd, x, w: nd.Convolution(
        x, w, kernel=(3, 3), stride=(2, 1), pad=(1, 1), num_filter=4,
        num_group=2, no_bias=True), [((2, 4, 6, 6), "n"), ((4, 2, 3, 3),
                                                           "n")],
        grad=(0, 1), tol=LOOSE),
    Case("convolution_1d", lambda nd, x, w, b: nd.Convolution(
        x, w, b, kernel=(3,), dilate=(2,), num_filter=4),
        [((2, 3, 9), "n"), ((4, 3, 3), "n"), ((4,), "n")], grad=(0, 1, 2),
        tol=LOOSE),
    Case("deconvolution", lambda nd, x, w: nd.Deconvolution(
        x, w, kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
        num_filter=2), [((2, 3, 4, 4), "n"), ((3, 2, 3, 3), "n")],
        grad=(0, 1), tol=LOOSE),
    Case("upsampling_nearest", lambda nd, x: nd.UpSampling(
        x, scale=2, sample_type="nearest"), IMG),
    Case("upsampling_bilinear", lambda nd, x: nd.UpSampling(
        x, scale=2, sample_type="bilinear"), IMG, tol=LOOSE),
    Case("pooling_max_full", lambda nd, x: nd.Pooling(
        x, kernel=(3, 3), stride=(2, 2), pool_type="max",
        pooling_convention="full"), IMG),
    Case("pooling_avg_pad", lambda nd, x: nd.Pooling(
        x, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False), IMG),
    Case("pooling_sum", lambda nd, x: nd.Pooling(
        x, kernel=(2, 2), stride=(2, 2), pool_type="sum"), IMG),
    Case("pooling_lp", lambda nd, x: nd.Pooling(
        x, kernel=(2, 2), stride=(1, 1), pool_type="lp"), IMG),
    Case("pooling_global_sum", lambda nd, x: nd.Pooling(
        x, pool_type="sum", global_pool=True), IMG),
    Case("pooling_max_3d", lambda nd, x: nd.Pooling(
        x, kernel=(2, 2, 2), stride=(1, 2, 2), pool_type="max"),
        [((1, 2, 3, 4, 4), "n")]),
    Case("batch_norm_train", lambda nd, x, g, b, m, v: nd.BatchNorm(
        x, g, b, m, v, eps=1e-3, momentum=0.8), [((4, 3, 2, 2), "n"),
                                                 ((3,), "p"), ((3,), "n"),
                                                 ((3,), "n"), ((3,), "p")],
        grad=(0, 1, 2), tol=LOOSE, seeded=(0,)),
    Case("batch_norm_global", lambda nd, x, g, b, m, v: nd.BatchNorm(
        x, g, b, m, v, use_global_stats=True, fix_gamma=True)[0],
        [((4, 3, 2, 2), "n"), ((3,), "p"), ((3,), "n"), ((3,), "n"),
         ((3,), "p")], grad=(0, 2), tol=LOOSE),
    Case("layer_norm", lambda nd, x, g, b: nd.LayerNorm(x, g, b, axis=1),
         [((3, 4, 2), "n"), ((4,), "p"), ((4,), "n")], grad=(0, 1, 2),
         tol=LOOSE),
    Case("group_norm", lambda nd, x, g, b: nd.GroupNorm(
        x, g, b, num_groups=2), [((2, 4, 3, 3), "n"), ((4,), "p"),
                                 ((4,), "n")], grad=(0, 1, 2), tol=LOOSE),
    Case("instance_norm", lambda nd, x, g, b: nd.InstanceNorm(x, g, b),
         [((2, 3, 4, 4), "n"), ((3,), "p"), ((3,), "n")], grad=(0, 1, 2),
         tol=LOOSE),
    Case("l2_normalization", lambda nd, x: nd.L2Normalization(
        x, mode="channel"), IMG),
    Case("dropout_rate0", lambda nd, x: nd.Dropout(x, p=0.0), X34),
    Case("dropout_predict", lambda nd, x: nd.Dropout(x, p=0.5), X34,
         train=False),
    Case("embedding", lambda nd, i, w: nd.Embedding(i, w, input_dim=5,
                                                    output_dim=4),
         [((2, 3), "i5"), ((5, 4), "n")], grad=(1,)),
    Case("embedding_matmul", lambda nd, i, w: nd.Embedding(
        i, w, input_dim=5, output_dim=4, matmul_lookup=True),
        [((2, 3), "i5"), ((5, 4), "n")], grad=(1,)),
    Case("flatten", lambda nd, x: nd.Flatten(x), [((2, 3, 4), "n")]),
    Case("softmax", lambda nd, x: nd.softmax(x, axis=0, temperature=2.0),
         X34),
    Case("log_softmax", lambda nd, x: nd.log_softmax(x), X34),
    Case("softmax_cross_entropy", lambda nd, x, y:
         nd.softmax_cross_entropy(x, y), [((4, 5), "n"), ((4,), "i5")]),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_op_against_reference(case):
    idx = CASES.index(case)
    arrays = _inputs(case.kinds, 1000 + idx)
    got, _ = _run(tmx, case, arrays, None)
    rng = np.random.RandomState(2000 + idx)
    heads = [rng.normal(size=g.shape).astype(np.float32) for g in got]
    got, got_grads = _run(tmx, case, arrays, heads)
    ref, ref_grads = _run(jmx, case, arrays, heads)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, equal_nan=True, **case.tol)
    for g, r in zip(got_grads, ref_grads):
        np.testing.assert_allclose(g, r, **case.tol)


def test_every_reference_op_name_resolves():
    """Every name the reference's op modules export resolves in the
    port's ``nd`` namespace (the ops left out of slice 9 raise)."""
    from mxnet_tpu.ops import elemwise, nn_ops, output_ops, tensor

    names = set()
    for mod in (elemwise, tensor, nn_ops, output_ops):
        names |= set(mod.__all__)
    missing = sorted(n for n in names if not hasattr(tmx.nd, n))
    assert not missing
    for alias, canonical in (("broadcast_mul", "multiply"),
                             ("SliceChannel", "split"), ("crop", "slice"),
                             ("Pad", "pad"), ("inverse", "linalg_inverse")):
        assert getattr(tmx.nd, alias) is getattr(tmx.nd, canonical)
    # ctc_loss is ported in slice 14 (tests/test_torch_ctc.py): an empty
    # label over two uniform steps costs -2·log(1/3), as in the reference
    np.testing.assert_allclose(
        tmx.nd.ctc_loss(tmx.nd.zeros((2, 1, 3), ctx=CPU),
                        tmx.nd.zeros((1, 1), ctx=CPU)).asnumpy(),
        jmx.nd.ctc_loss(jmx.nd.zeros((2, 1, 3)),
                        jmx.nd.zeros((1, 1))).asnumpy(), rtol=1e-6)
    with tmx.cpu():
        for name in ("_zeros", "_ones"):  # the registry's creation ops
            got = getattr(tmx.nd, name)(shape=(2, 3), dtype="float16")
            ref = getattr(jmx.nd, name)(shape=(2, 3), dtype="float16")
            assert got.dtype == torch.float16
            np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    # the profiler, left out of slice 9, is ported in slice 16
    # (tests/test_torch_profiler.py): it starts and stops
    tmx.profiler.set_state("run")
    assert tmx.profiler.is_running()
    tmx.profiler.set_state("stop")
    assert not tmx.profiler.is_running()


def test_pooling_full_convention_differs_from_ceil_mode():
    """MXNet's "full" rule pads the upper edge so the last window fits,
    with -inf (max) or 0 counted in the window (avg); torch's ceil_mode
    drops a window that starts in the padding and divides a clipped
    window by what it covers.  On 5 wide with kernel 2, stride 2 and pad 1
    the two give different widths; on 6 wide with kernel 3, stride 2 the
    avg values differ at the edge."""
    x = np.arange(2 * 6 * 6, dtype=np.float32).reshape(1, 2, 6, 6)
    x5 = x[:, :, :5, :5].copy()
    args = dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="max",
                pooling_convention="full")
    got = tmx.nd.Pooling(tmx.nd.array(x5, ctx=CPU), **args).asnumpy()
    ref = jmx.nd.Pooling(jmx.nd.array(x5), **args).asnumpy()
    np.testing.assert_array_equal(got, ref)
    torch_ceil = torch.nn.functional.max_pool2d(
        torch.from_numpy(x5), 2, 2, 1, ceil_mode=True)
    assert got.shape == (1, 2, 4, 4) and tuple(torch_ceil.shape) == \
        (1, 2, 3, 3)
    args = dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
                pooling_convention="full")
    got = tmx.nd.Pooling(tmx.nd.array(x, ctx=CPU), **args).asnumpy()
    ref = jmx.nd.Pooling(jmx.nd.array(x), **args).asnumpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    torch_avg = torch.nn.functional.avg_pool2d(
        torch.from_numpy(x), 3, 2, ceil_mode=True).numpy()
    assert got.shape == torch_avg.shape and not np.allclose(got, torch_avg)


def test_samplers_draw_from_the_device_generator():
    """The samplers (module 6): shapes, dtypes, ranges and moments, and
    the same draws after the same seed."""
    with tmx.cpu():
        tmx.random.seed(7)
        u = tmx.random.uniform(-1, 3, shape=(4000,))
        n = tmx.random.normal(2.0, 0.5, shape=(4000,))
        tmx.random.seed(7)
        assert np.array_equal(u.asnumpy(), tmx.random.uniform(
            -1, 3, shape=(4000,)).asnumpy())
        r = tmx.random.randint(2, 9, shape=(500,))
        e = tmx.random.exponential(2.0, shape=(4000,))
        g = tmx.random.gamma(3.0, 0.5, shape=(4000,))
        p = tmx.random.poisson(4.0, shape=(4000,))
        b = tmx.random.bernoulli(0.3, shape=(4000,))
        m = tmx.random.multinomial(tmx.nd.array([[0.1, 0.9], [1.0, 0.0]]),
                                   shape=200)
        s = tmx.random.shuffle(tmx.nd.arange(10))
    a = u.asnumpy()
    assert a.min() >= -1 and a.max() < 3 and abs(a.mean() - 1) < 0.1
    assert abs(n.asnumpy().mean() - 2) < 0.05
    assert abs(n.asnumpy().std() - 0.5) < 0.05
    ri = r.asnumpy()
    assert r.dtype == torch.int32 and ri.min() >= 2 and ri.max() < 9
    assert abs(e.asnumpy().mean() - 2) < 0.15
    assert abs(g.asnumpy().mean() - 1.5) < 0.1
    assert abs(p.asnumpy().mean() - 4) < 0.2
    assert abs(b.asnumpy().mean() - 0.3) < 0.05
    mm = m.asnumpy()
    assert mm.shape == (2, 200) and (mm[1] == 0).all() and mm[0].mean() > 0.8
    assert sorted(s.asnumpy().tolist()) == list(range(10))
