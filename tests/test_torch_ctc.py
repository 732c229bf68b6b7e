"""The CTC loss of the PyTorch/CUDA port against the JAX package:
``nd.ctc_loss`` with the blank first and last, data and label lengths,
padded labels, an infeasible label, gradients, the host label checks,
and ``gluon.loss.CTCLoss`` in both layouts.

The same seeded numpy activations and labels go through both packages.
Losses and the activations' gradients are compared at f32
``rtol=1e-5, atol=1e-5`` (the same log-space lattice, summed in other
orders); an infeasible label's loss is the reference's finite ~1e30,
held at ``rtol=1e-6``.  ``torch.nn.functional.ctc_loss`` is a second
oracle on feasible inputs.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)
T, N, C, L = 12, 4, 6, 4


def _nd(pkg, a, dtype=None):
    kw = dict(ctx=CPU) if pkg is tmx else {}
    return pkg.nd.array(a, dtype=dtype, **kw) if dtype else \
        pkg.nd.array(a, **kw)


def _labels(rs, blank_first, lengths):
    lo, hi = (1, C) if blank_first else (0, C - 1)
    pad = 0 if blank_first else -1
    lab = np.full((N, L), pad, np.float32)
    for i, n in enumerate(lengths):
        lab[i, :n] = rs.randint(lo, hi, n)
    return lab


def _run(pkg, x, lab, data_len=None, lab_len=None, **kw):
    xin = _nd(pkg, x)
    xin.attach_grad()
    extra = {}
    if data_len is not None:
        extra["data_lengths"] = _nd(pkg, data_len)
    if lab_len is not None:
        extra["label_lengths"] = _nd(pkg, lab_len)
    with pkg.autograd.record():
        loss = pkg.nd.ctc_loss(xin, _nd(pkg, lab), **extra, **kw)
    loss.backward()
    return loss.asnumpy(), xin.grad.asnumpy()


CASES = [  # (name, blank, label lengths, data lengths, pass label_lengths)
    ("first_padded", "first", [4, 2, 0, 3], None, False),
    ("last_padded", "last", [1, 4, 3, 2], None, False),
    ("first_lengths", "first", [3, 4, 1, 2], [12, 9, 5, 7], True),
    ("last_repeats", "last", [4, 4, 4, 4], [12, 12, 10, 11], True),
]


@pytest.mark.parametrize("name,blank,lens,dlens,use_ll", CASES,
                         ids=[c[0] for c in CASES])
def test_ctc_loss_and_gradient_match_reference(name, blank, lens, dlens,
                                               use_ll):
    rs = np.random.RandomState(len(name))
    x = rs.normal(0, 2, (T, N, C)).astype(np.float32)
    lab = _labels(rs, blank == "first", lens)
    if name == "last_repeats":
        lab[0, :] = [1, 1, 2, 2]  # repeats need a blank between
    data_len = None if dlens is None else np.array(dlens, np.float32)
    lab_len = np.array(lens, np.float32) if use_ll else None
    ref = _run(jmx, x, lab, data_len, lab_len, blank_label=blank)
    got = _run(tmx, x, lab, data_len, lab_len, blank_label=blank)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)
    # torch's own CTC on the same feasible inputs
    b = 0 if blank == "first" else C - 1
    targets = torch.tensor(np.where(lab < 0, 0, lab), dtype=torch.long)
    oracle = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.tensor(x), -1), targets,
        torch.tensor(dlens or [T] * N), torch.tensor(lens), blank=b,
        reduction="none")
    np.testing.assert_allclose(got[0], oracle.numpy(), **TOL)


def test_infeasible_label_gives_the_reference_finite_loss():
    """Four labels with a repeat need 5 steps; 3 steps cannot emit them:
    the lattice's −1e30 stand-in gives a loss near 1e30 (not ``inf``,
    which ``F.ctc_loss`` gives) and finite gradients.  The infeasible
    row's gradient is held finite only: every cell of its lattice rounds
    to −1e30, so its gradient is how each framework's ``logaddexp``
    splits a tie; the feasible row's is held to the reference's."""
    rs = np.random.RandomState(1)
    x = rs.normal(0, 1, (3, 2, C)).astype(np.float32)
    lab = np.array([[1, 1, 2, 3], [2, 0, 0, 0]], np.float32)
    ref = _run(jmx, x, lab)
    got = _run(tmx, x, lab)
    assert 1e29 < got[0][0] < 1e31 and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(got[1][:, 1], ref[1][:, 1], **TOL)


def test_host_checks_refuse_what_the_reference_refuses():
    x = np.zeros((T, N, C), np.float32)
    bad = np.full((N, L), C, np.float32)  # C is out of range for 'first'
    for pkg in (jmx, tmx):
        with pytest.raises(pkg.MXNetError, match="label values"):
            pkg.nd.ctc_loss(_nd(pkg, x), _nd(pkg, bad))
        with pytest.raises(pkg.MXNetError, match="data_lengths exceed"):
            pkg.nd.ctc_loss(_nd(pkg, x), _nd(pkg, np.ones((N, L))),
                            data_lengths=_nd(pkg, np.full((N,), T + 1)))
    with pytest.raises(tmx.MXNetError, match="bad blank_label"):
        tmx.nd.ctc_loss(_nd(tmx, x), _nd(tmx, bad), blank_label="mid")


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_gluon_ctc_loss_matches_reference(layout):
    rs = np.random.RandomState(5)
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    x = rs.normal(0, 1, shape).astype(np.float32)
    lab = _labels(rs, False, [2, 3, 4, 1])
    pred_len = np.array([12, 10, 11, 8], np.float32)
    outs = []
    for pkg in (jmx, tmx):
        loss_fn = pkg.gluon.loss.CTCLoss(layout=layout, weight=0.5)
        xin = _nd(pkg, x)
        xin.attach_grad()
        with pkg.autograd.record():
            loss = loss_fn(xin, _nd(pkg, lab), _nd(pkg, pred_len))
        loss.backward()
        outs.append((loss.asnumpy(), xin.grad.asnumpy()))
    for g, r in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, r, **TOL)
