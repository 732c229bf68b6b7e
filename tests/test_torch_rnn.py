"""Recurrent nets of the PyTorch/CUDA port against the JAX package: the
fused ``nd.RNN`` op in every mode, ``gluon.rnn``'s layers and cells, and
``mx.rnn.BucketSentenceIter``.

The same seeded numpy inputs, states and weights go through both
packages.  Outputs, final states and the gradients of the data, the
states and every weight (one backward seeded with the same random heads)
are compared at f32 ``rtol=1e-4, atol=1e-5``: the reference's scan and
the port's loop run the same products and gates, in other summation
orders.  The port's cells unrolled equal its fused layer on the same
weights within the same tolerance.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
TOL = dict(rtol=1e-4, atol=1e-5)
GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
T, N, C, H, L = 5, 3, 4, 6, 2


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=CPU) if pkg is tmx else pkg.nd.array(a)


def _rnn_arrays(mode, d, seed):
    rs = np.random.RandomState(seed)
    g = GATES[mode]
    x = rs.normal(0, 1, (T, N, C)).astype(np.float32)
    states = [rs.normal(0, 0.5, (L * d, N, H)).astype(np.float32)
              for _ in range(2 if mode == "lstm" else 1)]
    params = []
    for layer in range(L):
        ni = C if layer == 0 else H * d
        for _ in range(d):
            params += [rs.normal(0, 0.4, s).astype(np.float32) for s in
                       ((g * H, ni), (g * H, H), (g * H,), (g * H,))]
    return x, states, params


def _run_rnn(pkg, mode, d, arrays, head_seed):
    x, states, params = arrays
    ins = [_nd(pkg, a) for a in [x] + states + params]
    for a in ins:
        a.attach_grad()
    with pkg.autograd.record():
        outs = pkg.nd.RNN(ins[0], ins[1:1 + len(states)],
                          ins[1 + len(states):], mode=mode, state_size=H,
                          num_layers=L, bidirectional=d == 2)
        rs = np.random.RandomState(head_seed)
        total = None
        for o in outs:
            w = _nd(pkg, rs.normal(size=o.shape).astype(np.float32))
            term = (o * w).sum()
            total = term if total is None else total + term
    total.backward()
    return [o.asnumpy() for o in outs] + [a.grad.asnumpy() for a in ins]


@pytest.mark.parametrize("mode", sorted(GATES))
@pytest.mark.parametrize("d", [1, 2], ids=["uni", "bi"])
def test_fused_rnn_forward_and_gradients_match_reference(mode, d):
    arrays = _rnn_arrays(mode, d, seed=len(mode) + d)
    ref = _run_rnn(jmx, mode, d, arrays, 7)
    got = _run_rnn(tmx, mode, d, arrays, 7)
    assert len(got) == len(ref)
    assert got[0].shape == (T, N, H * d)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)


def test_fused_rnn_dropout_between_layers_draws_from_the_generator():
    x, states, params = _rnn_arrays("lstm", 1, 3)
    ins = [_nd(tmx, a) for a in [x] + states + params]

    def run():
        with tmx.autograd.record():
            return tmx.nd.RNN(ins[0], ins[1:3], ins[3:], mode="lstm",
                              state_size=H, num_layers=L, p=0.5)[0]

    tmx.random.seed(11)
    a = run().asnumpy()
    b = run().asnumpy()
    tmx.random.seed(11)
    np.testing.assert_array_equal(run().asnumpy(), a)
    assert not np.array_equal(a, b)
    plain = tmx.nd.RNN(ins[0], ins[1:3], ins[3:], mode="lstm", state_size=H,
                       num_layers=L, p=0.5)[0].asnumpy()  # not training
    assert not np.array_equal(plain, a)


# -- gluon.rnn layers -----------------------------------------------------

def _layer(pkg, kind, layout, d):
    cls = getattr(pkg.gluon.rnn, kind)
    kw = {"activation": "tanh"} if kind == "RNN" else {}
    return cls(H, num_layers=L, layout=layout, bidirectional=d == 2, **kw)


def _weights(net, seed):
    rs = np.random.RandomState(seed)
    return {k: rs.normal(0, 0.4, p.shape).astype(np.float32)
            for k, p in net._collect_params_with_prefix().items()}


def _layer_pair(kind, layout, d, x_shape):
    tnet = _layer(tmx, kind, layout, d)
    tnet.initialize(ctx=CPU)
    tnet(tmx.nd.zeros(x_shape, ctx=CPU))  # the deferred i2h weight
    arrays = _weights(tnet, len(kind) + d)
    jnet = _layer(jmx, kind, layout, d)
    jnet.initialize()
    jnet(jmx.nd.zeros(x_shape))
    for net, pkg in ((tnet, tmx), (jnet, jmx)):
        params = net._collect_params_with_prefix()
        assert sorted(params) == sorted(arrays)
        for k, p in params.items():
            p.set_data(_nd(pkg, arrays[k]))
    return jnet, tnet


@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
def test_layers_with_states_match_reference(kind, layout):
    d = 2 if layout == "NTC" else 1
    x_shape = (T, N, C) if layout == "TNC" else (N, T, C)
    jnet, tnet = _layer_pair(kind, layout, d, x_shape)
    rs = np.random.RandomState(3)
    x = rs.normal(0, 1, x_shape).astype(np.float32)
    n_states = 2 if kind == "LSTM" else 1
    states = [rs.normal(0, 0.5, (L * d, N, H)).astype(np.float32)
              for _ in range(n_states)]
    outs = []
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        xin = _nd(pkg, x)
        xin.attach_grad()
        with pkg.autograd.record():
            out, new = net(xin, [_nd(pkg, s) for s in states])
            loss = out.sum() + sum((s * s).sum() for s in new)
        loss.backward()
        plain = net(_nd(pkg, x))  # no states: the output alone
        outs.append([out.asnumpy(), plain.asnumpy(), xin.grad.asnumpy()] +
                    [s.asnumpy() for s in new] +
                    [p.grad().asnumpy() for _, p in sorted(
                        net._collect_params_with_prefix().items())])
    assert outs[1][0].shape == (x_shape[0], x_shape[1], H * d)
    for g, r in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, r, **TOL)
    assert [s.shape for s in tnet.begin_state(N, ctx=CPU)] == \
        [(L * d, N, H)] * n_states


def test_layer_hybridized_and_param_names_round_trip(tmp_path):
    """The parameters' structural names are the reference's, and a
    ``.params`` file written by either package loads into the other and
    writes back the same bytes."""
    jnet, tnet = _layer_pair("LSTM", "TNC", 2, (T, N, C))
    assert sorted(tnet._collect_params_with_prefix()) == sorted(
        f"{j}{i}_{k}_{w}" for j in "lr" for i in range(L)
        for k in ("i2h", "h2h") for w in ("weight", "bias"))
    tnet.save_parameters(str(tmp_path / "t.params"))
    jnet.load_parameters(str(tmp_path / "t.params"))
    jnet.save_parameters(str(tmp_path / "j.params"))
    assert (tmp_path / "j.params").read_bytes() == \
        (tmp_path / "t.params").read_bytes()
    fresh = _layer(tmx, "LSTM", "TNC", 2)
    fresh.load_parameters(str(tmp_path / "j.params"), ctx=CPU)
    x = np.random.RandomState(4).normal(0, 1, (T, N, C)).astype(np.float32)
    fresh.hybridize()
    np.testing.assert_allclose(fresh(_nd(tmx, x)).asnumpy(),
                               jnet(_nd(jmx, x)).asnumpy(), **TOL)


# -- cells ----------------------------------------------------------------

def _cell(pkg, kind):
    r = pkg.gluon.rnn
    if kind == "lstm":
        return r.LSTMCell(H, input_size=C)
    if kind == "gru":
        return r.GRUCell(H, input_size=C)
    if kind == "rnn":
        return r.RNNCell(H, input_size=C)
    if kind == "sequential":
        seq = r.SequentialRNNCell()
        seq.add(r.LSTMCell(H, input_size=C))
        seq.add(r.DropoutCell(0.0))
        seq.add(r.ResidualCell(r.GRUCell(H, input_size=H)))
        return seq
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(H, input_size=C), 0.3, 0.3)
    return r.BidirectionalCell(r.LSTMCell(H, input_size=C),
                               r.GRUCell(H, input_size=C))


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn", "sequential",
                                  "zoneout", "bidirectional"])
def test_cells_unroll_match_reference(kind):
    """Zoneout is held in inference (its masks are random in training)."""
    rs = np.random.RandomState(len(kind))
    x = rs.normal(0, 1, (N, T, C)).astype(np.float32)
    arrays = None
    outs = []
    for pkg in (jmx, tmx):
        cell = _cell(pkg, kind)
        cell.initialize(ctx=CPU) if pkg is tmx else cell.initialize()
        params = cell._collect_params_with_prefix()
        if arrays is None:
            arrays = {k: rs.normal(0, 0.4, p.shape).astype(np.float32)
                      for k, p in params.items()}
        for k, p in params.items():
            p.set_data(_nd(pkg, arrays[k]))
        out, states = cell.unroll(T, _nd(pkg, x), layout="NTC",
                                  merge_outputs=True)
        outs.append([out.asnumpy()] + [s.asnumpy() for s in states])
    assert outs[1][0].shape[:2] == (N, T)
    for g, r in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_cell_unroll_equals_the_fused_layer(kind):
    layer = getattr(tmx.gluon.rnn, kind)(H, input_size=C)
    cell = getattr(tmx.gluon.rnn, f"{kind}Cell")(H, input_size=C)
    layer.initialize(ctx=CPU)
    cell.initialize(ctx=CPU)
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, name).set_data(getattr(layer, f"l0_{name}").data())
    x = np.random.RandomState(9).normal(0, 1, (T, N, C)).astype(np.float32)
    fused, fstates = layer(_nd(tmx, x), layer.begin_state(N, ctx=CPU))
    out, states = cell.unroll(T, _nd(tmx, x), layout="TNC",
                              merge_outputs=True)
    np.testing.assert_allclose(out.asnumpy(), fused.asnumpy(), **TOL)
    for s, f in zip(states, fstates):
        np.testing.assert_allclose(s.asnumpy(), f.asnumpy()[0], **TOL)


def test_bidirectional_cell_cannot_be_stepped():
    cell = _cell(tmx, "bidirectional")
    with pytest.raises(tmx.MXNetError, match="unroll"):
        cell(tmx.nd.zeros((N, C), ctx=CPU), [])


# -- mx.rnn ---------------------------------------------------------------

def test_bucket_sentence_iter_batches_match_reference():
    rs = np.random.RandomState(0)
    sentences = [list(rs.randint(1, 50, rs.randint(2, 30)))
                 for _ in range(60)] + [[1] * 600]  # one too long
    got, ref = [], []
    with tmx.cpu():
        it_t = tmx.rnn.BucketSentenceIter(sentences, 4, seed=3)
    it_j = jmx.rnn.BucketSentenceIter(sentences, 4, seed=3)
    assert it_t.buckets == it_j.buckets and \
        it_t.default_bucket_key == it_j.default_bucket_key
    assert it_t.provide_data == it_j.provide_data
    for _ in range(2):  # two epochs: the reshuffle too
        for it, out in ((it_t, got), (it_j, ref)):
            for b in it:
                out.append((b.bucket_key, b.data[0].asnumpy(),
                            b.label[0].asnumpy()))
            it.reset()
    assert len(got) == len(ref) > 0
    for (kt, dt, lt), (kj, dj, lj) in zip(got, ref):
        assert kt == kj
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(lt, lj)
