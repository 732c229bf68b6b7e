"""``mx.mod`` and ``mx.model`` of the port against the JAX package: a
small conv net's ``Module.fit`` (three steps, SGD with momentum and
Adam) from the same weights gives the reference's weights and moving
statistics; ``score``, ``predict``, ``save_checkpoint``/``load``,
``BucketingModule`` over two sequence lengths sharing its parameters, and
``FeedForward``.  f32 on the CPU; weights within 1e-5 relative after
three steps (the two packages' products round differently in f32)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
B, STEPS = 4, 3


def _net(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        # no bias: BatchNorm cancels it, so its gradient is f32 noise
        # (which Adam's normalized step would amplify)
        h = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                               pad=(1, 1), no_bias=True, name="conv")
        h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn")
        h = mx.sym.Activation(h, act_type="relu", name="relu")
        h = mx.sym.Flatten(h, name="flat")
        h = mx.sym.FullyConnected(h, num_hidden=3, name="fc")
        return mx.sym.SoftmaxOutput(h, name="softmax")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B * STEPS, 2, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, B * STEPS).astype(np.float32)
    return x, y


def _params(seed=1):
    sym = _net(jmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(B, 2, 6, 6))
    rng = np.random.RandomState(seed)
    arg = {n: (rng.randn(*s) * 0.3).astype(np.float32)
           for n, s in zip(sym.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    aux = {"bn_moving_mean": np.zeros(4, np.float32),
           "bn_moving_var": np.ones(4, np.float32)}
    return arg, aux


def _fit(mx, optimizer, opt_params, kw):
    x, y = _data()
    arg, aux = _params()
    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=B)
        mod = mx.mod.Module(_net(mx), context=mx.cpu())
        mod.fit(it, num_epoch=1, optimizer=optimizer,
                optimizer_params=opt_params,
                arg_params={k: mx.nd.array(v, **kw) for k, v in arg.items()},
                aux_params={k: mx.nd.array(v, **kw) for k, v in aux.items()})
    return mod, it


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})])
def test_three_fit_steps_give_the_reference_weights(optimizer, opt_params):
    (jmod, _), (tmod, _) = (_fit(jmx, optimizer, opt_params, {}),
                            _fit(tmx, optimizer, opt_params, {"ctx": CPU}))
    jarg, jaux = jmod.get_params()
    targ, taux = tmod.get_params()
    assert sorted(targ) == sorted(jarg) and sorted(taux) == sorted(jaux)
    for n in jarg:
        np.testing.assert_allclose(targ[n].asnumpy(), jarg[n].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        assert not np.allclose(targ[n].asnumpy(), _params()[0][n]), n
    # a training BatchNorm commits its moving statistics as the reference
    for n in jaux:
        np.testing.assert_allclose(taux[n].asnumpy(), jaux[n].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert not np.allclose(taux["bn_moving_var"].asnumpy(), 1.0)


def test_score_predict_and_checkpoint(tmp_path):
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    (jmod, jit), (tmod, tit) = (_fit(jmx, "sgd", opt, {}),
                                _fit(tmx, "sgd", opt, {"ctx": CPU}))
    assert tmod.score(tit, "acc")[0][1] == jmod.score(jit, "acc")[0][1]
    with tmx.cpu():
        tp = tmod.predict(tit).asnumpy()
    np.testing.assert_allclose(tp, jmod.predict(jit).asnumpy(), rtol=1e-5,
                               atol=1e-6)
    prefix = str(tmp_path / "conv")
    tmod.save_checkpoint(prefix, 3)
    # the reference reads the port's checkpoint, and the port its own
    jsym, jarg, jaux = jmx.model.load_checkpoint(prefix, 3)
    assert jsym.tojson() == _net(jmx).tojson()
    loaded = tmx.mod.Module.load(prefix, 3, context=CPU)
    with tmx.cpu():
        loaded.bind(tit.provide_data, tit.provide_label, for_training=False)
        loaded.init_params_from_cache()
        np.testing.assert_array_equal(loaded.predict(tit).asnumpy(), tp)
    targ, _ = tmod.get_params()
    for n in jarg:
        np.testing.assert_array_equal(jarg[n].asnumpy(), targ[n].asnumpy())


def _seq_gen(mx, hidden=6):
    """Per-bucket symbols of a sequence classifier whose parameters do not
    depend on the length: a shared per-step projection, a mean over the
    steps and a classifier."""
    def sym_gen(seq_len):
        with mx.name.NameManager():
            data = mx.sym.var("data")
            h = mx.sym.FullyConnected(data, num_hidden=hidden, flatten=False,
                                      name="step")
            h = mx.sym.Activation(h, act_type="tanh", name="act")
            h = mx.sym.mean(h, axis=1, name="pool")
            fc = mx.sym.FullyConnected(h, num_hidden=3, name="fc")
            sm = mx.sym.SoftmaxOutput(fc, name="softmax")
        return sm, ("data",), ("softmax_label",)

    return sym_gen


def _lstm_gen(mx, hidden):
    """Per-bucket symbols of a one-layer LSTM (``sym.RNN``) tagger."""
    def sym_gen(seq_len):
        with mx.name.NameManager():
            data = mx.sym.var("data")
            states = [mx.sym.var("lstm_h"), mx.sym.var("lstm_c")]
            params = [mx.sym.var(f"lstm_{n}", shape=s) for n, s in (
                ("i2h_weight", (4 * hidden, 3)),
                ("h2h_weight", (4 * hidden, hidden)),
                ("i2h_bias", (4 * hidden,)), ("h2h_bias", (4 * hidden,)))]
            out = mx.sym.RNN(data, states, params, state_size=hidden,
                             num_layers=1, mode="lstm", name="lstm")
            out = mx.sym.Reshape(out, shape=(-1, hidden))
            fc = mx.sym.FullyConnected(out, num_hidden=3, name="fc")
            lab = mx.sym.Reshape(mx.sym.var("softmax_label"), shape=(-1,))
            sm = mx.sym.SoftmaxOutput(fc, lab, name="softmax")
        return sm, ("data", "lstm_h", "lstm_c"), ("softmax_label",)

    return sym_gen


def _bucket_run(mx, sym_gen, batches, data_shapes, arg_params, kw):
    with mx.cpu():
        bm = mx.mod.BucketingModule(sym_gen, default_bucket_key=5,
                                    context=mx.cpu())
        bm.bind(data_shapes(5), [("softmax_label", batches[0][2].shape)])
        bm.init_params(arg_params={k: mx.nd.array(v, **kw)
                                   for k, v in arg_params.items()},
                       allow_missing=True)
        bm.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.5})
        for t, xs, y in batches:
            batch = mx.io.DataBatch(
                [mx.nd.array(x, **kw) for x in xs], [mx.nd.array(y, **kw)],
                bucket_key=t, provide_data=data_shapes(t),
                provide_label=[("softmax_label", y.shape)])
            bm.forward(batch, is_train=True)
            bm.backward()
            bm.update()
        # the buckets read one set of parameter arrays
        a, b = bm._buckets[3], bm._buckets[5]
        assert a._exec.arg_dict["fc_weight"] is b._exec.arg_dict["fc_weight"]
        return {k: v.asnumpy() for k, v in bm.get_params()[0].items()}


def test_bucketing_module_shares_parameters_across_lengths():
    nb, hidden = 4, 6
    rng = np.random.RandomState(4)
    arg = {"step_weight": rng.randn(hidden, 3).astype(np.float32) * 0.3,
           "step_bias": np.zeros(hidden, np.float32),
           "fc_weight": rng.randn(3, hidden).astype(np.float32) * 0.3,
           "fc_bias": np.zeros(3, np.float32)}
    batches = [(t, [rng.randn(nb, t, 3).astype(np.float32)],
                rng.randint(0, 3, nb).astype(np.float32)) for t in (5, 3, 5)]

    def shapes(t):
        return [("data", (nb, t, 3))]

    ref = _bucket_run(jmx, _seq_gen(jmx, hidden), batches, shapes, arg, {})
    got = _bucket_run(tmx, _seq_gen(tmx, hidden), batches, shapes, arg,
                      {"ctx": CPU})
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        assert not np.allclose(got[n], arg[n]), n


def test_bucketing_lstm_symbol_trains_like_nd_rnn():
    """The port's symbol LSTM (``sym.RNN``; the reference's symbol
    ``RNN`` node cannot run, see ``ops/rnn_ops.rnn``) in a
    BucketingModule: its first step's loss gradient equals ``nd.RNN``'s
    under autograd on the same weights, and the buckets share them."""
    nb, hidden = 2, 6
    rng = np.random.RandomState(5)
    arg = {"lstm_i2h_weight": rng.randn(4 * hidden, 3),
           "lstm_h2h_weight": rng.randn(4 * hidden, hidden),
           "lstm_i2h_bias": rng.randn(4 * hidden),
           "lstm_h2h_bias": rng.randn(4 * hidden),
           "fc_weight": rng.randn(3, hidden), "fc_bias": np.zeros(3)}
    arg = {k: (v * 0.3).astype(np.float32) for k, v in arg.items()}
    zeros = np.zeros((1, nb, hidden), np.float32)
    batches = [(t, [rng.randn(t, nb, 3).astype(np.float32), zeros, zeros],
                rng.randint(0, 3, (t, nb)).astype(np.float32))
               for t in (5, 3)]

    def shapes(t):
        return [("data", (t, nb, 3)), ("lstm_h", (1, nb, hidden)),
                ("lstm_c", (1, nb, hidden))]

    got = _bucket_run(tmx, _lstm_gen(tmx, hidden), batches, shapes, arg,
                      {"ctx": CPU})
    # the same steps by hand: nd.RNN, FullyConnected and softmax's
    # gradient; each bucket's Module sets rescale_grad to 1 / its first
    # data axis (T)
    nd = tmx.nd
    want = dict(arg)
    for t, xs, y in batches:
        w = {k: nd.array(v, ctx=CPU) for k, v in want.items()}
        for v in w.values():
            v.attach_grad()
        with tmx.autograd.record():
            out = nd.RNN(nd.array(xs[0], ctx=CPU),
                         [nd.array(zeros, ctx=CPU)] * 2,
                         [w[f"lstm_{n}"] for n in ("i2h_weight",
                                                   "h2h_weight", "i2h_bias",
                                                   "h2h_bias")],
                         state_size=hidden, mode="lstm")[0]
            logits = nd.FullyConnected(out.reshape((-1, hidden)),
                                       w["fc_weight"], w["fc_bias"],
                                       num_hidden=3)
            picked = nd.pick(nd.log_softmax(logits),
                             nd.array(y.reshape(-1), ctx=CPU))
            total = -nd.sum(picked)
        total.backward()
        want = {k: want[k] - 0.5 / t * w[k].grad.asnumpy() for k in want}
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        assert not np.allclose(got[n], arg[n]), n


def test_feedforward_fit_predict_save_load(tmp_path):
    x, y = _data(7)
    arg, aux = _params(8)
    outs = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        with mx.cpu():
            ff = mx.model.FeedForward(
                _net(mx), ctx=mx.cpu(), num_epoch=1,
                optimizer="sgd", learning_rate=0.05,
                arg_params={k: mx.nd.array(v, **kw) for k, v in arg.items()},
                aux_params={k: mx.nd.array(v, **kw) for k, v in aux.items()})
            ff.fit(mx.io.NDArrayIter(x, y, batch_size=B))
            outs.append(ff.predict(mx.io.NDArrayIter(x, batch_size=B)))
            if mx is tmx:
                ff.save(str(tmp_path / "ff"))
                back = mx.model.FeedForward.load(str(tmp_path / "ff"), 1,
                                                 ctx=mx.cpu())
                np.testing.assert_array_equal(
                    back.predict(mx.io.NDArrayIter(x, batch_size=B)),
                    outs[-1])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
