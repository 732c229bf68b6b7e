"""Training checkpoints of the PyTorch/CUDA port (``checkpoint.py``): save,
resume, prune, the asynchronous writer, the torn-checkpoint fallback and
sweep, and the preemption drain's exit code; and ``elastic``'s index math
against the JAX package's over a grid.  Everything runs on the CPU.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from mxnet_tpu import elastic as jelastic

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch import elastic as telastic

CPU = tmx.cpu()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(seed=0):
    tmx.random.seed(seed)
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(8, in_units=4, activation="relu"),
            tmx.gluon.nn.BatchNorm(in_channels=8),
            tmx.gluon.nn.Dense(3, in_units=8))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01})
    return net, tr


def _batch(step):
    rng = np.random.RandomState(100 + step)
    return (tmx.nd.array(rng.normal(size=(6, 4)).astype(np.float32),
                         ctx=CPU),
            tmx.nd.array(rng.randint(0, 3, 6).astype(np.float32), ctx=CPU))


def _step(net, tr, step):
    x, y = _batch(step)
    with tmx.autograd.record():
        loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    tr.step(6)
    return float(loss.mean().asscalar())


def _params(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """Steps 1-4 straight through equal steps 1-2, a checkpoint, a fresh
    net and trainer resumed from it, then steps 3-4: losses and weights
    (moving statistics and Adam's moments carried) bit for bit."""
    net, tr = _setup()
    straight = [_step(net, tr, s) for s in range(4)]
    net_a, tr_a = _setup()
    first = [_step(net_a, tr_a, s) for s in range(2)]
    path = ckpt.save_checkpoint(str(tmp_path), 2, net_a, tr_a,
                                extra={"epoch": 1})
    assert os.path.basename(path) == "ckpt-2"
    assert sorted(os.listdir(path)) == ["manifest.json", "model.params",
                                        "rng.npz", "trainer.states"]
    net_b, tr_b = _setup(seed=7)  # other weights: all come from the file
    assert ckpt.resume(str(tmp_path), net_b, tr_b) == (2, {"epoch": 1})
    rest = [_step(net_b, tr_b, s) for s in range(2, 4)]
    assert first + rest == straight
    for a, b in zip(_params(net), _params(net_b)):
        np.testing.assert_array_equal(a, b)


def test_random_state_round_trips(tmp_path):
    net, tr = _setup()
    tmx.random.generator(CPU.device).manual_seed(1234)
    tmx.random.generator(CPU.device).seed()  # some state
    want = tmx.random.get_state()
    ckpt.save_checkpoint(str(tmp_path), 1, net, tr)
    tmx.random.seed(99)
    ckpt.resume(str(tmp_path), net, tr)
    got = tmx.random.get_state()
    assert got["seed"] == want["seed"]
    for dev, state in want["generators"].items():
        np.testing.assert_array_equal(got["generators"][dev], state)


def test_seed_and_resume_keep_each_generator_object(tmp_path):
    """``seed`` and ``set_state`` (a resume) re-seed and restore a
    device's generator in place: a captured CUDA graph replays with the
    generator object it registered, so a new object would never reach
    it.  The draws after each equal a fresh start's."""
    import torch

    gen = tmx.random.generator(CPU.device)
    tmx.random.seed(5)
    first = torch.rand(4, generator=gen)
    tmx.random.seed(5)
    assert tmx.random.generator(CPU.device) is gen
    assert torch.equal(torch.rand(4, generator=gen), first)
    state = tmx.random.get_state()
    nxt = torch.rand(4, generator=gen)
    tmx.random.seed(6)
    tmx.random.set_state(state)
    assert tmx.random.generator(CPU.device) is gen
    assert torch.equal(torch.rand(4, generator=gen), nxt)


def test_latest_prune_and_no_checkpoint(tmp_path):
    net, tr = _setup()
    assert ckpt.resume(str(tmp_path / "none"), net, tr) == (0, {})
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), step, net, tr, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-2", "ckpt-3", "ckpt-4"]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt-4")
    ckpt.prune_checkpoints(str(tmp_path), keep=1)
    assert os.listdir(tmp_path) == ["ckpt-4"]


def test_torn_checkpoint_falls_back_and_stale_staging_is_swept(tmp_path):
    net, tr = _setup()
    ckpt.save_checkpoint(str(tmp_path), 1, net, tr)
    want = _params(net)
    _step(net, tr, 0)
    ckpt.save_checkpoint(str(tmp_path), 2, net, tr)
    os.remove(tmp_path / "ckpt-2" / "model.params")  # torn after rename
    dead = tmp_path / ".tmp-3-1-999999999"  # a crashed save's staging dir
    dead.mkdir()
    live = tmp_path / f".tmp-3-2-{os.getpid()}"  # a live process's
    live.mkdir()
    fresh, tr2 = _setup(seed=3)
    with pytest.warns(UserWarning, match="torn"):
        assert ckpt.resume(str(tmp_path), fresh, tr2)[0] == 1
    for a, b in zip(want, _params(fresh)):
        np.testing.assert_array_equal(a, b)
    assert not dead.exists() and live.exists()
    os.remove(tmp_path / "ckpt-1" / "trainer.states")
    with pytest.warns(UserWarning, match="torn"), \
            pytest.raises(tmx.MXNetError, match="every checkpoint"):
        ckpt.resume(str(tmp_path), fresh, tr2)


def test_resume_with_a_trainer_needs_its_state(tmp_path):
    net, tr = _setup()
    ckpt.save_checkpoint(str(tmp_path), 5, net)
    with pytest.raises(tmx.MXNetError, match="no trainer state"):
        ckpt.resume(str(tmp_path), net, tr)
    assert ckpt.resume(str(tmp_path), net)[0] == 5
    # sharded checkpoints are ported in slice 12
    # (test_torch_checkpoint_sharded): the same contract holds for them
    ckpt.save_checkpoint(str(tmp_path), 6, net, sharded=True)
    with pytest.raises(tmx.MXNetError, match="no trainer state"):
        ckpt.resume(str(tmp_path), net, tr)
    assert ckpt.resume(str(tmp_path), net)[0] == 6


def test_async_checkpoints_commit_in_order(tmp_path):
    net, tr = _setup()
    writer = ckpt.AsyncCheckpointer(max_pending=1)
    tickets = []
    for step in range(3):
        _step(net, tr, step)
        tickets.append(writer.save(str(tmp_path), step + 1, net, tr))
    want = _params(net)
    writer.wait(timeout=60)
    assert [t.result(timeout=1) for t in tickets] == \
        [str(tmp_path / f"ckpt-{s}") for s in (1, 2, 3)]
    assert writer.pending() == 0
    writer.close()
    fresh, tr2 = _setup(seed=4)
    assert ckpt.resume(str(tmp_path), fresh, tr2)[0] == 3
    for a, b in zip(want, _params(fresh)):
        np.testing.assert_array_equal(a, b)
    ticket = ckpt.save_checkpoint_async(str(tmp_path), 9, net, tr)
    ckpt.wait_async(timeout=60)
    assert ticket.done() and ckpt.latest_checkpoint(
        str(tmp_path)).endswith("ckpt-9")


def test_drain_handler_exits_75_with_a_checkpoint(tmp_path):
    """SIGTERM under ``install_preemption_handler`` sets the drain flag;
    ``drain_checkpoint_and_exit`` writes the checkpoint and exits with
    ``PREEMPTED_EXIT_CODE`` (75), in a subprocess."""
    script = textwrap.dedent(f"""
        import os, signal
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import checkpoint
        from mxnet_tpu_torch.gluon import trainer as trainer_mod
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=mx.cpu())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd")
        trainer_mod.install_preemption_handler()
        assert not trainer_mod.drain_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert trainer_mod.drain_requested()
        checkpoint.drain_checkpoint_and_exit({str(tmp_path)!r}, 7, net, tr)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 75, proc.stderr
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt-7")
    from mxnet_tpu_torch.gluon import trainer as trainer_mod

    trainer_mod.request_drain()
    assert trainer_mod.drain_requested()
    trainer_mod.reset_drain()
    assert not trainer_mod.drain_requested()


@pytest.mark.parametrize("size,batch", [(10, 4), (37, 12), (100, 8)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_elastic_index_math_matches_jax(size, batch, shuffle):
    for step in (0, 1, 5):
        for seed in (0, 3):
            want = jelastic.global_batch_indices(size, batch, step, seed,
                                                 shuffle)
            np.testing.assert_array_equal(
                telastic.global_batch_indices(size, batch, step, seed,
                                              shuffle), want)
            for world in (1, 2, 4):
                if batch % world:
                    with pytest.raises(tmx.MXNetError):
                        telastic.shard_indices(want, world, 0)
                    continue
                for rank in range(world):
                    np.testing.assert_array_equal(
                        telastic.shard_for_step(size, batch, step, world,
                                                rank, seed, shuffle),
                        jelastic.shard_for_step(size, batch, step, world,
                                                rank, seed, shuffle))
                    np.testing.assert_array_equal(
                        telastic.shard_rows(batch, world, rank),
                        jelastic.shard_rows(batch, world, rank))
    assert telastic.world_info() == (0, 1)
