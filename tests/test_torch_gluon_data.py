"""``gluon.data`` of the PyTorch/CUDA port against the JAX package:
datasets, samplers, the vision transforms and the DataLoader with thread
and process workers.  Random transforms draw from numpy's global
generator in both packages, so one seed gives the same pixels."""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jT

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as tT

CPU = tmx.cpu()


def _img(h=20, w=24, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


def _run(block, arr, seed, port):
    np.random.seed(seed)
    if port:
        with CPU:
            out = block(tmx.nd.array(arr, ctx=CPU, dtype=arr.dtype))
    else:
        out = block(jmx.nd.array(arr, dtype=arr.dtype))
    return out.asnumpy()


@pytest.mark.parametrize("name,args", [
    ("ToTensor", ()), ("Cast", ("float32",)),
    ("Resize", (16,)), ("Resize", ((10, 14),)), ("CenterCrop", (12,)),
    ("CropResize", (2, 3, 10, 8, 6)), ("RandomResizedCrop", (16,)),
    ("RandomFlipLeftRight", (0.5,)), ("RandomFlipTopBottom", (0.5,)),
])
def test_geometric_transforms_match(name, args):
    img = _img()
    for seed in range(3):
        got = _run(getattr(tT, name)(*args), img, seed, True)
        ref = _run(getattr(jT, name)(*args), img, seed, False)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("Normalize", ((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))),
    ("RandomBrightness", (0.4,)), ("RandomContrast", (0.4,)),
    ("RandomSaturation", (0.4,)), ("RandomLighting", (0.1,)),
])
def test_photometric_transforms_match(name, args):
    chw = np.random.RandomState(3).rand(3, 8, 9).astype(np.float32)
    for seed in range(3):
        got = _run(getattr(tT, name)(*args), chw, seed, True)
        ref = _run(getattr(jT, name)(*args), chw, seed, False)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_compose_pipeline_matches():
    img = _img(30, 36)
    mk = lambda T: T.Compose([T.Resize(20, keep_ratio=True),  # noqa: E731
                              T.CenterCrop(16), T.ToTensor(),
                              T.Normalize((0.5, 0.5, 0.5), (0.2, 0.2, 0.2))])
    got = _run(mk(tT), img, 0, True)
    assert got.shape == (3, 16, 16)
    np.testing.assert_allclose(got, _run(mk(jT), img, 0, False), rtol=0,
                               atol=1e-6)


def test_samplers_match():
    for last in ("keep", "discard", "rollover"):
        tb = tdata.BatchSampler(tdata.SequentialSampler(10, start=2), 4,
                                last)
        jb = jdata.BatchSampler(jdata.SequentialSampler(10, start=2), 4,
                                last)
        for _ in range(3):  # rollover carries the tail into the next epoch
            assert list(tb) == list(jb)
            assert len(tb) == len(jb)
    np.random.seed(4)
    tr = list(tdata.RandomSampler(9))
    np.random.seed(4)
    assert tr == list(jdata.RandomSampler(9))
    with pytest.raises(MXNetError, match="last_batch"):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "drop")


def test_datasets_match():
    x = np.random.RandomState(0).rand(11, 4).astype(np.float32)
    y = np.arange(11, dtype=np.float32)
    td, jd = tdata.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    assert len(td) == len(jd) == 11
    np.testing.assert_array_equal(td[3][0], jd[3][0])
    for i in range(4):
        a, b = td.shard(4, i), jd.shard(4, i)
        assert len(a) == len(b)
        np.testing.assert_array_equal(a[0][0], b[0][0])
    assert len(td.take(5)) == 5
    assert len(td.filter(lambda s: s[1] > 6)) == 4
    t2 = td.transform_first(lambda v: v * 2)
    np.testing.assert_array_equal(t2[2][0], x[2] * 2)
    assert t2[2][1] == y[2]
    eager = tdata.SimpleDataset(list(range(5))).transform(lambda v: v + 1,
                                                          lazy=False)
    assert [eager[i] for i in range(5)] == [1, 2, 3, 4, 5]


def _write_rec(tmp_path, n=10, seed=0):
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 256, (18 + i % 3, 22, 3)).astype(np.uint8)
        w.write_idx(i, jrec.pack_img((0, float(i % 4), i, 0), img,
                                     quality=3, img_fmt=".png"))
    w.close()
    return rec


def test_record_datasets_match(tmp_path):
    rec = _write_rec(tmp_path)
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 10 and t[4] == j[4]
    ti = tdata.vision.ImageRecordDataset(rec)
    ji = jdata.vision.ImageRecordDataset(rec)
    for i in (0, 7):
        (timg, tl), (jimg, jl) = ti[i], ji[i]
        assert timg.context == CPU and tl == jl
        np.testing.assert_array_equal(timg.asnumpy(), jimg.asnumpy())
    back = pickle.loads(pickle.dumps(ti))
    np.testing.assert_array_equal(back[3][0].asnumpy(), ti[3][0].asnumpy())


def test_folder_and_synthetic_datasets_match(tmp_path):
    import cv2

    for c, cls in enumerate(("cat", "dog")):
        os.makedirs(tmp_path / cls)
        for k in range(2):
            cv2.imwrite(str(tmp_path / cls / f"{k}.png"), _img(8, 9, c + k))
    t = tdata.vision.ImageFolderDataset(str(tmp_path))
    j = jdata.vision.ImageFolderDataset(str(tmp_path))
    assert t.synsets == j.synsets == ["cat", "dog"] and len(t) == 4
    np.testing.assert_array_equal(t[3][0].asnumpy(), j[3][0].asnumpy())
    ts = tdata.vision.SyntheticImageDataset(6, (5, 5, 3), 4, seed=2)
    js = jdata.vision.SyntheticImageDataset(6, (5, 5, 3), 4, seed=2)
    assert ts[5][1] == js[5][1]
    np.testing.assert_array_equal(ts[5][0].asnumpy(), js[5][0].asnumpy())


def test_mnist_and_cifar_read_local_files(tmp_path):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    for name, arr in (("train-images-idx3-ubyte.gz", imgs),
                      ("train-labels-idx1-ubyte.gz",
                       np.arange(5, dtype=np.uint8))):
        with gzip.open(tmp_path / name, "wb") as f:
            f.write(struct.pack(">I", 0x0800 | arr.ndim))
            f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
            f.write(arr.tobytes())
    tm, jm = tdata.vision.MNIST(str(tmp_path)), \
        jdata.vision.MNIST(str(tmp_path))
    assert len(tm) == 5 and tm[2][1] == jm[2][1]
    np.testing.assert_array_equal(tm[2][0].asnumpy(), jm[2][0].asnumpy())
    cif = tmp_path / "cifar"
    os.makedirs(cif)
    with open(cif / "test_batch", "wb") as f:
        pickle.dump({"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8),
                     "labels": [1, 2, 3]}, f)
    tc = tdata.vision.CIFAR10(str(cif), train=False)
    jc = jdata.vision.CIFAR10(str(cif), train=False)
    np.testing.assert_array_equal(tc[1][0].asnumpy(), jc[1][0].asnumpy())
    with pytest.raises(MXNetError, match="no network"):
        tdata.vision.MNIST(str(tmp_path / "empty"))


def _image_dataset(mod, rec):
    T = mod.vision.transforms
    return mod.vision.ImageRecordDataset(rec).transform_first(T.Compose([
        T.CenterCrop(16), T.ToTensor(),
        T.Normalize((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))]))


@pytest.mark.parametrize("workers", [0, 3])
def test_dataloader_matches_reference(tmp_path, workers):
    rec = _write_rec(tmp_path, n=11)
    ref = [(d.asnumpy(), l.asnumpy()) for d, l in
           jdata.DataLoader(_image_dataset(jdata, rec), batch_size=4)]
    loader = tdata.DataLoader(_image_dataset(tdata, rec), batch_size=4,
                              num_workers=workers)
    got = [(d, l) for d, l in loader]
    assert len(got) == len(ref) == 3
    for (d, l), (rd, rl) in zip(got, ref):
        assert d.context == CPU and d.shape[1:] == (3, 16, 16)
        np.testing.assert_allclose(d.asnumpy(), rd, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(l.asnumpy(), rl)


def test_dataloader_last_batch_shuffle_and_pin_memory():
    ds = tdata.ArrayDataset(np.arange(10, dtype=np.float32))
    np.random.seed(0)
    got = [b.asnumpy() for b in tdata.DataLoader(ds, batch_size=3,
                                                 shuffle=True,
                                                 last_batch="discard")]
    np.random.seed(0)
    ref = [b.asnumpy() for b in jdata.DataLoader(jdata.ArrayDataset(
        np.arange(10, dtype=np.float32)), batch_size=3, shuffle=True,
        last_batch="discard")]
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # without a card there is nothing to pin for: host batches as they are
    batches = list(tdata.DataLoader(ds, batch_size=4, pin_memory=True,
                                    num_workers=2))
    assert [b.shape for b in batches] == [(4,), (4,), (2,)]
    assert all(b._data.device.type == "cpu" for b in batches)
    with pytest.raises(MXNetError, match="batch_size"):
        tdata.DataLoader(ds)


def test_dataloader_thread_worker_error_propagates():
    class Bad(tdata.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("bad sample 5")
            return np.zeros(2, np.float32)

    with pytest.raises(ValueError, match="bad sample 5"):
        list(tdata.DataLoader(Bad(), batch_size=2, num_workers=2))


def test_dataloader_process_workers(tmp_path):
    """Spawned workers, batches back through shared memory: equal to the
    serial batches over two epochs on one pool, and no block left."""
    rec = _write_rec(tmp_path, n=9, seed=4)
    ds = _image_dataset(tdata, rec)
    serial = [(d.asnumpy(), l.asnumpy())
              for d, l in tdata.DataLoader(ds, batch_size=4)]
    loader = tdata.DataLoader(ds, batch_size=4, num_workers=2,
                              worker_type="process", timeout=120)
    try:
        for _ in range(2):
            got = [(d.asnumpy(), l.asnumpy()) for d, l in loader]
            assert len(got) == len(serial) == 3
            for (a, al), (b, bl) in zip(serial, got):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(al, bl)
        procs = loader._pool[0]
    finally:
        loader.close()
    assert not any(p.is_alive() for p in procs)
    mine = [f for f in os.listdir("/dev/shm")
            if f.startswith(f"mxt-{os.getpid()}-")]
    assert mine == []
