"""``mx.io`` of the PyTorch/CUDA port against the JAX package: the same
record files and seeds give the same batches, on the port's native reader
and on its Python reader (the reference runs its Python reader, which its
own tests hold equal to its native one)."""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimg
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
            std_g=57.12, std_b=57.375)


def _write_images(path, n, seed, fmt=".png", label_width=1, idx=None):
    """n images of varying sizes (28..40 wide), label i % 5 (or a vector),
    written by the JAX package."""
    rng = np.random.RandomState(seed)
    rec = jrec.MXIndexedRecordIO(str(idx), str(path), "w") if idx \
        else jrec.MXRecordIO(str(path), "w")
    for i in range(n):
        img = (rng.rand(26 + i % 5, 28 + (3 * i) % 13, 3) * 255) \
            .astype(np.uint8)
        label = float(i % 5) if label_width == 1 else \
            [float(i), float(-i), 0.5 * i][:label_width]
        payload = jrec.pack_img((0, label, i, 0), img,
                                quality=3 if fmt == ".png" else 95,
                                img_fmt=fmt)
        if idx:
            rec.write_idx(i, payload)
        else:
            rec.write(payload)
    rec.close()
    return str(path)


def _epoch(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _assert_same(got, ref):
    assert len(got) == len(ref) > 0
    for (gd, gl, gp), (rd, rl, rp) in zip(got, ref):
        assert gd.shape == rd.shape and gd.dtype == np.float32
        np.testing.assert_allclose(gd, rd, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gl, rl)
        assert gp == rp


@pytest.mark.parametrize("no_native", [False, True])
@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_image_record_iter_matches(tmp_path, no_native, fmt):
    """Shuffled, randomly cropped and mirrored, normalized batches: equal
    over two epochs (the generator carries over the reset)."""
    path = _write_images(tmp_path / "a.rec", 23, seed=1, fmt=fmt)
    kw = dict(path_imgrec=path, data_shape=(3, 24, 24), batch_size=5,
              shuffle=True, rand_crop=True, rand_mirror=True, seed=7,
              preprocess_threads=3, **MEAN)
    ref = jmx.io.ImageRecordIter(no_native=True, **kw)
    with CPU:
        it = tmx.io.ImageRecordIter(no_native=no_native, **kw)
    assert (it._records is None) != no_native
    for _ in range(2):
        got = _epoch(it)
        _assert_same(got, _epoch(ref))
        assert got[-1][2] == 2  # 23 = 4 * 5 + 3: the last batch pads 2
        it.reset()
        ref.reset()
    assert it.provide_data[0].shape == (5, 3, 24, 24)
    it.close()


@pytest.mark.parametrize("no_native", [False, True])
def test_image_record_iter_with_idx_parts_and_label_width(tmp_path,
                                                          no_native):
    path = _write_images(tmp_path / "b.rec", 14, seed=2, label_width=3,
                         idx=tmp_path / "b.idx")
    kw = dict(path_imgrec=path, path_imgidx=str(tmp_path / "b.idx"),
              data_shape=(3, 20, 20), batch_size=3, label_width=3,
              num_parts=2, part_index=1, resize=22, seed=3)
    ref = _epoch(jmx.io.ImageRecordIter(no_native=True, **kw))
    with CPU:
        got = _epoch(tmx.io.ImageRecordIter(no_native=no_native, **kw))
    _assert_same(got, ref)
    assert got[0][1].shape == (3, 3)
    assert got[0][1][:, 0].tolist() == [1.0, 3.0, 5.0]  # keys 1, 3, 5


def test_image_record_iter_midepoch_reset(tmp_path):
    """A reset after one batch drains the batches in flight and restarts
    on the same native prefetcher."""
    path = _write_images(tmp_path / "c.rec", 20, seed=5)
    kw = dict(path_imgrec=path, data_shape=(3, 24, 24), batch_size=4,
              shuffle=True, seed=1)
    with CPU:
        it = tmx.io.ImageRecordIter(**kw)
    ref = jmx.io.ImageRecordIter(no_native=True, **kw)
    next(it)
    next(ref)
    pf = it._pf
    it.reset()
    ref.reset()
    assert it._pf is pf
    _assert_same(_epoch(it), _epoch(ref))


def test_image_record_iter_small_shard_pads_a_full_batch(tmp_path):
    path = _write_images(tmp_path / "d.rec", 3, seed=6)
    for no_native in (False, True):
        with CPU:
            it = tmx.io.ImageRecordIter(path_imgrec=path,
                                        data_shape=(3, 24, 24),
                                        batch_size=8, no_native=no_native)
        b = next(it)
        assert b.data[0].shape == (8, 3, 24, 24) and b.pad == 5
        assert b.label[0].asnumpy().tolist() == \
            [0.0, 1.0, 2.0, 0.0, 1.0, 2.0, 0.0, 1.0]
        assert b.data[0].context == CPU


def test_image_iter_matches(tmp_path):
    path = _write_images(tmp_path / "e.rec", 9, seed=8)
    kw = dict(batch_size=4, data_shape=(3, 24, 24), path_imgrec=path,
              shuffle=True, rand_crop=True, seed=4)
    with CPU:
        got = _epoch(timg.ImageIter(**kw))
    _assert_same(got, _epoch(jimg.ImageIter(no_native=True, **kw)))


@pytest.mark.parametrize("handle", ["pad", "discard"])
def test_ndarray_iter_matches(handle):
    rng = np.random.RandomState(0)
    x = rng.randn(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    for shuffle in (False, True):
        np.random.seed(5)
        ref = jmx.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                                 last_batch_handle=handle)
        rb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
              for b in ref]
        np.random.seed(5)
        with CPU:
            it = tmx.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                                    last_batch_handle=handle)
        tb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
              for b in it]
        assert len(tb) == len(rb) == (3 if handle == "pad" else 2)
        for (td, tl, tp), (rd, rl, rp) in zip(tb, rb):
            np.testing.assert_array_equal(td, rd)
            np.testing.assert_array_equal(tl, rl)
            assert tp == rp
    assert [d.shape for d in it.provide_data] == [(4, 3)]


def test_csv_resize_and_prefetching_iters(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(7, 6).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", x, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(7.0), delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=3)
    ref = [b.data[0].asnumpy() for b in jmx.io.CSVIter(**kw)]
    with CPU:
        csv = tmx.io.CSVIter(**kw)
        got = [b.data[0].asnumpy() for b in csv]
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        csv.reset()
        resized = tmx.io.ResizeIter(csv, 5)
        labels = [b.label[0].asnumpy().tolist() for b in resized]
        assert len(labels) == 5 and labels[3] == labels[0]
        inner = tmx.io.NDArrayIter(x, np.arange(7.0, dtype=np.float32),
                                   batch_size=2)
    pre = tmx.io.PrefetchingIter(inner)
    for _ in range(2):
        got = [b.label[0].asnumpy().tolist() for b in pre]
        assert got == [[0, 1], [2, 3], [4, 5], [6, 0]]
        pre.reset()
    pre.close()


def test_prefetching_iter_raises_the_source_error():
    class Bad(tmx.io.DataIter):
        def next(self):
            raise ValueError("broken source")

    pre = tmx.io.PrefetchingIter(Bad(2))
    with pytest.raises(ValueError, match="broken source"):
        pre.next()
    pre.close()


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def test_mnist_iter_matches(tmp_path):
    rng = np.random.RandomState(2)
    _write_idx(tmp_path / "img.gz",
               rng.randint(0, 256, (9, 28, 28)).astype(np.uint8))
    _write_idx(tmp_path / "lbl.gz", rng.randint(0, 10, 9).astype(np.uint8))
    kw = dict(image=str(tmp_path / "img.gz"), label=str(tmp_path / "lbl.gz"),
              batch_size=4, shuffle=False)
    ref = [b.data[0].asnumpy() for b in jmx.io.MNISTIter(**kw)]
    with CPU:
        got = [b.data[0].asnumpy() for b in tmx.io.MNISTIter(**kw)]
    assert len(got) == 2 and got[0].shape == (4, 1, 28, 28)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_libsvm_iter_names_the_roadmap(tmp_path):
    """``LibSVMIter``, refused naming "Left out of slice 10" until slice
    16, now reads CSR batches equal to the reference's
    (``test_torch_fm.py`` holds padding and the label file)."""
    path = tmp_path / "x"
    path.write_text("1 0:0.5 3:2\n0 1:1\n1 2:0.25 3:1\n")
    ref = [b.data[0].asnumpy() for b in
           jmx.io.LibSVMIter(data_libsvm=str(path), data_shape=(4,),
                             batch_size=2)]
    with CPU:
        got = [b.data[0].asnumpy() for b in
               tmx.io.LibSVMIter(data_libsvm=str(path), data_shape=(4,),
                                 batch_size=2)]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
