"""``image.ImageDetIter``, ``CreateDetAugmenter`` and the ``Det*``
augmenters of the PyTorch/CUDA port against the JAX package.

Both read the same ``.rec`` file of synthetic JPEGs (written here with
the port's ``recordio``, 1–4 boxes each in the reference's label wire
format ``[2, 5, cls, x1, y1, x2, y2, ...]``) and draw their augmentation
from the same ``RandomState`` seed: every batch's pixels and padded
labels (``-1`` rows past an image's boxes) must be equal, crops and
flips included, and each augmenter's output equal on the same image,
boxes and seed.  Both decode and resize with OpenCV and augment in
numpy, so equal means bit for bit.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio

N_IMAGES = 7


def _image(rs, i):
    h, w = 40 + 4 * i, 56 - 3 * i
    img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    k = 1 + i % 4
    c = rs.uniform(0.25, 0.75, (k, 2))
    wh = rs.uniform(0.1, 0.4, (k, 2))
    boxes = np.concatenate([rs.randint(0, 3, (k, 1)), c - wh / 2,
                            c + wh / 2], 1).astype(np.float32)
    return img, boxes


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("det")
    rec, idx = str(root / "det.rec"), str(root / "det.idx")
    rs = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    raw = []
    for i in range(N_IMAGES):
        img, boxes = _image(rs, i)
        label = np.concatenate([[2, 5], boxes.ravel()]).astype(np.float32)
        ok, buf = cv2.imencode(".jpg", img[:, :, ::-1])
        assert ok
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, label, i, 0),
                                     buf.tobytes()))
        raw.append((img, boxes))
    w.close()
    return rec, raw


def _batches(pkg, rec, epochs=2, **kw):
    it = pkg.image.ImageDetIter(4, (3, 32, 48), path_imgrec=rec, **kw)
    out = []
    for _ in range(epochs):
        it.reset()
        for batch in it:
            out.append((batch.data[0].asnumpy(), batch.label[0].asnumpy(),
                        batch.pad))
    return out, it


@pytest.mark.parametrize("augmented", [False, True])
def test_image_det_iter_batches_equal_the_reference(records, augmented):
    rec, _ = records
    res = []
    for pkg in (jmx, tmx):
        kw = {}
        if augmented:  # resize, crop, mirror and normalize, shuffled
            kw = dict(shuffle=True, seed=3,
                      aug_list=pkg.image.CreateDetAugmenter(
                          (3, 32, 48), resize=40, rand_crop=0.7,
                          rand_mirror=True, mean=(120.0, 110.0, 100.0),
                          std=(60.0, 50.0, 40.0)))
        with tmx.cpu():
            res.append(_batches(pkg, rec, **kw))
    (ref, jit), (got, tit) = res
    assert len(got) == len(ref) == 4
    for (rd, rl, rp), (gd, gl, gp) in zip(ref, got):
        assert gp == rp
        np.testing.assert_array_equal(gd, rd)
        np.testing.assert_array_equal(gl, rl)
    assert got[1][2] == 1  # 7 images, batches of 4: the last one padded
    assert (got[0][1] == -1).all(-1).any()  # -1 rows past the boxes
    assert tit.provide_label[0].shape == jit.provide_label[0].shape == \
        (4, 4, 5)
    assert tit.provide_data[0].shape == (4, 3, 32, 48)


def test_image_det_iter_from_an_image_list(records):
    _, raw = records
    imglist = [(img, boxes) for img, boxes in raw[:3]]
    res = []
    for pkg in (jmx, tmx):
        with tmx.cpu():
            it = pkg.image.ImageDetIter(2, (3, 24, 24), imglist=imglist)
            res.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                        for b in it])
    for (rd, rl), (gd, gl) in zip(*res):
        np.testing.assert_array_equal(gd, rd)
        np.testing.assert_array_equal(gl, rl)


AUGS = {
    "flip": lambda pkg: pkg.image.DetHorizontalFlipAug(1.0),
    "resize": lambda pkg: pkg.image.DetResizeAug((30, 20)),
    "crop": lambda pkg: pkg.image.DetRandomCropAug(min_crop=0.5),
    "resize_short": lambda pkg: pkg.image.detection.DetResizeShortAug(25),
    "normalize": lambda pkg: pkg.image.detection.DetNormalizeAug(
        (1.0, 2.0, 3.0), (4.0, 5.0, 6.0)),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_det_augmenters_equal_the_reference(records, name):
    _, raw = records
    res = []
    for pkg in (jmx, tmx):
        rs = np.random.RandomState(11)
        aug = AUGS[name](pkg)
        outs = []
        for img, boxes in raw:
            a, b = aug(np.array(img, np.float32), boxes.copy(), rs)
            outs.append((np.asarray(a), np.asarray(b)))
        res.append(outs)
    moved = False
    for (ra, rb), (ga, gb) in zip(*res):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)
        moved |= ga.shape != raw[0][0].shape
    if name == "flip":  # x-coordinates mirrored, y kept
        img, boxes = raw[0]
        gb = res[1][0][1]
        np.testing.assert_allclose(gb[:, 1], 1.0 - boxes[:, 3], rtol=1e-6)
        np.testing.assert_array_equal(gb[:, 2], boxes[:, 2])
    if name == "crop":
        assert moved
