"""Image decode and augmentation.

Counterpart of ``mxnet_tpu/image/__init__.py`` (reference
``python/mxnet/image/image.py``): ``imdecode``/``imresize``, the crops,
``color_normalize``, the augmenter classes, ``CreateAugmenter`` and
``ImageIter``.

Decode and the geometric augmentations run on the host with OpenCV and
numpy, as in the reference; ``imdecode`` returns an ``NDArray`` on the
current context, and a function given an ``NDArray`` returns one on that
array's context.  The pipelines
(``io.ImageRecordIter``, ``gluon.data``, ``data.StreamingLoader``) keep
images as numpy until one host-to-device copy a batch.

The detection iterator and its box-aware augmenters (``ImageDetIter``,
``CreateDetAugmenter``, the ``Det*`` augmenters) are in
``image/detection.py``.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["imdecode", "imdecode_raw", "imresize", "imread",
           "resize_short", "fixed_crop", "center_crop", "random_crop",
           "color_normalize", "ImageIter", "augment_basic", "augment_geom",
           "CreateAugmenter", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "ImageDetIter", "CreateDetAugmenter", "DetAugmenter",
           "DetHorizontalFlipAug", "DetResizeAug", "DetRandomCropAug"]

def _cv2(what):
    """OpenCV, or ``MXNetError`` naming it (the host codec and resizer)."""
    try:
        import cv2
    except ImportError as exc:
        raise MXNetError(f"{what} needs OpenCV (the cv2 module), which "
                         "this Python cannot import") from exc
    return cv2


def _decode_bgr(buf, flag=1):
    """Encoded bytes to an HWC (or HW for ``flag=0``) uint8 array in the
    codec's BGR order; ``MXNetError`` if the bytes do not decode."""
    cv2 = _cv2("decoding an image")
    img = cv2.imdecode(np.frombuffer(bytes(buf), dtype=np.uint8), flag)
    if img is None:
        raise MXNetError("failed to decode image bytes")
    return img


def imdecode_raw(buf, flag=1):
    """Bytes to an HWC RGB uint8 numpy array (host)."""
    img = _decode_bgr(buf, flag)
    if img.ndim == 3 and img.shape[2] == 3:
        img = np.ascontiguousarray(img[:, :, ::-1])
    return img


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Reference ``mx.image.imdecode``: an HWC uint8 NDArray on the
    current context."""
    img = _decode_bgr(buf, flag)
    if to_rgb and img.ndim == 3 and img.shape[2] == 3:
        img = np.ascontiguousarray(img[:, :, ::-1])
    return NDArray(img)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def _host(src):
    return src.asnumpy() if isinstance(src, NDArray) else src


def _like(src, out):
    """``out`` as ``src`` came: an NDArray on ``src``'s context, or numpy."""
    if isinstance(src, NDArray):
        return NDArray(np.ascontiguousarray(out), ctx=src.context)
    return out


def imresize(src, w, h, interp=1):
    cv2 = _cv2("resizing an image")
    return _like(src, cv2.resize(_host(src), (w, h), interpolation=interp))


def resize_short(src, size, interp=2):
    """Resize the shorter edge to ``size`` (reference ``resize_short``)."""
    h, w = _host(src).shape[:2]
    if h > w:
        new_w, new_h = size, size * h // w
    else:
        new_w, new_h = size * w // h, size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = _host(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return _like(src, out)


def center_crop(src, size, interp=2):
    arr = _host(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(arr, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return _like(src, out), (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2, rng=None):
    rng = rng or np.random
    arr = _host(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    x0 = rng.randint(0, max(w - new_w, 0) + 1)
    y0 = rng.randint(0, max(h - new_h, 0) + 1)
    out = fixed_crop(arr, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return _like(src, out), (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    arr = np.asarray(_host(src), np.float32)
    arr = arr - np.asarray(mean, np.float32)
    if std is not None:
        arr = arr / np.asarray(std, np.float32)
    return _like(src, arr)


def augment_geom(img, data_shape, rng, rand_crop=False, rand_mirror=False,
                 resize=-1):
    """The geometric half of ``ImageRecordIter``'s augmentation chain
    (resize-short, crop, mirror) on a uint8 HWC numpy image, drawing from
    ``rng`` in the reference's order.  The numeric half (scale, mean,
    std, CHW) runs on the batch's device after the uint8 copy."""
    if resize > 0:
        img = resize_short(img, resize)
    c, h, w = data_shape
    if img.shape[0] != h or img.shape[1] != w:
        if rand_crop and img.shape[0] >= h and img.shape[1] >= w:
            img, _ = random_crop(img, (w, h), rng=rng)
        else:
            ih, iw = img.shape[:2]
            if ih < h or iw < w:
                img = _cv2("resizing an image").resize(
                    img, (max(w, iw), max(h, ih)))
            img, _ = center_crop(img, (w, h))
    if rand_mirror and rng.rand() < 0.5:
        img = img[:, ::-1]
    return img


def augment_basic(img, data_shape, rng, mean=(0, 0, 0), std=(1, 1, 1),
                  scale=1.0, rand_crop=False, rand_mirror=False, resize=-1):
    """The whole ``ImageRecordIter`` chain on the host (reference
    ``augment_basic``): resize-short, crop, mirror, normalize, CHW."""
    img = augment_geom(img, data_shape, rng, rand_crop=rand_crop,
                       rand_mirror=rand_mirror, resize=resize)
    img = img.astype(np.float32) * scale
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if mean.any():
        img = img - mean
    if (std != 1).any():
        img = img / std
    return np.transpose(img, (2, 0, 1))


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError

    def dumps(self):
        import json

        return json.dumps([type(self).__name__, self._kwargs])


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if np.random.rand() < self.p:
            return _like(src, _host(src)[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ=np.float32):
        super().__init__(typ=str(typ))
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list (reference ``CreateAugmenter``)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    return auglist


class ImageIter:
    """Image iterator over a record file (reference ``mx.image.ImageIter``),
    a thin wrapper over ``io.ImageRecordIter``."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 shuffle=False, aug_list=None, **kwargs):
        from .. import io as mxio

        if path_imgrec is None:
            raise MXNetError("ImageIter requires path_imgrec")
        self._inner = mxio.ImageRecordIter(
            path_imgrec=path_imgrec, data_shape=data_shape,
            batch_size=batch_size, shuffle=shuffle, **kwargs)

    def __iter__(self):
        return self

    def __next__(self):
        return self._inner.next()

    next = __next__

    def reset(self):
        self._inner.reset()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


# detection iterator + box-aware augmenters (reference image/detection.py)
from .detection import (ImageDetIter, CreateDetAugmenter,  # noqa: E402,F401
                        DetAugmenter, DetHorizontalFlipAug, DetResizeAug,
                        DetRandomCropAug)
