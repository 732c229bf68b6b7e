"""Detection image iterator + box-aware augmenters.

Counterpart of ``mxnet_tpu/image/detection.py`` (reference
``python/mxnet/image/detection.py``, ``ImageDetIter`` and
``CreateDetAugmenter``): augmentations transform the ground-truth boxes
together with the pixels (a flip mirrors the x-coordinates, a crop
shifts and clips the boxes), on the host with numpy and OpenCV.

Label wire format (reference contract): per image
``[header_width, object_width, (extra...), obj0, obj1, ...]`` where each
object is ``[class, xmin, ymin, xmax, ymax]`` normalized to [0, 1].
``ImageDetIter.next`` emits padded (B, max_objs, 5) labels (-1 rows for
absent objects) — the shape ``MultiBoxTarget`` consumes — and one
host-to-device copy a batch, on the current context.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import current_context
from ..io import DataBatch, DataDesc, DataIter, _to_device
from . import imdecode_raw, imresize
from ..ndarray import NDArray  # noqa: F401

__all__ = ["DetAugmenter", "DetHorizontalFlipAug", "DetResizeAug",
           "DetRandomCropAug", "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    def __call__(self, img, boxes, rng):
        raise NotImplementedError


class DetResizeAug(DetAugmenter):
    """Resize pixels; normalized boxes are scale-invariant."""

    def __init__(self, size):
        self.size = size if isinstance(size, (tuple, list)) else \
            (size, size)

    def __call__(self, img, boxes, rng):
        return imresize(img, self.size[0], self.size[1]), boxes


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror pixels AND x-coordinates with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, boxes, rng):
        if rng.uniform() < self.p:
            img = img[:, ::-1, :]
            if len(boxes):
                flipped = boxes.copy()
                flipped[:, 1] = 1.0 - boxes[:, 3]
                flipped[:, 3] = 1.0 - boxes[:, 1]
                boxes = flipped
        return img, boxes


class DetRandomCropAug(DetAugmenter):
    """Random crop (applied with probability ``p``) keeping boxes whose
    center survives (reference min_object_covered-style constraint,
    simplified)."""

    def __init__(self, min_crop=0.6, attempts=10, p=1.0):
        self.min_crop = max(min_crop, 0.1)  # never emit zero-size crops
        self.attempts = attempts
        self.p = p

    def __call__(self, img, boxes, rng):
        if rng.uniform() >= self.p:
            return img, boxes
        h, w = img.shape[:2]
        for _ in range(self.attempts):
            scale = rng.uniform(self.min_crop, 1.0)
            cw, ch = max(int(w * scale), 1), max(int(h * scale), 1)
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            if not len(boxes):
                return img[y0:y0 + ch, x0:x0 + cw], boxes
            cx = (boxes[:, 1] + boxes[:, 3]) / 2 * w
            cy = (boxes[:, 2] + boxes[:, 4]) / 2 * h
            keep = ((cx >= x0) & (cx < x0 + cw) &
                    (cy >= y0) & (cy < y0 + ch))
            if not keep.any():
                continue
            nb = boxes[keep].copy()
            nb[:, 1] = np.clip((nb[:, 1] * w - x0) / cw, 0, 1)
            nb[:, 3] = np.clip((nb[:, 3] * w - x0) / cw, 0, 1)
            nb[:, 2] = np.clip((nb[:, 2] * h - y0) / ch, 0, 1)
            nb[:, 4] = np.clip((nb[:, 4] * h - y0) / ch, 0, 1)
            return img[y0:y0 + ch, x0:x0 + cw], nb
        return img, boxes


class DetNormalizeAug(DetAugmenter):
    """Per-channel mean/std pixel normalization (boxes untouched)."""

    def __init__(self, mean, std):
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, img, boxes, rng):
        img = np.asarray(img, np.float32)
        if self.mean is not None:
            img = img - self.mean
        if self.std is not None:
            img = img / self.std
        return img, boxes


class DetResizeShortAug(DetAugmenter):
    """Resize the short edge to ``size`` keeping aspect (boxes are
    normalized, so unchanged)."""

    def __init__(self, size):
        self.size = int(size)

    def __call__(self, img, boxes, rng):
        h, w = img.shape[:2]
        scale = self.size / min(h, w)
        return imresize(img, max(1, int(w * scale)),
                        max(1, int(h * scale))), boxes


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_mirror=False,
                       mean=None, std=None, **kwargs):
    """Reference ``CreateDetAugmenter``: standard detection pipeline.
    ``rand_crop`` is the PROBABILITY of applying the random crop
    (reference contract)."""
    augs = []
    if resize > 0:
        augs.append(DetResizeShortAug(resize))
    if rand_crop > 0:
        augs.append(DetRandomCropAug(min_crop=0.6, p=float(rand_crop)))
    augs.append(DetResizeAug((data_shape[2], data_shape[1])))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    if mean is not None or std is not None:
        augs.append(DetNormalizeAug(mean, std))
    return augs


class ImageDetIter(DataIter):
    """Reference ``mx.image.ImageDetIter``: record-file (or in-memory)
    detection batches with box-aware augmentation."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imgidx=None, imglist=None, aug_list=None,
                 shuffle=False, mean=None, std=None, seed=0, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self._rng = np.random.RandomState(seed)
        self._aug = aug_list if aug_list is not None else \
            CreateDetAugmenter(self.data_shape)
        self._mean = np.asarray(mean, np.float32) if mean is not None \
            else None
        self._std = np.asarray(std, np.float32) if std is not None else None
        self._shuffle = shuffle
        self._records = []   # list of (imgbytes_or_array, boxes (N,5))
        if path_imgrec is not None:
            from .. import recordio

            rec = recordio.MXIndexedRecordIO(
                path_imgidx or path_imgrec.replace(".rec", ".idx"),
                path_imgrec, "r")
            for k in rec.keys:
                header, img = recordio.unpack(rec.read_idx(k))
                self._records.append((img, self._parse_label(header.label)))
            rec.close()
        elif imglist is not None:
            for img, label in imglist:
                self._records.append(
                    (np.asarray(img), np.asarray(label, np.float32)
                     .reshape(-1, 5)))
        else:
            raise MXNetError("need path_imgrec or imglist")
        if not self._records:
            raise MXNetError("no records")
        self._max_objs = max(1, max(len(b) for _i, b in self._records))
        self._order = np.arange(len(self._records))
        self.reset()

    @staticmethod
    def _parse_label(label):
        label = np.asarray(label, np.float32).ravel()
        if label.size < 2:
            return np.zeros((0, 5), np.float32)
        header_w = int(label[0])
        obj_w = int(label[1])
        body = label[header_w:]
        n = body.size // obj_w
        objs = body[:n * obj_w].reshape(n, obj_w)
        return objs[:, :5].astype(np.float32)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size, self._max_objs, 5))]

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._records):
            raise StopIteration
        idxs = self._order[self._cursor:self._cursor + self.batch_size]
        pad = self.batch_size - len(idxs)
        if pad:
            idxs = np.concatenate([idxs, self._order[:pad]])
        self._cursor += self.batch_size
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        labels = -np.ones((self.batch_size, self._max_objs, 5), np.float32)
        for bi, ri in enumerate(idxs):
            raw, boxes = self._records[ri]
            img = imdecode_raw(raw) if isinstance(raw, bytes) else raw
            # copy: augmenters return views and normalization is in-place;
            # the cached record must never mutate across epochs
            img = np.array(img, np.float32, copy=True)
            for aug in self._aug:
                img, boxes = aug(img, boxes, self._rng)
            if img.shape[:2] != (h, w):
                img = imresize(img, w, h)
            chw = np.transpose(np.asarray(img, np.float32), (2, 0, 1))
            if self._mean is not None:
                chw -= self._mean.reshape(-1, 1, 1)
            if self._std is not None:
                chw /= self._std.reshape(-1, 1, 1)
            data[bi] = chw
            n = min(len(boxes), self._max_objs)
            if n:
                labels[bi, :n] = boxes[:n]
        ctx = current_context()
        return DataBatch(data=[_to_device(data, ctx)],
                         label=[_to_device(labels, ctx)], pad=pad)
