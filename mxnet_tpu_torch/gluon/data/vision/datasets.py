"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; reference
``python/mxnet/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10/100, ImageRecordDataset, ImageFolderDataset and
SyntheticImageDataset.

There is no download: the datasets read the standard files from ``root``
(idx, optionally gzipped, for MNIST; the Python pickles for CIFAR), as the
reference does.  Images are host arrays, as MXNet's datasets give them;
``SyntheticImageDataset`` makes deterministic data from a seed.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np
import torch

from ....base import MXNetError
from ....context import cpu
from ....ndarray import NDArray
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset",
           "SyntheticImageDataset"]


def _host_nd(arr):
    """A host NDArray sharing nothing with ``arr``."""
    return NDArray(torch.from_numpy(np.array(arr)))


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class _DownloadedDataset(Dataset):
    """Base of the MNIST/CIFAR datasets read from local files."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        img_name, lbl_name = self._files[self._train]
        img_path = lbl_path = None
        for suffix in ("", ".gz"):
            p = os.path.join(self._root, img_name + suffix)
            if os.path.isfile(p):
                img_path = p
            p = os.path.join(self._root, lbl_name + suffix)
            if os.path.isfile(p):
                lbl_path = p
        if img_path is None or lbl_path is None:
            raise MXNetError(
                f"MNIST files not found under {self._root!r} (no network "
                "access to download; place idx files there)")
        images = _read_idx(img_path)
        labels = _read_idx(lbl_path)
        self._data = _host_nd(images.reshape(-1, 28, 28, 1))
        self._label = labels.astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _load_batches(self, names):
        data, labels = [], []
        for name in names:
            path = os.path.join(self._root, name)
            if not os.path.isfile(path):
                raise MXNetError(
                    f"CIFAR batch {path!r} not found (no network access; "
                    "place the python-format batches there)")
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            data.append(batch["data"])
            labels.extend(batch.get("labels", batch.get("fine_labels")))
        data = np.concatenate(data).reshape(-1, 3, 32, 32)
        return data.transpose(0, 2, 3, 1), np.asarray(labels, np.int32)

    def _get_data(self):
        if self._train:
            names = [f"data_batch_{i}" for i in range(1, 6)]
        else:
            names = ["test_batch"]
        data, labels = self._load_batches(names)
        self._data = _host_nd(data)
        self._label = labels


class CIFAR100(CIFAR10):
    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        names = ["train"] if self._train else ["test"]
        data, labels = self._load_batches(names)
        self._data = _host_nd(data)
        self._label = labels


class ImageRecordDataset(Dataset):
    """Record-file image dataset (reference ``ImageRecordDataset``): item
    ``i`` is (HWC uint8 RGB host NDArray, label)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset

        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio, image

        record = self._record[idx]
        header, img_bytes = recordio.unpack(record)
        with cpu():
            img = image.imdecode(img_bytes, self._flag)
        label = header.label
        if isinstance(label, np.ndarray) and label.size == 1:
            label = float(label[0])
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._record)


class ImageFolderDataset(Dataset):
    """class-per-subdirectory image tree (reference
    ``ImageFolderDataset``)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = (".jpg", ".jpeg", ".png", ".bmp")
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if filename.lower().endswith(self._exts):
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image

        with cpu():
            img = image.imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class SyntheticImageDataset(Dataset):
    """Deterministic image data from a seed, for benchmarks and tests."""

    def __init__(self, length=256, shape=(32, 32, 3), classes=10, seed=0):
        rng = np.random.RandomState(seed)
        self._data = rng.randint(0, 256, (length,) + tuple(shape)) \
            .astype(np.uint8)
        self._label = rng.randint(0, classes, (length,)).astype(np.int32)

    def __getitem__(self, idx):
        return _host_nd(self._data[idx]), int(self._label[idx])

    def __len__(self):
        return len(self._label)
