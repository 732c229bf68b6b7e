"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; reference
``python/mxnet/gluon/data/vision/transforms.py``): ``Compose`` through
``RandomLighting``, as Gluon blocks over the op library and the host
image functions.  Random draws come from numpy's global generator, as in
the reference.  Constants are made on the input's context."""
from __future__ import annotations

import numpy as np

from ...block import Block, HybridBlock
from ...nn import Sequential
from .... import ndarray as nd
from ....base import MXNetError  # noqa: F401
from ....ndarray import NDArray  # noqa: F401
from ...nn import HybridSequential  # noqa: F401

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting", "CropResize"]

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


class Compose(Sequential):
    """Apply transforms in turn (reference ``transforms.Compose``)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0, 255] to CHW float32 [0, 1] (reference
    ``ToTensor``)."""

    def hybrid_forward(self, F, x):
        axes = (2, 0, 1) if x.ndim == 3 else (0, 3, 1, 2)
        return F.transpose(F.cast(x, dtype="float32") / 255.0, axes=axes)


class Normalize(HybridBlock):
    """(x - mean) / std per channel of CHW tensors (reference
    ``Normalize``)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def hybrid_forward(self, F, x):
        mean, std = self._mean, self._std
        if x.ndim == 4:
            mean = mean[None]
            std = std[None]
        return (x - nd.array(mean, ctx=x.context)) / \
            nd.array(std, ctx=x.context)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image

        if self._keep and isinstance(self._size, int):
            return image.resize_short(x, self._size, self._interpolation)
        size = (self._size, self._size) if isinstance(self._size, int) \
            else self._size
        return image.imresize(x, size[0], size[1], self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image

        return image.center_crop(x, self._size, self._interpolation)[0]


class CropResize(Block):
    def __init__(self, x, y, width, height, size=None, interpolation=None):
        super().__init__()
        self._args = (x, y, width, height)
        self._size = size
        self._interpolation = interpolation or 1

    def forward(self, data):
        from .... import image

        x, y, w, h = self._args
        size = (self._size, self._size) if isinstance(self._size, int) \
            else self._size
        return image.fixed_crop(data, x, y, w, h, size, self._interpolation)


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image

        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            aspect = np.exp(np.random.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = np.random.randint(0, w - cw + 1)
                y0 = np.random.randint(0, h - ch + 1)
                return image.fixed_crop(x, x0, y0, cw, ch, self._size,
                                        self._interpolation)
        return image.center_crop(x, self._size, self._interpolation)[0]


class RandomFlipLeftRight(HybridBlock):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def hybrid_forward(self, F, x):
        if np.random.rand() < self._p:
            return F.flip(x, axis=1 if x.ndim == 3 else 2)
        return x


class RandomFlipTopBottom(HybridBlock):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def hybrid_forward(self, F, x):
        if np.random.rand() < self._p:
            return F.flip(x, axis=0 if x.ndim == 3 else 1)
        return x


class RandomBrightness(HybridBlock):
    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def hybrid_forward(self, F, x):
        return x * np.random.uniform(*self._args)


def _gray_coef(x):
    shape = (3, 1, 1) if x.ndim == 3 else (1, 3, 1, 1)
    return nd.array(_GRAY.reshape(shape), ctx=x.context)


class RandomContrast(HybridBlock):
    """Blend with the mean gray level (of each CHW image; of the whole
    NCHW batch, where the reference's batch branch sums the weights
    alone)."""

    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def hybrid_forward(self, F, x):
        alpha = np.random.uniform(*self._args)
        gray_mean = F.mean(F.sum(x * _gray_coef(x),
                                 axis=-3 if x.ndim == 3 else 1))
        return x * alpha + gray_mean * (1 - alpha)


class RandomSaturation(HybridBlock):
    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0, 1 - saturation), 1 + saturation)

    def hybrid_forward(self, F, x):
        alpha = np.random.uniform(*self._args)
        gray = F.sum(x * _gray_coef(x), axis=-3, keepdims=True)
        return x * alpha + gray * (1 - alpha)


class RandomLighting(HybridBlock):
    """AlexNet-style PCA lighting noise (reference ``RandomLighting``)."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        alpha = np.random.normal(0, self._alpha, 3).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return x + nd.array(rgb.reshape(3, 1, 1), ctx=x.context)
