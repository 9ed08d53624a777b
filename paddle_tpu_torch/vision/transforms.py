"""Vision transforms of the port (``paddle_tpu/vision/transforms.py``;
parity: python/paddle/vision/transforms): a numpy pipeline on the host (the
card never sees per-sample Python code), run in the DataLoader's workers.

The random transforms take an explicit ``generator`` (a
``numpy.random.RandomState``, an int seed, or None for one derived from
:func:`paddle_tpu_torch.seed`) where the reference draws from numpy's global
stream; given one ``RandomState`` seeded as the reference's global stream,
a pipeline of them draws the reference's crops, flips and factors in the
reference's order (``ColorJitter`` hands its generator to its four parts).
In process workers each worker holds a forked copy of a generator: reseed
it from ``io.get_worker_info().seed`` in ``worker_init_fn`` so the workers
draw apart.

Layouts: images are HWC arrays or CHW tensors, as in
:mod:`.functional`; an array whose leading axis is 1 or 3 and whose last is
not is taken as CHW. ``Normalize`` honours ``data_format`` and
``RandomHorizontalFlip`` and ``Resize`` flip and resize an HWC array's
width and height (the reference normalizes as CHW whatever the format, and
flips and resizes the last two axes, which on an HWC array are the width
and the channels; ROADMAP.md, Queue 3). On CHW input every transform is the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io.dataset import as_random_state


def _generator(generator, kind):
    return as_random_state(generator, f"vision.transforms.{kind}")


def _is_chw(img):
    """Whether ``img`` is laid out CHW: a tensor, or an array whose leading
    axis looks like 1 or 3 channels and whose last does not."""
    if isinstance(img, torch.Tensor):
        return True
    arr = np.asarray(img)
    return arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    """``(img - mean) / std`` per channel, in f32; ``data_format`` "CHW"
    or "HWC" says where the channels are."""

    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        shape = (-1, 1, 1) if data_format == "CHW" else (1, 1, -1)
        self.mean = np.asarray(mean, np.float32).reshape(shape)
        self.std = np.asarray(std, np.float32).reshape(shape)

    def __call__(self, img):
        return (np.asarray(img, np.float32) - self.mean) / self.std


class ToTensor:
    """HWC (or CHW) image -> f32 CHW array, uint8 scaled to [0, 1]."""

    def __init__(self, data_format="CHW"):
        pass

    def __call__(self, img):
        raw = np.asarray(img)
        # the scale is keyed on the input dtype, not the values, so every
        # sample of a uint8 dataset gets the same normalization
        scale = 255.0 if raw.dtype == np.uint8 else 1.0
        arr = raw.astype(np.float32)
        if arr.ndim == 3 and arr.shape[-1] in (1, 3):
            arr = arr.transpose(2, 0, 1)
        return arr / scale


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, generator=None):
        self.prob = prob
        self.generator = _generator(generator, "RandomHorizontalFlip")

    def __call__(self, img):
        if self.generator.rand() < self.prob:
            if not _is_chw(img) and np.ndim(img) == 3:
                return np.ascontiguousarray(np.asarray(img)[:, ::-1])
            return np.ascontiguousarray(img[..., ::-1])
        return img


class RandomCrop:
    """A random ``size`` window of a CHW image (padded first)."""

    def __init__(self, size, padding=0, generator=None):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding
        self.generator = _generator(generator, "RandomCrop")

    def __call__(self, img):
        c, h, w = img.shape
        if self.padding:
            img = np.pad(img, [(0, 0), (self.padding, self.padding), (self.padding, self.padding)])
            h, w = img.shape[1:]
        th, tw = self.size
        i = self.generator.randint(0, h - th + 1)
        j = self.generator.randint(0, w - tw + 1)
        return img[:, i:i + th, j:j + tw]


class Resize:
    """Nearest resize to ``size`` on the host (models that need a quality
    resize do it on the card with ``F.interpolate``)."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def __call__(self, img):
        th, tw = self.size
        chw = _is_chw(img)
        h, w = img.shape[1:3] if chw else img.shape[:2]
        yi = (np.arange(th) * h // th).clip(0, h - 1)
        xi = (np.arange(tw) * w // tw).clip(0, w - 1)
        if chw:
            return img[:, yi][:, :, xi]
        return img[yi][:, xi]


# -- the transforms over vision/functional.py (reference
# vision/transforms/transforms.py)

from . import functional as Fv  # noqa: E402
from .functional import (  # noqa: E402,F401 — functional forms live here too
    adjust_brightness,
    adjust_contrast,
    adjust_hue,
    adjust_saturation,
    affine,
    center_crop,
    crop,
    erase,
    hflip,
    normalize,
    pad,
    perspective,
    resize,
    rotate,
    to_grayscale,
    to_tensor,
    vflip,
)


def _img_hw(img):
    """(h, w) of an image in this pipeline's conventions: Tensors are CHW
    (the vision/functional.py contract, any channel count); ndarrays are HWC
    unless the leading axis looks like 1/3 channels."""
    if isinstance(img, torch.Tensor):
        sh = tuple(img.shape)
        return int(sh[-2]), int(sh[-1])
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        return arr.shape[1], arr.shape[2]
    return arr.shape[0], arr.shape[1]


class BaseTransform:
    """Transform base (reference BaseTransform): keys select which inputs
    get transformed; single-image transforms just implement _apply_image."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, img):
        raise NotImplementedError

    def __call__(self, inputs):
        if isinstance(inputs, tuple):
            out = [self._apply_image(v) if k == "image" else v
                   for k, v in zip(self.keys, inputs)]
            out.extend(inputs[len(self.keys):])  # extras pass through
            return tuple(out)
        return self._apply_image(inputs)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return np.transpose(np.asarray(img), self.order)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return Fv.center_crop(img, self.size)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding, self.fill, self.mode = padding, fill, padding_mode

    def _apply_image(self, img):
        return Fv.pad(img, self.padding, self.fill, self.mode)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.n = num_output_channels

    def _apply_image(self, img):
        return Fv.to_grayscale(img, self.n)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "BrightnessTransform")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = self.generator.uniform(max(0, 1 - self.value), 1 + self.value)
        return Fv.adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "ContrastTransform")
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = self.generator.uniform(max(0, 1 - self.value), 1 + self.value)
        return Fv.adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "SaturationTransform")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = self.generator.uniform(max(0, 1 - self.value), 1 + self.value)
        return Fv.adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "HueTransform")
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return Fv.adjust_hue(img, self.generator.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "ColorJitter")
        self.ts = [BrightnessTransform(brightness, generator=self.generator),
                   ContrastTransform(contrast, generator=self.generator),
                   SaturationTransform(saturation, generator=self.generator),
                   HueTransform(hue, generator=self.generator)]

    def _apply_image(self, img):
        for t in self.generator.permutation(self.ts):
            img = t._apply_image(img)
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "RandomVerticalFlip")
        self.prob = prob

    def _apply_image(self, img):
        if self.generator.rand() < self.prob:
            return Fv.vflip(img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False, center=None, fill=0, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "RandomRotation")
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) else tuple(degrees)
        self.kw = dict(interpolation=interpolation, expand=expand, center=center, fill=fill)

    def _apply_image(self, img):
        angle = self.generator.uniform(*self.degrees)
        return Fv.rotate(img, angle, **self.kw)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None, interpolation="nearest", fill=0, center=None, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "RandomAffine")
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) else tuple(degrees)
        self.translate, self.scale_rng, self.shear = translate, scale, shear
        self.interpolation, self.fill, self.center = interpolation, fill, center

    def _apply_image(self, img):
        h, w = _img_hw(img)
        angle = self.generator.uniform(*self.degrees)
        tx = ty = 0
        if self.translate:
            tx = self.generator.uniform(-self.translate[0], self.translate[0]) * w
            ty = self.generator.uniform(-self.translate[1], self.translate[1]) * h
        sc = self.generator.uniform(*self.scale_rng) if self.scale_rng else 1.0
        if self.shear is None:
            sh = (0, 0)
        elif np.isscalar(self.shear):
            sh = (self.generator.uniform(-self.shear, self.shear), 0)
        else:  # sequence form: (min, max) x-shear, or (xmin, xmax, ymin, ymax)
            s = tuple(self.shear)
            sh = (self.generator.uniform(s[0], s[1]),
                  self.generator.uniform(s[2], s[3]) if len(s) == 4 else 0)
        return Fv.affine(img, angle=angle, translate=(tx, ty), scale=sc, shear=sh,
                         interpolation=self.interpolation, center=self.center, fill=self.fill)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5, interpolation="nearest", fill=0, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "RandomPerspective")
        self.prob, self.d = prob, distortion_scale
        self.interpolation, self.fill = interpolation, fill

    def _apply_image(self, img):
        if self.generator.rand() >= self.prob:
            return img
        h, w = _img_hw(img)
        dx, dy = self.d * w / 2, self.d * h / 2
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(self.generator.uniform(0, dx), self.generator.uniform(0, dy)),
               (w - 1 - self.generator.uniform(0, dx), self.generator.uniform(0, dy)),
               (w - 1 - self.generator.uniform(0, dx), h - 1 - self.generator.uniform(0, dy)),
               (self.generator.uniform(0, dx), h - 1 - self.generator.uniform(0, dy))]
        return Fv.perspective(img, start, end, self.interpolation, self.fill)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), interpolation="bilinear", keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "RandomResizedCrop")
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale, self.ratio, self.interpolation = scale, ratio, interpolation

    def _apply_image(self, img):
        h, w = _img_hw(img)
        area = h * w
        for _ in range(10):
            target = self.generator.uniform(*self.scale) * area
            ar = np.exp(self.generator.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = self.generator.randint(0, h - ch + 1)
                left = self.generator.randint(0, w - cw + 1)
                return Fv.resize(Fv.crop(img, top, left, ch, cw), self.size, self.interpolation)
        return Fv.resize(Fv.center_crop(img, min(h, w)), self.size, self.interpolation)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=0, inplace=False, keys=None, generator=None):
        super().__init__(keys)
        self.generator = _generator(generator, "RandomErasing")
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        if self.generator.rand() >= self.prob:
            return img
        h, w = _img_hw(img)
        area = h * w
        for _ in range(10):
            target = self.generator.uniform(*self.scale) * area
            ar = self.generator.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = self.generator.randint(0, h - eh + 1)
                j = self.generator.randint(0, w - ew + 1)
                return Fv.erase(img, i, j, eh, ew, self.value, self.inplace)
        return img
