"""The port's image functionals, transforms and datasets
(``paddle_tpu_torch.vision.{functional,transforms,datasets}``) against
``paddle_tpu.vision``'s on the same numpy images, on the CPU.

Tolerances: deterministic ops give uint8 images exactly and float images
within 1e-6 (the same numpy arithmetic on both sides; a CHW tensor goes
through the reference's JAX array and the port's torch tensor). The random
transforms are handed a ``numpy.random.RandomState`` seeded as the
reference's global stream, so they draw the same numbers and give the same
images (exactly, or within 1e-6 for float). The synthetic datasets are the
same arrays. Where the port departs from the reference on HWC arrays
(``Normalize``'s ``data_format``, ``RandomHorizontalFlip`` and ``Resize``),
it is held to numpy written out here.
"""
import gzip
import io
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.vision import datasets as rds
from paddle_tpu.vision import functional as rF
from paddle_tpu.vision import transforms as rT

from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import functional as pF
from paddle_tpu_torch.vision import transforms as pT

FLOAT = dict(rtol=1e-6, atol=1e-6)


def _image(dtype, shape=(12, 16, 3), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.random(shape).astype(np.float32)


def _out(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _same(got, want):
    got, want = _out(got), _out(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **FLOAT)


FUNCTIONAL_CASES = {
    "hflip": lambda F, x: F.hflip(x),
    "vflip": lambda F, x: F.vflip(x),
    "normalize_hwc": lambda F, x: F.normalize(x, [0.4, 0.5, 0.6], [0.2, 0.3, 0.4], "HWC"),
    "crop": lambda F, x: F.crop(x, 2, 3, 5, 7),
    "center_crop": lambda F, x: F.center_crop(x, (6, 9)),
    "resize_bilinear_short": lambda F, x: F.resize(x, 9),
    "resize_bilinear_hw": lambda F, x: F.resize(x, (20, 7)),
    "resize_nearest": lambda F, x: F.resize(x, (7, 21), "nearest"),
    "pad_constant": lambda F, x: F.pad(x, 2, fill=3),
    "pad_two": lambda F, x: F.pad(x, (1, 3), padding_mode="edge"),
    "pad_reflect": lambda F, x: F.pad(x, (1, 2, 3, 4), padding_mode="reflect"),
    "pad_symmetric": lambda F, x: F.pad(x, (2, 1, 0, 3), padding_mode="symmetric"),
    "brightness": lambda F, x: F.adjust_brightness(x, 1.3),
    "contrast": lambda F, x: F.adjust_contrast(x, 0.6),
    "saturation": lambda F, x: F.adjust_saturation(x, 1.7),
    "hue": lambda F, x: F.adjust_hue(x, 0.2),
    "grayscale": lambda F, x: F.to_grayscale(x, 3),
    "erase": lambda F, x: F.erase(x, 2, 3, 4, 5, 7),
    "rotate": lambda F, x: F.rotate(x, 30),
    "rotate_bilinear_expand": lambda F, x: F.rotate(x, 47, "bilinear", expand=True, fill=9),
    "rotate_center": lambda F, x: F.rotate(x, -20, center=(3, 4)),
    "affine": lambda F, x: F.affine(x, 15, (2, -1), 1.2, (10, 5)),
    "affine_bilinear": lambda F, x: F.affine(x, -30, (0, 3), 0.8, (0, 0), "bilinear"),
    "perspective": lambda F, x: F.perspective(x, [(0, 0), (15, 0), (15, 11), (0, 11)],
                                              [(2, 1), (13, 0), (15, 10), (1, 11)]),
}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", sorted(FUNCTIONAL_CASES))
def test_functional_on_hwc_arrays(name, dtype):
    fn = FUNCTIONAL_CASES[name]
    x = _image(dtype)
    _same(fn(pF, x.copy()), fn(rF, x.copy()))


@pytest.mark.parametrize("name", ["hflip", "vflip", "crop", "center_crop", "resize_bilinear_hw",
                                  "resize_nearest", "pad_reflect", "brightness", "hue",
                                  "grayscale", "erase", "rotate", "affine", "perspective"])
def test_functional_on_chw_tensors(name):
    fn = FUNCTIONAL_CASES[name]
    x = np.ascontiguousarray(_image("float32").transpose(2, 0, 1))
    got = fn(pF, torch.from_numpy(x.copy()))
    assert isinstance(got, torch.Tensor)
    _same(got, fn(rF, ref.to_tensor(x)))


def test_to_tensor():
    for dtype in ("uint8", "float32"):
        x = _image(dtype)
        for fmt in ("CHW", "HWC"):
            got = pF.to_tensor(x, fmt)
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            _same(got, rF.to_tensor(x, fmt))
    _same(pF.to_tensor(_image("uint8", (5, 6))), rF.to_tensor(_image("uint8", (5, 6))))


DETERMINISTIC = {
    "compose": lambda T: T.Compose([T.Transpose(), T.Normalize([10, 20, 30], [2, 3, 4])]),
    "to_tensor": lambda T: T.ToTensor(),
    "transpose": lambda T: T.Transpose((2, 1, 0)),
    "center_crop": lambda T: T.CenterCrop(7),
    "pad": lambda T: T.Pad((1, 2), fill=4),
    "grayscale": lambda T: T.Grayscale(3),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_transforms(name):
    for dtype in ("uint8", "float32"):
        x = _image(dtype)
        _same(DETERMINISTIC[name](pT)(x), DETERMINISTIC[name](rT)(x))


def test_chw_legacy_transforms_and_the_hwc_repairs():
    chw = np.ascontiguousarray(_image("float32").transpose(2, 0, 1))
    _same(pT.Normalize([0.1, 0.2, 0.3], [0.5, 0.6, 0.7])(chw),
          rT.Normalize([0.1, 0.2, 0.3], [0.5, 0.6, 0.7])(chw))
    _same(pT.Resize((5, 21))(chw), rT.Resize((5, 21))(chw))
    # HWC: the port normalizes per channel, flips and resizes height and width
    hwc = _image("uint8")
    mean, std = np.float32([10, 20, 30]), np.float32([2, 3, 4])
    _same(pT.Normalize(mean, std, data_format="HWC")(hwc), (hwc.astype(np.float32) - mean) / std)
    _same(pT.RandomHorizontalFlip(prob=1.0, generator=0)(hwc), hwc[:, ::-1])
    yi, xi = np.arange(5) * 12 // 5, np.arange(21) * 16 // 21
    _same(pT.Resize((5, 21))(hwc), hwc[yi][:, xi])


RANDOM = {
    "hflip": (lambda T, g: T.RandomHorizontalFlip(**g), "chw"),
    "random_crop": (lambda T, g: T.RandomCrop(5, padding=2, **g), "chw"),
    "brightness": (lambda T, g: T.BrightnessTransform(0.4, **g), "hwc"),
    "contrast": (lambda T, g: T.ContrastTransform(0.4, **g), "hwc"),
    "saturation": (lambda T, g: T.SaturationTransform(0.4, **g), "hwc"),
    "hue": (lambda T, g: T.HueTransform(0.3, **g), "hwc"),
    "color_jitter": (lambda T, g: T.ColorJitter(0.3, 0.3, 0.3, 0.2, **g), "hwc"),
    "vflip": (lambda T, g: T.RandomVerticalFlip(**g), "hwc"),
    "rotation": (lambda T, g: T.RandomRotation(40, **g), "hwc"),
    "affine": (lambda T, g: T.RandomAffine(20, (0.1, 0.2), (0.8, 1.2), (-5, 5, -3, 3), **g), "hwc"),
    "affine_scalar_shear": (lambda T, g: T.RandomAffine(10, shear=8, **g), "hwc"),
    "perspective": (lambda T, g: T.RandomPerspective(0.7, 0.4, **g), "hwc"),
    "resized_crop": (lambda T, g: T.RandomResizedCrop(8, **g), "hwc"),
    "erasing": (lambda T, g: T.RandomErasing(0.8, value=3, **g), "hwc"),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_transforms_draw_the_reference_stream(name, seed):
    make, layout = RANDOM[name]
    for dtype in ("uint8", "float32"):
        x = _image(dtype)
        if layout == "chw":
            x = np.ascontiguousarray(x.transpose(2, 0, 1))
        np.random.seed(seed)
        r = make(rT, {})
        want = [r(x.copy()) for _ in range(4)]
        p = make(pT, {"generator": np.random.RandomState(seed)})
        for g, w in zip([p(x.copy()) for _ in range(4)], want):
            _same(g, w)


def test_a_pipeline_sharing_one_generator():
    x = _image("uint8", (40, 48, 3))
    np.random.seed(9)
    r = rT.Compose([rT.RandomResizedCrop(16), rT.ColorJitter(0.2, 0.2, 0.2, 0.1),
                    rT.Transpose(), rT.RandomHorizontalFlip()])
    want = [r(x) for _ in range(3)]
    g = np.random.RandomState(9)
    p = pT.Compose([pT.RandomResizedCrop(16, generator=g), pT.ColorJitter(0.2, 0.2, 0.2, 0.1,
                                                                        generator=g),
                    pT.Transpose(), pT.RandomHorizontalFlip(generator=g)])
    for got, w in zip([p(x) for _ in range(3)], want):
        _same(got, w)


def test_synthetic_datasets_are_the_reference():
    for mode in ("train", "test"):
        for P, R, n in ((pds.MNIST, rds.MNIST, 60), (pds.Cifar10, rds.Cifar10, 50)):
            p, r = P(mode=mode, synthetic_size=n), R(mode=mode, synthetic_size=n)
            assert len(p) == len(r)
            np.testing.assert_array_equal(p.images, r.images)
            np.testing.assert_array_equal(p.labels, r.labels)
            for i in (0, len(r) - 1):
                for a, b in zip(p[i], r[i]):
                    np.testing.assert_array_equal(a, b)
    t = pds.MNIST(mode="test", synthetic_size=24, transform=lambda im: im * 2)
    np.testing.assert_array_equal(t[3][0], t.images[3] * 2)


def test_datasets_read_named_files(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    with gzip.open(tmp_path / "img.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(tmp_path / "lbl.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    p = pds.MNIST(str(tmp_path / "img.gz"), str(tmp_path / "lbl.gz"))
    r = rds.MNIST(str(tmp_path / "img.gz"), str(tmp_path / "lbl.gz"))
    np.testing.assert_array_equal(p.images, r.images)
    np.testing.assert_array_equal(p.labels, r.labels)
    # CIFAR-10's python archive: the train batches in name order
    batches = {f"cifar-10-batches-py/data_batch_{i}": rng.integers(0, 256, (2, 3072)).astype(
        np.uint8) for i in (2, 1)}
    batches["cifar-10-batches-py/test_batch"] = rng.integers(0, 256, (3, 3072)).astype(np.uint8)
    with tarfile.open(tmp_path / "cifar.tar.gz", "w:gz") as tar:
        for name, data in batches.items():
            blob = pickle.dumps({b"data": data, b"labels": list(range(len(data)))})
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    train = pds.Cifar10(str(tmp_path / "cifar.tar.gz"))
    want = np.concatenate([batches[f"cifar-10-batches-py/data_batch_{i}"] for i in (1, 2)])
    np.testing.assert_array_equal(train.images, want.reshape(-1, 3, 32, 32) / np.float32(255))
    assert train.labels.tolist() == [0, 1, 0, 1] and len(pds.Cifar10(
        str(tmp_path / "cifar.tar.gz"), mode="test")) == 3
