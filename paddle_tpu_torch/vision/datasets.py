"""Vision datasets of the port (``paddle_tpu/vision/datasets.py``; parity:
python/paddle/vision/datasets and paddle/dataset).

Nothing is downloaded: ``MNIST`` reads the idx files the caller names
(``image_path``, ``label_path``; gzip), ``Cifar10`` the python-version
archive (``data_file``, ``cifar-10-python.tar.gz``); without them both make
the reference's deterministic synthetic data of the right shapes (from
``RandomState(0)`` for "train", ``RandomState(1)`` otherwise), array for
array the reference's. Samples are numpy arrays; the DataLoader's collate
makes tensors of them.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io.dataset import Dataset


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train", transform=None, download=False, backend=None, synthetic_size=60000):
        self.transform = transform
        self.mode = mode
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(f.read(), np.uint8).reshape(n, 1, rows, cols).astype(np.float32) / 255.0
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        else:
            rng = np.random.RandomState(0 if mode == "train" else 1)
            n = synthetic_size if mode == "train" else synthetic_size // 6
            self.labels = rng.randint(0, 10, n).astype(np.int64)
            # class-dependent blobs so a model can actually learn
            base = rng.randn(10, 1, 28, 28).astype(np.float32)
            noise = rng.randn(n, 1, 28, 28).astype(np.float32) * 0.3
            self.images = base[self.labels] + noise

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar10(Dataset):
    """CIFAR-10 from ``data_file`` (Paddle's archive: pickled
    ``data_batch_*`` for "train", ``test_batch`` otherwise; images f32 CHW
    scaled to [0, 1]), or synthetic."""

    def __init__(self, data_file=None, mode="train", transform=None, download=False, backend=None, synthetic_size=50000):
        if data_file and os.path.exists(data_file):
            import pickle
            import tarfile

            want = "data_batch" if mode == "train" else "test_batch"
            images, labels = [], []
            with tarfile.open(data_file, mode="r") as f:
                for member in sorted(f.getmembers(), key=lambda m: m.name):
                    if want in member.name:
                        batch = pickle.load(f.extractfile(member), encoding="bytes")
                        images.append(np.asarray(batch[b"data"], np.uint8))
                        labels.extend(batch[b"labels"])
            self.images = np.concatenate(images).reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
            self.labels = np.asarray(labels, np.int64)
        else:
            rng = np.random.RandomState(0 if mode == "train" else 1)
            n = synthetic_size if mode == "train" else synthetic_size // 5
            self.labels = rng.randint(0, 10, n).astype(np.int64)
            base = rng.randn(10, 3, 32, 32).astype(np.float32)
            self.images = base[self.labels] + rng.randn(n, 3, 32, 32).astype(np.float32) * 0.3
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)
