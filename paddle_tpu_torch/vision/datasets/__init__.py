"""Vision datasets (port of paddle_tpu/vision/datasets/__init__.py:
``_SyntheticImageClasses``, MNIST and Cifar10).

Each loads local files when they are there (``~/.cache/paddle_tpu/
datasets`` or an explicit path) and otherwise falls back to the
reference's deterministic synthetic generator: a fixed random template a
class, each sample its template plus 0.25 x normal noise, clipped to
[0, 1], drawn with numpy's ``RandomState`` from the same seeds, so the
port's samples are the reference's, bit for bit.  Nothing is downloaded.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ...io import Dataset

_CACHE = os.path.expanduser("~/.cache/paddle_tpu/datasets")


class _SyntheticImageClasses(Dataset):
    """Learnable synthetic images: ``num_classes`` templates from
    ``template_seed``; labels and each sample's noise seed from
    ``sample_seed``."""

    def __init__(self, num_samples, image_shape, num_classes,
                 template_seed=0, sample_seed=1, transform=None):
        rng = np.random.RandomState(template_seed)
        self.templates = rng.rand(num_classes, *image_shape).astype(
            np.float32)
        self.num_samples = num_samples
        self.num_classes = num_classes
        self.image_shape = image_shape
        self.transform = transform
        self._rng = np.random.RandomState(sample_seed)
        self.labels = self._rng.randint(0, num_classes, num_samples)
        self.noise_seeds = self._rng.randint(0, 2 ** 31 - 1, num_samples)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        label = int(self.labels[idx])
        rng = np.random.RandomState(self.noise_seeds[idx])
        img = self.templates[label] + 0.25 * rng.randn(
            *self.image_shape).astype(np.float32)
        img = np.clip(img, 0.0, 1.0)
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), np.asarray(label, np.int64)


class MNIST(Dataset):
    """MNIST from local idx files if present, else 2048 (train) or 512
    (test) synthetic 28 x 28 samples of 10 classes; images [1, 28, 28]
    float32 in [0, 1], labels int64."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        img_name = ("train-images-idx3-ubyte.gz" if mode == "train"
                    else "t10k-images-idx3-ubyte.gz")
        lbl_name = ("train-labels-idx1-ubyte.gz" if mode == "train"
                    else "t10k-labels-idx1-ubyte.gz")
        image_path = image_path or os.path.join(_CACHE, "mnist", img_name)
        label_path = label_path or os.path.join(_CACHE, "mnist", lbl_name)
        if os.path.exists(image_path) and os.path.exists(label_path):
            self.images, self.labels = self._load_idx(image_path, label_path)
            self.synthetic = False
        else:
            # the templates are shared across splits; the samples differ
            self._synth = _SyntheticImageClasses(
                2048 if mode == "train" else 512, (28, 28), 10,
                template_seed=0, sample_seed=1 if mode == "train" else 2)
            self.synthetic = True

    @staticmethod
    def _load_idx(image_path, label_path):
        opener = gzip.open if image_path.endswith(".gz") else open
        with opener(image_path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
        with opener(label_path, "rb") as f:
            _, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        return images, labels

    def __len__(self):
        return len(self._synth) if self.synthetic else len(self.images)

    def __getitem__(self, idx):
        if self.synthetic:
            img, label = self._synth[idx]
        else:
            img = self.images[idx].astype(np.float32) / 255.0
            label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        if img.ndim == 2:
            img = img[None]
        return img.astype(np.float32), np.asarray(label, np.int64)


class Cifar10(Dataset):
    """CIFAR-10 from local pickled batches if present, else 2048 (train)
    or 512 (test) synthetic [3, 32, 32] samples of 10 classes."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        path = data_file or os.path.join(_CACHE, "cifar10")
        self.num_classes = 10
        if os.path.isdir(path):
            batches = ([f"data_batch_{i}" for i in range(1, 6)]
                       if mode == "train" else ["test_batch"])
            imgs, labels = [], []
            for b in batches:
                with open(os.path.join(path, b), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                imgs.append(d[b"data"].reshape(-1, 3, 32, 32))
                labels.extend(d[b"labels"])
            self.images = np.concatenate(imgs).astype(np.float32) / 255.0
            self.labels = np.asarray(labels, np.int64)
            self.synthetic = False
        else:
            self._synth = _SyntheticImageClasses(
                2048 if mode == "train" else 512, (3, 32, 32), 10,
                template_seed=5, sample_seed=1 if mode == "train" else 2)
            self.synthetic = True

    def __len__(self):
        return len(self._synth) if self.synthetic else len(self.images)

    def __getitem__(self, idx):
        if self.synthetic:
            img, label = self._synth[idx]
        else:
            img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), np.asarray(label, np.int64)
