"""CIFAR-10 loading (counterpart of bigdl_tpu/dataset/cifar.py;
BigDL's models/vgg/Train.scala trains from the CIFAR binary).

Reads both public layouts:

* binary (``cifar-10-batches-bin``): 10000 records a file of ``1 label
  byte + 3072 CHW pixel bytes`` (data_batch_{1..5}.bin, test_batch.bin);
* python (``cifar-10-batches-py``): pickled batches with ``data``
  (N, 3072) uint8 and ``labels``.

Without a folder, a seeded synthetic stand-in (a class-dependent colour
blob plus noise) takes their place.  Returns NHWC float32 RGB in [0, 1]
and int64 labels.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

# per-channel statistics of the real training set (public values),
# used by the normalization stage of the training drivers
TRAIN_MEAN = (0.4914, 0.4822, 0.4465)
TRAIN_STD = (0.2470, 0.2435, 0.2616)


def _from_records(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    rec = raw.reshape(-1, 3073)
    labels = rec[:, 0].astype(np.int64)
    images = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images.astype(np.float32) / 255.0, labels


def synthetic_cifar10(n: int = 2048, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-separable 32x32 RGB: class k gets a color blob at a
    class-specific location plus noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    images = np.zeros((n, 32, 32, 3), np.float32)
    for k in range(10):
        cx, cy = 6 + 5 * (k % 4), 6 + 7 * (k // 4)
        bump = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 18.0)
        color = np.asarray([(k % 3 == 0), (k % 3 == 1), (k % 3 == 2)],
                           np.float32) * 0.8 + 0.2
        mask = labels == k
        images[mask] = bump[..., None] * color
    images += 0.08 * rng.randn(n, 32, 32, 3).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels


def load_cifar10(folder: Optional[str] = None, train: bool = True,
                 synthetic_n: int = 2048,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    if folder is None:
        return synthetic_cifar10(synthetic_n, seed + (0 if train else 1))
    for sub in ("", "cifar-10-batches-bin", "cifar-10-batches-py"):
        root = os.path.join(folder, sub) if sub else folder
        bin_names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                     if train else ["test_batch.bin"])
        if os.path.exists(os.path.join(root, bin_names[0])):
            raws = [np.fromfile(os.path.join(root, nm), np.uint8)
                    for nm in bin_names]
            return _from_records(np.concatenate(raws))
        py_names = ([f"data_batch_{i}" for i in range(1, 6)]
                    if train else ["test_batch"])
        if os.path.exists(os.path.join(root, py_names[0])):
            xs, ys = [], []
            for nm in py_names:
                with open(os.path.join(root, nm), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(np.asarray(d[b"data"], np.uint8))
                ys.append(np.asarray(d[b"labels"], np.int64))
            images = (np.concatenate(xs).reshape(-1, 3, 32, 32)
                      .transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
            return images, np.concatenate(ys)
    raise FileNotFoundError(
        f"no CIFAR-10 batches (bin or py layout) under {folder!r}")
