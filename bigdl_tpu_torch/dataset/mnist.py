"""MNIST loading (counterpart of bigdl_tpu/dataset/mnist.py; reference
models/lenet/Train.scala reads the idx files).

Reads the idx files (plain or ``.gz``) when a folder holds them, else
makes the JAX package's deterministic synthetic stand-in (a
class-dependent blob plus noise), array for array for the same seed, so
that the drivers of both packages train on the same data.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

TRAIN_MEAN = 0.13066047740239506
TRAIN_STD = 0.3081078


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx_images(path: str) -> np.ndarray:
    """``(n, rows, cols)`` uint8 images of an idx3 file (magic 2051)."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx image magic {magic} in {path}")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    """``(n,)`` uint8 labels of an idx1 file (magic 2049)."""
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx label magic {magic} in {path}")
        return np.frombuffer(f.read(), dtype=np.uint8)[:n]


def synthetic_mnist(n: int = 2048, seed: int = 0, image_size: int = 28
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-separable images: digit k is a gaussian bump
    at a class-specific place plus noise, from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    images = np.zeros((n, image_size, image_size), np.float32)
    for k in range(10):
        cx = 4 + 3 * (k % 4)
        cy = 4 + 5 * (k // 4)
        bump = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 8.0)
        images[labels == k] = bump
    images += 0.1 * rng.randn(n, image_size, image_size).astype(np.float32)
    return images, labels


def load_mnist(folder: Optional[str] = None, train: bool = True,
               synthetic_n: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """``(images, labels)``: NHWC f32 images normalised by
    ``TRAIN_MEAN``/``TRAIN_STD`` and 0-based int32 labels, from the idx
    files under ``folder`` (``train-*`` or ``t10k-*``), else
    ``synthetic_mnist(synthetic_n)`` (seed 0 for training, 1 else)."""
    if folder and os.path.isdir(folder):
        prefix = "train" if train else "t10k"
        for suffix in ("", ".gz"):
            img = os.path.join(folder, f"{prefix}-images-idx3-ubyte{suffix}")
            lab = os.path.join(folder, f"{prefix}-labels-idx1-ubyte{suffix}")
            if os.path.exists(img) and os.path.exists(lab):
                images = _read_idx_images(img).astype(np.float32) / 255.0
                labels = _read_idx_labels(lab).astype(np.int32)
                break
        else:
            raise FileNotFoundError(f"no MNIST idx files under {folder}")
    else:
        images, labels = synthetic_mnist(synthetic_n, seed=0 if train else 1)
    images = (images - TRAIN_MEAN) / TRAIN_STD
    return images[..., None], labels
