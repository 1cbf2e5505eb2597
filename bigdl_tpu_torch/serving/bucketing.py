"""Shape bucketing for the serving engine: a copy of
bigdl_tpu/serving/bucketing.py (numpy only), kept in the port so the
port never imports the JAX package.

The grid maps every request onto a small declared set of padded shapes
so steady-state traffic reuses a fixed set of warmed forwards.

Exactness rule: the BATCH dimension is always safe to pad: padded rows
are sliced off before delivery, and eval-mode forwards are row-local
(BatchNorm uses running stats).  SAMPLE dims are padded only when the
caller *declares* a bucket grid, asserting the model treats the padding
as inert there.  The engine crops outputs back to the request's original
extent along every padded axis.  A shape no declared bucket covers
becomes its own *learned* bucket at the exact sample shape (batch still
padded), counted by the engine's first-sight counter.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class Bucket(NamedTuple):
    """One compiled-forward shape: ``(batch,) + dims``."""

    batch: int
    dims: Tuple[int, ...]


class BucketGrid:
    """Declared batch sizes x sample-dim grid, plus learned strays.

    ``dims_grid`` entries are full padded sample shapes (no batch dim),
    e.g. ``[(8, 16), (16, 16), (32, 16)]`` for sequences of 16-d
    features bucketed at lengths 8/16/32.  All entries must share the
    rank of the traffic they bucket; mixed-rank traffic simply lands in
    learned buckets.
    """

    def __init__(self, dims_grid: Optional[Sequence[Sequence[int]]] = None,
                 batch_sizes: Sequence[int] = (1, 8, 32),
                 pad_value: float = 0.0):
        if not batch_sizes:
            raise ValueError("batch_sizes must be non-empty")
        self.batch_sizes: Tuple[int, ...] = tuple(
            sorted({int(b) for b in batch_sizes}))
        if self.batch_sizes[0] < 1:
            raise ValueError(f"batch sizes must be >= 1: {batch_sizes}")
        # smallest-padding-first so choose_dims takes the tightest cover
        self.dims_grid: Tuple[Tuple[int, ...], ...] = tuple(sorted(
            {tuple(int(v) for v in d) for d in (dims_grid or ())},
            key=lambda d: (int(np.prod(d)), d)))
        self.pad_value = pad_value

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def declared_buckets(self) -> List[Bucket]:
        """Every (batch, dims) combination warmup pre-compiles."""
        return [Bucket(b, d) for d in self.dims_grid
                for b in self.batch_sizes]

    # -- request -> bucket ---------------------------------------------
    def choose_dims(self, shape: Sequence[int]) -> Tuple[Tuple[int, ...],
                                                         bool]:
        """Tightest declared dims covering ``shape`` (fewest padded
        elements), or ``(exact shape, False)`` when nothing covers it —
        a learned bucket."""
        shape = tuple(int(v) for v in shape)
        for dims in self.dims_grid:  # sorted: first cover is tightest
            if len(dims) == len(shape) and all(
                    b >= s for b, s in zip(dims, shape)):
                return dims, True
        return shape, False

    def choose_batch(self, n: int) -> int:
        """Smallest declared batch bucket holding ``n`` rows (callers
        chunk groups larger than ``max_batch``)."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.max_batch

    # -- padding / unpadding -------------------------------------------
    def pad_batch(self, samples: Sequence[np.ndarray],
                  dims: Tuple[int, ...], batch: int,
                  dtype) -> np.ndarray:
        """Place each sample at the origin of its row of a
        ``(batch,) + dims`` buffer filled with ``pad_value``."""
        out = np.full((batch,) + tuple(dims), self.pad_value, dtype=dtype)
        for i, s in enumerate(samples):
            out[(i,) + tuple(slice(0, n) for n in s.shape)] = s
        return out

    @staticmethod
    def _crop_slices(out_shape: Tuple[int, ...],
                     sample_shape: Tuple[int, ...],
                     dims: Tuple[int, ...]) -> Tuple[slice, ...]:
        """Output axis k is cropped back to the request's extent when it
        still carries the padded bucket dim (size match) and the request
        was smaller there; axes the model reshaped away are left alone."""
        sl = []
        for k, size in enumerate(out_shape):
            if (k < len(dims) and k < len(sample_shape)
                    and size == dims[k] and sample_shape[k] < dims[k]):
                sl.append(slice(0, sample_shape[k]))
            else:
                sl.append(slice(None))
        return tuple(sl)

    def unpad(self, out: np.ndarray, sample_shape: Sequence[int],
              dims: Tuple[int, ...]) -> np.ndarray:
        """Crop ONE request's output row back to its original extent."""
        return out[self._crop_slices(out.shape, tuple(sample_shape), dims)]

    def unpad_batch(self, out: np.ndarray, sample_shape: Sequence[int],
                    dims: Tuple[int, ...]) -> np.ndarray:
        """Crop a whole batched output (axis 0 = batch, already sliced
        to the real row count) in one slice."""
        sl = self._crop_slices(out.shape[1:], tuple(sample_shape), dims)
        return out[(slice(None),) + sl]
