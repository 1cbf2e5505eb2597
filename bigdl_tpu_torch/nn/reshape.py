"""Shape layers (counterpart of bigdl_tpu/nn/reshape.py).

Axis arguments are 0-based, as in the JAX package (the reference's are
1-based).  ``Flatten`` flattens NHWC rows, so a Linear after it reads
its input in H, W, C order.  Constants are applied in x's type, as
JAX's weakly typed Python scalars are.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


def _scalar(v, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


class SpaceToDepth(Module):
    """NHWC (N, H, W, C) -> (N, H/b, W/b, b*b*C): each b x b block folds
    into channels (bigdl_tpu/nn/reshape.py:17)."""

    def __init__(self, block: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.block = block

    def forward(self, x):
        n, h, w, c = x.shape
        b = self.block
        if h % b or w % b:
            raise ValueError(f"SpaceToDepth({b}): spatial dims ({h}, {w}) "
                             "must be divisible by the block size")
        x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // b, w // b, b * b * c)


class DepthToSpace(Module):
    """The inverse of :class:`SpaceToDepth`."""

    def __init__(self, block: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.block = block

    def forward(self, x):
        n, h, w, c = x.shape
        b = self.block
        if c % (b * b):
            raise ValueError(f"DepthToSpace({b}): channels ({c}) must be "
                             "divisible by block*block")
        x = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h * b, w * b, c // (b * b))


class Reshape(Module):
    """The non-batch dims reshaped to ``size`` (the whole tensor without
    ``batch_mode``); -1 is inferred."""

    def __init__(self, size: Sequence[int], batch_mode: bool = True,
                 name=None):
        super().__init__(name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.batch_mode:
            return torch.reshape(x, (x.shape[0],) + self.size)
        return torch.reshape(x, self.size)


class View(Reshape):
    """Alias of :class:`Reshape` (reference nn/View)."""


InferReshape = Reshape


class Flatten(Module):
    """(N, ...) -> (N, prod(...)), row-major over the NHWC dims."""

    def forward(self, x):
        return torch.reshape(x, (x.shape[0], -1))


class Squeeze(Module):
    """Drops ``dim`` (every size-1 dim when None)."""

    def __init__(self, dim: Optional[int] = None, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        if self.dim is None:
            return torch.squeeze(x)
        if x.shape[self.dim] != 1:
            raise ValueError(f"Squeeze: dim {self.dim} of shape "
                             f"{tuple(x.shape)} is not 1")
        return torch.squeeze(x, self.dim)


class Unsqueeze(Module):
    def __init__(self, dim: int, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return torch.unsqueeze(x, self.dim)


class Transpose(Module):
    """Swaps the listed axis pairs in order (reference nn/Transpose)."""

    def __init__(self, permutations: Sequence[Tuple[int, int]], name=None):
        super().__init__(name)
        self.permutations = [tuple(p) for p in permutations]

    def forward(self, x):
        axes = list(range(x.dim()))
        for a, b in self.permutations:
            axes[a], axes[b] = axes[b], axes[a]
        return x.permute(axes)


class Permute(Module):
    """Permutes the non-batch dims by ``dims`` (0-based over them)."""

    def __init__(self, dims: Sequence[int], name=None):
        super().__init__(name)
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute((0,) + tuple(d + 1 for d in self.dims))


class Select(Module):
    """Index ``index`` along ``dim``, the dim dropped (reference
    nn/Select)."""

    def __init__(self, dim: int, index: int, name=None):
        super().__init__(name)
        self.dim, self.index = dim, index

    def forward(self, x):
        return torch.select(x, self.dim, self.index)


class Narrow(Module):
    """``length`` entries from ``offset`` along ``dim``; a negative
    length counts from the end (reference nn/Narrow)."""

    def __init__(self, dim: int, offset: int, length: int = 1, name=None):
        super().__init__(name)
        self.dim, self.offset, self.length = dim, offset, length

    def forward(self, x):
        length = self.length
        if length < 0:
            length = x.shape[self.dim] - self.offset + length + 1
        idx = [slice(None)] * x.dim()
        idx[self.dim] = slice(self.offset, self.offset + length)
        return x[tuple(idx)]


class Replicate(Module):
    """A new dim of size ``n_features`` at ``dim`` (reference
    nn/Replicate)."""

    def __init__(self, n_features: int, dim: int = 0, name=None):
        super().__init__(name)
        self.n_features, self.dim = n_features, dim

    def forward(self, x):
        y = torch.unsqueeze(x, self.dim)
        reps = [1] * y.dim()
        reps[self.dim] = self.n_features
        return y.repeat(reps)


class Padding(Module):
    """``|pad|`` entries of ``value`` along ``dim``, after the data, or
    before it when ``pad`` is negative (reference nn/Padding)."""

    def __init__(self, dim: int, pad: int, value: float = 0.0, name=None):
        super().__init__(name)
        self.dim, self.pad, self.value = dim, pad, value

    def forward(self, x):
        widths = [(0, 0)] * x.dim()
        widths[self.dim] = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        return _pad(x, widths, self.value)


def _pad(x, widths, value):
    """``jnp.pad(x, widths, constant_values=value)``."""
    flat = [v for lo, hi in reversed(widths) for v in (lo, hi)]
    return F.pad(x, flat, value=value)


class Contiguous(Module):
    def forward(self, x):
        return x.contiguous()


class MulConstant(Module):
    """``x * scalar``, the scalar rounded to x's type first, as JAX's
    weakly typed product (bigdl_tpu/nn/reshape.py:237)."""

    def __init__(self, scalar: float, name: Optional[str] = None):
        super().__init__(name)
        self.scalar = scalar

    def forward(self, x):
        return x * _scalar(self.scalar, x)


class AddConstant(Module):
    def __init__(self, constant_scalar: float, name=None):
        super().__init__(name)
        self.constant_scalar = constant_scalar

    def forward(self, x):
        return x + _scalar(self.constant_scalar, x)


class Sum(Module):
    """The sum over ``dimension``, kept as a size-1 axis unless
    ``squeeze``."""

    def __init__(self, dimension: int = 0, squeeze: bool = True, name=None):
        super().__init__(name)
        self.dimension, self.squeeze = dimension, squeeze

    def forward(self, x):
        return x.sum(self.dimension, keepdim=not self.squeeze)


class Mean(Module):
    """The mean over ``dimension``, kept as a size-1 axis unless
    ``squeeze`` (bigdl_tpu/nn/reshape.py:264-270)."""

    def __init__(self, dimension: int = 0, squeeze: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dimension, self.squeeze = dimension, squeeze

    def forward(self, x):
        return x.mean(self.dimension, keepdim=not self.squeeze)


class Max(Module):
    def __init__(self, dim: int, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return torch.amax(x, dim=self.dim)


class Min(Module):
    def __init__(self, dim: int, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return torch.amin(x, dim=self.dim)


class ZeroPaddingND(Module):
    """Constant padding, ``pads`` a ``(before, after)`` pair per dim."""

    def __init__(self, pads, value: float = 0.0, name=None):
        super().__init__(name)
        self.pads = [tuple(int(v) for v in p) for p in pads]
        self.value = value

    def forward(self, x):
        return _pad(x, self.pads, self.value)


class Tile(Module):
    """``copies`` repeats along ``dim`` (reference nn/Tile.scala)."""

    def __init__(self, dim: int = 0, copies: int = 2, name=None):
        super().__init__(name)
        self.dim = dim
        self.copies = copies

    def forward(self, x):
        reps = [1] * x.dim()
        reps[self.dim] = self.copies
        return x.repeat(reps)


class Reverse(Module):
    """Reversed along ``dim`` (reference nn/Reverse.scala)."""

    def __init__(self, dim: int = 0, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return torch.flip(x, (self.dim,))


class ExpandSize(Module):
    """Size-1 dims broadcast to ``target_sizes`` (-1 keeps a dim;
    reference nn/ExpandSize.scala)."""

    def __init__(self, target_sizes, name=None):
        super().__init__(name)
        self.target_sizes = tuple(int(s) for s in target_sizes)

    def forward(self, x):
        if len(self.target_sizes) != x.dim():
            raise ValueError(f"ExpandSize: target rank "
                             f"{len(self.target_sizes)} != input rank "
                             f"{x.dim()}")
        tgt = []
        for have, want in zip(x.shape, self.target_sizes):
            if want == -1 or want == have:
                tgt.append(have)
            elif have == 1:
                tgt.append(want)
            else:
                raise ValueError(f"ExpandSize: cannot expand dim of size "
                                 f"{have} to {want}")
        return x.expand(tuple(tgt))
