"""Multi-branch containers and table arithmetic (counterpart of
bigdl_tpu/nn/table_ops.py).

A table activity is a tuple or list, or a :class:`~bigdl_tpu_torch.
utils.table.Table` read in its key order (integer keys, then string
keys); anything else is a table of one.  Indices are 0-based:
``SelectTable(0)`` is the first entry and ``JoinTable.dimension`` an
axis of the NHWC tensors.  Containers hand child ``i`` the seed
``split_rng(rng, i)``; ``MapTable`` hands its one child ``rng`` itself
for every entry, as the JAX layer does.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import (Container, Module, Seed, call_child)
from bigdl_tpu_torch.utils.table import Table, table_keys


def _as_seq(x):
    if isinstance(x, Table):
        return [x[k] for k in table_keys(x)]
    if isinstance(x, (tuple, list)):
        return list(x)
    return [x]


class Concat(Container):
    """Every child on the same input, the outputs concatenated along
    ``dimension`` (reference nn/Concat)."""

    def __init__(self, dimension: int, *modules: Module, name=None):
        super().__init__(*modules, name=name)
        self.dimension = dimension

    def forward(self, x, rng: Optional[Seed] = None):
        outs = [call_child(self._modules[k], x, rng, i)
                for i, k in enumerate(self._keys)]
        return torch.cat(outs, dim=self.dimension)


class ConcatTable(Container):
    """Every child on the same input, the outputs as a tuple (reference
    nn/ConcatTable)."""

    def forward(self, x, rng: Optional[Seed] = None):
        return tuple(call_child(self._modules[k], x, rng, i)
                     for i, k in enumerate(self._keys))


class ParallelTable(Container):
    """Child ``i`` on entry ``i`` (reference nn/ParallelTable)."""

    def forward(self, inputs, rng: Optional[Seed] = None):
        xs = _as_seq(inputs)
        return tuple(call_child(self._modules[k], xs[i], rng, i)
                     for i, k in enumerate(self._keys))


class MapTable(Container):
    """The one child, shared, on every entry (reference nn/MapTable)."""

    def forward(self, inputs, rng: Optional[Seed] = None):
        child = self._modules[self._keys[0]]
        return tuple(call_child(child, x, rng) for x in _as_seq(inputs))


class _TableReduce(Module):
    def _op(self, a, b):
        raise NotImplementedError

    def forward(self, inputs):
        xs = _as_seq(inputs)
        acc = xs[0]
        for x in xs[1:]:
            acc = self._op(acc, x)
        return acc


class CAddTable(_TableReduce):
    """Elementwise sum of the entries (the residual add)."""

    def _op(self, a, b):
        return a + b


class CMulTable(_TableReduce):
    def _op(self, a, b):
        return a * b


class CSubTable(_TableReduce):
    def _op(self, a, b):
        return a - b


class CDivTable(_TableReduce):
    def _op(self, a, b):
        return a / b


class CMaxTable(_TableReduce):
    def _op(self, a, b):
        return torch.maximum(a, b)


class CMinTable(_TableReduce):
    def _op(self, a, b):
        return torch.minimum(a, b)


class CAveTable(Module):
    """The entries' mean: their sum over their count."""

    def forward(self, inputs):
        xs = _as_seq(inputs)
        return sum(xs) / len(xs)


class JoinTable(Module):
    """The entries concatenated along ``dimension``, a 0-based axis
    (``n_input_dims`` is the reference's and unused)."""

    def __init__(self, dimension: int, n_input_dims: int = -1, name=None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, inputs):
        return torch.cat(_as_seq(inputs), dim=self.dimension)


class SelectTable(Module):
    """Entry ``index`` (0-based; reference nn/SelectTable is 1-based)."""

    def __init__(self, index: int, name=None):
        super().__init__(name)
        self.index = index

    def forward(self, inputs):
        return _as_seq(inputs)[self.index]


class NarrowTable(Module):
    """Entries ``[offset, offset + length)`` as a tuple."""

    def __init__(self, offset: int, length: int = 1, name=None):
        super().__init__(name)
        self.offset, self.length = offset, length

    def forward(self, inputs):
        return tuple(_as_seq(inputs)[self.offset:self.offset + self.length])


class FlattenTable(Module):
    """A nested table flattened to one tuple of tensors, depth first."""

    def forward(self, inputs):
        out = []

        def rec(x):
            if isinstance(x, (tuple, list, Table)):
                for v in _as_seq(x):
                    rec(v)
            else:
                out.append(x)

        rec(inputs)
        return tuple(out)


class SplitTable(Module):
    """A tensor split along ``dimension`` into a tuple of its slices,
    the dim dropped (reference nn/SplitTable)."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        return tuple(torch.unbind(x, dim=self.dimension))


class DotProduct(Module):
    """Row-wise dot product of ``(a, b)``."""

    def forward(self, inputs):
        a, b = _as_seq(inputs)
        return torch.sum(a * b, dim=-1)


class CosineDistance(Module):
    """Row-wise cosine of ``(a, b)``, the norms' product clamped at
    ``eps``."""

    def __init__(self, eps: float = 1e-12, name=None):
        super().__init__(name)
        self.eps = eps

    def forward(self, inputs):
        a, b = _as_seq(inputs)
        na = torch.linalg.vector_norm(a, dim=-1)
        nb = torch.linalg.vector_norm(b, dim=-1)
        return torch.sum(a * b, dim=-1) / torch.clamp_min(na * nb, self.eps)


class MM(Module):
    """Batched matrix product of ``(a, b)``, either transposed first."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 name=None):
        super().__init__(name)
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, inputs):
        a, b = _as_seq(inputs)
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """Batched matrix-vector product of ``(m, v)``."""

    def __init__(self, trans: bool = False, name=None):
        super().__init__(name)
        self.trans = trans

    def forward(self, inputs):
        m, v = _as_seq(inputs)
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class MixtureTable(Module):
    """Gated mixture ``sum_e gate[:, e] * expert_e`` of ``(gate (N, E),
    experts)``, the experts a table or an (N, E, ...) tensor (reference
    nn/MixtureTable)."""

    def forward(self, inputs):
        gate, experts = _as_seq(inputs)[0], _as_seq(inputs)[1]
        if isinstance(experts, (tuple, list)):
            experts = torch.stack(list(experts), dim=1)
        g = gate.reshape(tuple(gate.shape)
                         + (1,) * (experts.dim() - gate.dim()))
        return torch.sum(g * experts, dim=1)


class BifurcateSplitTable(Module):
    """``(left, right)`` halves along ``dimension``, the left holding
    ``size // 2`` slices (reference nn/BifurcateSplitTable.scala)."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        left = x.shape[self.dimension] // 2
        a, b = torch.split(x, [left, x.shape[self.dimension] - left],
                           dim=self.dimension)
        return a, b


class Index(Module):
    """``(tensor, index)``: the tensor's entries at ``index`` (any shape,
    integer) along ``dimension``, as ``jnp.take`` (reference
    nn/Index.scala)."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, inputs):
        t, idx = _as_seq(inputs)[:2]
        d = self.dimension % t.dim()
        idx = idx.long()
        y = torch.index_select(t, d, idx.reshape(-1))
        return y.reshape(tuple(t.shape[:d]) + tuple(idx.shape)
                         + tuple(t.shape[d + 1:]))


class Pack(Module):
    """The entries stacked along a new ``dimension`` (reference
    nn/Pack.scala)."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, inputs):
        return torch.stack(_as_seq(inputs), dim=self.dimension)


class CrossProduct(Module):
    """Pairwise dot products of a table of >= 2 embeddings, (D,) or
    (N, D): columns ``[A.B, A.C, B.C]`` for ``(A, B, C)`` (reference
    nn/CrossProduct.scala)."""

    def __init__(self, num_tensor: int = 0, embedding_size: int = 0,
                 name=None):
        super().__init__(name)
        self.num_tensor = num_tensor
        self.embedding_size = embedding_size

    def forward(self, inputs):
        parts = _as_seq(inputs)
        if self.num_tensor > 0 and len(parts) != self.num_tensor:
            raise ValueError(f"CrossProduct: got {len(parts)} tensors, "
                             f"expected {self.num_tensor}")
        parts = [p[None] if p.dim() == 1 else p for p in parts]
        if (self.embedding_size > 0
                and parts[0].shape[-1] != self.embedding_size):
            raise ValueError(f"CrossProduct: embedding size "
                             f"{parts[0].shape[-1]} != {self.embedding_size}")
        cols = [torch.sum(parts[i] * parts[j], dim=-1)
                for i in range(len(parts)) for j in range(i + 1, len(parts))]
        return torch.stack(cols, dim=-1)


class MaskedSelect(Module):
    """``(tensor, mask)``: the entries where ``mask`` holds, flat
    (reference nn/MaskedSelect.scala).  Their count depends on the data,
    so that form runs eagerly only.  With ``pad_to`` the output is
    ``(pad_to,)``: the selected entries first, in order, then the rest
    as ``fill_value`` (a stable sort of the mask), the form a CUDA graph
    can hold (bigdl_tpu/nn/table_ops.py:341-355)."""

    def __init__(self, pad_to: Optional[int] = None, fill_value=0.0,
                 name=None):
        super().__init__(name)
        self.pad_to = pad_to
        self.fill_value = fill_value

    def forward(self, inputs):
        t, mask = _as_seq(inputs)[:2]
        mask = mask.to(torch.bool)
        if self.pad_to is None:
            return t[mask]
        flat_t, flat_m = t.reshape(-1), mask.reshape(-1)
        order = torch.argsort((~flat_m).to(torch.int8), stable=True)
        fill = torch.tensor(self.fill_value, dtype=t.dtype, device=t.device)
        vals = torch.where(flat_m[order], flat_t[order], fill)
        n = flat_t.shape[0]
        if self.pad_to <= n:
            return vals[:self.pad_to]
        return torch.cat([vals, fill.expand(self.pad_to - n)])


class PairwiseDistance(Module):
    """The ``norm``-distance of ``(x1, x2)`` per row (reference
    nn/PairwiseDistance.scala); 1e-12 inside the root (p = 2) or added
    to each ``|d|`` (other p), as the JAX layer."""

    def __init__(self, norm: int = 2, name=None):
        super().__init__(name)
        self.norm = norm

    def forward(self, inputs):
        a, b = _as_seq(inputs)[:2]
        d = a - b
        if d.dim() == 1:
            d = d[None]
        eps = torch.tensor(1e-12, dtype=d.dtype, device=d.device)
        if self.norm == 1:
            return torch.sum(torch.abs(d), dim=-1)
        if self.norm == 2:
            return torch.sqrt(torch.sum(d * d, dim=-1) + eps)
        p = float(self.norm)
        return torch.pow(torch.sum(torch.pow(torch.abs(d) + eps, p), dim=-1),
                         1.0 / p)


class TableOperation(Module):
    """The smaller of two entries broadcast to the larger's shape, then
    ``operation_layer`` (a table layer such as CMulTable) on the pair
    (reference nn/TableOperation.scala)."""

    def __init__(self, operation_layer: Module, name=None):
        super().__init__(name)
        self.operation_layer = operation_layer

    def forward(self, inputs, rng: Optional[Seed] = None):
        a, b = _as_seq(inputs)[:2]
        if a.numel() < b.numel():
            a = torch.broadcast_to(a, b.shape)
        elif b.numel() < a.numel():
            b = torch.broadcast_to(b, a.shape)
        return call_child(self.operation_layer, (a, b), rng)


class Bottle(Container):
    """The leading dims of the input fused into one batch dim so that an
    ``n_input_dim``-D module can run, then restored (reference
    nn/Bottle.scala)."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: Optional[int] = None, name=None):
        super().__init__(module, name=name)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim or n_input_dim

    def forward(self, x, rng: Optional[Seed] = None):
        lead = x.dim() - self.n_input_dim + 1
        flat = x.reshape((-1,) + tuple(x.shape[lead:]))
        out = call_child(self._modules[self._keys[0]], flat, rng, 0)
        return out.reshape(tuple(x.shape[:lead]) + tuple(out.shape[1:]))
