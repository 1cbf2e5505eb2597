"""Module base of the port (counterpart of bigdl_tpu/nn/module.py).

The JAX package keeps parameters in explicit ``{"params", "state"}``
pytrees threaded through a pure ``apply``.  Here they live on
``torch.nn.Module``s under the same leaf names (``weight``, ``bias``,
``running_mean``, ``running_var``) and the same child keys, so the JAX
tree of a model and the port's ``named_parameters``/``named_buffers``
differ only in the path separator.

``train()``/``eval()`` choose the forward as ``training=True/False``
chooses it in the JAX ``apply``; the modules that keep running statistics
(BatchNorm, the fused blocks) update their buffers in place during a
training forward, where the JAX package returns new state.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch

_MASK64 = (1 << 64) - 1
_M1, _M2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB

#: a random seed: a Python int, or a 0-dim int64 tensor holding its low
#: 64 bits (the form a CUDA graph replays with new values)
Seed = Union[int, torch.Tensor]


def _signed(v: int) -> int:
    """The int64 whose bits are ``v``'s low 64 bits."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    z = ((z ^ (z >> 30)) * _M1) & _MASK64
    z = ((z ^ (z >> 27)) * _M2) & _MASK64
    return z ^ (z >> 31)


def _lsr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` by ``s`` (torch's is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(z: torch.Tensor) -> torch.Tensor:
    """:func:`_mix64` on the bits of an int64 tensor, elementwise: the
    products wrap modulo 2**64 as the unsigned ones do."""
    z = (z ^ _lsr(z, 30)) * _signed(_M1)
    z = (z ^ _lsr(z, 27)) * _signed(_M2)
    return z ^ _lsr(z, 31)


def split_rng(rng: Optional[Seed], i: int) -> Optional[Seed]:
    """The seed of stream ``i`` derived from the seed ``rng``, as
    ``jax.random.fold_in(rng, i)`` derives a key (bigdl_tpu/nn/module.py:
    37-40); ``None`` stays ``None``.  The port's random streams are
    seeds that dropout hashes into masks (:mod:`bigdl_tpu_torch.nn.dropout`);
    the result is a 63-bit seed.

    An int gives an int.  A 0-dim int64 tensor gives one on its device,
    computed by tensor ops with the same bits: the JAX key is a traced
    value, and this form is data to a CUDA graph, so a captured step
    draws new streams from every seed it is replayed with."""
    if rng is None:
        return None
    if torch.is_tensor(rng):
        return _lsr(mix64(mix64(rng) + (i + 1)), 1)
    return _mix64((_mix64(rng & _MASK64) + i + 1) & _MASK64) >> 1


class Module(torch.nn.Module):
    """Base of every layer and container: a ``torch.nn.Module`` with a
    BigDL ``name`` (the default is the class name, as in the JAX
    package) and graph-building sugar."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self._bigdl_name = name or type(self).__name__

    @property
    def name(self) -> str:
        return self._bigdl_name

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """(Re)initialise this module's own parameters; containers leave
        their children to :meth:`initialize`."""

    def initialize(self, generator: Optional[torch.Generator] = None
                   ) -> "Module":
        """Initialise every parameter of this module and its
        descendants in registration order from ``generator`` (a CPU
        ``torch.Generator``; ``None`` uses torch's global RNG)."""
        for m in self.modules():
            if isinstance(m, Module):
                m.reset_parameters(generator)
        return self

    def inputs(self, *nodes):
        """``node = module.inputs(n1, n2, ...)`` (bigdl_tpu/nn/graph.py)."""
        from bigdl_tpu_torch.nn.graph import Node

        return Node(self, list(nodes))

    def extra_repr(self) -> str:
        return f"name={self._bigdl_name!r}"


class Container(Module):
    """A module owning an ordered list of keyed children.

    Keys follow bigdl_tpu/nn/module.py:267-278: an explicit name, else
    the stringified position, with ``_<position>`` appended on a clash.
    """

    def __init__(self, *modules: Module, name: Optional[str] = None):
        super().__init__(name)
        self._keys: List[str] = []
        for m in modules:
            self.add(m)

    def add(self, module: Module) -> "Container":
        key = (module.name if module.name != type(module).__name__
               else str(len(self._keys)))
        if key in self._keys:
            key = f"{key}_{len(self._keys)}"
        self._register_child(key, module)
        return self

    def _register_child(self, key: str, module: Module):
        self.add_module(key, module)
        self._keys.append(key)

    @property
    def child_keys(self) -> List[str]:
        return list(self._keys)

    def replace_child(self, key: str, module: Module) -> Module:
        """Put ``module`` in place of the child under ``key`` and return
        the old one.  The key stays, and with it every ``state_dict``
        path below it (the quantizer's rewrite, bigdl_tpu/nn/
        quantized.py:311-320)."""
        if key not in self._modules:
            raise KeyError(f"{self.name} has no child {key!r}")
        old = self._modules[key]
        self.add_module(key, module)
        return old


class Sequential(Container):
    """Feed-forward chain (bigdl_tpu/nn/module.py:328)."""

    def forward(self, x):
        for k in self._keys:
            x = self._modules[k](x)
        return x
