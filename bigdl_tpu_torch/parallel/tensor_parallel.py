"""Tensor parallelism by parameter-sharding rules (counterpart of
bigdl_tpu/parallel/tensor_parallel.py).

The JAX package assigns a ``PartitionSpec`` to each parameter leaf by
path pattern and lets GSPMD place the collectives.  The port keeps the
rules and their matching: :func:`make_param_shardings` gives each leaf a
layout (:class:`~bigdl_tpu_torch.parallel.mesh.Sharded`: which dim is
split over which axis, and this rank's part), :func:`shard_variables`
cuts a rank's leaves from a whole tree and :func:`gather_variables`
puts them back together.  The layers read their leaf's layout from its
shape (a local ``wq`` narrower than the hidden size holds some heads) and
run on their shard, with the conjugate collectives of
``parallel/comm.py`` where the shard ends (Megatron's layouts):

* attention ``wq``/``wk``/``wv`` column-parallel (``P(None, "model")``:
  the heads split over the axis), ``wo`` row-parallel (``P("model",
  None)``: the partial sums reduced);
* FFN ``w1``/``b1`` column-parallel, ``w2`` row-parallel, ``b2`` added
  after the reduce;
* the embedding split on the vocab (``P("model", None)``): a masked
  lookup then the reduce, and the tied logits' vocab slices gathered.

A rule applies only where its axes divide the leaf's dims; otherwise the
leaf stays replicated (at vocab 10001 and ``--tp 2`` the embedding).
Paths are ``/name`` per key and ``/#i`` per list entry; a flat dict keyed
as ``named_parameters`` reads as the tree of its dotted names.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.parallel.mesh import (MODEL_AXIS, Mesh, Replicated,
                                           Sharded, sharded)

__all__ = ["CONVNET_RULES", "TRANSFORMER_RULES", "describe_shardings",
           "gather_variables", "make_param_shardings", "map_with_paths",
           "match_rule_spec", "shard_variables"]

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]

#: the rules of the ``nn.Transformer`` family
TRANSFORMER_RULES: Rules = (
    (r".*/(wq|wk|wv)$", (None, MODEL_AXIS)),
    (r".*/wo$", (MODEL_AXIS, None)),
    (r".*/(ffn)/w1$", (None, MODEL_AXIS)),
    (r".*/(ffn)/b1$", (MODEL_AXIS,)),
    (r".*/(ffn)/w2$", (MODEL_AXIS, None)),
    (r".*/embed/weight$", (MODEL_AXIS, None)),
)

#: conv nets stay replicated under tensor parallelism
CONVNET_RULES: Rules = ()


def _is_flat(tree) -> bool:
    return isinstance(tree, Mapping) and any("." in k for k in tree)


def map_with_paths(tree: Any, fn, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree, paths in the rules' ``/name`` and
    ``/#i`` scheme.  A flat dict with dotted keys maps key by key, each
    key's path its dotted name with ``/`` for ``.``."""
    if not prefix and _is_flat(tree):
        return {k: fn("/" + k.replace(".", "/"), v) for k, v in tree.items()}
    if isinstance(tree, Mapping):
        return {k: map_with_paths(v, fn, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(v, fn, f"{prefix}/#{i}")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", np.shape(leaf)))


def match_rule_spec(mesh: Mesh, path: str, leaf, compiled,
                    shift: int = 0) -> Optional[Spec]:
    """The first matching rule's spec if its axes divide the leaf's dims
    (``shift``: the rules' dim 0 is the leaf's dim ``shift``, 1 under a
    stacked pipeline dim); ``None`` when no rule matches or they do not
    divide."""
    shape = _shape(leaf)
    for pat, spec in compiled:
        if pat.match(path):
            for dim, axis in enumerate(spec):
                if axis is None:
                    continue
                d = dim + shift
                if d >= len(shape) or shape[d] % mesh.shape[axis]:
                    return None
            return tuple(spec)
    return None


def _compile(rules: Rules):
    return [(re.compile(pat), tuple(spec)) for pat, spec in rules]


def make_param_shardings(mesh: Mesh, params: Any,
                         rules: Rules = TRANSFORMER_RULES,
                         default: Optional[Spec] = None) -> Any:
    """Each leaf's layout (``Sharded`` or ``Replicated``) from the
    path-pattern rules, in the tree's structure; a leaf no rule divides
    takes ``default`` (replicated by default)."""
    compiled = _compile(rules)

    def spec_for(path, leaf):
        spec = match_rule_spec(mesh, path, leaf, compiled)
        if spec is None:
            spec = tuple(default) if default is not None else ()
        return sharded(mesh, spec)

    return map_with_paths(params, spec_for)


def _iter(tree, prefix=""):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _iter(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter(v, f"{prefix}/#{i}")
    else:
        yield prefix, tree


def describe_shardings(shardings: Any) -> Dict[str, str]:
    """path -> spec string of every leaf that is not replicated."""
    if _is_flat(shardings):
        shardings = {k.replace(".", "/"): v for k, v in shardings.items()}
    return {path: str(s) for path, s in _iter(shardings)
            if isinstance(s, Sharded)}


def _layout_of(shardings, key: str):
    """The layout of the dotted ``key`` in a flat or nested tree of
    layouts (replicated where the tree has none)."""
    if shardings is None:
        return Replicated()
    if key in shardings:
        return shardings[key]
    node = shardings
    for part in key.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return Replicated()
        node = node[part]
    return node


def shard_variables(variables: Mapping, mesh: Mesh, shardings) -> dict:
    """This rank's leaves of a whole tree (JAX's ``{"params", "state"}``
    variables, a params tree, or a flat dict): each ``Sharded`` leaf cut
    to its part (a contiguous copy), every other leaf as it is.
    ``shardings`` lays out the params (the variables' ``"params"``)."""
    if "params" in variables and not _is_flat(variables):
        return dict(variables, params=shard_variables(
            variables["params"], mesh, shardings))

    def cut(path, leaf):
        key = path.lstrip("/").replace("/", ".")
        lay = _layout_of(shardings, key)
        part = lay.local(leaf)
        if torch.is_tensor(part):
            return part.contiguous().clone()
        return np.ascontiguousarray(part)

    return map_with_paths(variables, cut)


def gather_variables(variables: Mapping, mesh: Mesh, shardings) -> dict:
    """The inverse of :func:`shard_variables`: every ``Sharded`` leaf
    gathered whole over its axes (collectives every rank joins, in the
    tree's order), every other leaf as it is."""
    from bigdl_tpu_torch.parallel import comm

    if "params" in variables and not _is_flat(variables):
        return dict(variables, params=gather_variables(
            variables["params"], mesh, shardings))

    def whole(path, leaf):
        key = path.lstrip("/").replace("/", ".")
        lay = _layout_of(shardings, key)
        if not isinstance(lay, Sharded):
            return leaf
        t = leaf if torch.is_tensor(leaf) else torch.from_numpy(
            np.ascontiguousarray(leaf))
        t = t.to(mesh.device)
        for dim, axis in enumerate(lay.spec):
            if axis is not None:
                t = comm.all_gather(t, mesh, axis, dim)
        return t if torch.is_tensor(leaf) else t.cpu().numpy()

    return map_with_paths(variables, whole)
