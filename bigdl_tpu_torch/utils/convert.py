"""Weights across from the JAX package.

The JAX package keeps a model's weights as ``{"params": tree, "state":
tree}``: nested dicts keyed by child name, with leaves such as
``weight``/``bias`` (params) and ``running_mean``/``running_var``
(state).  The port's modules carry the same child keys, leaf names and
layouts (NHWC, HWIO, ``(in, out)``), so the carry is one table:

    params leaf  a/b/weight        ->  parameter ``a.b.weight``
    state  leaf  a/b/running_mean  ->  buffer    ``a.b.running_mean``

with no rename and no transpose.  Leaves are numpy arrays (or anything
``np.asarray`` takes: a jax array converts on the caller's side).

An optimizer's state carries the same way: SGD's ``{"velocity": tree}``
and Adam's ``{"m": tree, "v": tree}`` hold trees shaped as the params,
each of which becomes a flat dict keyed by parameter name
(:func:`load_jax_opt_state`, :func:`export_opt_state`).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Container

__all__ = ["load_jax_variables", "export_variables", "flatten",
           "random_variables", "load_jax_opt_state", "export_opt_state"]


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> ``{"a.b.leaf": array}``; empty subtrees vanish."""
    out: Dict[str, object] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _table(model: torch.nn.Module):
    params = dict(model.named_parameters())
    state = dict(model.named_buffers())
    return {"params": params, "state": state}


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> dict:
    """Copy a JAX ``{"params", "state"}`` tree into ``model`` in place.

    Raises ``KeyError`` when the key sets differ (naming the missing and
    unexpected keys) and ``ValueError`` on a shape mismatch, before
    anything is copied.  Values are cast to each tensor's dtype and
    device.  Returns :func:`export_variables` of the loaded model.
    """
    table = _table(model)
    plan = []
    for kind in ("params", "state"):
        got = flatten(variables.get(kind, {}))
        want = table[kind]
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise KeyError(f"{kind} keys differ: missing {missing[:8]}"
                           f"{'...' if len(missing) > 8 else ''}, "
                           f"unexpected {extra[:8]}"
                           f"{'...' if len(extra) > 8 else ''}")
        for key, t in want.items():
            arr = np.asarray(got[key])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{kind} {key}: shape {tuple(arr.shape)} "
                                 f"!= {tuple(t.shape)}")
            plan.append((t, arr))
    with torch.no_grad():
        for t, arr in plan:
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return export_variables(model)


def _nest(module: torch.nn.Module, kind: str) -> dict:
    """The JAX tree shape: a container lists every child key (``{}``
    for a child without leaves), any other module only children that
    have leaves."""
    leaves = (module.named_parameters(recurse=False) if kind == "params"
              else module.named_buffers(recurse=False))
    out = {k: v.detach().float().cpu().numpy() for k, v in leaves}
    for key, child in module.named_children():
        sub = _nest(child, kind)
        if sub or isinstance(module, Container):
            out[key] = sub
    return out


def export_variables(model: torch.nn.Module) -> dict:
    """The port's weights as a JAX-shaped ``{"params", "state"}`` tree of
    f32 numpy arrays (the inverse of :func:`load_jax_variables`)."""
    return {"params": _nest(model, "params"), "state": _nest(model, "state")}


def random_variables(template: Mapping, seed: int) -> dict:
    """Random weights shaped like ``template`` (a ``{"params", "state"}``
    tree, e.g. :func:`export_variables` of a model), made with numpy from
    ``seed``: He-normal conv weights, uniform Linear weights, and every
    BatchNorm leaf randomised (gamma, beta, running mean and a positive
    running variance), so that no residual branch is multiplied by a zero
    gamma.  Deterministic in ``seed`` and the tree's key order."""
    rs = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = fill(v)
                continue
            shape = tuple(np.shape(v))
            if k == "weight" and len(shape) == 4:  # HWIO conv
                fan_in = shape[0] * shape[1] * shape[2]
                a = rs.randn(*shape) * math.sqrt(2.0 / fan_in)
            elif k == "weight" and len(shape) == 2:  # (in, out) Linear
                a = rs.uniform(-1.0, 1.0, shape) / math.sqrt(shape[0])
            elif k == "weight":  # BatchNorm gamma
                a = rs.uniform(0.2, 0.6, shape)
            elif k == "running_var":
                a = rs.uniform(0.5, 1.5, shape)
            else:  # bias, running_mean
                a = rs.randn(*shape) * 0.1
            out[k] = np.asarray(a, np.float32)
        return out

    return {kind: fill(template.get(kind, {})) for kind in ("params", "state")}


def load_jax_opt_state(opt_state: Mapping,
                       params: Mapping[str, torch.Tensor]) -> dict:
    """A JAX optimizer state such as SGD's ``{"velocity": tree}`` or
    Adam's ``{"m": tree, "v": tree}`` (each slot a tree shaped as the
    params) as the port's ``{"velocity":
    {name: f32 tensor}}``, each tensor on its parameter's device, so a
    JAX run's state continues in :func:`make_train_step`.  Raises
    ``KeyError`` when a slot's keys differ from ``params``' and
    ``ValueError`` on a shape mismatch."""
    out = {}
    for slot, tree in opt_state.items():
        got = flatten(tree)
        missing = sorted(set(params) - set(got))
        extra = sorted(set(got) - set(params))
        if missing or extra:
            raise KeyError(f"{slot} keys differ: missing {missing[:8]}, "
                           f"unexpected {extra[:8]}")
        out[slot] = {}
        for k, p in params.items():
            arr = np.asarray(got[k], np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{slot} {k}: shape {tuple(arr.shape)} "
                                 f"!= {tuple(p.shape)}")
            out[slot][k] = torch.tensor(arr, device=p.device)
    return out


def _fill(template: Mapping, flat: Mapping, prefix: str = "") -> dict:
    return {k: (_fill(v, flat, f"{prefix}{k}.") if isinstance(v, Mapping)
                else flat[f"{prefix}{k}"]) for k, v in template.items()}


def export_opt_state(model: torch.nn.Module, opt_state: Mapping) -> dict:
    """The inverse of :func:`load_jax_opt_state`: each slot as a tree of
    f32 numpy arrays nested as ``export_variables(model)["params"]``
    (empty subtrees included)."""
    template = _nest(model, "params")
    return {slot: _fill(template, {k: v.detach().float().cpu().numpy()
                                   for k, v in flat.items()})
            for slot, flat in opt_state.items()}
