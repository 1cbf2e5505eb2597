"""Numerics observatory (counterpart of bigdl_tpu/telemetry/numerics.py):
in-graph gradient and update statistics, NaN provenance and divergence
early warning.

* :func:`collect` runs inside the train step (on the card, inside its
  CUDA graph): per-layer gradient, parameter and update norms, int32
  counts of non-finite gradient values and a small strided subsample of
  the new parameters (the TensorBoard histograms), reduced on the device
  to a tree of a few KB (f32 norms, summed over a layer's leaves in
  f64).  A layer is the first dotted component of a
  parameter's name (the JAX tree's top-level key); its leaves are
  visited in the JAX tree's order, keys sorted at each level.  The
  reductions are grouped: one multi-tensor norm over every parameter,
  gradient and update leaf, one concatenation of the gradients for the
  non-finite counts (an int32 prefix sum read at the layers' ends) and
  one of the new parameters for the histograms (one gather), so the
  capture gains a few dozen launches, not four per leaf.  The stats ride
  the step's outputs and are read at the loop's existing drain.  Stats
  off (the default) leaves the step as it was: four outputs, the same
  launches.
* :class:`NumericsMonitor` digests drained stats: a ``numerics`` sample
  instant per step (the exporters' grad-norm counter lane, the cluster
  grad-norm skew) and ``numerics_anomaly`` instants (non-finite
  gradients, grad-norm spike or vanish, update/param ratio out of band)
  that the watchdog counts before the same window's loss is read.
* :func:`nan_provenance` re-runs a failing batch eagerly, layer by
  layer through the model's ``child_keys`` and then backward, and names
  the first layer and site (input, forward, backward) that went
  non-finite; it never runs while a capture is open and never raises.

Env knobs, the JAX package's: ``BIGDL_TPU_NUMERICS=1`` turns stats on,
``BIGDL_TPU_NUMERICS_HIST`` sets the histogram budget (default 1024),
``BIGDL_TPU_NUMERICS_SPIKE``, ``BIGDL_TPU_NUMERICS_VANISH`` and
``BIGDL_TPU_NUMERICS_BAND`` the early-warning thresholds.
"""
from __future__ import annotations

import inspect
import logging
import math
import os
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.telemetry.tracer import CAT_TRAIN, get_tracer

logger = logging.getLogger("bigdl_tpu_torch.telemetry")

__all__ = ["DEFAULT_HIST", "MIN_LAYER_HIST", "NUMERICS_EVENT",
           "NUMERICS_SAMPLE", "PROVENANCE_EVENT", "RECOVERY_EVENT",
           "Collector", "NumericsMonitor", "NumericsSpec", "collect",
           "emit_provenance", "enabled", "nan_provenance", "spec_for",
           "subsample_tree"]

# instant names (the watchdog counts NUMERICS_EVENT; the exporters draw
# NUMERICS_SAMPLE as a counter lane)
NUMERICS_SAMPLE = "numerics"
NUMERICS_EVENT = "numerics_anomaly"
PROVENANCE_EVENT = "nan_provenance"
RECOVERY_EVENT = "divergence_recovery"

DEFAULT_HIST = 1024
MIN_LAYER_HIST = 16


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def enabled() -> bool:
    """``BIGDL_TPU_NUMERICS=1`` turns the loop's stats on (default off:
    the step stays the stats-free one)."""
    return os.environ.get("BIGDL_TPU_NUMERICS", "0") == "1"


@dataclass(frozen=True)
class NumericsSpec:
    """The stats' static configuration.  ``layers``: the model's
    top-level child keys in forward order, the order a first offending
    layer is named in (empty: sorted names).  ``hist``: the histogram
    budget the layers share."""

    layers: Tuple[str, ...] = ()
    hist: int = DEFAULT_HIST


def spec_for(model=None, hist: Optional[int] = None) -> NumericsSpec:
    """The spec of ``model``: its ``child_keys`` when it is a
    container."""
    keys = getattr(model, "child_keys", None) or ()
    h = int(hist) if hist is not None else int(
        _env_float("BIGDL_TPU_NUMERICS_HIST", DEFAULT_HIST))
    return NumericsSpec(layers=tuple(keys), hist=max(MIN_LAYER_HIST, h))


# --------------------------------------------------------------------------
# trees: flat dicts of dotted names, in the JAX tree's order
# --------------------------------------------------------------------------
def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A dict of dicts as one dict of dotted paths, a flat dict as it is
    (``utils.convert.flatten``'s rule: the telemetry package sits below
    ``utils``, which imports ``nn``, which imports the kernels that import
    this package)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_order(names) -> List[str]:
    """Dotted names in ``jax.tree_util`` order: keys sorted at each
    level of the nesting."""
    return sorted(names, key=lambda n: tuple(str(n).split(".")))


def _leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts, lists and tuples (or of a flat dict
    of dotted names) in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        flat = flatten(tree)
        return [leaf for n in _jax_order(flat) for leaf in _leaves(flat[n])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _layer_groups(names, layer_order) -> List[Tuple[str, List[str]]]:
    """``[(layer, [names])]``: the names grouped by their first dotted
    component, the layers in ``layer_order`` first and then sorted, each
    layer's names in the JAX tree's order."""
    groups: Dict[str, List[str]] = {}
    for n in _jax_order(names):
        groups.setdefault(str(n).split(".")[0], []).append(n)
    order = [k for k in layer_order if k in groups]
    order += [k for k in sorted(groups) if k not in order]
    return [(k, groups[k]) for k in order]


def _subsample_index(sizes: List[int], budget: int) -> np.ndarray:
    """The flat indices (into the leaves concatenated) of the strided
    subsample of bigdl_tpu/telemetry/numerics.py:133-143: every
    ``total // budget``-th element of each leaf from its start, cut to
    ``budget``."""
    total = sum(sizes)
    if total == 0:
        return np.zeros((0,), np.int64)
    stride = max(1, total // max(1, budget))
    parts, off = [], 0
    for s in sizes:
        if s:
            parts.append(np.arange(off, off + s, stride, dtype=np.int64))
        off += s
    return np.concatenate(parts)[:budget]


def subsample_tree(tree: Any, budget: int = DEFAULT_HIST) -> np.ndarray:
    """A deterministic strided subsample of about ``budget`` f32 points
    over a tree's leaves in the JAX tree's order (the ``Parameters``
    histogram without stats).  It is gathered where the tensors live;
    only it is copied to the host."""
    leaves = [torch.as_tensor(leaf) for leaf in _leaves(tree)]
    total = sum(leaf.numel() for leaf in leaves)
    if total == 0:
        return np.zeros((0,), np.float32)
    stride = max(1, total // max(1, budget))
    with torch.no_grad():
        parts = [leaf.detach().reshape(-1)[::stride].float()
                 for leaf in leaves if leaf.numel()]
        out = torch.cat(parts)[:budget]
    return out.cpu().numpy()


# --------------------------------------------------------------------------
# in-graph collection
# --------------------------------------------------------------------------
class _Plan:
    """What one parameter tree's stats need, made once: the leaves in
    layer order, each layer's leaf slots (padded with the index of a
    zero), the gradient element at each layer's end, and the
    histograms' gather index, as device tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], spec: NumericsSpec,
                 device: torch.device):
        groups = _layer_groups(params, spec.layers)
        self.names = [n for _, g in groups for n in g]
        self.layers = [k for k, _ in groups]
        sizes = [params[n].numel() for n in self.names]
        total = sum(sizes) or 1
        n_leaves, width = len(self.names), max(len(g) for _, g in groups)
        slots = np.full((len(groups), width), n_leaves, np.int64)
        ends, hist, self.hist_sizes = [], [], []
        leaf, elem = 0, 0
        for i, (_, g) in enumerate(groups):
            gsizes = sizes[leaf:leaf + len(g)]
            slots[i, :len(g)] = np.arange(leaf, leaf + len(g))
            k = max(MIN_LAYER_HIST, spec.hist * sum(gsizes) // total)
            idx = elem + _subsample_index(gsizes, k)
            hist.append(idx)
            self.hist_sizes.append(len(idx))
            leaf += len(g)
            elem += sum(gsizes)
            ends.append(elem)
        self.slots = torch.as_tensor(slots, device=device)
        self.ends = torch.as_tensor(np.asarray(ends, np.int64) - 1,
                                    device=device)
        self.hist = torch.as_tensor(np.concatenate(hist), device=device)


def _empty(device) -> Dict[str, Any]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"layers": {}, "grad_norm": z, "param_norm": z.clone(),
            "update_norm": z.clone(),
            "nonfinite": torch.zeros((), dtype=torch.int32, device=device)}


def _stats(plan: _Plan, params, grads, new_params) -> Dict[str, Any]:
    P = [params[n].detach().float() for n in plan.names]
    G = [grads[n].detach().float() for n in plan.names]
    N = [new_params[n].detach().float() for n in plan.names]
    device = P[0].device
    with torch.no_grad():
        U = list(torch._foreach_sub(N, P))
        # the card's multi-tensor norm reduces each leaf in f32 by a tree;
        # the CPU's runs leaf by leaf and accumulates f32 in order, so it
        # reduces in f64 there
        norms = torch.stack(torch._foreach_norm(
            P + G + U, 2,
            dtype=torch.float64 if device.type == "cpu" else None)).double()
        # per leaf sums of squares, a zero appended for the pad slots
        sq = torch.cat([norms.square().view(3, -1),
                        torch.zeros((3, 1), dtype=torch.float64,
                                    device=device)], 1)
        per_layer = sq[:, plan.slots].sum(-1)  # (3, layers): p, g, u
        totals = per_layer.sum(-1).sqrt().float()
        bad = torch.cumsum(~torch.isfinite(torch.cat(
            [g.reshape(-1) for g in G])), 0, dtype=torch.int32)[plan.ends]
        nf = torch.diff(bad, prepend=bad.new_zeros(1))
        hist = torch.cat([n.reshape(-1) for n in N])[plan.hist]
        pn, gn, un = per_layer.sqrt().float()
    layers: Dict[str, Dict[str, torch.Tensor]] = {}
    start = 0
    for i, (name, k) in enumerate(zip(plan.layers, plan.hist_sizes)):
        layers[name] = {"g": gn[i], "p": pn[i], "u": un[i], "nf": nf[i],
                        "hist": hist[start:start + k]}
        start += k
    p_tot, g_tot, u_tot = totals
    return {"layers": layers, "grad_norm": g_tot, "param_norm": p_tot,
            "update_norm": u_tot, "nonfinite": nf.sum(dtype=torch.int32)}


class Collector:
    """:func:`collect` with its plan made at the first call and kept (by
    the tree's names, shapes and device): the train step holds one, so
    the plan's device tensors are made in an eager warm-up call and a
    CUDA graph's capture finds them ready."""

    def __init__(self, spec: NumericsSpec):
        self.spec = spec
        self._plans: Dict[Any, _Plan] = {}
        self._lock = threading.Lock()

    def __call__(self, params, grads, new_params) -> Dict[str, Any]:
        params, grads, new_params = (flatten(params), flatten(grads),
                                     flatten(new_params))
        if not params:
            return _empty(None)
        first = next(iter(params.values()))
        key = (first.device, tuple((n, tuple(p.shape))
                                   for n, p in params.items()))
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                plan = self._plans[key] = _Plan(params, self.spec,
                                                first.device)
        return _stats(plan, params, grads, new_params)


def collect(params, grads, new_params, spec: NumericsSpec
            ) -> Dict[str, Any]:
    """Per-layer and global stats of one step, on the parameters'
    device: ``{"layers": {layer: {"g", "p", "u", "nf", "hist"}},
    "grad_norm", "param_norm", "update_norm", "nonfinite"}`` (f32 norms,
    int32 counts of non-finite gradient values, f32 histograms of
    ``new_params``), as bigdl_tpu/telemetry/numerics.py:146-204 computes
    them.  ``new_params`` gives the update, ``new - old``."""
    return Collector(spec)(params, grads, new_params)


# --------------------------------------------------------------------------
# host-side monitor
# --------------------------------------------------------------------------
def _parse_band(raw: str) -> Tuple[float, float]:
    try:
        lo, hi = raw.split(":")
        return float(lo), float(hi)
    except (ValueError, AttributeError):
        return 1e-10, 0.5


class NumericsMonitor:
    """Digests drained (host) stats on the loop's drain cadence (see the
    module's docstring); the thresholds are the JAX package's."""

    def __init__(self, spec: Optional[NumericsSpec] = None, *,
                 spike_factor: Optional[float] = None,
                 vanish_floor: Optional[float] = None,
                 ratio_band: Optional[Tuple[float, float]] = None,
                 history: int = 64, warmup: int = 8,
                 log=logger.warning):
        self.spec = spec or NumericsSpec()
        self._spike = spike_factor if spike_factor is not None else \
            _env_float("BIGDL_TPU_NUMERICS_SPIKE", 10.0)
        self._vanish = vanish_floor if vanish_floor is not None else \
            _env_float("BIGDL_TPU_NUMERICS_VANISH", 1e-8)
        self._band = ratio_band if ratio_band is not None else \
            _parse_band(os.environ.get("BIGDL_TPU_NUMERICS_BAND",
                                       "1e-10:0.5"))
        self._hist: deque = deque(maxlen=max(8, int(history)))
        self._warmup = max(0, int(warmup))
        self._log = log
        self.anomaly_count = 0
        self.last: Optional[Dict[str, Any]] = None  # the scalars
        self.last_stats: Optional[Dict[str, Any]] = None  # the whole tree

    def first_nonfinite_layer(self, stats) -> Optional[str]:
        layers = stats.get("layers") or {}
        order = [k for k in self.spec.layers if k in layers]
        order += [k for k in sorted(layers) if k not in order]
        for name in order:
            if int(layers[name]["nf"]) > 0:
                return name
        return None

    def observe(self, iteration: int, stats) -> List[str]:
        """Digest one drained stats tree; returns the anomaly kinds."""
        tracer = get_tracer()
        g = float(stats["grad_norm"])
        p = float(stats["param_norm"])
        u = float(stats["update_norm"])
        nf = int(stats["nonfinite"])
        ratio = (u / p) if p > 0 else 0.0
        corr = f"step:{iteration}"
        self.last = {"iteration": iteration, "grad_norm": g,
                     "param_norm": p, "update_norm": u,
                     "update_ratio": ratio, "nonfinite": nf}
        self.last_stats = stats
        tracer.instant(
            NUMERICS_SAMPLE, CAT_TRAIN, corr=corr,
            args={"iteration": iteration, "grad_norm": g,
                  "update_ratio": ratio, "nonfinite": nf})
        fired: List[str] = []

        def fire(kind: str, message: str, **extra):
            fired.append(kind)
            self.anomaly_count += 1
            tracer.instant(
                NUMERICS_EVENT, CAT_TRAIN, corr=corr,
                args={"kind": kind, "iteration": iteration,
                      "message": message, **extra})
            if self._log is not None:
                try:
                    self._log("numerics: %s", message)
                except Exception:
                    pass

        if nf > 0 or not math.isfinite(g):
            layer = self.first_nonfinite_layer(stats)
            fire("nonfinite",
                 f"{nf} non-finite gradient value(s) at iteration "
                 f"{iteration}"
                 + (f" (first offending layer {layer!r})" if layer
                    else ""),
                 layer=layer, count=nf)
            return fired  # spike and ratio mean nothing on a NaN
        warm = len(self._hist) >= max(1, self._warmup)
        if warm:
            med = sorted(self._hist)[len(self._hist) // 2]
            if med > 0 and g > self._spike * med:
                fire("grad_spike",
                     f"grad norm {g:.3e} is x{g / med:.1f} the rolling "
                     f"median {med:.3e} at iteration {iteration}",
                     grad_norm=g, median=med)
            elif g < self._vanish:
                fire("grad_vanish",
                     f"grad norm {g:.3e} under the vanish floor "
                     f"{self._vanish:.1e} at iteration {iteration}",
                     grad_norm=g)
            lo, hi = self._band
            if p > 0 and not (lo <= ratio <= hi):
                fire("update_ratio",
                     f"update/param ratio {ratio:.3e} outside "
                     f"[{lo:.1e}, {hi:.1e}] at iteration {iteration}",
                     update_ratio=ratio)
        self._hist.append(g)
        return fired


# --------------------------------------------------------------------------
# NaN provenance (eager, off the loop's path)
# --------------------------------------------------------------------------
def _nonfinite(tree: Any) -> int:
    n = 0
    for leaf in _leaves(tree) if isinstance(tree, (dict, list, tuple)) \
            else [tree]:
        if leaf is None:
            continue
        if torch.is_tensor(leaf):
            if leaf.is_floating_point():
                n += int((~torch.isfinite(leaf.detach())).sum())
        else:
            a = np.asarray(leaf)
            if a.dtype.kind in "fc":
                n += int(np.sum(~np.isfinite(a)))
    return n


def _takes_rng(module) -> bool:
    try:
        return "rng" in inspect.signature(module.forward).parameters
    except (TypeError, ValueError):
        return False


def _first_leaf(out: Any) -> torch.Tensor:
    while isinstance(out, (list, tuple)):
        out = out[0]
    return out


def _provenance(model, params, model_state, features, targets, criterion,
                compute_dtype, rng) -> Dict[str, Any]:
    from torch.func import functional_call

    from bigdl_tpu_torch.nn.module import split_rng
    from bigdl_tpu_torch.utils.convert import subtree

    report: Dict[str, Any] = {"layer": None, "site": None, "loss": None,
                              "layers": {}}
    params, model_state = flatten(params), flatten(model_state)
    device = next(iter(params.values())).device if params else None
    as_t = (lambda t: torch.as_tensor(t, device=device)
            if not torch.is_tensor(t) else t)
    features = (type(features)(as_t(f) for f in features)
                if isinstance(features, (list, tuple)) else as_t(features))
    if targets is not None and not isinstance(targets, (list, tuple)):
        targets = as_t(targets)
    report["input_nonfinite"] = _nonfinite(features)
    if report["input_nonfinite"]:
        report["site"] = "input"

    def cast(t):
        return ({k: v.to(compute_dtype) if v.is_floating_point() else v
                 for k, v in t.items()} if compute_dtype is not None else t)

    model.train()
    keys = getattr(model, "child_keys", None)
    if keys:
        # the forward walk: each child on its predecessor's output
        x = features
        prev_finite = report["input_nonfinite"] == 0
        cp = cast({k: v.detach() for k, v in params.items()})
        state = {k: v.detach().clone() for k, v in model_state.items()}
        with torch.no_grad():
            for i, k in enumerate(keys):
                child = model._modules[k]
                kwargs = ({"rng": split_rng(rng, i)} if _takes_rng(child)
                          else {})
                try:
                    x = functional_call(child, {**subtree(cp, k),
                                                **subtree(state, k)},
                                        (x,), kwargs)
                except Exception:
                    break
                nf = _nonfinite(x)
                report["layers"][k] = {"out_nonfinite": nf}
                if nf and report["layer"] is None and prev_finite:
                    report["layer"], report["site"] = k, "forward"
                prev_finite = nf == 0

    # the whole backward: the layers whose gradients are not finite
    try:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        state = {k: v.detach().clone() for k, v in model_state.items()}
        kwargs = {"rng": rng} if _takes_rng(model) else {}
        with torch.enable_grad():
            out = functional_call(model, {**cast(leaves), **state},
                                  (features,), kwargs)
            if criterion is not None:
                loss = criterion.forward(out, targets).float()
            else:
                loss = _first_leaf(out).sum().float()
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        report["loss"] = float(loss.detach())
        grads = dict(zip(leaves, grads))
        bad_layers = []
        for name, names in _layer_groups(params, tuple(keys or ())):
            nf = sum(_nonfinite(grads[n]) for n in names)
            report["layers"].setdefault(name, {})["grad_nonfinite"] = nf
            if nf:
                bad_layers.append(name)
        if report["site"] is None and bad_layers:
            # a backward NaN flows toward the input: its origin is the
            # deepest layer still carrying it
            report["layer"], report["site"] = bad_layers[-1], "backward"
    except Exception as e:  # a diagnostic never stops the recovery
        report["error"] = repr(e)
    return report


def nan_provenance(model, params, model_state, features, targets,
                   criterion=None, compute_dtype=None,
                   rng=None) -> Dict[str, Any]:
    """Re-run a failing batch and name the first non-finite layer and
    site (bigdl_tpu/telemetry/numerics.py:324-394): poisoned input
    (``input``); else the first child, in ``child_keys`` order, whose
    output goes non-finite on a finite input (``forward``); else the
    last layer with non-finite gradients (``backward``).  ``params`` and
    ``model_state`` are the step's flat dicts of tensors.  Eager, never
    while a CUDA graph capture is open (the report then says so), and it
    never raises."""
    from bigdl_tpu_torch.utils import graphs

    try:
        report = graphs.unless_capturing(lambda: _provenance(
            model, params, model_state, features, targets, criterion,
            compute_dtype, rng))
    except Exception as e:
        return {"layer": None, "site": None, "loss": None, "layers": {},
                "input_nonfinite": 0, "error": repr(e)}
    if report is None:
        return {"layer": None, "site": None, "loss": None, "layers": {},
                "input_nonfinite": 0,
                "error": "a CUDA graph capture was running"}
    return report


def emit_provenance(report: Dict[str, Any], iteration: int) -> None:
    """The report as the ``nan_provenance`` instant, correlated with the
    ``loss_divergence`` instant of the same step."""
    get_tracer().instant(
        PROVENANCE_EVENT, CAT_TRAIN, corr=f"step:{iteration}",
        args={"iteration": iteration,
              "layer": report.get("layer"),
              "site": report.get("site"),
              "input_nonfinite": report.get("input_nonfinite", 0),
              "loss": str(report.get("loss"))})
