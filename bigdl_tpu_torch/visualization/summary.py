"""TrainSummary and ValidationSummary (counterpart of
bigdl_tpu/visualization/summary.py; BigDL's visualization/
{TrainSummary,ValidationSummary}.scala and Summary.scala:44-77).

A summary writes one TensorBoard event stream under ``log_dir/app_name/
tag``.  The optimizer takes them through ``set_train_summary`` and
``set_val_summary`` and writes ``Loss``, ``Throughput``,
``LearningRate`` and the validation methods' scores; the optional
``Parameters`` histogram is written when the trigger set by
``set_summary_trigger("Parameters", n)`` fires (every ``n``
iterations).  Without numerics statistics (not ported yet) the histogram
is :func:`subsample_tree` of the parameters: a strided subsample reduced
on the parameters' device, so only that vector is copied to the host.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.visualization.tensorboard import FileWriter, read_events

__all__ = ["DEFAULT_HIST", "ServingSummary", "Summary", "TelemetrySummary",
           "TrainSummary", "ValidationSummary", "subsample_tree"]

#: points of the Parameters histogram (bigdl_tpu/telemetry/numerics.py:67)
DEFAULT_HIST = 1024


def _nest(tree: Any) -> Any:
    """A dict whose keys are dotted paths (``named_parameters`` names) as
    nested dicts, so that its leaves order as the JAX tree's."""
    if not isinstance(tree, dict):
        return tree
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        *head, last = str(k).split(".")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = _nest(v)
    return out


def _leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_leaves`` order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def subsample_tree(tree: Any, budget: int = DEFAULT_HIST) -> np.ndarray:
    """A deterministic strided subsample of about ``budget`` f32 points
    over a tree's leaves (bigdl_tpu/telemetry/numerics.py:133-149): every
    ``total // budget``-th element of the leaves raveled in the JAX
    tree's order, cut to ``budget``.  ``tree`` is nested dicts, lists and
    tuples of tensors or arrays, or a flat dict keyed by dotted paths.
    The subsample is gathered where the tensors live; only it is copied
    to the host."""
    leaves = [torch.as_tensor(leaf) for leaf in _leaves(_nest(tree))]
    total = sum(leaf.numel() for leaf in leaves)
    if total == 0:
        return np.zeros((0,), np.float32)
    stride = max(1, total // max(1, budget))
    with torch.no_grad():
        parts = [leaf.detach().reshape(-1)[::stride].float()
                 for leaf in leaves if leaf.numel()]
        out = torch.cat(parts)[:budget]
    return out.cpu().numpy()


class Summary:
    def __init__(self, log_dir: str, app_name: str, tag: str):
        self.log_dir = os.path.join(log_dir, app_name, tag)
        self.writer = FileWriter(self.log_dir)
        self._triggers: Dict[str, int] = {}  # name -> every n iterations

    def set_summary_trigger(self, name: str, every_n: int) -> "Summary":
        """Turn on an optional stream (BigDL's
        TrainSummary.setSummaryTrigger), written every ``every_n``
        iterations."""
        self._triggers[name] = every_n
        return self

    def trigger_fires(self, name: str, step: int) -> bool:
        n = self._triggers.get(name)
        return bool(n) and step % n == 0

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.add_scalar(tag, float(value), step)
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self.writer.add_histogram(tag, np.asarray(values), step)
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """``[(step, value)]`` of ``tag`` over every event file of this
        summary's directory (BigDL's Summary.readScalar)."""
        rows = []
        for fn in sorted(os.listdir(self.log_dir)):
            if ".tfevents." not in fn:
                continue
            for r in read_events(os.path.join(self.log_dir, fn)):
                if r["tag"] == tag:
                    rows.append((r["step"], r["value"]))
        return rows

    def close(self):
        self.writer.close()


class TrainSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")

    def maybe_add_parameters(self, params, step: int):
        """The ``Parameters`` histogram, :func:`subsample_tree` of
        ``params``, when its trigger fires (the per-layer histograms of
        JAX's numerics statistics come with the numerics monitor)."""
        if self.trigger_fires("Parameters", step):
            self.add_histogram("Parameters/subsample",
                               subsample_tree(params), step)


class ValidationSummary(Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


class ServingSummary(Summary):
    """The event stream of a serving run, written by
    ``ServingMetrics.write_summary``."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "serving")


class TelemetrySummary(Summary):
    """The event stream of telemetry exports, written by
    ``Watchdog.write_summary`` and ``telemetry.write_scalars``."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "telemetry")
