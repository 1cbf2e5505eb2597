"""TrainSummary and ValidationSummary (counterpart of
bigdl_tpu/visualization/summary.py; BigDL's visualization/
{TrainSummary,ValidationSummary}.scala and Summary.scala:44-77).

A summary writes one TensorBoard event stream under ``log_dir/app_name/
tag``.  The optimizer takes them through ``set_train_summary`` and
``set_val_summary`` and writes ``Loss``, ``Throughput``,
``LearningRate`` and the validation methods' scores; the optional
``Parameters`` histogram is written when the trigger set by
``set_summary_trigger("Parameters", n)`` fires (every ``n``
iterations): with the loop's numerics statistics on, a histogram and the
norms per layer, from the drained stats; without, :func:`subsample_tree`
of the parameters, a strided subsample reduced on the parameters'
device, so only that vector is copied to the host.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from bigdl_tpu_torch.telemetry.numerics import DEFAULT_HIST, subsample_tree
from bigdl_tpu_torch.visualization.tensorboard import FileWriter, read_events

__all__ = ["DEFAULT_HIST", "ServingSummary", "Summary", "TelemetrySummary",
           "TrainSummary", "ValidationSummary", "subsample_tree"]


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

    def maybe_add_parameters(self, params, step: int, stats=None):
        """When the ``Parameters`` trigger fires: with ``stats`` (a
        drained numerics tree, ``telemetry/numerics.py collect``, already
        on the host) each layer's histogram ``Parameters/<layer>`` and its
        ``ParamNorm/<layer>`` and ``GradNorm/<layer>`` scalars, with no
        copy from the device here; without, the histogram
        ``Parameters/subsample``, :func:`subsample_tree` of ``params``
        (bigdl_tpu/visualization/summary.py:66-90)."""
        if not self.trigger_fires("Parameters", step):
            return
        if stats is not None and stats.get("layers"):
            for name in sorted(stats["layers"]):
                layer = stats["layers"][name]
                self.add_histogram(f"Parameters/{name}",
                                   np.asarray(layer["hist"]), step)
                self.add_scalar(f"ParamNorm/{name}", float(layer["p"]), step)
                self.add_scalar(f"GradNorm/{name}", float(layer["g"]), step)
            return
        self.add_histogram("Parameters/subsample", subsample_tree(params),
                           step)


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
