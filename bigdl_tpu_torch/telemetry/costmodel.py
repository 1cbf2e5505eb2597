"""Cost and MFU accounting of compiled programs (counterpart of
bigdl_tpu/telemetry/costmodel.py).

The JAX package stamps each compiled program with XLA's
``cost_analysis()``.  The port has no compiler to ask, so it counts one
eager call of the program, made before its capture (the first warm-up
call of ``utils/graphs.py``'s capture; on the CPU one more eager call on
copies of the arguments), never during a capture or a replay:

* library operations (matmuls, convolutions, the attention backward,
  the optimizer's products) are counted by PyTorch's
  ``FlopCounterMode``;
* a hand-written kernel is a ``ctypes`` launch that no dispatch mode
  sees, so each kernel wrapper adds its own operations and bytes, from
  one formula per kernel kept in its ``ops/`` module, through
  :func:`kernel`; on the CPU, where the wrapper runs the kernel's plain
  version, the operations of that version are left out, so a model
  counts the same on the CPU as on the card;
* bytes are the port's own estimate: each library operation's tensor
  inputs and outputs (views move nothing), plus the kernels' formulas.

:class:`ProgramCost` and :class:`CostTable` keep the JAX package's
fields and JSON, so a table persisted by either package loads in the
other.  :func:`mfu` divides by :func:`peak_flops_per_device`: the
card's dense bf16 peak, matched on ``torch.cuda.get_device_name()``,
or a nominal constant on the CPU, where MFU only compares runs.
``BIGDL_TPU_PEAK_FLOPS`` overrides the peak and
``BIGDL_TPU_COST_DISABLE=1`` turns all stamping off.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

# per-card dense bf16 peak, matched as substrings of the lowercased
# device name; anything else falls through to the nominal constant
_PEAK_BY_NAME = (
    ("h100 80gb hbm3", 989e12),  # H100 SXM (NVIDIA data sheet)
)
_NOMINAL_CPU_PEAK = 1.0e11


def cost_accounting_enabled() -> bool:
    """``BIGDL_TPU_COST_DISABLE=1`` turns all stamping into no-ops."""
    return os.environ.get("BIGDL_TPU_COST_DISABLE", "0") != "1"


def peak_flops_per_device(device=None) -> float:
    """Peak dense FLOP/s of one device (``BIGDL_TPU_PEAK_FLOPS`` wins).
    ``device`` defaults to the first card, or the CPU without one."""
    env = os.environ.get("BIGDL_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return _NOMINAL_CPU_PEAK
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAK_BY_NAME:
        if key in name:
            return peak
    return _NOMINAL_CPU_PEAK


def mfu(flops_per_step: float, step_time_s: float, *, n_devices: int = 1,
        peak: Optional[float] = None) -> float:
    """Model-flops-utilization of one step across ``n_devices``."""
    if not flops_per_step or not step_time_s or step_time_s <= 0:
        return 0.0
    peak = peak_flops_per_device() if peak is None else peak
    denom = step_time_s * peak * max(1, n_devices)
    return flops_per_step / denom if denom > 0 else 0.0


@dataclasses.dataclass
class ProgramCost:
    """One compiled program's cost stamp (flops and bytes of one call;
    ``temp_bytes`` and ``generated_code_bytes`` are XLA's and stay 0
    here)."""

    name: str
    flops: float = 0.0
    bytes_accessed: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    generated_code_bytes: int = 0
    n_devices: int = 1
    stamped_unix: float = 0.0

    def mfu(self, step_time_s: float, peak: Optional[float] = None) -> float:
        return mfu(self.flops, step_time_s, n_devices=self.n_devices,
                   peak=peak)

    def bytes_per_s(self, step_time_s: float) -> float:
        if not self.bytes_accessed or step_time_s <= 0:
            return 0.0
        return self.bytes_accessed / step_time_s

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, blob: dict) -> "ProgramCost":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in blob.items() if k in fields})


# --------------------------------------------------------------------------
# counting one eager call
# --------------------------------------------------------------------------
def _tensor_bytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


class Count:
    """What one counted call did: ``flops``, ``bytes_accessed``, and the
    bytes of its arguments and outputs (the caller sets those two)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._depth = 0        # kernel wrappers entered, nested
        self._excluded = 0.0   # library flops of kernels' plain versions
        self._flops_mode = None

    def _library_flops(self) -> float:
        return float(self._flops_mode.get_total_flops())

    def _enter_kernel(self, flops: float, nbytes: float):
        self._depth += 1
        if self._depth == 1:  # a padded call re-enters its own wrapper
            self.flops += flops
            self.bytes_accessed += nbytes
            self._mark = self._library_flops()

    def _exit_kernel(self):
        self._depth -= 1
        if self._depth == 0:
            self._excluded += self._library_flops() - self._mark

    def set_io(self, args, out):
        self.argument_bytes = _tensor_bytes(args)
        self.output_bytes = _tensor_bytes(out)


class _BytesMode(TorchDispatchMode):
    """Bytes of every operation outside a kernel wrapper: its tensor
    inputs and outputs, nothing for views."""

    def __init__(self, count: Count):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.count
        if c._depth == 0 and not getattr(func, "is_view", False):
            c.bytes_accessed += _tensor_bytes(args) \
                + _tensor_bytes(kwargs or {}) + _tensor_bytes(out)
        return out


def _active() -> Optional[Count]:
    """The count of the call running on this thread (autograd's worker
    threads inherit the dispatch modes, so a backward finds its count)."""
    if not _COUNTING:
        return None
    for m in _get_current_dispatch_mode_stack():
        if isinstance(m, _BytesMode):
            return m.count
    return None


_COUNTING = 0  # counts running in the process (a fast path for kernel())
_counting_lock = threading.Lock()


@contextmanager
def counting(count: Optional[Count] = None) -> Iterator[Count]:
    """Count the operations and bytes of the block into ``count`` (a new
    :class:`Count` by default), which it yields."""
    global _COUNTING
    from torch.utils.flop_counter import FlopCounterMode

    count = Count() if count is None else count
    count._flops_mode = FlopCounterMode(display=False)
    with _counting_lock:
        _COUNTING += 1
    try:
        with count._flops_mode, _BytesMode(count):
            yield count
    finally:
        with _counting_lock:
            _COUNTING -= 1
        count.flops += count._library_flops() - count._excluded
        count._flops_mode = None


@contextmanager
def kernel(cost: Callable[[], Tuple[float, float]]):
    """A kernel wrapper's call: adds the kernel's ``(flops, bytes)``,
    ``cost()``, to the running count, if any, and leaves out what the
    wrapper runs inside (its plain version on the CPU, its operand
    copies).  ``cost`` is called only while a count runs."""
    c = _active()
    if c is None:
        yield
        return
    c._enter_kernel(*cost())
    try:
        yield
    finally:
        c._exit_kernel()


def stamp(name: str, count: Optional[Count], *,
          table: "CostTable" = None,
          n_devices: int = 1) -> Optional[ProgramCost]:
    """A :class:`ProgramCost` from a filled :class:`Count`, added to
    ``table`` (default the process's); None when accounting is off or
    nothing was counted."""
    if count is None or not cost_accounting_enabled():
        return None
    cost = ProgramCost(
        name=name, flops=float(count.flops),
        bytes_accessed=float(count.bytes_accessed),
        argument_bytes=int(count.argument_bytes),
        output_bytes=int(count.output_bytes),
        n_devices=max(1, int(n_devices)), stamped_unix=time.time())
    (table if table is not None else get_cost_table()).add(cost)
    return cost


def new_count() -> Optional[Count]:
    """A :class:`Count` for a program about to compile, or None while
    accounting is off (the compile then counts nothing)."""
    return Count() if cost_accounting_enabled() else None


class CostTable:
    """Thread-safe per-program cost registry, persistable as JSON."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: dict = {}

    def add(self, cost: ProgramCost) -> None:
        with self._lock:
            self._programs[cost.name] = cost

    def get(self, name: str) -> Optional[ProgramCost]:
        with self._lock:
            return self._programs.get(name)

    def programs(self) -> dict:
        with self._lock:
            return dict(self._programs)

    def records(self) -> list:
        with self._lock:
            return [c.as_dict() for _, c in sorted(self._programs.items())]

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    def persist(self, path: str) -> str:
        """Write the table (a temporary file renamed into place)."""
        blob = {"record": "cost_table", "unix_time": time.time(),
                "programs": self.records()}
        tmp = f"{path}.{os.getpid()}.part"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CostTable":
        table = cls()
        try:
            with open(path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return table
        for rec in blob.get("programs", []):
            try:
                table.add(ProgramCost.from_dict(rec))
            except (TypeError, ValueError):
                continue
        return table


_GLOBAL_TABLE = CostTable()


def get_cost_table() -> CostTable:
    """The process-wide cost table."""
    return _GLOBAL_TABLE
