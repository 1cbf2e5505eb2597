"""Program X-ray: the compiled-program registry, recompile forensics
and a live HBM ledger (counterpart of bigdl_tpu/telemetry/programs.py).

The tracer sees the host's timeline; this module makes the compiled
side visible:

* :class:`ProgramRegistry`: a process-wide table of every compiled
  entry point (the train step, the serving buckets' forwards, the decode
  engine's prefill, tick, write and speculative programs, and each
  hand-written kernel as ``kernel:<name>`` with its route), keyed by a
  stable name.  Each compile carries a signature fingerprint (the
  arguments' paths, shapes, types and devices, static arguments, the
  donation mask), its capture seconds, the kernels its capture launched
  and the cost stamp of :mod:`~bigdl_tpu_torch.telemetry.costmodel`.
* **Recompile forensics**: a compile at steady state is diffed against
  the nearest registered signature of its program and the changed axis
  named ("arg `cache.k` dim 2 — 128 → 160, dtype unchanged") in a
  ``recompile_forensics`` tracer instant that the Watchdog folds into
  its anomaly.
* :class:`HbmLedger`: samples the card's allocator
  (``torch.cuda.memory_stats``, the card's total memory as the limit;
  on the CPU it falls back to the programs' footprints,
  ``source="estimate"``), emits an ``hbm`` instant and, under the
  headroom, an ``hbm_headroom`` instant.  It never samples while a CUDA
  graph capture runs.

All of it is host-side bookkeeping at compile sites, outside captured
graphs.  ``BIGDL_TPU_XRAY`` (default on; ``0`` disables),
``BIGDL_TPU_HBM_HEADROOM`` (warn under this free fraction, default
0.10), ``BIGDL_TPU_HBM_EVERY_S`` (the sampling cadence, default 2 s).
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.telemetry.costmodel import ProgramCost
from bigdl_tpu_torch.telemetry.tracer import CAT_HOST, get_tracer

__all__ = [
    "FORENSIC_EVENT",
    "HBM_EVENT",
    "HBM_HEADROOM_EVENT",
    "HbmLedger",
    "ProgramRecord",
    "ProgramRegistry",
    "ProgramSignature",
    "diff_signatures",
    "get_hbm_ledger",
    "get_program_registry",
    "signature_distance",
    "hbm_headroom",
    "hbm_sample_every_s",
    "device_memory_stats",
    "instrument",
    "record_route",
    "register_program",
    "signature_of",
    "xray_enabled",
]

FORENSIC_EVENT = "recompile_forensics"
HBM_EVENT = "hbm"
HBM_HEADROOM_EVENT = "hbm_headroom"

_MAX_SIGNATURES = 32       # distinct fingerprints kept per program
_MAX_FORENSICS = 256       # forensic records kept process-wide
_MAX_SAMPLES = 512         # HBM samples kept in the ledger


# ---------------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------------
def xray_enabled() -> bool:
    """``BIGDL_TPU_XRAY=0`` turns the whole registry into no-ops."""
    return os.environ.get("BIGDL_TPU_XRAY", "1").strip() not in (
        "0", "false", "off", "no")


def hbm_headroom(default: float = 0.10) -> float:
    """Free-HBM fraction below which the ledger warns
    (``BIGDL_TPU_HBM_HEADROOM``, default 0.10 = warn under 10% free)."""
    try:
        v = float(os.environ.get("BIGDL_TPU_HBM_HEADROOM", default))
    except ValueError:
        return default
    return min(max(v, 0.0), 1.0)


def hbm_sample_every_s(default: float = 2.0) -> float:
    """Ledger sampling cadence (``BIGDL_TPU_HBM_EVERY_S``, seconds)."""
    try:
        return max(0.0, float(
            os.environ.get("BIGDL_TPU_HBM_EVERY_S", default)))
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ProgramSignature:
    """A hashable fingerprint of one compiled specialization: flattened
    abstract avals as ``(path, shape, dtype, sharding)`` rows, static
    args, and the donation mask (paths of donated subtrees)."""

    avals: Tuple[Tuple[str, Tuple[int, ...], str, str], ...] = ()
    static: Tuple[Tuple[str, str], ...] = ()
    donated: Tuple[str, ...] = ()

    def by_path(self) -> Dict[str, Tuple[Tuple[int, ...], str, str]]:
        return {p: (shape, dtype, sh) for p, shape, dtype, sh in self.avals}

    def as_dict(self) -> Dict[str, Any]:
        return {
            "avals": [list(row) for row in self.avals],
            "static": [list(kv) for kv in self.static],
            "donated": list(self.donated),
        }


def _dtype_name(dtype) -> str:
    """``float32``, ``bfloat16``, ``int32``: the JAX package's spelling,
    for torch and numpy types alike."""
    return str(dtype).replace("torch.", "")


def _walk(tree: Any, path: Tuple[str, ...], out: List[Tuple[str, Any]]):
    """(dotted path, leaf) of a tree of dicts (keys sorted, as JAX
    flattens them), lists, tuples and modules (their parameters and
    buffers by name); ``None`` is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, torch.nn.Module):
        mod = tree
        tree = dict(mod.named_parameters())
        tree.update(mod.named_buffers())
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _walk(tree[k], path + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, path + (str(i),), out)
    else:
        out.append((".".join(path) if path else "<arg>", tree))


def _leaf_aval(leaf: Any) -> Tuple[Tuple[int, ...], str, str]:
    """(shape, dtype, device) of a leaf; a tensor's device stands where
    the JAX package keeps the sharding.  Reads no value."""
    shape = tuple(int(d) for d in getattr(leaf, "shape", ()) or ())
    dtype = getattr(leaf, "dtype", None)
    dtype_s = _dtype_name(dtype) if dtype is not None \
        else type(leaf).__name__
    device = getattr(leaf, "device", None)
    return shape, dtype_s, str(device) if torch.is_tensor(leaf) else ""


def signature_of(tree: Any, static: Optional[Dict[str, Any]] = None,
                 donated: Sequence[str] = ()) -> ProgramSignature:
    """Fingerprint a tree of tensors, numpy arrays and numbers (dicts,
    lists, tuples, modules' parameters and buffers).  Paths render keys
    dotted ("cache.0.k") so forensics can name the argument that
    changed; ``donated`` names the paths ``graphs.donate`` updates in
    place.  Only shapes, types and devices are read: no device sync."""
    rows: List[Tuple[str, Tuple[int, ...], str, str]] = []
    leaves: List[Tuple[str, Any]] = []
    _walk(tree, (), leaves)
    for path, leaf in leaves:
        shape, dtype_s, dev_s = _leaf_aval(leaf)
        rows.append((path, shape, dtype_s, dev_s))
    static_rows = tuple(sorted(
        (str(k), str(v)) for k, v in (static or {}).items()))
    return ProgramSignature(avals=tuple(rows), static=static_rows,
                            donated=tuple(str(d) for d in donated))


def diff_signatures(old: ProgramSignature,
                    new: ProgramSignature) -> List[str]:
    """Human-readable changes from ``old`` to ``new`` — one string per
    changed argument/static/donation axis, naming the dimension and
    dtype ("arg `cache.k` dim 2 — 128 → 160, dtype unchanged")."""
    changes: List[str] = []
    a, b = old.by_path(), new.by_path()
    for path in [p for p in a if p not in b]:
        changes.append(f"arg `{path}` removed")
    for path, (shape, dtype_s, _) in [(p, b[p]) for p in b if p not in a]:
        changes.append(f"new arg `{path}` {shape} {dtype_s}")
    for path in [p for p in b if p in a]:
        (os_, od, osh), (ns_, nd, nsh) = a[path], b[path]
        dtype_note = ("dtype unchanged" if od == nd
                      else f"dtype {od} → {nd}")
        if os_ != ns_:
            if len(os_) != len(ns_):
                changes.append(
                    f"arg `{path}` rank — {os_} → {ns_}, {dtype_note}")
            else:
                axes = [i for i, (x, y) in enumerate(zip(os_, ns_))
                        if x != y]
                if len(axes) == 1:
                    i = axes[0]
                    changes.append(f"arg `{path}` dim {i} — "
                                   f"{os_[i]} → {ns_[i]}, {dtype_note}")
                else:
                    changes.append(
                        f"arg `{path}` dims {tuple(axes)} — "
                        f"{tuple(os_[i] for i in axes)} → "
                        f"{tuple(ns_[i] for i in axes)}, {dtype_note}")
        elif od != nd:
            changes.append(f"arg `{path}` dtype — {od} → {nd}")
        elif osh != nsh:
            changes.append(f"arg `{path}` sharding changed")
    sa, sb = dict(old.static), dict(new.static)
    for k in sorted(set(sa) | set(sb)):
        if sa.get(k) != sb.get(k):
            changes.append(f"static `{k}` — {sa.get(k, '<absent>')} → "
                           f"{sb.get(k, '<absent>')}")
    if old.donated != new.donated:
        changes.append(f"donation mask — {old.donated} → {new.donated}")
    return changes


def signature_distance(old: ProgramSignature,
                       new: ProgramSignature) -> float:
    """Edit distance between two fingerprints, one unit per changed
    axis/dtype/sharding/static/donation, plus a sub-unit relative-
    magnitude term so equal change-counts tie-break toward the closest
    extents (a 48-miss diffs against the 32 bucket, not the 8 one).
    Finer-grained than counting :func:`diff_signatures` lines (which
    fold a dim change and a dtype change on the same argument into one
    line) so the forensics diff against the genuinely nearest
    registered signature."""
    dist = 0
    mag = 0.0
    a, b = old.by_path(), new.by_path()
    dist += len([p for p in a if p not in b])
    dist += len([p for p in b if p not in a])
    for path in [p for p in b if p in a]:
        (os_, od, osh), (ns_, nd, nsh) = a[path], b[path]
        if len(os_) != len(ns_):
            dist += 1 + abs(len(os_) - len(ns_))
        else:
            for x, y in zip(os_, ns_):
                if x != y:
                    dist += 1
                    mag += abs(x - y) / (x + y + 1)
        dist += int(od != nd) + int(osh != nsh)
    sa, sb = dict(old.static), dict(new.static)
    dist += sum(1 for k in set(sa) | set(sb) if sa.get(k) != sb.get(k))
    dist += int(old.donated != new.donated)
    return dist + mag / (1.0 + mag)  # tie-break strictly < 1 unit


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@dataclass
class ProgramRecord:
    """Everything the registry knows about one named program."""

    name: str
    calls: int = 0
    compiles: int = 0
    compile_s: float = 0.0
    last_compile_unix: float = 0.0
    last_recompile_cause: str = ""
    mfu: float = 0.0
    cost: Optional[ProgramCost] = None
    config: Dict[str, Any] = field(default_factory=dict)
    signatures: List[ProgramSignature] = field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        c = self.cost
        return {
            "name": self.name,
            "calls": self.calls,
            "compiles": self.compiles,
            "compile_s": round(self.compile_s, 6),
            "last_compile_unix": self.last_compile_unix,
            "last_recompile_cause": self.last_recompile_cause,
            "mfu": round(self.mfu, 4),
            "n_signatures": len(self.signatures),
            "config": dict(self.config),
            "flops": int(c.flops) if c else 0,
            "bytes_accessed": int(c.bytes_accessed) if c else 0,
            "argument_bytes": int(c.argument_bytes) if c else 0,
            "output_bytes": int(c.output_bytes) if c else 0,
            "temp_bytes": int(c.temp_bytes) if c else 0,
        }


class ProgramRegistry:
    """Thread-safe process-wide table of compiled programs.  Call sites
    register each compile (with its fingerprint) and count steady-state
    calls; a registration whose fingerprint is new *after* warmup
    (``expected=False``) produces a forensic record + tracer instant
    naming the changed axis."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[str, ProgramRecord] = {}
        self._forensics: List[Dict[str, Any]] = []

    # -- registration --------------------------------------------------
    def register_compile(self, name: str,
                         signature: Optional[ProgramSignature] = None,
                         *, compile_s: float = 0.0,
                         cost: Optional[ProgramCost] = None,
                         expected: bool = False
                         ) -> Optional[Dict[str, Any]]:
        """Record one compile of ``name``.  Returns the forensic record
        when this was an unexpected (steady-state) new specialization,
        else ``None``.  Never raises."""
        if not xray_enabled():
            return None
        try:
            return self._register(name, signature, compile_s, cost,
                                  expected)
        except Exception:  # observability must never break the caller
            return None

    def _register(self, name, signature, compile_s, cost, expected):
        forensic = None
        with self._lock:
            rec = self._programs.setdefault(name, ProgramRecord(name))
            rec.compiles += 1
            rec.compile_s += float(compile_s)
            rec.last_compile_unix = time.time()
            if cost is not None:
                rec.cost = cost
            fresh = (signature is not None
                     and signature not in rec.signatures)
            if fresh and not expected and rec.signatures:
                nearest = min(
                    rec.signatures,
                    key=lambda s: signature_distance(s, signature))
                changes = diff_signatures(nearest, signature)
                cause = "; ".join(changes) if changes \
                    else "signature changed"
                rec.last_recompile_cause = cause
                forensic = {
                    "record": "forensic",
                    "program": name,
                    "cause": cause,
                    "changes": changes,
                    "compile_s": round(float(compile_s), 6),
                    "unix_time": time.time(),
                }
                self._forensics.append(forensic)
                del self._forensics[:-_MAX_FORENSICS]
            if fresh:
                rec.signatures.append(signature)
                del rec.signatures[:-_MAX_SIGNATURES]
        if forensic is not None:
            tr = get_tracer()
            if tr.enabled:
                tr.instant(FORENSIC_EVENT, CAT_HOST, args={
                    "program": name,
                    "cause": forensic["cause"],
                    "compile_s": forensic["compile_s"],
                })
        return forensic

    def record_call(self, name: str, n: int = 1):
        """Count ``n`` steady-state dispatches of ``name``."""
        if not xray_enabled():
            return
        with self._lock:
            self._programs.setdefault(name, ProgramRecord(name)).calls += n

    def record_mfu(self, name: str, value: float):
        with self._lock:
            rec = self._programs.get(name)
            if rec is not None:
                rec.mfu = float(value)

    def annotate(self, name: str, **config: Any):
        """Attach static build-time configuration (wire dtype, grid
        size, kernel route, ...) to a program record."""
        if not xray_enabled():
            return
        with self._lock:
            rec = self._programs.setdefault(name, ProgramRecord(name))
            rec.config.update({k: str(v) for k, v in config.items()})

    # -- introspection -------------------------------------------------
    def get(self, name: str) -> Optional[ProgramRecord]:
        with self._lock:
            return self._programs.get(name)

    def programs(self) -> List[str]:
        with self._lock:
            return sorted(self._programs)

    def records(self) -> List[Dict[str, Any]]:
        """JSON-able rows for every program (the xray table)."""
        with self._lock:
            return [self._programs[n].as_dict()
                    for n in sorted(self._programs)]

    def forensic_records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._forensics)

    def footprints(self) -> Dict[str, int]:
        """Per-program device-bytes estimate (arguments + outputs +
        temps of the cost stamp; a stamp without them falls through to
        ``bytes_accessed``): the ledger's CPU fallback."""
        out: Dict[str, int] = {}
        with self._lock:
            for name, rec in self._programs.items():
                c = rec.cost
                if c is None:
                    continue
                f = int(c.argument_bytes + c.output_bytes + c.temp_bytes)
                if f <= 0:
                    f = int(c.bytes_accessed)
                if f > 0:
                    out[name] = f
        return out

    def clear(self):
        with self._lock:
            self._programs.clear()
            self._forensics.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    # -- persistence (CostTable-style atomic blob) ---------------------
    def persist(self, path: str):
        blob = {
            "record": "xray_table",
            "unix_time": time.time(),
            "programs": self.records(),
            "forensics": self.forensic_records()[-_MAX_FORENSICS:],
        }
        part = f"{path}.{os.getpid()}.part"
        with open(part, "w") as f:
            json.dump(blob, f, sort_keys=True, default=str)
        os.replace(part, path)

    @staticmethod
    def load_blob(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(blob, dict) \
                or blob.get("record") != "xray_table":
            return None
        return blob


# ---------------------------------------------------------------------------
# generic call-site wrapper
# ---------------------------------------------------------------------------
class _Instrumented:
    """Registering proxy around a compiled callable: counts calls by a
    fast (shape, dtype) key, registers a full fingerprint on first
    sight of a key, and forwards every other attribute to the wrapped
    function."""

    def __init__(self, name: str, fn: Callable,
                 static: Optional[Dict[str, Any]] = None,
                 donated: Sequence[str] = (),
                 expected: bool = True,
                 registry: Optional["ProgramRegistry"] = None):
        self._name = name
        self._fn = fn
        self._static = dict(static or {})
        self._donated = tuple(donated)
        self._expected = expected
        self._registry = registry
        self._seen: set = set()
        self._lock = threading.Lock()

    def _reg(self) -> "ProgramRegistry":
        return self._registry if self._registry is not None \
            else get_program_registry()

    def __call__(self, *args, **kwargs):
        reg = self._reg()
        leaves: List[Tuple[str, Any]] = []
        _walk((args, kwargs), (), leaves)
        key = tuple(_leaf_aval(leaf) for _, leaf in leaves)
        with self._lock:
            miss = key not in self._seen
            self._seen.add(key)
        if miss:
            sig = signature_of((args, kwargs) if kwargs else args,
                               static=self._static,
                               donated=self._donated)
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
            reg.register_compile(self._name, sig,
                                 compile_s=time.perf_counter() - t0,
                                 expected=self._expected)
            return out
        reg.record_call(self._name)
        return self._fn(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._fn, item)


def instrument(name: str, fn: Callable,
               static: Optional[Dict[str, Any]] = None,
               donated: Sequence[str] = (),
               expected: bool = True,
               registry: Optional[ProgramRegistry] = None) -> Callable:
    """Wrap a compiled callable so every call is accounted to ``name`` in
    the program registry (attribute access forwards to ``fn``)."""
    if not xray_enabled():
        return fn
    return _Instrumented(name, fn, static=static, donated=donated,
                         expected=expected, registry=registry)


def register_program(name: str, signature: Optional[ProgramSignature],
                     program: Any, seconds: float, *,
                     cost: Optional[ProgramCost] = None,
                     expected: bool = False,
                     registry: Optional[ProgramRegistry] = None
                     ) -> Optional[Dict[str, Any]]:
    """:meth:`ProgramRegistry.register_compile` for what
    ``graphs.compile`` returned: a captured graph hands over its capture
    seconds and the kernels its capture launched (``launches``, kept as
    static config); the CPU's eager function, the ``seconds`` its first
    call took."""
    reg = registry if registry is not None else get_program_registry()
    launches = getattr(program, "launches", None)
    if launches is not None:
        reg.annotate(name, launches=dict(sorted(launches.items())))
    return reg.register_compile(
        name, signature,
        compile_s=getattr(program, "capture_seconds", seconds),
        cost=cost, expected=expected)


_routes_seen: set = set()
_routes_lock = threading.Lock()


def record_route(kernel: str, route: str) -> None:
    """Register ``kernel:<kernel>`` with its route (``cuda``, or
    ``plain`` for a CPU tensor) as static config, once per route seen
    (the counterpart of the Pallas kernels' ``pallas:<kernel>``
    records): a route that flips at steady state becomes a forensic."""
    key = (kernel, route)
    if key in _routes_seen or not xray_enabled():
        return
    with _routes_lock:
        if key in _routes_seen:
            return
        _routes_seen.add(key)
    get_program_registry().register_compile(
        f"kernel:{kernel}", signature_of({}, static={"route": route}),
        expected=(route == "cuda"))


def device_memory_stats() -> Optional[dict]:
    """The card's allocator, in the JAX package's keys (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``), or None: no card, CUDA not
    started in this process, or a CUDA graph capture running (the check
    and the read hold the capture lock, so none starts meanwhile)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    from bigdl_tpu_torch.utils import graphs

    def read():
        dev = torch.cuda.current_device()
        st = torch.cuda.memory_stats(dev)
        return {
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(dev).total_memory),
        }

    return graphs.unless_capturing(read)


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------
class HbmLedger:
    """Samples device memory on the metrics cadence and attributes it
    to registered programs.  ``stats_fn`` defaults to
    :func:`device_memory_stats`; when it yields nothing (the CPU) the
    ledger falls back to the registry's per-program footprints
    (``source="estimate"``)."""

    def __init__(self, registry: Optional[ProgramRegistry] = None,
                 *, stats_fn: Optional[Callable[[], Optional[dict]]] = None,
                 headroom: Optional[float] = None,
                 every_s: Optional[float] = None):
        self._registry = registry
        self._stats_fn = stats_fn
        self._headroom = hbm_headroom() if headroom is None \
            else float(headroom)
        self.every_s = hbm_sample_every_s() if every_s is None \
            else max(0.0, float(every_s))
        self._lock = threading.Lock()
        self._samples: List[Dict[str, Any]] = []
        self._last_sample = 0.0
        self.warnings = 0
        self.peak_bytes = 0
        # dynamic resident-bytes contributions (name -> () -> bytes):
        # long-lived buffers whose size changes at runtime without a
        # recompile — e.g. the serving engine's paged-KV pool reports
        # pages_in_use * page_bytes here, so the Perfetto hbm lane (and
        # the estimate-source samples on CPU) show retirement actually
        # returning memory.  Program footprints can't express that:
        # they are per-compile constants.
        self._resident: Dict[str, Callable[[], Optional[int]]] = {}

    def _reg(self) -> ProgramRegistry:
        return self._registry if self._registry is not None \
            else get_program_registry()

    def _stats(self) -> Optional[dict]:
        if self._stats_fn is not None:
            try:
                return self._stats_fn()
            except Exception:
                return None
        return device_memory_stats()

    def add_resident(self, name: str,
                     fn: Callable[[], Optional[int]]) -> None:
        """Register a dynamic resident-bytes contribution.  ``fn`` is
        called (never raising into the sample) at every ledger sample
        and returns the bytes currently held, or None to skip."""
        with self._lock:
            self._resident[name] = fn

    def remove_resident(self, name: str) -> None:
        with self._lock:
            self._resident.pop(name, None)

    def _resident_bytes(self) -> Dict[str, int]:
        with self._lock:
            fns = dict(self._resident)
        out: Dict[str, int] = {}
        for name, fn in fns.items():
            try:
                b = fn()
            except Exception:
                b = None
            if b is not None:
                out[name] = int(b)
        return out

    def maybe_sample(self) -> Optional[Dict[str, Any]]:
        """Rate-limited :meth:`sample` (the metrics-cadence hook)."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_sample < self.every_s:
                return None
            self._last_sample = now
        return self.sample()

    def sample(self) -> Optional[Dict[str, Any]]:
        """Take one ledger sample; emits an ``hbm`` instant (Perfetto
        counter lane) and an ``hbm_headroom`` instant when free HBM
        drops under the threshold.  Never raises."""
        if not xray_enabled():
            return None
        try:
            return self._sample()
        except Exception:
            return None

    def _sample(self):
        stats = self._stats()
        footprints = self._reg().footprints()
        if stats:
            source = "device"
            in_use = int(stats.get("bytes_in_use", 0))
            peak = int(stats.get("peak_bytes_in_use", in_use))
            limit = stats.get("bytes_limit")
            limit = int(limit) if limit else None
        else:
            source = "estimate"
            in_use = max(footprints.values(), default=0)
            peak = in_use
            limit = None
        total = sum(footprints.values())
        top = [
            {"program": name, "bytes": b,
             "frac": round(b / total, 4) if total else 0.0}
            for name, b in sorted(footprints.items(),
                                  key=lambda kv: -kv[1])[:3]
        ]
        frac_free = (1.0 - in_use / limit) if limit else None
        resident = self._resident_bytes()
        rec = {
            "record": "hbm",
            "unix_time": time.time(),
            "source": source,
            "bytes_in_use": in_use,
            "peak_bytes_in_use": peak,
            "bytes_limit": limit,
            "frac_free": round(frac_free, 4) if frac_free is not None
            else None,
            "top": top,
        }
        if resident:
            rec["resident"] = resident
            rec["resident_bytes"] = sum(resident.values())
        with self._lock:
            self._samples.append(rec)
            del self._samples[:-_MAX_SAMPLES]
            self.peak_bytes = max(self.peak_bytes, peak)
        tr = get_tracer()
        if tr.enabled:
            args = {
                "bytes_in_use": in_use,
                "peak_bytes_in_use": peak,
                "bytes_limit": limit or 0,
                "source": source,
            }
            # one Perfetto counter per resident contribution: the
            # paged-KV lane rising on admission and falling at
            # retirement is the readout that paging frees memory
            for name, b in resident.items():
                args[f"resident_{name}"] = b
            tr.instant(HBM_EVENT, CAT_HOST, args=args)
        if frac_free is not None and frac_free < self._headroom:
            with self._lock:
                self.warnings += 1
            if tr.enabled:
                tr.instant(HBM_HEADROOM_EVENT, CAT_HOST, args={
                    "frac_free": round(frac_free, 4),
                    "bytes_in_use": in_use,
                    "bytes_limit": limit,
                    "top_program": top[0]["program"] if top else "",
                })
        return rec

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._samples)

    def report(self) -> Dict[str, Any]:
        with self._lock:
            last = self._samples[-1] if self._samples else None
            return {
                "record": "hbm_report",
                "samples": len(self._samples),
                "warnings": self.warnings,
                "peak_bytes": self.peak_bytes,
                "last": last,
            }

    def clear(self):
        with self._lock:
            self._samples.clear()
            self._last_sample = 0.0
            self.warnings = 0
            self.peak_bytes = 0


# ---------------------------------------------------------------------------
# process-wide singletons
# ---------------------------------------------------------------------------
_REGISTRY: Optional[ProgramRegistry] = None
_LEDGER: Optional[HbmLedger] = None
_GLOBAL_LOCK = threading.Lock()


def get_program_registry() -> ProgramRegistry:
    global _REGISTRY
    with _GLOBAL_LOCK:
        if _REGISTRY is None:
            _REGISTRY = ProgramRegistry()
        return _REGISTRY


def get_hbm_ledger() -> HbmLedger:
    global _LEDGER
    with _GLOBAL_LOCK:
        if _LEDGER is None:
            _LEDGER = HbmLedger()
        return _LEDGER
