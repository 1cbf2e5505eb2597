"""Workload recording: live traffic as replayable JSONL (counterpart
of bigdl_tpu/telemetry/workload.py, the same schema and ``VERSION``, so
a stream recorded by either package loads in the other).

:class:`WorkloadRecorder` writes one JSON line per submitted request:
its arrival time relative to the recorder's start, the prompt or the
sample's shape, the sampling parameters and the **resolved** seed (the
decode engine defaults the seed to the request id, so the stream replays
the same tokens even when callers passed none).

Arm it with ``BIGDL_TPU_WORKLOAD_RECORD=<path>`` (every engine of the
process records into one stream) or with :func:`arm`.  Recording is
append-only, takes a lock and runs on the host only.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

VERSION = 1

KIND_DECODE = "decode"
KIND_SERVE = "serve"


class WorkloadRecorder:
    """Append-only JSONL recorder of request arrivals.

    The first record is a header (version, wall time, host pid); every
    subsequent line is one request with ``t`` seconds relative to the
    recorder's epoch — replay only needs the relative spacing.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._n = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # one persistent handle: an open() per submit is measurable on
        # the engine hot path; line-buffered writes flush per record so
        # a crash still leaves every completed line on disk
        self._f = open(path, "w", buffering=1)
        self._f.write(json.dumps({
            "record": "workload_header", "version": VERSION,
            "unix_time": round(time.time(), 3), "pid": os.getpid(),
        }) + "\n")

    def _write(self, rec: Dict[str, Any]):
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._lock:
            self._n += 1
            if not self._f.closed:
                self._f.write(line)

    def record_decode(self, rid: int, prompt, max_new: int, *,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, seed: Optional[int] = None,
                      deadline_ms: Optional[float] = None):
        """One decode request.  ``seed`` must be the RESOLVED seed the
        engine actually keyed sampling with (the rid-derived default
        included) — that is what makes the replay bit-equal."""
        self._write({
            "record": "request", "kind": KIND_DECODE,
            "t": round(time.perf_counter() - self._epoch, 6),
            "rid": int(rid), "prompt": [int(t) for t in prompt],
            "max_new": int(max_new), "temperature": float(temperature),
            "top_k": int(top_k), "top_p": float(top_p),
            "seed": None if seed is None else int(seed),
            "deadline_ms": deadline_ms,
        })

    def record_serve(self, rid: int, shape, dtype: str, *,
                     deadline_ms: Optional[float] = None):
        """One serving request: the shape/dtype is all a replay needs
        (bucket selection + padding are shape functions)."""
        self._write({
            "record": "request", "kind": KIND_SERVE,
            "t": round(time.perf_counter() - self._epoch, 6),
            "rid": int(rid), "shape": [int(d) for d in shape],
            "dtype": str(dtype), "deadline_ms": deadline_ms,
        })

    @property
    def count(self) -> int:
        return self._n

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()


def load_workload(path: str) -> List[Dict[str, Any]]:
    """Read a recorded stream: request records sorted by arrival
    offset.  Raises ``ValueError`` on a missing/alien header so a
    replay never runs garbage."""
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    if not recs or recs[0].get("record") != "workload_header":
        raise ValueError(f"{path}: not a workload recording")
    if recs[0].get("version", 0) > VERSION:
        raise ValueError(
            f"{path}: workload version {recs[0]['version']} is newer "
            f"than this reader ({VERSION})")
    reqs = [r for r in recs[1:] if r.get("record") == "request"]
    reqs.sort(key=lambda r: r.get("t", 0.0))
    return reqs


# --------------------------------------------------------------------------
# process-global recorder (what the engines consult per submit)
# --------------------------------------------------------------------------

_GLOBAL: Optional[WorkloadRecorder] = None
_GLOBAL_LOCK = threading.Lock()
_ENV_CHECKED = False


def arm(path: str) -> WorkloadRecorder:
    """Start recording every engine's submits to ``path``."""
    global _GLOBAL, _ENV_CHECKED
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = WorkloadRecorder(path)
        _ENV_CHECKED = True
    return _GLOBAL


def disarm():
    global _GLOBAL, _ENV_CHECKED
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = None
        _ENV_CHECKED = True


def recorder() -> Optional[WorkloadRecorder]:
    """The armed recorder, or None.  First call resolves
    ``BIGDL_TPU_WORKLOAD_RECORD`` so exporting the env var is enough —
    no code change at any engine call site."""
    global _GLOBAL, _ENV_CHECKED
    if _GLOBAL is None and not _ENV_CHECKED:
        with _GLOBAL_LOCK:
            if _GLOBAL is None and not _ENV_CHECKED:
                _ENV_CHECKED = True
                path = os.environ.get("BIGDL_TPU_WORKLOAD_RECORD")
                if path:
                    _GLOBAL = WorkloadRecorder(path)
    return _GLOBAL
