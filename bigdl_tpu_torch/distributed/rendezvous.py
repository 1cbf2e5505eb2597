"""File-based rendezvous for elastic training groups (the port's own copy
of bigdl_tpu/distributed/rendezvous.py, which it reads and writes
interchangeably).

The control plane deliberately needs nothing but a shared directory
with POSIX rename — the same substrate the sharded checkpoint already
requires — so the elastic harness runs anywhere the checkpoints do
(reference analog: Spark's driver was the implicit membership service;
here membership is explicit and crash-evident on disk).

Files under the rendezvous dir:

* ``hb-<host>.json``  — heartbeat ``{t, gen, pid}``, rewritten (atomic
  rename) every ``BIGDL_TPU_ELASTIC_HEARTBEAT_S``; a host whose
  heartbeat is older than ``BIGDL_TPU_ELASTIC_STALE_S`` is dead.
* ``gen-<g>.json``    — generation manifest ``{gen, members, port, t}``
  written once by the coordinator (the lexicographically smallest
  alive host).  Generations only grow; the newest manifest a host is
  named in is its marching order.
* ``left-<host>.json``— a host's explicit resignation (policy
  ``shrink``): excluded from membership even while its heartbeat is
  still fresh.

Wall-clock ``time.time()`` in heartbeats is only ever compared between
processes on the SAME filesystem/host clock domain (the supported
deployment: one shared dir per job).
"""
from __future__ import annotations

import json
import os
import re
import socket
import time
from typing import List, Optional

_HB_RE = re.compile(r"hb-(.+)\.json")
_GEN_RE = re.compile(r"gen-(\d+)\.json")


def _default(name: str, fallback: float) -> float:
    return float(os.environ.get(name, fallback))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _atomic_json(path: str, blob: dict) -> None:
    tmp = f"{path}.{os.getpid()}.part"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # racing a rename / partial dir listing


class FileRendezvous:
    """One host's handle on the shared rendezvous directory."""

    def __init__(self, root: str, host_id: str,
                 heartbeat_s: Optional[float] = None,
                 stale_s: Optional[float] = None):
        self.root = root
        self.host_id = str(host_id)
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None
                            else _default("BIGDL_TPU_ELASTIC_HEARTBEAT_S",
                                          0.25))
        self.stale_s = (stale_s if stale_s is not None
                        else _default("BIGDL_TPU_ELASTIC_STALE_S", 3.0))
        os.makedirs(root, exist_ok=True)
        self._last_beat = 0.0

    # -- heartbeats ----------------------------------------------------
    def heartbeat(self, gen: int = 0, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_beat < self.heartbeat_s:
            return
        self._last_beat = now
        _atomic_json(os.path.join(self.root, f"hb-{self.host_id}.json"),
                     {"t": time.time(), "gen": int(gen), "pid": os.getpid()})

    def clock_offset_sample(self, gen: int = 0) -> float:
        """One clock-offset estimate via the heartbeat exchange: this
        host's wall clock minus the shared filesystem's clock.

        A heartbeat write carries our ``time.time()`` in the blob while
        the filesystem stamps the same write's mtime from ITS clock —
        two readings of (approximately) one instant in the two domains.
        Aligning every host's timestamps by subtracting its offset puts
        all segments on the filesystem clock, which is what makes the
        merged cluster trace's lanes comparable (telemetry/cluster.py).
        """
        self.heartbeat(gen=gen, force=True)
        path = os.path.join(self.root, f"hb-{self.host_id}.json")
        blob = _read_json(path)
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return 0.0
        if not blob:  # raced our own next rewrite; sample again later
            return 0.0
        return float(blob.get("t", mtime)) - mtime

    def retire(self) -> None:
        """Resign from the group (policy ``shrink``): membership drops
        this host at the next rendezvous even if its process lingers."""
        _atomic_json(os.path.join(self.root, f"left-{self.host_id}.json"),
                     {"t": time.time()})

    def alive_hosts(self) -> List[str]:
        """Hosts with a fresh heartbeat and no resignation, sorted."""
        now = time.time()
        out = []
        for name in os.listdir(self.root):
            m = _HB_RE.fullmatch(name)
            if not m:
                continue
            host = m.group(1)
            if os.path.exists(os.path.join(self.root,
                                           f"left-{host}.json")):
                continue
            blob = _read_json(os.path.join(self.root, name))
            if blob and now - blob.get("t", 0.0) <= self.stale_s:
                out.append(host)
        return sorted(out)

    def heartbeat_age(self, host: str) -> Optional[float]:
        blob = _read_json(os.path.join(self.root, f"hb-{host}.json"))
        return None if blob is None else time.time() - blob.get("t", 0.0)

    # -- generations ---------------------------------------------------
    def latest_generation(self) -> Optional[dict]:
        best = None
        for name in os.listdir(self.root):
            m = _GEN_RE.fullmatch(name)
            if not m:
                continue
            g = int(m.group(1))
            if best is None or g > best[0]:
                best = (g, name)
        if best is None:
            return None
        return _read_json(os.path.join(self.root, best[1]))

    def next_generation(self, members: List[str]) -> dict:
        """Coordinator-only: publish the next generation manifest."""
        latest = self.latest_generation()
        g = (latest["gen"] + 1) if latest else 1
        blob = {"gen": g, "members": sorted(members), "port": free_port(),
                "t": time.time()}
        _atomic_json(os.path.join(self.root, f"gen-{g}.json"), blob)
        return blob

    def rendezvous(self, after_gen: int = 0, timeout_s: float = 60.0,
                   settle_s: Optional[float] = None) -> dict:
        """Block until a generation newer than ``after_gen`` names this
        host; the coordinator (smallest alive host id) publishes it.

        ``settle_s``: how long the coordinator lets membership stabilise
        before cutting the manifest (default 2 heartbeats + stale floor
        fraction) — gives a just-started peer time to land a heartbeat.
        """
        if settle_s is None:
            settle_s = 2.0 * self.heartbeat_s
        deadline = time.monotonic() + timeout_s
        settled_at = None
        members: List[str] = []
        while time.monotonic() < deadline:
            self.heartbeat(gen=after_gen, force=True)
            latest = self.latest_generation()
            if (latest and latest["gen"] > after_gen
                    and self.host_id in latest["members"]):
                return latest
            alive = self.alive_hosts()
            if self.host_id not in alive:
                alive = sorted(alive + [self.host_id])
            if alive != members:
                members, settled_at = alive, time.monotonic()
            coordinator = members[0]
            if (coordinator == self.host_id and settled_at is not None
                    and time.monotonic() - settled_at >= settle_s):
                return self.next_generation(members)
            time.sleep(min(self.heartbeat_s, 0.1))
        raise TimeoutError(
            f"rendezvous: no generation > {after_gen} naming "
            f"{self.host_id!r} within {timeout_s:.0f}s "
            f"(alive={self.alive_hosts()})")
