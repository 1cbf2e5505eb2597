"""Elastic supervision: the per-host agent and the elastic optimizer
(counterpart of bigdl_tpu/distributed/elastic.py).

Recovery state machine::

    HEALTHY --(peer heartbeat stale / worker dead / join request)-->
    DEGRADED --(SIGTERM own worker, grace, SIGKILL)--> DRAIN
    --> RENDEZVOUS (new generation over the survivors)
    --> RESTORE (fresh worker resumes from the last COMMIT)
    --> HEALTHY

One :class:`ElasticAgent` runs per host.  It is a pure-Python supervisor
that heartbeats through the
:class:`~bigdl_tpu_torch.distributed.rendezvous.FileRendezvous`, spawns
the training process (``python -m bigdl_tpu_torch.distributed.worker``)
once per generation with the ``BIGDL_ELASTIC_*`` environment, and reacts
to membership changes.  Peer anomalies flow through the telemetry
:class:`Watchdog` (counter ``peer_failures``), whose ``on_anomaly`` hook
is the recovery trigger.  The agent ships the elastic lifecycle (peer
death, drain, generation bump, rejoin) through an events-only
:class:`TelemetryShipper` clock-aligned by the rendezvous heartbeat, and
its flight recorder watches the same watchdog.

The worker is a fresh process per generation, so "re-form the dp mesh
over the survivors" is literal: it makes a process group of the new
world size, builds the mesh over it, and the per-rank batch rescales
(``DataSet.sharded`` divides the global batch by the world), so the
global batch, and with it the loss curve, survives a re-formation.

Policies (what an agent does when ITS worker dies): ``restart`` stays
in the job and re-rendezvouses (the survivor's side); ``shrink``
resigns through the rendezvous's ``left-`` marker so the others re-form
without this host.

Knobs: ``BIGDL_TPU_ELASTIC_HEARTBEAT_S`` (0.25),
``BIGDL_TPU_ELASTIC_STALE_S`` (3.0), ``BIGDL_TPU_ELASTIC_GRACE_S``
(5.0, the SIGTERM -> SIGKILL drain window).
"""
from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from bigdl_tpu_torch.distributed.checkpoint import latest_committed
from bigdl_tpu_torch.distributed.rendezvous import FileRendezvous
from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.serving.metrics import PeriodicMetricsLogger
from bigdl_tpu_torch.telemetry import debug_server, flightrecorder
from bigdl_tpu_torch.telemetry.cluster import (EVENT_DRAIN, EVENT_GEN_BUMP,
                                               EVENT_PEER_DEAD,
                                               EVENT_PEER_JOIN, EVENT_REJOIN,
                                               TelemetryShipper)
from bigdl_tpu_torch.telemetry.watchdog import Watchdog

logger = logging.getLogger("bigdl_tpu_torch.distributed")

# worker exit codes the agent understands
EXIT_OK = 0        # end trigger reached — training is finished
EXIT_PREEMPTED = 3  # drained on request_stop: state committed, rejoinable


class ElasticAgent:
    """Per-host supervisor: rendezvous -> spawn worker -> monitor."""

    def __init__(self, workdir: str, host_id: str,
                 policy: str = "restart",
                 worker_argv: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 grace_s: Optional[float] = None,
                 rendezvous_timeout_s: float = 120.0,
                 max_generations: int = 8):
        if policy not in ("restart", "shrink"):
            raise ValueError(f"policy {policy!r}: restart or shrink")
        self.workdir = os.path.abspath(workdir)
        self.host_id = str(host_id)
        self.policy = policy
        self.worker_argv = worker_argv or [
            sys.executable, "-m", "bigdl_tpu_torch.distributed.worker"]
        self.env = dict(env) if env is not None else dict(os.environ)
        self.grace_s = (float(os.environ.get("BIGDL_TPU_ELASTIC_GRACE_S",
                                             "5.0"))
                        if grace_s is None else grace_s)
        self.rendezvous_timeout_s = rendezvous_timeout_s
        self.max_generations = max_generations
        os.makedirs(self.workdir, exist_ok=True)
        self.rdzv = FileRendezvous(
            os.path.join(self.workdir, "rendezvous"), self.host_id)
        self._recover_reason: Optional[str] = None
        self.watchdog = Watchdog(
            log=logger.warning,
            on_anomaly=self._on_anomaly)  # peer_failures -> DEGRADED
        self.generations_run = 0
        # events-only shipper (tracer=None): tests run several agents
        # in ONE process sharing the global tracer, so spans ship from
        # the worker processes; the agent ships the elastic lifecycle —
        # peer death, drain, gen bump, rejoin — each flushed immediately
        # so a postmortem sees them even if the agent dies next
        self.telemetry_dir = (self.env.get("BIGDL_TPU_TELEMETRY_DIR")
                              or os.path.join(self.workdir, "telemetry"))
        self.shipper = TelemetryShipper(
            self.telemetry_dir, self.host_id, tracer=None,
            clock_offset_fn=self.rdzv.clock_offset_sample)
        # live ops plane: the agent is the process most likely to
        # outlive a dying worker, so its black box captures the elastic
        # lifecycle (peer death -> drain) around the crash
        self.flight = flightrecorder.get_flight_recorder(
            out_dir=self.telemetry_dir)
        if self.flight is not None:
            self.flight.set_watchdog(self.watchdog)
        self._detach_debug = debug_server.attach_engine(
            f"agent-{self.host_id}", role="agent",
            status=lambda: {"host": self.host_id,
                            "generations_run": self.generations_run,
                            "policy": self.policy})

    def _ship_event(self, kind: str, **args):
        try:
            self.shipper.event(kind, **args)
            self.shipper.ship_now()
        except Exception:
            logger.warning("elastic agent %s: telemetry ship failed",
                           self.host_id, exc_info=True)

    def _on_anomaly(self, counter: str, message: str):
        if counter == "peer_failures" and self._recover_reason is None:
            self._recover_reason = message

    # -- lifecycle -----------------------------------------------------
    def run(self) -> str:
        """Supervise until the job finishes ("done"), this host resigns
        ("left"), or the generation budget runs out ("exhausted")."""
        gen = 0
        status: Optional[str] = None
        try:
            while self.generations_run < self.max_generations:
                manifest = self.rdzv.rendezvous(
                    after_gen=gen, timeout_s=self.rendezvous_timeout_s)
                gen = manifest["gen"]
                self.generations_run += 1
                self.shipper.set_generation(gen)
                if status == "drained":
                    # a drained worker landing in a new generation is
                    # the rejoin half of preemption
                    self._ship_event(EVENT_REJOIN, gen=gen)
                self._ship_event(EVENT_GEN_BUMP, gen=gen,
                                 members=list(manifest["members"]))
                status = self._run_generation(manifest)
                logger.info("elastic agent %s: generation %d -> %s",
                            self.host_id, gen, status)
                if status == "done":
                    return "done"
                if status == "left":
                    return "left"
            return "exhausted"
        finally:
            self._write_report()
            self._detach_debug()
            try:
                self.shipper.close()
            except Exception:
                pass

    def _write_report(self):
        with open(os.path.join(
                self.workdir,
                f"agent-{self.host_id}-watchdog.json"), "w") as f:
            json.dump(self.watchdog.report(), f)

    # -- one generation ------------------------------------------------
    def _spawn(self, manifest: dict) -> subprocess.Popen:
        members = manifest["members"]
        env = dict(self.env)
        env.update({
            "BIGDL_ELASTIC_WORKDIR": self.workdir,
            "BIGDL_ELASTIC_GEN": str(manifest["gen"]),
            "BIGDL_ELASTIC_RANK": str(members.index(self.host_id)),
            "BIGDL_ELASTIC_WORLD": str(len(members)),
            "BIGDL_ELASTIC_COORD": f"127.0.0.1:{manifest['port']}",
            "BIGDL_ELASTIC_CKPT": os.path.join(self.workdir, "ckpt"),
            "BIGDL_ELASTIC_HOST": self.host_id,
        })
        # workers ship spans/metrics into the same run dir so the
        # offline merge sees one lane per host (telemetry/cluster.py)
        env.setdefault("BIGDL_TPU_TELEMETRY_DIR", self.telemetry_dir)
        proc = subprocess.Popen(
            self.worker_argv, env=env, cwd=self.workdir,
            start_new_session=True)  # kill -9 tests target the pid file
        with open(os.path.join(
                self.workdir,
                f"worker-g{manifest['gen']}-{self.host_id}.pid"),
                "w") as f:
            f.write(str(proc.pid))
        return proc

    def _stop_worker(self, proc: subprocess.Popen):
        """SIGTERM (worker drains + commits + exits EXIT_PREEMPTED),
        grace window, then SIGKILL."""
        if proc.poll() is not None:
            return
        try:
            proc.terminate()
            proc.wait(timeout=self.grace_s)
        except subprocess.TimeoutExpired:
            logger.warning("worker %d ignored SIGTERM for %.1fs; killing",
                           proc.pid, self.grace_s)
            proc.kill()
            proc.wait()
        except ProcessLookupError:
            pass

    def _run_generation(self, manifest: dict) -> str:
        gen, members = manifest["gen"], manifest["members"]
        self._recover_reason = None
        proc = self._spawn(manifest)
        poll_s = min(self.rdzv.heartbeat_s, 0.25)
        try:
            while True:
                self.rdzv.heartbeat(gen=gen)
                rc = proc.poll()
                if rc is not None:
                    if rc == EXIT_OK:
                        return "done"
                    if rc == EXIT_PREEMPTED:
                        return "drained"  # re-rendezvous and resume
                    # our own worker died
                    if self.policy == "shrink":
                        logger.warning(
                            "elastic agent %s: worker rc=%d; resigning "
                            "(policy=shrink)", self.host_id, rc)
                        self.rdzv.retire()
                        return "left"
                    logger.warning(
                        "elastic agent %s: worker rc=%d; re-forming "
                        "(policy=restart)", self.host_id, rc)
                    return "worker_failed"
                alive = set(self.rdzv.alive_hosts())
                dead = [h for h in members
                        if h != self.host_id and h not in alive]
                joiners = sorted(alive - set(members))
                if dead:
                    for h in dead:
                        age = self.rdzv.heartbeat_age(h)
                        self.watchdog.peer_event(
                            h, "dead", age_s=age or 0.0)
                        self._ship_event(EVENT_PEER_DEAD, peer=h,
                                         age_s=round(age or 0.0, 3))
                elif joiners:
                    for h in joiners:
                        self.watchdog.peer_event(h, "join")
                        self._ship_event(EVENT_PEER_JOIN, peer=h)
                if self._recover_reason is not None:
                    # DEGRADED -> DRAIN: stop our worker cleanly (it
                    # commits what it can), then re-form over survivors
                    self._ship_event(EVENT_DRAIN,
                                     reason=self._recover_reason)
                    # black-box the pre-drain window: after re-form the
                    # dead generation's live state is gone for good
                    if self.flight is not None:
                        self.flight.dump(trigger="peer_failure",
                                         note=self._recover_reason)
                    self._stop_worker(proc)
                    return "recover"
                time.sleep(poll_s)
        finally:
            # never leak a live worker past the monitor (error paths)
            if proc.poll() is None:
                self._stop_worker(proc)


class ElasticDistriOptimizer(DistriOptimizer):
    """DistriOptimizer wired for elastic supervision: sharded
    checkpointing on, automatic resume from the newest commit under the
    checkpoint root, and SIGTERM/SIGINT mapped to a graceful
    ``request_stop`` (drain async work, force a final commit, join the
    writer) so a preempted worker leaves restorable state behind.
    """

    def __init__(self, model, dataset, criterion, end_trigger=None,
                 batch_size=None, mesh=None, ckpt_root=None,
                 ckpt_trigger=None, install_signal_handlers: bool = True,
                 **kwargs):
        kwargs.setdefault("sharded_checkpoint", True)
        super().__init__(model, dataset, criterion, end_trigger,
                         batch_size, mesh=mesh, **kwargs)
        if ckpt_root:
            if ckpt_trigger is not None:
                self.set_checkpoint(ckpt_root, ckpt_trigger)
            else:
                self.checkpoint_path = ckpt_root
            if latest_committed(ckpt_root) is not None:
                self.resume_from(ckpt_root)
        if install_signal_handlers:
            self._install_signal_handlers()

    def _install_signal_handlers(self):
        def handler(signum, frame):
            logger.warning("signal %d: draining for graceful stop",
                           signum)
            self.request_stop()

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:  # not the main thread (tests drive inline)
            logger.warning("not on main thread; signal handlers skipped")

    def optimize(self):
        """Training with the periodic metrics cadence attached: the
        canonical train log line (iteration/epoch/loss + phase summary,
        now incl. MFU and bytes/s) every ``BIGDL_TPU_METRICS_EVERY_S``
        seconds — a long elastic run stays observable between the
        loop's own log windows.  Stopped on drain and on exit."""
        self._periodic_log = PeriodicMetricsLogger(
            self.train_log_line, sink=logger.info).start()
        try:
            return super().optimize()
        finally:
            self._periodic_log.close()

    def request_stop(self) -> None:
        # drain: silence the cadence before async teardown so a final
        # half-updated summary line never interleaves with the drain
        p = getattr(self, "_periodic_log", None)
        if p is not None:
            p.close()
        super().request_stop()

    @property
    def stopped_early(self) -> bool:
        """True when optimize() exited on request_stop rather than the
        end trigger — the worker maps this to EXIT_PREEMPTED."""
        return self._stop_requested
