"""The port's elastic plane against the JAX package's, on the CPU
(tests/test_elastic.py:334-490, tests/test_multihost.py:257-440).

- ``FileRendezvous``: membership, generations, resignation and stale
  heartbeats, a port host and a JAX host in one directory agreeing;
- the watchdog's peer events driving the agent's recovery hook, and the
  DEGRADED -> DRAIN path dumping a flight bundle named for the peer;
- ``fp16_compress`` bit for bit against JAX's, and its bound;
- the kill -9 scenario with the port's worker (``python -m
  bigdl_tpu_torch.distributed.worker`` on gloo, the MLP 8-16-2): one of
  two workers killed after the first commit, its agent resigns, the
  survivor re-forms at world 1 from the last COMMIT, and the composed
  losses and final parameters match the uninterrupted world-1 run
  (rtol 1e-4 / atol 1e-5, JAX's tolerance); the shipped telemetry holds
  both hosts and the elastic sequence in order;
- the join scenario: a second agent arrives, the first drains, and both
  finish generation 2 in lockstep (equal digests).

Every agent runs in a thread joined with a time limit, and every worker
process has one (the agent kills it on the way out).  The two scenarios
are marked ``slow`` (about 28 and 20 s), as the JAX package's are.
"""
import glob
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

from bigdl_tpu.distributed.compression import fp16_compress as jax_fp16
from bigdl_tpu.distributed.rendezvous import FileRendezvous as JaxRdzv
from bigdl_tpu_torch.distributed.compression import fp16_compress
from bigdl_tpu_torch.distributed.elastic import ElasticAgent
from bigdl_tpu_torch.distributed.rendezvous import FileRendezvous
from bigdl_tpu_torch.telemetry import flightrecorder
from bigdl_tpu_torch.telemetry.watchdog import Watchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEARTBEAT_S = 0.25
STALE_S = 10.0


@pytest.fixture(autouse=True)
def clean_globals(monkeypatch):
    for knob in ("BIGDL_TPU_DEBUG_PORT", "BIGDL_TPU_TELEMETRY_DIR"):
        monkeypatch.delenv(knob, raising=False)
    flightrecorder.set_global(None)
    yield
    flightrecorder.set_global(None)


def test_file_rendezvous_membership_and_generations(tmp_path):
    root = str(tmp_path / "rdzv")
    a = FileRendezvous(root, "hostA", heartbeat_s=0.01, stale_s=0.5)
    b = JaxRdzv(root, "hostB", heartbeat_s=0.01, stale_s=0.5)
    a.heartbeat(force=True)
    b.heartbeat(force=True)
    assert a.alive_hosts() == b.alive_hosts() == ["hostA", "hostB"]
    ma = a.rendezvous(after_gen=0, timeout_s=10.0, settle_s=0.02)
    mb = b.rendezvous(after_gen=0, timeout_s=10.0, settle_s=0.02)
    assert ma == mb
    assert ma["gen"] == 1 and ma["members"] == ["hostA", "hostB"]
    b.retire()
    assert a.alive_hosts() == ["hostA"]
    m2 = a.rendezvous(after_gen=1, timeout_s=10.0, settle_s=0.02)
    assert m2["gen"] == 2 and m2["members"] == ["hostA"]
    assert m2["port"] != ma["port"]
    assert isinstance(a.clock_offset_sample(), float)


def test_file_rendezvous_stale_heartbeat_drops_member(tmp_path):
    root = str(tmp_path / "rdzv")
    a = FileRendezvous(root, "a", heartbeat_s=0.01, stale_s=0.05)
    b = FileRendezvous(root, "b", heartbeat_s=0.01, stale_s=0.05)
    a.heartbeat(force=True)
    b.heartbeat(force=True)
    time.sleep(0.1)
    a.heartbeat(force=True)
    assert a.alive_hosts() == ["a"]
    assert a.heartbeat_age("b") > 0.05


def test_watchdog_peer_event_drives_the_agents_recovery(tmp_path):
    agent = ElasticAgent(str(tmp_path / "job"), "h0",
                         worker_argv=[sys.executable, "-c", "pass"])
    try:
        agent.watchdog.peer_event("host1", "dead", age_s=4.2)
        assert agent._recover_reason is not None
        assert "host1" in agent._recover_reason
        assert "4.2s stale" in agent._recover_reason
        assert agent.watchdog.counters["peer_failures"] == 1
    finally:
        agent.shipper.close()
        agent._detach_debug()
    wd = Watchdog(log=None, on_anomaly=lambda c, m: 1 / 0)
    wd.peer_event("h", "dead")  # a failing hook never breaks the count
    assert wd.counters["peer_failures"] == 1
    with pytest.raises(ValueError, match="policy"):
        ElasticAgent(str(tmp_path / "job2"), "h1", policy="grow")


def test_peer_death_drain_dumps_flight_bundle(tmp_path, monkeypatch):
    """A peer named in the manifest that never heartbeats: the monitor's
    first poll flags it, and the drain black-boxes the window."""
    monkeypatch.setenv("BIGDL_TPU_FLIGHT", "1")
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    agent = ElasticAgent(
        str(tmp_path / "job"), "h0", policy="restart",
        worker_argv=[sys.executable, "-c", "import time; time.sleep(60)"],
        grace_s=2.0)
    try:
        assert agent.flight is not None and agent.flight.armed
        agent.rdzv.heartbeat(gen=1, force=True)
        status = agent._run_generation(
            {"gen": 1, "members": ["h0", "h9"], "port": 1})
        assert status == "recover"
        assert agent.watchdog.counters["peer_failures"] >= 1
        bundles = agent.flight.bundles()
        assert bundles, "drain path left no flight bundle"
        man = json.load(open(f"{bundles[-1]}/manifest.json"))
        assert man["trigger"] == "peer_failure"
        assert "h9" in man["note"]
    finally:
        agent.shipper.close()
        agent._detach_debug()


def test_fp16_compress_is_jax_bit_for_bit():
    x = np.random.RandomState(3).randn(4096).astype(np.float32) * 100
    got = fp16_compress(x)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.asarray(jax_fp16(x)).view(np.uint32))
    bound = np.abs(x) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - x) <= bound)
    rt = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert np.all(np.abs(rt - x) <= bound)


# ----------------------------------------------------------- the scenarios
def _env(iters, every):
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               BIGDL_ELASTIC_DEVICE="cpu", BIGDL_ELASTIC_ITERS=str(iters),
               BIGDL_ELASTIC_CKPT_EVERY=str(every),
               BIGDL_TPU_ELASTIC_HEARTBEAT_S=str(HEARTBEAT_S),
               BIGDL_TPU_ELASTIC_STALE_S=str(STALE_S),
               BIGDL_TPU_NUMERICS="1")
    env.pop("BIGDL_TPU_TELEMETRY_DIR", None)
    return env


def _knobs(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_ELASTIC_HEARTBEAT_S", str(HEARTBEAT_S))
    monkeypatch.setenv("BIGDL_TPU_ELASTIC_STALE_S", str(STALE_S))


def _wait_until(cond, what, budget_s=60.0):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out after {budget_s:.0f}s waiting for {what}")


def _start(agent, results, key):
    def run():
        try:
            results[key] = agent.run()
        except Exception as e:  # reported by the joining test
            results[key] = f"error: {e!r}"

    t = threading.Thread(target=run, name=f"agent-{key}", daemon=True)
    t.start()
    return t


def _join(threads, results, wd, budget_s=120.0):
    """Join the agents' threads within ``budget_s``; past it, kill every
    worker they started (each leads a session) and fail."""
    deadline = time.monotonic() + budget_s
    for t in threads:
        t.join(timeout=max(0.1, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        for pid_file in glob.glob(os.path.join(wd, "worker-g*.pid")):
            try:
                os.killpg(int(open(pid_file).read()), signal.SIGKILL)
            except (OSError, ValueError):
                pass
        pytest.fail(f"agents still running after {budget_s:.0f}s: {alive} "
                    f"{results}")


def _losses(workdir):
    """iteration -> loss of rank 0, the newest generation winning."""
    out = {}
    for path in sorted(glob.glob(os.path.join(workdir, "losses-g*.jsonl"))):
        for line in open(path):
            rec = json.loads(line)
            if rec["rank"] == 0:
                out[rec["it"]] = (rec["gen"], rec["loss"])
    return {it: loss for it, (_, loss) in out.items()}


def _result(workdir, gen, rank):
    return json.load(open(os.path.join(
        workdir, f"worker-result-g{gen}-r{rank}.json")))


@pytest.mark.slow  # ~28 s; chip_smoke.py phase 15 (d) runs it on the card
def test_elastic_kill9_survivor_reforms_and_matches_baseline(
        tmp_path, monkeypatch):
    import subprocess

    from bigdl_tpu_torch.telemetry.cluster import ClusterAggregator

    _knobs(monkeypatch)
    iters, every = 400, 20
    wd = str(tmp_path / "job")
    env = _env(iters, every)
    results = {}
    a0 = ElasticAgent(wd, "h0", policy="restart", env=env, grace_s=3.0,
                      rendezvous_timeout_s=60.0)
    a1 = ElasticAgent(wd, "h1", policy="shrink", env=env, grace_s=3.0,
                      rendezvous_timeout_s=60.0)
    threads = [_start(a0, results, "h0"), _start(a1, results, "h1")]
    ckpt = os.path.join(wd, "ckpt")
    pid_file = os.path.join(wd, "worker-g1-h1.pid")
    _wait_until(lambda: os.path.isdir(ckpt) and os.path.exists(pid_file)
                and any(os.path.exists(os.path.join(ckpt, d, "COMMIT"))
                        for d in os.listdir(ckpt)),
                "the first commit and h1's worker")
    os.kill(int(open(pid_file).read()), signal.SIGKILL)
    _join(threads, results, wd)
    assert results == {"h0": "done", "h1": "left"}, results
    report = json.load(open(os.path.join(wd, "agent-h0-watchdog.json")))
    assert report["counters"]["peer_failures"] >= 1
    gens = {int(f.split("-g")[1].split("-")[0])
            for f in os.listdir(wd) if f.startswith("losses-g")}
    assert max(gens) >= 2, gens
    final = _result(wd, max(gens), 0)
    assert final["world"] == 1 and final["iterations"] == iters

    # the uninterrupted world-1 run of the same job
    base = str(tmp_path / "baseline")
    os.makedirs(base)
    benv = dict(env, BIGDL_ELASTIC_WORKDIR=base, BIGDL_ELASTIC_GEN="1",
                BIGDL_ELASTIC_RANK="0", BIGDL_ELASTIC_WORLD="1")
    subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.distributed.worker"],
        env=benv, cwd=base, check=True, timeout=120, capture_output=True)
    composed, baseline = _losses(wd), _losses(base)
    assert set(composed) == set(baseline) == set(range(1, iters + 1))
    its = sorted(baseline)
    np.testing.assert_allclose([composed[i] for i in its],
                               [baseline[i] for i in its],
                               rtol=1e-4, atol=1e-5)
    want = _result(base, 1, 0)["params"]
    for k, v in final["params"].items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)

    # the shipped lifecycle: both hosts, and death -> re-form -> restore
    agg = ClusterAggregator(os.path.join(wd, "telemetry")).load()
    assert {"h0", "h1"} <= set(agg.hosts)
    events = agg.merge_trace()["traceEvents"]

    def first(name, **match):
        ts = [e["ts"] for e in events if e["name"] == name
              and all(e.get("args", {}).get(k) == v
                      for k, v in match.items())]
        return min(ts) if ts else None

    t = (first("peer_dead"), first("gen_bump", gen=2),
         first("worker_start", gen=2), first("resharding_restore"))
    assert None not in t, t
    assert t[0] < t[1] < t[2] <= t[3], t
    summary = agg.cluster_summary()
    assert summary["per_host"]["h0"]["n_steps"] > 0
    assert summary["per_host"]["h0"]["grad_norm"] > 0


@pytest.mark.slow  # ~20 s
def test_elastic_join_grows_the_mesh(tmp_path, monkeypatch):
    _knobs(monkeypatch)
    wd = str(tmp_path / "job")
    env = _env(1200, 25)
    results = {}
    a0 = ElasticAgent(wd, "h0", policy="restart", env=env, grace_s=5.0,
                      rendezvous_timeout_s=60.0)
    threads = [_start(a0, results, "h0")]
    probe = FileRendezvous(os.path.join(wd, "rendezvous"), "probe")

    def formed():
        m = probe.latest_generation()
        return bool(m and m["members"] == ["h0"])

    _wait_until(formed, "generation 1")
    a1 = ElasticAgent(wd, "h1", policy="restart", env=env, grace_s=5.0,
                      rendezvous_timeout_s=60.0)
    threads.append(_start(a1, results, "h1"))
    _join(threads, results, wd)
    assert results == {"h0": "done", "h1": "done"}, results
    gens = {int(f.split("-g")[1].split("-")[0])
            for f in os.listdir(wd) if f.startswith("losses-g")}
    assert max(gens) >= 2, gens
    finals = [_result(wd, max(gens), r) for r in (0, 1)]
    assert finals[0]["world"] == finals[1]["world"] == 2
    assert finals[0]["digest"] == finals[1]["digest"]
