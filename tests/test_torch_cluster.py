"""The port's cluster telemetry (bigdl_tpu_torch.telemetry.cluster) and
its ``cluster_top`` against the JAX package's on the CPU: the shipper's
atomic, tagged segments, clock offsets and knobs; each package's
aggregator merges the other's segments into the same trace, summary
(step percentiles, world throughput, straggler and grad-norm skew) and
request trees; the federated watchdog flags on transitions; the cost and
program tables ride the segments; each package's ``cluster_top`` prints
the same for one directory, and the live poll reads the port's
debug server."""
import glob
import json
import os
import time

import numpy as np
import pytest

from bigdl_tpu import telemetry as jtel
from bigdl_tpu.telemetry import cluster as jcluster
from bigdl_tpu.telemetry import debug_server as jdbg
from bigdl_tpu.telemetry import numerics as jnum
from bigdl_tpu.telemetry.tracer import Tracer as JTracer
from bigdl_tpu_torch import telemetry as ttel
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.telemetry import costmodel, debug_server, programs
from bigdl_tpu_torch.telemetry import numerics as tnum
from bigdl_tpu_torch.telemetry import tracer as ttr
from bigdl_tpu_torch.telemetry.cluster import (EVENT_GEN_BUMP,
                                               EVENT_PEER_DEAD, SEGMENT_GLOB,
                                               ClusterAggregator,
                                               FederatedWatchdog,
                                               TelemetryShipper,
                                               clock_sync_enabled,
                                               ship_every_s, telemetry_dir)
from bigdl_tpu_torch.telemetry.tracer import Tracer
from bigdl_tpu_torch.telemetry.watchdog import Watchdog
from bigdl_tpu_torch.tools import cluster_top


@pytest.fixture(autouse=True)
def clean_tracer(monkeypatch):
    for knob in ("BIGDL_TPU_DEBUG_PORT", "BIGDL_TPU_TELEMETRY_DIR",
                 "BIGDL_TPU_SHIP_EVERY_S", "BIGDL_TPU_CLOCK_SYNC"):
        monkeypatch.delenv(knob, raising=False)

    def reset():
        for tr, mod in ((ttel.get_tracer(), ttr),
                        (jtel.get_tracer(), jtel.tracer)):
            tr.disable()
            tr.clear()
            mod.set_correlation(None)
        for dbg in (debug_server, jdbg):
            srv = dbg.get_debug_server(create=False)
            if srv is not None:
                srv.close()
            dbg.set_global(None)

    reset()
    yield
    reset()


def _ship(run_dir, host, spans=(), *, pkg="port", offset=0.0, gen=1,
          metrics=None, events=(), instants=()):
    """One real flush by either package's shipper: ``spans`` are
    ``(name, wall t0, seconds, corr)``, put back into the tracer's clock
    so the shipper's conversion runs."""
    tracer_cls, shipper_cls = ((Tracer, TelemetryShipper) if pkg == "port"
                               else (JTracer, jcluster.TelemetryShipper))
    tr = tracer_cls(capacity=1024)
    tr.enable()
    shipper = shipper_cls(str(run_dir), host, gen=gen, tracer=tr,
                          interval_s=0,
                          clock_offset_fn=(lambda: offset) if offset
                          else None)
    if metrics is not None:
        shipper.add_metrics("test", metrics)
    skew = time.time() - time.perf_counter()
    for name, t0, dur, corr in spans:
        tr.add_span(name, "train", t0 - skew, t0 + dur - skew, corr=corr)
    for name, args in instants:
        tr.instant(name, "train", corr="step:1", args=args)
    for kind, args in events:
        shipper.event(kind, **args)
    path = shipper.ship_now()
    shipper.close()
    return path


def _write_seg(run_dir, host, seq, t_header, *, spans=(), metrics=None):
    lines = [json.dumps({
        "record": "segment_header", "host": host, "gen": 1, "pid": 1,
        "seq": seq, "t": t_header, "clock_offset_s": 0.0,
        "n_spans": len(spans), "n_events": 0})]
    for name, t0, dur, corr in spans:
        lines.append(json.dumps({
            "record": "span", "name": name, "cat": "train", "t0": t0,
            "t1": t0 + dur, "tid": 1, "thread": "MainThread", "corr": corr,
            "args": None, "gen": 1}))
    if metrics is not None:
        lines.append(json.dumps({"record": "metrics", "name": "test",
                                 "host": host, "gen": 1, "t": t_header,
                                 "snapshot": metrics}))
    with open(os.path.join(str(run_dir), f"seg-{host}-1-{seq:06d}.jsonl"),
              "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------- shipper
def test_shipper_segments_atomic_and_tagged(tmp_path):
    tr = Tracer(capacity=64)
    tr.enable()
    shipper = TelemetryShipper(str(tmp_path), "h0", gen=3, tracer=tr,
                               interval_s=0)
    t0 = time.perf_counter()
    tr.add_span("dispatch", "train", t0, t0 + 0.01, corr="step:1")
    tr.instant("queue_full", "serve", corr="req:9")
    shipper.event(EVENT_PEER_DEAD, peer="h1", age_s=4.2)
    shipper.add_metrics("train", Metrics())
    p1, p2 = shipper.ship_now(), shipper.ship_now()
    segs = sorted(glob.glob(os.path.join(str(tmp_path), SEGMENT_GLOB)))
    assert [os.path.basename(p) for p in (p1, p2)] == [
        os.path.basename(s) for s in segs]
    assert not glob.glob(os.path.join(str(tmp_path), "*.part"))
    recs = [json.loads(ln) for ln in open(p1) if ln.strip()]
    header = recs[0]
    assert (header["record"], header["host"], header["gen"],
            header["seq"], header["n_spans"]) == (
        "segment_header", "h0", 3, 0, 2)
    d = next(r for r in recs if r.get("name") == "dispatch")
    assert abs(d["t0"] - time.time()) < 60.0
    assert d["t1"] - d["t0"] == pytest.approx(0.01, abs=1e-6)
    assert d["corr"] == "step:1" and d["gen"] == 3
    (ev,) = [r for r in recs if r["record"] == "event"]
    assert ev["kind"] == EVENT_PEER_DEAD and ev["args"]["peer"] == "h1"
    (m,) = [r for r in recs if r["record"] == "metrics"]
    assert set(m["snapshot"]) == {"phases", "counters"}  # a port Metrics
    assert json.loads(open(p2).readline())["n_spans"] == 0
    shipper.set_generation(4)
    assert json.loads(open(shipper.ship_now()).readline())["gen"] == 4
    shipper.close()


def test_shipper_events_only_dict_metrics_and_knobs(tmp_path, monkeypatch):
    # no cost or program table: the process's own may hold entries
    monkeypatch.setenv("BIGDL_TPU_XRAY", "0")
    shipper = TelemetryShipper(str(tmp_path), "agent0", tracer=None,
                               interval_s=0, cost_table=costmodel.CostTable())
    shipper.add_metrics("serve", {"queue_depth": 7, "occupancy": 0.5})
    shipper.event(EVENT_GEN_BUMP, gen=2, members=["h0", "h1"])
    recs = [json.loads(ln) for ln in open(shipper.ship_now()) if ln.strip()]
    assert [r["record"] for r in recs] == ["segment_header", "event",
                                           "metrics"]
    assert recs[2]["snapshot"] == {"queue_depth": 7, "occupancy": 0.5}
    shipper.close()
    samples = iter([0.4, 0.6, 0.5])
    s2 = TelemetryShipper(str(tmp_path), "h0", tracer=None, interval_s=0,
                          clock_offset_fn=lambda: next(samples))
    for _ in range(3):
        path = s2.ship_now()
    assert json.loads(open(path).readline())["clock_offset_s"] == 0.5
    s2.close()
    for mod in (None, jcluster):
        td, se, cs = ((telemetry_dir, ship_every_s, clock_sync_enabled)
                      if mod is None else (mod.telemetry_dir,
                                           mod.ship_every_s,
                                           mod.clock_sync_enabled))
        monkeypatch.delenv("BIGDL_TPU_TELEMETRY_DIR", raising=False)
        monkeypatch.delenv("BIGDL_TPU_SHIP_EVERY_S", raising=False)
        monkeypatch.delenv("BIGDL_TPU_CLOCK_SYNC", raising=False)
        assert (td(), td("/f"), se(), cs()) == (None, "/f", 2.0, True)
        monkeypatch.setenv("BIGDL_TPU_TELEMETRY_DIR", "/run/t")
        monkeypatch.setenv("BIGDL_TPU_SHIP_EVERY_S", "junk")
        monkeypatch.setenv("BIGDL_TPU_CLOCK_SYNC", "0")
        assert (td(), se(), cs()) == ("/run/t", 2.0, False)
    off = TelemetryShipper(str(tmp_path), "h1", tracer=None, interval_s=0,
                           clock_offset_fn=lambda: 9.9)
    assert json.loads(open(off.ship_now()).readline())[
        "clock_offset_s"] == 0.0
    off.close()


def test_shipper_thread_flushes_on_its_cadence(tmp_path):
    with TelemetryShipper(str(tmp_path), "h0", tracer=None,
                          interval_s=0.05) as shipper:
        deadline = time.time() + 10
        while len(glob.glob(os.path.join(str(tmp_path), SEGMENT_GLOB))) \
                < 2 and time.time() < deadline:
            time.sleep(0.02)
    assert shipper._thread is None
    assert len(glob.glob(os.path.join(str(tmp_path), SEGMENT_GLOB))) >= 3


# ---------------------------------------------- aggregator, both packages
def _two_packages(tmp_path):
    """Host h0 shipped by the port (its clock 0.5 s ahead), h1 by JAX;
    the same steps on both, slower on h1, plus a numerics sample each."""
    now = time.time()
    _ship(tmp_path, "h0",
          [("dispatch", now + 0.5 + 0.1 * i, 0.010, f"step:{i}")
           for i in range(10)], pkg="port", offset=0.5,
          metrics={"throughput": 120.0,
                   "values": {"grad_norm": 1.0, "update_ratio": 0.01}},
          events=[(EVENT_PEER_DEAD, {"peer": "h1"})],
          instants=[("numerics", {"iteration": 1, "grad_norm": 1.0,
                                  "update_ratio": 0.01, "nonfinite": 0})])
    _ship(tmp_path, "h1",
          [("dispatch", now + 0.1 * i, 0.030, f"step:{i}")
           for i in range(10)], pkg="jax",
          metrics={"throughput": 80.0,
                   "values": {"grad_norm": 2.0, "update_ratio": 0.01}},
          instants=[("numerics", {"iteration": 1, "grad_norm": 2.0,
                                  "update_ratio": 0.01, "nonfinite": 0})])
    return now


def test_either_aggregator_merges_either_packages_segments(tmp_path):
    now = _two_packages(tmp_path)
    agg = ClusterAggregator(str(tmp_path)).load()
    jagg = jcluster.ClusterAggregator(str(tmp_path)).load()
    assert set(agg.hosts) == {"h0", "h1"}
    assert agg.clock_offset("h0") == pytest.approx(0.5)
    summary = agg.cluster_summary(now=now)
    assert summary == jagg.cluster_summary(now=now)
    trace = agg.merge_trace()
    assert trace == jagg.merge_trace()
    assert agg.request_trees() == {}
    ph, c = summary["per_host"], summary["cluster"]
    assert ph["h0"]["step_p50_ms"] == pytest.approx(10.0, abs=0.5)
    assert ph["h1"]["step_p50_ms"] == pytest.approx(30.0, abs=0.5)
    assert c["world_throughput"] == pytest.approx(200.0)
    assert c["straggler_skew_ms"]["n_steps"] == 10
    assert c["straggler_skew_ms"]["mean"] == pytest.approx(20.0, abs=1.0)
    assert c["grad_norm_skew"]["hosts"] == 2
    assert c["grad_norm_skew"]["rel_spread"] == pytest.approx(1.0 / 1.5)
    events = trace["traceEvents"]
    lanes = {e["args"]["name"].split()[0]: e["pid"] for e in events
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert set(lanes) == {"h0", "h1"}
    xs = {e["pid"]: e["ts"] for e in events
          if e.get("ph") == "X" and e["name"] == "dispatch"
          and e["args"].get("corr") == "step:0"}
    # the same instant on two clocks 0.5 s apart: aligned after the
    # correction
    assert abs(xs[lanes["h0"]] - xs[lanes["h1"]]) < 0.1e6
    gn = [e for e in events if e.get("ph") == "C"
          and e["name"] == "grad norm"]
    assert len({e["pid"] for e in gn}) == 2
    (dead,) = [e for e in events if e["name"] == EVENT_PEER_DEAD]
    assert dead["cat"] == "elastic" and dead["pid"] == lanes["h0"]
    path = agg.write_trace()
    assert json.load(open(path))["traceEvents"]
    assert json.load(open(agg.write_summary()))["cluster"]["hosts"] == 2


def test_request_trees_across_hosts_equal_jax(tmp_path):
    now = time.time()
    _ship(tmp_path, "router", [("route", now, 0.002, "req:7")],
          pkg="port")
    _ship(tmp_path, "replica", [("serve_device", now + 0.003, 0.004,
                                 "req:7")], pkg="jax")
    trees = ClusterAggregator(str(tmp_path)).load().request_trees()
    assert trees == jcluster.ClusterAggregator(
        str(tmp_path)).load().request_trees()
    assert list(trees) == [7]


# --------------------------------------------------- federated watchdog
def test_federated_watchdog_flags_on_transitions(tmp_path):
    now = time.time()
    _write_seg(tmp_path, "h0", 0, now,
               spans=[("dispatch", now - 1 + 0.01 * i, 0.010, f"step:{i}")
                      for i in range(30)])
    _write_seg(tmp_path, "h1", 0, now,
               metrics={"queue_depth": 64, "occupancy": 0.99})
    _write_seg(tmp_path, "h2", 0, now,
               spans=[("dispatch", now - 1 + 0.05 * i, 0.050, f"step:{i}")
                      for i in range(10)])
    _write_seg(tmp_path, "h3", 0, now - 60.0)
    wd = Watchdog(log=None)
    fed = FederatedWatchdog(str(tmp_path), watchdog=wd, stale_s=10.0,
                            straggler_factor=2.0, min_steps=8)
    flags = fed.check(now=now)
    assert flags == {"h1": ["saturated"], "h2": ["straggler"],
                     "h3": ["stalled"]}
    jflags = jcluster.FederatedWatchdog(str(tmp_path), log=None).check(
        now=now)
    assert flags == jflags
    n = wd.counters["peer_failures"]
    assert n == 3
    assert fed.check(now=now) == flags and wd.counters["peer_failures"] == n
    agg = ClusterAggregator(str(tmp_path)).load()
    del agg.hosts["h3"]
    assert "h3" not in fed.check(aggregator=agg, now=now)
    assert "h3" in fed.check(now=now)
    assert wd.counters["peer_failures"] == n + 1
    rep = fed.report()
    assert rep["flags"] == fed.flags()
    assert rep["watchdog"]["counters"]["peer_failures"] == n + 1
    assert rep["summary"]["cluster"]["hosts"] == 4


# ------------------------------------------- cost and program tables
def test_shipper_ships_cost_and_program_tables(tmp_path):
    table = costmodel.CostTable()
    table.add(costmodel.ProgramCost("double", flops=8.0,
                                    bytes_accessed=32.0))
    registry = programs.get_program_registry()
    registry.clear()
    registry.register_compile(
        "serving_forward",
        programs.signature_of({"x": np.zeros((1, 32, 16), np.float32)}),
        compile_s=0.2, expected=True)
    registry.register_compile(
        "serving_forward",
        programs.signature_of({"x": np.zeros((1, 48, 16), np.float32)}),
        compile_s=0.1)
    try:
        shipper = TelemetryShipper(str(tmp_path), "h0", tracer=None,
                                   interval_s=0, cost_table=table)
        recs = [json.loads(ln) for ln in open(shipper.ship_now())
                if ln.strip()]
        shipper.close()
    finally:
        registry.clear()
    (c,) = [r for r in recs if r["record"] == "cost"]
    assert [p["name"] for p in c["programs"]] == ["double"]
    assert costmodel.CostTable.load(
        str(tmp_path / "cost-h0.json")).get("double").flops == 8.0
    (x,) = [r for r in recs if r["record"] == "xray"]
    assert x["programs"][0]["compiles"] == 2
    assert "32 → 48" in x["forensics"][0]["cause"]
    assert os.path.exists(tmp_path / "xray-h0.json")
    for agg in (ClusterAggregator(str(tmp_path)).load(),
                jcluster.ClusterAggregator(str(tmp_path)).load()):
        assert agg.hosts["h0"]["costs"][0]["name"] == "double"
        assert agg.hosts["h0"]["xray"][0]["name"] == "serving_forward"


# ------------------------------------------------------------ cluster_top
def test_cluster_top_prints_what_the_jax_tool_prints(tmp_path, capsys):
    from tools import cluster_top as jtop

    now = _two_packages(tmp_path)
    _write_seg(tmp_path, "h2", 0, now - 60.0)  # stalled: flagged
    outs = []
    for tool in (cluster_top, jtop):
        assert tool.main([str(tmp_path), "--json"]) == 0
        blob = json.loads(capsys.readouterr().out)
        for h in blob["summary"]["per_host"].values():
            h.pop("last_flush_age_s")  # read at each call's own clock
        assert tool.main([str(tmp_path)]) == 0
        text = capsys.readouterr().out
        outs.append((blob, text.splitlines()[0]))
    assert outs[0] == outs[1]
    blob, head = outs[0]
    assert blob["flags"] == {"h2": ["stalled"]}
    assert "gnorm" in head and "spread=" in head
    trace_out = str(tmp_path / "merged.json")
    assert cluster_top.main([str(tmp_path), "--trace", trace_out]) == 0
    capsys.readouterr()
    assert json.load(open(trace_out))["traceEvents"]
    assert cluster_top.main([str(tmp_path / "missing"), "--json"]) == 2


def test_cluster_top_live_polls_the_ports_debug_server(tmp_path,
                                                       monkeypatch):
    """The segment header carries the debug server's address; the live
    poll scrapes /statusz and /metricsz (the port's Metrics and a decode
    snapshot), and falls back to the file plane once it is gone."""
    monkeypatch.setenv("BIGDL_TPU_DEBUG_PORT", "0")
    srv = debug_server.get_debug_server()
    m = Metrics().no_span("dispatch")
    m.add("dispatch", 0.01)
    m.add("dispatch", 0.02)
    m.set_value("throughput", 64.0)
    srv.attach("train", role="train", metrics=lambda: m)
    srv.add_metrics("decode", {"pages_in_use": 7,
                               "spec_acceptance_rate": 0.625,
                               "prefill_chunks": 12})
    shipper = TelemetryShipper(str(tmp_path), "hostA", gen=1)
    shipper.add_metrics("train", lambda: m)
    shipper.ship_now()
    shipper.close()
    summary = ClusterAggregator(str(tmp_path)).load().cluster_summary()
    assert summary["per_host"]["hostA"]["debug_addr"] == srv.address
    row = cluster_top.live_poll(summary)["hostA"]
    assert row["role"] == "train" and row["dispatches"] == 2.0
    assert row["throughput"] == 64.0 and row["pages_in_use"] == 7.0
    text = cluster_top.render_live({"hostA": row, "h1": None},
                                   {"per_host": {"h1": {"n_steps": 3}}}, {})
    live = next(ln for ln in text.splitlines() if ln.startswith("hostA"))
    assert " 7 " in live and "62.5" in live and " 12 " in live
    srv.close()
    assert cluster_top.live_poll(summary)["hostA"] is None


def test_numerics_sample_through_a_shipper_to_the_lanes(tmp_path):
    """A monitor's ``numerics`` instants, shipped by the port: the
    merged trace's grad-norm lane and the host's grad norm."""
    tr = Tracer(capacity=64)
    tr.enable()
    shipper = TelemetryShipper(str(tmp_path), "h0", tracer=tr,
                               interval_s=0)
    shipper.add_metrics("train", {"values": {"grad_norm": 2.5,
                                             "update_ratio": 0.02}})
    tr.instant(tnum.NUMERICS_SAMPLE, "train", corr="step:3",
               args={"iteration": 3, "grad_norm": 2.5,
                     "update_ratio": 0.02, "nonfinite": 0})
    shipper.ship_now()
    shipper.close()
    agg = ClusterAggregator(str(tmp_path)).load()
    (lane,) = [e for e in agg.merge_trace()["traceEvents"]
               if e.get("ph") == "C"]
    assert lane["args"] == {"grad_norm": 2.5, "update_ratio": 0.02}
    assert agg.cluster_summary()["per_host"]["h0"]["grad_norm"] == 2.5
    assert tnum.NUMERICS_SAMPLE == jnum.NUMERICS_SAMPLE
