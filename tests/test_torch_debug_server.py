"""The port's live plane (bigdl_tpu_torch.telemetry.debug_server and
flightrecorder) against the JAX package's on the CPU: ``/metricsz`` is
strict Prometheus text equal to JAX's on the same sources, ``/statusz``,
``/tracez``, ``/xrayz`` and ``/flightz`` answer, the server binds port 0
and closes cleanly, the flight recorder rate-limits, prunes, triggers on
severe anomalies and divergence instants, restores the hooks it
installs, and each package's ``blackbox`` reads the other's bundles;
then the engines attach and detach, and a training loop runs with the
plane live."""
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from bigdl_tpu import telemetry as jtel
from bigdl_tpu.optim.metrics import Metrics as JMetrics
from bigdl_tpu.serving.metrics import ServingMetrics as JServingMetrics
from bigdl_tpu.telemetry import debug_server as jdbg
from bigdl_tpu.telemetry import flightrecorder as jflight
from bigdl_tpu.telemetry import numerics as jnum
from bigdl_tpu.telemetry import tracer as jtr
from bigdl_tpu.telemetry.watchdog import Watchdog as JWatchdog
from bigdl_tpu_torch import telemetry as ttel
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.serving.metrics import LATENCY_BUCKETS, ServingMetrics
from bigdl_tpu_torch.telemetry import debug_server, flightrecorder
from bigdl_tpu_torch.telemetry import numerics as tnum
from bigdl_tpu_torch.telemetry import tracer as ttr
from bigdl_tpu_torch.telemetry.debug_server import (PROMETHEUS_CONTENT_TYPE,
                                                    DebugServer,
                                                    prometheus_text)
from bigdl_tpu_torch.telemetry.flightrecorder import FlightRecorder
from bigdl_tpu_torch.telemetry.watchdog import Watchdog
from bigdl_tpu_torch.tools import blackbox
from test_debug_server import parse_exposition_strict

SERVER_THREAD = "bigdl-debug-server"
KNOBS = ("BIGDL_TPU_DEBUG_PORT", "BIGDL_TPU_FLIGHT", "BIGDL_TPU_FLIGHT_DIR",
         "BIGDL_TPU_FLIGHT_MIN_INTERVAL_S", "BIGDL_TPU_FLIGHT_KEEP",
         "BIGDL_TPU_TELEMETRY_DIR")


@pytest.fixture(autouse=True)
def clean_plane(monkeypatch):
    """No knob, no global server or recorder, both tracers off and empty
    with no ambient correlation, before and after each test."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)

    def reset():
        for dbg, fl in ((debug_server, flightrecorder), (jdbg, jflight)):
            srv = dbg.get_debug_server(create=False)
            if srv is not None:
                srv.close()
            dbg.set_global(None)
            fl.set_global(None)
        for tr, mod in ((ttel.get_tracer(), ttr), (jtel.get_tracer(), jtr)):
            tr.disable()
            tr.clear()
            mod.set_correlation(None)
        for tel in (ttel, jtel):
            tel.get_hbm_ledger().clear()
            tel.get_program_registry().clear()

    reset()
    yield
    reset()


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.headers.get("Content-Type"), resp.read().decode()


def _fill(m):
    """The same samples into either package's Metrics."""
    m.no_span("dispatch").no_span("data")
    m.add("dispatch", 0.010)
    m.add("dispatch", 0.030)
    m.add("data", 0.002)
    m.set_value("throughput", 512.5)
    m.set_value("grad_norm", 0.25)
    return m


# ------------------------------------------------ Prometheus exposition
def test_metricsz_is_strict_and_equals_jax_on_the_same_sources():
    wds = []
    for wd_cls in (Watchdog, JWatchdog):
        wd = wd_cls(log=None)
        wd.counters["nan_windows"] = 2
        wd.counters["queue_full"] = 1
        wds.append(wd)
    mons = []
    for mod in (tnum, jnum):
        mon = mod.NumericsMonitor(log=None)
        mon.observe(7, {"grad_norm": 1.5, "param_norm": 3.0,
                        "update_norm": 0.03, "nonfinite": 0, "layers": {}})
        mons.append(mon)
    texts = [prometheus_text({"train": _fill(Metrics()),
                              "serve": {"queue_depth": 4, "ok": True}},
                             watchdog=wds[0], numerics=mons[0]),
             jdbg.prometheus_text({"train": _fill(JMetrics()),
                                   "serve": {"queue_depth": 4, "ok": True}},
                                  watchdog=wds[1], numerics=mons[1])]
    assert texts[0] == texts[1]
    prom = parse_exposition_strict(texts[0])
    m = _fill(Metrics())
    key = ("bigdl_tpu_phase_count_total",
           (("phase", "dispatch"), ("source", "train")))
    assert prom[key] == m.count("dispatch") == 2
    key = ("bigdl_tpu_phase_seconds_total",
           (("phase", "dispatch"), ("source", "train")))
    assert prom[key] == pytest.approx(m.get("dispatch") * 2)
    assert prom[("bigdl_tpu_value",
                 (("name", "throughput"), ("source", "train")))] == 512.5
    assert prom[("bigdl_tpu_watchdog_anomalies_total",
                 (("kind", "nan_windows"),))] == 2
    assert prom[("bigdl_tpu_numerics", (("stat", "grad_norm"),))] == 1.5
    assert prom[("bigdl_tpu_snapshot",
                 (("key", "queue_depth"), ("source", "serve")))] == 4


def test_metricsz_over_http_has_uptime_and_the_serving_histogram():
    """A ServingMetrics source: its latency histogram is cumulative, ends
    at +Inf and equals JAX's family on the same latencies."""
    lats = (0.0005, 0.003, 0.003, 0.08, 42.0)
    t, j = ServingMetrics(), JServingMetrics()
    for s in lats:
        t.record_latency(s)
        j.record_latency(s)
    with DebugServer(port=0, host="hostA") as srv:
        srv.add_metrics("serve", t)
        ctype, body = _get(srv.local_url("/metricsz"))
    assert ctype == PROMETHEUS_CONTENT_TYPE
    prom = parse_exposition_strict(body)
    assert ("bigdl_tpu_uptime_seconds", ()) in prom
    fam = "bigdl_tpu_request_latency_seconds"
    base = (("source", "serve"),)
    for le in LATENCY_BUCKETS:
        got = prom[(f"{fam}_bucket",
                    tuple(sorted((("le", f"{le:g}"),) + base)))]
        assert got == sum(1 for s in lats if s <= le), le
    assert prom[(f"{fam}_count", base)] == len(lats)
    assert prom[(f"{fam}_sum", base)] == pytest.approx(sum(lats))
    snap = {k for (n, labels) in prom if n == "bigdl_tpu_snapshot"
            for k in [dict(labels)["key"]]}
    assert {"completed", "p99_ms", "queue_depth", "mfu"} <= snap

    def hist_lines(text):
        return [ln for ln in text.splitlines() if fam in ln]

    assert hist_lines(prometheus_text({"serve": t})) == hist_lines(
        jdbg.prometheus_text({"serve": j}))


def test_prometheus_text_nonfinite_and_label_escaping_equal_jax():
    src = {'we"ird\nsource\\': {"nan_val": float("nan"),
                                "inf_val": float("inf")}}
    text = prometheus_text(src)
    assert text == jdbg.prometheus_text(src)
    prom = parse_exposition_strict(text)
    vals = {dict(lbl)["key"]: v for (n, lbl), v in prom.items()
            if n == "bigdl_tpu_snapshot"}
    assert np.isnan(vals["nan_val"]) and np.isposinf(vals["inf_val"])


# ---------------------------------------------- statusz, tracez, xrayz
def test_statusz_engines_knobs_and_detach(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_KEEP", "7")
    with DebugServer(port=0, host="hostA", role="test") as srv:
        detach = srv.attach("serve", role="serve", metrics=lambda: None,
                            status=lambda: {"queue_depth": 4})
        srv.set_status("generation", 3)
        obj = json.loads(_get(srv.local_url("/statusz"))[1])
        assert (obj["record"], obj["role"], obj["generation"]) == (
            "statusz", "test", 3)
        assert obj["debug_addr"] == srv.address == f"hostA:{srv.port}"
        assert obj["knobs"]["BIGDL_TPU_FLIGHT_KEEP"] == "7"
        (eng,) = obj["engines"]
        assert (eng["name"], eng["role"], eng["detail"]) == (
            "serve", "serve", {"queue_depth": 4})
        detach()
        assert json.loads(_get(srv.local_url("/statusz"))[1])[
            "engines"] == []
        xray = json.loads(_get(srv.local_url("/xrayz"))[1])
        assert xray["record"] == "xrayz" and xray["programs"] == []


def test_tracez_whole_ring_from_several_threads_and_a_window():
    tr = ttel.get_tracer()
    together = threading.Barrier(3)  # all alive at once: three idents
    with ttel.enabled():
        def emit(tag):
            with tr.span(f"work-{tag}", cat="test"):
                together.wait(10)

        threads = [threading.Thread(target=emit, args=(i,),
                                    name=f"worker-{i}") for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        with DebugServer(port=0) as srv:
            whole = json.loads(_get(srv.local_url("/tracez?secs=0"))[1])
            stop = threading.Event()

            def emitter():
                while not stop.is_set():
                    with tr.span("during-window", cat="test"):
                        time.sleep(0.005)

            t = threading.Thread(target=emitter, name="emitter")
            t.start()
            try:
                window = json.loads(_get(srv.local_url(
                    "/tracez?secs=0.15"))[1])
            finally:
                stop.set()
                t.join(10)
    xs = [e for e in whole["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} == {"work-0", "work-1", "work-2"}
    assert len({e["tid"] for e in xs}) == 3
    names = {e["name"] for e in window["traceEvents"] if e.get("ph") == "X"}
    assert names == {"during-window"}


def test_port_zero_bind_clean_close_and_unknown_paths():
    srv = DebugServer(port=0).start()
    port = srv.port
    assert port > 0
    assert any(t.name == SERVER_THREAD for t in threading.enumerate())
    with pytest.raises(urllib.request.HTTPError) as ei:
        _get(srv.local_url("/nope"))
    assert ei.value.code == 404
    assert "/metricsz" in json.loads(ei.value.read().decode())["endpoints"]
    with pytest.raises(urllib.request.HTTPError) as ei:
        _get(srv.local_url("/flightz"))  # no recorder armed
    assert ei.value.code == 503
    srv.close()
    srv.close()  # idempotent
    assert all(t.name != SERVER_THREAD for t in threading.enumerate())
    with pytest.raises(Exception):
        _get(f"http://127.0.0.1:{port}/statusz", timeout=0.5)


def test_global_server_from_the_knob(monkeypatch):
    assert debug_server.get_debug_server() is None  # the knob unset
    assert debug_server.attach_engine("x")() is None  # a no-op detach
    monkeypatch.setenv("BIGDL_TPU_DEBUG_PORT", "0")
    srv = debug_server.get_debug_server()
    assert srv is not None and debug_server.get_debug_server() is srv
    assert debug_server.bound_address() == srv.address
    detach = debug_server.attach_engine("train", role="train",
                                        metrics=lambda: _fill(Metrics()))
    obj = json.loads(_get(srv.local_url("/statusz"))[1])
    assert [e["name"] for e in obj["engines"]] == ["train"]
    detach()
    srv.close()
    assert debug_server.bound_address() is None


# ------------------------------------------------------ flight recorder
def test_flight_rate_limit_force_and_keep(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path / "a"), host="h0",
                        min_interval_s=3600.0)
    first = fr.dump(trigger="loss_divergence", note="a")
    assert first is not None
    assert fr.dump(trigger="loss_divergence", note="b") is None
    forced = fr.dump(trigger="flightz", force=True)
    assert forced is not None and forced != first
    assert len(fr.bundles()) == 2
    fr = FlightRecorder(out_dir=str(tmp_path / "b"), host="h0",
                        min_interval_s=0.0, keep=2)
    paths = [fr.dump(trigger="flightz", force=True) for _ in range(4)]
    assert fr.bundles() == sorted(paths[-2:])


def test_flight_knobs_equal_jax(monkeypatch, tmp_path):
    for mod in (flightrecorder, jflight):
        assert (mod.flight_min_interval_s(), mod.flight_keep()) == (30.0, 4)
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_MIN_INTERVAL_S", "2.5")
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_KEEP", "junk")
    monkeypatch.setenv("BIGDL_TPU_TELEMETRY_DIR", str(tmp_path))
    for mod in (flightrecorder, jflight):
        assert (mod.flight_min_interval_s(), mod.flight_keep(),
                mod.flight_dir()) == (2.5, 4, str(tmp_path))
        assert not mod.flight_enabled()
    monkeypatch.setenv("BIGDL_TPU_FLIGHT", "1")
    assert flightrecorder.flight_enabled() and jflight.flight_enabled()
    assert debug_server.resolved_knobs() == jdbg.resolved_knobs()


def test_flight_triggers_on_severe_anomalies_and_divergence(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path), host="h0",
                        min_interval_s=0.0)
    fr.on_anomaly("recompiles", "benign churn")
    assert fr.bundles() == []
    wd = Watchdog(log=None, on_anomaly=fr.on_anomaly)
    wd.peer_event("h1", "dead", age_s=4.0)
    (bundle,) = fr.bundles()
    man = json.load(open(f"{bundle}/manifest.json"))
    assert man["trigger"] == "watchdog:peer_failures"
    assert "'h1' dead" in man["note"]
    tr = ttel.get_tracer()
    with ttel.enabled():
        with fr:
            assert fr.armed
            tr.instant("loss_divergence", cat="train", args={"iteration": 6})
        assert not fr.armed
    man = json.load(open(f"{fr.bundles()[-1]}/manifest.json"))
    assert man["trigger"] == "loss_divergence" and "6" in man["note"]
    trace = json.load(open(f"{fr.bundles()[-1]}/trace.json"))
    assert any(e.get("name") == "loss_divergence"
               for e in trace["traceEvents"])


def test_flight_excepthooks_installed_restored_and_atexit(tmp_path,
                                                          monkeypatch):
    chained = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: chained.append("sys"))
    monkeypatch.setattr(threading, "excepthook",
                        lambda a: chained.append("thread"))
    prev_sys, prev_thread = sys.excepthook, threading.excepthook
    fr = FlightRecorder(out_dir=str(tmp_path), host="h0",
                        min_interval_s=0.0).arm()
    assert sys.excepthook is not prev_sys
    assert threading.excepthook is not prev_thread

    def die():
        raise RuntimeError("boom")

    t = threading.Thread(target=die, name="dying-thread")
    t.start()
    t.join(10)
    (bundle,) = fr.bundles()
    man = json.load(open(f"{bundle}/manifest.json"))
    assert man["trigger"] == "unhandled_exception"
    assert "dying-thread" in man["note"] and "boom" in man["note"]
    assert chained == ["thread"]
    fr._atexit()  # what atexit runs on a hard death
    assert not fr.armed
    assert json.load(open(f"{fr.bundles()[-1]}/manifest.json"))[
        "trigger"] == "atexit"
    assert sys.excepthook is prev_sys
    assert threading.excepthook is prev_thread


def _bundle(rec_cls, metrics, tmp_path, name):
    fr = rec_cls(out_dir=str(tmp_path / name), host="h0",
                 min_interval_s=0.0)
    fr.add_metrics("train", metrics)
    fr.add_blob("numerics", lambda: {"last": {"grad_norm": 1.5}})
    return fr


def test_flightz_and_either_blackbox_reads_either_bundle(tmp_path, capsys):
    """``/flightz`` dumps the port's bundle; the port's and the JAX
    package's blackbox give the same summary of it, and of JAX's."""
    from tools import blackbox as jbox

    fr = _bundle(FlightRecorder, _fill(Metrics()), tmp_path, "port")
    with DebugServer(port=0) as srv:
        srv.set_flight_recorder(fr)
        obj = json.loads(_get(srv.local_url("/flightz?note=poke"))[1])
    assert obj["record"] == "flightz" and obj["bundle"] in fr.bundles()
    jfr = _bundle(jflight.FlightRecorder, _fill(JMetrics()), tmp_path,
                  "jax")
    jpath = jfr.dump(trigger="flightz", note="poke", force=True)
    for path in (obj["bundle"], jpath):
        mine = blackbox.summarize(blackbox.load_bundle(path))
        theirs = jbox.summarize(jbox.load_bundle(path))
        assert mine == theirs
        assert mine["trigger"] == "flightz" and mine["note"] == "poke"
        assert mine["numerics"] == {"grad_norm": 1.5}
        assert mine["last_metrics"]["record"] == "train"
        assert blackbox.render(blackbox.load_bundle(path)) == jbox.render(
            jbox.load_bundle(path))
    assert blackbox.main([str(tmp_path / "port")]) == 0  # the newest
    out = capsys.readouterr().out
    assert "flightz" in out and "h0" in out
    assert blackbox.main([obj["bundle"], "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["trigger"] == "flightz"
    assert blackbox.main([str(tmp_path / "nope")]) == 2


def test_serving_metrics_source_in_a_bundle(tmp_path):
    """The port's ServingMetrics (no phase timers) still gives a record
    with its snapshot."""
    fr = FlightRecorder(out_dir=str(tmp_path), host="h0",
                        min_interval_s=0.0)
    m = ServingMetrics()
    m.record_latency(0.01)
    fr.add_metrics("serve", lambda: m)
    path = fr.dump(trigger="flightz", force=True)
    (rec,) = [json.loads(ln) for ln in open(f"{path}/metrics.jsonl")]
    assert rec["record"] == "serve" and rec["snapshot"]["completed"] == 0


# ------------------------------------------------ engines and the loop
def test_serving_and_decode_engines_attach_and_detach(monkeypatch,
                                                      tmp_path):
    import bigdl_tpu_torch.nn as tnn
    from bigdl_tpu_torch.serving import DecodeEngine, ServingEngine

    monkeypatch.setenv("BIGDL_TPU_DEBUG_PORT", "0")
    monkeypatch.setenv("BIGDL_TPU_FLIGHT", "1")
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path))
    srv = debug_server.get_debug_server()
    torch.manual_seed(0)
    mlp = tnn.Sequential(tnn.Linear(8, 8), tnn.ReLU())
    eng = ServingEngine(mlp, buckets=[(8,)], batch_sizes=(1, 2),
                        device="cpu")
    lm = tnn.Transformer(20, 16, 2, 32, 1, dropout=0.0)
    dec = DecodeEngine(lm, slots=2, max_len=16, prompt_buckets=(4,),
                       prefill_batch_sizes=(1,), device="cpu")
    try:
        eng.start()
        dec.start()
        eng.submit(np.ones(8, np.float32)).result(60)
        dec.generate(np.array([1, 2]), 2, timeout=60)
        obj = json.loads(_get(srv.local_url("/statusz"))[1])
        assert sorted(e["name"] for e in obj["engines"]) == ["decode",
                                                             "serve"]
        serve = next(e for e in obj["engines"] if e["name"] == "serve")
        assert set(serve["detail"]) == {"queue_depth", "xray", "exemplars"}
        prom = parse_exposition_strict(_get(srv.local_url("/metricsz"))[1])
        assert prom[("bigdl_tpu_snapshot", (("key", "completed"),
                                            ("source", "serve")))] == 1
        fr = flightrecorder.get_flight_recorder(create=False)
        path = fr.dump(trigger="flightz", force=True)
        files = json.load(open(f"{path}/manifest.json"))["files"]
        assert {"exemplars-serve.json", "exemplars-decode.json"} <= set(files)
    finally:
        eng.close(timeout=60)
        dec.close(timeout=60)
    assert json.loads(_get(srv.local_url("/statusz"))[1])["engines"] == []


def test_training_loop_with_the_live_plane(tmp_path, monkeypatch):
    """An async loop with the server and the recorder live: mid-run
    scrapes parse and follow the loop's metrics, the numerics norms are
    served, and a NaN batch leaves a ``loss_divergence`` bundle the
    console renders; the loop detaches at its end."""
    import bigdl_tpu_torch.nn as tnn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.minibatch import MiniBatch
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    monkeypatch.setenv("BIGDL_TPU_DEBUG_PORT", "0")
    monkeypatch.setenv("BIGDL_TPU_FLIGHT", "1")
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path))

    key = ("bigdl_tpu_phase_count_total",
           (("phase", "dispatch"), ("source", "train")))
    norm = ("bigdl_tpu_numerics", (("stat", "grad_norm"),))
    seen = threading.Event()  # a scrape saw the loop's phases and norms

    class PoisonOnce:
        """The ``at``-th training batch is NaN; the third waits for a
        scrape of the running loop, however slow the host."""

        def __init__(self, base, at):
            self.base, self.at, self.count = base, at, 0

        def batches_per_epoch(self):
            return self.base.batches_per_epoch()

        def data(self, train):
            for b in self.base.data(train):
                self.count += train
                if self.count == 3 and train:
                    seen.wait(30)
                if self.count == self.at and train:
                    b = MiniBatch(np.full_like(b.get_input(), np.nan),
                                  b.get_target())
                yield b

    rs = np.random.RandomState(3)
    x = rs.randn(64, 10).astype(np.float32)
    y = (x @ rs.randn(10, 4)).argmax(-1).astype(np.int64)
    torch.manual_seed(0)
    opt = LocalOptimizer(
        tnn.Sequential(tnn.Linear(10, 16), tnn.ReLU(), tnn.Linear(16, 4)),
        PoisonOnce(DataSet.from_arrays(x, y, 16), 6),
        tnn.ClassNLLCriterion(logits=True), Trigger.max_epoch(6),
        device="cpu")
    opt.set_optim_method(SGD(0.1, momentum=0.9)).set_numerics(True)
    opt.set_checkpoint(str(tmp_path / "ck"), Trigger.every_epoch())
    srv = debug_server.get_debug_server()
    scrapes, stop = [], threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                scrapes.append(parse_exposition_strict(
                    _get(srv.local_url("/metricsz"), timeout=2.0)[1]))
                if key in scrapes[-1] and norm in scrapes[-1]:
                    seen.set()
            except (OSError, AssertionError):
                pass
            time.sleep(0.02)

    tr = ttel.get_tracer()
    tr.enable()
    t = threading.Thread(target=scraper, name="scraper")
    t.start()
    try:
        opt.optimize()
    finally:
        stop.set()
        t.join(10)
    tr.disable()
    assert seen.is_set()
    counts = [s[key] for s in scrapes if key in s]
    assert counts and counts == sorted(counts)
    assert counts[-1] <= opt.metrics.count("dispatch")
    fr = flightrecorder.get_flight_recorder(create=False)
    triggers = {json.load(open(f"{b}/manifest.json"))["trigger"]: b
                for b in fr.bundles()}
    assert "loss_divergence" in triggers
    assert "loss_divergence" in blackbox.render(
        blackbox.load_bundle(triggers["loss_divergence"]))
    assert opt._retries == 1
    assert json.loads(_get(srv.local_url("/statusz"))[1])["engines"] == []
