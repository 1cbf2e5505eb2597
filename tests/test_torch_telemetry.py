"""The port's telemetry plane (bigdl_tpu_torch.telemetry) against the JAX
package's on the CPU: the tracer and the Metrics span sink, the Chrome
trace exporter, the watchdog, the metrics JSONL and TensorBoard exports,
the cost table, the workload recorder, and the cost model's count of
the fused ResNet-50 against XLA's ``cost_analysis``."""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu import telemetry as jtel
from bigdl_tpu.models import ResNet50 as JaxResNet50
from bigdl_tpu.serving.metrics import ServingMetrics as JaxServingMetrics
from bigdl_tpu.serving.warmup import build_forward as jax_build_forward
from bigdl_tpu.telemetry import costmodel as jcost
from bigdl_tpu.telemetry import workload as jwork
from bigdl_tpu.telemetry.tracer import Span as JSpan
from bigdl_tpu.telemetry.watchdog import Watchdog as JWatchdog
from bigdl_tpu_torch import telemetry as ttel
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.prefetch import Prefetcher
from bigdl_tpu_torch.models import ResNet50
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import fused_matmul as fm
from bigdl_tpu_torch.ops import int8_matmul as im
from bigdl_tpu_torch.optim import Optimizer, SGD, Trigger, make_train_step
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.serving.metrics import (LATENCY_BUCKETS,
                                             PeriodicMetricsLogger,
                                             ServingMetrics)
from bigdl_tpu_torch.telemetry import costmodel, workload
from bigdl_tpu_torch.telemetry.tracer import Span
from bigdl_tpu_torch.telemetry.watchdog import Watchdog
from bigdl_tpu_torch.visualization import (ServingSummary, TelemetrySummary,
                                           read_events)


@pytest.fixture(autouse=True)
def clean_tracer():
    """Both packages' global tracers start disabled and empty."""
    trs = (ttel.get_tracer(), jtel.get_tracer())
    for tr in trs:
        tr.disable()
        tr.clear()
    yield trs[0]
    for tr in trs:
        tr.disable()
        tr.clear()


def _stream(seed=0, n=400):
    """One seeded span stream as tuples (name, cat, t0, t1, tid, thread,
    corr, args), fed to both packages."""
    rs = np.random.RandomState(seed)
    out, t = [], 100.0
    names = ["dispatch", "compute", "decode_tick", "data_stall", "sync",
             "recompile", "queue_full", "deadline_reject", "enqueue",
             "deliver", "hbm", "hbm_headroom", "loss_divergence",
             "recompile_forensics", "serve_fetch"]
    for i in range(n):
        name = names[rs.randint(len(names))]
        instant = name in ("queue_full", "deadline_reject", "enqueue",
                           "deliver", "hbm", "hbm_headroom",
                           "loss_divergence", "recompile_forensics")
        dur = 0.0 if instant else float(rs.exponential(0.01))
        if name in ("dispatch", "decode_tick") and rs.rand() < 0.05:
            dur *= 40  # spikes
        tid = int(rs.randint(1, 4))
        corr = (f"req:{rs.randint(50)}" if name in ("enqueue", "deliver",
                                                    "queue_full")
                else f"step:{i}" if rs.rand() < 0.5 else None)
        args = None
        if name == "hbm":
            args = {"bytes_in_use": int(rs.randint(1 << 30)),
                    "peak_bytes_in_use": int(rs.randint(1 << 31))}
        elif name == "hbm_headroom":
            args = {"frac_free": 0.05, "bytes_in_use": 95,
                    "bytes_limit": 100, "top_program": "train_step"}
        elif name == "loss_divergence":
            args = {"iteration": i, "detected_at": i + 3, "lag_steps": 3,
                    "sync_window": 10}
        elif name == "recompile_forensics":
            args = {"program": "serving_forward",
                    "cause": "arg `x` dim 1 — 8 → 16, dtype unchanged"}
        out.append((name, "train", t, t + dur, tid, f"thread-{tid}", corr,
                    args))
        t += dur + float(rs.exponential(0.001))
    return out


# ---------------------------------------------------------------- tracer
def test_disabled_tracer_records_nothing_and_metrics_is_a_span_sink(
        clean_tracer):
    tr = clean_tracer
    tr.instant("x")
    with tr.span("y"):
        pass
    m = Metrics()
    m.add("dispatch", 0.01)
    assert len(tr) == 0
    tr.enable()
    m.no_span("data")
    with ttel.correlate("step:3"):
        m.add("dispatch", 0.002)
        m.add("data", 0.5)
    (s,) = tr.spans()
    assert (s.name, s.cat, s.corr) == ("dispatch", "train", "step:3")
    assert s.duration == pytest.approx(0.002)
    assert m.count("data") == 1 and sorted(m.phases()) == ["data",
                                                           "dispatch"]


def test_ring_buffer_bound_and_subscribers(clean_tracer):
    tr = clean_tracer.enable(capacity=4)
    seen = []
    tr.subscribe(seen.append)
    try:
        for i in range(7):
            tr.instant(f"e{i}", corr=f"req:{i}")
    finally:
        tr.unsubscribe(seen.append)
        tr.enable(capacity=ttel.tracer.DEFAULT_CAPACITY)
    assert [s.name for s in tr.spans()] == ["e3", "e4", "e5", "e6"]
    assert tr.dropped == 3 and len(seen) == 7


@pytest.mark.parametrize("chunk", [3, 1024])
@pytest.mark.parametrize("capacity", [1, 5, 8, 64])
def test_ring_chunks_read_back_and_bisect(monkeypatch, chunk, capacity):
    """The ring's chunks give exactly the newest ``capacity`` spans, and
    ``window_since`` the ones recorded at or after a time (here the
    clock reads i when span i is recorded, alone or in bulk)."""
    monkeypatch.setattr(ttel.tracer, "_CHUNK", chunk)
    clock = [0.0]
    monkeypatch.setattr(ttel.tracer.time, "perf_counter", lambda: clock[0])
    tr = ttel.Tracer(capacity=capacity, enabled=True)
    want = []
    for i in range(40):
        clock[0] = float(i)
        if i % 3:
            tr.add_span("x", "serve", i - 0.5, float(i), corr=f"step:{i}")
        else:  # bulk, as a serving batch's edges
            tr.add_instants("x", "serve", [float(i)], [f"step:{i}"])
        want = (want + [(float(i), f"step:{i}")])[-capacity:]
        assert [(s.t1, s.corr) for s in tr.spans()] == want
        assert len(tr) == len(want)
        assert tr.dropped == max(0, i + 1 - capacity)
        for t in (-1.0, 0.0, 3.5, 12.0, 39.0, 40.0):
            got = ttel.tracer.window_spans(tr.window_since(t))
            assert [(s.t1, s.corr) for s in got] == [
                w for w in want if w[0] >= t]
    tr.enable(capacity=max(1, capacity // 2))
    want = want[-max(1, capacity // 2):]
    assert [(s.t1, s.corr) for s in tr.spans()] == want
    tr.enable(capacity=2 * capacity)  # a wider ring holds no more
    assert [(s.t1, s.corr) for s in tr.spans()] == want
    # a bulk record wider than the ring keeps its newest
    tr.add_instants("y", "serve", [50.0 + k for k in range(3 * capacity)],
                    [None] * (3 * capacity))
    assert [s.t1 for s in tr.spans()] == [
        50.0 + k for k in range(capacity, 3 * capacity)]


def test_prefetcher_records_a_span_per_item(clean_tracer):
    clean_tracer.enable()
    p = Prefetcher(iter(range(5)), depth=2)
    assert list(p) == list(range(5))
    spans = [s for s in clean_tracer.spans() if s.name == "prefetch_item"]
    assert [s.corr for s in spans] == [f"item:{i}" for i in range(5)]
    assert {s.thread for s in spans} == {"bigdl-prefetch"}


@pytest.mark.parametrize("seed", [0, 1])
def test_chrome_trace_events_equal_jax(seed):
    rows = _stream(seed, 200)
    jt, tt = jtel.Tracer(), ttel.Tracer()
    jt.epoch = tt.epoch = 99.5
    je = jtel.chrome_trace(jt, [JSpan(*r) for r in rows])
    te = ttel.chrome_trace(tt, [Span(*r) for r in rows])
    assert te == je
    kinds = {e["ph"] for e in te["traceEvents"]}
    assert {"M", "X", "i", "C", "s", "f"} <= kinds
    # the same rows recorded through add_span (this thread's track)
    jt, tt = jtel.Tracer(enabled=True), ttel.Tracer(enabled=True)
    jt.epoch = tt.epoch = 99.5
    for name, cat, t0, t1, _, _, corr, args in rows:
        jt.add_span(name, cat, t0, t1, corr=corr, args=args)
        tt.add_span(name, cat, t0, t1, corr=corr, args=args)
    assert ttel.chrome_trace(tt) == jtel.chrome_trace(jt)


def test_write_chrome_trace_parses_back_with_thread_tracks(clean_tracer,
                                                           tmp_path):
    tr = clean_tracer.enable()

    def worker():
        with tr.span("serve_fetch", "serve", corr="req:1"):
            time.sleep(0.001)

    th = threading.Thread(target=worker, name="bigdl-serve-drain")
    with tr.span("serve_dispatch", "serve", corr="req:1"):
        th.start()
        th.join(10)
    path = ttel.write_chrome_trace(str(tmp_path / "t" / "trace.json"))
    blob = json.loads(open(path).read())
    names = {e["args"]["name"] for e in blob["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "bigdl-serve-drain" in names and len(names) == 2
    assert any(e["ph"] == "f" and e["name"] == "req:1"
               for e in blob["traceEvents"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watchdog_counters_equal_jax(seed):
    rows = _stream(seed)
    jw = JWatchdog(log=None, min_samples=10, stall_window=8)
    tw = Watchdog(log=None, min_samples=10, stall_window=8)
    for r in rows:
        jw.observe(JSpan(*r))
        tw.observe(Span(*r))
    assert tw.counters == jw.counters
    assert [a["message"] for a in tw.report()["anomalies"]] == \
        [a["message"] for a in jw.report()["anomalies"]]
    assert tw.total() > 5 and tw.log_line() == jw.log_line()
    assert tw.SUMMARY_TAGS == jw.SUMMARY_TAGS


def test_watchdog_attached_counts_and_writes_tensorboard(clean_tracer,
                                                         tmp_path):
    tr = clean_tracer.enable()
    with Watchdog(log=None).attach() as wd:
        tr.instant("queue_full", "serve", corr="req:1")
        tr.add_span("recompile", "serve", 1.0, 1.5)
        wd.close()
        tr.instant("queue_full", "serve")  # after close: not counted
    assert wd.counters["queue_full"] == 1
    assert wd.counters["steady_state_recompiles"] == 1
    s = TelemetrySummary(str(tmp_path), "app")
    written = wd.write_summary(s, 3)
    s.close()
    got = {r["tag"]: r["value"] for r in read_events(
        next(str(p) for p in (tmp_path / "app" / "telemetry").iterdir()))}
    assert got["Watchdog/QueueFull"] == 1.0 == written["queue_full"]


def test_metrics_jsonl_and_scalars(tmp_path):
    m = Metrics()
    m.add("dispatch", 0.004)
    m.add("dispatch", 0.002)
    m.set_value("mfu", 0.25)
    rec = ttel.metrics_record("train", m, extra={"run": 1})
    assert rec["phases"] == {"dispatch": {"mean_ms": 3.0, "count": 2}}
    assert rec["values"] == {"mfu": 0.25} and rec["run"] == 1
    path = str(tmp_path / "m" / "metrics.jsonl")
    ttel.write_metrics_jsonl(path, [rec])
    ttel.write_metrics_jsonl(path, [rec])
    back = ttel.read_metrics_jsonl(path)
    assert back == [rec, rec] == jtel.read_metrics_jsonl(path)
    s = TelemetrySummary(str(tmp_path), "app")
    ttel.write_scalars(s, {"mfu": 0.25, "qps": 3}, 7, prefix="T/")
    s.close()
    assert s.read_scalar("T/mfu") == [(7, 0.25)]


# ---------------------------------------------------------- serving metrics
def test_serving_metrics_cost_histogram_and_summary_equal_jax(tmp_path):
    jm, tm = JaxServingMetrics(), ServingMetrics()
    rs = np.random.RandomState(3)
    for v in rs.exponential(0.05, 300):
        jm.record_latency(float(v))
        tm.record_latency(float(v))
    assert tm.latency_histogram() == jm.latency_histogram()
    assert LATENCY_BUCKETS == tuple(le for le, _ in
                                    jm.latency_histogram()["buckets"][:-1])
    cost = costmodel.ProgramCost("serving_forward:4x8", flops=2e9,
                                 bytes_accessed=1e8)
    tm.record_program_cost(cost)
    for _ in range(5):
        tm.record_compute(cost.flops, cost.bytes_accessed)
    assert tm.program_costs() == {"serving_forward:4x8": cost}
    tm._t0 -= 100.0  # a 100 s run: the calls' own time is negligible
    assert tm.gflops_per_sec() == pytest.approx(10.0 / 100, rel=1e-3)
    assert tm.bytes_per_sec() == pytest.approx(5e8 / 100, rel=1e-3)
    assert tm.mfu() == pytest.approx(1e10 / 100 / 1.0e11, rel=1e-3)
    assert " GF/s | mfu=" in tm.log_line()
    assert tm.SUMMARY_TAGS == jm.SUMMARY_TAGS
    s = ServingSummary(str(tmp_path), "serve")
    snap = tm.write_summary(s, 1)
    s.close()
    assert s.read_scalar("Serving/MFU") == [(1, pytest.approx(snap["mfu"]))]


def test_periodic_logger_samples_the_hbm_ledger():
    ledger = ttel.get_hbm_ledger()
    before = len(ledger.samples())
    lines = []
    log = PeriodicMetricsLogger(lambda: "line", every_s=0.01,
                                sink=lines.append).start()
    deadline = time.time() + 10
    while (len(ledger.samples()) == before or not lines) \
            and time.time() < deadline:
        time.sleep(0.01)
    log.close()
    assert lines and len(ledger.samples()) > before
    assert ledger.samples()[-1]["source"] == "estimate"  # no card here


# ---------------------------------------------------------- cost model
def test_peak_flops_env_and_cpu_nominal(monkeypatch):
    assert costmodel.peak_flops_per_device("cpu") == 1.0e11
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "2e12")
    assert costmodel.peak_flops_per_device() == 2e12
    assert costmodel.mfu(1e12, 1.0) == 0.5


def test_cost_table_json_round_trips_both_ways(tmp_path):
    tt, jt = costmodel.CostTable(), jcost.CostTable()
    for i, (f, b) in enumerate(np.random.RandomState(0).rand(4, 2)):
        tt.add(costmodel.ProgramCost(f"p{i}", flops=float(f) * 1e9,
                                     bytes_accessed=float(b) * 1e6,
                                     argument_bytes=i, output_bytes=2 * i,
                                     stamped_unix=1.5))
        jt.add(jcost.ProgramCost(f"q{i}", flops=float(f), n_devices=2))
    tt.persist(str(tmp_path / "t.json"))
    jt.persist(str(tmp_path / "j.json"))
    assert jcost.CostTable.load(str(tmp_path / "t.json")).records() == \
        tt.records()
    assert costmodel.CostTable.load(str(tmp_path / "j.json")).records() == \
        jt.records()


def test_counting_adds_kernel_formulas_in_place_of_plain_versions():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(40, 24).astype(np.float32))
    w = torch.from_numpy(rs.randn(24, 16).astype(np.float32))
    ps = torch.ones(24)
    with costmodel.counting() as c:
        fm.fused_matmul_bn(x, w, ps, torch.zeros(24))
    assert c.flops == fm.cost_matmul(40, 24, 16, True, 4)[0]
    assert c.bytes_accessed >= fm.cost_matmul(40, 24, 16, True, 4)[1]
    # a width the kernels pad (12) is counted once, at its own shape
    x12 = torch.from_numpy(rs.randn(2, 5, 5, 12).astype(np.float32))
    w12 = torch.from_numpy(rs.randn(3, 3, 12, 8).astype(np.float32))
    with costmodel.counting() as c:
        fm.fused_conv3x3_bn(x12, w12)
    assert c.flops == 18 * 50 * 12 * 8
    q, k, v = (torch.from_numpy(rs.randn(2, 3, 16, 32).astype(np.float32))
               for _ in range(3))
    with costmodel.counting() as c:
        fa.flash_attention_lse(q, k, v, causal=True)
    assert (c.flops, c.bytes_accessed) == fa.flash_cost(2, 3, 16, 16, 32,
                                                        True, 4)
    xq = torch.from_numpy(rs.randint(-127, 128, (8, 32)).astype(np.int8))
    wq = torch.from_numpy(rs.randint(-127, 128, (32, 24)).astype(np.int8))
    scale = torch.ones(24)
    with costmodel.counting() as c:
        im.int8_matmul_dequant(xq, wq, scale, torch.float32)
    assert (c.flops, c.bytes_accessed) == im.int8_cost(8, 32, 24, 4)
    # no count running: the wrappers add nothing anywhere
    fm.fused_matmul_bn(x, w)


@pytest.fixture(scope="module")
def fused_resnet50():
    return ResNet50(1000, stem="space_to_depth", fused=True,
                    device="cpu").eval()


@pytest.fixture
def one_thread():
    """Counting needs no speed: one intra-op thread leaves the other
    test workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fused_resnet50_forward_count_within_5_percent_of_xla(
        fused_resnet50, one_thread):
    """The port counts every 3x3 window in full where XLA leaves out the
    taps on the SAME padding: 3.06% more at 224 px."""
    jm = JaxResNet50(1000, stem="space_to_depth", fused=True)
    var = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    x = jax.ShapeDtypeStruct((2, 224, 224, 3), jnp.float32)
    jc = jcost.stamp_jitted("fwd", jax.jit(jax_build_forward(jm)),
                            var["params"], var["state"], x,
                            table=jcost.CostTable())
    count = costmodel.new_count()
    from bigdl_tpu_torch.serving.warmup import build_forward
    from bigdl_tpu_torch.utils import graphs
    graphs.compile(build_forward(fused_resnet50),
                   (torch.zeros(2, 224, 224, 3),), count=count)
    assert 1.0 < count.flops / jc.flops < 1.05
    assert count.argument_bytes == 2 * 224 * 224 * 3 * 4
    assert count.output_bytes == 2 * 1000 * 4
    # the same with the kernels' plain versions called by the blocks
    tnn.use_plain_ops(fused_resnet50)
    try:
        with torch.inference_mode(), costmodel.counting() as plain:
            fused_resnet50(torch.zeros(2, 224, 224, 3))
    finally:
        tnn.use_plain_ops(fused_resnet50, False)
    assert plain.flops == count.flops


def test_train_step_count_equal_with_plain_ops(one_thread):
    """Kernels 2, 3 and 5 (the backward) count what autograd counts over
    the plain versions; the quantized MLP's kernel 7 its own product."""
    model = ResNet50(10, stem="space_to_depth", fused=True, device="cpu")
    crit = tnn.ClassNLLCriterion(logits=True)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(2, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, (2,)))
    counts = []
    for plain in (False, True):
        tnn.use_plain_ops(model, plain)
        step = make_train_step(model, crit, {"__all__": SGD(0.1)})
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = {k: b.detach().clone() for k, b in model.named_buffers()}
        opt = {"__all__": SGD(0.1).init_state(params)}
        with costmodel.counting() as c:
            step(params, state, opt, 1, 0, x, y, [0.1])
        counts.append(c.flops)
    assert counts[0] == counts[1] > 0
    torch.manual_seed(0)
    mlp = tnn.Sequential(tnn.Linear(32, 64), tnn.ReLU(), tnn.Linear(64, 8))
    qm, _ = tnn.quantize(mlp)
    xs = torch.from_numpy(rs.rand(4, 32).astype(np.float32))
    qcounts = []
    for plain in (False, True):
        tnn.use_plain_ops(qm, plain)
        with torch.inference_mode(), costmodel.counting() as c:
            qm(xs)
        qcounts.append(c.flops)
    assert qcounts[0] == qcounts[1] >= 2 * 4 * (32 * 64 + 64 * 8)


def test_training_loop_logs_mfu_and_registers_its_step(clean_tracer,
                                                       caplog):
    clean_tracer.enable()
    torch.manual_seed(0)
    model = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 4))
    rs = np.random.RandomState(0)
    x = rs.rand(64, 8).astype(np.float32)
    y = rs.randint(0, 4, (64,)).astype(np.int64)
    opt = Optimizer.apply(model, DataSet.from_arrays(x, y, batch_size=16),
                          tnn.ClassNLLCriterion(logits=True),
                          end_trigger=Trigger.max_iteration(12),
                          device="cpu")
    with caplog.at_level("INFO", logger="bigdl_tpu_torch.optim"):
        opt.optimize()
    cost = opt.train_step.cost
    # forward, backward twice over, but no gradient of the input
    assert cost.flops == 3 * 2 * 16 * (8 * 16 + 16 * 4) - 2 * 16 * 8 * 16
    assert "mfu:" in caplog.records[-1].getMessage()
    assert "bytes_per_sec" in opt.metrics.values()
    rec = ttel.get_program_registry().get("train_step")
    assert rec.cost is cost and rec.calls >= 11 and rec.mfu > 0
    steps = {s.corr for s in clean_tracer.spans() if s.name == "dispatch"}
    assert {"step:1", "step:12"} <= steps


# ---------------------------------------------------------- workload
def test_workload_recorded_by_either_package_loads_in_the_other(tmp_path):
    rs = np.random.RandomState(0)
    tp, jp = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    tr, jr = workload.WorkloadRecorder(tp), jwork.WorkloadRecorder(jp)
    for rec in (tr, jr):
        for i in range(5):
            prompt = rs.randint(0, 50, rs.randint(1, 9)).tolist()
            rec.record_decode(i, prompt, 8, temperature=0.5, seed=i)
            rec.record_serve(100 + i, (8, 16), "float32", deadline_ms=50.0)
        rec.close()
    assert tr.count == jr.count == 10
    assert workload.VERSION == jwork.VERSION
    for p in (tp, jp):
        assert workload.load_workload(p) == jwork.load_workload(p)
    assert [r["kind"] for r in workload.load_workload(jp)][:2] == [
        "decode", "serve"]
    (tmp_path / "bad.jsonl").write_text('{"record": "request"}\n')
    with pytest.raises(ValueError, match="not a workload"):
        workload.load_workload(str(tmp_path / "bad.jsonl"))


def test_workload_env_arms_the_recorder(tmp_path, monkeypatch):
    path = str(tmp_path / "w.jsonl")
    workload.disarm()
    monkeypatch.setattr(workload, "_ENV_CHECKED", False)
    monkeypatch.setenv("BIGDL_TPU_WORKLOAD_RECORD", path)
    try:
        rec = workload.recorder()
        assert rec is not None and rec.path == path
    finally:
        workload.disarm()
    assert workload.recorder() is None
