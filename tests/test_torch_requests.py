"""The port's request X-ray (bigdl_tpu_torch.telemetry.requests) against
the JAX package's on the CPU: the ledger's exact partition under an
injected clock, span-tree assembly, the exemplar reservoir, and real
engine runs (MLP engines in both packages, and the port's decode
engine): each request's phases sum to its latency, and a request that
expires in the queue names ``queue`` in its error."""
import time

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu import telemetry as jtel
from bigdl_tpu.serving import DeadlineExceededError as JaxDeadline
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.telemetry import requests as jreq
from bigdl_tpu.telemetry import tracer as jtr
from bigdl_tpu.telemetry.tracer import Span as JSpan
from bigdl_tpu_torch import telemetry as ttel
from bigdl_tpu_torch.serving import (DeadlineExceededError, DecodeEngine,
                                     ServingEngine)
from bigdl_tpu_torch.telemetry import flightrecorder
from bigdl_tpu_torch.telemetry import requests as treq
from bigdl_tpu_torch.telemetry import tracer as ttr
from bigdl_tpu_torch.telemetry.tracer import Span

FEAT = 16
WAIT = 60


@pytest.fixture(autouse=True)
def no_ambient_correlation():
    """Each test starts with no ambient correlation in either package: a
    training loop run earlier in the process (another test file) leaves
    its last ``step:<n>`` set on this thread, as the JAX loop does."""
    jtr.set_correlation(None)
    ttr.set_correlation(None)
    yield
    jtr.set_correlation(None)
    ttr.set_correlation(None)


@pytest.fixture(autouse=True)
def traced():
    """Both packages' tracers on (attribution follows them), and empty."""
    trs = (ttel.get_tracer(), jtel.get_tracer())
    for tr in trs:
        tr.clear()
        tr.enable()
    yield trs[0]
    for tr in trs:
        tr.disable()
        tr.clear()
    # the engines arm the flight recorder while tracing
    flightrecorder.set_global(None)


def _script(seed, n_req=12, n_ops=160):
    """A seeded sequence of ledger calls (op, rid or rids, phase, now)."""
    rs = np.random.RandomState(seed)
    ops, now, open_ = [], 10.0, []
    for i in range(n_ops):
        now += float(rs.exponential(0.003))
        k = rs.randint(6)
        if k == 0 and len(open_) < n_req:
            rid = len(ops)
            open_.append(rid)
            ops.append(("open", rid, None, now))
        elif open_ and k in (1, 2):
            ops.append(("to", open_[rs.randint(len(open_))],
                        treq.PHASES[rs.randint(len(treq.PHASES))], now))
        elif open_ and k == 3:
            pick = [r for r in open_ if rs.rand() < 0.5]
            ops.append(("to_many", pick,
                        treq.PHASES[rs.randint(len(treq.PHASES))], now))
        elif open_ and k == 4:
            ops.append(("note", open_[rs.randint(len(open_))], "ticks",
                        now))
        elif open_:
            rid = open_.pop(rs.randint(len(open_)))
            ops.append(("close", rid, None, now))
    return ops


def _play(ledger, ops):
    out = []
    for op, rid, phase, now in ops:
        if op == "open":
            ledger.open(rid, now=now)
        elif op == "to":
            ledger.to(rid, phase, now=now)
        elif op == "to_many":
            ledger.to_many(rid, phase, now=now)
        elif op == "note":
            ledger.note(rid, phase)
        else:
            att = ledger.close(rid, now=now)
            out.append(att.as_dict())
            assert sum(att.phases.values()) == pytest.approx(att.latency,
                                                             abs=1e-9)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_attributions_equal_jax(seed):
    ops = _script(seed)
    tl = treq.RequestLedger(tracer=ttel.get_tracer())
    jl = jreq.RequestLedger(tracer=jtel.get_tracer())
    got = _play(tl, ops)
    assert got == _play(jl, ops) and len(got) >= 3
    assert tl.summary() == jl.summary()
    assert tl.log_line() == jl.log_line()


def test_ledger_env_forces_attribution(monkeypatch, traced):
    traced.disable()
    assert not treq.RequestLedger().enabled
    monkeypatch.setenv("BIGDL_TPU_REQ_TRACE", "1")
    assert treq.RequestLedger().enabled and treq.request_trace_enabled()
    monkeypatch.setenv("BIGDL_TPU_REQ_TRACE", "0")
    traced.enable()
    assert not treq.RequestLedger().enabled


def test_request_trees_and_exemplars_equal_jax():
    rs = np.random.RandomState(4)
    rows = []
    for i in range(60):
        t0 = 5.0 + float(rs.rand())
        rid = int(rs.randint(8))
        kind = rs.randint(3)
        if kind == 0:
            rows.append(("enqueue", "serve", t0, t0, 1, "client",
                         f"req:{rid}", None))
        elif kind == 1:
            rows.append(("dispatch_batch", "serve", t0, t0, 2, "dispatch",
                         None, {"rids": [rid, (rid + 1) % 8]}))
        else:
            rows.append(("decode_tick", "decode", t0, t0 + 0.01, 3, "loop",
                         f"tick:{i}", None))
    dicts = [dict(zip(("name", "cat", "t0", "t1", "tid", "thread", "corr",
                       "args"), r)) for r in rows]
    assert treq.assemble_request_trees(dicts) == \
        jreq.assemble_request_trees(dicts)
    tt = treq.assemble_request_trees([Span(*r) for r in rows])
    assert {k: (v["threads"], len(v["spans"])) for k, v in tt.items()} == \
        {k: (v["threads"], len(v["spans"])) for k, v in
         jreq.assemble_request_trees([JSpan(*r) for r in rows]).items()}
    tr, jr = ttel.Tracer(enabled=True), jtel.Tracer(enabled=True)
    for r in rows:
        tr.add_span(*r[:4], corr=r[6], args=r[7])
        jr.add_span(*r[:4], corr=r[6], args=r[7])
    te = treq.ExemplarReservoir(capacity=3, min_samples=5, tracer=tr)
    je = jreq.ExemplarReservoir(capacity=3, min_samples=5, tracer=jr)
    for i, lat in enumerate(rs.exponential(0.05, 40)):
        phases = {"queue": float(lat) / 2, "device": float(lat) / 2}
        te.offer(treq.Attribution(i % 8, 5.0, 5.0 + lat, phases, {}))
        je.offer(jreq.Attribution(i % 8, 5.0, 5.0 + lat, phases, {}))
    assert te.summary() == je.summary() and te.summary()["kept"] == 3
    strip = [{k: v for k, v in ex.items() if k != "spans"}
             for ex in te.as_blob()["exemplars"]]
    assert strip == [{k: v for k, v in ex.items() if k != "spans"}
                     for ex in je.as_blob()["exemplars"]]


def _mlps():
    jm = jnn.Sequential(jnn.Linear(FEAT, 32), jnn.ReLU(), jnn.Linear(32, 8))
    var = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = tnn.Sequential(tnn.Linear(FEAT, 32), tnn.ReLU(), tnn.Linear(32, 8))
    return (jm, var), tm


def _engines(**kw):
    (jm, var), tm = _mlps()
    kw = dict(buckets=[(8, FEAT)], batch_sizes=(1, 4), **kw)
    return [("jax", JaxServingEngine(jm, var, **kw)),
            ("port", ServingEngine(tm, device="cpu", **kw))]


def test_engine_phases_sum_to_latency_in_both_packages(traced):
    x = np.random.RandomState(0).rand(24, 5, FEAT).astype(np.float32)
    for name, eng in _engines():
        try:
            futs = [eng.submit(s) for s in x]
            for f in futs:
                f.result(WAIT)
        finally:
            eng.close()
        atts = eng.xray.recent(64)
        assert len(atts) == len(x), name
        for a in atts:
            assert set(a.phases) <= {"queue", "pad", "device", "deliver"}
            assert abs(sum(a.phases.values()) - a.latency) < 1e-6, name
        assert eng.xray.summary()["n_closed"] == len(x)
        assert "xray: n=24" in eng.log_line()
    spans = ttel.get_tracer().spans()
    names = {s.name for s in spans}
    assert {"enqueue", "dispatch_batch", "deliver", "serve_dispatch",
            "serve_fetch"} <= names
    tracks = {s.thread for s in spans if s.name in ("dispatch_batch",
                                                    "deliver")}
    assert tracks == {"bigdl-serve-dispatch", "bigdl-serve-drain"}
    trees = ttel.assemble_request_trees(spans)
    assert len(trees) == len(x)
    assert all(len(t["threads"]) >= 2 for t in trees.values())


def test_expired_request_names_queue_in_both_packages():
    x = np.zeros((5, FEAT), np.float32)
    for name, eng in _engines(start=False):
        try:
            fut = eng.submit(x, deadline_ms=1.0)
            time.sleep(0.05)
            eng.start()
            err = fut.exception(WAIT)
        finally:
            eng.close()
        assert isinstance(err, (JaxDeadline, DeadlineExceededError)), name
        assert err.attribution.dominant()[0] == "queue"
        assert "[dominant: queue" in str(err), name


def test_decode_engine_attributions_and_trace(traced):
    torch.manual_seed(0)
    lm = tnn.Transformer(50, 32, 4, 64, 1, dropout=0.0).eval()
    eng = DecodeEngine(lm, slots=2, max_len=32, prompt_buckets=(4, 8),
                       prefill_batch_sizes=(1, 2), device="cpu")
    rs = np.random.RandomState(1)
    try:
        futs = [eng.submit(rs.randint(0, 50, (rs.randint(1, 8),)), 5)
                for _ in range(5)]
        for f in futs:
            f.result(WAIT)
    finally:
        eng.close(timeout=WAIT)
    atts = eng.xray.recent(16)
    assert len(atts) == 5
    for a in atts:
        assert abs(sum(a.phases.values()) - a.latency) < 1e-6
        assert {"queue", "prefill", "sample", "resident",
                "deliver"} >= set(a.phases) and a.counters["ticks"] >= 1
    spans = traced.spans()
    ticks = [s for s in spans if s.name == "decode_tick"]
    assert ticks and all(s.corr.startswith("tick:") for s in ticks)
    assert {"enqueue", "slot_fill", "deliver", "slot_free"} <= \
        {s.name for s in spans}


def test_exemplar_capture_of_a_live_ring_equals_jax(monkeypatch):
    """Spans recorded when they end, a request's own spans only in its
    life (as the engines record them): the port's capture, which looks
    back only to the request's opening, keeps what JAX's whole-ring scan
    keeps."""
    clock = [0.0]
    monkeypatch.setattr(ttel.tracer.time, "perf_counter", lambda: clock[0])
    rs = np.random.RandomState(5)
    tr, jr = ttel.Tracer(enabled=True), jtel.Tracer(enabled=True)
    end = 6.0
    opens = {99: end - 0.05, 7: end - 0.5, 31: end - 2.0}
    t = 0.0
    while t < end:
        t += float(rs.exponential(0.002))
        live = [r for r, t_open in opens.items() if t >= t_open]
        rid = int(rs.choice(live)) if live and rs.rand() < 0.3 \
            else int(rs.randint(200, 400))  # other requests
        kind = rs.randint(3)
        corr = (f"req:{rid}" if kind == 0 else
                f"tick:{int(t * 1e3)}" if kind == 1 else None)
        args = {"rids": [rid, rid + 1]} if kind == 2 else None
        dur = 0.001 if kind == 1 else 0.0
        clock[0] = t
        for tracer in (tr, jr):
            tracer.add_span("x", "serve", t - dur, t, corr=corr, args=args)
    te = treq.ExemplarReservoir(capacity=4, min_samples=1, tracer=tr)
    je = jreq.ExemplarReservoir(capacity=4, min_samples=1, tracer=jr)
    for rid, t_open in opens.items():  # latencies rising: each captured
        te.offer(treq.Attribution(rid, t_open, t, {"queue": t - t_open},
                                  {}))
        je.offer(jreq.Attribution(rid, t_open, t, {"queue": t - t_open},
                                  {}))
    got, want = te.as_blob(), je.as_blob()
    assert got["captured"] == want["captured"] == 3
    for a, b in zip(got["exemplars"], want["exemplars"]):
        assert a["spans"][1:] == b["spans"][1:] and len(a["spans"]) > 5


def test_close_many_is_to_then_close_and_survives_a_tracer_flip():
    """The serving engine's batch close equals JAX's ``to_many`` into
    the deliver phase then ``close`` per request, and closes what was
    opened while the ledger was on even after the tracer is turned off."""
    tr, jr = ttel.Tracer(enabled=True), jtel.Tracer(enabled=True)
    tl, jl = treq.RequestLedger(tracer=tr), jreq.RequestLedger(tracer=jr)
    rids = [3, 5, 8]
    for led in (tl, jl):
        for i, rid in enumerate(rids):
            led.open(rid, now=1.0 + i)
        led.to_many(rids, treq.PHASE_DEVICE, now=5.0)
    jl.to_many(rids, jreq.PHASE_DELIVER, now=6.0)
    want = [jl.close(rid, now=6.5).as_dict() for rid in rids]
    tr.disable()  # flipped after the batch was delivered
    got = tl.close_many(rids + [99], treq.PHASE_DELIVER, 6.0, now=6.5)
    assert [a.as_dict() for a in got[:3]] == want and got[3] is None
    assert tl.open_count() == 0
