"""The port's program X-ray (bigdl_tpu_torch.telemetry.programs) against
the JAX package's on the CPU: signatures and their diff text, the
registry's recompile forensics, ``instrument``, the HBM ledger, the
kernels' route records, and the engines' registrations (a learned bucket
named by its changed axis, and counted by the watchdog)."""
import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu import telemetry as jtel
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.telemetry import programs as jprog
from bigdl_tpu_torch import telemetry as ttel
from bigdl_tpu_torch.ops import fused_matmul as fm
from bigdl_tpu_torch.serving import DecodeEngine, ServingEngine
from bigdl_tpu_torch.telemetry import flightrecorder, programs
from bigdl_tpu_torch.telemetry.watchdog import Watchdog
from bigdl_tpu_torch.utils import graphs

FEAT = 16
WAIT = 60


@pytest.fixture(autouse=True)
def clean():
    """Disabled, empty tracers and empty registries in both packages."""
    for mod in (ttel, jtel):
        mod.get_tracer().disable()
        mod.get_tracer().clear()
        mod.get_program_registry().clear()
    yield
    for mod in (ttel, jtel):
        mod.get_tracer().disable()
        mod.get_tracer().clear()
        mod.get_program_registry().clear()
    # the engines arm the flight recorder while tracing
    flightrecorder.set_global(None)


def _trees(seed):
    """A seeded sequence of numpy trees of one program's arguments, each
    a small change of a base tree (a dim, a dtype, a new or a dropped
    argument)."""
    rs = np.random.RandomState(seed)
    base = {"cache": {"k": np.zeros((2, 4, 128, 8), np.float32),
                      "v": np.zeros((2, 4, 128, 8), np.float32)},
            "ids": np.zeros((4, 16), np.int32),
            "lens": [np.zeros((4,), np.int32), np.zeros((), np.int32)]}
    out = [base]
    for _ in range(8):
        t = {"cache": dict(base["cache"]), "ids": base["ids"],
             "lens": list(base["lens"])}
        kind = rs.randint(5)
        if kind == 0:
            t["cache"]["k"] = np.zeros((2, 4, int(rs.choice([96, 160])), 8),
                                       np.float32)
        elif kind == 1:
            t["ids"] = np.zeros((int(rs.randint(1, 9)), 16), np.int64)
        elif kind == 2:
            t["extra"] = np.zeros((3,), np.float32)
        elif kind == 3:
            del t["lens"]
        else:
            t["cache"]["v"] = np.zeros((1, 4, 64, 8), np.float16)
        out.append(t)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signatures_and_diffs_equal_jax(seed):
    trees = _trees(seed)
    for t in trees:
        js = jprog.signature_of(t, static={"b": 2}, donated=("cache",))
        ts = programs.signature_of(t, static={"b": 2}, donated=("cache",))
        assert ts.as_dict() == js.as_dict()
    for a in trees:
        for b in trees:
            ja, jb = jprog.signature_of(a), jprog.signature_of(b)
            ta, tb = programs.signature_of(a), programs.signature_of(b)
            assert programs.diff_signatures(ta, tb) == \
                jprog.diff_signatures(ja, jb)
            assert programs.signature_distance(ta, tb) == \
                jprog.signature_distance(ja, jb)


def test_torch_trees_and_modules_render_as_jax_paths():
    t = {"cache": {"k": torch.zeros(2, 128, dtype=torch.bfloat16)},
         "ids": torch.zeros(4, 16, dtype=torch.int32)}
    n = {"cache": {"k": np.zeros((2, 160), np.float32)},
         "ids": np.zeros((4, 16), np.int32)}
    ts = programs.signature_of(t)
    assert ts.avals[0] == ("cache.k", (2, 128), "bfloat16", "cpu")
    # a tensor's device stands where JAX keeps the sharding
    assert programs.diff_signatures(ts, programs.signature_of(n)) == [
        "arg `cache.k` dim 1 — 128 → 160, dtype bfloat16 → float32",
        "arg `ids` sharding changed"]
    m = tnn.Sequential(tnn.Linear(3, 4), tnn.BatchNormalization(4))
    paths = [row[0] for row in programs.signature_of({"p": m}).avals]
    assert paths == sorted(["p." + k for k, _ in m.named_parameters()]
                           + ["p." + k for k, _ in m.named_buffers()])


@pytest.mark.parametrize("seed", [0, 3])
def test_registry_forensics_equal_jax(seed):
    trees = _trees(seed)
    jr, tr = jprog.ProgramRegistry(), programs.ProgramRegistry()
    for i, t in enumerate(trees):
        for reg, mod in ((jr, jprog), (tr, programs)):
            reg.register_compile("decode_tick", mod.signature_of(t),
                                 compile_s=0.5, expected=(i == 0))
            reg.record_call("decode_tick", 3)
    tf = [{k: f[k] for k in ("program", "cause", "changes")}
          for f in tr.forensic_records()]
    jf = [{k: f[k] for k in ("program", "cause", "changes")}
          for f in jr.forensic_records()]
    assert tf == jf and len(tf) >= 1
    rec = tr.get("decode_tick")
    assert rec.calls == 3 * len(trees) and rec.compiles == len(trees)
    assert {k: v for k, v in tr.records()[0].items()
            if k != "last_compile_unix"} == \
        {k: v for k, v in jr.records()[0].items()
         if k != "last_compile_unix"}


def test_forensic_instant_feeds_the_watchdog():
    tr = ttel.get_tracer().enable()
    reg = ttel.get_program_registry()
    with Watchdog(log=None).attach() as wd:
        reg.register_compile("serving_forward", programs.signature_of(
            {"x": np.zeros((4, 8, 16), np.float32)}), expected=True)
        reg.register_compile("serving_forward", programs.signature_of(
            {"x": np.zeros((4, 24, 16), np.float32)}), compile_s=0.1)
        tr.add_span("recompile", "serve", 1.0, 1.1)
    assert wd.counters["steady_state_recompiles"] == 1
    assert "serving_forward: arg `x` dim 1 — 8 → 24" in \
        wd.anomalies[0]["message"]


def test_instrument_counts_calls_and_registers_new_shapes():
    reg = programs.ProgramRegistry()
    fn = programs.instrument("fwd", lambda x: x * 2, registry=reg,
                             expected=False)
    for n in (3, 3, 3, 5):
        fn(torch.ones(n))
    rec = reg.get("fwd")
    assert (rec.compiles, rec.calls) == (2, 2)
    assert reg.forensic_records()[0]["cause"] == \
        "arg `0` dim 0 — 3 → 5, dtype unchanged"


def test_hbm_ledger_estimates_on_the_cpu_and_warns_under_headroom():
    tr = ttel.get_tracer().enable()
    reg = programs.ProgramRegistry()
    reg.register_compile("a", None, cost=ttel.ProgramCost(
        "a", argument_bytes=100, output_bytes=50))
    reg.register_compile("b", None, cost=ttel.ProgramCost(
        "b", bytes_accessed=400))
    assert programs.device_memory_stats() is None  # no card here
    ledger = programs.HbmLedger(reg, every_s=0)
    ledger.add_resident("kv", lambda: 64)
    rec = ledger.sample()
    assert rec["source"] == "estimate" and rec["bytes_in_use"] == 400
    assert [t["program"] for t in rec["top"]] == ["b", "a"]
    assert rec["resident"] == {"kv": 64}
    low = programs.HbmLedger(reg, stats_fn=lambda: {
        "bytes_in_use": 95, "peak_bytes_in_use": 96, "bytes_limit": 100})
    with Watchdog(log=None).attach() as wd:
        assert low.sample()["source"] == "device"
    assert low.warnings == 1 and wd.counters["hbm_headroom"] == 1
    assert {s.name for s in tr.spans()} >= {"hbm", "hbm_headroom"}
    blob = ttel.chrome_trace()
    assert any(e["ph"] == "C" and e["name"] == "HBM bytes"
               for e in blob["traceEvents"])


def test_no_sample_while_a_capture_runs(monkeypatch):
    monkeypatch.setattr(graphs, "_capturing", 1)
    assert graphs.unless_capturing(lambda: 1) is None
    monkeypatch.setattr(graphs, "_capturing", 0)
    assert graphs.unless_capturing(lambda: 1) == 1


def test_kernel_routes_are_registered_and_a_flip_is_a_forensic(
        monkeypatch):
    reg = ttel.get_program_registry()
    monkeypatch.setattr(programs, "_routes_seen", set())
    x, w = torch.ones(8, 16), torch.ones(16, 8)
    fm.fused_matmul_bn(x, w)
    fm.fused_matmul_bn(x, w)
    rec = reg.get("kernel:fused_matmul_bn")
    assert rec.compiles == 1 and rec.signatures[0].static == (
        ("route", "plain"),)
    assert reg.forensic_records() == []  # a first route is no flip
    reg.clear()
    monkeypatch.setattr(programs, "_routes_seen", set())
    programs.record_route("fused_matmul_bn", "cuda")  # the card's route
    fm.fused_matmul_bn(x, w)  # then a CPU tensor: the route flips
    (f,) = reg.forensic_records()
    assert f["program"] == "kernel:fused_matmul_bn"
    assert f["cause"] == "static `route` — cuda → plain"


def _mlps():
    jm = jnn.Sequential(jnn.Linear(FEAT, 32), jnn.ReLU(),
                        jnn.Linear(32, 8))
    var = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = tnn.Sequential(tnn.Linear(FEAT, 32), tnn.ReLU(),
                        tnn.Linear(32, 8))
    return (jm, var), tm


def test_serving_learned_bucket_forensic_equals_jax():
    (jm, var), tm = _mlps()
    kw = dict(buckets=[(8, FEAT), (16, FEAT)], batch_sizes=(1, 4),
              start=False)
    x = np.random.RandomState(0).rand(1, 17, FEAT).astype(np.float32)
    causes = []
    for mod, eng in ((jtel, JaxServingEngine(jm, var, **kw)),
                     (ttel, ServingEngine(tm, device="cpu", **kw))):
        try:
            eng.predict_batch(x)
        finally:
            eng.close()
        reg = mod.get_program_registry()
        rec = reg.get("serving_forward")
        assert rec.compiles == 5 and rec.calls == 1
        (f,) = reg.forensic_records()
        causes.append(f["cause"])
    assert causes[1] == causes[0] == "arg `x` dim 1 — 16 → 17, dtype " \
        "unchanged"
    cost = ttel.get_program_registry().get("serving_forward").cost
    assert cost.name == "serving_forward:1x17x16"
    assert cost.flops == 2 * 17 * (FEAT * 32 + 32 * 8)


def test_decode_undeclared_bucket_names_the_axis_and_is_counted():
    torch.manual_seed(0)
    lm = tnn.Transformer(50, 32, 4, 64, 1, dropout=0.0).eval()
    ttel.get_tracer().enable()
    eng = DecodeEngine(lm, slots=2, max_len=32, prompt_buckets=(4, 8),
                       prefill_batch_sizes=(1, 2), device="cpu")
    try:
        reg = ttel.get_program_registry()
        assert reg.forensic_records() == []
        tick = reg.get("decode_tick")
        assert tick.cost is not None and tick.cost.flops > 0
        with Watchdog(log=None).attach() as wd:
            eng.generate(np.arange(1, 13), 3, timeout=WAIT)
        (f,) = reg.forensic_records()
        assert f["program"] == "decode_prefill"
        assert f["cause"] == "arg `ids` dim 1 — 8 → 12, dtype unchanged"
        assert wd.counters["steady_state_recompiles"] == 2  # and its write
        assert "decode_prefill: arg `ids` dim 1 — 8 → 12" in \
            wd.anomalies[0]["message"]
        assert reg.get("decode_tick").calls >= 2
        assert eng.metrics.gflops_per_sec() > 0
        assert "GF/s" in eng.log_line() and "xray: n=1" in eng.log_line()
        ledger = ttel.get_hbm_ledger()
        assert ledger.sample()["resident"]["decode_kv_cache"] == \
            eng._cache_bytes_total()
    finally:
        eng.close(timeout=WAIT)
    assert "decode_kv_cache" not in (ledger.sample().get("resident") or {})


def test_a_capture_counts_its_first_warm_up_and_blocks_samples(monkeypatch):
    """``graphs.Compiled`` with a count: the first warm-up call alone is
    counted (never the capture), and the HBM ledger's read waits out the
    capture (the CUDA calls around it faked on the CPU)."""
    import contextlib

    state = {"capturing": False, "sampled_in_capture": []}

    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(*a, **k):
        state["capturing"] = True
        try:
            yield
        finally:
            state["capturing"] = False

    monkeypatch.setattr(graphs, "prepare", lambda device: None)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    w = torch.ones(16, 8)

    def fn(x):
        if state["capturing"]:
            state["sampled_in_capture"].append(
                graphs.unless_capturing(lambda: "sampled"))
        return fm.fused_matmul_bn(x, w)[0]

    count = ttel.costmodel.Count()
    graphs.Compiled(fn, (torch.ones(4, 16),), count=count)
    assert count.flops == fm.cost_matmul(4, 16, 8, False, 4)[0]
    assert count.argument_bytes == 4 * 16 * 4
    assert count.output_bytes == 4 * 8 * 4
    assert state["sampled_in_capture"] == [None]
    assert graphs.unless_capturing(lambda: "sampled") == "sampled"


def test_bucket_program_check_logs_each_declared_bucket():
    from bigdl_tpu_torch.serving import BucketGrid
    from bigdl_tpu_torch.serving.warmup import (bucket_program_check,
                                                bucket_struct)

    _, tm = _mlps()
    grid = BucketGrid([(8, FEAT), (16, FEAT)], batch_sizes=(1, 4))
    lines = []
    assert bucket_program_check(tm, grid, log=lines.append,
                                device="cpu") == 0
    assert lines == [f"bucket {b.batch}x{b.dims[0]}x{FEAT}: OK"
                     for b in grid.declared_buckets()]
    assert len(lines) == 4
    bad = BucketGrid([(8, FEAT), (8, FEAT + 1)], batch_sizes=(2,))
    lines = []
    assert bucket_program_check(tm, bad, log=lines.append,
                                device="cpu") == 1
    assert [ln.split(":")[1].split()[0] for ln in lines] == ["OK", "FAIL"]
    s = bucket_struct(grid.declared_buckets()[0], torch.bfloat16)
    assert s.device.type == "meta" and s.dtype == torch.bfloat16
    assert tuple(s.shape) == (1, 8, FEAT)
