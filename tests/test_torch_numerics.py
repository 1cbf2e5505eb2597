"""The port's numerics observatory (bigdl_tpu_torch.telemetry.numerics)
against the JAX package's on the CPU: ``collect`` on an MLP and on the
fused CIFAR ResNet-20 tree (norms within 1e-6 relative in f32,
histograms and non-finite counts equal), the train step's fifth output,
the monitor's anomaly instants on one stats stream, NaN provenance's
layer and site, the loop's drain and summaries, stats that leave the
training bit-equal, and a seeded divergence: the early warning before
the loss drain, the provenance, the recovery record and a seven-file
flight bundle, bit for bit again on a second run."""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu import telemetry as jtel
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.dataset import Transformer as JTransformer
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.telemetry import numerics as jnum
from bigdl_tpu.telemetry import tracer as jtr
from bigdl_tpu.telemetry.export import chrome_trace as jchrome_trace
from bigdl_tpu.telemetry.watchdog import Watchdog as JWatchdog
from bigdl_tpu_torch import telemetry as ttel
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.minibatch import MiniBatch
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.optim import (SGD, CompiledTrainStep, LocalOptimizer,
                                   Trigger, make_train_step)
from bigdl_tpu_torch.telemetry import flightrecorder
from bigdl_tpu_torch.telemetry import numerics as tnum
from bigdl_tpu_torch.telemetry import tracer as ttr
from bigdl_tpu_torch.telemetry.export import chrome_trace
from bigdl_tpu_torch.telemetry.watchdog import Watchdog
from bigdl_tpu_torch.utils import (export_variables, flatten,
                                   load_jax_variables, random_variables)
from bigdl_tpu_torch.visualization import TrainSummary

RTOL = 1e-6
BUNDLE = {"trace.json", "metrics.jsonl", "xray.json", "watchdog.json",
          "numerics.json", "threads.txt", "manifest.json"}


@pytest.fixture(autouse=True)
def clean_tracer():
    """Both packages' tracers off and empty, no ambient correlation, no
    global flight recorder."""
    def reset():
        for tr, mod in ((ttel.get_tracer(), ttr), (jtel.get_tracer(), jtr)):
            tr.disable()
            tr.clear()
            mod.set_correlation(None)
        flightrecorder.set_global(None)

    reset()
    yield ttel.get_tracer()
    reset()


def _toy(n=64, dim=10, classes=4, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, dim).astype(np.float32)
    w = rs.randn(dim, classes).astype(np.float32)
    return x, (x @ w).argmax(-1).astype(np.int64)


def _mlps(seed=0):
    """The same MLP in both packages, with the same weights."""
    jm = jnn.Sequential(jnn.Linear(10, 16), jnn.ReLU(), jnn.Linear(16, 4))
    var = jm.init(jax.random.PRNGKey(seed))
    tm = tnn.Sequential(tnn.Linear(10, 16), tnn.ReLU(), tnn.Linear(16, 4))
    load_jax_variables(tm, var)
    return jm, tm, var


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            flatten(tree).items()}


def _same_spec(t, j):
    return (t.layers, t.hist) == (j.layers, j.hist)


def _assert_stats_equal(ts, js):
    """The port's stats tree against JAX's: norms within RTOL, counts and
    histograms equal."""
    assert list(ts["layers"]) == list(js["layers"])
    for name, jl in js["layers"].items():
        tl = ts["layers"][name]
        for k in ("g", "p", "u"):
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=RTOL,
                                       err_msg=f"{name}.{k}")
        assert int(tl["nf"]) == int(jl["nf"])
        assert tl["nf"].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(tl["hist"]),
                                      np.asarray(jl["hist"]))
    for k in ("grad_norm", "param_norm", "update_norm"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=RTOL,
                                   err_msg=k)
    assert int(ts["nonfinite"]) == int(js["nonfinite"])


# ------------------------------------------------------------- collect
@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_collect_on_an_mlp_equals_jax(poison):
    jm, tm, var = _mlps()
    spec = tnum.spec_for(tm)
    assert _same_spec(spec, jnum.spec_for(jm))
    assert spec.layers == ("0", "1", "2")
    rs = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(
        lambda p: rs.randn(*p.shape).astype(np.float32), var["params"])
    if poison:
        grads["2"]["weight"][3, 1] = float(poison)
        grads["2"]["weight"][0, 0] = float(poison)
    new = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, var["params"],
                                 grads)
    js = jax.jit(lambda p, g, n: jnum.collect(p, g, n, spec))(
        var["params"], grads, new)
    ts = tnum.collect(_torch(var["params"]), _torch(grads), _torch(new),
                      spec)
    _assert_stats_equal(ts, js)
    assert set(ts["layers"]) == {"0", "2"}  # the ReLU holds nothing
    assert int(ts["nonfinite"]) == (2 if poison else 0)


def test_collect_on_the_fused_cifar_resnet_equals_jax():
    """The width-reduced fused ResNet (CIFAR-20, fused basic blocks,
    widths 16-64): its Graph's child keys order the layers, dotted names
    group them and order their leaves as JAX's tree does."""
    tm = ResNet(10, 20, "cifar10", fused=True, device="cpu")
    spec = tnum.spec_for(tm)
    assert _same_spec(spec,
                      jnum.spec_for(JResNet(10, 20, "cifar10", fused=True)))
    params = random_variables(export_variables(tm), 0)["params"]
    rs = np.random.RandomState(2)
    grads = jax.tree_util.tree_map(
        lambda p: (1e-2 * rs.randn(*p.shape)).astype(np.float32), params)
    leaves = jax.tree_util.tree_leaves(grads)
    leaves[len(leaves) // 2].reshape(-1)[7] = np.nan
    new = jax.tree_util.tree_map(lambda p, g: p - 0.05 * g, params, grads)
    js = jnum.collect(params, grads, new, spec)
    ts = tnum.collect(_torch(params), _torch(grads), _torch(new), spec)
    _assert_stats_equal(ts, js)
    assert int(ts["nonfinite"]) == 1
    first = tnum.NumericsMonitor(spec, log=None).first_nonfinite_layer(ts)
    assert first == jnum.NumericsMonitor(
        spec, log=None).first_nonfinite_layer(js)


def test_subsample_tree_equals_jax():
    tree = {"a": np.arange(10000, dtype=np.float32),
            "b": {"c": np.ones((64, 64), np.float32), "a": -np.ones(7)}}
    for budget in (256, 1024):
        got = tnum.subsample_tree(_torch(tree), budget)
        assert got.shape[0] <= budget
        np.testing.assert_array_equal(
            got, np.asarray(jnum.subsample_tree(tree, budget)))


def test_train_step_fifth_output_equals_jax_collect():
    """``make_train_step(..., numerics=spec)``: the stats of the step's
    own parameters, clipped gradients and new parameters, as JAX's
    ``collect`` gives them; without a spec, four outputs."""
    jm, tm, var = _mlps()
    spec = tnum.spec_for(tm)
    seen = {}

    class Recording(SGD):
        def update(self, grads, state, params, lr, step):
            seen.update({k: g.detach().clone() for k, g in grads.items()})
            return super().update(grads, state, params, lr, step)

    x, y = _toy()
    crit = tnn.ClassNLLCriterion(logits=True)
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    state = {k: b.detach().clone() for k, b in tm.named_buffers()}
    method = Recording(0.1, momentum=0.9)
    opt_states = {"__all__": method.init_state(params)}
    step = make_train_step(tm, crit, {"__all__": method}, grad_clip_norm=0.5,
                           numerics=spec)
    out = step(params, state, opt_states, 1, None,
               torch.from_numpy(x[:16]), torch.from_numpy(y[:16]), [0.1])
    assert len(out) == 5
    new, stats = out[0], out[4]
    nest = lambda d: export_variables(tm, d, state)["params"]  # noqa: E731
    js = jnum.collect(nest(params), nest(seen), nest(new), spec)
    _assert_stats_equal(stats, js)
    plain = make_train_step(tm, crit, {"__all__": SGD(0.1)})
    assert len(plain(params, state, {"__all__": {}}, 1, None,
                     torch.from_numpy(x[:16]), torch.from_numpy(y[:16]),
                     [0.1])) == 4
    # compiled (eagerly on the CPU): the trees given back, then the stats
    compiled = CompiledTrainStep(step)
    trees = ({k: v.clone() for k, v in params.items()}, state,
             {"__all__": method.init_state(params)})
    *trees2, loss, stats2 = compiled(*trees, 1, None,
                                     torch.from_numpy(x[:16]),
                                     torch.from_numpy(y[:16]), [0.1])
    assert trees2[0] is trees[0] and math.isfinite(float(loss))
    np.testing.assert_allclose(float(stats2["grad_norm"]),
                               float(js["grad_norm"]), rtol=RTOL)


# ------------------------------------------------------------- monitor
def _stats(g=1.0, p=1.0, u=0.01, nf=0, layers=None):
    return {"grad_norm": g, "param_norm": p, "update_norm": u,
            "nonfinite": nf, "layers": layers or {}}


def test_monitor_fires_the_instants_jax_fires(clean_tracer):
    """One stats stream through both monitors: the same anomaly kinds,
    watchdog counters, sample and anomaly instants (name, corr, args)."""
    stream = [_stats() for _ in range(4)] + [
        _stats(g=50.0), _stats(g=1e-12), _stats(u=0.9),
        _stats(nf=2, layers={"0": {"nf": 0}, "1": {"nf": 2}}),
        _stats(g=float("inf"))]
    results = []
    for mod, tr, wd_cls in ((tnum, clean_tracer, Watchdog),
                            (jnum, jtel.get_tracer(), JWatchdog)):
        tr.enable()
        wd = wd_cls(log=None).attach(tr)
        mon = mod.NumericsMonitor(
            mod.NumericsSpec(layers=("0", "1", "2")), spike_factor=10.0,
            vanish_floor=1e-8, ratio_band=(1e-10, 0.5), warmup=4, log=None)
        fired = [mon.observe(i + 1, s) for i, s in enumerate(stream)]
        wd.close()
        instants = [(s.name, s.corr, s.args) for s in tr.spans()
                    if s.name in (mod.NUMERICS_SAMPLE, mod.NUMERICS_EVENT)]
        results.append((fired, dict(wd.counters), instants, mon.last,
                        mon.anomaly_count))
    assert results[0] == results[1]
    fired = results[0][0]
    assert fired[4:] == [["grad_spike"], ["grad_vanish"], ["update_ratio"],
                         ["nonfinite"], ["nonfinite"]]


def test_monitor_env_knobs(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_NUMERICS_SPIKE", "3.5")
    monkeypatch.setenv("BIGDL_TPU_NUMERICS_VANISH", "1e-4")
    monkeypatch.setenv("BIGDL_TPU_NUMERICS_BAND", "1e-6:0.25")
    mon = tnum.NumericsMonitor(log=None)
    assert (mon._spike, mon._vanish, mon._band) == (3.5, 1e-4, (1e-6, 0.25))
    monkeypatch.setenv("BIGDL_TPU_NUMERICS_BAND", "junk")
    assert tnum.NumericsMonitor(log=None)._band == (1e-10, 0.5)
    monkeypatch.setenv("BIGDL_TPU_NUMERICS", "1")
    assert tnum.enabled()
    monkeypatch.delenv("BIGDL_TPU_NUMERICS")
    assert not tnum.enabled()
    monkeypatch.setenv("BIGDL_TPU_NUMERICS_HIST", "8")
    assert tnum.spec_for(_mlps()[1]).hist == tnum.MIN_LAYER_HIST


# ---------------------------------------------------------- the loop
def _loop(on, summary=None):
    torch.manual_seed(0)
    tm = _mlps()[1]
    x, y = _toy()
    opt = LocalOptimizer(tm, DataSet.from_arrays(x, y, 16),
                         tnn.ClassNLLCriterion(logits=True),
                         Trigger.max_epoch(3), device="cpu")
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    if on is not None:
        opt.set_numerics(on)
    if summary is not None:
        opt.set_train_summary(summary)
    opt.optimize()
    return opt


@pytest.mark.parametrize("sync", [False, True])
def test_stats_leave_training_bit_equal_and_drain_each_step(sync,
                                                            monkeypatch):
    if sync:
        monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP", "1")
    on, off = _loop(True), _loop(False)
    for k, v in off.final_params.items():
        assert torch.equal(on.final_params[k], v), k
    mon = on._numerics_monitor
    assert mon.last["iteration"] == 12  # every step observed
    assert on.metrics.value("grad_norm") == pytest.approx(
        mon.last["grad_norm"], rel=1e-4)
    assert off._numerics_monitor is None and off._numerics is None
    if not sync:
        assert on.metrics.count("numerics") == 12
    assert on._recent_batches.maxlen == on.sync_window + 2


def test_env_knob_turns_the_loop_stats_on(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_NUMERICS", "1")
    opt = _loop(None)
    assert opt._numerics == tnum.spec_for(opt.model)
    assert opt._numerics_monitor.last["iteration"] == 12


def test_train_summary_gets_norms_and_per_layer_histograms(tmp_path):
    ts = TrainSummary(str(tmp_path), "app")
    ts.set_summary_trigger("Parameters", 4)
    opt = _loop(True, summary=ts)
    ts.close()
    gn = ts.read_scalar("GradNorm")
    assert gn and gn[-1] == (12, pytest.approx(
        opt._numerics_monitor.last["grad_norm"]))
    assert [s for s, _ in ts.read_scalar("GradNorm/0")] == [4, 8, 12]
    assert ts.read_scalar("UpdateRatio")
    # without stats: the one subsample histogram
    ts2 = TrainSummary(str(tmp_path / "b"), "app")
    ts2.set_summary_trigger("Parameters", 2)
    ts2.maybe_add_parameters({"w": torch.ones(512, 512)}, 2)
    ts2.close()
    assert os.listdir(ts2.log_dir)


def test_chrome_trace_grad_norm_lane_equals_jax(clean_tracer):
    lanes = []
    for mod, tr, exp in ((tnum, clean_tracer, chrome_trace),
                         (jnum, jtel.get_tracer(), jchrome_trace)):
        tr.enable()
        mod.NumericsMonitor(log=None).observe(3, _stats(g=2.5, u=0.02))
        lanes.append([{k: e[k] for k in ("name", "ph", "args", "cat")}
                      for e in exp(tr)["traceEvents"]
                      if e.get("ph") == "C"])
    assert lanes[0] == lanes[1] and lanes[0][0]["name"] == "grad norm"
    assert lanes[0][0]["args"] == {"grad_norm": 2.5, "update_ratio": 0.02}


# ------------------------------------------------------- provenance
class Trap(tnn.Module):
    """Pass-through that goes NaN where |x| > limit: an overflow site
    with a known name."""

    def __init__(self, limit=1e6):
        super().__init__()
        self.limit = limit

    def forward(self, x):
        return torch.where(x.abs() > self.limit,
                           torch.full_like(x, float("nan")), x)


class JTrap(jnn.Module):
    def __init__(self, limit=1e6):
        super().__init__()
        self.limit = limit

    def apply(self, params, state, *inputs, training=False, rng=None):
        x = inputs[0]
        return jnp.where(jnp.abs(x) > self.limit, jnp.float32(np.nan),
                         x), state


@jax.custom_vjp
def _nan_grad(x):
    return x


_nan_grad.defvjp(lambda x: (x, None), lambda _, g: (g * jnp.nan,))


class JNanGrad(jnn.Module):
    """Identity whose gradient is NaN: a backward-only origin."""

    def apply(self, params, state, *inputs, training=False, rng=None):
        return _nan_grad(inputs[0]), state


class _NanGradFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


class NanGrad(tnn.Module):
    def forward(self, x):
        return _NanGradFn.apply(x)


def _trap_models(middle="trap"):
    jmid, tmid = (JTrap(), Trap()) if middle == "trap" else \
        (JNanGrad(), NanGrad())
    jm = jnn.Sequential(jnn.Linear(10, 16), jmid, jnn.ReLU(),
                        jnn.Linear(16, 4))
    var = jm.init(jax.random.PRNGKey(0))
    tm = tnn.Sequential(tnn.Linear(10, 16), tmid, tnn.ReLU(),
                        tnn.Linear(16, 4))
    load_jax_variables(tm, var)
    return jm, tm, var


@pytest.mark.parametrize("case", ["input", "forward", "healthy",
                                  "backward"])
def test_nan_provenance_names_jax_layer_and_site(case):
    jm, tm, var = _trap_models("nan_grad" if case == "backward" else "trap")
    y = np.array([0, 1], np.int64)
    x = {"input": np.full((2, 10), np.nan, np.float32),
         "forward": np.full((2, 10), 1e8, np.float32)}.get(
             case, np.ones((2, 10), np.float32))
    with_crit = case != "input"
    jrep = jnum.nan_provenance(
        jm, var["params"], var["state"], x, y,
        criterion=jnn.ClassNLLCriterion(logits=True) if with_crit else None)
    trep = tnum.nan_provenance(
        tm, _torch(var["params"]), {}, x, torch.from_numpy(y),
        criterion=tnn.ClassNLLCriterion(logits=True) if with_crit else None)
    assert (trep["layer"], trep["site"]) == (jrep["layer"], jrep["site"])
    assert trep["input_nonfinite"] == jrep["input_nonfinite"]
    for k, v in jrep["layers"].items():
        assert trep["layers"][k] == v, k
    if case == "healthy":
        assert trep["site"] is None and math.isfinite(trep["loss"])
        np.testing.assert_allclose(trep["loss"], jrep["loss"], rtol=1e-5)
    expected = {"input": ("input", None), "forward": ("forward", "1"),
                "healthy": (None, None), "backward": ("backward", "0")}
    assert (trep["site"], trep["layer"]) == expected[case]


# ------------------------------------------------ seeded divergence
class SentinelOnce:
    """The ``at``-th batch the loop pulls gets a large finite feature
    value: the data is clean, the NaN is born at the Trap."""

    def __init__(self, base, at, value=1e8):
        self.base, self.at, self.value, self.count = base, at, value, 0

    def batches_per_epoch(self):
        return self.base.batches_per_epoch()

    def data(self, train):
        for b in self.base.data(train):
            if train:
                self.count += 1
                if self.count == self.at:
                    b = MiniBatch(np.full_like(b.get_input(), self.value),
                                  b.get_target())
            yield b


class JSentinelOnce(JTransformer):
    def __init__(self, at, value=1e8):
        self.at, self.value, self.count = at, value, 0

    def __call__(self, it):
        for b in it:
            self.count += 1
            if self.count == self.at:
                b = JMiniBatch(np.full_like(b.get_input(), self.value),
                               b.get_target())
            yield b


def _port_trap_run(tmp_path, tag, var):
    tm = tnn.Sequential(tnn.Linear(10, 16), Trap(), tnn.ReLU(),
                        tnn.Linear(16, 4))
    load_jax_variables(tm, var)
    x, y = _toy()
    opt = LocalOptimizer(tm, SentinelOnce(DataSet.from_arrays(x, y, 16), 6),
                         tnn.ClassNLLCriterion(logits=True),
                         Trigger.max_epoch(6), device="cpu")
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_checkpoint(str(tmp_path / f"ck-{tag}"), Trigger.every_epoch())
    opt.set_numerics(True)
    opt.optimize()
    return opt


def test_seeded_divergence_warns_names_the_layer_and_recovers(
        clean_tracer, tmp_path, monkeypatch):
    from bigdl_tpu.telemetry import flightrecorder as jflight

    monkeypatch.setenv("BIGDL_TPU_FLIGHT", "1")
    monkeypatch.setenv("BIGDL_TPU_FLIGHT_MIN_INTERVAL_S", "0")
    jm, _, var = _trap_models()
    var = jax.tree_util.tree_map(np.array, var)  # JAX's loop donates
    runs = {}
    for pkg in ("port", "jax"):
        monkeypatch.setenv("BIGDL_TPU_FLIGHT_DIR", str(tmp_path / pkg))
        tr = clean_tracer if pkg == "port" else jtel.get_tracer()
        tr.enable(capacity=65536)
        if pkg == "port":
            wd = Watchdog(log=None).attach(tr)
            fr = flightrecorder.get_flight_recorder()
            fr.set_watchdog(wd)
            opt = _port_trap_run(tmp_path, "a", var)
        else:
            wd = JWatchdog(log=None).attach(tr)
            x, y = _toy()
            ds = JDataSet.from_arrays(x, y, batch_size=16).transform(
                JSentinelOnce(6))
            opt = JLocalOptimizer(jm, ds, jnn.ClassNLLCriterion(logits=True),
                                  joptim.Trigger.max_epoch(6))
            opt.set_initial_variables(var)
            opt.set_optim_method(joptim.SGD(0.1, momentum=0.9))
            opt.set_checkpoint(str(tmp_path / "ck-jax"),
                               joptim.Trigger.every_epoch())
            opt.set_numerics(True)
            try:
                opt.optimize()
            finally:
                jflight.set_global(None)
        wd.close()
        spans = tr.spans()
        tr.disable()
        names = [s.name for s in spans]
        (prov,) = [s.args for s in spans if s.name == "nan_provenance"]
        (rec,) = [(s.corr, {k: v for k, v in s.args.items()
                            if k != "checkpoint_dir"})
                  for s in spans if s.name == "divergence_recovery"]
        anomaly = next(s.args for s in spans
                       if s.name == "numerics_anomaly")
        runs[pkg] = {"opt": opt, "wd": dict(wd.counters), "prov": prov,
                     "rec": rec, "kind": anomaly["kind"],
                     "layer": anomaly["layer"],
                     "early": names.index("numerics_anomaly")
                     < names.index("loss_divergence")}
    port, jx = runs["port"], runs["jax"]
    assert port["early"] and jx["early"]
    assert port["kind"] == jx["kind"] == "nonfinite"
    assert port["layer"] == jx["layer"]
    assert port["prov"]["layer"] == jx["prov"]["layer"] == "1"
    assert port["prov"]["site"] == jx["prov"]["site"] == "forward"
    assert port["prov"]["iteration"] == 6
    assert port["prov"]["input_nonfinite"] == 0
    assert port["rec"] == jx["rec"]
    assert port["rec"][0] == "step:6"
    assert port["rec"][1]["restored_iteration"] == 4
    assert port["opt"]._retries == 1
    assert port["wd"]["nonfinite_grads"] >= 1
    assert port["wd"]["nan_windows"] >= 1
    # the black box: JAX's seven files, the divergence as the trigger
    fr = flightrecorder.get_flight_recorder(create=False)
    mans = {b: json.load(open(os.path.join(b, "manifest.json")))
            for b in fr.bundles()}
    assert {m["trigger"] for m in mans.values()} >= {"numerics_anomaly",
                                                     "loss_divergence"}
    bundle = next(b for b, m in mans.items()
                  if m["trigger"] == "loss_divergence")
    assert set(os.listdir(bundle)) == BUNDLE
    assert set(mans[bundle]["files"]) == BUNDLE - {"manifest.json"}
    blob = json.load(open(os.path.join(bundle, "numerics.json")))
    assert "grad_norm" in blob["last"]
    flightrecorder.set_global(None)
    # the whole poisoned run again: bit for bit
    again = _port_trap_run(tmp_path, "b", var)
    for k, v in port["opt"].final_params.items():
        assert torch.isfinite(v).all()
        assert torch.equal(again.final_params[k], v), k
