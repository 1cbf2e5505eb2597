"""The port's profiling tools (bigdl_tpu_torch.utils.profiling) against
the JAX package's on the CPU: ``get_times`` rows of a ``Sequential``
(paths, types, forward and backward) and their grouping by type as
JAX's, the per-node walk of a ``Graph`` (the fused CIFAR ResNet-20),
parameters swapped in, and ``trace``: the profiler's Chrome trace with
an annotated region, and the tracer's spans of the block in
``host_trace.json``."""
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu import telemetry as jtel
from bigdl_tpu.utils import profiling as jprof
from bigdl_tpu_torch import telemetry as ttel
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.telemetry import tracer as ttr
from bigdl_tpu_torch.utils import load_jax_variables, profiling


@pytest.fixture(autouse=True)
def clean_tracer():
    def reset():
        for tr, mod in ((ttel.get_tracer(), ttr),
                        (jtel.get_tracer(), jtel.tracer)):
            tr.disable()
            tr.clear()
            mod.set_correlation(None)

    reset()
    yield ttel.get_tracer()
    reset()


def _models():
    jm = jnn.Sequential(jnn.Linear(6, 6), jnn.ReLU(), jnn.Linear(6, 6),
                        jnn.ReLU(), jnn.Linear(6, 3))
    var = jm.init(jax.random.PRNGKey(0))
    tm = tnn.Sequential(tnn.Linear(6, 6), tnn.ReLU(), tnn.Linear(6, 6),
                        tnn.ReLU(), tnn.Linear(6, 3))
    load_jax_variables(tm, var)
    return jm, tm, var


def test_get_times_rows_and_grouping_as_jax():
    jm, tm, var = _models()
    x = np.ones((2, 6), np.float32)
    jrows = jprof.get_times(jm, var["params"], var["state"], x)
    tm.train()
    rows = profiling.get_times(tm, None, None, torch.from_numpy(x))
    assert tm.training  # the mode is put back
    assert [r[:2] for r in rows] == [r[:2] for r in jrows]
    assert [r[0] for r in rows] == ["Sequential/Linear", "Sequential/ReLU",
                                    "Sequential/Linear", "Sequential/ReLU",
                                    "Sequential/Linear"]
    assert all(f > 0 for _, _, f, _ in rows)
    assert all((b > 0) == (t == "Linear") for _, t, _, b in rows)
    by_type = profiling.get_times_by_type(tm, None, None,
                                          torch.from_numpy(x))
    jby = jprof.get_times_by_type(jm, var["params"], var["state"], x)
    assert {k: v["count"] for k, v in by_type.items()} == {
        k: v["count"] for k, v in jby.items()} == {"Linear": 3, "ReLU": 2}
    for r in by_type.values():
        assert r["fwd_mean_s"] == pytest.approx(r["fwd_total_s"] / r["count"])
    grouped = profiling.get_times_grouped(tm, None, None,
                                          torch.from_numpy(x))
    assert set(grouped) == set(by_type) and grouped["Linear"][2] == 3
    table = profiling.format_times_by_type(by_type)
    assert table.splitlines()[0] == jprof.format_times_by_type(
        jby).splitlines()[0]
    assert "fwd ms" in profiling.format_times(rows)


def test_get_times_with_parameters_swapped_in():
    _, tm, _ = _models()
    params = {k: torch.zeros_like(p) for k, p in tm.named_parameters()}
    x = torch.ones(2, 6)
    rows = profiling.get_times(tm, params, {}, x)
    assert len(rows) == 5
    # the module's own weights are untouched
    assert all(p.abs().sum() > 0 for n, p in tm.named_parameters()
               if n.endswith("weight"))


def test_get_times_walks_a_graph_node_by_node():
    model = ResNet(10, 20, "cifar10", fused=True, device="cpu")
    x = torch.rand(2, 32, 32, 3)
    rows = profiling.get_times(model, x=x, backward=False)
    types = [t for _, t, _, _ in rows]
    assert types.count("FusedBasicBlock") == 9
    assert len(rows) == len(model.child_keys)
    assert all(p.startswith(f"{model.name}/") for p, _, _, _ in rows)
    assert types[-1] == "Linear"


def test_trace_writes_the_profile_and_the_host_spans(clean_tracer,
                                                     tmp_path):
    logdir = str(tmp_path / "prof")
    _, tm, _ = _models()
    with profiling.trace(logdir):
        with profiling.annotate("my_region"):
            m = Metrics()
            with m.time("compute"):
                tm(torch.ones(4, 6))
    assert not clean_tracer.enabled  # state restored
    (dev,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(dev))["traceEvents"]}
    assert "my_region" in names
    host = json.load(open(os.path.join(logdir, "host_trace.json")))
    assert any(e.get("name") == "compute" for e in host["traceEvents"])
    # host overlay only, as the JAX package's xplane=False
    with profiling.trace(str(tmp_path / "host"), xplane=False):
        with Metrics().time("compute"):
            pass
    assert os.listdir(tmp_path / "host") == ["host_trace.json"]
