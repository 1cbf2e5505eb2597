"""The port's serving engine (bigdl_tpu_torch.serving) on the CPU.

BucketGrid behaviour is the JAX package's (copied from
tests/test_serving.py); the engine is held to a direct forward of the
same model under concurrent clients, and to the JAX engine's admission
control (queue full, deadlines, per-request errors, draining close).
"""
import threading

import numpy as np
import pytest
import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models import ResNet50
from bigdl_tpu_torch.serving import (BucketGrid, DeadlineExceededError,
                                     EngineClosedError, QueueFullError,
                                     ServingEngine)
from bigdl_tpu_torch.utils import export_variables, random_variables

FEAT = 16


def _seq_model(feat=FEAT, hidden=32, classes=8):
    """Per-timestep MLP over (t, feat): padding along batch and sequence
    axes is exact after cropping."""
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(feat, hidden), nn.ReLU(),
                         nn.Linear(hidden, classes)).eval()


@pytest.fixture(scope="module")
def model():
    return _seq_model()


def _direct(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x[None])).numpy()[0]


def _engine(model, **kw):
    kw.setdefault("buckets", [(8, FEAT), (16, FEAT), (32, FEAT)])
    kw.setdefault("batch_sizes", (1, 8, 32))
    kw.setdefault("device", "cpu")
    return ServingEngine(model, **kw)


# ---------------------------------------------------------------- grid
def test_bucket_grid_choices_and_padding():
    grid = BucketGrid([(8, 4), (16, 4)], batch_sizes=(1, 4, 8))
    assert grid.choose_dims((5, 4)) == ((8, 4), True)
    assert grid.choose_dims((16, 4)) == ((16, 4), True)
    assert grid.choose_dims((17, 4)) == ((17, 4), False)  # learned
    assert grid.choose_dims((4,)) == ((4,), False)        # rank miss
    assert grid.choose_batch(1) == 1
    assert grid.choose_batch(5) == 8
    assert grid.choose_batch(99) == 8
    assert len(grid.declared_buckets()) == 6
    s = np.arange(12, dtype=np.float32).reshape(3, 4)
    xp = grid.pad_batch([s], (8, 4), 4, np.float32)
    assert xp.shape == (4, 8, 4)
    np.testing.assert_array_equal(xp[0, :3], s)
    assert xp[0, 3:].sum() == 0 and xp[1:].sum() == 0
    assert grid.unpad(np.ones((8, 7), np.float32), (3, 4), (8, 4)).shape \
        == (3, 7)
    assert grid.unpad(np.ones((5,), np.float32), (3, 4), (8, 4)).shape \
        == (5,)


def test_bucket_grid_edge_cases():
    grid = BucketGrid([(8,), (16,)], batch_sizes=(1, 4), pad_value=0)
    assert grid.choose_dims((5,)) == ((8,), True)
    assert grid.choose_dims((17,)) == ((17,), False)
    assert grid.choose_dims((0,)) == ((8,), True)
    ids = grid.pad_batch([np.asarray([3, 1, 2], np.int32)], (8,), 1,
                         np.int32)
    np.testing.assert_array_equal(ids[0], [3, 1, 2, 0, 0, 0, 0, 0])
    assert grid.unpad(np.ones((8, 5), np.float32), (0, 5),
                      (8, 5)).shape == (0, 5)


# ------------------------------------------------------------- engine
def test_concurrent_clients_match_direct(model):
    engine = _engine(model)
    assert engine.metrics.first_sights == len(engine.declared_buckets)
    rs = np.random.RandomState(0)
    xs = [rs.rand(t, FEAT).astype(np.float32)
          for t in rs.randint(3, 33, size=48)]
    results = [None] * len(xs)

    def client(lo, hi):
        futs = [(i, engine.submit(xs[i])) for i in range(lo, hi)]
        for i, f in futs:
            results[i] = f.result(30)

    ts = [threading.Thread(target=client, args=(i * 12, (i + 1) * 12))
          for i in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    for x, y in zip(xs, results):
        np.testing.assert_allclose(y, _direct(model, x), rtol=1e-5,
                                   atol=1e-6)
    assert engine.metrics.completed == len(xs)
    # steady state: every shape was covered by a declared bucket
    assert engine.metrics.first_sights == len(engine.declared_buckets)
    assert "ok=48" in engine.log_line()
    engine.close()


def test_predict_batch_chunks_and_learned_bucket(model):
    engine = _engine(model)
    x = np.random.RandomState(1).rand(70, 13, FEAT).astype(np.float32)
    with torch.inference_mode():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(engine.predict_batch(x), want, rtol=1e-5,
                               atol=1e-6)
    declared = len(engine.declared_buckets)
    y = engine.predict(np.ones((40, FEAT), np.float32), timeout=30)
    assert y.shape == (40, 8)
    assert engine.metrics.first_sights == declared + 1  # visible, once
    engine.predict(np.ones((40, FEAT), np.float32), timeout=30)
    assert engine.metrics.first_sights == declared + 1
    assert engine.warmup() == 0
    engine.close()


def test_deadline_expiry_is_delivered(model):
    engine = _engine(model)
    fut = engine.submit(np.zeros((8, FEAT), np.float32), deadline_ms=0.0)
    with pytest.raises(DeadlineExceededError):
        fut.result(10)
    assert engine.metrics.expired >= 1
    assert engine.predict(np.ones((8, FEAT), np.float32),
                          timeout=30).shape == (8, 8)
    engine.close()


def test_queue_full_fast_rejection(model):
    engine = _engine(model, max_queue=2, start=False, warmup=False)
    x = np.zeros((8, FEAT), np.float32)
    f1, f2 = engine.submit(x), engine.submit(x)
    with pytest.raises(QueueFullError):
        engine.submit(x)
    assert engine.metrics.rejected == 1
    engine.start()
    assert f1.result(30).shape == (8, 8)
    assert f2.result(30).shape == (8, 8)
    engine.close()


def test_exception_delivered_per_request_and_engine_survives(model):
    engine = _engine(model)
    bad = engine.submit(np.zeros((4, FEAT + 3), np.float32))
    good = engine.submit(np.ones((4, FEAT), np.float32))
    exc = bad.exception(30)
    assert exc is not None and not isinstance(exc, DeadlineExceededError)
    assert good.result(30).shape == (4, 8)
    engine.close()


def test_close_drains_then_refuses(model):
    engine = _engine(model)
    rs = np.random.RandomState(3)
    xs = [rs.rand(9, FEAT).astype(np.float32) for _ in range(40)]
    futs = [engine.submit(x) for x in xs]
    engine.close()
    for x, f in zip(xs, futs):
        np.testing.assert_allclose(f.result(1), _direct(model, x),
                                   rtol=1e-5, atol=1e-6)
    assert not engine._dispatcher.is_alive()
    assert not engine._drainer.is_alive()
    with pytest.raises(EngineClosedError):
        engine.submit(xs[0])
    engine.close()  # idempotent


def test_close_discard_and_context_manager(model):
    engine = _engine(model, start=False, warmup=False)
    futs = [engine.submit(np.zeros((8, FEAT), np.float32)) for _ in range(3)]
    engine.start()
    engine.close(drain=False)
    assert all(f.done() for f in futs)
    with _engine(model, warmup=False) as engine:
        assert engine.predict(np.ones((5, FEAT), np.float32),
                              timeout=30).shape == (5, 8)
    assert not engine._dispatcher.is_alive()


def test_fused_resnet50_served_in_bf16_equals_direct_forward():
    """The slice end to end on the CPU: JAX-shaped random weights carried
    in by the engine, bf16 compute, answers equal to a direct forward."""
    model = ResNet50(10, stem="space_to_depth", fused=True, device="cpu")
    variables = random_variables(export_variables(model), 0)
    engine = ServingEngine(model, variables, buckets=[(32, 32, 3)],
                           batch_sizes=(1, 4), input_dtype=torch.bfloat16,
                           device="cpu")
    xs = np.random.RandomState(2).randn(6, 32, 32, 3).astype(np.float32)
    futs = [engine.submit(x) for x in xs]
    got = np.stack([f.result(60) for f in futs])
    engine.close()
    with torch.inference_mode():
        want = model(torch.from_numpy(xs).to(torch.bfloat16)).float()
    assert got.shape == (6, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-2, atol=1e-2)


def test_shared_metrics_and_periodic_log_line(model, caplog):
    import logging
    import time

    from bigdl_tpu_torch.serving import ServingMetrics

    metrics = ServingMetrics()
    with caplog.at_level(logging.INFO, logger="bigdl_tpu_torch.serving"):
        with _engine(model, metrics=metrics,
                     metrics_log_every_s=0.02) as engine:
            engine.predict(np.ones((5, FEAT), np.float32), timeout=30)
            deadline = time.time() + 10
            while "ok=1" not in caplog.text and time.time() < deadline:
                time.sleep(0.02)
    assert engine.metrics is metrics and metrics.completed == 1
    assert "serving: ok=1" in caplog.text
    assert not engine._logger.is_alive()


def test_engine_defaults_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, buckets=[(8, FEAT)])
