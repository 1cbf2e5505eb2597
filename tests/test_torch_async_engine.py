"""The port's async training loop (bigdl_tpu_torch/optim/optimizer.py)
against its synchronous loop and the JAX package's async engine
(bigdl_tpu/optim/optimizer.py:420-512, 616-629, 735-790, 1032-1096), on
the CPU in f32, after the JAX package's tests/test_async_engine.py:

- the async and sync loops train bit-identically (same batches, seeds
  and rates), and the port's async run agrees with JAX's within 1e-6;
- a NaN batch is read at most one window late and retried from the
  background-written checkpoint, and the run ends finite;
- a background checkpoint loads in JAX's ``load_pytree`` and resumes in
  both packages, and the port resumes from JAX's;
- ``BIGDL_TPU_SYNC_WINDOW`` bounds the pending losses;
- the phases each loop reports;
- a writer's error is raised at the end of ``optimize`` and at the next
  write, and the writer is gone either way;
- ``request_stop`` under the async loop writes the iteration it stopped
  at.
"""
import math
import re

import numpy as np
import pytest

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.optim import SGD as JaxSGD, Trigger as JaxTrigger
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.utils.serialization import load_pytree as jax_load_pytree
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import AbstractDataSet, DataSet, MiniBatch
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.optim import optimizer as optmod
from bigdl_tpu_torch.utils import flatten, load_pytree


def _toy_problem(n=64, dim=10, classes=4, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, dim).astype(np.float32)
    w = rs.randn(dim, classes).astype(np.float32)
    return x, (x @ w).argmax(-1)


def _mlp(nn, dim=10, classes=4):
    return nn.Sequential(nn.Linear(dim, 16), nn.ReLU(),
                         nn.Linear(16, classes))


def _variables():
    return jax.tree_util.tree_map(
        np.asarray, _mlp(jnn).init(jax.random.PRNGKey(0)))


def _port(end, ds=None, ckpt=None, resume=None, lr=0.1):
    x, y = _toy_problem()
    opt = (Optimizer.apply(_mlp(tnn), ds or DataSet.from_arrays(x, y, 16),
                           tnn.ClassNLLCriterion(logits=True),
                           end_trigger=end, device="cpu")
           .set_optim_method(SGD(lr, momentum=0.9))
           .set_initial_variables(_variables()))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.every_epoch())
    if resume is not None:
        opt.resume_from(str(resume))
    return opt


def _jax(end, ckpt=None, resume=None):
    x, y = _toy_problem()
    opt = (JaxLocalOptimizer(_mlp(jnn), JaxDataSet.from_arrays(x, y, 16),
                             jnn.ClassNLLCriterion(logits=True), end)
           .set_optim_method(JaxSGD(0.1, momentum=0.9))
           .set_initial_variables(_variables()))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), JaxTrigger.every_epoch())
    if resume is not None:
        opt.resume_from(str(resume))
    return opt


def _sync(monkeypatch, on):
    monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP", "1" if on else "0")


def _numpy(flat):
    return {k: t.numpy() for k, t in flat.items()}


def test_async_and_sync_loops_train_identically_and_match_jax(monkeypatch):
    runs = {}
    for mode in ("async", "sync"):
        _sync(monkeypatch, mode == "sync")
        opt = _port(Trigger.max_epoch(3))
        opt.optimize()
        runs[mode] = opt
    a, s = runs["async"], runs["sync"]
    assert a._loop_state["neval"] == s._loop_state["neval"] == 12
    assert a._loop_state["loss"] == s._loop_state["loss"]
    for k, t in a.final_params.items():
        np.testing.assert_array_equal(t.numpy(), s.final_params[k].numpy(),
                                      err_msg=k)
    _sync(monkeypatch, False)
    j = _jax(JaxTrigger.max_epoch(3))
    j.optimize()
    want = flatten(jax.tree_util.tree_map(np.asarray, j.final_params))
    assert want.keys() == a.final_params.keys()
    for k, w in want.items():
        np.testing.assert_allclose(a.final_params[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert a._loop_state["loss"] == pytest.approx(
        float(j._driver_state["loss"]), rel=1e-6, abs=1e-6)


class _PoisonOnce(AbstractDataSet):
    """The batches of ``base`` with the features of the ``at``-th one
    produced replaced by NaN (a transient input corruption)."""

    def __init__(self, base, at):
        self.base, self.at, self.count = base, at, 0

    def batches_per_epoch(self):
        return self.base.batches_per_epoch()

    def data(self, train):
        for b in self.base.data(train):
            self.count += 1
            if train and self.count == self.at:
                b = MiniBatch(np.full_like(b.get_input(), np.nan),
                              b.get_target())
            yield b


def test_deferred_nan_detected_within_the_window_and_retried(tmp_path,
                                                             monkeypatch):
    _sync(monkeypatch, False)
    x, y = _toy_problem()
    ds = _PoisonOnce(DataSet.from_arrays(x, y, 16), 6)
    opt = _port(Trigger.max_epoch(6), ds=ds, ckpt=tmp_path / "ck")
    failures = []
    real = opt._recover_or_reraise

    def spy(e, ckpt_dir, trees, loop_state):
        failures.append(str(e))
        real(e, ckpt_dir, trees, loop_state)
        failures.append(loop_state["neval"])

    opt._recover_or_reraise = spy
    opt.optimize()
    assert opt._retries == 1 and len(failures) == 2
    m = re.search(r"iteration (\d+), detected at iteration (\d+)",
                  failures[0])
    assert m, failures[0]
    diverged_at, detected_at = int(m.group(1)), int(m.group(2))
    assert diverged_at == 6
    assert 0 < detected_at - diverged_at <= opt.sync_window
    assert failures[1] == 4  # restored to the end of epoch 1
    blob = load_pytree(str(tmp_path / "ck" / "model"))
    assert int(blob["driver_state"]["neval"]) == 24
    assert int(blob["driver_state"]["epoch"]) == 6
    assert math.isfinite(float(blob["driver_state"]["loss"]))
    assert all(np.isfinite(a).all() for a in flatten(blob["params"]).values())
    assert all(np.isfinite(t.numpy()).all()
               for t in opt.final_params.values())


def test_background_checkpoints_cross_between_the_packages(tmp_path,
                                                           monkeypatch):
    _sync(monkeypatch, False)
    ck = tmp_path / "port"
    opt = _port(Trigger.max_epoch(2), ckpt=ck)
    opt.optimize()
    assert opt._ckpt_pool is None and opt._ckpt_future is None
    # JAX's reader sees its own names and shapes
    blob = jax_load_pytree(str(ck / "model"))
    assert int(blob["driver_state"]["neval"]) == 8
    for k, t in opt.final_params.items():
        np.testing.assert_array_equal(flatten(blob["params"])[k], t.numpy())
    # ... and resumes from it, as the port does, to the same place
    j = _jax(JaxTrigger.max_epoch(4), resume=ck / "model")
    j.optimize()
    p = _port(Trigger.max_epoch(4), resume=ck / "model")
    p.optimize()
    assert p._loop_state["neval"] == 16
    for k, w in flatten(jax.tree_util.tree_map(np.asarray,
                                               j.final_params)).items():
        np.testing.assert_allclose(p.final_params[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # a JAX background checkpoint resumes in the port
    _jax(JaxTrigger.max_epoch(2), ckpt=tmp_path / "jax").optimize()
    jblob = jax_load_pytree(str(tmp_path / "jax" / "model"))
    q = _port(Trigger.max_epoch(2), resume=tmp_path / "jax" / "model")
    q.optimize()  # at its end already: the restored trees, no step
    assert q._loop_state["neval"] == 8
    for k, t in q.final_params.items():
        np.testing.assert_array_equal(t.numpy(), flatten(jblob["params"])[k])


def test_sync_window_env_bounds_pending(monkeypatch):
    _sync(monkeypatch, False)
    monkeypatch.setenv("BIGDL_TPU_SYNC_WINDOW", "3")
    seen = []
    opt = _port(Trigger.max_epoch(4))
    real = opt._drain_losses

    def spy(loop_state, keep=0):
        seen.append(len(opt._pending))
        return real(loop_state, keep=keep)

    opt._drain_losses = spy
    opt.optimize()
    assert opt.sync_window == 3 and len(opt._ring.events) == 4
    assert max(seen) == 3 + 1  # one new loss lands before each read
    assert not opt._pending


def test_phase_names_per_mode(monkeypatch):
    def run(sync):
        _sync(monkeypatch, sync)
        opt = _port(Trigger.max_epoch(2))
        opt.optimize()
        return opt.metrics.summary()

    s_async = run(False)
    assert all(p in s_async for p in ("data:", "data_stall", "dispatch",
                                      "sync"))
    assert "compute" not in s_async
    s_sync = run(True)
    assert "compute" in s_sync and "data:" in s_sync
    assert "data_stall" not in s_sync and "sync:" not in s_sync


@pytest.mark.parametrize("writes", [1, 2])
def test_a_writer_error_is_raised(tmp_path, monkeypatch, writes):
    """One write: raised when optimize joins the writer at its end; two:
    raised when the second waits for the first."""
    _sync(monkeypatch, False)

    def broken(path, blob):
        raise OSError("disk full")

    monkeypatch.setattr(optmod, "save_pytree", broken)
    opt = _port(Trigger.max_iteration(4))
    opt.set_checkpoint(str(tmp_path), Trigger.several_iteration(
        2 if writes == 2 else 3))
    with pytest.raises(OSError, match="disk full"):
        opt.optimize()
    assert opt._ckpt_pool is None and opt._ckpt_future is None


def test_request_stop_under_the_async_loop(tmp_path, monkeypatch):
    _sync(monkeypatch, False)
    opt = _port(Trigger.max_iteration(10))

    def stop_at_3(state):  # never fires: only the stop writes
        if state["neval"] == 3:
            opt.request_stop()
        return False

    opt.set_checkpoint(str(tmp_path), Trigger(stop_at_3))
    opt.optimize()
    assert opt._loop_state["neval"] == 3 and not opt._pending
    assert opt._ckpt_pool is None
    blob = load_pytree(str(tmp_path / "model"))
    assert blob["driver_state"]["neval"] == 3
    assert math.isfinite(blob["driver_state"]["loss"])
    for k, t in opt.final_params.items():
        np.testing.assert_array_equal(flatten(blob["params"])[k], t.numpy())
