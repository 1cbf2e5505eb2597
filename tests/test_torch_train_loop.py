"""The port's synchronous LocalOptimizer loop against the JAX package's
(``BIGDL_TPU_SYNC_LOOP=1`` on the JAX side only), and the dataset it
reads.

The model is small and well-conditioned (conv, BatchNorm over 256 values
per channel, ReLU, global pooling, Linear), so three trained iterations
can be compared: what is under test is the loop's bookkeeping (the batch
order across an epoch boundary, the learning rate, the step count, the
velocity), not the model.  Both loops start from the same numpy tree
(``set_initial_variables``).  f32, ``rtol=atol=1e-5``.
"""
import logging

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.optim import SGD as JaxSGD, Trigger as JaxTrigger
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.utils import flatten, random_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def _models():
    def build(nn):
        return nn.Sequential(
            nn.SpatialConvolution(3, 8, 3, padding="SAME"),
            nn.SpatialBatchNormalization(8), nn.ReLU(),
            nn.GlobalAveragePooling2D(), nn.Linear(8, 5))

    return build(jnn), build(tnn)


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(12, 8, 8, 3).astype(np.float32),
            rs.randint(0, 5, 12))


def test_local_optimizer_matches_jax_sync_loop(monkeypatch, caplog):
    jm, tm = _models()
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 4)
    x, y = _data()

    monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP", "1")
    jopt = (JaxLocalOptimizer(jm, JaxDataSet.from_arrays(x, y, batch_size=4),
                              jnn.ClassNLLCriterion(logits=True),
                              JaxTrigger.max_iteration(4))
            .set_optim_method(JaxSGD(0.1, momentum=0.9))
            .set_initial_variables(v))
    jopt.optimize()

    with caplog.at_level(logging.INFO, logger="bigdl_tpu_torch.optim"):
        topt = (Optimizer.apply(tm, DataSet.from_arrays(x, y, batch_size=4),
                                tnn.ClassNLLCriterion(logits=True),
                                end_trigger=Trigger.max_iteration(4),
                                device="cpu")
                .set_optim_method(SGD(0.1, momentum=0.9))
                .set_initial_variables(v))
        model = topt.optimize()

    # 3 batches per epoch: iteration 4 read the epoch-1 permutation
    assert topt._loop_state["neval"] == 4
    assert topt._loop_state["epoch"] == 1
    for kind, want in (("params", jopt.final_params),
                       ("state", jopt.final_state)):
        got = topt.final_params if kind == "params" else topt.final_state
        want = flatten(jax.tree_util.tree_map(np.asarray, want))
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **TOL)
    # the model holds the final weights
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), topt.final_params[k])
    lines = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("[Epoch 1 4/12][Iteration 1][Wall Clock")
               and "Throughput is" in m and "Loss is" in m for m in lines)
    assert any("[Iteration 3]" in m for m in lines)  # the epoch's end
    assert topt.train_log_line().startswith("train: iter=4 epoch=1 loss=")


def test_dataset_batches_match_jax_across_epochs():
    x, y = _data(1)
    jd = JaxDataSet.from_arrays(x, y, batch_size=5, seed=3).data(train=True)
    td = DataSet.from_arrays(x, y, batch_size=5, seed=3).data(train=True)
    for _ in range(7):  # 2 batches per epoch, remainder dropped
        jb, tb = next(jd), next(td)
        assert tb.size == 5
        np.testing.assert_array_equal(tb.get_input(), jb.get_input())
        np.testing.assert_array_equal(tb.get_target(), jb.get_target())


def test_triggers():
    s = {"epoch": 2, "neval": 6, "epoch_finished": True}
    assert Trigger.max_epoch(2)(s) and not Trigger.max_epoch(3)(s)
    assert Trigger.max_iteration(6)(s) and not Trigger.max_iteration(7)(s)
    assert Trigger.several_iteration(3)(s)
    assert not Trigger.several_iteration(4)(s)
    assert Trigger.every_epoch()(s)
    assert not Trigger.several_iteration(3)({"neval": 0})


def test_optimizer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    _, tm = _models()
    x, y = _data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer.apply(tm, DataSet.from_arrays(x, y, batch_size=4),
                        tnn.ClassNLLCriterion(logits=True))


@pytest.mark.parametrize("loop", ["async", "sync"])
def test_several_methods_by_key_match_jax(monkeypatch, loop):
    """``set_optim_methods`` with top-level keys: the conv ("0") with
    LARS, the Linear ("4") with Adam, the BatchNorm ("1") with no method
    (it keeps its weights); each method's state is its subtree's, the
    rates go in sorted order, and the run matches JAX's, whose loop runs
    the same way (async or synchronous)."""
    from bigdl_tpu.optim import Adam as JaxAdam, LarsSGD as JaxLars
    from bigdl_tpu_torch.optim import Adam, LarsSGD
    from bigdl_tpu_torch.utils import export_opt_state

    jm, tm = _models()
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 4)
    x, y = _data()
    monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP", "1" if loop == "sync" else "0")
    jopt = (JaxLocalOptimizer(jm, JaxDataSet.from_arrays(x, y, batch_size=4),
                              jnn.ClassNLLCriterion(logits=True),
                              JaxTrigger.max_iteration(4))
            .set_optim_methods({"0": JaxLars(0.1, weight_decay=1e-3),
                                "4": JaxAdam(1e-2)})
            .set_initial_variables(v))
    jopt.optimize()
    topt = (Optimizer.apply(tm, DataSet.from_arrays(x, y, batch_size=4),
                            tnn.ClassNLLCriterion(logits=True),
                            end_trigger=Trigger.max_iteration(4),
                            device="cpu")
            .set_optim_methods({"0": LarsSGD(0.1, weight_decay=1e-3),
                                "4": Adam(1e-2)})
            .set_initial_variables(v))
    topt.optimize()
    want = flatten(jax.tree_util.tree_map(np.asarray, jopt.final_params))
    assert topt.final_params.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(topt.final_params[k].numpy(), w,
                                   err_msg=k, **TOL)
    for k in ("1.weight", "1.bias"):  # owned by no method
        np.testing.assert_array_equal(topt.final_params[k].numpy(),
                                      flatten(v["params"])[k])
    # a method's state nests as JAX's {name: subtree}
    opt_states = {name: m.init_state({k: p for k, p in
                                      topt.final_params.items()
                                      if k.split(".")[0] == name})
                  for name, m in topt.optim_methods.items()}
    tree = export_opt_state(tm, opt_states["4"], "4")
    assert set(tree) == {"m", "v"} and set(tree["m"]) == {"4"}
    assert set(tree["m"]["4"]) == {"weight", "bias"}
