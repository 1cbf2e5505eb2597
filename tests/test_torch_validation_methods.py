"""The port's validation methods (bigdl_tpu_torch/optim/validation.py)
against the JAX package's (bigdl_tpu/optim/validation.py:70-320) on the
same outputs and targets, with ties: equal scores across the top-5
boundary (JAX's ``top_k`` puts the lower class first), a positive tied
with negatives (not counted as above it), equal PR scores, detections of
equal score.  Results fold with ``+`` as JAX's do.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu.optim import validation as jv
from bigdl_tpu_torch.optim import validation as tv


def _same(t_res, j_res):
    tv_, tn = t_res.result()
    jv_, jn = j_res.result()
    assert tn == jn
    assert tv_ == pytest.approx(jv_, rel=1e-6, abs=1e-7)


def _scores(seed, n, c, levels=4):
    """Scores drawn from a few levels, so that ties are everywhere."""
    rs = np.random.RandomState(seed)
    return rs.randint(0, levels, (n, c)).astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 10), (4, 6, 8), (16, 3)])
def test_top5_and_top1_with_ties(shape):
    out = _scores(0, int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    rs = np.random.RandomState(1)
    tgt = rs.randint(-1, shape[-1], shape[:-1])  # -1: not counted
    for name in ("Top5Accuracy", "Top1Accuracy"):
        j = getattr(jv, name)()(jnp.asarray(out), jnp.asarray(tgt))
        t = getattr(tv, name)()(torch.from_numpy(out), tgt)
        _same(t, j)


def test_top5_takes_the_lower_class_among_ties():
    out = torch.zeros(1, 8)
    out[0, 7] = 1.0  # class 7 first, then the ties 0..3
    assert tv.Top5Accuracy()(out, [3]).result()[0] == 1.0
    assert tv.Top5Accuracy()(out, [4]).result()[0] == 0.0
    j = jv.Top5Accuracy()(jnp.asarray(out.numpy()), jnp.asarray([4]))
    assert j.result()[0] == 0.0
    a = tv.Top5Accuracy()(out, [3]) + tv.Top5Accuracy()(out, [4])
    assert a.result() == (0.5, 2)


def test_tree_nn_accuracy():
    out = _scores(2, 12 * 5, 4).reshape(12, 5, 4)
    tgt = np.random.RandomState(3).randint(0, 4, (12, 5))
    _same(tv.TreeNNAccuracy()(torch.from_numpy(out), tgt),
          jv.TreeNNAccuracy()(jnp.asarray(out), jnp.asarray(tgt)))
    _same(tv.TreeNNAccuracy()(torch.from_numpy(out[:, 0]), tgt[:, 0]),
          jv.TreeNNAccuracy()(jnp.asarray(out[:, 0]), jnp.asarray(tgt[:, 0])))


@pytest.mark.parametrize("k", [1, 3, 10])
def test_hit_ratio_and_ndcg_with_ties(k):
    neg = 20
    out = _scores(4, 30, 1 + neg, levels=6).reshape(-1)
    tgt = np.zeros_like(out)
    for name in ("HitRatio", "NDCG"):
        j = getattr(jv, name)(k, neg)(jnp.asarray(out), jnp.asarray(tgt))
        t = getattr(tv, name)(k, neg)(torch.from_numpy(out), tgt)
        _same(t, j)
        _same(t + t, j + j)


def test_precision_recall_auc():
    rs = np.random.RandomState(5)
    scores = np.round(rs.rand(200), 1).astype(np.float32)  # ties
    labels = (rs.rand(200) < scores).astype(np.float32)
    j = jv.PrecisionRecallAUC()(scores, labels)
    t = tv.PrecisionRecallAUC()(torch.from_numpy(scores), labels)
    _same(t, j)
    _same(t + tv.PrecisionRecallAUC()(scores[:50], labels[:50]),
          j + jv.PrecisionRecallAUC()(scores[:50], labels[:50]))


def _detections(seed, b=3, k=12, g=5, classes=3):
    rs = np.random.RandomState(seed)
    gt = rs.rand(b, g, 4).astype(np.float32) * 50
    gt[..., 2:] = gt[..., :2] + 5 + rs.rand(b, g, 2) * 30
    gl = rs.randint(0, classes, (b, g))
    gl[:, -1] = -1  # padding
    dets = np.zeros((b, k, 6), np.float32)
    for i in range(b):
        for j in range(k):
            src = gt[i, j % g] + rs.randn(4) * (2 if j < g else 15)
            dets[i, j] = (gl[i, j % g] if gl[i, j % g] >= 0 else 0,
                          np.round(rs.rand(), 1), *src)  # tied scores
    dets[:, -2:, 0] = -1  # empty slots
    dets[:, -2:, 1] = 0
    return dets, (gt, gl)


@pytest.mark.parametrize("kw", [{}, {"use_voc2007": True}, {"coco": True}])
def test_mean_average_precision(kw):
    dets, (gt, gl) = _detections(6)
    dets2, (gt2, gl2) = _detections(7)
    j = jv.MeanAveragePrecision(3, **kw)
    t = tv.MeanAveragePrecision(3, **kw)
    jr = j(dets, (gt, gl)) + j(dets2, (gt2, gl2))
    tr = t(torch.from_numpy(dets), (torch.from_numpy(gt), gl)) \
        + t(dets2, (gt2, gl2))
    assert isinstance(tr, tv.DetectionResult)
    _same(tr, jr)
    assert repr(tr) == repr(jr)
    a, b = dets[0, :, 2:6], gt[0]
    np.testing.assert_array_equal(tv.DetectionResult._iou_np(a, b),
                                  jv.DetectionResult._iou_np(a, b))
