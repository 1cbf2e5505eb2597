"""Validation methods and results (counterpart of
bigdl_tpu/optim/validation.py:18-320; reference optim/ValidationMethod.scala).

A :class:`ValidationMethod` maps one batch's (model output, target) to a
:class:`ValidationResult`; results fold with ``+`` across batches on the
host.  Targets may be numpy arrays or tensors; they are moved to the
output's device.  ``Top5Accuracy`` ranks by a stable descending sort, so
among equal scores the lower class comes first, as ``jax.lax.top_k``
gives them.  ``PrecisionRecallAUC``, ``DetectionResult`` and
``MeanAveragePrecision`` are host arithmetic on numpy copies.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch


def _target(target: Any, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(target) if not torch.is_tensor(target)
                           else target, device=device)


def _numpy(a: Any) -> Any:
    """A tensor (any device, bf16 as f32), a list of them or an
    array-like as numpy."""
    if isinstance(a, (list, tuple)) and a and torch.is_tensor(a[0]):
        return type(a)(_numpy(v) for v in a)
    if torch.is_tensor(a):
        a = a.detach()
        return (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
    return np.asarray(a)


class ValidationResult:
    def result(self) -> Tuple[float, int]:
        """(metric value, record count)."""
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: float, count: int):
        self.correct = float(correct)
        self.count = int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        v, n = self.result()
        return f"Accuracy({v:.5f}, {n} records)"


class LossResult(ValidationResult):
    def __init__(self, loss_sum: float, count: int):
        self.loss_sum = float(loss_sum)
        self.count = int(count)

    def result(self):
        return (self.loss_sum / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss_sum + other.loss_sum,
                          self.count + other.count)

    def __repr__(self):
        v, n = self.result()
        return f"Loss({v:.5f}, {n} records)"


class ValidationMethod:
    name = "ValidationMethod"

    def __call__(self, output: Any, target: Any) -> ValidationResult:
        raise NotImplementedError

    def __repr__(self):
        return self.name


class Top1Accuracy(ValidationMethod):
    """Argmax of class scores (or ``> 0.5`` of one binary output) against
    0-based labels; labels < 0 are not counted."""

    name = "Top1Accuracy"

    def __call__(self, output, target):
        target = _target(target, output.device)
        if output.dim() > 2:
            output = output.reshape(-1, output.shape[-1])
            target = target.reshape(-1)
        if output.dim() == 2 and output.shape[-1] > 1:
            pred = output.argmax(-1)
        else:
            pred = (output.reshape(-1) > 0.5).long()
        tgt = target.reshape(-1).long()
        valid = tgt >= 0
        return AccuracyResult(float(((pred == tgt) & valid).sum()),
                              int(valid.sum()))


class Top5Accuracy(ValidationMethod):
    """A hit when the label is among the 5 highest scores (the lower
    class first among equal scores); labels < 0 are not counted."""

    name = "Top5Accuracy"

    def __call__(self, output, target):
        target = _target(target, output.device).reshape(-1).long()
        if output.dim() > 2:
            output = output.reshape(-1, output.shape[-1])
        k = min(5, output.shape[-1])
        top = torch.sort(output, dim=-1, descending=True,
                         stable=True).indices[:, :k]
        hit = (top == target[:, None]).any(-1)
        valid = target >= 0
        return AccuracyResult(float((hit & valid).sum()), int(valid.sum()))


class Loss(ValidationMethod):
    """Average criterion value, weighted by the batch's first dimension
    (reference ValidationMethod Loss)."""

    name = "Loss"

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

        self.criterion = criterion or ClassNLLCriterion(logits=True)

    def __call__(self, output, target):
        loss = self.criterion.forward(output, _target(target, output.device))
        n = int(output.shape[0])
        return LossResult(float(loss) * n, n)


class TreeNNAccuracy(ValidationMethod):
    """Accuracy of the root's prediction in tree outputs (reference
    ValidationMethod.scala:121): the first node of a ``(N, nodes, C)``
    output and the first column of a ``(N, nodes)`` target."""

    name = "TreeNNAccuracy"

    def __call__(self, output, target):
        target = _target(target, output.device)
        if output.dim() == 3:
            output = output[:, 0, :]
        if target.dim() == 2:
            target = target[:, 0]
        pred = output.argmax(-1)
        tgt = target.reshape(-1).long()
        return AccuracyResult(float((pred == tgt).sum()), int(tgt.shape[0]))


def _positive_rank(output, neg_num: int) -> torch.Tensor:
    """Per row of ``1 + neg_num`` scores (the positive first), the
    positive's 1-based rank: one more than the negatives above it."""
    scores = torch.as_tensor(output).reshape(-1, 1 + neg_num)
    return (scores[:, 1:] > scores[:, :1]).sum(-1) + 1


class HitRatio(ValidationMethod):
    """HR@k for recommendation (reference ValidationMethod HitRatio): the
    positive item is ranked against its ``neg_num`` negatives in its
    row."""

    name = "HitRatio"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg_num = neg_num

    def __call__(self, output, target):
        rank = _positive_rank(output, self.neg_num)
        return AccuracyResult(float((rank <= self.k).sum()),
                              int(rank.shape[0]))


class NDCG(ValidationMethod):
    """NDCG@k of the positive item, ranked as in :class:`HitRatio`
    (reference ValidationMethod NDCG)."""

    name = "NDCG"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg_num = neg_num

    def __call__(self, output, target):
        rank = _positive_rank(output, self.neg_num)
        gain = torch.where(rank <= self.k,
                           1.0 / torch.log2(rank + 1.0),
                           torch.zeros((), device=rank.device))
        return AccuracyResult(float(gain.sum()), int(rank.shape[0]))


class PrecisionRecallAUC(ValidationMethod):
    """Area under the precision-recall curve of binary scores (reference
    optim/PrecisionRecallAUC.scala), exact by sorting; the result holds
    ``auc * n`` as its correct count, so that ``+`` averages by
    records."""

    name = "PrecisionRecallAUC"

    def __call__(self, output, target):
        scores = _numpy(output).reshape(-1)
        labels = _numpy(target).reshape(-1)
        labels = labels[np.argsort(-scores)]
        tp = np.cumsum(labels)
        fp = np.cumsum(1 - labels)
        precision = tp / np.maximum(tp + fp, 1)
        recall = tp / max(tp[-1], 1)
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        auc = float(trapezoid(precision, recall))
        n = len(labels)
        return AccuracyResult(auc * n, n)


class DetectionResult(ValidationResult):
    """The (detections, ground-truth boxes, labels) of every image seen,
    folded by ``+``; the mean AP is computed in ``result()`` (reference
    MAPValidationResult, ValidationMethod.scala:410-760)."""

    def __init__(self, records, n_classes: int, iou_thresholds,
                 use_voc2007: bool = False):
        self.records = list(records)
        self.n_classes = n_classes
        self.iou_thresholds = tuple(iou_thresholds)
        self.use_voc2007 = use_voc2007

    def __add__(self, other):
        return DetectionResult(self.records + other.records, self.n_classes,
                               self.iou_thresholds, self.use_voc2007)

    @staticmethod
    def _iou_np(a, b):
        """IoU of every box of ``a`` (K, 4) with every box of ``b``
        (G, 4), boxes as (x1, y1, x2, y2)."""
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.maximum(rb - lt, 0.0)
        inter = wh[..., 0] * wh[..., 1]
        ar_a = np.maximum(a[:, 2] - a[:, 0], 0) \
            * np.maximum(a[:, 3] - a[:, 1], 0)
        ar_b = np.maximum(b[:, 2] - b[:, 0], 0) \
            * np.maximum(b[:, 3] - b[:, 1], 0)
        union = ar_a[:, None] + ar_b[None, :] - inter
        return np.where(union > 0, inter / union, 0.0)

    def _class_matches(self, cls: int):
        """Per image, the class's detections' scores (highest first) and
        their IoU with its ground truths, shared by every threshold."""
        out, n_gt = [], 0
        for dets, gtb, gtl in self.records:
            g = gtb[gtl == cls]
            n_gt += len(g)
            d = dets[(dets[:, 0] == cls) & (dets[:, 1] > 0)]
            d = d[np.argsort(-d[:, 1])]
            iou = (self._iou_np(d[:, 2:6], g) if len(d) and len(g)
                   else np.zeros((len(d), len(g))))
            out.append((d[:, 1], iou))
        return out, n_gt

    def _ap_one(self, per_image, n_gt: int, iou_t: float) -> Optional[float]:
        scores, matches = [], []
        for sc, iou in per_image:
            taken = np.zeros(iou.shape[1], bool)
            for i in range(len(sc)):
                scores.append(sc[i])
                if iou.shape[1] == 0:
                    matches.append(0)
                    continue
                row = np.where(taken, -1.0, iou[i])
                j = int(np.argmax(row))
                if row[j] >= iou_t:
                    taken[j] = True
                    matches.append(1)
                else:
                    matches.append(0)
        if n_gt == 0:
            return None
        if not scores:
            return 0.0
        m = np.asarray(matches)[np.argsort(-np.asarray(scores))]
        tp = np.cumsum(m)
        fp = np.cumsum(1 - m)
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1)
        if self.use_voc2007:  # 11-point interpolation
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t]
                ap += (p.max() if len(p) else 0.0) / 11
            return float(ap)
        # continuous interpolated AP (VOC2010+ and COCO)
        precision = np.maximum.accumulate(precision[::-1])[::-1]
        recall = np.concatenate([[0.0], recall])
        precision = np.concatenate([precision[:1], precision])
        return float(np.sum(np.diff(recall) * precision[1:]))

    def result(self):
        aps = []
        for c in range(self.n_classes):
            per_image, n_gt = self._class_matches(c)
            for t in self.iou_thresholds:
                ap = self._ap_one(per_image, n_gt, t)
                if ap is not None:
                    aps.append(ap)
        return (float(np.mean(aps)) if aps else 0.0, len(self.records))

    def __repr__(self):
        v, n = self.result()
        return f"MAP({v:.5f}, {n} images)"


class MeanAveragePrecision(ValidationMethod):
    """Object-detection mAP (reference ValidationMethod.scala:230,
    410-760), PASCAL VOC (IoU 0.5; ``use_voc2007`` for 11 points) or
    COCO (IoU 0.5 to 0.95).  ``output``: ``(B, K, 6)`` detections
    (label, score, x1, y1, x2, y2), label -1 and score 0 in empty slots;
    ``target``: ``(gt_boxes (B, G, 4), gt_labels (B, G))``, labels -1
    where padded."""

    name = "MeanAveragePrecision"

    def __init__(self, n_classes: int, use_voc2007: bool = False,
                 coco: bool = False):
        self.n_classes = n_classes
        self.use_voc2007 = use_voc2007
        self.iou_thresholds = (
            tuple(np.arange(0.5, 1.0, 0.05)) if coco else (0.5,))

    def __call__(self, output, target):
        dets = _numpy(output)
        gt_boxes, gt_labels = (_numpy(t) for t in target)
        records = []
        for i in range(dets.shape[0]):
            valid = gt_labels[i] >= 0
            records.append((dets[i], gt_boxes[i][valid],
                            gt_labels[i][valid]))
        return DetectionResult(records, self.n_classes, self.iou_thresholds,
                               self.use_voc2007)
