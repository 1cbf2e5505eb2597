"""Loss functions (counterpart of bigdl_tpu/nn/criterion.py).

A :class:`Criterion` is a callable ``loss = crit(input, target)``
returning a scalar; gradients come from autograd.  Class labels are
0-based integers.  Each class follows its JAX counterpart's arithmetic
and result type: the ones that cast to f32 before they reduce (MSE, Abs,
SmoothL1, BCE, BCEWithLogits, MultiLabelSoftMargin) return f32 for a
bf16 input, the others keep the input's type.

Table inputs (``(a, b)`` pairs, ``(mean, log_var)``, ``{1: .., 2: ..}``
dicts) are tuples, lists or dicts of tensors; :meth:`Criterion.backward`
returns the gradient in the same container.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (N, -1)."""
    return t.reshape(t.shape[0], -1)


def _is_integer(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)


def _pair(input):
    """``(first, second)`` of a table given as a sequence or a
    ``{1: .., 2: ..}`` dict."""
    if isinstance(input, dict):
        return input[1], input[2]
    return input[0], input[1]


class Criterion:
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def per_sample(self, input, target) -> torch.Tensor:
        """Loss per batch element, shape (N,)."""
        raise NotImplementedError

    def forward(self, input, target) -> torch.Tensor:
        ls = self.per_sample(input, target)
        return ls.mean() if self.size_average else ls.sum()

    def __call__(self, input, target):
        return self.forward(input, target)

    def backward(self, input, target):
        """Gradient with respect to ``input`` (reference
        Criterion.backward), by autograd; a table input gives its
        gradients in the same container (a tuple, a list or a dict), as
        ``jax.grad`` gives them.  A leaf the loss does not reach has a
        zero gradient."""
        if isinstance(input, dict):
            keys = list(input)
            leaves = [input[k] for k in keys]

            def rebuild(ts):
                return dict(zip(keys, ts))
        elif isinstance(input, (tuple, list)):
            leaves = list(input)

            def rebuild(ts):
                return type(input)(ts)
        else:
            leaves = [input]

            def rebuild(ts):
                return ts[0]
        xs = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            gs = torch.autograd.grad(self.forward(rebuild(xs), target), xs,
                                     allow_unused=True)
        return rebuild([torch.zeros_like(x) if g is None else g
                        for x, g in zip(xs, gs)])


class ClassNLLCriterion(Criterion):
    """NLL over log-probabilities, or over logits with ``logits=True``
    (reference nn/ClassNLLCriterion.scala).  Targets are integer labels
    or one-hot rows, as bigdl_tpu/nn/criterion.py:57-84 tells them
    apart: a target with the input's rank and class width that is not
    of an integer type holds rows, and gives ``-sum(logp * target)`` per
    row (soft rows too), ignoring ``weights`` and ``padding_value``.
    With labels, ``weights`` are per-class, rows whose label equals
    ``padding_value`` (by default, any label < 0) are masked out, and
    with ``size_average`` the mean is over the weight of the rows kept."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True, logits: bool = False,
                 padding_value: Optional[int] = None):
        super().__init__(size_average)
        self.weights = weights
        self.logits = logits
        self.padding_value = padding_value

    def per_sample(self, input, target):
        logp = torch.log_softmax(input, -1) if self.logits else input
        one_hot = (target.dim() == input.dim()
                   and target.shape[-1] == input.shape[-1]
                   and not _is_integer(target))
        logp = logp.reshape(-1, logp.shape[-1])
        if one_hot:
            return -(logp * target.reshape(-1, target.shape[-1])).sum(-1)
        tgt = target.reshape(-1).long()
        safe = tgt.clamp(0, logp.shape[-1] - 1)
        nll = -logp.gather(1, safe[:, None])[:, 0]
        w = (self.weights.to(nll.device)[safe] if self.weights is not None
             else torch.ones_like(nll))
        valid = (tgt != self.padding_value if self.padding_value is not None
                 else tgt >= 0)
        nll = torch.where(valid, nll * w, 0.0)
        if self.size_average:
            denom = torch.clamp_min(torch.where(valid, w, 0.0).sum(), 1e-8)
            return nll * (nll.shape[0] / denom)  # folded into mean()
        return nll


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused (reference nn/CrossEntropyCriterion)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self._nll = ClassNLLCriterion(weights, size_average, logits=True)

    def per_sample(self, input, target):
        return self._nll.per_sample(input, target)


class MSECriterion(Criterion):
    def per_sample(self, input, target):
        d = (input - target).float()
        return _rows(d * d).mean(-1)


class AbsCriterion(Criterion):
    def per_sample(self, input, target):
        return _rows((input - target).abs().float()).mean(-1)


L1Cost = AbsCriterion


class SmoothL1Criterion(Criterion):
    def per_sample(self, input, target):
        d = (input - target).abs().float()
        return _rows(torch.where(d < 1.0, 0.5 * d * d, d - 0.5)).mean(-1)


class BCECriterion(Criterion):
    """Binary cross-entropy over probabilities (reference
    nn/BCECriterion); the input is clipped to ``[eps, 1 - eps]`` in f32."""

    def __init__(self, weights=None, size_average: bool = True,
                 eps: float = 1e-12):
        super().__init__(size_average)
        self.weights = weights
        self.eps = eps

    def per_sample(self, input, target):
        x = torch.clamp(input.float(), self.eps, 1.0 - self.eps)
        l = -(target * torch.log(x) + (1.0 - target) * torch.log1p(-x))
        if self.weights is not None:
            l = l * self.weights
        return _rows(l).mean(-1)


def _softplus_ce(input, target):
    """``max(x, 0) - x * t + log1p(exp(-|x|))`` in f32, mean per row."""
    x = input.float()
    l = torch.clamp_min(x, 0.0) - x * target + torch.log1p(
        torch.exp(-x.abs()))
    return _rows(l).mean(-1)


class BCEWithLogitsCriterion(Criterion):
    def per_sample(self, input, target):
        return _softplus_ce(input, target)


SigmoidBinaryCrossEntropy = BCEWithLogitsCriterion


class MarginCriterion(Criterion):
    """Hinge loss; targets in {-1, 1} (reference nn/MarginCriterion)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared=False):
        super().__init__(size_average)
        self.margin = margin
        self.squared = squared

    def per_sample(self, input, target):
        l = torch.clamp_min(self.margin - input * target, 0.0)
        if self.squared:
            l = l * l
        return _rows(l).mean(-1)


class HingeEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def per_sample(self, input, target):
        l = torch.where(target > 0, input,
                        torch.clamp_min(self.margin - input, 0.0))
        return _rows(l).mean(-1)


class DistKLDivCriterion(Criterion):
    """KL(target || input) with log-prob inputs (reference
    nn/DistKLDivCriterion)."""

    def per_sample(self, input, target):
        l = torch.where(target > 0, target * (
            torch.log(torch.clamp_min(target, 1e-12)) - input), 0.0)
        return _rows(l).sum(-1)


class KLDCriterion(Criterion):
    """Gaussian KL to N(0, 1) from a ``(mean, log_var)`` table, the VAE
    loss (reference nn/KLDCriterion); the target is optional."""

    def per_sample(self, input, target=None):
        mean, log_var = _pair(input)
        kl = 0.5 * (mean * mean + torch.exp(log_var) - 1.0 - log_var)
        return _rows(kl).sum(-1)

    def forward(self, input, target=None):
        return super().forward(input, target)

    def backward(self, input, target=None):
        return super().backward(input, target)


def _norm(t: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(t, dim=-1, keepdim=keepdim)


class CosineEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def per_sample(self, input, target):
        a, b = input
        cos = (a * b).sum(-1) / torch.clamp_min(_norm(a) * _norm(b), 1e-12)
        return torch.where(target > 0, 1.0 - cos,
                           torch.clamp_min(cos - self.margin, 0.0))


class MarginRankingCriterion(Criterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def per_sample(self, input, target):
        x1, x2 = input
        return torch.clamp_min(-target * (x1 - x2) + self.margin, 0.0)


class MultiLabelSoftMarginCriterion(Criterion):
    def per_sample(self, input, target):
        return _softplus_ce(input, target)


class MultiMarginCriterion(Criterion):
    """Multi-class hinge (reference nn/MultiMarginCriterion): the target
    column is zeroed by a one-hot mask and the sum divided by C."""

    def __init__(self, p: int = 1, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__(size_average)
        self.p, self.margin = p, margin

    def per_sample(self, input, target):
        tgt = target.long()
        correct = input.gather(-1, tgt[:, None])
        l = torch.clamp_min(self.margin - correct + input, 0.0)
        if self.p == 2:
            l = l * l
        mask = torch.nn.functional.one_hot(tgt, input.shape[-1]).to(l.dtype)
        return (l * (1.0 - mask)).sum(-1) / input.shape[-1]


class SoftMarginCriterion(Criterion):
    def per_sample(self, input, target):
        return _rows(torch.log1p(torch.exp(-input * target))).mean(-1)


class MultiCriterion(Criterion):
    """Weighted sum of criterions on the same (input, target)
    (reference nn/MultiCriterion)."""

    def __init__(self):
        super().__init__()
        self.criterions = []
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        return sum(w * c.forward(input, target)
                   for c, w in zip(self.criterions, self.weights))


class ParallelCriterion(Criterion):
    """Criterion i applied to (input[i], target[i]), or to the one
    target with ``repeat_target`` (reference nn/ParallelCriterion)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.criterions = []
        self.weights = []
        self.repeat_target = repeat_target

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.weights)):
            t = target if self.repeat_target else target[i]
            total = total + w * c.forward(input[i], t)
        return total


class TimeDistributedCriterion(Criterion):
    """``critrn`` applied at every timestep of ``(N, T, ...)`` inputs
    (reference nn/TimeDistributedCriterion.scala): input and target are
    folded to ``(N * T, ...)`` and the inner criterion's reduction (a
    mean over all N * T rows for ``ClassNLLCriterion``) is the loss."""

    def __init__(self, critrn: Criterion, size_average: bool = True,
                 dimension: int = 1):
        super().__init__(size_average)
        self.critrn = critrn

    def forward(self, input, target):
        n, t = input.shape[0], input.shape[1]
        flat_in = input.reshape((n * t,) + tuple(input.shape[2:]))
        flat_tgt = target.reshape((n * t,) + tuple(target.shape[2:]))
        return self.critrn.forward(flat_in, flat_tgt)


class ClassSimplexCriterion(MSECriterion):
    """MSE against simplex-embedded class targets (reference
    nn/ClassSimplexCriterion), as the JAX package keeps it: the MSE
    core, the simplex embedding left to the data side."""


class DiceCoefficientCriterion(Criterion):
    """1 - Dice overlap for segmentation (reference
    nn/DiceCoefficientCriterion)."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__(size_average)
        self.epsilon = epsilon

    def per_sample(self, input, target):
        x, t = _rows(input), _rows(target)
        inter = (x * t).sum(-1)
        denom = x.sum(-1) + t.sum(-1)
        return 1.0 - (2.0 * inter + self.epsilon) / (denom + self.epsilon)


class MeanAbsolutePercentageCriterion(Criterion):
    def per_sample(self, input, target):
        d = (target - input).abs() / torch.clamp_min(target.abs(), 1e-7)
        return 100.0 * _rows(d).mean(-1)


class MeanSquaredLogarithmicCriterion(Criterion):
    def per_sample(self, input, target):
        a = torch.log1p(torch.clamp_min(input, 1e-7))
        b = torch.log1p(torch.clamp_min(target, 1e-7))
        return _rows((a - b) * (a - b)).mean(-1)


class KullbackLeiblerDivergenceCriterion(Criterion):
    def per_sample(self, input, target):
        t = torch.clamp(target, 1e-7, 1.0)
        x = torch.clamp(input, 1e-7, 1.0)
        return _rows(t * torch.log(t / x)).sum(-1)


class PoissonCriterion(Criterion):
    def per_sample(self, input, target):
        l = input - target * torch.log(torch.clamp_min(input, 1e-7))
        return _rows(l).mean(-1)


class CosineProximityCriterion(Criterion):
    def per_sample(self, input, target):
        x = input / torch.clamp_min(_norm(input, True), 1e-12)
        t = target / torch.clamp_min(_norm(target, True), 1e-12)
        return -(x * t).sum(-1)


class CategoricalCrossEntropy(Criterion):
    """Cross entropy with a one-hot target over *probabilities*
    (reference nn/CategoricalCrossEntropy.scala: the NLL of log(p))."""

    def per_sample(self, input, target):
        logp = torch.log(torch.clamp(input, 1e-12, 1.0))
        return -(logp * target).sum(-1)


class CosineDistanceCriterion(Criterion):
    """loss = 1 - cos(x, y) (reference nn/CosineDistanceCriterion.scala)."""

    def per_sample(self, input, target):
        x = _rows(input) if input.dim() > 1 else input[None]
        t = target.reshape(x.shape)
        den = torch.clamp_min(_norm(x) * _norm(t), 1e-12)
        return 1.0 - (x * t).sum(-1) / den


class DotProductCriterion(Criterion):
    """loss = <x, y> (reference nn/DotProductCriterion.scala; positive,
    callers negate when maximising).  ``size_average`` (default False)
    divides by the batch size for 2-D input only."""

    def __init__(self, size_average: bool = False):
        super().__init__(size_average)

    def forward(self, input, target):
        dot = (input * target).sum()
        if self.size_average and input.dim() == 2:
            dot = dot / input.shape[0]
        return dot


class PGCriterion(Criterion):
    """Policy-gradient loss (reference nn/PGCriterion.scala):
    ``-sum(R * log(P))``, the target carrying the reward at the sampled
    action's index; ``size_average`` (default False) divides by the
    batch size for 2-D input only."""

    def __init__(self, size_average: bool = False):
        super().__init__(size_average)

    def forward(self, input, target):
        l = -(target * torch.log(torch.clamp_min(input, 1e-12))).sum()
        if self.size_average and input.dim() == 2:
            l = l / input.shape[0]
        return l


class GaussianCriterion(Criterion):
    """Negative Gaussian log-likelihood of the target given a
    ``(mean, log_var)`` table (reference nn/GaussianCriterion.scala):
    ``0.5 log(2 pi) + 0.5 logvar + (x - mu)^2 / (2 exp(logvar))``,
    summed."""

    def forward(self, input, target):
        mean, logvar = _pair(input)
        l = (0.5 * math.log(2.0 * math.pi) + 0.5 * logvar
             + (target - mean) ** 2 / (2.0 * torch.exp(logvar)))
        return l.sum()


class L1HingeEmbeddingCriterion(Criterion):
    """Table input ``(a, b)``, a scalar target y in {1, -1} (reference
    nn/L1HingeEmbeddingCriterion.scala): y = 1 gives ||a - b||_1, y = -1
    ``max(0, margin - ||a - b||_1)``."""

    def __init__(self, margin: float = 1.0):
        super().__init__(size_average=False)
        self.margin = margin

    def forward(self, input, target):
        a, b = _pair(input)
        d = (a - b).abs().sum()
        y = torch.as_tensor(target, device=d.device).reshape(())
        return torch.where(y > 0, d, torch.clamp_min(self.margin - d, 0.0))


class MultiLabelMarginCriterion(Criterion):
    """Multi-class multi-label hinge (reference
    nn/MultiLabelMarginCriterion.scala, torch ``MultiLabelMarginLoss``):
    targets are label indices padded with -1 (0-based here; the
    reference is 1-based with 0 padding).  Only the contiguous block of
    labels before the first negative one counts, and the set of target
    classes is built by a max-combine, so that a padding entry (clipped
    to class 0) cannot un-mark a real target."""

    def per_sample(self, input, target):
        x = input if input.dim() > 1 else input[None]
        t = (target if target.dim() > 1 else target[None]).long()
        c = x.shape[-1]
        valid = torch.cumprod((t >= 0).int(), -1).bool()  # (n, labels)
        safe = t.clamp(0, c - 1)
        is_target = torch.zeros(x.shape, dtype=torch.int32,
                                device=x.device).scatter_reduce(
            1, safe, valid.int(), "amax").bool()
        xt = torch.where(valid, x.gather(1, safe), 0.0)
        margins = 1.0 - xt[:, :, None] + x[:, None, :]  # (n, labels, c)
        keep = valid[:, :, None] & ~is_target[:, None, :]
        m = torch.where(keep, torch.clamp_min(margins, 0.0), 0.0)
        return m.sum((1, 2)) / c


class SmoothL1CriterionWithWeights(Criterion):
    """Weighted smooth-L1 for box regression (reference
    nn/SmoothL1CriterionWithWeights.scala, Fast R-CNN): the target is
    ``(gt, w_in, w_out)`` (a dict in sorted-key order, a sequence, or a
    bare ``gt``); ``d = (x - gt) * w_in``, quadratic below
    ``1 / sigma^2``, times ``w_out``, summed, divided by ``num`` when it
    is positive."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__(size_average=False)
        self.sigma2 = float(sigma) ** 2
        self.num = num

    def forward(self, input, target):
        if isinstance(target, dict):
            parts = [target[k] for k in sorted(target)]
        elif isinstance(target, (tuple, list)):
            parts = list(target)
        else:
            parts = [target]
        d = input - parts[0]
        if len(parts) > 1:
            d = d * parts[1]
        ad = d.abs()
        l = torch.where(ad < 1.0 / self.sigma2, 0.5 * self.sigma2 * d * d,
                        ad - 0.5 / self.sigma2)
        if len(parts) > 2:
            l = l * parts[2]
        s = l.sum()
        return s / self.num if self.num > 0 else s


class SoftmaxWithCriterion(Criterion):
    """Caffe-style fused softmax + NLL over dim 1 of an (N, C, ...)
    tensor with an optional ignore label (reference
    nn/SoftmaxWithCriterion.scala).  ``normalize_mode``: "VALID" (the
    default: divide by the count of rows not ignored, at least 1),
    "FULL", "BATCH_SIZE" or "NONE"."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__(size_average=False)
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def forward(self, input, target):
        c = input.shape[1]
        x = torch.movedim(input, 1, -1).reshape(-1, c)
        t = torch.as_tensor(target, device=x.device).reshape(-1).long()
        logp = torch.log_softmax(x, -1)
        nll = -logp.gather(1, t.clamp(0, c - 1)[:, None])[:, 0]
        valid = (t != self.ignore_label if self.ignore_label is not None
                 else torch.ones_like(t, dtype=torch.bool))
        total = torch.where(valid, nll, 0.0).sum()
        if self.normalize_mode == "VALID":
            return total / torch.clamp_min(valid.to(total.dtype).sum(), 1.0)
        if self.normalize_mode == "FULL":
            return total / t.shape[0]
        if self.normalize_mode == "BATCH_SIZE":
            return total / input.shape[0]
        return total


class TimeDistributedMaskCriterion(Criterion):
    """Time-distributed criterion with a padding mask from the target
    (reference nn/TimeDistributedMaskCriterion.scala): the inner
    criterion per step (its ``size_average`` off for the call), a step
    counted when the first element of its flattened target is not
    ``padding_value``, the sum divided by the count of such steps (at
    least 1)."""

    def __init__(self, criterion: Criterion, padding_value: int = 0):
        super().__init__(size_average=False)
        self.criterion = criterion
        self.padding_value = padding_value

    def forward(self, input, target):
        b, t = input.shape[0], input.shape[1]
        x = input.reshape((b * t,) + tuple(input.shape[2:]))
        tgt = target.reshape((b * t,) + tuple(target.shape[2:]))
        inner = self.criterion
        old = inner.size_average
        inner.size_average = False
        try:
            ls = inner.per_sample(x, tgt)
        finally:
            inner.size_average = old
        valid = tgt.reshape(b * t, -1)[:, 0] != self.padding_value
        ls = torch.where(valid, ls, 0.0)
        return ls.sum() / torch.clamp_min(valid.to(ls.dtype).sum(), 1.0)


class TransformerCriterion(Criterion):
    """Input and target passed through their transformer modules, then
    the criterion (reference nn/TransformerCriterion.scala, the
    perceptual-loss composition of style transfer).  The transformers
    are port modules with their own weights, applied in eval mode; no
    gradient flows through the target's branch."""

    def __init__(self, criterion: Criterion,
                 input_transformer: Optional[Module] = None,
                 target_transformer: Optional[Module] = None):
        super().__init__(size_average=False)
        self.criterion = criterion
        self.input_transformer = input_transformer
        self.target_transformer = target_transformer

    @staticmethod
    def _tx(mod, x):
        if mod is None:
            return x
        was = mod.training
        mod.eval()
        try:
            return mod(x)
        finally:
            mod.train(was)

    def forward(self, input, target):
        xi = self._tx(self.input_transformer, input)
        with torch.no_grad():
            ti = self._tx(self.target_transformer, target)
        return self.criterion.forward(xi, ti.detach())


class CriterionAdapter(Module):
    """A criterion as a module taking an ``(input, target)`` table, so
    that a loss can stand in a graph (reference nn/CriterionTable)."""

    def __init__(self, criterion: Criterion, name: Optional[str] = None):
        super().__init__(name)
        self.criterion = criterion

    def forward(self, inputs):
        x, t = inputs
        return self.criterion.forward(x, t)
