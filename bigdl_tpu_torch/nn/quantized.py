"""Post-training int8 quantization (counterpart of bigdl_tpu/nn/quantized.py).

As in the JAX package:

* weights are quantized **per output channel, symmetric** to int8
  (``scale[o] = max|W[..., o]| / 127``);
* activations are quantized **dynamically per tensor** in the forward,
  so a quantized layer's product runs int8 x int8 -> int32.  The scale
  is taken over the whole batch, so an answer depends on its
  batch-mates (rows of zero padding do not change it);
* ``weight_only=True`` keeps activations in x's type and dequantizes
  the weights on the fly.

``quantize(model, variables)`` performs the reference's graph rewrite
(``Quantizer``) on a copy and returns ``(model, variables)``: every
``Linear`` and ``SpatialConvolution`` reached through containers becomes
its quantized twin under the same child key, so the quantized tree's
paths are the JAX tree's.  The int8 ``weight_q`` and the f32 ``scale``
are parameters with ``requires_grad=False`` (the JAX tree keeps them
under ``"params"``); the float weights are not kept.

Routes of the dynamic forward:

- ``QuantizedLinear`` and a 1x1 stride-1 convolution whose resolved pads
  are all zero run :func:`~bigdl_tpu_torch.ops.int8_matmul.int8_matmul_dequant`
  (the int8 kernel on the card).  The reference tests the spelling of
  the padding instead, so its ``"SAME"`` 1x1 convs take XLA's integer
  conv; the int32 sum is exact on both routes, so the values agree;
- every other convolution is a library conv over ``xq.float()`` and
  ``wq.float()``, exact as long as the integer sums stay below 2**24
  (every int8 value and product is exact in f32 and TF32), where the
  reference runs XLA's int32 conv.  It is never run in bf16, which
  would round the sums.

``plain = True`` (set by :func:`~bigdl_tpu_torch.nn.use_plain_ops`) runs
the kernel's plain PyTorch version on any device.
"""
from __future__ import annotations

import copy
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.conv import (SpatialConvolution, conv2d_nhwc,
                                     resolve_padding)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_dequant,
                                             int8_matmul_dequant_plain)

__all__ = ["QuantizedLinear", "QuantizedSpatialConvolution", "quantize",
           "quantize_weight", "save_quantized", "load_quantized"]

Tensor = torch.Tensor


def quantize_weight(w: Tensor, axis: int) -> Tuple[Tensor, Tensor]:
    """Symmetric per-channel int8 along ``axis``: returns (int8 weight,
    f32 scale with the reduced axes kept as 1)."""
    w = w.float()
    reduce = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    amax = w.abs().amax(dim=reduce, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_activation(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Dynamic per-tensor symmetric int8, computed in x's type (in bf16
    the max, the scale and ``x / scale`` each round to bf16)."""
    with torch.profiler.record_function("int8.quantize_activation"):
        scale = torch.clamp_min(x.abs().amax(), 1e-8) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _frozen(t: Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


def _k_major(k: int, n: int) -> Tensor:
    """A zero int8 (k, n) tensor laid out as its transpose: the (k, n)
    view of a contiguous (n, k) buffer, so that each output channel's k
    weights are contiguous, the layout the int8 kernel's wgmma reads (it
    takes s8 operands K-major only).  ``copy_`` (load_jax_variables),
    ``Module.to`` and ``deepcopy`` keep the layout."""
    return torch.zeros(n, k, dtype=torch.int8).t()


class QuantizedLinear(Module):
    """int8 x int8 -> int32 matmul (bigdl_tpu/nn/quantized.py:55):
    ``weight_q`` (in, out) int8 with ``in`` contiguous (:func:`_k_major`),
    ``scale`` (1, out) f32, ``bias`` (out,)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, weight_only: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight_only = weight_only
        self.plain = False
        self.weight_q = _frozen(_k_major(input_size, output_size))
        self.scale = _frozen(torch.ones(1, output_size))
        self.bias = _frozen(torch.zeros(output_size)) if with_bias else None

    @staticmethod
    def from_linear(m: Linear, params: Dict[str, Any], weight_only=False
                    ) -> Tuple["QuantizedLinear", Dict[str, np.ndarray]]:
        """The quantized twin of ``m`` and its params subtree, from
        ``m``'s params subtree ``{"weight", "bias"}`` (numpy)."""
        q, scale = quantize_weight(_tensor(params["weight"]), axis=1)
        with_bias = "bias" in params
        new = QuantizedLinear(m.input_size, m.output_size, with_bias,
                              weight_only, name=m.name)
        p = {"weight_q": q.numpy(), "scale": scale.reshape(1, -1).numpy()}
        if with_bias:
            p["bias"] = np.asarray(params["bias"])
        return new, p

    def forward(self, x: Tensor) -> Tensor:
        wq, scale = self.weight_q, self.scale
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if self.weight_only:
            y = x2 @ (wq.to(x.dtype) * scale.to(x.dtype))
        else:
            mm = int8_matmul_dequant_plain if self.plain \
                else int8_matmul_dequant
            xq, sx = _quantize_activation(x2)
            # the activation's and the weight's scales fold into one
            # f32 row applied in the kernel's epilogue
            y = mm(xq, wq, sx * scale.reshape(-1), out_dtype=x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.reshape(*lead, self.output_size)


class QuantizedSpatialConvolution(Module):
    """int8 convolution, NHWC / HWIO (bigdl_tpu/nn/quantized.py:102),
    built from the float ``conv``, of which it keeps a copy without
    weights (``.conv``: kernel, stride, padding, groups, dilation, bias or
    not):
    ``weight_q`` (kh, kw, in / n_group, out) int8 (a 1x1 ungrouped one
    with ``in`` contiguous, :func:`_k_major`), ``scale`` (1, 1, 1, out)
    f32, ``bias`` (out,).  ``conv`` is held outside the module's
    variables, as in the JAX package."""

    def __init__(self, conv: SpatialConvolution, weight_only: bool = False,
                 name: Optional[str] = None):
        super().__init__(name or conv.name)
        geometry = copy.copy(conv)
        geometry._parameters = {}  # the float weights are not kept
        self.__dict__["conv"] = geometry
        self.weight_only = weight_only
        self.plain = False
        kh, kw = conv.kernel_size
        n_in = conv.n_input_plane // conv.n_group
        n_out = conv.n_output_plane
        self.weight_q = _frozen(
            _k_major(n_in, n_out)[None, None]
            if (kh, kw) == (1, 1) and conv.n_group == 1 else
            torch.zeros(kh, kw, n_in, n_out, dtype=torch.int8))
        self.scale = _frozen(torch.ones(1, 1, 1, n_out))
        self.bias = (_frozen(torch.zeros(n_out)) if conv.with_bias
                     else None)

    @staticmethod
    def from_conv(m: SpatialConvolution, params: Dict[str, Any],
                  weight_only=False):
        q, scale = quantize_weight(_tensor(params["weight"]), axis=3)
        new = QuantizedSpatialConvolution(m, weight_only, name=m.name)
        p = {"weight_q": q.numpy(),
             "scale": scale.reshape(1, 1, 1, -1).numpy()}
        if m.with_bias and "bias" in params:
            p["bias"] = np.asarray(params["bias"])
        return new, p

    def _conv(self, x, w, pads):
        m = self.conv
        return conv2d_nhwc(x, w, m.stride, pads, m.dilation, m.n_group)

    def forward(self, x: Tensor) -> Tensor:
        m = self.conv
        wq, scale = self.weight_q, self.scale
        pads = resolve_padding(m.padding, x.shape[1:3], m.kernel_size,
                               m.stride, m.dilation)
        if self.weight_only:
            y = self._conv(x, wq.to(x.dtype) * scale.to(x.dtype), pads)
        else:
            xq, sx = _quantize_activation(x)
            srow = sx * scale
            if (m.kernel_size == (1, 1) and m.stride == (1, 1)
                    and m.n_group == 1 and pads == [(0, 0), (0, 0)]):
                # a 1x1 conv is a matmul over the (B*H*W, C) pixels
                mm = int8_matmul_dequant_plain if self.plain \
                    else int8_matmul_dequant
                n, h, w, c = xq.shape
                y = mm(xq.reshape(n * h * w, c), wq.reshape(c, -1),
                       srow.reshape(-1), out_dtype=x.dtype
                       ).reshape(n, h, w, -1)
            else:
                with torch.profiler.record_function("int8.library_conv"):
                    acc = self._conv(xq.float(), wq.float(), pads)
                y = (acc * srow).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _tensor(a) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _walk_quantized(m: torch.nn.Module):
    """Yield every quantized module in a model tree."""
    for sub in m.modules():
        if isinstance(sub, (QuantizedLinear, QuantizedSpatialConvolution)):
            yield sub


def quantize(model: Module, variables: Optional[Dict[str, Any]] = None,
             weight_only: bool = False) -> Tuple[Module, Dict[str, Any]]:
    """Graph rewrite replacing Linear/SpatialConvolution with quantized
    twins (reference nn/quantized/Quantizer.scala).  ``variables`` is the
    model's JAX-shaped ``{"params", "state"}`` tree of numpy arrays
    (default: :func:`~bigdl_tpu_torch.utils.export_variables` of
    ``model``).  Returns a new ``(model, variables)``, the model loaded
    with the variables on ``model``'s device; the originals are
    untouched."""
    from bigdl_tpu_torch.utils.convert import (export_variables,
                                               load_jax_variables)

    if variables is None:
        variables = export_variables(model)

    def convert(m: Module, p):
        if isinstance(m, Linear):
            return QuantizedLinear.from_linear(m, p, weight_only)
        if isinstance(m, SpatialConvolution):
            return QuantizedSpatialConvolution.from_conv(m, p, weight_only)
        return None

    new_model, new_params = _rewrite_like(model, variables["params"],
                                          convert)
    out = dict(variables)
    out["params"] = new_params
    load_jax_variables(new_model, out)
    return new_model, out


def save_quantized(path: str, model: Module,
                   variables: Optional[Dict[str, Any]] = None) -> None:
    """Persist a :func:`quantize` output (int8 weights, per-channel
    scales and the weight_only flag) in the JAX package's npz format, so
    either package loads it.  ``variables`` defaults to the model's own
    (:func:`~bigdl_tpu_torch.utils.export_variables`, which keeps int8
    leaves int8).  Reload with :func:`load_quantized`."""
    from bigdl_tpu_torch.utils.convert import export_variables
    from bigdl_tpu_torch.utils.serialization import save_pytree

    flags = {m.weight_only for m in _walk_quantized(model)}
    if len(flags) > 1:
        raise ValueError("mixed weight_only flags in one model")
    save_pytree(path, {
        "class": type(model).__name__,
        "quantized": True,
        "weight_only": bool(flags.pop()) if flags else False,
        "variables": (export_variables(model) if variables is None
                      else variables),
    })


def load_quantized(path: str, float_model: Module
                   ) -> Tuple[Module, Dict[str, Any]]:
    """Load a :func:`save_quantized` file (written by either package)
    into a servable model.

    ``float_model``: a freshly built FLOAT model of the architecture
    that was quantized (its weights are ignored).  The saved params drive
    the same Linear/SpatialConvolution -> quantized-twin rewrite
    :func:`quantize` performed; the returned model is loaded with the
    saved variables on ``float_model``'s device."""
    from bigdl_tpu_torch.utils.convert import load_jax_variables
    from bigdl_tpu_torch.utils.serialization import load_pytree

    blob = load_pytree(path)
    if not blob.get("quantized"):
        raise ValueError(f"{path} is not a save_quantized checkpoint")
    weight_only = bool(blob.get("weight_only", False))
    variables = blob["variables"]

    def convert(m: Module, p):
        # the int8 leaf marks a module the quantizer rewrote
        if isinstance(m, Linear) and "weight_q" in p:
            return QuantizedLinear(m.input_size, m.output_size,
                                   "bias" in p, weight_only, name=m.name), p
        if isinstance(m, SpatialConvolution) and "weight_q" in p:
            return QuantizedSpatialConvolution(m, weight_only,
                                               name=m.name), p
        return None

    model, _ = _rewrite_like(float_model, variables["params"], convert)
    load_jax_variables(model, variables)
    return model, variables


def _rewrite_like(model: Module, params, convert: Callable):
    """Shared structure-rewrite walk over a copy of ``model``:
    ``convert(module, params_subtree)`` returns ``(new_module,
    new_params)`` or None to recurse into a container or keep the module.
    Only containers are entered, as in the reference, so a module that
    holds layers of its own (a fused block, the Transformer) is kept as
    it is.  A new module goes to the device of the one it replaces."""
    # deepcopy recurses along the Graph's node -> in_nodes chain, whose
    # depth is the network depth (~160 nodes for ResNet-50) times
    # deepcopy's ~8 frames per object: past the default limit of 1000
    limit = sys.getrecursionlimit()
    try:
        sys.setrecursionlimit(max(limit, 10_000))
        model = copy.deepcopy(model)
    finally:
        sys.setrecursionlimit(limit)

    def walk(m: Module, p):
        done = convert(m, p)
        if done is not None:
            new, new_p = done
            old = next(m.parameters(), None)
            if old is not None:
                new = new.to(old.device)
            return new.train(m.training), new_p
        if isinstance(m, Container):
            newp = dict(p)
            for key in m.child_keys:
                child = m._modules[key]
                new_child, newp[key] = walk(child, p.get(key, {}))
                if new_child is not child:
                    m.replace_child(key, new_child)
            return m, newp
        return m, p

    return walk(model, params)
