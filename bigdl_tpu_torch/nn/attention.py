"""Attention and the Transformer LM (counterpart of bigdl_tpu/nn/attention.py:
25-131, 264-410, 412-480).

The children and leaves keep the JAX names (``embed``/``pos``/``drop``/
``layer{i}``/``ln_f``; ``ln1``/``mha``/``ln2``/``ffn``; ``wq``/``wk``/
``wv``/``wo`` and ``w1``/``b1``/``w2``/``b2``), so a JAX tree loads with
``load_jax_variables``.  Attention runs ``(B, H, T, D)``; activations are
``(N, T, D)``; weights are ``(in, out)`` and are cast to the activation's
type where they are used.

Random streams: ``forward(x, rng)`` takes a seed (an int, or a 0-dim
int64 tensor, the form a captured train step replays with new values)
and hands child ``i`` the seed ``split_rng(rng, i)``, as ``_child_apply``
hands it ``fold_in(rng, i)``.  Dropout acts on the Transformer's input
(``drop``), on the attention output after ``wo`` and on the FFN's hidden
activation, never on the attention probabilities, so the flash kernel
draws no random numbers.

Cached decoding (``init_cache``, ``apply_cached``, ``prefill``,
``decode_step``, ``extend``, the paged variants and ``generate``),
sequence parallelism (``seq_mesh``) and MoE FFNs (``moe_experts``) are not
ported yet: they raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.nn.dropout import Dropout, dropout
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.init import RandomNormal, Xavier
from bigdl_tpu_torch.nn.module import Container, Module, Seed, split_rng
from bigdl_tpu_torch.nn.norm import LayerNormalization
from bigdl_tpu_torch.ops.attention import dot_product_attention

_DECODE = ("cached decoding comes with the port's decode slice (the LM "
           "server); this slice trains the LM")


def _later(what: str, slice_: str):
    raise NotImplementedError(f"{what} is not ported yet: it comes with "
                              f"the port's {slice_}")


class MultiHeadAttention(Module):
    """Multi-head attention (reference nn/Attention.scala).  The input is
    a query ``(N, Tq, D)`` for self-attention, or a tuple ``(query, kv)``
    or ``(query, kv, mask)``; ``use_flash`` as in
    :func:`dot_product_attention` (``None``: the kernel when mask-free)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attn_dropout: float = 0.0, causal: bool = False,
                 use_flash: Optional[bool] = None, seq_mesh=None,
                 name: Optional[str] = None):
        super().__init__(name)
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        if seq_mesh is not None:
            _later("sequence-parallel attention (seq_mesh)",
                   "parallelism slice")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.attn_dropout = attn_dropout
        self.causal = causal
        self.use_flash = use_flash
        for leaf in ("wq", "wk", "wv", "wo"):
            self.register_parameter(leaf, torch.nn.Parameter(
                torch.empty(hidden_size, hidden_size)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        d = self.hidden_size
        with torch.no_grad():
            for leaf in ("wq", "wk", "wv", "wo"):
                getattr(self, leaf).copy_(Xavier()(generator, (d, d),
                                                   fan_in=d, fan_out=d))

    def _heads(self, x, w):
        """``(N, T, D) @ w`` split into heads: a ``(N, H, T, hd)`` view."""
        n, t, _ = x.shape
        y = x @ w.to(x.dtype)
        return y.reshape(n, t, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, inputs, rng: Optional[Seed] = None):
        if isinstance(inputs, (tuple, list)):
            query, kv = inputs[0], inputs[1]
            mask = inputs[2] if len(inputs) > 2 else None
        else:
            query = kv = inputs
            mask = None
        q = self._heads(query, self.wq)
        k = self._heads(kv, self.wk)
        v = self._heads(kv, self.wv)
        out = dot_product_attention(q, k, v, mask=mask, causal=self.causal,
                                    use_flash=self.use_flash)
        n, h, t, d = out.shape
        out = out.transpose(1, 2).reshape(n, t, h * d)
        out = out @ self.wo.to(out.dtype)
        if self.training and self.attn_dropout > 0.0 and rng is not None:
            out = dropout(out, self.attn_dropout, rng)
        return out

    def init_cache(self, *args, **kwargs):
        raise NotImplementedError(_DECODE)

    apply_cached = init_paged_cache = apply_paged = init_cache


class FeedForwardNetwork(Module):
    """Position-wise FFN (reference nn/FeedForwardNetwork.scala):
    Linear -> activation -> dropout -> Linear."""

    def __init__(self, hidden_size: int, filter_size: int,
                 relu_dropout: float = 0.0,
                 activation: Callable = torch.relu,
                 name: Optional[str] = None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.filter_size = filter_size
        self.relu_dropout = relu_dropout
        self.activation = activation
        self.w1 = torch.nn.Parameter(torch.empty(hidden_size, filter_size))
        self.b1 = torch.nn.Parameter(torch.zeros(filter_size))
        self.w2 = torch.nn.Parameter(torch.empty(filter_size, hidden_size))
        self.b2 = torch.nn.Parameter(torch.zeros(hidden_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        d, f = self.hidden_size, self.filter_size
        with torch.no_grad():
            self.w1.copy_(Xavier()(generator, (d, f), fan_in=d, fan_out=f))
            self.w2.copy_(Xavier()(generator, (f, d), fan_in=f, fan_out=d))
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x, rng: Optional[Seed] = None):
        y = self.activation(x @ self.w1.to(x.dtype) + self.b1.to(x.dtype))
        if self.training and self.relu_dropout > 0.0 and rng is not None:
            y = dropout(y, self.relu_dropout, rng)
        return y @ self.w2.to(x.dtype) + self.b2.to(x.dtype)


class TransformerLayer(Container):
    """Pre-LN block: ``x + MHA(LN(x))``, then ``x + FFN(LN(x))``."""

    def __init__(self, hidden_size: int, num_heads: int,
                 filter_size: Optional[int] = None,
                 attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 causal: bool = False, use_flash: Optional[bool] = None,
                 moe_experts: int = 0, moe_mesh=None, seq_mesh=None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        if moe_experts:
            _later("a mixture-of-experts FFN (moe_experts)",
                   "parallelism slice")
        filter_size = filter_size or 4 * hidden_size
        self.add(LayerNormalization(hidden_size, name="ln1"))
        self.add(MultiHeadAttention(hidden_size, num_heads, attn_dropout,
                                    causal, use_flash, seq_mesh=seq_mesh,
                                    name="mha"))
        self.add(LayerNormalization(hidden_size, name="ln2"))
        self.add(FeedForwardNetwork(hidden_size, filter_size, ffn_dropout,
                                    name="ffn"))

    def forward(self, x, rng: Optional[Seed] = None):
        x = x + self.mha(self.ln1(x), rng=split_rng(rng, 1))
        return x + self.ffn(self.ln2(x), rng=split_rng(rng, 3))

    def apply_cached(self, *args, **kwargs):
        raise NotImplementedError(_DECODE)

    apply_paged = apply_cached


class PositionEncode(Module):
    """Sinusoidal position encoding added to ``(N, T, D)`` embeddings."""

    def __init__(self, max_len: int = 4096, name: Optional[str] = None):
        super().__init__(name)
        self.max_len = max_len

    def forward(self, x):
        t, d = x.shape[1], x.shape[2]
        pe = self.encode_at(torch.arange(t, device=x.device), d, x.dtype)
        return x + pe[None]

    @staticmethod
    def encode_at(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
        """The rows for integer ``positions`` (any shape), computed in f32
        and cast to ``dtype``: ``positions.shape + (d,)``, the sines of
        ``pos / 10000^(2i/d)`` then the cosines."""
        pos = positions.float()[..., None]
        i = torch.arange(d // 2, device=positions.device,
                         dtype=torch.float32)[None, :]
        angle = pos / torch.pow(10000.0, 2.0 * i / d)
        return torch.cat([torch.sin(angle), torch.cos(angle)], -1).to(dtype)


class Transformer(Container):
    """The LM (reference nn/Transformer.scala, encoder-only): token ids
    ``(N, T)`` -> logits ``(N, T, vocab)``.  The embedding is scaled by
    ``sqrt(hidden)`` and initialised N(0, hidden^-1/2); the head is the
    embedding's transpose (weight-tied), so the embedding's gradient
    comes from both uses."""

    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 filter_size: int, num_layers: int, dropout: float = 0.1,
                 causal: bool = True, use_flash: Optional[bool] = None,
                 moe_experts: int = 0, moe_mesh=None, seq_mesh=None,
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.hidden_size = hidden_size
        self.vocab_size = vocab_size
        self.causal = causal
        self.add(LookupTable(
            vocab_size, hidden_size,
            weight_init=RandomNormal(0.0, hidden_size ** -0.5), name="embed"))
        self.add(PositionEncode(name="pos"))
        self.add(Dropout(dropout, name="drop"))
        for i in range(num_layers):
            self.add(TransformerLayer(
                hidden_size, num_heads, filter_size, attn_dropout=dropout,
                ffn_dropout=dropout, causal=causal, use_flash=use_flash,
                moe_experts=moe_experts, moe_mesh=moe_mesh,
                seq_mesh=seq_mesh, name=f"layer{i}"))
        self.add(LayerNormalization(hidden_size, name="ln_f"))

    def forward(self, x, rng: Optional[Seed] = None):
        h = self.embed(x)
        h = h * torch.tensor(math.sqrt(self.hidden_size), dtype=h.dtype)
        h = self.drop(self.pos(h), rng=split_rng(rng, 2))
        for i, key in enumerate(self._keys[3:-1], start=3):
            h = self._modules[key](h, rng=split_rng(rng, i))
        h = self.ln_f(h)
        return h @ self.embed.weight.to(h.dtype).t()

    def init_cache(self, *args, **kwargs):
        raise NotImplementedError(_DECODE)

    prefill = decode_step = extend = init_paged_cache = extend_paged = \
        decode_step_paged = generate = init_cache
