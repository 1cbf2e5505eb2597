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

Cached decoding (bigdl_tpu/nn/attention.py:134-257, 362-384, 482-672):
``init_cache``/``apply_cached`` keep a dense per-row KV cache, written
at each row's ``length`` and read under a causal-by-length mask;
``init_paged_cache``/``apply_paged`` keep it in pages of a pool through
a block table (:mod:`bigdl_tpu_torch.ops.paged_kv`), int8 pools taking
kernel 7 for QK^T where the shapes and the device allow.  The
Transformer's ``prefill``, ``decode_step``, ``extend``, their paged
twins and ``generate`` (beam search, cached or re-forward) are
inference: they and the layers' cached forwards run under
``torch.no_grad()``, return new caches (a dict per layer, as the JAX
trees) and leave the ones given unchanged.

Parallelism (``parallel/``): under a step's mesh scope the layers run on
the shards their leaves hold (``parallel/tensor_parallel.py``): q/k/v
with ``H / tp`` heads (the flash kernel per rank on them) and ``wo``
row-parallel then reduced over ``model``; the FFN's ``w1``/``b1``
column-parallel and ``w2`` row-parallel, the reduce before ``b2``; the
vocab-sharded embedding's masked lookup and the tied logits' vocab
slices gathered.  With ``seq_mesh`` and a batch split over ``seq`` the
attention core is ring or Ulysses attention (``parallel/sequence.py``,
``seq_mode``) and ``PositionEncode`` encodes global positions.
``moe_experts`` swaps each block's FFN for a Switch MoE
(``parallel/expert.py``), its load-balance loss in the state tree at
``.../ffn/aux_loss``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch
from bigdl_tpu_torch.nn.dropout import Dropout, dropout
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.init import RandomNormal, Xavier
from bigdl_tpu_torch.nn.module import Container, Module, Seed, split_rng
from bigdl_tpu_torch.nn.norm import LayerNormalization
from bigdl_tpu_torch.ops import paged_kv
from bigdl_tpu_torch.ops.attention import dot_product_attention
from bigdl_tpu_torch.ops.partition import (dropout_part, model_mesh,
                                           seq_sharding)
from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS
from bigdl_tpu_torch.utils import graphs


def _part(x, extra=()):
    """The dropout part of an activation: its sequence part and
    ``extra`` split dims."""
    part = list(dropout_part(x) or ()) + list(extra)
    return part or None


class MultiHeadAttention(Module):
    """Multi-head attention (reference nn/Attention.scala).  The input is
    a query ``(N, Tq, D)`` for self-attention, or a tuple ``(query, kv)``
    or ``(query, kv, mask)``; ``use_flash`` as in
    :func:`dot_product_attention` (``None``: the kernel when mask-free)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attn_dropout: float = 0.0, causal: bool = False,
                 use_flash: Optional[bool] = None, seq_mesh=None,
                 seq_mode: str = "ring", name: Optional[str] = None):
        super().__init__(name)
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        if seq_mesh is not None:
            from bigdl_tpu_torch.parallel.sequence import RingSelfAttention

            if seq_mode not in RingSelfAttention.MODES:
                raise ValueError(
                    f"unknown seq_mode {seq_mode!r}; expected one of "
                    f"{RingSelfAttention.MODES}")
        self.seq_mesh = seq_mesh
        self.seq_mode = seq_mode
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
        """``(N, T, D) @ w`` split into heads: a ``(N, H, T, hd)`` view
        (``H / tp`` heads of a column-parallel shard)."""
        n, t, _ = x.shape
        if w.shape[1] % self.head_dim:
            raise ValueError(
                f"a shard of {w.shape[1]} columns splits a head of "
                f"{self.head_dim}: the tensor-parallel degree must divide "
                f"num_heads {self.num_heads}")
        y = x @ w.to(x.dtype)
        return y.reshape(n, t, -1, self.head_dim).transpose(1, 2)

    def _seq_parallel(self, self_attention: bool, mask) -> bool:
        """Whether the core is ring/Ulysses attention: a ``seq_mesh``
        whose ``seq`` degree is above 1 (JAX's refusals: self-attention
        only, no mask) over a batch the step split on the sequence."""
        mesh = self.seq_mesh
        if mesh is None or mesh.shape.get(SEQ_AXIS, 1) <= 1:
            if seq_sharding() is not None:
                raise ValueError(
                    "a sequence-sharded batch needs seq_mesh attention "
                    "(MultiHeadAttention(..., seq_mesh=mesh))")
            return False
        if not self_attention:
            raise ValueError(
                "seq_mesh attention supports self-attention only (query "
                "is not the key/value input)")
        if mask is not None:
            raise ValueError(
                "seq_mesh attention does not take an explicit mask (use "
                "causal=; a dense mask would defeat the sequence "
                "sharding)")
        return seq_sharding() is not None

    def forward(self, inputs, rng: Optional[Seed] = None):
        if isinstance(inputs, (tuple, list)):
            query, kv = inputs[0], inputs[1]
            mask = inputs[2] if len(inputs) > 2 else None
        else:
            query = kv = inputs
            mask = None
        self_attention = query is kv
        seq_par = self._seq_parallel(self_attention, mask)
        tp = self.hidden_size // self.wq.shape[1]
        mesh = None
        if tp > 1:  # column-parallel q/k/v: the input enters the region
            mesh = model_mesh("MultiHeadAttention", tp)
            query = comm.copy_to(query, mesh, MODEL_AXIS)
            kv = query if self_attention else comm.copy_to(kv, mesh,
                                                           MODEL_AXIS)
        q = self._heads(query, self.wq)
        k = self._heads(kv, self.wk)
        v = self._heads(kv, self.wv)
        if seq_par:
            from bigdl_tpu_torch.parallel.sequence import RingSelfAttention

            core = RingSelfAttention(self.seq_mesh, causal=self.causal,
                                     mode=self.seq_mode)(q, k, v)
        else:
            core = dot_product_attention(q, k, v, mask=mask,
                                         causal=self.causal,
                                         use_flash=self.use_flash)
        out = self._out(core)
        if self.wo.shape[0] < self.hidden_size:  # row-parallel wo
            out = comm.reduce_from(out, model_mesh("MultiHeadAttention",
                                                   tp), MODEL_AXIS)
        if self.training and self.attn_dropout > 0.0 and rng is not None:
            out = dropout(out, self.attn_dropout, rng, _part(out))
        return out

    # ------------------------------------------------------------------
    # cached incremental decoding
    # ------------------------------------------------------------------
    def _no_seq_mesh(self):
        if self.seq_mesh is not None:
            raise ValueError(
                "cached decode does not compose with seq_mesh ring "
                "attention (single-token queries have no ring "
                "decomposition)")

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        """Dense KV cache ``{"k", "v": (batch, H, max_len, hd), "length":
        (batch,) int32}``, zeros, on the weights' device.  Every leaf
        leads with the batch dim (beams tile it, slots pack it); lengths
        are per row, so rows at different depths share one program."""
        self._no_seq_mesh()
        shape = (batch, self.num_heads, max_len, self.head_dim)
        dev = self.wq.device
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "length": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)}

    def _qkv(self, x):
        return (self._heads(x, self.wq), self._heads(x, self.wk),
                self._heads(x, self.wv))

    def _out(self, out):
        n, _, t, _ = out.shape
        out = out.transpose(1, 2).reshape(n, t, -1)
        return out @ self.wo.to(out.dtype)

    @staticmethod
    def _causal_by_length(pos, extent: int):
        """Query at absolute position p sees cache positions 0..p:
        ``(N, 1, Tq, extent)`` from ``pos`` (N, Tq)."""
        keys = torch.arange(extent, device=pos.device)
        return keys[None, None, None, :] <= pos[:, None, :, None]

    @torch.no_grad()
    def apply_cached(self, x, cache):
        """Self-attention of ``x`` (N, Tq, D) over the dense cache: its K/V
        written at each row's ``length``, the query attending under the
        causal-by-length mask (plain attention, ``use_flash=False``).
        Returns ``(out, new cache)`` with ``length + Tq``; positions at or
        past the cache's end drop their write (the caller retires a row
        before then)."""
        tq = x.shape[1]
        q, k, v = self._qkv(x)
        length = cache["length"]
        t_max = cache["k"].shape[2]
        pos = length[:, None] + torch.arange(tq, dtype=length.dtype,
                                             device=x.device)[None]
        # cache slot m of row n takes appended position m - length[n],
        # where that lies in [0, Tq): the JAX one-hot contraction's
        # result, exactly, as a gather and a select
        src = (torch.arange(t_max, device=x.device)[None]
               - length[:, None].to(torch.int64))           # (N, Tmax)
        hit = ((src >= 0) & (src < tq))[:, None, :, None]
        src = src.clamp(0, tq - 1)[:, None, :, None]

        def write(old, new):
            new = new.to(old.dtype)
            taken = torch.gather(new, 2, src.expand(
                new.shape[0], new.shape[1], t_max, new.shape[3]))
            return torch.where(hit, taken, old)

        new_k, new_v = write(cache["k"], k), write(cache["v"], v)
        out = dot_product_attention(
            q, new_k.to(q.dtype), new_v.to(q.dtype),
            mask=self._causal_by_length(pos, t_max), use_flash=False)
        return self._out(out), {"k": new_k, "v": new_v,
                                "length": length + tq}

    def init_paged_cache(self, num_pages: int, page_size: int, batch: int,
                         dtype=torch.float32, quantized: bool = False):
        """This layer's paged pool (:func:`paged_kv.init_pool`; page 0 is
        the trash page) on the weights' device."""
        self._no_seq_mesh()
        return paged_kv.init_pool(num_pages, page_size, self.num_heads,
                                  self.head_dim, batch, dtype,
                                  quantized=quantized, device=self.wq.device)

    @torch.no_grad()
    def apply_paged(self, x, cache, table, active):
        """``apply_cached`` over the paged pool: ``x``'s K/V scattered
        through the block ``table`` (N, M) at each row's ``length``
        (inactive rows, ``active`` (N,) False, write to the trash page),
        the whole logical extent gathered back and attended under the
        same mask.  An int8 pool takes kernel 7 for QK^T where
        :func:`paged_kv._int8_eligible` says so (then the f32 softmax and
        PV run plain); otherwise the gather dequantizes and the plain
        attention runs."""
        tq = x.shape[1]
        q, k, v = self._qkv(x)
        page = cache["k"].shape[1]
        l_max = table.shape[1] * page
        length = cache["length"]
        cache = paged_kv.paged_append(cache, table, active, k, v, page,
                                      l_max)
        pos = length[:, None] + torch.arange(tq, dtype=length.dtype,
                                             device=x.device)[None]
        mask = self._causal_by_length(pos, l_max)
        if paged_kv.is_quantized(cache) and paged_kv._int8_eligible(
                tq, l_max, self.head_dim, x.device):
            k_q, k_s, v_all = paged_kv.paged_gather_q(cache, table, page)
            scores = paged_kv.int8_scores(q, k_q, k_s, torch.float32)
            scores = scores / math.sqrt(self.head_dim)
            probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
            out = torch.matmul(probs, v_all).to(q.dtype)
        else:
            k_all, v_all = paged_kv.paged_gather(cache, table, page, q.dtype)
            out = dot_product_attention(q, k_all, v_all, mask=mask,
                                        use_flash=False)
        return self._out(out), dict(cache, length=length + tq)


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
        tp = self.filter_size // self.w1.shape[1]
        mesh = None
        if tp > 1:  # column-parallel w1/b1: the input enters the region
            mesh = model_mesh("FeedForwardNetwork", tp)
            x = comm.copy_to(x, mesh, MODEL_AXIS)
        y = self.activation(x @ self.w1.to(x.dtype) + self.b1.to(x.dtype))
        if self.training and self.relu_dropout > 0.0 and rng is not None:
            extra = ([(y.dim() - 1, mesh.rank(MODEL_AXIS), tp)]
                     if mesh is not None else [])
            y = dropout(y, self.relu_dropout, rng, _part(y, extra))
        y = y @ self.w2.to(x.dtype)
        if self.w2.shape[0] < self.filter_size:  # row-parallel w2
            y = comm.reduce_from(y, model_mesh("FeedForwardNetwork", tp),
                                 MODEL_AXIS)
        return y + self.b2.to(x.dtype)


def tied_logits(h, weight, vocab_size: int):
    """``h @ weight.T`` for the weight-tied LM head; a vocab-sharded
    ``weight`` gives this rank's logit columns, gathered over ``model``
    (the input entering the region, so its gradient sums every slice's
    part)."""
    tp = vocab_size // weight.shape[0]
    if tp == 1:
        return h @ weight.to(h.dtype).t()
    mesh = model_mesh("the tied LM head", tp)
    logits = comm.copy_to(h, mesh, MODEL_AXIS) @ weight.to(h.dtype).t()
    return comm.gather_from(logits, mesh, MODEL_AXIS, logits.dim() - 1)


class TransformerLayer(Container):
    """Pre-LN block: ``x + MHA(LN(x))``, then ``x + FFN(LN(x))``."""

    def __init__(self, hidden_size: int, num_heads: int,
                 filter_size: Optional[int] = None,
                 attn_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 causal: bool = False, use_flash: Optional[bool] = None,
                 moe_experts: int = 0, moe_mesh=None, seq_mesh=None,
                 seq_mode: str = "ring", name: Optional[str] = None):
        super().__init__(name=name)
        filter_size = filter_size or 4 * hidden_size
        self.add(LayerNormalization(hidden_size, name="ln1"))
        self.add(MultiHeadAttention(hidden_size, num_heads, attn_dropout,
                                    causal, use_flash, seq_mesh=seq_mesh,
                                    seq_mode=seq_mode, name="mha"))
        self.add(LayerNormalization(hidden_size, name="ln2"))
        if moe_experts:
            # the Switch MoE FFN; its aux_loss joins the training loss
            from bigdl_tpu_torch.parallel.expert import MoE

            self.add(MoE(hidden_size, filter_size, moe_experts,
                         mesh=moe_mesh, name="ffn"))
        else:
            self.add(FeedForwardNetwork(hidden_size, filter_size,
                                        ffn_dropout, name="ffn"))

    def forward(self, x, rng: Optional[Seed] = None):
        x = x + self.mha(self.ln1(x), rng=split_rng(rng, 1))
        return x + self.ffn(self.ln2(x), rng=split_rng(rng, 3))

    @torch.no_grad()
    def apply_cached(self, x, cache):
        """The block in evaluation mode with the attention core on the
        dense KV cache: ``(out, new cache)``.  LayerNorm and the FFN act
        per position, so prefill chunks and single tokens share it."""
        a, cache = self.mha.apply_cached(self.ln1(x), cache)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache

    @torch.no_grad()
    def apply_paged(self, x, cache, table, active):
        """``apply_cached`` with the attention core on the paged pool."""
        a, cache = self.mha.apply_paged(self.ln1(x), cache, table, active)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache


class PositionEncode(Module):
    """Sinusoidal position encoding added to ``(N, T, D)`` embeddings."""

    def __init__(self, max_len: int = 4096, name: Optional[str] = None):
        super().__init__(name)
        self.max_len = max_len

    def forward(self, x):
        t, d = x.shape[1], x.shape[2]
        s = seq_sharding()  # a sequence part: its global positions
        start = s[1] * t if s is not None and s[0] == 1 else 0
        pe = self.encode_at(torch.arange(start, start + t, device=x.device),
                            d, x.dtype)
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
                 seq_mode: str = "ring", name: Optional[str] = None):
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
                seq_mesh=seq_mesh, seq_mode=seq_mode, name=f"layer{i}"))
        self.add(LayerNormalization(hidden_size, name="ln_f"))

    def _scaled(self, h):
        """Embeddings times ``sqrt(hidden)``, the factor rounded to h's
        type first (the weak-typed JAX product)."""
        return h * torch.tensor(math.sqrt(self.hidden_size), dtype=h.dtype)

    def _head(self, h):
        """Final LayerNorm and the weight-tied LM head."""
        return tied_logits(self.ln_f(h), self.embed.weight, self.vocab_size)

    def forward(self, x, rng: Optional[Seed] = None):
        h = self._scaled(self.embed(x))
        h = self.drop(self.pos(h), rng=split_rng(rng, 2))
        for i, key in enumerate(self._keys[3:-1], start=3):
            h = self._modules[key](h, rng=split_rng(rng, i))
        return self._head(h)

    # ------------------------------------------------------------------
    # cached incremental decoding: prefill once over the prompt, then
    # O(cache) work per generated token instead of a re-forward
    # ------------------------------------------------------------------
    def _layer_keys(self):
        return [k for k in self._keys if k.startswith("layer")]

    def _layers(self):
        return [(k, self._modules[k]) for k in self._layer_keys()]

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        """Per-layer dense ``{k, v, length}`` caches, keyed as the layers."""
        return {k: layer.mha.init_cache(batch, max_len, dtype)
                for k, layer in self._layers()}

    def _embed_positions(self, ids, positions):
        """Embedding, ``sqrt(hidden)`` scaling and the position encoding
        at absolute ``positions`` (any shape broadcasting with ids)."""
        emb = self._scaled(self.embed.weight[ids.to(torch.int64)])
        return emb + PositionEncode.encode_at(positions, self.hidden_size,
                                              emb.dtype)

    def _run_cached(self, cache, ids, advance=None, paged=None):
        """Append ``ids`` (N, T) at each row's length through every layer
        (dense, or paged with ``paged = (table, active)``): the logits
        (N, T, V) and the new caches, lengths moved by ``advance`` (N,)
        where given, else by T."""
        pos0 = cache[self._layer_keys()[0]]["length"]
        t = ids.shape[1]
        h = self._embed_positions(ids, pos0[:, None] + torch.arange(
            t, dtype=pos0.dtype, device=ids.device)[None])
        new = {}
        for key, layer in self._layers():
            if paged is None:
                h, c = layer.apply_cached(h, cache[key])
            else:
                h, c = layer.apply_paged(h, cache[key], *paged)
            if advance is not None:
                c = dict(c, length=pos0 + advance.to(torch.int32))
            new[key] = c
        return self._head(h), new

    @torch.no_grad()
    def prefill(self, ids, cache, lengths=None):
        """The causal forward over padded prompts ``ids`` (N, T) into fresh
        cache rows (lengths 0).  ``lengths`` (N,): each row's true prompt
        length (default T); the cache slots past it are stale, and later
        steps overwrite them before the length mask shows them.  Returns
        ``(next-token logits (N, V), cache)``, each row's length set to
        its true length."""
        n, t = ids.shape
        if lengths is None:
            lengths = torch.full((n,), t, dtype=torch.int32,
                                 device=ids.device)
        lengths = lengths.to(torch.int32)
        h = self._embed_positions(ids, torch.arange(t, device=ids.device
                                                    )[None])
        new = {}
        for key, layer in self._layers():
            h, c = layer.apply_cached(h, cache[key])
            new[key] = dict(c, length=lengths)
        logits = self._head(h)
        last = torch.gather(logits, 1, (lengths.to(torch.int64) - 1)[
            :, None, None].expand(n, 1, logits.shape[2]))[:, 0]
        return last, new

    @torch.no_grad()
    def decode_step(self, cache, ids_t):
        """One cached step: ``ids_t`` (N,) is the token at each row's
        length.  Returns ``(logits (N, V), cache)``; every shape is
        static, so one compiled program serves every position."""
        logits, cache = self._run_cached(cache, ids_t[:, None])
        return logits[:, 0], cache

    @torch.no_grad()
    def extend(self, cache, ids, advance=None):
        """Append ``ids`` (N, T) at each row's current length and return
        the logits of every appended position (N, T, V) and the cache:
        chunked prefill and the speculative verify pass.  On a fresh
        cache this is ``prefill``.  ``advance`` (N,): how far each row's
        length moves (default T), so a padded last chunk leaves its
        padding stale past the length."""
        return self._run_cached(cache, ids, advance)

    # ------------------------------------------------------------------
    # paged decode
    # ------------------------------------------------------------------
    def init_paged_cache(self, num_pages: int, page_size: int, batch: int,
                         dtype=torch.float32, kv_dtype=None):
        """Per-layer paged pools of one block-table geometry;
        ``kv_dtype="int8"`` (or ``torch.int8``) stores K/V quantized with
        per-(token, head) f32 scales."""
        quantized = kv_dtype in ("int8", torch.int8)
        return {k: layer.mha.init_paged_cache(num_pages, page_size, batch,
                                              dtype, quantized=quantized)
                for k, layer in self._layers()}

    @torch.no_grad()
    def extend_paged(self, cache, table, ids, active, advance=None):
        """``extend`` over the paged pools: the block ``table`` (N, M)
        goes to every layer's scatter and gather, ``active`` (N,) gates
        the writes."""
        return self._run_cached(cache, ids, advance, paged=(table, active))

    @torch.no_grad()
    def decode_step_paged(self, cache, table, ids_t, active):
        """``decode_step`` through the block table."""
        logits, cache = self.extend_paged(cache, table, ids_t[:, None],
                                          active)
        return logits[:, 0], cache

    # ------------------------------------------------------------------
    # beam search
    # ------------------------------------------------------------------
    def _cached_logits(self, ids, i, cache):
        """The search's step on the cache: the token at step ``i``."""
        tok = ids.index_select(1, i.to(torch.int64).reshape(1))[:, 0]
        return self.decode_step(cache, tok)

    def _forward_logits(self, ids, i, cache):
        """The search's step by re-forward: the causal forward over the
        whole decoded buffer (later positions cannot reach position
        ``i``), read at ``i``."""
        logits = self(ids)
        return logits.index_select(1, i.to(torch.int64).reshape(1))[:, 0], \
            cache

    @torch.no_grad()
    def generate(self, initial_ids, max_decode_length: int,
                 beam_size: int = 4, alpha: float = 0.6,
                 eos_id: Optional[int] = None, use_cache: bool = True):
        """Beam search from one start token per row (reference wires
        nn/SequenceBeamSearch.scala into its Transformer the same way).

        ``initial_ids`` (B,) int; returns ``(sequences (B, beam, T+1),
        scores (B, beam))`` best-first.  ``use_cache=True`` threads the
        per-layer KV caches (in the embedding's type) through the search;
        ``use_cache=False`` re-runs the causal forward over the decoded
        prefix each step (the flash kernel on the card), the numerics
        oracle.  With tensors on the card the search step is one CUDA
        graph per (batch, beam, length, type, use_cache), captured at the
        first call and replayed once per step (the JAX search's one
        ``lax.scan`` program); on the CPU it runs eagerly.  Runs in
        evaluation mode whatever the module's mode."""
        if not self.causal:
            raise ValueError(
                "generate() needs a causal Transformer: with "
                "causal=False every step would attend to the padding "
                "beyond the current position")
        if use_cache:
            cache = self.init_cache(initial_ids.shape[0], max_decode_length,
                                    self.embed.weight.dtype)
            fn = self._cached_logits
        else:
            cache, fn = {}, self._forward_logits
        search = SequenceBeamSearch(
            self.vocab_size, beam_size, alpha, max_decode_length,
            eos_id=self.vocab_size - 1 if eos_id is None else eos_id,
            symbols_to_logits_fn=fn)
        # the graphs read the weights where they lie: new weight tensors
        # (.to(), .half()) need new captures
        weights = tuple(p.data_ptr() for p in self.parameters())
        graphs_cache = self.__dict__.get("_generate_graphs")
        if getattr(graphs_cache, "weights", None) != weights:
            graphs_cache = self.__dict__["_generate_graphs"] = graphs.Cache()
            graphs_cache.weights = weights
        was_training = self.training
        self.eval()
        try:
            return search.search(initial_ids, cache, compiled=graphs_cache)
        finally:
            self.train(was_training)
