"""Beam-search sequence decoding (counterpart of bigdl_tpu/nn/beam_search.py;
reference nn/SequenceBeamSearch.scala).

Each step expands ``beam_size`` hypotheses per batch row, takes the
top ``2 * beam_size`` candidates (so that ``beam_size`` stay live even
when that many end in EOS), keeps the best non-EOS ones live and merges
the EOS ones, length-normalised by ``((5 + len) / 6) ** alpha``, into a
pool of finished beams.  Rows that never finish fall back to their live
beams.

The JAX search is one ``lax.scan`` over ``max_decode_length`` steps; here
the step is a function of a carry of tensors and a 0-dim int32 step
index, run eagerly or, with ``compiled`` and tensors on the card, as one
CUDA graph replayed once per step (``utils/graphs.py``): the carry is
its donated input, updated in place by each replay.  Nothing in a step
reads a device value on the host.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values.
At the first step the dead beams' ``NEG_INF`` candidates and the empty
finished pool tie massively, so the order decides which sequences come
out; :func:`_top_k` is a stable descending sort, cut.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils import graphs

__all__ = ["NEG_INF", "SequenceBeamSearch"]

NEG_INF = -1.0e7

Tensor = torch.Tensor


def _length_norm(alpha: float, length: Tensor) -> Tensor:
    """``((5 + length) / 6) ** alpha`` in f32, ``length`` a tensor."""
    return torch.pow((5.0 + length.float()) / 6.0, alpha)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _gather_beams(tree: Any, idx: Tensor) -> Any:
    """Beams ``idx`` (B, k) of every (B, beam, ...) leaf of ``tree``."""
    def take(t):
        i = idx.reshape(tuple(idx.shape) + (1,) * (t.dim() - 2))
        return torch.gather(t, 1, i.expand(tuple(idx.shape)
                                           + tuple(t.shape[2:])))
    return _tree_map(take, tree)


def _top_k(x: Tensor, k: int):
    """The ``k`` largest values of the last axis and their indices, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class SequenceBeamSearch(Module):
    """Beam search over ``symbols_to_logits_fn(ids, i, cache) -> (logits,
    cache)``: ``ids`` (B*beam, T+1) decoded so far, ``i`` the 0-based step
    (a 0-dim int32 tensor), ``logits`` (B*beam, vocab).  The initial
    cache is a dict of tensors leading with the (B,) batch dim; it is
    tiled across beams.  ``search`` returns ``(sequences (B, beam, T+1),
    scores (B, beam))`` best-first."""

    def __init__(self, vocab_size: int, beam_size: int, alpha: float,
                 max_decode_length: int, eos_id: int,
                 padding_value: int = 0,
                 symbols_to_logits_fn: Optional[Callable] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.vocab_size = vocab_size
        self.beam_size = beam_size
        self.alpha = alpha
        self.max_decode_length = max_decode_length
        self.eos_id = eos_id
        self.padding_value = padding_value
        self.symbols_to_logits_fn = symbols_to_logits_fn

    def init_carry(self, initial_ids: Tensor, initial_cache=None) -> tuple:
        """``(seqs, live_logp, cache, fin_seqs, fin_scores, fin_flags)``
        before the first step.  The tiled cache is materialised: the
        compiled step updates it in place."""
        b, k, t = initial_ids.shape[0], self.beam_size, self.max_decode_length
        dev = initial_ids.device
        seqs = torch.full((b, k, t + 1), self.padding_value,
                          dtype=torch.int32, device=dev)
        seqs[:, :, 0] = initial_ids.to(torch.int32)[:, None]
        cache = _tree_map(
            lambda x: x[:, None].expand((b, k) + tuple(x.shape[1:]))
            .clone(), initial_cache or {})
        live_logp = torch.full((b, k), NEG_INF, device=dev)
        live_logp[:, 0] = 0.0  # only beam 0 is live at first
        return (seqs, live_logp, cache, seqs.clone(),
                torch.full((b, k), NEG_INF, device=dev),
                torch.zeros((b, k), dtype=torch.bool, device=dev))

    def step(self, carry: tuple, i: Tensor, fn: Callable) -> tuple:
        """One step of the search: the next carry, new tensors."""
        seqs, live_logp, cache, fin_seqs, fin_scores, fin_flags = carry
        b, k, v = seqs.shape[0], self.beam_size, self.vocab_size
        flat_cache = _tree_map(
            lambda t: t.reshape((b * k,) + tuple(t.shape[2:])), cache)
        logits, flat_cache = fn(seqs.reshape(b * k, -1), i, flat_cache)
        logp = torch.log_softmax(logits.reshape(b, k, v), dim=-1)
        cache = _tree_map(
            lambda t: t.reshape((b, k) + tuple(t.shape[1:])), flat_cache)

        cand = live_logp[:, :, None] + logp                   # (B, k, V)
        top_logp, top_idx = _top_k(cand.reshape(b, k * v), 2 * k)
        beam_idx = torch.div(top_idx, v, rounding_mode="floor")
        tok = (top_idx % v).to(torch.int32)
        new_seqs = torch.gather(seqs, 1, beam_idx[:, :, None].expand(
            -1, -1, seqs.shape[2]))
        col = (i.to(torch.int64) + 1).reshape(1, 1, 1).expand(b, 2 * k, 1)
        new_seqs = new_seqs.scatter(2, col, tok[:, :, None])

        is_eos = tok == self.eos_id
        # live: the best k non-EOS candidates (their cache rows gathered
        # once, through the composed index)
        live_top, live_sel = _top_k(
            torch.where(is_eos, NEG_INF, top_logp), k)
        live_seqs = torch.gather(new_seqs, 1, live_sel[:, :, None].expand(
            -1, -1, seqs.shape[2]))
        live_cache = _gather_beams(cache, torch.gather(beam_idx, 1, live_sel))

        # finished: the EOS candidates, length-normalised, merged into the
        # pool
        fin_cand = torch.where(
            is_eos, top_logp / _length_norm(self.alpha, i + 2), NEG_INF)
        all_scores = torch.cat([fin_scores, fin_cand], 1)
        all_seqs = torch.cat([fin_seqs, new_seqs], 1)
        all_flags = torch.cat([fin_flags, is_eos & (fin_cand > NEG_INF / 2)],
                              1)
        best, sel = _top_k(all_scores, k)
        fin_seqs = torch.gather(all_seqs, 1, sel[:, :, None].expand(
            -1, -1, seqs.shape[2]))
        return (live_seqs, live_top, live_cache, fin_seqs, best,
                torch.gather(all_flags, 1, sel))

    def finish(self, carry: tuple):
        """``(sequences, scores)`` from the last carry: the finished pool
        where a row has a finished beam, else its live beams scored by
        the length norm of the whole length."""
        seqs, live_logp, _, fin_seqs, fin_scores, fin_flags = carry
        norm = torch.pow(torch.tensor(
            (5.0 + self.max_decode_length + 1) / 6.0,
            device=live_logp.device), self.alpha)
        any_fin = fin_flags.any(dim=1, keepdim=True)
        return (torch.where(any_fin[:, :, None], fin_seqs, seqs),
                torch.where(any_fin, fin_scores, live_logp / norm))

    def search(self, initial_ids: Tensor, initial_cache=None,
               fn: Optional[Callable] = None,
               compiled: Optional[dict] = None):
        """Run the search.  ``compiled``: a dict (a ``graphs.Cache``) in
        which the step, captured for tensors on the card, is kept by the
        carry's signature; ``None`` runs every step eagerly."""
        fn = fn or self.symbols_to_logits_fn
        if fn is None:
            raise ValueError("SequenceBeamSearch needs symbols_to_logits_fn")
        with torch.no_grad():
            carry = self.init_carry(initial_ids, initial_cache)
            i = torch.zeros((), dtype=torch.int32, device=initial_ids.device)
            run = self._compiled_step(carry, i, fn, compiled) \
                if compiled is not None else \
                (lambda c, i_: self.step(c, i_, fn))
            for step in range(self.max_decode_length):
                i.fill_(step)
                carry = run(carry, i)
            return self.finish(carry)

    def _compiled_step(self, carry: tuple, i: Tensor, fn: Callable,
                       cache: dict) -> Callable:
        """The step as a compiled call whose carry is donated: each call
        writes the next carry into the static carry and returns it, so
        after the first call the carry passed in is the static one and
        nothing is copied."""
        key = (graphs.signature((carry, i)), self.alpha, self.eos_id, fn)
        # fn is part of the key: pass the same callable (a bound method
        # compares equal to its twin) to reuse a capture
        run = cache.get(key)
        if run is None:
            run = cache[key] = graphs.compile(graphs.donate(
                lambda c, i_: self.step(c, i_, fn)), (carry, i))
        return run
