"""The decode server's tick programs (counterpart of
bigdl_tpu/serving/decode.py:63-374).

A decode server keeps a fixed grid of ``slots`` sequences in one KV
cache (dense, or paged through a block table) and advances every slot by
one token per tick with one compiled program, whatever the occupancy:
inactive rows flow through the compute, and ``active`` gates only their
bookkeeping.  Prompts are prefilled in a bucket of padded rows, and a
``write_slot`` program splices one prefilled row into a grid slot.

Each ``*_fn`` returns the raw function, the JAX twin's signature less
``(params, state)`` (the model holds its weights).  Each ``build_*``
compiles it (``utils/graphs.py``) at the shapes of example arguments:
on the card one CUDA graph, on the CPU the eager function.  The first
argument, the grid cache or pool (the argument the JAX package's
``build_*`` functions donate), is donated: the program writes its new
value into those very tensors and returns them in its place.  The other
arguments are copied into the graph's inputs on each call (tokens,
``active``, keys, ``temp``, ``top_k``, ``top_p``, the block table,
``row``/``slot``, page ids, ``advance``); a write program reads its
batch cache in place when it is given the tensors it was built with (a
compiled prefill's outputs).
Outputs other than the donated tree are the graph's own, valid until
its next call.

Sampling draws its noise from the port's counter hash (``mix64`` of a
per-slot int64 key and the vocabulary index), so the key is data to a
captured tick; it cannot reproduce the JAX package's threefry streams.
Greedy rows (``temp <= 0``) take the exact argmax.

The decode engine itself (queue, admission, eviction, chunk scheduling,
speculative rounds) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from bigdl_tpu_torch.nn.dropout import _GAMMA
from bigdl_tpu_torch.nn.module import _lsr, mix64, split_rng
from bigdl_tpu_torch.ops import paged_kv
from bigdl_tpu_torch.utils import graphs

__all__ = ["decode_tick_fn", "build_decode_tick", "prefill_fn",
           "build_prefill", "write_slot_fn", "build_write_slot",
           "sample_logits", "sampling_tick_fn", "build_sampling_tick",
           "paged_tick_fn", "build_paged_tick", "paged_write_slot_fn",
           "build_paged_write_slot", "page_reset_fn", "build_page_reset",
           "prefill_chunk_fn", "build_prefill_chunk"]

Tensor = torch.Tensor


def _compile(fn: Callable, args: tuple, out_at: Optional[int] = 0,
             in_place: tuple = ()) -> Callable:
    """``fn`` compiled at the shapes of ``args`` with ``args[0]``
    donated (``graphs.donate``: its new value is the output at ``out_at``,
    ``None`` for the whole output).  The other arguments are cloned into
    static inputs, except those at the positions ``in_place``."""
    example = (args[0],) + tuple(
        a if j + 1 in in_place else graphs.clone(a)
        for j, a in enumerate(args[1:]))
    return graphs.compile(graphs.donate(fn, out_at), example)


def _freeze_lengths(cache: dict, old: dict, active: Tensor) -> dict:
    """Retired rows keep their final length, so an idle slot's length
    never walks off the end of its cache."""
    return {lk: dict(c, length=torch.where(active, c["length"], old[lk]))
            for lk, c in cache.items()}


# ---------------------------------------------------------------------------
# the greedy tick, prefill and the slot write
# ---------------------------------------------------------------------------
def decode_tick_fn(model) -> Callable:
    """The whole-grid greedy step ``tick(cache, tokens, active) -> (cache,
    next tokens)``: inactive rows still compute (their outputs ignored,
    their token and length kept), which keeps the program occupancy
    independent."""
    @torch.no_grad()
    def tick(cache, tokens, active):
        old = {lk: c["length"] for lk, c in cache.items()}
        logits, cache = model.decode_step(cache, tokens)
        nxt = torch.where(active, logits.argmax(-1).to(torch.int32), tokens)
        return _freeze_lengths(cache, old, active), nxt

    return tick


def build_decode_tick(model, cache, tokens, active) -> Callable:
    """:func:`decode_tick_fn` compiled, the grid ``cache`` donated."""
    return _compile(decode_tick_fn(model), (cache, tokens, active))


def prefill_fn(model, max_len: int, dtype=None) -> Callable:
    """``prefill(ids, lengths) -> (next-token logits, cache)``: fresh
    cache rows of ``max_len`` for a padded prompt batch, and the logits at
    each row's true length."""
    dtype = dtype or torch.float32

    @torch.no_grad()
    def prefill(ids, lengths):
        cache = model.init_cache(ids.shape[0], max_len, dtype)
        return model.prefill(ids, cache, lengths=lengths)

    return prefill


def build_prefill(model, max_len: int, ids, lengths, dtype=None
                  ) -> Callable:
    """:func:`prefill_fn` compiled at the shapes of ``ids`` (a prompt
    bucket) and ``lengths``; nothing is donated."""
    return graphs.compile(prefill_fn(model, max_len, dtype),
                          graphs.clone((ids, lengths)))


def write_slot_fn() -> Callable:
    """``write(grid_cache, batch_cache, row, slot) -> grid_cache``: row
    ``row`` of a prefill batch's cache copied into grid slot ``slot``
    (0-dim or (1,) int tensors) across every leaf."""
    @torch.no_grad()
    def write(grid_cache, batch_cache, row, slot):
        r = row.reshape(1).to(torch.int64)
        s = slot.reshape(1).to(torch.int64)

        def upd(g, b):
            if isinstance(g, dict):
                return {k: upd(v, b[k]) for k, v in g.items()}
            return g.index_copy(0, s, b.index_select(0, r).to(g.dtype))

        return upd(grid_cache, batch_cache)

    return write


def build_write_slot(grid_cache, batch_cache, row, slot) -> Callable:
    """:func:`write_slot_fn` compiled, ``grid_cache`` donated; the batch
    cache is read where it lies when a call passes the tensors given
    here."""
    return _compile(write_slot_fn(), (grid_cache, batch_cache, row, slot),
                    out_at=None, in_place=(1,))


# ---------------------------------------------------------------------------
# in-tick sampling
# ---------------------------------------------------------------------------
def _gumbel(keys: Tensor, v: int) -> Tensor:
    """Gumbel noise ``(S, V)`` f32, a function of each row's int64 key:
    element j reads 23 bits of ``mix64(key + (j + 1) * gamma)`` as a
    uniform u in (0, 1), and gives ``-log(-log(u))``."""
    idx = torch.arange(1, v + 1, dtype=torch.int64, device=keys.device)
    bits = mix64(torch.add(keys.to(torch.int64)[:, None], idx[None],
                           alpha=_GAMMA))
    u = (_lsr(bits, 41).float() + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def sample_logits(logits: Tensor, keys: Tensor, temp: Tensor,
                  top_k: Tensor, top_p: Tensor) -> Tensor:
    """Temperature, top-k and top-p sampling with static shapes:
    ``logits`` (S, V); ``keys`` (S,) int64 per-slot seeds; ``temp`` and
    ``top_p`` (S,) f32, ``top_k`` (S,) int.

    The filter works in sorted order (a stable descending sort): rank <
    top_k (``top_k <= 0`` keeps all), exclusive cumulative probability <
    top_p (``top_p >= 1`` keeps all), the top token always kept; the draw
    is the argmax of the kept scaled logits plus Gumbel noise
    (:func:`_gumbel`), mapped back through the sort.  Rows with ``temp <=
    0`` are the caller's greedy rows."""
    v = logits.shape[-1]
    scaled = logits.float() / temp.clamp_min(1e-6)[:, None]
    order = torch.argsort(scaled, dim=-1, descending=True, stable=True)
    l_sorted = torch.gather(scaled, 1, order)
    ranks = torch.arange(v, device=logits.device)[None]
    keep = ranks < torch.where(top_k > 0, top_k, v).to(torch.int64)[:, None]
    probs = torch.softmax(l_sorted, dim=-1)
    keep &= (probs.cumsum(-1) - probs) < top_p.clamp_max(1.0)[:, None]
    keep[:, 0] = True
    pick = torch.where(keep, l_sorted, -1e30) + _gumbel(keys, v)
    return torch.gather(order, 1, pick.argmax(-1, keepdim=True))[:, 0].to(
        torch.int32)


def _next_tokens(logits, tokens, active, keys, temp, top_k, top_p):
    """The ticks' epilogue: greedy rows take the exact argmax, sampled
    rows (temp > 0) the draw; inactive rows keep their token and their
    key, so a slot's key advances once per tick it decodes."""
    greedy = logits.argmax(-1).to(torch.int32)
    sampled = sample_logits(logits, keys, temp, top_k, top_p)
    nxt = torch.where(active, torch.where(temp > 0.0, sampled, greedy),
                      tokens)
    return nxt, torch.where(active, split_rng(keys, 0), keys)


def sampling_tick_fn(model) -> Callable:
    """The whole-grid step with in-tick sampling: ``tick(cache, tokens,
    active, keys, temp, top_k, top_p) -> (cache, next tokens, keys)``;
    greedy requests ride along as ``temp == 0`` rows."""
    @torch.no_grad()
    def tick(cache, tokens, active, keys, temp, top_k, top_p):
        old = {lk: c["length"] for lk, c in cache.items()}
        logits, cache = model.decode_step(cache, tokens)
        nxt, keys = _next_tokens(logits, tokens, active, keys, temp, top_k,
                                 top_p)
        return _freeze_lengths(cache, old, active), nxt, keys

    return tick


def build_sampling_tick(model, cache, tokens, active, keys, temp, top_k,
                        top_p) -> Callable:
    """:func:`sampling_tick_fn` compiled, the grid ``cache`` donated."""
    return _compile(sampling_tick_fn(model),
                    (cache, tokens, active, keys, temp, top_k, top_p))


# ---------------------------------------------------------------------------
# the paged tick, the paged slot write and the page reset
# ---------------------------------------------------------------------------
def paged_tick_fn(model) -> Callable:
    """The sampling tick over paged pools: ``tick(cache, table, tokens,
    active, keys, temp, top_k, top_p) -> (cache, next tokens, keys)``,
    the block ``table`` (S, M) one more input whose values change as
    pages move."""
    @torch.no_grad()
    def tick(cache, table, tokens, active, keys, temp, top_k, top_p):
        old = {lk: c["length"] for lk, c in cache.items()}
        logits, cache = model.decode_step_paged(cache, table, tokens, active)
        nxt, keys = _next_tokens(logits, tokens, active, keys, temp, top_k,
                                 top_p)
        return _freeze_lengths(cache, old, active), nxt, keys

    return tick


def build_paged_tick(model, cache, table, tokens, active, keys, temp,
                     top_k, top_p) -> Callable:
    """:func:`paged_tick_fn` compiled, the pools ``cache`` donated."""
    return _compile(paged_tick_fn(model), (cache, table, tokens, active,
                                           keys, temp, top_k, top_p))


def paged_write_slot_fn() -> Callable:
    """``write(pool_cache, table_row, batch_cache, row, slot) ->
    pool_cache``: one dense prefill row scattered into a slot's pages
    through its block-table row (M,) (quantized into an int8 pool).
    Logical pages the slot does not own map to the trash page, so only
    its granted pages are written."""
    @torch.no_grad()
    def write(pool_cache, table_row, batch_cache, row, slot):
        r = row.reshape(1).to(torch.int64)
        s = slot.reshape(1).to(torch.int64)
        out = {}
        for lk, pool in pool_cache.items():
            bc = batch_cache[lk]
            t_max = bc["k"].shape[2]
            page = pool["k"].shape[1]
            h, d = pool["k"].shape[2], pool["k"].shape[3]
            pos = torch.arange(t_max, dtype=torch.int32,
                               device=table_row.device)[None]
            ones = torch.ones((1,), dtype=torch.bool, device=pos.device)
            idx = (paged_kv.flat_positions(
                table_row[None], pos, ones, page,
                table_row.shape[0] * page).reshape(-1).to(torch.int64),)
            new = dict(pool)
            for name in ("k", "v"):
                vals = bc[name].index_select(0, r)[0].transpose(0, 1)
                paged_kv.scatter_rows(new, name, idx,
                                      vals.reshape(t_max, h, d))
            new["length"] = pool["length"].index_copy(
                0, s, bc["length"].index_select(0, r).to(torch.int32))
            out[lk] = new
        return out

    return write


def build_paged_write_slot(pool_cache, table_row, batch_cache, row, slot
                           ) -> Callable:
    """:func:`paged_write_slot_fn` compiled, ``pool_cache`` donated; the
    batch cache is read in place as in :func:`build_write_slot`."""
    return _compile(paged_write_slot_fn(),
                    (pool_cache, table_row, batch_cache, row, slot),
                    out_at=None, in_place=(2,))


def page_reset_fn() -> Callable:
    """``reset(pool_cache, pages) -> pool_cache``: physical pages
    ``pages`` (int (n,)) zeroed in every leaf but ``length``.  Hygiene
    only (the length mask hides freed bytes); id 0 re-zeroes the trash
    page, so a short list pads with 0."""
    @torch.no_grad()
    def reset(pool_cache, pages):
        idx = pages.to(torch.int64)
        return {lk: {name: leaf if name == "length"
                     else leaf.index_fill(0, idx, 0)
                     for name, leaf in pool.items()}
                for lk, pool in pool_cache.items()}

    return reset


def build_page_reset(pool_cache, pages) -> Callable:
    """:func:`page_reset_fn` compiled, ``pool_cache`` donated."""
    return _compile(page_reset_fn(), (pool_cache, pages), out_at=None)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
def prefill_chunk_fn(model) -> Callable:
    """``chunk(cache, ids, advance) -> (logits, cache)``: one bounded
    prompt chunk (1, T) appended to a batch-1 staging cache at its
    current length (``model.extend``), so one program serves the first
    chunk and every later one.  ``advance`` (1,) is the chunk's true
    token count (the last chunk is padded); the logits are those of the
    last valid position."""
    @torch.no_grad()
    def chunk(cache, ids, advance):
        logits, cache = model.extend(cache, ids, advance=advance)
        last = (advance.clamp_min(1) - 1).to(torch.int64)
        return torch.gather(logits, 1, last[:, None, None].expand(
            -1, 1, logits.shape[2]))[:, 0], cache

    return chunk


def build_prefill_chunk(model, cache, ids, advance) -> Callable:
    """:func:`prefill_chunk_fn` compiled, the staging ``cache``
    donated."""
    return _compile(prefill_chunk_fn(model), (cache, ids, advance),
                    out_at=1)
