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

Speculative decoding (bigdl_tpu/serving/decode.py:377-468) is two more
programs: a draft model proposes k tokens per slot (``build_draft_propose``)
and one pass of the big model over them accepts the longest prefix
equal to its own argmaxes (``build_spec_verify``).
:func:`decode_program_check` builds every program an engine would run
at example shapes (bigdl_tpu/serving/decode.py:470-600).

:class:`DecodeEngine` (bigdl_tpu/serving/decode.py:601-1860) drives
these programs: a request queue, admission into free slots through a
bucketed prefill (or a chunked one for long prompts), continuous
batching at token granularity, deadlines, page budgeting with eviction
of younger requests, per-request sampling and speculative rounds.  Its
telemetry, as the JAX engine's (``bigdl_tpu_torch.telemetry``): every
program is registered under the JAX engine's name (``decode_tick``,
``decode_prefill``, ``decode_write_slot``, ``decode_prefill_chunk``,
``page_reset``, ``draft_prefill``, ``draft_write_slot``,
``draft_prefill_chunk``, ``draft_propose``, ``spec_verify``) with its
signature, so a compile at steady state names its changed axis; the
tick, or the verify when speculating, is stamped with its flops and
bytes and accounted per round; tracer instants mark each request's
edges and each tick carries ``tick:<n>``; the request X-ray charges each
request's phases (queue, prefill, sample, resident, page stall,
spec_verify, deliver) and keeps tail exemplars; the KV cache is an HBM
ledger resident (the pages in use, or the dense grid's reservation);
``start()`` attaches the engine to the debug server and registers its
metrics and exemplars with the flight recorder, ``close()`` detaches it
(bigdl_tpu/serving/decode.py:1249-1297).
"""
from __future__ import annotations

import collections
import itertools
import logging
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.dropout import _GAMMA
from bigdl_tpu_torch.nn.module import _lsr, mix64, split_rng
from bigdl_tpu_torch.ops import paged_kv
from bigdl_tpu_torch.serving import paging
from bigdl_tpu_torch.serving.bucketing import BucketGrid
from bigdl_tpu_torch.serving.engine import (DeadlineExceededError,
                                            EngineClosedError,
                                            QueueFullError, ServingFuture)
from bigdl_tpu_torch.serving.metrics import (PeriodicMetricsLogger,
                                             ServingMetrics)
from bigdl_tpu_torch.telemetry import (costmodel, debug_server,
                                       flightrecorder, programs)
from bigdl_tpu_torch.telemetry import requests as request_xray
from bigdl_tpu_torch.telemetry import workload
from bigdl_tpu_torch.telemetry.tracer import (CAT_DECODE, get_tracer,
                                              set_correlation)
from bigdl_tpu_torch.utils import graphs

logger = logging.getLogger("bigdl_tpu_torch.serving")

__all__ = ["DecodeEngine", "decode_tick_fn", "build_decode_tick", "prefill_fn",
           "build_prefill", "write_slot_fn", "build_write_slot",
           "sample_logits", "sampling_tick_fn", "build_sampling_tick",
           "paged_tick_fn", "build_paged_tick", "paged_write_slot_fn",
           "build_paged_write_slot", "page_reset_fn", "build_page_reset",
           "prefill_chunk_fn", "build_prefill_chunk", "draft_propose_fn",
           "build_draft_propose", "spec_verify_fn", "build_spec_verify",
           "decode_program_check"]

Tensor = torch.Tensor


def _compile(fn: Callable, args: tuple, out_at: Optional[int] = 0,
             in_place: tuple = (), count=None) -> Callable:
    """``fn`` compiled at the shapes of ``args`` with ``args[0]``
    donated (``graphs.donate``: its new value is the output at ``out_at``,
    ``None`` for the whole output).  The other arguments are cloned into
    static inputs, except those at the positions ``in_place``.  ``count``
    is filled from one eager call (``graphs.compile``)."""
    example = (args[0],) + tuple(
        a if j + 1 in in_place else graphs.clone(a)
        for j, a in enumerate(args[1:]))
    return graphs.compile(graphs.donate(fn, out_at), example, count=count)


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
                        top_p, count=None) -> Callable:
    """:func:`sampling_tick_fn` compiled, the grid ``cache`` donated
    (``count``: see :func:`_compile`)."""
    return _compile(sampling_tick_fn(model),
                    (cache, tokens, active, keys, temp, top_k, top_p),
                    count=count)


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
                     top_k, top_p, count=None) -> Callable:
    """:func:`paged_tick_fn` compiled, the pools ``cache`` donated
    (``count``: see :func:`_compile`)."""
    return _compile(paged_tick_fn(model), (cache, table, tokens, active,
                                           keys, temp, top_k, top_p),
                    count=count)


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


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------
def draft_propose_fn(draft_model, k: int) -> Callable:
    """``propose(dcache, tokens, lengths, active) -> (dcache, proposals
    (S, k))``: k greedy draft steps in one program (the JAX package's
    ``lax.scan``, here a Python loop that one CUDA graph captures).  The
    draft cache's lengths are first set to the host's ``lengths``: a
    verify rolls the big model's cache back, and the draft follows it
    (what lies above is stale).  The loop runs k + 1 steps, so that the
    cache also takes in the last proposal (the verify may accept every
    one); the extra step's token is dropped.  Inactive rows keep their
    token and end at the host's length."""
    @torch.no_grad()
    def propose(dcache, tokens, lengths, active):
        dcache = {lk: dict(c, length=lengths) for lk, c in dcache.items()}
        tok, outs = tokens, []
        for _ in range(k + 1):
            logits, dcache = draft_model.decode_step(dcache, tok)
            tok = torch.where(active, logits.argmax(-1).to(torch.int32), tok)
            outs.append(tok)
        return (_freeze_lengths(dcache, {lk: lengths for lk in dcache},
                                active), torch.stack(outs[:k], 1))

    return propose


def build_draft_propose(draft_model, k: int, dcache, tokens, lengths,
                        active) -> Callable:
    """:func:`draft_propose_fn` compiled, the draft's dense ``dcache``
    donated."""
    return _compile(draft_propose_fn(draft_model, k),
                    (dcache, tokens, lengths, active))


def spec_verify_fn(model, k: int, paged: bool = False) -> Callable:
    """One big-model pass over ``[t_last, d_0..d_{k-1}]`` (S, k + 1):
    ``verify(cache, tokens, draft, active) -> (cache, emitted (S, k + 1),
    n_emit (S,))``, or ``verify(cache, table, tokens, draft, active)``
    over paged pools (``extend_paged``).  A row emits ``emitted[:n_emit]``,
    the big model's own argmaxes, so speculative decoding gives the greedy
    tokens whatever the draft proposes.  Lengths roll back in the program
    to ``old + n_emit``; the rejected drafts' K/V stay above the length,
    where the next round overwrites them before anything reads them."""
    def finish(cache, old, logits, tokens, draft, active):
        # b: the argmax at every position; the accepted prefix is the run
        # of drafts equal to b, and an active row emits it and one more
        b = logits.argmax(-1).to(torch.int32)
        acc = torch.cumprod((b[:, :k] == draft).to(torch.int32), 1)
        n_emit = torch.where(active, acc.sum(1) + 1, 0).to(torch.int32)
        return ({lk: dict(c, length=old[lk] + n_emit)
                 for lk, c in cache.items()},
                torch.where(active[:, None], b, tokens[:, None]), n_emit)

    @torch.no_grad()
    def verify(cache, tokens, draft, active):
        old = {lk: c["length"] for lk, c in cache.items()}
        logits, cache = model.extend(cache, torch.cat([tokens[:, None],
                                                       draft], 1))
        return finish(cache, old, logits, tokens, draft, active)

    @torch.no_grad()
    def verify_paged(cache, table, tokens, draft, active):
        old = {lk: c["length"] for lk, c in cache.items()}
        logits, cache = model.extend_paged(
            cache, table, torch.cat([tokens[:, None], draft], 1), active)
        return finish(cache, old, logits, tokens, draft, active)

    return verify_paged if paged else verify


def build_spec_verify(model, k: int, cache, *args, paged: bool = False,
                      count=None) -> Callable:
    """:func:`spec_verify_fn` compiled at the shapes of ``(cache, *args)``
    (``args``: ``tokens, draft, active``, the block table first when
    ``paged``), the grid ``cache`` donated; the ``draft`` tensor is read
    in place when a call passes the one given here (the propose
    program's output).  ``count``: see :func:`_compile`."""
    at = 3 if paged else 2  # the draft's position
    return _compile(spec_verify_fn(model, k, paged), (cache,) + args,
                    in_place=(at,), count=count)


def decode_program_check(model, *, slots: int = 8, max_len: int = 160,
                         prompt_buckets: Sequence[int] = (8, 16, 32),
                         prefill_batch_sizes: Sequence[int] = (1, 4, 8),
                         dtype=None, log: Optional[Callable] = None,
                         page_size: Optional[int] = None,
                         num_pages: Optional[int] = None,
                         kv_dtype=None,
                         prefill_chunk: Optional[int] = None,
                         draft_model=None, draft_k: int = 3,
                         device: DeviceLike = None) -> int:
    """Build every program the decode engine dispatches at its example
    shapes, and run each once: the greedy and the sampling tick, each
    declared prefill bucket and the slot writes; with ``page_size``, the
    paged tick, paged writes and page reset (``kv_dtype="int8"`` adds the
    quantized pool's); with ``prefill_chunk``, the chunk program; with
    ``draft_model``, the propose and verify pair (and the paged verify).
    The counterpart of the JAX package's ``deviceless_decode_check``,
    which compiles against a deviceless TPU topology; there is no such
    CUDA target, so on the card each program is captured (a CUDA graph)
    and replayed once, and on the CPU run once eagerly.  ``model`` (and
    ``draft_model``) move to ``device`` (default: the card).  Returns the
    failure count; ``log`` receives one line per program."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    dtype = dtype or model.embed.weight.dtype
    log = log or (lambda line: None)
    failures = 0

    def ints(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def check(tag, build, *args):
        nonlocal failures
        try:
            build(*args)(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            log(f"{tag}: OK")
        except Exception as e:  # counted and logged: the check's result
            failures += 1
            log(f"{tag}: FAIL {str(e)[:200]}")

    def cache(b=slots):
        return model.init_cache(b, max_len, dtype)

    tok, act = ints(slots), torch.zeros(slots, dtype=torch.bool, device=dev)
    samp = (torch.zeros(slots, dtype=torch.int64, device=dev),
            torch.zeros(slots, device=dev), ints(slots),
            torch.ones(slots, device=dev))
    row = (ints(1), ints(1))
    check("decode tick", lambda *a: build_decode_tick(model, *a), cache(),
          tok, act)
    check("sampling tick", lambda *a: build_sampling_tick(model, *a),
          cache(), tok, act, *samp)
    grid = BucketGrid([(int(t),) for t in prompt_buckets],
                      prefill_batch_sizes, pad_value=0)
    for bucket in grid.declared_buckets():
        check(f"prefill {bucket.batch}x{bucket.dims[0]}",
              lambda *a: build_prefill(model, max_len, *a, dtype=dtype),
              ints(bucket.batch, *bucket.dims), ints(bucket.batch) + 1)
    for b in grid.batch_sizes:
        check(f"write_slot batch={b}", build_write_slot, cache(), cache(b),
              *row)
    if page_size:
        n_pages = num_pages or paging.default_num_pages(slots, max_len,
                                                        page_size)
        m = -(-max_len // page_size)
        table = ints(slots, m)
        variants = [("fp", None)] + ([(str(kv_dtype), kv_dtype)]
                                     if kv_dtype else [])
        for tag, kvd in variants:
            def pool(kvd=kvd):
                return model.init_paged_cache(n_pages, page_size, slots,
                                              dtype, kv_dtype=kvd)

            check(f"paged tick [{tag}]",
                  lambda *a: build_paged_tick(model, *a), pool(), table,
                  tok, act, *samp)
            for b in grid.batch_sizes:
                check(f"paged write_slot batch={b} [{tag}]",
                      build_paged_write_slot, pool(), ints(m), cache(b),
                      *row)
            check(f"page reset [{tag}]", build_page_reset, pool(), ints(m))
            if draft_model is not None:
                check(f"spec verify paged k={draft_k} [{tag}]",
                      lambda *a: build_spec_verify(model, draft_k, *a,
                                                   paged=True),
                      pool(), table, tok, ints(slots, draft_k), act)
    if prefill_chunk:
        check(f"prefill chunk C={prefill_chunk}",
              lambda *a: build_prefill_chunk(model, *a), cache(1),
              ints(1, prefill_chunk), ints(1) + 1)
    if draft_model is not None:
        draft_model = draft_model.to(dev).eval()
        dcache = draft_model.init_cache(slots, max_len,
                                        draft_model.embed.weight.dtype)
        check(f"draft propose k={draft_k}",
              lambda *a: build_draft_propose(draft_model, draft_k, *a),
              dcache, tok, ints(slots), act)
        check(f"spec verify k={draft_k}",
              lambda *a: build_spec_verify(model, draft_k, *a), cache(),
              tok, ints(slots, draft_k), act)
    return failures



# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "fut", "t_submit", "deadline",
                 "rid", "temp", "top_k", "top_p", "key")

    def __init__(self, prompt, max_new, fut, t_submit, deadline, rid=0,
                 temp=0.0, top_k=0, top_p=1.0, key=0):
        self.prompt = prompt
        self.max_new = max_new
        self.fut = fut
        self.t_submit = t_submit
        self.deadline = deadline
        self.rid = rid
        self.temp = temp
        self.top_k = top_k
        self.top_p = top_p
        # the request's int64 sampling key, data to the tick (never a
        # capture constant)
        self.key = key


def _key_for_seed(seed: int) -> int:
    """A request's sampling key: the seed's low 63 bits, the form of the
    per-slot keys that :func:`sample_logits` hashes (the JAX engine keeps
    the seed's bits as a raw threefry key)."""
    return int(seed) & ((1 << 63) - 1)


def _host_sample(logits: Tensor, req: _DecodeRequest) -> int:
    """Token 0 from the prefill's next-token logits (V,) on the host.
    Greedy requests take the exact argmax (the first maximum); sampled
    ones draw by :func:`sample_logits` under the request's key: the
    first draw of the stream whose next keys, ``split_rng(key, 0)`` and
    on, the slot's ticks use."""
    if req.temp <= 0.0:
        return int(torch.argmax(logits))
    return int(sample_logits(
        logits[None].float(), torch.tensor([req.key], dtype=torch.int64),
        torch.tensor([req.temp], dtype=torch.float32),
        torch.tensor([req.top_k], dtype=torch.int32),
        torch.tensor([req.top_p], dtype=torch.float32))[0])


class _Slot:
    __slots__ = ("req", "generated")

    def __init__(self, req: _DecodeRequest, first_token: int):
        self.req = req
        self.generated = [first_token]


_CLOSE = object()  # queue sentinel


class DecodeEngine:
    """KV-cached incremental decoding with continuous batching
    (bigdl_tpu/serving/decode.py:664).

    ``model`` exposes the cached-decode methods of ``nn.Transformer``
    (``init_cache``/``prefill``/``decode_step``/``extend`` and the paged
    twins); ``variables``, when given, is a JAX ``{"params", "state"}``
    tree loaded into it by name.  ``device`` defaults to the card;
    ``device="cpu"`` serves on the CPU.  ``slots`` sequences decode
    together, one tick program advancing all of them; ``max_len`` bounds
    each slot's cache (prompt + new tokens - 1 must fit).  Prompts are
    prefilled in buckets of ``prompt_buckets`` x ``prefill_batch_sizes``
    (a longer prompt becomes a learned bucket), or, with
    ``prefill_chunk=C``, a prompt longer than the largest bucket is fed
    C tokens per loop iteration through a batch-1 staging cache.
    Per-request sampling (``temperature``/``top_k``/``top_p``/``seed``)
    runs inside the tick; the default is greedy, the exact argmax.
    ``continuous=False`` admits only into an empty grid (static
    batching, the baseline).  ``kv_layout="paged"`` keeps the cache in
    a page pool (``page_size``, ``num_pages``; pages return to the
    allocator at retirement) and ``kv_dtype="int8"`` quantizes it.
    ``draft=(draft_model, draft_variables)`` turns on speculative
    decoding (greedy only): each round the draft proposes ``draft_k``
    tokens (default ``BIGDL_TPU_DRAFT_K``, 3) and one verify pass of the
    big model emits the accepted prefix and its own next token, so the
    tokens are the greedy ones whatever the draft proposes.  The draft
    (its variables loaded as ``variables`` are, when given) keeps a
    dense cache of its own in its embedding's type.

    Every program is one of this module's ``build_*``: on the card a
    CUDA graph captured at its first sight, which ``metrics.recompiles``
    counts; ``warmup()`` captures :meth:`declared_programs` of them.
    """

    def __init__(self, model, variables: Optional[dict] = None, *,
                 slots: int = 8,
                 max_len: int = 160,
                 prompt_buckets: Sequence[int] = (8, 16, 32),
                 prefill_batch_sizes: Sequence[int] = (1, 4, 8),
                 eos_id: Optional[int] = None,
                 max_queue: int = 1024,
                 default_deadline_ms: Optional[float] = None,
                 continuous: bool = True,
                 warmup: bool = True,
                 start: bool = True,
                 metrics: Optional[ServingMetrics] = None,
                 metrics_log_every_s: Optional[float] = None,
                 kv_layout: str = "dense",
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 kv_dtype=None,
                 prefill_chunk: Optional[int] = None,
                 draft: Optional[tuple] = None,
                 draft_k: Optional[int] = None,
                 device: DeviceLike = None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {kv_layout!r}")
        if kv_dtype is not None and kv_layout != "paged":
            raise ValueError("kv_dtype requires kv_layout='paged'")
        self._spec = draft is not None
        self.draft_k = 0
        if self._spec:
            self.draft_k = int(draft_k if draft_k is not None
                               else paging.draft_k_default())
            if self.draft_k < 1:
                raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        self.device = resolve_device(device)
        self.model = self._place(model, variables)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.default_deadline_ms = default_deadline_ms
        self.continuous = continuous
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.grid = BucketGrid([(int(t),) for t in prompt_buckets],
                               prefill_batch_sizes, pad_value=0)
        self._largest_bucket = max(int(t) for t in prompt_buckets)
        self._dtype = self.model.embed.weight.dtype
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        if self.paged:
            self.page_size = int(page_size if page_size is not None
                                 else paging.page_size_default())
            self.num_pages = int(
                num_pages if num_pages is not None
                else paging.default_num_pages(self.slots, self.max_len,
                                              self.page_size))
            self.kv_dtype = kv_dtype if kv_dtype is not None \
                else paging.kv_dtype_default()
            self._page_zero = paging.page_zero_enabled()
            self._alloc = paging.PageAllocator(
                self.num_pages, self.page_size, self.slots, self.max_len)
            self._cache = self.model.init_paged_cache(
                self.num_pages, self.page_size, self.slots, self._dtype,
                kv_dtype=self.kv_dtype)
        else:
            self.page_size = None
            self.num_pages = 0
            self.kv_dtype = None
            self._page_zero = False
            self._alloc = None
            self._cache = self.model.init_cache(self.slots, self.max_len,
                                                self._dtype)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self._spec:
            self._draft_model = self._place(*draft)
            self._ddtype = self._draft_model.embed.weight.dtype
            # dense: the draft is small, and its lengths follow the
            # host's each round
            self._dcache = self._draft_model.init_cache(
                self.slots, self.max_len, self._ddtype)
        self._programs: dict = {}  # key -> compiled program

        # the host's grid state, copied into each tick
        self._tokens = np.zeros((self.slots,), np.int32)
        self._active = np.zeros((self.slots,), bool)
        self._slot_state: List[Optional[_Slot]] = [None] * self.slots
        self._keys = np.zeros((self.slots,), np.int64)
        self._temps = np.zeros((self.slots,), np.float32)
        self._topks = np.zeros((self.slots,), np.int32)
        self._topps = np.ones((self.slots,), np.float32)
        # each slot's valid cache extent (prompt + generated - 1), which
        # page budgeting reads
        self._host_len = np.zeros((self.slots,), np.int32)
        self._chunking: Optional[dict] = None
        self._chunk_pending: "collections.deque[_DecodeRequest]" = \
            collections.deque()

        self._rids = itertools.count()
        self._tick_no = 0
        self._tick_cost = None  # the tick's (or verify's) cost stamp
        self._warming = False
        self._resident_name: Optional[str] = None
        self._tracer = get_tracer()
        self._registry = programs.get_program_registry()
        # request X-ray: exact per-request budgets and tail exemplars
        self.xray = request_xray.RequestLedger(tracer=self._tracer)
        self.exemplars = request_xray.ExemplarReservoir(
            tracer=self._tracer)
        self._periodic = PeriodicMetricsLogger(
            self.log_line, every_s=metrics_log_every_s)
        self._rq: "queue.Queue" = queue.Queue(maxsize=max(1, max_queue))
        self._pending: "collections.deque[_DecodeRequest]" = \
            collections.deque()
        self._closed = False
        self._discard = False
        self._close_lock = threading.Lock()
        # the programs and the grid state: one loop iteration, or a
        # warmup, at a time
        self._lock = threading.Lock()
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True, name="bigdl-decode-loop")
        self._started = False

        if warmup:
            self.warmup()
        if start:
            self.start()

    # ------------------------------------------------------------------
    # programs (the compile counter lives here)
    # ------------------------------------------------------------------
    @property
    def recompiles(self) -> int:
        return self.metrics.recompiles

    def _tracked(self, key, build: Callable, program: str,
                 sig_fn: Callable, stamp: bool = False) -> Callable:
        """The program ``key``, built by ``build(count)`` at its first
        sight, which ``metrics.recompiles`` counts with its seconds (on
        the card a CUDA graph captured, its warm-up calls included; on
        the CPU the eager function).  Its compile is registered as
        ``program`` with the signature ``sig_fn()`` (before
        ``record_recompile``, so that the Watchdog pairs a forensic with
        that span); a call of a built program counts a call.  With
        ``stamp``, ``count`` is a cost count, stamped under ``program``
        as the tick's cost, which each round accounts."""
        prog = self._programs.get(key)
        if prog is not None:
            self._registry.record_call(program)
            return prog
        sig = sig_fn()
        count = costmodel.new_count() if stamp else None
        t0 = time.perf_counter()
        prog = build(count)
        dt = time.perf_counter() - t0
        cost = costmodel.stamp(program, count)
        if cost is not None:
            self._tick_cost = cost
            self.metrics.record_program_cost(cost)
        programs.register_program(program, sig, prog, dt, cost=cost,
                                  expected=self._warming,
                                  registry=self._registry)
        self.metrics.record_recompile(dt)
        self._programs[key] = prog
        return prog

    def _sig(self, params, **tree) -> Callable:
        """A ``sig_fn`` for :meth:`_tracked`: the signature of ``params``
        (a model, or ``None``) and the arguments ``tree``, whose
        ``cache``, when present, is donated; ``static`` goes apart."""
        static = tree.pop("static", None)
        if params is not None:
            tree["params"] = params
        return lambda: programs.signature_of(
            tree, static=static,
            donated=("cache",) if "cache" in tree else ())

    def _place(self, model, variables: Optional[dict]):
        """``model`` on the engine's device in evaluation mode, with a JAX
        ``{"params", "state"}`` tree loaded into it when one is given."""
        model = model.to(self.device).eval()
        if variables is not None:
            from bigdl_tpu_torch.utils.convert import load_jax_variables
            load_jax_variables(model, variables)
        return model

    def _dev(self, a: np.ndarray) -> Tensor:
        """A host array on the engine's device: a program's example
        argument (calls pass ``torch.from_numpy`` views, which a captured
        program copies into its inputs)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sides(self) -> tuple:
        """The models whose caches admission fills: the big model
        (``False``) and, speculating, the draft (``True``)."""
        return (False, True) if self._spec else (False,)

    def declared_programs(self) -> int:
        """How many programs a full warmup captures: the tick, and a
        prefill and its slot write per declared (batch, prompt) bucket;
        chunked prefill adds the chunk program and its write, and a
        paged engine that zeroes pages the page reset.  Speculating, the
        propose and verify pair replaces the tick and the draft has its
        own prefill and write per bucket (and chunk and write): ``4 *
        buckets + 2``, plus 4 with chunking and 1 with page zeroing.  A
        write is keyed by the program whose cache it reads, so it always
        reads that cache in place (the JAX engine keys it by batch size:
        one compiled program serves any input buffer there, while a
        graph reads fixed addresses)."""
        sides = len(self._sides())
        n = 2 * sides * len(self.grid.declared_buckets()) + sides
        if self.prefill_chunk:
            n += 2 * sides
        if self.paged and self._page_zero:
            n += 1
        return n

    def warmup(self) -> int:
        """Capture every declared program not captured yet, each run
        once (an all-idle tick or propose and verify, zero prompts
        prefilled and written into a slot that holds no request, a chunk
        into a fresh staging cache, an empty page reset), so that no
        request waits on a capture; returns how many ran (0 on a
        re-warm).  Writes need a slot with no request, and the chunk
        programs a moment when no chunked prefill holds a staging cache;
        otherwise they are captured at their first use."""
        before = self.metrics.recompiles
        with self._lock:
            self._warming = True  # declared programs: no forensics
            try:
                self._warm()
            finally:
                self._warming = False
        return self.metrics.recompiles - before

    def _warm(self):
        """:meth:`warmup`'s captures, with ``_lock`` held."""
        if self._spec:
            if ("propose",) not in self._programs or \
                    ("verify",) not in self._programs:
                self._run_verify(self._run_propose())
        elif ("tick",) not in self._programs:
            self._run_tick()
        idle = next((s for s in range(self.slots)
                     if self._slot_state[s] is None
                     and not self._active[s]
                     and (self._chunking is None
                          or self._chunking["slot"] != s)), None)
        for bucket, draft in itertools.product(
                self.grid.declared_buckets(), self._sides()):
            ids = np.zeros((bucket.batch,) + bucket.dims, np.int32)
            src = ("dprefill" if draft else "prefill", ids.shape)
            write = ("write",) + src not in self._programs \
                and idle is not None
            if src in self._programs and not write:
                continue
            _, pcache = self._run_prefill(
                ids, np.ones((bucket.batch,), np.int32), draft)
            if write:
                self._run_write(pcache, 0, idle, src, draft)
        for draft in self._sides() if self.prefill_chunk \
                and self._chunking is None else ():
            src = ("dchunk" if draft else "chunk",)
            write = ("write",) + src not in self._programs \
                and idle is not None
            if src in self._programs and not write:
                continue
            _, staging = self._run_chunk(
                self._staging(draft),
                np.zeros((1, self.prefill_chunk), np.int32),
                np.ones((1,), np.int32), draft)
            if write:
                self._run_write(staging, 0, idle, src, draft)
        if self._page_zero and ("page_reset",) not in self._programs:
            self._run_page_reset([])

    def _tick_args(self, place: Callable) -> tuple:
        host = (self._tokens, self._active, self._keys, self._temps,
                self._topks, self._topps)
        if self.paged:
            host = (self._alloc.table,) + host
        return (self._cache,) + tuple(place(a) for a in host)

    def _run_tick(self) -> np.ndarray:
        """One tick of the whole grid; the next tokens on the host (the
        tick's one synchronisation), the slots' keys advanced."""
        build = build_paged_tick if self.paged else build_sampling_tick
        host = dict(tokens=self._tokens, active=self._active, keys=self._keys,
                    temp=self._temps, top_k=self._topks, top_p=self._topps)
        if self.paged:
            host["table"] = self._alloc.table
        prog = self._tracked(
            ("tick",), lambda count: build(
                self.model, *self._tick_args(self._dev), count=count),
            "decode_tick", self._sig(self.model, cache=self._cache, **host),
            stamp=True)
        self._cache, nxt, keys = prog(*self._tick_args(torch.from_numpy))
        self._keys = keys.cpu().numpy().copy()
        return nxt.cpu().numpy().copy()

    def _run_propose(self) -> Tensor:
        """The draft's k proposals per slot (S, k), left on the device
        for the verify; the draft cache follows the host's lengths."""
        host = (self._tokens, self._host_len, self._active)
        prog = self._tracked(
            ("propose",), lambda count: build_draft_propose(
                self._draft_model, self.draft_k, self._dcache,
                *map(self._dev, host)),
            "draft_propose", self._sig(
                self._draft_model, cache=self._dcache,
                tokens=self._tokens, lengths=self._host_len,
                active=self._active))
        self._dcache, props = prog(self._dcache,
                                   *map(torch.from_numpy, host))
        return props

    def _run_verify(self, props: Tensor):
        """The big model's pass over each slot's token and proposals:
        the emitted tokens (S, k + 1) and their counts (S,) on the host
        (the round's one synchronisation)."""
        def args(place):
            table = (place(self._alloc.table),) if self.paged else ()
            return (self._cache,) + table + (place(self._tokens), props,
                                             place(self._active))

        prog = self._tracked(
            ("verify",), lambda count: build_spec_verify(
                self.model, self.draft_k, *args(self._dev),
                paged=self.paged, count=count),
            "spec_verify", self._sig(
                self.model, cache=self._cache, tokens=self._tokens,
                active=self._active, static={"draft_k": self.draft_k,
                                             "layout": self.kv_layout}),
            stamp=True)
        self._cache, emitted, n_emit = prog(*args(torch.from_numpy))
        return emitted.cpu().numpy().copy(), n_emit.cpu().numpy().copy()

    def _run_prefill(self, ids: np.ndarray, lengths: np.ndarray,
                     draft: bool = False):
        """A prompt bucket prefilled by the big model or, with ``draft``,
        by the draft (JAX's ``_run_draft_prefill``)."""
        model, dtype = (self._draft_model, self._ddtype) if draft \
            else (self.model, self._dtype)
        key = ("dprefill" if draft else "prefill", ids.shape)
        prog = self._tracked(
            key, lambda count: build_prefill(
                model, self.max_len, self._dev(ids), self._dev(lengths),
                dtype),
            "draft_prefill" if draft else "decode_prefill",
            self._sig(model, ids=ids, lengths=lengths))
        return prog(torch.from_numpy(ids), torch.from_numpy(lengths))

    def _run_write(self, pcache, row: int, slot: int, src: tuple,
                   draft: bool = False):
        """Row ``row`` of ``pcache`` into grid slot ``slot`` (with
        ``draft``, of the draft's dense cache: JAX's ``_run_draft_write``):
        one write program per program ``src`` that makes such caches (a
        prefill bucket, or a chunk program's staging cache), built on
        that program's output, which each call then reads in place."""
        rs = (np.array([row], np.int32), np.array([slot], np.int32))
        key = ("write",) + src
        sig = self._sig(None, cache=self._dcache if draft else self._cache,
                        prefill_cache=pcache, static={
                            "batch": src[1][0] if len(src) > 1 else 1,
                            "layout": "dense" if draft else self.kv_layout})
        name = "draft_write_slot" if draft else "decode_write_slot"
        if draft:
            prog = self._tracked(key, lambda count: build_write_slot(
                self._dcache, pcache, *map(self._dev, rs)), name, sig)
            self._dcache = prog(self._dcache, pcache,
                                *map(torch.from_numpy, rs))
        elif self.paged:
            table_row = self._alloc.table[slot]
            prog = self._tracked(key, lambda count: build_paged_write_slot(
                self._cache, self._dev(table_row), pcache,
                *map(self._dev, rs)), name, sig)
            self._cache = prog(self._cache, torch.from_numpy(table_row),
                               pcache, *map(torch.from_numpy, rs))
        else:
            prog = self._tracked(key, lambda count: build_write_slot(
                self._cache, pcache, *map(self._dev, rs)), name, sig)
            self._cache = prog(self._cache, pcache,
                               *map(torch.from_numpy, rs))

    def _run_page_reset(self, pages):
        """Zero freed physical pages; the id vector has a fixed length,
        padded with the trash page 0."""
        arr = np.zeros((self._alloc.pages_per_slot,), np.int32)
        ids = np.asarray(pages, np.int32)[:arr.size]
        arr[:ids.size] = ids
        prog = self._tracked(
            ("page_reset",), lambda count: build_page_reset(
                self._cache, self._dev(arr)),
            "page_reset", self._sig(None, cache=self._cache, pages=arr))
        self._cache = prog(self._cache, torch.from_numpy(arr))

    def _staging(self, draft: bool = False):
        """A fresh batch-1 staging cache for a chunked prefill."""
        if draft:
            return self._draft_model.init_cache(1, self.max_len,
                                                self._ddtype)
        return self.model.init_cache(1, self.max_len, self._dtype)

    def _run_chunk(self, staging, ids: np.ndarray, adv: np.ndarray,
                   draft: bool = False):
        """One prompt chunk into the batch-1 ``staging`` cache of the big
        model or, with ``draft``, of the draft (JAX's
        ``_run_draft_chunk``): the last valid position's logits on the
        host, and the staging cache."""
        model = self._draft_model if draft else self.model
        prog = self._tracked(
            ("dchunk" if draft else "chunk",), lambda count:
            build_prefill_chunk(model, staging, self._dev(ids),
                                self._dev(adv)),
            "draft_prefill_chunk" if draft else "decode_prefill_chunk",
            self._sig(model, cache=staging, ids=ids, advance=adv))
        last, staging = prog(staging, torch.from_numpy(ids),
                             torch.from_numpy(adv))
        return last.float().cpu(), staging

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               deadline_ms: Optional[float] = None, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0,
               seed: Optional[int] = None) -> ServingFuture:
        """Queue one prompt (1-D ints, at least one); returns a future
        resolving to the generated token ids (1-D ``int32``, the EOS
        included when hit).  ``temperature > 0`` samples inside the tick
        (``top_k``/``top_p`` filter; ``seed``, by default the request's
        id, makes the stream reproducible); ``temperature == 0`` is exact
        greedy (and the only mode of a speculating engine).  Raises
        :class:`QueueFullError` when the bounded queue is full,
        :class:`EngineClosedError` after ``close()``, ``ValueError``
        when the request samples on a speculating engine or cannot fit
        the cache (with ``draft_k`` slack when speculating) and
        ``OutOfPagesError`` when it cannot fit an empty page pool."""
        if self._closed:
            raise EngineClosedError("submit on a closed decode engine")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt: cached decode needs at "
                             "least one prompt token to prefill")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        temperature, top_k, top_p = float(temperature), int(top_k), \
            float(top_p)
        if temperature > 0.0 and self._spec:
            raise ValueError(
                "speculative decoding is greedy-only: the verify pass "
                "accepts draft tokens by argmax match, which sampling "
                "would break")
        if temperature > 0.0 and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # a speculative round writes up to draft_k tokens past the last
        # emitted position before it rolls back: reserve them
        slack = self.draft_k
        worst = int(prompt.size) + max_new_tokens - 1 + slack
        if worst > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) - 1"
                + (f" + draft_k ({slack})" if slack else "")
                + f" exceeds the cache max_len ({self.max_len})")
        if self.paged:
            pages = min(-(-worst // self.page_size),
                        self._alloc.pages_per_slot)
            if pages > self.num_pages - 1:
                raise paging.OutOfPagesError(
                    f"request needs {pages} pages at its longest but "
                    f"the pool only has {self.num_pages - 1} usable "
                    f"pages of {self.page_size} tokens")
        fut = ServingFuture()
        now = time.perf_counter()
        dl = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        rid = next(self._rids)
        req = _DecodeRequest(prompt, max_new_tokens, fut, now,
                             now + dl / 1e3 if dl is not None else None,
                             rid=rid, temp=temperature, top_k=top_k,
                             top_p=top_p,
                             key=_key_for_seed(rid if seed is None
                                               else seed))
        try:
            self._rq.put_nowait(req)
        except queue.Full:
            self.metrics.inc_rejected()
            self._tracer.instant("queue_full", CAT_DECODE, corr=f"req:{rid}",
                                 args={"max_queue": self._rq.maxsize})
            raise QueueFullError(
                f"decode queue full ({self._rq.maxsize}); retry later"
            ) from None
        self._tracer.instant("enqueue", CAT_DECODE, corr=f"req:{rid}",
                             args={"prompt_len": int(prompt.size),
                                   "max_new": max_new_tokens})
        self.xray.open(rid, now=now)
        rec = workload.recorder()
        if rec is not None:
            # the resolved seed, so that the stream replays the same tokens
            rec.record_decode(rid, prompt, max_new_tokens,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p,
                              seed=rid if seed is None else int(seed),
                              deadline_ms=dl)
        return fut

    def generate(self, prompt, max_new_tokens: int,
                 deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = None, **sampling) -> np.ndarray:
        """Submit one prompt and wait for its generated tokens;
        ``**sampling`` forwards ``temperature``/``top_k``/``top_p``/
        ``seed`` to :meth:`submit`."""
        return self.submit(prompt, max_new_tokens, deadline_ms=deadline_ms,
                           **sampling).result(timeout)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        if not self._started:
            self._started = True
            self._loop_thread.start()
            self._periodic.start()
            # the live plane: host-side registration only (see
            # ServingEngine.start)
            self._detach_debug = debug_server.attach_engine(
                "decode", role="decode", metrics=lambda: self.metrics,
                status=lambda: {"queue_depth": self._rq.qsize(),
                                "xray": self.xray.summary(),
                                "exemplars": self.exemplars.summary()},
                exemplars=lambda: self.exemplars)
            flight = flightrecorder.get_flight_recorder()
            if flight is not None:
                flight.add_metrics("decode", lambda: self.metrics)
                flight.add_blob("exemplars-decode", self.exemplars.as_blob)
            # the KV cache as an HBM ledger resident: a paged engine's
            # pages in use (retirement shows as memory returned), a dense
            # engine's fixed reservation
            ledger = programs.get_hbm_ledger()
            if self.paged:
                per_page = self._page_bytes_total()
                self._resident_name = "decode_kv_pages"
                ledger.add_resident(
                    self._resident_name,
                    lambda: self._alloc.pages_in_use * per_page)
            else:
                total = self._cache_bytes_total()
                self._resident_name = "decode_kv_cache"
                ledger.add_resident(self._resident_name, lambda: total)

    def close(self, drain: bool = True, timeout: float = 60.0):
        """Stop accepting requests and shut down.  ``drain=True`` decodes
        everything queued or in flight to its end first; ``drain=False``
        fails undelivered requests with :class:`EngineClosedError`.
        Waits at most ``timeout`` seconds for the loop.  Idempotent."""
        with self._close_lock:
            already, self._closed = self._closed, True
        if already:
            return
        detach = getattr(self, "_detach_debug", None)
        if detach is not None:
            detach()
        if self._resident_name is not None:
            programs.get_hbm_ledger().remove_resident(self._resident_name)
        self._periodic.close()
        self._discard = not drain
        if not self._started:
            self._fail_queued(EngineClosedError(
                "decode engine closed before start"))
            return
        self._rq.put(_CLOSE)
        self._loop_thread.join(timeout)

    def _fail_queued(self, exc: BaseException):
        while True:
            try:
                req = self._rq.get_nowait()
            except queue.Empty:
                break
            if req is not _CLOSE:
                self.xray.drop(req.rid)
                req.fut.set_exception(exc)
        for q in (self._pending, self._chunk_pending):
            while q:
                req = q.popleft()
                self.xray.drop(req.rid)
                req.fut.set_exception(exc)
        if self._chunking is not None:
            self.xray.drop(self._chunking["req"].rid)
            self._chunking["req"].fut.set_exception(exc)
            self._chunking = None

    def _fail_slots(self, exc: BaseException):
        """Fail every occupied slot's request, then free the slots with
        no program run (freed pages are not zeroed), so that a device
        fault cannot leave a request waiting."""
        held = [s for s in range(self.slots)
                if self._slot_state[s] is not None]
        for s in held:
            self.xray.drop(self._slot_state[s].req.rid)
            self._slot_state[s].req.fut.set_exception(exc)
        for s in held:
            self._free(s, zero_pages=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # engine loop: admit (prefill into free slots), then tick the grid
    # ------------------------------------------------------------------
    def _idle(self) -> bool:
        return (not self._active.any() and not self._pending
                and self._chunking is None and not self._chunk_pending
                and all(st is None for st in self._slot_state))

    def _loop(self):
        try:
            self._serve()
        except Exception as e:  # a fault fails every request, not hangs
            logger.exception("decode loop failed")
            self._closed = True
            self._periodic.close()
            with self._lock:
                self._fail_queued(e)
                self._fail_slots(e)

    def _serve(self):
        stopping = False
        while True:
            stopping = self._drain_queue(block=self._idle(),
                                         stopping=stopping)
            with self._lock:
                if stopping and self._discard:
                    exc = EngineClosedError("decode engine closed")
                    self._fail_queued(exc)
                    self._fail_slots(exc)
                    return
                self._admit()
                self._chunk_step()
                if self.paged:
                    # fund (and resume) occupied slots before the tick
                    self._budget_pages()
                if not self._active.any():
                    if stopping and self._idle():
                        return
                    continue
                # the tick's spans on this thread carry its index
                self._tick_no += 1
                if self._tracer.enabled:
                    set_correlation(f"tick:{self._tick_no}")
                t0 = time.perf_counter()
                if self._spec:
                    # the propose and verify round is the spec_verify
                    # phase; the gaps between rounds stay resident
                    spec_rids = [st.req.rid for s, st in
                                 enumerate(self._slot_state)
                                 if st is not None and self._active[s]] \
                        if self.xray.enabled else ()
                    self.xray.to_many(spec_rids, request_xray.PHASE_SPEC,
                                      now=t0)
                    emitted, n_emit = self._run_verify(self._run_propose())
                    self.xray.to_many(spec_rids,
                                      request_xray.PHASE_RESIDENT)
                else:
                    emitted = self._run_tick()[:, None]
                    n_emit = self._active.astype(np.int32)
                self.metrics.record_tick(time.perf_counter() - t0)
                if self._tick_cost is not None:
                    self.metrics.record_compute(
                        self._tick_cost.flops,
                        self._tick_cost.bytes_accessed)
                n_active = int(self._active.sum())
                self.metrics.record_slot_occupancy(n_active / self.slots)
                if self._spec:
                    # the bonus token is the big model's own, not a draft's
                    self.metrics.record_spec(
                        self.draft_k * n_active,
                        int(n_emit[self._active].sum()) - n_active)
                self.metrics.record_decode_tokens(
                    self._retire(emitted, n_emit))

    def _drain_queue(self, block: bool, stopping: bool) -> bool:
        """Move queued requests into the admission deque; ``block`` waits
        briefly when the engine is otherwise idle."""
        while True:
            try:
                req = self._rq.get(timeout=0.005) if block \
                    else self._rq.get_nowait()
            except queue.Empty:
                return stopping
            block = False
            if req is _CLOSE:
                stopping = True
                continue
            self._pending.append(req)

    def _free_slots(self) -> List[int]:
        reserved = self._chunking["slot"] if self._chunking else -1
        return [s for s in range(self.slots)
                if not self._active[s] and self._slot_state[s] is None
                and s != reserved]

    def _expire(self, req: _DecodeRequest, now: float, what: str) -> bool:
        """Fail ``req`` if its deadline passed before ``what``."""
        if req.deadline is None or now <= req.deadline:
            return False
        self.metrics.inc_expired()
        self._tracer.instant("deadline_reject", CAT_DECODE,
                             corr=f"req:{req.rid}")
        req.fut.set_exception(DeadlineExceededError(
            f"deadline expired {1e3 * (now - req.deadline):.1f}ms before "
            f"{what}", attribution=self.xray.close(req.rid, now=now)))
        return True

    def _admit(self):
        if self.prefill_chunk:
            # prompts longer than the largest declared bucket take the
            # chunked path instead of learning a one-off bucket
            keep: "collections.deque[_DecodeRequest]" = collections.deque()
            while self._pending:
                r = self._pending.popleft()
                (self._chunk_pending if r.prompt.size > self._largest_bucket
                 else keep).append(r)
            self._pending = keep
        free = self._free_slots()
        if not self._pending or not free:
            return
        if not self.continuous and len(free) < self.slots:
            # static batching: wait for the whole grid to drain
            return
        now = time.perf_counter()
        taken: List[_DecodeRequest] = []
        while self._pending and len(taken) < len(free):
            req = self._pending.popleft()
            if not self._expire(req, now, "prefill"):
                taken.append(req)
        if self.paged and taken:
            # admission never evicts (an evicted request re-queues and
            # could evict its evictor back): a prompt that does not fit
            # the free list waits for retirements
            fits: List[_DecodeRequest] = []
            free_pages = self._alloc.pages_free
            for i, req in enumerate(taken):
                need = min(-(-(int(req.prompt.size) + self._page_slack())
                             // self.page_size),
                           self._alloc.pages_per_slot)
                if need > free_pages:
                    self._pending.extendleft(reversed(taken[i:]))
                    break
                free_pages -= need
                fits.append(req)
            taken = fits
        groups: dict = {}
        for r in taken:
            dims, _ = self.grid.choose_dims(r.prompt.shape)
            groups.setdefault(dims, []).append(r)
        free_iter = iter(free)
        for dims, rs in groups.items():
            for lo in range(0, len(rs), self.grid.max_batch):
                chunk = rs[lo:lo + self.grid.max_batch]
                t0 = time.perf_counter()
                self.xray.to_many((r.rid for r in chunk),
                                  request_xray.PHASE_PREFILL, now=t0)
                try:
                    self._prefill_batch(chunk, dims, free_iter)
                except Exception as e:  # per-request delivery
                    for r in chunk:
                        if not r.fut.done():
                            self.xray.drop(r.rid)
                            r.fut.set_exception(e)
                    continue
                self.metrics.record_prefill(time.perf_counter() - t0)

    def _prefill_batch(self, chunk: List[_DecodeRequest], dims, free_iter):
        b = self.grid.choose_batch(len(chunk))
        ids = self.grid.pad_batch([r.prompt for r in chunk], dims, b,
                                  np.int32)
        lengths = np.ones((b,), np.int32)
        lengths[:len(chunk)] = [r.prompt.size for r in chunk]
        logits, pcache = self._run_prefill(ids, lengths)
        logits = logits.float().cpu()
        caches = {False: pcache}
        if self._spec:
            caches[True] = self._run_prefill(ids, lengths, draft=True)[1]
        for i, r in enumerate(chunk):
            self.xray.to(r.rid, request_xray.PHASE_SAMPLE)
            tok0 = _host_sample(logits[i], r)
            if self._done_at_first(r, tok0):
                continue
            slot = next(free_iter)
            if self.paged and not self._alloc.ensure(
                    slot, int(r.prompt.size) + self._page_slack()):
                # admission reserved these pages; losing them is
                # unexpected but recoverable: wait, do not evict
                self.xray.to(r.rid, request_xray.PHASE_PAGE_STALL)
                self._pending.appendleft(r)
                continue
            if self.paged:
                self.metrics.record_pages(self._alloc.pages_in_use)
            for draft, pcache in caches.items():
                self._run_write(pcache, i, slot, (
                    "dprefill" if draft else "prefill", ids.shape), draft)
            self._activate(slot, r, tok0)

    def _done_at_first(self, req: _DecodeRequest, tok0: int) -> bool:
        """Deliver ``req`` at its first token when that is an EOS or its
        whole budget."""
        eos = self.eos_id is not None and tok0 == self.eos_id
        if eos or req.max_new <= 1:
            self._finish(req, [tok0], "eos" if eos else "length")
            return True
        return False

    def _activate(self, slot: int, req: _DecodeRequest, tok0: int):
        """Bind a prefilled request to its slot: the token fed to the
        next tick, its sampling state and the host's length."""
        self._tokens[slot] = tok0
        self._active[slot] = True
        self._slot_state[slot] = _Slot(req, tok0)
        self._host_len[slot] = int(req.prompt.size)
        self._keys[slot] = split_rng(req.key, 0)
        self._temps[slot] = req.temp
        self._topks[slot] = req.top_k
        self._topps[slot] = req.top_p
        self._tracer.instant("slot_fill", CAT_DECODE, corr=f"req:{req.rid}",
                             args={"slot": slot})
        self.xray.to(req.rid, request_xray.PHASE_RESIDENT)

    # ------------------------------------------------------------------
    # chunked prefill: one chunk per loop iteration, so a long prompt
    # never stalls the occupied slots between ticks
    # ------------------------------------------------------------------
    def _chunk_step(self):
        if not self.prefill_chunk:
            return
        if self._chunking is None and self._chunk_pending:
            free = self._free_slots()
            if free:
                req = self._chunk_pending.popleft()
                now = time.perf_counter()
                if self._expire(req, now, "prefill"):
                    return
                self.xray.to(req.rid, request_xray.PHASE_PREFILL, now=now)
                self._chunking = {
                    "req": req, "slot": free[0], "offset": 0,
                    "staging": {d: self._staging(d) for d in self._sides()}}
        c = self._chunking
        if c is None:
            return
        if "tok0" in c:
            # prefilled, but the page pool was full: retry as ticks
            # retire slots and free pages
            self._finalize_chunk(c)
            return
        req = c["req"]
        now = time.perf_counter()
        if self._expire(req, now, f"the rest of its chunked prefill "
                        f"({c['offset']}/{req.prompt.size} tokens in)"):
            self._chunking = None  # nothing reached the grid cache yet
            return
        size, lo = self.prefill_chunk, c["offset"]
        hi = min(lo + size, int(req.prompt.size))
        ids = np.zeros((1, size), np.int32)
        ids[0, :hi - lo] = req.prompt[lo:hi]
        adv = np.array([hi - lo], np.int32)
        staging = c["staging"]
        last, staging[False] = self._run_chunk(staging[False], ids, adv)
        if self._spec:
            staging[True] = self._run_chunk(staging[True], ids, adv,
                                            draft=True)[1]
        self.metrics.inc_prefill_chunks()
        self.xray.note(req.rid, "prefill_chunks")
        self.metrics.record_prefill(time.perf_counter() - now)
        self._tracer.instant("prefill_chunk", CAT_DECODE,
                             corr=f"req:{req.rid}", args={"lo": lo, "hi": hi})
        c["offset"] = hi
        if hi < req.prompt.size:
            return  # more chunks on later loop iterations
        self.xray.to(req.rid, request_xray.PHASE_SAMPLE)
        tok0 = _host_sample(last[0], req)
        if self._done_at_first(req, tok0):
            self._chunking = None
            return
        c["tok0"] = tok0
        self._finalize_chunk(c)

    def _finalize_chunk(self, c: dict):
        """Splice a chunk-prefilled request into its reserved slot,
        deferred while the page pool is full (admission never evicts)."""
        req, slot = c["req"], c["slot"]
        if self.paged:
            if not self._alloc.ensure(
                    slot, int(req.prompt.size) + self._page_slack()):
                self.xray.to(req.rid, request_xray.PHASE_PAGE_STALL)
                return  # retry next loop iteration
            self.metrics.record_pages(self._alloc.pages_in_use)
        self._chunking = None
        for draft, staging in c["staging"].items():
            self._run_write(staging, 0, slot,
                            ("dchunk" if draft else "chunk",), draft)
        self._activate(slot, req, c["tok0"])

    # ------------------------------------------------------------------
    # page budgeting
    # ------------------------------------------------------------------
    def _page_slack(self) -> int:
        """Tokens a slot may write past its valid length in one round,
        which page budgeting funds ahead: the tick's token, and a
        speculative round's draft_k more."""
        return 1 + self.draft_k

    def _budget_pages(self):
        """Before each tick, fund every occupied slot with pages for the
        tokens this tick writes, oldest request first.  A slot the free
        list cannot fund evicts strictly younger requests (they re-queue
        and decode again to the same tokens); with no younger donor it
        is paused, keeping its pages and tokens, until retirements free
        pages.  ``submit`` lets in only requests that fit an empty pool,
        so the oldest slot is always funded: no livelock."""
        order = sorted((s for s in range(self.slots)
                        if self._slot_state[s] is not None),
                       key=lambda s: self._slot_state[s].req.rid)
        for s in order:
            if self._slot_state[s] is None:
                continue  # evicted by an older slot this round
            need = int(self._host_len[s]) + self._page_slack()
            funded = self._ensure_pages(s, need)
            rid = self._slot_state[s].req.rid
            if funded and not self._active[s]:
                # a paused slot resumes: its page stall ends here
                self.xray.to(rid, request_xray.PHASE_RESIDENT)
            elif not funded and self._active[s]:
                self._tracer.instant("page_pause", CAT_DECODE,
                                     args={"slot": s})
                self.xray.to(rid, request_xray.PHASE_PAGE_STALL)
                self.xray.note(rid, "page_pauses")
            self._active[s] = funded

    def _ensure_pages(self, slot: int, tokens: int) -> bool:
        """Grow ``slot`` to cover ``tokens``, evicting the youngest
        occupied slot younger than this one while the free list runs
        short.  False when no such donor is left."""
        me = self._slot_state[slot].req.rid
        while not self._alloc.ensure(slot, tokens):
            victim, rid = None, me
            for s in range(self.slots):
                st = self._slot_state[s]
                if s != slot and st is not None and st.req.rid > rid:
                    victim, rid = s, st.req.rid
            if victim is None:
                return False
            self._evict(victim)
        self.metrics.record_pages(self._alloc.pages_in_use)
        return True

    def _evict(self, victim: int):
        """Free ``victim``'s pages and re-queue its request at the front:
        greedy and seeded decoding restart to the same tokens, so an
        eviction costs time, not output."""
        self.metrics.inc_page_evictions()
        self._tracer.instant("page_evict", CAT_DECODE,
                             args={"slot": victim,
                                   "pages": self._alloc.owned(victim)})
        req = self._slot_state[victim].req
        # the whole wait to run again is charged to the eviction
        self.xray.to(req.rid, request_xray.PHASE_PAGE_STALL)
        self.xray.note(req.rid, "page_evictions")
        self._pending.appendleft(req)
        self._free(victim)

    # ------------------------------------------------------------------
    # bytes, retirement
    # ------------------------------------------------------------------
    def _page_bytes_total(self) -> int:
        """Bytes one physical page takes across every layer's pool (K, V
        and, int8, their scales)."""
        return sum(leaf[0].numel() * leaf.element_size()
                   for pool in self._cache.values()
                   for name, leaf in pool.items() if name != "length")

    def _cache_bytes_total(self) -> int:
        """Bytes of the whole cache: the dense grid's fixed reservation,
        or the whole page pool."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in graphs.leaves(self._cache))

    def _retire(self, emitted: np.ndarray, n_emit: np.ndarray) -> int:
        """Take each active slot's ``n_emit[s]`` tokens of ``emitted``
        (S, n) (a tick emits one, a speculative round up to draft_k + 1):
        the slot's next input is the last, its valid length grows by as
        many, and its request retires at an EOS, at its budget (the
        tokens past either are dropped) or past its deadline.  Returns
        the tokens delivered."""
        now = time.perf_counter()
        delivered = 0
        for s in range(self.slots):
            if not self._active[s]:
                continue
            n = int(n_emit[s])
            self._host_len[s] += n
            self._tokens[s] = emitted[s, n - 1]
            st = self._slot_state[s]
            req = st.req
            self.xray.note(req.rid, "spec_rounds" if self._spec else "ticks")
            reason = None
            for tok in emitted[s, :n]:
                st.generated.append(int(tok))
                delivered += 1
                if self.eos_id is not None and int(tok) == self.eos_id:
                    reason = "eos"
                elif len(st.generated) >= req.max_new:
                    reason = "length"
                if reason:
                    break
            if reason is None and req.deadline is not None \
                    and now > req.deadline:
                # decoding has started: truncate, do not fail
                reason = "deadline"
            if reason is None:
                continue
            self._finish(req, st.generated, reason)
            self._free(s)
        return delivered

    def _finish(self, req: _DecodeRequest, tokens: List[int], reason: str):
        self.xray.to(req.rid, request_xray.PHASE_DELIVER)
        self.metrics.inc_finished(reason)
        self.metrics.inc_completed()
        self.metrics.record_latency(time.perf_counter() - req.t_submit)
        self._tracer.instant("deliver", CAT_DECODE, corr=f"req:{req.rid}",
                             args={"reason": reason, "tokens": len(tokens)})
        req.fut.set_result(np.asarray(tokens, np.int32))
        self.exemplars.offer(self.xray.close(req.rid))

    def _free(self, slot: int, zero_pages: bool = True):
        self._active[slot] = False
        self._slot_state[slot] = None
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._topps[slot] = 1.0
        self._host_len[slot] = 0
        if self.paged:
            freed = self._alloc.release(slot)
            if freed and self._page_zero and zero_pages:
                self._run_page_reset(freed)
            self.metrics.record_pages(self._alloc.pages_in_use)
        self._tracer.instant("slot_free", CAT_DECODE, args={"slot": slot})

    def log_line(self) -> str:
        line = self.metrics.log_line()
        if self.xray.enabled:
            line = f"{line} | {self.xray.log_line()}"
        return line
