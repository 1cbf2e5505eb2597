"""Speculative decoding in the port (bigdl_tpu_torch/serving/decode.py)
against the JAX package's (bigdl_tpu/serving/decode.py:377-468, 735-795,
1066-1144, 1730-1788), on the CPU.

The LM is tools/kernel_shapes.py's DECODE_MODEL, its draft
DECODE_DRAFT_MODEL (one layer), both with JAX trees redrawn with numpy
(f32, as tests/test_torch_decode_engine.py draws them, the embedding
10x smaller so that the draft is accepted only in part) and carried into
the port by ``load_jax_variables``.  The engines run at the JAX tests'
sizes (2 slots, prompt buckets (4, 8), prefill batches (1, 2);
tests/test_decode.py:545-590).

- Programs: ``draft_propose_fn`` and ``spec_verify_fn`` (dense and paged)
  on caches both packages filled the same way: proposals, emitted
  tokens, ``n_emit`` and lengths equal; cache leaves below each row's
  length within 1e-5 (f32 sum order).  The verify's drafts mix a fully
  accepted row, a row rejected at its second token and an inactive row.
- Engines: greedy tokens equal to the JAX speculative engine's, dense at
  ``draft_k`` 3 and paged (pages of 4, so a window crosses a page) and
  chunked at ``draft_k`` 3; equal to the port's greedy engine without a
  draft for a self-draft (acceptance 1.0) and a draft that is always
  wrong (acceptance 0); captures equal ``declared_programs()`` after
  warmup and stay so while serving.
- Validation, the metrics' speculative counters against JAX's
  ``ServingMetrics``, and ``decode_program_check``.

Every future waits with a timeout and every engine closes in a
``finally``, so a fault fails a test instead of hanging the suite.
"""
import contextlib
import math
import runpy
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving import decode as jdec
from bigdl_tpu.serving.metrics import ServingMetrics as JaxServingMetrics
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.serving import (DecodeEngine, PageAllocator,
                                     ServingMetrics, decode_program_check,
                                     draft_k_default)
from bigdl_tpu_torch.serving import decode as tdec
from bigdl_tpu_torch.utils import load_jax_variables

SHAPES = runpy.run_path(str(Path(__file__).resolve().parents[1] / "tools"
                            / "kernel_shapes.py"))
LM, DRAFT = SHAPES["DECODE_MODEL"], SHAPES["DECODE_DRAFT_MODEL"]
VOCAB = LM["vocab_size"]
WAIT = 60  # seconds: every future's and every close's bound
TOL = dict(rtol=1e-5, atol=1e-5)

BASE = dict(slots=2, max_len=48, prompt_buckets=(4, 8),
            prefill_batch_sizes=(1, 2), eos_id=None)
# (prompt length, new tokens) per request; 19 and 21 pass the largest
# bucket (8) and take the chunked path where it is on
TRAFFIC = [(3, 9), (6, 5), (8, 7), (5, 11), (19, 8), (21, 6)]
LAYOUTS = {
    "dense": dict(draft_k=3, prefill_chunk=8),
    "paged_chunked": dict(draft_k=3, kv_layout="paged", page_size=4,
                          prefill_chunk=8),
}


def _variables(jm, seed):
    """A numpy draw of ``jm``'s tree.  The embedding is drawn 10x smaller
    than the other matrices: at full scale the weight-tied head repeats
    each row's last token, and any draft is accepted."""
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(seed)

    def fill(path, a):
        if a.ndim == 2:
            scale = 0.1 if any(getattr(p, "key", "") == "embed"
                               for p in path) else 1.0
            return (scale * rs.randn(*a.shape) / math.sqrt(a.shape[0])
                    ).astype(np.float32)
        if getattr(path[-1], "key", "") == "weight":
            return (1.0 + 0.1 * rs.randn(*a.shape)).astype(np.float32)
        return (0.1 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _pair(cfg, seed):
    """(JAX model, its numpy tree, the port's model with that tree)."""
    jm = jnn.Transformer(**cfg)
    v = _variables(jm, seed)
    tm = tnn.Transformer(**cfg)
    load_jax_variables(tm, v)
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def lms():
    return _pair(LM, 0), _pair(DRAFT, 1)


class _AlwaysWrong(torch.nn.Module):
    """A draft whose every proposal is the model's argmax + 1 (its logits
    rolled by one along the vocabulary): never the big model's token."""

    def __init__(self, model):
        super().__init__()
        self.m = model
        self.embed = model.embed

    def init_cache(self, *a, **kw):
        return self.m.init_cache(*a, **kw)

    def prefill(self, *a, **kw):
        logits, cache = self.m.prefill(*a, **kw)
        return logits.roll(1, -1), cache

    def decode_step(self, *a):
        logits, cache = self.m.decode_step(*a)
        return logits.roll(1, -1), cache

    def extend(self, *a, **kw):
        logits, cache = self.m.extend(*a, **kw)
        return logits.roll(1, -1), cache


def _prompts(seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (t,)), n) for t, n in TRAFFIC]


@contextlib.contextmanager
def _serving(model, **kw):
    eng = DecodeEngine(model, **{**BASE, "device": "cpu", **kw})
    try:
        yield eng
    except BaseException:
        eng.close(timeout=WAIT)
        raise
    eng.close(timeout=WAIT)
    assert not eng._loop_thread.is_alive()


def _serve(eng, reqs):
    """Tokens per request; ``recompiles`` must equal the declared
    programs before and after."""
    assert eng.recompiles == eng.declared_programs()
    futs = [eng.submit(p, n) for p, n in reqs]
    out = [[int(t) for t in f.result(WAIT)] for f in futs]
    assert eng.recompiles == eng.declared_programs()
    return out


@pytest.fixture(scope="module")
def greedy(lms):
    """The port's greedy tokens without a draft (chunked, so no bucket is
    learned)."""
    (_, _, tm), _ = lms
    with _serving(tm, prefill_chunk=8) as eng:
        return _serve(eng, _prompts())


# ---------------------------------------------------------------- programs
def _grid(jm, v, tm, ids, lengths, paged, page=4):
    """The same grid state in both packages: prompts ``ids`` (S, T) with
    true ``lengths`` appended to empty caches (paged: through a block
    table funding ``max_len`` tokens a slot).  Returns (JAX cache, port
    cache, table as numpy or None)."""
    s, max_len = ids.shape[0], 24
    adv = lengths.astype(np.int32)
    if not paged:
        jc = jm.init_cache(s, max_len, jnp.float32)
        _, jc = jm.extend(v["params"], v["state"], jc, jnp.asarray(ids),
                          advance=jnp.asarray(adv))
        _, tc = tm.extend(tm.init_cache(s, max_len), torch.from_numpy(ids),
                          advance=torch.from_numpy(adv))
        return jc, tc, None
    pages = s * max_len // page + 1
    alloc = PageAllocator(pages, page, s, max_len)
    for i in range(s):
        alloc.ensure(i, max_len)
    table = alloc.table.copy()
    act = np.ones((s,), bool)
    jc = jm.init_paged_cache(pages, page, s, jnp.float32)
    _, jc = jm.extend_paged(v["params"], v["state"], jc, jnp.asarray(table),
                            jnp.asarray(ids), jnp.asarray(act),
                            advance=jnp.asarray(adv))
    _, tc = tm.extend_paged(tm.init_paged_cache(pages, page, s),
                            torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(act),
                            advance=torch.from_numpy(adv))
    return jc, tc, table


def _rows(cache, table, lengths):
    """Per layer, leaf and row: the K/V at positions below the row's
    length (read through the block table when paged)."""
    out = {}
    for lk, c in cache.items():
        for name in ("k", "v"):
            leaf = np.asarray(c[name])
            for r, n in enumerate(lengths):
                if table is None:  # dense (S, H, T, D)
                    got = leaf[r, :, :n]
                else:  # pool (pages, page, H, D)
                    pos = np.arange(n)
                    page = leaf.shape[1]
                    got = leaf[table[r, pos // page], pos % page]
                out[(lk, name, r)] = got
    return out


def _same_caches(jc, tc, table, lengths):
    want = _rows(jax.tree_util.tree_map(np.asarray, jc), table, lengths)
    got = _rows({lk: {k: t.numpy() for k, t in c.items()}
                 for lk, c in tc.items()}, table, lengths)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, err_msg=str(key), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_propose_and_verify_equal_jax(lms, paged):
    (jm, v, tm), (jd, dv, td) = lms
    k = 3
    rs = np.random.RandomState(5)
    lengths = np.array([5, 7, 3], np.int32)
    ids = rs.randint(0, VOCAB, (3, 8)).astype(np.int32)
    tokens = rs.randint(0, VOCAB, (3,)).astype(np.int32)
    active = np.array([True, True, False])
    jt, ja = jnp.asarray(tokens), jnp.asarray(active)
    tt, ta = torch.from_numpy(tokens), torch.from_numpy(active)

    # the draft's proposals from its own (dense) cache
    jdc, tdc, _ = _grid(jd, dv, td, ids, lengths, paged=False)
    jdc, jprops = jdec.draft_propose_fn(jd, k)(
        dv["params"], dv["state"], jdc, jt, jnp.asarray(lengths), ja)
    tdc, tprops = tdec.draft_propose_fn(td, k)(
        tdc, tt, torch.from_numpy(lengths), ta)
    np.testing.assert_array_equal(tprops.numpy(), np.asarray(jprops))
    assert tprops.shape == (3, k)
    # active rows took in k + 1 positions (the extra step's the last
    # proposal), inactive rows kept the host's length
    for lk, c in tdc.items():
        np.testing.assert_array_equal(c["length"].numpy(),
                                      lengths + (k + 1) * active)
        np.testing.assert_array_equal(c["length"].numpy(),
                                      np.asarray(jdc[lk]["length"]))
    _same_caches(jdc, tdc, None, lengths + (k + 1) * active)

    # drafts: row 0 the big model's own greedy tokens (all accepted), row
    # 1 the same with its second token wrong, row 2 inactive
    jc0, _, _ = _grid(jm, v, tm, ids, lengths, paged=False)
    _, greedy = jdec.draft_propose_fn(jm, k)(v["params"], v["state"], jc0,
                                             jt, jnp.asarray(lengths), ja)
    draft = np.array(greedy)
    draft[1, 1] = (draft[1, 1] + 1) % VOCAB
    jc, tc, table = _grid(jm, v, tm, ids, lengths, paged)
    jargs, targs = (jt, jnp.asarray(draft), ja), (tt, torch.from_numpy(draft),
                                                  ta)
    if paged:
        jargs = (jnp.asarray(table),) + jargs
        targs = (torch.from_numpy(table),) + targs
    jc, jem, jn = jdec.spec_verify_fn(jm, k, paged)(v["params"], v["state"],
                                                    jc, *jargs)
    tc, tem, tn = tdec.spec_verify_fn(tm, k, paged)(tc, *targs)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    assert tn.tolist() == [k + 1, 2, 0]
    new_len = lengths + tn.numpy()
    for c in tc.values():
        np.testing.assert_array_equal(c["length"].numpy(), new_len)
    _same_caches(jc, tc, table, new_len)


# ----------------------------------------------------------------- engines
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_tokens_equal_the_jax_speculative_engine(lms, greedy, layout):
    (jm, v, tm), (jd, dv, td) = lms
    kw = LAYOUTS[layout]
    eng = JaxDecodeEngine(jm, v, draft=(jd, dv), **{**BASE, **kw})
    try:
        want = _serve(eng, _prompts())
    finally:
        eng.close(timeout=WAIT)
    with _serving(tm, draft=(td, None), **kw) as eng:
        got = _serve(eng, _prompts())
        # the draft is right in part: rounds accept and reject
        assert 0.0 < eng.metrics.spec_acceptance_rate() < 1.0
        assert eng.metrics.prefill_chunks >= 3
        if eng.paged:
            assert eng._alloc.pages_in_use == 0
    assert got == want
    assert got == greedy


@pytest.mark.parametrize("which", ["self", "always_wrong"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_self_and_always_wrong_drafts_give_the_greedy_tokens(
        lms, greedy, which, layout):
    (_, _, tm), _ = lms
    draft = tm if which == "self" else _AlwaysWrong(tm)
    with _serving(tm, draft=(draft, None), **LAYOUTS[layout]) as eng:
        got = _serve(eng, _prompts())
        rate = eng.metrics.spec_acceptance_rate()
        assert "spec acc=" in eng.log_line() or rate == 0.0
    assert got == greedy
    assert rate == (1.0 if which == "self" else 0.0)


def test_declared_programs_and_page_slack(lms):
    (_, _, tm), (_, _, td) = lms
    with _serving(tm, draft=(td, None), draft_k=2) as eng:
        # 4 prefill buckets: a prefill and a write each, for both models,
        # then propose and verify
        assert eng.declared_programs() == 4 * 4 + 2 == eng.recompiles
        assert eng.warmup() == 0
        assert eng._page_slack() == 3
        assert set(eng._programs) >= {("propose",), ("verify",)}
        assert ("tick",) not in eng._programs
    with _serving(tm, draft=(td, None), kv_layout="paged", page_size=4,
                  prefill_chunk=8) as eng:
        assert eng.draft_k == draft_k_default() == 3
        assert eng.declared_programs() == 4 * 4 + 2 + 4 == eng.recompiles
        assert eng._page_slack() == 4


def test_validation(lms, monkeypatch):
    (_, _, tm), (_, _, td) = lms
    with pytest.raises(ValueError, match="draft_k"):
        DecodeEngine(tm, draft=(td, None), draft_k=0, device="cpu",
                     warmup=False, start=False)
    monkeypatch.setenv("BIGDL_TPU_DRAFT_K", "5")
    eng = DecodeEngine(tm, **{**BASE, "device": "cpu"}, draft=(td, None),
                       warmup=False, start=False)
    try:
        assert eng.draft_k == 5
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit([1, 2], 4, temperature=0.5)
        # prompt 4 + 40 new - 1 = 43 fits max_len 48, but not with the
        # draft_k slack of 5
        with pytest.raises(ValueError, match="draft_k"):
            eng.submit([1, 2, 3, 4], 45)
        eng.submit([1, 2, 3, 4], 40)
    finally:
        eng.close(timeout=WAIT)


def test_spec_counters_equal_jax_metrics():
    jm, tm = JaxServingMetrics(), ServingMetrics()
    assert tm.spec_acceptance_rate() == jm.spec_acceptance_rate() == 0.0
    assert "spec acc" not in tm.log_line()
    for p, a in [(3, 2), (3, 0), (6, 5)]:
        jm.record_spec(p, a)
        tm.record_spec(p, a)
    assert tm.spec_acceptance_rate() == pytest.approx(
        jm.spec_acceptance_rate()) == 7 / 12
    assert tm.snapshot()["spec_acceptance_rate"] == pytest.approx(
        jm.snapshot()["spec_acceptance_rate"], abs=1e-4)
    assert tm.log_line().endswith(" | spec acc=58%")
    assert jm.log_line().endswith(" | spec acc=58%")
    assert tm.log_line() == jm.log_line()
    assert tm.SUMMARY_TAGS == jm.SUMMARY_TAGS
    assert tm.SUMMARY_TAGS["spec_acceptance_rate"] == \
        "Serving/SpecAcceptanceRate"


def test_decode_program_check(lms, monkeypatch):
    (_, _, tm), (_, _, td) = lms
    kw = dict(slots=2, max_len=32, prompt_buckets=(4, 8),
              prefill_batch_sizes=(1, 2), page_size=4, kv_dtype="int8",
              prefill_chunk=8, draft_model=td, draft_k=3, device="cpu")
    lines = []
    assert decode_program_check(tm, log=lines.append, **kw) == 0
    # 2 ticks, 4 prefills, 2 writes; per pool (f32, int8) a paged tick, 2
    # writes, a reset and a paged verify; the chunk, propose and verify
    assert len(lines) == 8 + 2 * 5 + 3
    assert all(line.endswith(": OK") for line in lines)
    assert "spec verify paged k=3 [int8]: OK" in lines

    def broken(*a, **k):
        raise RuntimeError("no capture")

    monkeypatch.setattr(tdec, "build_prefill_chunk", broken)
    lines = []
    assert decode_program_check(tm, log=lines.append, **kw) == 1
    assert "prefill chunk C=8: FAIL no capture" in lines
