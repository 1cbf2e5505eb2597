"""The port's DecodeEngine against the JAX package's
(bigdl_tpu/serving/decode.py:601-1860), on the CPU.

The LM is tools/kernel_shapes.py's DECODE_MODEL with its JAX tree
redrawn with numpy (f32), carried into the port by
``load_jax_variables``; the engines run at the JAX tests' sizes (2 slots,
max_len 32, prompt buckets (4, 8), prefill batches (1, 2);
tests/test_decode.py:252-608).

- Parity: the port's greedy tokens equal the JAX ``DecodeEngine``'s on
  the same prompts, token for token, for the dense cache, the paged pool
  and the paged pool with chunked prefill (prompts past the largest
  bucket).  Exact: the two differ only by f32 sum order, far below the
  gap between the top two logits at these weights.
- Behaviour, each as the JAX tests hold it, against the port's own
  uncached greedy rollout (``_rollout``, held to the JAX engine by the
  parity tests): EOS retirement, deadlines, admission and validation
  errors, a prompt past the largest bucket becoming one learned bucket,
  ``close()`` draining what is in flight, the log line's token fields,
  paged equal to dense, retirement freeing every page (read through
  ``metrics.pages_in_use`` and ``_page_bytes_total()``: the port has no
  HBM ledger), an unservable request rejected and the younger slot
  evicted under contention, the int8 pool at most half the bytes of the
  f32 pool per page with at least 90% of the f32 pool's tokens (the JAX
  test's bound: near-tie argmax flips), sampling reproducible per seed,
  greedy rows exact in mixed traffic, and chunked prefill equal to the
  bucketed path with no learned bucket.

Every future is waited on with a timeout and every engine is closed in a
``finally`` with a bounded ``close``, so a fault fails a test instead of
hanging the suite.
"""
import contextlib
import logging
import math
import runpy
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.serving import (DeadlineExceededError, DecodeEngine,
                                     EngineClosedError, OutOfPagesError,
                                     PeriodicMetricsLogger, QueueFullError,
                                     ServingMetrics, paging)
from bigdl_tpu_torch.serving import decode as tdec
from bigdl_tpu_torch.utils import load_jax_variables

LM = runpy.run_path(str(Path(__file__).resolve().parents[1] / "tools"
                        / "kernel_shapes.py"))["DECODE_MODEL"]
VOCAB = LM["vocab_size"]
WAIT = 60  # seconds: every future's and every close's bound

# the parity traffic: (prompt length, new tokens) per request
SHORT = [(3, 6), (4, 9), (7, 4), (5, 8), (8, 5)]
LONG = [(19, 8), (5, 10), (21, 6), (3, 7)]  # past the largest bucket, 8
LAYOUTS = {
    "dense": (dict(), SHORT),
    "paged": (dict(kv_layout="paged", page_size=4), SHORT),
    "paged_chunked": (dict(kv_layout="paged", page_size=4, max_len=48,
                           prefill_chunk=8), LONG),
}
BASE = dict(slots=2, max_len=32, prompt_buckets=(4, 8),
            prefill_batch_sizes=(1, 2), eos_id=None)


def _prompts(traffic, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (t,)), n) for t, n in traffic]


@pytest.fixture(scope="module")
def lm():
    jm = jnn.Transformer(**LM)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)

    def fill(path, a):
        if a.ndim == 2:
            return (rs.randn(*a.shape) / math.sqrt(a.shape[0])
                    ).astype(np.float32)
        if getattr(path[-1], "key", "") == "weight":
            return (1.0 + 0.1 * rs.randn(*a.shape)).astype(np.float32)
        return (0.1 * rs.randn(*a.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, tree)
    tm = tnn.Transformer(**LM)
    load_jax_variables(tm, v)
    return jm, v, tm.eval()


@contextlib.contextmanager
def _serving(model, **kw):
    """An engine closed on the way out (bounded); on a clean exit its
    loop thread must have ended."""
    eng = DecodeEngine(model, **{**BASE, "device": "cpu", **kw})
    try:
        yield eng
    except BaseException:
        eng.close(timeout=WAIT)
        raise
    eng.close(timeout=WAIT)
    assert not eng._loop_thread.is_alive()


def _rollout(model, prompt, n):
    """Greedy tokens by the port's uncached forward: the oracle."""
    ids = [int(t) for t in prompt]
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([ids]))
            ids.append(int(logits[0, -1].argmax()))
    return ids[len(prompt):]


def _serve(eng, reqs, **kw):
    futs = [eng.submit(p, n, **kw) for p, n in reqs]
    return [list(f.result(WAIT)) for f in futs]


@pytest.fixture(scope="module")
def jax_tokens(lm):
    """The JAX engine's greedy tokens for each layout's traffic."""
    jm, v, _ = lm
    out = {}
    for name, (kw, traffic) in LAYOUTS.items():
        eng = JaxDecodeEngine(jm, v, **{**BASE, **kw})
        try:
            out[name] = _serve(eng, _prompts(traffic, 1))
        finally:
            eng.close(timeout=WAIT)
    return out


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_tokens_equal_the_jax_engine(lm, jax_tokens, layout):
    _, _, tm = lm
    kw, traffic = LAYOUTS[layout]
    with _serving(tm, **kw) as eng:
        assert eng.recompiles == eng.declared_programs()
        got = _serve(eng, _prompts(traffic, 1))
        assert eng.recompiles == eng.declared_programs()
        if eng.paged:
            assert eng._alloc.pages_in_use == 0
        if eng.prefill_chunk:
            assert eng.metrics.prefill_chunks >= 3
    assert got == jax_tokens[layout]
    # the oracle the behaviour tests use agrees with JAX too
    assert got == [_rollout(tm, p, n) for p, n in _prompts(traffic, 1)]


# ------------------------------------------------------------- behaviour
def test_greedy_matches_rollout_with_no_steady_state_capture(lm):
    _, _, tm = lm
    reqs = _prompts([(3, 6), (4, 9), (7, 4), (5, 8), (8, 5)], 0)
    with _serving(tm) as eng:
        declared = eng.declared_programs()
        assert declared == 4 + 4 + 1  # prefills, their writes, the tick
        assert eng.recompiles == declared
        assert eng.warmup() == 0  # a re-warm captures nothing
        got = _serve(eng, reqs)
        assert got == [_rollout(tm, p, n) for p, n in reqs]
        # occupancy churned (5 requests over 2 slots) and no program
        # was captured while serving
        assert eng.recompiles == declared
        assert eng.metrics.completed == 5
        assert eng.metrics.decoded_tokens == sum(n - 1 for _, n in reqs)
        assert 0.0 < eng.metrics.slot_occupancy() <= 1.0
        assert eng.metrics.finished("length") == 5


def test_eos_retires_the_slot(lm):
    _, _, tm = lm
    prompt = [1, 2, 3]
    roll = _rollout(tm, prompt, 8)
    eos = roll[3]
    with _serving(tm, eos_id=eos) as eng:
        got = eng.generate(prompt, 8, timeout=WAIT)
        assert list(got) == roll[:roll.index(eos) + 1]
        assert eng.metrics.finished("eos") == 1


def test_deadlines(lm):
    _, _, tm = lm
    with _serving(tm) as eng:
        fut = eng.submit([1, 2], 4, deadline_ms=0.0)
        with pytest.raises(DeadlineExceededError):
            fut.result(WAIT)
        assert eng.metrics.expired >= 1
        assert len(eng.generate([1, 2], 3, timeout=WAIT)) == 3
    # expiring mid-decode truncates: the tokens so far are the result
    with _serving(tm, max_len=2048, prompt_buckets=(8,),
                  prefill_batch_sizes=(1,)) as eng:
        got = eng.generate([1, 2, 3], 2000, deadline_ms=100, timeout=WAIT)
        assert 1 <= len(got) < 2000
        assert eng.metrics.finished("deadline") == 1


def test_admission_and_validation(lm):
    _, _, tm = lm
    eng = DecodeEngine(tm, **{**BASE, "device": "cpu"}, max_queue=2,
                       start=False, warmup=False)
    try:
        with pytest.raises(ValueError):
            eng.submit([], 4)
        with pytest.raises(ValueError):
            eng.submit([1, 2], 0)
        with pytest.raises(ValueError):
            eng.submit([1] * 8, 100)  # cannot fit max_len 32
        with pytest.raises(ValueError):
            eng.submit([1, 2], 2, temperature=0.5, top_p=0.0)
        f1, f2 = eng.submit([1, 2], 2), eng.submit([1, 2], 2)
        with pytest.raises(QueueFullError):
            eng.submit([1, 2], 2)
        assert eng.metrics.rejected == 1
    finally:
        eng.close(timeout=WAIT)  # before start: queued requests fail
    for f in (f1, f2):
        assert isinstance(f.exception(WAIT), EngineClosedError)
    with pytest.raises(EngineClosedError):
        eng.submit([1, 2], 2)
    with pytest.raises(ValueError):
        DecodeEngine(tm, device="cpu", kv_dtype="int8", warmup=False,
                     start=False)
    with pytest.raises(ValueError):
        DecodeEngine(tm, device="cpu", kv_layout="ring", warmup=False,
                     start=False)


def test_oversized_prompt_becomes_one_learned_bucket(lm):
    _, _, tm = lm
    rs = np.random.RandomState(7)
    with _serving(tm) as eng:
        declared = eng.declared_programs()
        prompt = rs.randint(0, VOCAB, (11,))  # past the largest bucket
        assert list(eng.generate(prompt, 4, timeout=WAIT)) == \
            _rollout(tm, prompt, 4)
        # the learned bucket's prefill and its slot write
        assert eng.recompiles == declared + 2
        eng.generate(rs.randint(0, VOCAB, (11,)), 4, timeout=WAIT)
        assert eng.recompiles == declared + 2


def test_close_drains_what_is_in_flight(lm):
    _, _, tm = lm
    eng = DecodeEngine(tm, **{**BASE, "device": "cpu"})
    try:
        futs = [eng.submit([1, 2, 3], 6) for _ in range(4)]
    finally:
        eng.close(timeout=WAIT)  # drain: everything queued decodes
    want = _rollout(tm, [1, 2, 3], 6)
    for f in futs:
        assert list(f.result(1)) == want
    assert not eng._loop_thread.is_alive()
    eng.close(timeout=WAIT)  # idempotent


def test_close_without_drain_fails_what_is_left(lm):
    _, _, tm = lm
    eng = DecodeEngine(tm, **{**BASE, "device": "cpu"}, start=False)
    try:
        futs = [eng.submit([1, 2, 3], 20) for _ in range(4)]
        eng.start()
    finally:
        eng.close(drain=False, timeout=WAIT)
    assert not eng._loop_thread.is_alive()
    for f in futs:  # each one either finished or failed, none hangs
        exc = f.exception(WAIT)
        assert exc is None or isinstance(exc, EngineClosedError)


def test_log_line_carries_the_token_metrics(lm, caplog):
    _, _, tm = lm
    with caplog.at_level(logging.INFO, logger="bigdl_tpu_torch.serving"):
        with _serving(tm, metrics_log_every_s=0.01) as eng:
            eng.generate([1, 2], 4, timeout=WAIT)
            line = eng.log_line()
            assert eng._periodic.running
        assert not eng._periodic.running
    assert "tok/s" in line and "slots=" in line and "tick p50=" in line
    snap = eng.metrics.snapshot()
    assert snap["decoded_tokens"] == 3 and snap["decode_ms"] > 0
    assert snap["prefill_ms"] > 0 and snap["p95_tick_ms"] > 0


def test_periodic_logger_is_off_unless_asked(monkeypatch):
    lines = []
    monkeypatch.delenv("BIGDL_TPU_METRICS_EVERY_S", raising=False)
    assert not PeriodicMetricsLogger(lambda: "x", sink=lines.append
                                     ).start().running
    monkeypatch.setenv("BIGDL_TPU_METRICS_EVERY_S", "0.01")
    log = PeriodicMetricsLogger(lambda: "x", sink=lines.append).start()
    try:
        assert log.every_s == 0.01 and log.running
    finally:
        log.close()
        log.close()  # idempotent
    assert not log.running


def test_paging_defaults_read_the_environment(monkeypatch):
    for var in ("BIGDL_TPU_KV_PAGE", "BIGDL_TPU_KV_DTYPE",
                "BIGDL_TPU_PAGE_ZERO"):
        monkeypatch.delenv(var, raising=False)
    assert (paging.page_size_default(), paging.kv_dtype_default(),
            paging.page_zero_enabled()) == (16, None, False)
    monkeypatch.setenv("BIGDL_TPU_KV_PAGE", "8")
    monkeypatch.setenv("BIGDL_TPU_KV_DTYPE", " INT8 ")
    monkeypatch.setenv("BIGDL_TPU_PAGE_ZERO", "1")
    assert (paging.page_size_default(), paging.kv_dtype_default(),
            paging.page_zero_enabled()) == (8, "int8", True)


# ----------------------------------------------------------------- paged
def test_paged_equals_dense_and_returns_every_page(lm):
    _, _, tm = lm
    reqs = _prompts([(3, 6), (7, 4), (5, 9), (8, 5), (4, 7)], 3)
    with _serving(tm) as eng:
        dense = _serve(eng, reqs)
    with _serving(tm, kv_layout="paged", page_size=4) as eng:
        assert eng.recompiles == eng.declared_programs()
        assert _serve(eng, reqs) == dense
        assert eng.recompiles == eng.declared_programs()
        assert eng._alloc.pages_in_use == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_page_zeroing_engine(lm, monkeypatch, kv_dtype):
    """With ``BIGDL_TPU_PAGE_ZERO`` on, the page reset is one more
    declared program, captured at warmup; retirements zero the freed
    pages (every page but the trash page is zero once the grid is
    idle) and the tokens are those of the engine that does not zero."""
    _, _, tm = lm
    reqs = _prompts([(3, 6), (7, 4), (5, 9), (8, 5), (4, 7)], 3)
    kw = dict(kv_layout="paged", page_size=4, kv_dtype=kv_dtype)
    monkeypatch.delenv("BIGDL_TPU_PAGE_ZERO", raising=False)
    with _serving(tm, **kw) as eng:
        plain_declared = eng.declared_programs()
        plain = _serve(eng, reqs)
    monkeypatch.setenv("BIGDL_TPU_PAGE_ZERO", "1")
    with _serving(tm, **kw) as eng:
        assert eng.declared_programs() == plain_declared + 1
        assert eng.recompiles == eng.declared_programs()
        assert _serve(eng, reqs) == plain
        assert eng.recompiles == eng.declared_programs()
    # read once the loop has ended: a request's future resolves before
    # its slot is freed
    assert eng._alloc.pages_in_use == 0
    for pool in eng._cache.values():
        for name, leaf in pool.items():
            if name != "length":
                assert not leaf[1:].any(), name
    if kv_dtype is None:
        with _serving(tm) as eng:
            assert _serve(eng, reqs) == plain


@pytest.mark.parametrize("page_zero", [False, True])
def test_a_failing_loop_fails_every_request(lm, monkeypatch, page_zero):
    """A fault in the loop fails every queued and decoding request with
    that fault and ends the loop, even where freeing a slot would run the
    page reset and that would fail too."""
    _, _, tm = lm
    monkeypatch.setenv("BIGDL_TPU_PAGE_ZERO", "1" if page_zero else "0")
    eng = DecodeEngine(tm, **{**BASE, "device": "cpu"}, kv_layout="paged",
                       page_size=4, start=False)
    fault = RuntimeError("device fault")

    def boom(*args):
        raise fault

    try:
        eng._run_tick = boom
        eng._run_page_reset = boom
        futs = [eng.submit([1, 2, 3], 6) for _ in range(4)]
        eng.start()
        for f in futs:
            assert f.exception(WAIT) is fault
        eng._loop_thread.join(WAIT)
        assert not eng._loop_thread.is_alive()
        with pytest.raises(EngineClosedError):
            eng.submit([1, 2], 2)
    finally:
        eng.close(timeout=WAIT)


class _PeakPages(ServingMetrics):
    """Keeps the largest page count the engine recorded."""
    peak = 0

    def record_pages(self, in_use):
        self.peak = max(self.peak, int(in_use))
        super().record_pages(in_use)


def test_retirement_frees_pages(lm):
    _, _, tm = lm
    metrics = _PeakPages()
    with _serving(tm, kv_layout="paged", page_size=4, slots=1,
                  metrics=metrics) as eng:
        eng.generate([1, 2, 3, 4, 5, 6], 18, timeout=WAIT)
        per_page = eng._page_bytes_total()
        # 6 + 18 - 1 cached tokens grow the slot to 6 pages of 4
        assert metrics.peak == 6
        assert metrics.pages_in_use == 0 and eng._alloc.pages_in_use == 0
        assert metrics.peak * per_page <= eng._cache_bytes_total()
    # K and V of 4 tokens in 2 layers of 4 heads of 12, f32
    assert per_page == 2 * 2 * 4 * 4 * 12 * 4


def test_unservable_rejected_and_younger_evicted(lm):
    _, _, tm = lm
    # 6 usable pages of 4 tokens
    with _serving(tm, kv_layout="paged", page_size=4, num_pages=7) as eng:
        with pytest.raises(OutOfPagesError):
            eng.submit([1] * 8, 24)  # 8 pages alone: never servable
        prompts = [[1, 2, 3], [2, 3, 4], [3, 4, 5], [4, 5, 6]]
        got = _serve(eng, [(p, 12) for p in prompts])
        assert got == [_rollout(tm, p, 12) for p in prompts]
        assert eng.metrics.page_evictions >= 1
        assert eng._alloc.pages_in_use == 0


def test_int8_pool_halves_the_bytes_with_parity(lm):
    _, _, tm = lm
    reqs = _prompts([(4, 8), (7, 8), (3, 8), (6, 8)], 5)
    kw = dict(kv_layout="paged", page_size=4)
    with _serving(tm, **kw) as eng:
        fp_bytes = eng._page_bytes_total()
        fp = _serve(eng, reqs)
    with _serving(tm, kv_dtype="int8", **kw) as eng:
        q_bytes = eng._page_bytes_total()
        q = _serve(eng, reqs)
    assert 2 * q_bytes <= fp_bytes
    agree = sum(int(np.sum(np.asarray(a) == np.asarray(b)))
                for a, b in zip(fp, q))
    assert agree / sum(len(a) for a in fp) >= 0.9, (agree, fp, q)


# -------------------------------------------------------------- sampling
def test_sampling_reproducible_per_seed(lm):
    _, _, tm = lm
    prompt = [1, 2, 3, 4]
    kw = dict(temperature=1.5, top_k=0, top_p=0.95)
    with _serving(tm) as eng:
        a = eng.generate(prompt, 12, seed=11, timeout=WAIT, **kw)
        b = eng.generate(prompt, 12, seed=11, timeout=WAIT, **kw)
        c = eng.generate(prompt, 12, seed=12, timeout=WAIT, **kw)
        greedy = eng.generate(prompt, 12, timeout=WAIT)
        assert list(a) == list(b)
        assert list(a) != list(c)
        assert list(greedy) == _rollout(tm, prompt, 12)
        # sampling parameters are data: one tick serves them all
        assert eng.recompiles == eng.declared_programs()


def test_sampled_stream_continues_from_the_host_draw(lm):
    """Token 0 is the stream's first draw (the request's key on the
    host), and a slot's ticks continue it from ``split_rng(key, 0)``."""
    req = tdec._DecodeRequest(None, 4, None, 0.0, None, temp=1.0, top_k=5,
                              top_p=1.0, key=tdec._key_for_seed(11))
    logits = torch.tensor(np.random.RandomState(2).randn(VOCAB),
                          dtype=torch.float32)
    want = tdec.sample_logits(logits[None], torch.tensor([req.key]),
                              torch.tensor([1.0]), torch.tensor([5]),
                              torch.tensor([1.0]))
    assert tdec._host_sample(logits, req) == int(want[0])
    req.temp = 0.0
    assert tdec._host_sample(logits, req) == int(logits.argmax())
    assert tdec._key_for_seed(-1) == (1 << 63) - 1


def test_mixed_traffic_keeps_greedy_rows_exact(lm):
    _, _, tm = lm
    reqs = _prompts([(3, 6), (5, 6), (7, 6), (4, 6)], 9)
    with _serving(tm) as eng:
        futs = [eng.submit(p, n, temperature=0.8, seed=i) if i % 2
                else eng.submit(p, n) for i, (p, n) in enumerate(reqs)]
        got = [list(f.result(WAIT)) for f in futs]
    for i, (p, n) in enumerate(reqs):
        if i % 2 == 0:
            assert got[i] == _rollout(tm, p, n)
        else:
            assert len(got[i]) == n and all(0 <= t < VOCAB for t in got[i])


# ------------------------------------------------------- chunked prefill
def test_chunked_prefill_matches_the_bucketed_path(lm):
    _, _, tm = lm
    prompt = np.random.RandomState(21).randint(0, VOCAB, (21,))
    with _serving(tm, max_len=48, prefill_chunk=8) as eng:
        declared = eng.declared_programs()
        assert declared == 4 + 4 + 1 + 2  # + the chunk program, its write
        got = eng.generate(prompt, 6, timeout=WAIT)
        assert list(got) == _rollout(tm, prompt, 6)
        assert eng.recompiles == declared  # no learned bucket
        assert eng.metrics.prefill_chunks == 3
    with _serving(tm, max_len=48) as eng:  # the learned bucket's path
        assert list(eng.generate(prompt, 6, timeout=WAIT)) == list(got)


def test_chunk_program_without_a_batch_1_write(lm):
    _, _, tm = lm
    prompt = np.random.RandomState(22).randint(0, VOCAB, (13,))
    with _serving(tm, max_len=48, prefill_chunk=8,
                  prefill_batch_sizes=(2,)) as eng:
        # the chunk's write is its own program, with or without a
        # batch-1 bucket: 2 prefills, their writes, the tick, the chunk
        # program and its write
        assert eng.declared_programs() == 2 + 2 + 1 + 1 + 1
        assert eng.recompiles == eng.declared_programs()
        assert list(eng.generate(prompt, 5, timeout=WAIT)) == \
            _rollout(tm, prompt, 5)
        assert eng.recompiles == eng.declared_programs()


def test_many_clients_at_once(lm):
    """Submitting threads race the loop thread (queue, metrics, close):
    with a short switch interval every request still gets its greedy
    tokens and every counter adds up."""
    _, _, tm = lm
    reqs = _prompts([(3, 5), (6, 4), (8, 6), (4, 3)], 11)
    want = [_rollout(tm, p, n) for p, n in reqs]
    got, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _serving(tm) as eng:
            def client(c):
                try:
                    futs = [(i, eng.submit(p, n))
                            for i, (p, n) in enumerate(reqs)]
                    for i, f in futs:
                        got[(c, i)] = list(f.result(WAIT))
                except Exception as e:  # reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
            assert not any(t.is_alive() for t in threads)
            assert eng.metrics.completed == 8 * len(reqs)
            assert eng.metrics.decoded_tokens == 8 * sum(
                n - 1 for _, n in reqs)
            assert eng.recompiles == eng.declared_programs()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert all(got[(c, i)] == want[i] for c in range(8)
               for i in range(len(reqs)))
