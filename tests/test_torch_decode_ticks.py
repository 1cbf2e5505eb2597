"""The port's decode server programs against the JAX package's
(bigdl_tpu/serving/decode.py:63-374, bigdl_tpu/serving/paging.py): the
page allocator, the greedy, sampling and paged ticks, prefill, the slot
writes, the page reset and the prefill chunk, and sample_logits.

The LM is tools/kernel_shapes.py's DECODE_MODEL with its JAX tree
redrawn with numpy, f32.  The port's ``build_*`` programs run here in
their CPU form (the eager function with the grid cache donated: updated
in place and returned).  Greedy tokens and lengths are exact; cache and
pool leaves computed by the model within 1e-5 of the largest |leaf|
(the matmuls' sum order differs), those only moved or quantized by a
program (slot writes, page reset) bit-equal outside the trash page 0;
logits within 1e-5 of the largest |logit|.  Sampling cannot reproduce
JAX's threefry streams: its filter is held to JAX's exactly, its draw to
reproducibility and to a chi-square bound against the filtered softmax.
"""
import math
import runpy
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.serving import decode as jdec
from bigdl_tpu.serving import paging as jpaging
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.serving import decode as tdec
from bigdl_tpu_torch.serving import paging as tpaging
from bigdl_tpu_torch.utils import load_jax_variables

LM = runpy.run_path(str(Path(__file__).resolve().parents[1] / "tools"
                        / "kernel_shapes.py"))["DECODE_MODEL"]
VOCAB, D, HEADS = LM["vocab_size"], LM["hidden_size"], LM["num_heads"]
SLOTS, MAX_LEN, PAGE = 4, 24, 4


def _rel(got, want):
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy() if torch.is_tensor(tree) else tree)


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
    return jm, v["params"], v["state"], tm.eval()


def _check_cache(got, want, exact=False):
    """Lengths exact; the other leaves bit-equal where ``exact``, else
    within 1e-5; a paged pool's page 0 is left out."""
    for lk, c in want.items():
        paged = c["k"].shape[0] != c["length"].shape[0]
        for name, w in c.items():
            g, w = got[lk][name], np.asarray(w)
            if name == "length":
                np.testing.assert_array_equal(g.numpy(), w)
                continue
            lo = 1 if paged else 0
            if exact:
                np.testing.assert_array_equal(g.numpy()[lo:], w[lo:],
                                              err_msg=f"{lk} {name}")
            else:
                assert _rel(g[lo:], w[lo:]) < 1e-5, (lk, name)


def _prompts(seed):
    rs = np.random.RandomState(seed)
    lengths = np.array([3, 8, 5, 1], np.int32)
    ids = rs.randint(0, VOCAB, (SLOTS, 8)).astype(np.int32)
    return ids, lengths


# ------------------------------------------------------- page allocator
def test_page_allocator_same_script_as_jax():
    rs = np.random.RandomState(1)
    ja = jpaging.PageAllocator(13, 4, 3, 17)
    ta = tpaging.PageAllocator(13, 4, 3, 17)
    for _ in range(200):
        slot = int(rs.randint(0, 3))
        if rs.rand() < 0.7:
            tokens = int(rs.randint(-2, 22))
            assert ta.needed(slot, tokens) == ja.needed(slot, tokens)
            assert ta.ensure(slot, tokens) == ja.ensure(slot, tokens)
        else:
            assert ta.release(slot) == ja.release(slot)
        np.testing.assert_array_equal(ta.table, ja.table)
        assert (ta.pages_in_use, ta.pages_free, ta.owned(slot)) == \
            (ja.pages_in_use, ja.pages_free, ja.owned(slot))
    assert ta.table.dtype == np.int32 and ta.pages_per_slot == 5
    with pytest.raises(ValueError, match="page 0 is reserved"):
        tpaging.PageAllocator(1, 4, 3, 17)
    assert tpaging.default_num_pages(8, 512, 16) == \
        jpaging.default_num_pages(8, 512, 16) == 257
    assert issubclass(tpaging.OutOfPagesError, RuntimeError)


# --------------------------------------------- greedy grid, dense cache
def _serve_dense(lm, steps, active_at):
    """Both packages: prefill the prompts, write each row into its slot,
    then ``steps`` greedy ticks with ``active_at(step)`` as the active
    mask.  Returns the token streams, the final caches and the port's
    cache object."""
    jm, p, s, tm = lm
    ids, lengths = _prompts(2)
    jlast, jbatch = jax.jit(jdec.prefill_fn(jm, MAX_LEN))(
        p, s, jnp.asarray(ids), jnp.asarray(lengths))
    prefill = tdec.build_prefill(tm, MAX_LEN, torch.tensor(ids),
                                 torch.tensor(lengths))
    tlast, tbatch = prefill(torch.tensor(ids), torch.tensor(lengths))
    assert _rel(tlast, jlast) < 1e-5
    _check_cache(tbatch, jbatch)
    # grid slots in another order than the batch rows
    jgrid = jm.init_cache(SLOTS, MAX_LEN)
    tgrid = tm.init_cache(SLOTS, MAX_LEN)
    write = tdec.build_write_slot(tgrid, tbatch, torch.tensor(0),
                                  torch.tensor(0))
    jwrite = jax.jit(jdec.write_slot_fn())
    for row, slot in enumerate((2, 0, 3, 1)):
        jgrid = jwrite(jgrid, jbatch, row, slot)
        assert write(tgrid, tbatch, torch.tensor(row),
                     torch.tensor(slot)) is tgrid
    _check_cache(tgrid, jgrid)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)[[1, 3, 0, 2]]
    jtick = jax.jit(jdec.decode_tick_fn(jm))
    tick = tdec.build_decode_tick(tm, tgrid, torch.tensor(tok),
                                  torch.ones(SLOTS, dtype=torch.bool))
    jtok, ttok, out = tok, torch.tensor(tok), []
    for step in range(steps):
        active = active_at(step)
        jgrid, jtok = jtick(p, s, jgrid, jnp.asarray(jtok),
                            jnp.asarray(active))
        cache, ttok = tick(tgrid, ttok, torch.tensor(active))
        assert cache is tgrid  # donated: updated in place
        ttok = ttok.clone()
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        out.append(ttok.numpy())
    return np.stack(out), tgrid, jgrid


def test_prefill_write_slot_and_greedy_tick(lm):
    """Slot 3 retires after tick 2 (its token and length freeze)."""
    def active(step):
        return np.array([True, True, True, step < 2])

    toks, tgrid, jgrid = _serve_dense(lm, 6, active)
    _check_cache(tgrid, jgrid)
    assert (toks[2:, 3] == toks[1, 3]).all()
    # lengths: prompt + ticks while active; the grid slots hold rows
    # (1, 3, 0, 2) of the prompt batch (lengths 8, 1, 3, 5)
    assert tgrid["layer0"]["length"].tolist() == [14, 7, 9, 7]


def test_write_slot_moves_rows_exactly():
    rs = np.random.RandomState(3)

    def cache(n):
        return {"layer0": {"k": rs.randn(n, 2, 6, 3).astype(np.float32),
                           "v": rs.randn(n, 2, 6, 3).astype(np.float32),
                           "length": rs.randint(0, 6, n).astype(np.int32)}}

    grid, batch = cache(4), cache(2)
    want = jdec.write_slot_fn()(_j(grid), _j(batch), 1, 2)
    tgrid = _t(grid)
    got = tdec.build_write_slot(tgrid, _t(batch), torch.tensor(0),
                                torch.tensor(0))(
        tgrid, _t(batch), torch.tensor(1), torch.tensor(2))
    _check_cache(got, want, exact=True)
    assert got is tgrid


# ------------------------------------------------------------ sampling
def _keep_by_probe(sample, logits, temp, top_k, top_p, noise_of):
    """Which sorted ranks ``sample`` keeps, row by row: with noise +1e6 at
    rank r alone it picks rank r's token iff the filter keeps rank r."""
    s, v = logits.shape
    order = np.argsort(-(logits / np.maximum(temp, 1e-6)[:, None]),
                       axis=-1, kind="stable")
    keep = np.zeros((s, v), bool)
    for r in range(v):
        noise = np.zeros((s, v), np.float32)
        noise[:, r] = 1e6
        picked = np.asarray(sample(noise_of(noise)))
        keep[:, r] = picked == order[:, r]
    return keep


def _filter_case():
    rs = np.random.RandomState(4)
    logits = (rs.randn(6, VOCAB) * 2).astype(np.float32)
    logits[1, 5:9] = logits[1, 4]  # ties in the sorted order
    temp = np.array([0.8, 1.0, 0.5, 2.0, 0.8, 1e-7], np.float32)
    top_k = np.array([40, 5, 0, 3, 1, 0], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.99, 0.3, 1.0], np.float32)
    return logits, temp, top_k, top_p


def test_sample_logits_keeps_what_jax_keeps(monkeypatch):
    logits, temp, top_k, top_p = _filter_case()
    box = {}
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape: jnp.asarray(box["noise"]))
    keys = jnp.zeros((6, 2), jnp.uint32)

    def jsample(noise):
        out = []
        for row in range(6):  # JAX's vmap draws one (V,) per row
            box["noise"] = noise[row]
            out.append(np.asarray(jdec.sample_logits(
                jnp.asarray(logits), keys, jnp.asarray(temp),
                jnp.asarray(top_k), jnp.asarray(top_p)))[row])
        return np.array(out)

    want = _keep_by_probe(jsample, logits, temp, top_k, top_p, lambda n: n)
    monkeypatch.setattr(tdec, "_gumbel", lambda k, v: torch.tensor(
        box["noise"]))

    def tsample(noise):
        box["noise"] = noise
        return tdec.sample_logits(torch.tensor(logits),
                                  torch.zeros(6, dtype=torch.int64),
                                  torch.tensor(temp), torch.tensor(top_k),
                                  torch.tensor(top_p)).numpy()

    got = _keep_by_probe(tsample, logits, temp, top_k, top_p, lambda n: n)
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].all() and got[4].sum() == 1  # top_k 1
    assert 1 < got[1].sum() <= 5  # top_k 5 across tied logits


def _filtered_softmax(logits, temp, top_k, top_p):
    """numpy: the distribution sample_logits draws from, for one row."""
    scaled = logits.astype(np.float64) / max(temp, 1e-6)
    order = np.argsort(-scaled, kind="stable")
    probs = np.exp(scaled[order] - scaled[order].max())
    probs /= probs.sum()
    keep = np.arange(len(order)) < (top_k if top_k > 0 else len(order))
    keep &= (np.cumsum(probs) - probs) < min(top_p, 1.0)
    keep[0] = True
    out = np.zeros(len(order))
    out[order[keep]] = probs[keep] / probs[keep].sum()
    return out


def test_sample_logits_draws():
    """top_k 1 is the argmax; one key gives one stream; over 20000 keys
    the draws follow the filtered softmax (chi-square, p ~ 1e-6)."""
    logits, temp, top_k, top_p = _filter_case()
    t = {k: torch.tensor(v) for k, v in
         dict(logits=logits, temp=temp, top_k=top_k, top_p=top_p).items()}
    keys = torch.arange(6, dtype=torch.int64) * 977 + 5
    a = tdec.sample_logits(t["logits"], keys, t["temp"], t["top_k"],
                           t["top_p"])
    assert a.dtype == torch.int32
    assert torch.equal(a, tdec.sample_logits(t["logits"], keys, t["temp"],
                                             t["top_k"], t["top_p"]))
    assert a[4].item() == int(np.argmax(logits[4]))  # top_k 1
    n = 20000
    row = 0
    draws = tdec.sample_logits(
        t["logits"][row:row + 1].expand(n, -1),
        torch.arange(n, dtype=torch.int64) * 7919 + 11,
        t["temp"][row:row + 1].expand(n), t["top_k"][row:row + 1].expand(n),
        t["top_p"][row:row + 1].expand(n)).numpy()
    p = _filtered_softmax(logits[row], temp[row], top_k[row], top_p[row])
    counts = np.bincount(draws, minlength=VOCAB)
    assert counts[p == 0].sum() == 0
    live = p > 0
    chi2 = float((((counts - n * p) ** 2)[live] / (n * p[live])).sum())
    df = int(live.sum()) - 1
    assert chi2 < df + 7 * math.sqrt(2 * df), (chi2, df)


def test_sampling_tick_greedy_rows_and_keys(lm):
    """Mixed traffic: rows 0 and 2 sample, 1 and 3 are greedy, slot 3
    inactive.  Greedy rows equal JAX's greedy tick; the same keys repeat
    the tokens; a key advances only where its slot is active."""
    jm, p, s, tm = lm
    ids, lengths = _prompts(5)
    tlast, tbatch = tm.prefill(torch.tensor(ids),
                               tm.init_cache(SLOTS, MAX_LEN),
                               lengths=torch.tensor(lengths))
    jlast, jbatch = jax.jit(jdec.prefill_fn(jm, MAX_LEN))(
        p, s, jnp.asarray(ids), jnp.asarray(lengths))
    tokens = torch.tensor(np.asarray(jnp.argmax(jlast, -1)), dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    keys = torch.tensor([11, 12, 13, 14], dtype=torch.int64)
    temp = torch.tensor([0.8, 0.0, 0.8, 0.0])
    top_k = torch.tensor([40, 0, 40, 0], dtype=torch.int32)
    top_p = torch.tensor([0.9, 1.0, 0.9, 1.0])
    args = (tokens, active, keys, temp, top_k, top_p)
    grid = {k: {n: t.clone() for n, t in c.items()} for k, c in
            tbatch.items()}
    tick = tdec.build_sampling_tick(tm, grid, *args)
    runs = []
    for _ in range(2):
        cache = {k: {n: t.clone() for n, t in c.items()} for k, c in
                 tbatch.items()}
        c, nxt, new_keys = tick(cache, *args)
        assert c is cache
        runs.append((nxt.clone(), new_keys.clone(), cache))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    _, jnxt = jax.jit(jdec.decode_tick_fn(jm))(
        p, s, jbatch, jnp.asarray(tokens.numpy()), jnp.asarray(active.numpy()))
    greedy = np.array([1, 3])
    np.testing.assert_array_equal(runs[0][0].numpy()[greedy],
                                  np.asarray(jnxt)[greedy])
    nxt, new_keys = runs[0][0], runs[0][1]
    assert nxt[3] == tokens[3] and new_keys[3] == keys[3]
    assert (new_keys[:3] != keys[:3]).all()
    assert runs[0][2]["layer0"]["length"].tolist() == \
        (torch.tensor(lengths) + torch.tensor([1, 1, 1, 0])).tolist()


# ------------------------------------------------------------- paging
def _pools(lm, kv):
    jm, _, _, tm = lm
    pages = tpaging.default_num_pages(SLOTS, MAX_LEN, PAGE)
    return (jm.init_paged_cache(pages, PAGE, SLOTS, kv_dtype=kv),
            tm.init_paged_cache(pages, PAGE, SLOTS, kv_dtype=kv))


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_pool", "int8_pool"])
def test_paged_write_slot_and_tick(lm, kv):
    """Prompts written into pages a PageAllocator grants, then greedy
    paged ticks (pages granted as rows grow) against JAX's paged tick;
    the f32 pool's tokens equal the dense grid's too."""
    jm, p, s, tm = lm
    ids, lengths = _prompts(2)
    tlast, tbatch = tm.prefill(torch.tensor(ids),
                               tm.init_cache(SLOTS, MAX_LEN),
                               lengths=torch.tensor(lengths))
    jlast, jbatch = jax.jit(jdec.prefill_fn(jm, MAX_LEN))(
        p, s, jnp.asarray(ids), jnp.asarray(lengths))
    jpool, tpool = _pools(lm, kv)
    alloc = tpaging.PageAllocator(tpaging.default_num_pages(
        SLOTS, MAX_LEN, PAGE), PAGE, SLOTS, MAX_LEN)
    jwrite = jax.jit(jdec.paged_write_slot_fn())
    write = tdec.build_paged_write_slot(tpool, torch.tensor(alloc.table[0]),
                                        tbatch, torch.tensor(0),
                                        torch.tensor(0))
    for row, slot in enumerate((2, 0, 3, 1)):
        assert alloc.ensure(slot, int(lengths[row]) + 1)
        jpool = jwrite(jpool, jnp.asarray(alloc.table[slot]), jbatch, row,
                       slot)
        assert write(tpool, torch.tensor(alloc.table[slot]), tbatch,
                     torch.tensor(row), torch.tensor(slot)) is tpool
    _check_cache(tpool, jpool)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)[[1, 3, 0, 2]]
    active = np.array([True, True, True, False])
    zeros = dict(keys=np.zeros((SLOTS, 2), np.uint32),
                 temp=np.zeros(SLOTS, np.float32),
                 top_k=np.zeros(SLOTS, np.int32),
                 top_p=np.ones(SLOTS, np.float32))
    targs = (torch.zeros(SLOTS, dtype=torch.int64), torch.zeros(SLOTS),
             torch.zeros(SLOTS, dtype=torch.int32), torch.ones(SLOTS))
    jtick = jax.jit(jdec.paged_tick_fn(jm))
    tick = tdec.build_paged_tick(tm, tpool, torch.tensor(alloc.table),
                                 torch.tensor(tok), torch.tensor(active),
                                 *targs)
    jtok, ttok, streams = tok, torch.tensor(tok), []
    for _ in range(5):
        for slot in range(SLOTS):  # room for the token this tick writes
            assert alloc.ensure(slot, int(tpool["layer0"]["length"][slot])
                                + 1)
        table = alloc.table.copy()
        jpool, jtok, _ = jtick(p, s, jpool, jnp.asarray(table),
                               jnp.asarray(jtok), jnp.asarray(active),
                               *(jnp.asarray(v) for v in zeros.values()))
        c, ttok, _ = tick(tpool, torch.tensor(table), ttok,
                          torch.tensor(active), *targs)
        assert c is tpool
        ttok = ttok.clone()
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        streams.append(ttok.numpy())
    _check_cache(tpool, jpool)
    if kv is None:
        dense, _, _ = _serve_dense(lm, 5, lambda step: active)
        np.testing.assert_array_equal(np.stack(streams), dense)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_pool", "int8_pool"])
def test_paged_write_slot_and_reset_exact(kv):
    """Data movement only: the same batch cache, table row and pool give
    bit-equal pools outside page 0; the reset zeroes the pages given."""
    rs = np.random.RandomState(6)
    jm = jnn.MultiHeadAttention(8, 2)
    pool = jax.tree_util.tree_map(np.asarray, jm.init_paged_cache(
        7, 4, 3, quantized=kv == "int8"))
    for name, leaf in pool.items():
        if name != "length":
            pool[name] = (rs.randint(-100, 100, leaf.shape) if kv
                          and name in ("k", "v") else rs.rand(*leaf.shape)
                          ).astype(leaf.dtype)
    pool = {"layer0": pool}
    batch = {"layer0": {"k": rs.randn(2, 2, 9, 4).astype(np.float32),
                        "v": rs.randn(2, 2, 9, 4).astype(np.float32),
                        "length": np.array([6, 9], np.int32)}}
    row = np.array([4, 2, 0], np.int32)  # 2 of 3 logical pages granted
    want = jdec.paged_write_slot_fn()(_j(pool), jnp.asarray(row),
                                      _j(batch), 1, 2)
    tpool = _t(pool)
    got = tdec.build_paged_write_slot(tpool, torch.tensor(row), _t(batch),
                                      torch.tensor(0), torch.tensor(0))(
        tpool, torch.tensor(row), _t(batch), torch.tensor(1),
        torch.tensor(2))
    assert got is tpool
    _check_cache(got, want, exact=True)
    pages = np.array([2, 5, 0], np.int32)
    want = jdec.page_reset_fn()(want, jnp.asarray(pages))
    reset = tdec.build_page_reset(tpool, torch.tensor(pages))
    assert reset(tpool, torch.tensor(pages)) is tpool
    _check_cache(tpool, want, exact=True)
    assert not tpool["layer0"]["k"][[0, 2, 5]].any()


def test_prefill_chunk(lm):
    """A 10-token prompt in chunks of 4 through a batch-1 staging cache
    (the last chunk padded, advance 2) against JAX's chunk program; the
    last chunk's logits equal prefill's."""
    jm, p, s, tm = lm
    ids, _ = _prompts(7)
    prompt = np.concatenate([ids[0], ids[1, :2]])[None]       # (1, 10)
    jchunk = jax.jit(jdec.prefill_chunk_fn(jm))
    staging = tm.init_cache(1, MAX_LEN)
    chunk = tdec.build_prefill_chunk(tm, staging, torch.zeros(
        (1, 4), dtype=torch.int64), torch.tensor([4], dtype=torch.int32))
    jcache = jm.init_cache(1, MAX_LEN)
    for lo in (0, 4, 8):
        part = np.zeros((1, 4), np.int64)
        n = min(4, 10 - lo)
        part[0, :n] = prompt[0, lo:lo + n]
        adv = np.array([n], np.int32)
        jlast, jcache = jchunk(p, s, jcache, jnp.asarray(part),
                               jnp.asarray(adv))
        tlast, c = chunk(staging, torch.tensor(part), torch.tensor(adv))
        assert c is staging
        assert _rel(tlast, jlast) < 1e-5
    _check_cache(staging, jcache)
    assert staging["layer0"]["length"].tolist() == [10]
    want, _ = tm.prefill(torch.tensor(prompt), tm.init_cache(1, MAX_LEN))
    assert _rel(tlast, want.numpy()) < 1e-5
