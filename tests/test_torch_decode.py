"""The port's decode slice against the JAX package: the dense and paged
(f32 and int8) KV caches of MultiHeadAttention, the Transformer's
prefill / decode_step / extend and their paged twins, int8_scores and
its eligibility rule, SequenceBeamSearch and generate.

The LM is the decode model of tools/kernel_shapes.py (DECODE_MODEL:
vocab 32, hidden 48, 4 heads of 12, filter 96, 2 layers), its JAX tree
redrawn with numpy from a seed and loaded into both packages.
Tolerances: logits within 1e-5 (f32) and 2e-2 (bf16) of the largest
|logit|; cache and pool leaves bit-equal where both packages write the
same values (attention layers fed dyadic weights and inputs, whose
products and sums are exact in f32), within 1e-5 of the largest |leaf|
where the model computed them (the matmuls' sum order differs); lengths
and int8_scores exact; beam sequences equal, scores within 1e-6
relative.
"""
import math
import runpy
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import bigdl_tpu.ops.paged_kv as jkv
from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import beam_search as jbs
from bigdl_tpu.ops.pallas.int8_matmul import candidate_params
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn import beam_search as tbs
from bigdl_tpu_torch.ops import paged_kv as tkv
from bigdl_tpu_torch.utils import load_jax_variables

LM = runpy.run_path(str(Path(__file__).resolve().parents[1] / "tools"
                        / "kernel_shapes.py"))["DECODE_MODEL"]
VOCAB, D, HEADS = LM["vocab_size"], LM["hidden_size"], LM["num_heads"]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float() if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _tree(cache, fn=np.asarray):
    if isinstance(cache, dict):
        return {k: _tree(v, fn) for k, v in cache.items()}
    return fn(cache)


def _to_torch(tree, dtype=None):
    def one(a):
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                       else a)
        t = torch.tensor(a)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return _tree(tree, one)


def _random_tree(jax_module, seed):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_module.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(seed)

    def fill(path, a):
        name = getattr(path[-1], "key", "")
        if a.ndim == 2:
            return (rs.randn(*a.shape) / math.sqrt(a.shape[0])
                    ).astype(np.float32)
        if name == "weight":
            return (1.0 + 0.1 * rs.randn(*a.shape)).astype(np.float32)
        return (0.1 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _rounded(tree, dtype):
    """The tree's leaves rounded to ``dtype`` (f32 arrays again)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(torch.tensor(a).to(dtype).float()), tree)


class _Jitted:
    """The JAX LM's decode methods, jitted (fewer dispatches than eager;
    the model-level checks are held to a tolerance)."""

    def __init__(self, model):
        self.model = model
        for name in ("prefill", "decode_step", "extend", "extend_paged",
                     "decode_step_paged"):
            setattr(self, name, jax.jit(getattr(model, name)))

    def __getattr__(self, name):
        return getattr(self.model, name)


def _make_lm(dtype):
    jm = _Jitted(jnn.Transformer(**LM))
    tm = tnn.Transformer(**LM)
    v = _rounded(_random_tree(jm, 0), dtype)
    load_jax_variables(tm, v)
    tm = tm.to(dtype).eval()
    jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, JDT[dtype]), v)
    return jm, jv, tm, dtype


@pytest.fixture(scope="module", params=[torch.float32, torch.bfloat16],
                ids=["f32", "bf16"])
def lm(request):
    return _make_lm(request.param)


@pytest.fixture(scope="module")
def lm32():
    """The f32 LM: the paged paths and the beams (bf16 logits tie)."""
    return _make_lm(torch.float32)


def _ids(seed, n, t):
    return np.random.RandomState(seed).randint(0, VOCAB, (n, t))


def _check_cache(got, want, dtype):
    for lk, c in want.items():
        np.testing.assert_array_equal(got[lk]["length"].numpy(),
                                      np.asarray(c["length"]))
        for name in ("k", "v"):
            assert got[lk][name].dtype == dtype
            assert _rel(got[lk][name], c[name].astype(jnp.float32)) \
                < TOL[dtype], (lk, name)


# ------------------------------------------------------ the dense cache
def test_prefill_full_and_ragged(lm):
    jm, jv, tm, dtype = lm
    ids = _ids(1, 2, 9)
    for lengths in (None, np.array([3, 9], np.int32)):
        jc = jm.init_cache(2, 16, JDT[dtype])
        want, jc = jm.prefill(jv["params"], jv["state"], jnp.asarray(ids),
                              jc, lengths=None if lengths is None
                              else jnp.asarray(lengths))
        got, tc = tm.prefill(torch.tensor(ids), tm.init_cache(2, 16, dtype),
                             lengths=None if lengths is None
                             else torch.tensor(lengths))
        assert got.dtype == dtype and tuple(got.shape) == (2, VOCAB)
        assert _rel(got, want.astype(jnp.float32)) < TOL[dtype]
        _check_cache(tc, jc, dtype)


def test_decode_step_chain(lm):
    """Prefill then six steps, both fed JAX's greedy tokens."""
    jm, jv, tm, dtype = lm
    p, s = jv["params"], jv["state"]
    ids = _ids(2, 2, 5)
    jl, jc = jm.prefill(p, s, jnp.asarray(ids),
                        jm.init_cache(2, 12, JDT[dtype]))
    tl, tc = tm.prefill(torch.tensor(ids), tm.init_cache(2, 12, dtype))
    for _ in range(6):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jm.decode_step(p, s, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.tensor(tok))
        assert _rel(tl, jl.astype(jnp.float32)) < TOL[dtype]
    _check_cache(tc, jc, dtype)


def test_extend_chunks_with_advance(lm):
    """Chunks of 4 with a padded last chunk (advance 2 of 4) equal JAX's
    extend, and the first chunks equal prefill."""
    jm, jv, tm, dtype = lm
    p, s = jv["params"], jv["state"]
    ids = _ids(3, 2, 12)
    jc, tc = jm.init_cache(2, 16, JDT[dtype]), tm.init_cache(2, 16, dtype)
    for lo, adv in ((0, None), (4, None), (8, np.array([2, 4], np.int32))):
        chunk = ids[:, lo:lo + 4]
        jl, jc = jm.extend(p, s, jc, jnp.asarray(chunk),
                           advance=None if adv is None else jnp.asarray(adv))
        tl, tc = tm.extend(tc, torch.tensor(chunk),
                           advance=None if adv is None else torch.tensor(adv))
        assert tuple(tl.shape) == (2, 4, VOCAB)
        assert _rel(tl, jl.astype(jnp.float32)) < TOL[dtype]
    _check_cache(tc, jc, dtype)
    assert tc["layer0"]["length"].tolist() == [10, 12]
    pl, _ = tm.prefill(torch.tensor(ids[:, :8]), tm.init_cache(2, 16, dtype))
    t8, _ = tm.extend(tm.init_cache(2, 16, dtype), torch.tensor(ids[:, :8]))
    assert torch.equal(pl, t8[:, -1])


def _dyadic(rs, shape, den=8):
    return (rs.randint(-4, 5, shape) / den).astype(np.float32)


def _mha(seed, dtype):
    """A JAX and a port attention layer with dyadic weights: x @ w is
    exact in f32 in both packages."""
    rs = np.random.RandomState(seed)
    jm = jnn.MultiHeadAttention(D, HEADS, causal=True)
    tm = tnn.MultiHeadAttention(D, HEADS, causal=True)
    params = {k: _dyadic(rs, (D, D)) for k in ("wq", "wk", "wv", "wo")}
    load_jax_variables(tm, {"params": params, "state": {}})
    return jm, jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, JDT[dtype]), params), tm.to(dtype), rs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_apply_cached_writes_exactly(dtype):
    """Rows at lengths 3 and 10 of a 12-slot cache take a 4-token chunk:
    the second row's positions 12 and 13 drop their writes; every slot
    not written keeps its value, bit for bit."""
    jm, jp, tm, rs = _mha(4, dtype)
    x = _dyadic(rs, (2, 4, D))
    cache = {"k": _dyadic(rs, (2, HEADS, 12, D // HEADS)),
             "v": _dyadic(rs, (2, HEADS, 12, D // HEADS)),
             "length": np.array([3, 10], np.int32)}
    want, wc = jm.apply_cached(jp, jnp.asarray(x, JDT[dtype]), jax.tree_util
                               .tree_map(lambda a: jnp.asarray(
                                   a, JDT[dtype] if a.dtype == np.float32
                                   else a.dtype), cache))
    got, gc = tm.apply_cached(torch.tensor(x).to(dtype),
                              _to_torch(cache, dtype))
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(gc[name]),
                                      np.asarray(wc[name], np.float32))
    np.testing.assert_array_equal(gc["length"].numpy(), [7, 14])
    assert _rel(got.detach(), want.astype(jnp.float32)) < TOL[dtype]


def _pool(rs, quantized, pages=9, page=4):
    shape = (pages, page, HEADS, D // HEADS)
    if quantized:
        return {"k": rs.randint(-127, 128, shape).astype(np.int8),
                "v": rs.randint(-127, 128, shape).astype(np.int8),
                "k_scale": rs.rand(*shape[:3]).astype(np.float32) / 64,
                "v_scale": rs.rand(*shape[:3]).astype(np.float32) / 64,
                "length": np.array([5, 2, 9], np.int32)}
    return {"k": _dyadic(rs, shape), "v": _dyadic(rs, shape),
            "length": np.array([5, 2, 9], np.int32)}


# slot 0 owns pages 3, 1, 7; slot 1 (inactive) 2, 4; slot 2 5, 6, 8
TABLE = np.array([[3, 1, 7], [2, 4, 0], [5, 6, 8]], np.int32)
ACTIVE = np.array([True, False, True])


def _check_pool(got, want):
    """Every leaf bit-equal outside the trash page 0."""
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        if name == "length":
            np.testing.assert_array_equal(g, w)
        else:
            assert got[name].dtype == {np.int8: torch.int8}.get(
                w.dtype.type, torch.float32)
            np.testing.assert_array_equal(g[1:], w[1:], err_msg=name)


@pytest.mark.parametrize("kind", ["f32", "int8", "int8_kernel_route"])
def test_apply_paged(kind, monkeypatch):
    """A 3-token chunk through the block table: slot 2 runs past its
    12-token extent (positions 9-11 fit, none spill), slot 1 is inactive
    (its writes go to page 0).  ``int8_kernel_route`` forces the kernel-7
    route in both packages (JAX's TPU gate, the port's CUDA gate), whose
    scores the CPU computes with the kernel's plain version."""
    quantized = kind != "f32"
    if kind == "int8_kernel_route":
        monkeypatch.setattr(jkv, "_int8_eligible", lambda *a: True)
        monkeypatch.setattr(tkv, "_int8_eligible", lambda *a: True)
    jm, jp, tm, rs = _mha(5, torch.float32)
    x = _dyadic(rs, (3, 3, D))
    pool = _pool(rs, quantized)
    want, wp = jm.apply_paged(jp, jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, pool), jnp.asarray(TABLE), jnp.asarray(ACTIVE))
    got, gp = tm.apply_paged(torch.tensor(x), _to_torch(pool),
                             torch.tensor(TABLE), torch.tensor(ACTIVE))
    _check_pool(gp, wp)
    np.testing.assert_array_equal(gp["length"].numpy(), [8, 5, 12])
    live = np.asarray(ACTIVE)  # an inactive row's output is ignored
    assert _rel(got.detach()[live], np.asarray(want)[live]) < 1e-5


def test_int8_scores_bit_equal():
    rs = np.random.RandomState(6)
    q = rs.randn(2, 3, 5, 16).astype(np.float32)
    k_q = rs.randint(-127, 128, (2, 3, 40, 16)).astype(np.int8)
    k_s = (rs.rand(2, 3, 40) / 100).astype(np.float32)
    want = jkv.int8_scores(jnp.asarray(q), jnp.asarray(k_q),
                           jnp.asarray(k_s), jnp.float32)
    got = tkv.int8_scores(torch.tensor(q), torch.tensor(k_q),
                          torch.tensor(k_s), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_eligibility_rule_matches_candidate_params():
    """The port's shape rule is JAX's ``candidate_params`` on both of the
    score route's products; the device gate is CUDA (TPU in JAX)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for tq in (1, 2, 4, 8, 12, 16, 24, 64, 100, 128, 1024, 4096):
        for length in (64, 128, 256, 384, 512, 4096, 65536, 131072):
            for d in (12, 64, 128, 256):
                want = (bool(candidate_params((tq, d, length)))
                        and bool(candidate_params((tq, length, d))))
                assert tkv._int8_eligible(tq, length, d, cuda) == want, \
                    (tq, length, d)
                assert not tkv._int8_eligible(tq, length, d, cpu)
    assert tkv._int8_eligible(16, 512, 128, cuda)
    assert not tkv._int8_eligible(1, 512, 128, cuda)  # a decode step


def test_paged_pool_ops():
    """quantize_kv, init_pool, page_bytes, flat_positions and the gathers
    against JAX's on the same inputs."""
    rs = np.random.RandomState(7)
    x = (rs.randn(4, 6, 12) * 3).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero row: the 1e-8 floor
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(torch.tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    half = np.full((1, 3), 0.5, np.float32) * np.array([1, 3, 5])  # ties
    half = np.concatenate([half, [[127.0]]], 1)
    np.testing.assert_array_equal(
        tkv.quantize_kv(torch.tensor(half))[0].numpy(),
        np.asarray(jkv.quantize_kv(jnp.asarray(half))[0]))
    for quantized in (False, True):
        jp = jkv.init_pool(9, 4, HEADS, 12, 3, quantized=quantized)
        tp = tkv.init_pool(9, 4, HEADS, 12, 3, quantized=quantized)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tp.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
        assert tkv.is_quantized(tp) == quantized
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            assert tkv.page_bytes(16, 8, 32, dt, quantized) == \
                jkv.page_bytes(16, 8, 32, jdt, quantized)
    pos = np.array([[0, 3, 4, 11, 12, -1], [5, 6, 7, 8, 9, 10],
                    [1, 2, 3, 4, 5, 6]], np.int32)
    np.testing.assert_array_equal(
        tkv.flat_positions(torch.tensor(TABLE), torch.tensor(pos),
                           torch.tensor(ACTIVE), 4, 12).numpy(),
        np.asarray(jkv.flat_positions(jnp.asarray(TABLE), jnp.asarray(pos),
                                      jnp.asarray(ACTIVE), 4, 12)))
    assert tkv.num_logical_pages(13, 4) == jkv.num_logical_pages(13, 4) == 4
    pool = _pool(rs, True)
    jpool = jax.tree_util.tree_map(jnp.asarray, pool)
    for got, want in zip(
            tkv.paged_gather(_to_torch(pool), torch.tensor(TABLE), 4,
                             torch.float32)
            + tkv.paged_gather_q(_to_torch(pool), torch.tensor(TABLE), 4),
            jkv.paged_gather(jpool, jnp.asarray(TABLE), 4, jnp.float32)
            + jkv.paged_gather_q(jpool, jnp.asarray(TABLE), 4)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k_q = tkv.paged_gather_q(_to_torch(pool), torch.tensor(TABLE), 4)[0]
    assert k_q[1, 2].is_contiguous()  # each (slot, head) block


# ------------------------------------------------------ the paged model
@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_pool", "int8_pool"])
def test_extend_and_decode_step_paged(lm32, kv):
    """Two chunks of 4 through extend_paged, the last padded (advance 3),
    then three decode_step_paged, slot 1 inactive throughout."""
    jm, jv, tm, dtype = lm32
    p, s = jv["params"], jv["state"]
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    active = np.array([True, False, True])
    jc = jm.init_paged_cache(10, 4, 3, kv_dtype=kv)
    tc = tm.init_paged_cache(10, 4, 3, kv_dtype=kv)
    ids = _ids(8, 3, 8)
    for lo, adv in ((0, None), (4, np.array([3, 3, 3], np.int32))):
        jl, jc = jm.extend_paged(p, s, jc, jnp.asarray(table),
                                 jnp.asarray(ids[:, lo:lo + 4]),
                                 jnp.asarray(active), advance=None
                                 if adv is None else jnp.asarray(adv))
        tl, tc = tm.extend_paged(tc, torch.tensor(table),
                                 torch.tensor(ids[:, lo:lo + 4]),
                                 torch.tensor(active), advance=None
                                 if adv is None else torch.tensor(adv))
        assert _rel(tl[active], np.asarray(jl)[active]) < 1e-5
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl if jl.ndim == 2 else jl[:, 2],
                                    axis=-1)).astype(np.int32)
        jl, jc = jm.decode_step_paged(p, s, jc, jnp.asarray(table),
                                      jnp.asarray(tok), jnp.asarray(active))
        tl, tc = tm.decode_step_paged(tc, torch.tensor(table),
                                      torch.tensor(tok), torch.tensor(active))
        assert _rel(tl[active], np.asarray(jl)[active]) < 1e-5
    for lk in jc:
        np.testing.assert_array_equal(tc[lk]["length"].numpy(),
                                      np.asarray(jc[lk]["length"]))
        assert tc[lk]["length"].tolist() == [10, 10, 10]
    if kv == "int8":
        assert tc["layer0"]["k"].dtype == torch.int8


# -------------------------------------------------------- beam search
def _table_fn(table, eos_cost):
    """A deterministic step function on a (T, V, V) logits table: row
    ``table[i, last token]``, plus a dict cache of per-beam token counts
    (leaves with trailing dims, gathered with the beams) that nudges
    tokens already seen: both packages, same arithmetic."""
    t, v, _ = table.shape

    def jfn(ids, i, cache):
        tok = jax.lax.dynamic_index_in_dim(ids, i, axis=1, keepdims=False)
        acc = cache["acc"][:, :, 0] + jax.nn.one_hot(tok, v)
        logits = jnp.asarray(table)[i][tok] - eos_cost * (acc > 1)
        return logits, {"acc": acc[:, :, None], "step": cache["step"] + 1}

    def tfn(ids, i, cache):
        tok = ids.index_select(1, i.to(torch.int64).reshape(1))[:, 0]
        acc = cache["acc"][:, :, 0] + torch.nn.functional.one_hot(
            tok.to(torch.int64), v).float()
        logits = torch.tensor(table)[i.to(torch.int64)][tok.to(
            torch.int64)] - eos_cost * (acc > 1).float()
        return logits, {"acc": acc[:, :, None], "step": cache["step"] + 1}

    return jfn, tfn


@pytest.mark.parametrize("beam,alpha", [(1, 0.6), (3, 0.6), (4, 0.0)])
def test_sequence_beam_search_with_ties(beam, alpha):
    """Logits on a few integer levels: many exact ties within a row (the
    lower token first), EOS (token 5) scattered so that beams finish at
    several steps, and the empty finished pool's NEG_INF ties at the
    first step."""
    v, t = 6, 6
    rs = np.random.RandomState(9)
    table = rs.randint(0, 3, (t, v, v)).astype(np.float32)
    table[:, :, 5] -= rs.randint(0, 2, (t, v))
    jfn, tfn = _table_fn(table, 0.5)
    init = np.array([2, 4, 0], np.int32)
    cache0 = {"acc": np.zeros((3, v, 1), np.float32),
              "step": np.zeros((3,), np.int32)}
    jsearch = jnn.SequenceBeamSearch(v, beam, alpha, t, eos_id=5)
    tsearch = tnn.SequenceBeamSearch(v, beam, alpha, t, eos_id=5)
    ws, wsc = jsearch.search(jnp.asarray(init), jax.tree_util.tree_map(
        jnp.asarray, cache0), fn=jfn)
    gs, gsc = tsearch.search(torch.tensor(init), _to_torch(cache0), fn=tfn)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gsc.numpy(), np.asarray(wsc), rtol=1e-6)
    # the compiled route (its CPU form: the donated step, eager)
    cs, csc = tsearch.search(torch.tensor(init), _to_torch(cache0), fn=tfn,
                             compiled={})
    assert torch.equal(cs, gs) and torch.equal(csc, gsc)


def test_beam_search_helpers():
    rs = np.random.RandomState(10)
    tree = {"len": rs.randint(0, 9, (2, 3)).astype(np.int32),
            "kv": rs.rand(2, 3, 4, 5).astype(np.float32)}
    idx = np.array([[2, 0, 0], [1, 1, 2]])
    want = jbs._gather_beams(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(idx))
    got = tbs._gather_beams(_to_torch(tree), torch.tensor(idx))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for length in (2, 7, 129):
        np.testing.assert_allclose(
            tbs._length_norm(0.6, torch.tensor(length, dtype=torch.int32)
                             ).item(),
            float(jbs._length_norm(0.6, jnp.int32(length))), rtol=1e-7)
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    vals, ix = tbs._top_k(x, 4)
    assert ix.tolist() == [[1, 2, 4, 0]]
    wv, wi = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert ix.tolist() == np.asarray(wi).tolist()
    assert tbs.NEG_INF == jbs.NEG_INF


@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("use_cache", [True, False], ids=["cached",
                                                          "reforward"])
def test_generate_matches_jax(lm32, beam, use_cache):
    jm, jv, tm, dtype = lm32
    start = np.array([1, 7], np.int32)
    ws, wsc = jm.generate(jv["params"], jv["state"], jnp.asarray(start), 8,
                          beam_size=beam, use_cache=use_cache)
    gs, gsc = tm.generate(torch.tensor(start), 8, beam_size=beam,
                          use_cache=use_cache)
    assert tuple(gs.shape) == (2, beam, 9)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gsc.numpy(), np.asarray(wsc), rtol=1e-5)
