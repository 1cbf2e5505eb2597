"""The port's Transformer LM and its modules against the JAX package's.

Small sizes (hidden 32, 4 heads, filter 64, 1-2 layers, vocab 50, T 32,
batch 2-3).  The JAX module's ``init`` gives the tree's shape; every leaf
is redrawn with numpy from a seed (LayerNorm weights around 1, biases
around 0) and the tree is loaded into both packages.  f32 throughout:
outputs within 1e-5 relative (max |d| over max |want|), the whole LM's
parameter gradients within 1e-4 relative L2 per leaf (with LayerNorm and
no BatchNorm the model is well conditioned).  Dropout 0 for parity:
torch cannot draw JAX's threefry bits, so dropout is held to its own
properties instead.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.attention import PositionEncode as JaxPositionEncode
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import export_variables, flatten, load_jax_variables

VOCAB, D, HEADS, FILTER = 50, 32, 4, 64


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _random_tree(jax_module, seed):
    """The module's JAX ``{"params", "state"}`` tree with every leaf
    redrawn in numpy."""
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


def _both(jax_module, torch_module, seed=0):
    v = _random_tree(jax_module, seed)
    load_jax_variables(torch_module, v)
    return v, torch_module.eval()


def _tokens(seed, n=3, t=32):
    return np.random.RandomState(seed).randint(0, VOCAB, (n, t))


def _acts(seed, n=3, t=32, d=D):
    return np.random.RandomState(seed).randn(n, t, d).astype(np.float32)


def test_lookup_table_padding_and_max_norm():
    jm = jnn.LookupTable(10, 6, padding_value=0, max_norm=1.0)
    tm = tnn.LookupTable(10, 6, padding_value=0, max_norm=1.0)
    v = {"params": {"weight": (2.0 * np.random.RandomState(1).randn(10, 6))
                    .astype(np.float32)}, "state": {}}
    load_jax_variables(tm, v)
    idx = np.array([[0, 3, 9, 3], [1, 0, 2, 5]])
    cot = np.random.RandomState(2).randn(2, 4, 6).astype(np.float32)
    want, _ = jm.apply(v["params"], {}, jnp.asarray(idx))
    got = tm(torch.tensor(idx))
    assert _rel(got.detach(), want) < 1e-6
    assert not got[0, 0].any() and not got[1, 1].any()  # padding rows
    jg = jax.grad(lambda p: jnp.sum(jm.apply(p, {}, jnp.asarray(idx))[0]
                                    * cot))(v["params"])
    (got * torch.tensor(cot)).sum().backward()
    assert _rel(tm.weight.grad, jg["weight"]) < 1e-5
    # init zeroes the padding row
    assert not tnn.LookupTable(10, 6, padding_value=3).weight[3].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_normalization(dtype):
    jm, tm = jnn.LayerNormalization(D), tnn.LayerNormalization(D)
    v, tm = _both(jm, tm, 3)
    x = _acts(4) * 3.0 + 1.0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want, _ = jm.apply(v["params"], {}, jnp.asarray(x, jdt))
    got = tm(torch.tensor(x).to(dtype))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert _rel(got.float().detach(), want.astype(jnp.float32)) < tol


def test_position_encode_and_encode_at():
    x = _acts(5)
    want, _ = JaxPositionEncode().apply({}, {}, jnp.asarray(x))
    got = tnn.PositionEncode()(torch.tensor(x))
    assert _rel(got, want) < 1e-5
    pos = np.array([[0, 7, 100], [3, 4095, 12]])
    want = JaxPositionEncode.encode_at(jnp.asarray(pos), D, jnp.float32)
    got = tnn.PositionEncode.encode_at(torch.tensor(pos), D, torch.float32)
    assert tuple(got.shape) == (2, 3, D)
    assert _rel(got, want) < 1e-5
    bf = tnn.PositionEncode.encode_at(torch.tensor(pos), D, torch.bfloat16)
    assert bf.dtype == torch.bfloat16  # computed in f32, then cast


@pytest.mark.parametrize("causal", [True, False])
def test_multi_head_attention(causal):
    jm = jnn.MultiHeadAttention(D, HEADS, causal=causal)
    v, tm = _both(jm, tnn.MultiHeadAttention(D, HEADS, causal=causal), 6)
    x = _acts(7)
    want, _ = jm.apply(v["params"], {}, jnp.asarray(x))
    assert _rel(tm(torch.tensor(x)).detach(), want) < 1e-5


def test_multi_head_attention_cross_and_mask():
    jm = jnn.MultiHeadAttention(D, HEADS)
    v, tm = _both(jm, tnn.MultiHeadAttention(D, HEADS), 8)
    q, kv = _acts(9, t=16), _acts(10, t=24)
    mask = np.random.RandomState(11).rand(3, 1, 16, 24) > 0.3
    for inputs in ((q, kv), (q, kv, mask)):
        want, _ = jm.apply(v["params"], {}, tuple(jnp.asarray(a)
                                                  for a in inputs))
        got = tm(tuple(torch.tensor(a) for a in inputs))
        assert _rel(got.detach(), want) < 1e-5


def test_feed_forward_network():
    jm = jnn.FeedForwardNetwork(D, FILTER)
    v, tm = _both(jm, tnn.FeedForwardNetwork(D, FILTER), 12)
    x = _acts(13)
    want, _ = jm.apply(v["params"], {}, jnp.asarray(x))
    assert _rel(tm(torch.tensor(x)).detach(), want) < 1e-5


def test_transformer_layer():
    jm = jnn.TransformerLayer(D, HEADS, FILTER, causal=True)
    v, tm = _both(jm, tnn.TransformerLayer(D, HEADS, FILTER, causal=True),
                  14)
    assert tm.child_keys == ["ln1", "mha", "ln2", "ffn"]
    x = _acts(15)
    want, _ = jm.apply(v["params"], v["state"], jnp.asarray(x))
    assert _rel(tm(torch.tensor(x)).detach(), want) < 1e-5


def _lm(layers=2):
    jm = jnn.Transformer(VOCAB, D, HEADS, FILTER, layers, dropout=0.0)
    tm = tnn.Transformer(VOCAB, D, HEADS, FILTER, layers, dropout=0.0)
    return jm, tm


def test_transformer_tree_carries_across():
    """The JAX model's own init tree loads by name and comes back out in
    the same shape, empty subtrees included."""
    jm, tm = _lm()
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    out = load_jax_variables(tm, tree)
    assert tm.child_keys == ["embed", "pos", "drop", "layer0", "layer1",
                             "ln_f"]
    assert jax.tree_util.tree_structure(out) == \
        jax.tree_util.tree_structure(tree)
    for k, a in flatten(tree["params"]).items():
        np.testing.assert_array_equal(flatten(out["params"])[k], a)


def test_transformer_logits():
    jm, tm = _lm()
    v, tm = _both(jm, tm, 16)
    x = _tokens(17)
    want, _ = jm.apply(v["params"], v["state"], jnp.asarray(x))
    got = tm(torch.tensor(x))
    assert tuple(got.shape) == (3, 32, VOCAB)
    assert _rel(got.detach(), want) < 1e-5


def test_time_distributed_criterion():
    rs = np.random.RandomState(18)
    logits = rs.randn(3, 32, VOCAB).astype(np.float32)
    tgt = rs.randint(0, VOCAB, (3, 32))
    want = jnn.TimeDistributedCriterion(
        jnn.ClassNLLCriterion(logits=True)).forward(jnp.asarray(logits),
                                                    jnp.asarray(tgt))
    got = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(logits=True))(
        torch.tensor(logits), torch.tensor(tgt))
    assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))


def test_lm_loss_gradient_matches_jax_grad():
    """The whole model's gradient, the weight-tied embedding (lookup and
    head) included, per leaf within 1e-4 relative L2."""
    jm, tm = _lm()
    v, tm = _both(jm, tm, 19)
    x, y = _tokens(20), _tokens(21)
    jcrit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(logits=True))
    tcrit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(logits=True))

    def jloss(p):
        out, _ = jm.apply(p, v["state"], jnp.asarray(x), training=True)
        return jcrit.forward(out, jnp.asarray(y))

    jl, jg = jax.value_and_grad(jloss)(v["params"])
    params = {k: p.detach().requires_grad_(True)
              for k, p in tm.named_parameters()}
    tm.train()
    loss = tcrit(functional_call(tm, params, (torch.tensor(x),)),
                 torch.tensor(y))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(loss.item() - float(jl)) < 1e-5 * float(jl)
    jg = flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert jg.keys() == grads.keys()
    for k, w in jg.items():
        rel = np.linalg.norm(grads[k].numpy() - w) / np.linalg.norm(w)
        assert rel < 1e-4, (k, rel)


# ----------------------------------------------------------- dropout
def test_dropout_properties():
    p = 0.3
    drop = tnn.Dropout(p).train()
    x = torch.ones(400, 500)
    y = drop(x, rng=123)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        1 / (1 - p)))
    assert torch.equal(drop(x, rng=123), y)            # same seed, same mask
    assert not torch.equal(drop(x, rng=124) != 0, kept)
    assert drop(torch.ones(4, dtype=torch.bfloat16),
                rng=1).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="needs an rng"):
        drop(x)
    assert drop.eval()(x) is x                          # eval: identity
    assert tnn.Dropout(0.0).train()(x) is x             # p = 0: identity


def test_split_rng_streams():
    seeds = {tnn.split_rng(7, i) for i in range(100)}
    seeds |= {tnn.split_rng(8, i) for i in range(100)}
    assert len(seeds) == 200 and all(0 <= s < 2 ** 63 for s in seeds)
    assert tnn.split_rng(7, 3) == tnn.split_rng(7, 3)
    assert tnn.split_rng(None, 3) is None


def test_transformer_dropout_streams():
    """Training with dropout: the same seed gives the same logits, another
    seed others; evaluation and a p = 0 model ignore the seed; training
    with p > 0 and no seed raises in ``drop``, as in JAX."""
    tm = tnn.Transformer(VOCAB, D, HEADS, FILTER, 1, dropout=0.2)
    tm.initialize(torch.Generator().manual_seed(0))
    x = torch.tensor(_tokens(22))
    tm.train()
    a, b, c = tm(x, rng=5), tm(x, rng=5), tm(x, rng=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="needs an rng"):
        tm(x)
    tm.eval()
    assert torch.equal(tm(x, rng=5), tm(x))


def test_initializers_use_the_generator():
    xa = tnn.Xavier()(torch.Generator().manual_seed(1), (200, 300),
                      fan_in=200, fan_out=300)
    xb = tnn.Xavier()(torch.Generator().manual_seed(1), (200, 300),
                      fan_in=200, fan_out=300)
    bound = math.sqrt(6.0 / 500)
    assert torch.equal(xa, xb)
    assert xa.abs().max() <= bound and xa.abs().max() > 0.95 * bound
    rn = tnn.RandomNormal(0.5, 0.1)(torch.Generator().manual_seed(2),
                                    (100000,))
    assert abs(rn.mean().item() - 0.5) < 2e-3
    assert abs(rn.std().item() - 0.1) < 2e-3
    tm = tnn.Transformer(VOCAB, D, HEADS, FILTER, 1)
    tm.initialize(torch.Generator().manual_seed(3))
    assert abs(tm.embed.weight.std().item() - D ** -0.5) < 0.02
    w = export_variables(tm)["params"]
    assert not w["layer0"]["ffn"]["b1"].any()
    np.testing.assert_array_equal(w["ln_f"]["weight"], 1.0)


def test_later_slices_raise():
    """Decoding and parallelism are ported (tests/test_torch_decode*.py,
    tests/test_torch_{tensor,sequence}_parallel.py, test_torch_expert.py);
    what the JAX package refuses, the port refuses alike."""
    tm = tnn.Transformer(VOCAB, D, HEADS, FILTER, 1, causal=False)
    with pytest.raises(ValueError, match="needs a causal Transformer"):
        tm.generate(torch.zeros(2, dtype=torch.int32), 4)
    mha = tnn.MultiHeadAttention(D, HEADS)
    mha.seq_mesh = object()  # as a layer built for ring attention holds
    for call in (lambda: mha.init_cache(2, 8),
                 lambda: mha.init_paged_cache(5, 4, 2)):
        with pytest.raises(ValueError, match="does not compose with "
                                             "seq_mesh"):
            call()
    moe = tnn.Transformer(VOCAB, D, HEADS, FILTER, 1, moe_experts=4)
    assert type(moe.layer0.ffn).__name__ == "MoE"
    with pytest.raises(ValueError, match="unknown seq_mode"):
        tnn.MultiHeadAttention(D, HEADS, seq_mesh=object(), seq_mode="x")
