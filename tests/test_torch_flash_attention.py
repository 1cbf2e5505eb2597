"""The port's flash attention against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.

- ``flash_attention_plain`` (the kernel's plain version, which CPU
  tensors run) against JAX's Pallas kernel in interpret mode
  (``_flash_fwd_pallas(..., interpret=True)``) at the same key block
  (64): O and the f32 logsumexp.  f32 within 1e-5 of max|O| (max|lse|).
  bf16 within one bf16 step at the largest |O| (|lse|), i.e.
  ``2**(floor(log2(max)) - 7)``: the two
  keep the same rounding points, except that XLA on the CPU does not
  round ``q * sm_scale`` to bf16 before the product, which the kernel's
  jaxpr asks for and the port does.
- A ragged T (40, 100: no multiple of the key block) against JAX's
  ``dot_product_attention(use_flash=False)`` in f32, 1e-5 of max|O|.
- dq, dk, dv of ``_Flash`` against ``jax.grad`` of
  ``flash_attention(..., interpret=True)`` (whose backward is
  ``_bwd_blockwise``), f32, 1e-5 relative L2.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.ops.attention import dot_product_attention as jax_dpa
from bigdl_tpu.ops.pallas.flash_attention import _flash_fwd_pallas
from bigdl_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash
from bigdl_tpu_torch.ops import dot_product_attention
from bigdl_tpu_torch.ops import flash_attention as fa

TOL = {"f32": lambda m: 1e-5 * m,
       "bf16": lambda m: 2.0 ** (np.floor(np.log2(m)) - 7)}  # one step
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(seed, b, h, t, s, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, n, d).astype(np.float32) for n in (t, s, s)]


def _close(got, want, tol, what):
    """max |got - want| within ``tol(max |want|)``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol(scale), (what, err, scale)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,s,d,causal", [
    (2, 2, 128, 128, 32, True),
    (2, 2, 128, 128, 32, False),
    (1, 2, 64, 192, 16, False),   # KV longer than Q
    (1, 2, 128, 128, 16, True),
])
def test_plain_matches_interpret_kernel(dt, b, h, t, s, d, causal):
    tdt, jdt = DT[dt]
    q, k, v = _qkv(1, b, h, t, s, d)
    jo, jl = _flash_fwd_pallas(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                               causal, 1.0 / np.sqrt(d), 64, fa.BLOCK_K,
                               True)
    to, tl = fa.flash_attention_plain(
        *(torch.tensor(x).to(tdt) for x in (q, k, v)), causal)
    assert to.dtype == tdt and tl.dtype == torch.float32
    assert tuple(tl.shape) == (b, h, t)
    _close(to.float().numpy(), jo.astype(jnp.float32), TOL[dt], "O")
    _close(tl.numpy(), jl, TOL[dt], "lse")


@pytest.mark.parametrize("t,s,causal", [(40, 40, True), (40, 100, False),
                                        (100, 100, True)])
def test_ragged_lengths_match_plain_attention(t, s, causal):
    q, k, v = _qkv(2, 2, 3, t, s, 32)
    want = jax_dpa(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                   use_flash=False)
    got = dot_product_attention(*(torch.tensor(x) for x in (q, k, v)),
                                causal=causal)
    _close(got.numpy(), want, TOL["f32"], "O")
    # the kernel's plain version itself, with a short last key block
    o, _ = fa.flash_attention_plain(*(torch.tensor(x) for x in (q, k, v)),
                                    causal)
    _close(o.numpy(), want, TOL["f32"], "O plain")


@pytest.mark.parametrize("t,s,causal", [(64, 64, True), (64, 64, False),
                                        (32, 96, False)])
def test_gradients_match_jax_grad(t, s, causal):
    q, k, v = _qkv(3, 2, 2, t, s, 16)
    g = np.random.RandomState(4).randn(2, 2, t, 16).astype(np.float32)

    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal=causal, block_q=32, block_k=32,
                      interpret=True)
        return jnp.sum(o * g)

    want = jax.grad(loss, (0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (fa.flash_attention(tq, tk, tv, causal) * torch.tensor(g)).sum().backward()
    for name, w, got in zip("qkv", want, (tq, tk, tv)):
        w = np.asarray(w)
        rel = np.linalg.norm(got.grad.numpy() - w) / np.linalg.norm(w)
        assert rel < 1e-5, (name, rel)


def test_backward_blocks_agree():
    """The backward's memory bound comes from its query blocks; the
    blocking does not change the gradients."""
    q, k, v = (torch.tensor(x) for x in _qkv(5, 1, 2, 96, 96, 16))
    o, lse = fa.flash_attention_plain(q, k, v, True)
    g = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    whole = fa._flash_backward(q, k, v, o, lse, g, True, 0.25)
    blocked = fa._flash_backward(q, k, v, o, lse, g, True, 0.25, block_q=40)
    for a, b in zip(whole, blocked):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_causal_needs_matching_lengths():
    q, k, v = (torch.tensor(x) for x in _qkv(6, 1, 1, 32, 64, 16))
    for fn in (fa.flash_attention, fa.flash_attention_plain,
               fa.flash_attention_lse):
        with pytest.raises(ValueError, match="matching q/kv"):
            fn(q, k, v, True)
    with pytest.raises(ValueError, match="matching q/kv"):
        jax_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True)


def test_cpu_tensor_runs_the_plain_version_and_counts_nothing():
    q, k, v = (torch.tensor(x) for x in _qkv(7, 2, 2, 64, 64, 32))
    fa.reset_launches()
    o = fa.flash_attention(q, k, v, causal=True)
    po, _ = fa.flash_attention_plain(q, k, v, True)
    assert torch.equal(o, po)
    assert fa.LAUNCHES == {"flash_attention": 0}


def test_other_devices_have_no_route():
    q = torch.empty((1, 1, 8, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        fa.flash_attention_lse(q, q, q)


def test_masked_path_takes_no_kernel():
    """A mask (or use_flash=False) takes the plain einsum path, held
    against JAX's with the mask broadcast over heads."""
    q, k, v = _qkv(8, 2, 2, 16, 24, 16)
    mask = np.random.RandomState(9).rand(2, 1, 16, 24) > 0.3
    want = jax_dpa(*(jnp.asarray(x) for x in (q, k, v)),
                   mask=jnp.asarray(mask))
    got = dot_product_attention(*(torch.tensor(x) for x in (q, k, v)),
                                mask=torch.tensor(mask))
    _close(got.numpy(), want, TOL["f32"], "masked O")
