"""Host-side plans of the wgmma kernels, on the CPU.

- ``_conv3_plan`` (kernel 4's tiling) at ResNet-50's four 3x3 shapes at
  batches 1, 32 and 256, plus ragged ones: its row and column tiles cover
  M and Co exactly once, its slices cut the reduction (9 taps x 64-channel
  chunks) into whole steps, in whole x windows of 3 taps, and at batch 32
  on 132 SMs it launches at least 132 blocks.
- ``_matmul_plan`` (kernel 1) and ``_wgrad_plan`` (kernel 3) at the 16
  (M, K, N) shapes of a ResNet-50 forward at batches 1, 32 and 256, plus
  ragged ones: the tiles cover the output's rows and columns exactly
  once, the slices cut the reduction (64 channels of K, or 64 rows of M)
  into whole steps, none empty, and each plan is a function of its
  arguments alone.
- ``_dgrad_plan`` (kernel 2) at the same matmul shapes and
  ``_conv3_dgrad_plan`` (kernel 5) at the conv shapes: the kernel's walk
  of its work items (written out here as the kernel does it) covers
  every output tile of every slice exactly once, the persistent grid of
  kernel 2 is a multiple of the column tiles without a split (each block
  keeps one column tile, whose partial row it writes), the reduction is
  split only where the tiles leave three quarters of the SMs idle (never
  at ResNet-50's batch 32 and 256), and each plan is a function of its
  arguments alone.
- The flash kernel's plain version at the bf16 kernel's key block
  (``BLOCK_K``, 128; p rounds against the running max of its key block)
  against JAX's Pallas kernel in interpret mode at the same block, at
  D 32/64/128, causal and not, f32 within 1e-5 of max|O| (max|lse|) and
  bf16 within one bf16 step at the largest |O| (|lse|), as
  ``test_torch_flash_attention.py`` states; and against JAX's XLA path
  (``dot_product_attention(use_flash=False)``) at ragged T and S in f32,
  1e-5 of max|O|.
"""
from collections import Counter

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu.ops.attention import dot_product_attention as jax_dpa
from bigdl_tpu.ops.pallas.flash_attention import _flash_fwd_pallas
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import fused_matmul as tfm

SMS = 132  # an H100 SXM
RESNET50_CONV3 = [(56, 64), (28, 128), (14, 256), (7, 512)]  # (hw, c = co)
TOL = {"f32": lambda m: 1e-5 * m,
       "bf16": lambda m: 2.0 ** (np.floor(np.log2(m)) - 7)}  # one step
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def _check_plan(b, h, w, c, co, sms=SMS):
    plan = tfm._conv3_plan(b, h, w, c, co, sms)
    m = b * h * w
    rows, cols = -(-m // plan.bm), -(-co // plan.bn)
    # tiles cover M and Co exactly once: no tile starts past the end
    assert (rows - 1) * plan.bm < m <= rows * plan.bm
    assert (cols - 1) * plan.bn < co <= cols * plan.bn
    assert plan.bn in (64, 128, 256) and plan.bm == 128
    # the slices partition the reduction into whole steps and windows
    assert plan.steps == 9 * -(-c // 64)
    assert plan.per % 3 == 0 and plan.per > 0
    assert (plan.slices - 1) * plan.per < plan.steps <= plan.slices * plan.per
    bounds = [(z * plan.per, min(plan.steps, (z + 1) * plan.per))
              for z in range(plan.slices)]
    assert all(lo < hi for lo, hi in bounds)
    assert sum(hi - lo for lo, hi in bounds) == plan.steps
    return plan, rows * cols * plan.slices


@pytest.mark.parametrize("batch", [1, 32, 256])
@pytest.mark.parametrize("hw,c", RESNET50_CONV3)
def test_conv3_plan_covers_and_fills(batch, hw, c):
    plan, blocks = _check_plan(batch, hw, hw, c, c)
    if batch == 32:
        assert blocks >= SMS, plan
    if batch == 256:  # the grid fills the card without a split
        assert plan.slices == 1, plan


@pytest.mark.parametrize("shape", [(3, 7, 7, 512, 512), (2, 5, 5, 16, 24),
                                   (1, 1, 1, 8, 8), (5, 9, 11, 72, 200)])
def test_conv3_plan_ragged_shapes(shape):
    _check_plan(*shape)
    _check_plan(*shape, sms=16)


def test_conv3_plan_is_a_function_of_its_arguments():
    assert tfm._conv3_plan(32, 7, 7, 512, 512, SMS) == \
        tfm._conv3_plan(32, 7, 7, 512, 512, SMS)
    # fewer SMs need fewer slices to fill
    assert tfm._conv3_plan(32, 7, 7, 512, 512, 16).slices <= \
        tfm._conv3_plan(32, 7, 7, 512, 512, SMS).slices


def _resnet50_calls(batch):
    """The (M, K, N, prologue) of one fused ResNet-50 forward's matmuls."""
    calls, n_in, res = set(), 64, 56
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** stage
        for b in range(n_blocks):
            ro = res // (2 if stage > 0 and b == 0 else 1)
            calls.add((batch * res * res, n_in, planes, False))
            calls.add((batch * ro * ro, planes, 4 * planes, True))
            if ro != res or n_in != 4 * planes:
                calls.add((batch * ro * ro, n_in, 4 * planes, False))
            n_in, res = 4 * planes, ro
    return calls


def _resnet50_matmuls(batch):
    """The distinct (M, K, N) among them (the plans ignore the prologue)."""
    return sorted({c[:3] for c in _resnet50_calls(batch)})


def _check_slices(plan, depth):
    """``plan.slices`` whole runs of ``plan.per`` steps, none empty, over
    the ``depth / 64`` steps of the reduction."""
    assert plan.steps == -(-depth // 64)
    assert plan.per > 0
    assert (plan.slices - 1) * plan.per < plan.steps <= plan.slices * plan.per


def _covers(size, tile):
    tiles = -(-size // tile)
    return (tiles - 1) * tile < size <= tiles * tile


MATMUL_SHAPES = [s for b in (1, 32, 256) for s in _resnet50_matmuls(b)] + [
    (147, 2048, 512), (300, 72, 136), (1, 8, 8), (4099, 256, 64)]


def test_the_call_table_has_sixteen_shapes():
    assert all(len(_resnet50_calls(b)) == 16 for b in (1, 32, 256))


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_matmul_plan_covers_and_slices(m, k, n):
    for sms in (SMS, 16):
        plan = tfm._matmul_plan(m, k, n, sms)
        assert plan.bm == 128 and plan.bn in (64, 128)
        assert _covers(m, plan.bm) and _covers(n, plan.bn)
        _check_slices(plan, k)
        # persistent blocks: one per SM, at most one per tile; without a
        # split each keeps one column tile
        cols = -(-n // plan.bn)
        tiles = -(-m // plan.bm) * cols * plan.slices
        assert 1 <= plan.blocks <= min(max(sms, cols), tiles)
        if plan.slices == 1:
            assert plan.blocks % cols == 0
        assert plan == tfm._matmul_plan(m, k, n, sms)


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_wgrad_plan_covers_and_slices(m, k, n):
    for sms in (SMS, 16):
        plan = tfm._wgrad_plan(m, k, n, sms)
        assert plan.bn == 128 and plan.bk in (64, 128, 256)
        assert plan.bk == 64 or plan.bk // 2 < k  # no wider than K needs
        assert _covers(n, plan.bn) and _covers(k, plan.bk)
        _check_slices(plan, m)
        assert plan == tfm._wgrad_plan(m, k, n, sms)


def test_plans_split_only_where_the_tiles_leave_sms_idle():
    # batch 256 fills the card with output tiles: no split in kernel 1
    assert all(tfm._matmul_plan(*s, SMS).slices == 1
               for s in _resnet50_matmuls(256))
    # kernel 3's dW has few tiles: its M reduction is split to fill the
    # card, into slices of at least 6 steps
    for s in _resnet50_matmuls(32):
        plan = tfm._wgrad_plan(*s, SMS)
        tiles = -(-s[2] // plan.bn) * -(-s[1] // plan.bk)
        assert plan.slices > 1 and plan.per >= 6
        assert tiles * plan.slices <= 2 * SMS


def _walk(blocks, rows, cols, slices):
    """The (row tile, column tile, slice) items that each persistent
    block of kernels 1 and 2 visits: items b, b + blocks, ... with the
    column tile innermost, then the row tile, then the slice."""
    return {b: [(item // cols % rows, item % cols, item // (cols * rows))
                for item in range(b, rows * cols * slices, blocks)]
            for b in range(blocks)}


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_dgrad_plan_covers_each_tile_once(m, k, n):
    for sms in (SMS, 16):
        plan = tfm._dgrad_plan(m, k, n, sms)
        # dx (m, k): rows over m, columns over k; the reduction over n
        assert plan.bm == 128 and plan.bn in (64, 128)
        assert plan.bn == 64 or k > 64  # no wider than K needs
        assert _covers(m, plan.bm) and _covers(k, plan.bn)
        _check_slices(plan, n)
        rows, cols = -(-m // plan.bm), -(-k // plan.bn)
        walk = _walk(plan.blocks, rows, cols, plan.slices)
        seen = Counter(i for items in walk.values() for i in items)
        assert set(seen.values()) == {1}
        assert len(seen) == rows * cols * plan.slices
        assert 1 <= plan.blocks <= min(max(sms, cols),
                                       rows * cols * plan.slices)
        if plan.slices == 1:
            # each block keeps one column tile and writes its row of
            # partials: blocks / cols rows per column tile
            assert plan.blocks % cols == 0
            assert all(len({nt for _, nt, _ in items}) == 1
                       for items in walk.values())
            assert plan.part_rows == plan.blocks // cols
        else:  # the split sum writes one row per row tile
            assert plan.part_rows == rows
        assert plan == tfm._dgrad_plan(m, k, n, sms)


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_dgrad_plan_splits_only_where_tiles_leave_sms_idle(m, k, n):
    for sms in (SMS, 16):
        plan = tfm._dgrad_plan(m, k, n, sms)
        tiles = -(-m // plan.bm) * -(-k // plan.bn)
        if plan.slices > 1:
            assert 4 * tiles < sms
            assert tiles * plan.slices <= 2 * sms


def test_dgrad_plan_never_splits_resnet50_at_batch_32_and_256():
    for b in (32, 256):
        for m, k, n in _resnet50_matmuls(b):
            assert tfm._dgrad_plan(m, k, n, SMS).slices == 1


def _check_dgrad_conv_plan(b, h, w, ci, co, sms=SMS):
    """Kernel 5's grid (row tiles, column tiles, slices) covers M and Ci
    once per slice, and the slices cut the reduction over co into whole
    windows of 3 taps."""
    plan = tfm._conv3_dgrad_plan(b, h, w, ci, co, sms)
    m = b * h * w
    rows, cols = -(-m // plan.bm), -(-ci // plan.bn)
    assert plan.bm == 128 and plan.bn in (64, 128)
    assert plan.bn == 64 or ci > 64
    assert _covers(m, plan.bm) and _covers(ci, plan.bn)
    assert plan.steps == 9 * -(-co // 64)
    assert plan.per % 3 == 0 and plan.per > 0
    assert (plan.slices - 1) * plan.per < plan.steps <= plan.slices * plan.per
    steps = Counter(s for z in range(plan.slices)
                    for s in range(z * plan.per,
                                   min(plan.steps, (z + 1) * plan.per)))
    assert set(steps.values()) == {1} and len(steps) == plan.steps
    if plan.slices > 1:  # split only where the tiles leave SMs idle
        assert 4 * rows * cols < sms
    assert plan == tfm._conv3_dgrad_plan(b, h, w, ci, co, sms)
    return plan, rows * cols


@pytest.mark.parametrize("batch", [1, 32, 256])
@pytest.mark.parametrize("hw,c", RESNET50_CONV3)
def test_conv3_dgrad_plan_covers_and_fills(batch, hw, c):
    plan, tiles = _check_dgrad_conv_plan(batch, hw, hw, c, c)
    if batch in (32, 256):  # no split: it cost more than it filled
        assert plan.slices == 1, plan
    if batch == 256:  # the grid fills the card twice over
        assert tiles >= 2 * SMS, plan
    if batch == 1:  # a few tiles: the split fills the card
        assert tiles * plan.slices >= SMS // 2, plan


@pytest.mark.parametrize("shape", [(3, 7, 7, 512, 512), (2, 5, 5, 16, 24),
                                   (1, 1, 1, 8, 8), (5, 9, 11, 72, 200),
                                   (2, 14, 14, 64, 128)])
def test_conv3_dgrad_plan_ragged_shapes(shape):
    _check_dgrad_conv_plan(*shape)
    _check_dgrad_conv_plan(*shape, sms=16)


def _qkv(seed, b, h, t, s, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, n, d).astype(np.float32) for n in (t, s, s)]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol(scale), (what, err, scale)


def test_key_block_is_the_kernels():
    assert fa.BLOCK_K == 128


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_plain_at_the_key_block_matches_interpret_kernel(d, causal, dt):
    tdt, jdt = DT[dt]
    q, k, v = _qkv(d + causal, 1, 2, 256, 256, d)
    jo, jl = _flash_fwd_pallas(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                               causal, 1.0 / np.sqrt(d), 64, fa.BLOCK_K,
                               True)
    to, tl = fa.flash_attention_plain(
        *(torch.tensor(x).to(tdt) for x in (q, k, v)), causal)
    _close(to.float().numpy(), jo.astype(jnp.float32), TOL[dt], "O")
    _close(tl.numpy(), jl, TOL[dt], "lse")


@pytest.mark.parametrize("t,s,causal", [(200, 200, True), (100, 300, False)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_plain_at_ragged_lengths_matches_xla(d, t, s, causal):
    q, k, v = _qkv(7, 1, 2, t, s, d)
    want = jax_dpa(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                   use_flash=False)
    o, _ = fa.flash_attention_plain(*(torch.tensor(x) for x in (q, k, v)),
                                    causal)
    _close(o.numpy(), want, TOL["f32"], "O")
