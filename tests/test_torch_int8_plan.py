"""Kernel 7's host side on the CPU: its plan, the operands it reads and
the quantized layers' weight layout.

- ``_int8_plan`` at the 13 (M, K, N) shapes of a quantized ResNet-50
  forward at batches 1, 8, 32 and 256, plus the extras (FFN, int8 KV
  scores, the large-FC MLP) and ragged shapes: the tiles cover the
  output's rows and columns exactly once (on the large-M route through
  the persistent walk, each block keeping one column tile), slices cut K
  into whole 32-byte steps and none is empty, swap-AB is taken exactly
  for M <= ``SWAP_M``, K is split only where the tiles leave most SMs
  idle, the block fits the H100's shared memory, and the split-K walk,
  written out here as the kernel does it (s32 partials added into a
  workspace, an arrival counter per tile, the last slice applying the
  epilogue and zeroing both), visits every (tile, slice) once and gives
  the exact integer product in any order of arrival.  The plan is a
  function of its arguments alone.
- ``_operand_fix`` (relayout or zero-padded copy, or neither) on
  K-contiguous, N-contiguous, unaligned and ragged operands, and the
  copies ``_rows`` makes.
- The weight layout: after ``quantize()``, ``load_jax_variables``,
  ``load_quantized`` and ``.to("cpu")``, every ``QuantizedLinear`` and
  1x1 ``QuantizedSpatialConvolution`` holds ``weight_q`` with the
  reference's shape and K stride 1, bit for bit JAX's ``quantize()``
  leaves; ``save_quantized`` writes the arrays JAX's npz holds.
"""
import random
from collections import Counter

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.utils import serialization as jser
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.nn import quantized as pq
from bigdl_tpu_torch.ops import int8_matmul as im
from bigdl_tpu_torch.utils import (export_variables, flatten,
                                   load_jax_variables, random_variables)

SMS = 132  # H100 SXM


def resnet50_int8_calls(batch):
    """(M, K, N) of the int8 products of one quantized ResNet-50
    forward (its 1x1 stride-1 convs and the fc), as chip_smoke.py counts
    them."""
    calls = Counter()
    n_in, res = 64, 56
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** stage
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ro = res // s
            calls[(batch * res * res, n_in, planes)] += 1
            calls[(batch * ro * ro, planes, 4 * planes)] += 1
            if s == 1 and n_in != 4 * planes:
                calls[(batch * res * res, n_in, 4 * planes)] += 1
            n_in, res = 4 * planes, ro
    calls[(batch, 2048, 1000)] += 1
    return calls


EXTRA = [(4096, 768, 3072), (4096, 3072, 768), (8, 128, 4096),
         (8, 8192, 8192), (8, 8192, 1000)]
RAGGED = [(37, 200, 1000), (3, 7, 5), (1, 1, 1), (65, 33, 300),
          (64, 129, 65), (200, 100, 37), (1000, 5000, 9), (129, 64, 1)]
SHAPES = sorted({s for b in (1, 8, 32, 256) for s in resnet50_int8_calls(b)}
                | set(EXTRA) | set(RAGGED))


def test_resnet50_call_count():
    for batch in (1, 8, 32, 256):
        calls = resnet50_int8_calls(batch)
        assert sum(calls.values()) == 34 and len(calls) == 13


def _walk(plan, m, n):
    """Output tiles by block as the kernel walks them: large M, block b
    takes items b, b + blocks, ... (column tile innermost); swap AB,
    block b is (tile b % tiles, slice b // tiles)."""
    if plan.swap:
        tiles = -(-n // plan.bn)
        return {b: [(b % tiles, b // tiles)] for b in range(plan.blocks)}
    rows, cols = -(-m // plan.bm), -(-n // plan.bn)
    return {b: [(it // cols, it % cols)
                for it in range(b, rows * cols, plan.blocks)]
            for b in range(plan.blocks)}


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plan_tiles_cover_the_output_once(m, k, n):
    plan = im._int8_plan(m, k, n, SMS)
    assert plan.swap == (m <= im.SWAP_M)
    walk = _walk(plan, m, n)
    seen = Counter(item for items in walk.values() for item in items)
    assert all(c == 1 for c in seen.values())
    if plan.swap:
        # x's rows padded to the smallest integer-wgmma N that holds them
        assert plan.bm == min(v for v in im._MX if v >= m)
        tiles = -(-n // plan.bn)
        assert set(seen) == {(t, z) for t in range(tiles)
                             for z in range(plan.slices)}
        cover = Counter(c for t in range(tiles)
                        for c in range(t * plan.bn, (t + 1) * plan.bn)
                        if c < n)
        assert sorted(cover) == list(range(n)) and set(cover.values()) == {1}
    else:
        rows, cols = -(-m // plan.bm), -(-n // plan.bn)
        assert plan.bm == 128 and plan.bn in (64, 128, 256)
        assert (rows - 1) * plan.bm < m <= rows * plan.bm
        assert (cols - 1) * plan.bn < n <= cols * plan.bn
        assert set(seen) == {(r, c) for r in range(rows) for c in range(cols)}
        # each block keeps one column tile: the grid is a multiple of them
        assert plan.blocks % cols == 0 and plan.blocks <= SMS
        for b, items in walk.items():
            assert {c for _, c in items} <= {b % cols}
        assert plan.slices == 1


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plan_slices_and_shared_memory(m, k, n):
    plan = im._int8_plan(m, k, n, SMS)
    assert plan.kc == -(-k // 128)
    # slices of whole 128-byte chunks, so whole 32-byte k32 steps
    assert (plan.per * 128) % 32 == 0
    chunks = [list(range(z * plan.per, min(plan.kc, (z + 1) * plan.per)))
              for z in range(plan.slices)]
    assert all(chunks) and sum(chunks, []) == list(range(plan.kc))
    # K is split only on the swap route, where the tiles leave most SMs
    # idle, in slices of at least MX / 2 chunks, and there whenever such
    # a split is possible
    tiles = -(-n // plan.bn)
    if plan.slices > 1:
        assert plan.swap and 2 * tiles < SMS
        assert plan.per >= plan.bm // 2 or plan.slices == plan.kc
    elif plan.swap and 2 * tiles < SMS:
        assert plan.kc < 2 * max(1, plan.bm // 2)
    assert 1 <= plan.stages <= im._MAX_STAGES
    assert im._int8_smem(plan) <= im._SMEM
    if plan.swap:
        assert plan.stages <= plan.per and not plan.resident
        assert plan.blocks == tiles * plan.slices
    else:
        assert plan.stages >= 2
        assert not plan.resident or plan.kc <= im._MAX_PANEL


def test_resnet50_batch32_plans():
    """What the batch-32 forward runs: the large route, the weight panel
    resident where K <= 256 (6 of the 12 conv shapes); the fc on the
    swap route, unsplit (16 chunks < 2 x MX / 2); the MLP head split in
    8 slices, its hidden layers (128 tiles) not at all."""
    plans = {s: im._int8_plan(*s, SMS) for s in resnet50_int8_calls(32)}
    fc = plans.pop((32, 2048, 1000))
    assert fc.swap and fc.bm == 32 and fc.slices == 1 and fc.blocks == 16
    assert not any(p.swap for p in plans.values())
    assert {s for s, p in plans.items() if p.resident} == {
        s for s in plans if s[1] <= 256}
    assert len({s for s in plans if s[1] <= 256}) == 6
    assert im._int8_plan(8, 8192, 1000, SMS).slices == 8
    assert im._int8_plan(8, 8192, 8192, SMS).slices == 1
    assert im._int8_plan(6272, 1024, 256, SMS).bn == 128


@pytest.mark.parametrize("m", list(range(1, 80)) + [128, 129, 1000])
def test_swap_exactly_for_small_m(m):
    for k, n in ((64, 64), (2048, 1000), (200, 37)):
        plan = im._int8_plan(m, k, n, SMS)
        assert plan.swap == (m <= im.SWAP_M)


def test_plan_is_a_function_of_its_arguments(monkeypatch):
    def no_device(*a, **kw):
        raise AssertionError("the plan asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    first = [im._int8_plan(*s, sms) for s in SHAPES for sms in (132, 114)]
    random.Random(0).shuffle(shuffled := list(SHAPES))
    for s in shuffled:
        im._int8_plan(*s, 78)
    again = [im._int8_plan(*s, sms) for s in SHAPES for sms in (132, 114)]
    assert first == again


@pytest.mark.parametrize("m,k,n", [(32, 2048, 1000), (8, 8192, 1000),
                                   (37, 200, 1000), (1, 300, 70),
                                   (64, 1000, 129)])
def test_split_k_walk_is_exact_in_any_order(m, k, n):
    """The swap route's split-K, as the kernel does it: each (tile,
    slice) block adds its s32 partial (over its chunks) into the tile's
    workspace and counts its arrival; the block that arrives last reads
    the sum, applies the epilogue and zeroes the workspace and the
    counter.  In every order of arrival the product is exact, each
    (tile, slice) arrives once, and the workspace ends clean."""
    plan = im._int8_plan(m, k, n, SMS)
    assert plan.swap
    rs = np.random.RandomState(m + k + n)
    x = rs.randint(-127, 128, (m, k)).astype(np.int64)
    w = rs.randint(-127, 128, (k, n)).astype(np.int64)
    tiles = -(-n // plan.bn)
    for seed in range(3):
        order = list(range(plan.blocks))
        random.Random(seed).shuffle(order)
        ws = np.zeros((tiles, plan.bn, plan.bm), np.int64)  # (n, m) per tile
        cnt = np.zeros(tiles, np.int64)
        y = np.full((m, n), -1, np.int64)
        arrivals = Counter()
        for b in order:
            tile, z = b % tiles, b // tiles
            arrivals[(tile, z)] += 1
            n0, c0 = tile * plan.bn, z * plan.per * 128
            c1 = min(k, c0 + plan.per * 128)
            part = np.zeros((plan.bn, plan.bm), np.int64)
            nn_ = min(n, n0 + plan.bn) - n0
            part[:nn_, :m] = (x[:, c0:c1] @ w[c0:c1, n0:n0 + nn_]).T
            if plan.slices == 1:
                y[:, n0:n0 + nn_] = part[:nn_, :m].T
                continue
            ws[tile] += part
            cnt[tile] += 1
            if cnt[tile] == plan.slices:  # the last slice
                y[:, n0:n0 + nn_] = ws[tile][:nn_, :m].T
                ws[tile] = 0
                cnt[tile] = 0
        assert set(arrivals.values()) == {1}
        assert len(arrivals) == tiles * plan.slices
        np.testing.assert_array_equal(y, x @ w)
        assert not ws.any() and not cnt.any()


# ------------------------------------------------------ operand copies
@pytest.mark.parametrize("k,k_stride,rows,row_stride,ptr,want", [
    (2048, 1, 32, 2048, 0, "ok"),        # x, or w's (N, K) K-major view
    (128, 1, 4096, 128, 512, "ok"),      # k_q.T of an int8 key cache
    (2048, 1000, 1000, 1, 0, "relayout"),  # a contiguous (K, N) w_q
    (64, 256, 256, 1, 0, "relayout"),
    (200, 1, 37, 200, 0, "pad"),          # ragged K: 200-byte rows
    (200, 1000, 1000, 1, 0, "relayout"),  # ragged and N-contiguous
    (256, 1, 64, 256, 8, "pad"),          # base not 16-byte aligned
    (256, 1, 64, 264, 0, "pad"),          # row stride of 264 bytes
    (7, 1, 1, 7, 0, "ok"),                # one row: its stride is unused
    (1, 5, 9, 1, 0, "pad"),               # K = 1: any K stride
    (1, 5, 1, 1, 0, "ok"),
])
def test_operand_fix(k, k_stride, rows, row_stride, ptr, want):
    assert im._operand_fix(k, k_stride, rows, row_stride, ptr) == want


@pytest.mark.parametrize("layout", ["nk", "kn", "ragged", "one_row"])
def test_rows_copies_and_counts(layout):
    rs = np.random.RandomState(3)
    k, n = {"nk": (64, 48), "kn": (64, 48), "ragged": (200, 37),
            "one_row": (7, 1)}[layout]
    w = torch.from_numpy(rs.randint(-127, 128, (k, n)).astype(np.int8))
    if layout in ("nk", "one_row"):
        w = w.t().contiguous().t()  # (K, N) over a K-contiguous buffer
    im.reset_launches()
    view = w.t()  # the (N, K) rows the kernel reads
    got, ld = im._rows(view, k, "int8_matmul_w_relayout")
    copied = {"nk": None, "one_row": None, "kn": "int8_matmul_w_relayout",
              "ragged": "int8_matmul_w_relayout"}[layout]
    assert {key: v for key, v in im.LAUNCHES.items() if v} == (
        {copied: 1} if copied else {})
    if copied is None:
        assert got.data_ptr() == view.data_ptr()
    assert got.stride(1) == 1 and (ld % 16 == 0 or got.shape[0] == 1)
    assert torch.equal(got[:, :k], view)
    assert not got[:, k:].any()  # zero padding adds nothing
    im.reset_launches()


# -------------------------------------------------------- weight layout
def _model(pkg):
    inp = pkg.Input()
    c = pkg.SpatialConvolution(3, 8, 3, 1, "SAME").inputs(inp)
    r = pkg.ReLU().inputs(c)
    d = pkg.SpatialConvolution(8, 12, 1, 1).inputs(r)   # the int8 kernel
    e = pkg.SpatialConvolution(12, 6, 1, 2).inputs(d)   # 1x1, strided
    return pkg.Graph([inp], [e])


def _layers(model):
    return [m for m in model.modules()
            if isinstance(m, (pq.QuantizedLinear,
                              pq.QuantizedSpatialConvolution))]


def _assert_k_major(model, want_params):
    """Every matmul-route weight has the reference's shape and K stride 1
    and holds the given leaves bit for bit."""
    params = flatten(export_variables(model)["params"])
    want = flatten(want_params)
    n_k_major = 0
    for name, p in model.named_parameters():
        if not name.endswith("weight_q"):
            continue
        np.testing.assert_array_equal(params[name], np.asarray(want[name]))
        assert tuple(p.shape) == np.asarray(want[name]).shape
        if p.dim() == 2 or p.shape[:2] == (1, 1):
            assert p.stride(-2) == 1, (name, p.stride())
            n_k_major += 1
    return n_k_major


def _pair(seed=4):
    jm = jnn.Sequential(jnn.Linear(10, 16), jnn.ReLU(), jnn.Linear(16, 5))
    pm = nn.Sequential(nn.Linear(10, 16), nn.ReLU(), nn.Linear(16, 5))
    tmpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    var = random_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tmpl), seed)
    load_jax_variables(pm, var)
    return jm, pm, var


def _graph_pair(seed=5):
    jm, pm = _model(jnn), _model(nn)
    tmpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    var = random_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tmpl), seed)
    load_jax_variables(pm, var)
    return jm, pm, var


@pytest.mark.parametrize("which", ["linear", "conv"])
def test_weight_layout_after_quantize_load_and_to(which, tmp_path):
    jm, pm, var = (_pair if which == "linear" else _graph_pair)()
    jqm, jqv = jq.quantize(jm, var)
    jparams = jax.tree_util.tree_map(np.asarray, jqv["params"])
    expect = 2
    # quantize()
    qm, qv = pq.quantize(pm, var)
    assert _assert_k_major(qm, jparams) == expect
    # load_jax_variables of JAX's own quantize() output
    qm2, _ = pq.quantize(pm, var)
    load_jax_variables(qm2, jax.tree_util.tree_map(np.asarray, jqv))
    assert _assert_k_major(qm2, jparams) == expect
    # .to("cpu") and a deepcopy (quantize() copies the model)
    assert _assert_k_major(qm.to("cpu"), jparams) == expect
    # load_quantized of either package's file
    jq.save_quantized(str(tmp_path / "jax.npz"), jqm, jqv)
    pq.save_quantized(str(tmp_path / "port"), qm, qv)
    fresh = (_pair if which == "linear" else _graph_pair)()[1]
    for path in ("jax.npz", "port.npz"):
        qm3, _ = pq.load_quantized(str(tmp_path / path), fresh)
        assert _assert_k_major(qm3, jparams) == expect
    # a layer built directly has the layout too
    for layer in _layers(qm):
        if layer.weight_q.dim() == 2 or layer.weight_q.shape[:2] == (1, 1):
            assert layer.weight_q.stride(-2) == 1


def test_save_quantized_writes_jaxs_arrays(tmp_path):
    """The npz the port writes holds JAX's arrays under the same paths:
    the same dtypes, shapes and values, each stored in C order (the K-major
    weights are written as the reference's (K, N) arrays, not as their
    buffers)."""
    jm, pm, var = _graph_pair()
    jqm, jqv = jq.quantize(jm, var)
    qm, _ = pq.quantize(pm, var)
    jq.save_quantized(str(tmp_path / "jax.npz"), jqm, jqv)
    pq.save_quantized(str(tmp_path / "port"), qm)  # the model's own leaves
    a = flatten(jser.load_pytree(str(tmp_path / "jax.npz"))["variables"])
    b = flatten(jser.load_pytree(str(tmp_path / "port.npz"))["variables"])
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)
    with np.load(tmp_path / "port.npz") as z:
        assert all(z[f].flags.c_contiguous for f in z.files)


def test_quantized_layers_run_on_k_major_weights():
    """The plain route (CPU) on the K-major weights gives JAX's output,
    and the weight_only route too."""
    jm, pm, var = _graph_pair()
    x = np.random.RandomState(2).randn(2, 6, 6, 3).astype(np.float32)
    for weight_only in (False, True):
        jqm, jqv = jq.quantize(jm, var, weight_only=weight_only)
        qm, _ = pq.quantize(pm, var, weight_only=weight_only)
        want = np.asarray(jqm.apply(jqv["params"], jqv["state"], x)[0])
        with torch.inference_mode():
            got = qm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
