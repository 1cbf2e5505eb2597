"""The port's post-training int8 quantization (bigdl_tpu_torch.nn.quantized,
utils.serialization, optim.prediction_service) against the JAX package's.

Weights and inputs are made with numpy from a seed and given to both
packages; JAX's ``quantize()`` output crosses into the port through
``load_jax_variables``.  Tolerances:

- ``quantize_weight``: bit-equal leaves (f32 arithmetic on both sides).
- f32 forwards of each quantized layer: bit-equal on the matmul route
  (``QuantizedLinear``; a 1x1 stride-1 conv, which the port sends through
  the int8 matmul where JAX runs XLA's integer conv: the int32 sum is
  exact on both); 1e-6 relative on the library-conv route and in
  ``weight_only`` mode (f32 sums in another order).
- bf16: the activation scale and ``x / scale`` round to bf16 in the jaxpr,
  and XLA:CPU may keep them in f32 inside a fusion, so an int8 activation
  may differ by 1 (in at most ``BF16_FLIP_SHARE`` of the values; 0
  measured here) and y by one bf16 step at the largest |y| (measured: 0
  on every route, 1/16 of a step in the stem's ``weight_only`` conv).
- ResNet-50 (``class_num=10``, 64x64, batch 2, f32): every quantized
  layer, fed JAX's own input to it, gives JAX's output (bit-equal on the
  34 matmul-route layers, 1e-6 on the 20 library-conv layers); the whole
  model's logits agree within ``RESNET_TOL`` of the largest |logit| with
  the same argmax.  The whole-model bound is not 1e-3 because the
  quantized network is chaotic at the ulp level: BatchNorm's rsqrt and
  the average pool's sum order differ by an ulp between XLA and PyTorch,
  an ulp at a rounding boundary moves an int8 activation by 1, and the
  port's own logits move by 0.9% of the largest |logit| when the input
  is multiplied by (1 + 1e-7) (measured at this size); JAX and the port
  differ by 1.5% here.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.resnet import ResNet50 as JaxResNet50
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.optim.prediction_service import (
    PredictionService as JaxPredictionService)
from bigdl_tpu.utils import serialization as jser
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.models import ResNet50
from bigdl_tpu_torch.nn import quantized as pq
from bigdl_tpu_torch.ops import int8_matmul as im
from bigdl_tpu_torch.optim import PredictionService
from bigdl_tpu_torch.utils import (export_variables, flatten,
                                   load_jax_variables, random_variables)
from bigdl_tpu_torch.utils import serialization as pser

BF16_FLIP_SHARE = 0.01
RESNET_TOL = 5e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def _variables(jmodel, seed):
    """Random weights shaped as ``jmodel``'s tree, BatchNorm randomised."""
    tmpl = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   tmpl)
    return random_variables(zeros, seed)


def _bf16_close(got, want):
    """Within one bf16 step at the largest |y|."""
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= step


# ------------------------------------------------------------ weights
@pytest.mark.parametrize("shape,axis", [((48, 40), 1), ((3, 3, 16, 24), 3),
                                        ((1, 1, 32, 8), 3)])
def test_quantize_weight_bit_equal(shape, axis):
    rs = np.random.RandomState(0)
    w = (rs.randn(*shape) * rs.rand(shape[-1]) * 3).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    q, s = jq.quantize_weight(jnp.asarray(w), axis=axis)
    pq_, ps = pq.quantize_weight(torch.from_numpy(w), axis=axis)
    assert pq_.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq_.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))


def test_quantize_activation_f32_exact_bf16_within_one_step():
    rs = np.random.RandomState(1)
    x = (rs.randn(4, 9, 9, 16) * 2.5).astype(np.float32)
    q, s = jq._quantize_activation(jnp.asarray(x))
    pq_, ps = pq._quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(pq_.numpy(), np.asarray(q))
    assert ps.item() == float(s)
    q, s = jq._quantize_activation(jnp.asarray(x, jnp.bfloat16))
    pq_, ps = pq._quantize_activation(torch.from_numpy(x).bfloat16())
    d = np.abs(pq_.numpy().astype(int) - np.asarray(q).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= BF16_FLIP_SHARE
    assert abs(ps.float().item() - float(s)) <= 2 ** -7 * float(s)


# ------------------------------------------------------------ layers
def _linear_pair(weight_only, seed=2):
    jl = jnn.Linear(24, 40)
    var = _variables(jl, seed)
    jm, jp = jq.QuantizedLinear.from_linear(jl, var["params"], weight_only)
    pl = nn.Linear(24, 40)
    load_jax_variables(pl, var)
    qm, qv = pq.quantize(pl, var, weight_only=weight_only)
    return jm, jp, qm, qv


def _conv_pair(k, stride, padding, weight_only, seed=3, c=8, o=12):
    jc = jnn.SpatialConvolution(c, o, k, stride, padding)
    var = _variables(jc, seed)
    jm, jp = jq.QuantizedSpatialConvolution.from_conv(jc, var["params"],
                                                      weight_only)
    pc = nn.SpatialConvolution(c, o, k, stride, padding)
    load_jax_variables(pc, var)
    qm, qv = pq.quantize(pc, var, weight_only=weight_only)
    return jm, jp, qm, qv


ROUTES = {  # name -> (make the pair, input shape, exact in f32)
    "linear": (lambda wo: _linear_pair(wo), (6, 24), True),
    "conv1x1_same": (lambda wo: _conv_pair(1, 1, "SAME", wo), (2, 7, 7, 8),
                     True),
    "conv3x3": (lambda wo: _conv_pair(3, 1, "SAME", wo), (2, 7, 7, 8), False),
    "conv7x7_s2_stem": (lambda wo: _conv_pair(7, 2, "SAME", wo, c=3),
                        (2, 16, 16, 3), False),
}


@pytest.mark.parametrize("weight_only", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_quantized_layer_matches_jax(route, weight_only):
    build, shape, exact = ROUTES[route]
    jm, jp, qm, qv = build(weight_only)
    _assert_trees_equal(_np_tree(jp), qv["params"])
    assert qm.weight_q.dtype == torch.int8
    assert not any(p.requires_grad for p in qm.parameters())
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    im.reset_launches()
    with im.record_calls() as calls, torch.inference_mode():
        got = qm(torch.from_numpy(x)).numpy()
        got16 = qm(torch.from_numpy(x).bfloat16()).float().numpy()
    want = np.asarray(jm.apply(jp, {}, jnp.asarray(x))[0])
    want16 = np.asarray(jm.apply(jp, {}, jnp.asarray(x, jnp.bfloat16))[0]
                        .astype(jnp.float32))
    if exact and not weight_only:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    _bf16_close(got16, want16)
    # the int8 matmul takes the matmul route, and only it
    assert len(calls) == (0 if weight_only else 2 * exact)


def test_weight_only_does_not_quantize_activations():
    _, _, qm, _ = _linear_pair(True)
    x = torch.from_numpy(np.random.RandomState(5).randn(3, 24)
                         .astype(np.float32))
    w = qm.weight_q.float() * qm.scale
    with torch.inference_mode():
        np.testing.assert_allclose(qm(x).numpy(),
                                   (x @ w + qm.bias).numpy(), rtol=1e-6)


# --------------------------------------------------------- containers
def _seq():
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    pm = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    return jm, pm


def _graph(pkg):
    inp = pkg.Input()
    c = pkg.SpatialConvolution(2, 6, 3, 1, "SAME").inputs(inp)
    r = pkg.ReLU().inputs(c)
    d = pkg.SpatialConvolution(6, 4, 1, 1, "SAME").inputs(r)
    return pkg.Graph([inp], [d])


def _nested(pkg):
    return pkg.Sequential(pkg.Sequential(pkg.Linear(4, 3)), pkg.ReLU(),
                          pkg.Linear(3, 2))


MODELS = {
    "sequential": (_seq, (5, 8)),
    "graph": (lambda: (_graph(jnn), _graph(nn)), (2, 6, 6, 2)),
    "nested": (lambda: (_nested(jnn), _nested(nn)), (3, 4)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantize_containers_match_jax_and_leave_original(name):
    build, shape = MODELS[name]
    jm, pm = build()
    var = _variables(jm, 6)
    load_jax_variables(pm, var)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    jqm, jqv = jq.quantize(jm, var)
    qm, qv = pq.quantize(pm, var)
    _assert_trees_equal(_np_tree(jqv), qv)
    # the quantized model's state_dict paths are the JAX tree's
    assert set(k for k in qm.state_dict()) == set(flatten(qv["params"]))
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    with torch.inference_mode():
        got = qm(torch.from_numpy(x)).numpy()
    want = np.asarray(jqm.apply(jqv["params"], jqv["state"], jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # the original model and its weights are untouched
    assert not any(isinstance(m, (pq.QuantizedLinear,
                                  pq.QuantizedSpatialConvolution))
                   for m in pm.modules())
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_graph_rewrite_replaces_node_module():
    g = _graph(nn)
    qm, _ = pq.quantize(g)
    mods = [n.module for n in qm._order if n.module is not None]
    assert mods == [qm._modules[k] for k in qm.child_keys]
    assert sum(isinstance(m, pq.QuantizedSpatialConvolution)
               for m in mods) == 2


def test_use_plain_ops_reaches_quantized_layers():
    qm, _ = pq.quantize(_nested(nn))
    layers = list(pq._walk_quantized(qm))
    assert len(layers) == 2 and not any(m.plain for m in layers)
    nn.use_plain_ops(qm, True)
    assert all(m.plain for m in layers)


# ------------------------------------------------------------ ResNet-50
def _jax_walk(graph, params, state, x):
    """``graph.apply`` node by node (bigdl_tpu/nn/graph.py), keeping
    each quantized child's input and output by key."""
    values = {graph.input_nodes[0].id: jnp.asarray(x)}
    seen = {}
    for node in graph._order:
        if node.module is None:
            continue
        key = graph._node_key[node.id]
        args = [values[p.id] for p in node.in_nodes]
        xin = args[0] if len(args) == 1 else tuple(args)
        out, _ = node.module.apply(params.get(key, {}), state.get(key, {}),
                                   xin, training=False)
        values[node.id] = out
        if isinstance(node.module, (jq.QuantizedLinear,
                                    jq.QuantizedSpatialConvolution)):
            seen[key] = (np.asarray(xin), np.asarray(out))
    return np.asarray(values[graph.output_nodes[0].id]), seen


@pytest.fixture(scope="module")
def resnet():
    jmodel = JaxResNet50(10)
    var = _variables(jmodel, 0)
    model = ResNet50(10, device="cpu")
    load_jax_variables(model, var)
    jqm, jqv = jq.quantize(jmodel, var)
    qm, qv = pq.quantize(model, var)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want, layers = _jax_walk(jqm, jqv["params"], jqv["state"], x)
    with im.record_calls() as calls, torch.inference_mode():
        got = qm(torch.from_numpy(x)).numpy()
    return dict(var=var, model=model, jqm=jqm, jqv=_np_tree(jqv), qm=qm,
                qv=qv, x=x, want=want, got=got, layers=layers, calls=calls)


def test_resnet50_quantize_matches_jax_leaf_for_leaf(resnet):
    _assert_trees_equal(resnet["jqv"], resnet["qv"])
    # JAX's quantize() output loads into a quantized model of the port
    qm2, _ = pq.quantize(ResNet50(10, device="cpu"))
    _assert_trees_equal(load_jax_variables(qm2, resnet["jqv"]), resnet["qv"])
    assert sum(1 for _ in pq._walk_quantized(qm2)) == 54
    assert not any(isinstance(m, (nn.Linear, nn.SpatialConvolution))
                   for m in qm2.modules())


def test_resnet50_each_quantized_layer_matches_jax(resnet):
    qm, exact = resnet["qm"], 0
    assert len(resnet["layers"]) == 54
    for key, (xin, want) in resnet["layers"].items():
        layer = qm._modules[key]
        with torch.inference_mode():
            got = layer(torch.from_numpy(xin)).numpy()
        if isinstance(layer, pq.QuantizedLinear) or (
                layer.conv.kernel_size == (1, 1)
                and layer.conv.stride == (1, 1)):
            np.testing.assert_array_equal(got, want, err_msg=key)
            exact += 1
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=key)
    assert exact == 34


def test_resnet50_logits_match_jax(resnet):
    got, want = resnet["got"], resnet["want"]
    assert got.shape == (2, 10) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= RESNET_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # 34 int8 matmuls per forward: 32 bottleneck 1x1 convs, layer1's
    # stride-1 projection, the fc
    assert len(resnet["calls"]) == 34
    assert resnet["calls"][-1][:3] == (2, 2048, 10)


def test_resnet50_int8_weights_and_original_untouched(resnet):
    def nbytes(tree):
        return sum(a.nbytes for a in flatten(tree).values())

    assert nbytes(resnet["qv"]["params"]) < 0.3 * nbytes(resnet["var"]["params"])
    assert resnet["qm"]._modules["fc1000"].weight_q.dtype == torch.int8
    _assert_trees_equal(export_variables(resnet["model"]), resnet["var"])


# ------------------------------------------------------- save and load
def test_saved_resnet50_crosses_both_ways(resnet, tmp_path):
    """save_quantized in one package, load_quantized in the other:
    identical leaves; the port's load serves the same logits."""
    jq.save_quantized(str(tmp_path / "jax"), resnet["jqm"], resnet["jqv"])
    qm2, qv2 = pq.load_quantized(str(tmp_path / "jax"),
                                 ResNet50(10, device="cpu"))
    _assert_trees_equal(qv2, resnet["qv"])
    _assert_trees_equal(export_variables(qm2), resnet["qv"])
    with torch.inference_mode():
        np.testing.assert_array_equal(
            qm2(torch.from_numpy(resnet["x"])).numpy(), resnet["got"])

    pq.save_quantized(str(tmp_path / "port"), resnet["qm"])
    jqm2, jqv2 = jq.load_quantized(str(tmp_path / "port"), JaxResNet50(10))
    _assert_trees_equal(_np_tree(jqv2), resnet["jqv"])
    assert type(jqm2._children[-1]).__name__ == "QuantizedLinear"


@pytest.mark.parametrize("weight_only", [False, True])
def test_saved_graph_serves_the_same_in_both_packages(weight_only, tmp_path):
    jm, pm = _graph(jnn), _graph(nn)
    var = _variables(jm, 8)
    load_jax_variables(pm, var)
    x = np.random.RandomState(9).randn(2, 6, 6, 2).astype(np.float32)
    jqm, jqv = jq.quantize(jm, var, weight_only=weight_only)
    qm, qv = pq.quantize(pm, var, weight_only=weight_only)
    jq.save_quantized(str(tmp_path / "jax.npz"), jqm, jqv)
    pq.save_quantized(str(tmp_path / "port"), qm, qv)
    # the port loads JAX's file, JAX loads the port's
    qm2, qv2 = pq.load_quantized(str(tmp_path / "jax.npz"), _graph(nn))
    jqm2, jqv2 = jq.load_quantized(str(tmp_path / "port"), _graph(jnn))
    assert all(m.weight_only == weight_only for m in pq._walk_quantized(qm2))
    _assert_trees_equal(qv2, qv)
    _assert_trees_equal(_np_tree(jqv2), _np_tree(jqv))
    with torch.inference_mode():
        np.testing.assert_array_equal(qm2(torch.from_numpy(x)).numpy(),
                                      qm(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jqm2.apply(jqv2["params"], jqv2["state"], x)[0]),
        np.asarray(jqm.apply(jqv["params"], jqv["state"], x)[0]))


def test_load_quantized_refuses_a_float_file_and_remote_paths(tmp_path):
    pser.save_pytree(str(tmp_path / "f"), {"variables": {"params": {}}})
    with pytest.raises(ValueError, match="not a save_quantized"):
        pq.load_quantized(str(tmp_path / "f"), _graph(nn))
    # remote paths go through utils/file_io.py: the same refusal there
    pytest.importorskip("fsspec")
    url = f"memory://{tmp_path.name}/f"
    pser.save_pytree(url, {"variables": {"params": {}}})
    with pytest.raises(ValueError, match="not a save_quantized"):
        pq.load_quantized(url, _graph(nn))


def test_pytree_codec_crosses_both_ways(tmp_path):
    tree = {"a": np.arange(6, dtype=np.int8).reshape(2, 3),
            "b": (np.float32(1.5) * np.ones(4, np.float32), [np.zeros(2)]),
            "flag": True, "name": "resnet", "none": None}
    for dumps, loads in ((pser.dumps_pytree, jser.loads_pytree),
                         (jser.dumps_pytree, pser.loads_pytree)):
        got = loads(dumps(tree))
        assert got["flag"] is True and got["name"] == "resnet"
        assert got["none"] is None and isinstance(got["b"], tuple)
        assert isinstance(got["b"][1], list)
        assert got["a"].dtype == np.int8
        np.testing.assert_array_equal(got["a"], tree["a"])
        np.testing.assert_array_equal(got["b"][0], tree["b"][0])
    assert pser.dumps_pytree(tree) == jser.dumps_pytree(tree)
    pser.save_pytree("file://" + str(tmp_path / "t"), tree)
    assert jser.load_pytree(str(tmp_path / "t.npz"))["name"] == "resnet"


# --------------------------------------------------------- convert.py
def test_int8_leaves_keep_their_type_through_convert():
    qm, qv = pq.quantize(_nested(nn))
    out = export_variables(qm)
    leaf = out["params"]["0"]["0"]["weight_q"]
    assert leaf.dtype == np.int8
    np.testing.assert_array_equal(leaf, qv["params"]["0"]["0"]["weight_q"])
    assert out["params"]["0"]["0"]["scale"].dtype == np.float32
    again = load_jax_variables(qm, out)
    _assert_trees_equal(again, out)
    bad = copy.deepcopy(out)
    bad["params"]["0"]["0"]["weight_q"] = leaf.astype(np.float32)
    with pytest.raises(TypeError, match="weight_q"):
        load_jax_variables(qm, bad)


# --------------------------------------------------- PredictionService
@pytest.fixture(scope="module")
def service():
    jm, pm = _seq()
    var = _variables(jm, 10)
    load_jax_variables(pm, var)
    qm, qv = pq.quantize(pm, var)
    svc = PredictionService(qm, qv, buckets=[(8,)], batch_sizes=(1, 4),
                            device="cpu")
    yield svc, copy.deepcopy(qm)
    svc.close()


def _alone(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def test_prediction_service_predict_and_async(service):
    svc, qm = service
    x = np.random.RandomState(11).randn(6, 8).astype(np.float32)
    # predict: batches of up to 4, padded with zero rows (which do not
    # change the per-tensor activation scale)
    got = svc.predict(x)
    assert got.shape == (6, 4)
    np.testing.assert_array_equal(got[:4], _alone(qm, x[:4]))
    np.testing.assert_array_equal(got[4:], _alone(qm, x[4:]))
    outs = [svc.predict_async(x[i]) for i in range(6)]
    for i, q in enumerate(outs):
        y = q.get(timeout=30)
        assert not isinstance(y, Exception) and y.shape == (4,)
        assert np.isfinite(y).all()
    # 9 features: past the (8,) bucket, unpadded, and Linear(8, 16) fails
    bad = svc.predict_async(np.zeros(9, np.float32)).get(timeout=30)
    assert isinstance(bad, Exception)


def test_prediction_service_serialized_codec_crosses(service):
    svc, qm = service
    x = np.random.RandomState(12).randn(3, 8).astype(np.float32)
    req = svc.encode_request(x)
    np.testing.assert_array_equal(JaxPredictionService.decode_request(req), x)
    assert req == JaxPredictionService.encode_request(x)
    y = svc.decode_response(svc.predict_serialized(req))
    np.testing.assert_array_equal(y, _alone(qm, x))
    jresp = JaxPredictionService.encode_response(y)
    np.testing.assert_array_equal(svc.decode_response(jresp), y)
    # a pytree activity runs one unbucketed forward
    tree_req = JaxPredictionService.encode_request({"x": x})
    assert svc.decode_request(tree_req)["x"].shape == (3, 8)
    with pytest.raises(Exception):
        svc.predict_serialized(tree_req)  # Sequential takes no dict


def test_future_callbacks_fire_once_under_contention():
    """Callbacks added while other threads finish the futures: each fires
    exactly once, before or after the result lands."""
    import sys
    import threading

    from bigdl_tpu_torch.serving import ServingFuture

    futs = [ServingFuture() for _ in range(2000)]
    hits = [0] * len(futs)
    lock = threading.Lock()

    def bump(i):
        with lock:
            hits[i] += 1

    def finish(lo):
        for i in range(lo, len(futs), 4):
            futs[i].set_result(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=finish, args=(k,))
                   for k in range(4)]
        for w in workers:
            w.start()
        for i, f in enumerate(futs):
            f.add_done_callback(lambda f, i=i: bump(i))
        for w in workers:
            w.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert hits == [1] * len(futs)
    assert [f.result(0) for f in futs] == list(range(len(futs)))


def test_prediction_service_context_manager_closes():
    pm = nn.Sequential(nn.Linear(4, 2))
    with PredictionService(pq.quantize(pm)[0], device="cpu") as svc:
        assert svc.predict(np.ones((2, 4), np.float32)).shape == (2, 2)
    with pytest.raises(Exception):
        svc.engine.submit(np.ones(4, np.float32))
