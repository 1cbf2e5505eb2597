"""Rank processes of the port's data-parallel tests (not a test module).

:func:`run_worlds` starts each world's processes, all worlds at once,
with torch.multiprocessing's spawn, each in a gloo process group made on a file store under the
test's tmp directory (never a TCP port: the suite runs several workers
at once), with a timeout on the group and a time limit on the whole
world (its processes are killed past it).  Every rank runs one threads'
worth of torch (``torch.set_num_threads(1)``).

:func:`dp_world` runs every data-parallel case of one world size on the
inputs the test wrote (``<tmp>/inputs.npz``, the JAX package's npz
format) and rank 0 writes the results (``<tmp>/results.npz``):

- the data-parallel step (SGD with momentum and LARS, with and without
  ZeRO-1) for two steps on a model with an unfused BatchNorm and both
  fused blocks: parameters, running statistics, the whole optimizer
  state, the losses;
- the dp gradients (global BatchNorm statistics) and the gradients with
  per-replica statistics, both averaged over the ranks;
- the compressed step at the bf16 and fp8 wires;
- ``Optimizer.apply``'s choice at this world size;
- the ``allreduce`` gauge under the synchronous and the async loop;
- sharded checkpoints: a resume from a commit of another world size and
  a run that writes one;
- ``build_reshard_step`` and ``put_batch`` with accumulation.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch


def run_worlds(worlds, tmp_of, fn, timeout: float = 240.0):
    """``fn(rank, world, tmp_of(world))`` in ``world`` spawned processes
    for every size in ``worlds``, all at once; raises when one fails or
    a world outlives ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctxs = [mp.start_processes(fn, args=(w, str(tmp_of(w))), nprocs=w,
                               join=False, start_method="spawn")
            for w in worlds]
    deadline = time.monotonic() + timeout
    try:
        for w, ctx in zip(worlds, ctxs):
            while not ctx.join(timeout=max(0.1,
                                           deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {w} ranks still ran "
                                       f"after {timeout:.0f} s")
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)


def init_rank(rank: int, world: int, tmp: str):
    """The rank's gloo group on a file store, and its CPU mesh."""
    torch.set_num_threads(1)
    from bigdl_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                               init_process_group)

    init_process_group("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                       world_size=world, local_world_size=world,
                       timeout_s=60)
    return data_parallel_mesh(device="cpu")


def build_model():
    """An unfused conv + BatchNorm, a FusedBottleneck and a strided
    FusedBasicBlock with a projection: every BatchNorm path of the
    fused and unfused layers.  The conv has no bias, as a ResNet's: a
    BatchNorm after it makes a bias's gradient rounding noise, which
    LARS's trust ratio would divide by."""
    from bigdl_tpu_torch import nn

    return nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, padding="SAME", with_bias=False),
        nn.SpatialBatchNormalization(8), nn.ReLU(),
        nn.FusedBottleneck(8, 4, 1), nn.FusedBasicBlock(16, 16, 2),
        nn.GlobalAveragePooling2D(), nn.Linear(16, 3))


def build_mlp():
    from bigdl_tpu_torch import nn

    torch.manual_seed(42)
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))


def mlp_data():
    rs = np.random.RandomState(0)
    feats = rs.rand(64, 8).astype(np.float32)
    return feats, (feats.sum(-1) > 4.0).astype(np.int64)


def method(name: str):
    from bigdl_tpu_torch.optim import LarsSGD, SGD

    if name == "lars":
        return LarsSGD(0.1, momentum=0.9, weight_decay=1e-4)
    return SGD(0.1, momentum=0.9)


def whole_state(dp, st, params):
    """A method's state with its ZeRO-1 rows gathered whole."""
    from bigdl_tpu_torch.parallel import comm

    parts = dp.layout(params)
    out = {}
    for slot, flat in st.items():
        keys = [k for k in flat if parts.get(k) is not None]
        out[slot] = {**flat, **dict(zip(keys, comm.gather_leaves(
            [flat[k] for k in keys], dp.mesh)))}
    return out


def _flat(prefix, tree, out):
    from bigdl_tpu_torch.utils.convert import flatten

    for k, v in flatten(tree).items():
        out[f"{prefix}.{k}"] = np.asarray(v)


def _steps(mesh, inputs, name, zero1, results, tag):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel.data_parallel import build_dp_train_step
    from bigdl_tpu_torch.parallel.mesh import put_batch
    from bigdl_tpu_torch.utils.convert import (export_opt_state,
                                               export_variables,
                                               load_jax_variables)

    model = build_model()
    load_jax_variables(model, inputs["variables"])
    m = method(name)
    step, placement = build_dp_train_step(
        model, nn.ClassNLLCriterion(logits=True), {"__all__": m}, mesh,
        zero1=zero1)
    dp = placement["data_parallel"]
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    opt = {"__all__": dp.local_state(m.init_state(params), params)}
    x, y = put_batch(mesh, inputs["x"]), put_batch(mesh, inputs["y"])
    losses = []
    for i in range(2):
        params, state, opt, loss = step(params, state, opt, i + 1, None,
                                        x, y, [0.1])
        losses.append(float(loss))
    v = export_variables(model, params, state)
    _flat(f"{tag}.params", v["params"], results)
    _flat(f"{tag}.state", v["state"], results)
    _flat(f"{tag}.opt", export_opt_state(
        model, whole_state(dp, opt["__all__"], params)), results)
    results[f"{tag}.losses"] = np.asarray(losses)


def _grads(mesh, inputs, results):
    """The loss gradients of one forward and backward on this rank's
    rows, averaged over the ranks: with the global BatchNorm statistics
    (the step's scope) and with each replica's own."""
    from torch.func import functional_call

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel.data_parallel import DataParallel
    from bigdl_tpu_torch.parallel.mesh import put_batch
    from bigdl_tpu_torch.utils.convert import load_jax_variables

    model = build_model()
    load_jax_variables(model, inputs["variables"])
    model.train()
    crit = nn.ClassNLLCriterion(logits=True)
    dp = DataParallel(mesh)
    x, y = put_batch(mesh, inputs["x"]), put_batch(mesh, inputs["y"])
    for tag, scope in (("sync", dp.scope), ("replica", None)):
        params = {k: p.detach().clone().requires_grad_(True)
                  for k, p in model.named_parameters()}
        state = {k: b.detach().clone() for k, b in model.named_buffers()}
        import contextlib

        with (scope() if scope else contextlib.nullcontext()):
            loss = crit.forward(functional_call(model, {**params, **state},
                                                (x,)), y)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        _, grads, _ = dp.reduce(loss.detach(), grads, {})
        for k, g in grads.items():
            results[f"grads.{tag}.{k}"] = g.numpy()


def _compressed(mesh, inputs, results):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.distributed.compression import \
        build_compressed_dp_train_step
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel.mesh import put_batch
    from bigdl_tpu_torch.utils.convert import (export_variables, flatten,
                                               load_jax_variables)

    for wire in ("bf16", "fp8"):
        model = build_model()
        load_jax_variables(model, inputs["variables"])
        m = SGD(0.1, momentum=0.9)
        step, placement = build_compressed_dp_train_step(
            model, nn.ClassNLLCriterion(logits=True), {"__all__": m}, mesh,
            wire_dtype=wire)
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = {k: b.detach().clone() for k, b in model.named_buffers()}
        opt = {"__all__": m.init_state(params)}
        x, y = put_batch(mesh, inputs["x"]), put_batch(mesh, inputs["y"])
        losses = []
        for i in range(2):
            params, state, opt, loss = step(params, state, opt, i + 1, None,
                                            x, y, [0.1])
            losses.append(float(loss))
        v = export_variables(model, params, state)
        _flat(f"wire_{wire}.params", v["params"], results)
        _flat(f"wire_{wire}.state", v["state"], results)
        results[f"wire_{wire}.losses"] = np.asarray(losses)
        results[f"wire_{wire}.name"] = np.asarray(placement["wire_dtype"])
    # the compressed step's numerics stats: a fifth output
    from bigdl_tpu_torch.telemetry import numerics

    model = build_model()
    load_jax_variables(model, inputs["variables"])
    m = SGD(0.1, momentum=0.9)
    step, _ = build_compressed_dp_train_step(
        model, nn.ClassNLLCriterion(logits=True), {"__all__": m}, mesh,
        wire_dtype="bf16", numerics=numerics.spec_for(model))
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    *_, stats = step(params, state, {"__all__": m.init_state(params)}, 1,
                     None, put_batch(mesh, inputs["x"]),
                     put_batch(mesh, inputs["y"]), [0.1])
    leaves = [v for v in flatten(stats).values() if torch.is_tensor(v)]
    results["wire_numerics.leaves"] = np.asarray(len(leaves))
    results["wire_numerics.finite"] = np.asarray(all(
        bool(torch.isfinite(v.float()).all()) for v in leaves))


def _dispatch(mesh, results):
    """``Optimizer.apply``'s class for each case of JAX's rule."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Optimizer

    feats, labels = mlp_data()
    world = mesh.size
    cases = {
        "even": dict(dataset=DataSet.from_arrays(feats, labels, 4 * world)),
        "uneven": dict(dataset=DataSet.from_arrays(feats, labels,
                                                   4 * world + 1)),
        "mesh": dict(dataset=DataSet.from_arrays(feats, labels,
                                                 4 * world + 1),
                     mesh=mesh),
        "wrapped": dict(dataset=DataSet.sharded(feats, labels, 4 * world,
                                                mesh.rank(), world)),
    }
    for name, kw in cases.items():
        opt = Optimizer.apply(build_mlp(), kw.pop("dataset"),
                              nn.ClassNLLCriterion(logits=True),
                              device="cpu", **kw)
        results[f"dispatch.{name}"] = np.asarray(type(opt).__name__)


def _gauge(mesh, results):
    """The ``allreduce`` gauge: under ``BIGDL_TPU_SYNC_LOOP=1`` only."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    from bigdl_tpu_torch.optim import Top1Accuracy, evaluate

    feats, labels = mlp_data()
    for loop in ("sync", "async"):
        if loop == "sync":
            os.environ["BIGDL_TPU_SYNC_LOOP"] = "1"
        try:
            opt = Optimizer.apply(
                build_mlp(), DataSet.from_arrays(feats, labels, 16),
                nn.ClassNLLCriterion(logits=True),
                end_trigger=Trigger.max_epoch(1), device="cpu")
            val = DataSet.from_arrays(feats, labels, 16)
            opt.set_validation(Trigger.every_epoch(), val, [Top1Accuracy()])
            opt.optimize()
        finally:
            os.environ.pop("BIGDL_TPU_SYNC_LOOP", None)
        # the sharded validation against one process's over the same set
        local = evaluate(opt.model, opt.final_params, opt.final_state, val,
                         [Top1Accuracy()])[0][1].result()[0]
        results[f"validation.{loop}"] = np.asarray(
            [opt._loop_state["score"], local])
        results[f"gauge.{loop}.class"] = np.asarray(type(opt).__name__)
        results[f"gauge.{loop}.calibrated"] = np.asarray(
            opt._local_step_time is not None and opt._local_step_time > 0)
        results[f"gauge.{loop}.in_summary"] = np.asarray(
            "allreduce" in opt.metrics.summary())


def mlp_run(iters: int, root=None, resume=False, mesh=None,
            device="cpu", grad_compression=None):
    """The deterministic MLP job on ``DistriOptimizer`` (sharded
    checkpoints every 3 iterations under ``root``); its final
    parameters."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger

    feats, labels = mlp_data()
    rank, world = (0, 1) if mesh is None else (mesh.rank(), mesh.size)
    ds = DataSet.sharded(feats, labels, 16, rank, world, seed=0)
    opt = DistriOptimizer(build_mlp(), ds,
                          nn.ClassNLLCriterion(logits=True),
                          end_trigger=Trigger.max_iteration(iters),
                          mesh=mesh, sharded_checkpoint=True, device=device,
                          grad_compression=grad_compression)
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    if root is not None:
        opt.set_checkpoint(root, Trigger.several_iteration(3))
    if resume:
        opt.resume_from(root)
    opt.optimize()
    return {k: v.detach().numpy().copy() for k, v in opt.final_params.items()}


def _checkpoints(mesh, tmp, results):
    """Resume a commit of world 1 (``<tmp>/ck1``) at this world to 10
    iterations, and write one of this world (``<tmp>/ckw``, 6
    iterations)."""
    from bigdl_tpu_torch.parallel import comm

    for k, v in mlp_run(10, f"{tmp}/ck1", resume=True, mesh=mesh).items():
        results[f"ckpt.resumed.{k}"] = v
    mlp_run(6, f"{tmp}/ckw", mesh=mesh)
    comm.all_reduce_sum_(torch.zeros(1), mesh)  # every rank's commit done


def _reshard(mesh, results):
    from bigdl_tpu_torch.distributed.checkpoint import build_reshard_step
    from bigdl_tpu_torch.parallel.mesh import (Replicated, RowShard,
                                               put_batch)

    n = mesh.size
    whole = torch.arange(8 * n * 3, dtype=torch.float32).reshape(8 * n, 3)
    lo, hi = RowShard(mesh.rank(), n).rows(whole.shape[0])
    tree = {"w": whole[lo:hi].clone(), "b": torch.ones(5)}
    gather = build_reshard_step({"w": RowShard(mesh.rank(), n),
                                 "b": Replicated()},
                                {"w": Replicated(), "b": Replicated()},
                                mesh=mesh)
    out = gather(tree)
    results["reshard.gathered"] = out["w"].numpy()
    cut = build_reshard_step({"w": Replicated()},
                             {"w": RowShard(mesh.rank(), n)}, mesh=mesh)
    results["reshard.cut_ok"] = np.asarray(bool(torch.equal(
        cut({"w": whole})["w"], whole[lo:hi])))
    # accumulation's layout: micro-batch i of the global batch, split
    x = np.arange(4 * n * 2)
    results["put_batch.accum2"] = put_batch(mesh, x, accum_steps=2).numpy()


def dp_world(rank: int, world: int, tmp: str):
    from bigdl_tpu_torch.utils.serialization import load_pytree, save_pytree

    mesh = init_rank(rank, world, tmp)
    inputs = load_pytree(f"{tmp}/inputs")
    results = {}
    for name in ("sgd", "lars"):
        for zero1 in (False, True):
            _steps(mesh, inputs, name, zero1, results,
                   f"dp_{name}_{'zero1' if zero1 else 'replicated'}")
    _grads(mesh, inputs, results)
    _compressed(mesh, inputs, results)
    _dispatch(mesh, results)
    _gauge(mesh, results)
    _checkpoints(mesh, tmp, results)
    _reshard(mesh, results)
    if rank == 0:
        save_pytree(f"{tmp}/results", results)
    import torch.distributed as dist

    dist.destroy_process_group()
