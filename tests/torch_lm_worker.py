"""Rank processes of the port's LM parallelism tests (not a test module).

The test writes ``<tmp>/inputs.npz`` (the JAX package's npz format: the
whole JAX variables of each model configuration, the batch) and
``<tmp>/plans.json`` (the plans of this world) and starts the world with
``torch_dist_worker.run_worlds``; every rank runs :func:`lm_world`, which
runs each plan in turn on its own mesh, and rank 0 writes
``<tmp>/results.npz``:

- ``<plan>.logits``: the sharded forward, gathered (``build_dp_eval_step``);
- ``<plan>.loss`` and ``<plan>.grads.<leaf>``: one forward and backward
  through ``make_train_step``'s data-parallel path with a method that
  records the gradients it is handed (averaged over the data axes,
  unclipped), each leaf gathered whole;
- ``<plan>.params.<leaf>``, ``<plan>.m.<leaf>``, ``<plan>.step_loss``:
  one Adam step (lr 1e-2, gradients clipped to global norm 0.5) of
  ``build_dp_train_step``, the parameters and Adam's first moment
  gathered whole (ZeRO-1 rows and shards);
- with ``"one_rank": true`` the same Adam step of the one-rank port model
  on the whole batch, ``<plan>.one.params.<leaf>``/``.one.step_loss``
  (the dropout plans hold the sharded step against it).

A plan is ``{"name", "mesh": MeshConfig kwargs, "config": key of the
variables, "vocab", "moe", "sp_mode", "pp_M", "zero1", "dropout",
"capacity", "one_rank"}``; ``"kind": "moe"`` plans run one ``MoE`` layer
on ``x_moe`` instead of the LM, ``"kind": "attn"`` the sequence-parallel
attention functions alone, ``"kind": "pipe_fn"`` ``pipeline_apply`` and
``build_pipeline_train_step`` on a small stage, ``"kind": "ckpt_write"``/``"ckpt_read"`` the
sharded-checkpoint round trip of the pipeline's test.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

SIZE = dict(hidden_size=16, num_heads=4, filter_size=32, num_layers=2)
LR = 1e-2
CLIP = 0.5  # below every plan's global gradient norm: the clip acts
SEED = 1234  # the dropout plans' step seed


def to_pipelined(variables, num_stages: int, num_layers: int) -> dict:
    """A JAX ``nn.Transformer`` tree as ``pipelined_transformer_lm``'s:
    layer ``s * per + i`` is block ``i`` of stage ``s``."""
    p = variables["params"]
    per = num_layers // num_stages

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*[x[k] for x in xs]) for k in xs[0]}
        return np.stack([np.asarray(x) for x in xs])

    trunk = {f"block{i}": stack(*[p[f"layer{s * per + i}"]
                                  for s in range(num_stages)])
             for i in range(per)}
    params = {"head": {"embed": p["embed"], "scale": {}, "pos": {},
                       "drop": {}},
              "trunk": trunk, "tail": p["ln_f"]}
    state = {}
    if any("aux_loss" in str(k) for k in _keys(variables.get("state", {}))):
        state = {"trunk": {"aux_loss": np.zeros((), np.float32)}}
    return {"params": params, "state": state}


def _keys(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _keys(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


class Record:
    """An optimization method that keeps the gradients it is handed and
    leaves the parameters as they are."""

    def __init__(self):
        self.grads = None

    def init_state(self, params):
        return {}

    def leaf_norms(self, grads, params):
        return None

    def update(self, grads, opt_state, params, lr, step=None):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return dict(params), opt_state


def build(plan, mesh, inputs):
    """``(model, layouts, seq_dim)`` of a plan, the model holding the
    plan's whole JAX variables."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel.expert import transformer_expert_shardings
    from bigdl_tpu_torch.parallel.pipeline import pipelined_transformer_lm
    from bigdl_tpu_torch.parallel.tensor_parallel import (
        TRANSFORMER_RULES, make_param_shardings)
    from bigdl_tpu_torch.utils import load_jax_variables

    variables = inputs[f"vars_{plan['config']}"]
    dims = dict(SIZE, vocab_size=plan["vocab"])
    moe = plan.get("moe", 0)
    drop = plan.get("dropout", 0.0)
    seq_dim = None
    if plan.get("pp_M"):
        model = pipelined_transformer_lm(
            mesh=mesh, num_microbatches=plan["pp_M"], data_axis="data",
            moe_experts=moe, dropout=drop, **dims)
        load_jax_variables(model, to_pipelined(variables,
                                               mesh.shape["pipe"],
                                               SIZE["num_layers"]))
        layouts = model.param_shardings(
            mesh, tp_rules=TRANSFORMER_RULES if mesh.shape["model"] > 1
            else None,
            expert_axis="expert" if mesh.shape["expert"] > 1 else None)
        return model, layouts, None
    kw = {}
    if plan.get("sp_mode"):
        kw = dict(seq_mesh=mesh, seq_mode=plan["sp_mode"])
        seq_dim = 1
    if moe:
        kw.update(moe_experts=moe, moe_mesh=mesh)
    model = nn.Transformer(dropout=drop, **dims, **kw)
    load_jax_variables(model, variables)
    params = dict(model.named_parameters())
    if moe:
        layouts = transformer_expert_shardings(mesh, params)
    else:
        layouts = make_param_shardings(mesh, params, TRANSFORMER_RULES)
    return model, layouts, seq_dim


def _criterion():
    from bigdl_tpu_torch import nn

    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(logits=True))


def _gathered(dp, flat, layouts, mesh, zero1_state=None):
    from bigdl_tpu_torch.parallel.tensor_parallel import gather_variables
    from torch_dist_worker import whole_state

    if zero1_state is not None:
        flat = whole_state(dp, {"s": flat}, zero1_state)["s"]
    return gather_variables(dict(flat), mesh, layouts)


def run_lm(plan, mesh, inputs, results):
    from bigdl_tpu_torch.optim import Adam, make_train_step
    from bigdl_tpu_torch.parallel.data_parallel import (DataParallel,
                                                        build_dp_eval_step,
                                                        build_dp_train_step,
                                                        flat_layouts)
    from bigdl_tpu_torch.parallel.mesh import put_batch

    name = plan["name"]
    model, layouts, seq_dim = build(plan, mesh, inputs)
    crit = _criterion()
    lay = flat_layouts(model, layouts)
    zero1 = plan.get("zero1", True)
    rng = SEED if plan.get("dropout") else None
    x, y = inputs["x"], inputs["y"]
    if plan["vocab"] != 50:
        x, y = inputs["x51"], inputs["y51"]
    xs, ys = put_batch(mesh, x, seq_dim), put_batch(mesh, y, seq_dim)
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    dp = DataParallel(mesh, False, lay, seq_dim)
    params = dp.local_params(model)
    out = {}
    if not plan.get("dropout"):
        fwd = build_dp_eval_step(model, mesh, layouts, seq_dim)
        out["logits"] = fwd(params, state, xs)
        rec = Record()
        step = make_train_step(model, crit, {"__all__": rec},
                               data_parallel=dp)
        _, _, _, loss = step(params, dict(state), {"__all__": {}}, 1, rng,
                             xs, ys, [0.0])
        out["loss"] = loss
        for k, g in _gathered(dp, rec.grads, lay, mesh).items():
            out[f"grads.{k}"] = g
    # one Adam step, clipped
    m = Adam(LR)
    step, pl = build_dp_train_step(model, crit, {"__all__": m}, mesh,
                                   zero1=zero1, grad_clip_norm=CLIP,
                                   param_shardings=layouts, seq_dim=seq_dim)
    dpz = pl["data_parallel"]
    params = dpz.local_params(model)
    opt = {"__all__": dpz.local_state(m.init_state(params), params)}
    new, _, opt, loss = step(params, dict(state), opt, 1, rng, xs, ys, [LR])
    out["step_loss"] = loss
    for k, v in _gathered(dpz, new, lay, mesh).items():
        out[f"params.{k}"] = v
    for k, v in _gathered(dpz, opt["__all__"]["m"], lay, mesh,
                          new).items():
        out[f"m.{k}"] = v
    if plan.get("one_rank") and torch.distributed.get_rank() == 0:
        ref = whole_model(plan, inputs)
        m1 = Adam(LR)
        step1 = make_train_step(ref, crit, {"__all__": m1},
                                grad_clip_norm=CLIP)
        p1 = {k: p.detach().clone() for k, p in ref.named_parameters()}
        s1 = {k: b.detach().clone() for k, b in ref.named_buffers()}
        p1, _, _, l1 = step1(p1, s1, {"__all__": m1.init_state(p1)}, 1, rng,
                             torch.from_numpy(x), torch.from_numpy(y), [LR])
        out["one.step_loss"] = l1
        for k, v in p1.items():
            out[f"one.params.{k}"] = v
    for k, v in out.items():
        results[f"{name}.{k}"] = (v.detach().numpy() if torch.is_tensor(v)
                                  else np.asarray(v))


def whole_model(plan, inputs):
    """The plan's ``nn.Transformer`` on one rank, holding its variables."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils import load_jax_variables

    model = nn.Transformer(dropout=plan.get("dropout", 0.0),
                           vocab_size=plan["vocab"],
                           moe_experts=plan.get("moe", 0), **SIZE)
    load_jax_variables(model, inputs[f"vars_{plan['config']}"])
    return model


def run_moe(plan, mesh, inputs, results):
    """One ``MoE`` layer (the banks over ``expert``, the batch over
    ``data``): its output, ``aux_loss`` and the gradients of
    ``mean(y**2) + aux``, averaged over the data ranks."""
    from bigdl_tpu_torch.parallel.data_parallel import DataParallel
    from bigdl_tpu_torch.parallel.expert import (MoE,
                                                 expert_param_shardings)
    from bigdl_tpu_torch.parallel.mesh import put_batch
    from bigdl_tpu_torch.parallel.tensor_parallel import gather_variables

    name = plan["name"]
    moe = MoE(16, 32, plan["moe"], capacity_factor=plan["capacity"],
              mesh=mesh)
    w = inputs["moe_params"]
    with torch.no_grad():
        for k, p in moe.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(w[k])))
    lay = expert_param_shardings(mesh, dict(moe.named_parameters()))
    dp = DataParallel(mesh, False, lay)
    params = {k: v.requires_grad_(True)
              for k, v in dp.local_params(moe).items()}
    x = put_batch(mesh, inputs["x_moe"])
    buf = {"aux_loss": torch.zeros(())}
    with dp.scope():
        y = torch.func.functional_call(moe, {**params, **buf}, (x,))
        loss = (y ** 2).mean() + buf["aux_loss"]
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    _, grads, _ = dp.reduce(loss.detach(), grads, {})
    from bigdl_tpu_torch.parallel import comm

    results[f"{name}.y"] = comm.all_gather_rows(y.detach(), mesh).numpy()
    results[f"{name}.aux"] = buf["aux_loss"].detach().numpy()
    for k, g in gather_variables(grads, mesh, lay).items():
        results[f"{name}.grads.{k}"] = g.numpy()


def run_attn(plan, mesh, inputs, results):
    """``ring_attention``/``ulysses_attention`` on this rank's sequence
    block of ``attn_q``/``attn_k``/``attn_v`` (B, H, T, D): the output and
    the gradients of ``sum(o * attn_w)``, gathered along T."""
    from bigdl_tpu_torch.parallel import comm
    from bigdl_tpu_torch.parallel.mesh import seq_part
    from bigdl_tpu_torch.parallel.sequence import (ring_attention,
                                                   ulysses_attention)

    name = plan["name"]
    fn = ring_attention if plan["sp_mode"] == "ring" else ulysses_attention
    q, k, v, w = (seq_part(mesh, torch.from_numpy(inputs[f"attn_{n}"]), 2)
                  .contiguous() for n in "qkvw")
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    o = fn(q, k, v, mesh, causal=plan["causal"])
    grads = torch.autograd.grad((o * w).sum(), (q, k, v))
    for n, t in zip(("o", "dq", "dk", "dv"), (o.detach(),) + grads):
        results[f"{name}.{n}"] = comm.all_gather(t, mesh, "seq",
                                                 2).numpy()


def run_pipe_fn(plan, mesh, inputs, results):
    """``pipeline_apply`` of a ``Linear(8, 8)``/``ReLU`` stage over the
    ``pipe`` axis: the output and the gathered gradients of
    ``mean((y - pipe_t)**2)``, and one Adam step of
    ``build_pipeline_train_step``, gathered."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.parallel import comm
    from bigdl_tpu_torch.parallel.pipeline import (build_pipeline_train_step,
                                                   pipeline_apply)

    name = plan["name"]
    stage = nn.Sequential(nn.Linear(8, 8), nn.ReLU())
    r = mesh.rank("pipe")
    stacked = {k: torch.from_numpy(np.asarray(inputs[f"pipe_{k}"]))[r:r + 1]
               .clone() for k, _ in stage.named_parameters()}
    x = torch.from_numpy(inputs["pipe_x"])
    t = torch.from_numpy(inputs["pipe_t"])

    def mse(y, t):
        return ((y - t) ** 2).mean()

    fwd = pipeline_apply(stage, mesh, plan["pp_M"], remat=plan["remat"])
    leaves = {k: v.requires_grad_(True) for k, v in stacked.items()}
    y = fwd(leaves, x)
    grads = torch.autograd.grad(mse(y, t), list(leaves.values()))
    results[f"{name}.y"] = y.detach().numpy()
    for k, g in zip(leaves, grads):
        results[f"{name}.grads.{k}"] = comm.all_gather(g, mesh, "pipe",
                                                       0).numpy()
    method = Adam(0.05)
    step, init = build_pipeline_train_step(stage, mesh, plan["pp_M"], mse,
                                           optim_method=method)
    params = {k: v.detach().clone() for k, v in stacked.items()}
    params, _, loss = step(params, init(params), x, t, 1, 0.05)
    results[f"{name}.step_loss"] = loss.numpy()
    for k, v in params.items():
        results[f"{name}.params.{k}"] = comm.all_gather(v, mesh, "pipe",
                                                        0).numpy()


def run_ckpt(plan, mesh, inputs, results, tmp):
    """The pipelined LM through ``DistriOptimizer``: ``ckpt_write`` trains
    two iterations committing a sharded checkpoint (and, in a second run,
    the blob) under ``plan["root"]``; ``ckpt_read`` waits for that commit
    and resumes it under its own layout.  The final parameters, whole."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.distributed.checkpoint import latest_committed
    from bigdl_tpu_torch.optim import Adam, DistriOptimizer, Trigger

    name = plan["name"]
    root = plan["root"]
    x, y = inputs["x"], inputs["y"]

    def run(sharded: bool, resume: bool, ckpt_dir: str):
        model, layouts, _ = build(plan, mesh, inputs)
        ds = DataSet.from_arrays(np.concatenate([x, x[::-1]]),
                                 np.concatenate([y, y[::-1]]), batch_size=8)
        opt = DistriOptimizer(model, ds, _criterion(),
                              Trigger.max_iteration(2), mesh=mesh,
                              param_shardings=layouts, zero1=False,
                              sharded_checkpoint=sharded, device="cpu")
        opt.set_optim_method(Adam(LR))
        opt.set_gradient_clipping_by_l2_norm(CLIP)
        opt.set_checkpoint(ckpt_dir, Trigger.several_iteration(2))
        opt.over_write_checkpoint()
        if resume:
            opt.resume_from(ckpt_dir)
        opt.optimize()
        return opt.final_params

    if plan["kind"] == "ckpt_write":
        final = run(True, False, root)
        run(False, False, root + "_blob")
    else:
        deadline = time.monotonic() + 120
        while latest_committed(root) is None:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no commit under {root}")
            time.sleep(0.2)
        time.sleep(1.0)  # the writer's other files
        final = run(True, True, root)
    for k, v in final.items():
        results[f"{name}.final.{k}"] = v.detach().numpy()


def lm_world(rank: int, world: int, tmp: str):
    from bigdl_tpu_torch.parallel.mesh import (MeshConfig, init_process_group,
                                               make_mesh)
    from bigdl_tpu_torch.utils.serialization import load_pytree, save_pytree

    torch.set_num_threads(1)
    init_process_group("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                       world_size=world, local_world_size=world,
                       timeout_s=120)
    inputs = load_pytree(f"{tmp}/inputs")
    with open(f"{tmp}/plans.json") as f:
        plans = json.load(f)
    results = {}
    seconds = {}
    for plan in plans:
        t0 = time.perf_counter()
        mesh = make_mesh(MeshConfig(**plan["mesh"]), "cpu")
        kind = plan.get("kind", "lm")
        if kind == "lm":
            run_lm(plan, mesh, inputs, results)
        elif kind == "moe":
            run_moe(plan, mesh, inputs, results)
        elif kind == "attn":
            run_attn(plan, mesh, inputs, results)
        elif kind == "pipe_fn":
            run_pipe_fn(plan, mesh, inputs, results)
        else:
            run_ckpt(plan, mesh, inputs, results, tmp)
        torch.distributed.barrier()
        seconds[plan["name"]] = time.perf_counter() - t0
    if rank == 0:
        results["seconds"] = np.asarray(json.dumps(seconds))
        save_pytree(f"{tmp}/results", results)
    torch.distributed.destroy_process_group()


def write_world(tmp, inputs, plans):
    """The inputs and plans of one world under its directory."""
    from bigdl_tpu_torch.utils.serialization import save_pytree

    os.makedirs(tmp, exist_ok=True)
    save_pytree(os.path.join(tmp, "inputs"), inputs)
    with open(os.path.join(tmp, "plans.json"), "w") as f:
        json.dump(plans, f)
