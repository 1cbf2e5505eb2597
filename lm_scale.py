#!/usr/bin/env python3
"""The Transformer LM's tensor, pipeline, sequence and expert plans on N
cards: each step held against one card, and each plan's step time.

Run from the root of a checkout on a host with N NVIDIA GPUs:

    torchrun --standalone --nproc_per_node N lm_scale.py

Every rank makes its process group with the port's backend rule (NCCL,
one card a rank) and runs, at the LM's full width (LM, BATCH x SEQ
tokens, dropout 0, random weights from SEED), each plan of PLANS over
the N ranks: tensor parallelism over all of them (``tp``), one pipeline
stage a rank (``pp``, PP_M microbatches), tensor x sequence parallelism
(``tp_sp``, ring attention), the Switch-MoE LM with 2 N experts over the
expert axis (``ep``, as ``transformer_train --ep N``), and data
parallelism (``dp``) for comparison.  For each plan:

1. the held f32 steps (SGD at LR_CHECK), eager, with the clip at CLIP
   and without it (the raw gradient, where a gradient scaled on every
   leaf shows): every replicated leaf must equal rank 0's on every rank,
   and the update of every gathered leaf must be within chip_smoke's
   PAR_F32_TOL (relative L2) of the one-card step's on the global batch
   (rank 0 runs it); for ``tp`` also the control, its model-sharded
   gradients doubled, which must land outside that limit;
2. the driver's bf16 step (Adam, the clip): captured in one CUDA graph
   where ``data_parallel.captures`` says so (tp, ep, dp), else eager
   (the pipeline's point-to-point hops and the ring's), timed over TIMED
   steps after WARM: a graph's replays between CUDA events, eager steps
   on the host clock ending in a synchronise.  Rank 0 times the one-card
   compiled steps of the dense and the MoE LM on the whole batch the
   same way, the others waiting.

Rank 0 prints the card's name and power limit and one JSON line, and
writes it to --out (default build/lm_scale.json); the exit code is 0
when every check holds.  ``--device cpu`` rehearses on the CPU over gloo
at CPU_LM and CPU_SEQ (no graph, no timing).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

LM = dict(vocab_size=10001, hidden_size=256, num_heads=8, filter_size=1024,
          num_layers=4)  # bigdl_tpu/models/transformer_train.py defaults
BATCH, SEQ = 8, 512   # the driver's global batch
PP_M = 8              # the driver's 2 x pp microbatches at pp 4
SEED = 0
LR_CHECK, LR = 1e3, 1e-3  # the held step's lr: each weight moves ~0.4,
#                           far above its f32 spacing (chip_smoke PAR_LR)
CLIP = 1.0
CONTROL_PLAN = "tp"   # chip_smoke PAR_CONTROL's check, at n ranks
WARM, TIMED = 3, 20
CPU_LM = dict(vocab_size=50, hidden_size=32, num_heads=4, filter_size=64,
              num_layers=4)
CPU_SEQ = 16


def plans(n: int):
    """name -> (MeshConfig kwargs, model options) at ``n`` ranks."""
    return {"tp": ({"model": n}, {}),
            "pp": ({"pipe": n}, {"pp": True}),
            "tp_sp": ({"model": 2, "seq": n // 2}, {"seq": True}),
            "ep": ({"expert": n}, {"moe": 2 * n}),
            "dp": ({}, {})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "lm_scale.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from chip_smoke import (PAR_F32_TOL, _doubled_model_grads, leaf_errs,
                            lm_variables, pipelined_tree)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import (SGD, Adam, CompiledTrainStep,
                                       make_train_step)
    from bigdl_tpu_torch.parallel.data_parallel import build_dp_train_step
    from bigdl_tpu_torch.parallel.expert import transformer_expert_shardings
    from bigdl_tpu_torch.parallel.mesh import (MeshConfig, Replicated,
                                               init_process_group, make_mesh,
                                               put_batch)
    from bigdl_tpu_torch.parallel.pipeline import pipelined_transformer_lm
    from bigdl_tpu_torch.parallel.tensor_parallel import (
        TRANSFORMER_RULES, gather_variables, make_param_shardings)
    from bigdl_tpu_torch.utils import flatten, load_jax_variables

    cuda = args.device != "cpu"
    lm, seq = (LM, SEQ) if cuda else (CPU_LM, CPU_SEQ)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        _build.build()  # every rank: the libraries are built once
    backend, dev = init_process_group(args.device, timeout_s=600)
    rank, n = dist.get_rank(), dist.get_world_size()
    card = "cpu"
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[dev.index or 0]
    variables = lm_variables(nn.Transformer(dropout=0.0, **lm), SEED)
    experts = plans(n)["ep"][1]["moe"]
    moe_vars = lm_variables(nn.Transformer(dropout=0.0, moe_experts=experts,
                                           **lm), SEED + 2)
    rs = np.random.RandomState(SEED + 1)
    x = rs.randint(0, lm["vocab_size"], (BATCH, seq)).astype(np.int64)
    y = rs.randint(0, lm["vocab_size"], (BATCH, seq)).astype(np.int64)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(logits=True))
    start = {w: {k: np.asarray(v, np.float64) for k, v in
                 flatten(t["params"]).items()}
             for w, t in (("dense", variables), ("moe", moe_vars))}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def build(name, mesh, opts):
        if opts.get("pp"):
            m = pipelined_transformer_lm(mesh=mesh, num_microbatches=PP_M,
                                         data_axis="data", dropout=0.0,
                                         **lm).to(dev)
            load_jax_variables(m, pipelined_tree(
                variables, mesh.shape["pipe"], lm["num_layers"]))
            return m, m.param_shardings(mesh), None
        if opts.get("moe"):
            m = nn.Transformer(dropout=0.0, moe_experts=opts["moe"],
                               moe_mesh=mesh, **lm).to(dev)
            load_jax_variables(m, moe_vars)
            return m, transformer_expert_shardings(
                mesh, dict(m.named_parameters())), None
        m = nn.Transformer(dropout=0.0, seq_mesh=mesh if opts.get("seq")
                           else None, **lm).to(dev)
        load_jax_variables(m, variables)
        lay = make_param_shardings(mesh, dict(m.named_parameters()),
                                   TRANSFORMER_RULES)
        return m, lay, 1 if opts.get("seq") else None

    def timed(step, trees, xs, ys):
        """ms per step: a graph's replays between CUDA events, else eager
        steps on the host clock."""
        for i in range(WARM):
            *trees, loss = step(*trees, i + 1, None, xs, ys, [LR])
        sync()
        if step.capture and cuda:
            graph = next(iter(step.graphs.values())).graph
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(TIMED):
                graph.replay()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / TIMED
        t0 = time.perf_counter()
        for i in range(TIMED):
            *trees, loss = step(*trees, WARM + i + 1, None, xs, ys, [LR])
        float(loss)
        sync()
        return (time.perf_counter() - t0) / TIMED * 1e3

    # the one-card f32 steps on rank 0, with the clip and without (the
    # references of every plan; the MoE LM's for ``ep``)
    one = {}
    if rank == 0:
        for w, tree, e in (("dense", variables, 0), ("moe", moe_vars,
                                                     experts)):
            m = nn.Transformer(dropout=0.0, moe_experts=e, **lm).to(dev)
            load_jax_variables(m, tree)
            for clip in (CLIP, None):
                step = make_train_step(m, crit, {"__all__": SGD(LR_CHECK)},
                                       grad_clip_norm=clip)
                p1 = {k: p.detach().clone() for k, p in m.named_parameters()}
                s1 = {k: b.detach().clone() for k, b in m.named_buffers()}
                p1, _, _, loss1 = step(p1, s1, {"__all__": {}}, 1, None,
                                       torch.from_numpy(x).to(dev),
                                       torch.from_numpy(y).to(dev),
                                       [LR_CHECK])
                one[w, clip] = ({k: v.detach().cpu().double().numpy()
                                 for k, v in p1.items()}, float(loss1))
            del m, step, p1, s1
    res = {"card": card, "backend": backend, "world": n, "lm": lm,
           "batch": BATCH, "seq": seq, "pp_microbatches": PP_M,
           "experts": experts, "tol": PAR_F32_TOL, "plans": {}}
    ok = True
    for name, (mesh_kw, opts) in plans(n).items():
        mesh = make_mesh(MeshConfig(**mesh_kw), args.device)
        model, lay, seq_dim = build(name, mesh, opts)
        xs, ys = put_batch(mesh, x, seq_dim), put_batch(mesh, y, seq_dim)
        zero1 = not opts.get("pp")
        w = "moe" if opts.get("moe") else "dense"
        row = {"mesh": mesh_kw}
        # 1. the held f32 steps, eager: with the clip, without it, and
        # for tp the control (its model-sharded gradients doubled)
        held = [("", CLIP), ("raw_", None)]
        if name == CONTROL_PLAN:
            held.append(("control_", None))
        for tag, clip in held:
            step, pl = build_dp_train_step(
                model, crit, {"__all__": SGD(LR_CHECK)}, mesh, zero1=zero1,
                grad_clip_norm=clip, param_shardings=lay, seq_dim=seq_dim)
            step.capture = False
            dp = pl["data_parallel"]
            if tag == "control_":
                dp.reduce = _doubled_model_grads(dp)
            params = dp.local_params(model)
            state = {k: b.detach().clone() for k, b in
                     model.named_buffers()}
            _, _, _, loss = step(params, state, {"__all__": {}}, 1, None,
                                 xs, ys, [LR_CHECK])
            equal = True
            for k, v in params.items():
                if isinstance(pl["params"][k], Replicated):
                    ref = v.detach().clone()
                    dist.broadcast(ref, 0)
                    equal = equal and bool(torch.equal(ref, v))
            flag = torch.tensor([0.0 if equal else 1.0], device=dev)
            dist.all_reduce(flag)
            whole = gather_variables(params, mesh, pl["params"])
            row[tag + "replicas_equal"] = float(flag) == 0
            if rank == 0:
                ref, ref_loss = one[w, clip]
                errs = leaf_errs(
                    {k: v.detach().cpu().double().numpy()
                     for k, v in whole.items()}, ref, start[w],
                    mesh.shape["pipe"], lm["num_layers"])
                worst = max(errs.items(), key=lambda kv: kv[1])
                row.update({tag + "loss": float(loss),
                            tag + "one_card_loss": ref_loss,
                            tag + "update_err": worst[1],
                            tag + "worst_leaf": worst[0],
                            tag + "loss_err": abs(float(loss) - ref_loss)
                            / abs(ref_loss)})
                if tag == "control_":  # must fail the comparison
                    ok = ok and worst[1] > PAR_F32_TOL["update"]
                else:
                    ok = ok and row[tag + "replicas_equal"] and \
                        worst[1] <= PAR_F32_TOL["update"] and \
                        row[tag + "loss_err"] <= PAR_F32_TOL["loss"]
            del step, params, state, whole
        # 2. the driver's bf16 step, timed
        if cuda:
            method = Adam(LR)
            step, pl = build_dp_train_step(
                model, crit, {"__all__": method}, mesh, zero1=zero1,
                grad_clip_norm=CLIP, compute_dtype=torch.bfloat16,
                param_shardings=lay, seq_dim=seq_dim)
            dp = pl["data_parallel"]
            params = dp.local_params(model)
            state = {k: b.detach().clone() for k, b in model.named_buffers()}
            opt = {"__all__": dp.local_state(method.init_state(params),
                                             params)}
            ms = timed(step, (params, state, opt), xs, ys)
            row.update(ms_per_step=ms, tokens_per_s=BATCH * seq / ms * 1e3,
                       captured=bool(step.capture))
            del step, params, state, opt
            torch.cuda.empty_cache()
        res["plans"][name] = row
        del model
        dist.barrier()
    if cuda:  # the one-card compiled bf16 steps, the others waiting: the
        #       dense LM (every plan but ep) and the MoE LM (ep's)
        if rank == 0:
            for key, tree, e in (("one_card", variables, 0),
                                 ("one_card_moe", moe_vars, experts)):
                m = nn.Transformer(dropout=0.0, moe_experts=e, **lm).to(dev)
                load_jax_variables(m, tree)
                method = Adam(LR)
                step = CompiledTrainStep(make_train_step(
                    m, crit, {"__all__": method}, grad_clip_norm=CLIP,
                    compute_dtype=torch.bfloat16))
                p1 = {k: p.detach().clone()
                      for k, p in m.named_parameters()}
                s1 = {k: b.detach().clone() for k, b in m.named_buffers()}
                ms = timed(step, (p1, s1,
                                  {"__all__": method.init_state(p1)}),
                           torch.from_numpy(x).to(dev),
                           torch.from_numpy(y).to(dev))
                res[key] = {"ms_per_step": ms,
                            "tokens_per_s": BATCH * seq / ms * 1e3,
                            "captured": True}
                del m, step, p1, s1
                torch.cuda.empty_cache()
        dist.barrier()
    if rank == 0:
        res["ok"] = ok
        print(f"card: {card}", flush=True)
        print(json.dumps(res), flush=True)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
        if not ok:
            print("lm_scale: FAIL: a plan's replicas differ, its update is "
                  f"past {PAR_F32_TOL} of the one card's, or the control "
                  "is inside it", file=sys.stderr, flush=True)
    flag = torch.tensor([0.0 if ok else 1.0], device=dev)
    dist.all_reduce(flag)
    dist.destroy_process_group()
    return int(flag.item() > 0)


if __name__ == "__main__":
    sys.exit(main())
