#!/usr/bin/env python3
"""The data-parallel fused ResNet-50 step on N cards: held against one
card on the global batch, and its weak-scaling step time.

Run from the root of a checkout on a host with N NVIDIA GPUs:

    torchrun --standalone --nproc_per_node N dp_scale.py

Every rank makes its process group with the port's backend rule (NCCL,
one card a rank), builds the fused ResNet-50 (space-to-depth stem, 1000
classes, random weights from SEED, every BatchNorm leaf randomised)
and the dp step of ``build_dp_train_step`` (sync-BN through kernels 1-5's
statistics, ZeRO-1, one CUDA graph with its collectives inside):

1. f32 at CHECK_BATCH images a rank: one dp step; every leaf of every
   rank must equal rank 0's bit for bit (the ZeRO-1 gather), and rank 0
   runs the single-card step (``make_train_step``, kernels, no
   collective) on the whole global batch from the same weights.  The
   same dp step with per-replica BatchNorm (``chip_smoke``'s
   ``per_replica_bn_step``) is the control, and the single card on the
   global batch's rows reversed (the same function, another summation
   order) the rounding floor.  For each, the update's distance from the
   single card's (the whole model's relative L2, and each leaf's, its
   worst leaves named): the dp step must be within TOL and the control
   outside it;
2. bf16 at BATCH images a rank (the bench step, remat on): the captured
   dp step's replays timed between CUDA events, and rank 0's
   single-card compiled step on its own rows timed the same way, the
   others waiting: weak-scaling efficiency = single-card ms / dp ms.

Rank 0 prints the card's name and power limit and one JSON line, and
writes it to --out (default build/dp_scale.json).  ``--device cpu``
rehearses on the CPU over gloo at CPU_RES and CPU_CHECK_BATCH (no graph,
no timing).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BATCH = 256           # bf16 images a rank in the timed bench step
CHECK_BATCH = 32      # f32 images a rank in the held step
RES = 224
SEED = 0
TOL = 0.1             # the dp step's update against the single card's
#                       (whole-model relative L2); the control must exceed
CPU_RES, CPU_CHECK_BATCH = 64, 2  # the --device cpu rehearsal
TIMED = 50            # replays timed


def update_distance(got, want, start):
    """The update ``got - start`` against ``want - start``: the whole
    model's relative L2 and each leaf's (float64 on the host)."""
    num = den = 0.0
    leaves = {}
    for k in want:
        d = float((got[k] - want[k]).norm() ** 2)
        u = float((want[k] - start[k]).norm() ** 2)
        num, den = num + d, den + u
        leaves[k] = (d / max(u, 1e-60)) ** 0.5
    return (num / den) ** 0.5, leaves


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "dp_scale.json")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from chip_smoke import per_replica_bn_step, replay_ms

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import SGD, CompiledTrainStep, make_train_step
    from bigdl_tpu_torch.parallel.data_parallel import build_dp_train_step
    from bigdl_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                               init_process_group, put_batch)
    from bigdl_tpu_torch.utils import (export_variables, load_jax_variables,
                                       random_variables)

    cuda = args.device != "cpu"
    res_px, check_batch = (RES, CHECK_BATCH) if cuda else (
        CPU_RES, CPU_CHECK_BATCH)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        _build.build()  # every rank: the library is built once, atomically
    backend, dev = init_process_group(args.device, timeout_s=600)
    mesh = data_parallel_mesh(device=args.device)
    rank, n = mesh.rank(), mesh.size
    card = "cpu"
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[dev.index or 0]
    variables = random_variables(export_variables(
        ResNet50(1000, stem="space_to_depth", fused=True, device="cpu")),
        SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    crit = nn.ClassNLLCriterion(logits=True)

    def model():
        m = ResNet50(1000, stem="space_to_depth", fused=True, device=dev)
        load_jax_variables(m, variables)
        return m

    def trees(m, method):
        params = {k: p.detach().clone() for k, p in m.named_parameters()}
        state = {k: b.detach().clone() for k, b in m.named_buffers()}
        return params, state, {"__all__": method.init_state(params)}

    # 1. one f32 dp step, and its per-replica-BN control, against the
    # single card on the global batch
    xg = torch.rand((n * check_batch, res_px, res_px, 3), generator=gen)
    yg = torch.randint(0, 1000, (n * check_batch,), generator=gen)
    xr, yr = put_batch(mesh, xg), put_batch(mesh, yg)
    m = model()
    start = {k: p.detach().cpu().double() for k, p in m.named_parameters()}
    method = SGD(0.1, momentum=0.9)
    runs, equal = {}, True
    for name in ("dp", "control"):
        if name == "dp":
            step, placement = build_dp_train_step(m, crit,
                                                  {"__all__": method}, mesh)
            dp = placement["data_parallel"]
        else:
            step, dp = per_replica_bn_step(m, crit, {"__all__": method},
                                           mesh)
        params, state, opt = trees(m, method)
        opt = {"__all__": dp.local_state(opt["__all__"], params)}
        params, _, _, loss = step(params, state, opt, 1, None, xr, yr, [0.1])
        if name == "dp":  # every leaf on every rank equal to rank 0's
            for v in params.values():
                ref = v.detach().clone()
                dist.broadcast(ref, 0)
                equal = equal and bool(torch.equal(ref, v))
        runs[name] = ({k: v.detach().cpu().double()
                       for k, v in params.items()}, float(loss))
        del step, params, state, opt
    flag = torch.tensor([0.0 if equal else 1.0], device=dev)
    dist.all_reduce(flag)
    replicas_equal = float(flag) == 0
    del m
    check = {"batch_per_rank": check_batch, "res": res_px,
             "replicas_equal": replicas_equal, "tol": TOL}
    if rank == 0:  # the single card, and on the rows reversed
        m = model()
        local = make_train_step(m, crit, {"__all__": SGD(0.1, momentum=0.9)})
        for name, idx in (("single", slice(None)),
                          ("reversed", torch.arange(len(xg)).flip(0))):
            params, state, opt = trees(m, SGD(0.1, momentum=0.9))
            params1, _, _, loss1 = local(params, state, opt, 1, None,
                                         xg[idx].to(dev), yg[idx].to(dev),
                                         [0.1])
            runs[name] = ({k: v.detach().cpu().double()
                           for k, v in params1.items()}, float(loss1))
            del params, state, opt, params1
        one, check["single_card_loss"] = runs.pop("single")
        for name, (got, loss) in runs.items():
            whole, leaves = update_distance(got, one, start)
            worst = sorted(leaves, key=leaves.get, reverse=True)[:3]
            check[name] = {
                "loss": loss, "update_rel_l2": whole,
                "worst_leaves": {k: [leaves[k], float(
                    (one[k] - start[k]).norm()), one[k].numel()]
                    for k in worst}}
        del m, local
    dist.barrier()
    if cuda:
        torch.cuda.empty_cache()

    # 2. the bf16 bench step: dp replays against the single card's
    res = {"card": card, "backend": backend, "world": n, "check": check}
    if cuda:
        x = torch.rand((n * BATCH, RES, RES, 3),
                       generator=gen).to(torch.bfloat16)
        y = torch.randint(0, 1000, (n * BATCH,), generator=gen)
        m = model()
        step, placement = build_dp_train_step(
            m, crit, {"__all__": method}, mesh,
            compute_dtype=torch.bfloat16)
        params, state, opt = trees(m, method)
        opt = {"__all__": placement["data_parallel"].local_state(
            opt["__all__"], params)}
        xr, yr = put_batch(mesh, x), put_batch(mesh, y)
        for i in range(2):
            params, state, opt, loss = step(params, state, opt, i + 1, None,
                                            xr, yr, [0.1])
        graph = next(iter(step.graphs.values())).graph
        dp_ms = replay_ms(graph, TIMED)
        del step, params, state, opt, m, graph
        torch.cuda.empty_cache()
        dist.barrier()
        local_ms = None
        if rank == 0:
            m = model()
            local = CompiledTrainStep(make_train_step(
                m, crit, {"__all__": method},
                compute_dtype=torch.bfloat16))
            params, state, opt = trees(m, method)
            xl, yl = xr.clone(), yr.clone()
            for i in range(2):
                params, state, opt, _ = local(params, state, opt, i + 1,
                                              None, xl, yl, [0.1])
            local_ms = replay_ms(next(iter(local.graphs.values())).graph,
                                 TIMED)
        dist.barrier()
        res["bench"] = {"batch_per_rank": BATCH, "dp_ms": dp_ms,
                        "single_card_ms": local_ms,
                        "images_per_s": n * BATCH / dp_ms * 1e3}
        if local_ms:
            res["bench"]["weak_scaling_efficiency"] = local_ms / dp_ms
    ok = True
    if rank == 0:
        dp_rel = check["dp"]["update_rel_l2"]
        control_rel = check["control"]["update_rel_l2"]
        ok = replicas_equal and dp_rel <= TOL < control_rel
        print(f"card: {card}", flush=True)
        print(json.dumps(res), flush=True)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
        if not ok:
            print(f"dp_scale: FAIL: replicas equal {replicas_equal}; the "
                  f"dp step's update {dp_rel:.3g} from the single card's "
                  f"and the per-replica-BN control's {control_rel:.3g} "
                  f"(the first must be within {TOL}, the second outside)",
                  file=sys.stderr, flush=True)
    flag = torch.tensor([0.0 if ok else 1.0], device=dev)
    dist.all_reduce(flag)
    dist.destroy_process_group()
    return int(flag.item() > 0)


if __name__ == "__main__":
    sys.exit(main())
