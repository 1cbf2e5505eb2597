"""Elastic training worker: one OS process per generation (counterpart of
bigdl_tpu/distributed/worker.py).

:class:`~bigdl_tpu_torch.distributed.elastic.ElasticAgent` launches it as
``python -m bigdl_tpu_torch.distributed.worker``; everything it needs
arrives in ``BIGDL_ELASTIC_*`` environment variables (the work directory,
the generation, rank and world, rank 0's address from the generation's
manifest, the checkpoint root, the iterations, the checkpoint cadence,
the global batch).  The job is the JAX worker's deterministic one: the
MLP 8-16-2 on ``RandomState(0)`` data, so loss curves compare across
world sizes: ``DataSet.sharded`` slices a fixed global batch stream per
rank, which keeps the global batches, and the curve, the same through
a re-formation.

The process group is made with an explicit timeout (``TIMEOUT_S``)
under the backend rule:
``BIGDL_ELASTIC_DEVICE`` (default the card; ``cpu`` for the CPU) and
the ranks on this host (``LOCAL_WORLD_SIZE``, default the whole world)
choose NCCL or gloo.

Exit codes: 0 = end trigger reached; 3 = drained on SIGTERM (preempted:
state committed, rejoin later); anything else = failure.  Each drained
loss goes to ``losses-g<gen>-r<rank>.jsonl`` in the work directory; a
finished rank writes ``worker-result-g<gen>-r<rank>.json`` with a
parameter digest and the final parameters.
"""
from __future__ import annotations

import json
import os
import sys

#: the process group's timeout: a collective waiting on a dead peer
#: raises after it, so the agent can re-form
TIMEOUT_S = 60.0


def main() -> int:
    workdir = os.environ["BIGDL_ELASTIC_WORKDIR"]
    gen = int(os.environ.get("BIGDL_ELASTIC_GEN", "1"))
    rank = int(os.environ.get("BIGDL_ELASTIC_RANK", "0"))
    world = int(os.environ.get("BIGDL_ELASTIC_WORLD", "1"))
    coord = os.environ.get("BIGDL_ELASTIC_COORD", "")
    ckpt_root = os.environ.get(
        "BIGDL_ELASTIC_CKPT", os.path.join(workdir, "ckpt"))
    total_iters = int(os.environ.get("BIGDL_ELASTIC_ITERS", "12"))
    ckpt_every = int(os.environ.get("BIGDL_ELASTIC_CKPT_EVERY", "3"))
    global_batch = int(os.environ.get("BIGDL_ELASTIC_BATCH", "16"))
    device = os.environ.get("BIGDL_ELASTIC_DEVICE") or None

    import numpy as np
    import torch

    torch.set_num_threads(1)  # a tiny MLP; ranks may share the host

    from bigdl_tpu_torch import nn, telemetry
    from bigdl_tpu_torch.dataset.dataset import DataSet
    from bigdl_tpu_torch.distributed.elastic import ElasticDistriOptimizer
    from bigdl_tpu_torch.distributed.rendezvous import FileRendezvous
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.optim.triggers import Trigger
    from bigdl_tpu_torch.parallel.mesh import elastic_mesh, init_process_group
    from bigdl_tpu_torch.telemetry.cluster import (EVENT_WORKER_START,
                                                   TelemetryShipper,
                                                   telemetry_dir)

    init_process_group(
        device, init_method=f"tcp://{coord}" if world > 1 else None,
        rank=rank, world_size=world,
        local_world_size=int(os.environ.get("LOCAL_WORLD_SIZE", world)),
        timeout_s=TIMEOUT_S)

    # the data stream depends only on the seed, never on rank or world
    rs = np.random.RandomState(0)
    feats = rs.rand(64, 8).astype(np.float32)
    labels = (feats.sum(-1) > 4.0).astype(np.int64)
    ds = DataSet.sharded(feats, labels, global_batch,
                         process_id=rank, num_processes=world, seed=0)

    torch.manual_seed(42)  # the same weights on every rank, every world
    model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
    criterion = nn.ClassNLLCriterion(logits=True)
    mesh = elastic_mesh(device=device)  # data absorbs every rank

    # cluster telemetry: with BIGDL_TPU_TELEMETRY_DIR pointing at a shared
    # run directory, trace and ship this process's spans and metrics into
    # it, clock-aligned by the rendezvous heartbeat exchange
    shipper = None
    opt = None
    tdir = telemetry_dir()
    if tdir:
        telemetry.enable()
        host = os.environ.get("BIGDL_ELASTIC_HOST", f"rank{rank}")
        rdzv = FileRendezvous(os.path.join(workdir, "rendezvous"), host)
        shipper = TelemetryShipper(
            tdir, host, gen=gen, clock_offset_fn=rdzv.clock_offset_sample)
        shipper.add_metrics("train", lambda: getattr(opt, "metrics", None))
        srv = telemetry.get_debug_server()
        if srv is not None:
            srv.set_status("generation", gen)
            srv.set_status("rank", rank)
            srv.set_status("world", world)
        flight = telemetry.get_flight_recorder(out_dir=tdir)
        if flight is not None:
            flight.add_metrics("train",
                               lambda: getattr(opt, "metrics", None))
        shipper.event(EVENT_WORKER_START, gen=gen, rank=rank, world=world)
        shipper.ship_now()  # on disk before the first step
        shipper.start()

    losses_path = os.path.join(workdir, f"losses-g{gen}-r{rank}.jsonl")

    class LossRecorder:
        """A minimal train summary: the drained Loss scalars only."""

        def __init__(self):
            self._f = open(losses_path, "a")

        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                self._f.write(json.dumps(
                    {"it": int(step), "loss": float(value),
                     "gen": gen, "rank": rank}) + "\n")
                self._f.flush()

        def close(self):
            self._f.close()

    recorder = LossRecorder()
    opt = ElasticDistriOptimizer(
        model, ds, criterion,
        end_trigger=Trigger.max_iteration(total_iters),
        mesh=mesh, ckpt_root=ckpt_root,
        ckpt_trigger=Trigger.several_iteration(ckpt_every))
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_train_summary(recorder)
    try:
        opt.optimize()
    finally:
        recorder.close()
        if shipper is not None:
            shipper.close()

    if opt.stopped_early:
        return 3

    params = {k: v.detach().cpu().double()
              for k, v in opt.final_params.items()}
    digest = float(sum(v.abs().sum() for v in params.values()))
    with open(os.path.join(
            workdir, f"worker-result-g{gen}-r{rank}.json"), "w") as f:
        json.dump({"gen": gen, "rank": rank, "world": world,
                   "digest": digest, "iterations": total_iters,
                   "params": {k: v.tolist() for k, v in params.items()}},
                  f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
