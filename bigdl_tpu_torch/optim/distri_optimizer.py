"""DistriOptimizer: synchronous training over the mesh (counterpart of
bigdl_tpu/optim/distri_optimizer.py:37-361).

Every rank runs this loop, one process per device, with the same
triggers, seeds and rates: it feeds its rows of each global batch
(``put_batch``; a dataset that already shards by rank, such as
``DistributedDataSet``, is fed as it is) to the data-parallel step
(``parallel/data_parallel.py``: global BatchNorm statistics, gradients
averaged over the data axis, ZeRO-1 by default), or with
``grad_compression`` (``"bf16"``/``"fp8"``, or ``BIGDL_TPU_GRAD_COMPRESS``)
to the compressed step (``distributed/compression.py``).  What stays on
the host is :class:`LocalOptimizer`'s: triggers, validation, checkpoints,
retry, resume, metrics and the log lines.

With ``param_shardings`` (tensor, pipeline and expert layouts) every rank
starts from rank 0's whole trees and keeps its shards of them (the
step's parameters, and each method's state built over them); with
``seq_dim`` each rank feeds its part of the batch's sequence dim and
the targets' matching part.  ``final_params`` are whole leaves again,
gathered over the shards' axes at the end.

Validation runs the sharded forward (``build_dp_eval_step``): each rank
its rows (and sequence part), the outputs gathered, the methods over the
global batch.

Checkpoints: by default the loop's blob, written by rank 0 after every
rank gathers the ZeRO-1 optimizer state and the shards into whole leaves
(collectives); with ``sharded_checkpoint=True`` every rank writes its own
chunks through ``distributed/checkpoint.py``'s two-phase commit (each
chunk with its bounds on every dim, written by one rank of the ranks
that hold it; rank 0 the replicated leaves and the manifest), and a
restore reassembles each rank's shards whatever world and layout wrote
them.  The trees are in the JAX package's nesting,
so either package resumes from the other's checkpoint.

With ``BIGDL_TPU_SYNC_LOOP=1`` the ``allreduce`` gauge is the step's
``compute`` time less a collective-free step's on this rank's batch,
timed once after the first iteration (``phase_calibration``); the async
loop's host waits show up as ``data_stall``/``sync`` instead, and it
calibrates nothing (distri_optimizer.py:152-228).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.device import DeviceLike
from bigdl_tpu_torch.optim.optimizer import (CompiledTrainStep,
                                             LocalOptimizer, _LOOP_SEED,
                                             make_train_step)
from bigdl_tpu_torch.nn.module import split_rng
from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.mesh import (AXES, DATA_AXIS, MeshConfig,
                                           Replicated, Sharded, make_mesh,
                                           put_batch, seq_part)
from bigdl_tpu_torch.telemetry.tracer import CAT_TRAIN, get_tracer
from bigdl_tpu_torch.utils.convert import (_fill, _nest, export_variables,
                                           flatten)

logger = logging.getLogger("bigdl_tpu_torch.optim")


def dist_rank() -> int:
    """This process's rank in the world (the blob's one writer is 0)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0

__all__ = ["DistriOptimizer"]


def _map(tree, fn):
    """``fn`` over the arrays of a batch tree (an array, or a list or
    tuple of them)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return None if tree is None else fn(tree)


class DistriOptimizer(LocalOptimizer):
    """The distributed loop; see the module's docstring.  ``mesh``
    defaults to ``make_mesh()`` over the world's ranks on ``device`` (the
    card unless ``"cpu"``)."""

    def __init__(self, model, dataset, criterion, end_trigger=None,
                 batch_size: Optional[int] = None, mesh=None,
                 zero1: bool = True, param_shardings=None,
                 seq_dim: Optional[int] = None,
                 sharded_checkpoint: bool = False,
                 grad_compression: Optional[str] = None,
                 device: DeviceLike = None):
        self.mesh = mesh if mesh is not None else make_mesh(MeshConfig(),
                                                            device)
        super().__init__(model, dataset, criterion, end_trigger, batch_size,
                         self.mesh.device)
        self.zero1 = zero1
        self.param_shardings = param_shardings
        self.seq_dim = seq_dim
        self.sharded_checkpoint = sharded_checkpoint
        self._sharded_ckpt = None
        if grad_compression is None:
            grad_compression = os.environ.get("BIGDL_TPU_GRAD_COMPRESS", "")
        self.grad_compression = grad_compression or None
        self._placement: Optional[Dict[str, Any]] = None
        self._dp = None
        self.phase_instrumentation = True
        self._local_step_time: Optional[float] = None
        self._calib_batch = None
        self._dist_eval = None
        self._param_template = None

    # -- the step ------------------------------------------------------
    def _build_step_fn(self, model) -> CompiledTrainStep:
        # parallel.data_parallel imports this package's modules
        from bigdl_tpu_torch.parallel.data_parallel import \
            build_dp_train_step

        numerics = self._numerics_spec(model)
        if self.grad_compression:
            from bigdl_tpu_torch.distributed.compression import (
                build_compressed_dp_train_step)

            if self.accum_steps != 1 or self.compute_dtype is not None \
                    or self.param_shardings is not None \
                    or self.seq_dim is not None:
                raise ValueError(
                    "grad_compression composes with the plain dp layout "
                    "only (no accumulation / compute_dtype / "
                    "param_shardings)")
            step, placement = build_compressed_dp_train_step(
                model, self.criterion, self.optim_methods, self.mesh,
                wire_dtype=self.grad_compression,
                grad_clip_const=self.grad_clip_const,
                grad_clip_norm=self.grad_clip_norm, numerics=numerics)
        else:
            step, placement = build_dp_train_step(
                model, self.criterion, self.optim_methods, self.mesh,
                zero1=self.zero1, grad_clip_const=self.grad_clip_const,
                grad_clip_norm=self.grad_clip_norm,
                compute_dtype=self.compute_dtype,
                param_shardings=self.param_shardings, seq_dim=self.seq_dim,
                accum_steps=self.accum_steps, numerics=numerics)
        self._placement = placement
        self._dp = placement["data_parallel"]
        return step

    def _sync_replicas(self, params, model_state):
        """Rank 0's parameters and model state on every rank (JAX's
        replicated arrays are one value by construction), then each
        sharded parameter cut to this rank's shard, in place in
        ``params``."""
        leaves = list(params.values()) + list(model_state.values())
        for axis in AXES:  # rank (0, ..., 0)'s values along every axis
            if self.mesh.shape[axis] > 1:
                comm.broadcast_leaves(leaves, self.mesh, axis=axis)
        for k, p in params.items():
            part = self._layout(k)
            if isinstance(part, Sharded):
                params[k] = part.local(p).clone()

    def _layout(self, key: str):
        """A parameter's layout (replicated under the compressed step)."""
        layout_of = getattr(self._dp, "layout_of", None)
        return layout_of(key) if layout_of is not None else Replicated()

    @property
    def _sharded_params(self) -> bool:
        return any(isinstance(self._layout(k), Sharded)
                   for k, _ in self.model.named_parameters())

    def _whole_params(self, params):
        """Every sharded parameter gathered whole (collectives every rank
        joins)."""
        from bigdl_tpu_torch.parallel.tensor_parallel import \
            gather_variables

        return gather_variables(dict(params), self.mesh,
                                self._placement["params"])

    def _finish_model(self, model, params, model_state):
        if self._sharded_params:
            params = self._whole_params(params)
        return super()._finish_model(model, params, model_state)

    def _init_opt_states(self, params):
        """Each method's state; with ZeRO-1 this rank's rows of it."""
        states = super()._init_opt_states(params)
        if not self._dp.zero1:
            return states
        return {name: self._dp.local_state(st, params)
                for name, st in states.items()}

    def _local_batches(self, dataset) -> bool:
        """Whether ``dataset`` yields this rank's rows already."""
        return getattr(dataset, "num_processes", 1) > 1

    def _place_batch(self, batch, non_blocking: bool = False):
        local = self._local_batches(self.dataset)
        if local and self.accum_steps > 1:
            raise NotImplementedError(
                "gradient accumulation over a dataset that shards by rank: "
                "feed global batches (the micro-batches are cut from them)")
        if (self.phase_instrumentation and self._local_step_time is None
                and self._sync_loop and self.mesh.size > 1
                and self.param_shardings is None and self.seq_dim is None):
            # calibrated in _one_iteration, outside the 'data' timer
            self._calib_batch = batch

        def put(a):
            return put_batch(self.mesh, a, local=local,
                             accum_steps=self.accum_steps)

        def put_seq(a):
            t = put(a)
            # the targets' part matching the local logits
            return (seq_part(self.mesh, t, self.seq_dim)
                    if self.seq_dim is not None and t.dim() > self.seq_dim
                    else t)

        return (_map(batch.get_input(), put_seq),
                _map(batch.get_target(), put_seq), batch.size)

    def _calibrate_local_step(self, batch, reps: int = 3):
        """Time a collective-free step on this rank's rows (the
        ``allreduce`` gauge is the data-parallel step's time less
        this)."""
        self._local_step_time = 0.0  # never again, whatever happens
        try:
            features, targets, _ = LocalOptimizer._place_batch(self, batch)
            local = self._local_batches(self.dataset)
            n = self.mesh.size
            if not local:
                b = features.shape[0] // n
                features, targets = features[:b], targets[:b]
            step = CompiledTrainStep(make_train_step(
                self.model, self.criterion, self.optim_methods,
                self.grad_clip_const, self.grad_clip_norm,
                self.compute_dtype, accum_steps=self.accum_steps))
            params = {k: p.detach().clone()
                      for k, p in self.model.named_parameters()}
            state = {k: b.detach().clone()
                     for k, b in self.model.named_buffers()}
            opt = LocalOptimizer._init_opt_states(self, params)
            lrs = [m.current_rate()
                   for _, m in sorted(self.optim_methods.items())]
            trees = (params, state, opt)
            float(step(*trees, 1, split_rng(_LOOP_SEED, 0), features,
                       targets, lrs)[3])
            t0 = time.perf_counter()
            for i in range(reps):
                loss = step(*trees, i + 2, split_rng(_LOOP_SEED, 0),
                            features, targets, lrs)[3]
            float(loss)
            self._local_step_time = (time.perf_counter() - t0) / reps
            logger.info("Phase calibration: local per-device step %.2fms "
                        "(allreduce gauge = sharded step - this)",
                        1e3 * self._local_step_time)
        except (RuntimeError, ValueError) as e:
            # calibration must never kill training
            logger.warning("Phase calibration failed: %s", e)

    def _one_iteration(self, *args, **kwargs):
        out = super()._one_iteration(*args, **kwargs)
        batch, self._calib_batch = self._calib_batch, None
        if batch is not None:
            # a named span: the one-off calibration is a blip a trace
            # must be able to explain
            with get_tracer().span("phase_calibration", CAT_TRAIN):
                self._calibrate_local_step(batch)
        if self._local_step_time and self.metrics.count("compute") > 1:
            # the last sample, not the mean, which carries the capture
            est = max(0.0, self.metrics.last("compute")
                      - self._local_step_time)
            self.metrics.set_gauge("allreduce", est)
        return out

    def _step_n_devices(self) -> int:
        """Devices the step spans: the mesh's ranks."""
        return self.mesh.size

    # -- validation ----------------------------------------------------
    @torch.no_grad()
    def _evaluate(self, model, params, model_state):
        """The sharded evaluation: each rank forwards its rows, every
        rank gets the global batch's outputs, the methods run on them."""
        if self._dist_eval is None:
            from bigdl_tpu_torch.parallel.data_parallel import \
                build_dp_eval_step

            self._dist_eval = build_dp_eval_step(
                model, self.mesh, self.param_shardings, self.seq_dim)
        local = self._local_batches(self.val_dataset)
        model.eval()
        totals = [None] * len(self.val_methods)
        for batch in self.val_dataset.data(train=False):
            x = _map(batch.get_input(),
                     lambda a: put_batch(self.mesh, a, self.seq_dim,
                                         local=local))
            out = self._dist_eval(params, model_state, x)
            target = batch.get_target()
            if local:  # every rank's targets, in the outputs' order
                target = comm.all_gather_rows(
                    put_batch(self.mesh, target, local=True),
                    self.mesh).cpu().numpy()
            for i, m in enumerate(self.val_methods):
                r = m(out, target)
                totals[i] = r if totals[i] is None else totals[i] + r
        return list(zip(self.val_methods, totals))

    # -- checkpoints ---------------------------------------------------
    def _zero1_parts(self):
        """Each parameter's ZeRO-1 rows of its local shard (None where
        the leaf stays whole on every data rank)."""
        if not self._dp.zero1:
            return {}
        local = {k: torch.empty(self._layout(k).local_shape(p.shape))
                 for k, p in self.model.named_parameters()}
        return self._dp.layout(local)

    def _whole_opt_states(self, opt_states):
        """The optimizer states with every ZeRO-1 leaf gathered over the
        data axis, and every sharded leaf over its axes, whole
        (collectives every rank joins)."""
        parts = self._zero1_parts()
        out = {}
        for name, st in opt_states.items():
            out[name] = {}
            for slot, flat in st.items():
                keys = [k for k in flat if parts.get(k) is not None]
                whole = (comm.gather_leaves([flat[k] for k in keys],
                                            self.mesh) if keys else [])
                flat = {**flat, **dict(zip(keys, whole))}
                if self._sharded_params:
                    flat = self._whole_params(flat)
                out[name][slot] = flat
        return out

    def _host_state(self, driver_state) -> Dict[str, Any]:
        """JSON-able host-side state for the sharded manifest."""
        def js(d):
            return {k: v for k, v in d.items()
                    if isinstance(v, (int, float, str))
                    and not isinstance(v, bool)}

        host = {"driver_state": js(driver_state),
                "optim_methods": {name: js(m.state)
                                  for name, m in self.optim_methods.items()}}
        sd = getattr(self.dataset, "state_dict", None)
        if sd is not None:
            host["dataset"] = sd()
        return host

    def _sharded_tree(self, model, trees):
        """The step's trees in JAX's nesting, the ZeRO-1 leaves as this
        rank's :class:`ShardedLeaf` rows."""
        from bigdl_tpu_torch.distributed.checkpoint import ShardedLeaf

        params, model_state, opt_states = trees
        if self._param_template is None:
            self._param_template = _nest(model, "params")
        whole = dict(self.model.named_parameters())
        parts = self._zero1_parts()

        def leaf(k, v, zero):
            """``v`` (this rank's part of leaf ``k``) as a chunk with its
            bounds, written by the first rank of those holding it."""
            lay = self._layout(k)
            shape = tuple(whole[k].shape)
            if not isinstance(lay, Sharded) and zero is None:
                return v.detach().clone()
            bounds = lay.region(shape)
            axes = set(lay.axes)
            if zero is not None:
                lo = bounds[0][0]
                rows = zero.rows(bounds[0][1] - lo)
                bounds[0] = [lo + rows[0], lo + rows[1]]
                axes.add(DATA_AXIS)
            write = all(self.mesh.rank(a) == 0 for a in AXES
                        if a not in axes)
            return ShardedLeaf(v.detach().clone(), shape, bounds[0][0],
                               bounds=bounds, write=write)

        params_part = {k: leaf(k, v, None) for k, v in params.items()}
        opt = {}
        for name, st in opt_states.items():
            template = (self._param_template if name == "__all__"
                        else {name: self._param_template[name]})
            opt[name] = {}
            for slot, flat in st.items():
                opt[name][slot] = _fill(template, {
                    k: leaf(k, v, parts.get(k)) for k, v in flat.items()})
        state = export_variables(model, None, model_state)["state"]
        return {"params": _fill(self._param_template, params_part),
                "model_state": state, "opt_states": opt}

    def _prepare_ckpt_dir(self) -> Optional[str]:
        if not self.sharded_checkpoint:
            return super()._prepare_ckpt_dir()
        if not self.checkpoint_path:
            return None
        from bigdl_tpu_torch.distributed.checkpoint import \
            ShardedCheckpointer

        # step directories are per iteration already: no timestamped one
        self._sharded_ckpt = ShardedCheckpointer(
            self.checkpoint_path, process_index=dist_rank(),
            process_count=self.mesh.size)
        return self._sharded_ckpt.root

    def _save_checkpoint(self, ckpt_dir, model, trees, loop_state):
        if self.sharded_checkpoint:
            if self._sharded_ckpt is None:
                return
            self._sharded_ckpt.save(
                self._sharded_tree(model, trees),
                self._host_state(self._driver_state(loop_state)),
                loop_state["neval"])
            return
        params, model_state, opt_states = trees
        if self._sharded_params:
            params = self._whole_params(params)
        whole = (params, model_state, self._whole_opt_states(opt_states))
        if dist_rank() == 0:  # one writer of the blob
            super()._save_checkpoint(ckpt_dir, model, whole, loop_state)

    def _finish_checkpoints(self, raise_errors: bool = True):
        super()._finish_checkpoints(raise_errors=raise_errors)
        ckpt, self._sharded_ckpt = self._sharded_ckpt, None
        if ckpt is not None:
            ckpt.finish(raise_errors=raise_errors)

    def _wait_writer(self):
        super()._wait_writer()
        if self._sharded_ckpt is not None:
            self._sharded_ckpt.wait(raise_errors=False)

    def _restore(self, blob: dict, trees, loop_state):
        """The whole-leaf blob cut to this rank's shards and ZeRO-1 rows,
        then copied into the step's trees."""
        parts = self._zero1_parts()

        def cut(k, v, zero):
            v = self._layout(k).local(np.asarray(v))
            return v if zero is None else v[slice(*zero.rows(v.shape[0]))]

        if parts or self._sharded_params:
            opt = {}
            for name, st in blob["opt_states"].items():
                opt[name] = {slot: {k: cut(k, v, parts.get(k))
                                    for k, v in flatten(tree).items()}
                             for slot, tree in st.items()}
            params = {k: cut(k, v, None)
                      for k, v in flatten(blob["params"]).items()}
            blob = dict(blob, opt_states=opt, params=params)
        super()._restore(blob, trees, loop_state)

    def _restore_sharded(self, path: str, trees, loop_state) -> int:
        """Restore a committed sharded step into the trees and the loop's
        and methods' bookkeeping; returns its iteration."""
        from bigdl_tpu_torch.distributed.checkpoint import restore_checkpoint

        tree, host_state, manifest = restore_checkpoint(path)
        blob = {"params": tree["params"], "model_state": tree["model_state"],
                "opt_states": tree["opt_states"],
                "driver_state": host_state.get("driver_state", {})}
        self._restore(blob, trees, loop_state)
        for name, st in host_state.get("optim_methods", {}).items():
            if name in self.optim_methods:
                self.optim_methods[name].state.update(st)
        for m in self.optim_methods.values():
            m.state["neval"] = loop_state["neval"]
            m.state["epoch"] = loop_state["epoch"]
        return int(manifest["iteration"])

    def _load_latest(self, ckpt_dir, trees, loop_state) -> bool:
        if not self.sharded_checkpoint:
            return super()._load_latest(ckpt_dir, trees, loop_state)
        from bigdl_tpu_torch.distributed.checkpoint import latest_committed

        found = latest_committed(ckpt_dir)
        if found is None:
            return False
        self._restore_sharded(found[1], trees, loop_state)
        return True

    def _load_resume(self, trees, loop_state):
        from bigdl_tpu_torch.distributed.checkpoint import latest_committed

        found = (latest_committed(self._resume_from)
                 if self.sharded_checkpoint else None)
        if found is None:
            return super()._load_resume(trees, loop_state)
        it, path = found
        self._restore_sharded(path, trees, loop_state)
        self._restore_data_cursor(loop_state)
        logger.info("Resumed from sharded commit %s (iteration %d)", path,
                    it)
        # the elastic sequence's marker: a merged cluster trace puts it
        # after the peer_dead/gen_bump instants of a re-formation
        get_tracer().instant("resharding_restore", CAT_TRAIN,
                             args={"iteration": int(it),
                                   "n_devices": self._step_n_devices()})
