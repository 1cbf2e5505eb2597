"""The device mesh of the port (counterpart of bigdl_tpu/parallel/mesh.py).

The JAX package builds one ``jax.sharding.Mesh`` over every device, with
the axes ``data``, ``model``, ``seq``, ``expert`` and ``pipe`` (data
outermost), and lets GSPMD place the collectives.  The port runs one
process per device on ``torch.distributed`` and builds the same mesh over
the world's ranks with ``torch.distributed.device_mesh.init_device_mesh``,
ranks laid out as JAX lays out devices (``model`` innermost, then
``expert``, ``seq``, ``pipe``, and ``data`` outermost); the collectives
are explicit calls on each axis's group (``Mesh.group(axis)``,
``parallel/comm.py``).

The process group's backend is a rule on the topology, chosen before any
collective and logged: NCCL when every rank of the host has a card of its
own, gloo on the CPU and wherever ranks share a card (gloo stages CUDA
tensors through host memory, ``parallel/comm.py``).  A world of one
process needs no launcher: :func:`init_process_group` then uses an
in-process store.  Under ``torchrun`` the group is made from its
environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``).

A batch's layout: with :func:`put_batch` each rank takes its rows
``[r * b / n, (r + 1) * b / n)`` of a global batch of ``b`` rows, where
``r`` is its index on the data axis and ``n`` the data degree (JAX's
``P("data")`` sharding); with ``seq_dim`` it also takes its part
``[s * T / m, (s + 1) * T / m)`` of that dim, ``s`` its index on the
``seq`` axis of degree ``m`` (``P("data", ..., "seq")``).
:func:`shard_leading_dim` gives the ZeRO-1 layout of an optimizer state:
a leaf is split on dim 0 over an axis when dim 0 is positive and the
degree divides it, else every rank holds it whole (``Replicated``).

A parameter's layout under tensor, pipeline or expert parallelism is a
:class:`Sharded`: JAX's ``PartitionSpec`` (one axis name or ``None`` per
dim) with this rank's part of each split dim (``parallel/
tensor_parallel.py``).
"""
from __future__ import annotations

import datetime
import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.device import DeviceLike

logger = logging.getLogger("bigdl_tpu_torch.parallel")

__all__ = ["AXES", "DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS",
           "SEQ_AXIS", "Mesh", "MeshConfig", "PlanInfo", "Replicated",
           "RowShard", "Sharded", "batch_sharding", "choose_backend",
           "data_parallel_mesh", "elastic_mesh", "init_process_group",
           "make_mesh", "plan_info", "put_batch", "replicated",
           "shard_leading_dim", "world_size"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
#: the mesh's axes in JAX's order, data outermost
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS, PIPE_AXIS)
#: the ranks' layout, outermost first (JAX's ``reshape(d, p, s, e, m)``:
#: tensor-parallel collectives between neighbouring ranks)
RANK_ORDER = (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, EXPERT_AXIS, MODEL_AXIS)

#: collectives that wait longer than this raise (the process group's
#: timeout unless ``init_process_group`` is given ``timeout_s``)
DEFAULT_TIMEOUT_S = 600.0


@dataclass
class MeshConfig:
    """Logical parallelism degrees; -1 = absorb the remaining devices."""

    data: int = -1
    model: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        d, m, s, e, p = (self.data, self.model, self.seq, self.expert,
                         self.pipe)
        fixed = ((m if m > 0 else 1) * (s if s > 0 else 1)
                 * (e if e > 0 else 1) * (p if p > 0 else 1))
        if d == -1:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"model*seq*expert*pipe={fixed}")
            d = n_devices // fixed
        if d * m * s * e * p != n_devices:
            raise ValueError(f"mesh {d}x{m}x{s}x{e}x{p} != {n_devices} "
                             "devices")
        return d, m, s, e, p


@dataclass(frozen=True)
class PlanInfo:
    """What a mesh declares: ``(axis, degree)`` in mesh order."""

    degrees: Tuple[Tuple[str, int], ...]

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.degrees)

    @property
    def active_axes(self) -> frozenset:
        """Axes with parallelism actually requested (degree > 1)."""
        return frozenset(n for n, d in self.degrees if d > 1)

    def degree(self, axis: str) -> Optional[int]:
        return dict(self.degrees).get(axis)


class Mesh:
    """The (data, model, seq, expert, pipe) mesh of the world's ranks.

    ``shape`` maps each axis to its degree, ``device_mesh`` is the torch
    ``DeviceMesh``, ``device`` this rank's device and ``backend`` the
    process group's.  ``group(axis)`` is the process group of this
    rank's line along ``axis`` (the data axis by default), ``rank(axis)``
    this rank's index on it and ``size`` the ranks in all."""

    def __init__(self, device_mesh, shape: dict, device: torch.device,
                 backend: str):
        self.device_mesh = device_mesh
        self.shape = dict(shape)
        self.axis_names = AXES
        self.device = device
        self.backend = backend

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str = DATA_AXIS):
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str = DATA_AXIS) -> int:
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        dims = ", ".join(f"{a}={self.shape[a]}" for a in AXES)
        return f"Mesh({dims}; {self.backend} on {self.device})"


def plan_info(mesh: Mesh) -> PlanInfo:
    """The :class:`PlanInfo` a mesh declares (axis names + degrees)."""
    return PlanInfo(tuple((n, int(mesh.shape[n])) for n in mesh.axis_names))


def world_size() -> int:
    """Ranks of the initialised process group, else of the launcher's
    environment (``WORLD_SIZE``, set by ``torchrun``), else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def choose_backend(device: torch.device,
                   local_world_size: int) -> str:
    """The backend rule: ``nccl`` when the ranks on this host each have a
    card of their own, ``gloo`` on the CPU and where ranks share one."""
    if device.type != "cuda":
        return "gloo"
    return ("nccl" if local_world_size <= torch.cuda.device_count()
            else "gloo")


def _timeout(timeout_s: Optional[float]) -> datetime.timedelta:
    if timeout_s is None:
        timeout_s = DEFAULT_TIMEOUT_S
    return datetime.timedelta(seconds=timeout_s)


def _rank_device(device: DeviceLike, local_rank: int) -> torch.device:
    """This rank's device: the CPU when asked for, else card
    ``local_rank`` modulo the host's cards (``cuda`` by default)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'"
                           " to run on the CPU explicitly")
    if dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_process_group(device: DeviceLike = None, *,
                       init_method: Optional[str] = None, store=None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       local_world_size: Optional[int] = None,
                       timeout_s: Optional[float] = None
                       ) -> Tuple[str, torch.device]:
    """Initialise the default process group with the backend rule and
    return ``(backend, this rank's device)``.

    Unset arguments come from ``torchrun``'s environment, else describe a
    world of one process on an in-process store.  ``local_world_size``
    (the ranks on this host) decides the backend with
    :func:`choose_backend`; a rank on a card binds it.  When the group
    exists already, its backend is kept and only the device is
    resolved."""
    env = os.environ
    if dist.is_initialized():
        rank = dist.get_rank()
    elif rank is None:
        rank = int(env.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    if dist.is_initialized():
        return dist.get_backend(), dev
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend = choose_backend(dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend, timeout=_timeout(timeout_s))
    if store is None and init_method is None:
        if world_size == 1 and "MASTER_ADDR" not in env:
            store = dist.HashStore()
        else:
            init_method = "env://"
    if store is not None:
        kwargs.update(store=store, rank=rank, world_size=world_size)
    else:
        kwargs.update(init_method=init_method, rank=rank,
                      world_size=world_size)
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(**kwargs)
    logger.info("process group: %s, rank %d of %d on %s (%d ranks on this "
                "host, %d cards)", backend, rank, world_size, dev,
                local_world_size,
                torch.cuda.device_count() if dev.type == "cuda" else 0)
    return backend, dev


def make_mesh(config: Optional[MeshConfig] = None,
              device: DeviceLike = None) -> Mesh:
    """The (data, model, seq, expert, pipe) mesh over every rank of the
    world, the process group made first when there is none; the ranks
    laid out in :data:`RANK_ORDER`."""
    config = config or MeshConfig()
    backend, dev = init_process_group(device)
    shape = dict(zip(AXES, config.resolve(dist.get_world_size())))
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, tuple(shape[a] for a in RANK_ORDER),
                          mesh_dim_names=RANK_ORDER)
    mesh = Mesh(dm, shape, dev, backend)
    logger.info("%r", mesh)
    return mesh


def data_parallel_mesh(n: Optional[int] = None,
                       device: DeviceLike = None) -> Mesh:
    """The data-parallel mesh over the world's ranks; ``n``, when given,
    must be the world size (one process per device)."""
    mesh = make_mesh(MeshConfig(data=-1), device)
    if n is not None and n != mesh.size:
        raise ValueError(f"data_parallel_mesh({n}): the world has "
                         f"{mesh.size} ranks (one process per device)")
    return mesh


def elastic_mesh(config: Optional[MeshConfig] = None,
                 device: DeviceLike = None) -> Mesh:
    """The mesh of this elastic generation: the data axis absorbs every
    rank the generation's process group holds (bigdl_tpu/parallel/
    mesh.py:117-132), so the global batch, and the loss curve, stay
    what they were before a re-formation."""
    return make_mesh(config or MeshConfig(), device)


@dataclass(frozen=True)
class Replicated:
    """Layout of a leaf every rank holds whole (JAX's ``P()``)."""

    spec = ()
    axes = ()

    def region(self, shape) -> list:
        return [[0, n] for n in shape]

    def local(self, whole):
        return whole

    def local_shape(self, shape) -> Tuple[int, ...]:
        return tuple(shape)

    def __str__(self):
        return "P()"


@dataclass(frozen=True)
class RowShard:
    """Layout of a leaf split on dim 0 over ``parts`` ranks; this rank
    holds part ``index`` (JAX's ``P("data")``)."""

    index: int
    parts: int

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` rows."""
        per = n // self.parts
        return self.index * per, (self.index + 1) * per


@dataclass(frozen=True)
class Sharded:
    """Layout of a leaf split over mesh axes (JAX's ``NamedSharding(mesh,
    P(*spec))``): ``spec`` names one axis (or ``None``) per leading dim,
    ``index``/``parts`` are this rank's part and the parts of each of
    those dims (0 and 1 where ``spec`` holds ``None``)."""

    spec: Tuple[Optional[str], ...]
    index: Tuple[int, ...]
    parts: Tuple[int, ...]

    @property
    def axes(self) -> Tuple[str, ...]:
        """The axes the leaf is split over."""
        return tuple(a for a in self.spec if a is not None)

    def region(self, shape) -> list:
        """This rank's ``[lo, hi)`` of every dim of a global ``shape``."""
        out = []
        for d, n in enumerate(shape):
            if d < len(self.spec) and self.spec[d] is not None:
                per = n // self.parts[d]
                out.append([self.index[d] * per,
                            (self.index[d] + 1) * per])
            else:
                out.append([0, n])
        return out

    def local(self, whole):
        """This rank's part of a whole leaf (a view)."""
        return whole[tuple(slice(lo, hi)
                           for lo, hi in self.region(whole.shape))]

    def local_shape(self, shape) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.region(shape))

    def __str__(self):
        return "P(" + ", ".join(repr(a) for a in self.spec) + ")"


def sharded(mesh: Mesh, spec) -> "Sharded | Replicated":
    """The layout of ``P(*spec)`` on this rank; ``Replicated`` when the
    spec splits nothing."""
    spec = tuple(spec)
    if not any(a is not None for a in spec):
        return Replicated()
    return Sharded(spec,
                   tuple(0 if a is None else mesh.rank(a) for a in spec),
                   tuple(1 if a is None else mesh.shape[a] for a in spec))


def replicated(mesh: Mesh) -> Replicated:
    return Replicated()


def batch_sharding(mesh: Mesh, seq_dim: Optional[int] = None
                   ) -> "RowShard | Sharded":
    """The batch's layout: rows over the data axis, and with ``seq_dim``
    that dim over the ``seq`` axis."""
    if seq_dim is None:
        return RowShard(mesh.rank(), mesh.shape[DATA_AXIS])
    spec = [None] * (seq_dim + 1)
    spec[0] = DATA_AXIS
    spec[seq_dim] = SEQ_AXIS
    return sharded(mesh, spec)


def _shardable(shape, n: int) -> bool:
    return len(shape) >= 1 and shape[0] > 0 and shape[0] % n == 0


def shard_leading_dim(mesh: Mesh, tree: Any, axis: str = DATA_AXIS) -> Any:
    """Per-leaf layout: a :class:`RowShard` over ``axis`` where dim 0 is
    positive and divisible by the axis's degree, else
    :class:`Replicated`: the ZeRO-1 layout of an optimizer state."""
    n = mesh.shape[axis]
    part = RowShard(mesh.rank(axis), n)

    def spec(leaf):
        if isinstance(leaf, dict):
            return {k: spec(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(spec(v) for v in leaf)
        shape = tuple(getattr(leaf, "shape", ()))
        return part if _shardable(shape, n) else Replicated()

    return spec(tree)


def seq_part(mesh: Mesh, t, seq_dim: int):
    """This rank's part of ``t``'s dim ``seq_dim`` over the ``seq`` axis
    (the whole tensor at degree 1)."""
    n = mesh.shape[SEQ_AXIS]
    if n == 1:
        return t
    size = t.shape[seq_dim]
    if size % n:
        raise ValueError(f"dim {seq_dim} of {size} does not divide over "
                         f"{n} sequence-parallel ranks")
    per = size // n
    return t.narrow(seq_dim, mesh.rank(SEQ_AXIS) * per, per)


def put_batch(mesh: Mesh, array, seq_dim: Optional[int] = None,
              local: bool = False, accum_steps: int = 1):
    """This rank's rows of a global batch on its device, as a tensor.
    With ``accum_steps = k`` they are this rank's rows of each of the
    k micro-batches in turn (micro-batch i is the global rows ``[i * b /
    k, (i + 1) * b / k)``, split over the ranks as a batch is), so that
    the step's local micro-batch i is the rank's part of the global one.
    With ``local=True`` the array is already this rank's slice (a
    dataset that shards by rank, ``DistributedDataSet``) and only moves
    to the device.  With ``seq_dim`` the rank keeps its part of that dim
    over the ``seq`` axis (:func:`batch_sharding`)."""
    t = array if torch.is_tensor(array) else torch.from_numpy(
        np.ascontiguousarray(array))
    if not local:
        n = mesh.shape[DATA_AXIS]
        b = t.shape[0]
        if b % (n * accum_steps):
            raise ValueError(f"global batch of {b} rows does not divide "
                             f"over {n} data-parallel ranks x "
                             f"{accum_steps} micro-batches")
        part = RowShard(mesh.rank(), n)
        micro = [t[i * b // accum_steps:(i + 1) * b // accum_steps]
                 for i in range(accum_steps)]
        rows = [m[slice(*part.rows(m.shape[0]))] for m in micro]
        t = rows[0] if accum_steps == 1 else torch.cat(rows)
    if seq_dim is not None:
        t = seq_part(mesh, t, seq_dim)
    return t.to(mesh.device, non_blocking=mesh.device.type == "cuda")
