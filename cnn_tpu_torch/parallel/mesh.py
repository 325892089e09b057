"""The device mesh over ``torch.distributed`` ranks, counterpart of
``cnn_tpu/parallel/mesh.py``.

``cnn_tpu`` runs one process over many devices and arranges them as a
``('data', 'model'[, 'spatial'][, 'expert'])`` mesh, an axis beyond the
first two present only when its size is above 1, or, for the pipeline,
as a ``('data', 'stage'[, 'model'])`` mesh (``make_pp_mesh``); PyTorch's
idiom is one process per device, so here the ranks of the default process
group are the mesh's devices, in ``cnn_tpu``'s order: rank ``r`` sits at
the row-major coordinates of ``(data, stage, model, spatial, expert)``
(``rank_of``; an axis of size 1 adds nothing, so a mesh without
``'stage'`` orders its ranks as before). The batch shards over
``'data'``, the depth of a pipelined trunk over ``'stage'``
(``parallel/pipeline.py``), wide layers over ``'model'``, the image
rows (each activation's H) over ``'spatial'`` (``Mesh.strip``; the halo
exchange of ``parallel/collectives.py``) and MoE's experts over
``'expert'`` (``parallel/train_step.py``, ``nn/moe.py``). Each axis has
one process subgroup per line of the mesh; a rank's collectives over an
axis run in its own line (``parallel/collectives.py``). With no process
group the mesh has one device and every collective is the identity: the
single-device path.

``init_distributed`` starts the process group, from ``cnn_tpu``'s
``--coordinator`` / ``--num-processes`` / ``--process-id`` or, where one is
not given, torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``). The backend follows from the devices: NCCL
where every rank of the host has a GPU of its own, gloo on the CPU and
where ranks share a GPU.
"""

from __future__ import annotations

import copy
import itertools
import os

import torch
import torch.distributed as dist

from cnn_tpu_torch import default_device
from cnn_tpu_torch.parallel import collectives

AXES = ("data", "stage", "model", "spatial", "expert")


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``, else
    the global rank)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank))


def choose_backend(device, world_size: int) -> str:
    """``'nccl'`` where ``device`` is a GPU and every rank of the host has
    one of its own (``LOCAL_WORLD_SIZE``, else the world, on as many
    devices); ``'gloo'`` otherwise."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def init_distributed(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1, device=None) -> None:
    """Starts the default process group (a no-op where one is running):
    ``coordinator`` ``HOST:PORT`` (``tcp://``; torchrun's ``env://``
    without it), ``num_processes`` (0: ``WORLD_SIZE``), ``process_id``
    (-1: ``RANK``); ``device``: this rank's (default: the GPU), which
    picks the backend (``choose_backend``)."""
    if dist.is_initialized():
        return
    world = num_processes if num_processes > 0 else int(
        os.environ["WORLD_SIZE"])
    rank = process_id if process_id >= 0 else int(os.environ["RANK"])
    dev = default_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, world)
    dist.init_process_group(
        backend, init_method=(f"tcp://{coordinator}" if coordinator
                              else "env://"),
        world_size=world, rank=rank)


def rank_of(sizes: dict, coords: dict) -> int:
    """The rank at ``coords`` of a mesh of ``sizes``, row-major in
    ``AXES`` order (``cnn_tpu``'s device array)."""
    r = 0
    for a in AXES:
        r = r * sizes[a] + coords.get(a, 0)
    return r


def axis_lines(sizes: dict, axis: str) -> list:
    """The lines of ``axis``: for each place of the other axes (row-major),
    the ranks that differ only in ``axis``, in its order."""
    others = [a for a in AXES if a != axis]
    return [[rank_of(sizes, {**dict(zip(others, place)), axis: i})
             for i in range(sizes[axis])]
            for place in itertools.product(*(range(sizes[a])
                                             for a in others))]


class Mesh:
    """One rank's view of a ``('data', 'model'[, 'spatial'][, 'expert'])``
    mesh or of a pipeline's ``('data', 'stage'[, 'model'])`` mesh (one
    whose ``shape`` names ``'stage'``): ``shape`` (axis -> size, as
    ``cnn_tpu`` prints it: ``'spatial'`` and ``'expert'`` only when above
    1, and on a pipeline mesh ``'model'`` too), this rank's ``coords`` on
    every axis (0 on an absent one), its subgroup of each axis
    (``groups``, None without a process group or on an absent axis), its
    ``device`` and the ``backend``."""

    def __init__(self, shape: dict, rank: int = 0, groups=None,
                 device=None, backend: str | None = None):
        sizes = {a: int(shape.get(a, 1)) for a in AXES}
        pipeline = "stage" in shape
        self.shape = {a: n for a, n in sizes.items()
                      if a == "data" or n > 1
                      or (a == "stage" and pipeline)
                      or (a == "model" and not pipeline)}
        self.rank = rank
        self.coords, r = {}, rank
        for a in reversed(AXES):
            self.coords[a], r = r % sizes[a], r // sizes[a]
        self.coords = {a: self.coords[a] for a in AXES}
        self.groups = {a: None for a in AXES}
        self.groups.update(groups or {})
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = backend

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.backend or 'no process group'}, {self.device})")

    def __deepcopy__(self, memo):
        return self     # a handle on the process groups, shared

    def without_data(self) -> "Mesh":
        """This mesh with no collective over ``'data'``: each rank runs
        what it is given as the whole batch."""
        other = copy.copy(self)
        other.groups = {**self.groups, "data": None}
        return other

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def active(self, axis: str) -> bool:
        """Whether a collective over ``axis`` runs (``collectives``)."""
        return self.groups[axis] is not None and (
            self.size(axis) > 1 or self.backend == "nccl")

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` batch rows (images) sharded
        over ``'data'`` (contiguous, as even as they go)."""
        return collectives.even_split(n, self.coords["data"],
                                      self.size("data"))

    def strip(self, n: int, index: int | None = None) -> tuple[int, int]:
        """The ``[lo, hi)`` of ``n`` image rows (an activation's H) that
        ``'spatial'`` rank ``index`` (default: this rank's) holds:
        contiguous, as even as they go, empty where ``n`` is below the
        axis's size."""
        s = self.coords["spatial"] if index is None else index
        return collectives.even_split(n, s, self.size("spatial"))

    # the collectives, so that a layer holding a mesh needs no import
    def all_sum(self, x, axis):
        return collectives.all_sum(x, self, axis)

    def assemble(self, x, axis, total, start, dim=0):
        return collectives.assemble(x, self, axis, total, start, dim)

    def psum(self, x, axis):
        return collectives.psum(x, self, axis)

    def gather(self, x, axis, dim, total=None, start=None):
        return collectives.gather(x, self, axis, dim, total, start)

    def model_input(self, x):
        return collectives.model_input(x, self)

    def halo_plan(self, h, k, stride, padding):
        return collectives.halo_plan(h, k, stride, padding,
                                     self.size("spatial"))

    def halo(self, x, plan):
        return collectives.halo(x, self, plan)

    def hop(self, x, shift):
        return collectives.hop(x, self, shift)


def make_mesh(data_parallel: int = 0, model_parallel: int = 1,
              spatial_parallel: int = 1, expert_parallel: int = 1,
              device=None) -> Mesh:
    """``cnn_tpu``'s ``('data', 'model'[, 'spatial'][, 'expert'])`` mesh of
    the default group's ranks; ``data_parallel=0`` means the rest. Every
    rank calls it (the subgroups are made collectively, in one order).
    ``device``: this rank's (default: GPU ``LOCAL_RANK % device_count``);
    with no process group the mesh has one device, ``device``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    extra = model_parallel * spatial_parallel * expert_parallel
    if data_parallel <= 0:
        assert n % extra == 0, (n, model_parallel, spatial_parallel,
                                expert_parallel)
        data_parallel = n // extra
    need = data_parallel * extra
    assert need <= n, f"need {need} devices, have {n}"
    if need != n:
        raise ValueError(f"the {data_parallel} x {extra} mesh leaves "
                         f"{n - need} of {n} ranks out: each rank is one "
                         "device of the mesh")
    device = _rank_device(device)
    sizes = {"data": data_parallel, "model": model_parallel,
             "spatial": spatial_parallel, "expert": expert_parallel}
    if not dist.is_initialized():
        return Mesh(sizes, 0, None, device)
    return _grouped(sizes, device)


def _grouped(sizes: dict, device) -> Mesh:
    """The mesh of ``sizes`` over the default group's ranks, with a
    subgroup for each line of each axis it has."""
    rank = dist.get_rank()
    n = dist.get_world_size()
    full = {a: sizes.get(a, 1) for a in AXES}
    groups = {}
    for axis in AXES:
        if axis not in sizes or (axis in ("stage", "spatial", "expert")
                                 and sizes[axis] == 1):
            continue            # absent from the mesh: no subgroup
        for ranks in axis_lines(full, axis):
            # every rank makes every subgroup, in the same order
            g = (dist.group.WORLD if len(ranks) == n
                 else dist.new_group(ranks))
            if rank in ranks:
                groups[axis] = g
    return Mesh(sizes, rank, groups, device, dist.get_backend())


def _rank_device(device):
    if device is not None:
        return device
    return (torch.device("cuda", local_rank()
                         % max(1, torch.cuda.device_count()))
            if torch.cuda.is_available() else default_device())


def make_pp_mesh(data_parallel: int, stages: int, model_parallel: int = 1,
                 device=None) -> Mesh:
    """The pipeline's ``('data', 'stage'[, 'model'])`` mesh of the default
    group's ranks (``cnn_tpu``'s ``Mesh(devices.reshape(dp, stages[,
    tp]), ("data", "stage"[, "model"]))``): ``'model'`` only where
    ``model_parallel`` is above 1. Every rank calls it; ``device`` as in
    ``make_mesh``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    need = data_parallel * stages * model_parallel
    assert need <= n, f"need {need} devices, have {n}"
    if need != n:
        raise ValueError(f"the {data_parallel} x {stages} x "
                         f"{model_parallel} pipeline mesh leaves "
                         f"{n - need} of {n} ranks out: each rank is one "
                         "device of the mesh")
    device = _rank_device(device)
    sizes = {"data": data_parallel, "stage": stages}
    if model_parallel > 1:
        sizes["model"] = model_parallel
    if not dist.is_initialized():
        return Mesh(sizes, 0, None, device)
    return _grouped(sizes, device)
