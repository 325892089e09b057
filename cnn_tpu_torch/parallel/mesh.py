"""The device mesh over ``torch.distributed`` ranks, counterpart of
``cnn_tpu/parallel/mesh.py``.

``cnn_tpu`` runs one process over many devices and arranges them as a
``('data', 'model')`` mesh; PyTorch's idiom is one process per device, so
here the ranks of the default process group are the mesh's devices, in
``cnn_tpu``'s order: rank ``r`` sits at ``('data', 'model') = (r // M, r %
M)``. The batch shards over ``'data'`` and wide layers over ``'model'``
(``parallel/train_step.py``). Each axis has one process subgroup per line
of the mesh; a rank's collectives over an axis run in its own line
(``parallel/collectives.py``). With no process group the mesh is 1 x 1 and
every collective is the identity: the single-device path.

``init_distributed`` starts the process group, from ``cnn_tpu``'s
``--coordinator`` / ``--num-processes`` / ``--process-id`` or, where one is
not given, torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``). The backend follows from the devices: NCCL
where every rank of the host has a GPU of its own, gloo on the CPU and
where ranks share a GPU.

The ``'spatial'`` and ``'expert'`` axes are not ported
(``NotImplementedError``, naming ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import copy
import os

import torch
import torch.distributed as dist

from cnn_tpu_torch import default_device
from cnn_tpu_torch.parallel import collectives

AXES = ("data", "model")


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


class Mesh:
    """One rank's view of a ``('data', 'model')`` mesh: ``shape`` (axis ->
    size), this rank's ``coords``, its subgroup of each axis (``groups``,
    None without a process group), its ``device`` and the ``backend``."""
    axis_names = AXES

    def __init__(self, shape: dict, rank: int = 0, groups=None,
                 device=None, backend: str | None = None):
        self.shape = {a: int(shape[a]) for a in AXES}
        m = self.shape["model"]
        self.rank = rank
        self.coords = {"data": rank // m, "model": rank % m}
        self.groups = groups or {a: None for a in AXES}
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = backend

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
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def active(self, axis: str) -> bool:
        """Whether a collective over ``axis`` runs (``collectives``)."""
        return self.groups[axis] is not None and (
            self.shape[axis] > 1 or self.backend == "nccl")

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` rows sharded over ``'data'``
        (contiguous, as even as they go)."""
        d, size = self.coords["data"], self.shape["data"]
        return d * n // size, (d + 1) * n // size

    # the collectives, so that a layer holding a mesh needs no import
    def all_sum(self, x, axis):
        return collectives.all_sum(x, self, axis)

    def assemble(self, x, axis, total, start, dim=0):
        return collectives.assemble(x, self, axis, total, start, dim)

    def psum(self, x, axis):
        return collectives.psum(x, self, axis)

    def gather(self, x, axis, dim):
        return collectives.gather(x, self, axis, dim)

    def model_input(self, x):
        return collectives.model_input(x, self)


def make_mesh(data_parallel: int = 0, model_parallel: int = 1,
              spatial_parallel: int = 1, expert_parallel: int = 1,
              device=None) -> Mesh:
    """The ``('data', 'model')`` mesh of the default group's ranks;
    ``data_parallel=0`` means the rest. Every rank calls it (the subgroups
    are made collectively). ``device``: this rank's (default: GPU
    ``LOCAL_RANK % device_count``); with no process group the mesh is
    1 x 1 on ``device``."""
    for flag, n in (("--spatial-parallel", spatial_parallel),
                    ("--expert-parallel", expert_parallel)):
        if n > 1:
            raise NotImplementedError(
                f"{flag} {n}: the 'spatial' and 'expert' axes are not ported "
                "yet (ROADMAP.md Queue 1 item 10b)")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data_parallel <= 0:
        assert n % model_parallel == 0, (n, model_parallel)
        data_parallel = n // model_parallel
    need = data_parallel * model_parallel
    assert need <= n, f"need {need} devices, have {n}"
    if need != n:
        raise ValueError(f"the {data_parallel} x {model_parallel} mesh leaves "
                         f"{n - need} of {n} ranks out: each rank is one "
                         "device of the mesh")
    if device is None:
        device = torch.device("cuda", local_rank()
                              % max(1, torch.cuda.device_count())) \
            if torch.cuda.is_available() else default_device()
    shape = {"data": data_parallel, "model": model_parallel}
    if not dist.is_initialized():
        return Mesh(shape, 0, None, device)
    rank = dist.get_rank()
    d_own, m_own = rank // model_parallel, rank % model_parallel
    lines = {"data": [[d * model_parallel + m for d in range(data_parallel)]
                      for m in range(model_parallel)],
             "model": [[d * model_parallel + m for m in range(model_parallel)]
                       for d in range(data_parallel)]}
    groups = {}
    for axis, own in (("data", m_own), ("model", d_own)):
        for i, ranks in enumerate(lines[axis]):
            # every rank makes every subgroup, in the same order
            g = (dist.group.WORLD if len(ranks) == n
                 else dist.new_group(ranks))
            if i == own:
                groups[axis] = g
    return Mesh(shape, rank, groups, device, dist.get_backend())
