"""The process group and the device mesh — the port of
``deeplearning_tpu/parallel/mesh.py``.

JAX builds one ``Mesh`` over every device and lets GSPMD insert the
collectives. The port runs one process a card (``torchrun`` launches
them): ``initialize_distributed`` starts the ``torch.distributed`` group
(NCCL on the card, gloo when the caller asks for the CPU), and
``build_mesh`` lays the ranks out on the same five named axes, in the
same order and with the same ``-1`` inference and errors. A rank's
coordinates are ``np.unravel_index(rank, shape)``, as JAX reshapes its
device list, so rank r holds the shard JAX's device r holds.
``Mesh.group(axes)`` is the process group of the ranks that differ only
along ``axes`` (the ``data`` x ``fsdp`` group first): the collectives of
``parallel/collectives.py`` run over it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

__all__ = ["DATA_AXIS", "FSDP_AXIS", "SEQ_AXIS", "MODEL_AXIS",
           "EXPERT_AXIS", "AXES", "MeshConfig", "Mesh",
           "initialize_distributed", "build_mesh", "data_parallel_mesh",
           "mesh_shape_str", "local_device_count",
           "global_batch_from_per_device", "world_size", "rank"]

# Canonical axis names, in mesh order: data outermost, as in JAX
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS, MODEL_AXIS, EXPERT_AXIS)

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """-1 on the data axis means "absorb all remaining ranks"."""
    data: int = -1
    fsdp: int = 1
    seq: int = 1
    model: int = 1
    expert: int = 1


def world_size() -> int:
    """The ``torch.distributed`` world size, or 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank, or 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: Optional[Union[str, torch.device]] = None,
                           local_rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Start the process group (``init_process_group``): NCCL when the
    rank runs on the card (the default), gloo when ``device`` is the CPU
    (or when ``backend="gloo"`` asks for it on the card: gloo moves CUDA
    tensors too, and lets two ranks share one card, which NCCL refuses).
    The rank, world size and card come from the arguments, else from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``); a single process without that
    environment is a world of one. ``coordinator`` is ``host:port`` or an
    ``init_method`` URL (``file://...``). On the card the rank's device
    becomes ``cuda:LOCAL_RANK``. Returns True when this call started the
    group, False when one was already running."""
    if dist.is_initialized():
        return False
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank_ = int(process_id if process_id is not None
                else env.get("RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(local_rank if local_rank is not None
                    else env.get("LOCAL_RANK", rank_))
        torch.cuda.set_device(local)
        backend = backend or "nccl"
    else:
        backend = "gloo"
    kw: Dict = {"backend": backend, "rank": rank_, "world_size": world}
    if coordinator:
        kw["init_method"] = (coordinator if "://" in coordinator
                             else f"tcp://{coordinator}")
    elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        kw["init_method"] = "env://"
    elif world == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError(f"a world of {world} ranks needs a coordinator "
                         f"(host:port) or MASTER_ADDR / MASTER_PORT")
    dist.init_process_group(**kw)
    return True


def _canonical(axes: Axes) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in names:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; axes are {AXES}")
    return tuple(a for a in AXES if a in names)


class Mesh:
    """The ranks on the five named axes. ``shape`` maps each axis to its
    size (JAX's ``mesh.shape``), ``coords`` this rank's position on each;
    ``device`` is the rank's device."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 device: torch.device):
        self.shape = {a: int(shape[a]) for a in AXES}
        self.size = int(np.prod(list(self.shape.values())))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            self.rank, tuple(self.shape.values())))))
        self.device = torch.device(device)
        self._groups: Dict[Tuple[str, ...], object] = {}

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in _canonical(axes)]))

    def axis_index(self, axes: Axes) -> int:
        """This rank's row-major index along ``axes`` (JAX's
        ``lax.axis_index`` of a tuple of axes)."""
        idx = 0
        for a in _canonical(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes``, ordered by their index along ``axes``.
        Every rank must ask for the same axes in the same order (creating
        a group is collective); the world group when no other axis has
        more than one rank."""
        key = _canonical(axes)
        if key in self._groups:
            return self._groups[key]
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "parallel.mesh.initialize_distributed first")
        if dist.get_world_size() != self.size:
            raise ValueError(f"the mesh has {self.size} ranks, the process "
                             f"group {dist.get_world_size()}")
        others = [a for a in AXES if a not in key and self.shape[a] > 1]
        if not others:
            group = dist.group.WORLD
        else:
            shape = tuple(self.shape.values())
            ranks = np.arange(self.size).reshape(shape)
            # move the group's axes last: each row is one group
            order = [AXES.index(a) for a in AXES if a not in key] + \
                [AXES.index(a) for a in key]
            rows = ranks.transpose(order).reshape(-1, self.axis_size(key))
            group = None
            for row in rows:
                g = dist.new_group([int(r) for r in row])
                if self.rank in row:
                    group = g
        self._groups[key] = group
        return group

    def __repr__(self) -> str:
        return f"Mesh({mesh_shape_str(self)}, rank={self.rank})"


def build_mesh(cfg: MeshConfig = MeshConfig(),
               ranks: Optional[int] = None,
               this_rank: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The mesh over the process group's ranks (or ``ranks`` of them,
    this one ``this_rank``), JAX's ``build_mesh`` over ``jax.devices()``.
    ``device`` is the rank's device: by default ``cuda`` (the card
    ``initialize_distributed`` set) under NCCL, the CPU under gloo (name
    it for gloo on the card)."""
    n = world_size() if ranks is None else int(ranks)
    sizes = {DATA_AXIS: cfg.data, FSDP_AXIS: cfg.fsdp, SEQ_AXIS: cfg.seq,
             MODEL_AXIS: cfg.model, EXPERT_AXIS: cfg.expert}
    fixed = int(np.prod([s for s in sizes.values() if s > 0]))
    n_infer = sum(1 for s in sizes.values() if s == -1)
    if n_infer > 1:
        raise ValueError("At most one mesh axis may be -1")
    if n_infer == 1:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes = {k: (n // fixed if s == -1 else s) for k, s in sizes.items()}
    elif fixed != n:
        raise ValueError(f"Mesh {sizes} needs {fixed} devices, have {n}")
    if device is None:
        on_card = (dist.is_initialized()
                   and dist.get_backend() == "nccl")
        device = (torch.device("cuda", torch.cuda.current_device())
                  if on_card else torch.device("cpu"))
    return Mesh(sizes, rank() if this_rank is None else int(this_rank),
                torch.device(device))


def data_parallel_mesh(ranks: Optional[int] = None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Mesh:
    """Every rank a data replica (DDP's layout)."""
    return build_mesh(MeshConfig(), ranks, device=device)


def mesh_shape_str(mesh: Mesh) -> str:
    return "×".join(f"{k}={v}" for k, v in mesh.shape.items() if v > 1) or "1"


def local_device_count() -> int:
    """Cards this host shows (one rank drives one), 1 without a card."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def global_batch_from_per_device(per_device: int,
                                 mesh: Optional[Mesh] = None) -> int:
    """The batch across the data-parallel ranks: ``per_device`` times the
    world size, or times data x fsdp of ``mesh``."""
    if mesh is None:
        return per_device * world_size()
    return per_device * mesh.axis_size((DATA_AXIS, FSDP_AXIS))
