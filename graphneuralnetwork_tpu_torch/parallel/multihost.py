"""Process-group initialisation and the device mesh.

Port of ``graphneuralnetwork_tpu/parallel/multihost.py`` onto
``torch.distributed``: one process per device, NCCL on CUDA and gloo on
the CPU. Where JAX's mesh is an array of devices, the port's ``Mesh`` is an
array of process ranks (``devices``, in the mesh's shape) with the axis
names, the process group that spans them and the device of this process.
A mesh of more axes also holds, for each axis, the 1-D mesh along it that
holds this process (``Mesh.axis``), each with its own process group.

``initialize_distributed`` is idempotent and, in a single process with no
coordinator variables, a no-op: then ``make_mesh`` gives the one-process
mesh, whose collectives are the identity (``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

#: The rendezvous ``torchrun`` sets, which starts a process group as
#: ``COORDINATOR_ADDRESS`` does. Other cluster variables (a bare
#: ``MASTER_ADDR``, ``TPU_WORKER_HOSTNAMES``) are set on single-process rigs
#: too and start nothing.
TORCHRUN_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
#: How long a collective waits for its peers before it fails.
DEFAULT_TIMEOUT_S = 600.0


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: str | torch.device = "cuda") -> None:
    """Initialise the default process group (idempotent; a no-op in a
    single process without coordinator variables).

    ``coordinator_address`` (``host:port``, or ``COORDINATOR_ADDRESS``)
    with ``num_processes`` and ``process_id`` (or ``WORLD_SIZE`` and
    ``RANK``) starts a TCP rendezvous; without it, the variables
    ``torchrun`` sets start one. The backend is NCCL where ``device`` is
    CUDA (each process takes the card of its local rank) and gloo on the
    CPU.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    torchrun = all(k in os.environ for k in TORCHRUN_VARIABLES)
    if coordinator_address is None and not torchrun:
        return  # single-process run
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed: a coordinator needs the "
                         "process count and this process's id (arguments, "
                         "or WORLD_SIZE and RANK)")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank(process_id))
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend=_backend(device), init_method=init_method,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


def local_device_count() -> int:
    """Processes on this host: ``LOCAL_WORLD_SIZE`` where ``torchrun`` set
    it, else every process (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def _default_device() -> torch.device:
    """This process's device: its card under NCCL, the CPU under gloo, the
    card outside a process group."""
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    if dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_device("cuda")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Process ranks laid out in ``devices.shape`` under ``axis_names``.

    ``group`` is the process group over them (None outside a process
    group, where the mesh holds this one process, and for a one-rank
    mesh), ``device`` this process's device and ``rank`` its position in
    the flattened mesh (both None for a layout built by ``Mesh.layout``,
    which partitions graphs on the host for ranks that are not running).
    ``axes`` holds, for a mesh of more than one axis, the 1-D mesh along
    each axis through this process (``axis``)."""

    devices: np.ndarray
    axis_names: tuple
    group: Optional[dist.ProcessGroup]
    device: Optional[torch.device]
    rank: Optional[int]
    axes: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def live(self) -> bool:
        """This process runs one of the mesh's ranks."""
        return self.rank is not None

    @property
    def coords(self) -> tuple:
        """This process's position along each axis, e.g. ``(d, m)``."""
        return tuple(int(i) for i in np.unravel_index(self.rank,
                                                      self.devices.shape))

    def coord(self, name: str) -> int:
        """This process's position along axis ``name`` (0 along an axis the
        mesh does not have)."""
        if name not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(name)]

    def axis(self, name: str) -> "Mesh":
        """The 1-D mesh along axis ``name`` that holds this process: the
        mesh itself when it is 1-D along ``name``; a one-rank mesh (its
        collectives the identity) along an axis the mesh does not have."""
        if self.axis_names == (name,):
            return self
        if name in self.axes:
            return self.axes[name]
        if name in self.axis_names:
            raise ValueError(f"mesh axis {name!r} of a mesh that runs "
                             "nowhere")
        return Mesh(np.asarray([self.rank]), (name,), None, self.device,
                    None if self.rank is None else 0)

    @classmethod
    def layout(cls, n_devices, axis="data") -> "Mesh":
        """A mesh of ``n_devices`` ranks (an int, 1-D along ``axis``; or a
        shape along the axes ``axis``) that runs nowhere: the host
        partitioners build every shard of it, and a caller views each with
        ``shard(rank, device)``."""
        if isinstance(n_devices, int):
            return cls(np.arange(n_devices), (axis,), None, None, None)
        shape = tuple(int(k) for k in n_devices)
        return cls(np.arange(int(np.prod(shape))).reshape(shape),
                   tuple(axis), None, None, None)


def _group(ranks: Sequence[int]) -> Optional[dist.ProcessGroup]:
    """The process group over ``ranks``: the world's where they are every
    process, None for one rank; else a new group. ``dist.new_group`` is
    collective: every process must call this for every group, in the same
    order, member or not."""
    if len(ranks) == 1:
        return None
    if len(ranks) == process_count():
        return dist.group.WORLD
    return dist.new_group(sorted(int(r) for r in ranks))


def _axis_meshes(arr: np.ndarray, axis_names: tuple, me: int,
                 device: torch.device) -> dict:
    """For each axis of the mesh ``arr``, the 1-D mesh along it through
    process ``me``, creating every line's group on every process."""
    out = {}
    for i, name in enumerate(axis_names):
        lines = np.moveaxis(arr, i, -1).reshape(-1, arr.shape[i])
        for line in lines:
            group = _group(line.tolist()) if dist.is_initialized() else None
            if me in line:
                out[name] = Mesh(line.copy(), (name,), group, device,
                                 int(np.flatnonzero(line == me)[0]))
    return out


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[int]] = None,
              device: Optional[str | torch.device] = None) -> Mesh:
    """The mesh over every process (or the ranks ``devices``).

    1-D by default (pure data or edge parallelism). A mesh of more axes
    needs ``shape``; its ranks are laid out host-major, and its trailing
    axis must stay within one host (``local_device_count`` processes), as
    JAX's keeps to one host's ICI domain; it also builds the 1-D meshes
    along each axis (``Mesh.axis``), creating every one's group on every
    process. ``device`` defaults to this process's (``_default_device``).
    Every process calls this with the same arguments: a group's creation
    is collective."""
    ranks = sorted(devices if devices is not None
                   else range(process_count()))
    if shape is None:
        shape = (len(ranks),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for >1 mesh axis")
    shape = tuple(int(k) for k in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match the axes "
                         f"{tuple(axis_names)}")
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh shape {shape} does not hold the "
                         f"{len(ranks)} processes")
    if len(shape) > 1:
        local = local_device_count()
        if shape[-1] > local:
            raise ValueError(
                f"trailing mesh axis {shape[-1]} exceeds local_device_count "
                f"{local}; it would straddle hosts")
        hosts = (np.asarray(ranks) // local).reshape(shape)
        if not (hosts == hosts[..., :1]).all():
            raise ValueError("mesh trailing axis straddles hosts")
    arr = np.asarray(ranks).reshape(shape)
    me = process_index()
    group = None
    if dist.is_initialized():
        group = (dist.group.WORLD if len(ranks) == process_count()
                 else dist.new_group(sorted(ranks)))
    elif len(ranks) != 1:
        raise ValueError(f"a mesh of {len(ranks)} ranks needs a process "
                         "group (initialize_distributed)")
    rank = (int(np.flatnonzero(arr.ravel() == me)[0])
            if me in ranks else None)
    device = (resolve_device(device) if device is not None
              else _default_device())
    axes = (_axis_meshes(arr, tuple(axis_names), me, device)
            if len(shape) > 1 else {})
    return Mesh(arr, tuple(axis_names), group, device, rank, axes)
