"""A 1-D mesh of devices over one or several processes.

Counterpart of ``waldboost_tpu/parallel/mesh.py``.  Detection is
independent per image, so the mesh is one data axis: a batch's leading
dimension is split into equal shards, one per mesh device.  Training
shards the sample pools the same way at rest and gathers them for each
stage (:mod:`.train_step`).

A :class:`Mesh` is an ordered tuple of devices, one per shard.  When a
``torch.distributed`` process group is initialized, the mesh spans every
rank of the default group: each rank owns a contiguous block of shards,
in rank order, on its own devices.  Every process then runs the same
program on the same host values (JAX's multi-controller contract) and
keeps its own shards.  A sharded value is the list of this process's
shards in mesh order; :func:`gather` concatenates every shard, across
ranks too.  The backend is the caller's: gloo on the CPU, NCCL on cards.

A device may appear more than once (``["cpu"] * 8``, ``["cuda:0"] * 4``):
the shards are then separate tensors on one device, the stand-in for
JAX's virtual CPU devices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "shard_array", "gather", "is_multiprocess",
           "as_shards", "DATA_AXIS"]

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: every shard's device in mesh order (all ranks');
    this process is ``rank`` of ``world`` and owns the contiguous block
    :attr:`local_devices`."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    #: the name of the one data axis (JAX's mesh axis name)
    axis_name: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_local(self) -> int:
        return self.size // self.world

    @property
    def local_start(self) -> int:
        """The mesh index of this process's first shard."""
        return self.rank * self.n_local

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        return self.devices[self.local_start:self.local_start + self.n_local]


def is_multiprocess(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` spans more than one process."""
    return mesh is not None and mesh.world > 1


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """A mesh over this process's ``devices`` (the first ``n_devices`` of
    them), by default the visible CUDA devices, or the current one when a
    process group is initialized (one card per rank).  With a process
    group, every rank must call this with as many devices, and the mesh
    spans all ranks in rank order.  ``axis_name`` names its one axis, as
    in JAX (:func:`shard_array` checks it)."""
    if not isinstance(axis_name, str):
        raise TypeError(f"axis_name must be a str, got {axis_name!r}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass the mesh's devices, "
                               "e.g. devices=['cpu'] * 8")
        if dist.is_initialized():
            devices = [torch.cuda.current_device()]
        else:
            devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"Requested {n_devices} devices but only "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if not dist.is_initialized():
        return Mesh(tuple(devices), axis_name=axis_name)
    world, rank = dist.get_world_size(), dist.get_rank()
    every = [None] * world
    dist.all_gather_object(every, [str(d) for d in devices])
    if any(len(ds) != len(devices) for ds in every):
        raise ValueError(f"every rank needs as many mesh devices; got "
                         f"{[len(ds) for ds in every]}")
    return Mesh(tuple(torch.device(d) for ds in every for d in ds), rank,
                world, axis_name)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def shard_array(x, mesh: Mesh, axis_name: str = DATA_AXIS
                ) -> List[torch.Tensor]:
    """This process's shards of the full value ``x`` (numpy or a tensor):
    the leading dimension split into ``mesh.size`` equal blocks, each
    copied to its device (a shard never shares memory with ``x``).  Every
    process passes the same ``x``.  ``axis_name`` must name the mesh's
    axis (JAX rejects a name its mesh does not have)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh has no axis {axis_name!r} (its axis is "
                         f"{mesh.axis_name!r})")
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if x.dim() == 0 or x.shape[0] % mesh.size:
        raise ValueError(f"the mesh size {mesh.size} must divide the "
                         f"leading dimension of {tuple(x.shape)}")
    per = x.shape[0] // mesh.size
    return [x[(mesh.local_start + i) * per:
              (mesh.local_start + i + 1) * per].to(d, copy=True)
            for i, d in enumerate(mesh.local_devices)]


def as_shards(x, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` if it is already a list of this process's shards, else
    :func:`shard_array` of the full value."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.n_local:
            raise ValueError(f"expected {mesh.n_local} shards, got {len(x)}")
        for s, d in zip(x, mesh.local_devices):
            if s.device != d:
                raise ValueError(f"a shard on {s.device}, its mesh device "
                                 f"is {d}")
        return list(x)
    return shard_array(x, mesh, mesh.axis_name)


def gather(shards: Sequence[torch.Tensor], mesh: Mesh,
           device=None) -> torch.Tensor:
    """Every shard of a sharded value concatenated in mesh order on
    ``device`` (this process's first mesh device when None): the
    counterpart of JAX's ``process_allgather`` and of a replicated
    sharding constraint.  Across ranks it is one
    ``all_gather_into_tensor`` over the default group, on ``device``'s
    tensors (bool travels as uint8); every rank must call it.  Gloo takes
    CUDA tensors for this collective as NCCL does (tried with torch
    2.11), so no backend stages through the host."""
    device = mesh.local_devices[0] if device is None else _device(device)
    local = torch.cat([s.to(device) for s in shards])
    if mesh.world == 1:
        return local
    wire = local.view(torch.uint8) if local.dtype == torch.bool else local
    out = torch.empty((mesh.world * wire.shape[0],) + tuple(wire.shape[1:]),
                      dtype=wire.dtype, device=device)
    _all_gather(out, wire.contiguous())
    return out.view(torch.bool) if local.dtype == torch.bool else out


def _all_gather(out: torch.Tensor, inp: torch.Tensor) -> None:
    """``all_gather_single`` where torch has it (it replaced
    ``all_gather_into_tensor``), else ``all_gather_into_tensor``."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp)
