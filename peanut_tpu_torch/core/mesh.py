"""Device mesh, the helpers of its axes and the process group (port of
``peanut_tpu.core.mesh``).

The JAX package names its devices in a ``jax.sharding.Mesh`` and lets XLA
place the shards.  Here a ``Mesh`` is a numpy array of ``torch.device``
with axis names, and code that shards over an axis does it itself:

* the ``data`` axis splits a tensor's leading (batch or episode) axis into
  one chunk a device (``split_rows``), runs each chunk on its device and
  puts the pieces back together (``concat_rows``); ``replicate`` copies a
  module or a tensor once to each distinct device of a mesh;
* the ``spatial`` axis splits a map's height into row blocks
  (``row_ranges``, uneven where the rows do not divide), one a device,
  which ``core.spatial`` holds and exchanges halos between.

``axis_devices`` reads one axis of a mesh at a fixed index of the others
(index 0 by default): the JAX runtime, given a mesh with a second axis,
replicates over it and computes the same result.

Training and evaluation run one process a data index instead, joined in
a ``torch.distributed`` process group (``init_distributed``); ``rank()``
and ``world()`` are the counterparts of ``jax.process_index`` and
``jax.process_count``.  Each such process drives its own spatial shards.
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``"cuda"`` means the current card, as
    ``tensor.device`` reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Devices on named axes, as ``jax.sharding.Mesh``: ``devices`` is a
    numpy array of ``torch.device`` shaped by the axes, ``shape`` the
    sizes by name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(axes: Optional[dict] = None, devices=None) -> Mesh:
    """A named mesh.

    axes: {axis_name: size} in order; -1 for one axis means "the devices
      left".  Default: {'data': number of devices}.
    devices: the devices, in order (default: every visible card; it raises
      without one).  A device may appear more than once: each entry is a
      shard with its own state and programs, so one card (or the CPU)
      holds a mesh of several devices' worth of shards, as the JAX
      package's tests ran its mesh on virtual CPU devices.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. ['cpu'] * 4)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    if axes is None:
        axes = {"data": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh axes {axes} need {total} devices, have {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), names)


def axis_devices(mesh: Mesh, axis: str = "data",
                 at: Optional[Dict[str, int]] = None) -> List[torch.device]:
    """The devices along ``axis``, one a shard, at index ``at[name]`` (0
    unless given) of every other axis: on a {"data": a, "spatial": b}
    mesh, ``axis_devices(mesh, "data")`` is each data index's device at
    spatial index 0, and ``axis_devices(mesh, "spatial", {"data": r})``
    the spatial shards of data index r."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    at = dict(at or {})
    unknown = set(at) - set(mesh.axis_names) - {axis}
    if unknown:
        raise ValueError(f"mesh {mesh.shape} has no axis {sorted(unknown)}")
    index = tuple(slice(None) if name == axis else at.get(name, 0)
                  for name in mesh.axis_names)
    return list(mesh.devices[index])


def row_ranges(h: int, shards: int) -> List[tuple]:
    """[start, end) of each of ``shards`` row blocks of ``h`` rows: as even
    as they come, the first ``h % shards`` one row longer (90 rows over 4
    shards: 23, 23, 22, 22); a block is empty where ``h < shards``."""
    if shards < 1:
        raise ValueError(f"{shards} shards")
    q, r = divmod(h, shards)
    return [(i * q + min(i, r), (i + 1) * q + min(i + 1, r))
            for i in range(shards)]


def shard_slices(n: int, shards: int) -> List[slice]:
    """The rows of each of ``shards`` equal shards of ``n``; ValueError
    unless they divide."""
    if shards < 1 or n % shards:
        raise ValueError(f"{n} rows not divisible into {shards} shards")
    m = n // shards
    return [slice(i * m, (i + 1) * m) for i in range(shards)]


def split_rows(x: torch.Tensor, devices: Sequence[torch.device]
               ) -> List[torch.Tensor]:
    """``x``'s leading axis in ``len(devices)`` equal chunks, chunk i on
    ``devices[i]`` (a view where it is already there)."""
    return [x[s].to(d, non_blocking=True)
            for s, d in zip(shard_slices(x.shape[0], len(devices)), devices)]


def concat_rows(chunks: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The chunks of ``split_rows`` back in one tensor on ``device`` (the
    first chunk's by default)."""
    device = chunks[0].device if device is None else torch.device(device)
    return torch.cat([c.to(device) for c in chunks])


def replicate(obj, devices: Sequence[torch.device]) -> Dict:
    """{device: copy} with one copy of a module or tensor on each distinct
    device; the object itself where it already lies."""
    out = {}
    if isinstance(obj, torch.nn.Module):
        own = next(obj.parameters()).device
    else:
        own = obj.device
    for d in dict.fromkeys(canonical_device(d) for d in devices):
        if d == own:
            out[d] = obj
        elif isinstance(obj, torch.nn.Module):
            out[d] = copy.deepcopy(obj).to(d)
        else:
            out[d] = obj.to(d)
    return out


def on_device(device):
    """A context in which ``device`` is the current card (the kernels
    launch on the current card's stream); nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ----------------------------------------------------------------------
# the process group (training and evaluation: one process a device)
# ----------------------------------------------------------------------

def init_distributed(backend: Optional[str] = None, device=None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    Rank, world size and the rendezvous come from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) unless given; ``init_method`` (``tcp://...``,
    ``file://...``) replaces the environment's address.  ``device``: the
    rank's device, by default ``cuda:{LOCAL_RANK}`` (it raises without a
    card).  ``backend``: ``nccl`` for a card and ``gloo`` for the CPU
    unless named; nothing changes it by itself (NCCL refuses two ranks on
    one card: name ``gloo`` there).  A group joined before is kept as it
    is (its rank, world and backend)."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no card for rank "
                               f"{rank}; pass device='cpu'")
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    device = canonical_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    kw = dict(backend=backend, rank=rank, world_size=world_size)
    if init_method is not None:
        kw["init_method"] = init_method
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return device


def rank() -> int:
    """This process's rank: 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The process group's size: 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1
