"""Process groups and the 1-D mesh of chips, on ``torch.distributed``.

Counterpart of ``anemoi_tpu/dist/mesh.py``.  One process drives one chip:
NCCL between cards, gloo between CPU processes.  The mesh is a 1-D
``DeviceMesh`` over every rank with the dimension name "chips"; a batch
of limb columns int32 [..., N] is split along its last axis into one
contiguous slice a rank (the JAX package's ``P(None, "chips")``).

Nothing here finds a cluster on its own: ``initialize_distributed`` takes
the store's address (``tcp://host:port`` or ``file://path``), the world
size and the rank, or reads them from the environment a launcher such as
``torchrun`` sets.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Shard

from ..ff import cuda_backend

CHIPS_AXIS = "chips"


def initialize_distributed(
    *, init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
    device=None, timeout: float | None = None,
) -> None:
    """Joins this process to the process group of the run, on ``device``
    (None: the card, with NCCL; "cpu": gloo).

    A no-op in a single process with no arguments, or when the group
    exists.  With ``init_method``, ``world_size`` and ``rank`` it starts
    the group there; without them, from ``WORLD_SIZE`` and the rest of a
    launcher's environment.  On the card, rank r drives card r mod the
    local count.  ``timeout`` (seconds) bounds every collective."""
    if dist.is_initialized():
        return
    if init_method is None and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    device = cuda_backend.resolve_device(device)
    given = {"world_size": world_size, "rank": rank, "timeout": None if timeout is None else timedelta(seconds=timeout)}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init_method or "env://",
                            **{k: v for k, v in given.items() if v is not None})
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def chip_mesh(n_devices: int | None = None, *, device=None) -> DeviceMesh:
    """The 1-D mesh "chips" over the ranks of the process group, on
    ``device``'s type (None: the card).  ``n_devices``, if given, must be
    the world size: every rank of the group takes part."""
    device = cuda_backend.resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} chips needs a process group of {n_devices} ranks, not {world}")
    return init_device_mesh(device.type, (world,), mesh_dim_names=(CHIPS_AXIS,))


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """The placement of int32 [L, N] limb columns: N split over the chips."""
    return (Shard(1),)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in the mesh: its card, or the CPU."""
    return torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")


def shard_batch(arr, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's contiguous slice of the last (batch) axis of an int32
    [..., N] array or tensor, on this rank's device; N must divide evenly."""
    x = torch.as_tensor(arr)
    n, ranks = x.shape[-1], mesh.size()
    if n % ranks:
        raise ValueError(f"a batch of {n} does not split evenly over {ranks} chips")
    part = n // ranks
    rank = mesh.get_local_rank(CHIPS_AXIS)
    return x[..., rank * part : (rank + 1) * part].contiguous().to(mesh_device(mesh))


_DTYPE_NAMES = {torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8", torch.float32: "f32"}


def collective_record(op: str, out: torch.Tensor) -> dict:
    """One collective as ``collective_traffic`` reports it: its kind, its
    output's shape as "s32[20,2]", and the bytes of that output."""
    dims = ",".join(str(d) for d in out.shape)
    return {"op": op, "shape": f"{_DTYPE_NAMES.get(out.dtype, str(out.dtype))}[{dims}]",
            "bytes_per_device": out.numel() * out.element_size()}


def collective_traffic(fn, *args) -> dict:
    """The bytes of every collective one call of a forest function issues.

    Torch has no compiled program to scan, so the functions of
    ``dist/forest.py`` record each collective they issue in
    ``fn.collectives``; this calls ``fn(*args)`` once (a collective call:
    every rank must make it) and sums that record by kind.  Returns
    {"ops": [{op, shape, bytes_per_device}, ...], "total_bytes_per_device":
    N, "counts": {op: n}}, the JAX package's format."""
    fn(*args)
    ops = list(fn.collectives)
    counts: dict = {}
    for o in ops:
        counts[o["op"]] = counts.get(o["op"], 0) + 1
    return {"ops": ops, "total_bytes_per_device": sum(o["bytes_per_device"] for o in ops), "counts": counts}
