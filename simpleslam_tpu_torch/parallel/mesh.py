"""Mesh construction (the counterpart of ``simpleslam_tpu/parallel/mesh.py``).

The throughput design: data parallelism over frame pairs rides the 'dp'
axis; tensor parallelism over the matcher's hidden dimension rides 'tp'.
The mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group, one rank per device: NCCL on GPUs, gloo on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def init_world_one() -> None:
    """A one-rank default process group over an in-memory store (no TCP
    rendezvous): ``nccl`` when CUDA is there, ``gloo`` otherwise. Nothing
    happens when a group exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(n_devices: int = 0, tp: Optional[int] = None,
              axis_names: Tuple[str, str] = ("dp", "tp")) -> DeviceMesh:
    """Build a (dp, tp) mesh over the first ``n_devices`` ranks of the
    default process group (all of them when 0).

    tp defaults to 2 when the count is even and > 1, else 1; callers can
    force tp=1 for pure data parallelism. A caller with no process group
    gets a one-rank group (:func:`init_world_one`). Every rank of the group
    calls this together.
    """
    init_world_one()
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(
            f"make_mesh: asked for {n} devices but the process group has "
            f"{world} ranks. Start one process per device and give "
            f"torch.distributed.init_process_group its world size and "
            f"rank (the gloo backend on the CPU).")
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // tp
    backend = dist.get_backend()
    kind = "cuda" if backend == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 for an axis the mesh
    lacks)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


def dp_slice(mesh: DeviceMesh, B: int) -> slice:
    """This rank's contiguous share of a batch of ``B`` over 'dp'; raises
    when ``B`` does not split evenly, as the reference's sharding does."""
    dp = axis_size(mesh, "dp")
    if B % dp:
        raise ValueError(f"batch of {B} does not split over dp = {dp}")
    n = B // dp
    i = axis_index(mesh, "dp")
    return slice(i * n, (i + 1) * n)
