"""Mesh construction.

``make_production_mesh`` describes the reference's production meshes,
(data=16, model=16) = 256 chips or (pod=2, data=16, model=16) = 512, as
an abstract :class:`MeshSpec`: axis names and sizes, no devices. The
sharding rules of :mod:`repro_torch.dist.sharding` read it as they read a
real mesh, so the production layout can be reasoned about on one host.

``make_local_mesh`` is the mesh the port runs on: a ``DeviceMesh`` of
shape (world, 1) over the default process group, axes ("data", "model").
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, Tuple

__all__ = ["MeshSpec", "make_production_mesh", "make_local_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """An abstract mesh: ``axis_names`` and ``shape`` {name: size}."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """Single-pod (data=16, model=16) = 256 chips; multi-pod adds pod=2."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"),
                        {"pod": 2, "data": 16, "model": 16})
    return MeshSpec(("data", "model"), {"data": 16, "model": 16})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_local_mesh(device: str = "cuda"):
    """A (world, 1) ``DeviceMesh`` with axes ("data", "model") over the
    default process group. Without a group, starts a one-rank one first:
    ``nccl`` on ``"cuda"``, ``gloo`` when the caller asks for ``"cpu"``.
    It never falls back from the card to the CPU: ``"cuda"`` without CUDA
    raises."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_local_mesh(device='cuda') needs CUDA; pass "
                           "device='cpu' for a gloo mesh on the CPU")
    if not dist.is_initialized():
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    world = dist.get_world_size()
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    return init_device_mesh(device, (world, 1),
                            mesh_dim_names=("data", "model"))
