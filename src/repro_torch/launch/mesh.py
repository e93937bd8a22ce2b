"""Meshes and device placement (ports ``repro/launch/mesh.py``): the
production and debug meshes of the sharded dry run, the devices of the
pipeline serving path and of the replicated front door.

The production mesh's logical shape is JAX's: 16 x 16 ``("data",
"model")``, or 2 x 16 x 16 ``("pod", "data", "model")`` with a leading
pure data-parallel axis.  On H100s that reads as 256 or 512 GPUs, 32 or
64 eight-GPU nodes; the 16-way axes cross nodes.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device("cuda")`` raises when CUDA is absent instead of falling
back.  Nothing here touches device state at import time.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


class ShapeMesh:
    """A mesh of logical shape alone, for the dry run without that many
    processes: ``shape`` is ``{axis: size}`` (JAX's ``Mesh.shape``),
    ``size`` the device count."""

    def __init__(self, shape: tuple, axis_names: tuple):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape, strict=True))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The 16 x 16 (or 2 x 16 x 16) mesh as a ``ShapeMesh``; a caller
    with a live process group of that size builds its ``DeviceMesh``
    with ``make_debug_mesh(shape, axes)``."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def make_debug_mesh(shape=(2, 2), axes=("data", "model")):
    """A ``DeviceMesh`` over the live process group (its world size is
    ``prod(shape)``), on the card under NCCL, else on the CPU."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; raises
    when it names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def local_devices(device="cuda") -> list:
    """The devices a bare ``device`` names: every visible card for
    ``"cuda"``, else just the one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def pipeline_stage_devices(n_stages: int, devices) -> list:
    """One device per pipeline stage, in a 1-D stage chain.  With fewer
    devices than stages, stages wrap round-robin — correctness does not
    depend on placement (only throughput does), so one card or one CPU
    serves any stage count."""
    devices = list(devices)
    return [devices[s % len(devices)] for s in range(n_stages)]


def replica_pipeline_devices(n_replicas: int, n_stages: int,
                             devices) -> list:
    """Disjoint per-replica device groups for the replicated serving
    front door (serving/frontend.py): ``n_replicas`` stage chains of
    ``n_stages`` devices each, carved contiguously from ``devices`` —
    replica ``r`` owns ``[r*n_stages, (r+1)*n_stages)`` where that many
    devices exist.  With fewer devices the groups wrap round-robin, as
    ``pipeline_stage_devices`` does: correctness does not depend on
    placement, so every replica of a fleet may share one card (or the
    CPU)."""
    assert n_replicas >= 1 and n_stages >= 1, (n_replicas, n_stages)
    devices = list(devices)
    return [[devices[(r * n_stages + s) % len(devices)]
             for s in range(n_stages)] for r in range(n_replicas)]
