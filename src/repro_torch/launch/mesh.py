"""Device placement for the pipeline serving path and the replicated
front door (ports ``pipeline_stage_devices`` and
``replica_pipeline_devices`` of ``repro/launch/mesh.py``).

Entry points run on the card unless the caller asks for the CPU:
``resolve_device("cuda")`` raises when CUDA is absent instead of falling
back.  Nothing here touches device state at import time.
"""
from __future__ import annotations

import torch


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
