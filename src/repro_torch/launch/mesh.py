"""Device placement for the pipeline serving path (ports
``pipeline_stage_devices`` of ``repro/launch/mesh.py``).

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
