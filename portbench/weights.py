"""The benchmark's seeded inputs common to its architectures: the
generator on the device, and the pool of images a traffic mix draws
from, made in one call.  Each architecture's float weights are made by
its own module (``models/<arch>.py``); the program and the plain
reference get the same tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def image_pool(model: dict, n: int, seed: int, device) -> np.ndarray:
    """``n`` distinct f32 images (n, hw, hw, 3) ~ N(0, 1), made on
    ``device`` from the seed and kept on the host, where the front door
    takes them."""
    g = generator(seed ^ 0x5EED, device)
    hw = model["in_hw"]
    x = torch.randn((n, hw, hw, 3), generator=g, device=device)
    return x.cpu().numpy()
