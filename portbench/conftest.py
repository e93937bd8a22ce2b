"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with its configurations and mixes cut to a size the CPU runs in a second
or two (width 0.125, 32 x 32 images, 10 classes, microbatch 8)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TINY_MODEL = {"width_mult": 0.125, "in_hw": 32, "num_classes": 10}
TINY_MIX = {"offline": {"clients": 4, "request_images": 4,
                        "pool_images": 64}}


def make_tiny_root(dst: Path) -> Path:
    """A checkout-like directory: ``BENCHMARK.json`` and ``portbench/``
    copied, the configurations and mixes cut to the tiny size."""
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for f in (dst / "portbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["model"].update(TINY_MODEL)
        c["serve"]["microbatch"] = 8
        f.write_text(json.dumps(c))
    for name, upd in TINY_MIX.items():
        f = dst / "portbench" / "traffic" / f"{name}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **upd}))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "checkout")


@pytest.fixture(autouse=True)
def _few_threads():
    """The tests run beside others (pytest-xdist): two torch threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
