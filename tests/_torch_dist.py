"""Run a script as the ranks of a CPU ``gloo`` process group, for the
port's distributed tests.

``run_ranks(script, world, tmp_path)`` writes ``script`` to a file and
starts ``world`` processes of it at once, each with its rank, the world
size and a shared directory as arguments; the process group meets at a
``file://`` store in that directory (no network).  The script opens the
group with ``init_group()`` below, which it imports from this module.
Returns each rank's standard output; a rank that fails or outlasts the
timeout fails the test with its output.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def init_group():
    """-> (rank, world, shared directory) of a rank started by
    ``run_ranks``, its gloo process group open, torch on one thread."""
    import torch
    import torch.distributed as dist
    rank, world, shared = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{shared}/store",
                            rank=rank, world_size=world)
    return rank, world, shared


def run_ranks(script: str, world: int, tmp_path: Path,
              timeout: float = 240.0) -> list:
    path = tmp_path / "ranks.py"
    path.write_text(script)
    shared = tmp_path / "shared"
    shared.mkdir()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(world),
                               str(shared)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                pytest.fail(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs
