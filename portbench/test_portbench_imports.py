"""What the benchmark runs loads neither JAX nor the JAX package, compared
by whole top-level module names (``repro_torch`` begins with ``repro``);
the plain reference loads nothing of the program; and the command exits
without a result where it has no card or no program beside it."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import bench

SRC = bench.ROOT / "src"


def run_python(code: str, cwd=bench.ROOT, env_path=(SRC, bench.ROOT)):
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(str(p) for p in env_path)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    pb = bench.ROOT / "portbench"
    readers = sorted(p.stem for p in (pb / "metrics").glob("*.py"))
    modules = sorted(f"portbench.reference.{p.stem}"
                     for p in (pb / "reference").glob("*.py"))
    archs = sorted(p.stem for p in (pb / "models").glob("*.py")
                   if p.stem != "__init__")
    code = f"""
import importlib, json, sys, time
import portbench.run, portbench.bench as b, portbench.control
import portbench.models, portbench.traffic
for m in {modules!r}:
    importlib.import_module(m)
for a in {archs!r}:
    portbench.models.load(a)
for name in {readers!r}:
    b.reader(name)
spec = b.load_spec()
for cell in spec["workloads"]:
    b.find_cell(spec, cell["name"])
import repro_torch.serving.frontend, repro_torch.obs
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""
    res = run_python(code)
    assert res.returncode == 0, res.stderr
    tops = set(json.loads(res.stdout.splitlines()[-1]))
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & set(bench.FORBIDDEN), tops & set(bench.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    res = run_python("import sys, portbench.reference.resnet50, "
                     "portbench.weights, portbench.work, "
                     "portbench.models.resnet50; "
                     "print(sorted(n for n in sys.modules "
                     "if n.split('.')[0] in ('repro_torch', 'repro')))")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names():
    assert bench.forbidden_modules(["repro_torch.nn", "reprox", "jaxtyping",
                                    "numpy"]) == []
    assert bench.forbidden_modules(["repro.core.cfmm", "jax.numpy",
                                    "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]


def cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "resnet50-sparse80.offline", "--seed", "2147483699", "--seconds",
         "1", "--trace", "0", *args], cwd=cwd, capture_output=True,
        text=True, timeout=240, env={**os.environ, "PYTHONPATH": ""})


def test_no_result_without_the_program_beside_it(tmp_path):
    shutil.copytree(bench.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = cli(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = cli(bench.ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr
