"""The harness finds a configuration, its architecture, a traffic mix, a
cell and a metric by name: new ones added as files (and entries in
``BENCHMARK.json``) are run without editing any file that was there, and
a configuration whose architecture has no module is refused."""
from __future__ import annotations

import hashlib
import json
import time

import pytest

from portbench import bench, models

CELLS = ("resnet50-sparse80.offline", "resnet50-int8.offline")


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_spec_names_files_that_exist():
    spec = bench.load_spec()
    for c in spec["configs"]:
        assert (bench.ROOT / c["file"]).is_file(), c["file"]
    for cell in spec["workloads"]:
        _, config, mix = bench.find_cell(spec, cell["name"])
        assert config["name"] == cell["config"]
        assert mix["loop"] in ("closed", "open")
        models.load(config["model"]["arch"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"])), m["name"]


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_reports_what_the_contract_asks(workload):
    spec = bench.load_spec()
    e2e = {m["name"] for m in bench.cell_metrics(spec, workload, False)}
    layer = bench.cell_metrics(spec, workload, True)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer and all(m["moves"] in e2e for m in layer)


def test_new_cell_mix_config_and_metric_are_found(tiny_root):
    before = digests(tiny_root)
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs" / "resnet50-int8.json").read_text())
    cfg["name"] = "resnet50-int8-mb4"
    cfg["serve"]["microbatch"] = 4
    (pb / "configs" / "resnet50-int8-mb4.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "pairs.json").write_text(json.dumps(
        {"loop": "open", "arrivals": "poisson", "rate_rps": 60.0,
         "size_mix": [[1, 1.0], [2, 1.0]], "pool_images": 32}))
    (pb / "metrics" / "answered_share.py").write_text(
        "def read(rec):\n"
        "    return len(rec['window'].done) / max(1, rec['requests'])\n")
    (pb / "metrics" / "latency_p95_ms.py").write_text(
        "import numpy as np\n"
        "def read(rec):\n"
        "    return 1e3 * float(np.percentile(rec['latency_s'], 95))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(
        {**spec["configs"][1], "name": cfg["name"],
         "file": "portbench/configs/resnet50-int8-mb4.json"})
    spec["workloads"].append({"name": "resnet50-int8-mb4.pairs",
                              "config": cfg["name"], "traffic": "pairs",
                              "chips": 1, "why": "a test cell"})
    spec["end_to_end"].append({"name": "latency_p95_ms", "unit": "ms",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["resnet50-int8-mb4.pairs"]})
    spec["per_layer"].append({"name": "answered_share", "unit": "share",
                              "better": "higher", "source": "host_clock",
                              "layer": "front door",
                              "moves": "latency_p95_ms",
                              "workloads": ["resnet50-int8-mb4.pairs"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())   # nothing edited

    out, rec = bench.run_cell("resnet50-int8-mb4.pairs", 12345, 0.5, True,
                              t_process=time.perf_counter(), root=tiny_root,
                              device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["answered_share"]["value"] == 1.0
    assert rec["config"]["serve"]["microbatch"] == 4
    assert {r for _, _, r, _ in rec["window"].sent} == {1, 2}
    out, _ = bench.run_cell("resnet50-int8-mb4.pairs", 12345, 0.5, False,
                            t_process=time.perf_counter(), root=tiny_root,
                            device="cpu")
    assert set(out["metrics"]) == {"latency_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct_and_reports_its_metrics(tiny_root, workload,
                                                     trace):
    spec = bench.load_spec(tiny_root)
    out, _ = bench.run_cell(workload, 2 ** 31 + 77, 0.6, trace,
                            t_process=time.perf_counter(), root=tiny_root,
                            device="cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in bench.cell_metrics(spec, workload, trace)}
    if trace:        # the device's metrics need the card's trace
        want = {n for n in want if "roofline" not in n
                and not n.startswith(("device_idle", "launches"))}
    assert set(out["metrics"]) == want
    for v in out["metrics"].values():
        assert v["value"] == v["value"] and v["value"] >= 0


PROBE = """
from portbench.models import resnet50 as base

CALLS = []


def _call(name):
    def f(*a, **kw):
        CALLS.append(name)
        return getattr(base, name)(*a, **kw)
    return f


for _n in ("float_weights", "input_pool", "front_door", "request",
           "reference_logits", "ops_per_row", "kernel_launches"):
    globals()[_n] = _call(_n)
"""


def test_new_architecture_is_found_as_a_file(tiny_root):
    """A configuration naming a new architecture runs through that
    architecture's module, added as a file beside the others."""
    before = digests(tiny_root)
    pb = tiny_root / "portbench"
    (pb / "models" / "probe.py").write_text(PROBE)
    cfg = json.loads((pb / "configs" / "resnet50-sparse80.json").read_text())
    cfg["name"] = "probe-sparse80"
    cfg["model"]["arch"] = "probe"
    (pb / "configs" / "probe-sparse80.json").write_text(json.dumps(cfg))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][0], "name": cfg["name"],
                            "file": "portbench/configs/probe-sparse80.json"})
    spec["workloads"].append({"name": "probe-sparse80.offline",
                              "config": cfg["name"], "traffic": "offline",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("probe-sparse80.offline")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())   # nothing edited

    out, rec = bench.run_cell("probe-sparse80.offline", 2 ** 31 + 41, 0.5,
                              True, t_process=time.perf_counter(),
                              root=tiny_root, device="cpu")
    assert out["correct"], out["checks"]
    assert rec["arch"].__file__ == str(pb / "models" / "probe.py")
    assert {"float_weights", "input_pool", "front_door", "request",
            "reference_logits", "ops_per_row"} <= set(rec["arch"].CALLS)
    assert "mfu" in out["metrics"]


def test_architecture_without_a_module_is_refused(tiny_root):
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs" / "resnet50-int8.json").read_text())
    cfg["model"]["arch"] = "mobilenet_v2"
    (pb / "configs" / "resnet50-int8.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="mobilenet_v2"):
        bench.run_cell("resnet50-int8.offline", 3, 0.5, False,
                       t_process=time.perf_counter(), root=tiny_root,
                       device="cpu")


@pytest.mark.parametrize("arch", ["../configs/x", "", None])
def test_architecture_names_are_plain(arch):
    with pytest.raises(ValueError):
        models.load(arch)


def test_architecture_module_lacking_a_function_is_refused(tiny_root):
    pb = tiny_root / "portbench" / "models"
    (pb / "half_done.py").write_text("def float_weights(*a):\n    pass\n")
    with pytest.raises(ValueError, match="reference_logits"):
        models.load("half_done", tiny_root)
