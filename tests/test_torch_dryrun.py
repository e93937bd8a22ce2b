"""The port's dry run (``repro_torch/launch/dryrun.py``) and the meta
route it rests on.

* Every kernel wrapper takes meta tensors to its plain version: no
  launch, no kernel library loads, meta outputs of the right shapes.
* ``run_cell`` on two full-size cells (SmolLM-360M ``prefill_32k`` on
  16 x 16, Jamba-v0.1 ``decode_32k`` on 2 x 16 x 16) allocates
  nothing: every parameter, optimizer and cache leaf lies on the meta
  device but the cache's host counters (``length``, ``pos``: int32, the
  decode step reads them as numbers), and the process's peak resident
  memory grows by less than the f32 tree of either model would take.
* The FLOPs counted at ``reduced()`` equal the analytic forward formula
  (``roofline/analytic.py``) with attention counted whole — the plain
  attention computes every (query, key) score, where the analytic term
  halves causal attention — and the linears counted by their leaves
  (``_linear_params`` counts every parameter but the embedding; the norm
  scales are the difference); a prefill's head runs at the last position
  alone.
* The entry point writes its artifact under ``build/dryrun/`` and never
  creates ``experiments/dryrun/`` (the JAX package's artifacts, which
  ``tests/test_dryrun_artifacts.py`` checks once that folder exists).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import nn
from repro_torch.configs.base import get_config
from repro_torch.kernels import (_cuda, block_sparse, cfmm_matmul,
                                 conv_depthwise, conv_implicit, conv_sparse,
                                 flash_attention, sparse_matvec)
from repro_torch.launch import dryrun
from repro_torch.roofline import analytic

from _torch_dist import ROOT

KERNELS = (conv_implicit.KERNEL, conv_sparse.KERNEL, sparse_matvec.KERNEL,
           conv_depthwise.KERNEL, cfmm_matmul.KERNEL, flash_attention.KERNEL,
           flash_attention.BWD_KERNEL, block_sparse.KERNEL)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def meta(*shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


F32, BF16, U8, I32 = torch.float32, torch.bfloat16, torch.uint8, torch.int32
Q, KV = meta(1, 2, 3, 40, 64, dtype=BF16), meta(1, 2, 40, 64, dtype=BF16)
LSE = meta(1, 2, 3, 40, dtype=F32)
WRAPPERS = {
    "cfmm_matmul": (lambda: cfmm_matmul.cfmm_matmul(
        meta(4, 64), meta(64, 32), meta(32, dtype=F32)), [(4, 32)]),
    "sparse_matvec": (lambda: sparse_matvec.sparse_matvec(
        meta(4, 64), meta(8, 32, dtype=U8), meta(16, 32)), [(4, 32)]),
    "conv_implicit": (lambda: conv_implicit.conv2d_implicit(
        meta(2, 8, 8, 16), meta(144, 32), meta(2, 32, dtype=F32),
        meta(32, dtype=F32), k=3, stride=1), [(2, 8, 8, 32), (2,)]),
    "conv_sparse": (lambda: conv_sparse.conv2d_sparse(
        meta(2, 8, 8, 16), meta(18, 32, dtype=U8), meta(32, 32),
        meta(2, 32, dtype=F32), meta(32, dtype=F32), k=3, stride=1),
        [(2, 8, 8, 32), (2,)]),
    "conv_depthwise": (lambda: conv_depthwise.conv2d_dw(
        meta(2, 8, 8, 16), meta(9, 16), meta(2, 16, dtype=F32),
        meta(16, dtype=F32), k=3, stride=2), [(2, 4, 4, 16), (2,)]),
    "flash_attention": (lambda: flash_attention.flash_attention(
        Q, KV, KV, True, 16), [(1, 2, 3, 40, 64)]),
    "flash_attention_fwd": (lambda: flash_attention.flash_attention_fwd(
        Q, KV, KV), [(1, 2, 3, 40, 64), (1, 2, 3, 40)]),
    "flash_attention_bwd": (lambda: flash_attention.flash_attention_bwd(
        Q, KV, KV, Q, Q, LSE), [(1, 2, 3, 40, 64), (1, 2, 40, 64),
                                (1, 2, 40, 64)]),
    "block_sparse": (lambda: block_sparse.block_sparse_matmul(
        meta(5, 128, dtype=F32), meta(3, 64, 32, dtype=F32),
        meta(4, 3, dtype=I32), meta(4, dtype=I32), (64, 32), 3), [(5, 96)]),
}


@pytest.mark.parametrize("name", WRAPPERS)
def test_meta_tensors_take_the_plain_version(monkeypatch, name):
    def refuse(self, *args):
        raise AssertionError(f"{self.symbol} launched for a meta tensor")

    monkeypatch.setattr(_cuda.CudaKernel, "launch", refuse)
    for k in KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    call, shapes = WRAPPERS[name]
    out = call()
    out = out if isinstance(out, tuple) else (out,)
    assert [tuple(t.shape) for t in out[:len(shapes)]] == shapes
    assert all(t.device.type == "meta" for t in out[:len(shapes)])
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    assert all(k._fn is None for k in KERNELS)


# ---------------------------------------------------------------------------
# Full-size cells allocate nothing
# ---------------------------------------------------------------------------

NO_ALLOC = """
import json, resource, sys
import torch
from repro_torch import nn
from repro_torch.launch import dryrun

trees = []
def keep(fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        trees.append(out)
        return out
    return wrapped
dryrun.lm.init = keep(dryrun.lm.init)
dryrun.lm.cache_init = keep(dryrun.lm.cache_init)
dryrun.compile_params = keep(dryrun.compile_params)
dryrun.optimizer.init = keep(dryrun.optimizer.init)
arch, shape, multi = sys.argv[1], sys.argv[2], sys.argv[3] == "multi"
torch.set_num_threads(1)
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rec = dryrun.run_cell(arch, shape, multi)
grew = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
host, leaves = [], 0
for tree in trees:
    for path, t in nn.tree_flatten_with_path(nn.unbox(tree)):
        if isinstance(t, torch.Tensor):
            leaves += 1
            if t.device.type != "meta":
                host.append(("/".join(map(str, path)), t.numel()))
print(json.dumps({"grew_kib": grew, "leaves": leaves, "host": host,
                  "trees": len(trees), "rec": rec}))
"""

CELLS = {"smollm_360m/prefill_32k/single": 1.45e9,    # f32 tree bytes
         "jamba_v01_52b/decode_32k/multi": 206.3e9}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    script = tmp_path_factory.mktemp("dryrun") / "no_alloc.py"
    script.write_text(NO_ALLOC)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = {c: subprocess.Popen([sys.executable, str(script),
                                  *c.split("/")], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for c in CELLS}
    out = {}
    try:
        for c, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-3000:]
            out[c] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_full_size_cell_allocates_nothing(cells, cell):
    got = cells[cell]
    arch, shape, mesh = cell.split("/")
    rec = got["rec"]
    assert (rec["arch"], rec["shape"], rec["chips"]) == (
        arch, shape, 256 if mesh == "single" else 512)
    assert got["trees"] == (2 if shape.startswith("train") else 3)
    assert got["leaves"] > 20
    # the host counters alone: every layer's int32 length, the (B,) pos
    assert {p.rsplit("/", 1)[-1] for p, _ in got["host"]} <= {"length",
                                                              "pos"}
    assert sum(n for _, n in got["host"]) <= 4096
    # the f32 tree alone would take CELLS[cell] bytes
    assert got["grew_kib"] * 1024 < 0.25 * CELLS[cell]
    n = rec["n_params"]
    assert 4 * n > CELLS[cell] * 0.9
    mem = rec["memory_per_device"]
    assert mem["params_bytes"] > 0 and mem["batch_bytes"] > 0
    assert rec["counted"]["flops_global"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


# ---------------------------------------------------------------------------
# Counted FLOPs against the analytic formula at reduced()
# ---------------------------------------------------------------------------

def _reduced_fields(arch):
    full = get_config(arch)
    red = full.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


@pytest.mark.parametrize("mode", ["dense", "cfmm"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["smollm_360m", "stablelm_3b"])
def test_counted_flops_equal_analytic_formula(arch, shape, mode):
    extra = _reduced_fields(arch)
    cfg = dataclasses.replace(get_config(arch), **extra)
    rec = dryrun.run_cell(arch, shape, False, serve_mode=mode, extra=extra)
    sh = dryrun.SHAPES[shape]
    B, S = sh["batch"], sh["seq"]
    params = dryrun.lm.init(nn.SHAPE_ONLY, cfg)
    n = rec["n_params"]
    leaves = [p for p in nn.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, nn.Param))]
    vectors = sum(p.value.numel() for p in leaves if p.kind != "linear"
                  and p is not params["embed"]["table"])
    head = cfg.d_model * cfg.vocab
    # the linear leaves of the layers: the analytic N less the norm
    # scales, less an untied head
    lin = analytic._linear_params(cfg, n) - vectors \
        - (0 if cfg.tie_embeddings else head)
    if sh["step"] == "prefill":
        want = 2 * B * S * lin + 2 * B * head \
            + 2 * analytic._attn_fwd_flops(cfg, B, S)
    else:
        want = 2 * B * lin + 2 * B * head \
            + analytic._attn_decode_flops(cfg, B, S)
    assert rec["counted"]["flops_global"] == want


def test_entry_point_writes_under_build(capsys):
    experiments = ROOT / "experiments" / "dryrun"
    existed = experiments.exists()
    assert dryrun.main(["--arch", "smollm_360m", "--shape", "decode_32k",
                        "--mesh", "single"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    path = ROOT / "build" / "dryrun" / "single" / \
        "smollm_360m__decode_32k.json"
    assert line["artifact"] == str(path) and path.exists()
    rec = json.loads(path.read_text())
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["roofline"]["flops_per_device"] >= 0
    assert experiments.exists() == existed


def test_inapplicable_cell_is_skipped():
    rec = dryrun.run_cell("smollm_360m", "long_500k", False)
    assert rec["skipped"] and "sub-quadratic" in rec["reason"]
