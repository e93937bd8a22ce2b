"""Invariants of the ``repro_torch`` package itself (no JAX involved).

* No module of the port, no example port (``examples/torch_*.py``), and
  not ``chip_smoke.py``, imports ``jax`` or ``repro`` (an AST scan).
* Entry points run on the card unless the caller asks for the CPU: the
  engine and the serving driver raise without CUDA.
* Dispatch goes by the tensor's device alone: a CPU tensor never reaches
  a kernel, so every launch counter stays 0 and no kernel library loads.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.compiled_linear import ensure_compiled
from repro_torch.configs import smollm_360m
from repro_torch.kernels import (_cuda, block_sparse, cfmm_matmul,
                                 conv_depthwise, conv_implicit, conv_sparse,
                                 flash_attention, ops, sparse_matvec)
from repro_torch.launch import mesh, serve, serve_pipeline
from repro_torch.models import lm, mobilenet_v2, repvgg, resnet
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.pipeline import (PipelineEngine, PipelineRequest,
                                          reference_logits)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
KERNELS = (conv_implicit.KERNEL, conv_sparse.KERNEL, sparse_matvec.KERNEL,
           conv_depthwise.KERNEL, cfmm_matmul.KERNEL, flash_attention.KERNEL,
           flash_attention.BWD_KERNEL, block_sparse.KERNEL)
CFG = resnet.ResNetConfig(width_mult=0.125, num_classes=10, in_hw=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These ops are tiny: torch's thread pool only oversubscribes the
    cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + sorted((ROOT / "examples").glob("torch_*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the entry points do not raise")


@pytest.fixture(scope="module")
def params():
    return resnet.init(torch.Generator().manual_seed(0), CFG)


def test_engine_raises_without_cuda(no_cuda, params):
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineEngine(CFG, params, mode="int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.local_devices("cuda")


def test_driver_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_pipeline.main(["--width", "0.125", "--hw", "16",
                             "--images", "2"])


def test_driver_runs_on_cpu_when_asked(capsys):
    eng = serve_pipeline.main(["--width", "0.125", "--hw", "16",
                               "--images", "4", "--stages", "2",
                               "--mode", "sparse_cfmm", "--device", "cpu"])
    st = eng.stats()
    assert st["n_stages"] == 2 and st["stage_devices"] == ["cpu", "cpu"]
    assert "im/s" in capsys.readouterr().out


def _serve_on_cpu_without_kernels(monkeypatch, cfg, params, mode):
    def refuse(self, *args):
        raise AssertionError(f"{self.symbol} launched for a CPU tensor")

    monkeypatch.setattr(_cuda.CudaKernel, "launch", refuse)
    for k in KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    eng = PipelineEngine(cfg, params, mode=mode, n_stages=2, microbatch=2,
                         device="cpu")
    x = np.random.RandomState(0).randn(3, 16, 16, 3).astype(np.float32)
    out = eng.run_batch(x)
    assert np.isfinite(out).all() and out.shape == (3, cfg.num_classes)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    assert all(k._fn is None for k in KERNELS)


@pytest.mark.parametrize("mode", ["int8", "cfmm", "sparse_cfmm",
                                  "bitserial"])
def test_cpu_tensors_never_reach_a_kernel(monkeypatch, params, mode):
    _serve_on_cpu_without_kernels(monkeypatch, CFG, params, mode)


@pytest.mark.parametrize("model", ["mobilenet_v2", "repvgg_a0"])
def test_cpu_zoo_never_reaches_a_kernel(monkeypatch, model):
    """The depthwise path too: MobileNetV2 in sparse_cfmm, RepVGG (fused)
    in cfmm."""
    gen = torch.Generator().manual_seed(1)
    if model == "mobilenet_v2":
        cfg = mobilenet_v2.MobileNetV2Config(0.25, 10, 16)
        params, mode = cfg.init(gen), "sparse_cfmm"
    else:
        cfg = repvgg.RepVGGConfig(0.125, 10, 16)
        params, mode = cfg.fuse(cfg.init(gen)), "cfmm"
    _serve_on_cpu_without_kernels(monkeypatch, cfg, params, mode)


def test_lm_engine_and_driver_raise_without_cuda(no_cuda):
    cfg = serve.build_cfg("smollm_360m", "tiny")
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, mode="int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1", "--prompt-len", "4"])


@pytest.mark.parametrize("mode", ["int8", "cfmm", "sparse_cfmm"])
def test_lm_driver_serves_on_cpu_without_kernels(monkeypatch, capsys, mode):
    """``launch/serve.py --device cpu`` serves the tiny preset through the
    plain versions: no kernel launches, no kernel library loads."""
    def refuse(self, *args):
        raise AssertionError(f"{self.symbol} launched for a CPU tensor")

    monkeypatch.setattr(_cuda.CudaKernel, "launch", refuse)
    for k in KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    reqs = serve.main(["--mode", mode, "--requests", "3", "--prompt-len",
                       "11", "--max-new", "3", "--slots", "2",
                       "--device", "cpu"])
    assert [len(r.tokens_out) for r in reqs] == [3, 3, 3]
    assert all(0 <= t < 512 for r in reqs for t in r.tokens_out)
    assert "tok/s" in capsys.readouterr().out
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    assert all(k._fn is None for k in KERNELS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_block_sparse_matmul_never_reaches_a_kernel(monkeypatch, dtype):
    """``ops.block_sparse_matmul`` on CPU tensors takes the plain version:
    no launch, no kernel library loads."""
    def refuse(self, *args):
        raise AssertionError(f"{self.symbol} launched for a CPU tensor")

    monkeypatch.setattr(_cuda.CudaKernel, "launch", refuse)
    monkeypatch.setattr(block_sparse.KERNEL, "launches", 0)
    rng = np.random.RandomState(3)
    w = rng.randn(128, 96).astype(np.float32)
    w[:64, 32:64] = 0.0
    x = torch.from_numpy(rng.randn(37, 128).astype(np.float32)).to(dtype)
    y = ops.block_sparse_matmul(x, torch.from_numpy(w), (64, 32))
    assert y.dtype == dtype and y.shape == (37, 96)
    assert block_sparse.KERNEL.launches == 0
    assert block_sparse.KERNEL._fn is None


def test_lm_config_and_unported_parts_raise():
    """SmolLM-360M's published shape; parts of the LM stack the port does
    not have yet raise and name the queue that holds them."""
    cfg = smollm_360m.CONFIG
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (32, 960, 15, 5, 64,
                                                   2560, 49152)
    assert cfg.tie_embeddings and cfg.reduced().n_kv_heads == 1
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        serve.build_cfg("qwen2_vl_7b", "tiny")
    # forward_train(qat=True) runs since the training slice (checked in
    # tests/test_torch_lm_dense.py); the encoder-decoder still raises
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        lm.forward_train({}, {}, dataclasses.replace(
            cfg, encoder_decoder=True), qat=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        lm.cache_init(serve.build_cfg("smollm_360m", "tiny"), 1, 8,
                      kv_dtype=torch.int8)


def test_stage_devices_wrap_round_robin():
    devs = [torch.device("cpu")]
    assert mesh.pipeline_stage_devices(3, devs) == devs * 3
    assert mesh.local_devices("cpu") == devs


def test_reference_logits_stage_and_microbatch_invariant(params):
    """Per-row domains: the microbatch split changes no bit."""
    compiled = ensure_compiled(params, "sparse_cfmm", 0.8)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        4, 16, 16, 3).astype(np.float32))
    a = reference_logits(compiled, CFG, x, 1)
    b = reference_logits(compiled, CFG, x, 4)
    assert torch.equal(a, b)
    eng = PipelineEngine(CFG, compiled, mode="sparse_cfmm", n_stages=4,
                         microbatch=3, device="cpu")
    reqs = [PipelineRequest(rid=0, images=x[:1].numpy()),
            PipelineRequest(rid=1, images=x[1:].numpy())]
    eng.run(reqs)
    np.testing.assert_array_equal(
        np.concatenate([r.logits for r in reqs]), a.numpy())


def test_kernel_library_name_tracks_its_sources():
    """The build is keyed by a hash of the sources, so an edited kernel
    never loads a stale library; every kernel builds from csrc/."""
    names = {k.lib_path.name for k in KERNELS}
    assert len(names) == len(KERNELS) == 8
    for k in KERNELS:
        assert (_cuda.CSRC / f"{k.source}.cu").exists()
        assert k.lib_path.parent == _cuda.BUILD_DIR


def test_explicit_stage_map_and_cancel_in_flight(params):
    """An explicit stage map serves the same bits; cancelling a pipe with
    microbatches in flight returns their tags and leaves it idle."""
    compiled = ensure_compiled(params, "int8", 0.8)
    n_blocks = len(CFG.graph().blocks())
    eng = PipelineEngine(CFG, compiled, mode="int8", microbatch=2,
                         stage_blocks=((0, 1), tuple(range(2, n_blocks))),
                         device="cpu")
    assert eng.stats()["stage_blocks"][0] == [0, 1]
    x = np.random.RandomState(2).randn(4, 16, 16, 3).astype(np.float32)
    np.testing.assert_array_equal(
        eng.run_batch(x),
        reference_logits(compiled, CFG, torch.from_numpy(x), 2).numpy())
    pipe = eng.pipe
    pipe.tick(inject=torch.from_numpy(x[:2]), tag="a")
    assert pipe.in_flight == 1 and pipe.busy
    assert pipe.cancel_in_flight() == ["a"]
    assert not pipe.busy and pipe.in_flight == 0
