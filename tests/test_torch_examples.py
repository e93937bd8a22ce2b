"""The six example ports (``examples/torch_*.py``) run from ``main`` on
the CPU (``--device cpu``) at small flags, and the numbers in them that
depend only on shapes equal the JAX package's, without running the JAX
examples: ``table2_model()``, the Fig 7 projections and stage plans, and
the compiled bytes per serve mode (JAX's ``compile_params`` under
``jax.eval_shape``, so no JAX array is computed).  Each example's own
assertions run inside it (served logits bit-identical to
``reference_logits``, the dataflows bit-exact, the compile error under
0.15); its closing "``<name>`` OK" line is checked.  Without CUDA every
example raises unless given ``--device cpu``.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.core import compiled_linear as jcl
from repro.core import fpga_model as jfpga
from repro.core import partition as jpartition
from repro.launch.train import build_cfg as jbuild_cfg
from repro.models import lm as jlm
from repro.models import mobilenet_v2 as jmb
from repro.models import repvgg as jrepvgg
from repro.models import resnet as jresnet

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart", "compile_resnet50", "serve_resnet50_pipeline",
         "serve_resnet50_fleet", "serve_model_zoo", "serve_lm", "train_lm")
# small flags: compile_resnet50's default 64 px runs six forwards of the
# dense reference on the CPU; 0.125 x 32 px keeps it to seconds
FLAGS = {"compile_resnet50": ["--width", "0.125", "--hw", "32"],
         "serve_resnet50_pipeline": ["--images", "8"],
         "serve_model_zoo": ["--images", "4"],
         "train_lm": ["--steps", "100", "--seq", "32", "--batch", "2"]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ran():
    """name -> (main's return, its stdout), each example run once."""
    out = {}

    def get(name, capsys):
        if name not in out:
            capsys.readouterr()
            res = load(name).main(FLAGS.get(name, []) + ["--device", "cpu"])
            out[name] = (res, capsys.readouterr().out)
        return out[name]
    return get


def jax_compiled_bytes(init, mode) -> int:
    """Bytes of JAX's compiled tree from shapes alone."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    out = jax.eval_shape(lambda p: jnn.unbox(jcl.compile_params(
        p, mode=mode, sparsity=0.8)) if mode != "dense" else jnn.unbox(p),
        shapes)
    return int(sum(np.prod(leaf.shape) * leaf.dtype.itemsize
                   for leaf in jax.tree.leaves(out)))


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_and_says_ok(ran, capsys, name):
    res, out = ran(name, capsys)
    assert out.rstrip().splitlines()[-1] == f"{name} OK"
    assert res is not None


def test_quickstart_numbers(ran, capsys):
    res, out = ran("quickstart", capsys)
    codes = np.zeros((512, 256), np.int8)
    bitmap, values = jcl.bitmap_pack(codes, int(512 * 0.2))
    assert res["bitmap_shape"] == bitmap.shape
    assert res["values_shape"] == values.shape
    assert res["packed_bytes"] == bitmap.size + values.size
    assert res["logits_shape"] == (2, 1, 512)
    assert 1 <= res["unique_products"] <= 32
    assert "bit-exact" in out


def test_compile_resnet50_tables_and_bytes(ran, capsys):
    res, _ = ran("compile_resnet50", capsys)
    assert res["table1"] == jresnet.table1()
    assert res["table2"] == jfpga.table2_model()
    assert res["fig7"] == jpartition.fig7_projection()
    cfg = jresnet.ResNetConfig(width_mult=0.125, num_classes=100, in_hw=32)
    for mode, row in res["modes"].items():
        want = jax_compiled_bytes(lambda k: jresnet.init(k, cfg), mode)
        assert row["bytes"] == want, mode
        assert row["rel_err"] < 0.15
    assert set(res["modes"]) == {"int8", "cfmm", "sparse_cfmm", "bitserial"}


def test_pipeline_plan_matches_jax(ran, capsys):
    res, out = ran("serve_resnet50_pipeline", capsys)
    blocks50 = jresnet.resnet50_conv_blocks()
    assert res["projection"] == \
        jpartition.solve_max_throughput(blocks50).summary()
    cfg = jresnet.ResNetConfig(width_mult=0.25, num_classes=100, in_hw=32)
    blocks = jresnet.conv_blocks_for(cfg)
    plan = jpartition.partition(blocks, 10_000.0).stage_plans(blocks, 4)
    st = res["stats"]
    assert st["stage_blocks"] == [list(p.block_ids) for p in plan]
    assert st["planned_link_bytes"] == [p.link_bytes for p in plan[:-1]]
    assert "bit-identical" in out and res["logits"].shape == (8, 100)


def test_fleet_projection_and_routing(ran, capsys):
    res, out = ran("serve_resnet50_fleet", capsys)
    assert res["projection"] == jpartition.solve_max_throughput(
        jresnet.resnet50_conv_blocks()).summary()
    st = res["stats"]
    assert sum(st["rows_dispatched"]) == sum(res["sizes"])
    assert st["n_replicas"] == 2 and st["requests_done"] == 6
    assert "every request bit-identical" in out


def test_model_zoo_projections_match_jax(ran, capsys):
    res, out = ran("serve_model_zoo", capsys)
    full = {"resnet50": jresnet.ResNetConfig(),
            "mobilenet_v2": jmb.MobileNetV2Config(),
            "repvgg_a0": jrepvgg.RepVGGConfig()}
    assert set(res) == set(full)
    for name, cfg in full.items():
        assert res[name]["projection"] == jpartition.solve_max_throughput(
            cfg.graph().blocks()).summary(), name
    assert out.count("output bit-identical") == 3


def test_serve_lm_param_bytes_match_jax(ran, capsys):
    res, out = ran("serve_lm", capsys)
    cfg = jbuild_cfg("smollm_360m", "tiny")
    for mode, nbytes in res["param_bytes"].items():
        want = jax_compiled_bytes(lambda k: jlm.init(k, cfg), mode)
        assert nbytes == want, mode
    assert all(len(t) == 8 for toks in res["tokens"].values() for t in toks)
    assert "greedy-token agreement" in out


def test_train_lm_crashes_resumes_and_learns(ran, capsys):
    """The three phases ran: the planned crash at 60 % of 100 steps (exit
    42), the resume from the step-50 checkpoint, and the QAT finetune
    from the step-100 one; the Markov stream's CE ends below a uniform
    guess over the vocabulary (ln 512)."""
    res, out = ran("train_lm", capsys)
    assert "crashed as planned: exit 42" in out
    assert out.count("resumed from step 50") == 1
    assert out.count("resumed from step 100") == 1
    assert res["qat"]["ce"] < np.log(512) and res["resumed"]["ce"] < \
        np.log(512)


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the examples do not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        load(name).main(FLAGS.get(name, []))
