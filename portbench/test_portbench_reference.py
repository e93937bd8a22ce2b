"""The plain reference equals the program's CPU plain forward, logits to
the bit, in both served modes at a reduced width; and the control (the
reference one precision below, int4) fails the comparison that decides
``correct``, here at a size a test run holds and, with a card, at the
cells' own size."""
from __future__ import annotations

import pytest
import torch

from portbench import bench, control
from portbench.models import resnet50 as arch
from portbench.reference import resnet50 as ref

MODES = ("int8", "sparse_cfmm")
SMALL = [{"width_mult": 0.125, "in_hw": 32, "num_classes": 10,
          "expansion": 4},
         {"width_mult": 0.25, "in_hw": 40, "num_classes": 24,
          "expansion": 4}]


def program_logits(fw, model, mode, x):
    from repro_torch.core.compiled_linear import ensure_compiled
    from repro_torch.models.resnet import ResNetConfig
    cfg = ResNetConfig(width_mult=model["width_mult"],
                       num_classes=model["num_classes"],
                       in_hw=model["in_hw"], expansion=model["expansion"])
    tree = ensure_compiled(arch.program_tree(fw, model), mode, 0.8)
    return cfg.apply(tree, x)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model", SMALL, ids=("w0.125", "w0.25"))
def test_reference_equals_the_programs_plain_forward(mode, model):
    fw = arch.float_weights(model, 2 ** 31 + 3, "cpu")
    x = torch.from_numpy(arch.input_pool(model, 5, 2 ** 31 + 3, "cpu"))
    want = program_logits(fw, model, mode, x)
    config = {"model": model, "serve": {"mode": mode, "sparsity": 0.8}}
    got = arch.reference_logits(config, fw, x)
    assert torch.equal(got, want)
    assert bench.compare(got.numpy(), want.numpy()) == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_reference_rows_are_independent(mode):
    model = SMALL[0]
    fw = arch.float_weights(model, 9, "cpu")
    x = torch.from_numpy(arch.input_pool(model, 6, 9, "cpu"))
    whole = ref.logits(fw, x, mode=mode, sparsity=0.8, width_mult=0.125)
    one = torch.cat([ref.logits(fw, x[i:i + 1], mode=mode, sparsity=0.8,
                                width_mult=0.125) for i in range(6)])
    assert torch.equal(whole, one)


@pytest.mark.parametrize("workload", ["resnet50-sparse80.offline",
                                      "resnet50-int8.offline"])
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 102, 103])
def test_control_fails_the_check_at_a_small_size(tiny_root, workload, seed):
    spec = bench.load_spec(tiny_root)
    _, config, _ = bench.find_cell(spec, workload, tiny_root)
    limit = config["limits"]["logit_gap"]
    gap, self_gap = control.control_gap(config, seed, "cpu", 8)
    assert self_gap == 0.0
    assert gap > limit and gap > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["resnet50-sparse80.offline",
                                      "resnet50-int8.offline"])
def test_control_fails_the_check_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = bench.load_spec()
    _, config, _ = bench.find_cell(spec, workload)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        gap, self_gap = control.control_gap(config, seed, "cuda",
                                            bench.CHECK_ROWS)
        assert self_gap == 0.0
        assert gap > config["limits"]["logit_gap"]
