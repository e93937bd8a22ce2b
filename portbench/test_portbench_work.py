"""The benchmark's own counts of the work: ResNet50 at width 1.0 is about
3.86 G MACs an image dense (He et al.'s 3.8 G; the stride rides the
first 1x1 conv of a stage, as in the paper's network, where the 4.1 G
often quoted puts it on the 3x3), its convs are the served network's
convs, and the roofline's least time follows from the peaks."""
from __future__ import annotations

import pytest

from portbench import peaks, work
from portbench.models import resnet50 as arch
from portbench.reference import resnet50 as ref

FULL = {"width_mult": 1.0, "in_hw": 224, "num_classes": 1000,
        "expansion": 4}
INT8 = {"model": FULL, "serve": {"mode": "int8"}}
SPARSE = {"model": FULL, "serve": {"mode": "sparse_cfmm", "sparsity": 0.8}}


def test_resnet50_dense_macs_per_image():
    macs = sum(c.macs for c in arch.conv_work(FULL, "int8", None))
    macs += arch.head_macs(FULL, "int8", None)
    assert 3.8e9 < macs < 3.9e9
    assert arch.ops_per_row(INT8) == 2 * macs


def test_sparse_keeps_a_fifth_of_each_column():
    dense = arch.ops_per_row(INT8)
    sparse = arch.ops_per_row(SPARSE)
    # whole multiples of 8 kept: 16 of a 1x1 conv's 64 rows
    assert sparse / dense == pytest.approx(0.21, abs=0.01)
    assert ref.keep_rows(147, 0.8) == 32 and ref.keep_rows(4608, 0.8) == 928


@pytest.mark.parametrize("width", [1.0, 0.25])
def test_convs_are_the_served_networks(width):
    """The same convs, in the same order and at the same input sizes, as
    the program's graph of the network."""
    from repro_torch.models.resnet import ResNetConfig
    graph = ResNetConfig(width_mult=width).graph()
    served = [(s.c_in, s.c_out, s.k, s.stride, s.hw)
              for unit in graph.blocks() for s in unit]
    model = {**FULL, "width_mult": width}
    ours = []
    hw = 224
    stem, blocks = ref.architecture(width, 4)
    ours.append((3, stem.c_out, 7, 2, 112))
    hw = 56
    for blk in blocks:
        out_hw = ref.same_pads(hw, 1, blk.a.stride)[2]
        convs = ([blk.sc] if blk.sc else []) + [blk.a, blk.b, blk.c]
        for c in convs:
            ours.append((c.c_in, c.c_out, c.k, c.stride, out_hw))
        hw = out_hw
    assert sorted(ours) == sorted(served)
    assert len(arch.conv_work(model, "int8", None)) == len(served) == 53


def test_least_time_is_the_larger_bound_per_launch():
    works = arch.kernel_launches(INT8, "conv_implicit")
    one = work.least_s(works, [512])
    assert one == pytest.approx(sum(
        max(2 * c.macs * 512 / peaks.PEAK_INT8,
            (c.act_bytes * 512 + c.weight_bytes) / peaks.HBM_BW)
        for c in works))
    assert work.least_s(works, [512, 512]) == pytest.approx(2 * one)
    assert 0 < one < 0.05


@pytest.mark.parametrize("config, kernel", [(INT8, "conv_implicit"),
                                            (SPARSE, "conv_sparse")])
def test_each_mode_counts_its_own_conv_kernel(config, kernel):
    other = {"conv_implicit": "conv_sparse",
             "conv_sparse": "conv_implicit"}[kernel]
    assert len(arch.kernel_launches(config, kernel)) == 53
    assert arch.kernel_launches(config, other) == []
    assert arch.kernel_launches(config, "sparse_matvec") == []
