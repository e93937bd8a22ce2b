"""A run with the timed path broken underneath reads ``correct`` false:
the harness's look for a card skipped, the rest of a run driven on the
CPU at the tiny size (and, with a card, ``stale`` and ``half`` at each
cell's own size), one fault planted in the program for each way a
served cell can go wrong (no cell crosses chips, so no exchange can be
left out):

* ``stale``: a step hands back the previous microbatch's logits (its
  state unchanged);
* ``half``: half of each microbatch left out, its rows given the mean of
  the rest;
* ``altered``: one logit of every answer altered where the head makes
  it, by a ten-thousandth of the row's largest;
* ``lost``: every third row span the front door hands the engine never
  served, so its requests are never answered.
"""
from __future__ import annotations

import time

import pytest
import torch

from portbench import bench

CELLS = ("resnet50-sparse80.offline", "resnet50-int8.offline")


def plant(mp, fault):
    from repro_torch.distributed import conv_pipeline
    from repro_torch.models import graph
    from repro_torch.serving import pipeline
    tick = conv_pipeline.ConvPipeline.tick
    if fault == "stale":
        last = {}

        def stale(self, inject=None, tag=None):
            out = []
            for t, o in tick(self, inject, tag):
                prev = last.get(tuple(o.shape))
                last[tuple(o.shape)] = o
                out.append((t, o if prev is None else prev))
            return out
        mp.setattr(conv_pipeline.ConvPipeline, "tick", stale)
    elif fault == "half":
        def half(self, inject=None, tag=None):
            out = []
            for t, o in tick(self, inject, tag):
                o = o.clone()
                keep = max(1, o.shape[0] // 2)
                o[keep:] = o[:keep].mean(0)
                out.append((t, o))
            return out
        mp.setattr(conv_pipeline.ConvPipeline, "tick", half)
    elif fault == "altered":
        apply_linear = graph.apply_linear

        def altered(w, x, **kw):
            y = apply_linear(w, x, **kw).clone()
            y[:, 0] += 1e-4 * y.abs().amax(dim=1)
            return y
        mp.setattr(graph, "apply_linear", altered)
    elif fault == "lost":
        submit_rows = pipeline.PipelineEngine.submit_rows
        count = {"n": 0}

        def lost(self, req, start, stop):
            count["n"] += 1
            if req.rid >= 0 and count["n"] % 3 == 0:
                return
            submit_rows(self, req, start, stop)
        mp.setattr(pipeline.PipelineEngine, "submit_rows", lost)
        mp.setattr(bench, "DRAIN_S", 0.3)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered", "lost"])
def test_a_broken_path_reads_not_correct(tiny_root, workload, fault):
    with pytest.MonkeyPatch.context() as mp:
        plant(mp, fault)
        out, _ = bench.run_cell(workload, 2 ** 31 + 909, 0.6, False,
                                t_process=time.perf_counter(),
                                root=tiny_root, device="cpu")
    assert not out["correct"], out["checks"]
    c = out["checks"]
    if fault == "lost":
        assert c["unanswered"]["value"] > c["unanswered"]["limit"]
    else:
        assert c["logit_gap"]["value"] > c["logit_gap"]["limit"]


def test_the_comparison_reads_a_row_it_did_not_expect():
    want = torch.randn(4, 10).numpy()
    got = want.copy()
    assert bench.compare(got, want) == 0.0
    got[2, 3] = float("nan")
    assert bench.compare(got, want) == float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half"])
def test_a_broken_path_reads_not_correct_at_the_cells_size(workload, fault):
    """The faults confined to part of a microbatch, or to one step, at
    the cell's own size (microbatch 512, the 64-row sample), on three
    seeds; each reading printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        with pytest.MonkeyPatch.context() as mp:
            plant(mp, fault)
            out, _ = bench.run_cell(workload, seed, 2.0, False,
                                    t_process=time.perf_counter(),
                                    device="cuda")
        c = out["checks"]
        print(f"fault {fault} {workload} seed {seed}: attempted "
              f"{out['attempted']}, logit_gap {c['logit_gap']['value']!r} "
              f"(limit {c['logit_gap']['limit']!r}), unanswered "
              f"{c['unanswered']['value']}", flush=True)
        assert not out["correct"], c
        assert c["logit_gap"]["value"] > c["logit_gap"]["limit"]
