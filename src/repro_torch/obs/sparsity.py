"""Activation-sparsity profiling — post-ReLU zero fractions on real
traffic (ports ``repro/obs/sparsity.py``).

The paper exploits *weight* sparsity; ROADMAP's activation-sparsity item
starts with measuring how zero the *activations* actually are, per layer
and per ``coarse_in`` lane group (a kernel that skips an input column
group per tap needs the whole group zero, so the interesting number is
the all-zero-group cell fraction, not just the scalar element fraction).

The profiler is the host-side accumulator.  It never computes anything
itself — the conv ops emit per-layer count tensors (see
``kernels/ops.conv2d(zero_count=...)``): on the card, from the conv
kernels' epilogues (or a recount on ``y`` where the groups misalign the
kernel's channel tile), on the CPU from the plain ``ref.zero_counts_ref``.
Counts are *observation-only*: they read the f32 Collector output ``y``
that already exists, so logits are bit-identical with profiling on
(tested).

``add()`` stores the tensors as they are, on their device, with no copy
and no sync; they move to the host only at ``snapshot()`` time, so
profiling does not serialize the pipeline's asynchronous launches.
"""
from __future__ import annotations

import numpy as np
import torch

# aux keys every conv layer reports (all float32 arrays / scalars):
#   row_zeros     (N,)  zero elements per image row
#   group_zeros   (G,)  zero elements per coarse_in group, summed over rows
#   group_allzero (G,)  (image, pixel) cells whose whole group is zero
#   elems_per_row ()    H*W*C          (static, repeated per microbatch)
#   cells         ()    N*H*W          (per-group cell count this microbatch)
AUX_KEYS = ("row_zeros", "group_zeros", "group_allzero",
            "elems_per_row", "cells")


def _host(v) -> np.ndarray:
    """A count as a float64 numpy array (a CUDA tensor comes to the host
    first: ``np.asarray`` of one raises)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


class SparsityProfiler:
    """Accumulates per-layer zero-count aux emitted by profiled conv
    lowerings; reduces to fractions + histograms at snapshot time."""

    def __init__(self, groups: int = 8, hist_buckets: int = 10):
        assert groups >= 1 and hist_buckets >= 1
        self.groups = groups
        self.hist_buckets = hist_buckets
        self._acc: dict[str, list[dict]] = {}
        self.microbatches_profiled = 0

    def add(self, aux: dict, count_microbatch: bool = True):
        """Record per-layer counts (``{layer: {aux_key: tensor}}``);
        tensors stay on their device.  A pipeline delivers ONE microbatch's aux
        as several per-stage ``add`` calls across ticks — it passes
        ``count_microbatch`` only for stage 0 so
        ``microbatches_profiled`` counts microbatches, not stages."""
        if not aux:
            return
        if count_microbatch:
            self.microbatches_profiled += 1
        for layer, counts in aux.items():
            self._acc.setdefault(layer, []).append(counts)

    def reset(self):
        self._acc.clear()
        self.microbatches_profiled = 0

    @property
    def layers(self):
        return sorted(self._acc)

    def snapshot(self) -> dict:
        """Reduce everything accumulated so far (moves it to the host).

        Per layer: overall post-ReLU ``zero_fraction``, a per-image
        zero-fraction histogram over ``hist_buckets`` equal-width
        buckets on [0, 1], and per-``coarse_in``-group element /
        all-zero-cell fractions.  Plus an ``overall`` element-weighted
        aggregate across layers.
        """
        layers = {}
        tot_zeros = 0.0
        tot_elems = 0.0
        edges = np.linspace(0.0, 1.0, self.hist_buckets + 1)
        for name in self.layers:
            chunks = self._acc[name]
            row_zeros = np.concatenate(
                [_host(c["row_zeros"]) for c in chunks])
            elems_per_row = float(_host(chunks[0]["elems_per_row"]))
            group_zeros = np.sum(
                [_host(c["group_zeros"]) for c in chunks], axis=0)
            group_allzero = np.sum(
                [_host(c["group_allzero"]) for c in chunks], axis=0)
            cells = float(sum(float(_host(c["cells"])) for c in chunks))
            n_rows = int(row_zeros.shape[0])
            elems = n_rows * elems_per_row
            zeros = float(row_zeros.sum())
            frac_rows = row_zeros / max(elems_per_row, 1.0)
            hist, _ = np.histogram(frac_rows, bins=edges)
            n_groups = int(group_zeros.shape[0])
            group_elems = elems / max(n_groups, 1)
            layers[name] = {
                "n_rows": n_rows,
                "elems_per_row": elems_per_row,
                "zeros": zeros,
                "zero_fraction": zeros / max(elems, 1.0),
                "row_fraction_hist": {
                    "bucket_edges": [float(e) for e in edges],
                    "counts": [int(c) for c in hist],
                },
                "group_size": self.groups,
                "group_zero_fraction": [
                    float(z / max(group_elems, 1.0)) for z in group_zeros],
                "group_allzero_cell_fraction": [
                    float(a / max(cells, 1.0)) for a in group_allzero],
            }
            tot_zeros += zeros
            tot_elems += elems
        return {
            "groups": self.groups,
            "microbatches_profiled": self.microbatches_profiled,
            "overall_zero_fraction": tot_zeros / max(tot_elems, 1.0),
            "layers": layers,
        }
