"""Logical-axis sharding: rules tables, partition specs with divisibility
guards, DTensor placements, and in-graph sharding constraints (ports
``repro/distributed/sharding.py``).

Logical axes used across the codebase:
  batch/seq            activations
  embed/vocab/ffn_*    weight matrices (in x out)
  heads_q/heads_kv     attention projections (out dim = heads*head_dim)
  experts_stack        MoE expert-stacked leading dim
  layers               stacked leading dim (never sharded)
  *_s                  state/cache axes (heads_kv_sharded etc.)

The rules map logical -> mesh axes.  A guard drops any assignment whose
dimension is not divisible by the mesh-axis size (e.g. smollm's 15 heads
on a 16-way model axis) — the dry run then shows the replication cost in
the roofline instead of failing.

A spec is a tuple with one entry per leading tensor dim (trailing
replicated dims dropped), each ``None``, a mesh-axis name, or a tuple of
names sharded over their product, major to minor: it compares equal to
``tuple()`` of JAX's ``PartitionSpec``.  ``placements_of`` turns a spec
into DTensor placements on a torch ``DeviceMesh``, a dimension named on
several mesh dims sharded on each of them in mesh order (major to minor,
as JAX's).
"""
from __future__ import annotations

import logging

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import nn

log = logging.getLogger(__name__)

# Training: FSDP over 'data' on the weight in-dim, TP over 'model' on the
# out-dim (Megatron column-parallel; down/o projections are row-parallel
# via their own in-axis entry).  'pod' stays pure-DP.
TRAIN_RULES = {
    "batch": ("data",),
    "seq": (),
    "embed": ("data",),          # FSDP shard of the d_model dim
    "embed_out": ("model",),
    "vocab": ("model",),
    "ffn_in": ("model",),        # column-parallel out-dim (gate/up)
    "ffn_out": ("model",),       # row-parallel in-dim (down proj)
    "heads_q": ("model",),
    "heads_kv": ("model",),
    "kv_lora": (),
    "mamba_inner": ("model",),
    "experts": ("model",),       # router out-dim
    "experts_stack": ("model",), # expert parallelism
    "conv_in": (),
    "conv_out": ("model",),
    "classes": ("model",),
    "heads_s": ("model",),
    "heads_kv_sharded": ("model",),
    "mamba_inner_s": ("model",),
    "embed_s": (),
    "layers": (),
}

# Serving: weights replicated across 'data' (each DP replica serves its own
# requests), TP over 'model'; caches shard batch over 'data'.
SERVE_RULES = dict(TRAIN_RULES)
SERVE_RULES.update({
    "embed": (),
    "ffn_out": (),
    "kv_seq": (),
})

# Small dense models on a fixed 16x16 mesh are strangled by TP activation
# all-reduces; fold 'model' into data parallel — batch shards over both
# axes, weights FSDP over both, no activation ARs.
DP_ONLY_TRAIN_RULES = dict(TRAIN_RULES)
DP_ONLY_TRAIN_RULES.update({
    "batch": (("data", "model"), "data"),
    "embed": (("data", "model"), "data"),
    "ffn_in": (),
    "ffn_out": (),
    "heads_q": (),
    "heads_kv": (),
    "mamba_inner": (),
    "experts_stack": ("model",),   # expert parallelism stays
    "vocab": (),
    "embed_out": (),
    "conv_out": (),
})

# Split-KV decode: the KV cache seq dim shards over 'model'; the
# partitioned softmax reductions emit small per-layer all-reduces instead
# of replicating the cache 16x.  Weight TP unchanged.
SERVE_SPLITKV_RULES = dict(SERVE_RULES)
SERVE_SPLITKV_RULES.update({
    "kv_seq": ("model",),
    "heads_kv_sharded": (),
})

# Expert parallelism + pure DP — batch on 'data' only, experts sharded
# over 'model', NO tensor parallelism on the non-expert (mamba/attention/
# dense) linears: the only cross-'model' traffic left is the MoE
# dispatch/combine all-to-all.
EP_DP_TRAIN_RULES = dict(DP_ONLY_TRAIN_RULES)
EP_DP_TRAIN_RULES.update({
    "batch": ("data",),
    "embed": ("data",),
})

RULES_BY_NAME = {
    "train": TRAIN_RULES,
    "dp_only": DP_ONLY_TRAIN_RULES,
    "ep_dp": EP_DP_TRAIN_RULES,
    "serve": SERVE_RULES,
    "serve_splitkv": SERVE_SPLITKV_RULES,
}


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh``, or a shape-only mesh's own
    ``shape`` dict (``launch.mesh.ShapeMesh``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
    return dict(mesh.shape)


def _axis_size(shape: dict, mesh_ax) -> int:
    if isinstance(mesh_ax, tuple):
        size = 1
        for a in mesh_ax:
            size *= shape.get(a, 1)
        return size
    return shape.get(mesh_ax, 1)


def spec_for(axes: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    """A partition spec, dropping non-divisible assignments and never
    using one mesh axis twice in a single spec.  Rule entries may be
    tuples of mesh axes (sharded over their product)."""
    sizes = mesh_shape(mesh)
    entries = []
    used = set()
    for dim, ax in zip(shape, axes):
        assigned = None
        if ax is not None:
            for mesh_ax in rules.get(ax, ()):
                parts = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
                size = _axis_size(sizes, mesh_ax)
                if (size > 1 and not (used & set(parts))
                        and dim % size == 0):
                    assigned = mesh_ax
                    used.update(parts)
                    break
                elif size > 1:
                    log.debug("drop shard %s(%d) %% %s(%d)",
                              ax, dim, size, size)
        entries.append(assigned)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements_of(spec: tuple, mesh: DeviceMesh) -> list:
    """DTensor placements of a spec on a ``DeviceMesh``: ``Shard(dim)`` on
    each mesh dim a tensor dim names, ``Replicate()`` elsewhere.  A tuple
    entry must name its mesh dims in mesh order (major to minor)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in
               (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def param_shardings(params, mesh, rules: dict = TRAIN_RULES):
    """Param tree -> the tree of its leaves' specs; other leaves pass
    through."""
    def visit(p):
        if not isinstance(p, nn.Param):
            return p
        return spec_for(p.axes, tuple(p.value.shape), rules, mesh)

    return nn.tree_map(visit, params,
                       is_leaf=lambda x: isinstance(x, nn.Param))


def distribute_params(params, mesh: DeviceMesh, rules: dict = TRAIN_RULES):
    """Param tree -> the same tree with DTensor values sharded by the
    rules (the counterpart of ``jax.device_put`` with
    ``param_shardings``).  Every rank passes the same full tree; rank 0's
    values are the ones distributed."""
    def put(p):
        if not isinstance(p, nn.Param):
            return p
        spec = spec_for(p.axes, tuple(p.value.shape), rules, mesh)
        return nn.Param(distribute_tensor(p.value, mesh,
                                          placements_of(spec, mesh)),
                        p.axes, p.kind)

    return nn.tree_map(put, params, is_leaf=lambda x: isinstance(x, nn.Param))


_ACTIVE_RULES = [TRAIN_RULES]
_ACTIVE_MESH = [None]


class use_rules:
    def __init__(self, rules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.insert(0, self.rules)

    def __exit__(self, *a):
        _ACTIVE_RULES.pop(0)


class use_mesh:
    """The active mesh for ``shard`` (the counterpart of ``with mesh:``)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.insert(0, self.mesh)
        return self.mesh

    def __exit__(self, *a):
        _ACTIVE_MESH.pop(0)


def shard(x, *axes):
    """Sharding constraint by logical axes: a no-op without an active
    ``DeviceMesh``; under one a DTensor is redistributed to the spec's
    placements and a plain tensor passes through unchanged."""
    mesh = _ACTIVE_MESH[0]
    if not isinstance(mesh, DeviceMesh) or not isinstance(x, DTensor):
        return x
    spec = spec_for(tuple(axes), tuple(x.shape), _ACTIVE_RULES[0], mesh)
    return x.redistribute(mesh, placements_of(spec, mesh))


def batch_shardings(batch_specs: dict, mesh, dp_axes=("pod", "data")) -> dict:
    """Batch dict of tensors (meta ones in the dry run) -> a dict of
    specs: batch over the data-parallel axes, everything else
    replicated."""
    sizes = mesh_shape(mesh)
    dp = [ax for ax in dp_axes if sizes.get(ax, 1) > 1]
    total = 1
    for ax in dp:
        total *= sizes[ax]

    def visit(s: torch.Tensor):
        shape = tuple(s.shape)
        # find the batch dim: first dim unless M-RoPE positions (3, B, ...)
        bdim = 0 if len(shape) < 2 or shape[0] != 3 else 1
        entries = [None] * len(shape)
        if total > 1 and shape[bdim] % total == 0:
            entries[bdim] = tuple(dp) if len(dp) > 1 else dp[0]
        elif sizes.get("data", 1) > 1 and shape[bdim] % sizes["data"] == 0:
            entries[bdim] = "data"
        return tuple(entries)

    return {k: visit(v) for k, v in batch_specs.items()}
