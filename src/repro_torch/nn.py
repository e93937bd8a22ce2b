"""Parameter boxes and tree helpers (ports ``repro/nn.py``).

Parameters are plain nested dicts/lists of ``Param`` leaves.  A ``Param``
carries the tensor plus *logical* axis names and a ``kind`` string; conv
weights carry their ``(k, stride)`` geometry in the kind, exactly as in
the JAX package, so both packages' trees describe the same network.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


@dataclasses.dataclass
class Param:
    """A parameter leaf: tensor value + logical axis names (one per dim).

    kind='linear' marks weights eligible for constant-parameter compilation
    (core.compiled_linear.compile_params); ``conv{k}s{stride}`` marks conv
    weights; everything else is 'generic'.
    """

    value: Any
    axes: tuple = ()
    kind: str = "generic"


def tree_map(fn: Callable, tree: PyTree, is_leaf: Callable | None = None):
    """Map ``fn`` over the leaves of a dict/list/tuple tree.

    Anything that is not a dict, list or tuple (or that ``is_leaf``
    accepts) is a leaf — tensors, ``Param`` boxes, geometry markers."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree: PyTree, is_leaf: Callable | None = None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf)
    return out


def unstack(tree: PyTree, n: int) -> list:
    """The ``n`` slices along the leading axis of a stacked tree (the
    LM's ``layers``, the MoE's ``experts_stack``), as views: one
    ``unbind`` per tensor leaf, other leaves repeated.  Under autograd
    the slices' gradients then stack once per leaf, where ``n`` index
    views ``a[i]`` would each scatter into a zero tensor of the whole
    stack."""
    split = [a.unbind(0) if isinstance(a, torch.Tensor) else (a,) * n
             for a in tree_leaves(tree)]
    out = []
    for i in range(n):
        it = iter(s[i] for s in split)
        out.append(tree_map(lambda _: next(it), tree))
    return out


def tree_flatten_with_path(tree: PyTree, path: tuple = ()) -> list:
    """[(path, leaf)] in the JAX package's leaf order: dict keys sorted,
    lists and tuples by index, a NamedTuple by field.  A path entry is a
    dict key, an index, or ``".field"`` for a NamedTuple field — the
    strings the JAX package's checkpoint names leaves by."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree)
                for kv in tree_flatten_with_path(tree[key], path + (key,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, sub in zip(tree._fields, tree)
                for kv in tree_flatten_with_path(sub, path + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree)
                for kv in tree_flatten_with_path(sub, path + (i,))]
    return [(path, tree)]


def _is_param(x) -> bool:
    return isinstance(x, Param)


def param(gen: torch.Generator, shape, axes, init: str = "normal",
          kind: str = "generic", scale: float | None = None) -> Param:
    """Create an initialized f32 Param with logical axes, on the device of
    ``gen`` (a CUDA generator initialises on the card).

    init: 'normal' (truncated normal in [-2, 2], scaled by ``scale`` or
    by default 1/sqrt(fan_in) with fan_in = shape[0], as in the JAX
    package), 'zeros', 'ones'.  Values come from ``gen``; they differ
    from the JAX package's for the same seed, so parity tests carry
    weights across with ``params_from_numpy`` instead.
    """
    assert len(axes) == len(shape), (axes, shape)
    dev = gen.device if gen is not None else torch.device("cpu")
    if init == "zeros":
        value = torch.zeros(shape, device=dev)
    elif init == "ones":
        value = torch.ones(shape, device=dev)
    else:
        value = torch.empty(shape, device=dev)
        torch.nn.init.trunc_normal_(value, 0.0, 1.0, -2.0, 2.0,
                                    generator=gen)
        if scale is None:
            scale = 1.0 / math.sqrt(max(1, shape[0]))
        value *= scale
    return Param(value, tuple(axes), kind)


def linear_param(gen, d_in, d_out, axes):
    """A matmul weight eligible for constant-parameter compilation."""
    return param(gen, (d_in, d_out), axes, kind="linear")


def conv_kind(k: int, stride: int) -> str:
    """Param kind for a conv weight — the (k, stride) geometry rides the
    kind string."""
    return f"conv{k}s{stride}"


def conv_geom_of(kind) -> tuple | None:
    """(k, stride) of a conv kind, or None for non-conv kinds
    (``dwconv...`` kinds do not start with ``conv``)."""
    if isinstance(kind, str) and kind.startswith("conv"):
        ks, _, ss = kind[4:].partition("s")
        if ks.isdigit() and ss.isdigit():
            return int(ks), int(ss)
    return None


def dwconv_kind(k: int, stride: int) -> str:
    """Param kind for a depthwise conv weight (groups == channels)."""
    return f"dwconv{k}s{stride}"


def dwconv_geom_of(kind) -> tuple | None:
    """(k, stride) of a depthwise conv kind, or None otherwise."""
    if isinstance(kind, str) and kind.startswith("dwconv"):
        ks, _, ss = kind[6:].partition("s")
        if ks.isdigit() and ss.isdigit():
            return int(ks), int(ss)
    return None


def compilable(kind) -> bool:
    """Kinds eligible for constant-parameter compilation."""
    return (kind == "linear" or conv_geom_of(kind) is not None
            or dwconv_geom_of(kind) is not None)


def conv_param(gen, c_in, c_out, k, stride, axes):
    """A conv weight, stored flat (c_in*k*k, c_out) in im2col patch order
    (channel-major), carrying its (k, stride) geometry in the kind."""
    return param(gen, (c_in * k * k, c_out), axes, kind=conv_kind(k, stride))


def dwconv_param(gen, c, k, stride, axes):
    """A depthwise conv weight, stored (k*k, c) in tap-major row order —
    already the depthwise kernel's layout (one (c,) weight row per
    receptive-field tap), so compilation needs no layout shuffle."""
    return param(gen, (k * k, c), axes, kind=dwconv_kind(k, stride))


def unbox(tree: PyTree) -> PyTree:
    """Strip Param boxes -> raw tensor tree."""
    return tree_map(lambda p: p.value if _is_param(p) else p, tree,
                    is_leaf=_is_param)


def params_from_numpy(tree: PyTree) -> PyTree:
    """Carry a parameter tree across from the JAX package.

    ``tree`` is the JAX package's parameter tree with its leaves as any
    objects that have ``value`` (an array numpy can read), ``axes`` and
    ``kind`` — ``repro.nn.Param`` boxes qualify directly.  Returns the
    port's boxed tree with CPU tensors holding the same bits, so both
    packages compile and run the same network.
    """
    def box(leaf):
        value = torch.from_numpy(np.array(leaf.value, copy=True))
        return Param(value, tuple(leaf.axes), leaf.kind)

    return tree_map(box, tree, is_leaf=lambda x: hasattr(x, "kind")
                    and hasattr(x, "axes") and hasattr(x, "value"))


def params_to_numpy(tree: PyTree) -> PyTree:
    """Inverse of ``params_from_numpy``: Param leaves become
    ``(numpy value, axes, kind)`` triples the JAX package can rebox."""
    return tree_map(lambda p: (p.value.detach().cpu().numpy(), p.axes,
                               p.kind) if _is_param(p) else p, tree,
                    is_leaf=_is_param)


def vmap_init(init_fn: Callable, gen: torch.Generator, n: int, *args,
              **kwargs):
    """Initialize ``n`` stacked copies of a layer (the port of JAX's
    ``vmap`` over split keys): ``n`` calls of ``init_fn(gen, ...)`` in
    turn, each leaf stacked along a new leading axis named 'layers'.

    Each stacked leaf is allocated once and filled one layer at a time,
    so the peak holds the stacked tree and one layer, not two copies of
    the stack (Phi-3-medium's 40 layers are ~58 GB in f32)."""
    layer = init_fn(gen, *args, **kwargs)
    stacked = tree_map(
        lambda p: Param(torch.empty((n,) + tuple(p.value.shape),
                                    dtype=p.value.dtype,
                                    device=p.value.device),
                        ("layers",) + p.axes, p.kind) if _is_param(p) else p,
        layer, is_leaf=_is_param)
    slots = [p.value for p in tree_leaves(stacked, is_leaf=_is_param)
             if _is_param(p)]
    for i in range(n):
        if i:
            layer = init_fn(gen, *args, **kwargs)
        values = [p.value for p in tree_leaves(layer, is_leaf=_is_param)
                  if _is_param(p)]
        for slot, value in zip(slots, values, strict=True):
            slot[i].copy_(value)
    return stacked


def to_device(tree: PyTree, device) -> PyTree:
    """Move every tensor of a tree to ``device`` (other leaves pass)."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else x, tree)

