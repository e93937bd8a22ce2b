"""Conv-DAG graph IR + topological compiler (ports ``repro/models/graph.py``).

A model is a **graph** of ops over quantization-domain edges; unit
compilation, stage planning and the pipeline engine all consume it.
*Nodes* are ops (``input``, ``quant``, ``dequant``, ``conv``, ``dwconv``,
``pool``, ``head``); every edge a pipeline stage boundary may cut carries
the ``(int8, scale[row])`` pair — the paper's 8-bit inter-chip link with
one scale per image, so any packing of rows into microbatches gives the
same bits.  Residual adds are fused as the consuming conv's ``shortcut``
epilogue argument (the paper's Collector does the add, SS II-D.4).

``Graph.units()`` cuts the DAG into pipeline units at articulation edges:
after a node whose value is a quantization-domain pair and the ONLY live
value.  The trailing conv-free segment is the head unit (``block_id`` -1).

Every op is ported; a ``dwconv`` node runs the depthwise kernel through
``apply_conv`` (its leaf carries ``ConvGeom(dw=True)``).  With
``sparsity_groups`` every ReLU-output conv also returns its activation
zero counts (``compile_graph``), which obs/sparsity.py aggregates.
"""
from __future__ import annotations

import dataclasses
import heapq

import torch
import torch.nn.functional as F

from repro_torch.core.compiled_linear import act_quant, apply_conv, apply_linear
from repro_torch.core.fpga_model import ConvLayerSpec
from repro_torch.kernels.ref import fma_f32, pad_same_nhwc


class GraphError(ValueError):
    """A malformed model graph (shape mismatch, cycle, bad op wiring)."""


OPS = ("input", "quant", "dequant", "conv", "dwconv", "pool", "head")

# value kinds flowing along edges:
#   f32  — float NHWC activations (or the input image)
#   qt   — the (int8 NHWC, f32 scale[row]) quantization-domain pair
#   out  — the head's f32 logits
_F32, _QT, _OUT = "f32", "qt", "out"


@dataclasses.dataclass(frozen=True)
class Node:
    """One op of a model graph.

    ``inputs`` names the producer node(s) (all ops here are unary in
    their main input; the residual add rides ``shortcut``).  ``path`` is
    the param-tree path of the op's weights (conv/dwconv: a dict with
    ``w``/``scale``/``bias``; head: a dict with ``w``).  ``unit`` is an
    optional unit-label hint — the segment containing this node takes the
    first such label as its name.
    """

    name: str
    op: str
    inputs: tuple = ()
    path: tuple = ()
    k: int = 0
    stride: int = 1
    c_in: int = 0
    c_out: int = 0
    relu: bool = True
    quant_out: bool = False
    shortcut: str | None = None
    unit: str | None = None


@dataclasses.dataclass(frozen=True)
class ValueInfo:
    """Static shape/kind of one edge value: (hw, hw, ch) spatial map of
    ``kind`` ('f32' | 'qt' | 'out')."""

    hw: int
    ch: int
    kind: str


@dataclasses.dataclass(frozen=True)
class PipelineUnit:
    """One schedulable unit of the compiled forward.

    ``fn(params, carry) -> carry`` is a pure function of the unit's OWN
    param subtree (``params`` here), so a pipeline stage holds exactly its
    units' constant weights and nothing else — the paper's persistent
    per-chip network.  Every edge between units is the quantization-domain
    pair ``(int8 activations, f32 scale[row])`` — the 8-bit inter-chip
    link, with one independent scale PER IMAGE (per-row domains,
    DESIGN.md §9) so serving may pack rows from different requests into
    one microbatch without any row's bits depending on its neighbours —
    except the f32 image into the first unit and the f32 logits out of
    the head.  ``block_id`` indexes the graph's ``blocks()`` list so
    ``partition.StagePlan``s map 1:1 onto units; the head rides the last
    stage (``block_id`` -1).
    """

    name: str
    block_id: int
    params: dict
    fn: object


@dataclasses.dataclass(frozen=True)
class Graph:
    """A conv-DAG model: nodes + the input image geometry."""

    name: str
    nodes: tuple
    in_hw: int
    in_ch: int
    num_classes: int

    def __post_init__(self):
        seen = set()
        for n in self.nodes:
            if n.op not in OPS:
                raise GraphError(f"{n.name}: unknown op {n.op!r}")
            if n.name in seen:
                raise GraphError(f"duplicate node name {n.name!r}")
            seen.add(n.name)
        for n in self.nodes:
            for ref in n.inputs + ((n.shortcut,) if n.shortcut else ()):
                if ref not in seen:
                    raise GraphError(f"{n.name}: unknown input {ref!r}")

    # -- structure ---------------------------------------------------------

    def topo_order(self) -> tuple:
        """Deterministic Kahn topological order: among ready nodes, the
        earliest-declared runs first — so builders that already append in
        dataflow order compile to exactly that order, and any permutation
        of independent declarations yields the same schedule."""
        index = {n.name: i for i, n in enumerate(self.nodes)}
        indeg = {n.name: 0 for n in self.nodes}
        consumers: dict = {n.name: [] for n in self.nodes}
        for n in self.nodes:
            deps = set(n.inputs) | ({n.shortcut} if n.shortcut else set())
            indeg[n.name] = len(deps)
            for d in deps:
                consumers[d].append(n.name)
        ready = [index[n.name] for n in self.nodes if indeg[n.name] == 0]
        heapq.heapify(ready)
        order = []
        while ready:
            i = heapq.heappop(ready)
            node = self.nodes[i]
            order.append(node)
            for c in consumers[node.name]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    heapq.heappush(ready, index[c])
        if len(order) != len(self.nodes):
            raise GraphError(f"graph {self.name!r} has a cycle")
        return tuple(order)

    def shapes(self) -> dict:
        """name -> ValueInfo for every node's output value, checked: conv
        inputs must be quantization-domain pairs with matching channels,
        shortcuts must be f32 maps of the conv's own output shape."""
        info: dict = {}
        for n in self.topo_order():
            if n.op == "input":
                info[n.name] = ValueInfo(self.in_hw, self.in_ch, _F32)
                continue
            src = info[n.inputs[0]]
            if n.op == "quant":
                if src.kind != _F32:
                    raise GraphError(f"{n.name}: quant of {src.kind} value")
                info[n.name] = ValueInfo(src.hw, src.ch, _QT)
            elif n.op == "dequant":
                if src.kind != _QT:
                    raise GraphError(f"{n.name}: dequant of {src.kind}")
                info[n.name] = ValueInfo(src.hw, src.ch, _F32)
            elif n.op in ("conv", "dwconv"):
                if src.kind != _QT:
                    raise GraphError(
                        f"{n.name}: conv consumes (int8, scale) edges, "
                        f"got {src.kind} from {n.inputs[0]!r}")
                if src.ch != n.c_in:
                    raise GraphError(
                        f"{n.name}: c_in={n.c_in} but input "
                        f"{n.inputs[0]!r} has {src.ch} channels")
                if n.op == "dwconv" and n.c_out != n.c_in:
                    raise GraphError(f"{n.name}: depthwise needs "
                                     f"c_out == c_in, got {n.c_in}->{n.c_out}")
                hw = -(-src.hw // n.stride)
                info[n.name] = ValueInfo(hw, n.c_out,
                                         _QT if n.quant_out else _F32)
                if n.shortcut is not None:
                    if n.op == "dwconv":
                        raise GraphError(f"{n.name}: depthwise epilogue "
                                         "shortcut unsupported by design "
                                         "(no model needs it)")
                    sc = info[n.shortcut]
                    if sc.kind != _F32 or (sc.hw, sc.ch) != (hw, n.c_out):
                        raise GraphError(
                            f"{n.name}: shortcut {n.shortcut!r} is "
                            f"{sc.kind} {sc.hw}x{sc.hw}x{sc.ch}, need f32 "
                            f"{hw}x{hw}x{n.c_out}")
            elif n.op == "pool":
                if src.kind != _F32:
                    raise GraphError(f"{n.name}: pool of {src.kind}")
                info[n.name] = ValueInfo(-(-src.hw // n.stride), src.ch, _F32)
            elif n.op == "head":
                if src.kind != _QT:
                    raise GraphError(f"{n.name}: head consumes a "
                                     f"(int8, scale) edge, got {src.kind}")
                info[n.name] = ValueInfo(1, self.num_classes, _OUT)
        return info

    def units(self) -> list:
        """Cut the DAG at articulation edges -> [(unit_name, [nodes])].

        A cut is legal after node v iff v's value is a quantization-domain
        pair AND it is the only live value (every earlier value has no
        remaining consumer) AND the open segment contains a conv.  The
        trailing segment must be conv-free (the head unit).
        """
        order = self.topo_order()
        info = self.shapes()
        remaining = {n.name: 0 for n in order}
        for n in order:
            deps = set(n.inputs) | ({n.shortcut} if n.shortcut else set())
            for d in deps:
                remaining[d] += 1
        segments, seg, live = [], [], set()
        for n in order:
            seg.append(n)
            for d in set(n.inputs) | ({n.shortcut} if n.shortcut else set()):
                remaining[d] -= 1
                if remaining[d] == 0:
                    live.discard(d)
            if remaining[n.name] > 0:
                live.add(n.name)
            has_conv = any(m.op in ("conv", "dwconv") for m in seg)
            if (live == {n.name} and info[n.name].kind == _QT and has_conv):
                segments.append(seg)
                seg = []
        if seg:
            if any(m.op in ("conv", "dwconv") for m in seg):
                raise GraphError(
                    f"graph {self.name!r}: trailing segment holds conv "
                    f"nodes {[m.name for m in seg]} past the last "
                    "quantization-domain cut — the head unit must be "
                    "conv-free")
            segments.append(seg)
        names, counts = [], {}
        for s in segments[:-1]:
            label = next((m.unit for m in s if m.unit is not None), None)
            label = label if label is not None else f"unit{len(names)}"
            counts[label] = counts.get(label, 0) + 1
            names.append(label if counts[label] == 1
                         else f"{label}.{counts[label]}")
        names.append("head")
        return list(zip(names, segments))

    # -- analytic views (partitioning) ------------------------------------

    def blocks(self) -> list:
        """Per-unit conv specs for the Fig 7 planner: one
        ``list[ConvLayerSpec]`` per non-head unit, in unit order — the
        DAG-general replacement for ``resnet.conv_blocks_for``'s
        hand-built list.  Depthwise layers report ``c_in=1`` so their
        analytic MACs come out to k*k*C*hw*hw."""
        info = self.shapes()
        out = []
        for _, seg in self.units()[:-1]:
            specs = []
            for n in seg:
                if n.op in ("conv", "dwconv"):
                    c_in = 1 if n.op == "dwconv" else n.c_in
                    specs.append(ConvLayerSpec(n.name, c_in, n.c_out, n.k,
                                               info[n.name].hw,
                                               stride=n.stride))
            out.append(specs)
        return out

    def in_shape(self) -> tuple:
        """Expected per-image input shape (H, W, C) at the front door."""
        return (self.in_hw, self.in_hw, self.in_ch)

    def edge_bytes(self) -> list:
        """int8 bytes per image on each unit's outgoing cut edge (the
        8-bit inter-chip link), in unit order — what a ``StagePlan``
        cutting after that unit actually moves.  Replaces
        ``partition.edge_bytes_after_block``'s ResNet-only stem/maxpool
        special case with the graph's real shapes."""
        info = self.shapes()
        out = []
        for _, seg in self.units()[:-1]:
            v = info[seg[-1].name]
            out.append(v.hw * v.hw * v.ch)
        return out


# ---------------------------------------------------------------------------
# Compilation: graph -> pipeline units / single-device forward
# ---------------------------------------------------------------------------

def _row_scale(s: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-row ``(N,)`` scale (or a scalar) over NHWC values."""
    return s.reshape((-1,) + (1,) * 3)


def _subtree(params, path):
    sub = params
    for p in path:
        sub = sub[p]
    return sub


def _max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """SAME max-pool of NHWC ``x`` with -inf padding (the explicit pad
    keeps torch's symmetric padding out of it)."""
    xp, _, _ = pad_same_nhwc(x, k, stride, value=float("-inf"))
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), k, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _head_pool(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Global average of the dequantized map, ``mean(q * s[row])`` over
    (H, W): a running fused multiply-add over the pixels in order, then
    ``* f32(1/(H*W))``.  That is the order XLA's fused reduction takes on
    the JAX package's jitted forward for 1x1 and 7x7 maps; the result is
    the same bits on the CPU and on the card."""
    N, H, W, C = q.shape
    qf = q.float().reshape(N, H * W, C)
    sr = s.reshape(-1, 1).expand(N, C)
    acc = torch.zeros((N, C), dtype=torch.float32, device=q.device)
    for i in range(H * W):
        acc = fma_f32(qf[:, i], sr, acc)
    return acc * torch.tensor(1.0 / (H * W), dtype=torch.float32,
                              device=q.device)


@dataclasses.dataclass(frozen=True)
class Dequantized:
    """A ``dequant`` node's value, kept as its ``(int8, scale[row])``
    pair.  Its consumer is an identity shortcut (ResNet's c-conv,
    MobileNetV2's projection), which the conv epilogue adds as
    ``fma(q, scale, y)`` — the rounding XLA's fused lowering gives
    ``y + q * scale`` — and which reads int8 codes instead of an f32
    map."""

    q: torch.Tensor
    s: torch.Tensor

    def f32(self) -> torch.Tensor:
        return self.q.float() * _row_scale(self.s)


def _f32(v):
    return v.f32() if isinstance(v, Dequantized) else v


def _unit_fn(nodes, sparsity_groups=None):
    """Compile one unit segment into ``fn(params, carry) -> carry`` (or
    ``(carry, aux)`` when profiled).

    Nodes execute in the segment's (topological) order over a value
    environment; a reference to a name produced in an EARLIER unit
    resolves to the incoming carry — the cut rule guarantees exactly one
    such value exists.  With ``sparsity_groups``, every ReLU-output conv
    emits its zero-count dict under the node's name; carries are the
    same bits either way.
    """
    g = sparsity_groups
    profiled = g is not None

    def fn(p, carry):
        env, aux = {}, {}

        def val(name):
            return env[name] if name in env else carry

        out = carry
        for n in nodes:
            if n.op == "input":
                out = carry
            elif n.op == "quant":
                out = act_quant(_f32(val(n.inputs[0])), per_row=True)
            elif n.op == "dequant":
                out = Dequantized(*val(n.inputs[0]))
            elif n.op in ("conv", "dwconv"):
                q, s = val(n.inputs[0])
                sc = None if n.shortcut is None else val(n.shortcut)
                if isinstance(sc, Dequantized):
                    sc = (sc.q, sc.s)
                w = p[n.name]
                zc = g if (profiled and n.relu) else None
                out = apply_conv(w["w"], q, s, gamma=w["scale"],
                                 beta=w["bias"], shortcut=sc, relu=n.relu,
                                 quant_out=n.quant_out, zero_count=zc)
                if zc is not None:
                    aux[n.name] = out[-1]
                    out = out[0] if not n.quant_out else (out[0], out[1])
            elif n.op == "pool":
                out = _max_pool_same(_f32(val(n.inputs[0])), n.k, n.stride)
            elif n.op == "head":
                q, s = val(n.inputs[0])
                # per_row: the head's input quantization must not couple
                # rows either
                out = apply_linear(p[n.name]["w"], _head_pool(q, s),
                                   per_row=True)
            env[n.name] = out
        return (out, aux) if profiled else out

    return fn


def compile_graph(graph: Graph, params,
                  sparsity_groups: int | None = None) -> list:
    """The compiled forward of a conv-DAG as an ordered ``PipelineUnit``
    list.  Each unit's ``params`` maps its nodes' names to their param
    subtrees (so a stage holds exactly its own constant weights), and
    ``block_id`` is the unit's index into ``graph.blocks()`` (head -1).
    ``sparsity_groups`` opts every ReLU-output conv into activation-
    sparsity profiling: unit fns then return ``(carry, {node: aux})``."""
    units = []
    segs = graph.units()
    for j, (uname, seg) in enumerate(segs):
        sub = {n.name: _subtree(params, n.path) for n in seg if n.path}
        bid = -1 if j == len(segs) - 1 else j
        units.append(PipelineUnit(uname, bid, sub,
                                  _unit_fn(seg, sparsity_groups)))
    return units


def apply_graph(graph: Graph, params, x: torch.Tensor) -> torch.Tensor:
    """Single-device compiled forward: run every unit in order."""
    carry = x
    for u in compile_graph(graph, params):
        carry = u.fn(u.params, carry)
    return carry
