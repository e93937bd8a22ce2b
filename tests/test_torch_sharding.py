"""The port's logical-axis sharding (``repro_torch/distributed/
sharding.py``, ``launch/mesh.py``) against the JAX package's.

* JAX's three unit tests: the divisibility guard, the uniqueness guard,
  and a mesh of size-1 axes replicating everything (a shape-only mesh,
  and a one-process gloo ``DeviceMesh``).
* Full-size spec parity: for every leaf of every architecture's tree —
  the f32 parameters, the serve trees in ``dense``, ``int8`` and
  ``sparse_cfmm``, the bf16 and int8 KV caches at both decode shapes —
  the port's meta tree has JAX's ``jax.eval_shape`` shape, dtype and
  logical axes, and gets JAX's spec under each of the five rule tables
  on both production meshes and the 2 x 2 debug mesh (JAX's side on an
  ``AbstractMesh`` of that shape).
* ``input_specs`` and ``batch_shardings`` equal JAX's for every cell.
* Four gloo processes on a 2 x 2 CPU mesh distribute a ``reduced()``
  SmolLM tree under ``TRAIN_RULES``: each rank's local shard is the
  slice JAX's spec names for its device (major to minor), and
  ``full_tensor()`` gives the tree back to the bit; ``shard`` moves a
  DTensor to its spec's placements only under an active mesh, and
  ``batch_shardings``' spec gives its placements on a ``DeviceMesh``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate

from repro import nn as jnn
from repro.configs import base as jbase
from repro.core.compiled_linear import compile_params as jcompile
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro_torch import nn as tnn
from repro_torch.configs import base as tbase
from repro_torch.core.compiled_linear import compile_params as tcompile
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm

from _torch_dist import run_ranks

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
TREES = ("params", "dense", "int8", "sparse_cfmm", "cache_bf16",
         "cache_int8")
# the decode shapes' (B, S): the batch and sequence decide divisibility
CACHE_SHAPES = ((128, 32768), (1, 524288))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def test_spec_divisibility_guard():
    mesh = tmesh.ShapeMesh((16, 16), ("data", "model"))
    spec = tshd.spec_for(("embed", "heads_q"), (960, 960), tshd.TRAIN_RULES,
                         mesh)
    assert spec == ("data", "model")   # 960 % 16 == 0: both shard
    # truly indivisible out dim is dropped (replicated)
    spec = tshd.spec_for(("embed", "heads_q"), (960, 15 * 66),
                         tshd.TRAIN_RULES, mesh)
    assert spec == ("data",)
    # dp_only folds both mesh axes onto the batch/in dims
    spec = tshd.spec_for(("embed", "heads_q"), (1024, 512),
                         tshd.DP_ONLY_TRAIN_RULES, FakeMesh(mesh.shape))
    assert spec == (("data", "model"),)


def test_spec_uniqueness_guard():
    mesh = tmesh.ShapeMesh((16, 16), ("data", "model"))
    spec = tshd.spec_for(("experts_stack", "embed", "ffn_in"),
                         (64, 2048, 1024), tshd.TRAIN_RULES, mesh)
    # experts take 'model'; ffn_in must NOT reuse it
    assert spec == ("model", "data")


def test_param_shardings_tree(tmp_path):
    """Axes of size 1 -> everything replicated: a spec of () on a
    shape-only 1 x 1 mesh and on a live one, whose placements are
    Replicate() on both dims."""
    tree = {"w": tnn.Param(torch.zeros((64, 32)), ("embed", "ffn_in"),
                           "linear")}
    assert tshd.param_shardings(
        tree, tmesh.ShapeMesh((1, 1), ("data", "model")))["w"] == ()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_debug_mesh((1, 1))
        spec = tshd.param_shardings(tree, mesh)["w"]
        assert spec == ()
        assert tshd.placements_of(spec, mesh) == [Replicate()] * 2
    finally:
        dist.destroy_process_group()


def test_production_mesh_shapes():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.size, single.axis_names) == (
        {"data": 16, "model": 16}, 256, ("data", "model"))
    assert (multi.shape, multi.size, multi.axis_names) == (
        {"pod": 2, "data": 16, "model": 16}, 512, ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Full-size spec parity
# ---------------------------------------------------------------------------

def _s_enc(cfg):
    return 1500 if cfg.encoder_decoder else None


@functools.lru_cache(maxsize=None)
def jax_tree(arch, kind, B=None, S=None):
    cfg = jbase.get_config(arch)
    if kind == "params":
        return jax.eval_shape(functools.partial(jlm.init, cfg=cfg),
                              jax.random.PRNGKey(0))
    if kind.startswith("cache"):
        return jax.eval_shape(functools.partial(
            jlm.cache_init, cfg, B, S, S_enc=_s_enc(cfg),
            kv_dtype=jnp.int8 if kind == "cache_int8" else None))
    return jax.eval_shape(functools.partial(jcompile, mode=kind),
                          jax_tree(arch, "params"))


@functools.lru_cache(maxsize=None)
def port_tree(arch, kind, B=None, S=None):
    cfg = tbase.get_config(arch)
    if kind == "params":
        return tlm.init(tnn.SHAPE_ONLY, cfg)
    if kind.startswith("cache"):
        return tlm.cache_init(cfg, B, S, S_enc=_s_enc(cfg),
                              kv_dtype=torch.int8 if kind == "cache_int8"
                              else None, device="meta")
    return tcompile(port_tree(arch, "params"), mode=kind)


def flat_jax(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, (jnn.Param, jax.sharding.NamedSharding)))[0]}


def flat_port(tree, other=None, path=""):
    """{JAX keystr path: (Param, the same path in ``other``)} over the
    port's Param leaves."""
    if isinstance(tree, tnn.Param):
        return {path: (tree, other)}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_port(v, None if other is None else other[k],
                                 f"{path}['{k}']"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_port(v, None if other is None else other[i],
                                 f"{path}[{i}]"))
    return out


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _trees(arch, kind):
    shapes = CACHE_SHAPES if kind.startswith("cache") else ((None, None),)
    return [(jax_tree(arch, kind, B, S), port_tree(arch, kind, B, S))
            for B, S in shapes]


@pytest.mark.parametrize("kind", TREES)
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_full_size_specs_equal_jax(arch, kind):
    for jt, tt in _trees(arch, kind):
        jl, tl = flat_jax(jt), flat_port(tt)
        assert jl.keys() == tl.keys()
        for path, (p, _) in tl.items():
            j = jl[path]
            assert p.value.device.type == "meta" or path.endswith(
                ("['length']", "['pos']")), path   # the host counters
            assert (tuple(p.value.shape), _dtype_name(p.value.dtype),
                    tuple(p.axes)) == (tuple(j.value.shape),
                                       str(j.value.dtype), tuple(j.axes)), \
                path
        for mname, (shape, axes) in MESHES.items():
            amesh = AbstractMesh(shape, axes)
            smesh = tmesh.ShapeMesh(shape, axes)
            for rname in tshd.RULES_BY_NAME:
                js = flat_jax(jshd.param_shardings(
                    jt, amesh, jshd.RULES_BY_NAME[rname]))
                ts = flat_port(tt, tshd.param_shardings(
                    tt, smesh, tshd.RULES_BY_NAME[rname]))
                for path, (_, spec) in ts.items():
                    assert spec == tuple(js[path].spec), (mname, rname, path)


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_input_specs_and_batch_shardings_equal_jax(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    assert tuple(tbase.SHAPES) == tuple(jbase.SHAPES)
    for shape_name in tbase.SHAPES:
        assert tbase.SHAPES[shape_name] == jbase.SHAPES[shape_name]
        assert tbase.cell_applicable(tcfg, shape_name) == \
            jbase.cell_applicable(jcfg, shape_name)
        jb = jbase.input_specs(jcfg, shape_name)
        tb = tbase.input_specs(tcfg, shape_name)
        assert list(tb) == list(jb)
        for k, t in tb.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype_name(t.dtype)) == (
                tuple(jb[k].shape), str(jb[k].dtype)), (shape_name, k)
        for shape, axes in MESHES.values():
            for dp_axes in (("pod", "data"), ("pod", "data", "model")):
                js = jshd.batch_shardings(jb, AbstractMesh(shape, axes),
                                          dp_axes)
                ts = tshd.batch_shardings(tb, tmesh.ShapeMesh(shape, axes),
                                          dp_axes)
                assert {k: tuple(v.spec) for k, v in js.items()} == ts, \
                    (shape_name, shape, dp_axes)


def test_all_configs_are_the_registry():
    cfgs = tbase.all_configs()
    assert tuple(cfgs) == tbase.ARCH_IDS == jbase.ARCH_IDS
    assert all(c.name == jbase.get_config(a).name for a, c in cfgs.items())


# ---------------------------------------------------------------------------
# Four gloo processes on a 2 x 2 mesh
# ---------------------------------------------------------------------------

DISTRIBUTE = """
import torch
from _torch_dist import init_group
rank, world, shared = init_group()
from repro_torch import nn
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm

params = lm.init(torch.Generator().manual_seed(0),
                 get_config("smollm_360m").reduced())
mesh = make_debug_mesh((2, 2))
out = shd.distribute_params(params, mesh, shd.TRAIN_RULES)
local, exact = {}, 0
for (path, p), (_, d) in zip(nn.tree_flatten_with_path(params),
                             nn.tree_flatten_with_path(out), strict=True):
    key = "/".join(map(str, path))
    local[key] = d.value.to_local().clone()
    exact += torch.equal(d.value.full_tensor(), p.value)
torch.save({"coord": mesh.get_coordinate(), "local": local},
           shared / f"rank{rank}.pt")
print("EXACT", exact, len(local))

# shard(): a DTensor takes the spec's placements under an active mesh; a
# plain tensor passes, and without a mesh nothing moves
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
x = distribute_tensor(torch.arange(4 * 6 * 8.0).reshape(4, 6, 8), mesh,
                      [Replicate(), Replicate()])
plain = torch.zeros(4, 6, 8)
assert shd.shard(x, "batch", "seq", None) is x
with shd.use_mesh(mesh), shd.use_rules(shd.TRAIN_RULES):
    y = shd.shard(x, "batch", "seq", None)
    assert shd.shard(plain, "batch", "seq", None) is plain
assert list(y.placements) == [Shard(0), Replicate()], y.placements
assert torch.equal(y.full_tensor(), x.full_tensor())
assert torch.equal(y.to_local(), x.full_tensor()[2 * (rank // 2):][:2])
b = shd.batch_shardings({"tokens": torch.empty(4, 64, device="meta")}, mesh)
assert b == {"tokens": ("data", None)}, b
assert shd.placements_of(b["tokens"], mesh) == [Shard(0), Replicate()]
print("SHARD_OK")
"""


def _jax_slice(full: np.ndarray, spec: tuple, i: int, j: int) -> np.ndarray:
    """The block of ``full`` that JAX's ``spec`` gives device (i, j) of a
    2 x 2 ("data", "model") mesh, tuple entries major to minor."""
    coord, size = {"data": i, "model": j}, {"data": 2, "model": 2}
    out = full
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts = entry if isinstance(entry, tuple) else (entry,)
        idx, n = 0, 1
        for a in parts:
            idx, n = idx * size[a] + coord[a], n * size[a]
        step = full.shape[dim] // n
        out = np.take(out, range(idx * step, (idx + 1) * step), axis=dim)
    return out


def test_distribute_params_2x2_gloo(tmp_path):
    outs = run_ranks(DISTRIBUTE, 4, tmp_path)
    params = tlm.init(torch.Generator().manual_seed(0),
                      tbase.get_config("smollm_360m").reduced())
    leaves = {"/".join(map(str, path)): p for path, p in
              tnn.tree_flatten_with_path(params)}
    for out in outs:
        exact, n = map(int, out.split("EXACT")[1].split()[:2])
        assert exact == n == len(leaves)
        assert "SHARD_OK" in out
    mesh = FakeMesh({"data": 2, "model": 2})
    sharded = 0
    for r in range(4):
        got = torch.load(tmp_path / "shared" / f"rank{r}.pt")
        i, j = got["coord"]
        assert (i, j) == (r // 2, r % 2)
        for key, p in leaves.items():
            spec = tuple(jshd.spec_for(p.axes, tuple(p.value.shape),
                                       jshd.TRAIN_RULES, mesh))
            sharded += bool(spec)
            want = _jax_slice(p.value.numpy(), spec, i, j)
            np.testing.assert_array_equal(got["local"][key].numpy(), want,
                                          err_msg=f"rank {r} {key} {spec}")
    assert sharded > 0
