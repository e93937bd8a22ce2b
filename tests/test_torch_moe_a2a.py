"""The port's all_to_all MoE exchange (``repro_torch/distributed/
moe_a2a.py``) on four CPU gloo processes.

One run of four ranks on a 2 x 2 ("data", "model") mesh:
* JAX's case (E 8, d 16, T 32, K 2, experts y = x * (expert + 1)) at
  capacity factor 8.0 against the dense reference, within 1e-6 relative
  in f32, and at factor 1.0, where picks overflow their bins, against the
  dense reference over the picks the capacity rule keeps;
* both factors against JAX's own ``a2a_expert_exchange``, run in a
  subprocess over four host devices as ``tests/test_moe_a2a.py`` runs it:
  the outputs equal to the bit, so the same picks drop;
* at ep 1 (a 4 x 1 mesh: each rank its own expert group), a ``reduced()``
  OLMoE layer's experts through the exchange against ``moe_forward``'s
  expert path on the same picks and gates, ``dense`` and ``int8``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_dist import ROOT, run_ranks

E, D, T, K = 8, 16, 32, 2
CFS = (8.0, 1.0)
EP1_MODES = ("dense", "int8")
# the ep-1 layer: expert outputs of moe_forward's (E, cap, d) queues and
# of the exchange's (E, ep*cap, d) slots, in bf16 (measured 0 in both)
EP1_BOUND = {"dense": 0.0, "int8": 0.0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(T, D).astype(np.float32)
    logits = rng.randn(T, E).astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    gates = np.take_along_axis(probs, idx, -1)
    gates = (gates / gates.sum(-1, keepdims=True)).astype(np.float32)
    return x, idx.astype(np.int32), gates


def kept_picks(idx, cf, ep=2, n_ranks=4):
    """The capacity rule restated: each rank's (token, choice) picks in
    order fill their target shard's bin of ``cap`` slots."""
    E_loc, t_loc = E // ep, T // n_ranks
    cap = int(max(8, round(t_loc * K / E * cf * E_loc)))
    cap = -(-cap // 8) * 8
    keep = np.zeros(idx.shape, bool)
    for r in range(n_ranks):
        fill = [0] * ep
        for t in range(r * t_loc, (r + 1) * t_loc):
            for j in range(K):
                s = idx[t, j] // E_loc
                keep[t, j] = fill[s] < cap
                fill[s] += 1
    return keep


def dense_reference(x, idx, gates, keep):
    ref = np.zeros_like(x, dtype=np.float64)
    for t in range(T):
        for j in range(K):
            if keep[t, j]:
                ref[t] += float(gates[t, j]) * x[t] * (idx[t, j] + 1.0)
    return ref


JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.distributed.moe_a2a import a2a_expert_exchange

d = np.load(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
E_loc = {E} // 2

def experts_apply(x_e):
    i = jax.lax.axis_index("model")
    ids = i * E_loc + jnp.arange(E_loc, dtype=jnp.float32)
    return x_e * (ids + 1.0)[:, None, None]

out = {{}}
with mesh:
    xs = jax.device_put(jnp.asarray(d["x"]),
                        NamedSharding(mesh, P(("data", "model"))))
    for cf in {CFS}:
        out[f"cf{{cf}}"] = np.asarray(a2a_expert_exchange(
            xs, jnp.asarray(d["idx"]), jnp.asarray(d["gates"]),
            experts_apply, {E}, mesh, capacity_factor=cf))
np.savez(sys.argv[2], **out)
""".format(E=E, CFS=CFS)

PORT_SCRIPT = """
import numpy as np, torch
from _torch_dist import init_group
rank, world, shared = init_group()
from repro_torch import nn
from repro_torch.configs.base import get_config
from repro_torch.core.compiled_linear import compile_params
from repro_torch.distributed.moe_a2a import a2a_expert_exchange
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe
from repro_torch.models.layers import ffn

d = np.load(shared.parent / "inputs.npz")
E, CFS = {E}, {CFS}
mesh = make_debug_mesh((2, 2))
t_loc = d["x"].shape[0] // world
rows = slice(rank * t_loc, (rank + 1) * t_loc)
x, idx, gates = (torch.from_numpy(d[k][rows]) for k in ("x", "idx", "gates"))
E_loc = E // mesh["model"].size()
first = mesh.get_local_rank("model") * E_loc

def experts_apply(x_e):
    ids = first + torch.arange(E_loc, dtype=torch.float32)
    return x_e * (ids + 1.0)[:, None, None]

out = {{f"cf{{cf}}": a2a_expert_exchange(x, idx, gates, experts_apply, E,
                                       mesh, capacity_factor=cf).numpy()
       for cf in CFS}}

# ep 1: a reduced() OLMoE layer, each rank its own tokens and experts
mesh1 = make_debug_mesh((4, 1))
cfg = get_config("olmoe_1b_7b").reduced()
m = cfg.moe
layer = moe.moe_init(torch.Generator().manual_seed(0), cfg)
xb = torch.from_numpy(np.random.RandomState(10 + rank).randn(
    1, 16, cfg.d_model).astype(np.float32)).to(torch.bfloat16)
for mode in {MODES}:
    p = nn.unbox(compile_params(layer, mode))
    ref, _ = moe.moe_forward(p, xb, cfg, capacity_factor=16.0)
    xt = xb.reshape(-1, cfg.d_model)
    r = moe.route(xt, p["router"], m.top_k, 16.0)
    assert bool(r.keep.all())
    experts = nn.unstack(p["experts"], m.n_experts)
    got = a2a_expert_exchange(
        xt, r.expert_idx, r.gate_vals,
        lambda x_e: torch.stack([ffn(experts[e], x_e[e], act=m.act)
                                 for e in range(m.n_experts)]),
        m.n_experts, mesh1, capacity_factor=1.0)
    out[f"ep1_{{mode}}"] = (got.float() - ref.reshape(got.shape).float()
                           ).abs().max().numpy()
    out[f"ep1_{{mode}}_scale"] = ref.float().abs().max().numpy()
np.savez(shared / f"rank{{rank}}.npz", **out)
print("RANK_OK", rank)
""".format(E=E, CFS=CFS, MODES=EP1_MODES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("a2a")
    x, idx, gates = inputs()
    np.savez(tmp / "inputs.npz", x=x, idx=idx, gates=gates)
    jscript = tmp / "jax_a2a.py"
    jscript.write_text(JAX_SCRIPT)
    jax_proc = subprocess.Popen(
        [sys.executable, str(jscript), str(tmp / "inputs.npz"),
         str(tmp / "jax_out.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    try:
        run_ranks(PORT_SCRIPT, 4, tmp)
        jout, _ = jax_proc.communicate(timeout=240)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, jout[-3000:]
    ranks = [dict(np.load(tmp / "shared" / f"rank{r}.npz")) for r in range(4)]
    port = {f"cf{cf}": np.concatenate([r[f"cf{cf}"] for r in ranks])
            for cf in CFS}
    return {"port": port, "jax": dict(np.load(tmp / "jax_out.npz")),
            "ranks": ranks, "inputs": (x, idx, gates)}


@pytest.mark.parametrize("cf", CFS)
def test_a2a_matches_dense_reference(runs, cf):
    x, idx, gates = runs["inputs"]
    keep = kept_picks(idx, cf)
    assert keep.all() == (cf == 8.0)           # 1.0 drops picks
    ref = dense_reference(x, idx, gates, keep)
    err = np.abs(runs["port"][f"cf{cf}"] - ref).max() / np.abs(ref).max()
    assert err < 1e-6, err


@pytest.mark.parametrize("cf", CFS)
def test_a2a_equals_jax_a2a(runs, cf):
    np.testing.assert_array_equal(runs["port"][f"cf{cf}"],
                                  runs["jax"][f"cf{cf}"])


@pytest.mark.parametrize("mode", EP1_MODES)
def test_a2a_ep1_olmoe_layer_matches_moe_forward(runs, mode):
    for r in runs["ranks"]:
        assert float(r[f"ep1_{mode}_scale"]) > 0
        assert float(r[f"ep1_{mode}"]) <= EP1_BOUND[mode]
