"""SmolLM-360M at its published full width (32 layers, d 960, 15 heads
over 5 KV heads, vocab 49152): the port's CPU ``ServingEngine`` against
the JAX package's jitted engine, one slot, prompts of 37 and 300 tokens
(buckets 64 and 512), 3 new tokens each, ``max_seq`` 320, every call's
last-position logits compared (tests/_torch_lm_parity.py), in ``dense``
and ``int8``.  In ``int8`` the JAX engine serves the port's compiled
tree, leaf for leaf (tests/test_torch_lm.py holds SmolLM's two compiles
byte-equal; JAX's eager compile of the full tree costs seconds per
leaf).  ``sparse_cfmm`` stays out: JAX's compile of it alone takes
minutes at this size.

Bounds (logits of std 0.545): measured max |dlogit| 0.043 in ``dense``
and 0.154 in ``int8`` (jax 0.9.0), inside the reference's own spread
(JAX jitted against eager differs by 0.039 and 0.121 on the same
prefill; ROADMAP queue C).  Held to 0.06 (1.4x) and 0.25 (1.6x), the
bounds of the reduced configs' dense and untied compiled modes; greedy
tokens equal wherever JAX's margin exceeds twice the bound.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_lm_parity import (check_run, jget_config, run_engines, tcl,
                              tget_config, tnn)
from repro import nn as jnn
from repro.models import lm as jlm

ARCH = "smollm_360m"
PROMPTS, SLOTS, MAX_SEQ, MAX_NEW = (37, 300), 1, 320, 3
BOUND = {"dense": 0.06, "int8": 0.25}


@pytest.fixture(scope="module", autouse=True)
def _jnp_lowering_one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "jnp")
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    jcfg = jget_config(ARCH)
    jt = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, tget_config(ARCH), jt, tnn.params_from_numpy(jt)


@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_full_width_engine_matches_jitted_jax(trees, mode):
    jcfg, tcfg, jt, tt = trees
    assert (tcfg.n_layers, tcfg.d_model, tcfg.vocab) == (32, 960, 49152)
    if mode != "dense":
        tt = tcl.compile_params(tt, mode=mode)
        jt = tnn.tree_map(lambda p: jnn.Param(jnp.asarray(p.value.numpy()),
                                              p.axes, p.kind), tt,
                          is_leaf=lambda x: isinstance(x, tnn.Param))
    run = run_engines(jcfg, tcfg, jt, tt, mode, PROMPTS, SLOTS, MAX_SEQ,
                      MAX_NEW)
    check_run(run, len(PROMPTS), MAX_NEW, BOUND[mode], (ARCH, mode))
