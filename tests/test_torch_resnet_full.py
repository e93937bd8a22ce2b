"""ResNet50 at full width and 224 px (the paper's network as served):
the port's CPU ``reference_logits`` against the JAX package's jitted one,
bit for bit (bound 0), in ``int8`` (5 images at microbatch 2: two full
microbatches and a 1-row one) and ``sparse_cfmm`` (2 images).

JAX initialises the weights; the port compiles them, and the JAX side is
fed the port's compiled tree leaf for leaf (``test_torch_resnet._to_jax``;
tests/test_torch_compile.py holds the two compiles byte-equal).  At
224 px the head pools a 7x7 map: the port's sequential FMA order matches
XLA's there (ROADMAP queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet as jres
from repro.serving import pipeline as jpipe
from repro_torch import nn as tnn
from repro_torch.core import compiled_linear as tcl
from repro_torch.models import resnet as tres
from repro_torch.serving import pipeline as tpipe
from test_torch_resnet import _to_jax

JCFG = jres.ResNetConfig()
TCFG = tres.ResNetConfig()
LOGIT_BOUND = 0.0


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
def port_tree():
    jax_tree = jax.jit(jres.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                    JCFG)
    return tnn.params_from_numpy(jax_tree)


@pytest.mark.parametrize("mode,n_images", [("int8", 5), ("sparse_cfmm", 2)])
def test_full_width_logits_equal_jax(port_tree, mode, n_images):
    assert (TCFG.width_mult, TCFG.in_hw, TCFG.num_classes) == (1.0, 224,
                                                               1000)
    x = np.random.RandomState(11).randn(n_images, 224, 224, 3).astype(
        np.float32)
    compiled = tcl.ensure_compiled(port_tree, mode, 0.8)
    got = tpipe.reference_logits(compiled, TCFG, torch.from_numpy(x), 2)
    want = np.asarray(jpipe.reference_logits(_to_jax(compiled), JCFG,
                                             jnp.asarray(x), 2))
    assert got.shape == (n_images, 1000)
    d = float(np.abs(got.numpy() - want).max())
    assert d <= LOGIT_BOUND, (mode, d)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    assert float(np.abs(want).max()) > 0
