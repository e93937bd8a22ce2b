"""Port parity of Jamba-v0.1 (``configs/jamba_v01_52b.py``) at
``reduced()``: one period of 8 layers (Mamba at layers 0-3 and 5-7,
attention at layer 4 with 4 heads over 1 KV head of 32; every second
layer an MoE of 8 experts of width 64, top-2; d 128, d_inner 256,
d_state 8, dt_rank 8; an untied head) against the jitted JAX engine, in
``dense`` and ``int8`` here and ``sparse_cfmm`` in
tests/test_torch_lm_jamba_sparse.py (tests/_torch_lm_parity.py).

``MoEParity`` replays JAX's routing into the port (``RoutingTape``) and
holds every pick the port would have made otherwise to a near-tie
(``FLIP_MARGINS``), and ``forward_train``'s aux to JAX's.  Both engines
prefill a recurrent stack at exact length; the port's engine takes JAX's
greedy tokens (``FORCE_TOKENS``), so every call is compared.

The port initialises the weights and JAX takes them through numpy
(``PORT_INIT``).  Bounds, looser than ``UNTIED_BOUNDS`` (0.06 / 0.25), as
RWKV6's (tests/test_torch_lm_rwkv6.py): measured max |dlogit| (jax
0.9.0, logits of std 0.68-0.95) ``dense`` 0.125, ``int8`` 0.335,
``sparse_cfmm`` 0.444 on JAX's routing replayed; JAX's jitted prefill
against its eager one reads 0.077-0.209 in ``dense`` and 0.34 in
``sparse_cfmm`` on 13- and 37-token prompts (its own routing; in
``int8`` a turned pick takes it past 1).  Held at 1.6x (``dense``),
1.5x (``int8``) and 1.35x (``sparse_cfmm``: 0.6) the largest reading.
The shared length counter of the attention layer (ROADMAP queue C) is
mirrored: the shorter slot's decode reads the rows up to the longer
slot's length.
"""
import numpy as np
import torch

from _torch_lm_parity import FLIP_MARGIN, MoEParity
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng


class JambaParity(MoEParity):
    ARCH = "jamba_v01_52b"
    PROMPTS = (5, 37)
    SLOTS, MAX_SEQ, MAX_NEW = 2, 48, 3
    FORCE_TOKENS = True
    PORT_INIT = True
    BOUND = {"dense": 0.2, "int8": 0.5, "sparse_cfmm": 0.6}
    # Mamba layers between the MoE layers carry the compiled modes' spread
    # into the router: measured (jax 0.9.0) turned picks at JAX margins up
    # to 0.0019 in dense, 0.0078 in int8 and 0.0075 in sparse_cfmm (OLMoE
    # and DeepSeek: 0.0012 and 0.0020 at most); the compiled modes held
    # with 2.5x headroom
    FLIP_MARGINS = {"dense": FLIP_MARGIN, "int8": 0.02, "sparse_cfmm": 0.02}


class TestJamba(JambaParity):
    MODES = ("dense", "int8")

    def test_reduced_is_one_period(self):
        cfg = self.configs()[1]
        sigs = cfg.layer_sigs()
        assert [s["kind"] for s in sigs] == ["mamba"] * 4 + ["attn"] + \
            ["mamba"] * 3
        assert [s["moe"] for s in sigs] == [False, True] * 4
        assert tlm.group_layers(sigs) == (0, 8, 1, 0)
        assert cfg.n_kv_heads == 1 and not cfg.tie_embeddings
        full = tget_config(self.ARCH)
        assert tlm.group_layers(full.layer_sigs()) == (0, 8, 4, 0)
        assert (full.ssm.d_inner, full.ssm.d_state, full.ssm.d_conv,
                full.ssm.dt_rank) == (8192, 16, 4, 256)

    def test_slot_merge_writes_recurrent_rows(self, served_trees):
        """``_merge_slot_cache`` on the stacked ``(1, slots, ...)``
        recurrent leaves of one period (and RWKV's ``(4, slots, ...)``):
        slot 1's rows take the batch-1 prefill's state, slot 0's stay."""
        for arch, tree in ((self.ARCH, tnn.unbox(served_trees("dense")[1])),
                           ("rwkv6_7b", None)):
            cfg = tget_config(arch).reduced()
            if tree is None:
                tree = tnn.unbox(tlm.init(torch.Generator().manual_seed(0),
                                          cfg))
            full = tnn.unbox(tlm.cache_init(cfg, 3, 16))
            before = {k: v.clone() for k, v in _recurrent(full).items()}
            toks = torch.from_numpy(np.random.RandomState(1).randint(
                1, cfg.vocab, (1, 9)))
            _, one = tlm.forward_prefill(tree, {"tokens": toks}, cfg,
                                         tnn.unbox(tlm.cache_init(cfg, 1,
                                                                  16)))
            teng._merge_slot_cache(full, one, 1)
            after, new = _recurrent(full), _recurrent(one)
            assert after and after.keys() == new.keys()
            for k, v in after.items():
                assert v.shape[0] == new[k].shape[0] and v.shape[1] == 3, k
                assert torch.equal(v[:, 1], new[k][:, 0].to(v.dtype)), k
                assert torch.equal(v[:, 0], before[k][:, 0]), k
                assert torch.equal(v[:, 2], before[k][:, 2]), k
                assert bool(new[k].ne(0).any()), k


def _recurrent(cache):
    """path -> stacked recurrent leaf (``conv``, ``ssm``, ``shift``,
    ``wkv``, ``cm``) of a cache's template."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        elif path.rsplit("/", 1)[-1] in ("conv", "ssm", "shift", "wkv",
                                         "cm"):
            out[path] = t
    walk(cache["template"], "")
    return out
