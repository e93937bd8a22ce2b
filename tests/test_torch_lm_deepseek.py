"""Port parity of DeepSeek-V2-Lite-16B (``configs/deepseek_v2_lite_16b.py``)
at ``reduced()`` (4 layers, d 128, 4 heads; MLA with kv_lora 64, qk
32 + 16, v 32; layer 0 a dense FFN of width 256, the other three an MoE
of 8 experts of width 64, top-2, beside 2 shared experts; an untied
head) against the jitted JAX engine, in ``dense`` and ``int8`` here and
``sparse_cfmm`` in tests/test_torch_lm_deepseek_sparse.py
(tests/_torch_lm_parity.py).  Prefills run MLA's
expanded path (the flash attention at D = 48, Dv = 32), decode steps its
absorbed path on the latent cache.

``MoEParity`` replays JAX's routing into the port (``RoutingTape``) and
holds every pick the port would have made otherwise to a near-tie
(``FLIP_MARGIN``), and ``forward_train``'s aux to JAX's.  The untied
head's logits are held to ``UNTIED_BOUNDS``: 0.06 in ``dense``, 0.25 in
the compiled modes.

The port's engine takes JAX's greedy tokens (``FORCE_TOKENS``), so every
prefill and decode call is compared, the picks apart counted under the
bound's margin.  Beyond it: the grouping (at the published depth the
dense layer 0 in the prefix, the MoE layers in one stacked template,
latent cache leaves ``(B, S, kv_lora)`` and ``(layers, B, S, kv_lora)``
and a slot merged into them), and one slot of the port's engine in
``dense``, at JAX's loose capacity, against ``forward_train`` of each
request's whole sequence.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_lm_parity import UNTIED_BOUNDS, MoEParity, requests
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serving import engine as teng


class DeepSeekParity(MoEParity):
    ARCH = "deepseek_v2_lite_16b"
    BOUND = UNTIED_BOUNDS
    # JAX's greedy tokens, taken by the port's engine at every call: run
    # free, the first prefill in sparse_cfmm picks apart at JAX's margin
    # 0.078 (two logits of std 0.74; jax 0.9.0), within the compiled
    # bound, and the decode steps after it would see other tokens and go
    # uncompared.  Forced, every prefill and decode call is compared.
    FORCE_TOKENS = True


class TestDeepSeek(DeepSeekParity):
    # sparse_cfmm runs in tests/test_torch_lm_deepseek_sparse.py: JAX's
    # eager sparse_cfmm compile of the reduced tree (~19 s) and its three
    # jitted engine programs (~20 s) would take this file past a minute
    MODES = ("dense", "int8")

    def test_reduced_is_mla_moe_with_a_dense_first_layer(self):
        jcfg, tcfg = self.configs()
        assert tcfg.mla.kv_lora == 64 and tcfg.head_dim == 48
        assert tcfg.moe.n_experts == 8 and tcfg.moe.top_k == 2
        assert tcfg.moe.n_shared == 2 and not tcfg.tie_embeddings
        assert [s["moe"] for s in tcfg.layer_sigs()] == [False] + [True] * 3
        full = tget_config(self.ARCH)
        assert (full.mla.kv_lora, full.mla.qk_nope, full.mla.qk_rope,
                full.mla.v_dim) == (512, 128, 64, 128)
        assert (full.moe.n_experts, full.moe.top_k, full.moe.d_ff_expert,
                full.moe.n_shared) == (64, 6, 1408, 2)

    def test_tree_and_latent_cache_layout(self, served_trees):
        """At ``reduced()`` the four layers group as one period of four
        (JAX's grouping too): layer 0 an MLA mixer and a dense FFN of
        width ``d_ff``, the others MoE layers with shared experts.  At the
        published depth the dense layer 0 is the prefix and the 26 MoE
        layers one stacked template, whose latent cache leaves are
        ``(26, B, S, kv_lora)`` beside the prefix's ``(B, S, kv_lora)``;
        a slot's batch-1 cache merges into them row by row."""
        _, tcfg = self.configs()
        _, tt = served_trees("dense")
        m = tcfg.mla
        assert tlm.group_layers(tcfg.layer_sigs()) == (0, 4, 1, 0)
        dense0, moe1 = tt["template"][0], tt["template"][1]
        assert set(dense0["mixer"]) == {"q", "kv_down", "kv_norm", "k_up",
                                        "v_up", "o"}
        assert tuple(dense0["ffn"]["up"].value.shape) == (1, 128, tcfg.d_ff)
        assert tuple(moe1["mixer"]["kv_down"].value.shape) == \
            (1, 128, m.kv_lora + m.qk_rope)
        assert tuple(moe1["ffn"]["experts"]["up"].value.shape) == \
            (1, 8, 128, 64)
        assert tuple(moe1["ffn"]["shared"]["up"].value.shape) == \
            (1, 128, 128)

        full = tget_config(self.ARCH)
        assert tlm.group_layers(full.layer_sigs()) == (1, 1, 26, 0)
        batch = tnn.unbox(tlm.cache_init(full, 4, 16))
        assert set(batch["prefix"][0]) == {"c_kv", "k_rope", "length"}
        assert tuple(batch["prefix"][0]["c_kv"].shape) == (4, 16, 512)
        assert tuple(batch["template"][0]["c_kv"].shape) == (26, 4, 16, 512)
        assert tuple(batch["template"][0]["k_rope"].shape) == (26, 4, 16, 64)
        one = tnn.unbox(tlm.cache_init(full, 1, 16))
        g = torch.Generator().manual_seed(5)
        for c in (one["prefix"][0], one["template"][0]):
            for key in ("c_kv", "k_rope"):
                c[key].copy_(torch.randn(c[key].shape, generator=g))
            c["length"] = torch.full_like(c["length"], 9)
        teng._merge_slot_cache(batch, one, 2)
        for c, o in ((batch["prefix"][0], one["prefix"][0]),
                     (batch["template"][0], one["template"][0])):
            for key in ("c_kv", "k_rope"):
                rows = c[key][..., 2, :, :]
                assert torch.equal(rows, o[key][..., 0, :, :])
                assert not c[key][..., 3, :, :].any()
            assert bool((c["length"] == 9).all())

    def test_engine_decode_matches_full_forward(self, served_trees,
                                                monkeypatch):
        """One slot of the port's engine in ``dense`` (bucketed prefills,
        then decode steps on the absorbed path) against ``forward_train``
        of each request's prompt and tokens, MoE at JAX's loose capacity
        (no pick dropped in either): every served logit within 0.06 of
        max |logit|, and the greedy tokens equal wherever the full
        forward's margin exceeds 0.05 of it (JAX's test_decode.py rule)."""
        monkeypatch.setattr(tmoe, "moe_forward", functools.partial(
            tmoe.moe_forward, capacity_factor=16.0))
        _, tcfg = self.configs()
        params = tnn.unbox(served_trees("dense")[1])
        calls = []
        for name in ("forward_prefill", "forward_decode"):
            def rec(*a, _f=getattr(tlm, name), **kw):
                logits, nc = _f(*a, **kw)
                calls.append(logits[0, -1].float())
                return logits, nc
            monkeypatch.setattr(tlm, name, rec)
        eng = teng.ServingEngine(tcfg, params, mode="dense", batch_slots=1,
                                 max_seq=32, device="cpu")
        reqs = eng.run(requests(tcfg.vocab, teng.Request, (5, 13), 4))
        assert len(calls) == 2 * 4
        for i, r in enumerate(reqs):
            seq = torch.tensor([r.prompt + r.tokens_out[:-1]])
            full, aux = tlm.forward_train(params, {"tokens": seq}, tcfg)
            assert float(aux["dropped_frac"]) == 0.0
            ref = full[0, len(r.prompt) - 1:].float()
            got = torch.stack(calls[4 * i:4 * i + 4])
            scale = float(ref.abs().max())
            assert float((got - ref).abs().max()) / scale < 0.06, i
            top2 = torch.topk(ref, 2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]) / scale
            served = torch.tensor(r.tokens_out)
            assert torch.equal(served, got.argmax(-1))
            disagree = served != ref.argmax(-1)
            assert not bool((disagree & (margin > 0.05)).any()), i
