"""Port parity of OLMoE-1B-7B (``configs/olmoe_1b_7b.py``) at
``reduced()`` (4 layers, d 128, 4 heads over 4 KV heads of 32, qk-norm,
an untied head, every FFN an MoE of 8 experts of width 64, top-2)
against the jitted JAX engine, in ``dense``, ``int8`` and
``sparse_cfmm`` (tests/_torch_lm_parity.py).  The untied head's logits
(std 0.7-0.9) are held to ``UNTIED_BOUNDS``: 0.06 in ``dense``, 0.25 in
the compiled modes.

Eight experts whose router logits have a std of about 0.2 put many
tokens near a routing tie, and one bf16 rounding upstream turns some of
them: run free, a flipped pick moves the next logits by up to 1.9.  So
the engine runs replay JAX's routing into the port (``RoutingTape``: the
picks recorded inside JAX's jitted forwards), and the logits compare the
arithmetic: measured max |dlogit| 0.039 / 0.109 / 0.074 (jax 0.9.0).
Every pick the port would have made otherwise, at a token that reaches a
compared logit, is counted and held to a near-tie: JAX's own margin there
under ``FLIP_MARGIN``.

Beyond ``LMParity`` (``MoEParity``, tests/_torch_lm_parity.py, holds the
replay, the flips and ``forward_train``'s aux: ``lb_loss``, ``z_loss``,
``dropped_frac`` summed over the layers, against JAX's): a
``moe_pattern=(False, True)`` stack, whose template mixes a dense and an
MoE layer, grouped as JAX groups it and served within the bound.
"""
import pytest

from _torch_lm_parity import (FLIP_MARGIN, UNTIED_BOUNDS, MoEParity,
                              RoutingTape, check_run, flat_jax, flat_port,
                              run_engines)
from repro.models import lm as jlm
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import lm as tlm


class TestOLMoE(MoEParity):
    ARCH = "olmoe_1b_7b"
    BOUND = UNTIED_BOUNDS

    def test_reduced_is_moe_with_qk_norm(self):
        jcfg, tcfg = self.configs()
        assert tcfg.moe.n_experts == 8 and tcfg.moe.top_k == 2
        assert tcfg.qk_norm and not tcfg.tie_embeddings
        assert all(s["moe"] for s in tcfg.layer_sigs())
        m = tget_config(self.ARCH).moe
        assert (m.n_experts, m.top_k, m.d_ff_expert) == (64, 8, 1024)

    @pytest.fixture(scope="class")
    def mixed(self):
        """A ``moe_pattern=(False, True)`` stack: (JAX cfg, port cfg, JAX
        tree, port tree)."""
        jcfg, tcfg = self.configs(moe_pattern=(False, True))
        return (jcfg, tcfg) + self.init_trees(jcfg)

    def test_moe_pattern_mix_groups_and_serves(self, mixed):
        jcfg, tcfg, jt, tt = mixed
        sigs = tcfg.layer_sigs()
        assert [s["moe"] for s in sigs] == [False, True, False, True]
        assert tlm.group_layers(sigs) == jlm.group_layers(sigs) == \
            (0, 2, 2, 0)
        assert "router" not in tt["template"][0]["ffn"]
        assert tt["template"][1]["ffn"]["experts"]["up"].axes == \
            ("layers", "experts_stack", "embed", "ffn_in")
        assert flat_jax(jt).keys() == flat_port(tt).keys()
        tape = RoutingTape()
        with tape.record_jax(), tape.replay_port():
            run = run_engines(jcfg, tcfg, jt, tt, "dense", self.PROMPTS,
                              self.SLOTS, self.MAX_SEQ, self.MAX_NEW)
        assert len(tape.jax) == len(run["calls"]) * 2
        assert all(m <= FLIP_MARGIN
                   for _, _, m in tape.flips(run["calls"], self.PROMPTS))
        check_run(run, len(self.PROMPTS), self.MAX_NEW, self.BOUND["dense"],
                  "moe_pattern=(False, True)")
