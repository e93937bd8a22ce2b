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

Beyond ``LMParity``: ``forward_train``'s aux (``lb_loss``, ``z_loss``,
``dropped_frac`` summed over the layers) against JAX's, and a
``moe_pattern=(False, True)`` stack, whose template mixes a dense and an
MoE layer, grouped as JAX groups it and served within the bound.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import (MODES, UNTIED_BOUNDS, LMParity, check_run,
                              flat_jax, flat_port, run_engines)
from repro import nn as jnn
from repro.models import lm as jlm
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

# JAX's margin at a token whose picks the port, on JAX's routing so far,
# would make otherwise (``RoutingTape.flips``).  Measured (jax 0.9.0, the
# three modes' engine runs at reduced(), 8 experts whose router logits have
# a std of about 0.2, so probabilities near 1/8 sit close together): 3-9
# flips per mode among the tokens that reach a compared logit, margins
# 8.5e-5 to 1.23e-3.  Held with 4x headroom.
FLIP_MARGIN = 0.005
# forward_train's aux on JAX's routing: ``dropped_frac`` follows from the
# picks alone (1e-6: one f32 mean); ``lb_loss`` and ``z_loss`` read the
# router's probabilities and logits, whose inputs past the first layer
# carry the stack's bf16 spread: measured 9.4e-5 and 7.5e-5 relative,
# held to 1e-3.  At one input (tests/test_torch_moe.py) they hold 1e-5.
AUX_RTOL = {"dropped_frac": 1e-6, "lb_loss": 1e-3, "z_loss": 1e-3}


class RoutingTape:
    """JAX's routing picks, recorded inside its jitted forwards (an ordered
    debug callback on ``jax.lax.top_k``: one record per MoE layer and
    call, in order) and replayed into the port's ``moe.pick_experts``,
    which records its own picks beside them."""

    def __init__(self):
        self.jax, self.port = [], []

    @contextlib.contextmanager
    def record_jax(self):
        orig = jax.lax.top_k

        def rec(operand, k):
            vals, idx = orig(operand, k)
            jax.debug.callback(lambda o, i: self.jax.append(
                (np.asarray(o), np.asarray(i))), operand, idx, ordered=True)
            return vals, idx

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.lax, "top_k", rec)
            yield self

    @contextlib.contextmanager
    def replay_port(self):
        orig = tmoe.pick_experts

        def replay(probs, k):
            own = orig(probs, k)
            _, picks = self.jax[len(self.port)]
            assert picks.shape == tuple(own.shape)
            self.port.append(own.numpy().copy())
            return torch.from_numpy(picks.astype(np.int64))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmoe, "pick_experts", replay)
            yield self

    def flips(self, calls=None, prompts=None):
        """(record, token, JAX's margin) of every token whose own port
        picks differ from JAX's.  The margin is JAX's probability of its
        pick over that of the port's pick, at the first choice where they
        differ: how near JAX itself was to picking as the port did.

        Given an engine run's ``calls`` and its ``prompts``, only the
        tokens that reach a compared logit count: a prefill's first L
        rows (its pad rows queue behind them and attend to nothing
        real), a decode step's active rows, and no decode step after the
        greedy tokens part (``compare_calls``)."""
        assert len(self.port) == len(self.jax)
        per_call = len(self.jax) // len(calls) if calls else None
        lengths, parted, out = iter(prompts or ()), False, []
        real = {}
        for c, (kind, rows, jl, tl) in enumerate(calls or ()):
            if kind == "prefill":
                real[c] = set(range(next(lengths)))
            elif not parted:
                real[c] = set(rows)
            parted = parted or (kind == "decode" and any(
                np.argmax(jl[r]) != np.argmax(tl[r]) for r in rows))
        for i, ((probs, picks), own) in enumerate(zip(self.jax, self.port)):
            for t in np.nonzero((picks != own).any(-1))[0]:
                if calls and int(t) not in real.get(i // per_call, ()):
                    continue
                j = int(np.argmax(picks[t] != own[t]))
                out.append((i, int(t), float(probs[t, picks[t, j]]
                                             - probs[t, own[t, j]])))
        return out


class TestOLMoE(LMParity):
    ARCH = "olmoe_1b_7b"
    BOUND = UNTIED_BOUNDS

    @pytest.fixture(scope="class")
    def served(self, served_trees):
        """``LMParity.served`` with JAX's routing replayed into the port
        (``RoutingTape``): the runs make the same discrete choices, so
        the logits compare the arithmetic.  mode -> the run, with its
        tape under ``"tape"``."""
        runs = {}

        def get(mode):
            if mode not in runs:
                jcfg, tcfg = self.configs()
                tape = RoutingTape()
                with tape.record_jax(), tape.replay_port():
                    runs[mode] = run_engines(
                        jcfg, tcfg, *served_trees(mode), mode, self.PROMPTS,
                        self.SLOTS, self.MAX_SEQ, self.MAX_NEW)
                runs[mode]["tape"] = tape
            return runs[mode]
        return get

    def test_reduced_is_moe_with_qk_norm(self):
        jcfg, tcfg = self.configs()
        assert tcfg.moe.n_experts == 8 and tcfg.moe.top_k == 2
        assert tcfg.qk_norm and not tcfg.tie_embeddings
        assert all(s["moe"] for s in tcfg.layer_sigs())
        m = tget_config(self.ARCH).moe
        assert (m.n_experts, m.top_k, m.d_ff_expert) == (64, 8, 1024)

    @pytest.mark.parametrize("mode", MODES)
    def test_routing_flips_are_near_ties(self, served, mode):
        """Where the port, on JAX's routing so far, would pick otherwise
        than JAX, JAX's own margin at that token is under
        ``FLIP_MARGIN``: a near-tie that a bf16 rounding upstream turns.
        The flips are counted and named; none is hidden."""
        run = served(mode)
        tape = run["tape"]
        flips = tape.flips(run["calls"], self.PROMPTS)
        print(f"{mode}: {len(flips)} routing flips over "
              f"{len(tape.jax)} MoE layer calls; JAX margins "
              f"{sorted(round(m, 6) for _, _, m in flips)}")
        assert len(tape.jax) == len(run["calls"]) * 4
        assert all(m <= FLIP_MARGIN for _, _, m in flips), flips

    def test_forward_train_aux_matches_jax(self, served_trees):
        """The aux summed over the four MoE layers, on JAX's routing
        (replayed); the logits within the dense bound."""
        jcfg, tcfg = self.configs()
        jt, tt = served_trees("dense")
        toks = np.random.RandomState(4).randint(1, jcfg.vocab, (2, 24))
        tape = RoutingTape()
        with tape.record_jax():
            jl, jaux = jax.jit(lambda p, b: jlm.forward_train(p, b, jcfg))(
                jnn.unbox(jt), {"tokens": jnp.asarray(toks)})
            jax.effects_barrier()
        with tape.replay_port():
            tl, taux = tlm.forward_train(tnn.unbox(tt),
                                         {"tokens": torch.from_numpy(toks)},
                                         tcfg)
        assert len(tape.jax) == len(tape.port) == 4
        assert set(taux) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=AUX_RTOL[k], err_msg=k)
        assert float(taux["lb_loss"]) > 0 and float(taux["dropped_frac"]) > 0
        assert all(m <= FLIP_MARGIN for _, _, m in tape.flips())
        d = float(np.abs(np.asarray(jl.astype(jnp.float32))
                         - tl.float().numpy()).max())
        assert d <= self.BOUND["dense"], d

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
