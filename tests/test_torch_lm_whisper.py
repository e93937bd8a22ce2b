"""Port parity of the encoder-decoder, Whisper-small
(``configs/whisper_small.py``), at ``reduced()``: 2 encoder and 2 decoder
layers, d 128, 4 heads of 32, GeGLU, LayerNorm, sinusoidal positions, an
untied head, vocab 512, ``dec_len`` 16.  The JAX package initialises the
weights, which cross as f32 numpy (``params_from_numpy``); its jitted
``forward_prefill`` / ``forward_decode`` / ``forward_train`` under
``REPRO_PALLAS=jnp`` are the oracle (tests/_torch_lm_parity.py
``run_whisper``: no engine serves an encoder-decoder in either package).

Frames: 24 (and 40) post-conv frames.  At T_enc <= 1024 JAX's chunked
flash reads every key in one chunk, unpadded; at Whisper's 1500 frames it
would pad 548 zero keys into every non-causal softmax, which the port
(as the Pallas kernel) masks (tests/test_torch_flash_attention.py holds
that fact at T_enc = 1100).

Bounds are the untied heads' (tests/_torch_lm_parity.py): ``dense``
0.06, the compiled modes 0.25.  Measured here (jax 0.9.0): ``dense``
0.0234-0.0322 over the prefill and four steps, ``int8`` 0.0508-0.0703,
``int8`` with the int8 KV cache 0.0566-0.0781, logits of std 0.94;
``forward_train`` 0.0313; the train step's loss 2.0e-3 apart, gradients
0.011 (median) to 0.022 relative L2 per leaf.  This file: the config,
the positions, the trees both ways, ``cfmm`` bytes, ``dense`` serving,
training, the decode protocol, the refusals; the compiled modes' serving
(``int8``, with and without the int8 KV cache, ``sparse_cfmm``) and
their bytes: tests/test_torch_lm_whisper_compiled.py (``WhisperParity``
in tests/_torch_lm_parity.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import pytest

from _torch_lm_parity import (LOGIT_BOUND, WhisperParity, flat_jax,
                              flat_port, jax_tree_from_port, to_np,
                              whisper_inputs)
from repro import nn as jnn
from repro.configs.base import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import train_step as tts

# tests/test_torch_mrope.py's bounds of a training step with an untied
# head: the loss within 4.4e-3, each leaf's gradient within 0.05 relative L2
UNTIED_LOSS_ATOL, GRAD_REL_L2 = 4.4e-3, 0.05


class TestWhisper(WhisperParity):
    RUNS = (("dense", False),)
    BYTES = ("cfmm",)

    def test_config_matches_jax(self):
        """The full config and ``reduced()`` equal JAX's field for field;
        the full one at the published widths and depth, the reduced one
        at 2 + 2 layers and ``dec_len`` 16."""
        jfull, tfull = jget_config(self.ARCH), tget_config(self.ARCH)
        assert dataclasses.asdict(jfull) == dataclasses.asdict(tfull)
        assert dataclasses.asdict(jfull.reduced()) == dataclasses.asdict(
            tfull.reduced())
        c = tfull
        assert (c.n_enc_layers, c.n_layers, c.d_model, c.n_heads,
                c.n_kv_heads, c.head_dim, c.d_ff, c.vocab, c.dec_len) == (
                    12, 12, 768, 12, 12, 64, 3072, 51865, 448)
        assert (c.encoder_decoder, c.pos, c.act, c.norm, c.tie_embeddings,
                c.frontend) == (True, "sinusoidal", "gelu", "layernorm",
                                False, "audio")
        r = tfull.reduced()
        assert (r.n_enc_layers, r.n_layers, r.dec_len, r.d_model) == (
            2, 2, 16, 128)

    @pytest.mark.parametrize("T,d", [(1500, 768), (448, 768), (24, 128)])
    def test_sinusoidal_positions_bit_equal_jax(self, T, d):
        want = jlayers.sinusoidal_positions(T, d)
        got = tlayers.sinusoidal_positions(T, d)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        # as added to bf16 activations: one rounding, alike on both sides
        np.testing.assert_array_equal(
            to_np(jnp.asarray(want, jnp.bfloat16)),
            torch.from_numpy(got).to(torch.bfloat16).float().numpy())

    def test_trees_carry_both_ways(self, setup):
        """The encoder-decoder tree (``enc_blocks``, ``enc_norm``,
        ``dec_blocks`` with ``xattn``) crosses to the port and back bit
        for bit, leaf names, axes and kinds included; the port's own init
        has JAX's leaves at JAX's shapes."""
        jcfg, tcfg, jt, tt = setup
        jf, tf = flat_jax(jt), flat_port(tt)
        assert jf.keys() == tf.keys()
        assert "['dec_blocks']['xattn']['k']" in jf
        back = flat_jax(jax_tree_from_port(tt))
        for k, p in jf.items():
            assert (back[k].axes, back[k].kind) == (p.axes, p.kind)
            np.testing.assert_array_equal(np.asarray(back[k].value),
                                          np.asarray(p.value))
        own = flat_port(tlm.init(torch.Generator().manual_seed(0), tcfg))
        assert own.keys() == jf.keys()
        for k, p in jf.items():
            assert tuple(own[k].value.shape) == p.value.shape, k
            assert (own[k].axes, own[k].kind) == (p.axes, p.kind), k
        assert own["['enc_blocks']['ffn']['down']"].value.shape[0] == 2

    def test_forward_train_and_train_step_match_jax(self, setup, inputs):
        """``forward_train``'s logits (dense bound) and one training
        step's loss and per-leaf gradients against ``jax.value_and_grad``
        of the jitted JAX loss, the encoder, the cross-attention's own k/v
        projections and the remat included."""
        jcfg, tcfg, jt, tt = setup
        frames, toks = inputs
        jb = {"frames": jnp.asarray(frames).astype(jnp.bfloat16),
              "tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
        tb = {"frames": torch.from_numpy(frames).to(torch.bfloat16),
              "tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(toks)}

        def loss_of(p):
            logits, aux = jlm.forward_train(p, jb, jcfg)
            loss, _ = jlm.loss_fn(logits, jb["labels"], aux)
            return loss, logits

        (jloss, jlogits), jg = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))(jnn.unbox(jt))
        tp = tnn.unbox(tt)
        with torch.no_grad():
            tlogits, aux = tlm.forward_train(tp, tb, tcfg)
        assert tlogits.shape == (self.B, toks.shape[1], tcfg.vocab)
        assert aux == {"lb_loss": 0.0, "z_loss": 0.0, "dropped_frac": 0.0}
        d = float(np.abs(to_np(jlogits) - tlogits.float().numpy()).max())
        assert np.isfinite(d) and d <= LOGIT_BOUND, d
        tloss, _, tg = tts.value_and_grad(tp, tb, tcfg)
        assert abs(float(tloss) - float(jloss)) <= UNTIED_LOSS_ATOL
        jl = jax.tree_util.tree_flatten_with_path(jg)[0]
        tl = tnn.tree_flatten_with_path(tg)
        for (_, a), (path, t) in zip(jl, tl, strict=True):
            a, t = np.asarray(a, np.float32), t.float().numpy()
            rel = np.linalg.norm(t - a) / max(np.linalg.norm(a), 1e-30)
            assert rel <= GRAD_REL_L2, path
            assert np.abs(a).max() > 0, path    # every leaf has a gradient

    @pytest.mark.parametrize("T_enc", [24, 40])
    def test_decode_matches_own_full_forward(self, setup, T_enc):
        """JAX's tests/test_decode.py in the port (its own init): a
        prefill of T - 4 tokens and four steps against ``forward_train``
        of all T, within 0.06 of max |logit|, greedy tokens equal
        wherever the full forward's margin exceeds 0.05 of it; the cross
        cache equals the prefill's projections of the encoder's output
        cast to bf16, bit for bit, and the steps leave it as it was."""
        tcfg, B = setup[1], self.B
        params = tnn.unbox(tlm.init(torch.Generator().manual_seed(1), tcfg))
        frames, toks = whisper_inputs(tcfg.vocab, tcfg.d_model, B, T_enc,
                                      16, seed=T_enc)
        frames = torch.from_numpy(frames).to(torch.bfloat16)
        toks = torch.from_numpy(toks)
        T = toks.shape[1]
        with torch.no_grad():
            full, _ = tlm.forward_train(params, {"frames": frames,
                                                 "tokens": toks}, tcfg)
            cache = tnn.unbox(tlm.cache_init(tcfg, B, 32, S_enc=T_enc))
            lg, cache = tlm.forward_prefill(
                params, {"frames": frames, "tokens": toks[:, :T - 4]}, tcfg,
                cache)
            enc = tlm._encode(params, frames, tcfg)
            layers = tnn.unstack(params["dec_blocks"], tcfg.n_layers)
            for l, p in enumerate(layers):
                k, v = tlm._cross_kv(p, enc, tcfg)
                assert torch.equal(cache["cross"]["k"][l],
                                   k.to(torch.bfloat16))
                assert torch.equal(cache["cross"]["v"][l],
                                   v.to(torch.bfloat16))
            cross = {k: v.clone() for k, v in cache["cross"].items()}
            outs = [lg]
            for t in range(T - 4, T):
                lg, cache = tlm.forward_decode(
                    params, {"token": toks[:, t:t + 1]}, tcfg, cache)
                outs.append(lg)
        assert all(torch.equal(cache["cross"][k], cross[k]) for k in cross)
        dec = torch.cat(outs[:-1], dim=1).float()
        ref = full[:, T - 5:T - 1].float()
        scale = float(ref.abs().max())
        assert float((dec - ref).abs().max()) / scale < 0.06
        top2 = torch.topk(ref, 2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]) / scale
        disagree = dec.argmax(-1) != ref.argmax(-1)
        assert not bool((disagree & (margin > 0.05)).any())

    def test_cross_cache_of_another_length_raises(self, setup):
        """A cross cache whose length is not the frame count is refused,
        naming both (JAX asserts the same); the default length is
        Whisper's 1500 frames of 30 s of audio."""
        tcfg = setup[1]
        params = tnn.unbox(tlm.init(torch.Generator().manual_seed(0), tcfg))
        cache = tnn.unbox(tlm.cache_init(tcfg, 1, 16, S_enc=30))
        batch = {"frames": torch.zeros((1, 24, tcfg.d_model),
                                       dtype=torch.bfloat16),
                 "tokens": torch.ones((1, 4), dtype=torch.long)}
        with pytest.raises(ValueError, match="30 != encoder frames 24"):
            tlm.forward_prefill(params, batch, tcfg, cache)
        default = tnn.unbox(tlm.cache_init(tcfg, 1, 16))
        assert default["cross"]["k"].shape[2] == 1500

    def test_engine_refuses_the_encoder_decoder(self, setup):
        """Neither package's engine passes frames: the port's refuses an
        encoder-decoder at construction and names the path that serves
        it."""
        tcfg = setup[1]
        params = tlm.init(torch.Generator().manual_seed(0), tcfg)
        with pytest.raises(ValueError, match="forward_prefill"):
            ServingEngine(tcfg, params, mode="dense", device="cpu")
