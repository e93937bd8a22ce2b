"""Port parity of Qwen2-VL-7B (``configs/qwen2_vl_7b.py``) at ``reduced()``
(4 layers, d 128, 4 heads over 1 KV head of 32, SwiGLU, untied head,
M-RoPE sections (8, 4, 4)) against the jitted JAX engine, in ``dense``,
``int8``, ``cfmm`` and ``sparse_cfmm`` (tests/_torch_lm_parity.py).  The
engines serve text positions, which M-RoPE takes in all three streams
(the 3-D streams and the int8 KV cache: tests/test_torch_mrope.py).  The
untied head's logits are 4.4x as wide as SmolLM's: the compiled modes
are held to 0.25 (``UNTIED_LOGIT_BOUND``), ``dense`` to 0.06.
"""
import torch

from _torch_lm_parity import UNTIED_BOUNDS, UNTIED_LOGIT_BOUND, LMParity
from repro_torch import nn
from repro_torch.models import attention, layers, lm


class TestQwen2VL(LMParity):
    ARCH = "qwen2_vl_7b"
    # the four serve modes of ``launch/serve.py``: ``cfmm`` (the int8
    # codes through the CFMM product) too, a compiled mode's bound
    MODES = ("dense", "int8", "cfmm", "sparse_cfmm")
    BOUND = {**UNTIED_BOUNDS, "cfmm": UNTIED_LOGIT_BOUND}

    def test_reduced_keeps_mrope_gqa_and_untied_head(self):
        cfg = self.configs()[1]
        assert cfg.pos == "mrope" and cfg.mrope_sections == (8, 4, 4)
        assert sum(cfg.mrope_sections) == cfg.head_dim // 2
        assert cfg.n_heads // cfg.n_kv_heads == 4
        assert not cfg.tie_embeddings and cfg.rope_theta == 1e6

    def test_served_text_positions_are_standard_rope(self, monkeypatch):
        """The engine's M-RoPE positions are three equal text streams:
        every rotation it runs equals standard RoPE's to the bit."""
        cfg = self.configs()[1]
        seen, orig = [], layers.apply_rope

        def spy(x, positions, theta=1e4, sections=None):
            out = orig(x, positions, theta, sections)
            assert positions.ndim == 3 and sections == cfg.mrope_sections
            assert torch.equal(positions[0], positions[1])
            assert torch.equal(positions[0], positions[2])
            assert torch.equal(out, orig(x, positions[0], theta))
            seen.append(x.shape)
            return out
        monkeypatch.setattr(attention, "apply_rope", spy)
        params = nn.unbox(lm.init(torch.Generator().manual_seed(0), cfg))
        cache = nn.unbox(lm.cache_init(cfg, 1, 16))
        toks = torch.arange(1, 9)[None]
        _, cache = lm.forward_prefill(params, {"tokens": toks}, cfg, cache)
        lm.forward_decode(params, {"token": toks[:, :1]}, cfg, cache)
        assert len(seen) == 2 * 2 * cfg.n_layers      # q and k, two calls
