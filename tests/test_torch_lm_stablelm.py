"""Port parity of StableLM-3B (``configs/stablelm_3b.py``) at
``reduced()`` (4 layers, d 128, 4 heads over 4 KV heads of 32 — G = 1,
as the full config's MHA — LayerNorm, SwiGLU, untied head) against the
jitted JAX engine, in ``dense``, ``int8`` and ``sparse_cfmm``
(tests/_torch_lm_parity.py).  The untied head's logits are 4.4x as wide
as SmolLM's: ``int8`` and ``sparse_cfmm`` measure above 0.06 and are
held to 0.25 (``UNTIED_LOGIT_BOUND``), ``dense`` to 0.06.
"""
from _torch_lm_parity import UNTIED_BOUNDS, LMParity


class TestStableLM(LMParity):
    ARCH = "stablelm_3b"
    BOUND = UNTIED_BOUNDS

    def test_reduced_keeps_mha_and_layernorm(self):
        cfg = self.configs()[1]
        assert cfg.n_heads == cfg.n_kv_heads == 4
        assert cfg.norm == "layernorm" and not cfg.tie_embeddings
