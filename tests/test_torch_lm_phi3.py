"""Port parity of Phi-3-medium-14B (``configs/phi3_medium_14b.py``) at
``reduced()`` (4 layers, d 128, 4 heads over 1 KV head of 32, SwiGLU,
untied head) against the jitted JAX engine, in ``dense``, ``int8`` and
``sparse_cfmm`` (tests/_torch_lm_parity.py).  The untied head's logits
are 4.4x as wide as SmolLM's: ``int8`` and ``sparse_cfmm`` measure above
0.06 and are held to 0.25 (``UNTIED_LOGIT_BOUND``), ``dense`` to 0.06.
"""
from _torch_lm_parity import UNTIED_BOUNDS, LMParity


class TestPhi3(LMParity):
    ARCH = "phi3_medium_14b"
    BOUND = UNTIED_BOUNDS

    def test_reduced_keeps_gqa_and_untied_head(self):
        cfg = self.configs()[1]
        assert cfg.n_heads // cfg.n_kv_heads == 4
        assert not cfg.tie_embeddings and cfg.norm == "rmsnorm"
