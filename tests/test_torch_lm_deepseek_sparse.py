"""DeepSeek-V2-Lite-16B's port parity at ``reduced()`` in ``sparse_cfmm``
(the rest is tests/test_torch_lm_deepseek.py): the compiled bytes, every
prefill and decode call of the port's engine against the jitted JAX
engine within ``UNTIED_BOUNDS["sparse_cfmm"]`` on JAX's routing and
tokens, and every turned pick under ``FLIP_MARGIN``.  A file of its own:
JAX's eager compile of the bitmap tree and its jitted engine programs
take ~40 s on the CPU."""
from test_torch_lm_deepseek import DeepSeekParity


class TestDeepSeekSparse(DeepSeekParity):
    MODES = ("sparse_cfmm",)
    # mode-free tests, run once in tests/test_torch_lm_deepseek.py
    test_config_matches_jax = None
    test_forward_train_aux_matches_jax = None
