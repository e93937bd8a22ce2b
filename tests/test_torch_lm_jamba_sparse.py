"""Jamba-v0.1's port parity at ``reduced()`` in ``sparse_cfmm`` (the rest
is tests/test_torch_lm_jamba.py): the compiled bytes, every prefill and
decode call of the port's engine against the jitted JAX engine within
``JambaParity.BOUND["sparse_cfmm"]`` on JAX's routing and tokens, and
every turned pick under ``FLIP_MARGINS``.  A file of its own to keep each
file's time under a minute."""
from test_torch_lm_jamba import JambaParity


class TestJambaSparse(JambaParity):
    MODES = ("sparse_cfmm",)
    # one request: each prompt length is one more jitted JAX prefill
    # program (~5 s); the two-slot decode with a second, shorter prompt
    # runs in dense and int8
    PROMPTS = (37,)
    # mode-free tests, run once in tests/test_torch_lm_jamba.py
    test_config_matches_jax = None
    test_forward_train_aux_matches_jax = None
