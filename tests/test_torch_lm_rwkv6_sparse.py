"""RWKV6-7B's port parity at ``reduced()`` in ``sparse_cfmm`` (the rest
is tests/test_torch_lm_rwkv6.py): the compiled bytes, and every prefill
and decode call of the port's engine against the jitted JAX engine within
``RWKV6Parity.BOUND["sparse_cfmm"]`` on JAX's tokens.  A file of its own
to keep each file's time under a minute."""
from test_torch_lm_rwkv6 import RWKV6Parity


class TestRWKV6Sparse(RWKV6Parity):
    MODES = ("sparse_cfmm",)
    # mode-free tests, run once in tests/test_torch_lm_rwkv6.py
    test_config_matches_jax = None
    test_reduced_is_recurrent_and_untied = None
    test_jax_spreads_between_jit_and_eager = None
    test_jax_overflows_where_port_carries = None
