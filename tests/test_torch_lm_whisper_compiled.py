"""Port parity of Whisper-small (``configs/whisper_small.py``) at
``reduced()`` in the compiled serve modes, against the jitted JAX
``forward_prefill`` / ``forward_decode`` (``WhisperParity`` in
tests/_torch_lm_parity.py): ``int8`` with the bf16 and the int8 KV cache,
and ``sparse_cfmm``, a prefill of 24 frames and 8 tokens and four decode
steps each, within the untied bound of the compiled modes (0.25); the
``int8`` and ``sparse_cfmm`` trees' bytes equal JAX's, leaf for leaf.
Measured (jax 0.9.0): ``int8`` 0.0508-0.0703, with the int8 KV cache
0.0566-0.0781, ``sparse_cfmm`` 0.0391-0.0469 over the five calls.  The
rest of Whisper's parity: tests/test_torch_lm_whisper.py.
"""
from _torch_lm_parity import WhisperParity


class TestWhisperCompiled(WhisperParity):
    RUNS = (("int8", False), ("int8", True), ("sparse_cfmm", False))
    BYTES = ("int8", "sparse_cfmm")
