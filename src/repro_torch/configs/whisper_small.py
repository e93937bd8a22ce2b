"""Whisper-small: encoder-decoder, conv frontend stubbed [arXiv:2212.04356]
(ports ``repro/configs/whisper_small.py``).  As in the JAX package,
``frontend="audio"`` has no code: the model takes post-conv frame
embeddings (B, T_enc, d_model), T_enc = 1500 for 30 s of audio."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_small", family="audio",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    head_dim=64, d_ff=3072, vocab=51865, pos="sinusoidal", act="gelu",
    norm="layernorm", encoder_decoder=True, dec_len=448, frontend="audio",
)
