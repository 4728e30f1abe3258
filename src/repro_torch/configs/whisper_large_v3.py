"""Whisper-large-v3 backbone — encoder-decoder, conv frontend STUB.

[arXiv:2212.04356; unverified]. 32L d_model=1280 20H (kv=20, MHA)
d_ff=5120 vocab=51866. Encoder context fixed at Whisper's native 1500
frames (precomputed mel-frame embeddings from the stub frontend); the
assigned seq_len is the decoder length. LayerNorm + GELU per Whisper.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    norm="layernorm",
    is_encoder_decoder=True,
    n_encoder_layers=32,
    encoder_len=1500,
    microbatch=2,
    source="arXiv:2212.04356",
)
