"""Qwen1.5-0.5B — dense, QKV bias, MHA.

[hf:Qwen/Qwen1.5-0.5B; hf]. 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936. Tied embeddings per the released model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    microbatch=1,
    source="hf:Qwen/Qwen1.5-0.5B",
)
