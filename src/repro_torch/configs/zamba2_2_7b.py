"""Zamba2-2.7B — Mamba2 backbone + shared attention block (hybrid).

[arXiv:2411.15242; hf]. 54L d_model=2560 32H (kv=32) d_ff=10240,
ssm_state=64, vocab=32000. One shared attention+MLP block (parameters
reused) applied every 6 mamba layers. Runs long_500k (state decode).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    activation="gelu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    chunk_len=256,
    microbatch=2,
    source="arXiv:2411.15242",
)
