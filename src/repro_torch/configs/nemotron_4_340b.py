"""Nemotron-4-340B — dense, GQA, squared-ReLU MLP.

[arXiv:2402.16819; unverified]. 96L d_model=18432 96H (GQA kv=8)
d_ff=73728 vocab=256000. Largest assigned cell: bf16 optimizer moments +
aggressive microbatching to fit 16 GB/chip under FSDP x TP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    norm="layernorm",
    microbatch=8,
    act_shard="dmodel",
    optimizer_state_dtype="bfloat16",
    source="arXiv:2402.16819",
)
