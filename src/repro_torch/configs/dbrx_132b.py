"""DBRX-132B — 16-expert top-4 fine-grained MoE.

[hf:databricks/dbrx-base; unverified]. 40L d_model=6144 48H (GQA kv=8)
expert d_ff=10752 vocab=100352.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    d_ff_expert=10752,
    n_experts=16,
    n_shared_experts=0,
    moe_top_k=4,
    vocab_size=100352,
    activation="swiglu",
    norm="layernorm",
    microbatch=8,
    act_shard="dmodel",
    source="hf:databricks/dbrx-base",
)
