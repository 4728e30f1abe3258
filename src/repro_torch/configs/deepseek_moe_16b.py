"""DeepSeekMoE-16B — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf]. 28L d_model=2048 16H (kv=16, MHA) expert
d_ff=1408 vocab=102400. Layer 0 is a dense FFN (d_ff=10944) per the
released model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    d_ff_expert=1408,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    first_dense_layers=1,
    d_ff_first_dense=10944,
    vocab_size=102400,
    activation="swiglu",
    microbatch=4,
    # fine-grained experts (d_ff_e=1408): "din" sharding is 13% lighter on
    # collectives (1.41 vs 1.58 TB) but needs 22.6 GB temp (> 16 GB HBM);
    # the dff default is the feasible choice. Set moe_expert_shard="din"
    # on >=32 GB parts.
    source="arXiv:2401.06066",
)
