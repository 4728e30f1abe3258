"""The paper's own evaluation models (§3.4): Llama2-7B/70B, Mistral-7B,
Mixtral-8x22B. Used by the PIM-AI simulator benchmarks (Fig 4 / Fig 5);
not part of the assigned dry-run cells.

The cloud models are evaluated in both GQA=8 and MHA variants per §4.1.
"""
from repro_torch.configs.base import ArchConfig

LLAMA2_7B = ArchConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,  # Llama2-7B is MHA
    d_ff=11008,
    vocab_size=32000,
    activation="swiglu",
    source="arXiv:2307.09288",
)

LLAMA2_70B = ArchConfig(
    name="llama2-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,  # GQA=8 per the paper's cloud setup
    d_ff=28672,
    vocab_size=32000,
    activation="swiglu",
    source="arXiv:2307.09288",
)

MISTRAL_7B = ArchConfig(
    name="mistral-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    sliding_window=4096,
    source="arXiv:2310.06825",
)

MIXTRAL_8X22B = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    d_ff_expert=16384,
    n_experts=8,
    moe_top_k=2,
    vocab_size=32768,
    activation="swiglu",
    source="mistral.ai Mixtral-8x22B",
)


def mha_variant(cfg: ArchConfig) -> ArchConfig:
    """Paper evaluates GQA=8 vs MHA on the same cloud models (§4.1)."""
    return cfg.replace(n_kv_heads=cfg.n_heads, name=cfg.name + "-mha")
