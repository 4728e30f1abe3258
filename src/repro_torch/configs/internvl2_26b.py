"""InternVL2-26B — InternViT frontend (STUB) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]. 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The vision tower is a stub: ``input_specs`` provides
precomputed patch embeddings (256 per image) prepended to text tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    activation="swiglu",
    norm="rmsnorm",
    n_image_tokens=256,
    microbatch=8,
    act_shard="dmodel",
    source="arXiv:2404.16821",
)
