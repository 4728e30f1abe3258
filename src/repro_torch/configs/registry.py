"""Config registry: ``get_config("<arch-id>")`` for every assigned arch
(+ the paper's own models) and ``list_archs()`` for the 10 assigned ids."""
from __future__ import annotations

from repro_torch.configs import (
    base,
    dbrx_132b,
    deepseek_moe_16b,
    h2o_danube_1_8b,
    internvl2_26b,
    nemotron_4_340b,
    paper_models,
    phi3_mini_3_8b,
    qwen1_5_0_5b,
    whisper_large_v3,
    xlstm_350m,
    zamba2_2_7b,
)
from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, smoke_config

_ASSIGNED = {
    "internvl2-26b": internvl2_26b.CONFIG,
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "h2o-danube-1.8b": h2o_danube_1_8b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "nemotron-4-340b": nemotron_4_340b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "xlstm-350m": xlstm_350m.CONFIG,
    "zamba2-2.7b": zamba2_2_7b.CONFIG,
}

_PAPER = {
    "llama2-7b": paper_models.LLAMA2_7B,
    "llama2-70b": paper_models.LLAMA2_70B,
    "mistral-7b": paper_models.MISTRAL_7B,
    "mixtral-8x22b": paper_models.MIXTRAL_8X22B,
}

_ALL = {**_ASSIGNED, **_PAPER}


def list_archs(assigned_only: bool = True) -> list[str]:
    return sorted(_ASSIGNED if assigned_only else _ALL)


def get_config(name: str) -> ArchConfig:
    try:
        return _ALL[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_ALL)}"
        ) from None


def get_smoke_config(name: str) -> ArchConfig:
    return smoke_config(get_config(name))


def cells(assigned_only: bool = True):
    """All (arch, shape) dry-run cells, honoring long_500k applicability."""
    out = []
    for a in list_archs(assigned_only):
        cfg = get_config(a)
        for s in cfg.shapes():
            out.append((a, s.name))
    return out
