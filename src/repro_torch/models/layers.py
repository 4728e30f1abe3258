"""Shared building blocks on tensors: norms, MLP, RoPE, embeddings.

Counterpart of ``repro/models/layers.py``. Params are plain nested dicts
of tensors; layer stacks carry a leading ``L`` dimension on every leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init helpers (explicit generators; the JAX PRNG streams are not
# reproducible here, so only shapes and dtypes match the reference)
# ---------------------------------------------------------------------------

def dense_init(gen, shape, dtype, device, fan_in: int | None = None):
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / max(1, fan) ** 0.5
    return (torch.randn(shape, generator=gen, device=device) * scale
            ).to(dtype)


def embed_init(gen, shape, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * 0.02
            ).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def add_norm(p, cfg, x, a=None, *, out_dtype=None):
    """The residual add and the norm after it, in one pass (K5 on the
    card): (s, h) with s = x + a as torch rounds it (x itself when a is
    None) and h = RMSNorm(s) * w in ``out_dtype`` (default s's dtype)."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm={cfg.norm!r}: only rmsnorm is ported in this slice "
            "(layernorm comes with the audio family)")
    return ops.add_rmsnorm(x.contiguous(),
                           None if a is None else a.contiguous(), p["w"],
                           out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def apply_mlp(p, cfg, x):
    if cfg.activation != "swiglu":
        raise NotImplementedError(
            f"activation={cfg.activation!r}: only swiglu is ported in "
            "this slice")
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]


# ---------------------------------------------------------------------------
# rotary position embeddings (split-half form)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)  # (d_head/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def logits_from_hidden(head_table: torch.Tensor, x: torch.Tensor
                       ) -> torch.Tensor:
    """head_table (V, d); x (..., d). fp32 logits, accumulated in fp32
    and never rounded to a narrower type on the way."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ head_table.T
    elif x.is_cuda:
        out = torch.mm(x2, head_table.T, out_dtype=torch.float32)
    else:
        out = x2.float() @ head_table.float().T
    return out.reshape(*x.shape[:-1], head_table.shape[0])
