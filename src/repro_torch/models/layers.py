"""Shared building blocks on tensors: inits, norms, MLPs, RoPE,
embeddings.

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
    """N(0, 1 / fan_in) in ``dtype`` (``fan_in`` defaults to
    ``shape[0]``). A stacked leaf (L, ..., m, n) is drawn one trailing
    (m, n) matrix at a time into the output, so no float32 copy of the
    whole leaf is ever held (a full-width stack would need twice its
    own size again)."""
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / max(1, fan) ** 0.5
    return _fill_normal(gen, shape, dtype, device, scale)


def embed_init(gen, shape, dtype, device):
    return _fill_normal(gen, shape, dtype, device, 0.02)


def _fill_normal(gen, shape, dtype, device, scale):
    out = torch.empty(shape, dtype=dtype, device=device)
    if not out.numel():
        return out
    for m in out.view(-1, *shape[-2:]) if len(shape) > 2 else (out,):
        m.copy_(torch.randn(m.shape, generator=gen, device=device)
                .mul_(scale))
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg, lead=(), device="cuda") -> dict:
    """A norm's params with leading axes ``lead``: RMSNorm has ``w``
    (ones), LayerNorm also ``b`` (zeros)."""
    d, dt = cfg.d_model, dtype_of(cfg)
    p = {"w": torch.ones((*lead, d), dtype=dt, device=device)}
    if cfg.norm != "rmsnorm":
        p["b"] = torch.zeros((*lead, d), dtype=dt, device=device)
    return p


def layernorm(x, w, b, eps: float = 1e-5, *, out_dtype=None):
    """LayerNorm over the last axis: statistics and affine in fp32, the
    result cast to ``out_dtype`` (default x's dtype), as the reference
    computes it. No Pallas kernel exists for it: plain torch is its
    whole port."""
    y = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)
    return y.to(out_dtype or x.dtype)


def add_norm(p, cfg, x, a=None, *, out_dtype=None):
    """The residual add and the norm after it: (s, h) with s = x + a as
    torch rounds it (x itself when a is None) and h the norm of s in
    ``out_dtype`` (default s's dtype). RMSNorm runs both in one pass
    (K5 on the card); LayerNorm is the add, then :func:`layernorm`."""
    if cfg.norm == "rmsnorm":
        return ops.add_rmsnorm(x.contiguous(),
                               None if a is None else a.contiguous(),
                               p["w"], out_dtype=out_dtype)
    if cfg.norm != "layernorm":
        raise ValueError(f"unknown norm {cfg.norm!r}")
    s = x if a is None else x + a
    return s, layernorm(s, p["w"], p["b"], out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

GATED = ("swiglu", "geglu")


def init_mlp(gen, cfg, d_ff, lead=(), device="cuda") -> dict:
    """An MLP's params with leading axes ``lead``: gate, up and down for
    the gated activations, up and down for the others."""
    d, dt = cfg.d_model, dtype_of(cfg)

    def dense(*shape):
        return dense_init(gen, (*lead, *shape), dt, device, fan_in=shape[0])

    if cfg.activation in GATED:
        return {"w_gate": dense(d, d_ff), "w_up": dense(d, d_ff),
                "w_down": dense(d_ff, d)}
    return {"w_up": dense(d, d_ff), "w_down": dense(d_ff, d)}


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's own
    default, erf, is another function)."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, cfg, x):
    act = cfg.activation
    if act in GATED:
        g = x @ p["w_gate"]
        h = (F.silu(g) if act == "swiglu" else gelu(g)) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if act == "gelu":
            h = gelu(h)
        elif act == "squared_relu":
            r = F.relu(h)
            h = r * r
        else:
            raise ValueError(f"unknown activation {act}")
    return h @ p["w_down"]


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
