"""Shared building blocks on tensors: inits, norms, MLPs, RoPE,
sinusoidal positions, embeddings.

Counterpart of ``repro/models/layers.py``. Params are plain nested dicts
of tensors; layer stacks carry a leading ``L`` dimension on every leaf.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints as H
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
    if not out.numel() or out.is_meta:   # meta: shapes only, no draw
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


def add_rmsnorm(x, a, w, *, out_dtype=None):
    """(s, h): s = x + a as torch rounds it (x itself when a is None),
    h = RMSNorm(s) * w in ``out_dtype`` (default s's dtype), in one pass
    (K5 on the card) — whatever norm the config names: the recurrent
    blocks normalise by RMSNorm inside, as the reference's do."""
    return ops.add_rmsnorm(x.contiguous(),
                           None if a is None else a.contiguous(), w,
                           out_dtype=out_dtype)


def rmsnorm(x, w):
    """RMSNorm of ``x`` by ``w`` in x's dtype (K5 without the add)."""
    return add_rmsnorm(x, None, w)[1]


def add_norm(p, cfg, x, a=None, *, out_dtype=None):
    """The residual add and the norm after it: (s, h) with s = x + a as
    torch rounds it (x itself when a is None) and h the norm of s in
    ``out_dtype`` (default s's dtype). RMSNorm runs both in one pass
    (K5 on the card); LayerNorm is the add, then :func:`layernorm`.

    Where the call holds its residual stream split over ``model``
    (:func:`~repro_torch.distributed.hints.residual`), x and a are the
    rank's parts and so is s; h is whole, the norm of the whole sum: s
    is added on the parts and gathered, and the norm runs on it (K5
    without the add: the same bits, K5's ``s`` is torch's add). In
    training an RMSNorm's gradient is K5b's on the whole rows with the
    residual cotangent fused, as on one device (``ops.add_rmsnorm(...,
    part=)``); a LayerNorm's is autograd's sum of the two, as on one
    device."""
    if H.stream_dim(x) is None:
        return _add_norm(p, cfg, x, a, out_dtype)
    part = H.stream_layout(x)
    if part is not None and a is not None and cfg.norm == "rmsnorm":
        return ops.add_rmsnorm(x.contiguous(), a.contiguous(), p["w"],
                               out_dtype=out_dtype, part=part)
    s = x if a is None else x + a
    return s, _add_norm(p, cfg, H.stream_whole(s), None, out_dtype)[1]


def _add_norm(p, cfg, x, a, out_dtype):
    if cfg.norm == "rmsnorm":
        return add_rmsnorm(x, a, p["w"], out_dtype=out_dtype)
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


def apply_mlp(p, cfg, x, mm=torch.matmul):
    """The MLP of ``cfg.activation``; ``mm`` computes each product (the
    recurrent prefill passes :func:`row_tiled`). On a mesh the hidden
    units are the rank's columns: they are gathered whole before
    ``w_down`` (a row-parallel product that keeps its contraction
    whole), and its output columns gathered to x's width. In training
    ``w_down`` holds the rank's rows instead: x passes Megatron's *f*,
    and the partial sums of ``w_down`` its *g* — unless the MLP runs
    whole on every model rank (a :class:`~repro_torch.distributed.hints.
    Whole` sublayer: its width does not divide ``model``)."""
    split = not H.whole(p)
    x = H.col_input(x, split)
    act = cfg.activation
    if act in GATED:
        g = mm(x, p["w_gate"])
        h = (F.silu(g) if act == "swiglu" else gelu(g)) * mm(x, p["w_up"])
    else:
        h = mm(x, p["w_up"])
        if act == "gelu":
            h = gelu(h)
        elif act == "squared_relu":
            r = F.relu(h)
            h = r * r
        else:
            raise ValueError(f"unknown activation {act}")
    w = p["w_down"]
    return H.hidden(mm(H.row_input(h, w.shape[-2]), w), x.shape[-1], split)


def row_tiled(tile: int):
    """A product ``x (..., K) @ w (K, N)`` computed in blocks of ``tile``
    rows of x, the last one zero-padded, so every product the card (or
    the host's BLAS) runs has the same shape, whatever the row count. A
    library picks its algorithm, and with it the order of each row's
    sum, by the shape of the call: with a fixed shape a row's result
    depends on that row alone, and a prompt's rows come out bitwise the
    same at its exact length as inside a longer, padded bucket."""
    def mm(x, w):
        lead, k = x.shape[:-1], x.shape[-1]
        rows = x.reshape(-1, k)
        m = rows.shape[0]
        pad = -m % tile
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad, k))])
        out = torch.cat([rows[i:i + tile] @ w
                         for i in range(0, m + pad, tile)])
        return out[:m].reshape(*lead, w.shape[-1])
    return mm


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


def sinusoidal_positions(positions: torch.Tensor, d_model: int
                         ) -> torch.Tensor:
    """The classic transformer sinusoid (whisper's positions):
    (..., d_model) float32, the sines of ``positions * freqs`` before
    the cosines, ``freqs = exp(-ln(10000) * i / half)``."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_tokens(p, tokens: torch.Tensor, vocab: int | None = None
                 ) -> torch.Tensor:
    """Rows of ``p["table"]`` at ``tokens``; with ``vocab`` (the whole
    vocabulary) a mesh's vocab-sharded table is read by
    :func:`~repro_torch.distributed.hints.embed`."""
    if vocab is None:
        return p["table"][tokens.long()]
    return H.embed(p["table"], tokens, vocab)


class _HeadLogits(torch.autograd.Function):
    """bf16 hidden rows x2 (M, d) against the bf16 head (V, d) on the
    card: fp32 logits from ``torch.mm(..., out_dtype=float32)`` (each
    product exact, accumulated in fp32, never rounded to bf16), as the
    serving path computes them. Its backward is explicit — that overload
    of ``mm`` is not known to have a derivative — and in fp32: the fp32
    cotangent against the head and the hidden rows, each cast to its
    operand's dtype."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head.T, out_dtype=torch.float32)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x2, head = ctx.saved_tensors
        gx = gh = None
        if ctx.needs_input_grad[0]:
            gx = (g @ head.float()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gh = (g.T @ x2.float()).to(head.dtype)
        return gx, gh


def logits_from_hidden(head_table: torch.Tensor, x: torch.Tensor
                       ) -> torch.Tensor:
    """head_table (V, d); x (..., d). fp32 logits, accumulated in fp32
    and never rounded to a narrower type on the way; differentiable on
    every path (the bf16 one on the card through :class:`_HeadLogits`)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ head_table.T
    elif x.device.type == "cpu":   # meta takes the card's route: a trace
        # prices, and the dry-run meters, what the card runs
        out = x2.float() @ head_table.float().T
    elif torch.is_grad_enabled() and (x.requires_grad
                                      or head_table.requires_grad):
        out = _HeadLogits.apply(x2, head_table)
    else:
        out = torch.mm(x2, head_table.T, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], head_table.shape[0])


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          vocab: int | None = None) -> torch.Tensor:
    """logits fp32 (..., V), labels integer (...,): the mean negative log
    likelihood over the positions ``mask`` keeps (all when None; at least
    one counted), as the reference's. In training over a data-split
    batch the mean is the whole batch's: each rank's sum and count are
    summed over ``data`` before the divide (ranks may keep different
    counts of positions). ``vocab``: the whole vocabulary, where the
    logits may be a rank's columns of it (training over a mesh whose
    head splits the vocab over ``model``): then the NLL is the
    vocab-parallel one (:func:`~repro_torch.distributed.hints.
    vocab_nll`)."""
    if vocab is not None and logits.shape[-1] != vocab:
        nll = H.vocab_nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - gold
    if H.data_ranks() > 1:
        keep = (torch.ones_like(nll) if mask is None
                else mask.to(nll.dtype))
        total = H.sum_over_data((nll * keep).sum())
        return total / torch.clamp(H.sum_over_data(keep.sum()), min=1.0)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
