"""Fine-grained mixture of experts (DeepSeekMoE / DBRX style) on tensors.

Counterpart of ``repro/models/moe.py``, with its semantics down to the
dropped slot: softmax over fp32 router logits, top-k experts per token,
capacity-based dispatch into per-expert buffers of capacity
``max(8, min(n, ceil(n * k / E * capacity_factor)))`` for a dispatch of
``n`` tokens (bucket pad tokens included), one batched product over the
stacked expert weights, and a weighted combine; a routed slot past its
expert's capacity contributes nothing (shared experts still apply).

Everything is deterministic on the card: the kept slots' (expert,
position) pairs are unique, so the scatter into the buffers is a plain
indexed assignment, and the combine is a sum over each token's k slots —
no float atomics (``index_add_`` / ``scatter_add_`` would change bits
from run to run). Dropped slots are masked: their scatter lands on one
scratch row past the buffers, which is discarded, and their gather
reads zero.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints as H
from repro_torch.models import layers as L


def init_moe(gen, cfg, lead=(), device="cuda") -> dict:
    """Router (fp32), stacked expert weights (E leading) and, where the
    config has them, the shared experts' MLP; leading axes ``lead``."""
    d, dt, dev = cfg.d_model, L.dtype_of(cfg), device
    f, e = cfg.d_ff_expert, cfg.n_experts
    p = {"router": L.dense_init(gen, (*lead, d, e), torch.float32, dev,
                                fan_in=d),
         "w_gate": L.dense_init(gen, (*lead, e, d, f), dt, dev, fan_in=d),
         "w_up": L.dense_init(gen, (*lead, e, d, f), dt, dev, fan_in=d),
         "w_down": L.dense_init(gen, (*lead, e, f, d), dt, dev, fan_in=f)}
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, cfg,
                                 cfg.n_shared_experts * cfg.d_ff_expert,
                                 lead, dev)
    return p


def _capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for a dispatch of ``n_tokens`` tokens."""
    c = int(math.ceil(n_tokens * cfg.moe_top_k / cfg.n_experts
                      * cfg.moe_capacity_factor))
    return max(8, min(n_tokens, c))


def route(router_w, x, top_k: int):
    """x (N, d) -> (weights (N, k) fp32 renormalised, expert ids (N, k)
    int64), experts in ``jax.lax.top_k``'s order: descending, and on a
    tie the lower index first (a stable sort)."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ids


def slot_positions(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each routed slot's position within its expert: the exclusive
    count of earlier slots on the same expert, in flattened (token,
    slot) order. ids (N, k) -> (N * k,)."""
    flat = ids.reshape(-1)
    seen = torch.cumsum(F.one_hot(flat, n_experts), dim=0)
    return seen.gather(1, flat[:, None])[:, 0] - 1


def apply_moe(p, cfg, x):
    """x (B, S, d) -> (B, S, d) in x's dtype. On a mesh every rank
    routes the whole (gathered) hidden over all ``cfg.n_experts`` and
    fills the whole buffer; its three products run over its own experts
    (:func:`~repro_torch.distributed.hints.moe_buf`), whose outputs are
    gathered in expert order before the combine. Over a data-split
    batch — a training microbatch, or a serving decode or verify whose
    slots each data replica holds a block of — a rank's buffer holds its
    own tokens' slots at their places in the whole dispatch's. Where the
    call holds its residual stream split over ``model``
    (:func:`~repro_torch.distributed.hints.residual`), the output is the
    rank's part of it."""
    b, s, d = x.shape
    n, k, e = b * s, cfg.moe_top_k, cfg.n_experts
    # over a data-split batch the dispatch is the whole batch's, as in
    # the reference's one program: its capacity is of every data rank's
    # tokens, and a rank's slots follow the lower ranks' on each expert,
    # so the same slots drop
    cap = _capacity(n * H.data_ranks(), cfg)
    xf = x.reshape(n, d)
    w, ids = route(p["router"], xf, k)
    pos = slot_positions(ids, e) + H.slot_offsets(ids, e)
    keep = pos < cap
    # kept slots land at (expert, pos), all distinct; dropped ones on the
    # scratch row e * cap, discarded below
    dest = torch.where(keep, ids.reshape(-1) * cap + pos, e * cap)
    buf = x.new_zeros((e * cap + 1, d))
    buf[dest] = xf.repeat_interleave(k, dim=0)
    buf = H.moe_buf(buf[:-1].view(e, cap, d), p["w_gate"].shape[-3])
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = (L.gelu(g) if cfg.activation == "geglu" else F.silu(g)) * u
    y_buf = H.moe_gather(torch.bmm(h, p["w_down"]), e).view(e * cap, d)
    y_slots = torch.where(keep[:, None], y_buf[dest.clamp(max=e * cap - 1)],
                          0)
    y = (y_slots * w.reshape(-1, 1).to(y_slots.dtype)).view(n, k, d).sum(1)
    # whole on every model rank: where the call's residual stream is
    # split, the rank keeps its part, and so does the shared MLP's g
    y = H.stream_part(y.reshape(b, s, d))
    if "shared" in p:
        y = y + L.apply_mlp(p["shared"], cfg, x)
    return y.to(x.dtype)


def aux_load_balance_loss(p, cfg, x) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss of the router ``p``
    over x (B, S, d): E * sum over experts of (the share of routed slots
    it takes) * (its mean router probability). The reference's
    ``loss_fn`` does not add it; a trainer may."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"],
                          dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.moe_top_k]
    frac = F.one_hot(ids, cfg.n_experts).float().mean((0, 1))
    return cfg.n_experts * (frac * probs.mean(0)).sum()
