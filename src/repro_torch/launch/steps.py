"""Step builders: the units the launchers drive.

Counterpart of ``repro/launch/steps.py``:

- :func:`build_train_step` — loss and gradients (with fp32 gradient
  accumulation over ``cfg.microbatch`` slices of the batch), the
  optional gradient-compression hook, then the AdamW update. Functional
  as the reference's: it takes params and optimizer state and returns
  new ones; the params passed in need not require grad.
- :func:`build_prefill_step` — the prompt's last-token logits and a
  filled cache.
- :func:`build_serve_step` — one decode token against a cache and its
  greedy pick.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.models import model as MD
from repro_torch.optim import AdamW


def microbatches(cfg, batch_size: int) -> int:
    """Slices of a batch of ``batch_size`` rows: the largest count up to
    ``cfg.microbatch`` that divides it (one device: no mesh extent to
    keep divisible, as the reference's clamp also asks)."""
    mb = max(1, min(cfg.microbatch, batch_size))
    while mb > 1 and batch_size % mb:
        mb -= 1
    return mb


def loss_and_grads(params, cfg, batch, *, attn_impl="chunked"):
    """(loss, gradients in the params' dtypes) of one batch: the leaves
    are differentiated as they stand (detached copies that require
    grad), so the params themselves are left as they were."""
    leaves = [t.detach().requires_grad_() for t in T.leaves(params)]
    loss, _ = MD.loss_fn(T.unflatten(params, leaves), cfg, batch,
                         attn_impl=attn_impl)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), T.unflatten(params, grads)


def accumulated_grads(params, cfg, batch, *, attn_impl="chunked"):
    """(loss, gradients) of a batch over ``m = microbatches(cfg, B)``
    slices: with m > 1 each slice of B / m rows is differentiated in
    turn, the gradients added in fp32 and the sum and the loss divided
    by m, as the reference's scan does (the gradients are then fp32);
    with m == 1, :func:`loss_and_grads` of the whole batch."""
    mb = microbatches(cfg, batch["tokens"].shape[0])
    if mb == 1:
        return loss_and_grads(params, cfg, batch, attn_impl=attn_impl)
    acc = [torch.zeros_like(p, dtype=torch.float32)
           for p in T.leaves(params)]
    loss = 0.0
    for i in range(mb):
        part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                for k, v in batch.items()}
        li, g = loss_and_grads(params, cfg, part, attn_impl=attn_impl)
        acc = [a + gi.float() for a, gi in zip(acc, T.leaves(g))]
        loss = loss + li
    return loss / mb, T.unflatten(params, [a / mb for a in acc])


def build_train_step(cfg, opt: AdamW, *, attn_impl="chunked",
                     grad_compression=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`accumulated_grads`, then
    ``grad_compression(grads, opt_state) -> (grads, opt_state)`` where
    given, then the AdamW update."""
    def train_step(params, opt_state, batch):
        loss, grads = accumulated_grads(params, cfg, batch,
                                        attn_impl=attn_impl)
        if grad_compression is not None:
            grads, opt_state = grad_compression(grads, opt_state)
        params, opt_state, stats = opt.apply(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def build_prefill_step(cfg, *, capacity=None):
    """``prefill_step(params, batch) -> (logits (B, V), cache)`` of a
    cache holding ``capacity`` positions (the prompt's length when
    None)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        cap = capacity or batch["tokens"].shape[1]
        return MD.prefill(params, cfg, batch, cap)

    return prefill_step


def build_serve_step(cfg, *, sample="greedy"):
    """``serve_step(params, tokens, cache) -> (next tokens (B, 1) int32,
    logits (B, V), cache)``: one greedy decode step."""
    if sample != "greedy":
        raise ValueError(f"unknown sampling {sample!r}: the step builder "
                         "samples greedily (the engine samples otherwise)")

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        logits, cache = MD.decode_step(params, cfg, tokens, cache)
        return logits.argmax(-1)[:, None].to(torch.int32), logits, cache

    return serve_step
