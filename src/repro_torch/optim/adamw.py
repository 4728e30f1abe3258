"""AdamW on tensors: cosine schedule with warmup, global-norm clipping,
moments in a configurable dtype.

Counterpart of ``repro/optim/adamw.py``, with its semantics: the
gradient's global norm in fp32 (leaves summed in pytree order), one clip
scale for every leaf, bias correction by the step, decoupled weight
decay on leaves of two or more dimensions only, the update in fp32 and
the moments stored in ``moment_dtype``. Plain tensor code over the
params tree — ``torch.optim.AdamW`` decays every leaf and has neither
the clip nor the schedule. The state is a tree of the params' structure
(``mu``, ``nu``) and an int32 ``step``, as the reference's, so its
checkpoints carry the same leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import tree as T

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cosine_schedule(step, *, base_lr, warmup_steps, total_steps,
                    min_ratio=0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a number or tensor; fp32): linear
    warmup over ``warmup_steps``, then a cosine from ``base_lr`` down to
    ``min_ratio * base_lr`` at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = (torch.ones_like(step) if warmup_steps <= 0 else
            torch.clamp(step / max(1.0, warmup_steps), max=1.0))
    prog = torch.clamp((step - warmup_steps)
                       / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return base_lr * warm * (min_ratio + (1 - min_ratio) * cos)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"  # "bfloat16" for the biggest archs


class AdamW:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params) -> dict:
        """Zero moments of the params' shapes in ``moment_dtype`` on
        their devices, and step 0 (int32, on the first leaf's device)."""
        dt = _DTYPES[self.cfg.moment_dtype]
        first = T.leaves(params)[0]
        return {"mu": T.tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                                 params),
                "nu": T.tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                                 params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=first.device)}

    @torch.no_grad()
    def apply(self, grads, state, params):
        """One step. Returns (new params, new state, {"grad_norm",
        "lr"}); nothing is updated in place, and nothing waits for the
        card."""
        c = self.cfg
        step = state["step"] + 1
        gsq = sum(g.float().square().sum() for g in T.leaves(grads))
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        lr = cosine_schedule(step, base_lr=c.lr, warmup_steps=c.warmup_steps,
                             total_steps=c.total_steps)
        stepf = step.float()
        bc1 = 1.0 - torch.pow(c.b1, stepf)
        bc2 = 1.0 - torch.pow(c.b2, stepf)
        mdt = _DTYPES[c.moment_dtype]

        def upd(p, g, mu, nu):
            g = g.float() * scale
            mu_n = c.b1 * mu.float() + (1 - c.b1) * g
            nu_n = c.b2 * nu.float() + (1 - c.b2) * g * g
            delta = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + c.eps)
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                delta = delta + c.weight_decay * p.float()
            p_n = p.float() - lr * delta
            return p_n.to(p.dtype), mu_n.to(mdt), nu_n.to(mdt)

        out = [upd(*leaf) for leaf in zip(
            T.leaves(params), T.leaves(grads), T.leaves(state["mu"]),
            T.leaves(state["nu"]))]
        new = [T.unflatten(params, [o[i] for o in out]) for i in range(3)]
        return new[0], {"mu": new[1], "nu": new[2], "step": step}, \
            {"grad_norm": gnorm, "lr": lr}
