"""Gradient compression with error feedback: int8 codes per block of 256
values with one fp32 max-abs scale each, the quantization residual
carried to the next step and added back before quantizing again.

Counterpart of ``repro/distributed/compression.py``, on tensors: the
same blocks, scales, rounding (half to even) and clipping, so a
gradient's codes are the reference's bit for bit. On one device the
round trip is what a compressed reduction would hand the optimizer;
where it sits inside a mesh's gradient reduction comes with training
over a mesh.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def compress(g: torch.Tensor, block: int = 256):
    """g -> (int8 codes (n_blocks, block), fp32 scales (n_blocks, 1),
    g's shape): g flattened in fp32, zero-padded to whole blocks."""
    flat = g.float().reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % block)])
    blocks = flat.reshape(-1, block)
    scale = torch.clamp(blocks.abs().amax(1, keepdim=True) / 127.0,
                        min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(
        torch.int8)
    return codes, scale, tuple(g.shape)


def decompress(codes: torch.Tensor, scale: torch.Tensor, shape
               ) -> torch.Tensor:
    """The fp32 tensor of ``shape`` the codes and scales stand for."""
    n = 1
    for d in shape:
        n *= d
    return (codes.float() * scale).reshape(-1)[:n].reshape(shape)


def roundtrip_with_feedback(g: torch.Tensor, err: torch.Tensor,
                            block: int = 256):
    """(g_hat in g's dtype, new_err fp32): quantize g + err, return the
    reconstruction and the residual to carry to the next step."""
    target = g.float() + err
    g_hat = decompress(*compress(target, block))
    return g_hat.to(g.dtype), target - g_hat


def init_error_state(params):
    """Zero fp32 residuals of the params' shapes."""
    return T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)


def apply(grads, err_state, block: int = 256):
    """Tree-wise compression with error feedback. Returns (the
    round-tripped grads, the new error state)."""
    pairs = [roundtrip_with_feedback(g, e, block)
             for g, e in zip(T.leaves(grads), T.leaves(err_state))]
    return (T.unflatten(grads, [p[0] for p in pairs]),
            T.unflatten(err_state, [p[1] for p in pairs]))
