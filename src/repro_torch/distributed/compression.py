"""Gradient compression with error feedback: int8 codes per block of 256
values with one fp32 max-abs scale each, the quantization residual
carried to the next step and added back before quantizing again.

Counterpart of ``repro/distributed/compression.py``, on tensors: the
same blocks, scales, rounding (half to even) and clipping, so a
gradient's codes are the reference's bit for bit. The round trip is
what a compressed reduction would hand the optimizer.

Over a mesh (in a rank's training context) :func:`apply` takes the
rank's shards of the reduced gradient and of the error state, and gives
the shards of what it gives on the whole leaves, bit for bit: the blocks
run along each whole leaf's flattened order, so a shard that is a run of
whole blocks round-trips on its own, and any other shard (split on a
dim after a longer one, or not a multiple of the block) has its leaf's
``g + err`` gathered, round-tripped whole, and its own slice kept. Only
full-precision values cross the mesh — no int8 payload, which the
reference does not send either. :class:`ErrorFeedback` is the train
step's ``grad_compression`` hook that keeps the error state.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.distributed import hints as H


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
    round-tripped grads, the new error state). In a rank's training
    context the trees are the rank's shards, placed as the params."""
    place = H.train_placement()
    if place is None:
        pairs = [roundtrip_with_feedback(g, e, block)
                 for g, e in zip(T.leaves(grads), T.leaves(err_state))]
    else:
        from repro_torch.distributed import sharding as SH
        comm, specs = place
        pairs = [_shard_roundtrip(g, e, spec, comm, block)
                 for g, e, (_, spec) in zip(T.leaves(grads),
                                            T.leaves(err_state),
                                            SH.spec_leaves(specs))]
    return (T.unflatten(grads, [p[0] for p in pairs]),
            T.unflatten(err_state, [p[1] for p in pairs]))


def _whole_blocks(local, spec, comm, block: int) -> bool:
    """Whether the shard of shape ``local`` under ``spec`` is a run of
    whole blocks of its leaf's flattened order: split along one dim at
    most, every dim before it of size 1, its size a multiple of the
    block (so is its offset)."""
    split = [d for d, e in enumerate(spec)
             if e is not None and comm.size(tuple(e)) > 1]
    if not split:
        return True
    return (len(split) == 1 and all(n == 1 for n in local[:split[0]])
            and local.numel() % block == 0)


def _shard_roundtrip(g, err, spec, comm, block: int):
    """:func:`roundtrip_with_feedback` of the rank's shard of one leaf,
    bitwise the whole leaf's round trip cut to the shard."""
    if _whole_blocks(g.shape, spec, comm, block):
        return roundtrip_with_feedback(g, err, block)
    target = g.float() + err
    whole = target
    for d, e in enumerate(spec):
        if e is not None:
            whole = comm.all_gather(whole, d, tuple(e))
    g_hat = decompress(*compress(whole, block))
    for d, e in enumerate(spec):
        if e is not None:
            g_hat = comm.chunk(g_hat, d, tuple(e))
    return g_hat.to(g.dtype), target - g_hat


class ErrorFeedback:
    """The ``grad_compression`` hook of :func:`~repro_torch.launch.steps.
    build_train_step`: :func:`apply` with its error state kept here,
    from zeros — one tree on one device, one per rank over a mesh (each
    rank's shards). Returns the optimizer state as it came."""

    def __init__(self, block: int = 256):
        self.block = block
        self.err: dict = {}

    def __call__(self, grads, opt_state):
        key = H.train_rank()
        err = self.err.get(key)
        if err is None:
            err = init_error_state(grads)
        grads, self.err[key] = apply(grads, err, self.block)
        return grads, opt_state
