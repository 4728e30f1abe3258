"""K1 — split-KV GQA flash decode over a ragged contiguous cache, on the
card (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py::decode_attention_bhgd``
and also merges the current token's K/V as the always-valid self
partial of ``repro/models/attention.py::decode_attention``. One wrapper
call is two launches (split partials, then the fixed-order combine) and
counts once in ``launches``. :func:`launch_plan` sizes the splits; K2
(``paged_decode_attention.py``) takes the same plan.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

SPLITS = (32, 128)   # positions per pass-1 block the source takes
TILE = 32                # positions per staged tile (kTile)
MAX_G = 8     # query heads per KV head (kMaxG)
HEAD_DIMS = (64, 96, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# both exports of csrc/decode_attention.cu (K1 here, K2 in
# paged_decode_attention.py): one library, one signature table
SIG = {"decode_attention_launch":
       [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
       "paged_decode_attention_launch":
       [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]}


class Plan(NamedTuple):
    """Pass 1's launch: ``split`` positions per block, ``splits`` blocks
    per (batch row, KV head) over the capacity, ``grid`` (splits, Hkv,
    B); pass 2 has one block per (query head, batch row)."""
    split: int
    splits: int
    grid: tuple


def split_size(b: int, hkv: int) -> int:
    """Positions per pass-1 block, from the batch and KV-head counts
    that K1 and K2 share — never from the capacity or the lengths, so a
    contiguous cache and a block-table view of the same rows are cut at
    the same positions. Up to 64 (row, KV head) pairs take one-tile
    splits so that B = 1 still puts several blocks on every SM; G, Dh and
    the dtype change the work per position, not the count of blocks, and
    leave the split as it is."""
    return 32 if b * hkv <= 64 else 128


def launch_plan(b: int, hkv: int, cap: int) -> Plan:
    """The launch over a (logical) capacity ``cap``."""
    p = split_size(b, hkv)
    ns = max(1, -(-cap // p))
    return Plan(p, ns, (ns, hkv, b))


def row_lengths(cache_len, b: int, device) -> torch.Tensor:
    """``cache_len`` (int, 0-d or (B,)) as a contiguous (B,) int32
    tensor on ``device``."""
    t = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return torch.broadcast_to(t.reshape(-1), (b,)).contiguous()


def check_operands(what: str, q: torch.Tensor, kv_shape: tuple,
                   extra_k, extra_v) -> tuple:
    """Shared checks of K1 and K2: q (B,1,Hq,Dh) against a K/V array
    whose last two dims are (Hkv, Dh), the GQA group bound and the
    optional self KV. Returns the self operands, () or (k, v)."""
    b, _, hq, dh = q.shape
    hkv = kv_shape[-2]
    if q.shape[1] != 1 or kv_shape[-1] != dh:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} kv {kv_shape}")
    if hq % hkv or hq // hkv > MAX_G:
        raise ValueError(f"{what}: Hq={hq}, Hkv={hkv} needs "
                         f"Hq % Hkv == 0 and G <= {MAX_G}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: Dh={dh} not in {HEAD_DIMS}")
    if (extra_k is None) != (extra_v is None):
        raise ValueError(f"{what}: pass extra_k and extra_v together")
    extras = () if extra_k is None else (extra_k, extra_v)
    for e in extras:
        if tuple(e.shape) != (b, 1, hkv, dh):
            raise ValueError(f"{what}: extra shape "
                             f"{tuple(e.shape)} != {(b, 1, hkv, dh)}")
    return extras


def split_scratch(q: torch.Tensor, hkv: int, cap: int):
    """fp32 partials (o, m, l) of pass 1 for a logical capacity ``cap``,
    and the launch plan."""
    b, _, hq, dh = q.shape
    g = hq // hkv
    plan = launch_plan(b, hkv, cap)
    o_part = torch.empty((b, hkv, g, plan.splits, dh), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((b, hkv, g, plan.splits), dtype=torch.float32,
                         device=q.device)
    return o_part, m_part, torch.empty_like(m_part), plan


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     extra_k: torch.Tensor | None = None,
                     extra_v: torch.Tensor | None = None) -> torch.Tensor:
    """q (B,1,Hq,Dh); caches (B,C,Hkv,Dh); ``cache_len`` scalar or (B,)
    valid slots per row; ``extra_k``/``extra_v`` (B,1,Hkv,Dh), the
    current token's KV, or both None. Returns (B,1,Hq,Dh)."""
    global launches
    b, _, hq, dh = q.shape
    _, cap, hkv, _ = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or k_cache.shape[0] != b:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    extras = check_operands("decode_attention", q, tuple(k_cache.shape),
                            extra_k, extra_v)
    code = _build.launch_dtype("decode_attention", q, k_cache, v_cache,
                               *extras)
    lens = row_lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    o_part, m_part, l_part, plan = split_scratch(q, hkv, cap)
    lib = _build.load("decode_attention", SIG)
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        extra_k.data_ptr() if extras else None,
        extra_v.data_ptr() if extras else None,
        lens.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), out.data_ptr(), b, cap, hkv, hq // hkv, dh,
        plan.splits, plan.split, 1.0 / math.sqrt(dh), code,
        _build.stream_handle(q))
    _build.check(lib, err, "decode_attention")
    launches += 1
    return out
