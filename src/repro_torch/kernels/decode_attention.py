"""K1 — split-KV GQA flash decode over a ragged contiguous cache, on the
card (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py::decode_attention_bhgd``
and also merges the current token's K/V as the always-valid self
partial of ``repro/models/attention.py::decode_attention``, with that
function's rolling sliding-window mask (``window=``). One wrapper
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
MAX_G = 8     # query heads per KV head (kMidG) ...
WIDE = {192: 12}   # ... but 12 at Dh 192 (kWideDh, kMaxG): nemotron's
HEAD_DIMS = (64, 80, 96, 128, 192)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# both exports of csrc/decode_attention.cu (K1 here, K2 in
# paged_decode_attention.py): one library, one signature table
SIG = {"decode_attention_launch":
       [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
       "paged_decode_attention_launch":
       [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
       "decode_partial_launch":
       [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
        _I, _I, _I, _P],
       "decode_combine_launch":
       [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
        _I, _P]}


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


def launch_plan(b: int, hkv: int, cap: int, split: int | None = None
                ) -> Plan:
    """The launch over a (logical) capacity ``cap``; ``split`` (one of
    :data:`SPLITS`) overrides :func:`split_size` — a shard of a mesh
    cuts its cache where the whole decode's (B, Hkv) would."""
    p = split or split_size(b, hkv)
    if p not in SPLITS:
        raise ValueError(f"split {p} not in {SPLITS}")
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
    max_g = WIDE.get(dh, MAX_G)
    if hq % hkv or hq // hkv > max_g:
        raise ValueError(f"{what}: Hq={hq}, Hkv={hkv} needs "
                         f"Hq % Hkv == 0 and G <= {max_g} at Dh={dh}")
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


def row_list(lens, b: int) -> list:
    """Per-row lengths as ``b`` Python ints: ``lens`` an int, a
    sequence, or a host or card tensor (0-d or (B,))."""
    if isinstance(lens, torch.Tensor):
        lens = lens.reshape(-1).tolist()
    elif not isinstance(lens, (list, tuple)):
        lens = [int(lens)]
    lens = [int(n) for n in lens]
    return lens * b if len(lens) == 1 else lens


def positions_read(b: int, cap: int, lens=None, window=None) -> int:
    """Cache positions a call must read over all rows: every one up to
    the capacity when ``lens`` is None, else each row's valid slots —
    ``min(len, C)``, less the slot one window back that a full rolling
    row masks when ``C == window``."""
    if lens is None:
        return b * cap
    tot = 0
    for n in row_list(lens, b):
        n = max(0, n)
        tot += min(n, cap) - (window == cap and n >= cap)
    return tot


def cost(q_shape, kv_shape, dtype, lens=None, *, self_kv=True,
         window=None) -> tuple[float, float]:
    """(FLOPs, bytes) the call must do for q (B,1,Hq,Dh) over a cache
    (B,C,Hkv,Dh) of ``dtype``: QK and PV of every position read (2 x 2
    x Hq x Dh each, and the self partial's with ``self_kv``); bytes are
    q, the K/V rows read, the self K/V and the lengths read once, out
    written once. ``lens`` the real per-row lengths, or None for the
    capacity."""
    b, _, hq, dh = q_shape
    cap, hkv = kv_shape[1], kv_shape[2]
    elt = dtype.itemsize
    tot = positions_read(b, cap, lens, window)
    n_self = b if self_kv else 0
    flops = 4.0 * (tot + n_self) * hq * dh
    nbytes = ((2 * tot * hkv * dh + 2 * b * hq * dh
               + 2 * n_self * hkv * dh) * elt + 4 * b)
    return flops, float(nbytes)


def split_scratch(q: torch.Tensor, hkv: int, cap: int,
                  split: int | None = None):
    """fp32 partials (o, m, l) of pass 1 for a logical capacity ``cap``,
    and the launch plan."""
    b, _, hq, dh = q.shape
    g = hq // hkv
    plan = launch_plan(b, hkv, cap, split)
    o_part = torch.empty((b, hkv, g, plan.splits, dh), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((b, hkv, g, plan.splits), dtype=torch.float32,
                         device=q.device)
    return o_part, m_part, torch.empty_like(m_part), plan


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     extra_k: torch.Tensor | None = None,
                     extra_v: torch.Tensor | None = None,
                     window: int | None = None,
                     split: int | None = None) -> torch.Tensor:
    """q (B,1,Hq,Dh); caches (B,C,Hkv,Dh); ``cache_len`` scalar or (B,)
    valid slots per row; ``extra_k``/``extra_v`` (B,1,Hkv,Dh), the
    current token's KV, or both None. ``window``: the cache rolls (slot
    ``p % C`` holds position p); rows are valid to ``min(len, C)``, and
    when ``C == window`` a full row's slot ``len % C`` — the position
    ``window`` back — is masked. ``split``: pass 1's positions per block
    (:func:`launch_plan`). Returns (B,1,Hq,Dh)."""
    global launches
    b, _, hq, dh = q.shape
    _, cap, hkv, _ = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or k_cache.shape[0] != b:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    extras = check_operands("decode_attention", q, tuple(k_cache.shape),
                            extra_k, extra_v)
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window={window} must be >= 1")
    code = _build.launch_dtype("decode_attention", q, k_cache, v_cache,
                               *extras)
    lens = row_lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    o_part, m_part, l_part, plan = split_scratch(q, hkv, cap, split)
    lib = _build.load("decode_attention", SIG)
    _build.launch(
        lib, "decode_attention_launch", "decode_attention", q.device,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        extra_k.data_ptr() if extras else None,
        extra_v.data_ptr() if extras else None,
        lens.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), out.data_ptr(), b, cap, hkv, hq // hkv, dh,
        plan.splits, plan.split, 1.0 / math.sqrt(dh), int(window or 0),
        code, _build.stream_handle(q))
    with _build.COUNTING:
        launches += 1
    return out


def decode_attention_shard(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len, *,
                           offset: int, gather, capacity: int | None = None,
                           extra_k: torch.Tensor | None = None,
                           extra_v: torch.Tensor | None = None,
                           window: int | None = None,
                           split: int | None = None) -> torch.Tensor:
    """K1 over a cache split by position across shards: this shard holds
    slots ``offset .. offset + C - 1`` of every row in ``k_cache`` /
    ``v_cache`` (B,C,Hkv,Dh), of rows of ``capacity`` slots (by default
    ``offset + C``: the last shard); ``cache_len`` (scalar or (B,))
    counts the whole row, and ``window`` is the rolling window of the
    whole row, as :func:`decode_attention` takes it. Pass 1 runs over the
    shard's slots; ``gather(t, dim)`` concatenates every shard's ``t``
    along ``dim`` in shard order (one call per partial), and the combine
    runs over all of them with the whole row's length and the self
    partial — in shard order, then split order, then self, with no
    atomics. Where every shard holds whole splits these are the partials
    one cache's pass 1 would have written, so every shard returns K1's
    result on the whole cache. Returns (B,1,Hq,Dh); one launch in
    ``launches``."""
    global launches
    b, _, hq, dh = q.shape
    _, cap, hkv, _ = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or k_cache.shape[0] != b:
        raise ValueError(f"decode_attention_shard: shapes q "
                         f"{tuple(q.shape)} k {tuple(k_cache.shape)}")
    extras = check_operands("decode_attention_shard", q,
                            tuple(k_cache.shape), extra_k, extra_v)
    whole = offset + cap if capacity is None else int(capacity)
    if offset < 0 or whole < offset + cap:
        raise ValueError(f"decode_attention_shard: slots {offset} .. "
                         f"{offset + cap - 1} outside a row of {whole}")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention_shard: window={window} must "
                         "be >= 1")
    plan = launch_plan(b, hkv, cap, split)
    code = _build.launch_dtype("decode_attention_shard", q, k_cache,
                               v_cache, *extras)
    lens = row_lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    o_part, m_part, l_part, plan = split_scratch(q, hkv, cap, plan.split)
    lib = _build.load("decode_attention", SIG)
    g, scale = hq // hkv, 1.0 / math.sqrt(dh)
    _build.launch(
        lib, "decode_partial_launch", "decode_attention_shard", q.device,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), b, cap, hkv, g, dh, plan.splits, plan.split,
        scale, int(window or 0), offset, whole, code,
        _build.stream_handle(q))
    o_all = gather(o_part, 3).contiguous()
    m_all, l_all = gather(m_part, 3).contiguous(), gather(l_part, 3).contiguous()
    ns = o_all.shape[3]
    _build.launch(
        lib, "decode_combine_launch", "decode_attention_shard", q.device,
        q.data_ptr(), extra_k.data_ptr() if extras else None,
        extra_v.data_ptr() if extras else None, lens.data_ptr(),
        o_all.data_ptr(), m_all.data_ptr(), l_all.data_ptr(),
        out.data_ptr(), b, (ns // plan.splits) * cap, hkv, g, dh, ns,
        plan.split, scale, cap, code, _build.stream_handle(q))
    with _build.COUNTING:
        launches += 1
    return out
