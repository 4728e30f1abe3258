"""K4 — prefill over a KV cache on the card (``csrc/prefill_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_hist_bhsd``
with its two entries ``repro/kernels/ops.py::prefill_attention`` (chunked
prefill, S = chunk_tokens) and ``verify_attention`` (speculative verify,
S = gamma + 1) — except that GQA is indexed inside the kernel instead of
repeating K/V. ``launches`` counts this wrapper's calls that launch:
one count per call, though a bf16 verify call is two launches (split
partials, then their fixed-order merge).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import positions_read, row_lengths

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"prefill_attention_launch":
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "prefill_partial_launch":
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
         _P],
        "prefill_combine_launch":
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]}
HEAD_DIMS = (64, 96, 128, 192)
SPLIT = 128        # history positions per verify split (kSplit)
VERIFY_MAX_S = 16  # bf16 calls with S at or below take the split shape


class Plan(NamedTuple):
    """How one call launches: ``splits`` (bf16 with S <= 16: split
    partials over ``ns`` history splits of ``SPLIT`` positions plus the
    self partial, then a merge) or one pass over query tiles; the fp32
    partial scratch shapes of the split shape (o, then m and l)."""
    splits: bool
    ns: int
    o_shape: tuple
    ml_shape: tuple


def launch_plan(b: int, s: int, c: int, hq: int, dh: int,
                dtype: torch.dtype) -> Plan:
    """The launch shape for q (b, s, hq, dh) over a history of capacity
    ``c``, chosen from S and the dtype alone (never from ``hist_len``,
    which stays on the device): the split count is ceil(c / SPLIT)."""
    if dtype != torch.bfloat16 or s > VERIFY_MAX_S:
        return Plan(False, 0, (), ())
    ns = -(-c // SPLIT)
    return Plan(True, ns, (b, hq, s, ns + 1, dh), (b, hq, s, ns + 1))


def cost(q_shape, hist_shape, dtype, lens=None) -> tuple[float, float]:
    """(FLOPs, bytes) the call must do for q (B,S,Hq,Dh) over a history
    (B,C,Hkv,Dh) of ``dtype`` valid to ``lens`` (the real per-row
    lengths, or None for the capacity), then its own S causal keys: QK
    and PV over every kept pair (4 x Dh per pair and query head); q,
    the history rows read, the self K/V and the lengths read once, out
    written once."""
    b, s, hq, dh = q_shape
    c, hkv = hist_shape[1], hist_shape[2]
    elt = dtype.itemsize
    tot = positions_read(b, c, lens)
    pairs = tot * s + b * s * (s + 1) // 2
    nbytes = (2 * b * s * hq * dh + (2 * tot + 2 * b * s) * hkv * dh) * elt
    return 4.0 * pairs * hq * dh, float(nbytes + 4 * b)


def live_splits(hist_len, b: int, c: int) -> list:
    """History splits each batch row's pass-1 blocks attend (the rest
    exit at once): ceil(clamp(hist_len, 0, c) / SPLIT) per row."""
    lens = row_lengths(hist_len, b, "cpu").clamp(0, c)
    return [-(-int(n) // SPLIT) for n in lens]


def _library(dh: int):
    """K4's library for head dim ``dh``: Dh 192 builds apart
    (``csrc/prefill_attention_wide.cu``)."""
    return _build.load("prefill_attention_wide" if dh == 192
                       else "prefill_attention", _SIG)


def _check(what, q, k_hist, v_hist, k_self, v_self) -> None:
    """The shape, GQA and head-dim contract of every K4 entry."""
    b, s, hq, dh = q.shape
    hkv = k_hist.shape[2]
    if (tuple(v_hist.shape) != tuple(k_hist.shape) or k_hist.shape[0] != b
            or k_hist.shape[3] != dh
            or tuple(k_self.shape) != (b, s, hkv, dh)
            or tuple(v_self.shape) != (b, s, hkv, dh)):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)} hist "
            f"{tuple(k_hist.shape)} / {tuple(v_hist.shape)} self "
            f"{tuple(k_self.shape)} / {tuple(v_self.shape)}")
    if hq % hkv:
        raise ValueError(f"{what}: Hq={hq} not a multiple of Hkv={hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: Dh={dh} not in {HEAD_DIMS}")


def prefill_attention(q: torch.Tensor, k_hist: torch.Tensor,
                      v_hist: torch.Tensor, hist_len, k_self: torch.Tensor,
                      v_self: torch.Tensor) -> torch.Tensor:
    """q (B,S,Hq,Dh) at absolute positions ``hist_len .. hist_len+S-1``;
    history ``k_hist``/``v_hist`` (B,C,Hkv,Dh) valid to ``hist_len``
    (scalar or (B,)); the queries' own ``k_self``/``v_self``
    (B,S,Hkv,Dh), causal. Returns (B,S,Hq,Dh) in q's dtype."""
    global launches
    b, s, hq, dh = q.shape
    _, c, hkv, _ = k_hist.shape
    _check("prefill_attention", q, k_hist, v_hist, k_self, v_self)
    code = _build.launch_dtype("prefill_attention", q, k_hist, v_hist,
                               k_self, v_self)
    lens = row_lengths(hist_len, b, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = launch_plan(b, s, c, hq, dh, q.dtype)
    parts = [None] * 3
    if plan.splits:  # the fp32 partials o, m, l in one scratch buffer
        n_o, n_ml = math.prod(plan.o_shape), math.prod(plan.ml_shape)
        scratch = torch.empty(n_o + 2 * n_ml, dtype=torch.float32,
                              device=q.device)
        base = scratch.data_ptr()
        parts = [base, base + 4 * n_o, base + 4 * (n_o + n_ml)]
    lib = _library(dh)
    _build.launch(
        lib, "prefill_attention_launch", "prefill_attention", q.device,
        q.data_ptr(), k_hist.data_ptr(), v_hist.data_ptr(),
        k_self.data_ptr(), v_self.data_ptr(), lens.data_ptr(), *parts,
        out.data_ptr(), b, s, c, hq, hkv, dh, plan.ns, 1.0 / math.sqrt(dh),
        code, _build.stream_handle(q))
    with _build.COUNTING:
        launches += 1
    return out


def prefill_attention_shard(q: torch.Tensor, k_hist: torch.Tensor,
                            v_hist: torch.Tensor, hist_len,
                            k_self: torch.Tensor, v_self: torch.Tensor, *,
                            offset: int, gather) -> torch.Tensor:
    """K4 over a history split by position across shards (a mesh's
    sequence-sharded chunk or verify): this shard's ``k_hist`` /
    ``v_hist`` (B,C,Hkv,Dh) hold positions ``offset .. offset + C - 1``
    of rows valid to ``hist_len`` (the whole rows', scalar or (B,)). The
    history pass runs over the shard into an unnormalised fp32 partial
    (o, m, l) per (row, query, head); ``gather(t, dim)`` concatenates
    every shard's along ``dim`` in shard order; the combine merges them
    in that order, then the queries' own causal keys ``k_self`` /
    ``v_self`` (B,S,Hkv,Dh) — no atomics, so every shard returns the
    same bits. Both dtypes, on the CUDA-core body. Returns (B,S,Hq,Dh);
    one count in ``launches`` (two launches)."""
    global launches
    b, s, hq, dh = q.shape
    _, c, hkv, _ = k_hist.shape
    _check("prefill_attention_shard", q, k_hist, v_hist, k_self, v_self)
    if offset < 0:
        raise ValueError(f"prefill_attention_shard: offset={offset} < 0")
    code = _build.launch_dtype("prefill_attention_shard", q, k_hist,
                               v_hist, k_self, v_self)
    lens = row_lengths(hist_len, b, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    o_part = torch.empty((b, hq, s, 1, dh), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((b, hq, s, 1), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    lib = _library(dh)
    scale = 1.0 / math.sqrt(dh)
    _build.launch(
        lib, "prefill_partial_launch", "prefill_attention_shard", q.device,
        q.data_ptr(), k_hist.data_ptr(), v_hist.data_ptr(), lens.data_ptr(),
        o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), b, s,
        c, hq, hkv, dh, offset, scale, code, _build.stream_handle(q))
    o_all = gather(o_part, 3).contiguous()
    m_all, l_all = gather(m_part, 3).contiguous(), gather(l_part, 3).contiguous()
    _build.launch(
        lib, "prefill_combine_launch", "prefill_attention_shard", q.device,
        q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(),
        o_all.data_ptr(), m_all.data_ptr(), l_all.data_ptr(),
        out.data_ptr(), b, s, hq, hkv, dh, o_all.shape[3], scale, code,
        _build.stream_handle(q))
    with _build.COUNTING:
        launches += 1
    return out
