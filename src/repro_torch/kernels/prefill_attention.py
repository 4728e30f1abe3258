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
from repro_torch.kernels.decode_attention import row_lengths

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"prefill_attention_launch":
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]}
HEAD_DIMS = (64, 96, 128)
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


def live_splits(hist_len, b: int, c: int) -> list:
    """History splits each batch row's pass-1 blocks attend (the rest
    exit at once): ceil(clamp(hist_len, 0, c) / SPLIT) per row."""
    lens = row_lengths(hist_len, b, "cpu").clamp(0, c)
    return [-(-int(n) // SPLIT) for n in lens]


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
    if (tuple(v_hist.shape) != tuple(k_hist.shape) or k_hist.shape[0] != b
            or k_hist.shape[3] != dh
            or tuple(k_self.shape) != (b, s, hkv, dh)
            or tuple(v_self.shape) != (b, s, hkv, dh)):
        raise ValueError(
            f"prefill_attention: shapes q {tuple(q.shape)} hist "
            f"{tuple(k_hist.shape)} / {tuple(v_hist.shape)} self "
            f"{tuple(k_self.shape)} / {tuple(v_self.shape)}")
    if hq % hkv:
        raise ValueError(f"prefill_attention: Hq={hq} not a multiple of "
                         f"Hkv={hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"prefill_attention: Dh={dh} not in {HEAD_DIMS}")
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
    lib = _build.load("prefill_attention", _SIG)
    err = lib.prefill_attention_launch(
        q.data_ptr(), k_hist.data_ptr(), v_hist.data_ptr(),
        k_self.data_ptr(), v_self.data_ptr(), lens.data_ptr(), *parts,
        out.data_ptr(), b, s, c, hq, hkv, dh, plan.ns, 1.0 / math.sqrt(dh),
        code, _build.stream_handle(q))
    _build.check(lib, err, "prefill_attention")
    launches += 1
    return out
