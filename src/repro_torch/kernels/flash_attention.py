"""K3 — causal / sliding-window / non-causal flash prefill on the card
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_bhsd``
together with its entry ``repro/kernels/ops.py::flash_attention`` —
except that GQA is indexed inside the kernel instead of repeating K/V.
``launches`` counts this wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"flash_attention_launch":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]}
HEAD_DIMS = (64, 80, 96, 128, 192)


def kept_pairs(sq: int, skv: int, *, causal=True, window=None,
               q_offset=0) -> int:
    """(query, key) pairs the masks keep: query i at ``q_offset + i``
    sees key j when j <= its position (causal) and j > its position -
    ``window``."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv - 1, p) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, p - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def cost(q_shape, kv_shape, dtype, *, causal=True, window=None,
         q_offset=0) -> tuple[float, float]:
    """(FLOPs, bytes) the call must do for q (B,Sq,Hq,Dh) against k, v
    (B,Skv,Hkv,Dh) of ``dtype``: QK and PV over the kept pairs (4 x Dh
    per pair and query head); q, k and v read once, out written once."""
    b, sq, hq, dh = q_shape
    skv, hkv = kv_shape[1], kv_shape[2]
    elt = dtype.itemsize
    pairs = kept_pairs(sq, skv, causal=causal, window=window,
                       q_offset=q_offset)
    return (4.0 * b * pairs * hq * dh,
            float((2 * b * sq * hq * dh + 2 * b * skv * hkv * dh) * elt))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,Hq,Dh); k, v (B,Skv,Hkv,Dh), Hq % Hkv == 0. Query i sits
    at absolute position ``q_offset + i``, key j at j. Returns
    (B,Sq,Hq,Dh) in q's dtype."""
    global launches
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} not a multiple of "
                         f"Hkv={hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: Dh={dh} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset={q_offset} < 0")
    code = _build.launch_dtype("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _SIG)
    _build.launch(
        lib, "flash_attention_launch", "flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        hq, hkv, dh, int(causal), int(window or 0), int(q_offset),
        1.0 / math.sqrt(dh), code, _build.stream_handle(q))
    with _build.COUNTING:
        launches += 1
    return out
