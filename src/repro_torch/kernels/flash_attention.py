"""K3 — causal / sliding-window flash prefill on the card
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_bhsd``
together with its entry ``repro/kernels/ops.py::flash_attention`` —
except that GQA is indexed inside the kernel instead of repeating K/V.
``launches`` counts this wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"flash_attention_launch":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]}
HEAD_DIMS = (64, 96, 128)


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
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        hq, hkv, dh, int(causal), int(window or 0), int(q_offset),
        1.0 / math.sqrt(dh), code, _build.stream_handle(q))
    _build.check(lib, err, "flash_attention")
    launches += 1
    return out
