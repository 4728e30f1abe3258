"""K4 — prefill over a KV cache on the card (``csrc/prefill_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_hist_bhsd``
with its two entries ``repro/kernels/ops.py::prefill_attention`` (chunked
prefill, S = chunk_tokens) and ``verify_attention`` (speculative verify,
S = gamma + 1) — except that GQA is indexed inside the kernel instead of
repeating K/V. ``launches`` counts this wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import row_lengths

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"prefill_attention_launch":
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]}
HEAD_DIMS = (64, 128)


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
    lib = _build.load("prefill_attention", _SIG)
    err = lib.prefill_attention_launch(
        q.data_ptr(), k_hist.data_ptr(), v_hist.data_ptr(),
        k_self.data_ptr(), v_self.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, s, c, hq, hkv, dh, 1.0 / math.sqrt(dh), code,
        _build.stream_handle(q))
    _build.check(lib, err, "prefill_attention")
    launches += 1
    return out
