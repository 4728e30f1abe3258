"""K6 — W4A16 GEMV/GEMM on the card (``csrc/quant_gemv.cu``).

Replaces ``repro/kernels/quant_gemv.py::quant_gemv``: ``x (B, K)``
times the int4 weight held as ``w_packed (K//2, N)`` uint8 nibbles and
``scales (K//group, N)`` fp32, accumulated in fp32, returned in x's
dtype. One wrapper call is two launches (split partials, then the
fixed-order combine) and counts once in ``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

COLS = 128         # output columns per pass-1 block (kCols in the source)
ROWS = 8           # x rows per pass-1 block at most
MAX_GROUP = 256    # kMaxGroup in the source
TARGET_BLOCKS = 132 * 8   # pass-1 blocks to aim for: 8 per SM

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"quant_gemv_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _P]}


def k_splits(b: int, k: int, n: int, group: int) -> tuple[int, int]:
    """(groups per split, splits): the K axis cut into whole groups so
    that (column tiles x splits x row tiles) comes near
    ``TARGET_BLOCKS``, no split empty."""
    ng = k // group
    tiles = -(-n // COLS) * -(-b // ROWS)
    want = min(ng, max(1, -(-TARGET_BLOCKS // tiles)))
    gps = -(-ng // want)
    return gps, -(-ng // gps)


def quant_gemv(x: torch.Tensor, w_packed: torch.Tensor,
               scales: torch.Tensor, *, group: int = 128) -> torch.Tensor:
    """x (B, K) float32 or bfloat16; w_packed (K//2, N) uint8; scales
    (K//group, N) float32; ``group`` even, at most 256, dividing K.
    Returns (B, N) in x's dtype."""
    global launches
    if x.dim() != 2 or w_packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"quant_gemv: x {tuple(x.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}, scales "
                         f"{tuple(scales.shape)} must be 2-D")
    b, k = x.shape
    kp, n = w_packed.shape
    if group < 2 or group % 2 or group > MAX_GROUP or k % group:
        raise ValueError(f"quant_gemv: group={group} must be even, at most "
                         f"{MAX_GROUP} and divide K={k}")
    if kp * 2 != k or tuple(scales.shape) != (k // group, n):
        raise ValueError(f"quant_gemv: shapes x {tuple(x.shape)} w_packed "
                         f"{tuple(w_packed.shape)} scales "
                         f"{tuple(scales.shape)} at group {group}")
    code = _build.launch_dtype("quant_gemv", x)
    # both are read element by element: no vector alignment needed
    _build.check_operand("quant_gemv", w_packed, torch.uint8, align=1)
    _build.check_operand("quant_gemv", scales, torch.float32, align=4)
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    gps, ns = k_splits(b, k, n, group)
    part = torch.empty((ns, b, n), dtype=torch.float32, device=x.device)
    lib = _build.load("quant_gemv", _SIG)
    err = lib.quant_gemv_launch(
        x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
        part.data_ptr(), out.data_ptr(), b, k, n, group, gps, ns, code,
        _build.stream_handle(x))
    _build.check(lib, err, "quant_gemv")
    launches += 1
    return out
