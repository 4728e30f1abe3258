"""K6 — W4A16 GEMV/GEMM on the card (``csrc/quant_gemv.cu``).

Replaces ``repro/kernels/quant_gemv.py::quant_gemv``: ``x (B, K)``
times the int4 weight held as ``w_packed (K//2, N)`` uint8 nibbles and
``scales (K//group, N)`` fp32, accumulated in fp32, returned in x's
dtype. One wrapper call is one launch: the K splits of a column strip
are added, in split order, by the strip's last block to finish (a
per-strip ticket counter, left at 0 by every call).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

WARPS = 4          # warps per block (kWarps in the source)
COL_LANES = 8      # lanes along N on one packed row (kColLanes)
MMA_ROWS = 8       # x rows of a tensor-core tile (kMmaRows)
MAX_X_FLOATS = 8192          # x values a block stages (kMaxXFloats)
TARGET_WARPS = 132 * 16      # warps to aim for: 16 per SM

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"quant_gemv_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P]}


class Plan(NamedTuple):
    """How one call launches. ``mma``: on the tensor cores (bf16 x, N
    and the group multiples of 16) or the CUDA cores. Columns:
    ``strips`` strips of ``strip_cols`` = 8 x ``vec`` columns (``vec``
    bytes per weight load: 16 where it divides N, else 1). Rows:
    ``row_tiles`` tiles of ``rows`` x rows (8, the mma's N, on the
    tensor cores). K: units of ``unit`` rows, each inside one group (the
    whole group unless a block's x would outgrow ``MAX_X_FLOATS``);
    ``splits`` splits of ``WARPS`` x ``units_per_warp`` whole units (the
    last may be shorter, none empty). Grid: (strips, splits, row_tiles)
    blocks of ``WARPS`` warps."""
    mma: bool
    vec: int
    strip_cols: int
    strips: int
    rows: int
    row_tiles: int
    unit: int
    units_per_warp: int
    splits: int


def _unit(group: int, rows: int, mma: bool) -> int:
    """The K rows a warp takes as one piece: the whole group where four
    warps' x of it fits ``MAX_X_FLOATS``, else the largest divisor of the
    group that does (a multiple of 16 on the tensor cores, even on the
    CUDA cores)."""
    step = 16 if mma else 2
    top = min(group, MAX_X_FLOATS // (WARPS * rows)) // step * step
    return next(u for u in range(top, 0, -step) if group % u == 0)


def launch_plan(b: int, k: int, n: int, group: int,
                dtype=torch.bfloat16) -> Plan:
    """The launch for x (b, k) of ``dtype`` times a (k, n) int4 weight
    at an even ``group`` dividing k: one warp per (strip, row tile,
    unit) while the card holds that many (``TARGET_WARPS``), more units
    per warp beyond, and never more x than a block stages
    (``MAX_X_FLOATS``)."""
    vec = 16 if n % 16 == 0 else 1
    mma = dtype == torch.bfloat16 and vec == 16 and group % 16 == 0
    strip_cols = COL_LANES * vec
    strips = -(-n // strip_cols)
    rows = MMA_ROWS if mma else 1 if b == 1 else 2 if b == 2 else 4
    row_tiles = -(-b // rows)
    unit = _unit(group, rows, mma)
    nu = k // unit
    upw = max(1, strips * row_tiles * nu // TARGET_WARPS)
    upw = min(upw, -(-nu // WARPS), MAX_X_FLOATS // (WARPS * unit * rows))
    return Plan(mma, vec, strip_cols, strips, rows, row_tiles, unit, upw,
                -(-nu // (WARPS * upw)))


_tickets: dict = {}


def _ticket_counters(device, stream: int, count: int) -> torch.Tensor:
    """A zeroed int32 counter per (strip, row tile), one buffer per
    (device, stream): every call leaves the ones it used at 0, and calls
    on one stream run one after another, so they can share it. A buffer
    that is too small is replaced, so a CUDA graph must be captured after
    a call at its largest shape has grown the buffer."""
    t = _tickets.get((device, stream))
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _tickets[device, stream] = t
    return t


def quant_gemv(x: torch.Tensor, w_packed: torch.Tensor,
               scales: torch.Tensor, *, group: int = 128) -> torch.Tensor:
    """x (B, K) float32 or bfloat16; w_packed (K//2, N) uint8; scales
    (K//group, N) float32; ``group`` even, dividing K. Returns (B, N)
    in x's dtype."""
    global launches
    if x.dim() != 2 or w_packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"quant_gemv: x {tuple(x.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}, scales "
                         f"{tuple(scales.shape)} must be 2-D")
    b, k = x.shape
    kp, n = w_packed.shape
    if group < 2 or group % 2 or k % group:
        raise ValueError(f"quant_gemv: group={group} must be even and "
                         f"divide K={k}")
    if kp * 2 != k or tuple(scales.shape) != (k // group, n):
        raise ValueError(f"quant_gemv: shapes x {tuple(x.shape)} w_packed "
                         f"{tuple(w_packed.shape)} scales "
                         f"{tuple(scales.shape)} at group {group}")
    code = _build.launch_dtype("quant_gemv", x)
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    plan = launch_plan(b, k, n, group, x.dtype)
    # the weight is read in vec-byte vectors, the scales in float4s
    # where vec is 16
    _build.check_operand("quant_gemv", w_packed, torch.uint8,
                         align=plan.vec)
    _build.check_operand("quant_gemv", scales, torch.float32,
                         align=16 if plan.vec == 16 else 4)
    stream = _build.stream_handle(x)
    part = tickets = None
    if plan.splits > 1:
        part = torch.empty((plan.splits, b, n), dtype=torch.float32,
                           device=x.device)
        tickets = _ticket_counters(x.device, stream,
                                   plan.strips * plan.row_tiles)
    lib = _build.load("quant_gemv", _SIG)
    err = lib.quant_gemv_launch(
        x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        out.data_ptr(), b, k, n, group, plan.unit, plan.vec, plan.rows,
        plan.units_per_warp, plan.splits, code, stream)
    _build.check(lib, err, "quant_gemv")
    launches += 1
    return out
