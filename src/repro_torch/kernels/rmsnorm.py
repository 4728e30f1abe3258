"""K5 — fused residual add + RMSNorm on the card (``csrc/rmsnorm.cu``).

Replaces ``repro/kernels/rmsnorm.py::rmsnorm``, with the residual add
that precedes every norm of the model but the first fused in:
``add_rmsnorm(x, a, w)`` returns ``s = x + a`` (torch's rounding) and
``h = RMSNorm(s) * w``, one pass over memory; ``rmsnorm(x, w)`` is the
same kernel without the add. ``launches`` counts the kernel launches
this module made, with or without the add (reset by
:func:`repro_torch.kernels.ops.reset_launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

MAX_D = 8192              # the row stays in registers up to this width
VECS = (1, 2)             # 16-byte vectors a thread holds (instantiated)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"add_rmsnorm_launch": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I,
                               _I, _I, _P]}
_F32, _BF16 = torch.float32, torch.bfloat16
# (x, a or None, h) dtypes the kernel is instantiated for: those the
# model paths produce
COMBOS = {(_BF16, None, _BF16), (_BF16, _BF16, _BF16),
          (_F32, None, _F32), (_F32, _F32, _F32), (_F32, _BF16, _F32),
          (_F32, None, _BF16), (_F32, _F32, _BF16), (_F32, _BF16, _BF16)}


def launch_plan(d: int, elt: int) -> tuple[int, int]:
    """(threads, vectors a thread) for rows of ``d`` elements of
    ``elt`` bytes: one 16-byte vector a thread where a block of 1024
    threads covers the row (every bf16 row up to ``MAX_D``, float32 up
    to 4096), else two; threads a multiple of 32. Depends on d and x's
    type only, so a row is reduced in the same order with or without
    the add."""
    nvec = d * elt // 16
    v = VECS[0] if nvec <= 1024 else VECS[1]
    t = -(-nvec // v)
    return max(32, -(-t // 32) * 32), v


@functools.lru_cache(maxsize=None)
def _contract(d: int, wshape: torch.Size, xdt: torch.dtype,
              adt: torch.dtype | None, wdt: torch.dtype,
              out_dtype: torch.dtype | None) -> torch.dtype:
    """The part of :func:`check_shapes` that depends on the dtypes and
    widths only, checked once per key: h's dtype."""
    if tuple(wshape) != (d,):
        raise ValueError(f"rmsnorm: w shape {tuple(wshape)} != ({d},)")
    if d % 8 or d > MAX_D:
        raise ValueError(f"rmsnorm: d={d} must be a multiple of 8 and at "
                         f"most {MAX_D}")
    hdt = out_dtype or xdt
    if (xdt, adt, hdt) not in COMBOS or wdt != xdt:
        raise TypeError(f"add_rmsnorm: dtypes (x, a, h) {(xdt, adt, hdt)} "
                        f"with w {wdt} are not instantiated")
    return hdt


def check_shapes(x: torch.Tensor, a: torch.Tensor | None, w: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.dtype:
    """The kernel's contract on shapes and dtypes, which the plain
    version is held to as well (so a CPU run that passes does not raise
    on the card). Returns h's dtype."""
    if a is not None and a.shape != x.shape:
        raise ValueError(f"add_rmsnorm: a shape {tuple(a.shape)} != x "
                         f"shape {tuple(x.shape)}")
    return _contract(x.shape[-1], w.shape, x.dtype,
                     None if a is None else a.dtype, w.dtype, out_dtype)


@functools.lru_cache(maxsize=None)
def _launch_args(d: int, xdt: torch.dtype, adt: torch.dtype | None,
                 hdt: torch.dtype) -> tuple[int, int, int, int, int]:
    """(x, a, h dtype codes, threads, vectors a thread) of a launch."""
    codes = _build.DTYPE_CODES
    return (codes[xdt], -1 if adt is None else codes[adt], codes[hdt],
            *launch_plan(d, xdt.itemsize))


def _pointer(what: str, t: torch.Tensor, align: int = 16) -> int:
    """t's address, after :func:`_build.check_operand`'s checks of
    device, layout and alignment (its dtype is checked by the caller)."""
    if t.is_cuda and t.get_device() == 0 and t.is_contiguous():
        p = t.data_ptr()
        if p % align == 0:
            return p
    _build.check_operand(what, t, t.dtype, align=align)
    raise AssertionError("unreachable")


def add_rmsnorm(x: torch.Tensor, a: torch.Tensor | None, w: torch.Tensor,
                *, eps: float = 1e-6, out_dtype: torch.dtype | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) and a (x's shape, or None), w (d,) of x's dtype, all
    on the card; d % 8 == 0, d <= ``MAX_D``. Returns (s, h): s = x + a in
    x's dtype as torch rounds it (x itself when a is None, nothing
    written), h = RMSNorm(s) * w in ``out_dtype`` (default x's)."""
    global launches
    hdt = check_shapes(x, a, w, out_dtype)
    xp, wp = _pointer("rmsnorm x", x), _pointer("rmsnorm w", w)
    # a aligned to its share of a 16-byte x vector
    ap = None if a is None else _pointer(
        "add_rmsnorm a", a, 16 * a.element_size() // x.element_size())
    # fresh, contiguous, on x's card: aligned for the vector stores
    s = x if a is None else torch.empty_like(x)
    h = torch.empty_like(x, dtype=hdt)
    d = x.shape[-1]
    m = x.numel() // d
    if m == 0:
        return s, h
    xt, at, ht, threads, vecs = _launch_args(
        d, x.dtype, None if a is None else a.dtype, hdt)
    lib = _build.load("rmsnorm", _SIG)
    err = lib.add_rmsnorm_launch(
        xp, ap, wp, None if a is None else s.data_ptr(), h.data_ptr(), m, d,
        float(eps), xt, at, ht, threads, vecs, _build.stream_handle(x))
    _build.check(lib, err, "add_rmsnorm")
    launches += 1
    return s, h


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x (..., d), w (d,) on the card; d % 8 == 0. Returns x's dtype."""
    return add_rmsnorm(x, None, w, eps=eps)[1]
