"""K5 — fused residual add + RMSNorm on the card (``csrc/rmsnorm.cu``).

Replaces ``repro/kernels/rmsnorm.py::rmsnorm``, with the residual add
that precedes every norm of the model but the first fused in:
``add_rmsnorm(x, a, w)`` returns ``s = x + a`` (torch's rounding) and
``h = RMSNorm(s) * w``, one pass over memory; ``rmsnorm(x, w)`` is the
same kernel without the add. ``launches`` counts the kernel launches
this module made, with or without the add (reset by
:func:`repro_torch.kernels.ops.reset_launch_counts`).

K5b, :func:`add_rmsnorm_bwd`, is its backward (the same source): from
``s``, ``w`` and the cotangents of ``h`` and ``s`` it gives those of x,
a and w; ``bwd_launches`` counts its calls. It has no TPU counterpart —
it is the gradient XLA derives from the reference's plain RMSNorm — and
:func:`repro_torch.kernels.ops.add_rmsnorm` runs it as the backward of
K5 under autograd.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0
bwd_launches = 0

MAX_D = 8192              # the row stays in registers up to this width
VECS = (1, 2)             # 16-byte vectors a thread holds (instantiated)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"add_rmsnorm_launch": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I,
                               _I, _I, _P],
        "add_rmsnorm_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _F, _I, _I, _I, _I, _I, _I, _P]}
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


# K5b's grid: enough blocks of the forward's width to fill the card's
# 132 SMs with ``RESIDENT_THREADS`` threads each, at most one per row
SMS = 132
RESIDENT_THREADS = 1024


def bwd_launch_plan(m: int, d: int, elt: int) -> tuple[int, int, int]:
    """(threads, vectors a thread, blocks) of K5b over ``m`` rows of
    ``d`` elements of ``elt`` bytes: the forward's block shape
    (:func:`launch_plan`), and ``min(m, ceil(SMS * RESIDENT_THREADS /
    threads))`` blocks, each over rows ``b, b + blocks, ...``. Depends on
    m, d and x's type only, so gw's partials — one per block, summed in
    a fixed order — are the same from run to run."""
    threads, vecs = launch_plan(d, elt)
    return threads, vecs, min(m, -(-SMS * RESIDENT_THREADS // threads))


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


def cost(x_shape, dtype, *, add_dtype=None, out_dtype=None
         ) -> tuple[float, float]:
    """(FLOPs, bytes) of one call over x (..., d) of ``dtype`` (w of the
    same), with the residual of ``add_dtype`` (None: no add) and h of
    ``out_dtype`` (default x's): elementwise operations, 4 a value (5
    with the add); x, a and w read once, s (with the add) and h
    written once."""
    d = x_shape[-1]
    m = 1
    for n in x_shape[:-1]:
        m *= n
    ex = dtype.itemsize
    per_row = ex + (out_dtype or dtype).itemsize
    if add_dtype is not None:
        per_row += add_dtype.itemsize + ex
    return ((5.0 if add_dtype is not None else 4.0) * m * d,
            float(m * d * per_row + d * ex))


def bwd_cost(x_shape, dtype, *, add_dtype=None, out_dtype=None,
             residual=True) -> tuple[float, float]:
    """(FLOPs, bytes) of one K5b call over s (..., d) of ``dtype`` (w of
    the same), h of ``out_dtype`` (default s's), the forward's residual
    of ``add_dtype`` (None: no add, so no ga) and a cotangent of s along
    the residual (``residual``): 11 operations a value; s, gh, gs and w
    read once, gx, ga and gw written once. The fp32 partials of gw the
    kernel exchanges through memory are its own overhead, not counted."""
    d = x_shape[-1]
    m = 1
    for n in x_shape[:-1]:
        m *= n
    ex = dtype.itemsize
    per_row = 2 * ex + (out_dtype or dtype).itemsize
    if residual:
        per_row += ex
    if add_dtype is not None:
        per_row += add_dtype.itemsize
    return 11.0 * m * d, float(m * d * per_row + 2 * d * ex)


def _pointer(what: str, t: torch.Tensor, card: int, align: int = 16) -> int:
    """t's address, after :func:`_build.check_operand`'s checks of
    device, layout and alignment (its dtype is checked by the caller) and
    a check that it lies on CUDA device ``card``, x's."""
    if t.is_cuda and t.get_device() == card and t.is_contiguous():
        p = t.data_ptr()
        if p % align == 0:
            return p
    _build.check_operand(what, t, t.dtype, align=align)
    raise ValueError(f"{what}: operands on cuda:{card} and {t.device}; "
                     "one launch takes operands of one device")


def add_rmsnorm(x: torch.Tensor, a: torch.Tensor | None, w: torch.Tensor,
                *, eps: float = 1e-6, out_dtype: torch.dtype | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) and a (x's shape, or None), w (d,) of x's dtype, all
    on the card; d % 8 == 0, d <= ``MAX_D``. Returns (s, h): s = x + a in
    x's dtype as torch rounds it (x itself when a is None, nothing
    written), h = RMSNorm(s) * w in ``out_dtype`` (default x's)."""
    global launches
    hdt = check_shapes(x, a, w, out_dtype)
    card = x.get_device()
    xp, wp = _pointer("rmsnorm x", x, card), _pointer("rmsnorm w", w, card)
    # a aligned to its share of a 16-byte x vector
    ap = None if a is None else _pointer(
        "add_rmsnorm a", a, card, 16 * a.element_size() // x.element_size())
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
    _build.launch(
        lib, "add_rmsnorm_launch", "add_rmsnorm", x.device, xp, ap, wp,
        None if a is None else s.data_ptr(), h.data_ptr(), m, d, float(eps),
        xt, at, ht, threads, vecs, _build.stream_handle(x))
    with _build.COUNTING:
        launches += 1
    return s, h


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x (..., d), w (d,) on the card; d % 8 == 0. Returns x's dtype."""
    return add_rmsnorm(x, None, w, eps=eps)[1]


def check_bwd(s: torch.Tensor, w: torch.Tensor, gh: torch.Tensor,
              gs: torch.Tensor | None, add_dtype: torch.dtype | None
              ) -> None:
    """K5b's contract, held by the plain version too: the forward's
    (:func:`check_shapes`, h of gh's dtype) and the cotangents of s's
    shape, gs of s's dtype."""
    _contract(s.shape[-1], w.shape, s.dtype, add_dtype, w.dtype, gh.dtype)
    if gh.shape != s.shape or (gs is not None and gs.shape != s.shape):
        raise ValueError(f"add_rmsnorm_bwd: cotangent shapes "
                         f"{tuple(gh.shape)}, "
                         f"{None if gs is None else tuple(gs.shape)} != s "
                         f"shape {tuple(s.shape)}")
    if gs is not None and gs.dtype != s.dtype:
        raise TypeError(f"add_rmsnorm_bwd: gs dtype {gs.dtype} != s dtype "
                        f"{s.dtype}")


def add_rmsnorm_bwd(s: torch.Tensor, w: torch.Tensor, gh: torch.Tensor,
                    gs: torch.Tensor | None = None, *,
                    add_dtype: torch.dtype | None = None, eps: float = 1e-6
                    ) -> tuple[torch.Tensor, torch.Tensor | None,
                               torch.Tensor]:
    """K5b on the card: s (..., d) — the forward's sum, or its x where it
    had no add —, w (d,) of s's dtype, gh (s's shape, h's dtype) and gs
    (s's shape and dtype, or None). Returns (gx, ga, gw): gx in s's
    dtype, ga in ``add_dtype`` (None when the forward had no add), gw in
    w's dtype."""
    global bwd_launches
    check_bwd(s, w, gh, gs, add_dtype)
    card = s.get_device()
    sp, wp = _pointer("rmsnorm_bwd s", s, card), _pointer("rmsnorm_bwd w",
                                                         w, card)
    ghp = _pointer("rmsnorm_bwd gh", gh, card,
                   16 * gh.element_size() // s.element_size())
    gsp = None if gs is None else _pointer("rmsnorm_bwd gs", gs, card)
    gx = torch.empty_like(s)
    ga = None if add_dtype is None else torch.empty_like(s, dtype=add_dtype)
    gw = torch.empty_like(w)
    d = s.shape[-1]
    m = s.numel() // d
    if m == 0:
        return gx, ga, gw.zero_()
    threads, vecs, blocks = bwd_launch_plan(m, d, s.element_size())
    part = torch.empty((blocks, d), dtype=torch.float32, device=s.device)
    xt, at, ht, _, _ = _launch_args(d, s.dtype, add_dtype, gh.dtype)
    lib = _build.load("rmsnorm", _SIG)
    _build.launch(
        lib, "add_rmsnorm_bwd_launch", "add_rmsnorm_bwd", s.device, sp, wp,
        ghp, gsp, gx.data_ptr(), None if ga is None else ga.data_ptr(),
        gw.data_ptr(), part.data_ptr(), m, d, float(eps), xt, at, ht,
        threads, vecs, blocks, _build.stream_handle(s))
    with _build.COUNTING:
        bwd_launches += 1
    return gx, ga, gw
