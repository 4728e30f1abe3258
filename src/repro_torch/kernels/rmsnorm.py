"""K5 — fused RMSNorm on the card (``csrc/rmsnorm.cu``).

Replaces ``repro/kernels/rmsnorm.py::rmsnorm``. ``launches`` counts the
kernel launches this wrapper made (reset by
:func:`repro_torch.kernels.ops.reset_launch_counts`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"rmsnorm_launch": [_P, _P, _P, _I, _I, _F, _I, _P]}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x (..., d), w (d,) on the card; d % 8 == 0. Returns x's dtype."""
    global launches
    d = x.shape[-1]
    if tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)} != ({d},)")
    if d % 8:
        raise ValueError(f"rmsnorm: d={d} must be a multiple of 8")
    code = _build.launch_dtype("rmsnorm", x, w)
    out = torch.empty_like(x)
    m = x.numel() // d if d else 0
    if m == 0:
        return out
    lib = _build.load("rmsnorm", _SIG)
    err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), m,
                             d, float(eps), code, _build.stream_handle(x))
    _build.check(lib, err, "rmsnorm")
    launches += 1
    return out
