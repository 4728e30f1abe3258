"""Public kernel entry points: the hand-written kernel for a CUDA tensor,
the plain PyTorch version (:mod:`repro_torch.kernels.ref`) for a CPU
tensor. Nothing else — a kernel that fails to build or launch raises.

Counterpart of ``repro/kernels/ops.py`` (whose entries pick Pallas
interpret mode off-TPU). Layouts are the model's: q (B,S,Hq,Dh), caches
(B,C,Hkv,Dh).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import prefill_attention as _pre
from repro_torch.kernels import quant_gemv as _qg
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn

_KERNELS = {"rmsnorm": _rn, "flash_attention": _fa,
            "decode_attention": _dec, "paged_decode_attention": _pdec,
            "prefill_attention": _pre, "quant_gemv": _qg}


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def add_rmsnorm(x, a, w, *, eps=1e-6, out_dtype=None):
    """Residual add and RMSNorm over the last axis in one pass (K5):
    (s, h) with s = x + a as torch rounds it (x itself when a is None)
    and h = RMSNorm(s) * w in ``out_dtype`` (default x's dtype). The
    shape and dtype contract of the kernel holds on both devices."""
    if _on_card(x):
        return _rn.add_rmsnorm(x, a, w, eps=eps, out_dtype=out_dtype)
    _rn.check_shapes(x, a, w, out_dtype)
    return ref.add_rmsnorm(x, a, w, eps, out_dtype=out_dtype)


def rmsnorm(x, w, *, eps=1e-6):
    """RMSNorm over the last axis (K5 without the add)."""
    return add_rmsnorm(x, None, w, eps=eps)[1]


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Causal / windowed / non-causal prefill attention at absolute
    positions (K3); ``k``/``v`` may be longer or shorter than ``q``."""
    if _on_card(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len, *, extra_k=None,
                     extra_v=None, window=None):
    """Ragged split-KV decode attention with the self partial (K1), over
    a rolling sliding-window cache when ``window`` is given."""
    if _on_card(q):
        return _dec.decode_attention(q, k_cache, v_cache, cache_len,
                                     extra_k=extra_k, extra_v=extra_v,
                                     window=window)
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                extra_k=extra_k, extra_v=extra_v,
                                window=window)


def paged_decode_attention(q, k_pool, v_pool, block_tables, cache_len, *,
                           extra_k=None, extra_v=None):
    """Split-KV decode over a paged pool through block tables, with the
    self partial (K2)."""
    if _on_card(q):
        return _pdec.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                            cache_len, extra_k=extra_k,
                                            extra_v=extra_v)
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                      cache_len, extra_k=extra_k,
                                      extra_v=extra_v)


def prefill_attention(q, k_hist, v_hist, hist_len, k_self, v_self):
    """Chunked-prefill attention over cached history plus the chunk's own
    causal KV (K4)."""
    if _on_card(q):
        return _pre.prefill_attention(q, k_hist, v_hist, hist_len, k_self,
                                      v_self)
    return ref.prefill_attention(q, k_hist, v_hist, hist_len, k_self, v_self)


def verify_attention(q, k_hist, v_hist, hist_len, k_self, v_self):
    """Speculative-verify attention: each row's S = gamma + 1 candidates
    at its own ``hist_len`` (per-row (B,)) — the same kernel (K4)."""
    return prefill_attention(q, k_hist, v_hist, hist_len, k_self, v_self)


def quant_gemv(x, w_packed, scales, *, group=128):
    """W4A16 GEMV/GEMM: x (B, K) @ the int4 weight ``w_packed``
    (K//2, N) uint8 with per-group ``scales`` (K//group, N), fp32
    accumulation, x's dtype out (K6)."""
    if _on_card(x):
        return _qg.quant_gemv(x, w_packed, scales, group=group)
    return ref.quant_gemv(x, w_packed, scales, group=group)


def launch_counts() -> dict:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
