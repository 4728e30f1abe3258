"""K2 — split-KV GQA flash decode over a paged KV cache, on the card
(``csrc/decode_attention.cu``, export ``paged_decode_attention_launch``).

Replaces ``repro/kernels/decode_attention.py::decode_attention_paged_bhgd``
and, like K1, merges the current token's K/V as the always-valid self
partial of ``repro/models/attention.py::decode_attention``. The pool is
read through the block tables inside the kernel — there is no dense
gather. Same source, the same pass-1 body and the same launch plan
(``decode_attention.launch_plan``) as K1, so on a pool holding the same
logical rows as a contiguous cache the result is bitwise K1's.
One wrapper call is two launches (split partials, combine) and counts
once in ``launches``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (SIG, check_operands,
                                                  row_lengths, split_scratch)

launches = 0


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           cache_len, *, extra_k: torch.Tensor | None = None,
                           extra_v: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """q (B,1,Hq,Dh); pools (NB,bs,Hkv,Dh); ``block_tables`` (B,W) int
    block ids (entries >= NB are sentinels, masked by the length);
    ``cache_len`` scalar or (B,) valid positions per row, at most W*bs;
    ``extra_k``/``extra_v`` (B,1,Hkv,Dh) or both None. Returns
    (B,1,Hq,Dh)."""
    global launches
    b, _, hq, dh = q.shape
    nb, bs, hkv, _ = k_pool.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) \
            or block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"paged_decode_attention: shapes q {tuple(q.shape)} pools "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)} tables "
            f"{tuple(block_tables.shape)}")
    extras = check_operands("paged_decode_attention", q,
                            tuple(k_pool.shape), extra_k, extra_v)
    code = _build.launch_dtype("paged_decode_attention", q, k_pool, v_pool,
                               *extras)
    tab = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    lens = row_lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    w = tab.shape[1]
    if b == 0:
        return out
    o_part, m_part, l_part, plan = split_scratch(q, hkv, w * bs)
    lib = _build.load("decode_attention", SIG)
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        extra_k.data_ptr() if extras else None,
        extra_v.data_ptr() if extras else None,
        lens.data_ptr(), tab.data_ptr(), o_part.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(), b, w, bs, nb,
        hkv, hq // hkv, dh, plan.splits, plan.split, 1.0 / math.sqrt(dh),
        code, _build.stream_handle(q))
    _build.check(lib, err, "paged_decode_attention")
    launches += 1
    return out
