"""Attention for the dense decoder: prefill (K3), ragged decode over a
contiguous (K1) or paged (K2) cache, and prefill over a cache (K4) for
chunked prefill and speculative verify.

Counterpart of ``repro/models/attention.py``. Shapes: q (B, Sq, Hq, Dh);
k, v (B, Skv, Hkv, Dh); Hq % Hkv == 0. ``q_offset`` is the absolute
position of q[0]. Softmax runs in fp32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
# the paged-cache gather (chunk and verify histories on a paged pool) is
# the plain K2's own first step
from repro_torch.kernels.ref import gather_kv_blocks  # noqa: F401

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                        kv_offset=0):
    """Naive masked softmax attention (test oracle), in fp32 with the
    probabilities cast to v's dtype as the reference does."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(dh)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = kv_offset + torch.arange(sk, device=q.device)
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    p = torch.softmax(scores.masked_fill(~ok, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, sq, hq, dh)


def attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Full-sequence attention: the flash prefill kernel (K3) on the
    card, its plain version on the CPU."""
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               q_offset=q_offset)


def prefill_over_cache(q, k_hist, v_hist, hist_len, k_self, v_self):
    """Chunked-prefill attention: one prompt chunk against cached history.

    q (B, S, Hq, Dh), RoPE applied at absolute positions ``hist_len ..
    hist_len + S - 1``; ``k_hist``/``v_hist`` (B, C, Hkv, Dh) the cached
    rows (a contiguous view, or a block-table gather of a paged pool),
    valid to ``hist_len`` (scalar or per-row (B,)); ``k_self``/``v_self``
    (B, S, Hkv, Dh) the chunk's own KV, causal. Also the speculative-
    verify attention (per-row ``hist_len``, S = gamma + 1). Runs the
    prefill-over-cache kernel (K4) on the card."""
    return ops.prefill_attention(q.contiguous(), k_hist.contiguous(),
                                 v_hist.contiguous(), hist_len,
                                 k_self.contiguous(), v_self.contiguous())


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     extra_k=None, extra_v=None, block_tables=None):
    """Single-token attention against a contiguous or paged KV cache.

    q: (B, 1, Hq, Dh); k_cache/v_cache: (B, C, Hkv, Dh); ``cache_len``
    valid slots — a scalar, or a per-row (B,) vector for fully ragged
    continuous batching. With ``block_tables`` (B, W) the caches are
    shared block pools (NB, bs, Hkv, Dh) read through the tables (no
    dense gather on the card). ``extra_k``/``extra_v`` (B, 1, Hkv, Dh):
    the current token's KV, one more always-valid slot, so the cache
    write stays outside attention. Runs the split-KV decode kernel (K1,
    contiguous) or its paged form (K2) on the card."""
    if window is not None:
        raise NotImplementedError(
            "rolling sliding-window decode is not ported yet (SWA slice)")
    if block_tables is not None:
        return ops.paged_decode_attention(q.contiguous(), k_cache, v_cache,
                                          block_tables, cache_len,
                                          extra_k=extra_k, extra_v=extra_v)
    return ops.decode_attention(q.contiguous(), k_cache, v_cache, cache_len,
                                extra_k=extra_k, extra_v=extra_v)
