"""Attention for the decoder families: prefill (K3: causal, windowed or
non-causal, self- or cross-attention), ragged decode over a contiguous
— possibly rolling — (K1) or paged (K2) cache, and prefill over a cache
(K4) for chunked prefill and speculative verify; and the training path's
differentiable attention, :func:`chunked_attention` (the kernels have no
backward; the reference trains through its plain-JAX form too).

Counterpart of ``repro/models/attention.py``. Shapes: q (B, Sq, Hq, Dh);
k, v (B, Skv, Hkv, Dh); Hq % Hkv == 0. ``q_offset`` is the absolute
position of q[0]. Softmax runs in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints as H
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import split_size
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


class _Bf16Grad(torch.autograd.Function):
    """Identity whose cotangent is cast to bf16 (the reference's §Perf C7
    ``bf16_grad``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def bf16_grad(x):
    """Identity with a bf16 cotangent: fp32 accumulation stays inside
    attention, the gradient streamed back through the projections is
    bf16."""
    return _Bf16Grad.apply(x)


def _block_visible(qc0, qc1, kc0, kc1, causal, window) -> bool:
    """Static reachability of kv block [kc0, kc1) from q block [qc0,
    qc1)."""
    if causal and kc0 > qc1 - 1:
        return False
    if window is not None and kc1 - 1 <= qc0 - window:
        return False
    return True


def _mask_scores(s, q_pos, k_pos, causal, window):
    """s (..., Sq, Sk) with the causal / window mask at absolute
    positions q_pos (Sq,), k_pos (Sk,)."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=s.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return s.masked_fill(~ok, NEG_INF)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_offset=0, q_chunk=1024, kv_chunk=1024):
    """Flash-style online-softmax attention in plain torch, differentiable
    (the reference's ``chunked_attention``): static query chunks, each
    over the kv blocks its causal and window masks can reach (static
    block skipping), an online softmax across them in fp32; GQA keys and
    values expanded to every query head first, as the reference does. A
    block is masked only where the mask hides something in it (the
    reference masks every block: the same values).
    Scores and the probability-weighted values are exact fp32 products
    of the inputs (the reference's ``preferred_element_type=f32``), the
    probabilities cast to v's dtype first."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    nq, nk = -(-sq // q_chunk), -(-sk // kv_chunk)
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype)

    def heads(t, n):
        """(B, S, H, D) -> fp32 (B, H, S, D), padded to n positions
        (padded keys are masked off by position)."""
        t = t.transpose(1, 2).float().contiguous()
        return F.pad(t, (0, 0, 0, n - t.shape[2]))

    # every operand converted and laid out once, then cut into its
    # chunks: a chunk's gradient lands in its own piece, and the pieces
    # are joined by one concatenation
    q_parts = heads(q * scale, nq * q_chunk).split(q_chunk, dim=2)
    k_parts = heads(k, nk * kv_chunk).split(kv_chunk, dim=2)
    v_parts = heads(v, nk * kv_chunk).split(kv_chunk, dim=2)
    dev = q.device
    outs = []
    for qi, qc in enumerate(q_parts):
        q0 = q_offset + qi * q_chunk
        q_pos = q0 + torch.arange(q_chunk, device=dev)
        visible = [ki for ki in range(nk) if _block_visible(
            q0, q0 + q_chunk, kv_offset + ki * kv_chunk,
            kv_offset + (ki + 1) * kv_chunk, causal, window)]
        if not visible:
            outs.append(torch.zeros_like(qc, dtype=q.dtype))
            continue
        for n, ki in enumerate(visible):
            s = torch.matmul(qc, k_parts[ki].transpose(-1, -2))
            k0 = kv_offset + ki * kv_chunk
            k_pos = k0 + torch.arange(kv_chunk, device=dev)
            # a mask only where it hides something: the block crosses the
            # diagonal, reaches back past the window, or holds padding
            cross = causal and k0 + kv_chunk - 1 > q0
            back = window is not None and k0 <= q0 + q_chunk - 1 - window
            if cross or back:
                s = _mask_scores(s, q_pos, k_pos, causal, window)
            if k0 + kv_chunk > kv_offset + sk:
                s = s.masked_fill(
                    (k_pos >= kv_offset + sk)[None, None, None], NEG_INF)
            # the first block starts the running max, sum and output
            # (the reference's max with -1e30, times-0 and plus-0 are
            # exact there)
            m_new = s.amax(-1) if n == 0 else torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            pv = torch.matmul(p.to(v.dtype).float(), v_parts[ki])
            if n == 0:
                l, acc = p.sum(-1), pv
            else:
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)[:, :sq]


def attention(q, k, v, *, causal=True, window=None, q_offset=0,
              impl="pallas", q_chunk=1024, kv_chunk=1024):
    """Full-sequence attention by ``impl``: ``"pallas"`` — the flash
    prefill kernel (K3) on the card, its plain version on the CPU, the
    serving path's (no backward); ``"reference"`` — the naive masked
    softmax; ``"chunked"`` — :func:`chunked_attention`, or the naive one
    where Sq * Skv <= 256 * 256 (the reference's rule for both plain
    forms; its ``"pallas"`` also falls back there, the port's always
    runs K3, as its serving has)."""
    if impl == "pallas":
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, q_offset=q_offset)
    if impl not in ("reference", "chunked"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "reference" or q.shape[1] * k.shape[1] <= 256 * 256:
        return reference_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)


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
    """Single-token attention against a contiguous (possibly rolling) or
    paged KV cache.

    q: (B, 1, Hq, Dh); k_cache/v_cache: (B, C, Hkv, Dh); ``cache_len``
    valid slots — a scalar, or a per-row (B,) vector for fully ragged
    continuous batching. With ``window`` the cache is a rolling buffer
    (slot ``p % C`` holds position p): every slot is valid once
    ``cache_len >= C``, and when ``C == window`` slot ``cache_len % C``,
    the position ``window`` back, is masked. With ``block_tables``
    (B, W) the caches are shared block pools (NB, bs, Hkv, Dh) read
    through the tables (no dense gather on the card); a paged cache
    never rolls. ``extra_k``/``extra_v`` (B, 1, Hkv, Dh): the current
    token's KV, one more always-valid slot, so the cache write stays
    outside attention; both None for cross-attention over a fixed
    encoder cache. Runs the split-KV decode kernel (K1, contiguous) or
    its paged form (K2) on the card.

    On a mesh each rank's kernel cuts its cache where the whole decode's
    (B, Hkv) would (:func:`mesh_split`); in the sequence layout the
    rank's cache holds a range of positions and K1 runs as
    ``decode_attention_shard``: pass 1 over the range, every rank's
    partials gathered in shard order, one combine."""
    kw = {}
    split = mesh_split()
    if split is not None:
        kw["split"] = split
    if block_tables is not None:
        if window is not None:
            raise ValueError("a paged KV cache never rolls: sliding-window "
                             "decode needs a contiguous cache")
        return ops.paged_decode_attention(q.contiguous(), k_cache, v_cache,
                                          block_tables, cache_len,
                                          extra_k=extra_k, extra_v=extra_v,
                                          **kw)
    if H.attn_layout() == "seq":
        if window is not None:
            raise NotImplementedError(
                "the sequence-sharded decode takes a cache without a "
                "rolling window")
        return ops.decode_attention_shard(
            q.contiguous(), k_cache, v_cache, cache_len,
            offset=H.kv_offset(k_cache.shape[1]),
            gather=H.gather_positions, extra_k=extra_k, extra_v=extra_v,
            **kw)
    return ops.decode_attention(q.contiguous(), k_cache, v_cache, cache_len,
                                extra_k=extra_k, extra_v=extra_v,
                                window=window, **kw)


def mesh_split() -> int | None:
    """Pass 1's positions per block on a mesh: the split the whole
    decode's (batch, KV heads) gives (``H.decode_plan``), so a shard with
    fewer rows or heads sums each head's positions in the single
    device's blocks; None off a mesh."""
    plan = H.decode_plan()
    return None if plan is None else split_size(*plan)
