"""Plain PyTorch versions of the hand-written kernels.

The CPU path of :mod:`repro_torch.kernels.ops`, and the oracle every
kernel is held to on the card. Each computes in fp32 and returns the
input dtype, with the masks of its TPU counterpart
(``repro/kernels/ref.py``, ``repro/models/attention.py``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def add_rmsnorm(x: torch.Tensor, a: torch.Tensor | None, w: torch.Tensor,
                eps: float = 1e-6, *, out_dtype: torch.dtype | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, h): s = x + a (x when a is None), then :func:`rmsnorm` of s,
    cast to ``out_dtype``."""
    s = x if a is None else x + a
    return s, rmsnorm(s, w, eps).to(out_dtype or s.dtype)


def add_rmsnorm_bwd(s: torch.Tensor, w: torch.Tensor, gh: torch.Tensor,
                    gs: torch.Tensor | None = None, eps: float = 1e-6, *,
                    add_dtype: torch.dtype | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor | None,
                               torch.Tensor]:
    """The backward of :func:`add_rmsnorm` from its sum ``s``: with
    r = rsqrt(mean(s^2) + eps), n = s * r and u = gh * w, all in fp32,
    g = gs + r * (u - n * mean(u * n)) is the cotangent of s (gs, the
    one reaching s along the residual, may be None) — gx in s's dtype,
    ga in ``add_dtype`` (None without an add) — and gw = sum over rows
    of gh * n in w's dtype."""
    sf = s.float()
    r = torch.rsqrt((sf * sf).mean(-1, keepdim=True) + eps)
    n = sf * r
    gf = gh.float()
    u = gf * w.float()
    g = r * (u - n * (u * n).mean(-1, keepdim=True))
    if gs is not None:
        g = gs.float() + g
    gw = (gf * n).reshape(-1, s.shape[-1]).sum(0).to(w.dtype)
    return (g.to(s.dtype), None if add_dtype is None else g.to(add_dtype),
            gw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,Hq,Dh); k, v (B,Skv,Hkv,Dh) — GQA grouped, not expanded.
    Query i sits at ``q_offset + i``, key j at j."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    scores = scores.masked_fill(~ok, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     extra_k: torch.Tensor | None = None,
                     extra_v: torch.Tensor | None = None,
                     window: int | None = None,
                     split: int | None = None) -> torch.Tensor:
    """q (B,1,Hq,Dh); caches (B,C,Hkv,Dh) valid to ``cache_len`` (scalar
    or (B,)); optional current-token ``extra_k``/``extra_v``
    (B,1,Hkv,Dh) merged as one always-valid self partial, exactly as
    ``repro.models.attention.decode_attention`` does — with its rolling
    mask under ``window``: slots valid to ``min(len, C)``, and when
    ``C == window`` a full row's slot ``len % C`` (the position
    ``window`` back) masked. ``split`` is the kernel's launch plan and
    changes nothing here."""
    b, _, hq, dh = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, dh)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg,
                          k_cache.float()) / math.sqrt(dh)
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    slot = torch.arange(smax, device=q.device)[None, :]
    if window is None:
        valid = slot < clen
    else:
        valid = slot < torch.clamp(clen, max=smax)
        if smax == window:
            valid = valid & ((clen < smax) | (slot != clen % smax))
    valid = torch.broadcast_to(valid, (b, smax))
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m1 = torch.clamp(scores.amax(-1), min=NEG_INF)
    p1 = torch.where(valid, torch.exp(scores - m1[..., None]), 0.0)
    l1 = p1.sum(-1)
    o1 = torch.einsum("bhgk,bkhd->bhgd", p1, v_cache.float())
    if extra_k is None:
        out = o1 / torch.clamp(l1, min=1e-30)[..., None]
    else:
        s2 = torch.einsum("bhgd,bhd->bhg", qg,
                          extra_k[:, 0].float()) / math.sqrt(dh)
        m = torch.maximum(m1, s2)
        a1, a2 = torch.exp(m1 - m), torch.exp(s2 - m)
        v2 = extra_v[:, 0].float()[:, :, None, :]
        out = (o1 * a1[..., None] + v2 * a2[..., None]) \
            / torch.clamp(l1 * a1 + a2, min=1e-30)[..., None]
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def decode_attention_shard(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len, *,
                           offset: int, gather, capacity: int | None = None,
                           extra_k: torch.Tensor | None = None,
                           extra_v: torch.Tensor | None = None,
                           window: int | None = None,
                           split: int | None = None) -> torch.Tensor:
    """:func:`decode_attention` over a cache split by position across
    shards, this one holding slots ``offset .. offset + C - 1`` of rows
    of ``capacity`` slots (by default ``offset + C``): one unnormalised
    partial (o, m, l) over the shard's valid slots — masked by their
    slot in the whole row, with :func:`decode_attention`'s rolling mask
    under ``window`` —, every shard's gathered in shard order by
    ``gather(t, dim)``, then merged with the self partial — the same
    online softmax as one cache's, summed by shard. ``split`` is the
    kernel's launch plan and changes nothing here."""
    b, _, hq, dh = q.shape
    cap, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, dh)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg,
                          k_cache.float()) / math.sqrt(dh)
    clen = torch.broadcast_to(
        torch.as_tensor(cache_len, device=q.device).reshape(-1, 1), (b, 1))
    whole = offset + cap if capacity is None else int(capacity)
    slot = offset + torch.arange(cap, device=q.device)[None, :]
    if window is None:
        valid = slot < clen
    else:
        valid = slot < torch.clamp(clen, max=whole)
        if whole == window:
            valid = valid & ((clen < whole) | (slot != clen % whole))
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    m1 = torch.clamp(scores.amax(-1), min=NEG_INF)
    p1 = torch.where(valid, torch.exp(scores - m1[..., None]), 0.0)
    o1 = torch.einsum("bhgk,bkhd->bhgd", p1, v_cache.float())
    o = gather(o1[..., None, :], 3)                 # (b, hkv, g, n, dh)
    m = gather(m1[..., None], 3)                    # (b, hkv, g, n)
    l = gather(p1.sum(-1)[..., None], 3)
    mx = m.amax(-1)
    if extra_k is not None:
        s2 = torch.einsum("bhgd,bhd->bhg", qg,
                          extra_k[:, 0].float()) / math.sqrt(dh)
        mx = torch.maximum(mx, s2)
    a = torch.exp(m - mx[..., None])
    num = (o * a[..., None]).sum(3)
    den = (l * a).sum(-1)
    if extra_k is not None:
        a2 = torch.exp(s2 - mx)
        num = num + extra_v[:, 0].float()[:, :, None, :] * a2[..., None]
        den = den + a2
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def gather_kv_blocks(pool: torch.Tensor, block_tables: torch.Tensor
                     ) -> torch.Tensor:
    """Paged-cache gather: ``pool`` (NB, bs, Hkv, Dh) through per-row
    block tables (B, W) -> dense view (B, W*bs, Hkv, Dh). Sentinel ids
    are clamped onto a real block; those rows are garbage that the
    valid length masks downstream."""
    nb, bs, hkv, dh = pool.shape
    idx = block_tables.long().clamp(0, nb - 1)
    return pool[idx].reshape(idx.shape[0], idx.shape[1] * bs, hkv, dh)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           cache_len, *, extra_k: torch.Tensor | None = None,
                           extra_v: torch.Tensor | None = None,
                           split: int | None = None) -> torch.Tensor:
    """Pools (NB,bs,Hkv,Dh) read through ``block_tables`` (B,W): the
    table gather, then :func:`decode_attention` on the dense view — the
    reference's paged decode."""
    return decode_attention(q, gather_kv_blocks(k_pool, block_tables),
                            gather_kv_blocks(v_pool, block_tables),
                            cache_len, extra_k=extra_k, extra_v=extra_v)


def prefill_attention(q: torch.Tensor, k_hist: torch.Tensor,
                      v_hist: torch.Tensor, hist_len, k_self: torch.Tensor,
                      v_self: torch.Tensor) -> torch.Tensor:
    """q (B,S,Hq,Dh) at ``hist_len .. hist_len+S-1`` against history
    (B,C,Hkv,Dh) masked to ``hist_len`` (scalar or (B,)) plus its own
    causal KV (B,S,Hkv,Dh): one fp32 softmax over history + self, as
    ``repro.kernels.ref.verify_attention_ref`` (GQA grouped)."""
    b, s, hq, dh = q.shape
    c, hkv = k_hist.shape[1], k_hist.shape[2]
    k = torch.cat([k_hist.float(), k_self.float()], dim=1)
    v = torch.cat([v_hist.float(), v_self.float()], dim=1)
    qg = q.float().reshape(b, s, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(dh)
    clen = torch.as_tensor(hist_len, device=q.device).reshape(-1, 1, 1)
    hist_ok = torch.broadcast_to(
        torch.arange(c, device=q.device)[None, None, :] < clen, (b, s, c))
    rel = torch.arange(s, device=q.device)
    self_ok = torch.broadcast_to(rel[None, :] <= rel[:, None], (b, s, s))
    ok = torch.cat([hist_ok, self_ok], dim=-1)          # (b, s, c + s)
    scores = scores.masked_fill(~ok[:, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, s, hq, dh).to(q.dtype)


def prefill_attention_shard(q: torch.Tensor, k_hist: torch.Tensor,
                            v_hist: torch.Tensor, hist_len,
                            k_self: torch.Tensor, v_self: torch.Tensor, *,
                            offset: int, gather) -> torch.Tensor:
    """:func:`prefill_attention` over a history split by position across
    shards, this one holding positions ``offset .. offset + C - 1`` of
    rows valid to ``hist_len``: one unnormalised partial (o, m, l) of
    the shard's history per (row, head, query), every shard's gathered
    in shard order by ``gather(t, dim)``, merged in that order, then the
    queries' own causal keys — the kernel's online softmax, summed by
    shard."""
    b, s, hq, dh = q.shape
    c, hkv = k_hist.shape[1], k_hist.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(b, s, hkv, g, dh)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_hist.float()) * scale
    clen = torch.broadcast_to(torch.as_tensor(
        hist_len, device=q.device).reshape(-1), (b,))
    ok = (offset + torch.arange(c, device=q.device))[None, :] < clen[:, None]
    ok = ok[:, None, None, None, :]
    sc = torch.where(ok, sc, NEG_INF)
    m1 = torch.clamp(sc.amax(-1), min=NEG_INF)           # (b, h, g, s)
    p1 = torch.where(ok, torch.exp(sc - m1[..., None]), 0.0)
    o1 = torch.einsum("bhgqk,bkhd->bhgqd", p1, v_hist.float())
    o = gather(o1[..., None, :], 4)                      # (b, h, g, s, n, dh)
    m = gather(m1[..., None], 4)                         # (b, h, g, s, n)
    l = gather(p1.sum(-1)[..., None], 4)
    ss = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_self.float()) * scale
    rel = torch.arange(s, device=q.device)
    ss = ss.masked_fill(~(rel[None, :] <= rel[:, None]), NEG_INF)
    mx = torch.maximum(m.amax(-1), ss.amax(-1))
    a = torch.exp(m - mx[..., None])
    p2 = torch.exp(ss - mx[..., None])
    num = (o * a[..., None]).sum(-2) + torch.einsum(
        "bhgqk,bkhd->bhgqd", p2, v_self.float())
    den = (l * a).sum(-1) + p2.sum(-1)
    out = num / torch.clamp(den, min=1e-30)[..., None]   # (b, h, g, s, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh).to(q.dtype)


def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 in [-8, 7] -> (K//2, N) uint8, row 2k in the low
    nibble and row 2k+1 in the high one (``repro.kernels.ref.pack_int4``,
    byte for byte)."""
    w = torch.where(w_int < 0, w_int + 16, w_int).to(torch.uint8)
    return w[0::2] | (w[1::2] << 4)


def quantize_int4(w: torch.Tensor, group: int = 128):
    """(K, N) float -> (packed (K//2, N) uint8, scales (K//group, N) f32):
    symmetric per-(group, column) int4, the reference's arithmetic step
    for step (amax / 7, floor 1e-8, round half to even, clip to [-8, 7]),
    so the bytes and scales are identical to
    ``repro.kernels.ref.quantize_int4``."""
    k, n = w.shape
    wg = w.float().reshape(k // group, group, n)
    scales = torch.clamp(wg.abs().amax(1) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(wg / scales[:, None, :]), -8, 7)
    return pack_int4(q.reshape(k, n).to(torch.int8)), scales


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """(K//2, N) uint8 -> (K, N) int8 in [-8, 7]: nibbles >= 8 are
    ``v - 16``."""
    kp, n = w_packed.shape
    lo = (w_packed & 0xF).to(torch.int8)
    hi = (w_packed >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=1).reshape(2 * kp, n)


def quant_gemv(x: torch.Tensor, w_packed: torch.Tensor,
               scales: torch.Tensor, *, group: int = 128) -> torch.Tensor:
    """W4A16 GEMV/GEMM ``x (B, K) @ dequant(w_packed, scales)``: the
    weight dequantized to fp32, the product accumulated in fp32, the
    result in x's dtype (``repro.kernels.ref.quant_gemv_ref``)."""
    s_full = scales.float().repeat_interleave(group, dim=0)     # (K, N)
    w_deq = unpack_int4(w_packed).float() * s_full
    return (x.float() @ w_deq).to(x.dtype)
