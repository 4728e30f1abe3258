"""Decoder-only transformers on tensors — the dense, MoE and vlm
families: init, prefill, ragged decode on contiguous and paged caches,
chunked prefill, speculative verify.

Counterpart of ``repro/models/model.py`` for its attention families
(``TRANSFORMER_FAMILIES``): RMSNorm or LayerNorm, every MLP activation,
MoE FFNs after ``first_dense_layers`` dense ones (``params
["first_layers"]``, a list, then the stacked ``params["layers"]``), and
the vlm's stub image prefix (``batch["images"]`` (B, n_img, d), placed
before the tokens and counted in the positions):

- ``init_params(cfg, seed=, device=)`` -> params dict (layer-stacked
  leaves with a leading ``L`` axis, the reference's nested keys)
- ``init_cache(cfg, B, capacity, device=)`` -> decode cache dict;
  ``init_paged_pools(cfg, NB, bs, device=)`` -> shared block pools
- ``prefill(params, cfg, batch, capacity)`` -> (logits (B, V) fp32, cache)
- ``prefill_chunk(params, cfg, batch, k_hist, v_hist, hist_len)`` ->
  (logits, chunk KV rows)
- ``decode_step(params, cfg, tokens, cache, live=)`` -> (logits, cache)
- ``verify_tokens(params, cfg, tokens, cache, live=)`` -> (logits
  (B, S, V), cache); ``self_draft_params`` -> the self-draft pair

The reference's ``lax.scan`` over the stacked layer axis is a Python
loop over ``L`` here, and caches are written in place. Paged pools
carry one scratch block past the ``NB`` allocatable ones (id ``NB``,
the tables' sentinel): every dropped write lands there, so it can never
race a real write. Other families (recurrent, hybrid, audio) and
rolling sliding-window caches are later slices of the port and raise.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.attention import (attention, decode_attention,
                                          gather_kv_blocks,
                                          prefill_over_cache)


TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg) -> None:
    """Raise for what this slice of the port does not run yet."""
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is a later slice of the port (the "
            "recurrent, hybrid and audio families); "
            f"{', '.join(TRANSFORMER_FAMILIES)} run")
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding_window: rolling SWA caches are a later slice of the "
            "port")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random-init params from ``seed`` with an explicit generator.
    Shapes, dtypes and keys match ``repro.models.model.init_params``;
    the values do not (the JAX PRNG stream is not reproducible here —
    load reference weights through :mod:`repro_torch.bridge`). Stacked
    leaves are drawn a matrix at a time (``layers.dense_init``), so a
    full-width stack never has a float32 twin."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = L.dtype_of(cfg)
    p = {"embed": {"table": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                         dt, dev)},
         "final_norm": L.init_norm(cfg, device=dev)}
    if not cfg.tie_embeddings:
        p["head"] = L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, dev)
    n_first = n_first_layers(cfg)
    if n_first:
        p["first_layers"] = [
            _init_block(gen, cfg, (), dev, cfg.d_ff_first_dense or cfg.d_ff,
                        moe=False)
            for _ in range(n_first)]
    p["layers"] = _init_block(gen, cfg, (cfg.n_layers - n_first,), dev,
                              cfg.d_ff, moe=cfg.is_moe)
    return p


def n_first_layers(cfg) -> int:
    """Leading dense layers of an MoE config (kept apart, as a list)."""
    return cfg.first_dense_layers if cfg.is_moe else 0


def _init_block(gen, cfg, lead, dev, d_ff, *, moe) -> dict:
    """One decoder block's params with leading axes ``lead``."""
    dt = L.dtype_of(cfg)
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def dense(*shape):
        return L.dense_init(gen, (*lead, *shape), dt, dev, fan_in=shape[0])

    attn = {"wq": dense(d, hq * dh), "wk": dense(d, hkv * dh),
            "wv": dense(d, hkv * dh), "wo": dense(hq * dh, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            attn[name] = torch.zeros((*lead, width), dtype=dt, device=dev)
    p = {"ln1": L.init_norm(cfg, lead, dev), "attn": attn,
         "ln2": L.init_norm(cfg, lead, dev)}
    if moe:
        p["moe"] = M.init_moe(gen, cfg, lead, dev)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, d_ff, lead, dev)
    return p


def layer_params(tree, i: int):
    """Layer ``i``'s params: index the leading ``L`` axis of every leaf."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def blocks(params, cfg) -> list:
    """Every decoder block's params in layer order: the leading dense
    ``first_layers``, then each layer of the stack — cache layer ``i``
    belongs to block ``i``."""
    first = list(params.get("first_layers", []))
    return first + [layer_params(params["layers"], i)
                    for i in range(cfg.n_layers - len(first))]


def _head(params, cfg):
    return params["embed"]["table"] if cfg.tie_embeddings else params["head"]


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def _proj_qkv(p, cfg, x):
    """x: (B,S,d). Returns q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh)."""
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, cfg.n_heads, cfg.d_head),
            k.reshape(b, s, cfg.n_kv_heads, cfg.d_head),
            v.reshape(b, s, cfg.n_kv_heads, cfg.d_head))


def attn_full(p, cfg, x, *, positions, causal=True, window=None):
    """Full-sequence attention. Returns (out (B,S,d), (k, v))."""
    q, k, v = _proj_qkv(p, cfg, x)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=window, q_offset=0)
    return o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"], (k, v)


def attn_decode(p, cfg, x, k_cache, v_cache, cache_len, *,
                block_tables=None):
    """Single-token attention. x: (B,1,d); ``cache_len`` an int32
    tensor, 0-d or per-row (B,) — each row rotates and masks at its own
    absolute position. With ``block_tables`` (B, W) the caches are paged
    pools. Returns (out, k1, v1), the token's own KV."""
    q, k1, v1 = _proj_qkv(p, cfg, x)
    pos = cache_len.reshape(-1, 1)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k1 = L.apply_rope(k1, pos, cfg.rope_theta)
    o = decode_attention(q, k_cache, v_cache, cache_len, extra_k=k1,
                         extra_v=v1, block_tables=block_tables)
    return o.reshape(x.shape[0], 1, -1) @ p["wo"], k1, v1


def attn_chunk(p, cfg, x, k_hist, v_hist, hist_len, *, positions):
    """Prefill-over-cache attention: x (B,S,d) sits at ``positions``
    ((S,) or (B,S)), after ``hist_len`` cached rows of ``k_hist``/
    ``v_hist`` (B,C,Hkv,Dh). Returns (out (B,S,d), (k, v)) — the
    chunk's own KV, for the caller to write at offset ``hist_len``."""
    q, k, v = _proj_qkv(p, cfg, x)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = prefill_over_cache(q, k_hist, v_hist, hist_len, k, v)
    return o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# decoder blocks
# ---------------------------------------------------------------------------

def _apply_ffn(p, cfg, h):
    if "moe" in p:
        return M.apply_moe(p["moe"], cfg, h)
    return L.apply_mlp(p["mlp"], cfg, h)


# A block's input is the residual ``x`` plus the previous block's MLP
# output ``delta`` (None before the first block); its ``ln1`` adds them
# as it normalises (K5 with the add), and its ``ln2`` adds the attention
# output the same way. A block returns (residual, MLP output) un-added,
# for the next block's ``ln1`` or the final norm to add: the reference's
# adds, in its order, each fused into the norm that follows it.

def decoder_block(p, cfg, x, delta, *, positions, causal=True,
                  window=None):
    x, h = L.add_norm(p["ln1"], cfg, x, delta)
    a, (k, v) = attn_full(p["attn"], cfg, h, positions=positions,
                          causal=causal, window=window)
    x, h = L.add_norm(p["ln2"], cfg, x, a)
    return (x, _apply_ffn(p, cfg, h)), (k, v)


def decoder_block_chunk(p, cfg, x, delta, k_hist, v_hist, hist_len, *,
                        positions):
    """Decoder block over one chunk with a KV history (chunked prefill
    and speculative verify)."""
    x, h = L.add_norm(p["ln1"], cfg, x, delta)
    a, (k, v) = attn_chunk(p["attn"], cfg, h, k_hist, v_hist, hist_len,
                           positions=positions)
    x, h = L.add_norm(p["ln2"], cfg, x, a)
    return (x, _apply_ffn(p, cfg, h)), (k, v)


def decoder_block_decode(p, cfg, x, delta, k_cache, v_cache, cache_len, *,
                         block_tables=None):
    x, h = L.add_norm(p["ln1"], cfg, x, delta)
    a, k1, v1 = attn_decode(p["attn"], cfg, h, k_cache, v_cache, cache_len,
                            block_tables=block_tables)
    x, h = L.add_norm(p["ln2"], cfg, x, a)
    return (x, _apply_ffn(p, cfg, h)), k1, v1


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_struct(cfg, batch_size, capacity, dtype=None) -> dict:
    """Shape/dtype of each decode-cache leaf."""
    check_supported(cfg)
    dt = dtype or L.dtype_of(cfg)
    kshape = (cfg.n_layers, batch_size, capacity, cfg.n_kv_heads,
              cfg.d_head)
    return {"len": ((), torch.int32), "k": (kshape, dt), "v": (kshape, dt)}


def init_cache(cfg, batch_size, capacity, *, device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(sh, dtype=dt, device=dev)
            for k, (sh, dt) in cache_struct(cfg, batch_size,
                                            capacity).items()}


def paged_pool_struct(cfg, num_blocks, block_size, dtype=None) -> dict:
    """Shape/dtype of the shared paged KV pools, all layers stacked on
    the leading axis: ``num_blocks`` allocatable blocks of ``block_size``
    positions plus one scratch block, id ``num_blocks`` — the tables'
    sentinel — that is never allocated and takes every dropped write."""
    check_supported(cfg)
    dt = dtype or L.dtype_of(cfg)
    shape = (cfg.n_layers, num_blocks + 1, block_size, cfg.n_kv_heads,
             cfg.d_head)
    return {"k": (shape, dt), "v": (shape, dt)}


def init_paged_pools(cfg, num_blocks, block_size, *, device="cuda"):
    dev = resolve_device(device)
    st = paged_pool_struct(cfg, num_blocks, block_size)
    return tuple(torch.zeros(st[k][0], dtype=st[k][1], device=dev)
                 for k in ("k", "v"))


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, batch) -> torch.Tensor:
    """(B, S, d): the tokens' embeddings, after the vlm's image prefix
    ``batch["images"]`` (B, n_img, d) where the batch carries one."""
    x = L.embed_tokens(params["embed"], batch["tokens"])
    if cfg.family == "vlm" and "images" in batch:
        x = torch.cat([batch["images"].to(x.dtype), x], dim=1)
    return x


def _read_rows(logit_index, *xs):
    """Each of ``xs`` (B,S,d) -> (B,1,d) at ``logit_index`` (scalar or
    (B,)), or the last position."""
    if logit_index is None:
        return [x[:, -1:] for x in xs]
    b, dev = xs[0].shape[0], xs[0].device
    idx = torch.as_tensor(logit_index, device=dev).reshape(-1)
    idx = torch.broadcast_to(idx, (b,)).long()
    rows = torch.arange(b, device=dev)
    return [x[rows, idx][:, None] for x in xs]


def prefill(params, cfg, batch, capacity, *, logit_index=None):
    """Process the prompt. Returns (logits (B, V) fp32, cache).

    ``capacity``: the cache holds that many positions, the prompt's KV
    at ``0..S-1`` and zeros after, as in the reference. ``None`` returns
    only the prompt's rows (L, B, S, Hkv, Dh) — what the serving engine
    splices into its own cache, without building a full-capacity cache
    per admission.

    ``logit_index`` (scalar or (B,)): position to read logits from
    instead of the last — for right-padded (bucketed) prompts; positions
    count a vlm's image prefix (``batch["images"]``) first. Causal
    attention keeps pad positions out of every earlier row; their KV is
    masked at decode by the per-row cache length."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, batch)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)
    ks, vs = [], []
    delta = None
    for lp in blocks(params, cfg):
        (x, delta), (k, v) = decoder_block(lp, cfg, x, delta,
                                           positions=positions)
        ks.append(k)
        vs.append(v)
    k_all, v_all = torch.stack(ks), torch.stack(vs)
    if capacity is None:
        cache = {"k": k_all, "v": v_all}
    else:
        if s > capacity:
            raise ValueError(f"prompt of {s} positions exceeds the cache "
                             f"capacity {capacity}")
        cache = init_cache(cfg, b, capacity, device=x.device)
        cache["k"][:, :, :s] = k_all
        cache["v"][:, :, :s] = v_all
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    _, h = L.add_norm(params["final_norm"], cfg,
                      *_read_rows(logit_index, x, delta))
    return L.logits_from_hidden(_head(params, cfg), h)[:, 0], cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _write_token_kv(cache_arr, kv, slot, live=None):
    """Write one decoded token's KV ``kv`` (B, 1, H, Dh) into one layer's
    cache ``cache_arr`` (B, C, H, Dh) at ``slot`` — a scalar or a per-row
    (B,) vector — **in place** (the reference scatters functionally).
    Rows that are not ``live``, or whose slot is past the capacity, keep
    their cache exactly, like the reference's ``mode="drop"``: they
    write back the value already there, so no host sync is needed."""
    b, c = cache_arr.shape[0], cache_arr.shape[1]
    slot = torch.broadcast_to(
        torch.as_tensor(slot, device=cache_arr.device).reshape(-1), (b,))
    keep = slot < c
    if live is not None:
        keep = keep & live
    rows = torch.arange(b, device=cache_arr.device)
    slot = slot.clamp(max=c - 1).long()
    new = kv[:, 0].to(cache_arr.dtype)
    cache_arr[rows, slot] = torch.where(keep[:, None, None], new,
                                        cache_arr[rows, slot])


def _write_tokens_kv(cache_arr, kv, pos, live=None):
    """Multi-token form of :func:`_write_token_kv` for the verify
    dispatch: ``kv`` (B, S, H, Dh) lands in one layer's cache
    ``cache_arr`` (B, C, H, Dh) at per-row positions ``pos[b] ..
    pos[b] + S - 1``, in place. Non-live rows and positions past the
    capacity drop their write: they write back the value already held
    one position before the row's window — a position no kept write of
    this call targets, so a dropped write never races a real one (kept
    writes of a row are ``pos .. min(pos + S, C) - 1``, and a row only
    drops inside a live window when ``pos >= C - S + 1 >= 1``)."""
    b, c = cache_arr.shape[0], cache_arr.shape[1]
    s = kv.shape[1]
    dev = cache_arr.device
    pos = torch.broadcast_to(
        torch.as_tensor(pos, device=dev).reshape(-1), (b,)).long()
    pos2 = pos[:, None] + torch.arange(s, device=dev)[None, :]   # (B, S)
    keep = pos2 < c
    if live is not None:
        keep = keep & live.reshape(-1, 1)
    idx = torch.where(keep, pos2, (pos[:, None] - 1).clamp(min=0))
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    new = kv.to(cache_arr.dtype)
    cache_arr[rows, idx] = torch.where(keep[..., None, None], new,
                                       cache_arr[rows, idx])


def _paged_write_index(block_tab, pos, s, scratch, block_size, live=None):
    """Pool (block, offset) of positions ``pos[b] .. pos[b] + s - 1`` of
    each row through its block table (B, W): (B, s) long tensors each.
    Non-live rows, positions past the table's capacity and sentinel
    entries map to the scratch block ``scratch``, so the write is
    dropped there and never lands on a block a row owns."""
    b, w = block_tab.shape
    dev = block_tab.device
    pos = torch.broadcast_to(
        torch.as_tensor(pos, device=dev).reshape(-1), (b,)).long()
    pos2 = pos[:, None] + torch.arange(s, device=dev)[None, :]
    w_idx = (pos2 // block_size).clamp(max=w - 1)
    blk = torch.gather(block_tab.long(), 1, w_idx)
    drop = (pos2 >= w * block_size) | (blk < 0) | (blk >= scratch)
    if live is not None:
        drop = drop | ~live.reshape(-1, 1)
    return torch.where(drop, scratch, blk), pos2 % block_size


def _write_paged(pool, kv, index):
    """Scatter ``kv`` (B, s, H, Dh) into one layer's pool (NB + 1, bs, H,
    Dh) at ``index`` = :func:`_paged_write_index`'s (block, offset), in
    place. Kept writes hit distinct positions of blocks their rows own;
    dropped ones all hit the scratch block."""
    pool[index[0], index[1]] = kv.to(pool.dtype)


def decode_step(params, cfg, tokens, cache, *, live=None):
    """tokens: (B, 1) int. Returns (logits (B, V) fp32, cache).

    ``cache['len']`` is an int32 tensor, 0-d (all rows at one position —
    straight-line generation) or per-row (B,) (fully ragged continuous
    batching). ``live`` ((B,) bool, optional) freezes non-live rows:
    their KV rows and length stay exactly as they were. The cache's
    ``k``/``v`` are updated in place; its ``len`` is replaced.

    Paged caches carry ``block_tab`` (B, W): ``k``/``v`` are then the
    pools (L, NB + 1, bs, H, Dh), attention reads them through the
    tables (K2) and the token's KV lands in block ``tab[b, pos // bs]``
    at offset ``pos % bs``."""
    check_supported(cfg)
    x = L.embed_tokens(params["embed"], tokens)
    n = torch.as_tensor(cache["len"], dtype=torch.int32, device=x.device)
    btab = cache.get("block_tab")
    index = None
    if btab is not None:
        pool = cache["k"]
        index = _paged_write_index(btab, n, 1, pool.shape[1] - 1,
                                  pool.shape[2], live)
    delta = None
    for i, lp in enumerate(blocks(params, cfg)):
        (x, delta), k1, v1 = decoder_block_decode(
            lp, cfg, x, delta, cache["k"][i], cache["v"][i], n,
            block_tables=btab)
        # layer i's attention has read its cache; the token's KV lands
        # at its slot now (later layers never read layer i's rows)
        if btab is None:
            _write_token_kv(cache["k"][i], k1, n, live)
            _write_token_kv(cache["v"][i], v1, n, live)
        else:
            _write_paged(cache["k"][i], k1, index)
            _write_paged(cache["v"][i], v1, index)
    cache["len"] = n + 1 if live is None else n + live.to(torch.int32)
    _, h = L.add_norm(params["final_norm"], cfg, x, delta)
    return L.logits_from_hidden(_head(params, cfg), h)[:, 0], cache


# ---------------------------------------------------------------------------
# chunked prefill and speculative verify (prefill over a cache, K4)
# ---------------------------------------------------------------------------

def _layers_over_cache(params, cfg, x, hist, hist_len, positions, write):
    """Run every layer over ``x`` against layer ``i``'s history
    ``hist(i)`` -> (k_hist, v_hist); ``write(i, k, v)`` takes the
    layer's own KV once its attention has read the history. Returns the
    last block's (residual, MLP output), un-added."""
    delta = None
    for i, lp in enumerate(blocks(params, cfg)):
        kh, vh = hist(i)
        (x, delta), (k, v) = decoder_block_chunk(
            lp, cfg, x, delta, kh, vh, hist_len, positions=positions)
        write(i, k, v)
    return x, delta


def prefill_chunk(params, cfg, batch, k_hist, v_hist, hist_len, *,
                  logit_index=None, block_table=None):
    """One prompt chunk against cached history (chunked prefill).

    batch: ``{"tokens": (B, S)}`` — the chunk, right-padded; its first
    position sits at ``hist_len`` (int or 0-d). The first chunk of a vlm
    prompt also carries ``"images"``, which take its first positions.
    ``k_hist``/``v_hist`` (L, B, C, Hkv, Dh): per-layer views of the
    slot's cache, valid to ``hist_len``; or, with ``block_table``
    (B, W), the paged pools (L, NB + 1, bs, Hkv, Dh), gathered through
    the table layer by layer as the reference's ``chunk_paged`` closure
    gathers them. Returns
    (logits (B, V) read at ``logit_index`` within the chunk — the last
    position when None — and ks, vs (L, B, S, Hkv, Dh)): the chunk's KV
    rows, to be written at offset ``hist_len``."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    hl = torch.as_tensor(hist_len, dtype=torch.int32, device=x.device)
    positions = ((hl.reshape(-1, 1) if hl.ndim else hl)
                 + torch.arange(s, device=x.device))

    def hist(i):
        if block_table is None:
            return k_hist[i], v_hist[i]
        return (gather_kv_blocks(k_hist[i], block_table),
                gather_kv_blocks(v_hist[i], block_table))

    ks, vs = [], []
    x, delta = _layers_over_cache(
        params, cfg, x, hist, hl, positions,
        lambda i, k, v: (ks.append(k), vs.append(v)))
    _, h = L.add_norm(params["final_norm"], cfg,
                      *_read_rows(logit_index, x, delta))
    logits = L.logits_from_hidden(_head(params, cfg), h)[:, 0]
    return logits, torch.stack(ks), torch.stack(vs)


def verify_tokens(params, cfg, tokens, cache, *, live=None):
    """Verify ``S = gamma + 1`` candidate tokens per row in one dispatch.

    ``tokens`` (B, S): per row, the pending token and the draft's
    proposals; ``cache['len']`` the per-row (B,) valid history. Every
    candidate attends the row's history plus the causal prefix of its
    own window (K4 with per-row ``hist_len``). All S candidate KVs are
    written in place at ``len .. len + S - 1`` (live-masked; positions
    past the capacity, and on a paged cache past the rows' allocated
    blocks, are dropped). Returns (logits (B, S, V) fp32 — position i is
    the next-token distribution after candidate i — and the cache)."""
    check_supported(cfg)
    x = L.embed_tokens(params["embed"], tokens)
    b, s = tokens.shape
    dev = x.device
    n = torch.broadcast_to(torch.as_tensor(
        cache["len"], dtype=torch.int32, device=dev).reshape(-1), (b,))
    positions = n[:, None] + torch.arange(s, device=dev)[None, :]
    btab = cache.get("block_tab")
    kc, vc = cache["k"], cache["v"]
    if btab is None:
        if s > kc.shape[2]:
            raise ValueError(f"verify window {s} exceeds the cache "
                             f"capacity {kc.shape[2]}")

        def hist(i):
            return kc[i], vc[i]

        def write(i, k, v):
            _write_tokens_kv(kc[i], k, n, live)
            _write_tokens_kv(vc[i], v, n, live)
    else:
        index = _paged_write_index(btab, n, s, kc.shape[1] - 1, kc.shape[2],
                                  live)

        def hist(i):
            return (gather_kv_blocks(kc[i], btab),
                    gather_kv_blocks(vc[i], btab))

        def write(i, k, v):
            _write_paged(kc[i], k, index)
            _write_paged(vc[i], v, index)

    x, delta = _layers_over_cache(params, cfg, x, hist, n, positions, write)
    cache["len"] = n + (s if live is None else s * live.to(torch.int32))
    _, h = L.add_norm(params["final_norm"], cfg, x, delta)
    return L.logits_from_hidden(_head(params, cfg), h), cache


def self_draft_params(params, cfg, n_draft_layers: int):
    """Self-draft for speculative decoding: the target's embeddings,
    head and first ``k`` layers (``k`` clamped to ``[1, n_layers]``) —
    the leading dense ``first_layers`` first, then the stack. Returns
    ``(draft_params, draft_cfg)``; every leaf is a view of the target's
    tensors, not a copy."""
    check_supported(cfg)
    k = int(max(1, min(n_draft_layers, cfg.n_layers)))
    first = params.get("first_layers", [])
    n_stack = max(0, k - len(first))

    def head_of(tree):
        if isinstance(tree, dict):
            return {name: head_of(v) for name, v in tree.items()}
        return tree[:n_stack]

    dp = {"embed": params["embed"], "final_norm": params["final_norm"],
          "layers": head_of(params["layers"])}
    if first:
        dp["first_layers"] = first[:min(k, len(first))]
    if "head" in params:
        dp["head"] = params["head"]
    return dp, cfg.replace(
        n_layers=k, first_dense_layers=min(cfg.first_dense_layers, k)
        if cfg.is_moe else cfg.first_dense_layers)
