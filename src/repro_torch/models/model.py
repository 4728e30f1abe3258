"""Dense decoder (qwen/llama-style) on tensors: init, prefill, ragged
decode.

Counterpart of ``repro/models/model.py`` for the dense family only:

- ``init_params(cfg, seed=, device=)`` -> params dict (layer-stacked
  leaves with a leading ``L`` axis, the reference's nested keys)
- ``init_cache(cfg, B, capacity, device=)`` -> decode cache dict
- ``prefill(params, cfg, batch, capacity)`` -> (logits (B, V) fp32, cache)
- ``decode_step(params, cfg, tokens, cache, live=)`` -> (logits, cache)

The reference's ``lax.scan`` over the stacked layer axis is a Python
loop over ``L`` here. Other families (MoE, vlm, audio, recurrent),
rolling sliding-window caches and paged block tables are later slices
of the port and raise.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, decode_attention


def check_supported(cfg) -> None:
    """Raise for what this slice of the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is a later slice of the port (MoE/vlm "
            "and then the recurrent and audio families); only 'dense' runs")
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
    load reference weights through :mod:`repro_torch.bridge`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = L.dtype_of(cfg)
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def dense(shape, fan_in):
        return L.dense_init(gen, (n, *shape), dt, dev, fan_in=fan_in)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    attn = {"wq": dense((d, hq * dh), d), "wk": dense((d, hkv * dh), d),
            "wv": dense((d, hkv * dh), d),
            "wo": dense((hq * dh, d), hq * dh)}
    if cfg.qkv_bias:
        attn.update(bq=zeros(n, hq * dh), bk=zeros(n, hkv * dh),
                    bv=zeros(n, hkv * dh))
    p = {"embed": {"table": L.embed_init(gen, (cfg.vocab_size, d), dt, dev)},
         "final_norm": {"w": ones(d)},
         "layers": {"ln1": {"w": ones(n, d)}, "attn": attn,
                    "ln2": {"w": ones(n, d)},
                    "mlp": {"w_gate": dense((d, f), d),
                            "w_up": dense((d, f), d),
                            "w_down": dense((f, d), f)}}}
    if not cfg.tie_embeddings:
        p["head"] = L.embed_init(gen, (cfg.vocab_size, d), dt, dev)
    return p


def layer_params(tree, i: int):
    """Layer ``i``'s params: index the leading ``L`` axis of every leaf."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


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


def attn_decode(p, cfg, x, k_cache, v_cache, cache_len):
    """Single-token attention. x: (B,1,d); ``cache_len`` an int32
    tensor, 0-d or per-row (B,) — each row rotates and masks at its own
    absolute position. Returns (out, k1, v1), the token's own KV."""
    q, k1, v1 = _proj_qkv(p, cfg, x)
    pos = cache_len.reshape(-1, 1)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k1 = L.apply_rope(k1, pos, cfg.rope_theta)
    o = decode_attention(q, k_cache, v_cache, cache_len, extra_k=k1,
                         extra_v=v1)
    return o.reshape(x.shape[0], 1, -1) @ p["wo"], k1, v1


# ---------------------------------------------------------------------------
# decoder blocks
# ---------------------------------------------------------------------------

def decoder_block(p, cfg, x, *, positions, causal=True, window=None):
    h = L.apply_norm(p["ln1"], cfg, x)
    a, (k, v) = attn_full(p["attn"], cfg, h, positions=positions,
                          causal=causal, window=window)
    x = x + a
    h = L.apply_norm(p["ln2"], cfg, x)
    return x + L.apply_mlp(p["mlp"], cfg, h), (k, v)


def decoder_block_decode(p, cfg, x, k_cache, v_cache, cache_len):
    h = L.apply_norm(p["ln1"], cfg, x)
    a, k1, v1 = attn_decode(p["attn"], cfg, h, k_cache, v_cache, cache_len)
    x = x + a
    h = L.apply_norm(p["ln2"], cfg, x)
    return x + L.apply_mlp(p["mlp"], cfg, h), k1, v1


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


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _read_rows(x, logit_index):
    """x (B,S,d) -> (B,1,d) at ``logit_index`` (scalar or (B,)), or the
    last position."""
    if logit_index is None:
        return x[:, -1:]
    idx = torch.as_tensor(logit_index, device=x.device).reshape(-1)
    idx = torch.broadcast_to(idx, (x.shape[0],)).long()
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def prefill(params, cfg, batch, capacity, *, logit_index=None):
    """Process the prompt. Returns (logits (B, V) fp32, cache).

    ``capacity``: the cache holds that many positions, the prompt's KV
    at ``0..S-1`` and zeros after, as in the reference. ``None`` returns
    only the prompt's rows (L, B, S, Hkv, Dh) — what the serving engine
    splices into its own cache, without building a full-capacity cache
    per admission.

    ``logit_index`` (scalar or (B,)): position to read logits from
    instead of the last — for right-padded (bucketed) prompts. Causal
    attention keeps pad positions out of every earlier row; their KV is
    masked at decode by the per-row cache length."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = decoder_block(layer_params(params["layers"], i), cfg, x,
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
    x = L.apply_norm(params["final_norm"], cfg, _read_rows(x, logit_index))
    return L.logits_from_hidden(_head(params, cfg), x)[:, 0], cache


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


def decode_step(params, cfg, tokens, cache, *, live=None):
    """tokens: (B, 1) int. Returns (logits (B, V) fp32, cache).

    ``cache['len']`` is an int32 tensor, 0-d (all rows at one position —
    straight-line generation) or per-row (B,) (fully ragged continuous
    batching). ``live`` ((B,) bool, optional) freezes non-live rows:
    their KV rows and length stay exactly as they were. The cache's
    ``k``/``v`` are updated in place; its ``len`` is replaced."""
    check_supported(cfg)
    if "block_tab" in cache:
        raise NotImplementedError(
            "paged caches (block_tab) are the next slice of the port")
    x = L.embed_tokens(params["embed"], tokens)
    n = torch.as_tensor(cache["len"], dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        x, k1, v1 = decoder_block_decode(
            layer_params(params["layers"], i), cfg, x, cache["k"][i],
            cache["v"][i], n)
        # layer i's attention has read its cache; the token's KV lands
        # at its slot now (later layers never read layer i's rows)
        _write_token_kv(cache["k"][i], k1, n, live)
        _write_token_kv(cache["v"][i], v1, n, live)
    cache["len"] = n + 1 if live is None else n + live.to(torch.int32)
    x = L.apply_norm(params["final_norm"], cfg, x)
    return L.logits_from_hidden(_head(params, cfg), x)[:, 0], cache
