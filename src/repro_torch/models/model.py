"""Every model family of the registry on tensors — the dense, MoE and
vlm decoders, the audio encoder–decoder and the recurrent families:
init, prefill, ragged decode on contiguous and paged caches, chunked
prefill, speculative verify.

Counterpart of ``repro/models/model.py``: its attention families
(``TRANSFORMER_FAMILIES``), its audio family and its recurrent ones
(``RECURRENT_FAMILIES``). RMSNorm or LayerNorm,
every MLP activation, MoE FFNs after ``first_dense_layers`` dense ones
(``params["first_layers"]``, a list, then the stacked
``params["layers"]``), the vlm's stub image prefix (``batch["images"]``
(B, n_img, d), placed before the tokens and counted in the positions),
rolling sliding-window caches (``cfg.sliding_window``: the cache holds
``min(capacity, window)`` slots and position p lives at slot ``p % C``)
and whisper's encoder–decoder (``batch["frames"]`` (B, encoder_len, d)
through ``params["enc_layers"]`` and ``"enc_norm"``; each decoder layer
adds cross-attention, ``"ln_x"`` and ``"xattn"``, over the encoder
output, whose per-layer K/V the cache keeps as ``cross_k``/``cross_v``;
sinusoidal positions, no RoPE); xLSTM (family ``ssm``: ``n_super``
super-blocks of ``slstm_every - 1`` mLSTMs, ``params["mlstm"]`` stacked
(n_super, n_m_inner, ...), then one sLSTM, ``params["slstm"]`` stacked
(n_super, ...)) and Zamba2 (family ``hybrid``: ``n_groups`` groups of
``attn_every`` Mamba2 layers, ``params["mamba"]`` stacked (n_groups,
attn_every, ...) with a ``ln`` and a ``mamba`` per layer, each group
followed by the one unstacked ``params["shared"]`` decoder block, whose
K/V the cache keeps per application). Their caches hold O(1) state per
slot — ``ssm``, ``conv``, ``mlstm``, ``slstm_c/n/h`` — beside any
``k``/``v``, and their prefill takes the reference's ``length=``: a
right-padded prompt's pads get decay 1 and zero input, so its state is
bitwise the exact-length prompt's.

- ``init_params(cfg, seed=, device=)`` -> params dict (layer-stacked
  leaves with a leading ``L`` axis, the reference's nested keys;
  ``device="meta"``: shapes only)
- ``init_cache(cfg, B, capacity, device=)`` -> decode cache dict;
  ``init_paged_pools(cfg, NB, bs, device=)`` -> shared block pools;
  ``cache_spec``, ``paged_cache_spec``, ``batch_spec`` -> the same as
  meta tensors, for the cost model
- ``prefill(params, cfg, batch, capacity)`` -> (logits (B, V) fp32, cache)
- ``prefill_chunk(params, cfg, batch, k_hist, v_hist, hist_len)`` ->
  (logits, chunk KV rows)
- ``decode_step(params, cfg, tokens, cache, live=)`` -> (logits, cache)
- ``verify_tokens(params, cfg, tokens, cache, live=)`` -> (logits
  (B, S, V), cache); ``self_draft_params`` -> the self-draft pair
- ``forward(params, cfg, batch, attn_impl=)`` -> full-sequence fp32
  logits (B, S, V) and ``loss_fn(params, cfg, batch)`` -> (loss,
  metrics): the training path, differentiable end to end — the norms'
  K5 with its backward K5b, attention by ``attn_impl`` (``"chunked"``:
  :func:`~repro_torch.models.attention.chunked_attention`), each layer
  under ``cfg.remat``'s activation checkpointing (:func:`_remat`);
  ``make_dummy_batch`` -> a random batch of a kind

The reference's ``lax.scan`` over the stacked layer axis is a Python
loop over ``L`` here, and caches are written in place. Paged pools
carry one scratch block past the ``NB`` allocatable ones (id ``NB``,
the tables' sentinel): every dropped write lands there, so it can never
race a real write. Chunked prefill, speculative verify, paged pools and
the self-draft take the attention families without a rolling window
only, as in the reference.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.distributed import hints as H
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.attention import (attention, bf16_grad,
                                          decode_attention,
                                          gather_kv_blocks,
                                          prefill_over_cache)


TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
RECURRENT_FAMILIES = ("ssm", "hybrid")   # O(1)-state decode; prefill
# length-masked over a right-padded bucket
PORTED_FAMILIES = TRANSFORMER_FAMILIES + ("audio",) + RECURRENT_FAMILIES
SLSTM_LEAVES = ("slstm_c", "slstm_n", "slstm_h")


def check_supported(cfg) -> None:
    """Raise for a family the port does not know."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; "
                         f"{', '.join(PORTED_FAMILIES)} run")


def xlstm_dims(cfg) -> tuple[int, int]:
    """(n_super, n_m_inner) of an xLSTM: super-blocks of ``slstm_every
    - 1`` mLSTMs and one sLSTM, or one block of ``n_layers`` mLSTMs."""
    every = cfg.slstm_every or (cfg.n_layers + 1)
    n_super = max(1, cfg.n_layers // every)
    return n_super, (every - 1 if cfg.slstm_every else cfg.n_layers)


def n_groups(cfg) -> int:
    """Zamba2's groups: ``attn_every`` Mamba2 layers, then the shared
    block."""
    return cfg.n_layers // cfg.attn_every


def _use_rope(cfg) -> bool:
    """RoPE on q/k (the decoders); whisper adds sinusoids to its inputs
    instead."""
    return cfg.family in ("dense", "moe", "vlm", "hybrid")


def _kv_capacity(cfg, capacity: int) -> int:
    """Slots of a self-attention cache: a rolling sliding-window cache
    holds at most ``window`` of them."""
    if cfg.sliding_window is not None:
        return min(capacity, cfg.sliding_window)
    return capacity


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random-init params from ``seed`` with an explicit generator.
    Shapes, dtypes and keys match ``repro.models.model.init_params``;
    the values do not (the JAX PRNG stream is not reproducible here —
    load reference weights through :mod:`repro_torch.bridge`). Stacked
    leaves are drawn a matrix at a time (``layers.dense_init``), so a
    full-width stack never has a float32 twin. ``device="meta"`` returns
    the tree as empty meta leaves of the same shapes and dtypes (no
    generator, no storage): the cost model's parameter spec."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dt = L.dtype_of(cfg)
    p = {"embed": {"table": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                         dt, dev)},
         "final_norm": L.init_norm(cfg, device=dev)}
    if not cfg.tie_embeddings:
        p["head"] = L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, dev)
    if cfg.family == "ssm":
        n_super, n_inner = xlstm_dims(cfg)
        p["mlstm"] = X.init_mlstm(gen, cfg, (n_super, n_inner), dev)
        if cfg.slstm_every:
            p["slstm"] = X.init_slstm(gen, cfg, (n_super,), dev)
        return p
    if cfg.family == "hybrid":
        lead = (n_groups(cfg), cfg.attn_every)
        p["mamba"] = {"ln": L.init_norm(cfg, lead, dev),
                      "mamba": S.init_mamba2(gen, cfg, lead, dev)}
        p["shared"] = _init_block(gen, cfg, (), dev, cfg.d_ff, moe=False)
        return p
    if cfg.family == "audio":
        p["enc_layers"] = _init_block(gen, cfg, (cfg.n_encoder_layers,), dev,
                                      cfg.d_ff, moe=False)
        p["enc_norm"] = L.init_norm(cfg, device=dev)
        p["layers"] = _init_block(gen, cfg, (cfg.n_layers,), dev, cfg.d_ff,
                                  moe=False, cross=True)
        return p
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


def _init_attn(gen, cfg, lead, dev) -> dict:
    """One attention's projections with leading axes ``lead``."""
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
    return attn


def _init_block(gen, cfg, lead, dev, d_ff, *, moe, cross=False) -> dict:
    """One decoder block's params with leading axes ``lead``; ``cross``
    adds whisper's cross-attention (``ln_x``, ``xattn``)."""
    p = {"ln1": L.init_norm(cfg, lead, dev),
         "attn": _init_attn(gen, cfg, lead, dev),
         "ln2": L.init_norm(cfg, lead, dev)}
    if moe:
        p["moe"] = M.init_moe(gen, cfg, lead, dev)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, d_ff, lead, dev)
    if cross:
        p["ln_x"] = L.init_norm(cfg, lead, dev)
        p["xattn"] = _init_attn(gen, cfg, lead, dev)
    return p


def layer_params(tree, i: int):
    """Layer ``i``'s params: index the leading ``L`` axis of every leaf."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked subtree, each leaf split
    along its leading axis by one ``torch.unbind`` (under autograd one
    backward node a leaf, which stacks the layers' gradients at once)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"stacked leaf of {tree.shape[0]} layers, "
                         f"expected {n}")
    return list(torch.unbind(tree, 0))


def blocks(params, cfg) -> list:
    """Every decoder block's params in layer order: the leading dense
    ``first_layers``, then each layer of the stack — cache layer ``i``
    belongs to block ``i``."""
    first = list(params.get("first_layers", []))
    return first + [layer_params(params["layers"], i)
                    for i in range(cfg.n_layers - len(first))]


def _head(params, cfg):
    return params["embed"]["table"] if cfg.tie_embeddings else params["head"]


def _logits(params, cfg, h):
    """fp32 logits (..., V) of the final hidden ``h``: on a mesh the
    vocab-sharded head's columns gathered to the whole vocab."""
    return H.logits(L.logits_from_hidden(_head(params, cfg), h),
                    cfg.vocab_size)


def _embed(params, cfg, tokens):
    return L.embed_tokens(params["embed"], tokens, cfg.vocab_size)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def _proj_q(p, cfg, x, mm=torch.matmul):
    """x: (B,S,d) -> q (B,S,Hq,Dh); ``mm`` computes the product. On a
    mesh the product holds the rank's columns: its own heads (the shard
    config's ``n_heads``), or gathered to every head where the layout
    keeps them all (:func:`~repro_torch.distributed.hints.heads`); a
    whole bias is cut to the rank's columns."""
    q = H.heads(mm(x, p["wq"]), cfg.n_heads * cfg.d_head)
    if cfg.qkv_bias:
        q = q + H.local_cols(p["bq"], q.shape[-1])
    return q.reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.d_head)


def _proj_qkv(p, cfg, x, kv_x=None, mm=torch.matmul):
    """x: (B,S,d); ``kv_x`` (B,Skv,d), the keys' and values' input for
    cross-attention (x itself when None). Returns q (B,S,Hq,Dh), k/v
    (B,Skv,Hkv,Dh), each on a mesh as :func:`_proj_q` says."""
    kv_x = x if kv_x is None else kv_x
    b, skv, _ = kv_x.shape
    width = cfg.n_kv_heads * cfg.d_head
    k = H.heads(mm(kv_x, p["wk"]), width)
    v = H.heads(mm(kv_x, p["wv"]), width)
    if cfg.qkv_bias:
        k = k + H.local_cols(p["bk"], k.shape[-1])
        v = v + H.local_cols(p["bv"], v.shape[-1])
    return (_proj_q(p, cfg, x, mm),
            k.reshape(b, skv, cfg.n_kv_heads, cfg.d_head),
            v.reshape(b, skv, cfg.n_kv_heads, cfg.d_head))


def _out_proj(p, cfg, o, mm=torch.matmul):
    """The attention output (B, S, Hq * Dh) through ``wo``: on a mesh
    gathered whole first (the row-parallel product contracts every head
    locally), the product's columns then gathered to d_model."""
    return H.hidden(mm(H.row_input(o, p["wo"].shape[-2]), p["wo"]),
                    cfg.d_model)


def attn_full(p, cfg, x, *, positions, causal=True, window=None,
              kv_x=None, mm=torch.matmul, attn_impl="pallas"):
    """Full-sequence attention, or cross-attention over ``kv_x``
    (non-causal: every query sees every key), by ``attn_impl``
    (:func:`~repro_torch.models.attention.attention`: K3 for serving,
    ``"chunked"`` to train). Returns (out (B,S,d), (k, v))."""
    q, k, v = _proj_qkv(p, cfg, x, kv_x, mm)
    if cfg.bf16_grads and x.dtype == torch.bfloat16:
        q, k, v = bf16_grad(q), bf16_grad(k), bf16_grad(v)
    if _use_rope(cfg):
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=window, q_offset=0,
                  impl=attn_impl, q_chunk=cfg.attn_chunk,
                  kv_chunk=cfg.attn_chunk)
    return _out_proj(p, cfg, o.reshape(x.shape[0], x.shape[1], -1),
                     mm), (k, v)


def attn_decode(p, cfg, x, k_cache, v_cache, cache_len, *, window=None,
                block_tables=None):
    """Single-token attention. x: (B,1,d); ``cache_len`` an int32
    tensor, 0-d or per-row (B,) — each row rotates and masks at its own
    absolute position; ``window`` masks a rolling cache as the reference
    does. With ``block_tables`` (B, W) the caches are paged pools.
    Returns (out, k1, v1), the token's own KV."""
    q, k1, v1 = _proj_qkv(p, cfg, x)
    if _use_rope(cfg):
        pos = cache_len.reshape(-1, 1)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k1 = L.apply_rope(k1, pos, cfg.rope_theta)
    o = decode_attention(q, k_cache, v_cache, cache_len, window=window,
                         extra_k=k1, extra_v=v1, block_tables=block_tables)
    return _out_proj(p, cfg, o.reshape(x.shape[0], 1, -1)), k1, v1


def attn_cross_decode(p, cfg, x, cross_k, cross_v, cross_len):
    """One token's cross-attention over the fixed encoder cache
    ``cross_k``/``cross_v`` (B, T, Hkv, Dh): all ``cross_len`` (T, as
    an int32 tensor on the cache's device) slots valid, no self partial
    (K1 without extras)."""
    o = decode_attention(_proj_q(p, cfg, x), cross_k, cross_v, cross_len)
    return _out_proj(p, cfg, o.reshape(x.shape[0], 1, -1))


def attn_chunk(p, cfg, x, k_hist, v_hist, hist_len, *, positions):
    """Prefill-over-cache attention: x (B,S,d) sits at ``positions``
    ((S,) or (B,S)), after ``hist_len`` cached rows of ``k_hist``/
    ``v_hist`` (B,C,Hkv,Dh). Returns (out (B,S,d), (k, v)) — the
    chunk's own KV, for the caller to write at offset ``hist_len``."""
    q, k, v = _proj_qkv(p, cfg, x)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = prefill_over_cache(q, k_hist, v_hist, hist_len, k, v)
    return _out_proj(p, cfg, o.reshape(x.shape[0], x.shape[1], -1)), (k, v)


# ---------------------------------------------------------------------------
# decoder blocks
# ---------------------------------------------------------------------------

def _apply_ffn(p, cfg, h, mm=torch.matmul):
    if "moe" in p:
        return M.apply_moe(p["moe"], cfg, h)
    return L.apply_mlp(p["mlp"], cfg, h, mm)


# A block's input is the residual ``x`` plus the previous block's MLP
# output ``delta`` (None before the first block); its ``ln1`` adds them
# as it normalises (K5 with the add), and its ``ln2`` adds the attention
# output the same way. A block returns (residual, MLP output) un-added,
# for the next block's ``ln1`` or the final norm to add: the reference's
# adds, in its order, each fused into the norm that follows it.

def decoder_block(p, cfg, x, delta, *, positions, causal=True,
                  window=None, enc_out=None, mm=torch.matmul,
                  attn_impl="pallas"):
    """One block over a whole sequence. Returns ((residual, MLP output),
    kv): kv is the block's (k, v), and with ``enc_out`` (whisper's
    decoder) also its cross-attention's (k, v) over the encoder output,
    (k, v, xk, xv). ``mm`` computes the dense products (the recurrent
    prefill's :func:`~repro_torch.models.layers.row_tiled`),
    ``attn_impl`` the attention (:func:`attn_full`)."""
    x, h = L.add_norm(p["ln1"], cfg, x, delta)
    a, kv = attn_full(p["attn"], cfg, h, positions=positions,
                      causal=causal, window=window, mm=mm,
                      attn_impl=attn_impl)
    if enc_out is not None:
        x, h = L.add_norm(p["ln_x"], cfg, x, a)
        a, xkv = attn_full(p["xattn"], cfg, h, positions=positions,
                           causal=False, kv_x=enc_out, attn_impl=attn_impl)
        kv = kv + xkv
    x, h = L.add_norm(p["ln2"], cfg, x, a)
    return (x, _apply_ffn(p, cfg, h, mm)), kv


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
                         window=None, cross_k=None, cross_v=None,
                         cross_len=None, block_tables=None):
    x, h = L.add_norm(p["ln1"], cfg, x, delta)
    a, k1, v1 = attn_decode(p["attn"], cfg, h, k_cache, v_cache, cache_len,
                            window=window, block_tables=block_tables)
    if cross_k is not None:
        x, h = L.add_norm(p["ln_x"], cfg, x, a)
        a = attn_cross_decode(p["xattn"], cfg, h, cross_k, cross_v,
                              cross_len)
    x, h = L.add_norm(p["ln2"], cfg, x, a)
    return (x, _apply_ffn(p, cfg, h)), k1, v1


# ---------------------------------------------------------------------------
# the training path: forward and loss
# ---------------------------------------------------------------------------

# the products "dots" keeps (the reference's checkpoint_dots): what every
# einsum and matmul of a layer lowers to
_PRODUCTS = frozenset(
    getattr(torch.ops.aten, op).default
    for op in ("mm", "bmm", "addmm", "baddbmm"))


def _keep_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """``fn`` under ``cfg.remat``'s activation checkpointing (the
    reference's ``jax.checkpoint`` of a layer body): ``"none"`` keeps
    every activation; ``"full"`` recomputes the layer in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` keeps the
    layer's matmul outputs and recomputes the rest (a selective
    checkpoint whose policy saves ``mm``, ``bmm``, ``addmm`` and
    ``baddbmm``). A K5 inside runs again in the recompute."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _keep_products)}
    else:
        raise ValueError(f"unknown remat policy {cfg.remat!r}")

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _block_step(lp, cfg, **kw):
    """(x, delta) -> (residual, MLP output) of the decoder block ``lp``
    (:func:`decoder_block` with ``kw``), its K/V dropped."""
    def step(x, delta):
        return decoder_block(lp, cfg, x, delta, **kw)[0]
    return step


def _mlstm_step(lp, cfg):
    def step(x, delta):
        return X.apply_mlstm(lp, cfg, x, delta)[0]
    return step


def _mamba_step(lp, cfg):
    """One Zamba2 layer: its ``ln`` (with the pending add), then Mamba2."""
    def step(x, delta):
        x, h = L.add_norm(lp["ln"], cfg, x, delta)
        return x, S.apply_mamba2(lp["mamba"], cfg, h)[0]
    return step


def forward(params, cfg, batch, *, attn_impl="chunked") -> torch.Tensor:
    """Full-sequence logits (B, S, V) fp32 — the training path
    (reference ``forward``, ``model.py:344``), differentiable end to end.

    ``batch``: ``tokens`` (B, S_tok); a vlm's ``images`` (B, n_img, d)
    first, whose positions count; whisper's ``frames`` (B, encoder_len,
    d) through the encoder. ``attn_impl``: ``"chunked"`` (the plain
    online-softmax attention, or the naive one for Sq * Skv <= 256²),
    ``"reference"``, or ``"pallas"`` (K3, which has no backward: for a
    forward without grad). The layers the reference checkpoints run
    under :func:`_remat` — the stacked decoder layers (not an MoE's
    leading dense ones), whisper's encoder and decoder layers, each
    mLSTM and each Zamba2 Mamba2 layer (not the sLSTMs nor the shared
    block) — and every RMSNorm is K5 with K5b as its backward."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    delta = None
    fam = cfg.family
    if fam == "ssm":
        n_super, n_inner = xlstm_dims(cfg)
        slstm = (unstack(params["slstm"], n_super) if "slstm" in params
                 else None)
        for i, sup in enumerate(unstack(params["mlstm"], n_super)):
            for lp in unstack(sup, n_inner):
                x, delta = _remat(cfg, _mlstm_step(lp, cfg))(x, delta)
            if slstm is not None:
                (x, delta), _ = X.apply_slstm(slstm[i], cfg, x, delta)
    elif fam == "hybrid":
        for grp in unstack(params["mamba"], n_groups(cfg)):
            for lp in unstack(grp, cfg.attn_every):
                x, delta = _remat(cfg, _mamba_step(lp, cfg))(x, delta)
            (x, delta), _ = decoder_block(params["shared"], cfg, x, delta,
                                          positions=positions,
                                          attn_impl=attn_impl)
    else:
        enc = (_encode_audio(params, cfg, batch["frames"],
                             attn_impl=attn_impl, train=True)
               if fam == "audio" else None)
        kw = dict(positions=positions, window=cfg.sliding_window,
                  enc_out=enc, attn_impl=attn_impl)
        for lp in params.get("first_layers", []):
            x, delta = _block_step(lp, cfg, **kw)(x, delta)
        n_stack = cfg.n_layers - n_first_layers(cfg)
        for lp in unstack(params["layers"], n_stack):
            x, delta = _remat(cfg, _block_step(lp, cfg, **kw))(x, delta)
    _, h = L.add_norm(params["final_norm"], cfg, x, delta)
    return _logits(params, cfg, h)


def loss_fn(params, cfg, batch, *, attn_impl="chunked"):
    """Next-token cross-entropy of :func:`forward` against
    ``batch["labels"]`` (B, S_tok), aligned to the tokens: a vlm's
    image-prefix positions carry no loss; ``batch["loss_mask"]``, where
    given, keeps the positions it marks. Returns (loss, {"loss": loss})."""
    logits = forward(params, cfg, batch, attn_impl=attn_impl)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # a vlm's image prefix
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    loss = L.softmax_cross_entropy(logits, labels, batch.get("loss_mask"))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_struct(cfg, batch_size, capacity, dtype=None) -> dict:
    """Shape/dtype of each decode-cache leaf, in the reference's order:
    ``k``/``v`` hold ``_kv_capacity`` slots (the window for a rolling
    cache); whisper's also ``cross_k``/``cross_v`` (L, B, encoder_len,
    Hkv, Dh). An xLSTM holds fp32 state only: ``mlstm`` (n_super,
    n_m_inner, B, H, P + 1, N) and ``slstm_c/n/h`` (n_super, B, H, ph);
    Zamba2 the fp32 ``ssm`` (G, attn_every, B, H, P, N), the rolling
    ``conv`` (G, attn_every, B, k - 1, d_in + 2N) and the shared block's
    ``k``/``v`` (G, B, C, Hkv, Dh), one per application."""
    check_supported(cfg)
    dt = dtype or L.dtype_of(cfg)
    out = {"len": ((), torch.int32)}
    if cfg.family == "ssm":
        n_super, n_inner = xlstm_dims(cfg)
        out["mlstm"] = ((n_super, n_inner)
                        + X.mlstm_state_shape(cfg, batch_size), torch.float32)
        if cfg.slstm_every:
            for name in SLSTM_LEAVES:
                out[name] = ((n_super,) + X.slstm_state_shape(cfg, batch_size),
                             torch.float32)
        return out
    n_kv = cfg.n_layers
    if cfg.family == "hybrid":
        n_kv = n_groups(cfg)
        d_in = cfg.ssm_expand * cfg.d_model
        lead = (n_kv, cfg.attn_every, batch_size)
        out["ssm"] = (lead + (d_in // cfg.ssm_head_dim, cfg.ssm_head_dim,
                              cfg.ssm_state), torch.float32)
        out["conv"] = (lead + (cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state),
                       dt)
    kshape = (n_kv, batch_size, _kv_capacity(cfg, capacity),
              cfg.n_kv_heads, cfg.d_head)
    out["k"], out["v"] = (kshape, dt), (kshape, dt)
    if cfg.family == "audio":
        xshape = (cfg.n_layers, batch_size, cfg.encoder_len,
                  cfg.n_kv_heads, cfg.d_head)
        out["cross_k"] = (xshape, dt)
        out["cross_v"] = (xshape, dt)
    return out


def cache_batch_axes(cache: dict) -> dict:
    """The batch axis of each cache leaf (None for the position
    counter): what a slot splice or export takes from each."""
    axes = {}
    for name in cache:
        if name == "len":
            axes[name] = None
        elif name in ("k", "v", "cross_k", "cross_v"):
            axes[name] = 1        # (L|G, B, C, H, Dh)
        elif name in ("ssm", "conv", "mlstm"):
            axes[name] = 2        # (outer, inner, B, ...)
        elif name in SLSTM_LEAVES:
            axes[name] = 1        # (outer, B, ...)
        else:
            raise KeyError(f"unknown cache leaf {name}")
    return axes


def roll_window(rows: torch.Tensor, capacity: int) -> torch.Tensor:
    """A rolling cache's slots after a prompt: ``rows`` (L, B, S, H, Dh)
    with ``S >= capacity`` -> the window tail (positions ``S - C .. S -
    1``) rotated by ``S % C``, so position p sits at slot ``p % C`` (the
    reference's prefill, ``model.py:597-611``)."""
    s = rows.shape[2]
    tail = rows[:, :, s - capacity:]
    shift = s % capacity
    return torch.roll(tail, shift, dims=2) if shift else tail


def init_cache(cfg, batch_size, capacity, *, device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(sh, dtype=dt, device=dev)
            for k, (sh, dt) in cache_struct(cfg, batch_size,
                                            capacity).items()}


def _meta_tree(struct: dict) -> dict:
    """A ``{name: (shape, dtype)}`` struct as empty meta tensors."""
    return {k: torch.empty(sh, dtype=dt, device="meta")
            for k, (sh, dt) in struct.items()}


def cache_spec(cfg, batch_size, capacity) -> dict:
    """The decode cache of :func:`cache_struct` as meta tensors (shapes
    and dtypes, no storage) — what the cost model traces."""
    return _meta_tree(cache_struct(cfg, batch_size, capacity))


def paged_pool_struct(cfg, num_blocks, block_size, dtype=None) -> dict:
    """Shape/dtype of the shared paged KV pools, all layers stacked on
    the leading axis: ``num_blocks`` allocatable blocks of ``block_size``
    positions plus one scratch block, id ``num_blocks`` — the tables'
    sentinel — that is never allocated and takes every dropped write."""
    check_supported(cfg)
    if (cfg.family not in TRANSFORMER_FAMILIES
            or cfg.sliding_window is not None):
        raise ValueError("paged pools hold attention families without a "
                         "rolling SWA cache")
    dt = dtype or L.dtype_of(cfg)
    shape = (cfg.n_layers, num_blocks + 1, block_size, cfg.n_kv_heads,
             cfg.d_head)
    return {"k": (shape, dt), "v": (shape, dt)}


def init_paged_pools(cfg, num_blocks, block_size, *, device="cuda"):
    dev = resolve_device(device)
    st = paged_pool_struct(cfg, num_blocks, block_size)
    return tuple(torch.zeros(st[k][0], dtype=st[k][1], device=dev)
                 for k in ("k", "v"))


def paged_cache_spec(cfg, batch_size, capacity, block_size,
                     num_blocks=None, *, ragged=False) -> dict:
    """Meta tensors of a paged decode cache: the pools (``num_blocks``,
    by default the resident worst case ``batch * ceil(capacity /
    block_size)``, plus the scratch block) and per-row block tables
    wide enough for ``capacity`` positions; ``len`` per row when
    ``ragged``."""
    w = -(-capacity // block_size)
    out = _meta_tree(paged_pool_struct(cfg, num_blocks or batch_size * w,
                                       block_size))
    out["block_tab"] = torch.empty((batch_size, w), dtype=torch.int32,
                                   device="meta")
    out["len"] = torch.empty((batch_size,) if ragged else (),
                             dtype=torch.int32, device="meta")
    return out


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, batch) -> torch.Tensor:
    """(B, S, d): the tokens' embeddings, after the vlm's image prefix
    ``batch["images"]`` (B, n_img, d) where the batch carries one; plus
    the sinusoid of each position on whisper's decoder."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm" and "images" in batch:
        x = torch.cat([batch["images"].to(x.dtype), x], dim=1)
    if cfg.family == "audio":
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + L.sinusoidal_positions(pos, cfg.d_model)[None].to(x.dtype)
    return x


def _encode_audio(params, cfg, frames, *, attn_impl="pallas",
                  train=False) -> torch.Tensor:
    """Whisper's encoder over the frame embeddings (B, T, d): sinusoidal
    positions, non-causal blocks (K3 without a mask, or ``attn_impl``),
    then ``enc_norm``; each layer under :func:`_remat` when ``train``.
    Returns (B, T, d) in the frames' dtype."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames + L.sinusoidal_positions(pos, cfg.d_model)[None].to(
        frames.dtype)
    delta = None
    for lp in unstack(params["enc_layers"], cfg.n_encoder_layers):
        step = _block_step(lp, cfg, positions=pos, causal=False,
                           attn_impl=attn_impl)
        x, delta = (_remat(cfg, step) if train else step)(x, delta)
    return L.add_norm(params["enc_norm"], cfg, x, delta)[1]


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


def _prefill_recurrent(params, cfg, x, n_valid):
    """The recurrent families' prefill layers over x (B, S, d), of which
    the first ``n_valid`` positions are the prompt's.

    The layers run over whole chunks of ``chunk_len`` rows: x is padded
    to a multiple of the chunk, the pads are masked as a bucket's are,
    and every dense product runs one chunk of rows at a time
    (:func:`~repro_torch.models.layers.row_tiled`), as the SSD does. So
    every operation sees the same shapes and layouts, chunk for chunk,
    whatever the bucket, and each row's result depends on that row
    alone: a right-padded bucket gives the exact-length prompt's state
    and rows bit for bit. Returns (residual, last output) at the S input
    positions, and the state leaves and the shared block's ``k``/``v``
    rows (S of them)."""
    s = x.shape[1]
    x = F.pad(x, (0, 0, 0, -s % cfg.chunk_len))
    positions = torch.arange(x.shape[1], device=x.device)
    mm = L.row_tiled(cfg.chunk_len)
    delta = None
    if cfg.family == "ssm":
        n_super, n_inner = xlstm_dims(cfg)
        m_states, s_states = [], []
        for i in range(n_super):
            sup = layer_params(params["mlstm"], i)
            for j in range(n_inner):
                (x, delta), st = X.apply_mlstm(
                    layer_params(sup, j), cfg, x, delta, n_valid=n_valid,
                    mm=mm)
                m_states.append(st)
            if "slstm" in params:
                (x, delta), st = X.apply_slstm(
                    layer_params(params["slstm"], i), cfg, x, delta,
                    n_valid=n_valid, mm=mm)
                s_states.append(st)
        rows = {"mlstm": torch.stack(m_states).unflatten(
            0, (n_super, n_inner))}
        for name, leaf in zip(SLSTM_LEAVES, zip(*s_states)):
            rows[name] = torch.stack(leaf)
        return x[:, :s], delta[:, :s], rows
    sts, cvs, kvs = [], [], []
    for g in range(n_groups(cfg)):
        grp = layer_params(params["mamba"], g)
        for j in range(cfg.attn_every):
            lp = layer_params(grp, j)
            x, h = L.add_norm(lp["ln"], cfg, x, delta)
            delta, (st, cv) = S.apply_mamba2(lp["mamba"], cfg, h,
                                             n_valid=n_valid, mm=mm)
            sts.append(st)
            cvs.append(cv)
        (x, delta), kv = decoder_block(params["shared"], cfg, x, delta,
                                       positions=positions, mm=mm)
        kvs.append(kv)
    lead = (n_groups(cfg), cfg.attn_every)
    rows = {"ssm": torch.stack(sts).unflatten(0, lead),
            "conv": torch.stack(cvs).unflatten(0, lead)}
    rows["k"], rows["v"] = (torch.stack(t)[:, :, :s] for t in zip(*kvs))
    return x[:, :s], delta[:, :s], rows


def prefill(params, cfg, batch, capacity, *, logit_index=None,
            length=None):
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
    masked at decode by the per-row cache length.

    Sliding-window configs attend within the window (K3's window mask);
    their cache rolls once the prompt fills it (:func:`roll_window`),
    and ``capacity=None`` returns all S rows for the caller to roll.
    Whisper (``batch["frames"]`` (B, encoder_len, d)) runs the encoder
    first; every decoder layer's cross-attention K/V over its output
    comes back as ``cross_k``/``cross_v`` (L, B, encoder_len, Hkv, Dh).

    ``length`` (an int or 0-d tensor): the prompt's true length when a
    recurrent family's batch is right-padded. Pad steps get decay 1 and
    zero input (the values the SSD engine pads its own chunks with) and
    the sLSTM's carry stays frozen, so every state leaf is bitwise the
    exact-length prompt's. Attention families ignore it: their causal
    mask already keeps pads out. ``capacity=None`` returns the state
    leaves whole beside the ``k``/``v`` rows."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, batch)
    b, s = x.shape[:2]
    if cfg.family in RECURRENT_FAMILIES:
        x, delta, rows = _prefill_recurrent(
            params, cfg, x, s if length is None else int(length))
    else:
        positions = torch.arange(s, device=x.device)
        enc = (_encode_audio(params, cfg, batch["frames"])
               if cfg.family == "audio" else None)
        kvs = []
        delta = None
        for lp in blocks(params, cfg):
            (x, delta), kv = decoder_block(lp, cfg, x, delta,
                                           positions=positions,
                                           window=cfg.sliding_window,
                                           enc_out=enc)
            kvs.append(kv)
        rows = dict(zip(("k", "v", "cross_k", "cross_v"),
                        (torch.stack(t) for t in zip(*kvs))))
    if capacity is None:
        cache = rows
    else:
        cache = init_cache(cfg, b, capacity, device=x.device)
        for name, r in rows.items():
            c = cache[name].shape[2]
            if name not in ("k", "v"):
                cache[name].copy_(r)
            elif cfg.sliding_window is not None and s >= c:
                cache[name].copy_(roll_window(r, c))
            elif s > c:
                raise ValueError(f"prompt of {s} positions exceeds the "
                                 f"cache capacity {c}")
            else:
                cache[name][:, :, :s] = r
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    _, h = L.add_norm(params["final_norm"], cfg,
                      *_read_rows(logit_index, x, delta))
    return _logits(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _write_token_kv(cache_arr, kv, slot, live=None, *, shard=False):
    """Write one decoded token's KV ``kv`` (B, 1, H, Dh) into one layer's
    cache ``cache_arr`` (B, C, H, Dh) at ``slot`` — a scalar or a per-row
    (B,) vector — **in place** (the reference scatters functionally).
    Rows that are not ``live``, or whose slot is past the capacity, keep
    their cache exactly, like the reference's ``mode="drop"``: they
    write back the value already there, so no host sync is needed. A
    ``shard`` of a position-split cache also drops slots before its
    first position (negative ones)."""
    b, c = cache_arr.shape[0], cache_arr.shape[1]
    slot = torch.broadcast_to(
        torch.as_tensor(slot, device=cache_arr.device).reshape(-1), (b,))
    keep = slot < c
    if shard:
        keep = keep & (slot >= 0)
        slot = slot.clamp(min=0)
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


def _merge_rows(dst, new, live):
    """``dst`` (B, ...) <- ``new`` in place, only in the ``live`` rows
    (every row when None): a non-live row's state keeps its bits, as the
    reference's ``_merge_rows`` leaves it."""
    new = new.to(dst.dtype)
    if live is not None:
        new = torch.where(live.reshape(-1, *[1] * (new.dim() - 1)), new, dst)
    dst.copy_(new)


def _decode_recurrent(params, cfg, x, cache, n, slot, live):
    """The recurrent families' decode layers over x (B, 1, d); every
    state leaf of ``cache`` merged in place under ``live``, and Zamba2's
    shared block writes its K/V per group at the row's position (K1
    reads the group's cache first). Returns (residual, last output)."""
    delta = None
    if cfg.family == "ssm":
        n_super, n_inner = xlstm_dims(cfg)
        for i in range(n_super):
            sup = layer_params(params["mlstm"], i)
            for j in range(n_inner):
                (x, delta), st = X.mlstm_decode_step(
                    layer_params(sup, j), cfg, x, delta, cache["mlstm"][i, j])
                _merge_rows(cache["mlstm"][i, j], st, live)
            if "slstm" in params:
                (x, delta), carry = X.slstm_decode_step(
                    layer_params(params["slstm"], i), cfg, x, delta,
                    tuple(cache[name][i] for name in SLSTM_LEAVES))
                for name, st in zip(SLSTM_LEAVES, carry):
                    _merge_rows(cache[name][i], st, live)
        return x, delta
    for g in range(n_groups(cfg)):
        grp = layer_params(params["mamba"], g)
        for j in range(cfg.attn_every):
            lp = layer_params(grp, j)
            x, h = L.add_norm(lp["ln"], cfg, x, delta)
            delta, (st, cv) = S.mamba2_decode_step(
                lp["mamba"], cfg, h, cache["ssm"][g, j], cache["conv"][g, j])
            _merge_rows(cache["ssm"][g, j], st, live)
            _merge_rows(cache["conv"][g, j], cv, live)
        (x, delta), k1, v1 = decoder_block_decode(
            params["shared"], cfg, x, delta, cache["k"][g], cache["v"][g], n)
        _write_token_kv(cache["k"][g], k1, slot, live)
        _write_token_kv(cache["v"][g], v1, slot, live)
    return x, delta


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
    at offset ``pos % bs``. A rolling sliding-window cache writes at
    slot ``pos % C`` and masks the slot one window back (K1's window);
    whisper's decoder also attends its ``cross_k``/``cross_v`` (K1
    without a self partial) and adds the sinusoid of each position. The
    recurrent families update their state leaves in place too; a
    non-live row's keep their bits."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    n = torch.as_tensor(cache["len"], dtype=torch.int32, device=x.device)
    btab = cache.get("block_tab")
    window = cfg.sliding_window
    if btab is not None and (cfg.family not in TRANSFORMER_FAMILIES
                             or window is not None):
        raise ValueError("paged cache requires an attention family "
                         "without a rolling SWA cache")
    slot = n if window is None else n % cache["k"].shape[2]
    if cfg.family in RECURRENT_FAMILIES:
        x, delta = _decode_recurrent(params, cfg, x, cache, n, slot, live)
        cache["len"] = n + 1 if live is None else n + live.to(torch.int32)
        _, h = L.add_norm(params["final_norm"], cfg, x, delta)
        return _logits(params, cfg, h)[:, 0], cache
    if cfg.family == "audio":
        x = x + L.sinusoidal_positions(n.reshape(-1, 1), cfg.d_model).to(
            x.dtype)
    # a shard of a position-split cache (a mesh's sequence layout) holds
    # positions from its offset on: the token's slot is relative to it
    offset = 0 if btab is not None else H.kv_offset(cache["k"].shape[2])
    if offset:
        slot = slot - offset
    shard = btab is None and H.attn_layout() == "seq"
    index = None
    if btab is not None:
        pool = cache["k"]
        index = _paged_write_index(btab, n, 1, pool.shape[1] - 1,
                                  pool.shape[2], live)
    cross = cache.get("cross_k"), cache.get("cross_v")
    # the encoder length, made on the device once a step (a host scalar
    # per layer would be a copy to the card each time)
    cross_len = (None if cross[0] is None else torch.full(
        (), cross[0].shape[2], dtype=torch.int32, device=x.device))
    delta = None
    for i, lp in enumerate(blocks(params, cfg)):
        (x, delta), k1, v1 = decoder_block_decode(
            lp, cfg, x, delta, cache["k"][i], cache["v"][i], n,
            window=window,
            cross_k=None if cross[0] is None else cross[0][i],
            cross_v=None if cross[1] is None else cross[1][i],
            cross_len=cross_len, block_tables=btab)
        # layer i's attention has read its cache; the token's KV lands
        # at its slot now (later layers never read layer i's rows)
        if btab is None:
            _write_token_kv(cache["k"][i], k1, slot, live, shard=shard)
            _write_token_kv(cache["v"][i], v1, slot, live, shard=shard)
        else:
            _write_paged(cache["k"][i], k1, index)
            _write_paged(cache["v"][i], v1, index)
    cache["len"] = n + 1 if live is None else n + live.to(torch.int32)
    _, h = L.add_norm(params["final_norm"], cfg, x, delta)
    return _logits(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# chunked prefill and speculative verify (prefill over a cache, K4)
# ---------------------------------------------------------------------------

def check_over_cache(cfg, what: str) -> None:
    """Chunked prefill and verify resume attention from a KV view: the
    attention families without a rolling window only (the reference's
    refusals, ``model.py:708-714``, ``:1014-1020``)."""
    check_supported(cfg)
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(f"{what} unsupported for family {cfg.family!r}")
    if cfg.sliding_window is not None:
        raise ValueError(f"{what} does not support rolling SWA caches")


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
    check_over_cache(cfg, "chunked prefill")
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
    logits = _logits(params, cfg, h)[:, 0]
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
    check_over_cache(cfg, "speculative verify")
    x = _embed(params, cfg, tokens)
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
    return _logits(params, cfg, h), cache


def self_draft_params(params, cfg, n_draft_layers: int):
    """Self-draft for speculative decoding: the target's embeddings,
    head and first ``k`` layers (``k`` clamped to ``[1, n_layers]``) —
    the leading dense ``first_layers`` first, then the stack. Returns
    ``(draft_params, draft_cfg)``; every leaf is a view of the target's
    tensors, not a copy."""
    check_supported(cfg)
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(f"self-draft unsupported for family "
                         f"{cfg.family!r}")
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


# ---------------------------------------------------------------------------
# batch construction (specs)
# ---------------------------------------------------------------------------

def batch_struct(cfg, batch_size, seq_len, kind="train") -> dict:
    """Shape/dtype of each leaf of a batch of ``kind`` ("train",
    "prefill" or "decode"): ``seq_len`` counts a vlm's image prefix
    positions first; whisper's also carries its frames; a train batch
    adds ``labels``, aligned to the tokens."""
    if kind not in ("train", "decode", "prefill"):
        raise ValueError(f"unknown batch kind {kind!r}: train, decode or "
                         "prefill")
    dt = L.dtype_of(cfg)
    if kind == "decode":
        return {"tokens": ((batch_size, 1), torch.int32)}
    out = {}
    s_tok = seq_len
    if cfg.family == "vlm" and cfg.n_image_tokens:
        s_tok = seq_len - cfg.n_image_tokens
        out["images"] = ((batch_size, cfg.n_image_tokens, cfg.d_model), dt)
    if cfg.family == "audio":
        out["frames"] = ((batch_size, cfg.encoder_len, cfg.d_model), dt)
    out["tokens"] = ((batch_size, s_tok), torch.int32)
    if kind == "train":
        out["labels"] = ((batch_size, s_tok), torch.int32)
    return out


def batch_spec(cfg, batch_size, seq_len, kind="train") -> dict:
    """:func:`batch_struct` as meta tensors."""
    return _meta_tree(batch_struct(cfg, batch_size, seq_len, kind))


def make_dummy_batch(cfg, batch_size, seq_len, kind="train", *, seed=0,
                     device="cuda") -> dict:
    """A random batch of :func:`batch_struct`'s leaves, in its order,
    from an explicit generator seeded with ``seed``: integer leaves
    uniform over the vocabulary, the others N(0, 0.01) in their dtype
    (the reference's values differ: its PRNG stream is JAX's)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (sh, dt) in batch_struct(cfg, batch_size, seq_len,
                                       kind).items():
        if dt == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, sh, generator=gen,
                                      device=dev, dtype=torch.int32)
        else:
            out[name] = (torch.randn(sh, generator=gen, device=dev)
                         * 0.1).to(dt)
    return out
