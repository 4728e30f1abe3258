"""W4A16 mobile decode (the paper's §3.4 on-device mode) on tensors.

Counterpart of ``examples/w4_mobile_decode.py`` (its
``quantize_layer_stack``, ``layer_slice``, ``linear`` and
``w4_decode_step``, same names and arithmetic): every dense projection
of the dense decoder becomes packed int4 plus per-group scales, and a
greedy decode step runs every projection through the int4 GEMV (K6 on
the card) with the activations in fp32:

- embeddings in fp32; each GEMV input in bf16, its bf16 output cast
  back to fp32. The norms write their bf16 output directly (K5 rounds
  its fp32 result once, as the cast would), and the two residual deltas
  per layer stay bf16 until the fused add-and-norm after them adds them
  in fp32 (as ``x + y.float()``);
- RoPE at the scalar position ``n = cache["len"]``;
- split-KV decode attention (K1) on the layer's cache cast to fp32,
  with the token's own KV as the self partial;
- the token's KV written at ``[i, :, n]`` in the cache's dtype;
- the final norm, then fp32 logits from the head.

A quantized projection is the tree ``{"__w4__": True, "packed": (L,
K//2, N) uint8, "scales": (L, K//group, N) f32}``. Like the example,
the step applies no QKV bias: it is written for bias-free models.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.attention import decode_attention

PROJ_NAMES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


def quantize_layer_stack(layers_params, group):
    """Quantize each (L, K, N) projection stack to per-layer int4;
    every other leaf is returned as it is."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in PROJ_NAMES and tree.ndim == 3 \
                and tree.shape[1] % group == 0:
            packs, scales = zip(*(ref.quantize_int4(tree[i].float(),
                                                    group=group)
                                  for i in range(tree.shape[0])))
            return {"__w4__": True, "packed": torch.stack(packs),
                    "scales": torch.stack(scales)}
        return tree
    return walk(layers_params)


def quantize_params(params, group):
    """The quantized tree :func:`w4_decode_step` runs on: the layers'
    projections through :func:`quantize_layer_stack`, and every other
    float leaf (embeddings, head, norm weights) cast to float32 once,
    since the step consumes them with fp32 activations — the same
    function as the reference's in-step promotion, and it keeps the
    RMSNorm kernel on one dtype."""
    def f32(tree):
        if isinstance(tree, dict):
            if tree.get("__w4__"):
                return tree
            return {k: f32(v) for k, v in tree.items()}
        return tree.float() if tree.is_floating_point() else tree
    return f32(dict(params,
                    layers=quantize_layer_stack(params["layers"], group)))


def layer_slice(tree, i):
    """Layer ``i`` of a (partly quantized) layer stack."""
    if isinstance(tree, dict):
        if tree.get("__w4__"):
            return {"__w4__": True, "packed": tree["packed"][i],
                    "scales": tree["scales"][i]}
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _packed(w) -> bool:
    return isinstance(w, dict) and bool(w.get("__w4__"))


def linear(x, w, group, *, f32=True):
    """x (..., K) @ w — the int4 GEMV when packed (x in bf16; its bf16
    output cast to fp32 unless ``f32`` is False, for a fused add that
    takes it as it is), an fp32 matmul otherwise."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _packed(w):
        y = ops.quant_gemv(x2.to(torch.bfloat16), w["packed"], w["scales"],
                           group=group)
        y = y.float() if f32 else y
    else:
        y = x2.float() @ w.float()
    return y.reshape(*lead, -1)


def w4_decode_step(qp, cfg, tokens, cache, group):
    """Greedy decode step of the dense family through the int4 GEMV.
    tokens (B, 1); ``cache`` a contiguous decode cache whose ``len`` is
    one position for all rows. Returns (logits (B, V) fp32, cache); the
    cache's ``k``/``v`` are written in place, its ``len`` replaced."""
    x = L.embed_tokens(qp["embed"], tokens).float()           # (B, 1, d)
    n = torch.as_tensor(cache["len"], dtype=torch.int32, device=x.device)
    b = x.shape[0]
    pos = n.reshape(1)
    slot = pos.long()

    delta = None   # the last layer's MLP output, added by the next norm
    for i in range(cfg.n_layers):
        lp = layer_slice(qp["layers"], i)
        # the norms' outputs feed only wq, wk, wv, w_gate and w_up: bf16
        # when all of them are packed, as the GEMV would cast them
        hdt = (torch.bfloat16 if all(
            _packed(lp[sub][name]) for sub, name in (
                ("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                ("mlp", "w_gate"), ("mlp", "w_up"))) else torch.float32)
        x, h = L.add_norm(lp["ln1"], cfg, x, delta, out_dtype=hdt)
        q = linear(h, lp["attn"]["wq"], group).reshape(
            b, 1, cfg.n_heads, cfg.d_head)
        k1 = linear(h, lp["attn"]["wk"], group).reshape(
            b, 1, cfg.n_kv_heads, cfg.d_head)
        v1 = linear(h, lp["attn"]["wv"], group).reshape(
            b, 1, cfg.n_kv_heads, cfg.d_head)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k1 = L.apply_rope(k1, pos, cfg.rope_theta)
        o = decode_attention(q.float(), cache["k"][i].float(),
                             cache["v"][i].float(), n,
                             extra_k=k1.float(), extra_v=v1.float())
        x, h = L.add_norm(lp["ln2"], cfg, x,
                          linear(o.reshape(b, 1, -1), lp["attn"]["wo"],
                                 group, f32=False), out_dtype=hdt)
        g = linear(h, lp["mlp"]["w_gate"], group)
        u = linear(h, lp["mlp"]["w_up"], group)
        delta = linear(F.silu(g) * u, lp["mlp"]["w_down"], group, f32=False)
        cache["k"][i].index_copy_(1, slot, k1.to(cache["k"].dtype))
        cache["v"][i].index_copy_(1, slot, v1.to(cache["v"].dtype))
    cache["len"] = n + 1
    _, h = L.add_norm(qp["final_norm"], cfg, x, delta)
    head = qp["embed"]["table"] if cfg.tie_embeddings else qp["head"]
    return L.logits_from_hidden(head, h)[:, 0], cache
