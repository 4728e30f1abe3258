"""Public kernel entry points: the hand-written kernel for a CUDA tensor,
the plain PyTorch version (:mod:`repro_torch.kernels.ref`) for a CPU
tensor. Nothing else — a kernel that fails to build or launch raises.

Counterpart of ``repro/kernels/ops.py`` (whose entries pick Pallas
interpret mode off-TPU). Layouts are the model's: q (B,S,Hq,Dh), caches
(B,C,Hkv,Dh).

A ``meta`` operand (shape and dtype, no storage) runs nothing: the entry
hands the kernel's name, its ``cost()`` and the outputs it writes to the
installed tracer (:func:`set_meta_sink`, used by
:mod:`repro_torch.core.trace`) and returns meta outputs of the kernel's
shapes and dtypes. With no tracer installed a meta operand raises.
Under autograd a meta :func:`add_rmsnorm` is priced as K5 forward and
K5b (``add_rmsnorm_bwd``) backward, so a traced train step carries its
norms' backward; a shard entry gathers its kernel's partials over the
mesh as the kernel does.

Under autograd — grad mode on and an operand that requires grad —
:func:`add_rmsnorm` runs as an ``autograd.Function``: K5 forward, K5b
backward on the card, the plain versions of both on the CPU. Every other
kernel has no backward: its entry refuses such operands on either device
instead of returning a result cut off from the graph (training attention
is :func:`repro_torch.models.attention.chunked_attention`).
"""
from __future__ import annotations

import numbers

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


# the tracer's record hook for meta operands: (name, flops, bytes,
# written outputs) -> None; None when no trace is running
_meta_sink = None


def set_meta_sink(sink) -> None:
    """Install (or, with None, remove) the hook that prices a kernel
    call on meta operands."""
    global _meta_sink
    _meta_sink = sink


def _priced(name: str, cost: tuple, outs: tuple, ret):
    """A kernel call on meta operands: one record for the installed
    tracer, then ``ret`` (meta outputs); raises with no tracer."""
    if _meta_sink is None:
        raise ValueError(f"{name}: meta operands run no kernel and no "
                         "plain version; trace them with "
                         "repro_torch.core.trace.trace_ops")
    _meta_sink(name, cost[0], cost[1], outs)
    return ret


def _priced_shard(name: str, cost: tuple, q, parts, gather):
    """A shard entry on meta operands: its kernel's fp32 partials
    ``parts`` gathered over the shards as the kernel gathers them (the
    mesh's collectives see them), one record of the shard's cost, an
    output of q's shape."""
    for t in parts:
        gather(t, 3)
    out = torch.empty_like(q)
    return _priced(name, cost, (out,), out)


def _known(lens):
    """The lengths a cost can count: an int as it is, a tensor's values
    when it has storage (on the card, read with a synchronisation);
    None (the capacity) for a meta tensor, whose values a trace does not
    have."""
    if isinstance(lens, numbers.Integral):
        return int(lens)
    if isinstance(lens, torch.Tensor) and not lens.is_meta:
        return lens.tolist()
    return None


# each wrapper's arguments -> its kernel's cost(): the one mapping, read
# by the meta branches below and by whoever prices real launches
_COSTS = {
    "add_rmsnorm": lambda x, a, w, *, eps=1e-6, out_dtype=None: _rn.cost(
        tuple(x.shape), x.dtype, add_dtype=None if a is None else a.dtype,
        out_dtype=out_dtype),
    "flash_attention": lambda q, k, v, *, causal=True, window=None,
    q_offset=0: _fa.cost(tuple(q.shape), tuple(k.shape), q.dtype,
                         causal=causal, window=window, q_offset=q_offset),
    "decode_attention": lambda q, k_cache, v_cache, cache_len, *,
    extra_k=None, extra_v=None, window=None, split=None: _dec.cost(
        tuple(q.shape), tuple(k_cache.shape), q.dtype, _known(cache_len),
        self_kv=extra_k is not None, window=window),
    "paged_decode_attention": lambda q, k_pool, v_pool, block_tables,
    cache_len, *, extra_k=None, extra_v=None, split=None: _pdec.cost(
        tuple(q.shape), tuple(k_pool.shape), tuple(block_tables.shape),
        q.dtype, _known(cache_len), self_kv=extra_k is not None),
    "prefill_attention": lambda q, k_hist, v_hist, hist_len, k_self,
    v_self: _pre.cost(tuple(q.shape), tuple(k_hist.shape), q.dtype,
                      _known(hist_len)),
    "quant_gemv": lambda x, w_packed, scales, *, group=128: _qg.cost(
        tuple(x.shape), tuple(w_packed.shape), x.dtype, group=group),
}


def call_cost(name: str, *args, **kw) -> tuple:
    """(FLOPs, bytes) of one call of the wrapper ``name`` with these
    arguments (the kernel module's wrapper takes the same), from its
    kernel's ``cost()`` at the call's lengths (:func:`_known`)."""
    return _COSTS[name](*args, **kw)


def _needs_grad(*tensors) -> bool:
    """Grad mode is on and an operand requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a backward ``name`` lacks."""
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an operand requires "
            "grad; train through models.attention.chunked_attention "
            "(attn_impl='chunked'), or call it under torch.no_grad()")


def _add_rmsnorm(x, a, w, eps, out_dtype):
    """The forward on x's device: K5 on the card, its cost on meta
    operands, else its plain version under the kernel's contract."""
    if x.is_meta:
        hdt = _rn.check_shapes(x, a, w, out_dtype)
        s = x if a is None else torch.empty_like(x)
        h = torch.empty_like(x, dtype=hdt)
        return _priced("add_rmsnorm", call_cost(
            "add_rmsnorm", x, a, w, out_dtype=hdt),
            (h,) if a is None else (s, h), (s, h))
    if _on_card(x):
        return _rn.add_rmsnorm(x, a, w, eps=eps, out_dtype=out_dtype)
    _rn.check_shapes(x, a, w, out_dtype)
    return ref.add_rmsnorm(x, a, w, eps, out_dtype=out_dtype)


def _add_rmsnorm_bwd(s, w, gh, gs, eps, add_dtype):
    """(gx, ga, gw) on s's device: K5b on the card, else its plain
    version under the kernel's contract."""
    gh = gh.contiguous()
    gs = None if gs is None else gs.contiguous()
    if s.is_meta:
        _rn.check_bwd(s, w, gh, gs, add_dtype)
        gx, gw = torch.empty_like(s), torch.empty_like(w)
        ga = None if add_dtype is None else torch.empty_like(s,
                                                             dtype=add_dtype)
        outs = (gx, gw) if ga is None else (gx, ga, gw)
        return _priced("add_rmsnorm_bwd", _rn.bwd_cost(
            tuple(s.shape), s.dtype, add_dtype=add_dtype,
            out_dtype=gh.dtype, residual=gs is not None), outs,
            (gx, ga, gw))
    if _on_card(s):
        return _rn.add_rmsnorm_bwd(s, w, gh, gs, add_dtype=add_dtype,
                                   eps=eps)
    _rn.check_bwd(s, w, gh, gs, add_dtype)
    return ref.add_rmsnorm_bwd(s, w, gh, gs, eps, add_dtype=add_dtype)


class _RMSNorm(torch.autograd.Function):
    """h = RMSNorm(x) * w (K5 without the add); backward K5b with no
    residual cotangent — x's other uses get theirs from autograd."""

    @staticmethod
    def forward(ctx, x, w, eps, out_dtype):
        _, h = _add_rmsnorm(x, None, w, eps, out_dtype)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gh):
        x, w = ctx.saved_tensors
        gx, _, gw = _add_rmsnorm_bwd(x, w, gh, None, ctx.eps, None)
        return gx, gw if ctx.needs_input_grad[1] else None, None, None


class _AddRMSNorm(torch.autograd.Function):
    """(s, h) = (x + a, RMSNorm(s) * w) (K5 with the add); backward K5b,
    with the cotangent reaching s along the residual when s is used."""

    @staticmethod
    def forward(ctx, x, a, w, eps, out_dtype):
        ctx.set_materialize_grads(False)
        s, h = _add_rmsnorm(x, a, w, eps, out_dtype)
        ctx.save_for_backward(s, w)
        ctx.eps, ctx.add_dtype = eps, a.dtype
        return s, h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gs, gh):
        s, w = ctx.saved_tensors
        if gh is None:      # h unused: s passes its cotangent through
            return (gs, None if gs is None else gs.to(ctx.add_dtype), None,
                    None, None)
        gx, ga, gw = _add_rmsnorm_bwd(s, w, gh, gs, ctx.eps, ctx.add_dtype)
        return gx, ga, gw if ctx.needs_input_grad[2] else None, None, None


class _PartAddRMSNorm(torch.autograd.Function):
    """(s, h) = (x + a, RMSNorm(whole(s)) * w) where x and a are a rank's
    parts of a residual stream split across ranks, ``part`` their layout
    (``hints.StreamPart``): K5 without the add on the gathered sum
    (K5's ``s`` is torch's add). Backward K5b on the whole rows with the
    residual cotangent at the rank's part and zeros elsewhere: the
    rank's part of its gradient is K5b's fused sum, the bits of one
    device; the other parts are dropped, each rank keeping its own."""

    @staticmethod
    def forward(ctx, x, a, w, eps, out_dtype, part):
        ctx.set_materialize_grads(False)
        s = x + a
        sw = part.whole(s)
        _, h = _add_rmsnorm(sw, None, w, eps, out_dtype)
        ctx.save_for_backward(sw, w)
        ctx.eps, ctx.add_dtype, ctx.part = eps, a.dtype, part
        return s, h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gs, gh):
        sw, w = ctx.saved_tensors
        if gh is None:      # h unused: s passes its cotangent through
            return (gs, None if gs is None else gs.to(ctx.add_dtype), None,
                    None, None, None)
        part = ctx.part
        gx, ga, gw = _add_rmsnorm_bwd(
            sw, w, gh, None if gs is None else part.place(gs), ctx.eps,
            ctx.add_dtype)
        return (part.cut(gx), part.cut(ga),
                gw if ctx.needs_input_grad[2] else None, None, None, None)


def add_rmsnorm(x, a, w, *, eps=1e-6, out_dtype=None, part=None):
    """Residual add and RMSNorm over the last axis in one pass (K5):
    (s, h) with s = x + a as torch rounds it (x itself when a is None)
    and h = RMSNorm(s) * w in ``out_dtype`` (default x's dtype). The
    shape and dtype contract of the kernel holds on both devices.

    With grad mode on and an operand requiring grad it is an autograd
    node whose backward is K5b (:func:`_AddRMSNorm`, :func:`_RMSNorm`);
    otherwise the same call as ever, saving nothing.

    ``part``: x and a (not None) are a rank's parts of a residual stream
    split across ranks (``hints.StreamPart``); s is the rank's part of
    the sum and h the norm of the whole, gathered (:class:`_PartAddRMSNorm`
    under autograd)."""
    if part is not None:
        if _needs_grad(x, a, w):
            return _PartAddRMSNorm.apply(x, a, w, eps, out_dtype, part)
        s = x + a
        return s, _add_rmsnorm(part.whole(s), None, w, eps, out_dtype)[1]
    if _needs_grad(x, a, w):
        if a is None:
            return x, _RMSNorm.apply(x, w, eps, out_dtype)
        return _AddRMSNorm.apply(x, a, w, eps, out_dtype)
    return _add_rmsnorm(x, a, w, eps, out_dtype)


def rmsnorm(x, w, *, eps=1e-6):
    """RMSNorm over the last axis (K5 without the add)."""
    return add_rmsnorm(x, None, w, eps=eps)[1]


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Causal / windowed / non-causal prefill attention at absolute
    positions (K3); ``k``/``v`` may be longer or shorter than ``q``.
    No backward: refuses operands that require grad."""
    _refuse_grad("flash_attention", q, k, v)
    if q.is_meta:
        out = torch.empty_like(q)
        return _priced("flash_attention", call_cost(
            "flash_attention", q, k, v, causal=causal, window=window,
            q_offset=q_offset), (out,), out)
    if _on_card(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len, *, extra_k=None,
                     extra_v=None, window=None, split=None):
    """Ragged split-KV decode attention with the self partial (K1), over
    a rolling sliding-window cache when ``window`` is given; ``split``
    sets pass 1's positions per block (a mesh shard takes the whole
    decode's). No backward: refuses operands that require grad."""
    _refuse_grad("decode_attention", q, k_cache, v_cache, extra_k, extra_v)
    if q.is_meta:
        out = torch.empty_like(q)
        return _priced("decode_attention", call_cost(
            "decode_attention", q, k_cache, v_cache, cache_len,
            extra_k=extra_k, window=window), (out,), out)
    if _on_card(q):
        return _dec.decode_attention(q, k_cache, v_cache, cache_len,
                                     extra_k=extra_k, extra_v=extra_v,
                                     window=window, split=split)
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                extra_k=extra_k, extra_v=extra_v,
                                window=window)


def decode_attention_shard(q, k_cache, v_cache, cache_len, *, offset,
                           gather, capacity=None, extra_k=None,
                           extra_v=None, window=None, split=None):
    """K1 over one shard of a cache split by position across a mesh's
    ranks (slots ``offset ..`` of rows of ``capacity``, rolling under
    ``window``): pass 1 over the shard, ``gather`` to every shard's
    partials, the combine with the self partial (the sequence-sharded
    decode). No backward: refuses operands that require grad."""
    _refuse_grad("decode_attention", q, k_cache, v_cache, extra_k, extra_v)
    if q.is_meta:   # the kernel's partials gathered, pass 1 priced
        parts = _dec.split_scratch(q, k_cache.shape[2], k_cache.shape[1],
                                   split)[:3]
        return _priced_shard("decode_attention", call_cost(
            "decode_attention", q, k_cache, v_cache, cache_len,
            extra_k=extra_k, window=window), q, parts, gather)
    if _on_card(q):
        return _dec.decode_attention_shard(
            q, k_cache, v_cache, cache_len, offset=offset, gather=gather,
            capacity=capacity, extra_k=extra_k, extra_v=extra_v,
            window=window, split=split)
    return ref.decode_attention_shard(
        q, k_cache, v_cache, cache_len, offset=offset, gather=gather,
        capacity=capacity, extra_k=extra_k, extra_v=extra_v, window=window)


def paged_decode_attention(q, k_pool, v_pool, block_tables, cache_len, *,
                           extra_k=None, extra_v=None, split=None):
    """Split-KV decode over a paged pool through block tables, with the
    self partial (K2). No backward: refuses operands that require
    grad."""
    _refuse_grad("paged_decode_attention", q, k_pool, v_pool, extra_k,
                 extra_v)
    if q.is_meta:
        out = torch.empty_like(q)
        return _priced("paged_decode_attention", call_cost(
            "paged_decode_attention", q, k_pool, v_pool, block_tables,
            cache_len, extra_k=extra_k), (out,), out)
    if _on_card(q):
        return _pdec.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                            cache_len, extra_k=extra_k,
                                            extra_v=extra_v, split=split)
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                      cache_len, extra_k=extra_k,
                                      extra_v=extra_v)


def prefill_attention(q, k_hist, v_hist, hist_len, k_self, v_self):
    """Chunked-prefill attention over cached history plus the chunk's own
    causal KV (K4). No backward: refuses operands that require grad."""
    _refuse_grad("prefill_attention", q, k_hist, v_hist, k_self, v_self)
    if q.is_meta:
        out = torch.empty_like(q)
        return _priced("prefill_attention", call_cost(
            "prefill_attention", q, k_hist, v_hist, hist_len, k_self,
            v_self), (out,), out)
    if _on_card(q):
        return _pre.prefill_attention(q, k_hist, v_hist, hist_len, k_self,
                                      v_self)
    return ref.prefill_attention(q, k_hist, v_hist, hist_len, k_self, v_self)


def prefill_attention_shard(q, k_hist, v_hist, hist_len, k_self, v_self, *,
                            offset, gather):
    """K4 over one shard of a history split by position across a mesh's
    ranks: the history pass over the shard's positions (from
    ``offset``), ``gather`` to every shard's partials, the merge in
    shard order with the queries' own causal keys (the sequence-sharded
    chunk and verify). No backward: refuses operands that require
    grad."""
    _refuse_grad("prefill_attention", q, k_hist, v_hist, k_self, v_self)
    if q.is_meta:   # the kernel's partials gathered, the pass priced
        b, s, hq, dh = q.shape
        m = torch.empty((b, hq, s, 1), dtype=torch.float32, device="meta")
        parts = (torch.empty((b, hq, s, 1, dh), dtype=torch.float32,
                             device="meta"), m, torch.empty_like(m))
        return _priced_shard("prefill_attention", call_cost(
            "prefill_attention", q, k_hist, v_hist, hist_len, k_self,
            v_self), q, parts, gather)
    if _on_card(q):
        return _pre.prefill_attention_shard(q, k_hist, v_hist, hist_len,
                                            k_self, v_self, offset=offset,
                                            gather=gather)
    return ref.prefill_attention_shard(q, k_hist, v_hist, hist_len, k_self,
                                       v_self, offset=offset, gather=gather)


def verify_attention(q, k_hist, v_hist, hist_len, k_self, v_self):
    """Speculative-verify attention: each row's S = gamma + 1 candidates
    at its own ``hist_len`` (per-row (B,)) — the same kernel (K4)."""
    return prefill_attention(q, k_hist, v_hist, hist_len, k_self, v_self)


def quant_gemv(x, w_packed, scales, *, group=128):
    """W4A16 GEMV/GEMM: x (B, K) @ the int4 weight ``w_packed``
    (K//2, N) uint8 with per-group ``scales`` (K//group, N), fp32
    accumulation, x's dtype out (K6). No backward: refuses operands
    that require grad."""
    _refuse_grad("quant_gemv", x, scales)
    if x.is_meta:
        out = x.new_empty((x.shape[0], w_packed.shape[1]))
        return _priced("quant_gemv", call_cost(
            "quant_gemv", x, w_packed, scales, group=group), (out,), out)
    if _on_card(x):
        return _qg.quant_gemv(x, w_packed, scales, group=group)
    return ref.quant_gemv(x, w_packed, scales, group=group)


def launch_counts() -> dict:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def backward_launch_counts() -> dict:
    """Backward-kernel launches since the last reset: K5b's."""
    return {"add_rmsnorm_bwd": _rn.bwd_launches}


def rmsnorm_counts_by_card() -> dict:
    """{card index: (K5 launches, K5b launches)} since the last reset."""
    return {c: (_rn.by_card.get(c, 0), _rn.bwd_by_card.get(c, 0))
            for c in sorted(set(_rn.by_card) | set(_rn.bwd_by_card))}


def reset_launch_counts() -> None:
    """Every forward and backward count to zero."""
    for mod in _KERNELS.values():
        mod.launches = 0
    _rn.bwd_launches = 0
    _rn.by_card.clear()
    _rn.bwd_by_card.clear()
