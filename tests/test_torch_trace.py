"""The port's op-stream tracer (``repro_torch.core.trace``) — the
counterparts of ``tests/test_trace.py`` — and each kernel's ``cost()``
against closed forms, with K1 / K2 / K6 FLOPs equal to the reference's
traced ``repro.kernels.ref`` FLOPs at the same shapes. Everything runs
on meta tensors; the JAX side traces ``ShapeDtypeStruct``s."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.core import trace as JT
from repro.kernels import ref as JR
from repro_torch.core import trace as T
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as kpdec
from repro_torch.kernels import prefill_attention as kpre
from repro_torch.kernels import quant_gemv as kqg
from repro_torch.kernels import rmsnorm as krn
from _torch_threads import one_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16


def meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_exact():
    x, w = meta(8, 64), meta(64, 32)
    ops_ = T.trace_ops(lambda x, w: x @ w, x, w, weights=w)
    mm = [o for o in ops_ if o.kind == "gemm"]
    assert len(mm) == 1
    assert mm[0].flops == 2 * 8 * 64 * 32
    assert mm[0].weight_bytes == 64 * 32 * 4
    assert mm[0].in_bytes == (8 * 64 + 64 * 32) * 4


def test_gemv_classification():
    """One row -> gemv (the decode workload class)."""
    x, w = meta(1, 64), meta(64, 32)
    ops_ = T.trace_ops(lambda x, w: x @ w, x, w, weights=w)
    assert [o.kind for o in ops_ if o.prim == "mm"] == ["gemv"]


def test_batched_attention_scores_carry_no_weight():
    q, k = meta(2, 16, 4, 8), meta(2, 16, 4, 8)
    ops_ = T.trace_ops(lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k),
                       q, k)
    (mm,) = [o for o in ops_ if o.kind == "gemm"]
    assert mm.weight_bytes == 0.0
    assert mm.flops == 2 * 2 * 4 * 16 * 16 * 8


def test_stacked_expert_weight_found():
    """A stacked (E, d, f) expert weight reaches aten as a reshaped view:
    it is found by identity, not by rank."""
    x, w = meta(4, 8, 16), meta(4, 16, 32)
    ops_ = T.trace_ops(lambda x, w: torch.einsum("ecd,edf->ecf", x, w),
                       x, w, weights={"experts": w})
    (mm,) = [o for o in ops_ if o.prim == "bmm"]
    assert mm.batch_dims == 1
    assert mm.weight_bytes == 4 * 16 * 32 * 4
    assert mm.flops == 2 * 4 * 8 * 16 * 32


def test_weight_through_layer_views_transposes_and_casts():
    """A layer's slice of a stacked leaf, ``F.linear``'s transposed view
    and a float32 copy of a bf16 weight are all the weight, counted at
    the leaf's own dtype; an activation of the same shape is not."""
    w = meta(3, 32, 64, dtype=BF16)
    x = meta(5, 64, dtype=BF16)

    def fn(x, w):
        a = F.linear(x, w[1])                       # (5, 32), w[1].T
        b = x.float() @ w[2].float().T             # the CPU logits path
        c = a @ x[:, :32].T                         # activation only
        return a, b, c

    ops_ = T.trace_ops(fn, x, w, weights=[w])
    mms = [o for o in ops_ if o.kind in ("gemm", "gemv")]
    assert [o.weight_bytes for o in mms] == [32 * 64 * 2, 32 * 64 * 2, 0.0]


def test_gather_charges_gathered_rows_only():
    table, idx = meta(1000, 64), meta(8, dtype=torch.long)
    ops_ = T.trace_ops(lambda t, i: t[i], table, idx)
    (data,) = [o for o in ops_ if o.kind == "data"]
    assert data.out_bytes == 8 * 64 * 4
    assert data.in_bytes == 8 * 8          # the indices only


def test_scatter_charges_the_update_slice_only():
    cache, idx, new = meta(1000, 64), meta(8, dtype=torch.long), meta(8, 64)

    def fn(c, i, v):
        c[i] = v
        return c

    ops_ = T.trace_ops(fn, cache, idx, new)
    (data,) = [o for o in ops_ if o.kind == "data"]
    assert data.prim == "index_put_"
    assert data.in_bytes == data.out_bytes == 8 * 8 + 8 * 64 * 4


def test_totals_aggregation():
    x, w = meta(8, 16), meta(16, 16)
    t = T.totals(T.trace_ops(lambda x, w: torch.relu(x @ w).sum(), x, w,
                             weights=w))
    assert t.matmul_flops == 2 * 8 * 16 * 16
    assert t.weight_bytes == 16 * 16 * 4
    assert t.vector_ops == 8 * 16 + 8 * 16       # relu + the sum
    assert t.approx_ops == 0


def test_views_copies_and_creation_are_free():
    def fn(x):
        y = x.reshape(16, 4).t().contiguous().float()
        return torch.zeros_like(y) + y[:1]

    ops_ = T.trace_ops(fn, meta(64, dtype=BF16))
    assert [o.prim for o in ops_] == ["add"]


def test_python_loops_are_recorded_per_iteration():
    """The port's counterpart of the reference's scan multiplier: a
    Python loop is traced once per iteration, never guessed."""
    def fn(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    x, w = meta(8, 16), meta(16, 16)
    ops_ = T.trace_ops(fn, x, w, weights=w)
    mm = [o for o in ops_ if o.kind == "gemm"]
    assert len(mm) == 7 and sum(o.flops for o in mm) == 7 * 2 * 8 * 16 * 16
    assert T.totals(ops_).approx_ops == 0


def test_host_scalar_arithmetic_is_not_device_work():
    def fn(x):
        s = torch.tensor(4.0).sqrt().item()      # on the host
        return x * s

    assert [o.prim for o in T.trace_ops(fn, meta(8))] == ["mul"]


def test_memoized_meta_outputs_trace_the_same_stream(monkeypatch):
    """A repeated op's meta outputs come from the memo: the stream, the
    records and the outputs' shapes are those of running every op."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = registry.get_smoke_config("deepseek-moe-16b")
    p = MD.init_params(cfg, device="meta")
    cache = MD.cache_spec(cfg, 2, 40)
    tok = meta(2, 1, dtype=torch.int32)

    def step(p, t, c):
        return MD.decode_step(p, cfg, t, c)

    T._META_OUTS.clear()
    cold = T.trace_ops(step, p, tok, cache, weights=p)
    warm = T.trace_ops(step, p, tok, cache, weights=p)
    monkeypatch.setattr(T, "_memoizable", lambda func: False)
    plain = T.trace_ops(step, p, tok, cache, weights=p)
    assert cold == warm == plain and len(plain) > 100
    assert T._META_OUTS


def test_unknown_op_lands_in_other_with_its_bytes():
    ops_ = T.trace_ops(lambda x: torch.linalg.cholesky(x), meta(16, 16))
    other = [o for o in ops_ if o.kind == "other"]
    assert other and other[0].in_bytes == 16 * 16 * 4


# ---------------------------------------------------------------------------
# two-point linear tracing (KV growth)
# ---------------------------------------------------------------------------

def test_trace_linear_recovers_linear_costs():
    def of_len(L):
        def f(q, kv):
            return torch.einsum("bd,bkd->bk", q, kv)
        return f, (meta(1, 8), meta(1, L, 8))

    lin = T.trace_linear(of_len, 64, 256)
    (mm,) = [o for o in lin if o.prim == "bmm"]
    for L in (64, 100, 256, 1000):
        assert mm.at(L).flops == pytest.approx(2 * L * 8)


def test_trace_linear_rejects_structural_change():
    def of_len(L):
        if L > 100:
            return (lambda x: torch.sin(x).sum()), (meta(L),)
        return (lambda x: (torch.sin(x) + torch.cos(x)).sum()), (meta(L),)

    with pytest.raises(ValueError):
        T.trace_linear(of_len, 64, 256)


# ---------------------------------------------------------------------------
# the kernels' cost() and their meta records
# ---------------------------------------------------------------------------

def _kernel_record(fn, *operands):
    """The one kernel record ``fn`` leaves, and the whole stream."""
    recs = T.trace_ops(fn, *operands)
    (k,) = [o for o in recs if o.kind == "kernel"]
    return k, recs


def _jax_dot_flops(fn, *shapes):
    """The reference tracer's dot FLOPs of ``fn`` at ``shapes``."""
    specs = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    recs = JT.trace_ops(fn, *specs)
    return sum(o.flops for o in recs if o.prim == "dot_general")


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,cap,hq,hkv,dh", [(2, 64, 8, 2, 16),
                                             (8, 2048, 16, 16, 64)])
def test_k1_cost_closed_form_and_reference_flops(b, cap, hq, hkv, dh, dtype):
    elt = torch.empty((), dtype=dtype).element_size()
    lens = [cap] + [(7 * i + 3) % cap + 1 for i in range(1, b)]
    tot = sum(lens)
    flops, nbytes = kdec.cost((b, 1, hq, dh), (b, cap, hkv, dh), dtype, lens)
    # chip_smoke's phase-2 count: cache rows read, q in, out, self K/V
    assert nbytes == ((2 * tot * hkv * dh + 2 * b * hq * dh
                       + 2 * b * hkv * dh) * elt + 4 * b)
    assert flops == 4 * (tot + b) * hq * dh
    # at the capacity and without the self partial: the reference's
    # traced decode_attention_ref dot FLOPs
    f_cap, _ = kdec.cost((b, 1, hq, dh), (b, cap, hkv, dh), dtype,
                         self_kv=False)
    assert f_cap == _jax_dot_flops(
        lambda q, k, v, n: JR.decode_attention_ref(q, k, v, n),
        ((b, 1, hq, dh), jnp.float32), ((b, cap, hkv, dh), jnp.float32),
        ((b, cap, hkv, dh), jnp.float32), ((b,), jnp.int32))
    # the meta record of the ops entry is that cost, at the capacity
    k, _ = _kernel_record(
        lambda q, kc, vc, n, ek, ev: ops.decode_attention(
            q, kc, vc, n, extra_k=ek, extra_v=ev),
        meta(b, 1, hq, dh, dtype=dtype), meta(b, cap, hkv, dh, dtype=dtype),
        meta(b, cap, hkv, dh, dtype=dtype), meta(b, dtype=torch.int32),
        meta(b, 1, hkv, dh, dtype=dtype), meta(b, 1, hkv, dh, dtype=dtype))
    want = kdec.cost((b, 1, hq, dh), (b, cap, hkv, dh), dtype)
    assert (k.prim, k.flops, k.in_bytes + k.out_bytes) == (
        "decode_attention", *want)
    assert k.out_bytes == b * hq * dh * elt and k.rows == 1


def test_k1_rolling_window_rows():
    """A rolling row is valid to min(len, C); a full one masks the slot
    one window back (chip_smoke's ``rolling_decode_case`` rows)."""
    cap, lens = 4096, (600, 4095, 4096, 4097, 8191)
    rows = 600 + 4095 + 3 * 4095
    flops, nbytes = kdec.cost((5, 1, 32, 128), (5, cap, 8, 128), BF16,
                              lens, window=cap)
    assert nbytes == (2 * rows * 8 * 128 + 2 * 5 * 32 * 128
                      + 2 * 5 * 8 * 128) * 2 + 4 * 5
    assert flops == 4 * (rows + 5) * 32 * 128
    # a window wider than the cache never masks
    assert kdec.positions_read(1, cap, [5000], window=8192) == cap


def test_k2_cost_is_k1_at_the_table_capacity_plus_the_table():
    b, w, bs, hq, hkv, dh = 2, 4, 16, 8, 2, 16
    lens = [50, 9]
    f2, b2 = kpdec.cost((b, 1, hq, dh), (20, bs, hkv, dh), (b, w), F32,
                        lens)
    f1, b1 = kdec.cost((b, 1, hq, dh), (b, w * bs, hkv, dh), F32, lens)
    assert (f2, b2) == (f1, b1 + 4 * b * w)
    f_cap, _ = kpdec.cost((b, 1, hq, dh), (20, bs, hkv, dh), (b, w), F32,
                          self_kv=False)
    assert f_cap == _jax_dot_flops(
        lambda q, k, v, n: JR.decode_attention_ref(q, k, v, n),
        ((b, 1, hq, dh), jnp.float32), ((b, w * bs, hkv, dh), jnp.float32),
        ((b, w * bs, hkv, dh), jnp.float32), ((b,), jnp.int32))
    k, _ = _kernel_record(
        lambda q, kp, vp, t, n: ops.paged_decode_attention(q, kp, vp, t, n),
        meta(b, 1, hq, dh), meta(20, bs, hkv, dh), meta(20, bs, hkv, dh),
        meta(b, w, dtype=torch.int32), meta(b, dtype=torch.int32))
    assert (k.flops, k.in_bytes + k.out_bytes) == kpdec.cost(
        (b, 1, hq, dh), (20, bs, hkv, dh), (b, w), F32, self_kv=False)


@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (64, 64, False, None, 0), (48, 80, False, None, 0),
    (64, 64, True, None, 0), (64, 64, True, 16, 0),
    (16, 80, True, None, 64), (300, 300, True, 128, 0)])
def test_k3_cost_kept_pairs(sq, skv, causal, window, q_offset):
    b, hq, hkv, dh = 2, 8, 2, 16
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    pairs = int(ok.sum())
    flops, nbytes = kfa.cost((b, sq, hq, dh), (b, skv, hkv, dh), BF16,
                             causal=causal, window=window, q_offset=q_offset)
    assert flops == 4 * b * pairs * hq * dh
    assert nbytes == (2 * b * sq * hq * dh + 2 * b * skv * hkv * dh) * 2
    if not causal:
        # non-causal: every pair, the reference's dot FLOPs (heads
        # expanded, as the reference's flash entry expands them)
        assert flops == _jax_dot_flops(
            lambda q, k, v: JR.flash_attention_ref(q, k, v, causal=False),
            ((b, sq, hq, dh), jnp.float32), ((b, skv, hq, dh), jnp.float32),
            ((b, skv, hq, dh), jnp.float32))
    k, _ = _kernel_record(
        lambda q, kk, v: ops.flash_attention(q, kk, v, causal=causal,
                                             window=window,
                                             q_offset=q_offset),
        meta(b, sq, hq, dh, dtype=BF16), meta(b, skv, hkv, dh, dtype=BF16),
        meta(b, skv, hkv, dh, dtype=BF16))
    assert (k.flops, k.in_bytes + k.out_bytes) == (flops, nbytes)
    assert k.rows == sq


@pytest.mark.parametrize("b,s,c,hist", [(1, 256, 2048, [768]),
                                        (8, 5, 2048, None),
                                        (3, 5, 64, [0, 9, 64])])
def test_k4_cost_closed_form(b, s, c, hist):
    hq, hkv, dh = 16, 4, 64
    flops, nbytes = kpre.cost((b, s, hq, dh), (b, c, hkv, dh), BF16, hist)
    tot = b * c if hist is None else sum(hist)
    pairs = tot * s + b * s * (s + 1) // 2
    assert flops == 4 * pairs * hq * dh
    assert nbytes == ((2 * b * s * hq * dh + (2 * tot + 2 * b * s) * hkv * dh)
                      * 2 + 4 * b)
    # a host int history is known to the meta record; a tensor is not
    k, _ = _kernel_record(
        lambda q, kh, vh, ks, vs: ops.prefill_attention(q, kh, vh, 7, ks, vs),
        meta(b, s, hq, dh, dtype=BF16), meta(b, c, hkv, dh, dtype=BF16),
        meta(b, c, hkv, dh, dtype=BF16), meta(b, s, hkv, dh, dtype=BF16),
        meta(b, s, hkv, dh, dtype=BF16))
    assert k.flops == kpre.cost((b, s, hq, dh), (b, c, hkv, dh), BF16, 7)[0]


@pytest.mark.parametrize("xdt,adt,hdt", [(BF16, BF16, BF16),
                                         (F32, None, F32),
                                         (F32, BF16, BF16)])
def test_k5_cost_closed_form(xdt, adt, hdt):
    m, d = 24, 512
    ex, eh = (torch.empty((), dtype=t).element_size() for t in (xdt, hdt))
    flops, nbytes = krn.cost((2, 12, d), xdt, add_dtype=adt, out_dtype=hdt)
    if adt is None:    # x read, h written, w once
        assert (flops, nbytes) == (4 * m * d, m * d * (ex + eh) + d * ex)
    else:              # x and a read, s and h written, w once
        ea = torch.empty((), dtype=adt).element_size()
        assert (flops, nbytes) == (5 * m * d,
                                   m * d * (2 * ex + ea + eh) + d * ex)
    a = None if adt is None else meta(2, 12, d, dtype=adt)
    k, _ = _kernel_record(
        lambda x, w: ops.add_rmsnorm(x, a, w, out_dtype=hdt),
        meta(2, 12, d, dtype=xdt), meta(d, dtype=xdt))
    assert (k.prim, k.flops, k.in_bytes + k.out_bytes) == (
        "add_rmsnorm", flops, nbytes)


@pytest.mark.parametrize("b,k,n,group", [(1, 256, 384, 128), (8, 512, 64, 64)])
def test_k6_cost_closed_form_and_reference_flops(b, k, n, group):
    flops, nbytes = kqg.cost((b, k), (k // 2, n), BF16, group=group)
    assert nbytes == k * n // 2 + 4 * (k // group) * n + (b * k + b * n) * 2
    assert flops == 2 * b * k * n == _jax_dot_flops(
        lambda x, w, s: JR.quant_gemv_ref(x, w, s, group=group),
        ((b, k), jnp.bfloat16), ((k // 2, n), jnp.uint8),
        ((k // group, n), jnp.float32))
    rec, _ = _kernel_record(
        lambda x, w, s: ops.quant_gemv(x, w, s, group=group),
        meta(b, k, dtype=BF16), meta(k // 2, n, dtype=torch.uint8),
        meta(k // group, n))
    assert (rec.flops, rec.in_bytes + rec.out_bytes, rec.rows) == (
        flops, nbytes, b)


def test_meta_operand_without_a_tracer_raises():
    q = meta(1, 1, 4, 16)
    kv = meta(1, 8, 4, 16)
    with pytest.raises(ValueError, match="meta"):
        ops.decode_attention(q, kv, kv, 8)
    with pytest.raises(ValueError, match="meta"):
        ops.rmsnorm(meta(2, 16), meta(16))
    assert ops._meta_sink is None


def test_call_cost_prices_lengths_as_given():
    """``ops.call_cost`` (the wrappers' one argument -> ``cost()``
    mapping): a length tensor with storage is priced at its values, a
    host int as it is, a meta tensor at the capacity."""
    b, cap, hq, hkv, dh, w, bs = 2, 64, 8, 2, 16, 4, 16
    q, kc = torch.zeros(b, 1, hq, dh), torch.zeros(b, cap, hkv, dh)
    pool, tab = torch.zeros(10, bs, hkv, dh), torch.zeros(b, w)
    qc, ks = torch.zeros(b, 5, hq, dh), torch.zeros(b, 5, hkv, dh)
    lens = torch.tensor([50, 9])
    assert ops.call_cost("decode_attention", q, kc, kc, lens, extra_k=ks,
                         window=32) == kdec.cost(
        q.shape, kc.shape, F32, [50, 9], window=32)
    assert ops.call_cost("decode_attention", q, kc, kc, lens.to("meta")) \
        == kdec.cost(q.shape, kc.shape, F32, self_kv=False)
    assert ops.call_cost("paged_decode_attention", q, pool, pool, tab,
                         lens, extra_k=ks) == kpdec.cost(
        q.shape, pool.shape, tab.shape, F32, [50, 9])
    assert ops.call_cost("prefill_attention", qc, kc, kc, 40, ks, ks) \
        == kpre.cost(qc.shape, kc.shape, F32, 40)
    assert ops.call_cost("prefill_attention", qc, kc, kc, lens, ks, ks) \
        == kpre.cost(qc.shape, kc.shape, F32, [50, 9])
    assert ops.call_cost("flash_attention", qc, ks, ks, window=3,
                         q_offset=2) == kfa.cost(
        qc.shape, ks.shape, F32, window=3, q_offset=2)
    x = torch.zeros(3, 16, dtype=BF16)
    assert ops.call_cost("add_rmsnorm", x, x, torch.zeros(16),
                         out_dtype=F32) == krn.cost(
        x.shape, BF16, add_dtype=BF16, out_dtype=F32)
    assert ops.call_cost("quant_gemv", torch.zeros(2, 256),
                         torch.zeros(128, 64, dtype=torch.uint8),
                         torch.zeros(4, 64), group=64) == kqg.cost(
        (2, 256), (128, 64), F32, group=64)
