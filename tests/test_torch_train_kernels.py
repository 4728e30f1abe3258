"""K5b — the backward of K5 (``add_rmsnorm_bwd``) — and the autograd
wiring of ``ops.add_rmsnorm`` on the CPU, the guard on every kernel
without a backward, and K5b's launch plan and cost (pure Python).

The plain K5b is held to torch's autograd of the plain K5 and to
``jax.grad`` of the reference's ``x + a`` then ``layers.rmsnorm``: the
float32 results differ in summation order only (2e-5); a bf16 result
may sit a rounding apart (1e-2). The card's kernel against the plain
version is ``tests/test_torch_train_card.py`` (``-m cuda``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as krn

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: dict(atol=2e-5, rtol=2e-5), BF16: dict(atol=1e-2, rtol=1e-2)}
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
# (x, a or None, h) dtypes: bf16 and float32 training, the W4 step's mix
COMBOS = [(F32, F32, F32), (BF16, BF16, BF16), (F32, BF16, BF16),
          (F32, None, F32), (BF16, None, BF16)]


def _inputs(seed, shape, xdt, adt, hdt):
    rng = np.random.default_rng(seed)
    x, a, gh, gs = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    t = {"x": torch.from_numpy(x).to(xdt), "w": torch.from_numpy(w).to(xdt),
         "a": None if adt is None else torch.from_numpy(a).to(adt),
         "gh": torch.from_numpy(gh).to(hdt), "gs": torch.from_numpy(gs).to(
             xdt)}
    return t


def _jax_grads(t, hdt):
    """(gx, ga, gw) of jax.vjp of s = x + a, h = rmsnorm(s, w) cast to
    h's dtype, with cotangents gh on h and gs on s (s itself when a is
    None, where only gh flows)."""
    j = {k: None if v is None else jnp.asarray(v.float().numpy()).astype(
        JDT[v.dtype]) for k, v in t.items()}

    def f(x, a, w):
        s = x if a is None else x + a
        return s, jlayers.rmsnorm(s, w).astype(JDT[hdt])

    if t["a"] is None:
        _, vjp = jax.vjp(lambda x, w: f(x, None, w)[1], j["x"], j["w"])
        gx, gw = vjp(j["gh"])
        return gx, None, gw
    _, vjp = jax.vjp(f, j["x"], j["a"], j["w"])
    return vjp((j["gs"], j["gh"]))


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dt])


@pytest.mark.parametrize("xdt,adt,hdt", COMBOS,
                         ids=lambda d: str(d).removeprefix("torch."))
def test_plain_bwd_matches_autograd_and_jax(xdt, adt, hdt):
    t = _inputs(0, (6, 64), xdt, adt, hdt)
    s, _ = ref.add_rmsnorm(t["x"], t["a"], t["w"])
    gs = None if adt is None else t["gs"]
    gx, ga, gw = ref.add_rmsnorm_bwd(s, t["w"], t["gh"], gs, add_dtype=adt)
    assert gx.dtype == xdt and gw.dtype == xdt and gw.shape == (64,)
    assert (ga is None) == (adt is None)
    # torch's autograd of the plain forward
    leaves = [v.clone().requires_grad_() for v in (t["x"], t["a"], t["w"])
              if v is not None]
    x, w = leaves[0], leaves[-1]
    a = leaves[1] if adt is not None else None
    s2, h2 = ref.add_rmsnorm(x, a, w, out_dtype=hdt)
    outs, cots = ([h2], [t["gh"]]) if adt is None else ([s2, h2],
                                                        [gs, t["gh"]])
    auto = torch.autograd.grad(outs, leaves, cots)
    mine = [gx] + ([] if adt is None else [ga]) + [gw]
    for got, want in zip(mine, auto):
        assert got.dtype == want.dtype
        _close(got, want.float().numpy(), BF16 if BF16 in (xdt, adt, hdt)
               else F32)
    # jax.grad of the reference's add and RMSNorm
    jg = _jax_grads(t, hdt)
    for got, want in zip((gx, ga, gw), jg):
        if got is not None:
            _close(got, want, BF16 if BF16 in (xdt, adt, hdt) else F32)


@pytest.mark.parametrize("xdt,adt,hdt", COMBOS,
                         ids=lambda d: str(d).removeprefix("torch."))
def test_ops_add_rmsnorm_is_an_autograd_node_with_k5b_backward(xdt, adt,
                                                               hdt):
    """Under grad the forward gives the same bits as without, and the
    backward is the plain K5b on the same cotangents, bit for bit; a
    cotangent that does not reach s (its h only) is taken as none."""
    t = _inputs(1, (2, 3, 128), xdt, adt, hdt)
    s0, h0 = ops.add_rmsnorm(t["x"], t["a"], t["w"], out_dtype=hdt)
    assert h0.grad_fn is None and s0.grad_fn is None
    x = t["x"].clone().requires_grad_()
    a = None if adt is None else t["a"].clone().requires_grad_()
    w = t["w"].clone().requires_grad_()
    s, h = ops.add_rmsnorm(x, a, w, out_dtype=hdt)
    assert torch.equal(s, s0) and torch.equal(h, h0)
    assert h.grad_fn is not None
    if adt is None:
        assert s is x
        h.backward(t["gh"])
        want = ref.add_rmsnorm_bwd(s0, t["w"], t["gh"])
    else:
        torch.autograd.backward([s, h], [t["gs"], t["gh"]])
        want = ref.add_rmsnorm_bwd(s0, t["w"], t["gh"], t["gs"],
                                   add_dtype=adt)
    got = (x.grad, None if a is None else a.grad, w.grad)
    for g, wnt in zip(got, want):
        assert (g is None) == (wnt is None)
        if g is not None:
            assert torch.equal(g, wnt)
    if adt is not None:   # h alone carries a cotangent: gs taken as none
        x.grad = a.grad = w.grad = None
        s, h = ops.add_rmsnorm(x, a, w, out_dtype=hdt)
        h.backward(t["gh"])
        gx, ga, gw = ref.add_rmsnorm_bwd(s0, t["w"], t["gh"],
                                         add_dtype=adt)
        assert torch.equal(x.grad, gx) and torch.equal(a.grad, ga)
        assert torch.equal(w.grad, gw)


def test_grad_off_saves_nothing_and_keeps_the_bits():
    """With grad off, or no operand requiring grad, the call is the one
    the serving path always made: no graph, so nothing saved, and the
    same bits as the plain forward."""
    t = _inputs(2, (4, 64), F32, F32, F32)
    want = ref.add_rmsnorm(t["x"], t["a"], t["w"])
    with torch.no_grad():
        x = t["x"].clone().requires_grad_()
        s, h = ops.add_rmsnorm(x, t["a"], t["w"])
    assert s.grad_fn is None and h.grad_fn is None
    assert torch.equal(s, want[0]) and torch.equal(h, want[1])
    s, h = ops.add_rmsnorm(t["x"], t["a"], t["w"])
    assert s.grad_fn is None and h.grad_fn is None
    assert torch.equal(h, want[1])
    # under grad, the node saves s and w only
    x = t["x"].clone().requires_grad_()
    _, h = ops.add_rmsnorm(x, t["a"], t["w"])
    saved = h.grad_fn.saved_tensors
    assert len(saved) == 2 and torch.equal(saved[0], want[0])


def test_plain_bwd_holds_the_kernel_contract():
    s, w = torch.zeros((2, 64)), torch.ones(64)
    with pytest.raises(ValueError, match="cotangent shapes"):
        ops._add_rmsnorm_bwd(s, w, torch.zeros((2, 32)), None, 1e-6, None)
    with pytest.raises(TypeError, match="gs dtype"):
        ops._add_rmsnorm_bwd(s, w, torch.zeros((2, 64)),
                             torch.zeros((2, 64), dtype=BF16), 1e-6, F32)
    with pytest.raises(TypeError, match="not instantiated"):
        ops._add_rmsnorm_bwd(s.to(BF16), w.to(BF16), torch.zeros((2, 64)),
                             None, 1e-6, None)


def test_bwd_launch_plan_and_cost():
    """The forward's block shape; one block per row up to the grid that
    fills 132 SMs with 1024 threads each; the cost counts s, gh, gs and
    w read once, gx, ga and gw written once."""
    assert krn.bwd_launch_plan(8192, 1024, 2) == (128, 1, 1056)
    assert krn.bwd_launch_plan(8192, 1024, 4) == (256, 1, 528)
    assert krn.bwd_launch_plan(8, 2560, 2) == (320, 1, 8)
    assert krn.bwd_launch_plan(4096, 5120, 2) == (640, 1, 212)
    assert krn.bwd_launch_plan(64, 8192, 4) == (1024, 2, 64)
    m, d = 8192, 1024
    flops, nbytes = krn.bwd_cost((m, d), BF16, add_dtype=BF16)
    assert flops == 11.0 * m * d
    assert nbytes == m * d * 2 * 5 + 2 * d * 2   # s, gh, gs, gx, ga; w, gw
    _, nb = krn.bwd_cost((m, d), F32, add_dtype=None, out_dtype=BF16,
                         residual=False)
    assert nb == m * d * (4 + 2 + 4) + 2 * d * 4  # s, gh, gx; w, gw


def _grad_operand(*shape):
    return torch.zeros(shape, requires_grad=True)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "decode_attention_shard",
                                  "paged_decode_attention",
                                  "prefill_attention", "verify_attention",
                                  "quant_gemv"])
def test_kernels_without_backward_refuse_grad(name):
    """Each kernel without a backward raises on an operand that requires
    grad (on either device: the guard comes before the device), and runs
    as ever under no_grad."""
    q = _grad_operand(1, 1, 4, 16)
    kv = torch.zeros((1, 8, 4, 16))
    lens = torch.tensor([3])
    calls = {
        "flash_attention": lambda q: ops.flash_attention(q, kv, kv),
        "decode_attention": lambda q: ops.decode_attention(q, kv, kv, lens),
        "decode_attention_shard": lambda q: ops.decode_attention_shard(
            q, kv, kv, lens, offset=0, gather=lambda t, dim: t),
        "paged_decode_attention": lambda q: ops.paged_decode_attention(
            q, kv.reshape(2, 4, 4, 16), kv.reshape(2, 4, 4, 16),
            torch.tensor([[0, 1]], dtype=torch.int32), lens),
        "prefill_attention": lambda q: ops.prefill_attention(
            q, kv, kv, lens, q[:, :, :4].detach(), q[:, :, :4].detach()),
        "verify_attention": lambda q: ops.verify_attention(
            q, kv, kv, lens, q[:, :, :4].detach(), q[:, :, :4].detach()),
        "quant_gemv": lambda x: ops.quant_gemv(
            x, torch.zeros((8, 16), dtype=torch.uint8),
            torch.ones((1, 16)), group=16),
    }
    arg = _grad_operand(1, 16) if name == "quant_gemv" else q
    with pytest.raises(RuntimeError, match="no backward"):
        calls[name](arg)
    with torch.no_grad():
        calls[name](arg)


def test_k5_launch_counters_reset_together():
    krn.launches, krn.bwd_launches = 3, 4
    ops.reset_launch_counts()
    assert ops.launch_counts()["rmsnorm"] == 0
    assert ops.backward_launch_counts() == {"add_rmsnorm_bwd": 0}
