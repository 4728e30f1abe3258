"""The training path's attention and losses against the JAX reference on
the CPU: ``chunked_attention`` values and gradients (causal, windowed,
non-causal cross, GQA, a ``q_offset``, ragged chunks), ``attention``'s
choice of form on both sides of Sq * Skv = 256², ``bf16_grad``'s
cotangent, ``softmax_cross_entropy`` with a mask and
``aux_load_balance_loss``. Float32 values and gradients within 2e-5."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.configs import registry as treg
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, sq, sk, hq, hkv, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, dh)).astype(np.float32)
    g = rng.standard_normal((2, sq, hq, dh)).astype(np.float32)
    return q, k, v, g


CASES = {  # sq, sk, hq, hkv, causal, window, q_offset, q_chunk, kv_chunk
    "causal": (300, 300, 4, 4, True, None, 0, 64, 64),
    "causal_gqa": (300, 300, 4, 2, True, None, 0, 128, 64),
    "window": (300, 300, 4, 1, True, 50, 0, 64, 32),
    "cross_noncausal": (100, 260, 4, 4, False, None, 0, 32, 64),
    "q_offset": (128, 256, 4, 2, True, None, 128, 64, 64),
    "one_chunk": (40, 40, 2, 2, True, None, 0, 1024, 1024),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_attention_values_and_grads_match_jax(case):
    sq, sk, hq, hkv, causal, window, qo, qc, kc = CASES[case]
    q, k, v, g = _qkv(0, sq, sk, hq, hkv)
    kw = dict(causal=causal, window=window, q_offset=qo, q_chunk=qc,
              kv_chunk=kc)
    @jax.jit
    def oracle(q, k, v, g):
        out, vjp = jax.vjp(
            lambda q, k, v: JA.chunked_attention(q, k, v, **kw), q, k, v)
        return out, vjp(g)

    want, jgrads = oracle(*(jnp.asarray(a) for a in (q, k, v, g)))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = A.chunked_attention(*t, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(g))
    for tg, jg in zip(t, jgrads):
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg), **TOL)


def test_chunked_attention_bf16_matches_jax():
    """bf16 inputs: scores and values products exact in fp32, the
    probabilities rounded to bf16 first, as the reference's."""
    q, k, v, _ = _qkv(1, 300, 300, 4, 2)
    kw = dict(causal=True, window=None, q_offset=0, q_chunk=128,
              kv_chunk=128)
    want = jax.jit(lambda q, k, v: JA.chunked_attention(q, k, v, **kw))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = A.chunked_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("sq,sk", [(256, 256), (260, 256), (100, 700)])
def test_attention_picks_the_reference_form_below_256_squared(sq, sk):
    """``impl="chunked"`` is the naive form where Sq * Skv <= 256² and
    the chunked one above, as the reference's ``attention`` is; both
    match the reference's."""
    q, k, v, _ = _qkv(2, sq, sk, 4, 2)
    causal = sq <= sk
    jgot = JA.attention(*(jnp.asarray(a) for a in (q, k, v)),
                        causal=causal, impl="chunked", q_chunk=128,
                        kv_chunk=128)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = A.attention(*t, causal=causal, impl="chunked", q_chunk=128,
                      kv_chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
    small = sq * sk <= 256 * 256
    naive = A.reference_attention(*t, causal=causal)
    chunked = A.chunked_attention(*t, causal=causal, q_chunk=128,
                                  kv_chunk=128)
    assert torch.equal(got, naive if small else chunked)
    assert torch.equal(A.attention(*t, causal=causal, impl="reference"),
                       naive)
    with pytest.raises(ValueError, match="unknown attention impl"):
        A.attention(*t, impl="flash")


def test_bf16_grad_casts_the_cotangent_only():
    x = torch.randn(3, 4, requires_grad=True)
    y = A.bf16_grad(x)
    assert torch.equal(y, x) and y.dtype == torch.float32
    (y * torch.full((3, 4), 1 / 3)).sum().backward()
    assert x.grad.dtype == torch.float32   # autograd casts back to x's
    g = torch.full((3, 4), 1 / 3)
    got = A._Bf16Grad.backward(None, g)
    assert got.dtype == torch.bfloat16
    assert torch.equal(x.grad, got.float())
    _, vjp = jax.vjp(JA.bf16_grad, jnp.ones((3, 4)))
    assert vjp(jnp.full((3, 4), 1 / 3))[0].dtype == jnp.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.4) if masked else None
    f = lambda z: JL.softmax_cross_entropy(  # noqa: E731
        z, jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    want, jg = jax.value_and_grad(f)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = L.softmax_cross_entropy(
        z, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert abs(got.item() - float(want)) < 1e-5
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), **TOL)
    none = L.softmax_cross_entropy(z, torch.from_numpy(labels),
                                   torch.zeros((2, 7), dtype=torch.bool))
    assert none.item() == 0.0   # nothing kept: at least one counted


def test_aux_load_balance_loss_matches_jax():
    jcfg = jreg.get_smoke_config("deepseek-moe-16b")
    cfg = treg.get_smoke_config("deepseek-moe-16b")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(
        np.float32)
    want, jg = jax.value_and_grad(
        lambda r: JM.aux_load_balance_loss({"router": r}, jcfg,
                                           jnp.asarray(x)))(
        jnp.asarray(router))
    r = torch.from_numpy(router).requires_grad_()
    got = M.aux_load_balance_loss({"router": r}, cfg, torch.from_numpy(x))
    got.backward()
    assert abs(got.item() - float(want)) < 1e-5
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jg), **TOL)
