"""Port kernels: the plain PyTorch versions (the CPU path of
``repro_torch.kernels.ops``) against the JAX Pallas kernels in interpret
mode and the JAX model functions, at small shapes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as pattn

# float32 against the Pallas interpret path, as tests/test_kernels.py
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_rmsnorm_plain_matches_pallas_and_model():
    x, w = _inputs(0, (3, 5, 64), (64,))
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, jops.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    _close(got, jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("case,sq,sk,hq,hkv,window", [
    ("causal", 40, 40, 2, 2, None),
    ("window", 48, 48, 2, 2, 16),
    ("q_offset", 24, 56, 2, 2, None),   # continuation: q at sk - sq ..
    ("gqa", 32, 32, 8, 2, None),
])
def test_flash_attention_plain_matches_pallas(case, sq, sk, hq, hkv, window):
    dh = 16
    q, k, v = _inputs(1, (1, sq, hq, dh), (1, sk, hkv, dh), (1, sk, hkv, dh))
    q_off = sk - sq
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window, q_offset=q_off)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                q_offset=q_off, block_q=16, block_k=16)
    _close(got, want)
    model = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      window=window, q_offset=q_off)
    _close(got, model)
    _close(pattn.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_offset=q_off), model)


@pytest.mark.parametrize("case,sq,sk,hq,hkv,dh,causal,window", [
    ("window_dh80", 48, 48, 4, 2, 80, True, 16),   # h2o-danube's head dim
    ("encoder", 40, 40, 2, 2, 16, False, None),    # whisper's encoder
    ("cross", 16, 40, 2, 2, 16, False, None),      # its cross-attention
])
def test_flash_attention_plain_matches_pallas_window_and_audio(
        case, sq, sk, hq, hkv, dh, causal, window):
    """The rolling-window and whisper slice's K3 calls: head dim 80 with a
    window, and non-causal with Skv == Sq and Skv != Sq."""
    q, k, v = _inputs(2, (1, sq, hq, dh), (1, sk, hkv, dh), (1, sk, hkv, dh))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                block_q=16, block_k=16)
    _close(got, want)
    _close(got, jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_attention_plain_matches_pallas_and_model(hq, hkv):
    b, cap, dh = 3, 40, 16
    q, kc, vc, ek, ev = _inputs(2, (b, 1, hq, dh), (b, cap, hkv, dh),
                                (b, cap, hkv, dh), (b, 1, hkv, dh),
                                (b, 1, hkv, dh))
    lens = np.array([cap, 17, 1], np.int32)   # ragged, one full row
    t = [torch.from_numpy(a) for a in (q, kc, vc, ek, ev)]
    # cache only: the Pallas split-KV kernel
    got = ops.decode_attention(t[0], t[1], t[2], torch.from_numpy(lens))
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lens),
                                 block_s=16)
    _close(got, want)
    # with the current token's self partial: the model-side function
    got = ops.decode_attention(t[0], t[1], t[2], torch.from_numpy(lens),
                               extra_k=t[3], extra_v=t[4])
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(lens),
                                  extra_k=jnp.asarray(ek),
                                  extra_v=jnp.asarray(ev))
    _close(got, want)


def _scattered_tables(rng, lens, nb, bs, w):
    """Per-row block tables over a seeded permutation of ``nb`` pool
    blocks; entries past each row's length are the sentinel ``nb``."""
    perm = rng.permutation(nb)
    tab = np.full((len(lens), w), nb, np.int32)
    k = 0
    for i, n in enumerate(lens):
        m = -(-int(n) // bs)
        tab[i, :m] = perm[k:k + m]
        k += m
    return tab


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_paged_decode_attention_plain_matches_pallas_and_model(hq, hkv):
    b, nb, bs, w, dh = 3, 12, 8, 5, 16
    q, kp, vp, ek, ev = _inputs(4, (b, 1, hq, dh), (nb, bs, hkv, dh),
                                (nb, bs, hkv, dh), (b, 1, hkv, dh),
                                (b, 1, hkv, dh))
    lens = np.array([w * bs, 17, 1], np.int32)  # one full row, ragged
    tab = _scattered_tables(np.random.default_rng(5), lens, nb, bs, w)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tab, lens, ek, ev)]
    j = [jnp.asarray(a) for a in (q, kp, vp, tab, lens, ek, ev)]
    # pool only: the Pallas paged kernel (block table as scalar prefetch)
    _close(ops.paged_decode_attention(*t[:5]),
           jops.paged_decode_attention(*j[:5]))
    # with the self partial: the model's gather-then-decode
    got = ops.paged_decode_attention(*t[:5], extra_k=t[5], extra_v=t[6])
    _close(got, jattn.decode_attention(j[0], j[1], j[2], j[4], extra_k=j[5],
                                       extra_v=j[6], block_tables=j[3]))
    _close(pattn.decode_attention(t[0], t[1], t[2], t[4], extra_k=t[5],
                                  extra_v=t[6], block_tables=t[3]),
           got.numpy(), dict(atol=0, rtol=0))


@pytest.mark.parametrize("s", [16, 3])
@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_attention_plain_matches_pallas_and_model(s, per_row):
    b, c, hq, hkv, dh = 3, 40, 8, 2, 16
    q, kh, vh, ks, vs = _inputs(6, (b, s, hq, dh), (b, c, hkv, dh),
                                (b, c, hkv, dh), (b, s, hkv, dh),
                                (b, s, hkv, dh))
    hist = np.array([0, 17, c], np.int32) if per_row else np.int32(23)
    t = [torch.from_numpy(np.asarray(a)) for a in (q, kh, vh, hist, ks, vs)]
    j = [jnp.asarray(a) for a in (q, kh, vh, hist, ks, vs)]
    got = ops.prefill_attention(*t)
    _close(got, jops.prefill_attention(*j))         # Pallas interpret
    _close(got, jattn.prefill_over_cache(*j))       # the model's op
    _close(ops.verify_attention(*t), got.numpy(), dict(atol=0, rtol=0))
    _close(pattn.prefill_over_cache(*t), got.numpy(), dict(atol=0, rtol=0))


def test_cpu_ops_take_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    x, w = _inputs(3, (4, 64), (64,))
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got, ref.rmsnorm(torch.from_numpy(x),
                                        torch.from_numpy(w)))
    assert ops.launch_counts() == {
        "rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
        "paged_decode_attention": 0, "prefill_attention": 0,
        "quant_gemv": 0}
