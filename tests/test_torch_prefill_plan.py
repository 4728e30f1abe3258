"""K3 and K4 at phi3-mini's head dim 96: the plain versions (the CPU
path of ``repro_torch.kernels.ops``) against the JAX Pallas kernels in
interpret mode, float32; and the arithmetic of K4's launch plan, which
picks the launch shape from S and the dtype and sizes the verify split
scratch from the capacity alone."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention as kpre

# float32 against the Pallas interpret path, as tests/test_kernels.py
TOL = dict(atol=2e-5, rtol=2e-5)
DH = 96


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("sq,sk,hq,hkv,window", [
    (40, 40, 2, 2, None),      # causal
    (24, 56, 8, 2, None),      # GQA continuation at q_offset 32
    (48, 48, 2, 2, 16),        # window
])
def test_flash_attention_dh96_plain_matches_pallas(sq, sk, hq, hkv, window):
    q, k, v = _inputs(11, (1, sq, hq, DH), (1, sk, hkv, DH),
                      (1, sk, hkv, DH))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window, q_offset=sk - sq)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                q_offset=sk - sq, block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [3, 20])
def test_prefill_attention_dh96_plain_matches_pallas_and_model(s):
    b, c, hq, hkv = 3, 40, 8, 2
    q, kh, vh, ks, vs = _inputs(12, (b, s, hq, DH), (b, c, hkv, DH),
                                (b, c, hkv, DH), (b, s, hkv, DH),
                                (b, s, hkv, DH))
    hist = np.array([0, 17, c], np.int32)
    got = ops.prefill_attention(
        *(torch.from_numpy(a) for a in (q, kh, vh, hist, ks, vs)))
    j = [jnp.asarray(a) for a in (q, kh, vh, hist, ks, vs)]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.prefill_attention(*j)), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jattn.prefill_over_cache(*j)),
                               **TOL)


@pytest.mark.parametrize("s,dtype,splits", [
    (1, torch.bfloat16, True),
    (5, torch.bfloat16, True),
    (16, torch.bfloat16, True),
    (17, torch.bfloat16, False),
    (256, torch.bfloat16, False),
    (5, torch.float32, False),     # float32 keeps the CUDA-core body
])
def test_launch_plan_shape_follows_s_and_dtype(s, dtype, splits):
    plan = kpre.launch_plan(8, s, 2048, 16, 64, dtype)
    assert plan.splits is splits
    if splits:
        assert plan.ns == 16
        assert plan.o_shape == (8, 16, s, 17, 64)
        assert plan.ml_shape == (8, 16, s, 17)
    else:
        assert plan == kpre.Plan(False, 0, (), ())


@pytest.mark.parametrize("c,ns", [(0, 0), (1, 1), (127, 1), (128, 1),
                                  (129, 2), (2048, 16), (2080, 17)])
def test_launch_plan_splits_follow_capacity(c, ns):
    """ceil(C / 128) history splits, plus one self slot in the scratch."""
    plan = kpre.launch_plan(2, 5, c, 4, 96, torch.bfloat16)
    assert plan.ns == ns
    assert plan.ml_shape == (2, 4, 5, ns + 1)


def test_live_splits_follow_hist_len():
    """Per-row splits read: ceil(hist_len / 128), clamped to [0, C]; the
    same for a scalar length broadcast over the rows."""
    hist = torch.tensor([0, 1, 127, 128, 129, 300, 5000, -3],
                        dtype=torch.int32)
    assert kpre.live_splits(hist, 8, 300) == [0, 1, 1, 1, 2, 3, 3, 0]
    assert kpre.live_splits(129, 3, 2048) == [2, 2, 2]
