"""Mamba2 in the port (``repro_torch.models.ssm``) against the JAX package's
``repro.models.ssm``: the same seeded inputs through both, float32 on the
CPU, within 1e-5 (relative, with an absolute floor of 1e-5 for values near
zero) on every output and state. Params of one Mamba2 layer come from the
zamba2-2.7b smoke config (d 64, ssm_state 16, head dim 16, chunk_len 32)
through ``jax.random.PRNGKey(3)`` and the bridge. Also: a right-padded
input with ``n_valid`` gives the exact-length states bit for bit, and
:func:`~repro_torch.models.layers.row_tiled` gives each row the same bits
whatever the row count."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.models import ssm as JS
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import ssm as S

ARCH = "zamba2-2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)   # float32; sums run in other orders


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    assert (cfg.ssm_state, cfg.ssm_head_dim, cfg.chunk_len) == (16, 16, 32)
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    jlayer = jax.tree.map(lambda a: a[0, 1], jp["mamba"]["mamba"])
    tlayer = MD.layer_params(MD.layer_params(tp["mamba"]["mamba"], 0), 1)
    return jcfg, cfg, jlayer, tlayer


def _np(x):
    return np.asarray(x, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_segsum():
    la = -np.abs(_rand(np.random.default_rng(0), 2, 3, 9))
    want = _np(JS.segsum(jnp.asarray(la)))
    got = S.segsum(torch.from_numpy(la)).numpy()
    assert (np.isneginf(got) == np.isneginf(want)).all()
    assert np.isneginf(got).sum() == 2 * 3 * 36     # the strict upper part
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("s", [64, 45])        # whole chunks and not
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked(s, with_h0):
    rng = np.random.default_rng(s)
    b, h, p, n, chunk = 2, 3, 5, 4, 16
    x, bm, cm = (_rand(rng, b, s, h, p), _rand(rng, b, s, h, n),
                 _rand(rng, b, s, h, n))
    la = -np.abs(_rand(rng, b, s, h, scale=0.3))
    h0 = _rand(rng, b, h, p, n) if with_h0 else None
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, la, bm, cm)), chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    ty, th = S.ssd_chunked(*map(torch.from_numpy, (x, la, bm, cm)), chunk,
                           h0=None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == (b, s, h, p) and th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)


@pytest.mark.parametrize("n_valid", [None, 1, 7, 12])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(n_valid, with_state):
    rng = np.random.default_rng(5)
    x, w = _rand(rng, 2, 12, 6), _rand(rng, 4, 6)
    st = _rand(rng, 2, 3, 6) if with_state else None
    jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st),
                             n_valid=None if n_valid is None
                             else jnp.asarray(n_valid))
    ty, ts = S._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            None if st is None else torch.from_numpy(st),
                            n_valid=n_valid)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    assert ts.shape == (2, 3, 6)
    np.testing.assert_array_equal(ts.numpy(), _np(js))   # a slice of xp


@pytest.mark.parametrize("n_valid", [None, 37])
def test_apply_mamba2(setup, n_valid):
    """A 64-step input (two chunks), whole or with 37 valid positions:
    the valid rows of the output, the final SSM state and the conv state
    against the reference; with a carried state and conv state too."""
    jcfg, cfg, jlayer, tlayer = setup
    rng = np.random.default_rng(11)
    u = _rand(rng, 2, 64, cfg.d_model)
    jy, (jh, jc) = JS.apply_mamba2(
        jlayer, jcfg, jnp.asarray(u),
        n_valid=None if n_valid is None else jnp.asarray(n_valid))
    ty, (th, tc) = S.apply_mamba2(tlayer, cfg, torch.from_numpy(u),
                                  n_valid=n_valid)
    m = 64 if n_valid is None else n_valid
    np.testing.assert_allclose(ty[:, :m].numpy(), _np(jy)[:, :m], **TOL)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    # resumed from those states
    u2 = _rand(rng, 2, 20, cfg.d_model)
    jy2, (jh2, jc2) = JS.apply_mamba2(jlayer, jcfg, jnp.asarray(u2),
                                      state=jh, conv_state=jc)
    ty2, (th2, tc2) = S.apply_mamba2(tlayer, cfg, torch.from_numpy(u2),
                                     state=th, conv_state=tc)
    np.testing.assert_allclose(ty2.numpy(), _np(jy2), **TOL)
    np.testing.assert_allclose(th2.numpy(), _np(jh2), **TOL)
    np.testing.assert_allclose(tc2.numpy(), _np(jc2), **TOL)


def test_mamba2_decode_steps(setup):
    """A 21-step prefill, then six O(1) steps, each against the
    reference's step from the reference's states."""
    jcfg, cfg, jlayer, tlayer = setup
    rng = np.random.default_rng(12)
    u = _rand(rng, 3, 21, cfg.d_model)
    _, (jh, jc) = JS.apply_mamba2(jlayer, jcfg, jnp.asarray(u))
    _, (th, tc) = S.apply_mamba2(tlayer, cfg, torch.from_numpy(u))
    for i in range(6):
        ut = _rand(rng, 3, 1, cfg.d_model)
        jy, (jh, jc) = JS.mamba2_decode_step(jlayer, jcfg, jnp.asarray(ut),
                                             jh, jc)
        ty, (th, tc) = S.mamba2_decode_step(tlayer, cfg,
                                            torch.from_numpy(ut), th, tc)
        np.testing.assert_allclose(ty.numpy(), _np(jy), err_msg=f"step {i}",
                                   **TOL)
        np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
        np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)


@pytest.mark.parametrize("exact", [5, 32, 45])
def test_padded_prefill_states_are_the_exact_ones(setup, exact):
    """Inside the port: a 96-step right-padded input with ``n_valid`` =
    ``exact`` gives the states and valid rows of the exact-length input
    run as the model's prefill runs it — zero-padded to whole chunks,
    masked at ``exact`` — ``torch.equal``: the bucketed prefill's
    invariant (row-tiled products, chunk-by-chunk contractions, neutral
    pads)."""
    _, cfg, _, tlayer = setup
    rng = np.random.default_rng(exact)
    u = torch.from_numpy(_rand(rng, 1, 96, cfg.d_model))
    mm = L.row_tiled(cfg.chunk_len)
    whole = -(-exact // cfg.chunk_len) * cfg.chunk_len
    u0 = torch.nn.functional.pad(u[:, :exact], (0, 0, 0, whole - exact))
    y0, (h0, c0) = S.apply_mamba2(tlayer, cfg, u0, n_valid=exact, mm=mm)
    y1, (h1, c1) = S.apply_mamba2(tlayer, cfg, u, n_valid=exact, mm=mm)
    y0 = y0[:, :exact]
    assert torch.equal(h0, h1) and torch.equal(c0, c1)
    assert torch.equal(y0, y1[:, :exact])


def test_row_tiled_rows_do_not_depend_on_the_row_count():
    """Each row of a row-tiled product is the same bits at any row count
    (the plain product's may not be, at K 2560), and within float32
    rounding of the plain product."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((300, 2560), generator=g)
    w = torch.randn((2560, 96), generator=g)
    mm = L.row_tiled(64)
    first = mm(x[:3], w)
    for m in (17, 64, 65, 300):
        assert torch.equal(mm(x[:m], w)[:3], first), m
    torch.testing.assert_close(mm(x, w), x @ w, rtol=1e-4, atol=1e-3)
    assert mm(x[None, :5], w).shape == (1, 5, 96)
