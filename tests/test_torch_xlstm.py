"""The xLSTM blocks in the port (``repro_torch.models.xlstm``) against the
JAX package's ``repro.models.xlstm``: the same seeded inputs through both,
float32 on the CPU, within 1e-5 (relative, with an absolute floor of 1e-5)
on every output and state. Params of one mLSTM and one sLSTM come from the
xlstm-350m smoke config (d 64, 4 heads, chunk_len 32) through
``jax.random.PRNGKey(3)`` and the bridge. The port's blocks take the
previous block's output apart and add it in their first norm; the
reference's take the sum. Also: a right-padded input with ``n_valid``
gives the exact-length states bit for bit."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.models import xlstm as JX
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import xlstm as X

ARCH = "xlstm-350m"
TOL = dict(rtol=1e-5, atol=1e-5)   # float32; sums run in other orders


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    assert cfg.chunk_len == 32 and cfg.norm == "layernorm"
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    jm = jax.tree.map(lambda a: a[1, 0], jp["mlstm"])
    tm = MD.layer_params(MD.layer_params(tp["mlstm"], 1), 0)
    js = jax.tree.map(lambda a: a[1], jp["slstm"])
    ts = MD.layer_params(tp["slstm"], 1)
    return jcfg, cfg, (jm, tm), (js, ts)


def _np(x):
    return np.asarray(x, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mask(s, n_valid):
    return None if n_valid is None else jnp.arange(s) < n_valid


def test_state_shapes(setup):
    jcfg, cfg, _, _ = setup
    assert X.mlstm_state_shape(cfg, 3) == JX.mlstm_state_shape(jcfg, 3) \
        == (3, 4, 33, 32)
    assert X.slstm_state_shape(cfg, 3) == JX.slstm_state_shape(jcfg, 3)
    want = jax.eval_shape(lambda: JMD.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    assert X.slstm_ff(cfg.d_model) == want["slstm"]["w_ff_up"].shape[-1]


@pytest.mark.parametrize("n_valid", [None, 37])
@pytest.mark.parametrize("with_delta", [False, True])
def test_apply_mlstm(setup, n_valid, with_delta):
    """A 64-step input (two chunks), whole or with 37 valid positions,
    the previous block's output apart or not: the valid rows of x + out
    and the final state against the reference; then resumed from it."""
    jcfg, cfg, (jm, tm), _ = setup
    rng = np.random.default_rng(21)
    x, delta = _rand(rng, 2, 64, cfg.d_model), _rand(rng, 2, 64, cfg.d_model)
    jx = x + delta if with_delta else x
    jy, jh = JX.apply_mlstm(jm, jcfg, jnp.asarray(jx), mask=_mask(64, n_valid))
    (tx, tout), th = X.apply_mlstm(
        tm, cfg, torch.from_numpy(x),
        torch.from_numpy(delta) if with_delta else None, n_valid=n_valid)
    m = 64 if n_valid is None else n_valid
    np.testing.assert_allclose((tx + tout)[:, :m].numpy(), _np(jy)[:, :m],
                               **TOL)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    x2 = _rand(rng, 2, 20, cfg.d_model)
    jy2, jh2 = JX.apply_mlstm(jm, jcfg, jnp.asarray(x2), state=jh)
    (tx2, tout2), th2 = X.apply_mlstm(tm, cfg, torch.from_numpy(x2),
                                      state=th)
    np.testing.assert_allclose((tx2 + tout2).numpy(), _np(jy2), **TOL)
    np.testing.assert_allclose(th2.numpy(), _np(jh2), **TOL)


def test_mlstm_decode_steps(setup):
    jcfg, cfg, (jm, tm), _ = setup
    rng = np.random.default_rng(22)
    x = _rand(rng, 3, 21, cfg.d_model)
    _, jh = JX.apply_mlstm(jm, jcfg, jnp.asarray(x))
    _, th = X.apply_mlstm(tm, cfg, torch.from_numpy(x))
    for i in range(6):
        xt = _rand(rng, 3, 1, cfg.d_model)
        jy, jh = JX.mlstm_decode_step(jm, jcfg, jnp.asarray(xt), jh)
        (tx, tout), th = X.mlstm_decode_step(tm, cfg, torch.from_numpy(xt),
                                             None, th)
        np.testing.assert_allclose((tx + tout).numpy(), _np(jy),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)


@pytest.mark.parametrize("n_valid", [None, 9])
@pytest.mark.parametrize("with_delta", [False, True])
def test_apply_slstm(setup, n_valid, with_delta):
    """A 24-step input, whole or with 9 valid positions (the carry frozen
    at pad steps): valid rows and the three state leaves against the
    reference; then resumed from them."""
    jcfg, cfg, _, (js, ts) = setup
    rng = np.random.default_rng(23)
    x, delta = _rand(rng, 2, 24, cfg.d_model), _rand(rng, 2, 24, cfg.d_model)
    jx = x + delta if with_delta else x
    jy, jst = JX.apply_slstm(js, jcfg, jnp.asarray(jx),
                             mask=_mask(24, n_valid))
    (tx, tout), tst = X.apply_slstm(
        ts, cfg, torch.from_numpy(x),
        torch.from_numpy(delta) if with_delta else None, n_valid=n_valid)
    m = 24 if n_valid is None else n_valid
    np.testing.assert_allclose((tx + tout)[:, :m].numpy(), _np(jy)[:, :m],
                               **TOL)
    for got, want in zip(tst, jst):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    x2 = _rand(rng, 2, 5, cfg.d_model)
    jy2, jst2 = JX.apply_slstm(js, jcfg, jnp.asarray(x2), state=jst)
    (tx2, tout2), tst2 = X.apply_slstm(ts, cfg, torch.from_numpy(x2),
                                       state=tst)
    np.testing.assert_allclose((tx2 + tout2).numpy(), _np(jy2), **TOL)
    for got, want in zip(tst2, jst2):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_slstm_decode_steps(setup):
    jcfg, cfg, _, (js, ts) = setup
    rng = np.random.default_rng(24)
    x = _rand(rng, 3, 7, cfg.d_model)
    _, jst = JX.apply_slstm(js, jcfg, jnp.asarray(x))
    _, tst = X.apply_slstm(ts, cfg, torch.from_numpy(x))
    for i in range(5):
        xt = _rand(rng, 3, 1, cfg.d_model)
        jy, jst = JX.slstm_decode_step(js, jcfg, jnp.asarray(xt), jst)
        (tx, tout), tst = X.slstm_decode_step(ts, cfg, torch.from_numpy(xt),
                                              None, tst)
        np.testing.assert_allclose((tx + tout).numpy(), _np(jy),
                                   err_msg=f"step {i}", **TOL)
        for got, want in zip(tst, jst):
            np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("exact", [5, 45])
def test_padded_prefill_states_are_the_exact_ones(setup, exact):
    """Inside the port, both blocks: a 96-step right-padded input with
    ``n_valid`` = ``exact`` gives the states and valid rows of the
    exact-length input run as the model's prefill runs it (zero-padded
    to whole chunks, masked at ``exact``) ``torch.equal``."""
    _, cfg, (_, tm), (_, ts) = setup
    rng = np.random.default_rng(exact)
    x = torch.from_numpy(_rand(rng, 1, 96, cfg.d_model))
    mm = L.row_tiled(cfg.chunk_len)
    whole = -(-exact // cfg.chunk_len) * cfg.chunk_len
    x0 = torch.nn.functional.pad(x[:, :exact], (0, 0, 0, whole - exact))
    for block in (lambda t: X.apply_mlstm(tm, cfg, t, n_valid=exact, mm=mm),
                  lambda t: X.apply_slstm(ts, cfg, t, n_valid=exact, mm=mm)):
        (r0, o0), st0 = block(x0)
        (r1, o1), st1 = block(x)
        assert torch.equal(o0[:, :exact], o1[:, :exact])
        assert torch.equal(r0[:, :exact], r1[:, :exact])
        for a, b in zip(st0 if isinstance(st0, tuple) else (st0,),
                        st1 if isinstance(st1, tuple) else (st1,)):
            assert torch.equal(a, b)
