"""nemotron-4-340b's head geometry in the port's model functions against
the JAX model on bridged weights (float32, CPU): the smoke config with
its heads kept as the full model has them — 12 query heads over one KV
head of 192 (G 12, Dh 192) at d_model 2304 — two layers, a narrow MLP
and vocab; LayerNorm and squared ReLU as the full model. Prefill, the
ragged decode step on contiguous and paged caches, a prompt chunk over
cached history and a ragged verify window."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import model as MD

ARCH = "nemotron-4-340b"
GEOMETRY = dict(n_heads=12, n_kv_heads=1, d_model=2304, d_head=192,
                n_layers=2, d_ff=128, vocab_size=256, dtype="float32")
ATOL = 1e-4   # float32 logits, as the families tests hold them
B, CAP, N_TOK, BS, NB = 3, 40, 16, 8, 18


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config(ARCH).replace(**GEOMETRY)
    cfg = registry.get_smoke_config(ARCH).replace(**GEOMETRY)
    assert (cfg.d_head, cfg.n_heads // cfg.n_kv_heads) == (192, 12)
    assert (cfg.norm, cfg.activation) == ("layernorm", "squared_relu")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(B, N_TOK)).astype(np.int32)
    want, jcache = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CAP)
    return jcfg, jp, cfg, tp, toks, want, jcache


def test_prefill_matches(setup):
    _, _, cfg, tp, toks, want, jcache = setup
    got, cache = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, CAP)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]),
                                   atol=ATOL, rtol=0)


def _tables():
    tab = np.full((B, CAP // BS), NB, np.int32)
    tab[0, :3] = [11, NB - 1, 2]
    tab[1, :3] = [7, 9, 1]
    tab[2, :5] = [4, 0, 12, 3, 15]
    return tab


def _pools(jcache, tab):
    """The reference's pools holding each row's cache rows at its
    table's blocks, and the port's with the scratch block appended."""
    jpools, port = {}, {}
    for name in ("k", "v"):
        arr = _np(jcache[name])
        pool = np.zeros((arr.shape[0], NB, BS, *arr.shape[3:]), np.float32)
        for i in range(B):
            for j, blk in enumerate(tab[i]):
                if blk < NB:
                    pool[:, blk] = arr[:, i, j * BS:(j + 1) * BS]
        jpools[name] = pool
        port[name] = torch.from_numpy(np.concatenate(
            [pool, np.zeros_like(pool[:, :1])], axis=1))
    return jpools, port


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_ragged_decode_matches(setup, backend):
    jcfg, jp, cfg, tp, _, _, jcache = setup
    pos = np.array([N_TOK, 9, 3], np.int32)
    live = np.array([True, True, False])
    step = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    if backend == "contiguous":
        jc = {n: jcache[n] for n in ("k", "v")}
        port = {n: torch.from_numpy(_np(jcache[n]).copy())
                for n in ("k", "v")}
        extra = jextra = {}
    else:
        tab = _tables()
        jpools, port = _pools(jcache, tab)
        jc = {n: jnp.asarray(jpools[n]) for n in ("k", "v")}
        extra, jextra = ({"block_tab": torch.from_numpy(tab)},
                         {"block_tab": jnp.asarray(tab)})
    want, jnew = JMD.decode_step(jp, jcfg, jnp.asarray(step),
                                 dict(jc, len=jnp.asarray(pos), **jextra),
                                 live=jnp.asarray(live))
    got, new = MD.decode_step(tp, cfg, torch.from_numpy(step),
                              dict(port, len=torch.from_numpy(pos), **extra),
                              live=torch.from_numpy(live))
    np.testing.assert_allclose(got[live].numpy(), _np(want)[live],
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        held = new[name].numpy()
        if backend == "paged":
            held = held[:, :NB]
        np.testing.assert_allclose(held, _np(jnew[name]), atol=ATOL, rtol=0)


def test_chunk_over_history_matches(setup):
    """Row 2's prompt continued by a chunk of 5 tokens over its 16
    cached positions, logits at chunk index 4."""
    jcfg, jp, cfg, tp, toks, _, jcache = setup
    chunk = np.zeros((1, 8), np.int32)
    chunk[0, :5] = toks[1, :5]
    jk, jv = jcache["k"][:, 2:3], jcache["v"][:, 2:3]
    want, jks, _ = JMD.prefill_chunk(jp, jcfg, {"tokens": jnp.asarray(chunk)},
                                     jk, jv, jnp.int32(N_TOK),
                                     logit_index=jnp.int32(4))
    got, ks, _ = MD.prefill_chunk(
        tp, cfg, {"tokens": torch.from_numpy(chunk)},
        torch.from_numpy(_np(jk).copy()), torch.from_numpy(_np(jv).copy()),
        N_TOK, logit_index=4)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ks.numpy(), _np(jks), atol=ATOL, rtol=0)


def test_verify_window_matches(setup):
    """A ragged verify of 4 candidates: row 0 at its prompt's end, row 1
    frozen, row 2 past the capacity (dropped writes)."""
    jcfg, jp, cfg, tp, _, _, jcache = setup
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab_size, size=(B, 4)).astype(np.int32)
    pos = np.array([N_TOK, 20, 38], np.int32)
    live = np.array([True, False, True])
    want, jnew = JMD.verify_tokens(
        jp, jcfg, jnp.asarray(toks),
        {"k": jcache["k"], "v": jcache["v"], "len": jnp.asarray(pos)},
        live=jnp.asarray(live))
    got, new = MD.verify_tokens(
        tp, cfg, torch.from_numpy(toks),
        {"k": torch.from_numpy(_np(jcache["k"]).copy()),
         "v": torch.from_numpy(_np(jcache["v"]).copy()),
         "len": torch.from_numpy(pos)}, live=torch.from_numpy(live))
    np.testing.assert_allclose(got[live].numpy(), _np(want)[live],
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(), _np(jnew[name]),
                                   atol=ATOL, rtol=0)
