"""Port model functions against the JAX model on bridged weights for the
MoE and vlm families (smoke configs of deepseek-moe-16b — a leading
dense layer, then MoE with shared experts —, internvl2-26b — GQA and an
image prefix — and dbrx-132b — MoE with LayerNorm; float32, CPU):
prefill and the ragged decode step on contiguous and paged caches."""
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

ATOL = 1e-4  # float32 logits; the attention routes differ in sum order
ARCHS = ("deepseek-moe-16b", "internvl2-26b", "dbrx-132b")
B, CAP, BS, NB = 3, 40, 8, 18
N_TOK = 16   # prompt tokens per row (after a vlm's image prefix)


def family_setup(arch):
    """(jcfg, jp, cfg, tp, batches, jcache): bridged float32 weights, a
    seeded (B, N_TOK) prompt batch — with seeded images for the vlm —
    for both packages, and the reference's prefill cache of it."""
    jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
    cfg = registry.get_smoke_config(arch).replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, size=(B, N_TOK)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        img = (rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model))
               * 0.1).astype(np.float32)
        jb["images"], tb["images"] = jnp.asarray(img), torch.from_numpy(img)
    _, jcache = JMD.prefill(jp, jcfg, jb, CAP)
    return jcfg, jp, cfg, tp, (jb, tb), jcache


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return family_setup(request.param)


def _np(x):
    return np.asarray(x, np.float32)


def n_prefix(cfg):
    return cfg.n_image_tokens if cfg.family == "vlm" else 0


def test_prefill_logits_and_cache_match(setup):
    jcfg, jp, cfg, tp, (jb, tb), jcache = setup
    got, cache = MD.prefill(tp, cfg, tb, CAP)
    want, _ = JMD.prefill(jp, jcfg, jb, CAP)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    s = n_prefix(cfg) + N_TOK
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]),
                                   atol=ATOL, rtol=0)
    assert int(cache["len"]) == int(jcache["len"]) == s
    # logits read past the image prefix at each row's last real token,
    # and the rows-only form the engine splices
    idx = np.array([n_prefix(cfg) + 4, s - 1, n_prefix(cfg)], np.int32)
    want, _ = JMD.prefill(jp, jcfg, jb, CAP, logit_index=jnp.asarray(idx))
    got, rows = MD.prefill(tp, cfg, tb, None,
                           logit_index=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    assert tuple(rows["k"].shape) == (cfg.n_layers, B, s, cfg.n_kv_heads,
                                      cfg.d_head)


def test_ragged_decode_step_matches(setup):
    """Per-row positions and a live mask on the contiguous cache: logits
    of live rows, the written KV and the frozen rows match."""
    jcfg, jp, cfg, tp, _, jcache = setup
    rng = np.random.default_rng(1)
    pos = np.array([n_prefix(cfg) + N_TOK, 9, 3], np.int32)
    live = np.array([True, True, False])
    step = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    want, jnew = JMD.decode_step(jp, jcfg, jnp.asarray(step),
                                 dict(jcache, len=jnp.asarray(pos)),
                                 live=jnp.asarray(live))
    cache = {n: torch.from_numpy(_np(jcache[n]).copy()) for n in ("k", "v")}
    got, new = MD.decode_step(tp, cfg, torch.from_numpy(step),
                              dict(cache, len=torch.from_numpy(pos)),
                              live=torch.from_numpy(live))
    np.testing.assert_allclose(got[live].numpy(), _np(want)[live],
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(), _np(jnew[name]),
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(new["len"].numpy(), np.asarray(jnew["len"]))


def tables():
    """Scattered block tables over NB blocks (sentinel NB past each
    row's blocks)."""
    tab = np.full((B, CAP // BS), NB, np.int32)
    tab[0, :4] = [11, NB - 1, 2, 5]
    tab[1, :3] = [7, 9, 1]
    tab[2, :5] = [4, 0, 12, 3, 15]
    return tab


def pools(jcache, tab):
    """The reference's pools (L, NB, bs, H, Dh) holding each row's
    contiguous cache rows at its table's blocks, and the port's copy
    with its scratch block appended."""
    out = {}
    for name in ("k", "v"):
        arr = _np(jcache[name])
        pool = np.zeros((arr.shape[0], NB, BS, *arr.shape[3:]), np.float32)
        for i in range(B):
            for w in range(CAP // BS):
                if tab[i, w] < NB:
                    pool[:, tab[i, w]] = arr[:, i, w * BS:(w + 1) * BS]
        out[name] = pool
    port = {n: torch.from_numpy(np.concatenate(
        [p, np.zeros_like(p[:, :1])], axis=1)) for n, p in out.items()}
    return out, port


def test_paged_decode_step_matches(setup):
    jcfg, jp, cfg, tp, _, jcache = setup
    rng = np.random.default_rng(3)
    tab = tables()
    pos = np.array([24, 8, 5], np.int32)   # row 1 writes into a sentinel
    live = np.array([True, True, False])
    jpools, port = pools(jcache, tab)
    step = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    want, jnew = JMD.decode_step(
        jp, jcfg, jnp.asarray(step),
        {"k": jnp.asarray(jpools["k"]), "v": jnp.asarray(jpools["v"]),
         "block_tab": jnp.asarray(tab), "len": jnp.asarray(pos)},
        live=jnp.asarray(live))
    got, new = MD.decode_step(
        tp, cfg, torch.from_numpy(step),
        dict(port, block_tab=torch.from_numpy(tab),
             len=torch.from_numpy(pos)), live=torch.from_numpy(live))
    np.testing.assert_allclose(got[live].numpy(), _np(want)[live],
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name][:, :NB].numpy(),
                                   _np(jnew[name]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(new["len"].numpy(), np.asarray(jnew["len"]))
