"""Port chunked prefill and speculative verify against the JAX model on
bridged weights (qwen1.5-0.5b smoke config, float32, CPU): logits and
the KV they write, on contiguous and paged caches."""
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
B, CAP, BS, NB = 3, 32, 8, 14


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, size=(B, 24)).astype(np.int32)
    _, jcache = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, CAP)
    return jcfg, jp, cfg, tp, jcache


def _np(x):
    return np.asarray(x, np.float32)


def _tables():
    """Scattered tables: row 0 owns blocks 11 and 13 (= NB-1) — where its
    verify window writes while later rows drop writes — row 1 three
    blocks and a sentinel, row 2 four blocks."""
    return np.array([[11, NB - 1, NB, NB], [7, 9, 1, NB], [4, 0, 12, 2]],
                    np.int32)


def _pools(jcache, tab):
    """The reference's pools (L, NB, bs, H, Dh) holding the contiguous
    rows at the table's blocks, and the port's copy with its scratch
    block appended."""
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


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_prefill_chunk_matches(setup, backend):
    """One 16-token chunk of row 1 over its 9 cached positions (a short
    final chunk: 5 real tokens, logits read at chunk index 4)."""
    jcfg, jp, cfg, tp, jcache = setup
    rng = np.random.default_rng(12)
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :5] = rng.integers(0, cfg.vocab_size, size=5)
    hist, idx = 9, 4
    jk, jv = jcache["k"][:, 1:2], jcache["v"][:, 1:2]
    want, jks, jvs = JMD.prefill_chunk(
        jp, jcfg, {"tokens": jnp.asarray(chunk)}, jk, jv, jnp.int32(hist),
        logit_index=jnp.int32(idx))
    batch = {"tokens": torch.from_numpy(chunk)}
    if backend == "contiguous":
        got, ks, vs = MD.prefill_chunk(
            tp, cfg, batch, torch.from_numpy(_np(jk).copy()),
            torch.from_numpy(_np(jv).copy()), hist, logit_index=idx)
    else:
        tab = _tables()
        _, port = _pools(jcache, tab)
        got, ks, vs = MD.prefill_chunk(
            tp, cfg, batch, port["k"], port["v"], hist, logit_index=idx,
            block_table=torch.from_numpy(tab[1:2]))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ks.numpy(), _np(jks), atol=ATOL, rtol=0)
    np.testing.assert_allclose(vs.numpy(), _np(jvs), atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_verify_tokens_matches(setup, backend):
    """A ragged verify of S = 4 candidates: row 0 verifies at 5 (into
    block NB-1 on the paged cache), row 1 is frozen, row 2 at position
    30 runs past the capacity 32 (two dropped writes). Logits of live
    rows, the written KV and the lengths match the reference, so no
    dropped write raced a real one."""
    jcfg, jp, cfg, tp, jcache = setup
    rng = np.random.default_rng(13)
    s = 4
    toks = rng.integers(0, cfg.vocab_size, size=(B, s)).astype(np.int32)
    pos = np.array([5, 20, 30], np.int32)
    live = np.array([True, False, True])
    if backend == "contiguous":
        jc = {"k": jcache["k"], "v": jcache["v"]}
        port = {n: torch.from_numpy(_np(jcache[n]).copy())
                for n in ("k", "v")}
        extra, jextra = {}, {}
    else:
        tab = _tables()
        pools, port = _pools(jcache, tab)
        jc = {n: jnp.asarray(pools[n]) for n in ("k", "v")}
        extra = {"block_tab": torch.from_numpy(tab)}
        jextra = {"block_tab": jnp.asarray(tab)}
    want, jnew = JMD.verify_tokens(
        jp, jcfg, jnp.asarray(toks), dict(jc, len=jnp.asarray(pos), **jextra),
        live=jnp.asarray(live))
    got, new = MD.verify_tokens(
        tp, cfg, torch.from_numpy(toks),
        dict(port, len=torch.from_numpy(pos), **extra),
        live=torch.from_numpy(live))
    assert tuple(got.shape) == (B, s, cfg.vocab_size)
    np.testing.assert_allclose(got[live].numpy(), _np(want)[live],
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        held = new[name].numpy()
        if backend == "paged":
            held = held[:, :NB]
        np.testing.assert_allclose(held, _np(jnew[name]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(new["len"].numpy(), np.asarray(jnew["len"]))


def test_verify_single_token_matches_decode_step(setup):
    """S = 1 verify degenerates to a decode step: same logits, same KV."""
    _, _, cfg, tp, jcache = setup
    rng = np.random.default_rng(14)
    toks = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos = torch.tensor([24, 9, 3], dtype=torch.int32)
    live = torch.tensor([True, True, False])
    c1 = {n: torch.from_numpy(_np(jcache[n]).copy()) for n in ("k", "v")}
    c2 = {n: t.clone() for n, t in c1.items()}
    got, n1 = MD.verify_tokens(tp, cfg, torch.from_numpy(toks),
                               dict(c1, len=pos), live=live)
    want, n2 = MD.decode_step(tp, cfg, torch.from_numpy(toks),
                              dict(c2, len=pos), live=live)
    np.testing.assert_allclose(got[:, 0][live].numpy(), want[live].numpy(),
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(n1[name].numpy(), n2[name].numpy(),
                                   atol=ATOL, rtol=0)
