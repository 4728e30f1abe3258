"""Port chunked prefill and speculative verify against the JAX model on
bridged weights for the MoE and vlm families (deepseek-moe-16b,
internvl2-26b, dbrx-132b smoke configs, float32, CPU): the first chunk
(carrying the vlm's images), a later chunk over cached history, and a
ragged verify window, on contiguous and paged caches; and the
self-draft, which slices ``first_layers`` before the stack."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JMD
from repro_torch.models import model as MD
from test_torch_families_model import (ARCHS, ATOL, B, NB, _np, family_setup,
                                       n_prefix, pools, tables)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return family_setup(request.param)


_JAX = {}   # (arch, call) -> the reference's result, shared by backends


def _jax(jcfg, what, fn):
    key = (jcfg.name, what)
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_prefill_chunks_match(setup, backend):
    """Row 2's prompt as two 8-token chunks: the first from position 0
    (with the images of a vlm), the second over the cached history —
    on the paged cache read through row 2's table."""
    jcfg, jp, cfg, tp, (jb, tb), jcache = setup
    npre = n_prefix(cfg)
    first_j = {k: v[2:3, :8] if k == "tokens" else v[2:3]
               for k, v in jb.items()}
    first_t = {k: v[2:3, :8] if k == "tokens" else v[2:3]
               for k, v in tb.items()}
    zero = np.zeros_like(_np(jcache["k"][:, 2:3]))
    want, jks, _ = _jax(jcfg, "first", lambda: JMD.prefill_chunk(
        jp, jcfg, first_j, jnp.asarray(zero), jnp.asarray(zero),
        jnp.int32(0)))
    got, ks, _ = MD.prefill_chunk(tp, cfg, first_t,
                                  torch.from_numpy(zero.copy()),
                                  torch.from_numpy(zero.copy()), 0)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ks.numpy(), _np(jks), atol=ATOL, rtol=0)
    assert ks.shape[2] == npre + 8
    # the second chunk: 5 real tokens, logits at chunk index 4
    chunk = np.zeros((1, 8), np.int32)
    chunk[0, :5] = np.asarray(jb["tokens"])[2, 8:13]
    hist = npre + 8
    jk, jv = jcache["k"][:, 2:3], jcache["v"][:, 2:3]
    want, jks, jvs = _jax(jcfg, "second", lambda: JMD.prefill_chunk(
        jp, jcfg, {"tokens": jnp.asarray(chunk)}, jk, jv, jnp.int32(hist),
        logit_index=jnp.int32(4)))
    batch = {"tokens": torch.from_numpy(chunk)}
    if backend == "contiguous":
        got, ks, vs = MD.prefill_chunk(
            tp, cfg, batch, torch.from_numpy(_np(jk).copy()),
            torch.from_numpy(_np(jv).copy()), hist, logit_index=4)
    else:
        tab = tables()
        _, port = pools(jcache, tab)
        got, ks, vs = MD.prefill_chunk(
            tp, cfg, batch, port["k"], port["v"], hist, logit_index=4,
            block_table=torch.from_numpy(tab[2:3]))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ks.numpy(), _np(jks), atol=ATOL, rtol=0)
    np.testing.assert_allclose(vs.numpy(), _np(jvs), atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_verify_tokens_match(setup, backend):
    """A ragged verify of S = 4 candidates (one MoE dispatch of 12
    tokens): row 0 at its prompt's end, row 1 frozen, row 2 past the
    capacity (dropped writes)."""
    jcfg, jp, cfg, tp, _, jcache = setup
    rng = np.random.default_rng(13)
    s = 4
    toks = rng.integers(0, cfg.vocab_size, size=(B, s)).astype(np.int32)
    pos = np.array([n_prefix(cfg) + 10, 20, 38], np.int32)
    live = np.array([True, False, True])
    if backend == "contiguous":
        jc = {"k": jcache["k"], "v": jcache["v"]}
        port = {n: torch.from_numpy(_np(jcache[n]).copy())
                for n in ("k", "v")}
        extra, jextra = {}, {}
    else:
        tab = tables()
        jpools, port = pools(jcache, tab)
        jc = {n: jnp.asarray(jpools[n]) for n in ("k", "v")}
        extra = {"block_tab": torch.from_numpy(tab)}
        jextra = {"block_tab": jnp.asarray(tab)}
    want, jnew = JMD.verify_tokens(
        jp, jcfg, jnp.asarray(toks), dict(jc, len=jnp.asarray(pos), **jextra),
        live=jnp.asarray(live))
    got, new = MD.verify_tokens(
        tp, cfg, torch.from_numpy(toks),
        dict(port, len=torch.from_numpy(pos), **extra),
        live=torch.from_numpy(live))
    np.testing.assert_allclose(got[live].numpy(), _np(want)[live],
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        held = new[name].numpy()
        if backend == "paged":
            held = held[:, :NB]
        np.testing.assert_allclose(held, _np(jnew[name]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(new["len"].numpy(), np.asarray(jnew["len"]))


@pytest.mark.parametrize("k", [1, 2])
def test_self_draft_slices_first_layers_then_stack(setup, k):
    """The self-draft's keys, shapes and config equal the reference's
    (``first_layers`` first), and its leaves are views of the target's."""
    jcfg, jp, cfg, tp, _, _ = setup
    jdp, jdcfg = JMD.self_draft_params(jp, jcfg, k)
    dp, dcfg = MD.self_draft_params(tp, cfg, k)
    assert (dcfg.n_layers, dcfg.first_dense_layers) == \
        (jdcfg.n_layers, jdcfg.first_dense_layers)
    assert len(dp.get("first_layers", [])) == len(jdp.get("first_layers", []))
    wq = dp["layers"]["attn"]["wq"]
    assert tuple(wq.shape) == jdp["layers"]["attn"]["wq"].shape
    assert not wq.numel() or \
        wq.data_ptr() == tp["layers"]["attn"]["wq"].data_ptr()
    for got, want in zip(MD.blocks(dp, dcfg), MD.blocks(tp, cfg)):
        assert got["attn"]["wo"].data_ptr() == want["attn"]["wo"].data_ptr()
    assert len(MD.blocks(dp, dcfg)) == k
