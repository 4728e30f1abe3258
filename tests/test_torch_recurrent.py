"""The recurrent families in the port against the JAX package on bridged
weights: xlstm-350m (mLSTM / sLSTM) and zamba2-2.7b (Mamba2 + the shared
attention block), smoke configs (d 64, ssm_state 16, chunk_len 32, 4
layers), float32 on the CPU. The model: prefill (whole and length-masked)
and ragged ``decode_step`` with a ``live`` mask against the JAX model,
logits and state leaves within 1e-4 (relative and absolute), the greedy
argmax equal, non-live rows bitwise unchanged; the refusals the
reference makes; the bridge round trip. The serving engine's streams and
export packets are held to the JAX engine's in
``tests/test_torch_recurrent_engine.py``."""
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
from repro_torch.serving import EngineConfig
from repro_torch.serving.kv_cache import PagedCache

ARCHS = ("xlstm-350m", "zamba2-2.7b")
TOL = dict(rtol=1e-4, atol=1e-4)   # float32 logits and states after 4
                                   # layers; sums run in other orders
# the JAX model's functions compiled once a shape (its eager scans would
# compile again at every call)
jprefill = jax.jit(JMD.prefill, static_argnums=(1, 3))
jdecode = jax.jit(JMD.decode_step, static_argnums=1)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jreg.get_smoke_config(request.param).replace(dtype="float32")
    cfg = registry.get_smoke_config(request.param).replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(cache):
    return [k for k in cache if k != "len"]


@pytest.mark.parametrize("s,length", [(45, None), (64, 37)])
def test_prefill_matches_reference(setup, s, length):
    """Whole prompts (inside and at whole chunks) and a right-padded one
    with ``length=37`` read at position 36: logits and every cache leaf
    (the state, and zamba2's shared-block K/V rows) against the
    reference's, the cache structure leaf for leaf."""
    jcfg, jp, cfg, tp = setup
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab_size, size=(2, s)).astype(np.int32)
    kw = {} if length is None else dict(logit_index=length - 1)
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 64,
                      length=length, **kw)
    tl, tc = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 64,
                        length=length, **kw)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    assert (tl.numpy().argmax(-1) == _np(jl).argmax(-1)).all()
    assert set(tc) == set(jc)
    for name in _leaves(jc):
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
        want = _np(jc[name])
        if name in ("k", "v") and length is not None:
            tc[name], want = tc[name][:, :, :length], want[:, :, :length]
        np.testing.assert_allclose(tc[name].numpy(), want, err_msg=name,
                                   **TOL)
    assert int(tc["len"]) == s
    # capacity=None: the state whole, and only the prompt's K/V rows
    _, rows = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, None)
    assert set(_leaves(rows)) == set(_leaves(jc))
    for name in _leaves(rows):
        if name in ("k", "v"):
            assert rows[name].shape[2] == s
        else:
            assert rows[name].shape == tc[name].shape


def test_ragged_live_decode_matches_reference(setup):
    """Three rows from a 30-token prefill at per-row lengths; a live mask
    that freezes a row now and then: live rows' logits against the
    reference, and every leaf of a frozen row bitwise unchanged."""
    jcfg, jp, cfg, tp = setup
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 30)).astype(np.int32)
    _, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 64)
    _, tc = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 64)
    pos = np.array([30, 27, 25], np.int32)
    for i in range(8):
        live = np.array([True, i % 3 != 1, i % 2 == 0])
        tok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        jc["len"] = jnp.asarray(pos)
        tc["len"] = torch.from_numpy(pos.copy())
        before = {k: v.clone() for k, v in tc.items()}
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc,
                         live=jnp.asarray(live))
        tl, tc = MD.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                live=torch.from_numpy(live))
        np.testing.assert_allclose(tl.numpy()[live], _np(jl)[live],
                                   err_msg=f"step {i}", **TOL)
        axes = MD.cache_batch_axes(tc)
        for name in _leaves(tc):
            for row in np.flatnonzero(~live):
                assert torch.equal(tc[name].select(axes[name], row),
                                   before[name].select(axes[name], row)), \
                    (name, i, row)
        pos = pos + live
    for name in _leaves(jc):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   err_msg=name, **TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_what_the_reference_refuses_raises(setup):
    """Chunked prefill, verify, the self-draft and paged caches cannot
    carry recurrent state: each refuses as the reference does; the cache
    struct and batch axes equal the reference's."""
    jcfg, _, cfg, tp = setup
    fam = f"family {cfg.family!r}"
    toks = torch.zeros((1, 4), dtype=torch.int32)
    kh = torch.zeros((cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.d_head))
    with pytest.raises(ValueError, match=f"chunked prefill unsupported for "
                       f"{fam}"):
        MD.prefill_chunk(tp, cfg, {"tokens": toks}, kh, kh, 0)
    cache = MD.init_cache(cfg, 1, 64, device="cpu")
    with pytest.raises(ValueError, match=f"speculative verify unsupported "
                       f"for {fam}"):
        MD.verify_tokens(tp, cfg, toks, cache)
    with pytest.raises(ValueError, match="paged cache requires"):
        MD.decode_step(tp, cfg, toks[:, :1],
                       dict(cache, block_tab=torch.zeros((1, 4),
                                                         dtype=torch.int32)))
    with pytest.raises(ValueError, match="self-draft unsupported"):
        MD.self_draft_params(tp, cfg, 1)
    with pytest.raises(ValueError, match=f"does not support {fam}"):
        PagedCache(cfg, EngineConfig(kv_cache="paged"), "cpu")
    for b, cap in ((2, 16), (3, 64)):
        want = JMD.cache_struct(jcfg, b, cap)
        got = MD.cache_struct(cfg, b, cap)
        assert {k: tuple(v[0]) for k, v in got.items()} == \
            {k: tuple(v[0]) for k, v in want.items()}
        assert MD.cache_batch_axes(MD.init_cache(cfg, b, cap, device="cpu")) \
            == JMD.cache_batch_axes(JMD.init_cache(jcfg, b, cap))


def test_bridge_round_trip(setup):
    """The reference's tree arrives leaf for leaf (``shared`` unstacked,
    the stacked leaves with their leading axes) and goes back equal;
    bf16 leaves are carried bit for bit; a stack of the wrong depth is
    refused; the port's own init has the same keys, shapes and dtypes."""
    jcfg, jp, cfg, tp = setup
    flat_j = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
    back = bridge.params_to_numpy(tp)
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf),
                                      err_msg=str(path))
    own = jax.tree_util.tree_flatten_with_path(
        bridge.params_to_numpy(MD.init_params(cfg, device="cpu")))[0]
    assert [(p, a.shape, a.dtype) for p, a in own] == \
        [(p, np.shape(a), np.asarray(a).dtype) for p, a in flat_j]
    # bf16: bits through the bridge and back
    bcfg = cfg.replace(dtype="bfloat16")
    jb = jax.device_get(JMD.init_params(jax.random.PRNGKey(4),
                                        jcfg.replace(dtype="bfloat16")))
    tb = bridge.params_from_jax(jb, bcfg, device="cpu")
    def pick(tree):
        return (tree["mlstm"]["w_up"] if cfg.family == "ssm"
                else tree["mamba"]["mamba"]["in_proj"])

    got, want = pick(tb), pick(jb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    shallow = jax.device_get(JMD.init_params(
        jax.random.PRNGKey(5), jcfg.replace(n_layers=2 * jcfg.n_layers)))
    with pytest.raises(ValueError, match="leading axes"):
        bridge.params_from_jax(shallow, cfg, device="cpu")
