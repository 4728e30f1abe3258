"""Port model functions against the JAX model on bridged weights
(qwen1.5-0.5b smoke config, float32, CPU)."""
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
from test_serving import straight_line_generate

ATOL = 1e-4  # float32 logits; the attention routes differ in sum order


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _np(x):
    return np.asarray(x, np.float32)


def test_prefill_logits_and_cache_match(setup):
    jcfg, jp, cfg, tp = setup
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    want, jcache = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 32)
    got, cache = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]),
                                   atol=ATOL, rtol=0)
    assert int(cache["len"]) == int(jcache["len"]) == 20
    # right-padded (bucketed) prompt read at its true last position, and
    # the rows-only form the engine splices
    idx = np.array([12, 19], np.int32)
    want, _ = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 32,
                          logit_index=jnp.asarray(idx))
    got, rows = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, None,
                           logit_index=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    assert tuple(rows["k"].shape) == (cfg.n_layers, 2, 20, cfg.n_kv_heads,
                                      cfg.d_head)


def test_ragged_decode_step_matches(setup):
    """Per-row positions and a live mask: logits, the written KV and the
    frozen rows all match the reference."""
    jcfg, jp, cfg, tp = setup
    rng = np.random.default_rng(1)
    b, cap = 3, 24
    toks = rng.integers(0, cfg.vocab_size, size=(b, 16)).astype(np.int32)
    _, jcache = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, cap)
    _, cache = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, cap)
    pos = np.array([16, 9, 3], np.int32)
    live = np.array([True, True, False])
    step = rng.integers(0, cfg.vocab_size, size=(b, 1)).astype(np.int32)
    want, jnew = JMD.decode_step(jp, jcfg, jnp.asarray(step),
                                 dict(jcache, len=jnp.asarray(pos)),
                                 live=jnp.asarray(live))
    got, new = MD.decode_step(tp, cfg, torch.from_numpy(step),
                              dict(cache, len=torch.from_numpy(pos)),
                              live=torch.from_numpy(live))
    np.testing.assert_allclose(got[live].numpy(), _np(want)[live],
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(), _np(jnew[name]),
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(new["len"].numpy(), np.asarray(jnew["len"]))


def test_greedy_generation_matches_reference(setup):
    jcfg, jp, cfg, tp = setup
    rng = np.random.default_rng(2)
    for n in (5, 12):
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        want = straight_line_generate(jp, jcfg, prompt, 6, 32)
        logits, cache = MD.prefill(
            tp, cfg, {"tokens": torch.from_numpy(prompt[None])}, 32)
        cur = torch.argmax(logits, -1)[:, None]
        got = [int(cur[0, 0])]
        for _ in range(5):
            logits, cache = MD.decode_step(tp, cfg, cur, cache)
            cur = torch.argmax(logits, -1)[:, None]
            got.append(int(cur[0, 0]))
        assert got == want


def _paged_from_contiguous(cache, tab, bs, nb):
    """Numpy pools (L, nb, bs, H, Dh) holding each row's contiguous
    cache rows at its table's block ids (sentinels ``nb`` hold none)."""
    pools = {}
    for name in ("k", "v"):
        arr = np.asarray(cache[name], np.float32)          # (L, B, C, H, Dh)
        l, b, c = arr.shape[:3]
        pool = np.zeros((l, nb, bs, *arr.shape[3:]), np.float32)
        for i in range(b):
            for w in range(c // bs):
                if tab[i, w] < nb:
                    pool[:, tab[i, w]] = arr[:, i, w * bs:(w + 1) * bs]
        pools[name] = pool
    return pools


def test_paged_decode_step_matches(setup):
    """A paged decode step on scattered tables: logits, pool contents and
    lengths match the reference's. Row 0 is live and owns block NB-1 at
    its write position while row 2 is frozen and row 1's next block is a
    sentinel past its table — the dropped writes (frozen row, sentinel)
    must not race row 0's real write into block NB-1."""
    jcfg, jp, cfg, tp = setup
    rng = np.random.default_rng(3)
    b, cap, bs, nb = 3, 32, 8, 10
    toks = rng.integers(0, cfg.vocab_size, size=(b, 16)).astype(np.int32)
    _, jcache = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, cap)
    pos = np.array([16, 8, 5], np.int32)
    live = np.array([True, True, False])
    # row 0 writes position 16 -> its table entry 2 is block NB-1; row 1
    # writes position 8 -> entry 1 is a sentinel (write dropped)
    tab = np.array([[3, 0, nb - 1, nb], [5, nb, nb, nb], [7, nb, nb, nb]],
                   np.int32)
    pools = _paged_from_contiguous(jcache, tab, bs, nb)
    step = rng.integers(0, cfg.vocab_size, size=(b, 1)).astype(np.int32)
    want, jnew = JMD.decode_step(
        jp, jcfg, jnp.asarray(step),
        {"k": jnp.asarray(pools["k"]), "v": jnp.asarray(pools["v"]),
         "block_tab": jnp.asarray(tab), "len": jnp.asarray(pos)},
        live=jnp.asarray(live))
    # the port's pools carry one scratch block past the NB allocatable
    pk, pv = (torch.from_numpy(np.concatenate(
        [pools[n], np.zeros_like(pools[n][:, :1])], axis=1))
        for n in ("k", "v"))
    got, new = MD.decode_step(
        tp, cfg, torch.from_numpy(step),
        {"k": pk, "v": pv, "block_tab": torch.from_numpy(tab),
         "len": torch.from_numpy(pos)}, live=torch.from_numpy(live))
    np.testing.assert_allclose(got[live].numpy(), _np(want)[live],
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name][:, :nb].numpy(),
                                   _np(jnew[name]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(new["len"].numpy(), np.asarray(jnew["len"]))
    # the live row's token really landed in block NB-1, offset 0
    assert np.abs(new["k"][:, nb - 1, 0].numpy()).max() > 0


def test_self_draft_params_are_views(setup):
    _, _, cfg, tp = setup
    dp, dcfg = MD.self_draft_params(tp, cfg, 1)
    assert dcfg.n_layers == 1
    wq, dwq = tp["layers"]["attn"]["wq"], dp["layers"]["attn"]["wq"]
    assert dwq.shape[0] == 1 and dwq.data_ptr() == wq.data_ptr()
    assert dp["embed"]["table"] is tp["embed"]["table"]


def test_later_slices_raise(setup):
    """No family of the registry is left to a later slice: the recurrent
    and hybrid families init (their state leaves in the cache), as do
    the rolling window and whisper; a family the port does not know
    raises, and a paged pool refuses the window and the recurrent
    families as the reference's paged cache does."""
    _, _, cfg, tp = setup
    for arch, leaves in (("xlstm-350m", {"len", "mlstm", "slstm_c",
                                         "slstm_n", "slstm_h"}),
                         ("zamba2-2.7b", {"len", "ssm", "conv", "k", "v"})):
        rc = registry.get_smoke_config(arch)
        MD.init_params(rc, device="cpu")
        assert set(MD.init_cache(rc, 2, 64, device="cpu")) == leaves
        with pytest.raises(ValueError, match="paged pools hold"):
            MD.paged_pool_struct(rc, 4, 8)
    with pytest.raises(ValueError, match="unknown family"):
        MD.init_params(cfg.replace(family="rnn"), device="cpu")
    MD.init_params(registry.get_smoke_config("whisper-large-v3"),
                   device="cpu")
    swa = registry.get_smoke_config("h2o-danube-1.8b")
    assert MD.init_cache(swa, 1, 64, device="cpu")["k"].shape[2] == \
        swa.sliding_window
    with pytest.raises(ValueError, match="rolling SWA"):
        MD.paged_pool_struct(swa, 4, 8)
