"""The port's sampling head (qwen1.5-0.5b smoke config, float32, CPU):
greedy is the default and bitwise the JAX engine's stream; temperature
sampling is reproducible per (seed, request id, position) — the same
seed gives the same stream wherever the request lands (slot, batch, KV
backend, scheduler, preemption) and another seed another stream; the
top-k cut is the reference's threshold cut, ties included; and the draws
follow the softmax (a chi-square test)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.engine import (draw_keys, gumbel_draw, make_sampler,
                                        top_k_cut, vocab_keys)
from _torch_threads import one_thread  # noqa: F401

TEMP = dict(sample="temperature", temperature=0.8, top_k=8)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 21, 5, 33, 12)]
    return jcfg, jp, cfg, tp, prompts


def _engine(tp, cfg, **kw):
    ekw = dict(max_batch=2, max_seq_len=64, max_new_tokens=6)
    ekw.update(kw)
    return ServingEngine(tp, cfg, EngineConfig(**ekw), device="cpu")


def _serve(eng, prompts, seeds=None):
    reqs = [eng.submit(p, seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]
    eng.run()
    return [r.output for r in reqs]


def test_greedy_is_default_and_bitwise(setup):
    """Greedy is the default head: the port's stream equals the JAX
    engine's and the port's own batch-1 prefill + decode_step loop."""
    jcfg, jp, cfg, tp, prompts = setup
    eng = _engine(tp, cfg)
    assert eng.ecfg.sample == "greedy"
    got = _serve(eng, prompts)
    jeng = JServingEngine(jp, jcfg, JEngineConfig(
        max_batch=2, max_seq_len=64, max_new_tokens=6))
    assert got == _serve(jeng, prompts)
    toks = torch.as_tensor(prompts[0][None, :])
    logits, cache = MD.prefill(tp, cfg, {"tokens": toks}, 64)
    cur = torch.argmax(logits, -1)[:, None]
    want = [int(cur[0, 0])]
    for _ in range(5):
        logits, cache = MD.decode_step(tp, cfg, cur, cache)
        cur = torch.argmax(logits, -1)[:, None]
        want.append(int(cur[0, 0]))
    assert got[0] == want


def test_same_seed_same_stream_other_seed_differs(setup):
    _, _, cfg, tp, prompts = setup
    a = _serve(_engine(tp, cfg, **TEMP), prompts[:1], seeds=[7])
    b = _serve(_engine(tp, cfg, **TEMP), prompts[:1], seeds=[7])
    c = _serve(_engine(tp, cfg, **TEMP), prompts[:1], seeds=[8])
    assert a == b
    assert c != a
    assert all(0 <= t < cfg.vocab_size for t in a[0])
    # submit(seed=) overrides the config's seed; without it the config's
    # seed keys the stream
    d = _serve(_engine(tp, cfg, seed=7, **TEMP), prompts[:1])
    e = _serve(_engine(tp, cfg, seed=3, **TEMP), prompts[:1], seeds=[7])
    assert d == a == e
    # the temperature head draws: a sampled stream is not the greedy one
    g = _serve(_engine(tp, cfg), prompts)
    s = _serve(_engine(tp, cfg, **TEMP), prompts, seeds=[7] * len(prompts))
    assert s != g


@pytest.mark.parametrize("where", [
    dict(kv_cache="paged"),
    dict(scheduler="chunked", chunk_tokens=16),
    dict(kv_cache="paged", scheduler="slo"),
    dict(max_batch=5),
], ids=["paged", "chunked", "paged-slo", "wide"])
def test_stream_does_not_depend_on_slot_batch_or_backend(setup, where):
    """Each request alone in slot 0 of a contiguous + blocking engine
    (zero-budget requests before it give it the same request id), against
    all of them served together — other slots, other batch rows — on
    ``where``."""
    _, _, cfg, tp, prompts = setup
    alone = []
    for i, p in enumerate(prompts):
        eng = _engine(tp, cfg, **TEMP)
        for _ in range(i):
            eng.submit(p, max_new_tokens=0)
        req = eng.submit(p, seed=11)
        eng.run()
        assert req.rid == i
        alone.append(req.output)
    eng = _engine(tp, cfg, **{**TEMP, **where})
    reqs = [eng.submit(p, seed=11) for p in prompts]
    eng.run()
    assert [r.output for r in reqs] == alone


def test_preempted_sampled_stream_is_unchanged(setup):
    _, _, cfg, tp, prompts = setup
    want = _serve(_engine(tp, cfg, kv_cache="paged", **TEMP), prompts,
                  seeds=[5] * len(prompts))
    eng = _engine(tp, cfg, kv_cache="paged", **TEMP)
    reqs = [eng.submit(p, seed=5) for p in prompts]
    it = 0
    while eng.has_work():
        live = [i for i, r in enumerate(eng.slot_req) if r is not None]
        if live and it % 3 == 1:
            eng.preempt_slot(live[it % len(live)])
        eng.step()
        it += 1
    assert eng.preemptions >= 3
    assert [r.output for r in reqs] == want


@pytest.mark.parametrize("k", [1, 3, 8, 255, 256, 0])
def test_top_k_cut_equals_reference_threshold(k):
    """Ties with the k-th largest value survive, as in the reference's
    ``lg < kth -> -inf`` (a gather of k indices would drop them)."""
    rng = np.random.default_rng(k)
    lg = rng.integers(-6, 6, size=(4, 256)).astype(np.float32) / 2.0
    got = top_k_cut(torch.as_tensor(lg), k).numpy()
    j = jnp.asarray(lg)
    if 0 < k < lg.shape[-1]:
        kth = jax.lax.top_k(j, k)[0][..., -1:]
        j = jnp.where(j < kth, -jnp.inf, j)
    np.testing.assert_array_equal(got, np.asarray(j))
    if 0 < k < 256:   # the integer grid guarantees ties at the threshold
        assert ((got > -np.inf).sum(-1) > k).any()


def test_draw_frequencies_match_the_softmax():
    """20000 draws keyed by distinct (rid, pos) on fixed logits over 8
    tokens: Pearson's chi-square against the softmax must stay below
    24.32, the 0.999 quantile of chi-square with 7 degrees of freedom;
    a cut token is never drawn."""
    lg = torch.tensor([[1.5, 0.2, -0.7, 0.9, 0.0, -2.0, 1.1, 0.4]])
    n = 20000
    rids, pos = np.arange(n) // 100, np.arange(n) % 100 + 17
    keys = draw_keys(np.full(n, 3), rids, pos, "cpu")
    vk = vocab_keys(8, "cpu")
    draws = gumbel_draw(lg.expand(n, 8), keys, vk).numpy()
    p = torch.softmax(lg[0].double(), -1).numpy()
    counts = np.bincount(draws, minlength=8)
    chi2 = float((((counts - n * p) ** 2) / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts, n * p)
    cut = top_k_cut(lg, 3).expand(n, 8)
    drawn = set(gumbel_draw(cut, keys, vk).numpy().tolist())
    assert drawn == {0, 3, 6}


def test_sampler_keys_fold_seed_rid_and_position():
    """Each of seed, rid and position changes the key; the same triple
    gives the same key in any batch."""
    base = draw_keys([1, 1, 1, 2], [4, 4, 5, 4], [9, 10, 9, 9], "cpu")
    assert len(set(base.tolist())) == 4
    again = draw_keys([2, 1], [4, 4], [9, 9], "cpu")
    assert again.tolist() == [base[3].item(), base[0].item()]
    assert all(0 <= x < 2 ** 32 for x in base.tolist())


def test_unknown_mode_and_speculative_temperature_raise(setup):
    _, _, cfg, tp, _ = setup
    with pytest.raises(ValueError, match="sample mode"):
        _engine(tp, cfg, sample="beam")
    with pytest.raises(ValueError, match="sample mode"):
        make_sampler(EngineConfig(sample="nucleus"))
    with pytest.raises(ValueError, match="requires sample='greedy'"):
        EngineConfig(scheduler="speculative", sample="temperature")
