"""Port prefix caching against the JAX package (qwen1.5-0.5b smoke config,
float32, CPU): the PrefixIndex's keys are the reference's byte for byte
and its invariants hold; warm admissions give the cold streams (and the
JAX engine's warm streams) under blocking and chunked admission; a cached
prefix charges only the suffix, with the reference's ``can_admit``
answers; the ``prefix_*`` summary keys equal the reference's; preemption
interleavings never leak; the contiguous backend and the speculative
policy ignore the flag."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import workload as JW
from repro.serving.kv_cache import PrefixIndex as JPrefixIndex
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving import workload as W
from repro_torch.serving.kv_cache import PrefixIndex
from _torch_threads import one_thread  # noqa: F401

BS = 16          # kv_block_size used throughout
PRE = 3 * BS     # shared preamble: exactly three full blocks
QUANTUM = 0.01
PREFIX_KEYS = ("prefix_hits", "prefix_lookups", "prefix_hit_tokens",
               "prefix_evictions", "prefix_hit_rate",
               "resident_shared_kv_bytes")


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _shared_prompts(cfg, n=4, tails=(4, 7, 9, 12, 5, 8), seed=0):
    """n prompts sharing one PRE-token preamble, distinct tails."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab_size, size=PRE)
    return [np.concatenate(
        [pre, rng.integers(0, cfg.vocab_size, size=tails[i % len(tails)])])
        for i in range(n)]


def _ekw(prefix_cache, **kw):
    ekw = dict(scheduler="blocking", kv_cache="paged", kv_block_size=BS,
               prefix_cache=prefix_cache, eos_token=-1, max_batch=2,
               max_seq_len=96, max_new_tokens=5)
    ekw.update(kw)
    return ekw


def _run(tp, cfg, prompts, *, prefix_cache, **kw):
    eng = ServingEngine(tp, cfg, EngineConfig(**_ekw(prefix_cache, **kw)),
                        device="cpu")
    for p in prompts:
        eng.submit(p)
    eng.run()
    return eng


def _outputs(eng):
    return {r.rid: r.output for r in eng.finished}


def _drained(kv):
    """Every alias released, shared blocks the only allocation left."""
    assert all(v == 0 for v in kv.prefix._refs.values())
    assert kv.allocator.allocated_blocks == kv.prefix.resident_blocks
    assert (kv.allocator.free_blocks + kv.prefix.resident_blocks
            == kv.allocator.num_blocks)
    assert not kv._reserved.any()
    # the scratch block (id num_blocks) is never registered
    assert kv.num_blocks not in kv.prefix._hash_of


# ---------------------------------------------------------------------------
# PrefixIndex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs,n", [(4, 12), (16, 64), (16, 100), (3, 7)])
def test_index_keys_equal_reference_byte_for_byte(bs, n):
    rng = np.random.default_rng(n)
    for prompt in (np.arange(n), rng.integers(0, 151936, size=n),
                   rng.integers(-5, 5, size=n).astype(np.int32)):
        k = n // bs
        assert PrefixIndex(bs).keys_for(prompt, k) == JPrefixIndex(
            bs).keys_for(prompt, k)


def test_index_match_caps_below_prompt_and_follows_chain():
    idx = PrefixIndex(4)
    p = np.arange(12)
    keys = idx.keys_for(p, 3)
    assert len(keys) == 3 and len(set(keys)) == 3
    for k in range(2):
        assert idx.register(keys[k], 100 + k)
    # limit is (n_prompt - 1) // bs: one suffix token must stay hot
    assert idx.match(p, 12) == [100, 101]
    assert idx.match(p, 9) == [100, 101]
    assert idx.match(p, 8) == [100]
    assert idx.match(p, 4) == []
    q = p.copy()
    q[1] = 999
    assert idx.match(q, 12) == []
    q2 = p.copy()
    q2[5] = 999
    assert idx.match(q2, 12) == [100]


def test_index_refcounts_lru_order_and_underflow():
    idx = PrefixIndex(4)
    keys = idx.keys_for(np.arange(16), 4)
    for k in range(4):
        assert idx.register(keys[k], k)
    assert not idx.register(keys[0], 99)   # canonical block wins
    assert idx.resident_blocks == 4 and idx.evictable() == 0
    for k in range(4):
        idx.release(k)
    assert idx.evictable() == 4
    idx.acquire([1])
    assert idx.evictable() == 3
    assert idx.evictable(excluding=[0, 1]) == 2
    idx.release(1)
    assert [idx.evict_lru() for _ in range(4)] == [0, 2, 3, 1]
    assert idx.evict_lru() is None
    assert idx.evictions == 4 and idx.resident_blocks == 0
    with pytest.raises(RuntimeError, match="underflow"):
        idx.release(7)


# ---------------------------------------------------------------------------
# warm == cold, and == the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched_kw", [
    {}, {"scheduler": "chunked", "chunk_tokens": 16}],
    ids=["blocking", "chunked"])
def test_warm_prefix_equals_cold_and_reference(setup, sched_kw):
    jcfg, jp, cfg, tp = setup
    prompts = _shared_prompts(cfg, seed=2)
    cold = _run(tp, cfg, prompts, prefix_cache=False, **sched_kw)
    warm = _run(tp, cfg, prompts, prefix_cache=True, **sched_kw)
    assert _outputs(warm) == _outputs(cold)
    jeng = JServingEngine(jp, jcfg, JEngineConfig(**_ekw(True, **sched_kw)))
    for p in prompts:
        jeng.submit(p)
    jeng.run()
    assert _outputs(warm) == {r.rid: r.output for r in jeng.finished}
    s, js = warm.summary(), jeng.summary()
    for key in PREFIX_KEYS + ("prefill_chunks", "prefill_chunk_dispatches",
                              "prefills"):
        assert s[key] == js[key], key
    assert s["prefix_hits"] >= 1 and s["prefix_lookups"] == len(prompts)
    assert 0.0 < s["prefix_hit_rate"] < 1.0
    assert s["resident_shared_kv_bytes"] > 0
    if sched_kw:   # warm admissions prefill only the suffix
        assert s["prefill_chunks"] < cold.summary()["prefill_chunks"]
    else:          # one chunk dispatch (K4) instead of a whole prefill
        assert s["prefills"] + s["prefill_chunk_dispatches"] == len(prompts)
        assert s["prefill_chunk_dispatches"] == s["prefix_hits"]
    sc = cold.summary()
    assert sc["prefix_hits"] == 0 and sc["prefix_hit_rate"] == 0.0
    _drained(warm.kv)
    assert cold.kv.allocator.allocated_blocks == 0


# ---------------------------------------------------------------------------
# suffix-only reservation + shared-block free guards
# ---------------------------------------------------------------------------

def test_cached_prefix_charges_only_uncached_suffix(setup):
    jcfg, jp, cfg, tp = setup
    p0, p1, p2 = _shared_prompts(cfg, n=3, tails=(4, 4, 4), seed=4)
    kw = dict(kv_blocks=5, max_new_tokens=4)
    eng = _run(tp, cfg, [p0], prefix_cache=True, **kw)
    jeng = JServingEngine(jp, jcfg, JEngineConfig(**_ekw(True, **kw)))
    jeng.submit(p0)
    jeng.run()
    kv = eng.kv
    assert kv.prefix.resident_blocks == PRE // BS
    # a live warm slot aliases the 3 shared blocks + 1 private tail
    for e in (eng, jeng):
        e.submit(p1)
        e.scheduler.admit(e)
    assert all(kv.prefix.refcount(b) == 1 for b in kv.prefix._refs)
    assert kv.allocator.free_blocks == jeng.kv.allocator.free_blocks == 1
    # the reference's answers: without the prompt nothing is free enough,
    # with it the cached blocks charge nothing
    for n, budget in ((len(p2), 4), (len(p2), 1), (PRE + 10, 10)):
        for prompt in (None, p2):
            assert kv.can_admit(n, budget, prompt=prompt) == \
                jeng.kv.can_admit(n, budget, prompt=prompt), (n, prompt)
    assert not kv.can_admit(len(p2), 4)
    assert kv.can_admit(len(p2), 4, prompt=p2)

    shared = next(iter(kv.prefix._refs))
    with pytest.raises(RuntimeError, match="refcount"):
        kv._free_block(shared)
    eng.run()
    assert kv.prefix.refcount(shared) == 0
    with pytest.raises(RuntimeError, match="registered"):
        kv._free_block(shared)
    _drained(kv)


@pytest.mark.parametrize("scheduler", ["blocking", "slo"])
def test_prefix_summary_keys_equal_reference(setup, scheduler):
    """The sharedprefix trace on a 6-block pool (hits, misses and LRU
    evictions): the port's schedule and prefix ledger are the JAX
    engine's."""
    jcfg, jp, cfg, tp = setup
    kw = dict(scheduler=scheduler, kv_cache="paged", kv_block_size=BS,
              kv_blocks=6, prefix_cache=True, eos_token=-1, max_batch=4,
              max_seq_len=96, max_new_tokens=16)
    want = JW.replay(JServingEngine(jp, jcfg, JEngineConfig(**kw)),
                     JW.make_named_trace("sharedprefix", vocab_size=256,
                                         seed=1), step_quantum_s=QUANTUM)
    eng = ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    got = W.replay(eng, W.make_named_trace("sharedprefix", vocab_size=256,
                                           seed=1), step_quantum_s=QUANTUM)
    for key in ("outputs", "admission_order", "preemption_log", "steps"):
        assert got[key] == want[key], key
    for key in PREFIX_KEYS + ("preemptions", "preempted_kv_bytes"):
        assert got["summary"][key] == want["summary"][key], key
    assert got["summary"]["prefix_hits"] >= 1
    assert got["summary"]["prefix_evictions"] >= 1
    _drained(eng.kv)


# ---------------------------------------------------------------------------
# preemption interleavings never leak or corrupt shared blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prop_ref(setup):
    _, _, cfg, tp = setup
    prompts = _shared_prompts(cfg, n=5, seed=7)
    return prompts, _outputs(_run(tp, cfg, prompts, prefix_cache=False))


def _drive_with_preemptions(tp, cfg, prompts, kv_cache, plan):
    kw = {"kv_blocks": 8} if kv_cache == "paged" else {}
    eng = ServingEngine(tp, cfg, EngineConfig(**_ekw(
        True, kv_cache=kv_cache, **kw)), device="cpu")
    for p in prompts:
        eng.submit(p)
    it = 0
    while eng.has_work():
        assert it < 500, "interleaving failed to drain"
        live = [i for i, r in enumerate(eng.slot_req) if r is not None]
        if live and it < len(plan) and plan[it] is not None:
            eng.preempt_slot(live[plan[it] % len(live)])
        eng.step()
        it += 1
    return eng


def _check_interleaving(tp, cfg, prompts, want, plan):
    eng = _drive_with_preemptions(tp, cfg, prompts, "paged", plan)
    assert _outputs(eng) == want
    _drained(eng.kv)
    ctg = _drive_with_preemptions(tp, cfg, prompts, "contiguous", plan)
    assert _outputs(ctg) == want
    assert ctg.summary()["prefix_hit_rate"] == 0.0


@pytest.mark.parametrize("plan", [
    (),                                    # no preemption at all
    (0,) * 24,                             # hammer the first live slot
    (None, 1, None, 0, 3, None, 2) * 3,    # scattered mixed victims
    (None, None, None, 1, 1, 1, 1, 1),     # burst mid-run
])
def test_preemption_interleavings_never_leak(setup, prop_ref, plan):
    _, _, cfg, tp = setup
    prompts, want = prop_ref
    _check_interleaving(tp, cfg, prompts, want, plan)


def test_random_preemption_interleavings_never_leak(setup, prop_ref):
    from hypothesis import given, settings, strategies as st

    _, _, cfg, tp = setup
    prompts, want = prop_ref

    @settings(max_examples=10, deadline=None)
    @given(plan=st.lists(st.one_of(st.none(), st.integers(0, 3)),
                         max_size=24))
    def check(plan):
        _check_interleaving(tp, cfg, prompts, want, tuple(plan))

    check()


# ---------------------------------------------------------------------------
# where the flag is ignored, as in the reference
# ---------------------------------------------------------------------------

def test_contiguous_backend_ignores_the_flag(setup):
    _, _, cfg, tp = setup
    prompts = _shared_prompts(cfg)
    on = _run(tp, cfg, prompts, prefix_cache=True, kv_cache="contiguous")
    off = _run(tp, cfg, prompts, prefix_cache=False, kv_cache="contiguous")
    assert not on._prefix_on and _outputs(on) == _outputs(off)
    s = on.summary()
    assert all(s[k] == 0 for k in PREFIX_KEYS)


def test_speculative_accepts_and_ignores_prefix_cache(setup):
    jcfg, jp, cfg, tp = setup
    prompts = _shared_prompts(cfg)
    kw = dict(scheduler="speculative", spec_gamma=2)
    JServingEngine(jp, jcfg, JEngineConfig(**_ekw(True, **kw)))
    on = _run(tp, cfg, prompts, prefix_cache=True, **kw)
    off = _run(tp, cfg, prompts, prefix_cache=False, **kw)
    assert on.kv.prefix is not None and not on._prefix_on
    assert _outputs(on) == _outputs(off)
    assert on.summary()["prefix_lookups"] == 0
    assert on.kv.prefix.resident_blocks == 0
