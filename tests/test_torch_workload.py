"""Port workload layer and SLO scheduling against the JAX package
(qwen1.5-0.5b smoke config, float32, CPU): the seeded traces are equal,
the autoscale policy agrees, trace replays give the JAX engine's streams,
admission orders, preemption logs and virtual-clock breakdowns, and the
SLO policy holds chat's TTFT target under overload while FIFO does not —
losslessly."""
from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import workload as JW
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving import workload as W
from _torch_threads import one_thread  # noqa: F401

QUANTUM = 0.01
NAMES = ("overload", "steady", "diurnal", "mixshift", "sharedprefix")


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _kw(scheduler="blocking", kv_cache="contiguous", **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("max_new_tokens", 16)
    return dict(scheduler=scheduler, kv_cache=kv_cache, eos_token=-1, **kw)


def _engine(tp, cfg, *args, **kw):
    return ServingEngine(tp, cfg, EngineConfig(**_kw(*args, **kw)),
                         device="cpu")


def _same_trace(a, b):
    assert a.schema() == b.schema()
    assert len(a.requests) == len(b.requests)
    for x, y in zip(a.requests, b.requests):
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.prompt.dtype == y.prompt.dtype
        assert (x.rid, x.arrival_s, x.tenant, x.priority, x.slo.ttft_s,
                x.slo.itl_s, x.max_new_tokens, x.seed) == (
                    y.rid, y.arrival_s, y.tenant, y.priority, y.slo.ttft_s,
                    y.slo.itl_s, y.max_new_tokens, y.seed)


# ---------------------------------------------------------------------------
# traces: the port's copy gives the reference's traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_named_traces_equal_reference(name, seed):
    _same_trace(W.make_named_trace(name, vocab_size=256, seed=seed),
                JW.make_named_trace(name, vocab_size=256, seed=seed))


@pytest.mark.parametrize("arrival,len_step,prefix", [
    ("poisson", 1, 0), ("diurnal", 1, 0), ("poisson", 8, 16),
    ("diurnal", 4, 32)])
def test_make_trace_equals_reference(arrival, len_step, prefix):
    def tenants(mod):
        return (mod.TenantSpec("a", rate_rps=9.0, prompt_len=(3, 20),
                               new_tokens=(2, 5), priority=1,
                               slo=mod.SLO(ttft_s=0.1), burst=2,
                               prefix_len=prefix),
                mod.TenantSpec("b", rate_rps=4.0, prompt_len=(6, 9),
                               new_tokens=(1, 3), window=(0.5, 2.0)))
    kw = dict(vocab_size=1000, seed=5, arrival=arrival, len_step=len_step,
              diurnal_period_s=2.0)
    _same_trace(W.make_trace(tenants(W), 3.0, **kw),
                JW.make_trace(tenants(JW), 3.0, **kw))


def test_trace_generation_deterministic_and_seed_sensitive():
    a = W.make_named_trace("overload", vocab_size=256, seed=0)
    b = W.make_named_trace("overload", vocab_size=256, seed=0)
    c = W.make_named_trace("overload", vocab_size=256, seed=1)
    assert a.schema() == b.schema() != c.schema()
    arr = [r.arrival_s for r in a.requests]
    assert arr == sorted(arr)
    assert all(0.0 <= t < a.horizon_s for t in arr)
    assert len({r.rid for r in a.requests}) == len(a.requests)
    with pytest.raises(ValueError, match="unknown named trace"):
        W.make_named_trace("bursty", vocab_size=256)
    with pytest.raises(ValueError, match="arrival"):
        W.make_trace((), 1.0, vocab_size=256, arrival="hawkes")


def test_autoscale_decision_matches_reference_over_its_policy_table():
    for waiting, pending, live, n_prefill, n_decode, spw in itertools.product(
            range(0, 5), range(0, 3), range(0, 10, 3), range(1, 4),
            range(1, 4), (2, 4)):
        kw = dict(waiting=waiting, pending=pending, live=live,
                  n_prefill=n_prefill, n_decode=n_decode,
                  slots_per_worker=spw)
        assert W.autoscale_decision(**kw) == JW.autoscale_decision(**kw), kw
    base = dict(waiting=0, pending=0, live=0, n_prefill=2, n_decode=2,
                slots_per_worker=4)
    assert W.autoscale_decision(**base) is None
    assert W.autoscale_decision(**{**base, "pending": 1}) == "to_decode"
    assert W.autoscale_decision(**{**base, "waiting": 3}) == "to_prefill"


# ---------------------------------------------------------------------------
# replay through both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
@pytest.mark.parametrize("scheduler", ["blocking", "slo"])
def test_overload_replay_matches_reference(setup, scheduler, kv_cache):
    jcfg, jp, cfg, tp = setup
    kw = _kw(scheduler, kv_cache)
    want = JW.replay(JServingEngine(jp, jcfg, JEngineConfig(**kw)),
                     JW.make_named_trace("overload", vocab_size=256, seed=0),
                     step_quantum_s=QUANTUM)
    got = W.replay(_engine(tp, cfg, scheduler, kv_cache),
                   W.make_named_trace("overload", vocab_size=256, seed=0),
                   step_quantum_s=QUANTUM)
    for key in ("outputs", "admission_order", "preemption_log", "steps",
                "decode_steps", "tokens"):
        assert got[key] == want[key], key
    s, js = got["summary"], want["summary"]
    for key in ("by_tenant", "by_priority", "preemptions",
                "preempted_kv_bytes", "slo_attainment", "ttft_p50_s",
                "ttft_p99_s", "mean_itl_s", "requests", "tokens"):
        assert s[key] == js[key], key
    ttft = {rid: r.ttft_s for rid, r in got["requests"].items()}
    assert ttft == {rid: r.ttft_s for rid, r in want["requests"].items()}
    if scheduler == "slo":
        assert s["preemptions"] >= 1


@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
def test_slo_scheduler_holds_chat_p99_fifo_does_not(setup, kv_cache):
    """The reference's overload gate on the port: the SLO policy keeps
    chat's p99 TTFT within 40 ms by preempting, with streams equal to
    FIFO's and throughput within 5%; FIFO misses the target; the paged
    pool drains to empty."""
    _, _, cfg, tp = setup
    tr = W.make_named_trace("overload", vocab_size=cfg.vocab_size, seed=0)
    runs = {}
    for sched in ("blocking", "slo"):
        eng = _engine(tp, cfg, sched, kv_cache)
        runs[sched] = W.replay(eng, tr, step_quantum_s=QUANTUM)
        if kv_cache == "paged":
            assert eng.kv.allocator.allocated_blocks == 0
            assert eng.kv.allocator.free_blocks == eng.kv.num_blocks
    fifo, slo = runs["blocking"], runs["slo"]
    assert slo["outputs"] == fifo["outputs"]
    assert slo["summary"]["preemptions"] >= 1
    assert len(slo["preemption_log"]) == slo["summary"]["preemptions"]
    chat_slo = slo["summary"]["by_tenant"]["chat"]
    chat_fifo = fifo["summary"]["by_tenant"]["chat"]
    assert chat_slo["ttft_p99_s"] <= 0.04 < chat_fifo["ttft_p99_s"]
    assert chat_slo["slo_attainment"] == 1.0 > chat_fifo["slo_attainment"]
    ratio = ((slo["tokens"] / slo["steps"])
             / (fifo["tokens"] / fifo["steps"]))
    assert ratio >= 0.95
    prio = {r.rid: r.priority for r in tr.requests}
    assert all(prio[rid] < 2 for _, rid in slo["preemption_log"])


def test_per_tenant_and_priority_breakdowns_in_summary(setup):
    _, _, cfg, tp = setup
    tr = W.make_named_trace("steady", vocab_size=cfg.vocab_size, seed=0)
    s = W.replay(_engine(tp, cfg, "slo"), tr, step_quantum_s=QUANTUM)[
        "summary"]
    assert set(s["by_tenant"]) == {"chat", "summarize", "agent"}
    assert set(s["by_priority"]) == {0, 1, 2}
    for b in list(s["by_tenant"].values()) + list(s["by_priority"].values()):
        assert b["requests"] > 0
        assert b["ttft_p50_s"] <= b["ttft_p99_s"]
        assert 0.0 <= b["slo_attainment"] <= 1.0
    n = sum(b["requests"] for b in s["by_tenant"].values())
    assert n == s["requests"] == len(tr.requests)


def test_summary_key_set_stable_and_equal_to_reference(setup):
    """The port's summary holds every key of the reference's, with and
    without finished requests."""
    jcfg, jp, cfg, tp = setup
    jkeys = set(JServingEngine(jp, jcfg, JEngineConfig()).summary())
    eng = _engine(tp, cfg)
    empty = set(eng.summary())
    eng.submit(np.arange(5))
    eng.run()
    assert empty == set(eng.summary())
    assert jkeys <= empty


def test_random_preemptions_lose_no_tokens_property(setup):
    """Property: preempting random live slots at random steps — packets
    requeued and resumed by the blocking scheduler — never loses a
    token, on both KV backends."""
    from hypothesis import given, settings, strategies as st

    _, _, cfg, tp = setup
    kw = dict(max_batch=2, max_seq_len=64, max_new_tokens=4)
    singles: dict = {}

    @given(lens=st.lists(st.integers(1, 30), min_size=1, max_size=5),
           plan=st.lists(st.tuples(st.integers(1, 20), st.integers(0, 1)),
                         min_size=1, max_size=4, unique_by=lambda p: p[0]),
           kv_cache=st.sampled_from(["contiguous", "paged"]))
    @settings(max_examples=10, deadline=None)
    def prop(lens, plan, kv_cache):
        prompts = [np.arange(n) % cfg.vocab_size for n in lens]
        skey = (tuple(lens), kv_cache)
        if skey not in singles:
            ref = _engine(tp, cfg, kv_cache=kv_cache, **kw)
            for p in prompts:
                ref.submit(p)
            ref.run()
            singles[skey] = {r.rid: r.output for r in ref.finished}
        eng = _engine(tp, cfg, kv_cache=kv_cache, **kw)
        for p in prompts:
            eng.submit(p)
        by_step = dict(plan)
        steps = preempted = 0
        while eng.has_work():
            slot = by_step.get(steps)
            if (slot is not None and eng.slot_req[slot] is not None
                    and slot not in eng.prefilling):
                eng.preempt_slot(slot)
                preempted += 1
            eng.step()
            steps += 1
            assert steps < 500, "engine failed to drain"
        assert {r.rid: r.output for r in eng.finished} == singles[skey]
        assert eng.preemptions == preempted
        if kv_cache == "paged":
            assert eng.kv.allocator.allocated_blocks == 0

    prop()


def test_preempt_slot_guards(setup):
    _, _, cfg, tp = setup
    eng = _engine(tp, cfg, "chunked", chunk_tokens=16)
    with pytest.raises(ValueError, match="not live"):
        eng.preempt_slot(0)
    eng.submit(np.arange(40) % cfg.vocab_size)
    eng.scheduler.admit(eng)
    with pytest.raises(RuntimeError, match="mid-prefill"):
        eng.preempt_slot(0)
    spec = _engine(tp, cfg, "speculative", spec_gamma=2)
    spec.submit(np.arange(9))
    spec.step()
    with pytest.raises(RuntimeError, match="speculative"):
        spec.preempt_slot(0)
