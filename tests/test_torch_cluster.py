"""The port's disaggregated cluster against the JAX package's
(qwen1.5-0.5b smoke config, float32, CPU, weights bridged from
``PRNGKey(5)``): one run of each cluster — paged, 1 prefill + 2 decode
workers, the reference test's six prompts, decode worker 0 killed after
two steps, telemetry on, the virtual clock — gives the same streams, handoffs, migrations,
hops, transfer bytes, per-worker records, summary keys and spans; the
straggler monitor equals the reference's; the reference's router,
admission, fault and schema tests hold inside the port; placement
raises without CUDA unless the CPU is named, shares the weights between
workers on one device, and a kernel launch refuses operands on two
devices."""
from __future__ import annotations

import collections
import math
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed.fault_tolerance import \
    StragglerMonitor as JStragglerMonitor
from repro.models import model as JMD
from repro.serving import ClusterConfig as JClusterConfig
from repro.serving import ClusterEngine as JClusterEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.telemetry import Telemetry as JTelemetry
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.kernels import _build, flash_attention
from repro_torch.serving import (ClusterConfig, ClusterEngine, EngineConfig,
                                 ServingEngine, Telemetry)
from repro_torch.serving.workload import SLO, TenantSpec, make_trace, replay
from _torch_threads import one_thread  # noqa: F401

ARCH = "qwen1.5-0.5b"
CPU = ("cpu",)
ROUND_ROBIN = "workers share devices round-robin"
KW = dict(max_batch=2, max_seq_len=64, max_new_tokens=5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(5), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def _cluster(tp, cfg, ecfg_kw, **ccfg_kw):
    """A port cluster on the CPU (its round-robin warning expected)."""
    with pytest.warns(UserWarning, match=ROUND_ROBIN):
        return ClusterEngine(tp, cfg, EngineConfig(**ecfg_kw),
                             ClusterConfig(devices=CPU, **ccfg_kw))


def _outputs(finished) -> dict:
    return {r.rid: r.output for r in finished}


@pytest.fixture(scope="module")
def pair(setup):
    """The JAX cluster and the port's over the same traffic and fault:
    paged, 1 + 2 workers, six prompts, kill_worker(0) after two steps —
    under the virtual clock, where the straggler monitors see no wall
    jitter, so their events are part of the comparison."""
    jcfg, jp, cfg, tp = setup
    prompts = _prompts(cfg.vocab_size, [7, 12, 19, 9, 15, 6], seed=1)
    runs = []
    for Cluster, Config, ECfg, Tel, params, c, extra in (
            (JClusterEngine, JClusterConfig, JEngineConfig, JTelemetry, jp,
             jcfg, {}),
            (ClusterEngine, ClusterConfig, EngineConfig, Telemetry, tp, cfg,
             {"devices": CPU})):
        tel = Tel()
        with pytest.warns(UserWarning, match=ROUND_ROBIN):
            clu = Cluster(params, c, ECfg(kv_cache="paged", **KW),
                          Config(n_prefill=1, n_decode=2, **extra),
                          telemetry=tel)
        clu.set_now(0.0)
        for p in prompts:
            clu.submit(p)
        for _ in range(2):
            clu.step()
        clu.kill_worker(0)
        clu.run()
        runs.append((clu, tel))
    return runs


def test_streams_equal_reference(pair):
    (jclu, _), (tclu, _) = pair
    want = _outputs(jclu.finished)
    assert len(want) == 6
    assert _outputs(tclu.finished) == want


@pytest.mark.parametrize("key", [
    "handoffs", "migrations", "max_migration_hops", "kv_transfer_bytes",
    "migration_bytes", "dispatches_per_step", "decode_steps",
    "decode_dispatches", "prefills", "workers_alive", "n_prefill",
    "n_decode", "requests", "tokens", "kv_cache", "resident_kv_bytes"])
def test_summary_value_equals_reference(pair, key):
    (jclu, _), (tclu, _) = pair
    assert tclu.summary()[key] == jclu.summary()[key]


def test_summary_keys_and_per_worker_equal_reference(pair):
    (jclu, _), (tclu, _) = pair
    js, ts = jclu.summary(), tclu.summary()
    assert set(ts) == set(js)
    assert set(ts["telemetry"]["workers"]) == set(js["telemetry"]["workers"])
    strip = [[{k: v for k, v in w.items() if k != "device"}
              for w in s["per_worker"]] for s in (js, ts)]
    assert strip[1] == strip[0]
    assert [w["device"] for w in ts["per_worker"]] == ["cpu"] * 3
    assert ts["migrations"] >= 1 and ts["dispatches_per_step"] == 1.0


def test_spans_and_transfer_counters_equal_reference(pair):
    (jclu, jtel), (tclu, ttel) = pair

    def spans(tel):
        return collections.Counter((s.name, s.tid) for s in tel.tracer.spans)

    assert spans(ttel) == spans(jtel)
    assert {s.tid for s in ttel.tracer.spans} == {
        "cluster", "prefill0", "decode0", "decode1"}
    for kind in ("handoff", "migration"):
        for name in ("cluster_kv_transfers_total",
                     "cluster_kv_transfer_bytes_total"):
            want = jtel.metrics.counter(name, kind=kind).value
            assert ttel.metrics.counter(name, kind=kind).value == want
    assert ttel.metrics.counter("cluster_kv_transfer_bytes_total",
                                kind="handoff").value + ttel.metrics.counter(
        "cluster_kv_transfer_bytes_total", kind="migration").value == \
        tclu.kv_transfer_bytes


@pytest.mark.parametrize("factor,min_samples", [(3.0, 3), (1.5, 1),
                                                (1.0, 5)])
def test_straggler_monitor_equals_reference(factor, min_samples):
    rng = np.random.default_rng(11)
    lat = rng.exponential(0.01, size=200) * np.where(
        rng.random(200) < 0.1, 8.0, 1.0)
    ours = StragglerMonitor(factor=factor, min_samples=min_samples)
    ref = JStragglerMonitor(factor=factor, min_samples=min_samples)
    assert ours.deadline_s == ref.deadline_s == float("inf")
    for i, s in enumerate(lat):
        assert ours.observe(i, float(s)) == ref.observe(i, float(s))
        assert ours.deadline_s == ref.deadline_s
    assert ours.events == ref.events and ours.events
    assert (ours.ema_s, ours.n) == (ref.ema_s, ref.n)


# ---------------------------------------------------------------------------
# the reference's router / admission / fault tests, inside the port
# ---------------------------------------------------------------------------

def test_router_balances_decode_workers(setup):
    _, _, cfg, tp = setup
    clu = _cluster(tp, cfg, dict(max_batch=4, max_seq_len=64,
                                 max_new_tokens=8), n_prefill=1, n_decode=2)
    for p in _prompts(cfg.vocab_size, [8, 9, 10, 11], seed=3):
        clu.submit(p)
    clu.step()
    assert [len(w.live_slots()) for w in clu.decode_workers] == [2, 2]


def test_in_flight_budget_caps_worker_load(setup):
    _, _, cfg, tp = setup
    clu = _cluster(tp, cfg, dict(max_batch=4, max_seq_len=64,
                                 max_new_tokens=8),
                   n_prefill=1, n_decode=2, in_flight=1)
    for p in _prompts(cfg.vocab_size, [8, 9, 10, 11], seed=4):
        clu.submit(p)
    max_load = 0
    while clu.waiting or clu.pending or clu._any_live():
        clu.step()
        max_load = max(max_load,
                       *(len(w.live_slots()) for w in clu.decode_workers))
    assert max_load == 1
    assert len(clu.finished) == 4


@pytest.mark.parametrize("scheduler", ["chunked", "speculative", "slo"])
def test_cluster_rejects_nonblocking_scheduler(setup, scheduler):
    _, _, cfg, tp = setup
    with pytest.raises(ValueError, match="blocking"):
        ClusterEngine(tp, cfg, EngineConfig(max_batch=2, max_seq_len=64,
                                            scheduler=scheduler),
                      ClusterConfig(devices=CPU))


@pytest.mark.parametrize("kw", [dict(n_prefill=0), dict(n_decode=0),
                                dict(autoscale=True, autoscale_interval=0)])
def test_cluster_config_refusals(kw):
    with pytest.raises(ValueError):
        ClusterConfig(**kw)


def test_no_routable_decode_worker_raises(setup):
    _, _, cfg, tp = setup
    clu = _cluster(tp, cfg, dict(max_batch=2, max_seq_len=64,
                                 max_new_tokens=4), n_prefill=1, n_decode=1)
    clu.submit(_prompts(cfg.vocab_size, [8], seed=5)[0])
    clu.kill_worker(0)
    with pytest.raises(RuntimeError, match="no routable decode worker"):
        clu.run()


def test_drain_refuses_last_routable_worker(setup):
    _, _, cfg, tp = setup
    clu = _cluster(tp, cfg, dict(max_batch=2, max_seq_len=64,
                                 max_new_tokens=4), n_prefill=1, n_decode=1)
    clu.submit(_prompts(cfg.vocab_size, [8], seed=6)[0])
    clu.step()
    with pytest.warns(UserWarning, match="refusing to drain"):
        clu.drain_worker(0)
    assert not clu.decode_workers[0].draining
    clu.run()
    assert len(clu.finished) == 1


def test_migration_hops_accumulate(setup):
    """Drained, then killed: one request survives two hops, and its
    stream is the single engine's."""
    _, _, cfg, tp = setup
    kw = dict(max_batch=2, max_seq_len=64, max_new_tokens=12)
    [prompt] = _prompts(cfg.vocab_size, [8], seed=7)
    single = ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    single.submit(prompt)
    single.run()
    clu = _cluster(tp, cfg, kw, n_prefill=1, n_decode=3)
    clu.submit(prompt)
    clu.step()
    loaded = next(i for i, w in enumerate(clu.decode_workers)
                  if w.live_slots())
    clu.drain_worker(loaded)   # hop 1
    clu.step()
    loaded = next(i for i, w in enumerate(clu.decode_workers)
                  if w.live_slots())
    clu.kill_worker(loaded)    # hop 2
    clu.run()
    s = clu.summary()
    assert s["migrations"] == 2 and s["max_migration_hops"] == 2
    assert _outputs(clu.finished) == _outputs(single.finished)


def test_replay_with_auto_drain_is_deterministic(setup):
    """Under the virtual clock the monitor sees a constant, which never
    breaches: two replays take identical schedules and drain nothing."""
    _, _, cfg, tp = setup
    tr = make_trace(
        (TenantSpec("t", rate_rps=25.0, prompt_len=(6, 10),
                    new_tokens=(3, 3), priority=0,
                    slo=SLO(ttft_s=float("inf"))),),
        0.3, vocab_size=cfg.vocab_size, seed=4)

    def once():
        clu = _cluster(tp, cfg, dict(max_batch=2, max_seq_len=64,
                                     max_new_tokens=4, eos_token=-1),
                       n_prefill=1, n_decode=2, straggler_factor=1.0,
                       auto_drain_stragglers=True)
        return replay(clu, tr, step_quantum_s=0.01), clu

    rep1, clu1 = once()
    rep2, clu2 = once()
    assert rep1["outputs"] and rep1["outputs"] == rep2["outputs"]
    assert rep1["steps"] == rep2["steps"]
    for clu in (clu1, clu2):
        assert all(w.monitor.events == [] for w in clu.decode_workers)
        assert all(not w.draining for w in clu.decode_workers)


def _assert_nan_free(obj, path=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _assert_nan_free(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _assert_nan_free(v, f"{path}[{i}]")
    elif isinstance(obj, float):
        assert not math.isnan(obj), f"NaN at {path}"


def test_cluster_summary_schema_stable_for_zero_and_n_requests(setup):
    _, _, cfg, tp = setup
    kw = dict(max_batch=2, max_seq_len=64, max_new_tokens=4)
    s0 = _cluster(tp, cfg, kw, n_prefill=1, n_decode=2).summary()
    clu = _cluster(tp, cfg, kw, n_prefill=1, n_decode=2)
    for p in _prompts(cfg.vocab_size, [8, 13], seed=8):
        clu.submit(p)
    clu.run()
    sN = clu.summary()
    assert set(s0) == set(sN)
    _assert_nan_free(s0)
    _assert_nan_free(sN)
    assert s0["requests"] == 0 and sN["requests"] == 2
    assert s0["tokens_per_s"] == 0.0
    assert s0["slo_attainment"] == 1.0
    assert s0["workers_alive"] == 2


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ccfg", [None, ClusterConfig()])
def test_default_devices_without_cuda_raise(setup, monkeypatch, ccfg):
    """``()`` means every CUDA device: with none the cluster raises and
    never carries on on the CPU."""
    _, _, cfg, tp = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterEngine(tp, cfg, EngineConfig(**KW), ccfg)


def test_named_cpu_shares_weights_round_robin(setup):
    """Three workers on the one named device: the round-robin warning,
    and every worker's weights are the caller's tensors (no copy)."""
    _, _, cfg, tp = setup
    clu = _cluster(tp, cfg, KW, n_prefill=1, n_decode=2)
    assert clu.ccfg.devices == (torch.device("cpu"),)
    workers = clu.prefill_workers + clu.decode_workers
    assert all(w.device == torch.device("cpu") for w in workers)
    assert all(w.params is workers[0].params for w in workers)
    assert all(w.eng.params is w.params for w in workers)
    assert workers[0].params["embed"]["table"] is tp["embed"]["table"]
    kv = {id(w.eng.kv) for w in workers}
    assert len(kv) == 3


def test_launch_refuses_operands_on_two_devices():
    """One launch takes operands of one device: the message names both
    (checked before anything would touch the card)."""
    a = types.SimpleNamespace(device=torch.device("cuda", 0))
    b = types.SimpleNamespace(device=torch.device("cuda", 1))
    with pytest.raises(ValueError, match=r"cuda:0 and cuda:1"):
        _build.same_device("k", a, b)
    assert _build.same_device("k", a, a) == torch.device("cuda", 0)
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="operands on cpu and meta"):
        flash_attention.flash_attention(q, q.to("meta"), q.to("meta"))
