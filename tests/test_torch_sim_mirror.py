"""The port's simulator schedule mirror (``LLMSimulator.serve(trace=)``)
against the port's engine and cluster replays, and against the
reference simulator's schedule on the same trace (qwen1.5-0.5b smoke
config, float32, CPU).

The reference's simulator cases of ``tests/test_workload.py``,
``tests/test_prefix_cache.py``, ``tests/test_cluster.py`` and
``tests/test_kv_cache.py``, on the port: the mirror runs the port's own
scheduler objects, ``PrefixIndex`` and autoscale policy, so admission
order, preemption log, steps, every request's virtual TTFT, prefix hits
and evictions, rescale log, handoffs and transferred KV bytes equal the
engine's — and the reference simulator's, which runs the reference's
copies of the same policies."""
from __future__ import annotations

import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.core import profiles as JHW
from repro.core import simulator as JS
from repro.serving import workload as JW
from repro_torch.configs import registry
from repro_torch.core import profiles as HW
from repro_torch.core.scenarios import (run_cloud_disaggregated,
                                        run_cloud_trace)
from repro_torch.core.simulator import LLMSimulator, SimConfig
from repro_torch.models import model as MD
from repro_torch.serving import (ClusterConfig, ClusterEngine, EngineConfig,
                                 ServingEngine)
from repro_torch.serving.kv_cache import (kv_bytes_per_token,
                                          paged_resident_kv_bytes)
from repro_torch.serving.workload import make_named_trace, replay
from _torch_threads import one_thread  # noqa: F401

QUANTUM = 0.01
BS = 16
ARCH = "qwen1.5-0.5b"
MIXSHIFT_ECFG = dict(max_batch=4, max_seq_len=96, max_new_tokens=16,
                     kv_cache="paged", kv_block_size=16, kv_blocks=6,
                     eos_token=-1)
MIXSHIFT_CCFG = dict(n_prefill=1, n_decode=3, autoscale=True,
                     autoscale_interval=4, prefill_rate=2)
MIXSHIFT_OPTS = {"autoscale": True, "autoscale_interval": 4,
                 "prefill_rate": 2}
PREFIX_KEYS = ("prefix_hits", "prefix_lookups", "prefix_hit_tokens",
               "prefix_evictions")


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    return cfg, MD.init_params(cfg, seed=3, device="cpu")


def _engine(params, cfg, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("max_new_tokens", 16)
    return ServingEngine(params, cfg, EngineConfig(eos_token=-1, **kw),
                         device="cpu")


def _cluster(params, cfg, ecfg, **ccfg):
    with pytest.warns(UserWarning, match="round-robin"):
        return ClusterEngine(params, cfg, EngineConfig(**ecfg),
                             ClusterConfig(devices=("cpu",), **ccfg))


# (trace, seed, engine settings / cluster settings) of every replay
RUNS = {
    "overload-blocking": ("overload", 0, dict(scheduler="blocking")),
    "overload-slo": ("overload", 0, dict(scheduler="slo")),
    "overload-slo-paged": ("overload", 0, dict(scheduler="slo",
                                               kv_cache="paged")),
    "prefix-blocking": ("sharedprefix", 1, dict(
        scheduler="blocking", kv_cache="paged", kv_block_size=BS,
        kv_blocks=6, prefix_cache=True)),
    "prefix-slo": ("sharedprefix", 1, dict(
        scheduler="slo", kv_cache="paged", kv_block_size=BS, kv_blocks=6,
        prefix_cache=True)),
}


def _sim_kw(ecfg):
    """``serve(trace=)`` arguments for an engine's settings."""
    kw = dict(max_batch=4, max_seq_len=96, step_quantum_s=QUANTUM)
    for k in ("scheduler", "kv_cache", "kv_block_size", "kv_blocks",
              "prefix_cache"):
        if k in ecfg:
            kw[k] = ecfg[k]
    return kw


@pytest.fixture(scope="module")
def replays(setup):
    """name -> (trace, the engine's replay, the port mirror's result)."""
    cfg, params = setup
    out = {}
    for name, (trace, seed, ecfg) in RUNS.items():
        tr = make_named_trace(trace, vocab_size=cfg.vocab_size, seed=seed)
        rep = replay(_engine(params, cfg, **ecfg), tr,
                     step_quantum_s=QUANTUM)
        sim = LLMSimulator(cfg, HW.PIM_AI_SERVER, SimConfig())
        out[name] = (tr, rep, sim.serve(trace=tr, **_sim_kw(ecfg)))
    return out


@pytest.fixture(scope="module")
def cluster_replays(setup):
    """name -> (trace, the cluster, its replay, the mirror's result)."""
    cfg, params = setup
    out = {}
    tr = make_named_trace("mixshift", vocab_size=cfg.vocab_size, seed=0)
    clu = _cluster(params, cfg, MIXSHIFT_ECFG, **MIXSHIFT_CCFG)
    rep = replay(clu, tr, step_quantum_s=QUANTUM)
    sim = LLMSimulator(cfg, HW.PIM_AI_SERVER, SimConfig())
    out["mixshift"] = (tr, clu, rep, sim.serve(
        trace=tr, cluster=(1, 3), kv_cache="paged", kv_blocks=6,
        max_batch=4, max_seq_len=96, step_quantum_s=QUANTUM,
        cluster_opts=MIXSHIFT_OPTS))
    tr = make_named_trace("sharedprefix", vocab_size=cfg.vocab_size, seed=0)
    clu = _cluster(params, cfg, dict(
        scheduler="blocking", kv_cache="paged", kv_block_size=BS,
        kv_blocks=12, prefix_cache=True, eos_token=-1, max_batch=4,
        max_seq_len=96, max_new_tokens=16), n_prefill=2, n_decode=2)
    rep = replay(clu, tr, step_quantum_s=QUANTUM)
    out["prefix"] = (tr, clu, rep, sim.serve(
        trace=tr, cluster=(2, 2), kv_cache="paged", kv_block_size=BS,
        kv_blocks=12, prefix_cache=True, max_batch=4, max_seq_len=96,
        step_quantum_s=QUANTUM))
    return out


def _ttfts(requests) -> dict:
    return {rid: req.ttft_s for rid, req in requests.items()}


# ---------------------------------------------------------------------------
# tests/test_workload.py's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["overload-blocking", "overload-slo",
                                  "overload-slo-paged"])
def test_simulator_trace_mirror_matches_engine_schedule(replays, name):
    """The mirror instantiates the port's scheduler over the analytical
    slot mechanism: admission order, preemption log, step count, every
    request's virtual TTFT and token count equal the engine replay's,
    and the schedule comes out priced."""
    tr, rep, r = replays[name]
    assert r["admission_order"] == rep["admission_order"]
    assert r["preemption_log"] == rep["preemption_log"]
    assert r["steps"] == rep["steps"]
    assert r["decode_steps"] == rep["decode_steps"]
    assert _ttfts(r["requests"]) == _ttfts(rep["requests"])
    assert ({rid: len(o) for rid, o in rep["outputs"].items()}
            == {rid: len(q.output) for rid, q in r["requests"].items()})
    assert r["energy_j"] > 0 and r["energy_per_token_j"] > 0
    if "slo" in name:
        assert r["preemptions"] >= 1 and r["preempted_kv_bytes"] > 0
        assert (r["preempted_kv_bytes"]
                == rep["summary"]["preempted_kv_bytes"])


def test_simulator_cluster_trace_mirror_matches_rescale_schedule(
        cluster_replays):
    """The disaggregated mirror reproduces the cluster's autoscale
    decisions (both directions), handoffs, transferred KV bytes and the
    per-request schedule over the mixshift trace."""
    tr, clu, rep, r = cluster_replays["mixshift"]
    assert r["rescale_log"] == clu.rescale_log
    assert {d for _, d in r["rescale_log"]} == {"to_prefill", "to_decode"}
    assert r["handoffs"] == clu.handoffs >= len(tr.requests)
    assert r["migrations"] == clu.migrations
    assert r["kv_transfer_bytes"] == clu.kv_transfer_bytes > 0
    assert r["steps"] == rep["steps"]
    assert r["decode_steps"] == rep["decode_steps"]
    assert _ttfts(r["requests"]) == _ttfts(rep["requests"])
    assert r["energy_j"] > 0


def test_simulator_trace_mirror_heterogeneous_prefill(setup):
    """``prefill_sim`` prices prefill dispatches on different hardware:
    same schedule, more prefill energy on the hungrier profile."""
    cfg, _ = setup
    tr = make_named_trace("overload", vocab_size=cfg.vocab_size, seed=0)
    pim = LLMSimulator(cfg, HW.PIM_AI_SERVER, SimConfig())
    xpu = LLMSimulator(cfg, HW.DGX_H100, SimConfig())
    homo = pim.serve(trace=tr, scheduler="slo", max_batch=4, max_seq_len=96)
    het = pim.serve(trace=tr, scheduler="slo", max_batch=4, max_seq_len=96,
                    prefill_sim=xpu)
    assert het["admission_order"] == homo["admission_order"]
    assert het["steps"] == homo["steps"]
    assert het["decode"].energy_j == pytest.approx(homo["decode"].energy_j)
    assert het["encode"].energy_j != homo["encode"].energy_j


def test_run_cloud_trace_prices_all_three_systems():
    r = run_cloud_trace(trace="diurnal", seed=0)
    assert r["trace"]["name"] == "diurnal"
    n = len(r["trace"]["requests"])
    for system in ("dgx-h100", "pim-ai-engine", "disaggregated"):
        s = r[system]
        assert s["requests"] == n          # every system drains the trace
        assert s["qps_sustained"] > 0
        assert s["energy_per_token_j"] > 0
        assert s["tco_per_qps"] > 0
    # PIM's memory-bound decode wins energy/token over the trace
    assert r["ratios"]["energy_per_token"] > 1.0
    assert np.isfinite(r["ratios"]["tco_per_qps_disagg_vs_h100"])
    assert r["disaggregated"]["handoffs"] >= n


# ---------------------------------------------------------------------------
# tests/test_prefix_cache.py's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["prefix-blocking", "prefix-slo"])
def test_simulator_mirrors_engine_prefix_schedule(replays, name):
    """Same PrefixIndex, same arithmetic: admission order, preemptions,
    per-step schedule and the hit / eviction ledger under pool pressure
    equal the engine's."""
    _, rep, r = replays[name]
    s = rep["summary"]
    assert r["admission_order"] == rep["admission_order"]
    assert r["preemption_log"] == rep["preemption_log"]
    assert r["steps"] == rep["steps"]
    assert r["decode_steps"] == rep["decode_steps"]
    for k in PREFIX_KEYS:
        assert r[k] == s[k], k
    assert _ttfts(r["requests"]) == _ttfts(rep["requests"])
    assert s["prefix_hits"] >= 1 and s["prefix_evictions"] >= 1


def test_simulator_mirrors_cluster_prefix_routing(cluster_replays):
    _, clu, rep, r = cluster_replays["prefix"]
    s = rep["summary"]
    assert r["steps"] == rep["steps"]
    assert r["handoffs"] == clu.handoffs
    assert r["kv_transfer_bytes"] == clu.kv_transfer_bytes
    assert r["prefix_routed"] == s["prefix_routed"]
    for k in PREFIX_KEYS:
        assert r[k] == s[k], k
    assert _ttfts(r["requests"]) == _ttfts(rep["requests"])
    assert s["prefix_routed"] >= 1 and s["prefix_hits"] >= 1


def test_prefix_sweep_hit_rate_lowers_ttft_and_tco():
    rows = run_cloud_trace(prefix_sweep=(0, 48))["prefix_sweep"]
    assert [r["prefix_len"] for r in rows] == [0, 48]
    assert rows[0]["prefix_hit_rate"] == 0.0
    assert rows[1]["prefix_hit_rate"] > 0.3
    assert rows[1]["ttft_p99_s"] < rows[0]["ttft_p99_s"]
    assert rows[1]["tco_per_qps"] < rows[0]["tco_per_qps"]


# ---------------------------------------------------------------------------
# tests/test_cluster.py's and tests/test_kv_cache.py's cases
# ---------------------------------------------------------------------------

def test_simulator_cluster_serve_charges_transfer():
    cfg = registry.get_config(ARCH)
    sim = LLMSimulator(cfg, HW.PIM_AI_CHIP, SimConfig())
    n_ins = [12, 20, 8, 16]
    r = sim.serve(n_ins, 8, cluster=(1, 2))
    assert r["cluster"] == (1, 2)
    # one handoff per request: prompt positions x bytes/token
    assert r["kv_transfer_bytes"] == pytest.approx(
        sum(n_ins) * kv_bytes_per_token(cfg))
    assert r["kv_transfer_s"] > 0
    assert r["decode_dispatches"] == 2 * 8
    base = sim.serve(n_ins, 8)
    assert r["decode"].seconds <= base["decode"].seconds * (1 + 1e-9)


def test_simulator_cluster_requires_blocking():
    sim = LLMSimulator(registry.get_config(ARCH), HW.PIM_AI_CHIP,
                       SimConfig())
    with pytest.raises(ValueError, match="blocking"):
        sim.serve([8, 8], 4, cluster=(1, 2), scheduler="chunked")


def test_run_cloud_disaggregated_reports_tco_vs_both_baselines():
    r = run_cloud_disaggregated("llama2-70b", "gqa", n_in=64, n_out=8)
    for system in ("disaggregated", "dgx-h100", "pim-ai-4srv"):
        assert r["tco"][system]["tco_per_qps"] > 0
    for key in ("tco_per_qps_vs_h100", "tco_per_qps_vs_pim",
                "energy_per_query_vs_h100", "energy_per_query_vs_pim"):
        assert np.isfinite(r["ratios"][key])
    assert r["kv_transfer"]["bytes"] > 0
    assert r["kv_transfer"]["seconds"] > 0
    assert r["engines_per_xpu"] > 0
    assert r["prefill"]["profile"] == "dgx-h100"
    assert r["decode"]["profile"].startswith("pim-ai-engine")


def test_simulator_serve_reports_resident_kv():
    """The simulator consumes the engine's KV accounting."""
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    sim = LLMSimulator(cfg, HW.PIM_AI_CHIP, SimConfig())
    lens = [6, 11, 17, 33]
    contig = sim.serve(lens, 8, max_seq_len=96)
    paged = sim.serve(lens, 8, kv_cache="paged", kv_block_size=16,
                      max_seq_len=96)
    assert contig["resident_kv_bytes"] == contig["contiguous_kv_bytes"]
    assert paged["resident_kv_bytes"] < paged["contiguous_kv_bytes"]
    assert paged["resident_kv_bytes"] == paged_resident_kv_bytes(
        cfg, [min(n + 8 - 1, 96) for n in lens], 16)
    for r in (contig, paged):
        assert r["tokens_per_s"] > 0 and r["decode_dispatches"] == 8


# ---------------------------------------------------------------------------
# the port's schedule against the reference simulator's
# ---------------------------------------------------------------------------

SCHEDULE_KEYS = ("admission_order", "preemption_log", "steps",
                 "decode_steps", "tokens", "preemptions",
                 "preempted_kv_bytes", "prefills") + PREFIX_KEYS
CLUSTER_KEYS = ("rescale_log", "handoffs", "migrations",
                "kv_transfer_bytes", "migration_bytes", "prefix_routed",
                "n_prefill", "n_decode", "steps", "decode_steps", "tokens",
                "prefix_hits", "prefix_hit_tokens", "prefix_evictions")


@pytest.fixture(scope="module")
def jsim():
    cfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    return JS.LLMSimulator(cfg, JHW.PIM_AI_SERVER, JS.SimConfig())


@pytest.mark.parametrize("name", sorted(RUNS))
def test_schedule_equals_reference_simulator(replays, jsim, name):
    """The reference simulator on the same trace (its own copy, equal by
    construction: tests/test_torch_workload.py) gives the same schedule,
    virtual TTFTs and KV bytes."""
    trace, seed, ecfg = RUNS[name]
    _, _, r = replays[name]
    tr = JW.make_named_trace(trace, vocab_size=jsim.cfg.vocab_size,
                             seed=seed)
    want = jsim.serve(trace=tr, **_sim_kw(ecfg))
    for k in SCHEDULE_KEYS:
        assert r[k] == want[k], k
    assert _ttfts(r["requests"]) == _ttfts(want["requests"])


@pytest.mark.parametrize("name", ["mixshift", "prefix"])
def test_cluster_schedule_equals_reference_simulator(cluster_replays, jsim,
                                                     name):
    _, _, _, r = cluster_replays[name]
    if name == "mixshift":
        tr = JW.make_named_trace("mixshift", vocab_size=jsim.cfg.vocab_size,
                                 seed=0)
        want = jsim.serve(trace=tr, cluster=(1, 3), kv_cache="paged",
                          kv_blocks=6, max_batch=4, max_seq_len=96,
                          step_quantum_s=QUANTUM, cluster_opts=MIXSHIFT_OPTS)
    else:
        tr = JW.make_named_trace("sharedprefix",
                                 vocab_size=jsim.cfg.vocab_size, seed=0)
        want = jsim.serve(trace=tr, cluster=(2, 2), kv_cache="paged",
                          kv_block_size=BS, kv_blocks=12, prefix_cache=True,
                          max_batch=4, max_seq_len=96,
                          step_quantum_s=QUANTUM)
    for k in CLUSTER_KEYS:
        assert r[k] == want[k], k
    assert _ttfts(r["requests"]) == _ttfts(want["requests"])


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
@pytest.mark.parametrize("cluster", [None, (1, 2)])
def test_kv_accounting_equals_reference_simulator(jsim, kv, cluster):
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    sim = LLMSimulator(cfg, HW.PIM_AI_SERVER, SimConfig())
    kw = dict(kv_cache=kv, kv_block_size=16, max_seq_len=96,
              cluster=cluster)
    got = sim.serve([6, 11, 17, 33], 8, **kw)
    want = jsim.serve([6, 11, 17, 33], 8, **kw)
    for k in ("resident_kv_bytes", "contiguous_kv_bytes",
              "decode_dispatches", "kv_transfer_bytes"):
        assert got.get(k) == want.get(k), k
