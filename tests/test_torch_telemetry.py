"""The port's serving telemetry (qwen1.5-0.5b smoke config, float32, CPU):
the reference's telemetry tests (calibration aside) against the port's
module and engine; the metrics registry's snapshot and Prometheus text
equal the reference's for the same operations; a replay's virtual-clock
span schedule equals the JAX engine's; every dispatch joins a profiler
sample for every KV backend × scheduler; disabled telemetry is bitwise."""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import Telemetry as JTelemetry
from repro.serving import telemetry as JT
from repro.serving import workload as JW
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.serving import (EngineConfig, ServingEngine, Telemetry,
                                 join_coverage, merge_snapshots,
                                 validate_trace_events)
from repro_torch.serving import workload as W
from repro_torch.serving.telemetry import (MetricsRegistry, SpanTracer,
                                           bucket_index, bucket_upper)
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(9), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _tiny_trace(mod, cfg, seed=0):
    tenants = (mod.TenantSpec("t", rate_rps=20.0, prompt_len=(6, 10),
                              new_tokens=(3, 3), priority=0,
                              slo=mod.SLO(ttft_s=float("inf"))),)
    return mod.make_trace(tenants, 0.3, vocab_size=cfg.vocab_size, seed=seed)


def _drive(tp, cfg, tel, seed=0, label="engine", **ecfg_kw):
    kw = dict(max_batch=2, max_seq_len=64, max_new_tokens=4)
    kw.update(ecfg_kw)
    eng = ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu",
                        telemetry=tel, telemetry_label=label)
    rng = np.random.default_rng(seed)
    for n in (6, 11, 17):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n))
    eng.run()
    return eng


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

def test_virtual_clock_spans_deterministic(setup):
    _, _, cfg, tp = setup
    tr = _tiny_trace(W, cfg)

    def once():
        tel = Telemetry()
        eng = ServingEngine(tp, cfg, EngineConfig(
            max_batch=2, max_seq_len=64, max_new_tokens=4, eos_token=-1),
            device="cpu", telemetry=tel)
        W.replay(eng, tr, step_quantum_s=0.01)
        return tel.tracer.virtual_schedule()

    a, b = once(), once()
    assert a and a == b
    assert all(v0 is not None for (_, _, _, _, _, v0, _) in a)
    assert [s[0] for s in a] == sorted(s[0] for s in a)


@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
@pytest.mark.parametrize("scheduler", ["blocking", "chunked", "slo"])
def test_virtual_span_schedule_equals_jax_engine(setup, scheduler, kv_cache):
    """One replay of the overload trace through both engines records the
    same spans — names, categories, nesting depths, start order and
    virtual stamps — dispatches, splices, preemptions and all."""
    jcfg, jp, cfg, tp = setup
    kw = dict(max_batch=4, max_seq_len=96, max_new_tokens=16,
              scheduler=scheduler, kv_cache=kv_cache, eos_token=-1,
              chunk_tokens=16)
    jtel, tel = JTelemetry(), Telemetry()
    JW.replay(JServingEngine(jp, jcfg, JEngineConfig(**kw), telemetry=jtel),
              JW.make_named_trace("overload", vocab_size=256, seed=0))
    W.replay(ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu",
                           telemetry=tel),
             W.make_named_trace("overload", vocab_size=256, seed=0))
    got, want = tel.tracer.virtual_schedule(), jtel.tracer.virtual_schedule()
    assert got == want
    names = {s[1] for s in got}
    assert {"step", "admit", "decode", "sample", "kv_splice", "kv_commit",
            "retire", "chunk_" + kv_cache if scheduler == "chunked"
            else "prefill"} <= names
    if scheduler == "slo":
        assert {"preempt", "kv_export", "kv_import"} <= names
    # the metric series are the reference's too (values aside: walls)
    assert (set(tel.metrics.snapshot())
            == set(jtel.metrics.snapshot()))


def test_span_nesting_depths(setup):
    _, _, cfg, tp = setup
    tel = Telemetry()
    _drive(tp, cfg, tel, seed=1)
    by_name = {}
    for s in tel.tracer.spans:
        by_name.setdefault(s.name, []).append(s)
    assert all(s.depth == 0 for s in by_name["step"])
    for name in ("admit", "prefill", "decode", "kv_commit", "sample"):
        assert name in by_name, f"no {name!r} spans recorded"
        assert all(s.depth >= 1 for s in by_name[name]), name
    assert all(s.wall_end_s >= s.wall_start_s for s in tel.tracer.spans)


def test_perfetto_export_schema_valid(setup):
    _, _, cfg, tp = setup
    tel = Telemetry()
    _drive(tp, cfg, tel, seed=2)
    for clock in ("wall", "virtual"):
        obj = tel.tracer.trace_events(clock=clock)
        assert validate_trace_events(obj) == []
        json.dumps(obj)
    names = {e["name"] for e in tel.tracer.trace_events()["traceEvents"]
             if e.get("ph") == "X"}
    assert {"step", "prefill", "decode"} <= names
    with pytest.raises(ValueError, match="clock"):
        tel.tracer.trace_events(clock="lamport")


def test_validate_trace_events_catches_breakage():
    assert validate_trace_events([]) != []
    assert validate_trace_events({"traceEvents": [{"ph": "X"}]}) != []
    bad = {"traceEvents": [{"name": "x", "ph": "X", "pid": 0, "tid": 0,
                            "ts": float("nan"), "dur": 1.0}]}
    assert any("ts" in p for p in validate_trace_events(bad))
    for obj in ([], {"traceEvents": [{"ph": "X"}]}, bad,
                {"traceEvents": [{"name": "m", "ph": "M", "pid": 0,
                                  "tid": 0}, {"name": "q", "ph": "Q",
                                              "pid": 0, "tid": 0}]}):
        assert validate_trace_events(obj) == JT.validate_trace_events(obj)


def test_slowest_spans(setup):
    _, _, cfg, tp = setup
    tel = Telemetry()
    _drive(tp, cfg, tel, seed=3)
    top = tel.tracer.slowest(5)
    assert len(top) == 5
    durs = [s.wall_dur_s for s in top]
    assert durs == sorted(durs, reverse=True)
    assert durs[0] == max(s.wall_dur_s for s in tel.tracer.spans)


def test_span_tracer_without_engine():
    tr = SpanTracer()
    with tr.span("outer", cat="test", tid="t"):
        with tr.span("inner", cat="test", tid="t", detail=1):
            pass
    outer = next(s for s in tr.spans if s.name == "outer")
    inner = next(s for s in tr.spans if s.name == "inner")
    assert outer.depth == 0 and inner.depth == 1
    assert inner.index > outer.index
    assert inner.labels == {"detail": 1}
    assert outer.wall_dur_s >= inner.wall_dur_s


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_histogram_merge_property():
    from hypothesis import given, settings, strategies as st

    vals = st.floats(min_value=0.0, max_value=1e6, allow_nan=False,
                     allow_infinity=False)

    @given(xs=st.lists(vals, max_size=40), ys=st.lists(vals, max_size=40))
    @settings(max_examples=60, deadline=None)
    def prop(xs, ys):
        ra, rb, rall = (MetricsRegistry() for _ in range(3))
        for v in xs:
            ra.histogram("h", k="1").observe(v)
            rall.histogram("h", k="1").observe(v)
        for v in ys:
            rb.histogram("h", k="1").observe(v)
            rall.histogram("h", k="1").observe(v)
        merged = merge_snapshots(ra.snapshot(), rb.snapshot())
        whole = rall.snapshot()
        if not xs and not ys:
            assert merged == whole == {}
            return
        mh, wh = merged['h{k="1"}'], whole['h{k="1"}']
        assert mh["counts"] == wh["counts"]
        assert mh["count"] == wh["count"]
        assert mh["sum"] == pytest.approx(wh["sum"])
        assert mh["min"] == wh["min"] and mh["max"] == wh["max"]

    prop()


def test_bucket_index_boundaries():
    assert bucket_index(0.0) == 0
    for i in range(1, 20):
        edge = bucket_upper(i - 1)
        assert bucket_index(edge) == i
        assert bucket_index(edge * 0.999) == i - 1
        assert bucket_index(edge) == JT.bucket_index(edge)
    with pytest.raises(ValueError):
        bucket_index(-1e-9)
    with pytest.raises(ValueError):
        bucket_index(float("nan"))


def test_registry_counters_gauges_delta_and_prometheus():
    reg = MetricsRegistry()
    reg.counter("reqs", kind="a").inc()
    reg.counter("reqs", kind="a").inc(2)
    reg.gauge("live").set(3.0)
    reg.histogram("lat").observe(0.5)
    prev = reg.snapshot()
    reg.counter("reqs", kind="a").inc(4)
    reg.gauge("live").set(1.0)
    d = reg.delta(prev)
    assert d['reqs{kind="a"}']["value"] == 4
    assert d["live"]["value"] == 1.0
    text = reg.to_prometheus()
    assert "# TYPE reqs counter" in text
    assert 'reqs{kind="a"} 7' in text
    assert 'le="+Inf"' in text
    assert reg.validate() == []
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("reqs")
    with pytest.raises(ValueError):
        reg.counter("reqs", kind="a").inc(-1)


def test_snapshot_delta_and_prometheus_equal_reference():
    """The same operations on the port's registry and the reference's
    give equal snapshots, deltas, merges, Prometheus text and
    quantiles."""
    rng = np.random.default_rng(0)
    samples = np.concatenate([rng.exponential(1e-3, 50), [0.0, 1e-7, 3.5]])
    regs = (MetricsRegistry(), JT.MetricsRegistry())
    prevs = []
    for reg in regs:
        for i, v in enumerate(samples):
            reg.histogram("lat_s", kind=("decode", "prefill")[i % 2],
                          engine="e").observe(float(v))
            reg.counter("reqs_total", tenant=f"t{i % 3}").inc(i % 4)
        reg.gauge("live").set(3.0)
        prevs.append(reg.snapshot())
        reg.counter("reqs_total", tenant="t0").inc(5)
        reg.histogram("lat_s", kind="decode", engine="e").observe(0.25)
        reg.gauge("live").dec(2)
    assert prevs[0] == prevs[1]
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].delta(prevs[0]) == regs[1].delta(prevs[1])
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert merge_snapshots(prevs[0], regs[0].snapshot()) == \
        JT.merge_snapshots(prevs[1], regs[1].snapshot())
    h = [r.histogram("lat_s", kind="decode", engine="e") for r in regs]
    assert [h[0].quantile(q) for q in (0.5, 0.9, 0.99)] == \
        [h[1].quantile(q) for q in (0.5, 0.9, 0.99)]


# ---------------------------------------------------------------------------
# dispatch profiler: every dispatch joined
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_cache,scheduler", [
    ("contiguous", "blocking"), ("paged", "blocking"),
    ("contiguous", "chunked"), ("paged", "chunked"),
    ("contiguous", "speculative"), ("paged", "speculative"),
    ("contiguous", "slo"), ("paged", "slo"),
])
def test_profiler_joins_every_dispatch(setup, kv_cache, scheduler):
    """Every dispatch_log entry gets a measured wall-time sample, every
    logged kind a span, and every entry a shape/dtype spec per
    operand."""
    _, _, cfg, tp = setup
    tel = Telemetry()
    eng = _drive(tp, cfg, tel, seed=4, label=f"{kv_cache}-{scheduler}",
                 kv_cache=kv_cache, scheduler=scheduler, chunk_tokens=16,
                 spec_gamma=2)
    joined, total = join_coverage(eng, tel)
    assert total > 0 and joined == total
    logged = {e["kind"] for e in eng.dispatch_log}
    spanned = {s.name for s in tel.tracer.spans if s.cat == "dispatch"}
    assert logged <= spanned
    assert all(e["step"] >= 1 for e in eng.dispatch_log)
    assert eng.summary()["telemetry"]["dispatches"] == total
    first = eng.dispatch_log[0]["spec"]
    assert first[0]["tokens"].shape[0] == 1          # a batch-1 admission
    assert all(s.wall_dur_s >= 0 for s in tel.tracer.spans)


# ---------------------------------------------------------------------------
# disabled mode
# ---------------------------------------------------------------------------

def test_disabled_telemetry_records_nothing_and_is_bitwise(setup):
    _, _, cfg, tp = setup
    off = Telemetry(enabled=False)
    eng_off = _drive(tp, cfg, off, seed=6, kv_cache="paged")
    assert off.tracer.spans == []
    assert off.metrics.snapshot() == {}
    assert off.profiler.samples == []
    assert off.engine_aggregates("engine") == {
        "enabled": False, "spans": 0, "span_wall_s": 0.0,
        "dispatches": 0, "dispatch_wall_s": 0.0}
    on = Telemetry()
    eng_on = _drive(tp, cfg, on, seed=6, kv_cache="paged")
    eng_none = _drive(tp, cfg, None, seed=6, kv_cache="paged")
    outs = [{r.rid: r.output for r in e.finished}
            for e in (eng_off, eng_on, eng_none)]
    assert outs[0] == outs[1] == outs[2]
    assert len(on.tracer.spans) > 0
    # the audit log is written either way
    assert len(eng_off.dispatch_log) == len(eng_on.dispatch_log) > 0


def test_summary_folds_in_telemetry_aggregates(setup):
    _, _, cfg, tp = setup
    tel = Telemetry()
    eng = _drive(tp, cfg, tel, seed=7, label="agg")
    s = eng.summary()["telemetry"]
    assert s["enabled"] and s["spans"] > 0
    assert s["dispatches"] == len(eng.dispatch_log)
    assert s["dispatch_wall_s"] > 0
    assert s["span_wall_s"] <= sum(
        sp.wall_dur_s for sp in tel.tracer.spans if sp.tid == "agg") + 1e-9
    requests = tel.metrics.counter("engine_requests_total", engine="agg",
                                   tenant="default", priority="0")
    assert requests.value == 3


def test_shared_hub_separates_engine_tracks(setup):
    _, _, cfg, tp = setup
    tel = Telemetry()
    a = _drive(tp, cfg, tel, seed=8, label="a")
    b = _drive(tp, cfg, tel, seed=9, label="b", kv_cache="paged")
    assert join_coverage(a, tel) == (len(a.dispatch_log),
                                     len(a.dispatch_log))
    assert join_coverage(b, tel) == (len(b.dispatch_log),
                                     len(b.dispatch_log))
    assert {"a", "b"} <= {s.tid for s in tel.tracer.spans}
