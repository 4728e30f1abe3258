"""Measured-against-predicted dispatch calibration
(``repro_torch.serving.telemetry.dispatch_calibration``): the port's and
the JAX engines on the same short run with telemetry on (qwen1.5-0.5b
smoke config, float32, CPU, bridged weights). For every dispatch kind
the port's table has one sample per dispatch of that kind, FLOPs and
bytes equal to the pricer's totals for those dispatches, and a finite
measured / predicted ratio; it keys the same kinds and counts as the
reference's table, and its text has the reference's columns."""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import Telemetry as JTelemetry
from repro.serving import telemetry as JT
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.core import costmodel as CM
from repro_torch.core import profiles as HW
from repro_torch.core import trace as T
from repro_torch.serving import EngineConfig, ServingEngine, Telemetry
from repro_torch.serving import telemetry as TT
from _torch_threads import one_thread  # noqa: F401

ARCH = "qwen1.5-0.5b"
RUNS = {"paged_blocking": dict(kv_cache="paged", kv_block_size=8),
        "speculative": dict(scheduler="speculative", spec_gamma=2)}


def _drive(eng, vocab):
    rng = np.random.default_rng(0)
    for n in (6, 11, 17):
        eng.submit(rng.integers(0, vocab, size=n).astype(np.int32))
    eng.run()
    return eng


@pytest.fixture(scope="module")
def runs():
    jcfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(4), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    out = {}
    for name, ekw in RUNS.items():
        kw = dict(max_batch=2, max_seq_len=64, max_new_tokens=4,
                  eos_token=-1, **ekw)
        jtel, tel = JTelemetry(), Telemetry()
        jeng = _drive(JServingEngine(jp, jcfg, JEngineConfig(**kw),
                                     telemetry=jtel), cfg.vocab_size)
        eng = _drive(ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu",
                                   telemetry=tel), cfg.vocab_size)
        out[name] = (jeng, jtel, eng, tel)
    return out


def _pricer_totals(eng, entry, pricers):
    """The pricer's op stream for one logged dispatch: the bucketed
    prefill at the entry's length, decode and verify at the engine's
    capacity (the linear fit read at it), the draft's through a pricer
    of the draft model."""
    kind = entry["kind"]
    draft = kind.startswith("draft_")
    cfg = eng.draft_cfg if draft else eng.cfg
    pricer = pricers.setdefault(draft, CM.DispatchPricer(cfg))
    kind = kind.removeprefix("draft_")
    toks = entry["spec"][0]
    cap = eng.ecfg.max_seq_len
    kv = "paged" if (eng.kv.name == "paged" and not draft) else "contiguous"
    if kind == "prefill":
        ops = pricer.prefill_ops(1, toks["tokens"].shape[1])
    elif kind == "decode":
        ops = [o.at(cap) for o in pricer.decode_ops_linear(
            toks.shape[0], cap, ragged=True, kv_cache=kv,
            kv_block_size=eng.ecfg.kv_block_size)]
    else:
        ops = [o.at(cap) for o in pricer.verify_ops_linear(
            toks.shape[0], cap, toks.shape[1] - 1, kv_cache=kv)]
    return T.totals(ops)


@pytest.mark.parametrize("run", list(RUNS))
def test_calibration_joins_every_sample_to_the_pricer(runs, run):
    _, _, eng, tel = runs[run]
    profile = HW.DGX_H100.scaled(1, "h100")
    table = TT.dispatch_calibration(eng, tel, profile)
    samples = {}
    for s in tel.profiler.samples:
        samples.setdefault(s.kind, []).append(s)
    assert set(table) == set(samples) == {e["kind"] for e in
                                          eng.dispatch_log}
    pricers: dict = {}
    for kind, row in table.items():
        assert row["n"] == len(samples[kind])
        tots = [_pricer_totals(eng, eng.dispatch_log[s.index], pricers)
                for s in samples[kind]]
        assert row["flops"] == pytest.approx(sum(t.flops for t in tots),
                                             rel=1e-9)
        assert row["bytes"] == pytest.approx(sum(t.bytes for t in tots),
                                             rel=1e-9)
        assert row["wall_s"] == pytest.approx(
            sum(s.wall_s for s in samples[kind]))
        pred = sum(max(t.flops / profile.ops_per_s,
                       t.bytes / (profile.mem_bw_gbs * 1e9)) for t in tots)
        assert row["predicted_s"] == pytest.approx(pred, rel=1e-9)
        assert math.isfinite(row["model_error_ratio"])
        assert row["model_error_ratio"] > 0


@pytest.mark.parametrize("run", list(RUNS))
def test_calibration_matches_the_reference_table_shape(runs, run):
    jeng, jtel, eng, tel = runs[run]
    got = TT.dispatch_calibration(eng, tel)
    want = JT.dispatch_calibration(jeng, jtel)
    assert {k: r["n"] for k, r in got.items()} == {
        k: r["n"] for k, r in want.items()}
    for kind in got:
        assert got[kind].keys() == want[kind].keys()
    text, jtext = TT.format_calibration(got), JT.format_calibration(want)
    assert text.splitlines()[:2] == jtext.splitlines()[:2]
    assert [ln.split()[:2] for ln in text.splitlines()[2:]] == [
        ln.split()[:2] for ln in jtext.splitlines()[2:]]
    assert (TT.HOST_REF_OPS_PER_S, TT.HOST_REF_BYTES_PER_S) == (
        JT.HOST_REF_OPS_PER_S, JT.HOST_REF_BYTES_PER_S)


def test_disabled_telemetry_calibrates_nothing(runs):
    _, _, eng, _ = runs["paged_blocking"]
    assert TT.dispatch_calibration(eng, Telemetry(enabled=False)) == {}
