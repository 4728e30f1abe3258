"""The reference's three bitwise serving matrices, held inside the port
for the MoE and vlm families (deepseek-moe-16b, internvl2-26b, dbrx-132b
smoke configs on bridged float32 weights, CPU): paged == contiguous
under every scheduler, chunked == blocking and speculative == blocking
on both backends.

Speculative == blocking holds for MoE only where no dispatch drops a
routed slot. At the config's capacity factor (1.25) a verify dispatch of
B * (gamma + 1) tokens can drop one (12 tokens: capacity 8 for 24 slots
on 4 experts) while a decode dispatch of B <= 8 rows never does — the
reference's own stream differs there, and so does the port's, on the
same tokens (``test_torch_families_engine.py``). At capacity factor
E / k nothing is ever dropped and the streams are equal."""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import pytest

from repro_torch.serving import EngineConfig, ServingEngine
from test_torch_families_engine import KW, SPEC, bridged, streams

ARCHS = ("deepseek-moe-16b", "internvl2-26b", "dbrx-132b")
CHUNKED = dict(scheduler="chunked", chunk_tokens=16)
SCHEDULERS = {"blocking": {}, "chunked": CHUNKED, "speculative": SPEC}


@functools.lru_cache(maxsize=None)
def _weights(arch, seed):
    _, _, cfg, tp, prompts = bridged(arch, seed)
    return cfg, tp, prompts


def _run(arch, seed=7, cf=None, **kw):
    cfg, tp, prompts = _weights(arch, seed)
    if cf is not None:
        cfg = cfg.replace(moe_capacity_factor=cf)
    eng = ServingEngine(tp, cfg, EngineConfig(**kw, **KW), device="cpu")
    return eng, streams(eng, prompts)


@pytest.mark.parametrize("sched", list(SCHEDULERS))
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_matches_contiguous(arch, sched):
    """The same dispatch shapes on both layouts: equal at any capacity
    factor, drops included."""
    _, want = _run(arch, **SCHEDULERS[sched])
    eng, got = _run(arch, kv_cache="paged", **SCHEDULERS[sched])
    assert got == want
    s = eng.summary()
    assert s["peak_resident_kv_bytes"] - s["draft_kv_bytes"] < \
        s["contiguous_kv_bytes"]


def _dropless(cfg):
    return cfg.n_experts / cfg.moe_top_k if cfg.is_moe else None


@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_matches_blocking(arch, kv_cache):
    """deepseek-moe and internvl2 at their configs, as in the reference's
    matrix; dbrx at E / k — at 1.25 its blocking prefills and its chunks
    drop different routed slots (a 63-token bucket against 16-token
    chunks), and the reference's chunked stream differs from its
    blocking one too (``test_torch_families_engine.py``)."""
    cf = _dropless(_weights(arch, 7)[0]) if arch == "dbrx-132b" else None
    _, want = _run(arch, cf=cf, kv_cache=kv_cache)
    eng, got = _run(arch, cf=cf, kv_cache=kv_cache, **CHUNKED)
    assert got == want
    # the first chunk of a vlm prompt carries its image prefix: a
    # 40-token prompt after 8 image positions still takes 3 chunks
    assert eng.prefill_chunk_dispatches == sum(-(-n // 16)
                                               for n in (5, 16, 21, 40))


@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_matches_blocking(arch, kv_cache):
    """vlm at its config; MoE at capacity factor E / k (dropless)."""
    cf = _dropless(_weights(arch, 7)[0])
    _, want = _run(arch, cf=cf, kv_cache=kv_cache)
    eng, got = _run(arch, cf=cf, kv_cache=kv_cache, **SPEC)
    assert got == want
    assert eng.summary()["dispatches_per_step"] == 1.0


@pytest.mark.xfail(strict=True, reason=(
    "reference semantics: at moe_capacity_factor 1.25 a verify dispatch "
    "of B * (gamma + 1) tokens drops routed slots past an expert's "
    "capacity (12 tokens: capacity 8 for 24 slots) that the blocking "
    "stream's decode dispatches (B <= 8 rows) never drop, so the "
    "speculative stream differs from blocking — in the JAX engine too"))
@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
def test_moe_speculative_matches_blocking_at_config_capacity(kv_cache):
    _, want = _run("deepseek-moe-16b", kv_cache=kv_cache)
    _, got = _run("deepseek-moe-16b", kv_cache=kv_cache, **SPEC)
    assert got == want


def _counting_drops():
    """``chip_smoke.counting_drops``: the one drop counter, a wrapper
    around the port's ``moe`` functions outside the package."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.counting_drops()


def test_moe_drops_come_from_the_verify_dispatch():
    """Count dropped routed slots per dispatch kind of a speculative
    run: at capacity factor 1.25 verify dispatches drop and decode ones
    (target or draft, B <= 8 rows) never do; at E / k nothing drops."""
    with _counting_drops() as drops:
        _run("deepseek-moe-16b", **SPEC)
    n = {k: int(sum(v)) for k, v in drops.items()}
    assert n.get("verify", 0) > 0
    assert n.get("decode", 0) == n.get("draft_decode", 0) == 0
    with _counting_drops() as drops:
        _run("deepseek-moe-16b", cf=2.0, **SPEC)
    assert sum(int(sum(v)) for v in drops.values()) == 0
    assert "verify" in drops
