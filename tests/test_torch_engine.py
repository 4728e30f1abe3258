"""Port serving engine against the JAX engine on the contiguous cache
(qwen1.5-0.5b smoke config, float32, CPU): equal greedy streams and one
decode dispatch per step."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.serving import EngineConfig, ServingEngine


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _serve(engine, prompts, budgets):
    for p, n in zip(prompts, budgets):
        engine.submit(p, max_new_tokens=n)
    engine.run()
    return {r.rid: r.output for r in engine.finished}, engine.summary()


@pytest.mark.parametrize("case,lens,budgets,slots", [
    # ragged prompts (several prefill buckets), one admit-time retirement
    ("ragged", (5, 12, 17, 30), (6, 6, 1, 6), 4),
    # more requests than slots: slots are recycled mid-run
    ("oversubscribed", (8, 3, 11, 8, 20, 6, 9), (4, 5, 3, 4, 2, 4, 3), 2),
])
def test_engine_streams_match_reference(setup, case, lens, budgets, slots):
    jcfg, jp, cfg, tp = setup
    rng = np.random.default_rng(len(lens))
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    kw = dict(max_batch=slots, max_seq_len=48, max_new_tokens=6)
    want, jsum = _serve(JServingEngine(jp, jcfg, JEngineConfig(**kw)),
                        prompts, budgets)
    got, s = _serve(ServingEngine(tp, cfg, EngineConfig(**kw),
                                  device="cpu"), prompts, budgets)
    assert got == want
    assert [len(got[i]) for i in range(len(lens))] == list(budgets)
    assert s["decode_dispatches"] == s["decode_steps"] == jsum["decode_steps"]
    assert s["prefills"] == jsum["prefills"] == len(lens)


def test_engine_config_and_slices(setup):
    _, _, cfg, tp = setup
    with pytest.raises(ValueError, match="max_batch"):
        EngineConfig(max_batch=0)
    # the SLO policy and prefix caching are accepted as in the
    # reference (the contiguous backend ignores prefix_cache) ...
    eng = ServingEngine(tp, cfg, EngineConfig(scheduler="slo"), device="cpu")
    assert eng.scheduler.name == "slo"
    eng = ServingEngine(tp, cfg, EngineConfig(prefix_cache=True),
                        device="cpu")
    assert not eng._prefix_on
    eng = ServingEngine(tp, cfg, EngineConfig(prefix_cache=True,
                                              kv_cache="paged"),
                        device="cpu")
    assert eng._prefix_on and eng.kv.prefix is not None
    # ... what this slice of the port still leaves to later ones raises
    ssm = registry.get_smoke_config("xlstm-350m")
    with pytest.raises(NotImplementedError, match="later slice"):
        ServingEngine(tp, ssm, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="unknown kv_cache"):
        ServingEngine(tp, cfg, EngineConfig(kv_cache="ring"), device="cpu")
    with pytest.raises(ValueError, match="engine runs on"):
        ServingEngine(tp, cfg, EngineConfig(), device="meta")
    eng = ServingEngine(tp, cfg, EngineConfig(max_seq_len=16), device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit([])
    # a prompt past the capacity is truncated (with a warning) and, with
    # no room left to decode, retires at admission with one token
    with pytest.warns(UserWarning, match="truncated"):
        eng.submit(np.arange(20) % cfg.vocab_size)
        eng.run()
    (req,) = eng.finished
    assert req.truncated_from == 20 and len(req.output) == 1
    assert eng.summary()["truncated"] == 1
