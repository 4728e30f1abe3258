"""Port chunked prefill: chunked == blocking greedy streams inside the
port, on both KV backends, and equal to the JAX engine's chunked streams
(qwen1.5-0.5b smoke config, float32, CPU)."""
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
from _torch_threads import one_thread  # noqa: F401

KW = dict(max_batch=3, max_seq_len=64, max_new_tokens=6)
LENS, BUDGETS = (5, 40, 17, 30, 9), (6, 9, 1, 7, 5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in LENS]
    blocking, _ = _serve(ServingEngine(tp, cfg, EngineConfig(**KW),
                                       device="cpu"), prompts)
    return jcfg, jp, cfg, tp, prompts, blocking


def _serve(engine, prompts):
    for p, n in zip(prompts, BUDGETS):
        engine.submit(p, max_new_tokens=n)
    engine.run()
    return {r.rid: r.output for r in engine.finished}, engine.summary()


@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
def test_chunked_matches_blocking_and_reference(setup, kv_cache):
    """16-token chunks: a 40-token prompt streams in over 3 chunks while
    other slots decode; one request retires on its first token."""
    jcfg, jp, cfg, tp, prompts, blocking = setup
    kw = dict(KW, scheduler="chunked", chunk_tokens=16, kv_cache=kv_cache)
    want, jsum = _serve(JServingEngine(jp, jcfg, JEngineConfig(**kw)),
                        prompts)
    eng = ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    got, s = _serve(eng, prompts)
    assert got == want == blocking
    assert s["scheduler"] == "chunked"
    assert s["decode_dispatches"] == s["decode_steps"] == jsum["decode_steps"]
    assert (s["prefill_chunk_dispatches"] == jsum["prefill_chunk_dispatches"]
            == sum(-(-n // 16) for n in LENS))
    assert {r.rid: r.prefill_chunks for r in eng.finished}[1] == 3
    assert s["prefills"] == 0


def test_chunked_config_validation():
    with pytest.raises(ValueError, match="multiple"):
        EngineConfig(scheduler="chunked", chunk_tokens=24)
    with pytest.raises(ValueError, match="chunk_tokens"):
        EngineConfig(scheduler="chunked", chunk_tokens=0)
    with pytest.raises(ValueError, match="unknown scheduler"):
        EngineConfig(scheduler="fifo")
    EngineConfig(scheduler="chunked", chunk_tokens=24, prefill_bucket_min=0)
