"""The port's serving engine against the JAX engine on bridged weights for
the MoE and vlm families (deepseek-moe-16b, internvl2-26b, dbrx-132b
smoke configs, float32, CPU): blocking streams on the contiguous cache
(``test_torch_families_engine_paged.py``: on the paged one), and the MoE
speculative stream and dbrx's chunked stream — each equal to the JAX
engine's stream of the same scheduler, not to its blocking one (a
verify dispatch or a chunk can drop routed slots a prefill does not).
``test_torch_families_matrix.py`` holds the rest inside the port."""
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

LENS = (5, 16, 21, 40)   # straddles bucket, chunk, block and gamma edges
KW = dict(max_batch=3, max_seq_len=64, max_new_tokens=5)
SPEC = dict(scheduler="speculative", spec_gamma=3, spec_draft_layers=1)


def bridged(arch, seed):
    """(jcfg, jp, cfg, tp, prompts): the reference's float32 smoke
    weights from ``PRNGKey(seed)``, bridged, and seeded prompts."""
    jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
    cfg = registry.get_smoke_config(arch).replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in LENS]
    return jcfg, jp, cfg, tp, prompts


def streams(engine, prompts):
    for p in prompts:
        engine.submit(p)
    engine.run()
    assert engine.decode_dispatches == engine.decode_steps
    return {r.rid: r.output for r in engine.finished}


ARCHS = ("deepseek-moe-16b", "internvl2-26b", "dbrx-132b")


def check_blocking_streams(arch, kv_cache):
    jcfg, jp, cfg, tp, prompts = bridged(arch, 3)
    want = streams(JServingEngine(jp, jcfg, JEngineConfig(
        kv_cache=kv_cache, **KW)), prompts)
    eng = ServingEngine(tp, cfg, EngineConfig(kv_cache=kv_cache, **KW),
                        device="cpu")
    assert streams(eng, prompts) == want
    assert eng.summary()["prefills"] == len(LENS)
    assert eng.kv.name == kv_cache


@pytest.mark.parametrize("arch", ARCHS)
def test_blocking_streams_match_reference(arch):
    check_blocking_streams(arch, "contiguous")


def test_moe_speculative_stream_is_the_references_speculative_stream():
    """The reference's own speculative deepseek-moe stream differs from
    its blocking one (its verify dispatch of B * (gamma + 1) tokens can
    drop a routed slot at capacity factor 1.25); the port's speculative
    stream is that stream, token for token."""
    jcfg, jp, cfg, tp, prompts = bridged("deepseek-moe-16b", 7)
    want = streams(JServingEngine(jp, jcfg, JEngineConfig(**SPEC, **KW)),
                   prompts)
    blocking = streams(JServingEngine(jp, jcfg, JEngineConfig(**KW)),
                       prompts)
    assert want != blocking   # the reference's known divergence
    eng = ServingEngine(tp, cfg, EngineConfig(**SPEC, **KW), device="cpu")
    assert streams(eng, prompts) == want
    assert eng.verify_dispatches == eng.decode_dispatches


def test_dbrx_chunked_stream_is_the_references_chunked_stream():
    """At capacity factor 1.25 the reference's dbrx chunked stream
    differs from its blocking one (its 63-token prefill buckets and its
    16-token chunks drop different routed slots); the port's chunked
    stream is that stream, token for token."""
    jcfg, jp, cfg, tp, prompts = bridged("dbrx-132b", 7)
    chunked = dict(scheduler="chunked", chunk_tokens=16)
    want = streams(JServingEngine(jp, jcfg, JEngineConfig(**chunked, **KW)),
                   prompts)
    blocking = streams(JServingEngine(jp, jcfg, JEngineConfig(**KW)),
                       prompts)
    assert want != blocking   # the reference's own divergence
    eng = ServingEngine(tp, cfg, EngineConfig(**chunked, **KW), device="cpu")
    assert streams(eng, prompts) == want
