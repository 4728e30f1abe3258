"""Port speculative decoding: the self-draft proposes, one verify
dispatch per step checks every slot's window through the prefill-over-
cache attention. speculative == blocking greedy streams inside the
port, on both KV backends, and equal to the JAX engine's speculative
streams (qwen1.5-0.5b smoke config, float32, CPU)."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

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
def test_speculative_matches_blocking_and_reference(setup, kv_cache):
    jcfg, jp, cfg, tp, prompts, blocking = setup
    kw = dict(KW, scheduler="speculative", spec_gamma=3, kv_cache=kv_cache)
    want, jsum = _serve(JServingEngine(jp, jcfg, JEngineConfig(**kw)),
                        prompts)
    eng = ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    got, s = _serve(eng, prompts)
    assert got == want == blocking
    assert s["decode_dispatches"] == s["decode_steps"] == s[
        "verify_dispatches"] == jsum["decode_steps"]
    assert s["draft_dispatches"] == jsum["draft_dispatches"]
    assert s["spec_committed"] == sum(len(o) - 1 for o in got.values())
    for r in eng.finished:
        assert sum(r.spec_accepted) == len(r.output) - 1
    assert s["accepted_tokens_per_step"] == pytest.approx(
        jsum["accepted_tokens_per_step"])
    assert eng.kv.resident_kv_bytes() == (
        0 if kv_cache == "paged" else s["contiguous_kv_bytes"])


def test_full_depth_self_draft_accepts_everything(setup):
    """With the draft == the target every proposal is accepted: each
    verify commits gamma + 1 tokens until the budget caps the window."""
    _, _, cfg, tp, prompts, blocking = setup
    eng = ServingEngine(tp, cfg, EngineConfig(
        **KW, scheduler="speculative", spec_gamma=3,
        spec_draft_layers=cfg.n_layers), device="cpu")
    got, s = _serve(eng, prompts)
    assert got == blocking
    for r in eng.finished:
        left, rounds = len(r.output) - 1, []
        while left:
            rounds.append(min(4, left))
            left -= rounds[-1]
        assert r.spec_accepted == rounds
    assert s["accepted_tokens_per_step"] > 2.0


def test_garbage_draft_still_exact_and_frees_blocks(setup):
    """A zero-weight draft is rejected every round: the streams are still
    the blocking ones, and rollback returns every paged block."""
    _, _, cfg, tp, prompts, blocking = setup

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros_like(tree)

    eng = ServingEngine(tp, cfg, EngineConfig(
        **KW, scheduler="speculative", spec_gamma=3, kv_cache="paged"),
        draft_params=zeros(tp), draft_cfg=cfg, device="cpu")
    got, _ = _serve(eng, prompts)
    assert got == blocking
    assert eng.kv.allocator.allocated_blocks == 0


def test_registry_draft_matches_blocking(setup):
    """A draft named by registry id (its own seeded weights) proposes
    other tokens; the committed streams are still the blocking ones."""
    _, _, cfg, tp, prompts, blocking = setup
    eng = ServingEngine(tp, cfg, EngineConfig(
        **KW, scheduler="speculative", spec_gamma=2, draft="qwen1.5-0.5b"),
        device="cpu")
    got, s = _serve(eng, prompts)
    assert got == blocking
    assert eng.draft_params is not tp and s["draft_dispatches"] > 0


def test_speculative_config_validation(setup):
    _, _, cfg, tp, _, _ = setup
    with pytest.raises(ValueError, match="spec_gamma"):
        EngineConfig(scheduler="speculative", spec_gamma=0)
    bad = registry.get_smoke_config("qwen1.5-0.5b").replace(
        dtype="float32", vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(tp, cfg, EngineConfig(scheduler="speculative"),
                      draft_params=tp, draft_cfg=bad, device="cpu")
