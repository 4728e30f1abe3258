"""The serving engine on the recurrent families, in the port against the
JAX engine on bridged weights (xlstm-350m and zamba2-2.7b smoke configs,
float32, CPU): the reference's own traffic of
``test_hybrid_family_ragged_engine`` and
``test_recurrent_bucketed_prefill_matches_exact`` (``tests/
test_serving.py``) with equal streams; bucketed == exact inside the port
with every leaf an admission splices ``torch.equal``; the requested paged
/ chunked / speculative runs falling back with the reference's warning;
an SLO replay with preemption; export packets equal to the reference's,
leaf by leaf, and an import that gives them back bitwise; the summary's
keys and counts equal to the reference's."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import kv_cache as JKV
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.kv_cache import (ContiguousCache,
                                          contiguous_kv_bytes,
                                          kv_bytes_per_token)
from test_torch_recurrent_card import record_splices
from test_torch_swa import _streams, slo_replay_check
from _torch_threads import one_thread  # noqa: F401

ARCHS = ("xlstm-350m", "zamba2-2.7b")
# the reference's bucketed-prefill traffic (test_serving.py:349-358)
LENS = (3, 7, 13, 21, 17)
KW = dict(max_batch=2, max_seq_len=64, max_new_tokens=5)


def _weights(arch, key):
    jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
    cfg = registry.get_smoke_config(arch).replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(key), jcfg)
    return jcfg, jp, cfg, bridge.params_from_jax(jax.device_get(jp), cfg,
                                                 device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, jp, cfg, tp = _weights(request.param, 2)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in LENS]
    return jcfg, jp, cfg, tp, prompts


@pytest.fixture(scope="module")
def jax_run(setup):
    jcfg, jp, _, _, prompts = setup
    eng = JServingEngine(jp, jcfg, JEngineConfig(**KW))
    return _streams(eng, prompts), eng.summary()


def _fallbacks(family):
    return {
        "paged": ({"kv_cache": "paged"}, f"paged KV cache unsupported for "
                  f"family='{family}' sliding_window=None; falling back to "
                  "contiguous"),
        "chunked": ({"scheduler": "chunked", "chunk_tokens": 16},
                    f"chunked scheduling unsupported for family='{family}' "
                    "sliding_window=None; falling back to blocking"),
        "speculative": ({"scheduler": "speculative", "spec_gamma": 3},
                        f"speculative scheduling unsupported for "
                        f"family='{family}' sliding_window=None; falling "
                        "back to blocking"),
    }


def test_hybrid_ragged_engine_matches_reference():
    """The reference's hybrid traffic (PRNGKey(1), prompts of 5, 9, 14,
    4 slots, capacity 48): the shared block's per-row K/V scatter and the
    live-masked Mamba2 state hold; streams equal the JAX engine's and the
    port's own batch-1 prefill + decode loop."""
    jcfg, jp, cfg, tp = _weights("zamba2-2.7b", 1)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 14)]
    kw = dict(max_batch=4, max_seq_len=48, max_new_tokens=4)
    want = _streams(JServingEngine(jp, jcfg, JEngineConfig(**kw)), prompts)
    eng = ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    assert eng._bucketed
    assert _streams(eng, prompts) == want
    for i, p in enumerate(prompts):
        logits, cache = MD.prefill(
            tp, cfg, {"tokens": torch.as_tensor(p[None, :])}, 48)
        out = [int(logits.argmax(-1))]
        for _ in range(3):
            logits, cache = MD.decode_step(
                tp, cfg, torch.tensor([[out[-1]]]), cache)
            out.append(int(logits.argmax(-1)))
        assert out == want[i], i


def test_bucketed_prefill_matches_exact(setup, jax_run):
    """The reference's traffic with buckets from 16 and without: equal
    streams, equal to the JAX engine's, and every leaf of every
    admission's splice ``torch.equal`` — the state, the conv window and
    zamba2's shared-block K/V rows of the prompt (a bucket's pad rows
    past it are masked by the slot's length)."""
    _, _, cfg, tp, prompts = setup
    outs, spliced = {}, {}
    for bucket in (0, 16):
        eng = ServingEngine(tp, cfg, EngineConfig(
            prefill_bucket_min=bucket, **KW), device="cpu")
        assert eng._bucketed == (bucket > 0)
        spliced[bucket] = record_splices(eng)
        outs[bucket] = _streams(eng, prompts)
    assert outs[16] == outs[0] == jax_run[0]
    assert len(spliced[0]) == len(spliced[16]) == len(LENS)
    for i, (a, b) in enumerate(zip(spliced[0], spliced[16])):
        assert set(a) == set(b)
        for name in a:
            x, y = a[name], b[name]
            if name in ("k", "v"):
                assert x.shape[2] == LENS[i] <= y.shape[2]
                y = y[:, :, :LENS[i]]
            assert torch.equal(x, y), (i, name)


@pytest.mark.parametrize("which", ["paged", "chunked", "speculative"])
def test_requested_fallbacks_warn_and_keep_the_stream(setup, jax_run, which):
    _, _, cfg, tp, prompts = setup
    kw, msg = _fallbacks(cfg.family)[which]
    with pytest.warns(UserWarning, match=msg):
        eng = ServingEngine(tp, cfg, EngineConfig(**kw, **KW), device="cpu")
    assert eng.kv.name == "contiguous" and eng.scheduler.name == "blocking"
    assert eng.draft_kv is None        # no draft after the fallback
    assert _streams(eng, prompts) == jax_run[0]


def test_summary_matches_reference(setup, jax_run):
    """Every key of the reference's summary (the port's adds a few), with
    the same counts and byte figures (0 KV bytes a token on xlstm; the
    state leaves counted in the dense charge)."""
    jcfg, _, cfg, tp, prompts = setup
    eng = ServingEngine(tp, cfg, EngineConfig(**KW), device="cpu")
    _streams(eng, prompts)
    got, want = eng.summary(), jax_run[1]
    assert set(want) <= set(got)
    for key in ("requests", "tokens", "decode_dispatches", "decode_steps",
                "dispatches_per_step", "prefills", "prefill_chunks",
                "prefill_chunk_dispatches", "draft_dispatches",
                "verify_dispatches", "spec_gamma", "kv_cache", "scheduler",
                "resident_kv_bytes", "contiguous_kv_bytes", "draft_kv_bytes",
                "truncated", "preemptions", "preempted_kv_bytes",
                "prefix_hits", "mesh", "mesh_devices", "kv_partitions",
                "resident_kv_bytes_per_device"):
        assert got[key] == want[key], key
    assert kv_bytes_per_token(cfg) == JKV.kv_bytes_per_token(jcfg)
    assert (kv_bytes_per_token(cfg) == 0) == (cfg.family == "ssm")
    assert contiguous_kv_bytes(cfg, 3, 64) == JKV.contiguous_kv_bytes(
        jcfg, 3, 64)


def test_slo_replay_with_preemption_matches_reference(setup):
    """The overload trace's first second (21 requests: the burst of
    long jobs and the chats that preempt them)."""
    slo_replay_check(setup, horizon_s=1.0)


def test_export_packets_equal_reference(setup):
    """Both engines, the same state (two requests, 6 steps): each slot's
    packet has the reference's keys, ``n_valid``, ``kv_bytes`` and every
    leaf — the state whole on its batch axis, K/V up to the export span;
    an import into a free slot gives the packet back ``torch.equal``, and
    an occupied slot refuses it."""
    jcfg, jp, cfg, tp, prompts = setup
    kw = dict(max_batch=4, max_seq_len=64, max_new_tokens=20, eos_token=-1)
    eng = ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    jeng = JServingEngine(jp, jcfg, JEngineConfig(**kw))
    for e in (eng, jeng):
        for p in prompts[3:]:
            e.submit(p)
        for _ in range(6):
            e.step()
    assert isinstance(eng.kv, ContiguousCache)
    for slot in range(2):
        pos = int(eng.slot_pos[slot])
        assert pos == int(jeng.slot_pos[slot])
        for n in (pos, 1, 17):
            got, want = eng.kv.export_slot(slot, n), jeng.kv.export_slot(
                slot, n)
            assert set(got) == set(want)
            assert got["n_valid"] == want["n_valid"] == n
            assert got["kv_bytes"] == want["kv_bytes"]
            for name in set(got) - {"n_valid", "kv_bytes"}:
                assert tuple(got[name].shape) == want[name].shape, name
                w = np.asarray(want[name], np.float32)
                g = got[name].float().numpy()
                if name in ("k", "v"):   # rows past the position: zeros
                    w, g = w[:, :, :min(n, pos)], g[:, :, :min(n, pos)]
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                           err_msg=name)
        pkt = eng.kv.export_slot(slot, pos)
        eng.kv.import_slot(pkt, 2 + slot, len(prompts[3 + slot]), 20)
        back = eng.kv.export_slot(2 + slot, pos)
        for name in set(pkt) - {"n_valid", "kv_bytes"}:
            assert torch.equal(back[name], pkt[name]), name
        with pytest.raises(RuntimeError, match="occupied"):
            eng.kv.import_slot(pkt, 2 + slot, len(prompts[3 + slot]), 20)
