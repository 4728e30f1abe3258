"""Whisper's encoder–decoder in the port against the JAX package on
bridged weights (whisper-large-v3 smoke config: 2 + 2 layers, MHA of 4
heads of 16, encoder_len 16, LayerNorm and GELU; float32, CPU):
``sinusoidal_positions``, the encoder, the audio prefill with its cross
K/V and the decode step over them against the JAX model; the refusals
the reference makes; the engine's streams against the JAX engine's —
contiguous + blocking with bucketed prompts, the requested paged /
chunked / speculative configurations that fall back with the
reference's warning, and an SLO replay with preemption — and slot
export packets, cross leaves included, equal to the reference's."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.kv_cache import PagedCache, contiguous_kv_bytes
from test_torch_swa import (KW, _np, _streams, export_packets_check,
                            slo_replay_check)
from _torch_threads import one_thread  # noqa: F401

ARCH = "whisper-large-v3"
ATOL = 1e-4
LENS = (40, 20, 9)
FALLBACK_MSGS = {
    "paged": ({"kv_cache": "paged"}, "paged KV cache unsupported for "
              "family='audio' sliding_window=None; falling back to "
              "contiguous"),
    "chunked": ({"scheduler": "chunked", "chunk_tokens": 16},
                "chunked scheduling unsupported for family='audio' "
                "sliding_window=None; falling back to blocking"),
    "speculative": ({"scheduler": "speculative", "spec_gamma": 3},
                    "speculative scheduling unsupported for "
                    "family='audio' sliding_window=None; falling back to "
                    "blocking"),
}


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in LENS]
    return jcfg, jp, cfg, tp, prompts


@pytest.fixture(scope="module")
def jax_streams(setup):
    jcfg, jp, _, _, prompts = setup
    return _streams(JServingEngine(jp, jcfg, JEngineConfig(**KW)), prompts)


def _frames(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.encoder_len, cfg.d_model))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("d_model", [64, 1280])
def test_sinusoidal_positions_match_reference(d_model):
    """Whisper's 1500 encoder positions and per-row decode positions
    (B, 1): float32 angles, the sines before the cosines. The two
    packages' float32 ``exp`` may round a frequency one ulp apart, which
    moves an angle by up to ``pos`` ulps: the tolerance is two of them
    at the largest position."""
    for pos in (np.arange(1500, dtype=np.int32),
                np.array([[0], [7], [1499], [4095]], np.int32)):
        want = _np(JL.sinusoidal_positions(jnp.asarray(pos), d_model))
        got = L.sinusoidal_positions(torch.from_numpy(pos), d_model)
        assert got.dtype == torch.float32 and got.shape == want.shape
        tol = 2 * int(pos.max()) * float(np.finfo(np.float32).eps)
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_encoder_matches_reference(setup):
    jcfg, jp, cfg, tp, _ = setup
    fr = _frames(cfg, 2, 1)
    want = JMD._encode_audio(jp, jcfg, jnp.asarray(fr), "chunked")
    got = MD._encode_audio(tp, cfg, torch.from_numpy(fr))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=ATOL)


def test_prefill_and_decode_match_reference(setup):
    """A 20-token prefill over seeded frames (logits, self and cross K/V),
    then 6 ragged decode steps with a live mask that freezes one row
    now and then: logits and every cache leaf equal the reference's;
    the cross leaves never move."""
    jcfg, jp, cfg, tp, _ = setup
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    fr = _frames(cfg, 3, 3)
    jl, jc = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(fr)}, 48)
    tl, tc = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks),
                                  "frames": torch.from_numpy(fr)}, 48)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL, rtol=ATOL)
    assert set(tc) == set(jc) == {"len", "k", "v", "cross_k", "cross_v"}
    cross = {n: tc[n].clone() for n in ("cross_k", "cross_v")}
    pos = np.full(3, 20, np.int32)
    for i in range(6):
        live = np.array([True, i % 3 != 1, i % 2 == 0])
        tok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        jc["len"], tc["len"] = jnp.asarray(pos), torch.from_numpy(pos.copy())
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                 live=jnp.asarray(live))
        tl, tc = MD.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                live=torch.from_numpy(live))
        np.testing.assert_allclose(tl.numpy()[live], _np(jl)[live],
                                   atol=ATOL, rtol=ATOL, err_msg=f"step {i}")
        pos = pos + live
    for name in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    for name, t in cross.items():
        assert torch.equal(tc[name], t)
    _, rows = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(fr)}, None)
    assert rows["k"].shape[2] == 20
    assert rows["cross_k"].shape[2] == cfg.encoder_len


def test_what_the_reference_refuses_raises(setup):
    """Chunked prefill, verify, the self-draft and a paged cache cannot
    carry the cross-attention cache: each refuses as the reference
    does. The cache struct and the dense footprint count the cross K/V
    as the reference's do."""
    jcfg, _, cfg, tp, _ = setup
    toks = torch.zeros((1, 4), dtype=torch.int32)
    kh = torch.zeros((cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.d_head))
    with pytest.raises(ValueError, match="unsupported for family 'audio'"):
        MD.prefill_chunk(tp, cfg, {"tokens": toks}, kh, kh, 0)
    cache = MD.init_cache(cfg, 1, 64, device="cpu")
    with pytest.raises(ValueError, match="unsupported for family 'audio'"):
        MD.verify_tokens(tp, cfg, toks, cache)
    with pytest.raises(ValueError, match="self-draft unsupported"):
        MD.self_draft_params(tp, cfg, 1)
    with pytest.raises(ValueError, match="does not support family"):
        PagedCache(cfg, EngineConfig(kv_cache="paged", **KW), "cpu")
    want = JMD.cache_struct(jcfg, 2, 64)
    got = MD.cache_struct(cfg, 2, 64)
    assert {k: tuple(v[0]) for k, v in got.items()} == \
        {k: tuple(v[0]) for k, v in want.items()}
    from repro.serving import kv_cache as JKV
    assert contiguous_kv_bytes(cfg, 3, 64) == JKV.contiguous_kv_bytes(
        jcfg, 3, 64)


def test_engine_streams_match_reference(setup, jax_streams):
    """Contiguous + blocking, prompts bucketed as the reference buckets
    them, stub zero frames at admission: the JAX engine's streams."""
    _, _, cfg, tp, prompts = setup
    eng = ServingEngine(tp, cfg, EngineConfig(**KW), device="cpu")
    assert eng._bucketed
    assert _streams(eng, prompts) == jax_streams


@pytest.mark.parametrize("which", sorted(FALLBACK_MSGS))
def test_requested_fallbacks_warn_and_keep_the_stream(setup, jax_streams,
                                                      which):
    _, _, cfg, tp, prompts = setup
    kw, msg = FALLBACK_MSGS[which]
    with pytest.warns(UserWarning, match=msg):
        eng = ServingEngine(tp, cfg, EngineConfig(**kw, **KW), device="cpu")
    assert eng.kv.name == "contiguous" and eng.scheduler.name == "blocking"
    assert _streams(eng, prompts) == jax_streams


def test_slo_replay_with_preemption_matches_reference(setup):
    slo_replay_check(setup)


def test_export_packets_with_cross_leaves_equal_reference(setup):
    """A packet carries the slot's self K/V to its padded span and its
    cross K/V whole, as the reference's does; an import gives it back."""
    eng = export_packets_check(setup, ("k", "v", "cross_k", "cross_v"), 6)
    pkt = eng.kv.export_slot(0, int(eng.slot_pos[0]))
    assert pkt["cross_k"].shape[2] == eng.cfg.encoder_len
