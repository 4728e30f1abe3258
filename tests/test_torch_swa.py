"""The rolling sliding-window cache in the port against the JAX package on
bridged weights (h2o-danube-1.8b smoke config: window 32, 2 layers, 4
heads of 16; float32, CPU): the plain rolling decode against the
reference's ``decode_attention(window=)`` with the cache as wide as the
window and narrower; prefill that rolls, and decode past the window,
against the JAX model; the refusals the reference makes; the engine's
streams against the JAX engine's — contiguous + blocking, the requested
paged / chunked / speculative configurations that fall back with the
reference's warning, and an SLO replay with preemption — and slot
export packets equal to the reference's across the window."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as JA
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import workload as JW
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving import workload as W
from repro_torch.serving.kv_cache import PagedCache
from _torch_threads import one_thread  # noqa: F401

ARCH = "h2o-danube-1.8b"
WINDOW = 32
ATOL = 1e-4   # float32 logits; the attention routes differ in sum order
LENS = (40, 20, 9)    # one prompt rolls in prefill, one rolls in decode
KW = dict(max_batch=3, max_seq_len=64, max_new_tokens=12)
FALLBACKS = {
    "paged": ({"kv_cache": "paged"}, "paged KV cache unsupported for "
              "family='dense' sliding_window=32; falling back to contiguous"),
    "chunked": ({"scheduler": "chunked", "chunk_tokens": 16},
                "chunked scheduling unsupported for family='dense' "
                "sliding_window=32; falling back to blocking"),
    "speculative": ({"scheduler": "speculative", "spec_gamma": 3},
                    "speculative scheduling unsupported for family='dense' "
                    "sliding_window=32; falling back to blocking"),
}


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config(ARCH).replace(dtype="float32")
    cfg = registry.get_smoke_config(ARCH).replace(dtype="float32")
    assert cfg.sliding_window == jcfg.sliding_window == WINDOW
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in LENS]
    return jcfg, jp, cfg, tp, prompts


def _np(x):
    return np.asarray(x, np.float32)


def _streams(engine, prompts):
    for p in prompts:
        engine.submit(p)
    engine.run()
    assert engine.decode_dispatches == engine.decode_steps
    return {r.rid: r.output for r in engine.finished}


@pytest.fixture(scope="module")
def jax_streams(setup):
    jcfg, jp, _, _, prompts = setup
    return _streams(JServingEngine(jp, jcfg, JEngineConfig(**KW)), prompts)


# ---------------------------------------------------------------------------
# the plain rolling decode (K1's CPU path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [WINDOW, 24])   # C == window, C < window
@pytest.mark.parametrize("self_kv", [True, False])
def test_plain_rolling_decode_matches_reference(cap, self_kv):
    """Rows before, at and past the capacity: valid to min(len, C), and
    when C == window a full row's slot len % C masked — against the
    reference's decode_attention(window=), GQA 8/2."""
    rng = np.random.default_rng(1)
    b, hq, hkv, dh = 6, 8, 2, 16
    lens = np.array([1, cap - 1, cap, cap + 1, 2 * cap + 3, 100], np.int32)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (b, 1, hq, dh), (b, cap, hkv, dh), (b, cap, hkv, dh),
        (b, 1, hkv, dh), (b, 1, hkv, dh))]
    q, kc, vc, ek, ev = arrs
    jkw = dict(extra_k=jnp.asarray(ek), extra_v=jnp.asarray(ev)) \
        if self_kv else {}
    tkw = dict(extra_k=torch.from_numpy(ek), extra_v=torch.from_numpy(ev)) \
        if self_kv else {}
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lens),
                               window=WINDOW, **jkw)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(lens),
                               window=WINDOW, **tkw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                               rtol=1e-5)
    # the window's mask matters on the full rows, and only where C ==
    # window does it drop a slot of the clamped length
    clamped = ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(np.minimum(lens, cap)), **tkw)
    full = lens >= cap
    assert torch.equal(got[~full], clamped[~full])
    assert torch.equal(got[full], clamped[full]) == (cap != WINDOW)


# ---------------------------------------------------------------------------
# the model against the JAX model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [40, WINDOW, 20])
def test_prefill_rolls_like_reference(setup, s):
    """A prompt past the window (rolled by s % C), one that fills it
    exactly and one inside it: logits and every cache leaf equal the
    reference's; ``capacity=None`` gives all s rows, which
    ``roll_window`` turns into the same slots."""
    jcfg, jp, cfg, tp, _ = setup
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size,
                                             size=(2, s)).astype(np.int32)
    jl, jc = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 64)
    tl, tc = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 64)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL, rtol=ATOL)
    assert tc["k"].shape == jc["k"].shape == (cfg.n_layers, 2, WINDOW,
                                              cfg.n_kv_heads, cfg.d_head)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   atol=ATOL, rtol=ATOL)
    assert int(tc["len"]) == int(jc["len"]) == s
    _, rows = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, None)
    assert rows["k"].shape[2] == s
    if s >= WINDOW:
        assert torch.equal(MD.roll_window(rows["k"], WINDOW), tc["k"])


def test_decode_past_the_window_matches_reference(setup):
    """A 40-token prefill, then 8 decode steps (positions 40..47): within
    the reference test's tolerances of the JAX full forward
    (``tests/test_models.py``'s SWA test) and within float32 tolerance of
    the JAX prefill + decode_step, argmax equal, caches equal."""
    jcfg, jp, cfg, tp, _ = setup
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(1, 48)).astype(np.int32)
    full = _np(JMD.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}))
    jl, jc = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :40])}, 64)
    tl, tc = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :40])},
                        64)
    np.testing.assert_allclose(tl.numpy(), full[:, 39], atol=3e-2, rtol=3e-2)
    for i in range(40, 48):
        tok = toks[:, i:i + 1]
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        tl, tc = MD.decode_step(tp, cfg, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), full[:, i], atol=4e-2,
                                   rtol=4e-2, err_msg=f"step {i}")
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL,
                                   rtol=ATOL, err_msg=f"step {i}")
        assert (tl.numpy().argmax(-1) == _np(jl).argmax(-1)).all()
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   atol=ATOL, rtol=ATOL)


def test_ragged_live_decode_across_the_window(setup):
    """Three rows from a 28-token prefill, per-row lengths, a live mask
    that freezes one row now and then: rows cross the window at
    different steps; logits and caches equal the reference's."""
    jcfg, jp, cfg, tp, _ = setup
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 28)).astype(np.int32)
    _, jc = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 64)
    _, tc = MD.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 64)
    pos = np.full(3, 28, np.int32)
    for i in range(10):
        live = np.array([True, i % 3 != 1, i % 2 == 0])
        tok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        jc["len"] = jnp.asarray(pos)
        tc["len"] = torch.from_numpy(pos.copy())
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                 live=jnp.asarray(live))
        tl, tc = MD.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                live=torch.from_numpy(live))
        np.testing.assert_allclose(tl.numpy()[live], _np(jl)[live],
                                   atol=ATOL, rtol=ATOL, err_msg=f"step {i}")
        pos = pos + live
    assert len(set(pos.tolist())) == 3 and pos.min() > WINDOW
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                   atol=ATOL, rtol=ATOL)


def test_what_the_reference_refuses_raises(setup):
    """Chunked prefill, verify and a paged cache cannot express a rolling
    window: each refuses as the reference does; the cache struct holds
    the window."""
    jcfg, _, cfg, tp, _ = setup
    toks = torch.zeros((1, 4), dtype=torch.int32)
    kh = torch.zeros((cfg.n_layers, 1, WINDOW, cfg.n_kv_heads, cfg.d_head))
    with pytest.raises(ValueError, match="rolling SWA"):
        MD.prefill_chunk(tp, cfg, {"tokens": toks}, kh, kh, 0)
    cache = MD.init_cache(cfg, 1, 64, device="cpu")
    with pytest.raises(ValueError, match="rolling SWA"):
        MD.verify_tokens(tp, cfg, toks, cache)
    with pytest.raises(ValueError, match="rolling SWA"):
        MD.decode_step(tp, cfg, toks[:, :1],
                       dict(cache, block_tab=torch.zeros((1, 4),
                                                         dtype=torch.int32)))
    with pytest.raises(ValueError, match="rolling SWA"):
        PagedCache(cfg, EngineConfig(kv_cache="paged", **KW), "cpu")
    for cap in (16, 64):
        want = JMD.cache_struct(jcfg, 2, cap)
        got = MD.cache_struct(cfg, 2, cap)
        assert {k: tuple(v[0]) for k, v in got.items()} == \
            {k: tuple(v[0]) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the serving engine against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_streams_match_reference(setup, jax_streams):
    """Contiguous + blocking: exact-length prefills (no bucket: pads
    would roll into the window), streams equal to the JAX engine's."""
    _, _, cfg, tp, prompts = setup
    eng = ServingEngine(tp, cfg, EngineConfig(**KW), device="cpu")
    assert not eng._bucketed
    assert _streams(eng, prompts) == jax_streams
    assert eng.summary()["prefills"] == len(LENS)


@pytest.mark.parametrize("which", sorted(FALLBACKS))
def test_requested_fallbacks_warn_and_keep_the_stream(setup, jax_streams,
                                                      which):
    _, _, cfg, tp, prompts = setup
    kw, msg = FALLBACKS[which]
    with pytest.warns(UserWarning, match=msg):
        eng = ServingEngine(tp, cfg, EngineConfig(**kw, **KW), device="cpu")
    assert eng.kv.name == "contiguous" and eng.scheduler.name == "blocking"
    assert _streams(eng, prompts) == jax_streams


def overload_tenants(mod):
    """A smaller overload (prompt lengths in steps of 8, so each package
    prefills six exact lengths): 6–12-token chat at priority 2 with a
    40 ms TTFT target beside a burst of 24–48-token jobs, the long ones
    rolling in prefill."""
    return (mod.TenantSpec("chat", rate_rps=2.5, prompt_len=(6, 12),
                           new_tokens=(4, 4), priority=2,
                           slo=mod.SLO(ttft_s=0.04, itl_s=0.05)),
            mod.TenantSpec("summarize", rate_rps=30.0, prompt_len=(24, 48),
                           new_tokens=(16, 16), priority=0,
                           window=(0.0, 0.8)))


def slo_replay_check(setup, horizon_s=4.0):
    """The SLO replay of a ``horizon_s`` trace through both engines:
    equal streams, admission orders and preemption logs, at least one
    preemption, and the port's SLO streams equal to its FIFO streams."""
    jcfg, jp, cfg, tp, _ = setup
    kw = dict(max_batch=4, max_seq_len=96, max_new_tokens=16, eos_token=-1)
    trace = dict(vocab_size=cfg.vocab_size, seed=0, len_step=8, name="slo")
    want = JW.replay(JServingEngine(jp, jcfg, JEngineConfig(
        scheduler="slo", **kw)), JW.make_trace(
            overload_tenants(JW), horizon_s, **trace), step_quantum_s=0.01)
    runs = {s: W.replay(ServingEngine(tp, cfg, EngineConfig(
        scheduler=s, **kw), device="cpu"), W.make_trace(
            overload_tenants(W), horizon_s, **trace), step_quantum_s=0.01)
        for s in ("slo", "blocking")}
    got = runs["slo"]
    for key in ("outputs", "admission_order", "preemption_log", "tokens"):
        assert got[key] == want[key], key
    assert got["summary"]["preemptions"] >= 1
    assert got["outputs"] == runs["blocking"]["outputs"]


def test_slo_replay_with_preemption_matches_reference(setup):
    slo_replay_check(setup)


def export_packets_check(setup, leaves, n_steps):
    """Both engines, the same state (two requests, ``n_steps`` steps):
    each slot's packet has the reference's ``n_valid``, spans,
    ``kv_bytes`` and rows of every leaf in ``leaves``; an import into a
    free slot gives the packet back ``torch.equal``."""
    jcfg, jp, cfg, tp, prompts = setup
    kw = dict(KW, max_new_tokens=20, eos_token=-1)
    eng = ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    jeng = JServingEngine(jp, jcfg, JEngineConfig(**kw))
    for e in (eng, jeng):
        for p in prompts[:2]:
            e.submit(p)
        for _ in range(n_steps):
            e.step()
    cap = eng.kv._cache["k"].shape[2]
    for slot in range(2):
        pos = int(eng.slot_pos[slot])
        for n in (pos, 1, 16, 17):
            got, want = eng.kv.export_slot(slot, n), jeng.kv.export_slot(
                slot, n)
            assert got["n_valid"] == want["n_valid"] == n
            assert got["kv_bytes"] == want["kv_bytes"]
            assert set(got) == set(want)
            for name in leaves:
                assert tuple(got[name].shape) == want[name].shape, name
                m = min(n, pos, cap) if name in ("k", "v") else None
                np.testing.assert_allclose(
                    got[name][:, :, :m].numpy(), _np(want[name])[:, :, :m],
                    rtol=1e-5, atol=1e-5)
        pkt = eng.kv.export_slot(slot, pos)
        eng.kv.import_slot(pkt, 2, len(prompts[slot]), 20)
        back = eng.kv.export_slot(2, pos)
        for name in leaves:
            assert torch.equal(back[name], pkt[name]), name
        eng.kv.free(2)
    return eng


def test_export_packets_equal_reference_across_the_window(setup):
    """The 40-token prompt's slot is past the window (its packet carries
    every rolled slot), the 20-token one crosses it during the steps."""
    eng = export_packets_check(setup, ("k", "v"), 14)
    assert int(eng.slot_pos[0]) > int(eng.slot_pos[1]) >= WINDOW
