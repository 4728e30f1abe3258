"""Slot export and import (the SLO preemption path) on both KV backends
and across them: a moved stream continues as if it had never moved; the
packet's ``kv_bytes``, padded spans and KV rows equal the JAX package's
for the same engine state (qwen1.5-0.5b smoke config, float32, CPU); an
import into an occupied slot raises; a bf16 round trip is bitwise, here
and — under the ``cuda`` marker — on the card, where this module runs
without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kv_export.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine

BACKENDS = ("contiguous", "paged")
KW = dict(max_batch=3, max_seq_len=64, max_new_tokens=9, eos_token=-1)


@pytest.fixture(scope="module")
def setup():
    """Port weights bridged from the JAX package's (JAX imported here, so
    the card tests below collect without it)."""
    import jax
    from repro.configs import registry as jreg
    from repro.models import model as JMD
    from repro_torch import bridge
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (19, 7, 33)]
    return jcfg, jp, cfg, tp, prompts


def _engine(tp, cfg, kv_cache, device="cpu", **kw):
    return ServingEngine(tp, cfg, EngineConfig(kv_cache=kv_cache,
                                               **{**KW, **kw}),
                         device=device)


@pytest.mark.parametrize("dst", BACKENDS)
@pytest.mark.parametrize("src", BACKENDS)
def test_moved_stream_continues_unchanged(setup, src, dst):
    """Three requests decode for 4 steps on ``src``; request 0's slot is
    packed, landed in the last slot of a ``dst`` engine and served to the
    end there, beside the others on ``src``: every stream equals an
    unmoved run's."""
    _, _, cfg, tp, prompts = setup
    want = _engine(tp, cfg, src)
    for p in prompts:
        want.submit(p)
    want.run()
    a = _engine(tp, cfg, src)
    for p in prompts:
        a.submit(p)
    for _ in range(4):
        a.step()
    pkt = a._pack_slot(0)
    assert pkt.pos == len(prompts[0]) + pkt.gen_len - 1
    b = _engine(tp, cfg, dst)
    assert b.kv.can_admit(pkt.n_prompt, pkt.budget)
    b._unpack_slot(pkt, 2)
    b.run()
    a.run()
    got = {r.rid: r.output for r in a.finished + b.finished}
    assert got == {r.rid: r.output for r in want.finished}
    for eng in (a, b):
        if eng.kv.name == "paged":
            assert eng.kv.allocator.allocated_blocks == 0


@pytest.mark.parametrize("kv_cache", BACKENDS)
def test_packet_bytes_spans_and_rows_equal_reference(setup, kv_cache):
    """The same engine state in both packages (bridged weights, two
    requests, five steps): each slot's packet has the reference's
    ``n_valid``, padded span, ``kv_bytes`` and — within float32
    tolerance — KV rows; spans past the valid length too."""
    from repro.serving import EngineConfig as JEngineConfig
    from repro.serving import ServingEngine as JServingEngine
    jcfg, jp, cfg, tp, prompts = setup
    eng = _engine(tp, cfg, kv_cache)
    jeng = JServingEngine(jp, jcfg, JEngineConfig(kv_cache=kv_cache, **KW))
    for e in (eng, jeng):
        for p in prompts[:2]:
            e.submit(p)
        for _ in range(5):
            e.step()
    for slot in range(2):
        for n in (int(eng.slot_pos[slot]), 1, 16, 17, 48):
            got = eng.kv.export_slot(slot, n)
            want = jeng.kv.export_slot(slot, n)
            assert got["n_valid"] == want["n_valid"] == n
            assert got["kv_bytes"] == want["kv_bytes"]
            for name in ("k", "v"):
                assert tuple(got[name].shape) == want[name].shape
                m = min(n, int(eng.slot_pos[slot]))
                np.testing.assert_allclose(
                    got[name][:, :, :m].numpy(), want[name][:, :, :m],
                    rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_cache", BACKENDS)
def test_import_into_occupied_slot_raises(setup, kv_cache):
    _, _, cfg, tp, prompts = setup
    eng = _engine(tp, cfg, kv_cache)
    eng.submit(prompts[0])
    eng.step()
    pkt = eng.kv.export_slot(0, int(eng.slot_pos[0]))
    with pytest.raises(RuntimeError, match="occupied slot 0"):
        eng.kv.import_slot(pkt, 0, len(prompts[0]), 9)
    eng.kv.import_slot(pkt, 1, len(prompts[0]), 9)     # a free slot takes it
    with pytest.raises(RuntimeError, match="occupied slot 1"):
        eng.kv.import_slot(pkt, 1, len(prompts[0]), 9)
    eng.kv.free(1)
    eng.kv.import_slot(pkt, 1, len(prompts[0]), 9)


def _bf16_round_trip(device):
    """bf16 rows exported from slot 0 and imported into slot 1 of each
    backend (and across backends) come back ``torch.equal``. Head dim 64:
    the card's attention kernels take 64, 96 and 128, not the smoke
    config's 16."""
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(d_head=64)
    assert cfg.dtype == "bfloat16"
    params = MD.init_params(cfg, seed=0, device=device)
    engines = {}
    for kv in BACKENDS:
        eng = _engine(params, cfg, kv, device=device)
        eng.submit(np.arange(37) % cfg.vocab_size)
        for _ in range(3):
            eng.step()
        engines[kv] = eng
    for src in BACKENDS:
        for dst in BACKENDS:
            a, b = engines[src], engines[dst]
            n = int(a.slot_pos[0])
            pkt = a.kv.export_slot(0, n)
            assert pkt["k"].dtype == torch.bfloat16
            assert pkt["k"].device.type == "cpu"
            assert pkt["kv_bytes"] == 2 * pkt["k"].numel() * 2
            b.kv.import_slot(pkt, 1, 37, 9)
            back = b.kv.export_slot(1, n)
            for name in ("k", "v"):
                assert torch.equal(back[name][:, :, :n], pkt[name][:, :, :n])
            b.kv.free(1)


def test_bf16_round_trip_is_bitwise_on_cpu():
    _bf16_round_trip("cpu")


@pytest.mark.cuda
def test_bf16_round_trip_is_bitwise_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    _bf16_round_trip("cuda")
