"""The cluster on the card — under the ``cuda`` marker — and its handoff
round trip on the CPU too. Imports no JAX, so the card cases also run on
a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cluster_card.py

Model: qwen1.5-0.5b narrowed to 2 layers of width 256, 4 heads of 64 (a
head dim the card's kernels take), bf16, random weights from seed 0.
Checked: a 1 prefill + 2 decode cluster on ``cuda:0`` (the three
workers share the card round-robin, and its weights) gives the single
engine's bf16 greedy streams, a killed worker's slots included; a
handoff packet is host tensors whose rows, landed on a decode worker and
exported again, are ``torch.equal`` to the prefill worker's."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving import (ClusterConfig, ClusterEngine, EngineConfig,
                                 ServingEngine)

KW = dict(max_batch=4, max_seq_len=256, max_new_tokens=12, eos_token=-1)
LENS = (7, 40, 100, 19, 150, 33)


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    return torch.device("cuda", 0) if name == "cuda" else torch.device(name)


def _model(dev):
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(
        d_model=256, n_heads=4, n_kv_heads=4, d_head=64, d_ff=512,
        dtype="bfloat16")
    return cfg, MD.init_params(cfg, seed=0, device=dev)


def _prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, size=n) for n in LENS]


def _cluster(params, cfg, dev, kv_cache):
    with pytest.warns(UserWarning, match="round-robin"):
        return ClusterEngine(params, cfg,
                             EngineConfig(kv_cache=kv_cache, **KW),
                             ClusterConfig(n_prefill=1, n_decode=2,
                                           devices=(dev,)))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
def test_bf16_cluster_streams_equal_single_engine_on_card(kv_cache):
    dev = _device("cuda")
    cfg, params = _model(dev)
    prompts = _prompts(cfg)
    single = ServingEngine(params, cfg, EngineConfig(kv_cache=kv_cache,
                                                     **KW), device=dev)
    for p in prompts:
        single.submit(p)
    single.run()
    clu = _cluster(params, cfg, dev, kv_cache)
    assert all(w.params is clu.prefill_workers[0].params
               for w in clu.decode_workers)
    for p in prompts:
        clu.submit(p)
    for _ in range(2):
        clu.step()
    clu.kill_worker(0)
    clu.run()
    assert ({r.rid: r.output for r in clu.finished}
            == {r.rid: r.output for r in single.finished})
    s = clu.summary()
    assert s["migrations"] >= 1 and s["dispatches_per_step"] == 1.0
    assert {w["device"] for w in s["per_worker"]} == {"cuda:0"}


@pytest.mark.parametrize("name", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_handoff_packet_round_trip_is_bitwise(name):
    dev = _device(name)
    cfg, params = _model(dev)
    clu = _cluster(params, cfg, dev, "paged")
    clu.submit(_prompts(cfg)[4])
    pw, dw = clu.prefill_workers[0], clu.decode_workers[1]
    with pw.ctx():
        pw.eng.waiting.append(clu.waiting.popleft())
        pw.eng.scheduler.admit(pw.eng)
    [slot] = pw.live_slots()
    n = int(pw.eng.slot_pos[slot])
    before = pw.eng.kv.export_slot(slot, n)
    clu._export_slot(pw, slot)
    [pkt] = clu.pending
    assert all(pkt.kv[x].device.type == "cpu" for x in ("k", "v"))
    assert clu.kv_transfer_bytes == pkt.kv["kv_bytes"] > 0
    assert clu.handoffs == 1 and not pw.live_slots()
    with dw.ctx():
        dw.eng._unpack_slot(pkt, 2)
    assert dw.eng.kv._pool_k.device == dev
    back = dw.eng.kv.export_slot(2, n)
    for x in ("k", "v"):
        assert before[x].dtype == torch.bfloat16
        assert torch.equal(back[x], before[x])
        assert torch.equal(pkt.kv[x], before[x])
