"""The recurrent families' bitwise invariants, on the CPU and — under the
``cuda`` marker — on the card. Imports no JAX, so the card cases also run
on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_recurrent_card.py

Models: xlstm-350m and zamba2-2.7b narrowed to 4 layers of width 256, 4
heads (zamba2's attention at head dim 64, which the card's kernels take)
and their published chunk of 256, random weights from seed 0. Checked:
a prompt admitted bucketed and at its exact length splices every state
leaf — and zamba2's shared-block K/V rows of the prompt — ``torch.equal``
with the same stream after it: on the card 700 tokens in the 1024
bucket (3 chunks against 4); on the CPU 300 in the 512 bucket (2 chunks
each: the plain attention sums a row over all S keys, so only there are
its bits bucket-free by construction); a bf16 slot exported and imported
into a free slot gives every leaf back ``torch.equal``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine
from _torch_threads import one_thread  # noqa: F401

ARCHS = ("xlstm-350m", "zamba2-2.7b")


def narrow(arch, dtype):
    return registry.get_smoke_config(arch).replace(
        d_model=256, n_heads=4, n_kv_heads=4, d_head=64, d_ff=512,
        ssm_head_dim=64, chunk_len=256, dtype=dtype)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    return "cuda"


def record_splices(eng) -> list:
    """Every row dict ``eng``'s cache splices from now on, cloned (the
    position counter left out)."""
    seen, splice = [], eng.kv.splice

    def recording(rows, *args, **kw):
        seen.append({k: v.clone() for k, v in rows.items() if k != "len"})
        return splice(rows, *args, **kw)

    eng.kv.splice = recording
    return seen


def bucketed_equals_exact(arch, dtype, device, n, new=4):
    """Admit one ``n``-token prompt with buckets from 16 and without;
    every leaf each admission splices must be equal (K/V up to the
    prompt), and so must the streams."""
    cfg = narrow(arch, dtype)
    params = MD.init_params(cfg, seed=0, device=device)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=n)
    rows, outs = {}, {}
    nb = 16
    while nb < n:
        nb *= 2
    for bucket in (0, 16):
        eng = ServingEngine(params, cfg, EngineConfig(
            max_batch=2, max_seq_len=1100, max_new_tokens=new,
            prefill_bucket_min=bucket), device=device)
        assert eng._bucket_len(n) == (nb if bucket else n)
        seen = record_splices(eng)
        eng.submit(prompt)
        eng.run()
        (rows[bucket],) = seen
        outs[bucket] = eng.finished[0].output
    assert outs[0] == outs[16] and len(outs[0]) == new
    assert set(rows[0]) == set(rows[16])
    for name, a in rows[0].items():
        b = rows[16][name]
        if name in ("k", "v"):
            assert a.shape[2] == n and b.shape[2] == nb
            b = b[:, :, :n]
        assert torch.equal(a, b), name


def bf16_round_trip(arch, device):
    cfg = narrow(arch, "bfloat16")
    params = MD.init_params(cfg, seed=0, device=device)
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=4, max_seq_len=512, max_new_tokens=32), device=device)
    rng = np.random.default_rng(1)
    for m in (150, 37):
        eng.submit(rng.integers(0, cfg.vocab_size, size=m))
    for _ in range(5):
        eng.step()
    for slot in range(2):
        pos = int(eng.slot_pos[slot])
        pkt = eng.kv.export_slot(slot, pos)
        leaves = set(pkt) - {"n_valid", "kv_bytes"}
        assert leaves == set(MD.cache_batch_axes(eng.kv._cache)) - {"len"}
        assert pkt["kv_bytes"] == sum(pkt[x].numel() * pkt[x].element_size()
                                      for x in leaves)
        eng.kv.import_slot(pkt, 2 + slot, pos, 32)
        back = eng.kv.export_slot(2 + slot, pos)
        for name in leaves:
            assert back[name].dtype == pkt[name].dtype
            assert torch.equal(back[name], pkt[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_prefill_state_is_exact_on_cpu(arch):
    bucketed_equals_exact(arch, "float32", "cpu", 300)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_round_trip_is_bitwise_on_cpu(arch):
    bf16_round_trip(arch, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_prefill_state_is_exact_on_card(arch, dtype):
    bucketed_equals_exact(arch, dtype, _card(), 700)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_round_trip_is_bitwise_on_card(arch):
    bf16_round_trip(arch, _card())
