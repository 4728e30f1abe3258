"""Port paged KV cache: block allocator, reservation arithmetic,
rollback, resident bytes, and paged == contiguous greedy streams inside
the port and against the JAX engine's paged streams (qwen1.5-0.5b smoke
config, float32, CPU)."""
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
from repro_torch.serving.kv_cache import (BlockAllocator, PagedCache,
                                          paged_resident_kv_bytes)
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _serve(engine, prompts, budgets=None):
    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=None if budgets is None
                      else budgets[i])
    engine.run()
    return {r.rid: r.output for r in engine.finished}, engine.summary()


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def test_paged_streams_equal_contiguous_and_reference(setup):
    """Ragged prompts over several waves of slot reuse: the paged
    engine's streams equal the port's contiguous streams and the JAX
    paged engine's; one decode dispatch per step; peak resident KV
    below the dense charge."""
    jcfg, jp, cfg, tp = setup
    prompts = _prompts(0, (5, 40, 17, 30, 9, 22, 3), cfg.vocab_size)
    budgets = (6, 9, 1, 7, 5, 4, 8)
    kw = dict(max_batch=3, max_seq_len=64, max_new_tokens=6)
    want, jsum = _serve(JServingEngine(jp, jcfg, JEngineConfig(
        kv_cache="paged", **kw)), prompts, budgets)
    got, s = _serve(ServingEngine(tp, cfg, EngineConfig(
        kv_cache="paged", **kw), device="cpu"), prompts, budgets)
    dense, _ = _serve(ServingEngine(tp, cfg, EngineConfig(**kw),
                                    device="cpu"), prompts, budgets)
    assert got == want == dense
    assert s["decode_dispatches"] == s["decode_steps"] == jsum["decode_steps"]
    assert s["kv_cache"] == "paged" and s["resident_kv_bytes"] == 0
    assert 0 < s["peak_resident_kv_bytes"] < s["contiguous_kv_bytes"]


def test_paged_admission_defers_until_blocks_free(setup):
    """A 3-block pool holds one 2-block request at a time: admission
    waits (FIFO) instead of deadlocking, and the streams are unchanged."""
    _, _, cfg, tp = setup
    prompts = _prompts(3, (20, 20, 20), cfg.vocab_size)
    kw = dict(max_batch=4, max_seq_len=64, max_new_tokens=4)
    eng = ServingEngine(tp, cfg, EngineConfig(
        kv_cache="paged", kv_block_size=16, kv_blocks=3, **kw), device="cpu")
    got, s = _serve(eng, prompts)
    want, _ = _serve(ServingEngine(tp, cfg, EngineConfig(**kw),
                                   device="cpu"), prompts)
    assert got == want and s["requests"] == 3
    assert eng.kv.allocator.peak_allocated <= 3


def test_paged_config_errors(setup):
    _, _, cfg, tp = setup
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(tp, cfg, EngineConfig(kv_cache="paged", max_seq_len=60,
                                            kv_block_size=16), device="cpu")
    eng = ServingEngine(tp, cfg, EngineConfig(
        max_batch=2, max_seq_len=64, max_new_tokens=60, kv_cache="paged",
        kv_block_size=16, kv_blocks=2), device="cpu")
    eng.submit(np.arange(30, dtype=np.int32))
    with pytest.raises(ValueError, match="KV blocks"):
        eng.run()


def test_allocator_basics():
    a = BlockAllocator(4)
    got = [a.alloc() for _ in range(4)]
    assert sorted(got) == [0, 1, 2, 3] and a.peak_allocated == 4
    with pytest.raises(RuntimeError):
        a.alloc()
    a.free(got[1])
    assert a.alloc() == got[1]          # freed blocks are reused
    with pytest.raises(ValueError):
        a.free(99)                       # foreign block
    a.free(got[0])
    with pytest.raises(ValueError):
        a.free(got[0])                   # double free
    assert a.free_blocks + a.allocated_blocks == 4


def test_commit_n_frees_over_allocated_blocks(setup):
    """verify_view allocates the candidate window's blocks; commit_n at
    the bonus-only position frees them and puts them back on the
    reservation, so a later verify can take them again."""
    _, _, cfg, _ = setup
    cache = PagedCache(cfg, EngineConfig(max_batch=2, max_seq_len=64,
                                         kv_block_size=16), "cpu")
    shape = (cfg.n_layers, 1, 10, cfg.n_kv_heads, cfg.d_head)
    rows = {n: torch.ones(shape) for n in ("k", "v")}
    cache.splice(rows, 0, n_prompt=10, budget=32)   # block 0 only
    r0, free0 = cache.resident_kv_bytes(), cache.allocator.free_blocks
    live = np.array([True, False])
    view = cache.verify_view(np.array([10, 0]), live, np.array([8, 1]))
    assert cache.resident_kv_bytes() > r0           # window 10..17
    assert int(view["block_tab"][0, 1]) < cache.num_blocks
    cache.commit_n(0, 11)                           # full rejection
    assert cache.resident_kv_bytes() == r0
    assert cache.allocator.free_blocks == free0
    assert int(cache.table[0, 1]) == cache.num_blocks
    cache.verify_view(np.array([10, 0]), live, np.array([8, 1]))
    cache.commit_n(0, 18)                           # accepted across
    assert cache.resident_kv_bytes() > r0
    cache.free(0)
    assert cache.allocator.allocated_blocks == 0


def test_resident_bytes_accounting_matches_blocks(setup):
    """Request 0 writes positions 0..6 (1 block), request 1 0..19 (2
    blocks): the peak is exactly those 3 blocks."""
    _, _, cfg, tp = setup
    prompts = _prompts(5, (5, 18), cfg.vocab_size)
    eng = ServingEngine(tp, cfg, EngineConfig(
        max_seq_len=64, max_new_tokens=3, kv_cache="paged",
        kv_block_size=16), device="cpu")
    _, s = _serve(eng, prompts)
    want = paged_resident_kv_bytes(cfg, [7, 20], 16)
    assert s["peak_resident_kv_bytes"] == want
    assert eng.kv.resident_kv_bytes() == 0
