"""The port's cluster against its own single blocking engine, family by
family (smoke configs, float32, CPU, the port's seeded weights): every
greedy stream through prefill and decode workers — handed off once,
and again when a decode worker is killed or drained mid-stream — is
bitwise the single engine's. The dense, MoE and vlm families run on
both KV backends with a kill; the recurrent, audio and rolling-window
families, for which a paged request falls back to the contiguous cache
with the reference's warning, with a drain. Then prefix-affinity
routing over 2 + 2 workers and the mixshift trace's autoscaling in both
directions. The single engine is held to the JAX package's per family
in the other port tests, which closes the chain."""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving import (ClusterConfig, ClusterEngine, EngineConfig,
                                 ServingEngine)
from repro_torch.serving.workload import make_named_trace, replay
from _torch_threads import one_thread  # noqa: F401

CPU = ("cpu",)
ROUND_ROBIN = "workers share devices round-robin"
FALLBACK = "paged KV cache unsupported for family="
KW = dict(max_batch=2, max_seq_len=64, max_new_tokens=5, eos_token=-1)
LENS = [7, 12, 19, 9, 15, 6]
# past the smoke window of 32: two prompts roll in prefill and land on
# decode worker 0 (least-loaded routing alternates), which the drain
# empties
WINDOW_LENS = [40, 7, 35, 19, 15, 6]
_params: dict = {}


def _setup(arch):
    if arch not in _params:
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        _params[arch] = cfg, MD.init_params(cfg, seed=3, device="cpu")
    return _params[arch]


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def _outputs(finished) -> dict:
    return {r.rid: r.output for r in finished}


def _single(params, cfg, prompts, **kw) -> dict:
    eng = ServingEngine(params, cfg, EngineConfig(**kw), device="cpu")
    for p in prompts:
        eng.submit(p)
    eng.run()
    return _outputs(eng.finished)


def _faulted(params, cfg, prompts, fault, ecfg, ccfg=None, before=None):
    """A 1 + 2 cluster on the CPU; ``fault`` (kill or drain) hits decode
    worker 0 after two steps, just after ``before(cluster)``."""
    with pytest.warns(UserWarning, match=ROUND_ROBIN):
        clu = ClusterEngine(params, cfg, EngineConfig(**ecfg),
                            ClusterConfig(devices=CPU, **(ccfg or {})))
    for p in prompts:
        clu.submit(p)
    for _ in range(2):
        clu.step()
    if before is not None:
        before(clu)
    getattr(clu, f"{fault}_worker")(0)
    clu.run()
    return clu


@pytest.mark.parametrize("kv_cache", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-moe-16b",
                                  "internvl2-26b"])
def test_cluster_with_kill_equals_single_engine(arch, kv_cache):
    cfg, params = _setup(arch)
    prompts = _prompts(cfg.vocab_size, LENS)
    kw = dict(KW, kv_cache=kv_cache)
    clu = _faulted(params, cfg, prompts, "kill", kw)
    assert _outputs(clu.finished) == _single(params, cfg, prompts, **kw)
    s = clu.summary()
    assert s["migrations"] >= 1 and s["workers_alive"] == 1
    assert s["handoffs"] == len(prompts) and s["kv_cache"] == kv_cache
    assert s["dispatches_per_step"] == 1.0
    if kv_cache == "paged":      # the pools balance after the drain
        for w in clu.prefill_workers + clu.decode_workers:
            assert w.eng.kv.allocator.allocated_blocks == 0
            assert not w.eng.kv._reserved.any()


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m",
                                  "whisper-large-v3", "h2o-danube-1.8b"])
def test_cluster_with_drain_on_the_contiguous_fallback(arch):
    """A paged request falls back to the contiguous cache on every
    worker with the reference's warning; the packets carry the state
    leaves (recurrent), the cross K/V (whisper) or the rolled window."""
    cfg, params = _setup(arch)
    lens = WINDOW_LENS if cfg.sliding_window else LENS
    prompts = _prompts(cfg.vocab_size, lens, seed=2)
    moved = []

    def positions(clu):
        w = clu.decode_workers[0]
        moved.extend(int(w.eng.slot_pos[i]) for i in w.live_slots())

    with pytest.warns(UserWarning, match=FALLBACK):
        clu = _faulted(params, cfg, prompts, "drain",
                       dict(KW, kv_cache="paged"), before=positions)
    assert moved
    if cfg.sliding_window:       # a rolled slot crosses between workers
        assert max(moved) > cfg.sliding_window
    want = _single(params, cfg, prompts, **KW)
    assert _outputs(clu.finished) == want
    s = clu.summary()
    assert s["kv_cache"] == "contiguous" and s["migrations"] >= 1
    assert s["workers_alive"] == 2 and clu.decode_workers[0].draining
    assert s["dispatches_per_step"] == 1.0


def test_prefix_affinity_routing_bitwise():
    """Six prompts on a three-block preamble through 2 prefill + 2
    decode workers with prefix caching: streams equal the cold single
    engine's, the router sends a warm prompt to the worker holding its
    prefix, and every alias is released after the drain."""
    cfg, params = _setup("qwen1.5-0.5b")
    rng = np.random.default_rng(5)
    pre = rng.integers(0, cfg.vocab_size, size=48)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size,
                                                 size=n)])
               for n in (4, 7, 9, 12, 5, 8)]
    kw = dict(kv_cache="paged", kv_block_size=16, eos_token=-1,
              max_batch=2, max_seq_len=96, max_new_tokens=5)
    want = _single(params, cfg, prompts, **kw)
    with pytest.warns(UserWarning, match=ROUND_ROBIN):
        clu = ClusterEngine(params, cfg,
                            EngineConfig(prefix_cache=True, **kw),
                            ClusterConfig(n_prefill=2, n_decode=2,
                                          devices=CPU))
    for p in prompts:
        clu.submit(p)
    clu.run()
    assert _outputs(clu.finished) == want
    s = clu.summary()
    assert s["prefix_routed"] >= 1 and s["prefix_hits"] >= 1
    for w in clu.prefill_workers + clu.decode_workers:
        kv = w.eng.kv
        assert all(v == 0 for v in kv.prefix._refs.values())
        assert not kv._reserved.any()


MIXSHIFT_ECFG = dict(max_batch=4, max_seq_len=96, max_new_tokens=16,
                     kv_cache="paged", kv_block_size=16, kv_blocks=6,
                     eos_token=-1)
MIXSHIFT_CCFG = dict(n_prefill=1, n_decode=3, autoscale=True,
                     autoscale_interval=4, prefill_rate=2)


def test_cluster_autoscales_both_directions_on_mixshift():
    """The mixshift trace over a block-constrained decode tier drives
    the autoscaler both ways on interval boundaries, conserves workers,
    hands every stream off at least once, and keeps the single engine's
    streams."""
    cfg, params = _setup("qwen1.5-0.5b")
    tr = make_named_trace("mixshift", vocab_size=cfg.vocab_size, seed=0)
    with pytest.warns(UserWarning, match=ROUND_ROBIN):
        clu = ClusterEngine(params, cfg, EngineConfig(**MIXSHIFT_ECFG),
                            ClusterConfig(devices=CPU, **MIXSHIFT_CCFG))
    rep = replay(clu, tr, step_quantum_s=0.01)
    assert {d for _, d in clu.rescale_log} == {"to_prefill", "to_decode"}
    assert all(s % 4 == 0 for s, _ in clu.rescale_log)
    assert (len(clu.prefill_workers) + len(clu.decode_workers)
            == MIXSHIFT_CCFG["n_prefill"] + MIXSHIFT_CCFG["n_decode"])
    assert clu.handoffs >= len(tr.requests)
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=4, max_seq_len=96, max_new_tokens=16, eos_token=-1),
        device="cpu")
    assert rep["outputs"] == replay(eng, tr, step_quantum_s=0.01)["outputs"]
