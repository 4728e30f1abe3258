"""Property (the reference's ``tests/test_cluster.py`` property, inside
the port): killing or draining a decode worker at a random step mid-run
loses no token — every request retires with exactly the port's single
blocking engine's stream — on both KV backends (qwen1.5-0.5b smoke
config, float32, CPU)."""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving import (ClusterConfig, ClusterEngine, EngineConfig,
                                 ServingEngine)
from _torch_threads import one_thread  # noqa: F401

KW = dict(max_batch=2, max_seq_len=64, max_new_tokens=4)


def test_migration_loses_no_tokens_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    params = MD.init_params(cfg, seed=5, device="cpu")
    singles = {}

    def single(prompts, kv_cache):
        eng = ServingEngine(params, cfg, EngineConfig(kv_cache=kv_cache,
                                                      **KW), device="cpu")
        for p in prompts:
            eng.submit(p)
        eng.run()
        return {r.rid: r.output for r in eng.finished}

    @given(lens=st.lists(st.integers(1, 40), min_size=1, max_size=6),
           fault_step=st.integers(1, 6),
           fault=st.sampled_from(["kill", "drain"]),
           kv_cache=st.sampled_from(["contiguous", "paged"]))
    @settings(max_examples=8, deadline=None)
    def prop(lens, fault_step, fault, kv_cache):
        prompts = [np.arange(n) % cfg.vocab_size for n in lens]
        skey = (tuple(lens), kv_cache)
        if skey not in singles:
            singles[skey] = single(prompts, kv_cache)
        with pytest.warns(UserWarning, match="round-robin"):
            clu = ClusterEngine(params, cfg,
                                EngineConfig(kv_cache=kv_cache, **KW),
                                ClusterConfig(n_prefill=1, n_decode=2,
                                              devices=("cpu",)))
        for p in prompts:
            clu.submit(p)
        steps = 0
        while clu.waiting or clu.pending or clu._any_live():
            clu.step()
            steps += 1
            if steps == fault_step:
                getattr(clu, f"{fault}_worker")(1)
            assert steps < 500, "cluster failed to drain"
        assert len(clu.finished) == len(prompts)
        assert {r.rid: r.output for r in clu.finished} == singles[skey]

    prop()
