"""Mesh serving's layouts on the CPU, every shard a rank of
``devices=("cpu",) * n`` (smoke configs in float32, weights bridged from
the JAX package), each against the port's single engine and the JAX
package's single-device engine, one dispatch a step:

- a batch that does not divide over ``data`` (3 slots at (2, 2)): the
  contiguous cache splits its positions over ``(data, model)``, the
  paged pools stay whole, every data replica serves every slot;
- the sequence-sharded layout (4 KV heads over ``model`` 8) under
  chunked prefill and speculative verify — K4 over each rank's
  positions, partials merged in rank order — and under a rolling window
  of 32 (h2o-danube-1.8b), masked by global position;
- weights split over ``data`` (the FSDP rules at a budget of 0),
  gathered layer by layer at use;
- in each, the dispatch audit of the mesh engine: clean, its log the
  one-device engine's, and its totals those of the one-device engine
  that ran the same log."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.core import trace as T
from repro_torch.core.costmodel import (assert_no_drift, audit_engine,
                                        entry_tracer)
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.serving import EngineConfig, ServingEngine
from _torch_threads import one_thread  # noqa: F401

LENS = [17, 33, 5, 64]
WINDOW_LENS = [17, 40, 5, 70]   # two prompts past danube's window of 32
KW = dict(max_batch=4, max_seq_len=96, max_new_tokens=8)


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p)
    eng.run()
    return eng, {r.rid: r.output for r in eng.finished}


@pytest.fixture(scope="module")
def models():
    """Per (arch, max_batch, new tokens): the port's config, bridged
    weights, prompts and the JAX engine's blocking streams."""
    out = {}
    for arch, b, n_new in (("qwen1.5-0.5b", 4, 8), ("qwen1.5-0.5b", 3, 8),
                           ("h2o-danube-1.8b", 4, 20)):
        jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        jp = JMD.init_params(jax.random.PRNGKey(0), jcfg)
        prompts = _prompts(cfg.vocab_size, WINDOW_LENS
                           if cfg.sliding_window else LENS)
        kw = dict(KW, max_batch=b, max_new_tokens=n_new)
        _, want = _serve(JServingEngine(jp, jcfg, JEngineConfig(**kw)),
                         prompts)
        out[arch, b] = (cfg, bridge.params_from_jax(
            jax.device_get(jp), cfg, device="cpu"), prompts, want, kw)
    return out


def _engine(tp, cfg, kw, mesh=None, **more):
    kw = {**kw, **more}
    if mesh is None:
        return ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    return ServingEngine(tp, cfg, EngineConfig(mesh=mesh, **kw),
                         devices=("cpu",) * (mesh[0] * mesh[1]))


def _check(models, key, mesh, **more):
    """The mesh engine's streams against the single engine's and the
    reference's; one dispatch a step. Returns (mesh engine, single)."""
    cfg, tp, prompts, want, kw = models[key]
    single, got_single = _serve(_engine(tp, cfg, kw, **more), prompts)
    eng, got = _serve(_engine(tp, cfg, kw, mesh, **more), prompts)
    assert got == got_single == want
    assert eng.summary()["dispatches_per_step"] == pytest.approx(1.0)
    return eng, single


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_batch_not_dividing_data(models, kv):
    eng, single = _check(models, ("qwen1.5-0.5b", 3), (2, 2), kv_cache=kv)
    _same_audit(eng, single)
    assert not eng.kv.split_rows
    if kv == "contiguous":
        assert (eng.kv.layout, eng.kv.pos_axes) == ("seq", ("data", "model"))
        assert eng.kv.placement["k"][2] == ("data", "model")
        assert eng.summary()["kv_partitions"] == 4
    else:
        assert eng.kv.layout == "heads"


@pytest.mark.parametrize("policy", [
    dict(scheduler="chunked", chunk_tokens=16),
    dict(scheduler="speculative", spec_gamma=3),
], ids=["chunked", "speculative"])
def test_sequence_layout_chunked_and_speculative(models, policy):
    eng, single = _check(models, ("qwen1.5-0.5b", 4), (1, 8), **policy)
    _same_audit(eng, single)
    assert (eng.kv.layout, eng.kv.pos_axes) == ("seq", ("model",))
    s = eng.summary()
    if policy["scheduler"] == "chunked":
        assert s["prefill_chunk_dispatches"] > 4
    else:
        assert s["verify_dispatches"] == s["decode_steps"] > 0
        assert eng.draft_kv.layout == "seq"


def test_sequence_layout_rolling_window(models):
    """danube's window of 32 over 8 ranks of 4 slots each: the prompts
    of 40 and 70 tokens roll at admission, the others while they
    decode."""
    eng, _ = _check(models, ("h2o-danube-1.8b", 4), (1, 8))
    assert eng.kv.layout == "seq" and eng.kv._c_local == 4


def test_weights_split_over_data_and_audit(models):
    """qwen's weights by the FSDP rules at (2, 2), on the paged cache
    with chunked prefill; the audit of the mesh engine is clean and its
    totals are the single engine's."""
    cfg, tp, prompts, want, kw = models["qwen1.5-0.5b", 4]
    shape = DeviceMesh((2, 2), ("cpu",) * 4)
    specs = SH.serve_specs(tp, shape, serve_budget_bytes=0)
    more = dict(kv_cache="paged", scheduler="chunked", chunk_tokens=16)
    eng, got = _serve(_engine(SH.shard_tree(tp, specs, shape), cfg, kw,
                              (2, 2), **more), prompts)
    single, got_single = _serve(_engine(tp, cfg, kw, **more), prompts)
    assert got == got_single == want
    assert eng._gather_specs is not None
    _same_audit(eng, single)


def _same_audit(eng, single):
    """The mesh engine's audit is clean, its log the single engine's
    entry for entry, and its traced FLOPs and bytes the single
    engine's."""
    assert_no_drift(audit_engine(eng))
    assert [(e["step"], e["kind"], repr(e["spec"]))
            for e in eng.dispatch_log] == [
        (e["step"], e["kind"], repr(e["spec"])) for e in single.dispatch_log]

    def totals(e):
        trace = entry_tracer(e)
        t = [T.totals(trace(x)) for x in e.dispatch_log]
        return sum(x.flops for x in t), sum(x.bytes for x in t)

    assert totals(eng) == totals(single)
