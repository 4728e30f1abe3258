"""Mesh serving (``EngineConfig.mesh``) on the CPU, every shard a rank
of ``devices=("cpu",) * n``: the reference's mesh cases — qwen1.5-0.5b
at (2, 4) and deepseek-moe-16b at (2, 2), smoke configs in float32,
weights bridged from the JAX package, on both KV backends — give the
greedy streams of the port's single engine and of the JAX package's
single-device engine, one dispatch a step, and per-device KV that tiles
the total; so does the sequence-sharded fallback at (1, 8) (4 KV heads
do not divide 8). The
rest of the mesh's surface is ``test_torch_mesh_surface.py``."""
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
from repro_torch.serving import EngineConfig, ServingEngine
from _torch_threads import one_thread  # noqa: F401

LENS = [17, 33, 5, 64]   # the reference test's prompts
KW = dict(max_batch=4, max_seq_len=96, max_new_tokens=8)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen1.5-0.5b", "deepseek-moe-16b"):
        jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        jp = JMD.init_params(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, jp, cfg,
                     bridge.params_from_jax(jax.device_get(jp), cfg,
                                            device="cpu"))
    return out


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def _serve(eng, prompts, budget=None):
    for p in prompts:
        eng.submit(p, max_new_tokens=budget)
    eng.run()
    return eng, {r.rid: r.output for r in eng.finished}


def _engine(tp, cfg, mesh=None, **kw):
    kw = {**KW, **kw}
    if mesh is None:
        return ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu")
    return ServingEngine(tp, cfg, EngineConfig(mesh=mesh, **kw),
                         devices=("cpu",) * (mesh[0] * mesh[1]))


@pytest.mark.parametrize("arch,mesh", [("qwen1.5-0.5b", (2, 4)),
                                       ("deepseek-moe-16b", (2, 2))])
@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_mesh_streams_equal_single_and_reference(models, arch, mesh, kv):
    jcfg, jp, cfg, tp = models[arch]
    prompts = _prompts(cfg.vocab_size)
    _, want = _serve(JServingEngine(jp, jcfg, JEngineConfig(
        **KW, kv_cache=kv)), prompts)
    _, single = _serve(_engine(tp, cfg, kv_cache=kv), prompts)
    eng, got = _serve(_engine(tp, cfg, mesh, kv_cache=kv), prompts)
    assert got == single == want
    s = eng.summary()
    assert s["dispatches_per_step"] == pytest.approx(1.0)
    assert s["mesh"] == mesh and s["mesh_devices"] == mesh[0] * mesh[1]
    parts = s["kv_partitions"]
    # contiguous: slots over data and heads over model; paged pools:
    # heads over model only
    assert parts == (mesh[0] * mesh[1] if kv == "contiguous" else mesh[1])
    per = s["resident_kv_bytes_per_device"]
    resident = s["peak_resident_kv_bytes"]
    assert per * parts >= resident > per


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_sequence_fallback_streams(models, kv):
    """model 8 over 4 KV heads: the contiguous cache splits its 96
    positions over the ranks (K1's partials gathered and combined), the
    paged pools stay whole; both give the single engine's streams."""
    _, _, cfg, tp = models["qwen1.5-0.5b"]
    prompts = _prompts(cfg.vocab_size)
    _, single = _serve(_engine(tp, cfg, kv_cache=kv), prompts)
    eng, got = _serve(_engine(tp, cfg, (1, 8), kv_cache=kv), prompts)
    assert got == single
    s = eng.summary()
    assert s["dispatches_per_step"] == pytest.approx(1.0)
    assert eng.kv.layout == ("seq" if kv == "contiguous" else "replicated")
    assert s["kv_partitions"] == (8 if kv == "contiguous" else 1)
