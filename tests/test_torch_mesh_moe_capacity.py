"""An MoE's capacity over a serving batch split over ``data``, on the
CPU (every shard a rank of ``devices=("cpu",) * n``, smoke configs in
float32 at capacity factor 1.25, weights bridged from the JAX package).

A decode or verify dispatch on a mesh with ``data`` > 1 routes each data
replica's rows on its own ranks, yet its expert buffers are the whole
dispatch's — ``_capacity`` of every replica's rows — and each rank's
slots follow the lower replicas' on every expert, as the reference's
one program numbers them. So the same routed slots drop as on one
device: for deepseek-moe-16b, dbrx-132b and mixtral-8x22b at (2, 2) and
(4, 1), speculative on both KV backends at ``max_batch`` 8 and blocking
at ``max_batch`` 16, the streams equal the port's single engine's, one
target dispatch a step, with every dispatch's dropped slots equal to the
single engine's — and at least one dispatch drops in every case.
Blocking at (2, 2) also equals the JAX engine's streams."""
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
from _moe_drops import counting_dispatch_drops
from _torch_threads import one_thread  # noqa: F401

ARCHS = ("deepseek-moe-16b", "dbrx-132b", "mixtral-8x22b")
MESHES = ((2, 2), (4, 1))
CONFIGS = {
    "speculative_contiguous": dict(max_batch=8, scheduler="speculative"),
    "speculative_paged": dict(max_batch=8, scheduler="speculative",
                              kv_cache="paged"),
    "blocking_16": dict(max_batch=16),
}
KW = dict(max_seq_len=80, max_new_tokens=10)


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(k)).astype(np.int32)
            for k in rng.integers(5, 65, size=n)]


@pytest.fixture(scope="module")
def models():
    """Per arch: the JAX config and weights, the port's config and the
    bridged weights."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        assert cfg.moe_capacity_factor == 1.25
        # jitted: made in a few seconds less than eagerly
        jp = jax.jit(JMD.init_params, static_argnums=1)(
            jax.random.PRNGKey(i), jcfg)
        out[arch] = (jcfg, jp, cfg, bridge.params_from_jax(
            jax.device_get(jp), cfg, device="cpu"))
    return out


def _serve(tp, cfg, conf, prompts, mesh=None):
    ecfg = EngineConfig(**KW, **conf, mesh=mesh)
    kw = ({"device": "cpu"} if mesh is None
          else {"devices": ("cpu",) * (mesh[0] * mesh[1])})
    with counting_dispatch_drops() as drops:
        eng = ServingEngine(tp, cfg, ecfg, **kw)
        for p in prompts:
            eng.submit(p)
        eng.run()
    return eng, {r.rid: r.output for r in eng.finished}, drops


@pytest.fixture(scope="module")
def single(models):
    """(arch, config) -> the single engine's (prompts, streams, drops)."""
    out = {}
    for arch in ARCHS:
        _, _, cfg, tp = models[arch]
        for name, conf in CONFIGS.items():
            prompts = _prompts(cfg.vocab_size, conf["max_batch"])
            _, streams, drops = _serve(tp, cfg, conf, prompts)
            out[arch, name] = (prompts, streams, drops)
    return out


@pytest.mark.parametrize("conf", CONFIGS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_drops_the_single_engines_slots(models, single, arch, mesh,
                                             conf):
    _, _, cfg, tp = models[arch]
    prompts, want, want_drops = single[arch, conf]
    assert sum(want_drops.values()) > 0, "no dispatch drops a slot"
    eng, got, drops = _serve(tp, cfg, CONFIGS[conf], prompts, mesh)
    assert got == want
    assert drops == want_drops
    assert eng.summary()["dispatches_per_step"] == pytest.approx(1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_streams_equal_the_reference_engine(models, single, arch):
    """Blocking at ``max_batch`` 16 on (2, 2): the JAX engine's streams
    (one device, one global dispatch) are the mesh's."""
    jcfg, jp, cfg, tp = models[arch]
    prompts, _, _ = single[arch, "blocking_16"]
    jeng = JServingEngine(jp, jcfg, JEngineConfig(**KW, max_batch=16))
    for p in prompts:
        jeng.submit(p)
    jeng.run()
    want = {r.rid: r.output for r in jeng.finished}
    _, got, _ = _serve(tp, cfg, CONFIGS["blocking_16"], prompts, (2, 2))
    assert got == want
