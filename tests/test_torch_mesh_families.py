"""Mesh serving of whisper and the recurrent families on the CPU, every
shard a rank of ``devices=("cpu",) * n`` (smoke configs in float32,
weights bridged from the JAX package): whisper-large-v3 at (1, 2) — its
encoder at admission on every rank, its cross K/V by heads —,
zamba2-2.7b at (2, 2) and xlstm-350m at (1, 2) — Mamba2 and the mLSTM
split by heads over ``model``, the sLSTM's recurrence whole on every
model rank, their state over ``data`` — give
the port's single engine's and the JAX package's greedy streams, one
dispatch a step; an exported slot is the single engine's packet, leaf
for leaf; zamba2 with its weights split over ``data`` (gathered at use)
serves the same streams."""
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
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.serving import EngineConfig, ServingEngine
from _torch_threads import one_thread  # noqa: F401

LENS = [17, 33, 5, 64]   # the reference mesh test's prompts
KW = dict(max_batch=4, max_seq_len=96, max_new_tokens=8)
CASES = [("whisper-large-v3", (1, 2)), ("zamba2-2.7b", (2, 2)),
         ("xlstm-350m", (1, 2))]


@pytest.fixture(scope="module")
def models():
    """Per arch: the port's config and bridged weights, the prompts and
    the JAX engine's streams on them."""
    out = {}
    for arch, _ in CASES:
        jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        jp = JMD.init_params(jax.random.PRNGKey(0), jcfg)
        prompts = _prompts(cfg.vocab_size)
        jeng = JServingEngine(jp, jcfg, JEngineConfig(**KW))
        _, want = _serve(jeng, prompts)
        out[arch] = (cfg, bridge.params_from_jax(jax.device_get(jp), cfg,
                                                 device="cpu"), prompts, want)
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


@pytest.mark.parametrize("arch,mesh", CASES)
def test_family_streams_equal_single_and_reference(models, arch, mesh):
    cfg, tp, prompts, want = models[arch]
    _, single = _serve(_engine(tp, cfg), prompts)
    eng, got = _serve(_engine(tp, cfg, mesh), prompts)
    assert got == single == want
    s = eng.summary()
    assert s["dispatches_per_step"] == pytest.approx(1.0)
    assert s["mesh"] == mesh
    # the recurrent sublayers' columns split over model by the serve
    # rule, as attention's heads do
    rank = eng.params[0]
    if cfg.family == "ssm":
        assert eng.kv.layout == "replicated"
        w = rank["mlstm"]["wq"]
        assert w.shape[-1] * mesh[1] == tp["mlstm"]["wq"].shape[-1]
    else:
        assert eng.kv.layout == "heads"
        assert rank["embed"]["table"].shape[0] == cfg.vocab_size // mesh[1]
    if cfg.family == "hybrid":
        w = rank["mamba"]["mamba"]["in_proj"]
        assert w.shape[-1] * mesh[1] == \
            tp["mamba"]["mamba"]["in_proj"].shape[-1]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_family_packets_equal_single_engine(models, arch, mesh):
    """A live slot's packet — K/V, whisper's cross K/V by heads, a
    recurrent slot's state — is the single engine's, leaf for leaf;
    preempted and resumed, the stream is the single engine's."""
    cfg, tp, prompts, _ = models[arch]

    def packets(eng):
        for p in prompts[:3]:
            eng.submit(p, max_new_tokens=12)
        for _ in range(3):
            eng.step()
        return {i: eng.kv.export_slot(i, int(eng.slot_pos[i]))
                for i, r in enumerate(eng.slot_req) if r is not None}

    want = packets(_engine(tp, cfg))
    eng = _engine(tp, cfg, mesh)
    got = packets(eng)
    assert got.keys() == want.keys() and len(got) == 3
    for i in want:
        assert set(got[i]) == set(want[i])
        assert got[i]["kv_bytes"] == want[i]["kv_bytes"]
        for name, leaf in want[i].items():
            if isinstance(leaf, torch.Tensor):
                torch.testing.assert_close(got[i][name], leaf, rtol=1e-5,
                                           atol=1e-6)
    _, single = _serve(_engine(tp, cfg), prompts[:3], 12)
    eng.preempt_slot(1)
    eng.run()
    assert {r.rid: r.output for r in eng.finished} == single


def test_weights_split_over_data(models):
    """zamba2's weights placed by the FSDP rules (a budget of 0) at
    (2, 2): every split leaf is half a data replica's, gathered whole at
    use; the streams are the single engine's and the reference's."""
    cfg, tp, prompts, want = models["zamba2-2.7b"]
    shape = DeviceMesh((2, 2), ("cpu",) * 4)
    specs = SH.serve_specs(tp, shape, serve_budget_bytes=0)
    assert SH.splits_over_data(specs, shape)
    per_rank = SH.shard_tree(tp, specs, shape)
    eng, got = _serve(_engine(per_rank, cfg, (2, 2)), prompts)
    assert got == want
    assert eng.summary()["dispatches_per_step"] == pytest.approx(1.0)
    w = per_rank[0]["mamba"]["mamba"]["in_proj"]
    assert 2 * w.shape[-2] == tp["mamba"]["mamba"]["in_proj"].shape[-2]
