"""Serving with ``act_shard``: the residual stream held split over
``model`` between the sublayers, as the reference's
``hints.hidden(x, cfg.act_shard)`` pins it in serving too — d_model
(``"dmodel"``: nemotron-4-340b, dbrx-132b and internvl2-26b set it;
whisper with it set, its encoder too) or the positions (``"seq"``,
qwen) — on the float32 smoke models, weights bridged from the JAX
package, on the CPU: at (1, 2) and (2, 2) the greedy streams equal one
device's, and ``"none"``'s at (2, 2), under blocking, chunked and
speculative scheduling on both KV backends; blocking on the contiguous
cache equals the JAX engine's; and the norms gather the ranks' parts of
the stream whole. Training's split is ``test_torch_train_split.py``."""
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
from repro_torch.distributed import hints as H
from repro_torch.serving import EngineConfig, ServingEngine
from _torch_threads import one_thread  # noqa: F401

CASES = [("nemotron-4-340b", "dmodel"), ("dbrx-132b", "dmodel"),
         ("internvl2-26b", "dmodel"), ("qwen1.5-0.5b", "dmodel"),
         ("qwen1.5-0.5b", "seq"), ("whisper-large-v3", "dmodel")]
MESHES = ((1, 2), (2, 2))


def _dim(mode):
    return {"dmodel": -1, "seq": 1}[mode]


LENS = [17, 5, 40]
KW = dict(max_batch=4, max_seq_len=64, max_new_tokens=6)
SERVING = [dict(scheduler=s, kv_cache=kv, **({"chunk_tokens": 16}
                                              if s == "chunked" else {}))
           for s in ("blocking", "chunked", "speculative")
           for kv in ("contiguous", "paged")]
_MODELS: dict = {}


def _model(arch):
    """(port cfg, bridged weights, the JAX engine's blocking streams on
    the contiguous cache — None for qwen, whose split is the override's
    and whose streams the mesh tests hold to the reference), made once
    a process."""
    if arch not in _MODELS:
        jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        jp = jax.jit(JMD.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg)
        want = None
        if not arch.startswith("qwen"):
            jeng = JServingEngine(jp, jcfg, JEngineConfig(**KW))
            for p in _prompts(cfg.vocab_size):
                jeng.submit(p)
            jeng.run()
            want = {r.rid: r.output for r in jeng.finished}
        _MODELS[arch] = (cfg, bridge.params_from_jax(
            jax.device_get(jp), cfg, device="cpu"), want)
    return _MODELS[arch]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _serve(cfg, params, mesh=None, **kw):
    kw = {**KW, **kw}
    if mesh is None:
        eng = ServingEngine(params, cfg, EngineConfig(**kw), device="cpu")
    else:
        eng = ServingEngine(params, cfg, EngineConfig(mesh=mesh, **kw),
                            devices=("cpu",) * (mesh[0] * mesh[1]))
    for p in _prompts(cfg.vocab_size):
        eng.submit(p)
    eng.run()
    return {r.rid: r.output for r in eng.finished}


@pytest.mark.parametrize("arch,mode", CASES)
def test_serving_split_stream_streams_equal_none_and_one_device(
        monkeypatch, arch, mode):
    cfg, params, want = _model(arch)
    parts = []
    stream_whole = H.stream_whole

    def recorded(x):
        out = stream_whole(x)
        parts.append((x.shape[_dim(mode)], out.shape[_dim(mode)]))
        return out

    monkeypatch.setattr(H, "stream_whole", recorded)
    for kw in SERVING:
        if cfg.family == "audio" and kw["scheduler"] != "blocking":
            continue    # whisper falls back to blocking (test_torch_audio)
        one = _serve(cfg, params, **kw)
        if (want is not None and kw["scheduler"] == "blocking"
                and kw["kv_cache"] == "contiguous"):
            assert one == want
        none = _serve(cfg.replace(act_shard="none"), params, (2, 2), **kw)
        assert none == one, kw
        for mesh in MESHES:
            parts.clear()
            got = _serve(cfg.replace(act_shard=mode), params, mesh, **kw)
            assert got == one, (kw, mesh)
            # the norms gathered the ranks' parts of the stream whole
            assert parts and all(w == p * mesh[1] for p, w in parts)
            if mode == "dmodel":
                assert {w for _, w in parts} == {cfg.d_model}
