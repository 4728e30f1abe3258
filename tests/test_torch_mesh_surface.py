"""The rest of mesh serving's surface on the CPU (``devices=("cpu",) *
n``, qwen1.5-0.5b's smoke config in float32, weights bridged from the
JAX package): chunked and speculative equal blocking on the paged cache
at (1, 2); an exported packet equals the single engine's leaf for leaf,
and a preempted slot resumes its stream; the simulator's
``serve(mesh=)`` accounts the KV as the engine does; too few devices
and CUDA-less defaults raise, the families, batches and layouts a mesh
once refused serve; an exception in one rank reaches the caller; launch
counts and the decode split under threads; telemetry's dispatch
calibration of a mesh engine equals the one-device engine's."""
from __future__ import annotations

import math
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.core import profiles as HW
from repro_torch.core.costmodel import audit_engine
from repro_torch.core.simulator import LLMSimulator, SimConfig
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.kernels import ops
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine, Telemetry
from repro_torch.serving import telemetry as TT
from _torch_threads import one_thread  # noqa: F401

KW = dict(max_batch=4, max_seq_len=96, max_new_tokens=8)


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    return {"qwen1.5-0.5b": (None, None, cfg, bridge.params_from_jax(
        jax.device_get(jp), cfg, device="cpu"))}


def _prompts(vocab, lens, seed=0):
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


@pytest.mark.parametrize("policy", [
    dict(scheduler="chunked", chunk_tokens=16),
    dict(scheduler="speculative", spec_gamma=3),
], ids=["chunked", "speculative"])
def test_chunked_and_speculative_on_paged_mesh(models, policy):
    _, _, cfg, tp = models["qwen1.5-0.5b"]
    prompts = _prompts(cfg.vocab_size, (17, 33, 5, 64, 40, 9), seed=1)
    _, base = _serve(_engine(tp, cfg, (1, 2), kv_cache="paged"), prompts)
    eng, got = _serve(_engine(tp, cfg, (1, 2), kv_cache="paged", **policy),
                      prompts)
    assert got == base
    s = eng.summary()
    assert s["dispatches_per_step"] == pytest.approx(1.0)
    if policy["scheduler"] == "chunked":
        assert s["prefill_chunk_dispatches"] > len(prompts)
    else:
        assert s["verify_dispatches"] == s["decode_steps"] > 0


@pytest.mark.parametrize("mesh,kv", [((2, 2), "contiguous"),
                                     ((1, 8), "contiguous"),
                                     ((2, 2), "paged")])
def test_exported_packet_equals_single_engine(models, mesh, kv):
    """A live slot's packet, gathered from its data replica's ranks, is
    the single engine's packet: the same leaves, bytes and values — the
    very bits where each rank computes its own heads' K/V; at (1, 8),
    where each K/V head is a gather of column shards of 8 columns, to
    float32 rounding (the CPU's BLAS sums a narrower product in another
    order). Preempted and resumed, the slot's stream is the single
    engine's."""
    _, _, cfg, tp = models["qwen1.5-0.5b"]
    prompts = _prompts(cfg.vocab_size, (40, 23, 61), seed=2)

    def packets(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=12)
        for _ in range(4):
            eng.step()
        return {i: eng.kv.export_slot(i, int(eng.slot_pos[i]))
                for i, r in enumerate(eng.slot_req) if r is not None}

    want = packets(_engine(tp, cfg, kv_cache=kv))
    mesh_eng = _engine(tp, cfg, mesh, kv_cache=kv)
    got = packets(mesh_eng)
    assert got.keys() == want.keys() and len(got) == 3
    for i in want:
        assert set(got[i]) == set(want[i])
        assert got[i]["kv_bytes"] == want[i]["kv_bytes"]
        for name in ("k", "v"):
            assert got[i][name].dtype == want[i][name].dtype
            if mesh_eng.kv.layout == "heads":
                assert torch.equal(got[i][name], want[i][name]), (i, name)
            else:
                torch.testing.assert_close(got[i][name], want[i][name],
                                           rtol=1e-5, atol=1e-6)
    # preempt slot 1 into a packet and let it resume: the stream is the
    # single engine's
    _, single = _serve(_engine(tp, cfg, kv_cache=kv), prompts, 12)
    mesh_eng.preempt_slot(1)
    mesh_eng.run()
    assert {r.rid: r.output for r in mesh_eng.finished} == single


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_simulator_mesh_accounting_equals_engine(models, kv):
    _, _, cfg, tp = models["qwen1.5-0.5b"]
    n_out = 8
    lens = [17, 33, 5, 64]
    eng, _ = _serve(_engine(tp, cfg, (2, 2), kv_cache=kv,
                            max_new_tokens=n_out),
                    _prompts(cfg.vocab_size, lens))
    s = eng.summary()
    sim = LLMSimulator(cfg, HW.DGX_H100, SimConfig()).serve(
        lens, n_out, mesh=(2, 2), kv_cache=kv, max_seq_len=KW["max_seq_len"])
    assert sim["kv_partitions"] == s["kv_partitions"]
    assert sim["resident_kv_bytes"] == s["peak_resident_kv_bytes"]
    assert (sim["resident_kv_bytes_per_device"]
            == s["resident_kv_bytes_per_device"])
    assert sim["mesh_devices"] == s["mesh_devices"] == 4


def test_refusals():
    """What a mesh still refuses — too few devices, no CUDA by default,
    a malformed shape — and what it once refused and now serves as the
    single engine does: whisper and the recurrent families, a batch that
    does not divide over ``data``, chunked prefill over the
    sequence-sharded layout, and the dispatch audit."""
    prompts = _prompts(256, (17, 33, 5, 40), seed=4)
    for arch in ("whisper-large-v3", "zamba2-2.7b", "xlstm-350m"):
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        p = MD.init_params(cfg, device="cpu")
        _, single = _serve(_engine(p, cfg), prompts)
        _, got = _serve(_engine(p, cfg, (1, 2)), prompts)
        assert got == single, arch
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    p = MD.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs 4 devices"):
        ServingEngine(p, cfg, EngineConfig(mesh=(2, 2), **KW),
                      devices=("cpu",) * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(p, cfg, EngineConfig(mesh=(1, 2), **KW))
    with pytest.raises(ValueError, match="data, model"):
        EngineConfig(mesh=(2, 0))
    # 4 slots over 3 data replicas: every replica holds every slot and
    # the cache splits its positions over (data, model)
    _, single = _serve(_engine(p, cfg), prompts)
    eng, got = _serve(_engine(p, cfg, (3, 1)), prompts)
    assert got == single and not eng.kv.split_rows
    assert eng.kv.pos_axes == ("data", "model")
    # the sequence-sharded layout serves chunked prefill
    eng, got = _serve(_engine(p, cfg, (1, 8), scheduler="chunked",
                              chunk_tokens=16), prompts)
    assert got == single and eng.kv.layout == "seq"
    # the dispatch audit prices a mesh engine's whole-model program
    eng, got = _serve(_engine(p, cfg, (1, 2)), prompts)
    assert got == single
    assert audit_engine(eng)["ok"]


def test_rank_exception_reaches_caller():
    """A rank that raises aborts the others waiting at a gather; the
    caller gets the rank's exception at once, and the mesh serves the
    next call. A rank that never reaches the gather ends the call at the
    barrier's timeout."""
    mesh = DeviceMesh((1, 4), ("cpu",) * 4, timeout=5.0)

    def fails(r):
        if r == 2:
            raise KeyError("rank 2")
        return mesh.all_gather(torch.ones(1), 0, "model")

    done = threading.Event()
    err = []

    def call():
        try:
            mesh.run(fails)
        except KeyError as e:
            err.append(e)
        done.set()

    threading.Thread(target=call, daemon=True).start()
    assert done.wait(10.0) and err
    out = mesh.run(lambda r: mesh.all_gather(torch.full((1,), r), 0,
                                             "model"))
    assert all(torch.equal(o, torch.arange(4)) for o in out)
    slow = DeviceMesh((1, 2), ("cpu",) * 2, timeout=0.5)
    with pytest.raises(RuntimeError, match="waited"):
        slow.run(lambda r: None if r else slow.all_gather(
            torch.ones(1), 0, "model"))
    # a gather over ranks the call does not run is refused
    with pytest.raises(RuntimeError, match="needs ranks"):
        mesh.run(lambda r: mesh.all_gather(torch.ones(1), 0, "model"),
                 ranks=(0, 1))


def test_launch_counts_from_threads():
    """Every rank's wrapper counts its launches under one lock: the plain
    versions count none, so the counts stay zero on the CPU — and the
    decode split of a mesh shard is the whole decode's."""
    from repro_torch.distributed import hints as H
    from repro_torch.models.attention import mesh_split
    from repro_torch.kernels.decode_attention import launch_plan
    ops.reset_launch_counts()
    mesh = DeviceMesh((2, 2), ("cpu",) * 4)

    def split(r):
        with H.use_mesh(mesh, plan=(8, 16)):
            return mesh_split()

    assert mesh.run(split) == [128] * 4
    assert mesh_split() is None
    # a shard's 4 rows of 8 heads alone would take 32-position splits
    assert launch_plan(4, 8, 2048).split == 32
    assert launch_plan(4, 8, 2048, 128).split == 128
    assert sum(ops.launch_counts().values()) == 0
    # the split is a launch plan: the cost of a call is the same with it
    q, k = torch.ones(2, 1, 4, 64), torch.ones(2, 32, 4, 64)
    lens = torch.tensor([3, 9])
    for name, args in (("decode_attention", (q, k, k, lens)),
                       ("paged_decode_attention",
                        (q, k, k, torch.zeros(2, 2, dtype=torch.int32),
                         lens))):
        assert (ops.call_cost(name, *args, extra_k=q, split=128)
                == ops.call_cost(name, *args, extra_k=q))


def test_mesh_calibration_prices_the_whole_model(models):
    """Telemetry's dispatch calibration covers a mesh engine: on the
    same traffic its table keys the one-device engine's kinds and counts,
    with their FLOPs and bytes (the whole model's dispatch), and a finite
    measured / predicted ratio."""
    _, _, cfg, tp = models["qwen1.5-0.5b"]
    prompts = _prompts(cfg.vocab_size, (6, 11, 17), seed=3)
    tables = []
    for mesh in (None, (1, 2)):
        tel = Telemetry()
        kw = dict(KW, kv_cache="paged")
        eng = (ServingEngine(tp, cfg, EngineConfig(**kw), device="cpu",
                             telemetry=tel) if mesh is None else
               ServingEngine(tp, cfg, EngineConfig(mesh=mesh, **kw),
                             devices=("cpu",) * 2, telemetry=tel))
        _serve(eng, prompts)
        tables.append(TT.dispatch_calibration(eng, tel))
    single, mesh_t = tables
    assert mesh_t.keys() == single.keys() and single
    for kind, row in mesh_t.items():
        want = single[kind]
        assert (row["n"], row["flops"], row["bytes"]) == (
            want["n"], want["flops"], want["bytes"]), kind
        assert math.isfinite(row["model_error_ratio"]) and \
            row["model_error_ratio"] > 0
