"""The recurrent sublayers split over ``model`` in mesh serving, on the
CPU (every shard a rank of ``devices=("cpu",) * n``, smoke configs in
float32, weights bridged from the JAX package): zamba2-2.7b (Mamba2 and
its shared attention block) and xlstm-350m (mLSTM and sLSTM) at (1, 2),
(2, 2), (1, 4) and (1, 3) — where nothing recurrent divides, so every
recurrence runs whole by the rule.

- every rank's param and cache leaf has the local shape the reference's
  ``PartitionSpec``\\ s give it (``param_shardings(serve=True)``,
  ``cache_shardings`` on an ``AbstractMesh``);
- ``gather_tree`` of the shards is the whole tree, bit for bit, and a
  rank's Mamba2 in-projection is its slice of the reference's columns;
- the greedy streams equal the port's single engine's and the JAX
  engine's, on the contiguous cache and through the paged fallback;
- an exported slot is the single engine's packet: its leaves, shapes,
  dtypes and bytes, its values to float32 rounding (rtol 1e-4: the
  CPU's BLAS sums a rank's narrower product in another order, and two
  layers carry it); the single engine's
  packet imported into the mesh exports again byte for byte (every
  shard lands where the reference's channel order puts it); a slot
  preempted and resumed keeps its stream;
- a bucketed prefill leaves each rank's state as the exact-length one,
  bit for bit."""
from __future__ import annotations

import math
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.distributed import sharding as JSH
from repro.models import model as JMD
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine
from _torch_threads import one_thread  # noqa: F401

ARCHS = ("zamba2-2.7b", "xlstm-350m")
MESHES = ((1, 2), (2, 2), (1, 4), (1, 3))
LENS = [17, 30, 9, 25]
KW = dict(max_batch=4, max_seq_len=96, max_new_tokens=6)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def models():
    """Per arch: the JAX config, the port's config, the bridged weights,
    the prompts, and the streams of the JAX engine and of the port's
    single engine."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        # jitted: made in a few seconds less than eagerly
        jp = jax.jit(JMD.init_params, static_argnums=1)(
            jax.random.PRNGKey(i + 5), jcfg)
        prompts = _prompts(cfg.vocab_size)
        jeng = JServingEngine(jp, jcfg, JEngineConfig(**KW))
        _, want = _serve(jeng, prompts)
        tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
        _, single = _serve(_engine(tp, cfg), prompts)
        out[arch] = (jcfg, cfg, tp, prompts, want, single)
    return out


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
                         devices=("cpu",) * math.prod(mesh))


def _reference_local(tree_shape, shardings) -> dict:
    """{path names: local shape} the reference's shardings give a
    device."""
    flat = jax.tree_util.tree_leaves_with_path(tree_shape)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): tuple(sh.shard_shape(leaf.shape))
            for (path, leaf), sh in zip(flat, shs)}


CASES = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CASES]


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_local_shapes_are_the_reference_shards(models, arch, mesh):
    jcfg, cfg, tp, _, _, _ = models[arch]
    amesh = AbstractMesh(mesh, ("data", "model"))
    jshape = jax.eval_shape(lambda: JMD.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    ref = _reference_local(jshape, JSH.param_shardings(amesh, jshape,
                                                       serve=True))
    eng = _engine(tp, cfg, mesh)
    split = 0
    for r in range(eng.mesh.size):
        for names, leaf in SH._walk(eng.params[r]):
            assert tuple(leaf.shape) == ref[tuple(names)], (names, r)
            split += tuple(leaf.shape) != tuple(SH._lookup(tp, names).shape)
    jc = jax.eval_shape(lambda: JMD.init_cache(jcfg, KW["max_batch"],
                                               KW["max_seq_len"]))
    cref = _reference_local(jc, JSH.cache_shardings(amesh, jc, jcfg))
    for r in range(eng.mesh.size):
        for name, leaf in eng.kv._shards[r].items():
            if name != "len":
                assert tuple(leaf.shape) == cref[(name,)], (name, r)
    # where the heads divide, the recurrent state is the rank's heads'
    name = "ssm" if cfg.family == "hybrid" else "mlstm"
    nh, m = eng.kv._meta[name].shape[-3], mesh[1]
    assert eng.kv._shards[0][name].shape[-3] == (nh // m if nh % m == 0
                                                 else nh)
    assert (split > 0) == (m != 3)


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_gather_tree_is_the_whole_tree(models, arch, mesh):
    _, cfg, tp, _, _, _ = models[arch]
    dmesh = DeviceMesh(mesh, ("cpu",) * math.prod(mesh))
    specs = SH.serve_specs(tp, dmesh)
    back = SH.gather_tree(SH.shard_params(tp, cfg, dmesh, specs), specs,
                          dmesh)
    for names, leaf in SH._walk(tp):
        assert torch.equal(SH._lookup(back, names), leaf), names
    if cfg.family == "hybrid" and mesh[1] != 3:
        # rank (0, 1)'s in-projection holds the second 1 / model of the
        # reference's columns (z, x, B, C, dt concatenated)
        w = tp["mamba"]["mamba"]["in_proj"]
        wd = w.shape[-1] // mesh[1]
        got = SH.shard_params(tp, cfg, dmesh, specs)[1]["mamba"]["mamba"][
            "in_proj"]
        assert torch.equal(got, w[..., wd:2 * wd])


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_streams_equal_single_and_reference(models, arch, mesh, kv):
    _, cfg, tp, prompts, want, single = models[arch]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng, got = _serve(_engine(tp, cfg, mesh, kv_cache=kv), prompts)
    assert got == single == want
    assert eng.summary()["dispatches_per_step"] == pytest.approx(1.0)
    assert (kv == "paged") == any("falling back" in str(w.message)
                                  for w in caught)


def _packets(eng, prompts):
    """Three requests of ``prompts`` (12 new tokens each) after three
    steps: each live slot's exported packet."""
    for p in prompts[:3]:
        eng.submit(p, max_new_tokens=12)
    for _ in range(3):
        eng.step()
    return {i: eng.kv.export_slot(i, int(eng.slot_pos[i]))
            for i, r in enumerate(eng.slot_req) if r is not None}


@pytest.fixture(scope="module")
def single_packets(models):
    """Per arch: the single engine's :func:`_packets`, and its streams of
    those three requests run to their end."""
    out = {}
    for arch in ARCHS:
        _, cfg, tp, prompts, _, _ = models[arch]
        out[arch] = (_packets(_engine(tp, cfg), prompts),
                     _serve(_engine(tp, cfg), prompts[:3], 12)[1])
    return out


@pytest.mark.parametrize("arch,mesh", CASES, ids=IDS)
def test_packets_equal_single_engine_and_resume(models, single_packets,
                                                 arch, mesh):
    _, cfg, tp, prompts, _, _ = models[arch]
    want, single = single_packets[arch]
    eng = _engine(tp, cfg, mesh)
    got = _packets(eng, prompts)
    assert got.keys() == want.keys() and len(got) == 3
    for i in want:
        assert set(got[i]) == set(want[i])
        for name, leaf in want[i].items():
            if isinstance(leaf, torch.Tensor):
                assert got[i][name].dtype == leaf.dtype
                assert got[i][name].shape == leaf.shape
                torch.testing.assert_close(got[i][name], leaf, rtol=1e-4,
                                           atol=1e-5)
            else:
                assert got[i][name] == leaf, (i, name)
    # the single engine's packet imported into the mesh lands as the
    # mesh's own export did: exported again, the same bytes
    eng.kv.free(2)
    eng.kv.import_slot(want[2], 2, 0, 0)
    again = eng.kv.export_slot(2, want[2]["n_valid"])
    for name, leaf in want[2].items():
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(again[name], leaf), name
    eng = _engine(tp, cfg, mesh)
    _packets(eng, prompts)
    eng.preempt_slot(1)
    eng.run()
    assert {r.rid: r.output for r in eng.finished} == single


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_prefill_equals_exact_on_every_rank(models, arch):
    """A 17-token prompt prefilled in the 32 bucket and at its length,
    then one decode step: every rank's recurrent state shards, and its
    K/V shards at the 18 written positions, equal bit for bit (past
    them a bucket's splice leaves its pad rows, which nobody reads)."""
    _, cfg, tp, prompts, _, _ = models[arch]
    shards = []
    for bucket in (16, 0):
        eng = _engine(tp, cfg, (2, 2), prefill_bucket_min=bucket)
        eng.submit(prompts[0], max_new_tokens=4)
        eng.step()
        shards.append(eng.kv._shards)
    n = len(prompts[0]) + 1
    for r, (a, b) in enumerate(zip(*shards)):
        for name in a:
            x, y = a[name], b[name]
            if name in ("k", "v"):
                x, y = x[:, :, :n], y[:, :, :n]
            assert torch.equal(x, y), (r, name)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cells_place_and_run_split(arch, kind):
    """The dry-run's serving cells take the split: at (2, 2) every rank's
    step runs on meta, its argument bytes are the serve placement's rank
    shards', and the recurrent products gather over model."""
    from repro_torch.launch import dryrun as D
    cfg = registry.get_smoke_config(arch)
    cell = D.Cell(cfg, kind, 4, 64, (2, 2), every_rank=True)
    rec = cell.run(trace=False)
    cell.close()
    assert rec["collectives"]["counts"]["all-gather"] > 0
    meta = SH._map(cell.params, lambda n, x: x)
    specs = SH.serve_specs(meta, (2, 2))
    want = sum(math.prod(SH.local_shape(tuple(x.shape), SH._lookup(
        specs, n), (2, 2))) * x.element_size() for n, x in SH._walk(meta))
    got = sum(math.prod(x.shape) * x.element_size()
              for _, x in SH._walk(cell._arg_shapes(0)["params"]))
    assert got == want


def test_mamba_split_off_the_head_alignment():
    """zamba2's smoke shapes with a state width of 12 at (1, 8): the 8
    heads divide the ranks and the state width does not, yet the
    in-projection and conv weight split in the reference's column order
    (their widths, 288 and 152, divide 8), each rank convolves its share
    of the channels, and the scan runs over its one head, B and C
    gathered whole — every local shape the reference's, the streams the
    single engine's."""
    cfg = registry.get_smoke_config("zamba2-2.7b").replace(dtype="float32",
                                                           ssm_state=12)
    jcfg = jreg.get_smoke_config("zamba2-2.7b").replace(dtype="float32",
                                                        ssm_state=12)
    tp = MD.init_params(cfg, seed=3, device="cpu")
    prompts = _prompts(cfg.vocab_size)[:2]
    _, single = _serve(_engine(tp, cfg), prompts)
    eng, got = _serve(_engine(tp, cfg, (1, 8)), prompts)
    assert got == single
    amesh = AbstractMesh((1, 8), ("data", "model"))
    jshape = jax.eval_shape(lambda: JMD.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    ref = _reference_local(jshape, JSH.param_shardings(amesh, jshape,
                                                       serve=True))
    for r in range(8):
        for names, leaf in SH._walk(eng.params[r]):
            assert tuple(leaf.shape) == ref[tuple(names)], (names, r)
    rank = eng.params[0]["mamba"]["mamba"]
    assert rank["in_proj"].shape[-1] == 288 // 8
    assert rank["conv_w"].shape[-1] == 152 // 8
    assert eng.kv._shards[0]["ssm"].shape[-3] == 1
    assert eng.kv._shards[0]["conv"].shape[-1] == 152 // 8
