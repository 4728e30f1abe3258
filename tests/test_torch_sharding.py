"""The port's serve-mode sharding rules against the JAX package's: for
every registry architecture at full size (shapes only — the port's meta
tensors, the reference's ``jax.eval_shape`` on an ``AbstractMesh``, no
device), the per-leaf placement of the params
(``param_shardings(..., serve=True)``), of the contiguous decode cache
(``cache_shardings``) and of the paged pools (``pool_shardings``) at
(2, 4), (2, 2), (1, 4) and (1, 8); the serve budget switch; the
realization the engine uses (shared experts on the dense MLP's rule, a
split over ``data`` refused); the shards of :func:`shard_params` and
:func:`init_params_sharded`."""
from __future__ import annotations

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.distributed import sharding as JSH
from repro.models import model as JMD
from repro_torch.configs import registry
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.models import model as MD
from _torch_threads import one_thread  # noqa: F401

MESHES = ((2, 4), (2, 2), (1, 4), (1, 8))
ARCHS = registry.list_archs(False)


def _norm(spec, nd):
    """A PartitionSpec as the port writes a spec: one entry per dim,
    None or a tuple of axis names."""
    out = []
    for e in tuple(spec) + (None,) * (nd - len(tuple(spec))):
        out.append(None if e is None else
                   ((e,) if isinstance(e, str) else tuple(e)))
    return tuple(out)


def _names(path):
    return [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]


def _lookup(tree, names):
    for n in names:
        tree = tree[int(n)] if isinstance(tree, list) else tree[n]
    return tree


@pytest.fixture(scope="module")
def shapes():
    """arch -> (reference param shapes, port meta params)."""
    out = {}
    for arch in ARCHS:
        jcfg = jreg.get_config(arch)
        jp = jax.eval_shape(lambda c=jcfg: JMD.init_params(
            jax.random.PRNGKey(0), c))
        out[arch] = (jp, MD.init_params(registry.get_config(arch),
                                        device="meta"))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_param_placement_equals_reference(shapes, mesh):
    amesh = AbstractMesh(mesh, ("data", "model"))
    for arch in ARCHS:
        jp, meta = shapes[arch]
        ref = JSH.param_shardings(amesh, jp, serve=True)
        ours = SH.param_specs(meta, mesh, serve=True)
        n = 0
        for path, sh in jax.tree_util.tree_leaves_with_path(ref):
            names = _names(path)
            leaf = _lookup(meta, names)
            want = _norm(sh.spec, leaf.dim())
            assert _lookup(ours, names) == want, (arch, names)
            n += 1
        assert n == sum(1 for _ in SH._walk(meta)), arch


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_cache_and_pool_placement_equals_reference(mesh):
    amesh = AbstractMesh(mesh, ("data", "model"))
    for arch in ARCHS:
        jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
        for b, c in ((8, 2048), (1, 4096), (3, 96)):
            jc = jax.eval_shape(lambda: JMD.init_cache(jcfg, b, c))
            ref = JSH.cache_shardings(amesh, jc, jcfg)
            ours = SH.cache_specs(MD.cache_spec(cfg, b, c), mesh)
            assert set(ours) == set(ref), arch
            for name, sh in ref.items():
                assert ours[name] == _norm(sh.spec, jc[name].ndim), (
                    arch, b, c, name)
        if cfg.family in MD.TRANSFORMER_FAMILIES \
                and cfg.sliding_window is None:
            pk, pv = jax.eval_shape(
                lambda: JMD.init_paged_pools(jcfg, 64, 16))
            ref = JSH.pool_shardings(amesh, (pk, pv))
            for leaf, sh in zip((pk, pv), ref):
                assert SH.pool_spec(leaf.shape, mesh) == _norm(
                    sh.spec, leaf.ndim), arch


def test_budget_switch_keeps_fsdp_over_budget(shapes):
    """qwen (1.2 GB) fits the 8e9 budget: weights whole over data;
    llama2-70b (138 GB / 4 a device) keeps the FSDP rules."""
    _, small = shapes["qwen1.5-0.5b"]
    _, big = shapes["llama2-70b"]
    s = SH.param_specs(small, (2, 4), serve=True)
    b = SH.param_specs(big, (2, 4), serve=True)
    assert s["layers"]["attn"]["wq"] == (None, None, ("model",))
    assert b["layers"]["attn"]["wq"] == (None, ("data",), ("model",))
    assert s["layers"]["attn"]["wo"] == (None, None, ("model",))
    # a budget of 0 keeps FSDP for any model; without serve the row
    # rule splits the contraction over model
    z = SH.param_specs(small, (2, 4), serve=True, serve_budget_bytes=0)
    assert z["layers"]["attn"]["wq"] == (None, ("data",), ("model",))
    t = SH.param_specs(small, (2, 4))
    assert t["layers"]["attn"]["wo"] == (None, ("model",), ("data",))


def test_serve_specs_refuse_data_split_and_fix_shared_experts(shapes):
    _, big = shapes["llama2-70b"]
    # over the budget at data 2 the weights split over data (gathered at
    # use by the engine); the stacked norms stay whole
    split = SH.serve_specs(big, (2, 4))
    assert split["layers"]["attn"]["wq"] == (None, ("data",), ("model",))
    assert split["layers"]["ln1"]["w"] == (None, None)
    assert SH.splits_over_data(split, (2, 4))
    assert not SH.splits_over_data(SH.serve_specs(big, (1, 4)), (1, 4))
    # at data = 1 the size-1 axis splits nothing: allowed
    specs = SH.serve_specs(big, (1, 4))
    assert specs["layers"]["attn"]["wq"] == (None, ("data",), ("model",))
    assert SH.local_shape(big["layers"]["attn"]["wq"].shape,
                          specs["layers"]["attn"]["wq"], (1, 4)) \
        == (80, 8192, 2048)
    # deepseek-moe's 27 stacked layers at model 3: the reference's rule
    # splits the shared MLP's layer axis; the engine's takes its columns
    cfg = registry.get_config("deepseek-moe-16b")
    meta = MD.init_params(cfg, device="meta")
    ref = SH.param_specs(meta, (1, 3), serve=True)
    ours = SH.serve_specs(meta, (1, 3))
    sh_ref, sh = ref["layers"]["moe"]["shared"], ours["layers"]["moe"]["shared"]
    assert sh_ref["w_gate"][0] == ("model",)
    # over budget: the dense column rule, d_model over the size-1 data
    # axis, the 2816 columns whole (2816 % 3 != 0)
    assert sh["w_gate"] == (None, ("data",), None)
    assert sh["w_down"] == (None, None, None)   # d_model 2048 % 3 != 0
    assert ours["layers"]["moe"]["w_gate"] == ref["layers"]["moe"]["w_gate"]


def test_shards_cut_and_init(shapes):
    """shard_params cuts each leaf at its rank's index (replicated
    leaves shared on one device); init_params_sharded makes equal
    shards equal and the rule's local shapes, and refuses what the
    engine refuses."""
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(
        dtype="float32")
    params = MD.init_params(cfg, seed=3, device="cpu")
    mesh = DeviceMesh((2, 2), ("cpu",) * 4)
    shards = SH.shard_params(params, cfg, mesh)
    wq = params["layers"]["attn"]["wq"]
    n = wq.shape[-1] // 2
    for r in range(4):
        mi = mesh.coords(r)[1]
        assert torch.equal(shards[r]["layers"]["attn"]["wq"],
                           wq[..., mi * n:(mi + 1) * n])
        assert shards[r]["final_norm"]["w"] is params["final_norm"]["w"]
        assert torch.equal(shards[r]["embed"]["table"],
                           params["embed"]["table"][mi * 128:(mi + 1) * 128])
    made = SH.init_params_sharded(cfg, mesh, seed=3)
    for r in range(4):
        for names, leaf in SH._walk(made[r]):
            spec = _lookup(SH.serve_specs(params, mesh), names)
            assert tuple(leaf.shape) == SH.local_shape(
                tuple(_lookup(params, names).shape), spec, mesh), names
    # ranks (0, j) and (1, j) hold the same shard: the same values
    assert torch.equal(made[0]["layers"]["mlp"]["w_up"],
                       made[2]["layers"]["mlp"]["w_up"])
    assert not torch.equal(made[0]["layers"]["mlp"]["w_up"],
                           made[1]["layers"]["mlp"]["w_up"])
    assert made[1]["layers"]["ln1"]["w"].eq(1).all()
    assert made[1]["layers"]["attn"]["bq"].eq(0).all()
    std = made[0]["layers"]["mlp"]["w_up"].std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.02
    # whisper cuts as every family does: the shards make the whole tree
    wcfg = registry.get_smoke_config("whisper-large-v3").replace(
        dtype="float32")
    wp = MD.init_params(wcfg, seed=3, device="cpu")
    back = SH.gather_tree(SH.shard_params(wp, wcfg, mesh),
                          SH.serve_specs(wp, mesh), mesh)
    for names, leaf in SH._walk(wp):
        assert torch.equal(_lookup(back, names), leaf), names
