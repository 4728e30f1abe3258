"""The port's MoE (``repro_torch.models.moe``) against
``repro.models.moe`` on bridged weights (smoke configs, float32, CPU):
router ids equal and weights close, the capacity rule, ``apply_moe``
with and without dropped slots, the shared experts, and ``init_params``
of the MoE and vlm configs (keys, shapes, dtypes) equal to JAX's."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro.models import moe as JM
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import moe as M

ATOL = 1e-4
ARCHS = ("deepseek-moe-16b", "dbrx-132b")


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (jreg.get_smoke_config(arch).replace(**kw),
            registry.get_smoke_config(arch).replace(**kw))


def _moe_params(jcfg, cfg, seed=5):
    jp = jax.device_get(JM.init_moe(jax.random.PRNGKey(seed), jcfg))
    return jp, bridge.params_from_jax(jp, cfg, device="cpu")


def _x(cfg, b, s, seed=0, pad_from=None):
    """Seeded (b, s, d) inputs; rows from ``pad_from`` on repeat one row,
    as a bucket's pad tokens do (they all pick the same experts)."""
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    if pad_from is not None:
        x[:, pad_from:] = x[:, pad_from:pad_from + 1]
    return x


def _drops(cfg, tp, x):
    """Routed slots past their expert's capacity in one dispatch of x."""
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, ids = M.route(tp["router"], xf, cfg.moe_top_k)
    pos = M.slot_positions(ids, cfg.n_experts)
    return int((pos >= M._capacity(xf.shape[0], cfg)).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_ids_equal_and_weights_match(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, cfg)
    x = _x(cfg, 3, 40).reshape(-1, cfg.d_model)
    jw, jids = JM.route(jnp.asarray(jp["router"]), jnp.asarray(x),
                        cfg.moe_top_k)
    w, ids = M.route(tp["router"], torch.from_numpy(x), cfg.moe_top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)


def test_route_ties_take_the_lower_expert_first():
    """A zero router makes every expert tie: ``lax.top_k`` order is the
    lowest indices, and so is the port's."""
    jcfg, cfg = _cfgs("deepseek-moe-16b")
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    x = _x(cfg, 1, 6).reshape(-1, cfg.d_model)
    _, jids = JM.route(jnp.asarray(router), jnp.asarray(x), cfg.moe_top_k)
    _, ids = M.route(torch.from_numpy(router), torch.from_numpy(x),
                     cfg.moe_top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.tolist() == [list(range(cfg.moe_top_k))] * 6


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
@pytest.mark.parametrize("arch", ARCHS + ("mixtral-8x22b",))
def test_capacity_matches_reference(arch, cf):
    jcfg = jreg.get_config(arch).replace(moe_capacity_factor=cf)
    cfg = registry.get_config(arch).replace(moe_capacity_factor=cf)
    assert [M._capacity(n, cfg) for n in range(1, 65)] == \
        [JM._capacity(n, jcfg) for n in range(1, 65)]


@pytest.mark.parametrize("case,b,s,cf", [
    # 40 tokens, 28 of them one pad row: capacity 25 for 80 slots, and
    # the pad row's experts overflow
    ("drops", 1, 40, 1.25),
    ("dropless", 2, 20, 2.0),   # cf = E / k: no slot is ever dropped
    ("decode", 8, 1, 1.25),     # B <= 8 rows: capacity 8 >= n
])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, case, b, s, cf):
    jcfg, cfg = _cfgs(arch, moe_capacity_factor=cf)
    jp, tp = _moe_params(jcfg, cfg)
    x = _x(cfg, b, s, seed=1, pad_from=12 if case == "drops" else None)
    drops = _drops(cfg, tp, x)
    assert (drops > 0) == (case == "drops"), drops
    want = JM.apply_moe(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                        jnp.asarray(x))
    got = M.apply_moe(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # deterministic: the same dispatch twice gives the same bits
    assert torch.equal(got, M.apply_moe(tp, cfg, torch.from_numpy(x)))


def test_dropped_slot_contributes_nothing():
    """With capacity 8 a 40-token dispatch drops routed slots: the port
    equals a plain per-slot sum over the kept slots only."""
    jcfg, cfg = _cfgs("dbrx-132b", moe_capacity_factor=0.01)
    _, tp = _moe_params(jcfg, cfg)
    x = torch.from_numpy(_x(cfg, 1, 40, seed=2)).reshape(40, -1)
    w, ids = M.route(tp["router"], x, cfg.moe_top_k)
    keep = (M.slot_positions(ids, cfg.n_experts) < 8).view(40, -1)
    assert 0 < int(keep.sum()) < keep.numel()
    want = torch.zeros_like(x)
    for t in range(40):
        for j in range(cfg.moe_top_k):
            if keep[t, j]:
                e = int(ids[t, j])
                g, u = x[t] @ tp["w_gate"][e], x[t] @ tp["w_up"][e]
                h = torch.nn.functional.silu(g) * u
                want[t] += w[t, j] * (h @ tp["w_down"][e])
    got = M.apply_moe(tp, cfg, x[None])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_shared_experts_match_reference():
    """deepseek's shared experts add their MLP to every token: the port's
    output without them differs by exactly that MLP, and both equal the
    reference's."""
    jcfg, cfg = _cfgs("deepseek-moe-16b")
    assert cfg.n_shared_experts
    jp, tp = _moe_params(jcfg, cfg)
    x = _x(cfg, 2, 9, seed=3)
    routed = {k: v for k, v in tp.items() if k != "shared"}
    jrouted = {k: jnp.asarray(v) for k, v in jp.items() if k != "shared"}
    got_all = M.apply_moe(tp, cfg, torch.from_numpy(x))
    got_routed = M.apply_moe(routed, cfg, torch.from_numpy(x))
    want_routed = JM.apply_moe(jrouted, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got_routed.numpy(), np.asarray(want_routed),
                               atol=ATOL, rtol=0)
    shared = L.apply_mlp(tp["shared"], cfg, torch.from_numpy(x))
    np.testing.assert_allclose((got_all - got_routed).numpy(),
                               shared.numpy(), atol=ATOL, rtol=0)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-26b",
                                  "dbrx-132b"])
def test_init_params_keys_shapes_dtypes_match_reference(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    want = dict(_leaves(jax.eval_shape(
        lambda: JMD.init_params(jax.random.PRNGKey(0), jcfg))))
    got = dict(_leaves(MD.init_params(cfg, seed=0, device="cpu")))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).split(".")[1] == str(want[path].dtype), path
    n_first = cfg.first_dense_layers if cfg.is_moe else 0
    assert len(MD.blocks(MD.init_params(cfg, device="cpu"), cfg)) == \
        cfg.n_layers
    assert ("/first_layers/0/mlp/w_gate" in got) == bool(n_first)
